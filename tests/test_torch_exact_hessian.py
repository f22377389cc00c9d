"""PyTorch port, the exact Hessian (hessian_approx="EXACT"): the EXACT
branch of ocp_nlp/linearize.py against jax.vmap of the JAX package's
linearize with ERK, each of exact_hess_cost/dyn/constr off in turn, on a
pendulum whose cost residual and h row are nonlinear, at an iterate with
nonzero multipliers (float64, CPU): every QP field within a relative gap
of 1e-9 (IRK in tests/test_torch_exact_irk.py). Then the EXACT SQP
through both packages, the per-instance lm of adaptive LM, and the K1
launches an EXACT linearization makes on the main path's integrator
(chip_smoke.py's count).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_nlp import linearize as jlin
from acados_tpu.ocp_nlp.formulation import NlpData as JNlpData
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp import linearize as tlin
from acados_tpu_torch.sim import irk
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_torch_globalization import (assert_same_solve, batch_data,
                                      jax_solve, port_solve, rel_gap,
                                      zero_iterate)

torch.set_num_threads(1)

N = 4
X0S = (np.array([0.0, np.pi, 0.0, 0.0])
       + np.random.default_rng(2).normal(0.0, 0.2, (3, 4)))
QP_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg", "ug")


def curved_pendulum(pkg, integrator_type, N=N, **so):
    """The pendulum with a nonlinear cost residual (sin(theta) * F after
    x and u) and a nonlinear h row (v^2 + 0.1 sin(theta) F <= 4), so
    that the cost and constraint curvature of the exact Hessian are not
    zero."""
    lib = jnp if pkg == "jax" else torch
    cat = jnp.concatenate if pkg == "jax" else torch.cat
    make = jax_pendulum_ocp if pkg == "jax" else make_pendulum_ocp
    ocp = make(N=N, dtype="float64", nlp_solver_type="SQP",
               integrator_type=integrator_type)
    m = ocp.model
    m.cost_y_expr = lambda x, u: cat([x, u, lib.sin(x[1:2]) * u])
    ocp.cost.yref = np.zeros(6)
    W = np.zeros((6, 6))
    W[:5, :5] = ocp.cost.W
    W[5, 5] = 0.5
    ocp.cost.W = W
    m.con_h_expr = lambda x, u: x[2:3] ** 2 + 0.1 * lib.sin(x[1:2]) * u
    ocp.constraints.lh = np.array([-1e3])
    ocp.constraints.uh = np.array([4.0])
    ocp.solver_options.hessian_approx = "EXACT"
    for k, v in so.items():
        setattr(ocp.solver_options, k, v)
    return ocp


def _iterate(form, seed):
    """A seeded iterate with every multiplier nonzero (B = 3)."""
    rng = np.random.default_rng(seed)
    B, nx, nu, nc = len(X0S), form.nx, form.nu, form.nc
    x = np.repeat(X0S[:, None], N + 1, axis=1) + 0.1 * rng.normal(
        size=(B, N + 1, nx))
    return dict(x=x, u=rng.normal(size=(B, N, nu)),
                pi=rng.normal(size=(B, N, nx)),
                lam_l=rng.uniform(0.1, 2.0, (B, N + 1, nc)),
                lam_u=rng.uniform(0.1, 2.0, (B, N + 1, nc)),
                sl=np.zeros((B, N + 1, nc)), su=np.zeros((B, N + 1, nc)))


VARIANTS = {"all": {}, "no_cost": dict(exact_hess_cost=0),
            "no_dyn": dict(exact_hess_dyn=0),
            "no_constr": dict(exact_hess_constr=0),
            "gauss_newton": dict(hessian_approx="GAUSS_NEWTON")}


def test_exact_linearize_matches_jax():
    """All on, each toggle off in turn and Gauss-Newton, at one iterate:
    the port's QP equals the JAX package's, and each toggle changes the
    QP (so each term is really exercised)."""
    check_linearize("ERK", VARIANTS)


def check_linearize(integrator_type, variants):
    Qs = {}
    for name, so in variants.items():
        jform, dnp, _ = jax_build_ocp(curved_pendulum("jax", integrator_type,
                                                      **so))
        form, _, _ = build_ocp(curved_pendulum("torch", integrator_type,
                                               **so))
        data = batch_data(dnp, X0S, 4)
        itn = _iterate(form, seed=1)
        sr = jlin.build_static_rows(jform, jnp.float64)
        ref = jax.jit(jax.vmap(lambda d, it: jlin.linearize(
            jform, sr, d, it, jnp.asarray(0.0))))(
            JNlpData(**{k: jnp.asarray(v) for k, v in data.items()}),
            jlin.NlpIterate(**{k: jnp.asarray(v) for k, v in itn.items()}))
        got = tlin.linearize(
            form, tlin.build_static_rows(form, torch.float64, "cpu"),
            data_to_torch(data, torch.float64, "cpu"),
            iterate_from_numpy(itn, torch.float64, "cpu"),
            torch.zeros((), dtype=torch.float64))
        for f in QP_FIELDS:
            gap = rel_gap(getattr(got, f).numpy(), getattr(ref, f))
            assert gap <= 1e-9, f"{integrator_type} {name} {f}: {gap:.3e}"
        Qs[name] = np.concatenate([np.asarray(getattr(ref, f)).reshape(
            len(X0S), -1) for f in ("Q", "R", "S")], axis=-1)
    for name in variants:
        if name != "all":
            assert np.abs(Qs[name] - Qs["all"]).max() > 1e-3, name


def test_exact_sqp_matches_jax():
    """The EXACT SQP (PROJECT, MERIT_BACKTRACKING) on the curved pendulum
    from near the upright: per-instance status, sqp_iter, qp_iter_total,
    stat table and iterates as in tests/test_torch_globalization.py,
    whose cost weights scaled by 1e-3 keep the line search off rounding
    ties (see there). From the swing-up at pi the exact-Hessian SQP of
    this problem stops at 100 iterations in both packages."""
    so = dict(regularize_method="PROJECT", globalization="MERIT_BACKTRACKING",
              nlp_solver_max_iter=100)
    x0s = (np.array([0.0, 0.6, 0.0, 0.0])
           + np.random.default_rng(2).normal(0.0, 0.2, (4, 4)))[1:]

    def ocp(pkg):
        o = curved_pendulum(pkg, "ERK", N=6, **so)
        o.cost.W = 1e-3 * np.asarray(o.cost.W)
        o.cost.W_e = 1e-3 * np.asarray(o.cost.W_e)
        return o

    data, init, it_ref, st_ref = jax_solve(ocp("jax"), x0s)
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    it, st = port_solve(ocp("torch"), data, init)
    assert_same_solve(it, st, it_ref, st_ref, "EXACT SQP")


def test_per_instance_levenberg_marquardt():
    """linearize takes one lm an instance (adaptive LM): instance b's QP
    equals that of a scalar lm = lm[b]."""
    form, dnp, _ = build_ocp(curved_pendulum("torch", "ERK"))
    data = data_to_torch(batch_data(dnp, X0S, 4), torch.float64, "cpu")
    it = iterate_from_numpy(_iterate(form, seed=2), torch.float64, "cpu")
    sr = tlin.build_static_rows(form, torch.float64, "cpu")
    lm = torch.tensor([1e-3, 0.5, 7.0], dtype=torch.float64)
    qp = tlin.linearize(form, sr, data, it, lm)
    for b in range(3):
        qb = tlin.linearize(form, sr, data, it, lm[b])
        for f in ("Q", "R", "S", "q"):
            assert torch.equal(getattr(qp, f)[b], getattr(qb, f)[b]), f


def _counting(monkeypatch):
    """Count the K1 wrapper calls of the IRK step (linsolve and
    gj_inverse_any each launch K1 once on the card)."""
    calls = []
    for name in ("linsolve", "gj_inverse_any"):
        orig = getattr(irk, name)
        monkeypatch.setattr(irk, name, lambda *a, _o=orig: (
            calls.append(1), _o(*a))[1])
    return calls


def test_k1_launches_of_an_exact_linearization(monkeypatch):
    """chip_smoke.py's launch counts for the main path (the pendulum, IRK
    GL4, 2 substeps): a Gauss-Newton linearization makes 8 K1 calls (3
    Newton + 1 sensitivity solve a substep); an EXACT one
    K1_PER_EXACT_LINEARIZE = 8 + 14 (the dynamics Hessian, one vmapped
    torch.func.hessian over every interval: a substep's 3 Newton solves
    in the forward pass, 1 in the reverse, 1 in the forward-mode pass of
    the root and 2 in that of its reverse); a dynamics-gap evaluation
    (the merit's) K1_PER_DYN_GAP = 6; at any B and N."""
    calls = _counting(monkeypatch)
    zero = torch.zeros((), dtype=torch.float64)
    for B, n in ((2, 3), (5, 6)):
        x0s = np.resize(X0S, (B, 4))
        for hess, want in (("GAUSS_NEWTON", chip_smoke.LAUNCHES_PER_RTI),
                           ("EXACT", chip_smoke.K1_PER_EXACT_LINEARIZE)):
            ocp = make_pendulum_ocp(N=n, integrator_type="IRK")
            ocp.solver_options.hessian_approx = hess
            form, dnp, _ = build_ocp(ocp)
            data = data_to_torch(batch_data(dnp, x0s, 4), torch.float64,
                                 "cpu")
            itn = zero_iterate(form, x0s)
            itn["pi"] = np.ones_like(itn["pi"])
            it = iterate_from_numpy(itn, torch.float64, "cpu")
            sr = tlin.build_static_rows(form, torch.float64, "cpu")
            calls.clear()
            tlin.linearize(form, sr, data, it, zero)
            assert len(calls) == want, (hess, B, n)
            calls.clear()
            tlin.eval_dyn_gap(form, data, it.x, it.u)
            assert len(calls) == chip_smoke.K1_PER_DYN_GAP
