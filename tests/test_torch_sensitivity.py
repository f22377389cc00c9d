"""PyTorch port, the solution sensitivities (`ocp_nlp/sensitivity.py` and
the sensitivity API of both solvers) against the JAX package, in float64
on the CPU, on the parametric pendulum of tests/test_sensitivity.py,
hard and with a softened state bound.

The cases of tests/test_sensitivity.py (forward parameter sensitivity,
initial-state sensitivity, forward-adjoint consistency, adjoint gradient,
batch against serial, optimal-value gradient; the differentiable solver
is in tests/test_torch_diff_solver.py) each hold the port's function
against the JAX package's same function at 1e-9 relative, at the same
solved point: the JAX solver solves, and its iterate is handed to the
port's solver, so the comparison isolates the sensitivity layer.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu import AcadosOcpBatchSolver as JaxBatchSolver
from acados_tpu import AcadosOcpSolver as JaxSolver
from acados_tpu.interface.builder import data_to_jax
from acados_tpu_torch import AcadosOcpBatchSolver, AcadosOcpSolver
from acados_tpu_torch.ocp_nlp import sensitivity as sens
from acados_tpu_torch.testing import param_pendulum_ocp
from test_sensitivity import make_param_ocp

torch.set_num_threads(1)

REL = 1e-9
N = 20
P0 = np.array([0.1, 0.8])


def _close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = np.max(np.abs(ref)) if ref.size else 0.0
    assert np.max(np.abs(ours - ref), initial=0.0) <= rel * max(scale,
                                                                1e-300)


@pytest.fixture(scope="module", params=[False, True], ids=["hard", "soft"])
def pair(request):
    """(JAX solver, port solver, the JAX reference, the seeds, the JAX
    reference at the iterate moved by one rounding step) at the JAX
    solver's solution of the parametric pendulum. The reference is one
    jitted call of the JAX package's sensitivity functions (KktFactor, then
    forward_sensitivity over every seed direction the tests use,
    adjoint_sensitivity for every seed, eval_lagrange_grad_p and
    optimal_value_grad_x0): the JAX interface methods are thin slices of
    these, run op by op."""
    from acados_tpu.ocp_nlp.sensitivity import (KktFactor, SensOpts,
                                                adjoint_sensitivity,
                                                eval_lagrange_grad_p,
                                                forward_sensitivity,
                                                optimal_value_grad_x0)
    soft = request.param
    js = JaxSolver(make_param_ocp(soft=soft))
    for k in range(N + 1):
        js.set(k, "p", P0)
    assert js.solve() == 0
    ts = AcadosOcpSolver(param_pendulum_ocp(soft=soft), device="cpu")
    ts._iterate = {k: np.array(v) for k, v in js._iterate.items()}
    ts._default_init = False

    form, off = js.form, js.layouts["0"].off_bx
    rng = np.random.default_rng(42)
    seeds = dict(seed_x=rng.normal(size=(N + 1, 4)),
                 seed_u=rng.normal(size=(N, 1)),
                 dp=rng.normal(size=(N + 1, 2)),
                 dyref=rng.normal(size=(N - 1, 5)),
                 u0=np.asarray(js.get(0, "u")))

    def reference(data, it, seed_x, seed_u, dp, dyref, u0):
        kf = KktFactor(form, SensOpts(), data, it)
        zero = jax.tree.map(jnp.zeros_like, data)
        dirs = []
        for i in range(2):   # p_i at every stage, then p_i at stage 7
            dirs.append(zero.replace(p=zero.p.at[:, i].set(1.0)))
            dirs.append(zero.replace(p=zero.p.at[7, i].set(1.0)))
        for i in range(4):   # the initial state
            e = zero.lb_0.at[off + i].set(1.0)
            dirs.append(zero.replace(lb_0=e, ub_0=e))
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *dirs)
        fwd = jax.vmap(lambda d: forward_sensitivity(kf, d)[:2])(stacked)
        zx, zu = jnp.zeros_like(it.x), jnp.zeros_like(it.u)
        return dict(
            fwd=fwd,
            fwd_rand=forward_sensitivity(kf, zero.replace(p=dp,
                                                          yref=dyref)),
            adj_rand=adjoint_sensitivity(kf, seed_x, seed_u),
            adj_u0=adjoint_sensitivity(kf, zx, zu.at[0].set(u0)),
            adj_x=adjoint_sensitivity(kf, seed_x, zu),
            grad_p=eval_lagrange_grad_p(form, data, it),
            grad_x0=optimal_value_grad_x0(form, data, it))

    ref_fn = jax.jit(reference)
    data, it = data_to_jax(js._data, js.dtype), js._iterate_jax()
    args = [jnp.asarray(v) for v in seeds.values()]
    ref = ref_fn(data, it, *args)
    sign = np.random.default_rng(3).choice((-1.0, 1.0), it.x.shape)
    # the reference again at x moved by one rounding step: its own spread
    moved = ref_fn(data, it.replace(
        x=it.x * (1 + np.finfo(np.float64).eps * sign)), *args)
    return (js, ts, jax.tree.map(np.asarray, ref), seeds,
            jax.tree.map(np.asarray, moved))


def test_forward_param_sens_matches_jax(pair):
    _, ts, ref, _, _ = pair
    dx, du = ref["fwd"]
    for k, (index, stage) in enumerate(((0, None), (0, 7), (1, None),
                                        (1, 7))):
        out = ts.eval_param_sens(index, stage)
        _close(out["sens_x"], dx[k])
        _close(out["sens_u"], du[k])


@pytest.mark.parametrize("wrt", ["initial_state", "params_global"])
def test_solution_sensitivity_matches_jax(pair, wrt):
    _, ts, ref, _, _ = pair
    dx, du = ref["fwd"]
    pick = [0, 2] if wrt == "params_global" else [4, 5, 6, 7]
    stages = list(range(N + 1))
    out_x, out_u = ts.eval_solution_sensitivity(stages, wrt)
    _close(np.stack(out_x), np.moveaxis(dx[pick], 0, -1))
    _close(np.stack(out_u)[:N], np.moveaxis(du[pick], 0, -1))
    assert not np.any(out_u[N])
    if wrt == "initial_state":
        # the reference's own check (tests/test_sensitivity.py:110)
        np.testing.assert_allclose(out_x[0], np.eye(4), atol=1e-6)
    sx0 = ts.eval_solution_sensitivity(0, wrt, return_sens_u=False)
    _close(sx0, np.moveaxis(dx[pick], 0, -1)[0])


def test_adjoint_forward_consistency_matches_jax(pair):
    """adjoint_sensitivity for random seeds and forward_sensitivity for a
    random data direction (p and yref), each against the JAX function,
    and <seed, forward(d)> == <adjoint(seed), d>."""
    _, ts, ref, seeds, _ = pair
    kf = ts._kkt_factor()
    grad = sens.adjoint_sensitivity(kf,
                                    torch.as_tensor(seeds["seed_x"][None]),
                                    torch.as_tensor(seeds["seed_u"][None]))
    for f in ("p", "yref", "W", "yref_e", "lb_0", "ub_0", "lb", "ub",
              "Zl", "zl", "cost_scale"):
        _close(getattr(grad, f)[0].numpy(), getattr(ref["adj_rand"], f))
    d = sens.NlpData(**dict.fromkeys(sens.NlpData.__dataclass_fields__))
    d = d.replace(p=torch.as_tensor(seeds["dp"][None]),
                  yref=torch.as_tensor(seeds["dyref"][None]))
    out = sens.forward_sensitivity(kf, d)
    moved = pair[4]["fwd_rand"]
    for o, r, m in zip(out[:3], ref["fwd_rand"], moved):
        _close(o[0].numpy(), r)
    # dlam = -W dt: on a soft row whose t sits at the t_lam_min floor the
    # weight W = lam / t is ~1e10, and the reference's own dlam moves by
    # ~1e-9 of its largest entry when the iterate moves by one rounding
    # step; there the bound is 4 x that spread
    for o, r, m in zip(out[3:], ref["fwd_rand"][3:], moved[3:]):
        spread = np.max(np.abs(m - r))
        assert np.max(np.abs(o[0].numpy() - r)) <= max(
            REL * np.max(np.abs(r)), 4 * spread)
    lhs = np.sum(seeds["seed_x"] * out[0][0].numpy()) + np.sum(
        seeds["seed_u"] * out[1][0].numpy())
    rhs = np.sum(grad.p[0].numpy() * seeds["dp"]) + np.sum(
        grad.yref[0].numpy() * seeds["dyref"])
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10, atol=1e-12)


def test_adjoint_gradient_matches_jax(pair):
    js, ts, ref, seeds, _ = pair
    u0, off = seeds["u0"], js.layouts["0"].off_bx
    g = ref["adj_u0"]
    out = lambda wrt: ts.eval_adjoint_solution_sensitivity(
        None, [(0, u0)], wrt)
    _close(out("params_global"), g.p.sum(axis=0))
    _close(out("p_stagewise"), g.p)
    _close(out("initial_state"), (g.lb_0 + g.ub_0)[off:off + 4])
    _close(ts.eval_adjoint_solution_sensitivity(seeds["seed_x"], None),
           ref["adj_x"].p.sum(axis=0))
    full = ts.eval_adjoint_solution_sensitivity(None, [(0, u0)], "all")
    _close(full.W[0].numpy(), g.W)


def test_optimal_value_gradient_matches_jax(pair):
    _, ts, ref, _, _ = pair
    _close(ts.eval_and_get_optimal_value_gradient("p_global"),
           ref["grad_p"].sum(axis=0))
    _close(ts.eval_and_get_optimal_value_gradient("initial_state"),
           ref["grad_x0"])
    # the parametric pendulum declares no model.p_global
    with pytest.raises(ValueError, match="p_global"):
        ts.set_p_global_and_precompute_dependencies(np.zeros(1))


def _batch_x0s():
    return [np.array([0.0, np.pi / 2, 0.0, 0.0]),
            np.array([0.1, 1.2, 0.0, 0.0]),
            np.array([0.0, 1.8, 0.1, 0.0])]


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_batch_sensitivities_match_serial_and_jax(soft):
    """The batched adjoint and forward sensitivities (B = 3, N = 10)
    against the serial solver's, instance by instance (the serial ones
    are held against the JAX package above), and the adjoint against the
    JAX batch solver's."""
    Nb, B = 10, 3
    jocp, tocp = make_param_ocp(soft=soft, N=Nb), param_pendulum_ocp(
        soft=soft, N=Nb)
    for ocp in (jocp, tocp):
        ocp.solver_options.tol = 1e-9
    jb = JaxBatchSolver(jocp, N_batch=B)
    tb = AcadosOcpBatchSolver(tocp, B, device="cpu")
    for b in (jb, tb):
        for i, x0 in enumerate(_batch_x0s()):
            v = b.ocp_solvers[i]
            v.set(0, "lbx", x0)
            v.set(0, "ubx", x0)
            for k in range(Nb + 1):
                v.set(k, "x", x0)
        assert np.all(b.solve() == 0)
    # the port's batch at the JAX batch's solution
    tb._iterate = {k: np.array(v) for k, v in jb._iterate.items()}
    tb._it_dev, tb._host_stale = None, False
    seed_u = np.ones((B, Nb, 1))
    g_t = tb.eval_adjoint_solution_sensitivity(None, seed_u)
    _close(g_t, jb.eval_adjoint_solution_sensitivity(None, seed_u))
    sx_t, su_t = tb.eval_solution_sensitivity([0, 3, Nb], "initial_state")
    serial = AcadosOcpSolver(tocp, device="cpu")
    for i in range(B):
        serial._iterate = {k: v[i].copy() for k, v in tb._iterate.items()}
        serial._data = {k: v[i].copy() for k, v in tb._data.items()}
        serial._default_init = False
        _close(g_t[i], serial.eval_adjoint_solution_sensitivity(
            None, np.ones((Nb, 1))), 1e-12)
        ssx, ssu = serial.eval_solution_sensitivity([0, 3, Nb],
                                                    "initial_state")
        _close(sx_t[i], np.stack(ssx), 1e-12)
        _close(su_t[i], np.stack(ssu), 1e-12)
