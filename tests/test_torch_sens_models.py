"""PyTorch port, the solution sensitivities on the solver paths the card
runs, against the JAX package in float64 on the CPU: the QP-level seeds
(`ocp_qp/ipm.py:solve_ocp_qp_sens_frw/_adj`), the pendulum with the main
path's IRK (Gauss-Legendre 4 stages, 2 substeps; the Lagrangian Hessian
goes through the IRK step's implicit gradient) at N = 8, and the chain at
n_mass = 5 (nx = 21 > 12, so P_0 is factored by `chol_any`, the plain
version of K2 here; the dynamics Jacobians come from the Kronecker IRK
path, the Hessian from the generic IRK at nw = 42).

Each NLP case solves with the JAX solver and hands its iterate to the
port's, and the JAX side's sensitivities are one jitted call of the JAX
package's functions, so the comparison isolates the sensitivity layer.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu import AcadosOcpSolver as JaxSolver
from acados_tpu.interface.builder import data_to_jax
from acados_tpu.ocp_nlp.sensitivity import (KktFactor, SensOpts,
                                            adjoint_sensitivity,
                                            forward_sensitivity)
from acados_tpu.ocp_qp import data as jdata
from acados_tpu.ocp_qp.ipm import solve_ocp_qp as jax_solve_ocp_qp
from acados_tpu.ocp_qp.ipm import solve_ocp_qp_sens_adj as jax_sens_adj
from acados_tpu.ocp_qp.ipm import solve_ocp_qp_sens_frw as jax_sens_frw
from acados_tpu_torch import AcadosOcpSolver
from acados_tpu_torch.ocp_qp import data as tdata
from acados_tpu_torch.ocp_qp.ipm import (solve_ocp_qp_sens_adj,
                                         solve_ocp_qp_sens_frw)
from acados_tpu_torch.testing import random_qp_batch

torch.set_num_threads(1)

REL = 1e-9
QP_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg", "ug",
             "mask_l", "mask_u", "Zl", "Zu", "zl", "zu", "soft_mask")
SOL_FIELDS = ("x", "u", "pi", "lam_lg", "lam_ug", "t_lg", "t_ug", "sl", "su")


def _close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.max(np.abs(ours - ref), initial=0.0) <= rel * max(
        np.max(np.abs(ref), initial=0.0), 1e-300)


@pytest.mark.parametrize("active", [False, True],
                         ids=["inactive", "active"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_qp_sens_frw_and_adj_match_jax(soft, active):
    """The QP seeds at the JAX IPM's solution of seeded random QPs: the
    forward sensitivity along a random data direction, and the adjoint's
    gradient with respect to every data field, against jax.vmap of the
    JAX functions.

    With every row inactive (bounds widened by 10) the system is well
    conditioned: the bound is 1e-9 relative, and the adjoint is the
    forward map's transpose to 1e-10. With active rows the
    barrier weights lam / t of the converged IPM reach ~1e13 (t ~ 1e-14),
    and the JAX package's own result moves by ~1e-5 of its largest entry
    when the solution's x, slacks and multipliers move by one rounding
    step; there each output is held to 1e-9 relative or 4 x that spread
    of the reference."""
    d = random_qp_batch(20 + soft, B=4, N=6, soft=soft, x0_rows=False)
    if not active:
        d["lg"], d["ug"] = d["lg"] - 10.0, d["ug"] + 10.0
    jqp = jdata.OcpQp(**{k: jnp.asarray(d[k]) for k in QP_FIELDS})
    tqp = tdata.OcpQp(**{k: torch.as_tensor(d[k]) for k in QP_FIELDS})
    jsol, info = jax.vmap(jax_solve_ocp_qp)(jqp)
    assert np.all(np.asarray(info.status) == 0)
    tsol = tdata.OcpQpSol(**{k: torch.as_tensor(np.asarray(getattr(jsol, k)))
                             for k in SOL_FIELDS})
    rng = np.random.default_rng(30 + soft)
    tan = {k: rng.normal(size=d[k].shape) for k in ("q", "r", "b", "lg",
                                                     "ug", "Q")}
    zero = {k: np.zeros_like(d[k]) for k in QP_FIELDS}
    jd = jdata.OcpQp(**{k: jnp.asarray(tan.get(k, zero[k]))
                        for k in QP_FIELDS})
    td = tdata.OcpQp(**{k: torch.as_tensor(tan[k]) if k in tan else None
                        for k in QP_FIELDS})
    seed_x = rng.normal(size=d["q"].shape)
    seed_u = rng.normal(size=d["r"].shape)
    frw = jax.jit(jax.vmap(jax_sens_frw))
    adj = jax.jit(jax.vmap(jax_sens_adj))
    # the solution with x, the slacks and the multipliers moved by one
    # rounding step each, up or down at random
    step = lambda a: a * (1 + np.finfo(np.float64).eps * rng.choice(
        (-1.0, 1.0), a.shape))
    moved = jsol.replace(**{k: step(getattr(jsol, k)) for k in
                            ("x", "t_lg", "t_ug", "lam_lg", "lam_ug")})
    refs = [(frw(jqp, s, jd), adj(jqp, s, jnp.asarray(seed_x),
                                  jnp.asarray(seed_u)))
            for s in (jsol, moved)]

    def check(ours, ref, ref_moved):
        ref, ref_moved = np.asarray(ref), np.asarray(ref_moved)
        spread = np.max(np.abs(ref_moved - ref), initial=0.0)
        assert np.max(np.abs(ours - ref), initial=0.0) <= max(
            REL * np.max(np.abs(ref), initial=0.0), 4 * spread, 1e-300)

    out = solve_ocp_qp_sens_frw(tqp, tsol, td)
    for o, r, m in zip(out, refs[0][0], refs[1][0]):
        check(o.numpy(), r, m)
    gout = solve_ocp_qp_sens_adj(tqp, tsol, seed_x, seed_u)
    for k in QP_FIELDS:
        check(getattr(gout, k).numpy(), getattr(refs[0][1], k),
              getattr(refs[1][1], k))
    if not active:
        for o, r in zip(out, refs[0][0]):
            _close(o.numpy(), r)
        # the adjoint is the forward map's transpose
        lhs = np.sum(seed_x * out[0].numpy()) + np.sum(seed_u *
                                                       out[1].numpy())
        rhs = sum(np.sum(getattr(gout, k).numpy() * v)
                  for k, v in tan.items())
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def _jax_reference(js):
    """Forward sensitivities to every initial-state entry and the adjoint
    seeded on u_0 (ones), one jitted call of the JAX functions."""
    form, off = js.form, js.layouts["0"].off_bx
    nbx = js.layouts["0"].nbx

    def reference(data, it):
        kf = KktFactor(form, SensOpts(), data, it)
        zero = jax.tree.map(jnp.zeros_like, data)
        dirs = []
        for i in range(nbx):
            e = zero.lb_0.at[off + i].set(1.0)
            dirs.append(zero.replace(lb_0=e, ub_0=e))
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *dirs)
        dx, du = jax.vmap(lambda d: forward_sensitivity(kf, d)[:2])(stacked)
        g = adjoint_sensitivity(kf, jnp.zeros_like(it.x),
                                jnp.zeros_like(it.u).at[0].set(1.0))
        return (jnp.moveaxis(dx, 0, -1), jnp.moveaxis(du, 0, -1),
                (g.lb_0 + g.ub_0)[off:off + nbx], g.p)

    out = jax.jit(reference)(data_to_jax(js._data, js.dtype),
                             js._iterate_jax())
    return [np.asarray(o) for o in out]


def _port_at(ocp, js):
    ts = AcadosOcpSolver(ocp, device="cpu")
    ts._iterate = {k: np.array(v) for k, v in js._iterate.items()}
    ts._default_init = False
    return ts


def _check_port(ts, ref):
    N = ts.N
    dx, du, gx0, gp = ref
    sx, su = ts.eval_solution_sensitivity(list(range(N + 1)),
                                          "initial_state")
    _close(np.stack(sx), dx)
    _close(np.stack(su)[:N], du)
    nu = ts.form.nu
    _close(ts.eval_adjoint_solution_sensitivity(
        None, [(0, np.ones(nu))], "initial_state"), gx0)
    full = ts.eval_adjoint_solution_sensitivity(None, [(0, np.ones(nu))],
                                                "all")
    _close(full.p[0].numpy(), gp)
    # forward-adjoint consistency of the port itself
    np.testing.assert_allclose(su[0].sum(axis=0), gx0, rtol=1e-9,
                               atol=1e-12)


def test_irk_pendulum_sensitivities_match_jax():
    """The pendulum with the main path's IRK, SQP, N = 8, float64."""
    from acados_tpu.models.pendulum import make_pendulum_ocp as jax_ocp
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    kw = dict(N=8, nlp_solver_type="SQP", integrator_type="IRK",
              x0=[0.0, 0.5, 0.0, 0.0])
    js = JaxSolver(jax_ocp(**kw))
    assert js.solve() == 0
    _check_port(_port_at(make_pendulum_ocp(**kw), js), _jax_reference(js))


def test_chain_sensitivities_match_jax():
    """The chain at n_mass = 5 (nx = 21), N = 6, three RTI iterations
    from the steady state moved by 0.02, float64: P_0 through chol_any,
    the dynamics Jacobians through the Kronecker IRK path."""
    from acados_tpu.models.chain_mass import make_chain_mass_ocp as jax_ocp
    from acados_tpu_torch.models.chain_mass import make_chain_mass_ocp
    (jocp, xrest), (tocp, _) = jax_ocp(n_mass=5, N=6), \
        make_chain_mass_ocp(n_mass=5, N=6)
    x0 = xrest + np.random.default_rng(3).normal(0.0, 0.02, xrest.shape)
    js = JaxSolver(jocp)
    js.set(0, "lbx", x0)
    js.set(0, "ubx", x0)
    for _ in range(3):
        js.solve()
    ts = _port_at(tocp, js)
    ts.set(0, "lbx", x0)
    ts.set(0, "ubx", x0)
    _check_port(ts, _jax_reference(js))
