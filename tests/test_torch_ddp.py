"""PyTorch port, DDP (ocp_nlp/ddp.py), against jax.vmap of the JAX
package's make_ddp_solver (float64, CPU), after tests/test_ddp.py: the
LQR exact in at most two iterations, the unconstrained pendulum swing-up
(ERK and IRK) against the JAX DDP and against the port's SQP, the
infeasible initial guess made feasible by the first rollout, the two
rejections of a constrained OCP, the IRK DDP's K1 calls worked out from
its stat table with a counting `linsolve`, and AcadosOcpSolver with
nlp_solver_type="DDP".

Held per instance as tests/test_torch_globalization.py holds the SQP:
equal status, sqp_iter, qp_iter_total, the stat table's QP columns and
its alpha column on the rows where a step was taken, iterates within
a relative gap of 1e-9.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.interface.acados_ocp import AcadosModel as JModel
from acados_tpu.interface.acados_ocp import AcadosOcp as JOcp
from acados_tpu.models.pendulum import pendulum_ode as jax_pendulum_ode
from acados_tpu.ocp_nlp.ddp import make_ddp_solver as jax_make_ddp_solver
from acados_tpu_torch import AcadosModel, AcadosOcp, AcadosOcpSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.ocp_nlp.ddp import make_ddp_solver
from acados_tpu_torch.ocp_nlp.sqp import SqpOpts, make_sqp_solver
from acados_tpu_torch.testing import ddp_pendulum_ocp
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_torch_globalization import (FIELDS, assert_same_solve,
                                      batch_data, jax_solve, port_solve,
                                      rel_gap)

torch.set_num_threads(1)

N = 10
X0_SWING = np.array([0.0, np.pi, 0.0, 0.0])
X0S = X0_SWING + np.random.default_rng(5).normal(0.0, 0.1, (3, 4))
MERIT = dict(max_iter=100, globalization="MERIT_BACKTRACKING")
# the swing-up's cost weights scaled by 1e-3, as
# tests/test_torch_globalization.py scales the SQP's: at the weights of
# tests/test_ddp.py (cost ~1e3) the backtracking's last comparisons
# c_trial < c_0, from res_stat ~5e-5 on, are between costs a few
# rounding steps apart, and which alpha passes follows the order of the
# sums, which XLA and PyTorch take differently (the two packages part in
# iteration 33-34 of 41-46 there, at the same KKT point)
WEIGHT = 1e-3


def lqr_ocp(pkg, N_=10):
    """tests/test_ddp.py's double integrator LQR."""
    cat = jnp.concatenate if pkg == "jax" else torch.cat
    ocp, m = (JOcp(), JModel()) if pkg == "jax" else (AcadosOcp(),
                                                      AcadosModel())
    m.name, m.x, m.u = "dint", 2, 1
    m.f_expl_expr = lambda x, u: cat([x[1:2], u])
    m.cost_y_expr = lambda x, u: cat([x, u])
    m.cost_y_expr_e = lambda x: x
    ocp.model = m
    ocp.solver_options.N_horizon, ocp.solver_options.tf = N_, 1.0
    ocp.cost.cost_type = ocp.cost.cost_type_e = "NONLINEAR_LS"
    ocp.cost.yref, ocp.cost.W = np.zeros(3), np.diag([1.0, 1.0, 0.1])
    ocp.cost.yref_e, ocp.cost.W_e = np.zeros(2), np.eye(2)
    ocp.constraints.x0 = np.array([1.0, 0.0])
    ocp.solver_options.dtype = "float64"
    return ocp


def pendulum_ocp(pkg, integrator="ERK", N_=N, weight=WEIGHT):
    """tests/test_ddp.py's unconstrained pendulum swing-up (2 substeps of
    ERK or of the main path's IRK), its cost weights scaled by `weight`:
    the port's acados_tpu_torch.testing.ddp_pendulum_ocp, and the same
    OCP in the JAX package."""
    if pkg == "torch":
        return ddp_pendulum_ocp(N_, "float64", integrator, weight)
    ocp, m = JOcp(), JModel()
    m.name, m.x, m.u = "pend", 4, 1
    m.f_expl_expr = lambda x, u: jax_pendulum_ode(x, u, None, 0.0)
    m.cost_y_expr = lambda x, u: jnp.concatenate([x, u])
    m.cost_y_expr_e = lambda x: x
    ocp.model = m
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N_, 1.0, "float64"
    so.sim_method_num_steps = 2
    so.integrator_type = integrator
    Q = 2 * np.diag([1e3, 1e3, 1e-2, 1e-2])
    W = np.zeros((5, 5))
    W[:4, :4] = Q
    W[4, 4] = 2.0
    ocp.cost.cost_type = ocp.cost.cost_type_e = "NONLINEAR_LS"
    ocp.cost.yref, ocp.cost.W = np.zeros(5), weight * W
    ocp.cost.yref_e, ocp.cost.W_e = np.zeros(4), weight * Q
    ocp.constraints.x0 = X0_SWING
    return ocp


def both(make_ocp, x0s, opts=MERIT, init=None, **kw):
    """The JAX DDP (vmapped) and the port's DDP on the same batch."""
    data, init, it_ref, st_ref = jax_solve(
        make_ocp("jax", **kw), x0s, opts_update=opts, init=init,
        make=jax_make_ddp_solver)
    it, st = port_solve(make_ocp("torch", **kw), data, init,
                        opts_update=opts, make=make_ddp_solver)
    return data, init, it, st, it_ref, st_ref


def test_lqr_exact_in_two_iterations():
    """On an LQ problem one backward/forward sweep is the solution."""
    x0s = np.array([[1.0, 0.0], [0.5, -0.3], [-1.0, 0.4]])
    _, _, it, st, it_ref, st_ref = both(lqr_ocp, x0s,
                                        opts=dict(max_iter=30))
    assert_same_solve(it, st, it_ref, st_ref, "LQR DDP")
    assert np.all(st["status"] == 0) and np.all(st["sqp_iter"] <= 2)
    assert np.all(st["res_stat"] < 1e-8)


@pytest.fixture(scope="module")
def swingup():
    return both(pendulum_ocp, X0S)


def test_swingup_matches_jax(swingup):
    _, _, it, st, it_ref, st_ref = swingup
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    assert_same_solve(it, st, it_ref, st_ref, "swing-up DDP")
    # several backtracking steps were compared
    alpha = np.concatenate([st["stat"][b, :n, 6]
                            for b, n in enumerate(st["sqp_iter"])])
    assert np.any(alpha < 1), alpha


def test_swingup_matches_sqp(swingup):
    """The port's DDP and SQP stop at the same KKT point, at the cost
    weights of tests/test_ddp.py (its check, within 1e-6)."""
    data, init = swingup[:2]
    ocp = pendulum_ocp("torch", weight=1.0)
    data = batch_data(build_ocp(ocp)[1], X0S, 4)
    it, st = port_solve(ocp, data, init, opts_update=MERIT,
                        make=make_ddp_solver)
    it_s, st_s = port_solve(ocp, data, init, opts_update=MERIT,
                            make=make_sqp_solver)
    assert np.all(st["status"] == 0) and np.all(st_s["status"] == 0)
    np.testing.assert_allclose(it["x"], it_s["x"], atol=1e-6)
    np.testing.assert_allclose(it["u"], it_s["u"], atol=1e-6)


def test_infeasible_init_made_feasible():
    """From the zero trajectory (x0 on its target only through the
    bounds) the first rollout makes the iterate dynamically feasible and
    puts x0 on its target; every later iterate stays feasible."""
    form = build_ocp(pendulum_ocp("torch"))[0]
    B = len(X0S)
    zero = dict(x=np.zeros((B, N + 1, 4)), u=np.zeros((B, N, 1)),
                pi=np.zeros((B, N, 4)), lam_l=np.zeros((B, N + 1, form.nc)),
                lam_u=np.zeros((B, N + 1, form.nc)),
                sl=np.zeros((B, N + 1, form.nc)),
                su=np.zeros((B, N + 1, form.nc)))
    _, _, it, st, it_ref, st_ref = both(pendulum_ocp, X0S, init=zero)
    assert_same_solve(it, st, it_ref, st_ref, "infeasible init DDP")
    assert np.all(st["status"] == 0)
    # rows 1.. of the stat table's res_eq: after the first rollout
    for b, n in enumerate(st["sqp_iter"]):
        assert np.all(st["stat"][b, 1:n + 1, 1] < 1e-10)
    np.testing.assert_allclose(it["x"][:, 0], X0S, atol=1e-12)


def test_cycling_instances_match_jax():
    """At N = 20 and the weights of tests/test_ddp.py, from chip_smoke.py's
    main-path x0s [0, pi, 0, 0] + N(0, 0.05) (seed 0) and at its float32
    tolerances, DDP converges from the first and cycles to max_iter (40
    here) from the fourth (the two swing-up directions alternate), in
    both packages alike: the same statuses and iterations, the converged
    instance's iterate within 1e-9 (chip_smoke.py's phase 29 runs the
    whole batch, where about 4 in 10 instances cycle)."""
    import chip_smoke
    x0s = (np.asarray(chip_smoke.X0_CENTER) + np.random.default_rng(
        chip_smoke.SEED).normal(0.0, chip_smoke.X0_SIGMA, (4, 4)))[[0, 3]]
    opts = dict(MERIT, max_iter=40, tol_stat=2e-3, tol_eq=1e-4,
                tol_ineq=1e-4, tol_comp=1e-3)
    _, _, it, st, it_ref, st_ref = both(pendulum_ocp, x0s, opts=opts,
                                        N_=20, weight=1.0)
    np.testing.assert_array_equal(st_ref["status"], [0, 2])
    np.testing.assert_array_equal(st["status"], st_ref["status"])
    np.testing.assert_array_equal(st["sqp_iter"], st_ref["sqp_iter"])
    for f in FIELDS:
        assert rel_gap(it[f][0], it_ref[f][0]) <= 1e-9, f


def test_rejects_constrained():
    """The JAX package's two ValueErrors, word for word."""
    ocp = pendulum_ocp("torch")
    ocp.constraints.lbu, ocp.constraints.ubu = np.array([-80.0]), \
        np.array([80.0])
    ocp.constraints.idxbu = np.array([0])
    with pytest.raises(ValueError, match="unconstrained OCPs only"):
        make_ddp_solver(build_ocp(ocp)[0], SqpOpts())
    ocp = pendulum_ocp("torch")
    ocp.constraints.x0 = None
    ocp.constraints.idxbx_0 = np.array([0, 1])
    ocp.constraints.lbx_0 = ocp.constraints.ubx_0 = np.zeros(2)
    with pytest.raises(ValueError, match="full initial-state constraint"):
        make_ddp_solver(build_ocp(ocp)[0], SqpOpts())


def test_irk_ddp_k1_count(monkeypatch):
    """The IRK DDP (the main path's IRK, 2 substeps) at N = 3, cut at 4
    iterations, against the JAX DDP, and its K1 calls (a counting `linsolve` on the CPU) against
    chip_smoke.py's ddp_k1_expected, which works them out from the stat
    table (phase 29 holds the card's launches to it)."""
    import chip_smoke
    from test_torch_exact_hessian import _counting

    N_, cut = 3, dict(MERIT, max_iter=4)
    data, init, it_ref, st_ref = jax_solve(
        pendulum_ocp("jax", "IRK", N_), X0S[:2], opts_update=cut,
        make=jax_make_ddp_solver)
    form = build_ocp(pendulum_ocp("torch", "IRK", N_))[0]
    opts = SqpOpts(**cut)
    calls = _counting(monkeypatch)
    it, st = make_ddp_solver(form, opts)(
        data_to_torch(data, torch.float64, "cpu"),
        iterate_from_numpy(init, torch.float64, "cpu"))
    assert_same_solve({f: getattr(it, f).numpy() for f in FIELDS},
                      {f: getattr(st, f).numpy() for f in (
                          "status", "sqp_iter", "qp_iter_total", "stat")},
                      it_ref, st_ref, "IRK DDP")
    assert np.any(st.stat[:, :, 6].numpy() < 1)
    assert len(calls) == chip_smoke.ddp_k1_expected(st, opts, N_)


def test_acados_ocp_solver_ddp():
    """nlp_solver_type="DDP" through AcadosOcpSolver: the first instance
    of the swing-up batch as the JAX DDP solves it."""
    ocp = pendulum_ocp("torch")
    so = ocp.solver_options
    so.nlp_solver_type = "DDP"
    so.globalization = "MERIT_BACKTRACKING"
    so.nlp_solver_max_iter = 100
    solver = AcadosOcpSolver(ocp, device="cpu")
    solver.constraints_set(0, "lbx", X0S[0])
    solver.constraints_set(0, "ubx", X0S[0])
    for k in range(N + 1):
        solver.set(k, "x", X0S[0])
    data, init, it_ref, st_ref = jax_solve(
        pendulum_ocp("jax"), X0S[:1], opts_update=dict(
            max_iter=100, globalization="MERIT_BACKTRACKING"),
        make=jax_make_ddp_solver)
    assert solver.solve() == st_ref["status"][0] == 0
    assert solver.get_stats("sqp_iter") == st_ref["sqp_iter"][0]
    for k in range(N):
        assert rel_gap(solver.get(k, "u"), it_ref["u"][0, k]) <= 1e-9
