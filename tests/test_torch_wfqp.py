"""PyTorch port, SQP with feasible QPs (ocp_nlp/wfqp.py), against
jax.vmap of the JAX package's make_wfqp_solver (float64, CPU), after
tests/test_wfqp.py: the obstacle rescue (a linearization at the zero
iterate whose obstacle row 0 >= 1 has a zero gradient: plain SQP fails
in both packages with the same status, WFQP converges in both), the
feasible pendulum where WFQP follows SQP, the interface dispatch, and
the IRK WFQP's K1 calls against chip_smoke.py's count from its stat
table.

Held per instance as tests/test_torch_globalization.py holds the SQP:
equal status, sqp_iter, qp_iter_total (both QPs' iterations), the stat
table's QP columns and its alpha column on the rows where a step was
taken, iterates within a relative gap of 1e-9.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.interface.acados_ocp import AcadosModel as JModel
from acados_tpu.interface.acados_ocp import AcadosOcp as JOcp
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_nlp.sqp import make_sqp_solver as jax_make_sqp_solver
from acados_tpu.ocp_nlp.wfqp import make_wfqp_solver as jax_make_wfqp_solver
from acados_tpu_torch import AcadosOcpSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.interface.solver import _sqp_opts_from
from acados_tpu_torch.ocp_nlp.wfqp import make_wfqp_solver
from acados_tpu_torch.testing import obstacle_ocp as port_obstacle_ocp
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_torch_globalization import (FIELDS, assert_same_solve, jax_solve,
                                      port_solve, rel_gap)

torch.set_num_threads(1)

N_OBS = 10
X0_OBS = np.array([-2.0, 0.01])
X0S_OBS = X0_OBS + np.random.default_rng(6).normal(0.0, 0.01, (3, 2))
MERIT = dict(max_iter=100, globalization="MERIT_BACKTRACKING")


def obstacle_ocp(pkg, rows="h", N_=N_OBS):
    """tests/test_wfqp.py's point mass from (-2, 0.01) to (2, 0) outside
    the unit disc, ||x||^2 >= 1 on the path and at the end: as BGH h rows
    (rows="h") or as BGP rows phi(r) = r1^2 + r2^2 with r = x
    (rows="bgp", tests/test_formulations.py:35-74), the same NLP: the
    port's acados_tpu_torch.testing.obstacle_ocp, and the same OCP in the
    JAX package."""
    if pkg == "torch":
        return port_obstacle_ocp(rows, N_)
    ocp, m = JOcp(), JModel()
    goal = jnp.array([2.0, 0.0])
    m.name, m.x, m.u = "pt", 2, 2
    m.f_expl_expr = lambda x, u: u
    m.cost_y_expr = lambda x, u: jnp.concatenate([x - goal, 0.3 * u])
    m.cost_y_expr_e = lambda x: x - goal
    ocp.model = m
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N_, 4.0, "float64"
    ocp.cost.cost_type = ocp.cost.cost_type_e = "NONLINEAR_LS"
    ocp.cost.yref, ocp.cost.W = np.zeros(4), np.eye(4)
    ocp.cost.yref_e, ocp.cost.W_e = np.zeros(2), 10 * np.eye(2)
    ocp.constraints.x0 = X0_OBS
    c = ocp.constraints
    if rows == "bgp":
        m.con_phi_expr = lambda r: jnp.stack([r[0] ** 2 + r[1] ** 2])
        m.con_r_expr = lambda x, u: x
        m.con_phi_expr_e = m.con_phi_expr
        m.con_r_expr_e = lambda x: x
        c.lphi, c.uphi = np.array([1.0]), np.array([1e10])
        c.lphi_e, c.uphi_e = np.array([1.0]), np.array([1e10])
    else:
        m.con_h_expr = lambda x, u: jnp.stack([x[0] ** 2 + x[1] ** 2])
        m.con_h_expr_e = lambda x: jnp.stack([x[0] ** 2 + x[1] ** 2])
        c.lh, c.uh = np.array([1.0]), np.array([1e10])
        c.lh_e, c.uh_e = np.array([1.0]), np.array([1e10])
    return ocp


def zero_init(form, B):
    """The zero iterate of tests/test_wfqp.py (init_iterate): x = 0 on
    every stage, where the obstacle rows' gradient vanishes."""
    N_, nx, nu, nc = form.N, form.nx, form.nu, form.nc
    z = lambda *s: np.zeros((B,) + s)
    return dict(x=z(N_ + 1, nx), u=z(N_, nu), pi=z(N_, nx),
                lam_l=z(N_ + 1, nc), lam_u=z(N_ + 1, nc), sl=z(N_ + 1, nc),
                su=z(N_ + 1, nc))


def wfqp_both(make_ocp, x0s, init=None, opts=MERIT, **kw):
    """The JAX WFQP (vmapped) and the port's WFQP on the same batch."""
    if init == "zero":
        init = zero_init(build_ocp(make_ocp("torch", **kw))[0], len(x0s))
    data, init, it_ref, st_ref = jax_solve(
        make_ocp("jax", **kw), x0s, opts_update=opts, init=init,
        make=jax_make_wfqp_solver)
    it, st = port_solve(make_ocp("torch", **kw), data, init,
                        opts_update=opts, make=make_wfqp_solver)
    return data, init, it, st, it_ref, st_ref


@pytest.fixture(scope="module")
def rescue():
    return wfqp_both(obstacle_ocp, X0S_OBS, init="zero")


def test_obstacle_rescue(rescue):
    """Plain SQP fails from the zero iterate in both packages with the
    same statuses; WFQP converges in both, the same way, to the goal
    with every node outside the disc (the first on its boundary: the
    nodes, which alone are constrained, step across)."""
    data, init, it, st, it_ref, st_ref = rescue
    _, _, _, sq_ref = jax_solve(obstacle_ocp("jax"), X0S_OBS,
                                opts_update=MERIT, init=init,
                                make=jax_make_sqp_solver)
    _, sq = port_solve(obstacle_ocp("torch"), data, init, opts_update=MERIT)
    assert np.all(sq_ref["status"] != 0), sq_ref["status"]
    np.testing.assert_array_equal(sq["status"], sq_ref["status"])
    np.testing.assert_array_equal(sq["sqp_iter"], sq_ref["sqp_iter"])

    assert np.all(st_ref["status"] == 0), st_ref["status"]
    assert_same_solve(it, st, it_ref, st_ref, "obstacle WFQP")
    assert np.all(st["res_stat"] < 1e-6)
    assert np.all(np.sum(it["x"] ** 2, axis=-1) >= 1.0 - 1e-8)
    np.testing.assert_allclose(it["x"][:, -1], np.tile([2.0, 0.0], (3, 1)),
                               atol=1e-2)


def test_feasible_pendulum_matches_sqp():
    """Every QP feasible: the feasibility slacks solve to zero and the
    relaxed bounds are the nominal ones, so WFQP matches the JAX WFQP and
    takes the port's SQP's iterations to the same KKT point (within the
    NLP tolerance's reach: the two line searches differ, as in the JAX
    package, whose WFQP and SQP part by 5e-7 here)."""
    x0s = np.array([0.0, np.pi, 0.0, 0.0]) + np.random.default_rng(
        7).normal(0.0, 0.05, (3, 4))
    mk = lambda pkg: _scaled((jax_pendulum_ocp if pkg == "jax" else
                              make_pendulum_ocp)(N=8, dtype="float64"))
    data, init, it, st, it_ref, st_ref = wfqp_both(mk, x0s)
    assert np.all(st_ref["status"] == 0)
    assert_same_solve(it, st, it_ref, st_ref, "pendulum WFQP")
    it_s, st_s = port_solve(mk("torch"), data, init, opts_update=MERIT)
    np.testing.assert_array_equal(st_s["status"], st["status"])
    np.testing.assert_array_equal(st_s["sqp_iter"], st["sqp_iter"])
    np.testing.assert_allclose(it["x"], it_s["x"], atol=1e-6)


def _scaled(ocp, weight=1e-3):
    """The pendulum's cost weights scaled by 1e-3, as the line-search
    tests of tests/test_torch_globalization.py run it (there the reason:
    at the pendulum's own weights the merit's last comparisons are at
    rounding level)."""
    ocp.cost.W = weight * np.asarray(ocp.cost.W)
    ocp.cost.W_e = weight * np.asarray(ocp.cost.W_e)
    return ocp


def test_interface_dispatch(rescue):
    """nlp_solver_type="SQP_WITH_FEASIBLE_QP" through AcadosOcpSolver (the
    first instance) and AcadosOcpBatchSolver (the batch), each from the
    zero iterate, against the vmapped JAX WFQP of the rescue."""
    from acados_tpu_torch import AcadosOcpBatchSolver

    data, init, _, _, it_ref, st_ref = rescue
    ocp = obstacle_ocp("torch")
    single = AcadosOcpSolver(ocp, device="cpu")
    single.constraints_set(0, "lbx", X0S_OBS[0])
    single.constraints_set(0, "ubx", X0S_OBS[0])
    for k in range(N_OBS + 1):
        single.set(k, "x", np.zeros(2))
    assert single.solve() == st_ref["status"][0] == 0
    assert single.get_stats("sqp_iter") == st_ref["sqp_iter"][0]
    assert single.get_stats("qp_iter") == st_ref["qp_iter_total"][0]
    for k in range(N_OBS):
        assert rel_gap(single.get(k, "u"), it_ref["u"][0, k]) <= 1e-9

    batch = AcadosOcpBatchSolver(obstacle_ocp("torch"), len(X0S_OBS),
                                 device="cpu")
    batch._data = {k: v.copy() for k, v in data.items()}
    batch._iterate = {k: v.copy() for k, v in init.items()}
    status = batch.solve()
    np.testing.assert_array_equal(status, st_ref["status"])
    np.testing.assert_array_equal(batch.get_stats("qp_iter"),
                                  st_ref["qp_iter_total"])
    assert rel_gap(batch._it_dev.x.numpy(), it_ref["x"]) <= 1e-9


def test_irk_wfqp_k1_count(monkeypatch):
    """make_pendulum_ocp(nlp_solver_type="SQP_WITH_FEASIBLE_QP",
    integrator_type="IRK") with MERIT at N = 4 (chip_smoke.py's phase
    30 at the main path's width) against the JAX WFQP, and its K1 calls
    (a counting `linsolve` on the CPU) against chip_smoke.py's
    wfqp_k1_expected from its stat table."""
    import chip_smoke
    from test_torch_exact_hessian import _counting

    x0s = np.array([0.0, np.pi, 0.0, 0.0]) + np.random.default_rng(
        8).normal(0.0, 0.05, (2, 4))
    mk = lambda f: _scaled(f(N=4, dtype="float64", integrator_type="IRK",
                             nlp_solver_type="SQP_WITH_FEASIBLE_QP"))
    opts_update = dict(max_iter=50, globalization="MERIT_BACKTRACKING")
    data, init, it_ref, st_ref = jax_solve(
        mk(jax_pendulum_ocp), x0s, opts_update=opts_update,
        make=jax_make_wfqp_solver)
    form = build_ocp(mk(make_pendulum_ocp))[0]
    opts = _sqp_opts_from(mk(make_pendulum_ocp)).replace(**opts_update)
    calls = _counting(monkeypatch)
    solve = make_wfqp_solver(form, opts)
    it, st = solve(data_to_torch(data, torch.float64, "cpu"),
                   iterate_from_numpy(init, torch.float64, "cpu"))
    assert_same_solve({f: getattr(it, f).numpy() for f in FIELDS},
                      {f: getattr(st, f).numpy() for f in (
                          "status", "sqp_iter", "qp_iter_total", "stat")},
                      it_ref, st_ref, "IRK WFQP")
    assert np.all(st.status.numpy() == 0)
    assert np.all(st.feas_qp_iter.numpy() > 0)
    assert np.all(st.feas_qp_iter.numpy() < st.qp_iter_total.numpy())
    assert len(calls) == chip_smoke.wfqp_k1_expected(st, opts)
