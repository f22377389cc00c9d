"""PyTorch port, the slice as a whole: the canonical pendulum IRK SQP-RTI
batch (make_pendulum_ocp(integrator_type="IRK"), 4 Gauss-Legendre
stages, 2 substeps) through the port's AcadosOcpBatchSolver on the CPU,
against the JAX package's batched solve as bench.py builds it
(bench._build_rti: per-instance x0 perturbed from a seed, lbx/ubx at
stage 0, x trajectory initialised at x0).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.interface.builder import data_to_jax
from acados_tpu.interface.solver import AcadosOcpSolver as JaxOcpSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_nlp import linearize as jlin
from acados_tpu.ocp_nlp.sqp import init_iterate as jax_init_iterate
from acados_tpu_torch import AcadosOcpBatchSolver, AcadosOcpSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.interface.solver import _sqp_opts_from
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp import linearize as tlin
from acados_tpu_torch.ocp_nlp.linearize import build_static_rows
from acados_tpu_torch.ocp_nlp.sqp import init_iterate, make_sqp_solver
from acados_tpu_torch.ocp_qp import xcond
from acados_tpu_torch.testing import rti_batch
from acados_tpu_torch.utils.convert import iterate_from_numpy

torch.set_num_threads(1)

X0 = [0.0, np.pi, 0.0, 0.0]
SIGMA = 0.05
N = 20


def _full_cond(make_ocp):
    """make_ocp with solver_options.qp_solver = "FULL_CONDENSING_HPIPM"."""
    def make(**kw):
        ocp = make_ocp(**kw)
        ocp.solver_options.qp_solver = "FULL_CONDENSING_HPIPM"
        return ocp
    return make


def _port_batch(data_lb_0, make_ocp=make_pendulum_ocp, **ocp_kw):
    """Port batch solver with the x0s of the JAX data set through the
    per-instance views, as a user would."""
    return rti_batch(make_ocp(**ocp_kw), np.asarray(data_lb_0)[:, :4],
                     "cpu")


def _traj(solver, field, n):
    return np.stack([np.stack([v.get(k, field) for k in range(n)])
                     for v in solver.ocp_solvers])


def _assert_calls_agree(it, stats, solver, status):
    np.testing.assert_array_equal(status, np.asarray(stats.status))
    np.testing.assert_array_equal(solver.get_stats("sqp_iter"),
                                  np.asarray(stats.sqp_iter))
    np.testing.assert_array_equal(solver.get_stats("qp_iter"),
                                  np.asarray(stats.qp_iter_total))
    for field, n in (("x", N + 1), ("u", N), ("pi", N)):
        ref = np.asarray(getattr(it, field))
        got = _traj(solver, field, n)
        assert np.all(np.abs(got - ref) <= 1e-9 * (1 + np.abs(ref))), field


@pytest.mark.parametrize("kind,calls", [("SQP_RTI", 3), ("SQP", 1)])
def test_irk_batch_matches_jax_float64(kind, calls):
    kw = dict(N=N, dtype="float64", nlp_solver_type=kind,
              integrator_type="IRK")
    solve_batch, data, it, _, _, _ = bench._build_rti(
        jax_pendulum_ocp, X0, SIGMA, 8, jnp.float64, seed=0, **kw)
    solver = _port_batch(data.lb_0, **kw)
    for _ in range(calls):
        it_prev = it
        it, stats = solve_batch(data, it)
        status = solver.solve()
        _assert_calls_agree(it, stats, solver, status)
    assert np.all(status == 0)
    # the JAX package's data and warm start, carried across as numpy,
    # give the port's solve function the same last call
    data_np = {f.name: np.asarray(getattr(data, f.name))
               for f in dataclasses.fields(data)}
    port_solve = make_sqp_solver(build_ocp(make_pendulum_ocp(**kw))[0],
                                 _sqp_opts_from(make_pendulum_ocp(**kw)))
    it_t, stats_t = port_solve(
        data_to_torch(data_np, torch.float64, "cpu"),
        iterate_from_numpy(it_prev, torch.float64, "cpu"))
    np.testing.assert_array_equal(stats_t.qp_iter_total.numpy(),
                                  np.asarray(stats.qp_iter_total))
    for field in ("x", "u", "pi", "lam_l", "lam_u"):
        ref = np.asarray(getattr(it, field))
        got = getattr(it_t, field).numpy()
        assert np.all(np.abs(got - ref) <= 1e-9 * (1 + np.abs(ref))), field


def test_irk_rti_float32_batch_in_tolerance():
    """B = 64 in float32, the production precision: every instance passes
    bench.py's in_tolerance gate at the pendulum's float32 tolerances
    once the warm RTI loop has settled (this exercises the
    float32-only stall exit of the IPM)."""
    kw = dict(N=N, dtype="float32", nlp_solver_type="SQP_RTI",
              integrator_type="IRK")
    rng = np.random.default_rng(0)
    x0s = np.asarray(X0) + rng.normal(0.0, SIGMA, (64, 4))
    solver = _port_batch(np.pad(x0s, ((0, 0), (0, 1))), **kw)
    for _ in range(10):
        assert np.all(solver.solve() == 0)
    res = solver.get_stats("residuals")
    gate = _f32_gate(solver, type("Stats", (), dict(
        res_stat=res[:, 0], res_eq=res[:, 1], res_ineq=res[:, 2],
        res_comp=res[:, 3])))
    assert gate["in_tolerance"], gate
    assert gate["n_in_tol_stat"] == 64


def _f32_gate(solver, stats):
    """bench.py's in_tolerance gate at the configuration's tolerances."""
    so = solver.acados_ocp.solver_options
    return bench._residual_fields(stats, dict(
        tol_stat=so.nlp_solver_tol_stat, tol_eq=so.nlp_solver_tol_eq,
        tol_ineq=so.nlp_solver_tol_ineq, tol_comp=so.nlp_solver_tol_comp))


def test_irk_rti_float32_plateau_matches_jax():
    """Float32, B = 32, the same x0s through both packages: the warm RTI
    loop settles (by call 8) on a largest res_stat just under the 2e-3
    tolerance in both. Float32 rounding moves the IPM's stall exit, so
    per-instance qp_iter may differ here; what must hold is that every
    status is 0 in both, both pass the gate, and the port's plateau is
    within 5 % of the reference's (measured 0.65 %)."""
    kw = dict(N=N, dtype="float32", nlp_solver_type="SQP_RTI",
              integrator_type="IRK")
    solve_batch, data, it, _, _, _ = bench._build_rti(
        jax_pendulum_ocp, X0, SIGMA, 32, jnp.float32, seed=0, **kw)
    solver = _port_batch(data.lb_0, **kw)
    for _ in range(10):
        it, stats = solve_batch(data, it)
        assert np.all(np.asarray(stats.status) == 0)
        assert np.all(solver.solve() == 0)
    res = solver.get_stats("residuals")
    ours = _f32_gate(solver, type("Stats", (), dict(
        res_stat=res[:, 0], res_eq=res[:, 1], res_ineq=res[:, 2],
        res_comp=res[:, 3])))
    ref = _f32_gate(solver, stats)
    assert ours["in_tolerance"] and ref["in_tolerance"], (ours, ref)
    plateau, ref_plateau = res[:, 0].max(), np.asarray(stats.res_stat).max()
    assert abs(plateau - ref_plateau) <= 0.05 * ref_plateau, (plateau,
                                                              ref_plateau)


def test_single_solver_matches_jax_float64():
    """AcadosOcpSolver (one instance, ERK, SQP to tolerance) against the
    JAX package's AcadosOcpSolver: trajectory, stats and residuals."""
    ours = AcadosOcpSolver(make_pendulum_ocp(N=N, dtype="float64"),
                           device="cpu")
    ref = JaxOcpSolver(jax_pendulum_ocp(N=N, dtype="float64"))
    assert ours.solve() == ref.solve() == 0
    assert ours.get_status() == 0
    for field in ("sqp_iter", "qp_iter"):
        assert ours.get_stats(field) == ref.get_stats(field)
    np.testing.assert_allclose(ours.get_stats("residuals"),
                               ref.get_stats("residuals"), rtol=1e-6,
                               atol=1e-12)
    _assert_stages_agree(ours, ref, ("x", "u", "pi"))
    assert ours.get_stats("time_tot") > 0


def _assert_stages_agree(ours, ref, fields):
    for k in range(N + 1):
        for field in fields if k < N else ("x",):
            a, b = ours.get(k, field), ref.get(k, field)
            assert np.all(np.abs(a - b) <= 1e-9 * (1 + np.abs(b))), (k, field)


def _with_bgh_rows(ocp, h):
    """General linear rows (cart position), a nonlinear h row and soft
    slacks on it: the BGH row kinds the pendulum itself does not use."""
    c = ocp.constraints
    c.C, c.D = np.array([[1.0, 0.0, 0.0, 0.0]]), np.array([[0.0]])
    c.lg, c.ug = np.array([-2.0]), np.array([2.0])
    ocp.model.con_h_expr = h
    c.lh, c.uh = np.array([-1.0]), np.array([1.0])
    c.idxsh = np.array([0])
    ocp.cost.Zl = ocp.cost.Zu = np.array([100.0])
    ocp.cost.zl = ocp.cost.zu = np.array([10.0])
    return ocp


def test_bgh_rows_and_soft_slacks_match_jax_float64():
    ours = AcadosOcpSolver(_with_bgh_rows(
        make_pendulum_ocp(N=N, dtype="float64"),
        lambda x, u: torch.stack([x[2] + 0.1 * torch.sin(x[1])])),
        device="cpu")
    ref = JaxOcpSolver(_with_bgh_rows(
        jax_pendulum_ocp(N=N, dtype="float64"),
        lambda x, u: jnp.stack([x[2] + 0.1 * jnp.sin(x[1])])))
    assert ours.solve() == ref.solve() == 0
    for field in ("sqp_iter", "qp_iter"):
        assert ours.get_stats(field) == ref.get_stats(field)
    assert max(np.max(ref.get(k, "sl")) + np.max(ref.get(k, "su"))
               for k in range(N)) > 1e-3   # the soft row is violated
    _assert_stages_agree(ours, ref, ("x", "u", "pi", "sl", "su", "lam"))


def test_nlp_evaluators_match_jax_float64():
    """build_ocp's data dict, init_iterate, eval_constraints, eval_cost
    (with soft slacks) and eval_dyn_gap (the IRK forward step) against the
    JAX package's, vmapped over a seeded batch of trajectories, on the
    pendulum IRK config with BGH rows."""
    kw = dict(N=N, dtype="float64", integrator_type="IRK")
    jform, jdata_np, _ = jax_build_ocp(_with_bgh_rows(
        jax_pendulum_ocp(**kw),
        lambda x, u: jnp.stack([x[2] + 0.1 * jnp.sin(x[1])])))
    tform, data_np, _ = build_ocp(_with_bgh_rows(
        make_pendulum_ocp(**kw),
        lambda x, u: torch.stack([x[2] + 0.1 * torch.sin(x[1])])))
    assert data_np.keys() == jdata_np.keys()
    for k in data_np:
        np.testing.assert_array_equal(data_np[k], np.asarray(jdata_np[k]),
                                      err_msg=k)

    B, nc = 6, tform.nc
    rng = np.random.default_rng(7)
    x = np.asarray(X0) + 0.3 * rng.normal(size=(B, N + 1, 4))
    u = 10.0 * rng.normal(size=(B, N, 1))
    sl, su = np.abs(rng.normal(size=(2, B, N + 1, nc)))
    rows = build_static_rows(tform, torch.float64, "cpu")
    soft = (rows["soft"] * rows["mask"]).numpy()
    assert soft.sum() > 0

    jd = data_to_jax(jdata_np, jnp.float64)
    td = data_to_torch(data_np, torch.float64, "cpu", batch=B)
    tx, tu, tsl, tsu = (torch.as_tensor(a) for a in (x, u, sl, su))
    pairs = [
        (tlin.eval_constraints(tform, td, tx, tu),
         jax.vmap(lambda a, b: jlin.eval_constraints(jform, jd, a, b))(x, u)),
        (tlin.eval_cost(tform, td, tx, tu, tsl, tsu, torch.as_tensor(soft)),
         jax.vmap(lambda a, b, c, d: jlin.eval_cost(
             jform, jd, a, b, c, d, jnp.asarray(soft)))(x, u, sl, su)),
        (tlin.eval_dyn_gap(tform, td, tx, tu),
         jax.vmap(lambda a, b: jlin.eval_dyn_gap(jform, jd, a, b))(x, u)),
    ]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.all(np.abs(got.numpy() - ref) <= 1e-11 * (1 + np.abs(ref)))

    it = init_iterate(tform, batch=B, dtype=torch.float64, device="cpu",
                      x_traj=x[0], u_traj=u[0])
    jit_ = jax_init_iterate(jform, jnp.float64, x_traj=x[0], u_traj=u[0])
    for f in dataclasses.fields(it):
        ref = np.broadcast_to(np.asarray(getattr(jit_, f.name)),
                              getattr(it, f.name).shape)
        np.testing.assert_array_equal(getattr(it, f.name).numpy(), ref)


def test_readme_quickstart():
    """The README quickstart with acados_tpu_torch in place of
    acados_tpu (on the CPU here)."""
    solver = AcadosOcpSolver(make_pendulum_ocp(dtype="float32"),
                             device="cpu")
    assert solver.solve() == 0
    u0 = solver.get(0, "u")
    assert u0.shape == (1,) and np.all(np.isfinite(u0))
    assert abs(u0[0]) <= 80.0 + 1e-3


def test_solver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AcadosOcpSolver(make_pendulum_ocp())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AcadosOcpBatchSolver(make_pendulum_ocp(), 2)


@pytest.mark.parametrize("kind,calls", [("SQP_RTI", 3), ("SQP", 1)])
def test_full_condensing_irk_batch_matches_jax_float64(kind, calls):
    """The slice as a whole: the canonical pendulum IRK with
    qp_solver = "FULL_CONDENSING_HPIPM" (full condensing, then the dense
    IPM, whose barrier Hessian goes through chol_any), B = 8, against the
    JAX package's batched solve: equal statuses, sqp_iter and qp_iter per
    instance, x, u and pi within 1e-9. The x0 rows' multipliers are
    ill-determined on this path (ROADMAP Queue 3 watch-list) and are not
    compared."""
    kw = dict(N=N, dtype="float64", nlp_solver_type=kind,
              integrator_type="IRK")
    solve_batch, data, it, _, _, opts = bench._build_rti(
        _full_cond(jax_pendulum_ocp), X0, SIGMA, 8, jnp.float64, seed=0,
        **kw)
    assert opts.full_cond and opts.cond_N is None
    solver = _port_batch(data.lb_0, _full_cond(make_pendulum_ocp), **kw)
    assert solver.opts.full_cond and solver.opts.cond_N is None
    for _ in range(calls):
        it, stats = solve_batch(data, it)
        status = solver.solve()
        _assert_calls_agree(it, stats, solver, status)
    assert np.all(status == 0)


def test_full_condensing_float32_plateau_matches_jax():
    """Float32, B = 32, full condensing, the same x0s through both
    packages: both settle (by call 9) on the same largest res_stat,
    1.8311e-3 against the 2e-3 tolerance, with every status 0. The port's
    plateau must be within 5 % of the reference's."""
    kw = dict(N=N, dtype="float32", nlp_solver_type="SQP_RTI",
              integrator_type="IRK")
    solve_batch, data, it, _, _, _ = bench._build_rti(
        _full_cond(jax_pendulum_ocp), X0, SIGMA, 32, jnp.float32, seed=0,
        **kw)
    solver = _port_batch(data.lb_0, _full_cond(make_pendulum_ocp), **kw)
    for _ in range(11):
        it, stats = solve_batch(data, it)
        assert np.all(np.asarray(stats.status) == 0)
        assert np.all(solver.solve() == 0)
    res = solver.get_stats("residuals")
    ours = _f32_gate(solver, type("Stats", (), dict(
        res_stat=res[:, 0], res_eq=res[:, 1], res_ineq=res[:, 2],
        res_comp=res[:, 3])))
    ref = _f32_gate(solver, stats)
    assert ours["in_tolerance"] and ref["in_tolerance"], (ours, ref)
    plateau, ref_plateau = res[:, 0].max(), np.asarray(stats.res_stat).max()
    assert abs(plateau - ref_plateau) <= 0.05 * ref_plateau, (plateau,
                                                              ref_plateau)


def test_cond_N_mapping(monkeypatch):
    """qp_solver_cond_N as the JAX interface maps it: cond_N = N is
    HPIPM's "no condensing" and solves like the default, with the JAX
    package's iterates; a FULL_CONDENSING_* qp_solver ignores cond_N and
    runs the dense IPM; a cond_N < N is partial condensing, which solves
    like the JAX package's (equal iteration counts, iterates within
    1e-9)."""
    def with_cond(make_ocp, cond_N, full=False):
        ocp = (_full_cond(make_ocp) if full else make_ocp)(N=N,
                                                           dtype="float64")
        ocp.solver_options.qp_solver_cond_N = cond_N
        return ocp

    ours = AcadosOcpSolver(with_cond(make_pendulum_ocp, N), device="cpu")
    assert ours.opts.cond_N is None and not ours.opts.full_cond
    ref = JaxOcpSolver(with_cond(jax_pendulum_ocp, N))
    plain = AcadosOcpSolver(make_pendulum_ocp(N=N, dtype="float64"),
                            device="cpu")
    assert ours.solve() == ref.solve() == plain.solve() == 0
    for field in ("sqp_iter", "qp_iter"):
        assert ours.get_stats(field) == ref.get_stats(field) \
            == plain.get_stats(field)
    _assert_stages_agree(ours, ref, ("x", "u", "pi"))
    for k in range(N):
        np.testing.assert_array_equal(ours.get(k, "u"), plain.get(k, "u"))

    calls = []
    orig = xcond.solve_dense_qp
    monkeypatch.setattr(xcond, "solve_dense_qp", lambda *a, **k: (
        calls.append(1), orig(*a, **k))[1])
    dense = AcadosOcpSolver(with_cond(make_pendulum_ocp, N // 4, full=True),
                            device="cpu")
    assert dense.opts.full_cond and dense.opts.cond_N is None
    # one dense QP per SQP round, the round that finds convergence too
    assert dense.solve() == 0
    assert len(calls) == dense.get_stats("sqp_iter") + 1

    part = AcadosOcpSolver(with_cond(make_pendulum_ocp, N // 4),
                           device="cpu")
    part_ref = JaxOcpSolver(with_cond(jax_pendulum_ocp, N // 4))
    assert part.opts.cond_N == part_ref.opts.cond_N == N // 4
    assert part.solve() == part_ref.solve() == 0
    for field in ("sqp_iter", "qp_iter"):
        assert part.get_stats(field) == part_ref.get_stats(field)
    _assert_stages_agree(part, part_ref, ("x", "u", "pi"))
