"""PyTorch port, the interface utilities: mpc_utils (J_to_idx, the cost
and constraint evaluator, the cost-state model, constraint-structure
detection), penalty_utils, param_manager and the developer debug checks,
against the JAX package's modules on the same inputs (float64, CPU).

The models are the pendulum of tests/test_interface.py:make_ocp, in
torch (acados_tpu_torch.models.pendulum) and in jnp; the checks of
tests/test_utils_interface.py stand beside the parity checks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.interface import mpc_utils as jmu
from acados_tpu.interface import param_manager as jpm
from acados_tpu.interface import penalty_utils as jpu
from acados_tpu.interface.solver import AcadosOcpSolver as JaxOcpSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.utils import debug_checks as jdc
from acados_tpu_torch import (AcadosOcpSolver, AcadosParam,
                              AcadosParamManager)
from acados_tpu_torch.interface import mpc_utils as pmu
from acados_tpu_torch.interface import penalty_utils as ppu
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.utils import debug_checks as pdc
from test_interface import make_ocp as jax_make_ocp
from test_torch_globalization import rel_gap

torch.set_num_threads(1)

F64 = torch.float64
t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))


def soft_pendulum(make, h_of):
    """The pendulum at N = 10 with an h row |x_0 + 2 u_0| <= 1 softened
    (l1 and quadratic penalties) and a state box on x_2: the evaluator's
    slack penalty has work to do."""
    ocp = make(N=10)
    m, con, c = ocp.model, ocp.constraints, ocp.cost
    m.con_h_expr = h_of
    con.lh, con.uh = np.array([-1.0]), np.array([1.0])
    con.idxsh = np.array([0])
    con.idxbx, con.lbx, con.ubx = np.array([2]), np.array([-2.0]), \
        np.array([2.0])
    c.Zl, c.Zu, c.zl, c.zu = (np.array([v]) for v in (3.0, 4.0, 0.5, 0.7))
    return ocp


def test_j_to_idx_matches_jax():
    J = np.array([[0, 1, 0], [0, 0, 1.0], [1, 0, 0]])
    np.testing.assert_array_equal(pmu.J_to_idx(J), jmu.J_to_idx(J))
    for bad in (np.array([[0.5, 0, 0]]), np.array([[1.0, 1.0, 0]])):
        with pytest.raises(ValueError):
            pmu.J_to_idx(bad)


def test_evaluator_matches_jax():
    """evaluate() at seeded points of stages 0, a path stage and the
    terminal one, violations included, and evaluate_ocp_cost of a
    seeded trajectory, against the JAX evaluator; at the port solver's
    solution evaluate_ocp_cost equals get_cost."""
    pocp = soft_pendulum(make_pendulum_ocp,
                         lambda x, u: torch.stack([x[0] + 2.0 * u[0]]))
    jocp = soft_pendulum(jax_make_ocp,
                         lambda x, u: jnp.stack([x[0] + 2.0 * u[0]]))
    pev = pmu.AcadosCostConstraintEvaluator(pocp, device="cpu")
    jev = jmu.AcadosCostConstraintEvaluator(jocp)
    rng = np.random.default_rng(4)
    for step in (0, 1, 5, 9):
        x, u = 2.0 * rng.normal(size=4), 2.0 * rng.normal(size=1)
        got, ref = pev.evaluate(x, u, step), jev.evaluate(x, u, step)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            assert rel_gap(got[k], ref[k]) <= 1e-12, (step, k)
    traj = {"x": rng.normal(size=(11, 4)), "u": rng.normal(size=(10, 1))}
    assert rel_gap(pev.evaluate_ocp_cost(traj),
                   jev.evaluate_ocp_cost(traj)) <= 1e-12
    solver = AcadosOcpSolver(make_pendulum_ocp(N=10), device="cpu")
    assert solver.solve() == 0
    ev = pmu.AcadosCostConstraintEvaluator(make_pendulum_ocp(N=10),
                                           device="cpu")
    xs = np.stack([solver.get(k, "x") for k in range(11)])
    us = np.stack([solver.get(k, "u") for k in range(10)])
    np.testing.assert_allclose(ev.evaluate_ocp_cost({"x": xs, "u": us}),
                               solver.get_cost(), rtol=1e-6, atol=1e-8)
    out = ev.evaluate(np.zeros(4), np.array([100.0]), step=1)
    assert out["violation"].max() == pytest.approx(20.0)
    # update_all takes the solver's data (a changed yref moves the cost)
    solver.set(1, "yref", np.ones(5))
    before = float(ev.evaluate(xs[1], us[1], 1)["cost"])
    ev.update_all(solver)
    assert float(ev.evaluate(xs[1], us[1], 1)["cost"]) != before


def test_cost_state_model_matches_jax():
    """create_model_with_cost_state: f_aug at seeded points equals the
    JAX package's, on the soft pendulum (the slack penalties enter the
    cost rate)."""
    pocp = soft_pendulum(make_pendulum_ocp,
                         lambda x, u: torch.stack([x[0] + 2.0 * u[0]]))
    jocp = soft_pendulum(jax_make_ocp,
                         lambda x, u: jnp.stack([x[0] + 2.0 * u[0]]))
    pm, ppv = pmu.create_model_with_cost_state(pocp)
    jm, jpv = jmu.create_model_with_cost_state(jocp)
    assert (pm.x, pm.name) == (jm.x, jm.name)
    np.testing.assert_array_equal(ppv, jpv)
    rng = np.random.default_rng(5)
    for _ in range(4):
        x, u = 2.0 * rng.normal(size=5), 3.0 * rng.normal(size=1)
        got = pm.f_expl_expr(t64(x), t64(u), t64(np.zeros(0)), 0.0)
        ref = jm.f_expl_expr(jnp.asarray(x), jnp.asarray(u),
                             jnp.zeros(0), 0.0)
        assert rel_gap(got.numpy(), np.asarray(ref)) <= 1e-12


@pytest.mark.parametrize("stage_type", ["path", "initial", "terminal"])
def test_detect_constraint_structure_matches_jax(stage_type):
    """The same rows move to the same fields in both packages, and the
    kept nonlinear rows evaluate alike (tests/test_utils_interface.py's
    h = [x_2, x_0 + 2 u_0, sin(x_1)] plus a u-bound row)."""
    sfx = {"initial": "_0", "path": "", "terminal": "_e"}[stage_type]
    def h_of(lib):
        return lambda x, u: lib.stack([x[2], x[0] + 2.0 * u[0],
                                       lib.sin(x[1]), u[0]])

    out = []
    for make, lib in ((make_pendulum_ocp, torch), (jax_make_ocp, jnp)):
        ocp = make(N=5)
        m, con = ocp.model, ocp.constraints
        setattr(m, "con_h_expr" + sfx, h_of(lib))
        setattr(con, "lh" + sfx, np.array([-1.0, -2.0, -0.5, -3.0]))
        setattr(con, "uh" + sfx, np.array([1.0, 2.0, 0.5, 3.0]))
        (pmu if lib is torch else jmu).detect_constraint_structure(
            m, con, stage_type)
        out.append((m, con))
    (pm, pc), (jm, jc) = out
    for name in ("idxbx", "lbx", "ubx", "idxbu", "lbu", "ubu", "C", "D",
                 "lg", "ug", "lh", "uh"):
        got, ref = getattr(pc, name + sfx, None), getattr(jc, name + sfx,
                                                          None)
        assert (got is None) == (ref is None), name
        if ref is not None:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                          err_msg=name)
    hp, hj = getattr(pm, "con_h_expr" + sfx), getattr(jm, "con_h_expr" + sfx)
    x, u = np.arange(4.0) / 3, np.array([0.7])
    np.testing.assert_allclose(hp(t64(x), t64(u)).numpy(),
                               np.asarray(hj(jnp.asarray(x),
                                             jnp.asarray(u))), rtol=1e-14)


def test_control_horizon_phases_match_jax():
    """create_ocp_with_control_horizon on the pendulum: the same phases,
    dims, options and time grid as the JAX package's, and Nc = Np passes
    the OCP through."""
    pm = pmu.create_ocp_with_control_horizon(make_pendulum_ocp(N=20), Nc=5)
    jm = jmu.create_ocp_with_control_horizon(jax_make_ocp(N=20), Nc=5)
    assert pm.N_list == jm.N_list == [5, 1, 15]
    assert [(m.x, m.u, m.name) for m in pm.model] == \
        [(m.x, m.u, m.name) for m in jm.model]
    assert pm.mocp_opts.integrator_type == jm.mocp_opts.integrator_type
    np.testing.assert_array_equal(pm.solver_options.time_steps,
                                  jm.solver_options.time_steps)
    assert pm.solver_options.tf == jm.solver_options.tf
    x = np.linspace(-1.0, 1.0, 5)
    got = pm.model[2].f_expl_expr(t64(x), t64(np.zeros(0)), None, 0.0)
    ref = jm.model[2].f_expl_expr(jnp.asarray(x), jnp.zeros(0), None, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14)
    out = pmu.create_ocp_with_control_horizon(make_pendulum_ocp(N=10),
                                              Nc=10)
    assert type(out).__name__ == "AcadosOcp"


PENALTY_GRID = np.concatenate([np.linspace(-4.0, 4.0, 161),
                               [0.0, 0.3, -0.3, 1.2, -1.2, 0.6, 1.0]])


@pytest.mark.parametrize("kind,kw", [
    ("one_sided", dict(delta=0.3, tau=1.5)),
    ("one_sided", dict(delta=0.3, w=2.5, min_hess=0.07)),
    ("symmetric", dict(delta=0.2, tau=1.0)),
    ("symmetric", dict(delta=0.2, w=0.5, min_hess=0.05))])
def test_penalties_match_jax(kind, kw):
    """Value, gradient, Hessian and XGN Hessian on a grid that crosses
    every region (inside, the ramps, the linear tails), elementwise on
    the whole grid and at a few scalars (the shapes of a scalar call)."""
    name = f"{kind}_huber_penalty"
    pen_p = getattr(ppu, name)(**kw)
    pen_j = getattr(jpu, name)(**kw)
    for fp, fj in zip(pen_p, pen_j):
        for v in (PENALTY_GRID, 0.0, 1.2, -3.0):
            got = fp(t64(v)).numpy()
            ref = np.asarray(fj(jnp.asarray(v)))
            assert got.shape == ref.shape
            assert rel_gap(got, ref) <= 1e-12, (v, got, ref)


def test_huber_loss_matches_jax():
    loss_p, xgn_p = ppu.huber_loss(0.5, 2.0)
    loss_j, xgn_j = jpu.huber_loss(0.5, 2.0)
    g = PENALTY_GRID
    assert rel_gap(loss_p(t64(g)).numpy(),
                   np.asarray(loss_j(jnp.asarray(g)))) <= 1e-14
    assert rel_gap(xgn_p(t64(g)).numpy(),
                   np.asarray(xgn_j(jnp.asarray(g)))) <= 1e-14
    assert float(torch.func.grad(loss_p)(t64(3.0))) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        ppu.huber_loss(0.0, 1.0)
    with pytest.raises(ValueError):
        ppu.one_sided_huber_penalty(0.3)
    with pytest.raises(ValueError):
        ppu.one_sided_huber_penalty(0.3, tau=1.0, w=1.0)


def test_param_manager_matches_jax():
    """tests/test_utils_interface.py::TestParamManager's checks on the
    port, its layout and stage values against the JAX manager's, and
    slice_fn's blocks against the JAX slices."""
    pm = AcadosParamManager([AcadosParam("mass", np.array([1.5])),
                             AcadosParam("target", np.zeros(3))],
                            N_horizon=4)
    jm = jpm.AcadosParamManager([jpm.AcadosParam("mass", np.array([1.5])),
                                 jpm.AcadosParam("target", np.zeros(3))],
                                N_horizon=4)
    for m in (pm, jm):
        m.set_value("target", [1.0, 2.0, 3.0], stage=2)
        m.set_value("mass", 2.0)
    assert pm.np_total == jm.np_total == 4
    np.testing.assert_array_equal(pm.stage_values(), jm.stage_values())
    np.testing.assert_allclose(pm.get_value("target", 2), [1, 2, 3])
    np.testing.assert_allclose(pm.get_value("target", 1), 0)
    np.testing.assert_allclose(pm.stage_values()[:, 0], 2.0)
    p2 = pm.stage_values()[2]
    got, ref = pm.slice_fn()(torch.as_tensor(p2)), jm.slice_fn()(
        jnp.asarray(p2))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    with pytest.raises(ValueError):
        pm.set_value("target", [1.0, 2.0])
    for m in (pm, jm):
        m.N_horizon = 6
    np.testing.assert_array_equal(pm.stage_values(), jm.stage_values())
    pm.N_horizon = 1
    assert pm.stage_values().shape == (2, 4)
    with pytest.raises(ValueError):
        pm.N_horizon = -1


def test_param_manager_apply_to_solver():
    """apply_to sets every stage's p of a solver, as set(k, 'p') does."""
    from acados_tpu_torch.testing import param_pendulum_ocp
    solver = AcadosOcpSolver(param_pendulum_ocp(N=5), device="cpu")
    npar = solver._data["p"].shape[1]
    pm = AcadosParamManager([AcadosParam("p", np.arange(npar) + 1.0)],
                            N_horizon=5)
    pm.set_value("p", np.full(npar, 7.0), stage=3)
    pm.apply_to(solver)
    np.testing.assert_array_equal(solver._data["p"], pm.stage_values())


def _data_cases():
    """(label, corruption of a pendulum data dict, iterate or None)."""
    def nan_yref(d):
        d["yref"][2, 0] = np.nan

    def empty_box(d):
        d["lb_0"][0], d["ub_0"][0] = 1.0, -1.0

    def neg_Zl(d):
        d["Zl"][1, 0] = -1.0

    def asym_W(d):
        d["W"][0, 0, 1] = 1.0

    def zero_dt(d):
        d["dts"][3] = 0.0

    def inf_p(d):
        d["ts"][1] = np.inf

    return [("clean", None), ("nan yref", nan_yref), ("empty box", empty_box),
            ("negative Zl", neg_Zl), ("asymmetric W", asym_W),
            ("zero dt", zero_dt), ("infinite ts", inf_p)]


def _outcome(fn, *a):
    try:
        fn(*a)
    except AssertionError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("label,corrupt", _data_cases())
def test_debug_checks_match_jax(label, corrupt):
    """check_nlp_data raises the same error (type and message) or passes
    on the same data in both packages; check_iterate likewise on a clean
    and a corrupted iterate."""
    from acados_tpu_torch.interface.builder import build_ocp
    data = build_ocp(make_pendulum_ocp(N=10))[1]
    if corrupt is not None:
        corrupt(data)
    got = _outcome(pdc.check_nlp_data, data)
    ref = _outcome(jdc.check_nlp_data, data)
    assert got == ref
    assert (got is None) == (label == "clean")
    it = {"x": np.zeros((11, 4)), "lam_l": np.ones((11, 6))}
    assert _outcome(pdc.check_iterate, it) is None
    it["lam_l"][3, 2] = -0.1 if label != "clean" else 0.0
    assert _outcome(pdc.check_iterate, it) == _outcome(jdc.check_iterate,
                                                       it)


def test_debug_checks_elimination_rows():
    """x0_elim_nx: an asymmetric initial-state box raises in both."""
    from acados_tpu_torch.interface.builder import build_ocp
    data = build_ocp(make_pendulum_ocp(N=10))[1]
    data["ub_0"][1] += 0.5
    assert _outcome(pdc.check_nlp_data, data, 4) == \
        _outcome(jdc.check_nlp_data, data, 4) is not None


def _nan_yref(solver):
    yref = np.asarray(solver._data["yref"]).copy()
    yref[2, 0] = np.nan
    solver._data["yref"] = yref


def test_solver_debug_checks_like_jax():
    """The NaN-yref pendulum of tests/test_utils_interface.py::
    TestDebugChecks with with_debug_checks = True raises in both
    packages' AcadosOcpSolver.solve (before this check the port solved
    it silently); the clean problem solves."""
    jocp = jax_pendulum_ocp(N=10, dtype="float64", nlp_solver_type="SQP")
    pocp = make_pendulum_ocp(N=10, dtype="float64", nlp_solver_type="SQP")
    jocp.solver_options.with_debug_checks = True
    pocp.solver_options.with_debug_checks = True
    js = JaxOcpSolver(jocp)
    ps = AcadosOcpSolver(pocp, device="cpu")
    assert ps.solve() == 0
    for s in (js, ps):
        _nan_yref(s)
    with pytest.raises(jdc.AcadosDebugCheckError, match="yref"):
        js.solve()
    with pytest.raises(pdc.AcadosDebugCheckError, match="yref"):
        ps.solve()
    ps = AcadosOcpSolver(make_pendulum_ocp(N=10, dtype="float64"),
                         device="cpu")
    ps.set(0, "lbx", np.array([1.0, 0.0, 0.0, 0.0]))
    ps.set(0, "ubx", np.array([-1.0, 0.0, 0.0, 0.0]))
    ps.acados_ocp.solver_options.with_debug_checks = True
    with pytest.raises(pdc.AcadosDebugCheckError, match="lb_0 > ub_0"):
        ps.solve()


def test_solver_debug_checks_by_environment(monkeypatch):
    """ACADOS_TPU_DEBUG_CHECKS=1 turns the checks on without the option;
    unset, the same data solves without a check."""
    ps = AcadosOcpSolver(make_pendulum_ocp(N=10, dtype="float64"),
                         device="cpu")
    _nan_yref(ps)
    monkeypatch.setenv("ACADOS_TPU_DEBUG_CHECKS", "1")
    assert pdc.debug_checks_enabled(None)
    with pytest.raises(pdc.AcadosDebugCheckError, match="yref"):
        ps.solve()
    monkeypatch.setenv("ACADOS_TPU_DEBUG_CHECKS", "0")
    assert not pdc.debug_checks_enabled(ps.acados_ocp.solver_options)
    ps.solve()  # no check: the NaN goes into the solve
