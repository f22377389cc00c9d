"""PyTorch port, multiphase OCPs: build_mocp, the multiphase linearization
and evaluations, AcadosOcpSolver on an AcadosMultiphaseOcp and the
batch-first MocpBatch, against the JAX package.

The problems are the transition example of tests/test_multiphase.py
(double integrator -> DISCRETE transition nx 2 -> 1 -> single
integrator, with ERK or with IRK phases) and the control-horizon
pendulum of tests/test_utils_interface.py::TestControlHorizon, written in
torch in acados_tpu_torch.testing and taken in jnp from the JAX tests.
Both packages see the same inputs (float64, CPU): every data field, the
QP of a seeded random iterate, the evaluations, and the solves (equal
statuses and sqp_iter; x and u at the phase dims, pi, the cost and the
residuals within a relative 1e-9).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.builder import data_to_jax
from acados_tpu.interface.mpc_utils import \
    create_ocp_with_control_horizon as jax_control_horizon
from acados_tpu.interface.multiphase import build_mocp as jax_build_mocp
from acados_tpu.interface.solver import AcadosOcpSolver as JaxOcpSolver
from acados_tpu.ocp_nlp.linearize import NlpIterate as JNlpIterate
from acados_tpu.ocp_nlp.linearize import build_static_rows as jax_static_rows
from acados_tpu.ocp_nlp.linearize import eval_constraints as jax_eval_con
from acados_tpu.ocp_nlp.linearize import eval_cost as jax_eval_cost
from acados_tpu.ocp_nlp.linearize import eval_dyn_gap as jax_eval_gap
from acados_tpu.ocp_nlp.linearize import linearize as jax_linearize
from acados_tpu_torch import (AcadosMultiphaseOcp, AcadosOcpBatchSolver,
                              AcadosOcpSolver)
from acados_tpu_torch.interface.builder import data_to_torch
from acados_tpu_torch.interface.mpc_utils import \
    create_ocp_with_control_horizon
from acados_tpu_torch.interface.multiphase import build_mocp
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate,
                                                build_static_rows,
                                                eval_constraints, eval_cost,
                                                eval_dyn_gap, linearize)
from acados_tpu_torch.testing import (MOCP_X0, MocpBatch,
                                      control_horizon_mocp, transition_mocp)
from test_interface import make_ocp as jax_pendulum_ocp
from test_multiphase import make_transition_mocp as jax_transition_mocp
from test_torch_globalization import rel_gap

torch.set_num_threads(1)

F64 = torch.float64
IRK_PHASES = ("IRK", "DISCRETE", "IRK")
OCP_QP_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg",
                 "ug", "mask_l", "mask_u", "Zl", "Zu", "zl", "zu",
                 "soft_mask")


def problems(kind, t1=0.4, nlp_solver_type="SQP"):
    """(port mocp, JAX mocp) of one problem kind: 'erk' and 'irk' are the
    transition example, 'ch' the control-horizon pendulum."""
    if kind == "ch":
        return (control_horizon_mocp(nlp_solver_type=nlp_solver_type),
                jax_control_horizon(
                    jax_pendulum_ocp(N=20, nlp_solver_type=nlp_solver_type),
                    Nc=5))
    phases = IRK_PHASES if kind == "irk" else ("ERK", "DISCRETE", "ERK")
    jm = jax_transition_mocp(t1)
    jm.mocp_opts.integrator_type = list(phases)
    jm.solver_options.nlp_solver_type = nlp_solver_type
    return (transition_mocp(t1, phases, nlp_solver_type=nlp_solver_type),
            jm)


def random_iterate(form, B, seed):
    """Seeded iterate of B instances (numpy, float64), multipliers and
    slacks nonnegative."""
    rng = np.random.default_rng(seed)
    N, nx, nu, nc = form.N, form.nx, form.nu, form.nc
    n = lambda *s: rng.normal(size=(B,) + s)
    return dict(x=n(N + 1, nx), u=n(N, nu), pi=n(N, nx),
                lam_l=np.abs(n(N + 1, nc)), lam_u=np.abs(n(N + 1, nc)),
                sl=np.abs(n(N + 1, nc)), su=np.abs(n(N + 1, nc)))


def both_at(kind, B, seed):
    """The port's and the JAX package's (form, batched data, iterate) of
    one problem at a seeded random iterate."""
    pm, jm = problems(kind)
    pform, pdata, _ = build_mocp(pm)
    jform, jdata, _ = jax_build_mocp(jm)
    it = random_iterate(pform, B, seed)
    p = (pform, data_to_torch(pdata, F64, "cpu", batch=B),
         NlpIterate(**{k: torch.as_tensor(v) for k, v in it.items()}))
    j = (jform, data_to_jax(jdata, jnp.float64),
         JNlpIterate(**{k: jnp.asarray(v) for k, v in it.items()}))
    return p, j


def jax_per_instance(fn, data, it):
    """fn(data, it_b) of the JAX package for every instance of it."""
    return jax.vmap(lambda it_b: fn(data, it_b))(it)


@pytest.mark.parametrize("kind", ["erk", "irk", "ch"])
def test_build_mocp_matches_jax(kind):
    """Every data field, the dims, the segments' ranges and row counts,
    and the stage layouts equal the JAX package's."""
    pm, jm = problems(kind)
    pform, pdata, play = build_mocp(pm)
    jform, jdata, jlay = jax_build_mocp(jm)
    assert (pform.N, pform.nx, pform.nu, pform.nc, pform.np_) == \
        (jform.N, jform.nx, jform.nu, jform.nc, jform.np_)
    assert [(s.start, s.stop, s.con.nrows, s.cost.ny, s.cost.kind)
            for s in pform.segments] == \
        [(s.start, s.stop, s.con.nrows, s.cost.ny, s.cost.kind)
         for s in jform.segments]
    assert sorted(pdata) == sorted(jdata)
    for k in jdata:
        np.testing.assert_array_equal(pdata[k], np.asarray(jdata[k]),
                                      err_msg=k)
    for key in ("0", "e"):
        assert vars(play[key]) == vars(jlay[key])
    assert [vars(a) for a in play["p"]] == [vars(b) for b in jlay["p"]]
    if kind == "ch":
        assert (pform.N, pform.nx, pform.nu, pform.nc) == (21, 5, 1, 5)


@pytest.mark.parametrize("kind", ["erk", "irk", "ch"])
def test_linearize_mp_matches_jax(kind):
    """The QP of three seeded random iterates, every OcpQp field instance
    by instance against the JAX package's linearize_mp (jacfwd of the
    padded step there, the phases' own step Jacobians zero-padded
    here), with a Levenberg-Marquardt term."""
    (pf, pd, pit), (jf, jd, jit) = both_at(kind, 3, seed=1)
    qp = linearize(pf, build_static_rows(pf, F64, "cpu"), pd, pit,
                   torch.tensor(1e-3, dtype=F64))
    jsr = jax_static_rows(jf, jnp.float64)
    jqp = jax_per_instance(
        lambda d, i: jax_linearize(jf, jsr, d, i, jnp.asarray(1e-3)), jd, jit)
    for f in OCP_QP_FIELDS:
        got = getattr(qp, f).numpy()
        ref = np.asarray(getattr(jqp, f))
        assert got.shape == ref.shape, f
        assert rel_gap(got, ref) <= 1e-9, (f, rel_gap(got, ref))


@pytest.mark.parametrize("kind", ["erk", "irk", "ch"])
def test_evaluations_match_jax(kind):
    """eval_cost_mp (with slacks), eval_constraints_mp and eval_dyn_gap_mp
    at three seeded random iterates."""
    (pf, pd, pit), (jf, jd, jit) = both_at(kind, 3, seed=2)
    sr = build_static_rows(pf, F64, "cpu")
    soft = sr["soft"] * sr["mask"]
    jsr = jax_static_rows(jf, jnp.float64)
    jsoft = jsr["soft"] * jsr["mask"]
    pairs = (
        (eval_cost(pf, pd, pit.x, pit.u, pit.sl, pit.su, soft),
         jax_per_instance(lambda d, i: jax_eval_cost(
             jf, d, i.x, i.u, i.sl, i.su, jsoft), jd, jit)),
        (eval_constraints(pf, pd, pit.x, pit.u),
         jax_per_instance(lambda d, i: jax_eval_con(jf, d, i.x, i.u), jd,
                          jit)),
        (eval_dyn_gap(pf, pd, pit.x, pit.u),
         jax_per_instance(lambda d, i: jax_eval_gap(jf, d, i.x, i.u), jd,
                          jit)))
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert rel_gap(got.numpy(), np.asarray(ref)) <= 1e-9


def assert_same_solve(ps, js):
    """Equal status and sqp_iter; x and u at every stage's phase dims, pi,
    the cost and the residuals within a relative 1e-9."""
    assert ps.solve() == js.solve()
    assert ps.get_stats("sqp_iter") == js.get_stats("sqp_iter")
    N = js.N
    for field, stages in (("x", N + 1), ("u", N), ("pi", N)):
        for k in range(stages):
            got, ref = ps.get(k, field), js.get(k, field)
            assert got.shape == ref.shape, (field, k)
            assert rel_gap(got, ref) <= 1e-9, (field, k, rel_gap(got, ref))
    assert rel_gap(ps.get_cost(), js.get_cost()) <= 1e-9
    assert rel_gap(ps.get_residuals(), js.get_residuals()) <= 1e-9


@pytest.mark.parametrize("kind,t1", [("erk", 0.2), ("erk", 0.4),
                                     ("irk", 0.2), ("irk", 0.4)])
def test_transition_solve_matches_jax(kind, t1):
    """The transition example by SQP with MERIT_BACKTRACKING, ERK and IRK
    phases, at two split points."""
    pm, jm = problems(kind, t1)
    assert_same_solve(AcadosOcpSolver(pm, device="cpu"), JaxOcpSolver(jm))


def test_partial_condensing_matches_jax():
    """qp_solver_cond_N on a multiphase OCP resolves against sum(N_list)
    (the JAX package's _resolve_cond) and partial condensing keeps every
    stage's rows (keep_rows None): the transition example at cond_N = 10
    against the JAX package."""
    pm, jm = problems("erk")
    pm.solver_options.qp_solver_cond_N = jm.solver_options.qp_solver_cond_N \
        = 10
    ps, js = AcadosOcpSolver(pm, device="cpu"), JaxOcpSolver(jm)
    assert ps.opts.cond_N == js.opts.cond_N == 10
    assert_same_solve(ps, js)


def test_transition_rti_matches_jax():
    """The transition example under SQP_RTI: two RTI calls."""
    pm, jm = problems("erk", nlp_solver_type="SQP_RTI")
    ps, js = AcadosOcpSolver(pm, device="cpu"), JaxOcpSolver(jm)
    for _ in range(2):
        assert_same_solve(ps, js)


@pytest.mark.parametrize("level", ["A", "B", "D"])
def test_as_rti_phases_match_jax(level):
    """The RTI phases (options_set("rti_phase", 1 then 2), three cycles)
    with AS-RTI levels A, B and D (SIMULATE steps interval 0 with phase
    0's dynamics) on the transition example; level C is refused: the JAX
    package's adjoint correction takes phase 0's dynamics on every
    interval."""
    pm, jm = problems("erk", nlp_solver_type="SQP_RTI")
    pm.solver_options.as_rti_level = jm.solver_options.as_rti_level = level
    ps, js = AcadosOcpSolver(pm, device="cpu"), JaxOcpSolver(jm)
    for _ in range(3):
        for s in (ps, js):
            s.options_set("rti_phase", 1)
            s.solve()
            s.options_set("rti_phase", 2)
        assert ps.solve() == js.solve()
    for k in range(js.N + 1):
        assert rel_gap(ps.get(k, "x"), js.get(k, "x")) <= 1e-9, k
    assert rel_gap(ps.get_cost(), js.get_cost()) <= 1e-9
    pm.solver_options.as_rti_level = "C"
    ps = AcadosOcpSolver(pm, device="cpu")
    ps.options_set("rti_phase", 1)
    with pytest.raises(NotImplementedError, match="phase 0"):
        ps.solve()


def test_control_horizon_solve_matches_jax():
    """create_ocp_with_control_horizon(pendulum, N = 20, Nc = 5) by SQP:
    8 SQP iterations in both packages, the held control equal to the
    transition stage's decision (tests/test_utils_interface.py)."""
    pm, jm = problems("ch")
    ps, js = AcadosOcpSolver(pm, device="cpu"), JaxOcpSolver(jm)
    assert_same_solve(ps, js)
    assert ps.get_stats("sqp_iter") == 8
    u_t = ps.get(5, "u")
    for k in (7, 10, 15, 21):
        np.testing.assert_allclose(ps.get(k, "x")[4:], u_t, atol=1e-8)


def test_mocp_batch_matches_jax_solves():
    """MocpBatch at B = 3 (x0 = MOCP_X0 + N(0, 0.05)) against three JAX
    solves, each with its x0 set as lbx = ubx at stage 0: equal statuses
    and sqp_iter, the padded iterates within a relative 1e-9."""
    rng = np.random.default_rng(3)
    x0s = np.asarray(MOCP_X0) + rng.normal(0.0, 0.05, (3, 2))
    batch = MocpBatch(transition_mocp(), x0s, "cpu")
    st = batch.solve()
    js = JaxOcpSolver(jax_transition_mocp())
    for i, x0 in enumerate(x0s):
        js.reset()
        js.set(0, "lbx", x0)
        js.set(0, "ubx", x0)
        assert st[i] == js.solve()
        assert batch.get_stats("sqp_iter")[i] == js.get_stats("sqp_iter")
        for f in ("x", "u", "pi"):
            got = getattr(batch._it_dev, f)[i].numpy()
            assert rel_gap(got, js._iterate[f]) <= 1e-9, f
        assert rel_gap(batch.get_stats("cost")[i], js.get_cost()) <= 1e-9


def test_solver_on_mocp():
    """tests/test_multiphase.py:82-105 on the port: the stage dims follow
    the phase, the transition carries the position over, x0 holds, the
    terminal position is near the origin, each phase's control bounds
    hold; set of x at a phase's dims."""
    N_H = 25
    solver = AcadosOcpSolver(transition_mocp(), device="cpu")
    assert solver.solve() == 0
    assert solver.get_residuals()[0] < 1e-6
    assert solver.get(0, "x").shape == (2,)
    assert solver.get(N_H, "x").shape == (2,)
    assert solver.get(N_H + 1, "x").shape == (1,)
    assert solver.get(N_H, "u").shape == (0,)
    np.testing.assert_allclose(solver.get(N_H + 1, "x")[0],
                               solver.get(N_H, "x")[0], atol=1e-10)
    np.testing.assert_allclose(solver.get(0, "x"), MOCP_X0, atol=1e-8)
    assert abs(solver.get(2 * N_H + 1, "x")[0]) < 0.1
    u0 = np.array([solver.get(k, "u")[0] for k in range(N_H)])
    u2 = np.array([solver.get(k, "u")[0]
                   for k in range(N_H + 1, 2 * N_H + 1)])
    assert np.max(np.abs(u0)) <= 50.0 + 1e-6
    assert np.max(np.abs(u2)) <= 5.0 + 1e-6
    solver.set(N_H + 2, "x", [0.5])
    np.testing.assert_array_equal(solver.get(N_H + 2, "x"), [0.5])


def test_raise_cases_match_jax():
    """Where the JAX package fails on a multiphase OCP the port raises,
    and the errors of create_ocp_with_control_horizon are the same."""
    with pytest.raises(ValueError):
        jax_control_horizon(jax_pendulum_ocp(N=10), Nc=11)
    with pytest.raises(ValueError):
        create_ocp_with_control_horizon(make_pendulum_ocp(N=10), Nc=11)
    jirk = jax_pendulum_ocp(N=10)
    jirk.solver_options.integrator_type = "IRK"
    with pytest.raises(NotImplementedError):
        jax_control_horizon(jirk, Nc=5)
    with pytest.raises(NotImplementedError):
        create_ocp_with_control_horizon(
            make_pendulum_ocp(N=10, integrator_type="IRK"), Nc=5)
    ps = AcadosOcpSolver(transition_mocp(), device="cpu")
    js = JaxOcpSolver(jax_transition_mocp())
    ps.solve()
    js.solve()
    for field in ("lam", "sl"):
        with pytest.raises(AttributeError):
            js.get(3, field)
        with pytest.raises(NotImplementedError, match="multiphase"):
            ps.get(3, field)
    with pytest.raises(NotImplementedError, match="multiphase"):
        ps.set(3, "su", [0.0])
    with pytest.raises(NotImplementedError, match="multiphase"):
        ps.constraints_set(3, "lbu", [0.0])
    with pytest.raises(NotImplementedError, match="multiphase"):
        ps.get(3, "z")
    with pytest.raises(NotImplementedError, match="multiphase"):
        ps.eval_param_sens(0)
    # stages 0 and N keep their single layouts, as in the JAX package
    for k in (0, ps.N):
        np.testing.assert_array_equal(ps.get(k, "lam").shape,
                                      js.get(k, "lam").shape)
    with pytest.raises(NotImplementedError, match="single-phase"):
        AcadosOcpBatchSolver(transition_mocp(), 2, device="cpu")


@pytest.mark.parametrize("nlp_solver_type", ["DDP", "SQP_WITH_FEASIBLE_QP"])
def test_refused_nlp_solvers(nlp_solver_type):
    """DDP and SQP_WITH_FEASIBLE_QP read the single-phase stage classes:
    the JAX package fails on a multiphase OCP, the port raises."""
    pm, jm = problems("erk", nlp_solver_type=nlp_solver_type)
    with pytest.raises(AttributeError):
        JaxOcpSolver(jm).solve()
    with pytest.raises(NotImplementedError, match="multiphase"):
        AcadosOcpSolver(pm, device="cpu")


def test_mocp_builds_and_sets_phases():
    """AcadosMultiphaseOcp's checks and set_phase."""
    with pytest.raises(ValueError):
        AcadosMultiphaseOcp([3, 0])
    mocp = AcadosMultiphaseOcp([2, 3])
    ocp = make_pendulum_ocp()
    assert mocp.set_phase(ocp, 1) is mocp
    assert mocp.model[1] is ocp.model and mocp.N_list == [2, 3]


def test_mp_k1_count_matches_chip_smoke(monkeypatch):
    """chip_smoke.py's phase 36 holds the K1 launches of the IRK
    transition example's SQP call to mp_k1_expected, worked out from its
    stat table: here the count of K1 wrapper calls of such a call on the
    CPU (B = 2, float64) equals it, and every call inverts a stage system
    of 4 x 2 = 8 (double integrator) or 4 x 1 = 4 (single integrator)
    unknowns over the batch's 25 intervals of that phase."""
    import chip_smoke
    from acados_tpu_torch.sim import irk

    shapes = []
    for name in ("linsolve", "gj_inverse_any"):
        orig = getattr(irk, name)
        monkeypatch.setattr(irk, name, lambda *a, _o=orig: (
            shapes.append(tuple(a[0].shape)), _o(*a))[1])
    rng = np.random.default_rng(4)
    x0s = np.asarray(MOCP_X0) + rng.normal(0.0, 0.05, (2, 2))
    batch = MocpBatch(transition_mocp(integrator_type=IRK_PHASES), x0s,
                      "cpu")
    assert np.all(batch.solve() == 0)
    assert len(shapes) == chip_smoke.mp_k1_expected(batch._stats,
                                                    batch.opts)
    assert sorted(set(shapes)) == [(50, n, n)
                                   for n in chip_smoke.MP_STAGE_N]
