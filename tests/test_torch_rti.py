"""PyTorch port, the RTI phases: ocp_nlp/rti.py (prepare / feedback,
AS-RTI levels A-D), AcadosOcpSolver's rti_phase and options_set, and
AcadosOcpBatchSolver.prepare()/feedback(), against the JAX package's
solvers (tests/test_batch_rti.py's set-up), on the pendulum ERK SQP-RTI
OCP in float64 on the CPU: equal statuses and QP iteration counts per
instance, iterates within a relative gap of 1e-9.
"""
import numpy as np
import pytest
import torch

from acados_tpu.interface.batch_solver import AcadosOcpBatchSolver as JaxBatch
from acados_tpu.interface.solver import AcadosOcpSolver as JaxSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu_torch import AcadosOcpBatchSolver, AcadosOcpSolver
from acados_tpu_torch.models.pendulum import make_pendulum_ocp

torch.set_num_threads(1)

B, N = 3, 8
# the swing-up from pi (tests/test_batch_rti.py's x0s), and regulation
# near the upright reference (its closed loop's)
X0S = (np.array([0.0, np.pi, 0.0, 0.0])
       + np.random.default_rng(7).normal(0.0, 0.05, (B, 4)))
X0S_UP = (np.array([0.0, 0.15, 0.0, 0.0])
          + np.random.default_rng(7).normal(0.0, 0.03, (B, 4)))
FIELDS = ("x", "u", "pi", "lam_l", "lam_u", "sl", "su")
CYCLES = 4


def _ocp(make, level="STANDARD", advancement="SIMULATE", **so):
    ocp = make(N=N, dtype="float64", nlp_solver_type="SQP_RTI")
    ocp.solver_options.as_rti_level = level
    ocp.solver_options.as_rti_advancement_strategy = advancement
    for k, v in so.items():
        setattr(ocp.solver_options, k, v)
    return ocp


def _close(got, ref, err_msg=""):
    gap = np.max(np.abs(got - ref) / (1 + np.abs(ref)), initial=0.0)
    assert gap <= 1e-9, f"{err_msg}: {gap:.3e}"


def _batch_at(solver, x0s=X0S):
    for i, view in enumerate(solver.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(N + 1):
            view.set(k, "x", x0s[i])
    return solver


def _single_at(solver, x0):
    solver.constraints_set(0, "lbx", x0)
    solver.constraints_set(0, "ubx", x0)
    for k in range(N + 1):
        solver.set(k, "x", x0)
    return solver


@pytest.mark.parametrize("level,advancement", [
    ("STANDARD", "SIMULATE"),
    ("A", "SHIFT"), ("A", "SIMULATE"), ("B", "SHIFT"), ("B", "SIMULATE"),
    ("C", "SHIFT"), ("C", "SIMULATE"), ("D", "SHIFT"), ("D", "SIMULATE")])
def test_batch_prepare_feedback_matches_jax(level, advancement):
    """Batched prepare()/feedback(x0) cycles near the upright reference,
    the measured x0 moved to the reference's x_1 after each cycle (a
    closed loop on the model itself), so the AS-RTI levels advance onto
    a new x0. On the swing-up from pi (X0S) at level D with SIMULATE,
    both packages' feedback IPMs stop at iter_max = 50 on two instances
    in the third cycle, and from the unconverged iterates on the two
    part (1.8e-2 in x): the reference's behaviour, not held here."""
    ours = _batch_at(AcadosOcpBatchSolver(_ocp(make_pendulum_ocp, level,
                                               advancement), B,
                                          device="cpu"), X0S_UP)
    ref = _batch_at(JaxBatch(_ocp(jax_pendulum_ocp, level, advancement), B),
                    X0S_UP)
    assert ours.opts.as_rti_level == level
    x0 = X0S_UP.copy()
    for _ in range(CYCLES):
        ours.prepare()
        ref.prepare()
        st, st_ref = ours.feedback(x0=x0), ref.feedback(x0=x0)
        np.testing.assert_array_equal(st, st_ref)
        assert np.all(st == 0)
        np.testing.assert_array_equal(
            ours.get_stats("qp_iter"), np.asarray(ref._stats.qp_iter_total))
        it = ours._host_iterate()
        for f in FIELDS:
            _close(it[f], ref._iterate[f], f)
        _close(ours.get_stats("residuals")[:, 0],
               np.asarray(ref._stats.res_stat), "res_stat")
        x0 = ref._iterate["x"][:, 1]
    for field in ("time_preparation", "time_feedback"):
        assert ours.get_stats(field) > 0


@pytest.mark.parametrize("level", ["STANDARD", "A", "B", "C", "D"])
def test_rti_phase_matches_jax(level):
    """options_set("rti_phase", 1) (preparation), the measured x0 set,
    then 2 (feedback) on one instance, against the JAX package's
    AcadosOcpSolver, the measurement moved to the reference's x_1 after
    each cycle; the AS-RTI levels advance with SIMULATE (the default).
    The instance regulates near the upright reference
    (tests/test_batch_rti.py's closed loop): on the swing-up from pi,
    bang-bang cycles make the multipliers sensitive at 1e-8, and there
    the JAX package's own single solver and its vmapped batch differ by
    3.8e-8 in pi at level D."""
    x0 = X0S_UP[1]
    ours = _single_at(AcadosOcpSolver(_ocp(make_pendulum_ocp, level),
                                      device="cpu"), x0)
    ref = _single_at(JaxSolver(_ocp(jax_pendulum_ocp, level)), x0)
    for _ in range(CYCLES):
        for phase in (1, 2):
            for s in (ours, ref):
                s.options_set("rti_phase", phase)
                if phase == 2:
                    s.constraints_set(0, "lbx", x0)
                    s.constraints_set(0, "ubx", x0)
            assert ours.solve() == ref.solve() == 0
            for k in range(N + 1):
                for f in ("x", "u", "pi") if k < N else ("x",):
                    _close(ours.get(k, f), ref.get(k, f), f"{phase} {f}")
        assert ours.get_stats("qp_iter") == ref.get_stats("qp_iter")
        _close(ours.get_residuals(), ref.get_residuals(), "residuals")
        x0 = ref.get(1, "x")
    assert ours.get_stats("time_preparation") > 0
    assert ours.get_stats("time_feedback") > 0
    # back to whole RTI calls: phase 0
    ours.options_set("rti_phase", 0)
    ref.options_set("rti_phase", 0)
    assert ours.solve() == ref.solve() == 0
    _close(ours.get(0, "u"), ref.get(0, "u"), "u after phase 0")


ADAPTIVE = dict(nlp_qp_tol_strategy="ADAPTIVE_CURRENT_RES_JOINT")


@pytest.mark.parametrize("which", ["batch", "single"])
def test_adaptive_qp_tol_phases_match_jax(which):
    """Under ADAPTIVE_CURRENT_RES_JOINT the standard preparation's and
    the feedback's QPs take each instance's tolerances from its NLP
    residuals (acados_tpu/ocp_nlp/rti.py:_qp_opts_at), in the batch's
    prepare()/feedback(x0) and in rti_phase 1/2 of one instance: three
    cycles near the upright reference against the JAX package, equal
    feedback qp_iter and x, u, pi (and the batch's predicted QP
    solutions) within 1e-9. With opts.qp_opts in those QPs the port's
    feedback QPs took 2, 3 and 3 iterations where the JAX package's
    took 1, and the iterates parted by up to 1.3e-3."""
    if which == "batch":
        ours = _batch_at(AcadosOcpBatchSolver(
            _ocp(make_pendulum_ocp, **ADAPTIVE), B, device="cpu"), X0S_UP)
        ref = _batch_at(JaxBatch(_ocp(jax_pendulum_ocp, **ADAPTIVE), B),
                        X0S_UP)
        x0 = X0S_UP.copy()
        for _ in range(3):
            ours.prepare()
            ref.prepare()
            for f in ("x", "u", "pi"):
                _close(getattr(ours._rti_cache.sol_pred, f).numpy(),
                       np.asarray(getattr(ref._rti_cache.sol_pred, f)),
                       f"predicted {f}")
            st, st_ref = ours.feedback(x0=x0), ref.feedback(x0=x0)
            np.testing.assert_array_equal(st, st_ref)
            np.testing.assert_array_equal(
                ours.get_stats("qp_iter"),
                np.asarray(ref._stats.qp_iter_total))
            it = ours._host_iterate()
            for f in ("x", "u", "pi"):
                _close(it[f], ref._iterate[f], f)
            x0 = ref._iterate["x"][:, 1]
        return
    x0 = X0S_UP[1]
    ours = _single_at(AcadosOcpSolver(_ocp(make_pendulum_ocp, **ADAPTIVE),
                                      device="cpu"), x0)
    ref = _single_at(JaxSolver(_ocp(jax_pendulum_ocp, **ADAPTIVE)), x0)
    for _ in range(3):
        for phase in (1, 2):
            for s in (ours, ref):
                s.options_set("rti_phase", phase)
                if phase == 2:
                    s.constraints_set(0, "lbx", x0)
                    s.constraints_set(0, "ubx", x0)
            assert ours.solve() == ref.solve() == 0
        assert ours.get_stats("qp_iter") == ref.get_stats("qp_iter")
        for k in range(N + 1):
            for f in ("x", "u", "pi") if k < N else ("x",):
                _close(ours.get(k, f), ref.get(k, f), f)
        x0 = ref.get(1, "x")


def test_batch_phases_equal_single_phases():
    """The batch's prepare()/feedback() equal each instance's rti_phase
    1/2 (tests/test_batch_rti.py's batch == serial oracle), in the port
    alone."""
    batch = _batch_at(AcadosOcpBatchSolver(_ocp(make_pendulum_ocp), B,
                                           device="cpu"))
    singles = [_single_at(AcadosOcpSolver(_ocp(make_pendulum_ocp),
                                          device="cpu"), X0S[i])
               for i in range(B)]
    for _ in range(3):
        batch.prepare()
        assert np.all(batch.feedback() == 0)
        for s in singles:
            for phase in (1, 2):
                s.options_set("rti_phase", phase)
                assert s.solve() == 0
    xb = batch._host_iterate()["x"]
    for i, s in enumerate(singles):
        _close(xb[i], np.stack([s.get(k, "x") for k in range(N + 1)]),
               f"instance {i}")


def test_phase_errors():
    """feedback() before prepare() and prepare() without SQP_RTI raise,
    as in the JAX package; so does rti_phase without SQP_RTI."""
    batch = AcadosOcpBatchSolver(_ocp(make_pendulum_ocp), 2, device="cpu")
    with pytest.raises(RuntimeError, match="prepare"):
        batch.feedback()
    ocp = make_pendulum_ocp(N=N, dtype="float64", nlp_solver_type="SQP")
    with pytest.raises(RuntimeError, match="SQP_RTI"):
        AcadosOcpBatchSolver(ocp, 2, device="cpu").prepare()
    with pytest.raises(ValueError, match="SQP_RTI"):
        AcadosOcpSolver(ocp, device="cpu").options_set("rti_phase", 1)
    with pytest.raises(ValueError, match="rti_phase"):
        AcadosOcpSolver(_ocp(make_pendulum_ocp),
                        device="cpu").options_set("rti_phase", 3)


def test_options_set_runtime_fields():
    """The runtime options of the ported paths take effect (the solve
    then agrees with the JAX solver given the same options), the
    globalization's (alpha_min, alpha_reduction, Anderson and the
    string-keyed globalization itself) among them, and those of the
    interface utilities (print_level, store_iterates, timeout_max_time)
    are taken as the JAX solver takes them; an unknown field raises
    ValueError."""
    ours = _single_at(AcadosOcpSolver(_ocp(make_pendulum_ocp),
                                      device="cpu"), X0S[0])
    ref = _single_at(JaxSolver(_ocp(jax_pendulum_ocp)), X0S[0])
    # a solver option re-derives the options from the OCP (as in the
    # JAX package), so it goes first
    for field, value in (("qp_solver_cond_N", 4), ("qp_tol_stat", 1e-7),
                         ("qp_iter_max", 40), ("qp_mu0", 50.0),
                         ("levenberg_marquardt", 1e-3), ("tol_stat", 1e-5),
                         ("nlp_solver_step_length", 1.0),
                         ("as_rti_iter", 2)):
        ours.options_set(field, value)
        ref.options_set(field, value)
    assert ours.opts.qp_opts.tol_stat == 1e-7
    assert ours.opts.qp_opts.iter_max == 40
    assert ours.opts.cond_N == ref.opts.cond_N == 4
    for _ in range(3):
        assert ours.solve() == ref.solve() == 0
        assert ours.get_stats("qp_iter") == ref.get_stats("qp_iter")
    for k in range(N):
        _close(ours.get(k, "u"), ref.get(k, "u"), f"u {k}")
    # the globalization's runtime options, as the JAX solver takes them
    for field, value in (("globalization_alpha_min", 0.1),
                         ("alpha_reduction", 0.5),
                         ("anderson_activation_threshold", 1e2),
                         ("with_anderson_acceleration", True)):
        ours.options_set(field, value)
        ref.options_set(field, value)
    for field in ("alpha_min", "alpha_reduction",
                  "anderson_activation_threshold",
                  "with_anderson_acceleration"):
        assert getattr(ours.opts, field) == getattr(ref.opts, field)
    for glob in ("FIXED_STEP", "MERIT_BACKTRACKING"):
        ours.options_set("globalization", glob)
        ref.options_set("globalization", glob)
        assert ours.opts.globalization == ref.opts.globalization == glob
        for _ in range(2):
            assert ours.solve() == ref.solve() == 0
            assert ours.get_stats("qp_iter") == ref.get_stats("qp_iter")
            np.testing.assert_array_equal(
                ours.get_stats("statistics")[7],
                np.asarray(ref.get_stats("statistics"))[7])
        for k in range(N):
            _close(ours.get(k, "u"), ref.get(k, "u"), f"{glob} u {k}")
    # the interface utilities' options, as the JAX solver takes them
    for field, value in (("print_level", 0), ("store_iterates", 1),
                         ("timeout_max_time", 60.0)):
        ours.options_set(field, value)
        ref.options_set(field, value)
    assert ours._print_level == ref._print_level == 0
    assert ours.opts.store_iterates is ref.opts.store_iterates is True
    assert ours.opts.timeout_max_time == ref.opts.timeout_max_time == 60.0
    assert ours.acados_ocp.solver_options.timeout_max_time == 60.0
    with pytest.raises(ValueError, match="unsupported"):
        ours.options_set("no_such_option", 1)
