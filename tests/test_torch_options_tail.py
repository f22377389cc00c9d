"""PyTorch port, the options tail of the SQP loop and its interface:
stored iterates (SqpStats.iterates_x/u, get_iterates), the in-loop
timeouts (timeout_max_time with the ZERO, LAST, MAX and AVERAGE
heuristics), the phase times (collect_phase_times and the re-executed
ones of get_stats), print_level and print_statistics, and
dump_qp_to_file, against the JAX package on the pendulum ERK SQP
(float64, CPU).

The stored iterates are held to jax.vmap of the JAX solve at B = 3,
rows after an instance stopped included. The timeouts are the JAX
package's single-instance host callbacks: at B = 1 the port gives the
same statuses and iteration counts; at B > 1, where the JAX package has
no counterpart, the lockstep batch's one clock is held to being
consistent with itself.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.interface.solver import AcadosOcpSolver as JaxSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_nlp.formulation import NlpData as JNlpData
from acados_tpu.ocp_nlp.linearize import NlpIterate as JNlpIterate
from acados_tpu.ocp_nlp.sqp import SqpOpts as JSqpOpts
from acados_tpu.ocp_nlp.sqp import make_sqp_solver as jax_make_sqp_solver
from acados_tpu_torch import AcadosOcpBatchSolver, AcadosOcpSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.sqp import SqpOpts, make_sqp_solver
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_torch_globalization import batch_data, rel_gap, zero_iterate
from test_torch_rti import _batch_at

torch.set_num_threads(1)

N = 8
X0S = (np.array([0.0, np.pi, 0.0, 0.0])
       + np.random.default_rng(3).normal(0.0, 0.2, (4, 4)))[:3]
PHASES = ("time_lin", "time_reg", "time_qp", "time_glob")


def _sqp(make, N=N, **so):
    ocp = make(N=N, dtype="float64", nlp_solver_type="SQP")
    for k, v in so.items():
        setattr(ocp.solver_options, k, v)
    return ocp


@pytest.mark.parametrize("max_iter", [50, 4])
def test_stored_iterates_match_jax_vmap(max_iter):
    """iterates_x/u of the port's batch-first solve against jax.vmap of
    the JAX solve at B = 3: every row within 1e-9, the rows after each
    instance stopped (zeros, as the vmapped while_loop leaves them)
    included; row 0 the initial iterate and row sqp_iter the returned
    one. At max_iter 4 every instance stops at the cap."""
    jform, dnp, _ = jax_build_ocp(_sqp(jax_pendulum_ocp))
    data = batch_data(dnp, X0S, 4)
    init = zero_iterate(jform, X0S)
    jsolve = jax.jit(jax.vmap(jax_make_sqp_solver(
        jform, JSqpOpts(max_iter=max_iter, store_iterates=True))))
    jit_, jst = jsolve(JNlpData(**{k: jnp.asarray(v)
                                   for k, v in data.items()}),
                       JNlpIterate(**{k: jnp.asarray(v)
                                      for k, v in init.items()}))
    form = build_ocp(_sqp(make_pendulum_ocp))[0]
    it, st = make_sqp_solver(form, SqpOpts(max_iter=max_iter,
                                           store_iterates=True))(
        data_to_torch(data, torch.float64, "cpu"),
        iterate_from_numpy(init, torch.float64, "cpu"))
    np.testing.assert_array_equal(st.sqp_iter.numpy(),
                                  np.asarray(jst.sqp_iter))
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(jst.status))
    for f in ("iterates_x", "iterates_u"):
        got, ref = getattr(st, f).numpy(), np.asarray(getattr(jst, f))
        assert got.shape == ref.shape == (3, max_iter + 1) + got.shape[2:]
        assert rel_gap(got, ref) <= 1e-9, f
    k = st.sqp_iter.numpy()
    assert len(set(k.tolist())) > 1 or max_iter == 4
    for b in range(3):
        assert torch.equal(st.iterates_x[b, 0], torch.as_tensor(init["x"][b]))
        assert torch.equal(st.iterates_x[b, k[b]], it.x[b])
        assert torch.equal(st.iterates_u[b, k[b]], it.u[b])
        assert not st.iterates_x[b, k[b] + 2:].any()
    # without the option, no history
    _, st0 = make_sqp_solver(form, SqpOpts(max_iter=max_iter))(
        data_to_torch(data, torch.float64, "cpu"),
        iterate_from_numpy(init, torch.float64, "cpu"))
    assert st0.iterates_x is None and st0.phase_times is None


def test_get_iterates_matches_jax():
    """get_iterates() of AcadosOcpSolver with store_iterates against the
    JAX solver's; options_set('store_iterates') turns it on."""
    ours = AcadosOcpSolver(_sqp(make_pendulum_ocp, store_iterates=True),
                           device="cpu")
    ref = JaxSolver(_sqp(jax_pendulum_ocp, store_iterates=True))
    assert ours.solve() == ref.solve() == 0
    got, want = ours.get_iterates(), ref.get_iterates()
    assert got["x"].shape == want["x"].shape == (
        ours.get_stats("sqp_iter") + 1, N + 1, 4)
    for f in ("x", "u"):
        assert rel_gap(got[f], want[f]) <= 1e-9, f
    plain = AcadosOcpSolver(_sqp(make_pendulum_ocp), device="cpu")
    assert plain.solve() == 0
    with pytest.raises(RuntimeError, match="store_iterates"):
        plain.get_iterates()
    plain.options_set("store_iterates", True)
    plain.reset()
    assert plain.solve() == 0
    np.testing.assert_array_equal(plain.get_iterates()["u"], got["u"])


def test_timeout_impossible_budget_matches_jax():
    """tests/test_options.py::TestPredictiveTimeout's impossible budget
    (1e-7 s, LAST) at B = 1: status 7 after the first iteration in both
    packages."""
    so = dict(timeout_max_time=1e-7, timeout_heuristic="LAST")
    ours = AcadosOcpSolver(_sqp(make_pendulum_ocp, **so), device="cpu")
    ref = JaxSolver(_sqp(jax_pendulum_ocp, **so))
    assert ours.solve() == ref.solve() == 7
    assert ours.get_stats("sqp_iter") == ref.get_stats("sqp_iter") < 5


@pytest.mark.parametrize("heur", ["ZERO", "LAST", "MAX", "AVERAGE"])
def test_timeout_generous_budget_matches_jax(heur):
    """A generous budget (120 s) with each heuristic: status 0 as in the
    JAX package, within 1e-9 of its solution, and bit for bit the port's
    solve without a timeout."""
    so = dict(timeout_max_time=120.0, timeout_heuristic=heur)
    ours = AcadosOcpSolver(_sqp(make_pendulum_ocp, **so), device="cpu")
    ref = JaxSolver(_sqp(jax_pendulum_ocp, **so))
    plain = AcadosOcpSolver(_sqp(make_pendulum_ocp), device="cpu")
    assert ours.solve() == ref.solve() == plain.solve() == 0
    assert ours.get_stats("sqp_iter") == ref.get_stats("sqp_iter")
    for f in ("x", "u", "pi", "lam", "sl", "su"):
        np.testing.assert_array_equal(ours.get_flat(f), plain.get_flat(f))
        assert rel_gap(ours.get_flat(f), ref.get_flat(f)) <= 1e-9, f


def test_timeout_options_set_and_batch():
    """options_set of the timeouts rebuilds the solve (as
    TestPredictiveTimeout.test_options_set_rebuilds), an unknown
    heuristic is refused and leaves the solver as it was; a lockstep
    batch has one clock: at the impossible budget every instance stops
    with status 7 after its first iteration, at a generous one the batch
    is bit for bit the batch without a timeout."""
    s = AcadosOcpSolver(_sqp(make_pendulum_ocp), device="cpu")
    assert s.solve() == 0
    with pytest.raises(ValueError, match="timeout_heuristic"):
        s.options_set("timeout_heuristic", "SOMETIMES")
    assert s.acados_ocp.solver_options.timeout_heuristic == "ZERO"
    s.options_set("timeout_heuristic", "MAX")
    s.options_set("timeout_max_time", 1e-7)
    assert s.opts.timeout_max_time == 1e-7
    assert s.acados_ocp.solver_options.timeout_heuristic == "MAX"
    s.reset()
    assert s.solve() == 7

    def batch(**so):
        return _batch_at(AcadosOcpBatchSolver(
            _sqp(make_pendulum_ocp, **so), 3, device="cpu"), X0S)

    tight = batch(timeout_max_time=1e-7, timeout_heuristic="LAST")
    np.testing.assert_array_equal(tight.solve(), [7, 7, 7])
    np.testing.assert_array_equal(tight.get_stats("sqp_iter"), [1, 1, 1])
    loose, plain = batch(timeout_max_time=120.0, timeout_heuristic="MAX"), \
        batch()
    np.testing.assert_array_equal(loose.solve(), plain.solve())
    for f in ("x", "u", "pi", "lam", "sl", "su"):
        np.testing.assert_array_equal(loose.get_flat(f), plain.get_flat(f))


def test_collect_phase_times_cover_the_solve():
    """collect_phase_times (tests/test_options.py::TestPhaseTimes): the
    four phases measured in the loop are positive and cover between half
    and all of time_tot, for AcadosOcpSolver and for a lockstep batch;
    time_sim is time_lin; the solve is bit for bit the one without."""
    s = AcadosOcpSolver(_sqp(make_pendulum_ocp, N=10,
                             collect_phase_times=True), device="cpu")
    assert s.solve() == 0
    s.reset()
    assert s.solve() == 0
    assert s.get_stats("sqp_iter") >= 5
    parts = [s.get_stats(k) for k in PHASES]
    assert all(p > 0.0 for p in parts), parts
    assert 0.5 < sum(parts) / s.get_stats("time_tot") <= 1.05
    assert s.get_stats("time_sim") == s.get_stats("time_lin")
    ref = AcadosOcpSolver(_sqp(make_pendulum_ocp, N=10), device="cpu")
    assert ref.solve() == 0
    for f in ("x", "u", "pi"):
        np.testing.assert_array_equal(s.get_flat(f), ref.get_flat(f))

    b = _batch_at(AcadosOcpBatchSolver(
        _sqp(make_pendulum_ocp, collect_phase_times=True), 3, device="cpu"),
        X0S)
    assert np.all(b.solve() == 0)
    parts = [b.get_stats(k) for k in PHASES]
    assert all(p > 0.0 for p in parts), parts
    assert 0.5 < sum(parts) / b.get_stats("time_tot") <= 1.05


def test_phase_time_stats_on_both_solvers():
    """get_stats('time_*') without collect_phase_times, on both port
    solvers (the JAX package's keys): finite and non-negative, from
    isolated re-execution (AcadosOcpSolver) and differencing
    (AcadosOcpBatchSolver, time_sim == time_lin, time_reg 0 inside the
    QP's), cached per solve."""
    keys = PHASES + ("time_sim",)
    s = AcadosOcpSolver(_sqp(make_pendulum_ocp), device="cpu")
    assert s.solve() == 0
    got = {k: s.get_stats(k) for k in keys}
    assert all(np.isfinite(v) and v >= 0.0 for v in got.values()), got
    assert s.get_stats("time_qp") == got["time_qp"]   # cached
    b = _batch_at(AcadosOcpBatchSolver(
        make_pendulum_ocp(N=N, dtype="float64", nlp_solver_type="SQP_RTI"),
        3, device="cpu"), X0S)
    assert np.all(b.solve() == 0)
    got = {k: b.get_stats(k) for k in keys}
    assert all(np.isfinite(v) and v >= 0.0 for v in got.values()), got
    assert got["time_sim"] == got["time_lin"] and got["time_reg"] == 0.0


def _table(text: str):
    """(header, rows of floats) of a printed statistics table."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return lines[0], [[float(v) for v in re.split(r"\s+", ln.strip())]
                      for ln in lines[1:]]


def test_print_statistics_matches_jax(capsys):
    """print_level = 1 prints the table after solve(), and
    print_statistics() prints it on demand, with the JAX package's
    header and columns; the printed numbers equal the JAX package's to
    the printed precision (absolutely within 1e-9 where they are at
    rounding level), the statistics matrix within 1e-9."""
    ours = AcadosOcpSolver(_sqp(make_pendulum_ocp, print_level=1),
                           device="cpu")
    ref = JaxSolver(_sqp(jax_pendulum_ocp, print_level=1))
    capsys.readouterr()
    assert ours.solve() == 0
    printed = capsys.readouterr().out
    assert ref.solve() == 0
    printed_ref = capsys.readouterr().out
    head, rows = _table(printed)
    head_ref, rows_ref = _table(printed_ref)
    assert head == head_ref and "res_stat" in head
    assert len(rows) == len(rows_ref) == ours.get_stats("sqp_iter") + 1
    # printed to 4 digits; entries at rounding level (res_eq ~1e-15)
    # differ in those digits, within the statistics' 1e-9 below
    np.testing.assert_allclose(rows, rows_ref, rtol=1e-3, atol=1e-9)
    assert rel_gap(ours.get_stats("statistics"),
                   np.asarray(ref.get_stats("statistics"))) <= 1e-9
    ours.print_statistics()
    assert capsys.readouterr().out == printed
    ours.options_set("print_level", 0)
    ours.solve()
    assert capsys.readouterr().out == ""


def test_dump_qp_to_file_matches_jax(tmp_path):
    """dump_qp_to_file after a solve in both packages: the same 19 keys
    and shapes, every array within 1e-9."""
    ours = AcadosOcpSolver(_sqp(make_pendulum_ocp), device="cpu")
    ref = JaxSolver(_sqp(jax_pendulum_ocp))
    assert ours.solve() == ref.solve() == 0
    ours.dump_qp_to_file(str(tmp_path / "ours.npz"))
    ref.dump_qp_to_file(str(tmp_path / "jax.npz"))
    got, want = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 19
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        assert rel_gap(got[k], want[k]) <= 1e-9, k
