"""PyTorch port, batch sharding over devices and processes
(acados_tpu_torch/parallel/, AcadosOcpBatchSolver(devices=...)): the
counterpart of tests/test_sharding.py on the CPU in float64. Repeated
"cpu" entries stand where the JAX tests use 8 virtual CPU devices; each
shard runs in a thread of its own. Sharded and unsharded solves agree
per instance (equal statuses and iteration counts, 1e-9), and with the
JAX package at 1e-9; two processes over gloo solve their slices of one
batch.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.batch_solver import AcadosOcpBatchSolver as JaxBatch
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_qp.ipm import IpmOpts as JIpmOpts
from acados_tpu.ocp_qp.ipm import solve_ocp_qp as jax_solve_ocp_qp
from acados_tpu.parallel.mesh import batch_pad as jax_batch_pad
from acados_tpu_torch import AcadosOcpBatchSolver
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.linearize import NlpIterate
from acados_tpu_torch.ocp_qp import data as tdata
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
from acados_tpu_torch.ops import batched_chol, batched_inv, cuda_build
from acados_tpu_torch.parallel.distributed import (all_reduce_status_counts,
                                                   global_batch_mesh,
                                                   global_max_residual,
                                                   initialize_distributed,
                                                   process_local_batch_slice)
from acados_tpu_torch.parallel.mesh import (BATCH_AXIS, batch_pad,
                                            gather_batch, make_batch_mesh,
                                            map_shards, shard_batch)
from acados_tpu_torch.testing import rti_batch, slice_solve_worker
from acados_tpu_torch.utils.device import wait_any

from test_ocp_qp import random_ocp_qp

torch.set_num_threads(1)

requires_8dev = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

QP_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg", "ug",
             "mask_l", "mask_u", "Zl", "Zu", "zl", "zu", "soft_mask")
FIELDS = ("x", "u", "pi")
B = 8
X0S = np.tile(np.array([0.0, np.pi, 0.0, 0.0]), (B, 1))
X0S[:, 1] += np.linspace(-0.05, 0.05, B)


def _gap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b)), initial=0.0))


# -- the mesh helpers --------------------------------------------------------

def test_mesh_helpers():
    """batch_pad as the JAX function; shard_batch then gather_batch is the
    identity on a dataclass with a None field; make_batch_mesh() is every
    visible card and raises without CUDA; an uneven batch raises."""
    assert BATCH_AXIS == "batch"
    for n, d in ((16, 8), (10, 8), (1, 4), (4096, 2), (7, 3)):
        assert batch_pad(n, d) == jax_batch_pad(n, d)
    mesh = make_batch_mesh(["cpu"] * 4)
    assert mesh == (torch.device("cpu"),) * 4
    rng = np.random.default_rng(0)
    it = NlpIterate(**{f.name: torch.as_tensor(rng.normal(size=(8, 3, 2)))
                       for f in dataclasses.fields(NlpIterate)})
    it = it.replace(sl=None)
    pieces = shard_batch((it, it.x), mesh)
    assert len(pieces) == 4
    assert all(p[0].x.shape == (2, 3, 2) and p[0].sl is None
               for p in pieces)
    back, x = gather_batch(pieces, mesh[0])
    assert back.sl is None and torch.equal(x, it.x)
    for f in ("x", "u", "pi", "lam_l", "lam_u", "su"):
        assert torch.equal(getattr(back, f), getattr(it, f))
    with pytest.raises(ValueError, match="batch_pad"):
        shard_batch(torch.zeros(6, 2), make_batch_mesh(["cpu"] * 4))
    if torch.cuda.is_available():
        assert len(make_batch_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_batch_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_batch_mesh(["cuda:0"])


def test_map_shards_raises_a_shards_exception():
    """A shard's exception reaches the caller, after every shard ran."""
    ran = []

    def fn(x):
        ran.append(float(x[0]))
        if float(x[0]) == 2.0:
            raise FloatingPointError("shard 1")
        return x

    with pytest.raises(FloatingPointError, match="shard 1"):
        map_shards(fn, make_batch_mesh(["cpu"] * 4), torch.arange(8.0))
    assert sorted(ran) == [0.0, 2.0, 4.0, 6.0]


def test_shards_take_turns_between_waits():
    """Over 4 CPU shards at most one runs host code at a time: a shard
    hands the turn on only in wait_any, the lockstep loops' sync."""
    inside, most, waits = [0], [0], []

    def fn(x):
        for r in range(5):
            inside[0] += 1
            most[0] = max(most[0], inside[0])
            time.sleep(0.002)
            inside[0] -= 1
            waits.append(wait_any(x > r))
        return x

    out = map_shards(fn, make_batch_mesh(["cpu"] * 4), torch.arange(8))
    assert torch.equal(out, torch.arange(8))
    assert most[0] == 1 and len(waits) == 20
    assert wait_any(torch.tensor([False, True]))


def test_qp_batch_sharded_matches_single_device_and_jax():
    """16 random QPs (tests/test_sharding.py's) through the port's IPM
    over 8 shards: bit for bit the unsharded port, and against jax.vmap of
    the JAX IPM equal statuses and iterations. Their x0 rows (lg == ug)
    are held by the barrier, not eliminated, so lam / t grows without
    bound there: the JAX package's own x and u move by up to 3.2e-8 under
    one rounding step of the inputs, and its single solve and its vmap
    part by 3.2e-9 (instance 5). x and u are held to 4 x that spread
    (the repo's rule for barrier-held rows; the port's gap is 6.0e-9)."""
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    qps = [random_ocp_qp(k, N=6, nx=3, nu=2, nc=2) for k in keys]
    qp_j = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    jsolve = jax.jit(jax.vmap(
        lambda q: jax_solve_ocp_qp(q, JIpmOpts(iter_max=50))))
    sol_j, info_j = jsolve(qp_j)
    rng = np.random.default_rng(0)
    sol_m, _ = jsolve(jax.tree.map(lambda a: a * (1 + np.finfo(
        np.float64).eps * rng.choice((-1.0, 1.0), a.shape)), qp_j))
    qp = tdata.OcpQp(**{k: torch.as_tensor(np.array(getattr(qp_j, k)))
                        for k in QP_FIELDS})
    solve = lambda q: solve_ocp_qp(q, IpmOpts(iter_max=50))
    sol_1, info_1 = solve(qp)
    sol_8, info_8 = map_shards(solve, make_batch_mesh(["cpu"] * 8), qp)
    for f in ("status", "num_iter"):
        assert torch.equal(getattr(info_8, f), getattr(info_1, f))
        np.testing.assert_array_equal(getattr(info_8, f).numpy(),
                                      np.asarray(getattr(info_j, f)))
    for f in ("x", "u", "pi", "lam_lg", "t_lg"):
        assert torch.equal(getattr(sol_8, f), getattr(sol_1, f)), f
    for f in ("x", "u"):
        spread = _gap(getattr(sol_m, f), getattr(sol_j, f))
        assert 1e-9 < spread
        assert _gap(getattr(sol_8, f), getattr(sol_j, f)) <= 4 * spread


# -- the batch solver ------------------------------------------------------

def _sqp(make):
    """tests/test_sharding.py's pendulum MERIT SQP (N = 20) with its cost
    weights scaled by 1e-3, as tests/test_torch_globalization.py scales
    them: at its own weights the merit's changes near the solution are a
    few rounding steps wide, so which alpha passes follows the order of
    the sums, and the JAX package's sharded and unsharded solves already
    part (sqp_iter 26/31 against 26/29 on instances 0, 1)."""
    ocp = make(N=20, nlp_solver_type="SQP")
    ocp.solver_options.globalization = "MERIT_BACKTRACKING"
    ocp.cost.W = 1e-3 * np.asarray(ocp.cost.W)
    ocp.cost.W_e = 1e-3 * np.asarray(ocp.cost.W_e)
    return ocp


@pytest.fixture(scope="module")
def merit_pair():
    """The B = 8 pendulum MERIT SQP solved by the port unsharded and over
    4 shards."""
    one = rti_batch(_sqp(make_pendulum_ocp), X0S, None, devices=["cpu"])
    four = rti_batch(_sqp(make_pendulum_ocp), X0S, None,
                     devices=["cpu"] * 4)
    st_1, st_4 = one.solve(), four.solve()
    return one, four, st_1, st_4


def test_sqp_batch_sharded_matches_single_device(merit_pair):
    one, four, st_1, st_4 = merit_pair
    assert len(four.mesh) == 4 and len(one.mesh) == 1
    assert np.all(st_1 == 0)
    np.testing.assert_array_equal(st_4, st_1)
    for field in ("sqp_iter", "qp_iter"):
        np.testing.assert_array_equal(four.get_stats(field),
                                      one.get_stats(field))
    it_1, it_4 = one._host_iterate(), four._host_iterate()
    for f in FIELDS:
        assert _gap(it_4[f], it_1[f]) <= 1e-9, f
    # gathered on the mesh's first device; get through the views
    assert four._it_dev.x.device == four.device == torch.device("cpu")
    assert four.get_stats("time_tot") > 0
    for i in (0, 5):
        for f in FIELDS:
            assert _gap(four.ocp_solvers[i].get(3, f),
                        one.ocp_solvers[i].get(3, f)) <= 1e-9


@requires_8dev
def test_sqp_batch_sharded_matches_jax_sharded(merit_pair):
    """Against the JAX batch solver sharded over 8 devices."""
    _, four, _, st_4 = merit_pair
    ref = JaxBatch(_sqp(jax_pendulum_ocp), B, devices=jax.devices()[:8])
    for i, view in enumerate(ref.ocp_solvers):
        view.set(0, "lbx", X0S[i])
        view.set(0, "ubx", X0S[i])
        for k in range(21):
            view.set(k, "x", X0S[i])
    st_ref = ref.solve()
    assert len(ref.mesh.devices.flat) == 8
    np.testing.assert_array_equal(st_4, st_ref)
    np.testing.assert_array_equal(four.get_stats("sqp_iter"),
                                  np.asarray(ref._stats.sqp_iter))
    it = four._host_iterate()
    for f in FIELDS:
        assert _gap(it[f], ref._iterate[f]) <= 1e-9, f


def test_sensitivities_after_sharded_solve(merit_pair):
    """eval_solution_sensitivity at the gathered iterate equals the
    unsharded solver's."""
    one, four, _, _ = merit_pair
    for a, b in zip(four.eval_solution_sensitivity([0, 7], "initial_state"),
                    one.eval_solution_sensitivity([0, 7], "initial_state")):
        assert _gap(a, b) <= 1e-9


def test_rti_phases_after_sharded_solve():
    """An SQP_RTI batch over 4 shards: two sharded solve() calls, then
    prepare()/feedback(x0) on the gathered iterate, each equal to the
    unsharded batch's."""
    x0s = X0S.copy()
    kw = dict(N=8, dtype="float64", nlp_solver_type="SQP_RTI")
    one = rti_batch(make_pendulum_ocp(**kw), x0s, None, devices=["cpu"])
    four = rti_batch(make_pendulum_ocp(**kw), x0s, None,
                     devices=["cpu"] * 4)
    for _ in range(2):
        np.testing.assert_array_equal(four.solve(), one.solve())
        np.testing.assert_array_equal(four.get_stats("qp_iter"),
                                      one.get_stats("qp_iter"))
    x0s[:, 1] -= 0.01
    for s in (one, four):
        s.prepare()
    np.testing.assert_array_equal(four.feedback(x0=x0s),
                                  one.feedback(x0=x0s))
    np.testing.assert_array_equal(four.get_stats("qp_iter"),
                                  one.get_stats("qp_iter"))
    it_1, it_4 = one._host_iterate(), four._host_iterate()
    for f in FIELDS:
        assert _gap(it_4[f], it_1[f]) <= 1e-9, f


def test_device_and_devices_together_raise():
    with pytest.raises(ValueError, match="not both"):
        AcadosOcpBatchSolver(make_pendulum_ocp(N=4), 2, device="cpu",
                             devices=["cpu"])


def test_uneven_batch_solves_unsharded():
    """N_batch that does not divide by the mesh solves on mesh[0], as the
    JAX solver does."""
    kw = dict(N=4, dtype="float64", nlp_solver_type="SQP_RTI")
    three = rti_batch(make_pendulum_ocp(**kw), X0S[:3], None,
                      devices=["cpu"] * 2)
    one = rti_batch(make_pendulum_ocp(**kw), X0S[:3], "cpu")
    np.testing.assert_array_equal(three.solve(), one.solve())
    assert _gap(three._host_iterate()["x"], one._host_iterate()["x"]) == 0


# -- thread safety of the kernels' shared state -----------------------------

def test_load_builds_once_under_threads(monkeypatch, tmp_path):
    """Two threads loading one kernel library: the process-wide lock lets
    one build it (a stub build here) while the other waits, and both get
    the same handle."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    inside, most, builds = [0], [0], []
    gate = threading.Barrier(2)

    def stub_build(names):
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        builds.append(list(names))
        threading.Event().wait(0.2)
        for name in names:
            cuda_build.target(name).write_bytes(b"")
        inside[0] -= 1
        return {}

    monkeypatch.setattr(cuda_build, "_build", stub_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    got = [None, None]

    def run(i):
        gate.wait(timeout=10)
        got[i] = cuda_build.load("gj_inverse")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["gj_inverse"]] and most[0] == 1
    assert got[0] is got[1] is not None


class _SlowReads(dict):
    """A counter dict whose reads let other threads run, so that a
    read-modify-write without a lock loses updates (CPython switches
    threads only at calls and backward jumps)."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


@pytest.mark.parametrize("counter", ["batched_inv", "batched_chol",
                                     "interleaved"])
def test_launch_counts_exact_under_threads(monkeypatch, counter):
    """8 threads counting launches through count_launch, the switch
    interval shortened: every count kept, on K1's module counter, on
    K2-K4's dict and on a dict whose reads switch threads (without the
    lock that one kept 2008 of 16,000)."""
    per = 2000
    if counter == "batched_inv":
        monkeypatch.setattr(batched_inv, "LAUNCHES", 0)
        counts, key, per = vars(batched_inv), "LAUNCHES", 20_000
    elif counter == "batched_chol":
        monkeypatch.setattr(batched_chol, "LAUNCHES", {"chol_factor": 0})
        counts, key, per = batched_chol.LAUNCHES, "chol_factor", 20_000
    else:
        counts, key = _SlowReads(n=0), "n"

    def run():
        for _ in range(per):
            cuda_build.count_launch(counts, key)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts[key] == 8 * per


# -- processes ---------------------------------------------------------------

class TestDistributedHelpers:
    """Single process (tests/test_sharding.py's TestDistributedHelpers)."""

    def test_initialize_idempotent(self, monkeypatch):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert initialize_distributed() == 1
        assert initialize_distributed() == 1

    def test_local_batch_slice_covers(self):
        assert process_local_batch_slice(100) == (0, 100)

    def test_status_counts_and_residual(self):
        counts = all_reduce_status_counts(np.array([0, 0, 1, 2, 0, 4]))
        assert counts[0] == 3 and counts[1] == 1 and counts[4] == 1
        assert counts.shape == (8,) and counts.sum() == 6
        assert global_max_residual(np.array([1e-3, 2e-5])) == 1e-3
        np.testing.assert_array_equal(
            all_reduce_status_counts(torch.tensor([7, 7, 0])),
            [1, 0, 0, 0, 0, 0, 0, 2])

    def test_global_batch_mesh(self):
        if torch.cuda.is_available():
            assert len(global_batch_mesh()) >= 1
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                global_batch_mesh()


def test_two_processes_over_gloo(tmp_path):
    """Two processes (spawned, a file:// rendezvous) each solve their
    slice of a B = 4 pendulum RTI batch (N = 8): the slices of 100 are
    (0, 50) and (50, 100), the summed status histogram and the largest
    res_stat are the whole batch's, and each rank's x and u equal those
    rows of the whole-batch solve."""
    import torch.multiprocessing as mp
    kw = dict(N=8, dtype="float64", nlp_solver_type="SQP_RTI")
    x0s, calls = X0S[::2].copy(), 3
    init = f"file://{tmp_path / 'rendezvous'}"
    mp.spawn(slice_solve_worker, nprocs=2, join=True,
             args=(init, 2, kw, x0s, calls, "cpu", str(tmp_path)))
    whole = rti_batch(make_pendulum_ocp(**kw), x0s, "cpu")
    for _ in range(calls):
        status = whole.solve()
    it = whole._host_iterate()
    res_max = float(whole.get_stats("residuals")[:, 0].max())
    for rank, want in enumerate(((0, 50), (50, 100))):
        out = np.load(tmp_path / f"rank{rank}.npz")
        assert int(out["n"]) == 2
        assert tuple(out["slice100"]) == want
        start, stop = out["slice"]
        assert (start, stop) == (2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(out["status"], status[start:stop])
        np.testing.assert_array_equal(
            out["counts"], np.bincount(status, minlength=8))
        assert float(out["res_max"]) == pytest.approx(res_max, rel=1e-9)
        for f in ("x", "u"):
            assert _gap(out[f], it[f][start:stop]) <= 1e-9, f
