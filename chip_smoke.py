#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, in order; any
failure exits non-zero:
 1. device: the card's name and power limit (nvidia-smi), torch/CUDA
    versions, TF32 off;
 2. build: every CUDA kernel of acados_tpu_torch/csrc/ with nvcc for
    sm_90a (one nvcc per source, all started together);
 3. kernels against their plain PyTorch versions on the card: the
    Gauss-Jordan inverse K1 on the IRK stage Jacobians of the main path
    (81,920 x 16 x 16 float32), on seeded diagonally dominant batches
    (n = 2, 4, 8, 16 for its group branch, n = 9, 21, 29, 39, 48 for its
    warp branch, a ragged batch size, n = 56 through the Schur path), on
    the same with rows permuted (row swaps at most steps), in float32 and
    float64, on matrices with equal magnitudes in their pivot columns,
    where exact arithmetic makes kernel, plain version and exact inverse
    agree bit for bit only under the lowest-index tie rule, and on the
    edge cases of both branches (every n = 1..48 at B = 7; B = 1, 2, 3,
    33 at n = 9, 29, 39, 48; B = 1, 2, 3, 33, 65, 1023 at n = 2, 4, 8,
    16; n = 2, 3, 16 at B = 200,003; a misaligned input at n = 2 and 16);
    linsolve on the card launching K1 for small n too; then K1's time at
    the main-path shape beside its bound, the plain version and
    torch.linalg.inv, and over both branches' grid (n = 9, 21, 29, 39, 48
    x B = 1024, 10240 and n = 2, 4, 8, 16 x B = 10240, 81920 float32,
    (10240, 39, 39) and (81920, 16, 16) float64) beside the branches they
    replaced;
 4. main path: AcadosOcpBatchSolver on the canonical pendulum IRK SQP-RTI
    config (N = 20, float32) at B = 4096, 1 cold + 15 warm + timed
    solve() calls; every status 0, the float32 tolerances met, and exactly
    8 kernel launches per RTI call; then where the time of a call goes
    (layers on the host clock, device busy share from torch.profiler);
 5. reference check: the same config in float64 at B = 8 on the card and
    on the CPU (the port's plain path, which the CPU tests hold against
    the JAX package) must agree;
 6. full-condensing path: the same config with qp_solver =
    "FULL_CONDENSING_HPIPM" (full condensing, then the dense IPM, whose
    barrier Hessian is factored by the Cholesky kernel K2 once per
    lockstep round) at B = 4096 float32, 1 cold + 15 warm + timed calls;
    every status 0, in tolerance, K1 at 8 launches per call and K2 at the
    sum over calls of the batch's largest qp_iter; then where the time
    goes (linearize, condense, dense IPM, expand);
 7. the Cholesky kernels K2 (factor), K3 (solve) and K4 (fused) against
    their plain versions: the barrier Hessians captured from phase 6's
    first dense-IPM round (4096 x 24 x 24), seeded SPD batches at n = 1,
    4, 13, 24, 39, 64 with a ragged B = 1001, in float32 and float64, and
    a batch mixing SPD with indefinite and non-finite matrices, which
    must come back NaN throughout; K2, K3 and K4 bit for bit (NaN in the
    same matrices), float32 and float64, on the barrier Hessians, every
    n = 1..32 at B = 7, B = 1, 2, 3, 5, 33, 1023 at n = 4, 8, 16, 24, 32,
    B = 200,003 at n = 4 and 24, misaligned inputs at n = 24 and 13, and
    the indefinite and non-finite batches at n = 4, 13, 24 with a bad
    matrix in every group position (K3 also on factors with NaN and inf
    above the diagonal and with a zero or NaN diagonal); then their times
    at (4096, 24, 24) float32 beside their bounds, the plain versions and
    the library's Cholesky calls (CUDA events around one call, and the
    device time of the call's kernels), and the grid of each (n = 4, 8, 13, 16, 24, 32 x
    B = 4096, 65536 float32, (4096, 24, 24) float64, n = 39, 64 at
    B = 4096) beside the replaced kernels' figures and the library call;
 8. the public ops entry points (chol_factor_batched, chol_solve_batched,
    chol_factor_solve_batched: K3 and K4 have no solver caller) on the
    barrier Hessians of phase 6 in float64, one launch each, against the
    plain fused version;
 9. reference check of the full-condensing path: float64, B = 8, card
    against CPU;
10. the Riccati IPM with a free initial state at nx = 16 (P_0 factored by
    K2, one launch a round), float64, card against CPU; with K2 on that
    run's P_0 against its plain version, the same solve on the card with
    the plain version in K2's place, and the CPU's own spread on inputs
    moved by one rounding step, beside it;
11. chain path: AcadosOcpBatchSolver on make_chain_mass_ocp(n_mass=8,
    N=40) (nx = 39, nu = 3, the Kronecker IRK path) in float32 at B = 256,
    x0 = steady state + N(0, 0.02), 1 cold + 15 warm + timed calls; every
    status 0, bench.py's chain tolerances met, K1 exactly 2 launches a call
    of (10240, 39, 39), K2 and K5 none; K1 on the captured block
    determinants against its plain version, and its time there; then
    where the time of a call goes;
12. chain sweep: n_mass = 3, 5, 11 (nx = 9, 21, 57) at B = 256, N = 40,
    1 cold + 15 warm calls; every status 0 and in tolerance, K1 at 2
    launches a call (4 at nx = 57: two n = 29 inverses of the Schur
    recursion per determinant);
13. the small-matrix product K5 against its plain version, bit for bit:
    on phase 11's dynamics Jacobians (A @ A at (10240, 39, 39)), on seeded
    batches at n = 1, 20, 39, 48, 64 with B = 1001 in float32 and float64,
    on a batch with NaN and infinite entries, and on the edge cases of its
    pair groups and padded tiles (n = 1, 7, 39, 40, 64 at B = 1, 2, 3, 5,
    1023, and n = 1, 7 at B = 200,003); then its device time beside
    torch.bmm's and the bound over the microbenchmark's grid (n = 20, 39,
    48, 64 x B = 256 ... 10240), and at the chain's shape in float64;
14. chain reference check: float64, n_mass = 8, N = 40, B = 4, 3 RTI
    calls, card against CPU, beside the CPU's own spread under one
    rounding step of the x0s;
15. the quadrotor (N = 20) and race car (N = 30, Tf = 0.6) ERK RTI batches
    at B = 1024, x0 spreads 0.05 and 0.01, 1 cold + 20 warm calls; every
    status 0, within stat 5e-3 and eq 1e-4, no kernel launches.
The last lines are the kernels JSON line, the card line and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B_MAIN = 4096
N_HORIZON = 20
WARM_CALLS = 15
TIMED_CALLS = 12
LAUNCHES_PER_RTI = 8          # 4 inverses per substep x 2 substeps
X0_CENTER = (0.0, np.pi, 0.0, 0.0)
X0_SIGMA = 0.05
SEED = 0
FULL_COND = "FULL_CONDENSING_HPIPM"
# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12            # outside the tensor cores
F32_BOUND = 1e-4
F64_BOUND = 1e-12
# the chain entry of bench.py: n_mass = 8 (nx = 39), B = 256, N = 40, x0
# spread 0.02 around the steady state, and its float32 tolerances
# (stat, eq, ineq, comp)
N_MASS, B_CHAIN, N_CHAIN, CHAIN_SIGMA = 8, 256, 40, 0.02
CHAIN_TOLS = (1e-2, 1e-4, 1e-3, 1e-2)
K1_PER_CHAIN_CALL = 2         # one block-determinant inverse per substep
# bench.py's quadrotor and race car entries: (builder, x0 spread, OCP
# keywords), gated at stat 5e-3 and eq 1e-4
ERK_MODELS = (("quadrotor", 0.05, dict(N=20)),
              ("race_car", 0.01, dict(N=30, Tf=0.6)))
ERK_TOLS = (5e-3, 1e-4, np.inf, np.inf)
B_ERK = 1024
# K5's edge cases: n at the start, inside and at the end of a band of the
# kernel's padded sizes (one n in each band: 4, 8, 16, ..., 64), batches
# that end inside a pair group (4 k + 3 among them), a long batch with
# more groups than resident blocks, and every n at a short ragged batch
K5_EDGE_N = (1, 7, 13, 20, 29, 39, 40, 48, 53, 64)
K5_EDGE_B = (1, 2, 3, 5, 1023)
K5_LONG_B = 200_003
K5_SWEEP_B = 7
# K1's warp branch (every n <= 48 but 2, 4, 8, 16): the n of its checks
# and grid (one in each band from 16 to 48), the n and batches of its
# edge cases (batches that end inside a block of warps), the long batch
# and the short batch every n runs at
K1_BRANCH_N = (9, 21, 29, 39, 48)
K1_EDGE_N = (9, 29, 39, 48)
K1_EDGE_B = (1, 2, 3, 33)
K1_LONG_B = 200_003
K1_SWEEP_B = 7
K1_GRID_B = (1024, 10240)
# K1's group branch (n = 2, 4, 8, 16): batches that end inside a group of
# lanes, a warp and a block of warps, the n of the long batch beside the
# warp branch's n = 3, and the batches of its grid
K1_GROUP_N = (2, 4, 8, 16)
K1_GROUP_EDGE_B = (1, 2, 3, 33, 65, 1023)
K1_LONG_N = (2, 3, 16)
K1_GROUP_GRID_B = (10240, 81920)
# the branch K1's warp branch replaced (one warp a matrix, [A | I] in
# shared memory): device ms back to back over k1_grid's cells, by (n, B,
# type), from k1_compare.py (NVIDIA H100 80GB HBM3, 700.00 W), for the log
# lines only
K1_PARENT_DEVICE_MS = {
    (9, 1024, "float32"): 0.0145, (9, 10240, "float32"): 0.0394,
    (21, 1024, "float32"): 0.0477, (21, 10240, "float32"): 0.1833,
    (29, 1024, "float32"): 0.0750, (29, 10240, "float32"): 0.3177,
    (39, 1024, "float32"): 0.1628, (39, 10240, "float32"): 0.8959,
    (48, 1024, "float32"): 0.2298, (48, 10240, "float32"): 1.8106,
    (39, 10240, "float64"): 1.7107}
# the same branch at the chain's shape, on the chain's block determinants
# (chip_smoke.py phase 11; NVIDIA H100 80GB HBM3, 700.00 W)
K1_PARENT_CHAIN_DEVICE_MS = 0.9014
# the branch K1's group branch replaced ([A | I] in registers, a column a
# lane): device ms back to back over k1_grid's group cells, from
# k1_compare.py, and on the main path's stage Jacobians, from this
# script (NVIDIA H100 80GB HBM3, 700.00 W), for the log lines only
K1_PARENT_GROUP_DEVICE_MS = {
    (2, 10240, "float32"): 0.0056, (2, 81920, "float32"): 0.0071,
    (4, 10240, "float32"): 0.0065, (4, 81920, "float32"): 0.0133,
    (8, 10240, "float32"): 0.0108, (8, 81920, "float32"): 0.0439,
    (16, 10240, "float32"): 0.0341, (16, 81920, "float32"): 0.2175,
    (16, 81920, "float64"): 0.4028}
K1_PARENT_MAIN_DEVICE_MS = 0.2793
# K2's row branch (n <= 32, bands 4, 8, 16, 24, 32): an n in each band
# with the batches that end inside a group, a warp and a block of warps,
# the long batches, the short batch every n <= 32 runs at, and K2's grid
# (K2_WIDE_N: the shared-memory kernel above the row branch)
K2_ROW_N = (4, 8, 16, 24, 32)
K2_EDGE_B = (1, 2, 3, 5, 33, 1023)
K2_LONG_N = (4, 24)
K2_LONG_B = 200_003
K2_SWEEP_B = 7
K2_GRID_N = (4, 8, 13, 16, 24, 32)
K2_GRID_B = (4096, 65536)
K2_WIDE_N = (39, 64)
# the K2 the row branch replaced (one warp a matrix, left-looking, in
# shared memory): device ms back to back over chol_grid's cells, by (n, B,
# type), from k2_compare.py (NVIDIA H100 80GB HBM3, 700.00 W), for the log
# lines only
K2_PARENT_DEVICE_MS = {
    (4, 4096, "float32"): 0.0073, (4, 65536, "float32"): 0.0383,
    (8, 4096, "float32"): 0.0101, (8, 65536, "float32"): 0.0738,
    (13, 4096, "float32"): 0.0152, (13, 65536, "float32"): 0.1376,
    (16, 4096, "float32"): 0.0178, (16, 65536, "float32"): 0.1727,
    (24, 4096, "float32"): 0.0289, (24, 65536, "float32"): 0.3156,
    (32, 4096, "float32"): 0.0423, (32, 65536, "float32"): 0.4870,
    (24, 4096, "float64"): 0.0329, (39, 4096, "float32"): 0.0645,
    (64, 4096, "float32"): 0.2332}
# the K3 and K4 the row branch replaced (one warp a matrix in shared
# memory, the back substitution on one lane): device ms back to back over
# chol_grid's cells, by (n, B, type), from k2_compare.py (NVIDIA H100 80GB
# HBM3, 700.00 W), for the log lines only
K3_PARENT_DEVICE_MS = {
    (4, 4096, "float32"): 0.0087, (4, 65536, "float32"): 0.0491,
    (8, 4096, "float32"): 0.0119, (8, 65536, "float32"): 0.0907,
    (13, 4096, "float32"): 0.0169, (13, 65536, "float32"): 0.1590,
    (16, 4096, "float32"): 0.0198, (16, 65536, "float32"): 0.1993,
    (24, 4096, "float32"): 0.0304, (24, 65536, "float32"): 0.3438,
    (32, 4096, "float32"): 0.0373, (32, 65536, "float32"): 0.4440,
    (24, 4096, "float64"): 0.0389, (39, 4096, "float32"): 0.0514,
    (64, 4096, "float32"): 0.1576}
K4_PARENT_DEVICE_MS = {
    (4, 4096, "float32"): 0.0110, (4, 65536, "float32"): 0.0794,
    (8, 4096, "float32"): 0.0168, (8, 65536, "float32"): 0.1586,
    (13, 4096, "float32"): 0.0261, (13, 65536, "float32"): 0.2840,
    (16, 4096, "float32"): 0.0318, (16, 65536, "float32"): 0.3576,
    (24, 4096, "float32"): 0.0520, (24, 65536, "float32"): 0.6260,
    (32, 4096, "float32"): 0.0703, (32, 65536, "float32"): 0.8669,
    (24, 4096, "float64"): 0.0650, (39, 4096, "float32"): 0.1041,
    (64, 4096, "float32"): 0.3214}
# K5 at (10240, 39, 39) float32, device ms back to back, before the
# register-tiled design (one output a thread; NVIDIA H100 80GB HBM3,
# 700.00 W), for the log line only
K5_PREVIOUS_DEVICE_MS = 0.2336


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float:
    """Median device time (ms) of one fn() call, the calls queued back to
    back behind a spin kernel that holds the stream until all of them are
    queued: the events between the calls then time the card alone, not
    the host's launch time, which CUDA events around a short kernel on an
    idle card also count. The spin doubles until the host has queued
    every call before the first event is reached."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(cycles)
        ev[0].record()
        for r in range(reps):
            fn()
            ev[r + 1].record()
        queued_in_time = not ev[0].query()
        torch.cuda.synchronize()
        if queued_in_time:
            return float(np.median([ev[r].elapsed_time(ev[r + 1])
                                    for r in range(reps)]))
        if cycles >= 1 << 32:
            raise SystemExit("device_ms: the host could not queue "
                             f"{reps} calls ahead of the card")
        cycles *= 2


def kernel_busy_ms(fn, calls: int = 10) -> float:
    """Device time (ms) of one fn() call as the sum of the CUDA kernels it
    launches (torch.profiler, mean over `calls` calls): for a library
    call that waits for the host inside, which device_ms cannot queue."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / calls


def bound_of(bytes_moved: float, flops: float, peak: float = FP32_FLOPS):
    """The least time the card could take (ms) and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def reset_counts():
    """Every kernel's launch count to 0."""
    from acados_tpu_torch.ops import batched_chol, batched_inv, small_mm
    batched_inv.LAUNCHES = 0
    small_mm.LAUNCHES = 0
    for k in batched_chol.LAUNCHES:
        batched_chol.LAUNCHES[k] = 0


def read_counts() -> dict:
    from acados_tpu_torch.ops import batched_chol, batched_inv, small_mm
    return dict(gj_inverse=batched_inv.LAUNCHES, **batched_chol.LAUNCHES,
                small_mm=small_mm.LAUNCHES)


class K1Shapes:
    """While active, records the shape of every K1 launch and keeps a copy
    of the first launch's input."""

    def __enter__(self):
        from acados_tpu_torch.ops import batched_inv
        self._mod, self._orig = batched_inv, batched_inv._gj_inverse_cuda
        self.shapes, self.first = [], None

        def record(A):
            if self.first is None:
                self.first = A.detach().clone()
            self.shapes.append(tuple(A.shape))
            return self._orig(A)

        batched_inv._gj_inverse_cuda = record
        return self

    def __exit__(self, *exc):
        self._mod._gj_inverse_cuda = self._orig


def check_inverse(name, A, inv_kernel, bound, quiet=False):
    """Kernel against the plain version on the same input; returns
    (rel_err, abs_err, resid). quiet: log only a failure."""
    import torch
    from acados_tpu_torch.ops.batched_inv import gj_inverse_plain
    Ak = inv_kernel(A)
    torch.cuda.synchronize()
    Ap = gj_inverse_plain(A)
    abs_err = float((Ak - Ap).abs().max())
    rel = abs_err / float(Ap.abs().max())
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    resid = float((A @ Ak - eye).abs().max())
    ok = rel <= bound and resid <= bound and bool(torch.isfinite(Ak).all())
    if not quiet or not ok:
        log(f"  {name:<34} {str(A.dtype):<14} max|k-p|/max|p| {rel:.3e}  "
            f"max|A Ainv - I| {resid:.3e}  bound {bound:g}  "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version: {name}")
    return rel, abs_err, resid


def rti_batch(ocp_kw, B, device, seed=SEED, qp_solver=None):
    """The main path's batch solver with bench.py's _build_rti set-up:
    x0 per instance = X0_CENTER + N(0, X0_SIGMA), set as lbx/ubx at stage
    0, and the x trajectory initialised at x0. qp_solver, if given, is
    set in the solver options."""
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    ocp = make_pendulum_ocp(**ocp_kw)
    if qp_solver is not None:
        ocp.solver_options.qp_solver = qp_solver
    rng = np.random.default_rng(seed)
    x0s = np.asarray(X0_CENTER) + rng.normal(0.0, X0_SIGMA, (B, 4))
    return batch_at(ocp, x0s, device), ocp


def chain_batch(n_mass, B, dtype, device, seed=SEED, moved=False):
    """bench_chain_rti's set-up: the chain OCP at N = N_CHAIN, x0 per
    instance = steady state + N(0, CHAIN_SIGMA). moved: every x0 entry
    moved by one rounding step, up or down at random."""
    from acados_tpu_torch.models.chain_mass import make_chain_mass_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    ocp, xrest = make_chain_mass_ocp(n_mass=n_mass, N=N_CHAIN, dtype=dtype)
    rng = np.random.default_rng(seed)
    x0s = xrest + rng.normal(0.0, CHAIN_SIGMA, (B, len(xrest)))
    if moved:
        x0s = x0s * (1 + np.finfo(np.float64).eps * rng.choice(
            (-1.0, 1.0), x0s.shape))
    return batch_at(ocp, x0s, device)


def in_tolerance(solver, tols=None):
    """bench.py's _residual_fields gate on the last solve's residuals, at
    the configuration's tolerances unless tols (stat, eq, ineq, comp) are
    given."""
    so = solver.acados_ocp.solver_options
    res = solver.get_stats("residuals").max(axis=0)
    if tols is None:
        tols = (so.nlp_solver_tol_stat, so.nlp_solver_tol_eq,
                so.nlp_solver_tol_ineq, so.nlp_solver_tol_comp)
    return bool(np.all(res <= np.asarray(tols))), res, tols


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of fn() ending in a synchronize (ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_calls(solver, label, on_call=None, tols=None, warm=WARM_CALLS,
              timed=TIMED_CALLS):
    """1 cold + `warm` warm + `timed` timed solve() calls: every status
    must be 0 and the last call in tolerance (at `tols`, or the
    configuration's). Returns the timed calls' host times (ms) and each
    call's largest qp_iter."""
    import torch
    call_ms, statuses, qp_max = [], [], []
    for c in range(1 + warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = solver.solve()
        torch.cuda.synchronize()
        if c > warm:
            call_ms.append((time.perf_counter() - t0) * 1e3)
        statuses.append(st)
        qp_max.append(int(solver.get_stats("qp_iter").max()))
        if on_call is not None:
            on_call(c)
    bad = [c for c, st in enumerate(statuses) if np.any(st != 0)]
    if bad:
        raise SystemExit(f"{label}: non-zero statuses in calls {bad}: "
                         f"{np.unique(statuses[bad[0]], return_counts=True)}")
    ok_tol, res, tols = in_tolerance(solver, tols)
    log(f"  residual maxima {res.tolist()} vs tolerances {list(tols)}: "
        f"{'in tolerance' if ok_tol else 'OUT OF TOLERANCE'}")
    if not ok_tol:
        raise SystemExit(f"{label} not in tolerance")
    x = solver._it_dev.x
    if x.shape != (solver.N_batch, solver.N + 1, solver.form.nx) or not \
            bool(torch.isfinite(x).all()):
        raise SystemExit(f"bad trajectory tensor {tuple(x.shape)}")
    return call_ms, qp_max


def call_stats(call_ms, B=B_MAIN) -> str:
    med = float(np.median(call_ms))
    p10, p90 = (float(np.percentile(call_ms, q)) for q in (10, 90))
    return (f"median {med:.2f} ms (p10 {p10:.2f}, p90 {p90:.2f}) over "
            f"{len(call_ms)} calls -> {B / med * 1e3:.1f} solves/s")


def profile_calls(solver, call_ms: float, calls: int = 3) -> dict:
    """A torch.profiler trace of a few solve() calls: the device's busy
    share of the unprofiled call time, launches per call, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            solver.solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {}
    for e in kern:
        t = busy.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.elapsed_us() / 1e3 / calls
        t[1] += 1 / calls
    busy_ms = sum(t[0] for t in busy.values())
    return dict(device_busy_ms_per_call=busy_ms,
                device_busy_share=busy_ms / call_ms,
                profiled_wall_ms_per_call=wall_ms / calls,
                kernel_launches_per_call=len(kern) / calls,
                top_kernels=[dict(name=k[:80], ms=v[0], launches=v[1])
                             for k, v in sorted(busy.items(),
                                                key=lambda kv: -kv[1][0])[:6]])


def linearized(solver):
    """(linearize thunk, its QP) at the solver's current iterate."""
    import torch
    from acados_tpu_torch.ocp_nlp.linearize import (build_static_rows,
                                                    linearize)
    form, opts = solver.form, solver.opts
    data, it = solver._data_dev, solver._it_dev
    rows = build_static_rows(form, it.x.dtype, it.x.device)
    lm = torch.tensor(opts.levenberg_marquardt, dtype=it.x.dtype,
                      device=it.x.device)
    lin = lambda: linearize(form, rows, data, it, lm)
    return lin, lin()


def time_split(solver) -> dict:
    """Where the time of one warm RTI call goes: its layers on the host
    clock (each synchronised, medians), then a torch.profiler trace of a
    few calls for the device's busy share and kernel launches per call.
    The QP is warm-started from the NLP multipliers where the
    configuration asks for it, as the SQP loop does."""
    import torch
    from acados_tpu_torch.ocp_nlp.sqp import (_nlp_residuals,
                                              use_x0_elimination)
    from acados_tpu_torch.ocp_qp.data import OcpQpSol
    from acados_tpu_torch.ocp_qp.ipm import solve_ocp_qp
    form, opts = solver.form, solver.opts
    data, it = solver._data_dev, solver._it_dev
    x0f = use_x0_elimination(form, opts)
    M = it.u.shape[0] * it.u.shape[1]
    flat = lambda t: t.reshape((M,) + tuple(t.shape[2:]))
    step_args = (flat(it.x[:, :-1]), flat(it.u), flat(data.p[:, :-1]),
                 flat(data.ts[:, :-1]), flat(data.dts))
    lin, qp = linearized(solver)
    warm = None
    if opts.warm_start_first_qp_from_nlp:
        warm = OcpQpSol(x=torch.zeros_like(qp.q), u=torch.zeros_like(qp.r),
                        pi=it.pi, lam_lg=it.lam_l, lam_ug=it.lam_u,
                        t_lg=torch.ones_like(it.lam_l),
                        t_ug=torch.ones_like(it.lam_u), sl=it.sl, su=it.su)
    _, info = solve_ocp_qp(qp, opts.qp_opts, warm=warm, x0_fixed=x0f)
    out = dict(call_ms=host_ms(solver.solve),
               linearize_ms=host_ms(lin),
               irk_step_jac_ms=host_ms(lambda: form.step_jac_fn(*step_args)),
               qp_ms=host_ms(lambda: solve_ocp_qp(qp, opts.qp_opts,
                                                  warm=warm, x0_fixed=x0f)),
               qp_rounds=int(info.num_iter.max()),
               residuals_ms=host_ms(lambda: _nlp_residuals(qp, it)))
    out["rest_ms"] = out["call_ms"] - out["linearize_ms"] - out["qp_ms"]
    out.update(profile_calls(solver, out["call_ms"]))
    return out


def fc_time_split(solver) -> dict:
    """time_split for the full-condensing path: linearize, condense,
    dense IPM, expand."""
    from acados_tpu_torch.dense_qp.ipm import solve_dense_qp
    from acados_tpu_torch.ocp_qp.full_condensing import (full_condense,
                                                         full_expand)
    qp_opts = solver.opts.qp_opts
    lin, qp = linearized(solver)
    dense, cache = full_condense(qp)
    sol_d, info = solve_dense_qp(dense, qp_opts)
    out = dict(call_ms=host_ms(solver.solve),
               linearize_ms=host_ms(lin),
               condense_ms=host_ms(lambda: full_condense(qp)),
               dense_ipm_ms=host_ms(lambda: solve_dense_qp(dense, qp_opts)),
               dense_ipm_rounds=int(info.num_iter.max()),
               expand_ms=host_ms(lambda: full_expand(qp, cache, sol_d)))
    out["rest_ms"] = out["call_ms"] - sum(
        out[k] for k in ("linearize_ms", "condense_ms", "dense_ipm_ms",
                         "expand_ms"))
    out.update(profile_calls(solver, out["call_ms"]))
    return out


def card_vs_cpu(label, make, moved=None, calls=3):
    """The same float64 batch (make(device) -> solver) on the card and on
    the CPU, `calls` RTI calls: equal statuses and qp_iter, and
    max |d|/(1 + |ref|) over x, u, pi within 1e-9, naming the worst
    instance. moved, if given, makes the CPU batch again from inputs
    moved by one rounding step (moved() -> solver), to log the CPU's own
    spread beside the card's gap."""
    import torch
    gpu, cpu = make(torch.device("cuda")), make("cpu")
    for _ in range(calls):
        st_g, st_c = gpu.solve(), cpu.solve()
        if not (np.array_equal(st_g, st_c) and np.array_equal(
                gpu.get_stats("qp_iter"), cpu.get_stats("qp_iter"))):
            raise SystemExit(f"{label}: card and CPU disagree on "
                             "statuses/qp_iter")

    def gaps(s):
        """Per instance, max |s - cpu| / (1 + |cpu|) over x, u, pi."""
        out = 0.0
        for f in ("x", "u", "pi"):
            a = getattr(s._it_dev, f).cpu().numpy()
            b = getattr(cpu._it_dev, f).numpy()
            out = np.maximum(out, np.max(
                (np.abs(a - b) / (1 + np.abs(b))).reshape(len(b), -1), 1))
        return out

    g = gaps(gpu)
    worst = int(np.argmax(g))
    log(f"{label} float64 B={len(g)}, {calls} RTI calls: card vs CPU "
        f"max |d|/(1+|ref|) {g[worst]:.3e} (bound 1e-9, worst instance "
        f"{worst}), statuses {st_g.tolist()}, qp_iter "
        f"{gpu.get_stats('qp_iter').tolist()}")
    if moved is not None:
        cpu_moved = moved()
        for _ in range(calls):
            cpu_moved.solve()
        gm = gaps(cpu_moved)
        log(f"  CPU against the CPU on x0s moved by one rounding step: "
            f"worst instance {int(np.argmax(gm))} ({gm.max():.3e}; "
            f"instance {worst} {gm[worst]:.3e})")
    if not g[worst] <= 1e-9:
        raise SystemExit(f"{label}: card and CPU disagree")


def spd_batch(rng, B, n):
    """Seeded SPD matrices A A' / n + I."""
    A = rng.normal(size=(B, n, n))
    return A @ np.swapaxes(A, 1, 2) / n + np.eye(n)


def chol_flops(n):
    """Operations of the factor as the kernel runs it: the sums, the
    column scalings, a sqrt and a reciprocal per column."""
    return (n ** 3 - n) / 3 + n * (n - 1) / 2 + 2 * n


def check_chol(name, H, b, bound, bad=None):
    """K2, K3 and K4 against their plain versions on the same inputs;
    returns {kernel: (rel_err, abs_err)}. `bad` marks the matrices that
    must come back NaN throughout (all others finite)."""
    import torch
    from acados_tpu_torch.ops import batched_chol as bc
    Lk = bc.chol_factor_batched(H)
    Lp = bc.chol_factor_plain(H)
    # K3's input: the plain factors, an identity in place of a NaN one
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    Lref = torch.where(torch.isnan(Lp).flatten(1).any(1)[:, None, None],
                       eye, Lp)
    pairs = dict(chol_factor=(Lk, Lp),
                 chol_solve=(bc.chol_solve_batched(Lref, b),
                             bc.chol_solve_plain(Lref, b)))
    xk, Lk4 = bc.chol_factor_solve_batched(H, b)
    xp, Lp4 = bc.chol_factor_solve_plain(H, b)
    pairs["chol_factor_solve"] = (torch.cat([xk, Lk4.flatten(1)], 1),
                                  torch.cat([xp, Lp4.flatten(1)], 1))
    torch.cuda.synchronize()
    out, fail = {}, []
    for kname, (k, p) in pairs.items():
        good = torch.isfinite(p).flatten(1).all(1)
        nan_k = torch.isnan(k).flatten(1)
        nan_ok = bool((nan_k.all(1) == ~good).all()) and bool(
            torch.isfinite(k[good]).all())
        if bad is not None and kname != "chol_solve":
            nan_ok = nan_ok and bool((~good == bad).all())
        abs_err = float((k[good] - p[good]).abs().max()) if good.any() \
            else 0.0
        rel = abs_err / max(float(p[good].abs().max()), 1e-300) \
            if good.any() else 0.0
        ok = rel <= bound and nan_ok
        out[kname] = (rel, abs_err)
        log(f"  {kname:<18} {name:<30} {str(H.dtype):<14} "
            f"max|k-p|/max|p| {rel:.3e}  NaN rows "
            f"{int((~good).sum())}/{len(good)} {'as planned' if nan_ok else 'WRONG'}"
            f"  bound {bound:g}  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail.append(kname)
    if fail:
        raise SystemExit(f"{fail} disagree with their plain versions: {name}")
    return out


def indefinite_batch(rng, B, n):
    """SPD matrices with every 5th made indefinite, every 7th given a NaN
    and every 11th an infinite diagonal entry in the lower triangle;
    returns (H, bad)."""
    H = spd_batch(rng, B, n)
    bad = np.zeros(B, bool)
    H[::5, n // 2, n // 2] = -1.0
    H[3::7, n - 1, 0] = np.nan
    H[6::11, n // 3, n // 3] = np.inf
    bad[::5] = bad[3::7] = bad[6::11] = True
    return H, bad


def k2_bit_checks(dev, rng, kern, Hb=None) -> None:
    """K2 (kern: chol_factor_batched, or the same on a copy's build)
    against chol_factor_plain bit for bit, NaN in the same matrices, in
    float32 and float64: on the barrier Hessians Hb (where given), every
    n = 1..32 at B = K2_SWEEP_B, the batches of K2_EDGE_B at each band's n
    (they end inside a group, a warp and a block of warps), B = K2_LONG_B
    at K2_LONG_N, an input one element off its allocation (not aligned to
    the row branch's vectors) at n = 24 and 13, and batches mixing SPD with
    indefinite and non-finite matrices at n = 4, 13, 24, whose bad
    matrices fall in every position of a warp's groups (up to 8).
    Raises at the first batch that differs."""
    import torch
    from acados_tpu_torch.ops.batched_chol import chol_factor_plain
    for dtype in (torch.float32, torch.float64):
        def spd(B, n):
            return torch.as_tensor(spd_batch(rng, B, n), dtype=dtype,
                                   device=dev)
        batches = [] if Hb is None else [
            (f"barrier Hessians {tuple(Hb.shape)}", Hb.to(dtype), None)]
        batches += [(f"n={n} B={K2_SWEEP_B}", spd(K2_SWEEP_B, n), None)
                    for n in range(1, 33)]
        batches += [(f"n={n} B={B}", spd(B, n), None) for n in K2_ROW_N
                    for B in K2_EDGE_B]
        batches += [(f"long n={n} B={K2_LONG_B}", spd(K2_LONG_B, n), None)
                    for n in K2_LONG_N]
        for n in (24, 13):
            B = 1023
            H = torch.empty(B * n * n + 1, dtype=dtype,
                            device=dev)[1:].view(B, n, n)
            H.copy_(spd(B, n))
            batches.append((f"misaligned n={n} B={B}", H, None))
        for n in (4, 13, 24):
            H, bad = indefinite_batch(rng, 1001, n)
            if set(np.flatnonzero(bad) % 8) != set(range(8)):
                raise SystemExit("the bad matrices miss a group position")
            batches.append((f"indefinite/non-finite n={n} B=1001",
                            torch.as_tensor(H, dtype=dtype, device=dev),
                            torch.as_tensor(bad, device=dev)))
        for name, H, bad in batches:
            Lk, Lp = kern(H), chol_factor_plain(H)
            nan_p = torch.isnan(Lp).flatten(1).all(1)
            if not (same_bits(Lk, Lp) and (bad is None
                                           or torch.equal(nan_p, bad))):
                raise SystemExit(f"K2 is not bit for bit its plain version: "
                                 f"{name} {dtype}")
        log(f"  K2 bit for bit, {str(dtype):<14} {len(batches)} batches "
            f"(n = 1..32 at B = {K2_SWEEP_B}; n in {K2_ROW_N} at B in "
            f"{K2_EDGE_B}; n in {K2_LONG_N} at B = {K2_LONG_B}; misaligned "
            f"n = 24, 13; indefinite/non-finite n = 4, 13, 24): equal, NaN "
            f"in the same matrices")


def k3_k4_bit_checks(dev, rng, kern, Hb=None) -> None:
    """K3 and K4 (kern: {"chol_solve": fn, "chol_factor_solve": fn}, the
    wrappers or the same on a copy's build) against chol_solve_plain and
    chol_factor_solve_plain bit for bit, NaN in the same entries, in
    float32 and float64, with b ~ N(0, 1), on k2_bit_checks' batches: the
    barrier Hessians Hb (where given), every n = 1..32 at B = K2_SWEEP_B,
    the batches of K2_EDGE_B at each band's n, B = K2_LONG_B at K2_LONG_N,
    H, L and b each one element off its allocation at n = 24 and 13, and
    for K4 the indefinite and non-finite batches at n = 4, 13, 24 (x and L
    NaN throughout in exactly the bad matrices). K3 solves with each
    batch's plain factor (the identity in place of a failed one), and at
    n = 4, 13, 24 also with factors holding NaN and inf above the diagonal
    (never read) and with a zero or a NaN on the diagonal (x as the plain
    version's, NaN where it is NaN). Raises at the first batch that
    differs."""
    import torch
    from acados_tpu_torch.ops import batched_chol as bc
    solve, factor_solve = kern["chol_solve"], kern["chol_factor_solve"]

    def off_by_one(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return out[1:].view(t.shape).copy_(t)

    for dtype in (torch.float32, torch.float64):
        def spd(B, n):
            return torch.as_tensor(spd_batch(rng, B, n), dtype=dtype,
                                   device=dev)
        # (name, H, bad matrices or None, one element off)
        batches = [] if Hb is None else [
            (f"barrier Hessians {tuple(Hb.shape)}", Hb.to(dtype), None,
             False)]
        batches += [(f"n={n} B={K2_SWEEP_B}", spd(K2_SWEEP_B, n), None,
                     False) for n in range(1, 33)]
        batches += [(f"n={n} B={B}", spd(B, n), None, False)
                    for n in K2_ROW_N for B in K2_EDGE_B]
        batches += [(f"long n={n} B={K2_LONG_B}", spd(K2_LONG_B, n), None,
                     False) for n in K2_LONG_N]
        batches += [(f"misaligned n={n} B=1023", spd(1023, n), None, True)
                    for n in (24, 13)]
        for n in (4, 13, 24):
            H, bad = indefinite_batch(rng, 1001, n)
            batches.append((f"indefinite/non-finite n={n} B=1001",
                            torch.as_tensor(H, dtype=dtype, device=dev),
                            torch.as_tensor(bad, device=dev), False))
        n3 = 0
        for name, H, bad, shift in batches:
            B, n = H.shape[0], H.shape[-1]
            b = torch.as_tensor(rng.normal(size=(B, n)), dtype=dtype,
                                device=dev)
            L = bc.chol_factor_plain(H)
            L = torch.where(torch.isnan(L).flatten(1).any(1)[:, None, None],
                            torch.eye(n, dtype=dtype, device=dev), L)
            if shift:
                H, L, b = off_by_one(H), off_by_one(L), off_by_one(b)
            x4, L4 = factor_solve(H, b)
            xp, Lp = bc.chol_factor_solve_plain(H, b)
            if not (same_bits(x4, xp) and same_bits(L4, Lp)) or (
                    bad is not None and not (
                        torch.equal(torch.isnan(Lp).flatten(1).all(1), bad)
                        and torch.equal(torch.isnan(x4).all(1), bad))):
                raise SystemExit(f"K4 is not bit for bit its plain version: "
                                 f"{name} {dtype}")
            solves = [(name, L)]
            if n in (4, 13, 24) and bad is None and not shift \
                    and B == K2_SWEEP_B:
                above = torch.ones(n, n, dtype=torch.bool,
                                   device=dev).triu(1)
                garbage = L.clone()
                garbage[0::2, above] = float("nan")
                garbage[1::2, above] = float("inf")
                diag = L.clone()
                diag[0::3, n - 1, n - 1] = 0.0
                diag[1::3, n // 2, n // 2] = float("nan")
                solves += [(f"{name}, NaN/inf above the diagonal", garbage),
                           (f"{name}, zero/NaN on the diagonal", diag)]
            for sname, Ls in solves:
                if not same_bits(solve(Ls, b), bc.chol_solve_plain(Ls, b)):
                    raise SystemExit(f"K3 is not bit for bit its plain "
                                     f"version: {sname} {dtype}")
            n3 += len(solves)
        log(f"  K3/K4 bit for bit, {str(dtype):<14} K4 {len(batches)} "
            f"batches, K3 {n3} (n = 1..32 at B = {K2_SWEEP_B}; n in "
            f"{K2_ROW_N} at B in {K2_EDGE_B}; n in {K2_LONG_N} at B = "
            f"{K2_LONG_B}; H, L, b misaligned at n = 24, 13; indefinite/"
            f"non-finite n = 4, 13, 24; K3's L with NaN/inf above and zero/"
            f"NaN on the diagonal at n = 4, 13, 24): equal, NaN in the same "
            f"entries")


def chol_library(kname):
    """(name, fn(H, L, b)): the library call that computes the function of
    kernel kname (chol_factor: K2, chol_solve: K3, chol_factor_solve: K4)."""
    import torch
    return {
        "chol_factor": ("torch.linalg.cholesky_ex",
                        lambda H, L, b: torch.linalg.cholesky_ex(H)),
        "chol_solve": ("torch.cholesky_solve",
                       lambda H, L, b: torch.cholesky_solve(b[..., None], L)),
        "chol_factor_solve": (
            "cholesky_ex + cholesky_solve",
            lambda H, L, b: torch.cholesky_solve(
                b[..., None], torch.linalg.cholesky_ex(H)[0])),
    }[kname]


def chol_args(kname, H, L, b):
    """The arguments of kernel kname's wrapper."""
    return {"chol_factor": (H,), "chol_solve": (L, b),
            "chol_factor_solve": (H, b)}[kname]


def chol_bound(kname, B, n, dtype):
    """Kernel kname's bound (ms, what bounds it) at (B, n, n) of dtype:
    the lower triangle read, b read and x written, L written (K2, K4);
    chol_flops(n) a matrix for the factor, 2 n^2 for the solve."""
    import torch
    size = torch.empty((), dtype=dtype).element_size()
    peak = FP32_FLOPS if dtype == torch.float32 else FP64_FLOPS
    tri = n * (n + 1) // 2
    factor = kname != "chol_solve"
    solve = kname != "chol_factor"
    return bound_of(B * (tri + factor * n * n + solve * 2 * n) * size,
                    B * (factor * chol_flops(n) + solve * 2 * n * n), peak)


def chol_grid(kname, kerns: dict, parent=None, order=None) -> list:
    """Device ms back to back of each wrapper of kernel kname (chol_factor,
    chol_solve or chol_factor_solve) in kerns ({label: fn}), called in
    turns (order: labels, default each once), over K2's grid (n in
    K2_GRID_N x B in K2_GRID_B and n in K2_WIDE_N at B = 4096 float32,
    (4096, 24, 24) float64) on SPD X X' / n + I (K3: its library factor)
    and b ~ N(0, 1), beside the library call (CUDA events around one call:
    it waits for the host) and the bound. parent: device ms of an earlier
    build by (n, B, dtype name), logged beside."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    order = list(kerns) if order is None else order
    cells = [(n, B, torch.float32) for n in K2_GRID_N for B in K2_GRID_B]
    cells.append((24, 4096, torch.float64))
    cells += [(n, 4096, torch.float32) for n in K2_WIDE_N]
    lname, lib_fn = chol_library(kname)
    log(f"{kname} grid (device ms back to back; {lname} CUDA events around "
        f"one call; X X' / n + I):")
    rows = []
    for n, B, dtype in cells:
        X = torch.randn((B, n, n), generator=gen, device=dev, dtype=dtype)
        H = X @ X.transpose(1, 2) / n + torch.eye(n, device=dev, dtype=dtype)
        b = torch.randn((B, n), generator=gen, device=dev, dtype=dtype)
        L = torch.linalg.cholesky_ex(H)[0].contiguous()  # row-major
        args = chol_args(kname, H, L, b)
        times = {label: [] for label in kerns}
        for label in order:
            times[label].append(device_ms(lambda: kerns[label](*args)))
        lib = cuda_ms(lambda: lib_fn(H, L, b), reps=10)
        b_ms, b_by = chol_bound(kname, B, n, dtype)
        dt = str(dtype).split(".")[-1]
        rows.append(dict(kernel=kname, n=n, B=B, dtype=dt, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib,
                         **{k: float(np.median(v)) for k, v in times.items()}))
        old = (parent or {}).get((n, B, dt))
        log(f"  n={n:2d} B={B:6d} {dt:<7} " + "  ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in v)}"
            for k, v in times.items())
            + (f"  (before: {old:.4f})" if old is not None else "")
            + f"  library {lib:.4f}  bound {b_ms:.4f} ({b_by})")
    return rows


def riccati_free_x0(dev) -> None:
    """Phase 10: the Riccati IPM with a free initial state at nx = 16,
    whose P_0 goes through chol_any (K2 on the card, one launch a round),
    float64, card against CPU. The same solve on the card with P_0
    factored by the plain version, K2 on the captured P_0 against the
    plain version, and the CPU solve of inputs moved by one rounding
    step show where the gap between card and CPU comes from."""
    import torch
    from acados_tpu_torch.ocp_qp import data as qp_data
    from acados_tpu_torch.ocp_qp import riccati
    from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
    from acados_tpu_torch.ops import batched_chol
    from acados_tpu_torch.testing import random_qp_batch
    d = random_qp_batch(SEED, B=256, N=8, nx=16, nu=2, nc=3, x0_rows=False)
    rng = np.random.default_rng(SEED + 1)
    # every number of the problem (not the masks) moved by about one
    # rounding step, up or down
    d_moved = {k: v if "mask" in k else v * (
        1 + np.finfo(np.float64).eps * rng.choice((-1.0, 1.0), v.shape))
        for k, v in d.items()}
    opts = IpmOpts(iter_max=50)
    orig_chol = riccati.chol_any
    p0 = []

    def capture_p0(H):
        p0.append(H.detach().clone())
        return orig_chol(H)

    def solve(data, where, chol=orig_chol):
        qp = qp_data.OcpQp(**{k: torch.as_tensor(v, device=where)
                              for k, v in data.items()})
        riccati.chol_any = chol
        try:
            reset_counts()
            sol, info = solve_ocp_qp(qp, opts, x0_fixed=False)
            return sol, info, read_counts()
        finally:
            riccati.chol_any = orig_chol

    sc, ic, _ = solve(d, "cpu")
    sm, _, _ = solve(d_moved, "cpu")
    sg, ig, counts = solve(d, dev, capture_p0)
    sp, _, counts_p = solve(d, dev, batched_chol.chol_factor_plain)

    def gaps(s, fields=("x", "u", "pi")):
        """Per instance, max |s - cpu| / (1 + |cpu|) over `fields`."""
        out = 0.0
        for f in fields:
            a, b = getattr(s, f).cpu().numpy(), getattr(sc, f).numpy()
            out = np.maximum(out, np.max(
                (np.abs(a - b) / (1 + np.abs(b))).reshape(len(b), -1), 1))
        return out

    g_card, g_moved = gaps(sg), gaps(sm)
    gap, lam_gap = float(g_card.max()), float(
        gaps(sg, ("lam_lg", "lam_ug")).max())
    worst, worst_moved = int(np.argmax(g_card)), int(np.argmax(g_moved))
    fields = ("x", "u", "pi", "lam_lg", "lam_ug")
    plain_same = all(torch.equal(getattr(sg, f), getattr(sp, f))
                     for f in fields)
    k2_same = all(torch.equal(batched_chol.chol_factor_plain(P),
                              batched_chol.chol_factor_batched(P))
                  for P in p0)
    rounds = int(ig.num_iter.max())
    same = (np.array_equal(ig.num_iter.cpu(), ic.num_iter)
            and np.array_equal(ig.status.cpu(), ic.status))
    log(f"Riccati IPM, x0 free, nx=16, B=256, float64: card vs CPU "
        f"max |d|/(1+|ref|) over x, u, pi {gap:.3e} (bound 1e-8; over "
        f"lam_lg, lam_ug {lam_gap:.3e}), equal iterations and statuses "
        f"{same}, K2 launches {counts['chol_factor']} for {rounds} rounds, "
        f"statuses {np.unique(ig.status.cpu()).tolist()}")
    log(f"  worst instance {worst} ({g_card[worst]:.3e}; median instance "
        f"{float(np.median(g_card)):.3e}, {int(np.sum(g_card > 1e-9))} "
        f"above 1e-9); K2 on this run's {len(p0)} P_0 batches equals the "
        f"plain version bit for bit: {k2_same}; the card's solve with P_0 "
        f"factored by the plain version ({counts_p['chol_factor']} K2 "
        f"launches) equals the one through K2 bit for bit: {plain_same}")
    log(f"  CPU against the CPU on inputs moved by one rounding step: "
        f"worst instance {worst_moved} ({g_moved[worst_moved]:.3e}; "
        f"instance {worst} {g_moved[worst]:.3e}; median "
        f"{float(np.median(g_moved)):.3e})")
    # 1e-8: K2 is bit for bit the plain version on these P_0, and the gap
    # is the same without it; one instance amplifies rounding-level
    # differences (cuBLAS against the CPU's BLAS, or a rounding step of
    # its inputs) to a few 1e-9
    if not (same and gap <= 1e-8 and counts["chol_factor"] == rounds
            and len(p0) == rounds and counts_p["chol_factor"] == 0
            and k2_same and plain_same
            and bool((ig.status == 0).all())):
        raise SystemExit("Riccati IPM with P_0 through K2 failed")


def k1_batches(dev, rng, kern):
    """K1 against its plain version on seeded batches at every n of the
    warp branch's grid and at the group branch's n = 2, 4, 8, 16: random
    N(0, 1) + n I, the same with rows permuted (row swaps at most steps),
    in float32 and float64, and matrices with equal magnitudes in their
    pivot columns, where exact arithmetic makes kernel, plain version and
    exact inverse agree bit for bit only under the lowest-index tie
    rule."""
    import torch
    from acados_tpu_torch.ops.batched_inv import gj_inverse_plain
    from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
    ns = K1_BRANCH_N + K1_GROUP_N
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        for n in ns:
            A = torch.as_tensor(rng.normal(size=(1001, n, n)) + n * np.eye(n),
                                dtype=dtype, device=dev)
            check_inverse(f"random n={n} B=1001", A, kern, bound)
        for n in ns:
            A = row_permuted_batch(rng, 1001, n)
            swaps = np.mean(np.argmax(np.abs(A[:, :, 0]), axis=1) != 0)
            check_inverse(f"rows permuted n={n} (swap at k=0: "
                          f"{swaps:.0%})",
                          torch.as_tensor(A, dtype=dtype, device=dev), kern,
                          bound)
    for n in ns:
        A, X = pivot_tie_batch(rng, 4096, n)
        col0 = np.abs(A[:, :, 0])
        ties = np.sum(np.sum(col0 == col0.max(1, keepdims=True), 1) > 1)
        swaps = np.sum(np.argmax(col0, axis=1) != 0)
        for dtype in (torch.float32, torch.float64):
            At = torch.as_tensor(A, dtype=dtype, device=dev)
            Xt = torch.as_tensor(X, dtype=dtype, device=dev)
            Ak, Ap = kern(At), gj_inverse_plain(At)
            d_kp = float((Ak - Ap).abs().max())
            d_kx = float((Ak - Xt).abs().max())
            ok = len(A) > 0 and d_kp == d_kx == 0
            log(f"  ties n={n} B={len(A)} {str(dtype):<14} (ties at k=0 "
                f"{ties}, swaps {swaps}): max|k-p| {d_kp:g}, "
                f"max|k-exact| {d_kx:g}  bound 0  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K1 breaks pivot ties differently: n={n}")


def k1_edge_cases(dev, rng, kern):
    """K1 against its plain version where the branches' groups, warps,
    bands and blocks end: every n = 1..48 at a short batch, batches that
    end inside a block of warps (warp branch) or inside a group, a warp or
    a block (group branch), long batches at n = 2, 3, 16 (more warps than
    the card holds at once), and an input one element off its allocation
    (not aligned to the group branch's vector loads). The long batches
    are strictly diagonally dominant with their rows permuted, so they
    pivot and stay well conditioned: 200,003 draws of N(0, 1) + 3 I hold
    matrices so ill-conditioned that the kernel's fused multiply-adds
    alone move their inverses by more than F32_BOUND or F64_BOUND of the
    batch's largest entry (k1_compare.py logs such batches)."""
    import torch
    from acados_tpu_torch.ops.batched_inv import _GJ_MAX_N
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        cases = [(n, K1_SWEEP_B) for n in range(1, _GJ_MAX_N + 1)]
        cases += [(n, B) for n in K1_EDGE_N for B in K1_EDGE_B]
        cases += [(n, B) for n in K1_GROUP_N for B in K1_GROUP_EDGE_B]
        worst = 0.0
        for n, B in cases:
            A = torch.as_tensor(rng.normal(size=(B, n, n)) + n * np.eye(n),
                                dtype=dtype, device=dev)
            worst = max(worst, check_inverse(f"edge n={n} B={B}", A, kern,
                                             bound, quiet=True)[0])
        for n in K1_LONG_N:
            A = rng.uniform(-1.0, 1.0, (K1_LONG_B, n, n)) + 2 * n * np.eye(n)
            A = np.take_along_axis(
                A, np.argsort(rng.random((K1_LONG_B, n)))[..., None], 1)
            worst = max(worst, check_inverse(
                f"long n={n} B={K1_LONG_B}", torch.as_tensor(
                    A, dtype=dtype, device=dev), kern, bound, quiet=True)[0])
        for n in (2, 16):
            B = 1023
            flat = torch.empty(B * n * n + 1, dtype=dtype, device=dev)
            A = flat[1:].view(B, n, n)
            A.copy_(torch.as_tensor(rng.normal(size=(B, n, n))
                                    + n * np.eye(n), dtype=dtype))
            worst = max(worst, check_inverse(
                f"misaligned n={n} B={B}", A, kern, bound, quiet=True)[0])
        log(f"  edge cases {str(dtype):<14} {len(cases) + len(K1_LONG_N) + 2}"
            f" batches (n = 1..{_GJ_MAX_N} at B = {K1_SWEEP_B}; n in "
            f"{K1_EDGE_N} at B in {K1_EDGE_B}; n in {K1_GROUP_N} at B in "
            f"{K1_GROUP_EDGE_B}; n in {K1_LONG_N} dominant, rows permuted, "
            f"at B = {K1_LONG_B}; misaligned n = 2, 16): worst "
            f"max|k-p|/max|p| {worst:.3e}, bound {bound:g}, ok")


def k1_bound(A):
    """K1's bound (ms, what bounds it) at the shape and type of A: each
    input byte read and each output byte written once, and 2 n^3 flops a
    matrix (the in-place Gauss-Jordan's multiply-adds)."""
    import torch
    M, n = A.shape[0], A.shape[-1]
    peak = FP32_FLOPS if A.dtype == torch.float32 else FP64_FLOPS
    return bound_of(2 * M * n * n * A.element_size(), 2 * M * n ** 3, peak)


def k1_grid(kerns: dict, parent=None, order=None) -> list:
    """Device ms back to back of each K1 wrapper in kerns ({label: fn}),
    called in turns (order: labels, default each once), over both
    branches' grid (n in K1_BRANCH_N x B in K1_GRID_B and n in K1_GROUP_N
    x B in K1_GROUP_GRID_B, float32, and (10240, 39, 39) and
    (81920, 16, 16) float64), beside torch.linalg.inv (CUDA events around
    one call: it waits for the host) and the bound. parent: device ms of
    an earlier build by (n, B, dtype name), logged beside."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    order = list(kerns) if order is None else order
    cells = [(n, B, torch.float32) for n in K1_BRANCH_N for B in K1_GRID_B]
    cells.append((39, 10240, torch.float64))
    cells += [(n, B, torch.float32) for n in K1_GROUP_N
              for B in K1_GROUP_GRID_B]
    cells.append((16, 81920, torch.float64))
    log("K1 grid (device ms back to back; torch.linalg.inv CUDA events "
        "around one call; N(0, 1) + n I):")
    rows = []
    for n, B, dtype in cells:
        A = torch.randn((B, n, n), generator=gen, device=dev, dtype=dtype) \
            + n * torch.eye(n, device=dev, dtype=dtype)
        times = {label: [] for label in kerns}
        for label in order:
            times[label].append(device_ms(lambda: kerns[label](A)))
        lib = cuda_ms(lambda: torch.linalg.inv(A), reps=10)
        b_ms, b_by = k1_bound(A)
        dt = str(dtype).split(".")[-1]
        row = dict(n=n, B=B, dtype=dt, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib, **{k: float(np.median(v))
                                      for k, v in times.items()})
        rows.append(row)
        old = (parent or {}).get((n, B, dt))
        log(f"  n={n:2d} B={B:6d} {dt:<7} " + "  ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in v)}"
            for k, v in times.items())
            + (f"  (before: {old:.4f})" if old is not None else "")
            + f"  torch.linalg.inv {lib:.4f}  bound {b_ms:.4f} ({b_by})")
    return rows


def k1_entry(name, A, launches, rel, abs_err, before=None) -> dict:
    """K1's kernels-line entry at the shape of A (float32): its time per
    wrapper call and back to back, the plain version's and
    torch.linalg.inv's, and the bound. before: the replaced branch's
    device ms at this shape, logged beside. A as the solver hands it over:
    where it is not contiguous (the IRK stage Jacobians come transposed),
    each wrapper call copies it first, and the device time on a
    contiguous copy is given beside, for the kernel alone."""
    import torch
    from acados_tpu_torch.ops import batched_inv
    kern = batched_inv._gj_inverse_cuda
    M, n = A.shape[0], A.shape[-1]
    k_ms = cuda_ms(lambda: kern(A), reps=30)
    k_dev_ms = device_ms(lambda: kern(A))
    contiguous = {}
    if not A.is_contiguous():
        Ac = A.contiguous()
        contiguous = {"contiguous_device_ms": device_ms(lambda: kern(Ac))}
    p_ms = cuda_ms(lambda: batched_inv.gj_inverse_plain(A), reps=10)
    l_ms = cuda_ms(lambda: torch.linalg.inv(A), reps=20)
    nbytes = 2 * M * n * n * A.element_size()
    flops = 2 * M * n ** 3
    b_ms, b_by = k1_bound(A)
    was = f"; the replaced branch: {before}" if before else ""
    if contiguous:
        was += (f"; strides {A.stride()}, so the wrapper's copy is in it: "
                f"{contiguous['contiguous_device_ms']:.4f} ms on a "
                f"contiguous copy")
    log(f"K1 at {tuple(A.shape)} float32: kernel {k_ms:.4f} ms (device "
        f"{k_dev_ms:.4f} ms back to back{was}), plain {p_ms:.4f} ms, "
        f"torch.linalg.inv {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": name, "route": "cuda",
            "source": "acados_tpu_torch/csrc/gj_inverse.cu",
            "replaces": "acados_tpu/ops/batched_inv.py:39",
            "shape": list(A.shape), "launches": launches,
            "max_abs_err": abs_err, "max_rel_err_f32": rel, "ms": k_ms,
            "device_ms": k_dev_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms, **contiguous}


def chain_path(dev):
    """Phase 11: the chain RTI batch at full width. Returns K1's kernels
    entry at the chain's shape and the dynamics Jacobians A of one
    linearisation, (B * N, nx, nx)."""
    from acados_tpu_torch.ops import batched_inv
    solver = chain_batch(N_MASS, B_CHAIN, "float32", dev)
    nx = solver.form.nx
    n_calls = 1 + WARM_CALLS + TIMED_CALLS
    reset_counts()
    with K1Shapes() as k1:
        call_ms, qp_max = run_calls(solver, "chain path", tols=CHAIN_TOLS)
    counts = read_counts()
    M = B_CHAIN * N_CHAIN
    log(f"chain path: make_chain_mass_ocp(n_mass={N_MASS}, N={N_CHAIN}), "
        f"nx={nx}, IRK 2 stages kron, B={B_CHAIN}, float32, {n_calls} "
        f"solve() calls, launches {counts}, K1 shapes "
        f"{sorted(set(k1.shapes))}; largest qp_iter per call {qp_max}")
    want = K1_PER_CHAIN_CALL * n_calls
    if counts["gj_inverse"] != want or k1.shapes != [(M, nx, nx)] * want:
        raise SystemExit(f"chain path: expected {want} K1 launches of "
                         f"{(M, nx, nx)}, counted {counts['gj_inverse']}")
    if any(v for k, v in counts.items() if k != "gj_inverse"):
        raise SystemExit(f"chain path: unexpected launches {counts}")
    log(f"  per call: {call_stats(call_ms, B_CHAIN)}; qp_iter max "
        f"{int(solver.get_stats('qp_iter').max())} mean "
        f"{float(solver.get_stats('qp_iter').mean()):.2f}")
    log(f"  time split: {json.dumps(time_split(solver))}")
    # K1 on the block determinants of the cold call's first substep
    D = k1.first
    rel, abs_err, _ = check_inverse(
        f"chain block determinants {tuple(D.shape)}", D,
        batched_inv._gj_inverse_cuda, F32_BOUND)
    entry = k1_entry("gj_inverse_chain", D, counts["gj_inverse"], rel,
                     abs_err, before=K1_PARENT_CHAIN_DEVICE_MS)
    _, qp = linearized(solver)
    return entry, qp.A.reshape(M, nx, nx).contiguous()


def chain_sweep(dev):
    """Phase 12: n_mass = 3, 5, 11 at B_CHAIN, N_CHAIN, float32."""
    for n_mass, per_call in ((3, 2), (5, 2), (11, 4)):
        solver = chain_batch(n_mass, B_CHAIN, "float32", dev)
        reset_counts()
        with K1Shapes() as k1:
            call_ms, qp_max = run_calls(solver, f"chain n_mass={n_mass}",
                                        tols=CHAIN_TOLS,
                                        warm=WARM_CALLS - 1, timed=1)
        counts = read_counts()
        calls = 1 + WARM_CALLS
        log(f"chain sweep n_mass={n_mass} nx={solver.form.nx}: {calls} "
            f"calls, K1 launches {counts['gj_inverse']} of "
            f"{sorted(set(k1.shapes))}, largest qp_iter per call {qp_max}, "
            f"last call {call_ms[0]:.2f} ms")
        if counts["gj_inverse"] != per_call * calls:
            raise SystemExit(f"chain n_mass={n_mass}: expected "
                             f"{per_call * calls} K1 launches")


def same_bits(k, p) -> bool:
    """Equal entry for entry, NaN where the other is NaN."""
    import torch
    nan = torch.isnan(p)
    return bool(torch.equal(torch.isnan(k), nan)) and bool(
        torch.equal(k[~nan], p[~nan]))


def small_mm_phase(dev, A) -> dict:
    """Phase 13: K5 against its plain version bit for bit (the edge cases
    of its pair groups and padded tiles included), then its times over the
    microbenchmark's grid beside torch.bmm and the bound."""
    import torch
    from acados_tpu_torch.ops.small_mm import (SMALL_MM_MAX_N,
                                               small_mm_batched,
                                               small_mm_plain)

    def check(label, X, Y, quiet=False):
        k = small_mm_batched(X, Y)
        torch.cuda.synchronize()
        p = small_mm_plain(X, Y)
        ok = same_bits(k, p)
        fin = torch.isfinite(p)
        err = float((k[fin] - p[fin]).abs().max()) if bool(fin.any()) \
            else 0.0
        if not quiet or not ok:
            log(f"  {label:<40} {str(X.dtype):<14} max|k-p| {err:g}, NaN "
                f"{int(torch.isnan(p).sum())}, bit for bit {ok}")
        if not ok:
            raise SystemExit(f"K5 disagrees with its plain version: {label}")
        return err

    log("K5 small_mm: kernel vs plain version on the card")
    reset_counts()
    small_mm_batched(A, A)
    launches = read_counts()["small_mm"]
    err32 = check(f"chain Jacobians A @ A {tuple(A.shape)}", A, A)
    check(f"chain Jacobians A @ A {tuple(A.shape)}", A.double(), A.double())
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float32, torch.float64):
        for n in (1, 20, 39, 48, 64):
            X, Y = (torch.as_tensor(rng.normal(size=(1001, n, n)),
                                    dtype=dtype, device=dev)
                    for _ in range(2))
            check(f"random n={n} B=1001", X, Y)
        X, Y = (torch.as_tensor(rng.normal(size=(1001, 39, 39)), dtype=dtype,
                                device=dev) for _ in range(2))
        X[::7, 3, 5] = float("nan")
        Y[::5, 11, 2] = float("inf")
        X[::11, 20, 30] = -float("inf")
        check("NaN/inf entries n=39 B=1001", X, Y)
        # the ends of a pair group and the padded tile edge: short and
        # ragged batches, n inside and at the end of a band, and batches
        # with more groups than the card holds blocks
        cases = [(n, B) for n in K5_EDGE_N for B in K5_EDGE_B]
        cases += [(n, K5_LONG_B) for n in (1, 7)]
        cases += [(n, K5_SWEEP_B) for n in range(1, SMALL_MM_MAX_N + 1)]
        for n, B in cases:
            X, Y = (torch.as_tensor(rng.normal(size=(B, n, n)), dtype=dtype,
                                    device=dev) for _ in range(2))
            check(f"edge n={n} B={B}", X, Y, quiet=True)
        log(f"  edge cases {str(dtype):<14} {len(cases)} batches (n in "
            f"{K5_EDGE_N}, B in {K5_EDGE_B}; n = 1, 7 at B = {K5_LONG_B}; "
            f"n = 1..{SMALL_MM_MAX_N} at B = {K5_SWEEP_B}), bit for bit True")

    log("K5 grid, float32 (device ms back to back; torch.bmm with TF32 off):")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in (20, 39, 48, 64):
        for B in (256, 1024, 4096, 10240):
            X, Y = (torch.randn((B, n, n), generator=gen, device=dev)
                    for _ in range(2))
            k_dev = device_ms(lambda: small_mm_batched(X, Y))
            l_dev = device_ms(lambda: torch.bmm(X, Y))
            b_ms, b_by = bound_of(3 * B * n * n * 4, 2 * B * n ** 3)
            log(f"  n={n:2d} B={B:5d}: K5 {k_dev:.4f} ms, torch.bmm "
                f"{l_dev:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    X = A
    M, n = X.shape[0], X.shape[-1]
    k_ms = cuda_ms(lambda: small_mm_batched(X, X), reps=30)
    k_dev = device_ms(lambda: small_mm_batched(X, X))
    p_ms = cuda_ms(lambda: small_mm_plain(X, X), reps=5)
    l_ms = cuda_ms(lambda: torch.bmm(X, X), reps=30)
    l_dev = device_ms(lambda: torch.bmm(X, X))
    nbytes, flops = 3 * M * n * n * X.element_size(), 2 * M * n ** 3
    b_ms, b_by = bound_of(nbytes, flops)
    log(f"K5 at {tuple(X.shape)} float32: kernel {k_ms:.4f} ms (device "
        f"{k_dev:.4f} ms back to back; {K5_PREVIOUS_DEVICE_MS} before the "
        f"register-tiled design), plain {p_ms:.4f} ms, torch.bmm "
        f"{l_ms:.4f} ms (device {l_dev:.4f} ms), bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    X64 = A.double()
    k64 = device_ms(lambda: small_mm_batched(X64, X64))
    l64 = device_ms(lambda: torch.bmm(X64, X64))
    b64, b64_by = bound_of(2 * nbytes, flops, FP64_FLOPS)
    log(f"K5 at {tuple(X.shape)} float64: device {k64:.4f} ms back to "
        f"back, torch.bmm {l64:.4f} ms, bound {b64:.4f} ms ({b64_by}: "
        f"{2 * nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP at "
        f"{FP64_FLOPS / 1e12:g} TFLOP/s)")
    return {"name": "small_mm", "route": "cuda",
            "source": "acados_tpu_torch/csrc/small_mm.cu",
            "replaces": "scratch/bench_smallmm39.py:39",
            "shape": list(X.shape), "launches": launches,
            "solver_path_launches": 0, "max_abs_err": err32, "ms": k_ms,
            "device_ms": k_dev, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "library_device_ms": l_dev,
            "f64_device_ms": k64, "f64_library_device_ms": l64,
            "f64_bound_ms": b64}


def erk_models(dev):
    """Phase 15: the quadrotor and race car RTI batches at bench.py's
    widths, float32."""
    from acados_tpu_torch import models
    from acados_tpu_torch.testing import rti_batch as batch_at
    for name, sigma, kw in ERK_MODELS:
        ocp = getattr(models, f"make_{name}_ocp")(dtype="float32", **kw)
        nx = len(ocp.constraints.x0)
        x0s = np.random.default_rng(SEED).normal(0.0, sigma, (B_ERK, nx))
        solver = batch_at(ocp, x0s, dev)
        reset_counts()
        call_ms, qp_max = run_calls(solver, name, tols=ERK_TOLS, warm=19,
                                    timed=1)
        counts = read_counts()
        log(f"{name}: nx={nx}, N={solver.N}, B={B_ERK}, float32, 21 calls, "
            f"launches {counts}, largest qp_iter per call {qp_max}, last "
            f"call {call_ms[0]:.2f} ms")
        if any(counts.values()):
            raise SystemExit(f"{name}: unexpected kernel launches {counts}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    from acados_tpu_torch.dense_qp import ipm as dense_ipm
    from acados_tpu_torch.ops import batched_chol, batched_inv, cuda_build
    from acados_tpu_torch.ops.linsolve import linsolve
    from acados_tpu_torch.utils.device import full_precision_matmul

    # ---- 1. device ---------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    full_precision_matmul()
    dev = torch.device("cuda")

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    log(f"build: {sorted(cuda_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- 3. K1 against its plain version --------------------------------------
    log("K1 gj_inverse: kernel vs plain version on the card")
    solver, ocp = rti_batch(dict(N=N_HORIZON, dtype="float32",
                                 nlp_solver_type="SQP_RTI",
                                 integrator_type="IRK"), B_MAIN, dev)
    # stage Jacobians of one linearisation of the main path: the first
    # inverse the IRK step asks for at the initial iterate
    data = solver._data
    M = B_MAIN * N_HORIZON
    flat = lambda a: torch.as_tensor(
        np.asarray(a).reshape((M,) + np.shape(a)[2:]), dtype=torch.float32,
        device=dev)
    x_init = np.repeat(np.asarray(data["lb_0"])[:, None, :4], N_HORIZON,
                       axis=1)
    with K1Shapes() as k1:
        solver.form.step_jac_fn(
            flat(x_init), torch.zeros((M, 1), device=dev),
            torch.zeros((M, 0), device=dev),
            flat(data["ts"][:, :-1]), flat(data["dts"]))
    J = k1.first
    if J.shape != (M, 16, 16):
        raise SystemExit(f"unexpected stage Jacobian shape {tuple(J.shape)}")
    kern = batched_inv._gj_inverse_cuda
    rel32, abs32, res32 = check_inverse(
        f"stage Jacobians {tuple(J.shape)}", J, kern, F32_BOUND)
    check_inverse(f"stage Jacobians {tuple(J.shape)}", J.double(), kern,
                  F64_BOUND)
    rng = np.random.default_rng(SEED)
    k1_batches(dev, rng, kern)
    k1_edge_cases(dev, rng, kern)
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        n = 56
        A = torch.as_tensor(rng.normal(size=(1001, n, n)) + n * np.eye(n),
                            dtype=dtype, device=dev)
        check_inverse(f"random n={n} B=1001 (Schur)", A,
                      batched_inv._inv_impl, bound)
    # linsolve on the card inverts through the kernel at every n
    for n in (4, 16):
        A = torch.as_tensor(rng.normal(size=(1001, n, n)) + n * np.eye(n),
                            device=dev)
        b = torch.as_tensor(rng.normal(size=(1001, n)), device=dev)
        before = batched_inv.LAUNCHES
        x = linsolve(A, b)
        launched = batched_inv.LAUNCHES - before
        ref = (batched_inv.gj_inverse_plain(A) @ b[..., None])[..., 0]
        err = float((x - ref).abs().max() / ref.abs().max())
        log(f"  linsolve n={n} float64: {launched} K1 launch, "
            f"max|x-ref|/max|ref| {err:.3e}")
        if launched != 1 or not err <= F64_BOUND:
            raise SystemExit(f"linsolve on the card, n={n}: {launched} "
                             f"launches, error {err:.3e}")

    # time at the main-path shape, then over both branches' grid
    kernels = [k1_entry("gj_inverse", J, None, rel32, abs32,
                        before=K1_PARENT_MAIN_DEVICE_MS)]
    k1_grid({"K1": kern},
            parent={**K1_PARENT_DEVICE_MS, **K1_PARENT_GROUP_DEVICE_MS})
    k1_ms = kernels[0]["ms"]

    # ---- 4. main path ----------------------------------------------------------
    n_calls = 1 + WARM_CALLS + TIMED_CALLS
    reset_counts()
    call_ms, qp_max = run_calls(solver, "main path")
    counts = read_counts()
    launches = counts["gj_inverse"]
    kernels[0]["launches"] = launches
    log(f"main path: pendulum IRK SQP-RTI, B={B_MAIN}, N={N_HORIZON}, "
        f"float32, {n_calls} solve() calls, launches {counts}")
    if launches != LAUNCHES_PER_RTI * n_calls:
        raise SystemExit(f"expected {LAUNCHES_PER_RTI * n_calls} K1 "
                         f"launches, counted {launches}")
    med = float(np.median(call_ms))
    qp_iter = solver.get_stats("qp_iter")
    log(f"  per call: {call_stats(call_ms)}; "
        f"K1 {LAUNCHES_PER_RTI * k1_ms:.3f} ms per call "
        f"({LAUNCHES_PER_RTI * k1_ms / med * 100:.2f} %); qp_iter max "
        f"{int(qp_iter.max())} mean {float(qp_iter.mean()):.2f}")
    log(f"  time split: {json.dumps(time_split(solver))}")

    # ---- 5. reference check at a small input --------------------------------------
    kw64 = dict(N=N_HORIZON, dtype="float64", nlp_solver_type="SQP_RTI",
                integrator_type="IRK")
    card_vs_cpu("reference check",
                lambda where: rti_batch(kw64, 8, where, seed=1)[0])

    # ---- 6. full-condensing path ----------------------------------------------------
    fc, _ = rti_batch(dict(N=N_HORIZON, dtype="float32",
                           nlp_solver_type="SQP_RTI", integrator_type="IRK"),
                      B_MAIN, dev, qp_solver=FULL_COND)
    if not (fc.opts.full_cond and fc.opts.cond_N is None):
        raise SystemExit("the full-condensing options did not take")
    hb = []
    orig_chol = dense_ipm.chol_any

    def capture_hb(H):
        hb.append(H.detach().clone())
        return orig_chol(H)

    def release(c):
        dense_ipm.chol_any = orig_chol

    dense_ipm.chol_any = capture_hb   # the cold call's first round only
    reset_counts()
    try:
        fc_ms, fc_qp_max = run_calls(
            fc, "full-condensing path",
            on_call=lambda c: release(c) if c == 0 else None)
    finally:
        dense_ipm.chol_any = orig_chol
    counts = read_counts()
    nv = 4 + N_HORIZON
    log(f"full-condensing path: pendulum IRK SQP-RTI, {FULL_COND}, "
        f"B={B_MAIN}, float32, {n_calls} solve() calls, launches {counts}; "
        f"largest qp_iter per call {fc_qp_max} (sum {sum(fc_qp_max)})")
    if counts["gj_inverse"] != LAUNCHES_PER_RTI * n_calls:
        raise SystemExit(f"expected {LAUNCHES_PER_RTI * n_calls} K1 "
                         f"launches, counted {counts['gj_inverse']}")
    if counts["chol_factor"] != sum(fc_qp_max):
        raise SystemExit(f"expected {sum(fc_qp_max)} K2 launches (one per "
                         f"dense-IPM round), counted {counts['chol_factor']}")
    k2_launches = counts["chol_factor"]
    Hb = hb[0]
    if Hb.shape != (B_MAIN, nv, nv) or len(hb) != fc_qp_max[0]:
        raise SystemExit(f"captured {len(hb)} barrier Hessians of shape "
                         f"{tuple(Hb.shape)}")
    fc_qp = fc.get_stats("qp_iter")
    log(f"  per call: {call_stats(fc_ms)}; qp_iter max {int(fc_qp.max())} "
        f"mean {float(fc_qp.mean()):.2f}")
    log(f"  time split: {json.dumps(fc_time_split(fc))}")

    # ---- 7. K2, K3, K4 against their plain versions ---------------------------------
    log("K2/K3/K4 batched Cholesky: kernels vs plain versions on the card")
    b_hb = torch.as_tensor(rng.normal(size=(B_MAIN, nv)), device=dev)
    errs32 = check_chol(f"barrier Hessians {tuple(Hb.shape)}", Hb,
                        b_hb.float(), F32_BOUND)
    check_chol(f"barrier Hessians {tuple(Hb.shape)}", Hb.double(), b_hb,
               F64_BOUND)
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        for n in (1, 4, 13, 24, 39, 64):
            H = torch.as_tensor(spd_batch(rng, 1001, n), dtype=dtype,
                                device=dev)
            b = torch.as_tensor(rng.normal(size=(1001, n)), dtype=dtype,
                                device=dev)
            check_chol(f"SPD n={n} B=1001", H, b, bound)
        for n in (4, 24, 64):
            H, bad = indefinite_batch(rng, 1001, n)
            check_chol(f"indefinite/non-finite n={n} B=1001",
                       torch.as_tensor(H, dtype=dtype, device=dev),
                       torch.as_tensor(rng.normal(size=(1001, n)),
                                       dtype=dtype, device=dev),
                       bound, bad=torch.as_tensor(bad, device=dev))

    k2_bit_checks(dev, rng, batched_chol.chol_factor_batched, Hb)
    k3_k4_bit_checks(dev, rng, dict(
        chol_solve=batched_chol.chol_solve_batched,
        chol_factor_solve=batched_chol.chol_factor_solve_batched), Hb)

    # times at the dense IPM's shape, then over the grid
    n, Bm = nv, B_MAIN
    bf = b_hb.float()
    L32 = batched_chol.chol_factor_plain(Hb)
    parents = dict(chol_factor=("K2", ":38", K2_PARENT_DEVICE_MS),
                   chol_solve=("K3", ":60", K3_PARENT_DEVICE_MS),
                   chol_factor_solve=("K4", ":79", K4_PARENT_DEVICE_MS))
    for kname, (_, line, parent) in parents.items():
        kfn = getattr(batched_chol, kname + "_batched")
        pfn = getattr(batched_chol, kname + "_plain")
        args = chol_args(kname, Hb, L32, bf)
        lname, lfn = chol_library(kname)
        k_ms = cuda_ms(lambda: kfn(*args), reps=30)
        k_dev_ms = device_ms(lambda: kfn(*args))
        p_ms = cuda_ms(lambda: pfn(*args), reps=10)
        l_ms = cuda_ms(lambda: lfn(Hb, L32, bf), reps=20)
        l_dev_ms = kernel_busy_ms(lambda: lfn(Hb, L32, bf))
        b_ms, b_by = chol_bound(kname, Bm, n, Hb.dtype)
        log(f"{kname} at ({Bm}, {n}, {n}) float32: kernel {k_ms:.4f} ms "
            f"(device {k_dev_ms:.4f} ms back to back; the kernel the row "
            f"branch replaced {parent[(n, Bm, 'float32')]}), plain "
            f"{p_ms:.4f} ms, {lname} {l_ms:.4f} ms (its kernels' device "
            f"time {l_dev_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by})")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "acados_tpu_torch/csrc/batched_chol.cu",
            "replaces": "acados_tpu/ops/batched_chol.py" + line,
            "shape": [Bm, n, n],
            "launches": k2_launches if kname == "chol_factor" else None,
            "max_abs_err": errs32[kname][1],
            "max_rel_err_f32": errs32[kname][0], "ms": k_ms,
            "device_ms": k_dev_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
            "library_device_ms": l_dev_ms})
    for kname, (label, _, parent) in parents.items():
        chol_grid(kname, {label: getattr(batched_chol, kname + "_batched")},
                  parent=parent)

    # ---- 8. the public ops entry points ----------------------------------------------
    from acados_tpu_torch.ops import (chol_factor_batched,
                                      chol_factor_solve_batched,
                                      chol_solve_batched)
    H64, b64 = Hb.double(), b_hb
    reset_counts()
    L = chol_factor_batched(H64)
    x3 = chol_solve_batched(L, b64)
    x4, L4 = chol_factor_solve_batched(H64, b64)
    counts = read_counts()
    ref, _ = batched_chol.chol_factor_solve_plain(H64, b64)
    gap = max(float((x - ref).abs().max() / ref.abs().max())
              for x in (x3, x4))
    lib = torch.cholesky_solve(b64[..., None],
                               torch.linalg.cholesky(H64))[..., 0]
    lib_gap = float((x4 - lib).abs().max() / lib.abs().max())
    log(f"ops entry points on the barrier Hessians, float64: launches "
        f"{counts}, max|x-plain|/max|plain| {gap:.3e} (bound "
        f"{F64_BOUND:g}), L of K2 and K4 equal: {bool(torch.equal(L, L4))}; "
        f"beside torch.cholesky_solve {lib_gap:.3e}")
    if counts != dict(gj_inverse=0, chol_factor=1, chol_solve=1,
                      chol_factor_solve=1, small_mm=0) \
            or not gap <= F64_BOUND \
            or not torch.equal(L, L4):
        raise SystemExit("ops entry points failed")
    for kd in kernels[2:]:
        kd["launches"] = counts[kd["name"]]

    # ---- 9. full-condensing reference check ------------------------------------------
    card_vs_cpu("full-condensing reference check",
                lambda where: rti_batch(kw64, 8, where, seed=1,
                                        qp_solver=FULL_COND)[0])

    # ---- 10. Riccati IPM with a free initial state at nx = 16 -----------------------------
    riccati_free_x0(dev)

    # ---- 11. chain path at full width (the Kronecker IRK path) -----------------------------
    k1_chain, A_chain = chain_path(dev)
    kernels.append(k1_chain)

    # ---- 12. chain sweep -------------------------------------------------------------------
    chain_sweep(dev)

    # ---- 13. K5 against its plain version, its times -----------------------------------------
    kernels.append(small_mm_phase(dev, A_chain))

    # ---- 14. chain reference check -----------------------------------------------------------
    card_vs_cpu(f"chain reference check (n_mass={N_MASS}, N={N_CHAIN})",
                lambda where: chain_batch(N_MASS, 4, "float64", where),
                moved=lambda: chain_batch(N_MASS, 4, "float64", "cpu",
                                          moved=True))

    # ---- 15. quadrotor and race car ------------------------------------------------------------
    erk_models(dev)

    log(json.dumps({"kernels": kernels}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
