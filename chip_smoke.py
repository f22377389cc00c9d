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
    (n = 4, 8, 16, 39, 48, a ragged batch size, n = 56 through the Schur
    path), on the same with rows permuted (row swaps at most steps), in
    float32 and float64, and on matrices with equal magnitudes in their
    pivot columns, where exact arithmetic makes kernel, plain version and
    exact inverse agree bit for bit only under the lowest-index tie rule;
    linsolve on the card launching K1 for small n too; then K1's time at
    the main-path shape beside its bound, the plain version and
    torch.linalg.inv;
 4. main path: AcadosOcpBatchSolver on the canonical pendulum IRK SQP-RTI
    config (N = 20, float32) at B = 4096, 1 cold + 15 warm + timed
    solve() calls; every status 0, the float32 tolerances met, and exactly
    8 kernel launches per RTI call; then where the time of a call goes
    (layers on the host clock, device busy share from torch.profiler);
 5. reference check: the same config in float64 at B = 8 on the card and
    on the CPU (the port's plain path, which the CPU tests hold against
    the JAX package) must agree.
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
# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
F32_BOUND = 1e-4
F64_BOUND = 1e-12


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


def check_inverse(name, A, inv_kernel, bound):
    """Kernel against the plain version on the same input; returns
    (rel_err, abs_err, resid)."""
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
    log(f"  {name:<34} {str(A.dtype):<14} max|k-p|/max|p| {rel:.3e}  "
        f"max|A Ainv - I| {resid:.3e}  bound {bound:g}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version: {name}")
    return rel, abs_err, resid


def rti_batch(ocp_kw, B, device, seed=SEED):
    """The main path's batch solver with bench.py's _build_rti set-up:
    x0 per instance = X0_CENTER + N(0, X0_SIGMA), set as lbx/ubx at stage
    0, and the x trajectory initialised at x0."""
    from acados_tpu_torch import AcadosOcpBatchSolver
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    ocp = make_pendulum_ocp(**ocp_kw)
    solver = AcadosOcpBatchSolver(ocp, N_batch=B, device=device)
    rng = np.random.default_rng(seed)
    x0s = np.asarray(X0_CENTER) + rng.normal(0.0, X0_SIGMA, (B, 4))
    for i, view in enumerate(solver.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(solver.N + 1):
            view.set(k, "x", x0s[i])
    return solver, ocp


def in_tolerance(solver, so):
    """bench.py's _residual_fields gate on the last solve's residuals."""
    res = solver.get_stats("residuals").max(axis=0)
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


def time_split(solver) -> dict:
    """Where the time of one warm RTI call goes: its layers on the host
    clock (each synchronised, medians), then a torch.profiler trace of a
    few calls for the device's busy share and kernel launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acados_tpu_torch.ocp_nlp.linearize import (build_static_rows,
                                                    linearize)
    from acados_tpu_torch.ocp_nlp.sqp import use_x0_elimination
    from acados_tpu_torch.ocp_qp.ipm import solve_ocp_qp
    form, opts = solver.form, solver.opts
    data, it = solver._data_dev, solver._it_dev
    rows = build_static_rows(form, it.x.dtype, it.x.device)
    lm = torch.tensor(opts.levenberg_marquardt, dtype=it.x.dtype,
                      device=it.x.device)
    x0f = use_x0_elimination(form, opts)
    M = it.u.shape[0] * it.u.shape[1]
    flat = lambda t: t.reshape((M,) + tuple(t.shape[2:]))
    step_args = (flat(it.x[:, :-1]), flat(it.u), flat(data.p[:, :-1]),
                 flat(data.ts[:, :-1]), flat(data.dts))
    qp = linearize(form, rows, data, it, lm)
    out = dict(call_ms=host_ms(solver.solve),
               linearize_ms=host_ms(lambda: linearize(form, rows, data, it,
                                                      lm)),
               irk_step_jac_ms=host_ms(lambda: form.step_jac_fn(*step_args)),
               qp_ms=host_ms(lambda: solve_ocp_qp(qp, opts.qp_opts,
                                                  x0_fixed=x0f)))
    out["rest_ms"] = out["call_ms"] - out["linearize_ms"] - out["qp_ms"]
    calls = 3
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
    out.update(device_busy_ms_per_call=busy_ms,
               device_busy_share=busy_ms / out["call_ms"],
               profiled_wall_ms_per_call=wall_ms / calls,
               kernel_launches_per_call=len(kern) / calls,
               top_kernels=[dict(name=k[:80], ms=v[0], launches=v[1])
                            for k, v in sorted(busy.items(),
                                               key=lambda kv: -kv[1][0])[:6]])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    from acados_tpu_torch.ops import batched_inv, cuda_build
    from acados_tpu_torch.ops.linsolve import linsolve
    from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
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
    import acados_tpu_torch.sim.irk as irk_mod
    captured = []
    orig_inv = irk_mod.gj_inverse_any

    def capture(A):
        if not captured:
            captured.append(A.detach().clone())
        return orig_inv(A)

    irk_mod.gj_inverse_any = capture
    try:
        data = solver._data
        M = B_MAIN * N_HORIZON
        flat = lambda a: torch.as_tensor(
            np.asarray(a).reshape((M,) + np.shape(a)[2:]),
            dtype=torch.float32, device=dev)
        x_init = np.repeat(np.asarray(data["lb_0"])[:, None, :4], N_HORIZON,
                           axis=1)
        solver.form.step_jac_fn(
            flat(x_init), torch.zeros((M, 1), device=dev),
            torch.zeros((M, 0), device=dev),
            flat(data["ts"][:, :-1]), flat(data["dts"]))
    finally:
        irk_mod.gj_inverse_any = orig_inv
    J = captured[0]
    if J.shape != (M, 16, 16):
        raise SystemExit(f"unexpected stage Jacobian shape {tuple(J.shape)}")
    kern = batched_inv._gj_inverse_cuda
    rel32, abs32, res32 = check_inverse(
        f"stage Jacobians {tuple(J.shape)}", J, kern, F32_BOUND)
    check_inverse(f"stage Jacobians {tuple(J.shape)}", J.double(), kern,
                  F64_BOUND)
    rng = np.random.default_rng(SEED)
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        for n in (4, 8, 16, 39, 48, 56):
            batch = 1001
            A = rng.normal(size=(batch, n, n)) + n * np.eye(n)
            A = torch.as_tensor(A, dtype=dtype, device=dev)
            fn = kern if n <= 48 else batched_inv._inv_impl
            label = f"random n={n} B={batch}" + (" (Schur)" if n > 48
                                                  else "")
            check_inverse(label, A, fn, bound)
        for n in (4, 8, 16, 39):
            A = row_permuted_batch(rng, 1001, n)
            swaps = np.mean(np.argmax(np.abs(A[:, :, 0]), axis=1) != 0)
            check_inverse(f"rows permuted n={n} (swap at k=0: "
                          f"{swaps:.0%})",
                          torch.as_tensor(A, dtype=dtype, device=dev), kern,
                          bound)
    # equal magnitudes in the pivot columns, in exact arithmetic: the
    # kernel must pick the lowest row index, as the plain version does
    for n in (4, 8, 16, 39):
        A, X = pivot_tie_batch(rng, 4096, n)
        col0 = np.abs(A[:, :, 0])
        ties = np.sum(np.sum(col0 == col0.max(1, keepdims=True), 1) > 1)
        swaps = np.sum(np.argmax(col0, axis=1) != 0)
        for dtype in (torch.float32, torch.float64):
            At = torch.as_tensor(A, dtype=dtype, device=dev)
            Xt = torch.as_tensor(X, dtype=dtype, device=dev)
            Ak, Ap = kern(At), batched_inv.gj_inverse_plain(At)
            d_kp = float((Ak - Ap).abs().max())
            d_kx = float((Ak - Xt).abs().max())
            log(f"  ties n={n} B={len(A)} {str(dtype):<14} (ties at k=0 "
                f"{ties}, swaps {swaps}): max|k-p| {d_kp:g}, "
                f"max|k-exact| {d_kx:g}  bound 0  "
                f"{'ok' if d_kp == d_kx == 0 else 'FAIL'}")
            if not d_kp == d_kx == 0:
                raise SystemExit(f"K1 breaks pivot ties differently: n={n}")
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

    # time at the main-path shape
    n = 16
    k1_ms = cuda_ms(lambda: kern(J), reps=30)
    plain_ms = cuda_ms(lambda: batched_inv.gj_inverse_plain(J), reps=20)
    lib_ms = cuda_ms(lambda: torch.linalg.inv(J), reps=20)
    bytes_moved = 2 * M * n * n * J.element_size()
    flops = M * (4 * n ** 3 - 2 * n ** 2)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"K1 at {tuple(J.shape)} float32: kernel {k1_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.linalg.inv {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {bytes_moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")

    # ---- 4. main path ----------------------------------------------------------
    so = ocp.solver_options
    batched_inv.LAUNCHES = 0
    call_ms, statuses = [], []
    n_calls = 1 + WARM_CALLS + TIMED_CALLS
    for c in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = solver.solve()
        torch.cuda.synchronize()
        if c > WARM_CALLS:
            call_ms.append((time.perf_counter() - t0) * 1e3)
        statuses.append(st)
    launches = batched_inv.LAUNCHES
    log(f"main path: pendulum IRK SQP-RTI, B={B_MAIN}, N={N_HORIZON}, "
        f"float32, {n_calls} solve() calls, K1 launches {launches}")
    if launches != LAUNCHES_PER_RTI * n_calls:
        raise SystemExit(f"expected {LAUNCHES_PER_RTI * n_calls} K1 "
                         f"launches, counted {launches}")
    bad = [c for c, st in enumerate(statuses) if np.any(st != 0)]
    if bad:
        raise SystemExit(f"non-zero statuses in calls {bad}: "
                         f"{np.unique(statuses[bad[0]], return_counts=True)}")
    ok_tol, res, tols = in_tolerance(solver, so)
    log(f"  residual maxima {res.tolist()} vs tolerances {list(tols)}: "
        f"{'in tolerance' if ok_tol else 'OUT OF TOLERANCE'}")
    if not ok_tol:
        raise SystemExit("main path not in tolerance")
    x = solver._it_dev.x
    if x.shape != (B_MAIN, N_HORIZON + 1, 4) or not bool(
            torch.isfinite(x).all()):
        raise SystemExit(f"bad trajectory tensor {tuple(x.shape)}")
    med = float(np.median(call_ms))
    p10, p90 = (float(np.percentile(call_ms, q)) for q in (10, 90))
    qp_iter = solver.get_stats("qp_iter")
    log(f"  per call: median {med:.2f} ms (p10 {p10:.2f}, p90 {p90:.2f}) "
        f"over {len(call_ms)} calls -> {B_MAIN / med * 1e3:.1f} solves/s; "
        f"K1 {LAUNCHES_PER_RTI * k1_ms:.3f} ms per call "
        f"({LAUNCHES_PER_RTI * k1_ms / med * 100:.2f} %); qp_iter max "
        f"{int(qp_iter.max())} mean {float(qp_iter.mean()):.2f}")
    log(f"  time split: {json.dumps(time_split(solver))}")

    # ---- 5. reference check at a small input --------------------------------------
    kw64 = dict(N=N_HORIZON, dtype="float64", nlp_solver_type="SQP_RTI",
                integrator_type="IRK")
    gpu, _ = rti_batch(kw64, 8, dev, seed=1)
    cpu, _ = rti_batch(kw64, 8, "cpu", seed=1)
    for _ in range(3):
        st_g, st_c = gpu.solve(), cpu.solve()
        if not (np.array_equal(st_g, st_c) and np.array_equal(
                gpu.get_stats("qp_iter"), cpu.get_stats("qp_iter"))):
            raise SystemExit("card and CPU disagree on statuses/qp_iter")
    gap = 0.0
    for f in ("x", "u", "pi"):
        a = getattr(gpu._it_dev, f).cpu().numpy()
        b = getattr(cpu._it_dev, f).numpy()
        gap = max(gap, float(np.max(np.abs(a - b) / (1 + np.abs(b)))))
    log(f"reference check float64 B=8, 3 RTI calls: card vs CPU "
        f"max |d|/(1+|ref|) {gap:.3e} (bound 1e-9), statuses "
        f"{st_g.tolist()}")
    if not gap <= 1e-9:
        raise SystemExit("card and CPU disagree")

    kernels = {"kernels": [{
        "name": "gj_inverse", "route": "cuda",
        "source": "acados_tpu_torch/csrc/gj_inverse.cu",
        "replaces": "acados_tpu/ops/batched_inv.py:39",
        "launches": launches, "max_abs_err": abs32,
        "max_rel_err_f32": rel32, "ms": k1_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}]}
    log(json.dumps(kernels))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
