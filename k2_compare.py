#!/usr/bin/env python3
"""Build copies of the Cholesky kernels' CUDA source side by side and
compare them on one GPU: each build's K2 against the plain version bit for
bit on chip_smoke.py's K2 batches, each later build's K2 against the
first's bit for bit, each build's K3 and K4 against their plain versions
bit for bit, then their device times in turns over K2's grid and K3's and
K4's at the dense IPM's (4096, 24, 24) float32.

Run from the root of the repository:

    python3 k2_compare.py [--sass] [LABEL=PATH.cu ...]

With no LABEL=PATH it builds acados_tpu_torch/csrc/batched_chol.cu alone.
To hold the source against an earlier commit's, write that copy under
build/ first and name both, the earlier first (it is the reference of the
bit-for-bit lines between builds):

    git show <commit>:acados_tpu_torch/csrc/batched_chol.cu \\
        > build/batched_chol_before.cu
    python3 k2_compare.py before=build/batched_chol_before.cu \\
        now=acados_tpu_torch/csrc/batched_chol.cu

The copies are built by `cuda_build` and launched through the package's
own wrappers (`source=` the path), one library per source. A build that
fails a check is logged and still timed, and the exit code is then 1. The
builds are timed in turns (each label, then the labels in reverse), so
two versions are compared on one card in one run. --sass prints ptxas's
registers and spills for each kernel and, for each build, the SASS
instruction mix (cuobjdump) of one step of the row branch at each band.
Needs one GPU and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs
from k1_compare import _INSN

ROOT = Path(__file__).resolve().parent
SOURCE = "acados_tpu_torch/csrc/batched_chol.cu"
KERNELS = ("chol_factor", "chol_solve", "chol_factor_solve")


def build(specs: dict) -> dict:
    """{label: source path} -> {label: {kernel: its wrapper on that
    build}}; all built at once, each kernel's registers and spills
    logged."""
    from acados_tpu_torch.ops import batched_chol, cuda_build
    paths = {label: str((ROOT / src).resolve()) for label, src in
             specs.items()}
    reports = cuda_build.build_all(list(paths.values()))
    for label, path in paths.items():
        kernel = None
        for line in reports.get(path, "").splitlines():
            m = re.search(r"Compiling entry function '.*?\d(chol_kernel|"
                          r"chol_factor_rows)I([fd])(?:Li(\d+)E|LN\w+?(\d)E)?",
                          line)
            if m:
                kernel = f"{m.group(1)} {m.group(2)}" + (
                    f"{m.group(3)}" if m.group(3) else
                    f" op {m.group(4)}" if m.group(4) else "")
            elif kernel and ("registers" in line or "spill" in line):
                cs.log(f"  ptxas {label} {kernel}: "
                       f"{line.replace('ptxas info    :', '').strip()}")
    wrappers = (batched_chol.chol_factor_batched,
                batched_chol.chol_solve_batched,
                batched_chol.chol_factor_solve_batched)
    return {label: {k: functools.partial(fn, source=path)
                    for k, fn in zip(KERNELS, wrappers)}
            for label, path in paths.items()}


def step_mix(sass: str) -> list:
    """Per band of the row branch (chol_factor_rows<T, NP>): its SASS
    instructions, and those of one step and their mix. The step loop
    unrolls fully and each step starts with the pivot's shuffle (two in
    float64), so a step is the span from the first shuffle to the last
    over NP - 1 steps."""
    rows = []
    for func in re.split(r"\n\s*Function : ", sass):
        head = func.split("\n", 1)[0]
        band = re.search(r"chol_factor_rowsI([fd])Li(\d+)E", head)
        if not band:
            continue
        ops = [mm.group(2) for mm in map(_INSN.search, func.split("\n"))
               if mm]
        shfl = [i for i, op in enumerate(ops) if op.startswith("SHFL")]
        k = int(band.group(2)) - 1
        if len(shfl) < 2:
            continue
        body = collections.Counter(
            op.split(".")[0] for op in ops[shfl[0]:shfl[-1]])
        per = lambda *names: sum(body[x] for x in names) / k
        rows.append(dict(
            band=f"{band.group(1)}{band.group(2)}", instructions=len(ops),
            per_step=sum(body.values()) / k,
            mul_add=per("FMUL", "FADD", "DMUL", "DADD"),
            fma=per("FFMA", "DFMA"), mufu=per("MUFU"),
            shared=per("LDS", "STS"), shuffle=per("SHFL"),
            compare_select=per("FSETP", "DSETP", "ISETP", "FSEL", "SEL",
                               "FCHK"),
            integer=per("IMAD", "IADD3", "VIADD", "LOP3", "SHF", "LEA",
                        "MOV", "P2R", "R2P", "PLOP3"),
            branch=per("BRA", "BSSY", "BSYNC", "CALL", "WARPSYNC", "NOP")))
    return rows


def step_listing(sass: str, band: str = "f24", step: int = 12) -> list:
    """The SASS of one step of the row branch at a band (default the
    dense IPM's, float32 NP = 24): from the pivot shuffle that ends step
    `step` - 1 (or begins step 0) to the next, one instruction a line."""
    for func in re.split(r"\n\s*Function : ", sass):
        head = func.split("\n", 1)[0]
        m = re.search(r"chol_factor_rowsI([fd])Li(\d+)E", head)
        if not m or f"{m.group(1)}{m.group(2)}" != band:
            continue
        lines = [ln.split(";")[0].split("*/", 1)[1].strip()
                 for ln in func.split("\n") if _INSN.search(ln)]
        shfl = [i for i, ln in enumerate(lines) if "SHFL" in ln]
        return lines[shfl[step]:shfl[step + 1] + 1]
    return []


def k3_k4_checks(dev, label, kern) -> bool:
    """K3 and K4 of one build against their plain versions bit for bit on
    SPD batches at n = 24 (B = 4096) and n = 39, 64 (B = 1001), float32
    and float64."""
    import torch
    from acados_tpu_torch.ops import batched_chol as bc
    rng = np.random.default_rng(cs.SEED)
    ok = True
    for n, B in ((24, 4096), (39, 1001), (64, 1001)):
        for dtype in (torch.float32, torch.float64):
            H = torch.as_tensor(cs.spd_batch(rng, B, n), dtype=dtype,
                                device=dev)
            b = torch.as_tensor(rng.normal(size=(B, n)), dtype=dtype,
                                device=dev)
            L = bc.chol_factor_plain(H)
            x4, L4 = kern["chol_factor_solve"](H, b)
            x4p, L4p = bc.chol_factor_solve_plain(H, b)
            same = dict(K3=cs.same_bits(kern["chol_solve"](L, b),
                                        bc.chol_solve_plain(L, b)),
                        K4=cs.same_bits(x4, x4p) and cs.same_bits(L4, L4p))
            ok = ok and all(same.values())
            cs.log(f"  {label} n={n:2d} B={B:4d} {str(dtype):<14} "
                   + ", ".join(f"{k} bit for bit {v}"
                               for k, v in same.items()))
    return ok


def builds_agree(dev, kerns: dict) -> list:
    """Each later build's K2 against the first's bit for bit on SPD X X' /
    n + I at every n = 1..32 (B = 4096) and on the indefinite and
    non-finite batches at n = 4, 13, 24, float32 and float64. Returns the
    labels of the builds that differ anywhere (expected none: the same
    operations in the same order)."""
    import torch
    ref, *rest = kerns
    differ = []
    if not rest:
        return differ
    rng = np.random.default_rng(cs.SEED + 1)
    batches = [(f"n={n} B=4096", cs.spd_batch(rng, 4096, n))
               for n in range(1, 33)]
    batches += [(f"indefinite/non-finite n={n} B=1001",
                 cs.indefinite_batch(rng, 1001, n)[0]) for n in (4, 13, 24)]
    for dtype in (torch.float32, torch.float64):
        counts = {label: 0 for label in rest}
        for name, H0 in batches:
            H = torch.as_tensor(H0, dtype=dtype, device=dev)
            first = kerns[ref]["chol_factor"](H)
            for label in rest:
                if not cs.same_bits(kerns[label]["chol_factor"](H), first):
                    counts[label] += 1
                    cs.log(f"  K2 {label} differs from {ref}: {name} "
                           f"{dtype}")
        cs.log(f"  K2 each build against {ref!r}, {str(dtype):<14} "
               f"{len(batches)} batches: " + ", ".join(
                   f"{label} differs in {c}" for label, c in counts.items()))
        differ += [label for label, c in counts.items()
                   if c and label not in differ]
    return differ


def k3_k4_times(kerns: dict, order: list) -> list:
    """Device ms back to back of each build's K3 and K4 at (4096, 24, 24)
    float32, in turns, beside the bound."""
    import torch
    from acados_tpu_torch.ops import batched_chol as bc
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    n, B = 24, cs.B_MAIN
    H = torch.as_tensor(cs.spd_batch(rng, B, n), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32,
                        device=dev)
    L = bc.chol_factor_plain(H)
    tri = n * (n + 1) // 2
    calls = dict(chol_solve=(lambda kern: kern["chol_solve"](L, b),
                             B * (tri + 2 * n) * 4),
                 chol_factor_solve=(lambda kern: kern["chol_factor_solve"](
                     H, b), B * (tri + n * n + 2 * n) * 4))
    rows = []
    for name, (call, nbytes) in calls.items():
        times = {label: [] for label in kerns}
        for label in order:
            times[label].append(cs.device_ms(lambda: call(kerns[label])))
        b_ms, _ = cs.bound_of(nbytes, 0)
        rows.append(dict(kernel=name, n=n, B=B, bound_ms=b_ms,
                         **{k: float(np.median(v)) for k, v in times.items()}))
        cs.log(f"  {name:<18} ({B}, {n}, {n}) float32 " + "  ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in v)}"
            for k, v in times.items()) + f"  bound {b_ms:.4f} (bytes)")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_compare: CUDA is not available; this needs a GPU",
              file=sys.stderr)
        return 2
    from acados_tpu_torch.ops import cuda_build
    from acados_tpu_torch.utils.device import full_precision_matmul
    specs = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    specs = specs or {"now": SOURCE}
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    full_precision_matmul()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kerns = build(specs)
    cs.log(f"build: {sorted(specs)} in {time.perf_counter() - t0:.1f} s")
    if "--sass" in sys.argv:
        tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
        for label, kern in kerns.items():
            sass = subprocess.run(
                [str(tool), "-sass", str(cuda_build.target(
                    kern["chol_factor"].keywords["source"]))],
                capture_output=True, text=True, check=True).stdout
            for row in step_mix(sass):
                cs.log(f"  sass {label} {row['band']}: {row['instructions']}"
                       f" instructions, {row['per_step']:.1f} a step: "
                       f"{row['mul_add']:.1f} mul/add, {row['fma']:.1f} "
                       f"FMA, {row['mufu']:.1f} MUFU, {row['shared']:.1f} "
                       f"shared, {row['shuffle']:.1f} shuffle, "
                       f"{row['compare_select']:.1f} compare/select, "
                       f"{row['integer']:.1f} integer/move, "
                       f"{row['branch']:.1f} branch/sync")
            for line in step_listing(sass):
                cs.log(f"  sass {label} f24 step: {line}")
    failed = []
    for label, kern in kerns.items():
        cs.log(f"build {label!r} against the plain versions:")
        try:
            cs.k2_bit_checks(dev, np.random.default_rng(cs.SEED),
                             kern["chol_factor"])
        except SystemExit as e:
            cs.log(f"  build {label!r} FAILED: {e}")
            failed.append(label)
        if not k3_k4_checks(dev, label, kern) and label not in failed:
            failed.append(label)
    failed += [label for label in builds_agree(dev, kerns)
               if label not in failed]
    labels = list(kerns)
    order = labels + labels[::-1]
    rows = cs.k2_grid({label: kern["chol_factor"]
                       for label, kern in kerns.items()}, order=order,
                      parent=cs.K2_PARENT_DEVICE_MS)
    rows += k3_k4_times(kerns, order)
    cs.log(json.dumps({"k2_grid": rows, "card": cs.card_line(),
                       "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
