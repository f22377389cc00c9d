#!/usr/bin/env python3
"""Build copies of the Cholesky kernels' CUDA source side by side and
compare them on one GPU: each build's K2, K3 and K4 against their plain
versions bit for bit on chip_smoke.py's batches, each later build's K2
against the first's bit for bit, then their device times in turns over
the grid of each (chip_smoke.chol_grid).

Run from the root of the repository:

    python3 k2_compare.py [--sass] [--sweep] [--ablate] [LABEL=PATH.cu ...]

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
instruction mix (cuobjdump) of one step of each row-branch kernel at each
band, and the listings of one factor step and one back-substitution step
at the dense IPM's band. --sweep also times
K2 alone over batches of 64..4096 at n = 15, 39, 64 in both types
(batch_sweep), beside torch.linalg.cholesky_ex timed the same way: where
the block branch and the others cross over in B. --ablate adds builds
of the `now` source (or the package's) with parts of the block branch's
step taken out (ABLATIONS; they fail the checks and are timed all the
same), and one that sends K2 through the block branch at every n. Needs one GPU and nvcc; imports nothing of JAX.
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
            entry = "Compiling entry function" in line
            m = re.search(r"\dchol_kernelI([fd])LN\w*?OpE(\d)E", line)
            blk = re.search(r"\dchol_blockI([fd])E", line)
            if entry and m:
                kernel = f"chol_kernel {m.group(1)} op {m.group(2)}"
            elif entry and blk:
                kernel = f"block branch {blk.group(1)}"
            elif entry and _row_kernel(line):
                kernel = f"row branch {_row_kernel(line)}"
            elif kernel and ("registers" in line or "spill" in line):
                cs.log(f"  ptxas {label} {kernel}: "
                       f"{line.replace('ptxas info    :', '').strip()}")
    wrappers = (batched_chol.chol_factor_batched,
                batched_chol.chol_solve_batched,
                batched_chol.chol_factor_solve_batched)
    return {label: {k: functools.partial(fn, source=path)
                    for k, fn in zip(KERNELS, wrappers)}
            for label, path in paths.items()}


def _row_kernel(name: str):
    """The band of a row-branch kernel named in a line ("f24": K2 at
    float32 NP = 24, "f24 K3", "f24 K4"; chol_factor_rows, an earlier
    source's K2, reads as K2), or None."""
    m = re.search(r"chol_(?:factor_)?rowsI([fd])Li(\d+)E(?:LN\w*?OpE(\d)E)?",
                  name)
    if not m:
        return None
    return m.group(1) + m.group(2) + {"1": " K3", "2": " K4"}.get(
        m.group(3), "")


def _functions(sass: str):
    """(band, instruction lines) of each row-branch kernel in a listing."""
    for func in re.split(r"\n\s*Function : ", sass):
        band = _row_kernel(func.split("\n", 1)[0])
        if band:
            yield band, [ln for ln in func.split("\n") if _INSN.search(ln)]


def _divisions(ops: list) -> list:
    """Positions of the divisions' reciprocals before the last EXIT (the
    slow paths' subroutines follow it)."""
    ends = [i for i, op in enumerate(ops) if op == "EXIT"] or [len(ops)]
    return [i for i, op in enumerate(ops[:ends[-1]])
            if op.startswith("MUFU.RCP")]


def step_mix(sass: str) -> list:
    """Per row-branch kernel and band (chol_rows<T, NP, OP>): its SASS
    instructions, and those of one step and their mix. Every step (a
    factor step, a forward or a back substitution step) holds one
    division, each on the chain of the one before, so a step is the span
    from the first division's reciprocal (MUFU.RCP, MUFU.RCP64H) to the
    last before the final EXIT over their count less one."""
    rows = []
    for band, lines in _functions(sass):
        ops = [_INSN.search(ln).group(2) for ln in lines]
        rcp = _divisions(ops)
        if len(rcp) < 2:
            continue
        body = collections.Counter(
            op.split(".")[0] for op in ops[rcp[0]:rcp[-1]])
        k = len(rcp) - 1
        per = lambda *names: sum(body[x] for x in names) / k
        rows.append(dict(
            band=band, instructions=len(ops), steps=len(rcp),
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
    """The SASS of one step of a row-branch kernel at a band (default K2
    at the dense IPM's, float32 NP = 24): from the reciprocal of step
    `step` to the next, one instruction a line. In "f24 K3" steps 0..23
    are the forward substitution's and 24..47 the back's (x_23 first)."""
    for name, lines in _functions(sass):
        if name != band:
            continue
        rcp = _divisions([_INSN.search(ln).group(2) for ln in lines])
        lines = [ln.split(";")[0].split("*/", 1)[1].strip() for ln in lines]
        return lines[rcp[step]:rcp[step + 1] + 1]
    return []


def builds_agree(dev, kerns: dict) -> list:
    """Each later build's K2 against the first's bit for bit on SPD X X' /
    n + I at every n = 1..32 (B = 4096) and at K2_BLOCK_N (B = 256), and
    on the indefinite and non-finite batches at n = 4, 13, 24, float32
    and float64. Returns the
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
    batches += [(f"n={n} B=256", cs.spd_batch(rng, 256, n))
                for n in cs.K2_BLOCK_N]
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


SWEEP_N = (15, 39, 64)
SWEEP_B = (64, 128, 256, 512, 1024, 2048, 4096)

# the block branch's step loop with a part taken out, for timing alone
# (the results are wrong): the pivots' sqrt and reciprocal, the general
# threads' updates, or both (the barriers and the pivot thread's loads
# and products remain); and "allblock", right, whose dispatcher sends K2
# through the block branch at every (B, n)
_PIVOTS = (("const T d2 = sqrt_rn(p2);", "const T d2 = p2;"),
           ("const T inv2 = dvd(T(1), d2);", "const T inv2 = p2;"),
           ("const T d3 = sqrt_rn(p3);", "const T d3 = p3;"),
           ("inv3 = dvd(T(1), d3);", "inv3 = p3;"))
_GENERAL = (("    } else if (tid < kBlockGeneral) {",
             "    } else if (false) {"),)
ABLATIONS = {"nosqrt": _PIVOTS, "noupdate": _GENERAL,
             "barrier": _PIVOTS + _GENERAL,
             # not an ablation: K2 through the block branch at every (B, n)
             "allblock": (("  if (n <= 32) return Branch::kRows;",
                           "  if (OP == Op::kFactor) return Branch::kBlock;"
                           "\n  if (n <= 32) return Branch::kRows;"),)}


def ablations(source: str) -> dict:
    """{label: path} of copies of `source` with ABLATIONS applied, written
    under build/."""
    text = (ROOT / source).read_text()
    out = {}
    for label, edits in ABLATIONS.items():
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"ablation {label}: the source has no "
                                 f"{old!r}")
            t = t.replace(old, new)
        path = ROOT / "build" / f"batched_chol_{label}.cu"
        path.parent.mkdir(exist_ok=True)
        path.write_text(t)
        out[label] = str(path.relative_to(ROOT))
    return out


def batch_sweep(kerns: dict, order: list) -> list:
    """K2's device ms back to back of each build in turns at n in SWEEP_N
    x B in SWEEP_B, float32 and float64, beside torch.linalg.cholesky_ex
    timed the same way and each build's branch there: where the branches
    cross over in B."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    rows = []
    cs.log("K2 batch sweep (device ms back to back; cholesky_ex the same "
           "way):")
    for dtype in (torch.float32, torch.float64):
        for n in SWEEP_N:
            for B in SWEEP_B:
                X = torch.randn((B, n, n), generator=gen, device=dev,
                                dtype=dtype)
                H = X @ X.transpose(1, 2) / n + torch.eye(
                    n, device=dev, dtype=dtype)
                times = {label: [] for label in kerns}
                for label in order:
                    fn = kerns[label]["chol_factor"]
                    times[label].append(cs.device_ms(lambda: fn(H)))
                lib = cs.device_ms(lambda: torch.linalg.cholesky_ex(H))
                dt = str(dtype).split(".")[-1]
                branch = {label: cs.k2_branch("chol_factor", B, n,
                                              kern["chol_factor"])
                          for label, kern in kerns.items()}
                rows.append(dict(n=n, B=B, dtype=dt, library_ms=lib,
                                 branch=branch, **{
                                     k: float(np.median(v))
                                     for k, v in times.items()}))
                cs.log(f"  n={n:2d} B={B:5d} {dt:<7} " + "  ".join(
                    f"{k} {float(np.median(v)):.4f} ({branch[k]})"
                    for k, v in times.items())
                    + f"  cholesky_ex {lib:.4f}")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_compare: CUDA is not available; this needs a GPU",
              file=sys.stderr)
        return 2
    from acados_tpu_torch.ops import cuda_build
    from acados_tpu_torch.utils.device import full_precision_matmul
    specs = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a
                 and not a.startswith("--"))
    specs = specs or {"now": SOURCE}
    if "--ablate" in sys.argv:
        specs.update(ablations(specs.get("now", SOURCE)))
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
                       f" instructions, {row['steps']} steps, "
                       f"{row['per_step']:.1f} a step: "
                       f"{row['mul_add']:.1f} mul/add, {row['fma']:.1f} "
                       f"FMA, {row['mufu']:.1f} MUFU, {row['shared']:.1f} "
                       f"shared, {row['shuffle']:.1f} shuffle, "
                       f"{row['compare_select']:.1f} compare/select, "
                       f"{row['integer']:.1f} integer/move, "
                       f"{row['branch']:.1f} branch/sync")
            for band, step in (("f24", 12), ("f24 K3", 36)):
                for line in step_listing(sass, band, step):
                    cs.log(f"  sass {label} {band} step {step}: {line}")
    failed = []
    for label, kern in kerns.items():
        cs.log(f"build {label!r} against the plain versions:")
        for check, arg in ((cs.k2_bit_checks, kern["chol_factor"]),
                           (cs.k3_k4_bit_checks, kern)):
            try:
                check(dev, np.random.default_rng(cs.SEED), arg)
            except SystemExit as e:
                cs.log(f"  build {label!r} FAILED: {e}")
                if label not in failed:
                    failed.append(label)
    failed += [label for label in builds_agree(dev, kerns)
               if label not in failed]
    labels = list(kerns)
    order = labels + labels[::-1]
    parents = dict(chol_factor=cs.K2_PARENT_DEVICE_MS,
                   chol_solve=cs.K3_PARENT_DEVICE_MS,
                   chol_factor_solve=cs.K4_PARENT_DEVICE_MS)
    rows = []
    for kname, parent in parents.items():
        rows += cs.chol_grid(kname, {label: kern[kname]
                                     for label, kern in kerns.items()},
                             order=order, parent=parent)
    sweep = batch_sweep(kerns, order) if "--sweep" in sys.argv else None
    cs.log(json.dumps({"grid": rows, "sweep": sweep, "card": cs.card_line(),
                       "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
