#!/usr/bin/env python3
"""Build copies of K1's CUDA source side by side and compare them on one
GPU: each against the plain version (chip_smoke.py's K1 batches and edge
cases), on N(0, 1) + 3 I at n = 3 against the plain version and against
each other, each later build against the first bit for bit on the group
branch's batches (n = 2, 4, 8, 16), then their device times in turns over
K1's grid.

Run from the root of the repository:

    python3 k1_compare.py [--sass] [LABEL=PATH.cu ...]

With no LABEL=PATH it builds acados_tpu_torch/csrc/gj_inverse.cu alone. To
hold the source against an earlier commit's, write that copy under build/
first and name both:

    git show <commit>:acados_tpu_torch/csrc/gj_inverse.cu \\
        > build/gj_inverse_before.cu
    python3 k1_compare.py before=build/gj_inverse_before.cu \\
        now=acados_tpu_torch/csrc/gj_inverse.cu

The copies are built by `cuda_build` and launched through K1's own wrapper
(`batched_inv._gj_inverse_cuda`), one library per source. A build that
fails a check is logged and still timed, and the exit code is then 1. The
builds are timed in turns (each label, then the labels in reverse), so two
versions are compared on one card in one run. The first build is the
reference of the bit-for-bit lines: name the earlier commit's copy first.
A build whose group-branch results differ from the first's also makes the
exit code 1. --sass prints, for each build, the SASS instruction mix of
one elimination step (cuobjdump) for each band of the warp branch and
each instance of the group branch. Needs one GPU and nvcc; imports
nothing of JAX.

The group branch's rows a lane (RL, 1 or 2 at each n) are held against
the other choice by a copy that differs in the dispatch lines alone:

    sed -e 's/\\(launch_group<T, [0-9]*\\), 1>/\\1, 3>/' \\
        -e 's/\\(launch_group<T, [0-9]*\\), 2>/\\1, 1>/' \\
        -e 's/\\(launch_group<T, [0-9]*\\), 3>/\\1, 2>/' \\
        acados_tpu_torch/csrc/gj_inverse.cu > build/gj_inverse_flip.cu
    python3 k1_compare.py before=build/gj_inverse_before.cu \\
        now=acados_tpu_torch/csrc/gj_inverse.cu flip=build/gj_inverse_flip.cu
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

ROOT = Path(__file__).resolve().parent
SOURCE = "acados_tpu_torch/csrc/gj_inverse.cu"
ILL_SEEDS = (0, 1, 2, 3)


def build(specs: dict) -> dict:
    """{label: source path} -> {label: K1 wrapper on that build}; all
    built at once, each build's registers and spills logged."""
    from acados_tpu_torch.ops import batched_inv, cuda_build
    paths = {label: str((ROOT / src).resolve()) for label, src in
             specs.items()}
    reports = cuda_build.build_all(list(paths.values()))
    for label, path in paths.items():
        kernel = None
        for line in reports.get(path, "").splitlines():
            m = re.search(r"Compiling entry function '.*?(gj_inv_\w+?)I([fd])"
                          r"(?:Li(\d+)E)?(?:Li(\d+)E)?", line)
            if m:
                kernel = f"{m.group(1)} {m.group(2)}{m.group(3) or ''}" + (
                    f" RL={m.group(4)}" if m.group(4) else "")
            elif kernel and ("registers" in line or "spill" in line):
                cs.log(f"  ptxas {label} {kernel}: "
                       f"{line.replace('ptxas info    :', '').strip()}")
    return {label: functools.partial(batched_inv._gj_inverse_cuda,
                                     source=path)
            for label, path in paths.items()}


_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def step_mix(sass: str) -> list:
    """Per band of the warp branch and per instance of the group branch:
    its SASS instructions, and those of one elimination step and their
    mix. The warp branch's step is averaged over its loop's body (one
    REDUX.MIN a step); the group branch has no loop (its k loop unrolls
    fully), so its step is its main body over n: the instructions up to
    its first unpredicated EXIT, staging included, the division's slow
    path (a subroutine after it) left out."""
    rows = []
    for func in re.split(r"\n\s*Function : ", sass):
        head = func.split("\n", 1)[0]
        warp = re.search(r"gj_inv_warpI([fd])Li(\d+)E", head)
        group = re.search(r"gj_inv_groupI([fd])Li(\d+)ELi(\d+)E", head)
        if not (warp or group):
            continue
        insns = [mm.groups() for mm in map(_INSN.search, func.split("\n"))
                 if mm]
        ops = [op for _, op in insns]
        if warp:
            steps = [i for i, op in enumerate(ops) if op == "REDUX.MIN"]
            if len(steps) < 2:
                continue
            body = ops[steps[0]:steps[-1]]
            k = len(steps) - 1
            band = f"{warp.group(1)}{warp.group(2)}"
        else:
            end = next((i + 1 for i, (pred, op) in enumerate(insns)
                        if op == "EXIT" and not pred), len(ops))
            body, k = ops[:end], int(group.group(2))
            band = f"{group.group(1)}{group.group(2)} RL={group.group(3)}"
        body = collections.Counter(op.split(".")[0] for op in body)
        per = lambda *names: sum(body[x] for x in names) / k
        rows.append(dict(
            band=band, instructions=len(ops),
            per_step=sum(body.values()) / k,
            fma=per("FFMA", "DFMA"), mul_add=per("FMUL", "FADD", "DMUL",
                                                 "DADD"),
            select=per("FSEL", "SEL"), shared=per("LDS", "STS"),
            reduce=per("REDUX"), shuffle=per("SHFL"),
            integer=per("ISETP", "IMAD", "IADD3", "VIADD", "LOP3", "SHF",
                        "LEA", "MOV", "P2R", "R2P"),
            branch=per("BRA", "BSSY", "BSYNC", "CALL")))
    return rows


def ill_conditioned_n3(kerns: dict) -> None:
    """Each build on N(0, 1) + 3 I at n = 3, B = 200,003 (one batch a seed
    of ILL_SEEDS, float32 and float64): its max|k - p| / max|p| against
    the plain version and the matrices it does not match bit for bit, and
    each later build's largest difference from the first build's result.
    Logged only: such batches hold matrices so ill-conditioned that
    rounding differences alone exceed F32_BOUND and F64_BOUND."""
    import torch
    from acados_tpu_torch.ops.batched_inv import gj_inverse_plain
    dev = torch.device("cuda")
    n, B = 3, cs.K1_LONG_B
    cs.log(f"N(0, 1) + {n} I at n = {n}, B = {B} (logged, not gated):")
    for seed in ILL_SEEDS:
        A0 = np.random.default_rng(seed).normal(size=(B, n, n)) \
            + n * np.eye(n)
        for dtype in (torch.float32, torch.float64):
            A = torch.as_tensor(A0, dtype=dtype, device=dev)
            P = gj_inverse_plain(A)
            outs = {label: kern(A) for label, kern in kerns.items()}
            first = next(iter(outs.values()))
            parts = []
            for label, K in outs.items():
                d = (K - P).abs().amax((1, 2))
                part = (f"{label} {float(d.max() / P.abs().max()):.3e} "
                        f"({int((d > 0).sum())} != plain")
                if K is not first:
                    dk = (K - first).abs().amax((1, 2))
                    part += (f"; max|{label} - {next(iter(outs))}| "
                             f"{float(dk.max()):.3e} in {int((dk > 0).sum())}")
                parts.append(part + ")")
            cs.log(f"  seed {seed} {str(dtype):<14} max|k-p|/max|p|: "
                   + ", ".join(parts))


def group_bit_equality(kerns: dict) -> list:
    """Each later build against the first on the group branch's batches
    (n in chip_smoke's K1_GROUP_N, float32 and float64): N(0, 1) + n I at
    each B of the grid, the same with rows permuted, the pivot-tie batch,
    and the long diagonally dominant batch with rows permuted. Logs max
    |build - first| and the matrices that differ; returns the labels of
    the builds that differ anywhere (expected none: the same operations in
    the same order)."""
    import torch
    from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
    dev = torch.device("cuda")
    ref, *rest = kerns
    differ = []
    if not rest:
        return differ
    cs.log(f"group branch, each build against {ref!r} bit for bit:")
    for n in cs.K1_GROUP_N:
        rng = np.random.default_rng(cs.SEED + n)
        batches = [(f"random B={B}", rng.normal(size=(B, n, n))
                    + n * np.eye(n)) for B in cs.K1_GROUP_GRID_B]
        batches.append(("rows permuted B=10240",
                        row_permuted_batch(rng, 10240, n)))
        batches.append(("ties", pivot_tie_batch(rng, 4096, n)[0]))
        A = rng.uniform(-1.0, 1.0, (cs.K1_LONG_B, n, n)) + 2 * n * np.eye(n)
        batches.append((f"long dominant B={cs.K1_LONG_B}", np.take_along_axis(
            A, np.argsort(rng.random((cs.K1_LONG_B, n)))[..., None], 1)))
        for name, A0 in batches:
            for dtype in (torch.float32, torch.float64):
                A = torch.as_tensor(A0, dtype=dtype, device=dev)
                first = kerns[ref](A)
                parts = []
                for label in rest:
                    d = (kerns[label](A) - first).abs().amax((1, 2))
                    count = int((d > 0).sum())
                    parts.append(f"max|{label} - {ref}| {float(d.max()):g} "
                                 f"in {count} of {len(A)}")
                    if count and label not in differ:
                        differ.append(label)
                cs.log(f"  n={n:2d} {name:<28} {str(dtype):<14} "
                       + ", ".join(parts))
    return differ


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_compare: CUDA is not available; this needs a GPU",
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
                [str(tool), "-sass",
                 str(cuda_build.target(kern.keywords["source"]))],
                capture_output=True, text=True, check=True).stdout
            for row in step_mix(sass):
                cs.log(f"  sass {label} {row['band']}: {row['instructions']}"
                       f" instructions, {row['per_step']:.0f} a step: "
                       f"{row['fma']:.0f} FMA, {row['mul_add']:.0f} "
                       f"mul/add, {row['select']:.0f} select, "
                       f"{row['shared']:.1f} shared, {row['reduce']:.0f} "
                       f"redux, {row['shuffle']:.1f} shuffle, "
                       f"{row['integer']:.0f} integer/move, "
                       f"{row['branch']:.1f} branch")
    failed = []
    for label, kern in kerns.items():
        cs.log(f"K1 build {label!r} against the plain version:")
        rng = np.random.default_rng(cs.SEED)
        try:
            cs.k1_batches(dev, rng, kern)
            cs.k1_edge_cases(dev, rng, kern)
        except SystemExit as e:
            cs.log(f"  build {label!r} FAILED: {e}")
            failed.append(label)
    ill_conditioned_n3(kerns)
    failed += [label for label in group_bit_equality(kerns)
               if label not in failed]
    labels = list(kerns)
    rows = cs.k1_grid(kerns, order=labels + labels[::-1])
    cs.log(json.dumps({"k1_grid": rows, "card": cs.card_line(),
                       "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
