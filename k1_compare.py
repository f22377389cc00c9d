#!/usr/bin/env python3
"""Build copies of K1's CUDA source side by side and compare them on one
GPU: each against the plain version (chip_smoke.py's K1 batches and edge
cases), on N(0, 1) + 3 I at n = 3 against the plain version and against
each other, each later build against the first bit for bit on the group
branch's batches (n = 2, 4, 8, 16), then their device times in turns over
K1's grid, each cell on its row-major batch and on the same matrices as a
transposed view (label/tr; the layout the IRK hands over, read in place
by a build that has the gj_inverse_tr_* entry points, copied first by the
wrapper as the parent did for one that has not).

Run from the root of the repository:

    python3 k1_compare.py [--sass] [--stage] [--pad] [--variants[=A,B]]
                          [LABEL=PATH.cu ...]

--stage also captures the main path's stage Jacobians, (81,920, 16, 16)
float32 as the IRK hands them over (chip_smoke.stage_jacobians), and
times each build in turns on them as handed over, on their contiguous
copy and on variants that each change one property of the data (N(0, 1)
+ 16 I, their exact zeros filled, N(0, 1) + 16 I with their zeros, their
rows permuted, 1e-2 N(0, 1) + I, the identity), logging each variant's
share of zeros and of matrices whose pivot search swaps a row.
--pad holds the group branch's padded orders (n = 3, 5-7, 9-15, each
inverted in the band the next power of two) against the first build:
every build's route at each n (a build that has gj_inverse_route), the
bit-for-bit lines at every n = 3..15 beside n = 2, 4, 8, 16, and the DAE
cart's stage systems, (81,920, 9, 9) float32 as its IRK hands them over
(the first K1 launch of one SQP iteration), each build timed on them in
turns; its grid is K1_PAD_CELLS (every n = 3..15 at B = 81,920, float32
and float64), then the default one.
--variants adds builds of the `now` source (or the package's) with one
change each (VARIANTS, written under build/; --variants=A,B only those):
flip_tr, the group branch's other transposed loads at each n (see
below); seethrough, the numerator's select left visible to the compiler
(which then divides zeros on the slow path, as the parent did); divzero,
zero numerators divided as the others (the same results: x / piv and
x * piv are the same signed zero); nodiv, the quotients multiplied
instead of divided (wrong results, timed all the same); pad_rl, the
padded orders' other rows a lane in each band (one at n = 3, 5-7, two at
n = 9-15); flip_rl, the other rows a lane at n = 2, 4, 8, 16.

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

The group branch's transposed loads (direct scalar loads at one row a
lane, the warp's matrices staged through shared memory at two) are held
against the other choice at n = 2, 4, 8, 16 (a padded order loads
directly) by a copy that flips kStageTransposed:

    sed -e 's/kStageTransposed = RL == 2/kStageTransposed = RL != 2/' \
        acados_tpu_torch/csrc/gj_inverse.cu > build/gj_inverse_flip_tr.cu
    python3 k1_compare.py --stage now=acados_tpu_torch/csrc/gj_inverse.cu \
        flip_tr=build/gj_inverse_flip_tr.cu

The group branch's rows a lane (RL, 1 or 2 at each n) are held against
the other choice by the variants flip_rl (at n = 2, 4, 8, 16) and pad_rl
(at the padded orders):

    python3 k1_compare.py --pad --variants=flip_rl,pad_rl \
        before=build/gj_inverse_before.cu \
        now=acados_tpu_torch/csrc/gj_inverse.cu
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
# copies of the source with one change each, for timing (--variants)
_DIVIDE = "const T q = opaque(z ? T(1) : x) / piv;"
VARIANTS = {
    "flip_tr": (("kStageTransposed = RL == 2", "kStageTransposed = RL != 2"),),
    "seethrough": ((_DIVIDE, _DIVIDE.replace("opaque(z ? T(1) : x)",
                                             "(z ? T(1) : x)")),),
    "divzero": (("const bool z = plain_zero && x == T(0);",
                 "const bool z = false && plain_zero;"),),
    "nodiv": ((_DIVIDE, _DIVIDE.replace(" / piv", " * piv")),),
    "pad_rl": (("constexpr int kPadRL4 = 2, kPadRL8 = 2, kPadRL16 = 1;",
                "constexpr int kPadRL4 = 1, kPadRL8 = 1, kPadRL16 = 2;"),),
    "flip_rl": (("return n == 2 || n == 16 ? 1 : n == 4 || n == 8 ? 2",
                 "return n == 2 || n == 16 ? 2 : n == 4 || n == 8 ? 1"),)}


def variants(source: str, names=None) -> dict:
    """{label: path} of copies of `source` with VARIANTS applied (every
    occurrence: both branches), written under build/; names: the
    VARIANTS to write (default all)."""
    text = (ROOT / source).read_text()
    out = {}
    for label in names or VARIANTS:
        edits = VARIANTS[label]
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"variant {label}: the source has no "
                                 f"{old!r}")
            t = t.replace(old, new)
        path = ROOT / "build" / f"gj_inverse_{label}.cu"
        path.parent.mkdir(exist_ok=True)
        path.write_text(t)
        out[label] = str(path.relative_to(ROOT))
    return out


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
                          r"(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Li(\d+)E)?", line)
            if m:
                kernel = f"{m.group(1)} {m.group(2)}{m.group(3) or ''}" + (
                    f" RL={m.group(4)}" if m.group(4) else "") + (
                    f" n={m.group(5)}" if m.group(5) not in (None, m.group(3))
                    else "")
            elif kernel and ("registers" in line or "spill" in line):
                cs.log(f"  ptxas {label} {kernel}: "
                       f"{line.replace('ptxas info    :', '').strip()}")
    kerns = {}
    for label, path in paths.items():
        kern = functools.partial(batched_inv._gj_inverse_cuda, source=path)
        if not hasattr(cuda_build.load(path), "gj_inverse_tr_f32"):
            kern = functools.partial(_copy_first, kern)
        kerns[label] = kern
    return kerns


def _copy_first(kern, A):
    """A build without the transposed entry points, called as its own
    wrapper called it: on a row-major copy of any other layout."""
    return kern(A.contiguous())


def pivot_swaps(A) -> float:
    """The share of the matrices of A whose partial pivoting swaps a row
    at some step (gj_inverse_plain's pivot search, in A's type)."""
    import torch
    n = A.shape[-1]
    M = A.clone()
    idx = torch.arange(n, device=A.device)
    swapped = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    rows = torch.arange(A.shape[0], device=A.device)
    for k in range(n):
        mag = torch.where(idx >= k, M[:, :, k].abs(), -1.0)
        p = mag.argmax(-1)
        swapped |= p != k
        rk, rp = M[:, k].clone(), M[rows, p].clone()
        M[rows, p] = rk
        M[:, k] = rp / rp[:, k:k + 1]
        f = torch.where(idx == k, 0.0, M[:, :, k])
        M = M - f[:, :, None] * M[:, k][:, None, :]
        M[:, k] = rp / rp[:, k:k + 1]
    return float(swapped.double().mean())


def stage_gap(kerns: dict) -> list:
    """Device ms back to back of each build, in turns (labels, then
    reversed), on the main path's stage Jacobians J as handed over, on
    J's contiguous copy and on row-major variants of the same shape, each
    changing one property of J; every result bit for bit the first
    build's on J's contiguous copy where the input is J."""
    import torch
    from acados_tpu_torch.ops.batched_inv import input_layout
    _, J = cs.stage_jacobians(torch.device("cuda"))
    gen = torch.Generator(device=J.device).manual_seed(cs.SEED)
    n = J.shape[-1]
    eye = torch.eye(n, device=J.device)
    noise = torch.randn(J.shape, generator=gen, device=J.device)
    Jc = J.contiguous()
    perm = torch.argsort(torch.rand(J.shape[:2], generator=gen,
                                    device=J.device), dim=1)
    variants = {
        "J as handed over": J,
        "J contiguous": Jc,
        "N(0, 1) + 16 I": noise + n * eye,
        "J, zeros filled by 1e-3 N(0, 1)": Jc + (Jc == 0) * 1e-3 * noise,
        "N(0, 1) + 16 I with J's zeros": (noise + n * eye) * (Jc != 0),
        "J, rows permuted": torch.take_along_dim(Jc, perm[..., None], 1),
        "1e-2 N(0, 1) + I": 1e-2 * noise + eye,
        "identity": eye.expand(J.shape).contiguous(),
    }
    first = next(iter(kerns.values()))
    ref = first(Jc)
    labels = list(kerns)
    rows, differ = [], []
    cs.log(f"K1 on the main path's stage Jacobians {tuple(J.shape)} float32 "
           f"(strides {J.stride()}) and variants, device ms back to back "
           f"in turns {labels + labels[::-1]}:")
    for name, X in variants.items():
        if X.data_ptr() == J.data_ptr() or name == "J contiguous":
            for label, kern in kerns.items():
                if not cs.same_bits(kern(X), ref) and label not in differ:
                    cs.log(f"  {label} on {name} differs from {labels[0]} "
                           f"on J's contiguous copy")
                    differ.append(label)
        times = {label: [] for label in labels}
        for label in labels + labels[::-1]:
            times[label].append(cs.device_ms(lambda: kerns[label](X)))
        nz = X[X != 0].abs()
        row = dict(variant=name, layout=input_layout(X),
                   zeros=float((X == 0).double().mean()),
                   min_abs_nonzero=float(nz.min()),
                   swaps=pivot_swaps(X),
                   **{k: float(np.median(v)) for k, v in times.items()})
        rows.append(row)
        cs.log(f"  {name:<34} {row['layout']:<10} zeros {row['zeros']:.3f}"
               f" min|nonzero| {row['min_abs_nonzero']:.2e} pivot swaps in "
               f"{row['swaps']:.3f}: " + "  ".join(
                   f"{k} {' '.join(f'{t:.4f}' for t in v)}"
                   for k, v in times.items()))
    return rows, differ


def dae_gap(kerns: dict) -> list:
    """Device ms back to back of each build, in turns (labels, then
    reversed), on the DAE cart's stage systems as its IRK hands them over
    to K1 (the first launch of one SQP iteration at chip_smoke's width,
    (81,920, 9, 9) float32, transposed) and on their contiguous copy;
    each build's result bit for bit the first build's. Returns the rows
    and the labels of the builds that differ."""
    import torch
    from acados_tpu_torch.ops.batched_inv import input_layout
    solver = cs.dae_batch(cs.B_MAIN, "float32", torch.device("cuda"),
                          max_iter=1)
    with cs.K1Shapes() as k1:
        solver.solve()
    D = k1.first
    labels = list(kerns)
    ref = kerns[labels[0]](D)
    differ = [label for label in labels[1:]
              if not cs.same_bits(kerns[label](D), ref)]
    cs.log(f"K1 on the DAE cart's stage systems {tuple(D.shape)} "
           f"{D.dtype} (strides {D.stride()}), device ms back to back in "
           f"turns {labels + labels[::-1]}; bit for bit {labels[0]}'s: "
           + ", ".join(f"{label} {label not in differ}"
                       for label in labels[1:]))
    rows = []
    for name, X in (("as handed over", D), ("contiguous copy",
                                             D.contiguous())):
        times = {label: [] for label in labels}
        for label in labels + labels[::-1]:
            times[label].append(cs.device_ms(lambda: kerns[label](X)))
        rows.append(dict(variant=name, layout=input_layout(X),
                         **{k: float(np.median(v)) for k, v in
                            times.items()}))
        cs.log(f"  {name:<16} {input_layout(X):<10} " + "  ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in v)}"
            for k, v in times.items()))
    return rows, differ


_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def step_mix(sass: str) -> list:
    """Per band of the warp branch and per instance of the group branch:
    its SASS instructions, and those of one elimination step and their
    mix. The warp branch's step is averaged over its loop's body (one
    REDUX.MIN a step); the group branch has no loop (its k loop unrolls
    fully), so its step is its main body over its band: the instructions
    up to its first unpredicated EXIT, staging included, the division's
    slow path (a subroutine after it) left out; a padded instance (its
    order n below the band, labelled n=...) runs n steps."""
    rows = []
    for func in re.split(r"\n\s*Function : ", sass):
        head = func.split("\n", 1)[0]
        warp = re.search(r"gj_inv_warpI([fd])Li(\d+)E", head)
        group = re.search(
            r"gj_inv_groupI([fd])Li(\d+)ELi(\d+)E(?:Li(\d+)E)?", head)
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
            nv = group.group(4) or group.group(2)
            body, k = ops[:end], int(nv)
            band = (f"{group.group(1)}{group.group(2)} RL={group.group(3)}"
                    + (f" n={nv}" if nv != group.group(2) else ""))
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
            fchk=per("FCHK"), mufu=per("MUFU"),
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


def group_bit_equality(kerns: dict, ns=cs.K1_GROUP_N) -> list:
    """Each later build against the first on the group branch's batches
    (n in ns, default chip_smoke's K1_GROUP_N; --pad adds every n =
    3..15, where the parent's build ran the warp branch; float32 and
    float64): N(0, 1) + n I at each B of the grid, the same with rows
    permuted and transposed, the pivot-tie batch, and the long diagonally
    dominant batch with rows permuted. Logs max |build - first| and the
    matrices that differ; returns the labels of the builds that differ
    anywhere (expected none: the same operations in the same order)."""
    import torch
    from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
    dev = torch.device("cuda")
    ref, *rest = kerns
    differ = []
    if not rest:
        return differ
    cs.log(f"group branch, each build against {ref!r} bit for bit:")
    for n in ns:
        rng = np.random.default_rng(cs.SEED + n)
        batches = [(f"random B={B}", rng.normal(size=(B, n, n))
                    + n * np.eye(n)) for B in cs.K1_GROUP_GRID_B]
        batches.append(("rows permuted B=10240",
                        row_permuted_batch(rng, 10240, n)))
        batches.append(("rows permuted B=10240 /tr",
                        row_permuted_batch(rng, 10240, n)))
        batches.append(("ties", pivot_tie_batch(rng, 4096, n)[0]))
        A = rng.uniform(-1.0, 1.0, (cs.K1_LONG_B, n, n)) + 2 * n * np.eye(n)
        batches.append((f"long dominant B={cs.K1_LONG_B}", np.take_along_axis(
            A, np.argsort(rng.random((cs.K1_LONG_B, n)))[..., None], 1)))
        for name, A0 in batches:
            for dtype in (torch.float32, torch.float64):
                A = torch.as_tensor(A0, dtype=dtype, device=dev)
                if name.endswith("/tr"):
                    A = cs.transposed_view(A)
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
    specs = dict(a.split("=", 1) for a in sys.argv[1:]
                 if "=" in a and not a.startswith("--"))
    specs = specs or {"now": SOURCE}
    picked = [a.split("=", 1)[1].split(",") if "=" in a else None
              for a in sys.argv[1:] if a.split("=")[0] == "--variants"]
    if picked:
        specs.update(variants(specs.get("now", SOURCE), picked[0]))
    pad = "--pad" in sys.argv
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    full_precision_matmul()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kerns = build(specs)
    cs.log(f"build: {sorted(specs)} in {time.perf_counter() - t0:.1f} s")
    if "--sass" in sys.argv:
        tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
        for label in kerns:
            lib = cuda_build.target(str((ROOT / specs[label]).resolve()))
            sass = subprocess.run([str(tool), "-sass", str(lib)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for row in step_mix(sass):
                cs.log(f"  sass {label} {row['band']}: {row['instructions']}"
                       f" instructions, {row['per_step']:.0f} a step: "
                       f"{row['fma']:.0f} FMA, {row['mul_add']:.0f} "
                       f"mul/add, {row['select']:.0f} select, "
                       f"{row['shared']:.1f} shared, {row['reduce']:.0f} "
                       f"redux, {row['shuffle']:.1f} shuffle, "
                       f"{row['integer']:.0f} integer/move, "
                       f"{row['branch']:.1f} branch, {row['fchk']:.1f} "
                       f"FCHK, {row['mufu']:.1f} MUFU")
    failed = []
    for label, kern in kerns.items():
        cs.log(f"K1 build {label!r} against the plain version:")
        path = str((ROOT / specs[label]).resolve())
        if hasattr(cuda_build.load(path), "gj_inverse_route"):
            try:
                cs.k1_routes(path)
            except SystemExit as e:
                cs.log(f"  build {label!r} FAILED: {e}")
                failed.append(label)
        rng = np.random.default_rng(cs.SEED)
        try:
            cs.k1_batches(dev, rng, kern)
            cs.k1_edge_cases(dev, rng, kern)
        except SystemExit as e:
            cs.log(f"  build {label!r} FAILED: {e}")
            failed.append(label)
    ill_conditioned_n3(kerns)
    ns = tuple(range(2, 17)) if pad else cs.K1_GROUP_N
    failed += [label for label in group_bit_equality(kerns, ns)
               if label not in failed]
    labels = list(kerns)
    stage = dae = None
    if "--stage" in sys.argv:
        stage, differ = stage_gap(kerns)
        failed += [label for label in differ if label not in failed]
    if pad:
        dae, differ = dae_gap(kerns)
        failed += [label for label in differ if label not in failed]
    cells = cs.K1_WARP_CELLS + cs.K1_GROUP_CELLS
    if pad:
        cells = cs.K1_PAD_CELLS + cells
    rows = cs.k1_grid(kerns, order=labels + labels[::-1], transposed=True,
                      cells=cells)
    cs.log(json.dumps({"k1_grid": rows, "stage": stage, "dae": dae,
                       "card": cs.card_line(), "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
