"""Batched small-matrix inverse: Hopper CUDA kernel + its plain version.

Counterpart of `acados_tpu/ops/batched_inv.py`. The IRK stage system
needs A^-1 for huge batches of small general matrices; on the card that
is the hand-written Gauss-Jordan kernel in `csrc/gj_inverse.cu` (which
replaces the Pallas kernel `_gj_inv_kernel`), on the CPU the plain
PyTorch loop below, which runs the same algorithm.

The kernel has two branches with one schedule: the rows are owned by
lanes and never moved. Each row carries its logical position (a pivot
swap exchanges two positions), and its n slots are updated in place,
slot k receiving the inverse's column of the row that pivoted at step k.
n = 2, 4, 8, 16 run a group of n or n / 2 lanes a matrix (one or two
rows a lane), so a warp holds several matrices; every other n <= 48 runs
one warp a matrix. That computes what `gj_inverse_plain` computes, to the
last bit: it drops only the columns of [A | I] that hold 0 or 1 and the
updates that leave them so (tests/test_torch_ops.py holds a PyTorch model
of that schedule against `gj_inverse_plain` bit for bit). Both branches
differ from the plain version only by fused multiply-adds.

`gj_inverse_any` takes (..., n, n) and flattens every leading axis into
one launch, which is what the JAX package's `custom_vmap` collapse does:
the kernel sees the whole (B*N, n, n) batch at once. Which version runs
depends only on where the tensor lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from acados_tpu_torch.ops import cuda_build

_GJ_MAX_N = 48  # the kernel's limit; above it _schur_inverse recurses

# launches of the CUDA kernel (the wrapper adds one per launch)
LAUNCHES = 0


def gj_inverse_plain(A: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of (..., n, n) by Gauss-Jordan with partial
    pivoting: the plain PyTorch version of the kernel, one step of k at a
    time over the whole batch.

    At step k the pivot is the row i >= k of largest |M[i, k]| (the lowest
    index among equal magnitudes, as torch.argmax and jnp.argmax pick);
    rows k and p are swapped, the pivot row is divided by the pivot and
    column k is eliminated from every other row.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, eye], dim=-1)                      # (..., n, 2n)
    idx = torch.arange(n, device=A.device)
    neg = torch.tensor(-1.0, dtype=A.dtype, device=A.device)
    for k in range(n):
        mag = torch.where(idx >= k, M[..., :, k].abs(), neg)
        p = mag.argmax(dim=-1)                           # (...,)
        row_p = torch.take_along_dim(
            M, p[..., None, None].expand(p.shape + (1, 2 * n)), dim=-2)
        row_k = M[..., k:k + 1, :]
        M = torch.where((idx == k)[:, None], row_p,
                        torch.where((idx[:, None] == p[..., None, None]),
                                    row_k, M))
        norm_row = M[..., k, :] / M[..., k, k:k + 1]
        factors = torch.where(idx == k, 0.0, M[..., :, k])
        M = M - factors[..., :, None] * norm_row[..., None, :]
        M = torch.where((idx == k)[:, None], norm_row[..., None, :], M)
    return M[..., :, n:]


def _gj_inverse_cuda(A: torch.Tensor,
                     source: str = "gj_inverse") -> torch.Tensor:
    """Launch the CUDA kernel on a (B, n, n) CUDA tensor. source: its
    library, `cuda_build`'s name for csrc/gj_inverse.cu or the path of a
    copy of that file (to hold two versions of the kernel side by side)."""
    global LAUNCHES
    if A.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gj_inverse kernel takes float32/float64, got "
                        f"{A.dtype}")
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected (B, n, n), got {tuple(A.shape)}")
    n = A.shape[-1]
    if not 1 <= n <= _GJ_MAX_N:
        raise ValueError(f"kernel takes 1 <= n <= {_GJ_MAX_N}, got {n}")
    A = A.contiguous()
    out = torch.empty_like(A)
    if A.shape[0] == 0:
        return out  # nothing to launch, nothing to count
    lib = cuda_build.load(source)
    fn = lib.gj_inverse_f32 if A.dtype == torch.float32 \
        else lib.gj_inverse_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), out.data_ptr(), A.shape[0], n, stream)
    if err != 0:
        raise RuntimeError(f"gj_inverse kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def _gj_inverse_kernel(A: torch.Tensor) -> torch.Tensor:
    """(B, n, n), n <= 48: the kernel on the card, the plain version on
    the CPU."""
    if A.device.type == "cuda":
        return _gj_inverse_cuda(A)
    if A.device.type == "cpu":
        return gj_inverse_plain(A)
    raise ValueError(f"gj_inverse: unsupported device {A.device}")


def _schur_inverse(A: torch.Tensor) -> torch.Tensor:
    """Blocked 2x2 Schur-complement inverse for n > _GJ_MAX_N.

    A: (B, n, n). Recurses on half-size blocks with the kernel at its
    base; pivoting is within-block only, as in the reference
    (acados_tpu/ops/batched_inv.py:92-121)."""
    B, n, _ = A.shape
    m = -(-n // 2)
    if 2 * m > n:
        # pad to an even split with an identity tail (decouples exactly)
        pad = 2 * m - n
        Ap = torch.zeros((B, 2 * m, 2 * m), dtype=A.dtype, device=A.device)
        Ap[:, :n, :n] = A
        Ap[:, n:, n:] = torch.eye(pad, dtype=A.dtype, device=A.device)
        return _schur_inverse(Ap)[:, :n, :n]
    A11, A12 = A[:, :m, :m], A[:, :m, m:]
    A21, A22 = A[:, m:, :m], A[:, m:, m:]
    X = _inv_impl(A11)
    XA12 = X @ A12
    A21X = A21 @ X
    S = A22 - A21 @ XA12
    Y = _inv_impl(S)
    B21 = -(Y @ A21X)
    B12 = -(XA12 @ Y)
    B11 = X - XA12 @ B21
    top = torch.cat([B11, B12], dim=-1)
    bot = torch.cat([B21, Y], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _inv_impl(A: torch.Tensor) -> torch.Tensor:
    if A.shape[-1] <= _GJ_MAX_N:
        return _gj_inverse_kernel(A)
    return _schur_inverse(A)


class _GjInverse(torch.autograd.Function):
    """A^-1 with the closed-form gradient d(A^-1) = -A^-1 dA A^-1
    (reference batched_inv.py:199-205), so autograd never traces the
    kernel: grad_A = -A^-T grad A^-T, through torch.matmul."""

    @staticmethod
    def forward(A):
        return _inv_impl(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, grad):
        (Ai,) = ctx.saved_tensors
        AiT = Ai.transpose(-1, -2)
        return -(AiT @ grad @ AiT)


def gj_inverse_any(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., n, n), with every leading axis flattened into one
    batch. The entry point the IRK hot path uses."""
    lead = A.shape[:-2]
    flat = A.reshape((-1,) + A.shape[-2:])
    return _GjInverse.apply(flat).reshape(lead + A.shape[-2:])
