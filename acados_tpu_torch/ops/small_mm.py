"""Batched product of small square matrices: Hopper CUDA kernel + its plain
version.

`small_mm_batched(X, Y)` is the counterpart of `pallas_mm` in
scratch/bench_smallmm39.py (the Pallas kernel `_mm_kernel`, K5): the
batched (B, n, n) @ (B, n, n) product written to find the best form of
the chain model's n = 39 products. On the card it launches the
hand-written kernel of `csrc/small_mm.cu`; on the CPU it runs the plain
version below, the same ascending-k recurrence one multiply and one add
at a time, so the two agree bit for bit. The Pallas `_TB`, a TPU VMEM
block size, has no counterpart.

At the chain's shape (10240, 39, 39) float32 the card must move 186.9 MB
(55.8 us at 3.35 TB/s) and issue 1.215 G separate FP multiplies and adds
(~36 us on 132 SMs x 128 lanes). The kernel gives each thread a 4 x 4
register tile (n padded to a multiple of 8, one template per band) and
stages X transposed, so one 16-byte load of X and one of Y feed 32 FP
instructions. Persistent blocks walk over groups of consecutive pairs,
copied element by element into shared memory with `cp.async`; the
copies of one block overlap with the products of the others on its SM.
The source header has the byte, FP-instruction and shared-load counts.

No solver path calls it, in either package: the chain's products go to
`torch.matmul` as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import ctypes

import torch

from acados_tpu_torch.ops import cuda_build

SMALL_MM_MAX_N = 64

# launches of the CUDA kernel (the wrapper adds one per launch)
LAUNCHES = 0


def small_mm_plain(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X @ Y for (..., n, n) by the recurrence of `_mm_kernel`:
    acc = 0; acc = acc + X[:, k] Y[k, :] for k ascending, one eager
    multiply and one eager add per k."""
    n = X.shape[-1]
    acc = torch.zeros(torch.broadcast_shapes(X.shape, Y.shape),
                      dtype=X.dtype, device=X.device)
    for k in range(n):
        acc = acc + X[..., :, k, None] * Y[..., None, k, :]
    return acc


def _check(X: torch.Tensor, Y: torch.Tensor) -> int:
    """Device, dtype and shape checks; returns n."""
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"small_mm: unsupported device {X.device}")
    if Y.device != X.device:
        raise ValueError(f"small_mm: X on {X.device}, Y on {Y.device}")
    if X.dtype not in (torch.float32, torch.float64) or Y.dtype != X.dtype:
        raise TypeError(f"small_mm takes float32/float64 of one dtype, got "
                        f"{X.dtype} and {Y.dtype}")
    if X.dim() != 3 or X.shape[-1] != X.shape[-2] or Y.shape != X.shape:
        raise ValueError(f"expected (B, n, n) @ (B, n, n), got "
                         f"{tuple(X.shape)} @ {tuple(Y.shape)}")
    n = X.shape[-1]
    if not 1 <= n <= SMALL_MM_MAX_N:
        raise ValueError(f"kernel takes 1 <= n <= {SMALL_MM_MAX_N}, got {n}")
    return n


def _small_mm_cuda(X: torch.Tensor, Y: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous (B, n, n) CUDA tensors."""
    global LAUNCHES
    if X.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{X.device}")
    X, Y = X.contiguous(), Y.contiguous()
    out = torch.empty_like(X)
    if X.shape[0] == 0:
        return out  # nothing to launch, nothing to count
    lib = cuda_build.load("small_mm")
    fn = lib.small_mm_f32 if X.dtype == torch.float32 else lib.small_mm_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(X.data_ptr(), Y.data_ptr(), out.data_ptr(), X.shape[0], n,
                 stream)
    if err != 0:
        raise RuntimeError(f"small_mm kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def small_mm_batched(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Batched X @ Y, X and Y: (B, n, n), n <= 64, float32 or float64
    (K5). A CUDA tensor launches the kernel, a CPU tensor takes
    `small_mm_plain`."""
    n = _check(X, Y)
    if X.device.type == "cpu":
        return small_mm_plain(X, Y)
    return _small_mm_cuda(X, Y, n)
