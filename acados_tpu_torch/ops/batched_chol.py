"""Batched small-matrix Cholesky factor and solve: Hopper CUDA kernels +
their plain versions.

Counterpart of `acados_tpu/ops/batched_chol.py`. The three Pallas kernels
there become the hand-written CUDA kernels of `csrc/batched_chol.cu`:

    K2  _chol_kernel          -> chol_factor_batched(H) -> L
    K3  _solve_kernel         -> chol_solve_batched(L, b) -> x
    K4  _factor_solve_kernel  -> chol_factor_solve_batched(H, b) -> (x, L)

Beside each is its plain PyTorch version (`chol_factor_plain`,
`chol_solve_plain`, `chol_factor_solve_plain`): the same recurrences in
the same order, one step at a time over the whole batch. Which one runs
depends only on where the tensor lies: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. The Pallas `tile_b`
argument, which sizes TPU VMEM blocks, has no counterpart.

K2, K3 and K4 at n <= 32 (the dense IPM, the Riccati P_0 at nx = 16, the
chain's condensed Huu) run the kernel's row branch: lanes own rows; the
factor and the forward substitution go right-looking, and the back
substitution subtracts each entry's products in ascending k. K2 at
n = 33..64 up to 512 matrices (the chain's free-x0 P_0 at nx = 39, B =
256; condensed Huu of more than 32 controls) runs the block branch, made
for small batches: a thread block a matrix in shared memory,
right-looking, two columns a step and one barrier a step, the general
threads updating the trailing triangle while one thread takes the next
two pivots' sqrt and reciprocal. K3 and K4 at n = 33..64 (no solver
caller), and K2 there above 512 matrices, keep the first port's one-warp
kernel. Each branch subtracts the plain version's products in the plain
version's order, so the kernels equal the plain versions bit for bit
(tests/test_torch_chol.py holds PyTorch models of the row and block
schedules against them); `chol_branch` says which branch an op takes at
a (B, n).

A matrix that is not positive definite (a pivot that is <= 0 or not
finite) comes back NaN in every entry, from kernel and plain version
alike, as `jnp.linalg.cholesky` returns it.

`chol_any` takes (..., n, n), flattens every leading axis and every
vmapped axis into one launch (the JAX package's `custom_vmap` collapse)
and is differentiable in forward and reverse mode.
"""
from __future__ import annotations

import ctypes

import torch

from acados_tpu_torch.ops import cuda_build
from acados_tpu_torch.utils.autodiff import fold_vmap

CHOL_MAX_N = 64  # the kernels' limit, as the JAX package's _CHOL_MAX_N

# launches of each CUDA kernel (its wrapper adds one per launch)
LAUNCHES = {"chol_factor": 0, "chol_solve": 0, "chol_factor_solve": 0}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def chol_factor_plain(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (..., n, n) by the Cholesky-Banachiewicz
    recurrence of `_chol_kernel`, column by column over the whole batch:

        s = H[i, j] - sum_{k < j} L[i, k] L[j, k]   (k ascending)
        L[j, j] = sqrt(s_jj);  L[i, j] = s_ij * (1 / L[j, j])  (i > j)

    Only the lower triangle of H is read; the upper triangle of L is 0.
    A matrix with a pivot s_jj that is <= 0 or not finite is NaN
    throughout."""
    n = H.shape[-1]
    L = torch.zeros_like(H)
    ok = torch.ones(H.shape[:-2], dtype=torch.bool, device=H.device)
    for j in range(n):
        s = H[..., j:, j]
        for k in range(j):
            s = s - L[..., j:, k] * L[..., j, k:k + 1]
        piv = s[..., 0]
        ok = ok & (piv > 0) & torch.isfinite(piv)
        d = torch.sqrt(piv)
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] * (1.0 / d)[..., None]
    return torch.where(ok[..., None, None], L,
                       torch.full_like(L, float("nan")))


def chol_solve_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L' x = b for (..., n, n) lower L and (..., n) b by the
    substitutions of `_solve_kernel`: forward L y = b, then back L' x = y,
    each entry's sum subtracted in ascending k. Only the lower triangle
    of L is read."""
    n = L.shape[-1]
    r = b.clone()
    y = torch.empty_like(b)
    for i in range(n):   # forward: column i updates the rows below it
        y[..., i] = r[..., i] / L[..., i, i]
        r[..., i + 1:] = r[..., i + 1:] - L[..., i + 1:, i] * y[..., i:i + 1]
    x = torch.empty_like(b)
    for i in reversed(range(n)):
        s = y[..., i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[..., k]
        x[..., i] = s / L[..., i, i]
    return x


def chol_factor_solve_plain(H: torch.Tensor, b: torch.Tensor):
    """x = H^-1 b for SPD H, by the factor then the solve above; returns
    (x, L)."""
    L = chol_factor_plain(H)
    return chol_solve_plain(L, b), L


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(M: torch.Tensor, b: torch.Tensor | None = None) -> int:
    """Device, dtype and shape checks shared by the wrappers; returns n."""
    if M.device.type not in ("cpu", "cuda"):
        raise ValueError(f"batched_chol: unsupported device {M.device}")
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched_chol takes float32/float64, got "
                        f"{M.dtype}")
    if M.dim() != 3 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"expected (B, n, n), got {tuple(M.shape)}")
    n = M.shape[-1]
    if not 1 <= n <= CHOL_MAX_N:
        raise ValueError(f"kernel takes 1 <= n <= {CHOL_MAX_N}, got {n}")
    if b is not None:
        if b.shape != M.shape[:-1]:
            raise ValueError(f"b must be {tuple(M.shape[:-1])}, got "
                             f"{tuple(b.shape)}")
        if b.dtype != M.dtype or b.device != M.device:
            raise TypeError("b must have the matrix's dtype and device")
    return n


def _launch(name: str, inputs, outputs, n: int,
            source: str = "batched_chol") -> None:
    """Call the C entry point `name`_f32/_f64 on PyTorch's current stream
    and count the launch. source: the library, `cuda_build`'s name for
    csrc/batched_chol.cu or the path of a copy of that file (to hold two
    versions of the kernels side by side)."""
    lead = inputs[0]
    if lead.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{lead.device}")
    batch = lead.shape[0]
    if batch == 0:
        return  # nothing to launch, nothing to count
    lib = cuda_build.load(source)
    suffix = "_f32" if lead.dtype == torch.float32 else "_f64"
    fn = getattr(lib, name + suffix)
    nptr = len(inputs) + len(outputs)
    fn.argtypes = ([ctypes.c_void_p] * nptr
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(lead.device):
        stream = torch.cuda.current_stream(lead.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (*inputs, *outputs)), batch, n,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, name)


BRANCHES = ("rows", "block", "warp")


def chol_branch(kname: str, batch: int, n: int,
                source: str = "batched_chol") -> str:
    """The branch of csrc/batched_chol.cu that kernel kname (chol_factor,
    chol_solve or chol_factor_solve) takes at (batch, n, n), as its
    dispatcher decides: "rows", "block" or "warp" (the one-warp
    chol_kernel). Asks the built library (the card's machine only)."""
    fn = cuda_build.load(source).chol_branch
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_int
    return BRANCHES[fn(tuple(LAUNCHES).index(kname), batch, n)]


def chol_factor_batched(H: torch.Tensor,
                        source: str = "batched_chol") -> torch.Tensor:
    """Lower Cholesky of a batch of SPD matrices, H: (B, n, n) ->
    (B, n, n), n <= 64 (K2). source: the kernels' library, as for
    `_launch`."""
    n = _check(H)
    if H.device.type == "cpu":
        return chol_factor_plain(H)
    H = H.contiguous()
    L = torch.empty_like(H)
    _launch("chol_factor", (H,), (L,), n, source)
    return L


def chol_solve_batched(L: torch.Tensor, b: torch.Tensor,
                       source: str = "batched_chol") -> torch.Tensor:
    """Solve L L' x = b for a batch; L: (B, n, n) lower, b: (B, n) (K3).
    source: as for `chol_factor_batched`."""
    n = _check(L, b)
    if L.device.type == "cpu":
        return chol_solve_plain(L, b)
    L, b = L.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    _launch("chol_solve", (L, b), (x,), n, source)
    return x


def chol_factor_solve_batched(H: torch.Tensor, b: torch.Tensor,
                              source: str = "batched_chol"):
    """Fused factor + solve, x = H^-1 b for SPD H, in one launch (K4).
    Returns (x, L). source: as for `chol_factor_batched`."""
    n = _check(H, b)
    if H.device.type == "cpu":
        return chol_factor_solve_plain(H, b)
    H, b = H.contiguous(), b.contiguous()
    x, L = torch.empty_like(b), torch.empty_like(H)
    _launch("chol_factor_solve", (H, b), (x, L), n, source)
    return x, L


# ---------------------------------------------------------------------------
# flattening, differentiable entry point (the solvers' hook)
# ---------------------------------------------------------------------------

def _chol_flat(H: torch.Tensor) -> torch.Tensor:
    """(B, n, n): K2 for n <= 64. Above that the JAX package itself takes
    XLA's Cholesky (acados_tpu/ops/batched_chol.py:202-204), so the port
    takes the library's, with the same all-NaN result where a matrix is
    not positive definite."""
    if H.shape[-1] <= CHOL_MAX_N:
        return chol_factor_batched(H)
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


class _CholAny(torch.autograd.Function):
    """L = chol(H) with the closed-form derivatives of the JAX package's
    JVP (acados_tpu/ops/batched_chol.py:233-247):
    - jvp: dL = L phi(L^-1 dH L^-T), phi = lower triangle with the
      diagonal halved;
    - backward: its transpose, with P = phi(L' Lbar) and
      S = L^-T P L^-1, Hbar = (S + S') / 2, the gradient for a symmetric
      H; in torch ops on the saved output, so it is exact to any order;
    - vmap: every vmapped axis folds into one launch.
    The triangular solves are torch.linalg's, as the JAX tangent takes
    jax.scipy's."""

    @staticmethod
    def forward(H):
        return _chol_flat(H)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        P = (L.transpose(-1, -2) @ Lbar).tril()
        P = P - 0.5 * torch.diag_embed(P.diagonal(dim1=-2, dim2=-1))
        Y = torch.linalg.solve_triangular(L.transpose(-1, -2), P,
                                          upper=True)          # L^-T P
        S = torch.linalg.solve_triangular(L, Y, upper=False,
                                          left=False)          # .. L^-1
        return 0.5 * (S + S.transpose(-1, -2))

    @staticmethod
    def jvp(ctx, dH):
        (L,) = ctx.saved_tensors
        Li_dH = torch.linalg.solve_triangular(L, dH, upper=False)
        M = torch.linalg.solve_triangular(
            L, Li_dH.transpose(-1, -2), upper=False).transpose(-1, -2)
        phi = M.tril(-1) + 0.5 * torch.diag_embed(
            M.diagonal(dim1=-2, dim2=-1))
        return L @ phi

    @staticmethod
    def vmap(info, in_dims, H):
        return fold_vmap(_CholAny.apply, info, in_dims, H)


def chol_any(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (..., n, n) SPD, every leading axis flattened
    into one batch (one K2 launch on the card for n <= 64);
    differentiable. The entry point the dense IPM and the Riccati
    factorization (n > 12) use."""
    lead = H.shape[:-2]
    flat = H.reshape((-1,) + H.shape[-2:])
    return _CholAny.apply(flat).reshape(lead + H.shape[-2:])
