"""Backward Riccati factorization / solve for equality-constrained LQ
problems, batch-first.

Counterpart of `acados_tpu/ocp_qp/riccati.py:56-183`. The stage
recursion is a Python loop over N on (B, ., .) tensors. The small
products use `torch.matmul` and the Cholesky factors
`torch.linalg.cholesky_ex` / `torch.cholesky_solve`; the TPU-only
unroll and VPU dispatch of `ops/small_chol.py` and `ops/smallmm.py` has no
counterpart here; above n = 12, where the TPU launches the Pallas
Cholesky, `_chol` takes `chol_any` (the kernel K2 on the card).

Convention: the dynamics multiplier pi_k is attached to
(A_k x_k + B_k u_k + b_k - x_{k+1}), so pi_k = P_{k+1} dx_{k+1} + p_{k+1}.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.ops.batched_chol import chol_any
from acados_tpu_torch.utils.struct import tensor_dataclass

# largest n the TPU factors with unrolled jnp code (ops/small_chol.py);
# above it the TPU launches the Pallas Cholesky kernel K2
UNROLL_MAX_N = 12


def _chol(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where H is not positive definite, as
    the reference's LAPACK path returns. Above UNROLL_MAX_N it is
    `chol_any` (the kernel K2 on the card), as
    acados_tpu/ocp_qp/riccati.py:41-45 dispatches on the TPU."""
    if H.shape[-1] > UNROLL_MAX_N:
        return chol_any(H)
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L') x = b; b: (..., n) or (..., n, m)."""
    if b.dim() == L.dim() - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def _mv(X, v):
    return (X @ v[..., None])[..., 0]


def _mTv(X, v):
    return (X.transpose(-1, -2) @ v[..., None])[..., 0]


def _T(X):
    return X.transpose(-1, -2)


@tensor_dataclass
class RiccatiFactor:
    """Factorization of the LQ problem's KKT system (batch-first).

    P   (B, N+1, nx, nx)  cost-to-go Hessians
    Luu (B, N,   nu, nu)  lower Cholesky of Huu_k = Rb_k + B_k' P_{k+1} B_k
    K   (B, N,   nu, nx)  feedback gains, du = K dx + kff
    LP0 (B, nx, nx)       lower Cholesky of P_0 (free-initial-state solve);
                          None when the factorization was built for solves
                          with a fixed initial state
    """

    P: torch.Tensor
    Luu: torch.Tensor
    K: torch.Tensor
    LP0: torch.Tensor | None


def riccati_factor(Qb, Rb, Sb, A, B, reg_eps: float = 0.0,
                   factor_p0: bool = True) -> RiccatiFactor:
    """Backward Riccati factorization.

    Qb: (B, N+1, nx, nx); Rb: (B, N, nu, nu); Sb: (B, N, nu, nx);
    A: (B, N, nx, nx); B: (B, N, nx, nu). reg_eps is added to the diagonal
    before each Cholesky.

    factor_p0: factor P_0 for a solve with a free initial state. Solves
    with a fixed x0 never read it (under jit the JAX package drops that
    Cholesky as dead code), so with False LP0 is None and no factor of
    P_0 is computed: above nx = 12 that is one K2 launch saved.
    """
    N = A.shape[1]
    nx, nu = Qb.shape[-1], Rb.shape[-1]
    eye_u = torch.eye(nu, dtype=Rb.dtype, device=Rb.device) * reg_eps
    eye_x = torch.eye(nx, dtype=Qb.dtype, device=Qb.device) * reg_eps
    P = Qb[:, N]
    Ps, Luus, Ks = [None] * (N + 1), [None] * N, [None] * N
    Ps[N] = P
    for k in reversed(range(N)):
        A_k, B_k = A[:, k], B[:, k]
        PA = P @ A_k
        PB = P @ B_k
        Huu = Rb[:, k] + _T(B_k) @ PB
        Hux = Sb[:, k] + _T(B_k) @ PA
        Luu = _chol(Huu + eye_u)
        K = -_cho_solve(Luu, Hux)
        P = Qb[:, k] + _T(A_k) @ PA + _T(Hux) @ K
        P = 0.5 * (P + _T(P))
        Ps[k], Luus[k], Ks[k] = P, Luu, K
    LP0 = _chol(P + eye_x) if factor_p0 else None
    return RiccatiFactor(P=torch.stack(Ps, 1), Luu=torch.stack(Luus, 1),
                         K=torch.stack(Ks, 1), LP0=LP0)


def riccati_backward(fact: RiccatiFactor, A, B, qb, rb, b):
    """Backward value-gradient sweep only: returns (kff (B, N, nu),
    p (B, N+1, nx)), the affine policy du = K dx + kff and the cost-to-go
    gradients."""
    N = A.shape[1]
    p = qb[:, N]
    kffs, ps = [None] * N, [None] * (N + 1)
    ps[N] = p
    for k in reversed(range(N)):
        Pb_p = _mv(fact.P[:, k + 1], b[:, k]) + p
        h_u = rb[:, k] + _mTv(B[:, k], Pb_p)
        kffs[k] = -_cho_solve(fact.Luu[:, k], h_u)
        p = qb[:, k] + _mTv(A[:, k], Pb_p) + _mTv(fact.K[:, k], h_u)
        ps[k] = p
    return torch.stack(kffs, 1), torch.stack(ps, 1)


def riccati_solve(fact: RiccatiFactor, A, B, qb, rb, b, dx0=None):
    """Solve the LQ problem for one right-hand side using a factorization.

    qb: (B, N+1, nx); rb: (B, N, nu); b: (B, N, nx) dynamics residual.
    dx0: optional (B, nx) fixed initial state; if None, x0 is solved as a
    free variable from P_0.

    Returns (dx (B, N+1, nx), du (B, N, nu), dpi (B, N, nx)).
    """
    N = A.shape[1]
    kff, p = riccati_backward(fact, A, B, qb, rb, b)
    if dx0 is None:
        if fact.LP0 is None:
            raise ValueError("a solve with a free initial state needs the "
                             "factor of P_0: riccati_factor(..., "
                             "factor_p0=True)")
        dx0 = -_cho_solve(fact.LP0, p[:, 0])
    dx = dx0
    dxs, dus, dpis = [dx0], [None] * N, [None] * N
    for k in range(N):
        du = _mv(fact.K[:, k], dx) + kff[:, k]
        dx = _mv(A[:, k], dx) + _mv(B[:, k], du) + b[:, k]
        dpis[k] = _mv(fact.P[:, k + 1], dx) + p[:, k + 1]
        dus[k] = du
        dxs.append(dx)
    return torch.stack(dxs, 1), torch.stack(dus, 1), torch.stack(dpis, 1)
