"""Backward Riccati factorization / solve for equality-constrained LQ
problems, batch-first.

Counterpart of `acados_tpu/ocp_qp/riccati.py`. The sequential stage
recursion (`riccati_factor`, `riccati_solve`) is a Python loop over N on
(B, ., .) tensors; the parallel-in-time variant
(`parallel_riccati_factor`, `parallel_riccati_solve`) replaces each loop
by an associative scan of about 2 log2(N) combine levels. The small
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
from acados_tpu_torch.ops.linsolve import linsolve
from acados_tpu_torch.utils.scan import associative_scan
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


# ---------------------------------------------------------------------------
# Parallel-in-time Riccati (log-depth associative scan)
# ---------------------------------------------------------------------------
#
# acados_tpu/ocp_qp/riccati.py:186-320 (Sarkka & Garcia-Fernandez,
# "Temporal Parallelization of Dynamic Programming and Linear Quadratic
# Control"). Each stage is an element (A_e, C_e, J_e) of the conditional
# value function with u eliminated:
#   A_e = A - B R^-1 S,  C_e = B R^-1 B',  J_e = Q - S' R^-1 S,
# the terminal element (0, 0, Q_N). Composition (earlier i) x (later j):
#   A = A_j (I + C_i J_j)^-1 A_i
#   C = A_j (I + C_i J_j)^-1 C_i A_j' + C_j
#   J = A_i' J_j (I + C_i J_j)^-1 A_i + J_i
# The suffix-combined element at k has J = P_k. The gradient sweep and
# the forward rollout of the solve are affine recursions, scanned as
# compositions of affine maps.


def _compose_affine(inner, outer):
    """Affine-map composition outer o inner: x -> Mo (Mi x + vi) + vo.
    The first argument is the already-combined part of the scan (the
    lower stages of a prefix scan, the higher stages of a reverse one)."""
    Mi, vi = inner
    Mo, vo = outer
    return Mo @ Mi, _mv(Mo, vi) + vo


def parallel_riccati_factor(Qb, Rb, Sb, A, B, reg_eps: float = 0.0,
                            factor_p0: bool = True) -> RiccatiFactor:
    """`riccati_factor` with the cost-to-go Hessians from a reverse
    associative scan over the stages (shapes as there).

    Every non-empty combine solves (I + C_i J_j) X = [A_i | C_i] for all
    pairs of its level and the whole batch at once through `linsolve`:
    on the card one launch of the Gauss-Jordan kernel K1 at
    (B m, nx, nx), m the pairs of the level (13 launches a factor at
    N = 128, 7 at N = 20). The products stay torch.matmul, as the JAX
    package computes them outside any Pallas kernel.
    """
    nx, nu = Qb.shape[-1], Rb.shape[-1]
    dt, dev = Qb.dtype, Qb.device
    eye_u = torch.eye(nu, dtype=dt, device=dev) * reg_eps
    eye_x = torch.eye(nx, dtype=dt, device=dev)

    # per-stage elimination of u, every stage at once
    LR = _chol(Rb + eye_u)
    RiS = _cho_solve(LR, Sb)
    RiBt = _cho_solve(LR, _T(B))
    zero = torch.zeros_like(Qb[:, :1])
    A_el = torch.cat([A - B @ RiS, zero], dim=1)
    C_el = torch.cat([B @ RiBt, zero], dim=1)
    J_el = torch.cat([Qb[:, :-1] - _T(Sb) @ RiS, Qb[:, -1:]], dim=1)

    def combine(ej, ei):
        # the reverse scan passes (later j, earlier i)
        Aj, Cj, Jj = ej
        Ai, Ci, Ji = ei
        M = eye_x + Ci @ Jj
        MiAC = linsolve(M, torch.cat([Ai, Ci], dim=-1))
        MiAi, MiCi = MiAC[..., :nx], MiAC[..., nx:]
        A_n = Aj @ MiAi
        C_n = Aj @ MiCi @ _T(Aj) + Cj
        J_n = _T(Ai) @ Jj @ MiAi + Ji
        J_n = 0.5 * (J_n + _T(J_n))
        return A_n, C_n, J_n

    _, _, P = associative_scan(combine, (A_el, C_el, J_el), reverse=True)

    # per-stage gains from P_{k+1}
    P1 = P[:, 1:]
    Huu = Rb + _T(B) @ (P1 @ B)
    Hux = Sb + _T(B) @ (P1 @ A)
    Luu = _chol(Huu + eye_u)
    K = -_cho_solve(Luu, Hux)
    LP0 = _chol(P[:, 0] + reg_eps * eye_x) if factor_p0 else None
    return RiccatiFactor(P=P, Luu=Luu, K=K, LP0=LP0)


def parallel_riccati_solve(fact: RiccatiFactor, A, B, qb, rb, b, dx0=None):
    """`riccati_solve` with the gradient sweep and the forward rollout as
    associative scans of affine maps (arguments and results as there).
    No linear solve runs inside the scans."""
    N, nx = A.shape[1], qb.shape[-1]
    P1 = fact.P[:, 1:]
    E = A + B @ fact.K  # closed loop

    # backward affine recursion p_k = qhat_k + E_k' p_{k+1}
    Pb = _mv(P1, b)
    qhat = qb[:, :-1] + _mTv(fact.K, rb) + _mTv(E, Pb)
    M_el = torch.cat([_T(E), torch.zeros_like(E[:, :1])], dim=1)
    v_el = torch.cat([qhat, qb[:, -1:]], dim=1)
    _, p = associative_scan(_compose_affine, (M_el, v_el), reverse=True)

    h_u = rb + _mTv(B, Pb + p[:, 1:])
    kff = -_cho_solve(fact.Luu, h_u)
    if dx0 is None:
        if fact.LP0 is None:
            raise ValueError("a solve with a free initial state needs the "
                             "factor of P_0: parallel_riccati_factor(..., "
                             "factor_p0=True)")
        dx0 = -_cho_solve(fact.LP0, p[:, 0])

    # forward affine recursion dx_{k+1} = E_k dx_k + (B kff + b)
    eye = torch.eye(nx, dtype=qb.dtype, device=qb.device)
    M_pre, v_pre = associative_scan(
        _compose_affine,
        (torch.cat([eye.expand(E.shape[0], 1, nx, nx), E], dim=1),
         torch.cat([torch.zeros_like(b[:, :1]), _mv(B, kff) + b], dim=1)))
    dx = _mv(M_pre, dx0[:, None].expand(-1, N + 1, -1)) + v_pre

    du = _mv(fact.K, dx[:, :-1]) + kff
    dpi = _mv(P1, dx[:, 1:]) + p[:, 1:]
    return dx, du, dpi
