"""Hessian regularization, batch-first.

Counterpart of `acados_tpu/ocp_nlp/regularize.py` (the reference's
regularize->regularize hook, ocp_nlp_sqp.c:602): NO_REGULARIZE, MIRROR
(eigenvalue flip), PROJECT (eigenvalue clip), GLM (Gershgorin shift),
CONVEXIFY (Verschueren's structure-preserving convexification) and
PROJECT_REDUC_HESS (reduced-Hessian projection). The stage blocks
H_k = [[Q_k, S_k'], [S_k, R_k]] of every instance and stage go through
one batched `torch.linalg.eigh`; the two backward sweeps are Python loops
over the stages (the JAX package's reverse `lax.scan`s), each step on the
whole batch, with a batched `torch.linalg.cholesky` solve of Muu. The
JAX package computes these with `jnp.linalg` outside any Pallas kernel,
so they stay library calls here. On the card `torch.linalg.eigh` takes
cuSOLVER's batched small-matrix eigensolver, which refused the 81,920
stage blocks of the main path's batch (CUSOLVER_STATUS_INVALID_VALUE;
NVIDIA H100, torch 2.11, CUDA 12.8; chip_smoke.py phase 27), so the
batch goes through in chunks of EIGH_CHUNK matrices.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.ocp_qp.data import OcpQp

REG_METHODS = ("NO_REGULARIZE", "MIRROR", "PROJECT", "GLM",
               "CONVEXIFY", "PROJECT_REDUC_HESS")
EIGH_CHUNK = 16384


def _sym(H):
    return 0.5 * (H + H.transpose(-1, -2))


def _eigh(H):
    """torch.linalg.eigh of the symmetric part of every trailing (n, n)
    block, EIGH_CHUNK blocks a call."""
    H = _sym(H)
    flat = H.reshape((-1,) + tuple(H.shape[-2:]))
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_CHUNK)]
    w = torch.cat([p[0] for p in parts]).reshape(H.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(H.shape)
    return w, V


def _rebuild(V, w):
    """V diag(w) V' over the trailing axes."""
    return (V * w[..., None, :]) @ V.transpose(-1, -2)


def _eig_fix(H, eps: float, mirror: bool):
    """Eigenvalue fix of the trailing (n, n) blocks: MIRROR takes
    max(|w|, eps) (reg_mirror.c:369), PROJECT max(w, eps)
    (reg_project.c:367)."""
    w, V = _eigh(H)
    w = torch.clamp(w.abs() if mirror else w, min=eps)
    return _rebuild(V, w)


def _glm_shift(H, eps: float):
    """The diagonal shift that lifts each block's Gershgorin lower bound
    on lambda_min to eps, 0 where it is already there (reg_glm.c:321)."""
    H = _sym(H)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    radius = H.abs().sum(dim=-1) - diag.abs()
    bound = (diag - radius).amin(dim=-1)
    return torch.clamp(eps - bound, min=0.0)


def _stage_blocks(Q, R, S):
    """(..., nx+nu, nx+nu) blocks [[Q, S'], [S, R]], w = [x; u]."""
    return torch.cat([torch.cat([Q, S.transpose(-1, -2)], dim=-1),
                      torch.cat([S, R], dim=-1)], dim=-2)


def regularize_qp(qp: OcpQp, method: str, eps: float) -> OcpQp:
    """Regularize the stage Hessian blocks of every instance: the coupled
    block [[Q_k, S_k'], [S_k, R_k]] for k < N and Q_N alone, as the
    reference regularizes RSQrq per stage."""
    if method == "NO_REGULARIZE":
        return qp
    if method not in REG_METHODS:
        raise ValueError(
            f"regularize_method {method!r}; supported {REG_METHODS}")
    if method == "CONVEXIFY":
        return _convexify(qp, eps)
    if method == "PROJECT_REDUC_HESS":
        return _project_reduc_hess(qp, eps)
    nx = qp.Q.shape[-1]
    H = _stage_blocks(qp.Q[:, :-1], qp.R, qp.S)
    Qe = qp.Q[:, -1]
    if method == "GLM":
        eye_w = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        eye_x = torch.eye(nx, dtype=H.dtype, device=H.device)
        H = H + _glm_shift(H, eps)[..., None, None] * eye_w
        Qe = Qe + _glm_shift(Qe, eps)[..., None, None] * eye_x
    else:
        H = _eig_fix(H, eps, mirror=(method == "MIRROR"))
        Qe = _eig_fix(Qe, eps, mirror=(method == "MIRROR"))
    return qp.replace(Q=torch.cat([H[:, :, :nx, :nx], Qe[:, None]], dim=1),
                      R=H[:, :, nx:, nx:], S=H[:, :, nx:, :nx])


def _cost_to_go(P, A_k, B_k):
    """[A B]' P [A B] of every instance, with [A B] (B, nx, nx+nu)."""
    AB = torch.cat([A_k, B_k], dim=-1)
    return AB.transpose(-1, -2) @ P @ AB


def _chol_solve(M, rhs, eps: float):
    """(M + eps I)^-1 rhs through a batched Cholesky factor, as the
    reference's cho_solve of jnp.linalg.cholesky."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    L = torch.linalg.cholesky(M + eps * eye)
    return torch.cholesky_solve(rhs, L)


def _convexify(qp: OcpQp, eps: float) -> OcpQp:
    """Structure-preserving convexification (reference reg_convexify.c:
    936; acados_tpu/ocp_nlp/regularize.py:128-184): a backward sweep that
    clips the full-space cost-to-go block M_k = H_k + [A B]' P [A B] at
    eps, hands M~_k - [A B]' P [A B] to the QP and propagates the Schur
    complement of M~_k. Where the reduced Hessian is convex every M_k is
    PSD and nothing changes."""
    nx = qp.Q.shape[-1]
    N = qp.R.shape[1]

    def clip(Hm):
        return _eig_fix(Hm, eps, mirror=False)

    P = clip(qp.Q[:, -1])
    PN = P
    Ht = [None] * N
    for k in reversed(range(N)):
        W = _cost_to_go(P, qp.A[:, k], qp.B[:, k])
        H = _stage_blocks(qp.Q[:, k], qp.R[:, k], qp.S[:, k])
        Mt = clip(H + W)
        Ht[k] = Mt - W
        Mux = Mt[:, nx:, :nx]
        P = Mt[:, :nx, :nx] - Mux.transpose(-1, -2) @ _chol_solve(
            Mt[:, nx:, nx:], Mux, eps)
        P = _sym(P)
    Ht = torch.stack(Ht, dim=1)
    return qp.replace(
        Q=torch.cat([Ht[:, :, :nx, :nx], PN[:, None]], dim=1),
        R=Ht[:, :, nx:, nx:], S=Ht[:, :, nx:, :nx])


def _project_reduc_hess(qp: OcpQp, eps: float) -> OcpQp:
    """Reduced-Hessian projection (reference reg_project_reduc_hess.c:
    332-520; acados_tpu/ocp_nlp/regularize.py:187-266). Backward over
    k = N-1..1 with M_k = H_k + [A B]' P_{k+1} [A B]: the uu block is
    eigenvalue-lifted (w < eps -> eps) onto R_k; where an instance's
    lift is nonzero, P_k is the true Schur complement of M_k by
    elimination with pivot flooring and Q_k absorbs the gap between the
    true and the regularized Schur complement, elsewhere P_k is the
    regularized one. Stage 0 gets a full-block eigenvalue lift."""
    nx = qp.Q.shape[-1]
    nu = qp.R.shape[-1]
    N = qp.R.shape[1]
    dt, dev = qp.Q.dtype, qp.Q.device
    min_pivot = 1e-12 if dt == torch.float64 else 1e-6
    idx = torch.arange(nx + nu, device=dev)

    def eig_lift(Hm):
        w, V = _eigh(Hm)
        lift = torch.where(w < eps, eps - w, torch.zeros_like(w))
        return _rebuild(V, lift)

    def true_schur(Muu, Mux, Mxx):
        """Schur complement onto the x block by nu elimination steps of
        [[Muu, Mux], [Mux', Mxx]] with the pivot floored (no pivoting)."""
        M = torch.cat([torch.cat([Muu, Mux], dim=-1),
                       torch.cat([Mux.transpose(-1, -2), Mxx], dim=-1)],
                      dim=-2)
        for j in range(nu):
            piv = M[:, j, j]
            floor = torch.full_like(piv, min_pivot)
            floor = torch.where(piv < 0, -floor, floor)
            piv = torch.where(piv.abs() < min_pivot, floor, piv)
            colj = M[:, :, j]
            rowj = M[:, j, :]
            m = (idx > j).to(dt)
            M = M - (m[:, None] * m[None, :]) * (
                colj[:, :, None] * rowj[:, None, :]) / piv[:, None, None]
        return M[:, nu:, nu:]

    P = qp.Q[:, -1]
    R_new, Q_new = [None] * N, [None] * N
    for k in reversed(range(1, N)):
        W = _cost_to_go(P, qp.A[:, k], qp.B[:, k])
        Mxx = qp.Q[:, k] + W[:, :nx, :nx]
        Muu = _sym(qp.R[:, k] + W[:, nx:, nx:])
        Mux = qp.S[:, k] + W[:, nx:, :nx]
        dR = eig_lift(Muu)
        do_reg = (dR.abs().reshape(dR.shape[0], -1).amax(dim=1)
                  > 0.0)[:, None, None]
        schur_reg = Mxx - Mux.transpose(-1, -2) @ _chol_solve(Muu + dR, Mux,
                                                              eps)
        schur_true = true_schur(Muu, Mux, Mxx)
        P = _sym(torch.where(do_reg, schur_true, schur_reg))
        R_new[k] = qp.R[:, k] + dR
        Q_new[k] = qp.Q[:, k] + torch.where(do_reg, schur_true - schur_reg,
                                            torch.zeros_like(Mxx))

    W0 = _cost_to_go(P, qp.A[:, 0], qp.B[:, 0])
    H0 = _stage_blocks(qp.Q[:, 0], qp.R[:, 0], qp.S[:, 0])
    dH0 = eig_lift(H0 + W0)
    Q_new[0] = qp.Q[:, 0] + dH0[:, :nx, :nx]
    R_new[0] = qp.R[:, 0] + dH0[:, nx:, nx:]
    S0 = qp.S[:, 0] + dH0[:, nx:, :nx]
    return qp.replace(
        Q=torch.cat([torch.stack(Q_new, dim=1), qp.Q[:, -1:]], dim=1),
        R=torch.stack(R_new, dim=1),
        S=torch.cat([S0[:, None], qp.S[:, 1:]], dim=1))
