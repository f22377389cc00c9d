"""Full condensing: OCP-QP -> dense QP in w = (x0, u_0, ..., u_{N-1}),
batch-first.

Counterpart of `acados_tpu/ocp_qp/full_condensing.py`: every state but x0
is eliminated by forward substitution, x_i = Gam_i x0 + Phi_i u + gam_i,
giving one dense QP of nv = nx + N*nu variables and ng = (N+1)*nc rows.
x0 stays a variable: the initial state enters as equality rows
(lg == ug), which the dense QP carries as they are, and the dense IPM
holds them with its barrier.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.dense_qp.data import DenseQp, DenseQpSol
from acados_tpu_torch.ocp_qp.condensing import _condense_block
from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.riccati import _T, _mTv, _mv
from acados_tpu_torch.utils.struct import tensor_dataclass


@tensor_dataclass
class FullCondCache:
    """State-elimination operators for the expansion (i = 0..N, the
    terminal stage included)."""

    Gams: torch.Tensor  # (B, N+1, nx, nx)
    Phis: torch.Tensor  # (B, N+1, nx, N*nu)
    gams: torch.Tensor  # (B, N+1, nx)


def full_condense(qp: OcpQp):
    """Condense a batch of OcpQps into DenseQps. Returns (dense, cache)."""
    d = qp.dims
    N, nx, nu, nc = d.N, d.nx, d.nu, d.nc
    Bsz = qp.q.shape[0]

    (Q_b, R_b, S_b, q_b, r_b, A_N, B_N, b_N, C_b, D_b, lg_b, ug_b,
     (Gams, Phis, gams)) = _condense_block(
        qp.A, qp.B, qp.b, qp.Q[:, :N], qp.R, qp.S, qp.q[:, :N], qp.r,
        qp.C[:, :N], qp.D, qp.lg[:, :N], qp.ug[:, :N])

    # terminal stage: x_N = A_N x0 + B_N u + b_N
    QN, qN = qp.Q[:, N], qp.q[:, N]
    Qg = _mv(QN, b_N) + qN
    Hxx = Q_b + _T(A_N) @ QN @ A_N
    Hux = S_b + _T(B_N) @ QN @ A_N
    Huu = R_b + _T(B_N) @ QN @ B_N
    hx = q_b + _mTv(A_N, Qg)
    hu = r_b + _mTv(B_N, Qg)

    nv = nx + N * nu
    H = torch.zeros((Bsz, nv, nv), dtype=qp.q.dtype, device=qp.q.device)
    H[:, :nx, :nx] = Hxx
    H[:, nx:, :nx] = Hux
    H[:, :nx, nx:] = _T(Hux)
    H[:, nx:, nx:] = Huu
    h = torch.cat([hx, hu], dim=1)

    # rows: path stages, then the terminal stage
    CN = qp.C[:, N]
    G = torch.cat([torch.cat([C_b, D_b], dim=2),
                   torch.cat([CN @ A_N, CN @ B_N], dim=2)], dim=1)
    CNb = _mv(CN, b_N)
    lg = torch.cat([lg_b, qp.lg[:, N] - CNb], dim=1)
    ug = torch.cat([ug_b, qp.ug[:, N] - CNb], dim=1)

    flat = lambda v: v.reshape(Bsz, (N + 1) * nc)
    dense = DenseQp(H=H, h=h, G=G, lg=lg, ug=ug,
                    mask_l=flat(qp.mask_l), mask_u=flat(qp.mask_u),
                    Zl=flat(qp.Zl), Zu=flat(qp.Zu),
                    zl=flat(qp.zl), zu=flat(qp.zu),
                    soft_mask=flat(qp.soft_mask))
    cache = FullCondCache(Gams=torch.cat([Gams, A_N[:, None]], dim=1),
                          Phis=torch.cat([Phis, B_N[:, None]], dim=1),
                          gams=torch.cat([gams, b_N[:, None]], dim=1))
    return dense, cache


def full_expand(qp: OcpQp, cache: FullCondCache,
                sol_d: DenseQpSol) -> OcpQpSol:
    """Expand a batch of dense solutions to full-horizon OcpQpSols.

    pi comes from stationarity at the eliminated states, backwards from
    the terminal one: pi_{N-1} = Q_N x_N + q_N - C_N' lam_N, then
    pi_{i-1} = Q_i x_i + q_i + S_i' u_i - C_i' lam_i + A_i' pi_i.
    """
    d = qp.dims
    N, nx, nu, nc = d.N, d.nx, d.nu, d.nc
    Bsz = qp.q.shape[0]
    x0 = sol_d.w[:, :nx]
    u = sol_d.w[:, nx:].reshape(Bsz, N, nu)

    x = (torch.einsum("ziab,zb->zia", cache.Gams, x0)
         + torch.einsum("ziau,zu->zia", cache.Phis, sol_d.w[:, nx:])
         + cache.gams)

    rows = lambda v: v.reshape(Bsz, N + 1, nc)
    lam_l, lam_u = rows(sol_d.lam_lg), rows(sol_d.lam_ug)
    lam_d = qp.mask_l * lam_l - qp.mask_u * lam_u

    pi_next = (_mv(qp.Q[:, N], x[:, N]) + qp.q[:, N]
               - _mTv(qp.C[:, N], lam_d[:, N]))
    pis = [None] * N
    pis[N - 1] = pi_next
    for i in reversed(range(1, N)):
        pi_next = (_mv(qp.Q[:, i], x[:, i]) + qp.q[:, i]
                   + _mTv(qp.S[:, i], u[:, i]) - _mTv(qp.C[:, i], lam_d[:, i])
                   + _mTv(qp.A[:, i], pi_next))
        pis[i - 1] = pi_next

    return OcpQpSol(x=x, u=u, pi=torch.stack(pis, 1), lam_lg=lam_l,
                    lam_ug=lam_u, t_lg=rows(sol_d.t_lg),
                    t_ug=rows(sol_d.t_ug), sl=rows(sol_d.sl),
                    su=rows(sol_d.su))
