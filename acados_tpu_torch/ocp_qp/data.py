"""Batched stage-blocked OCP-QP data model.

Counterpart of `acados_tpu/ocp_qp/data.py`: the same fields and the same
unified two-sided row block (C, D, lg, ug with per-side masks), but every
tensor carries a leading batch axis B. The JAX package vmaps a
single-instance solver; the port's solvers take the batch as given.

    min   sum_k  1/2 x_k'Q_k x_k + 1/2 u_k'R_k u_k + u_k'S_k x_k
                 + q_k'x_k + r_k'u_k
          + sum_soft  zl's_l + 1/2 s_l'Zl s_l + zu's_u + 1/2 s_u'Zu s_u
    s.t.  x_{k+1} = A_k x_k + B_k u_k + b_k              k = 0..N-1
          lg_k <= C_k x_k + D_k u_k <= ug_k
"""
from __future__ import annotations

import dataclasses

import torch

from acados_tpu_torch.utils.struct import tensor_dataclass


@dataclasses.dataclass(frozen=True)
class OcpQpDims:
    """Dimensions of one OCP-QP (per instance)."""

    N: int
    nx: int
    nu: int
    nc: int  # unified two-sided constraint rows per stage


@tensor_dataclass
class OcpQp:
    """A batch of OCP-QPs. Shapes (leading batch axis B):
      Q  (B, N+1, nx, nx)   q  (B, N+1, nx)
      R  (B, N,   nu, nu)   r  (B, N,   nu)      S (B, N, nu, nx)
      A  (B, N,   nx, nx)   B  (B, N,   nx, nu)  b (B, N, nx)
      C  (B, N+1, nc, nx)   D  (B, N,   nc, nu)
      lg, ug, mask_l, mask_u, Zl, Zu, zl, zu, soft_mask (B, N+1, nc)
    mask_l/mask_u in {0, 1} enable the row's lower/upper side; soft_mask
    marks rows softened by slacks.
    """

    Q: torch.Tensor
    R: torch.Tensor
    S: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    D: torch.Tensor
    lg: torch.Tensor
    ug: torch.Tensor
    mask_l: torch.Tensor
    mask_u: torch.Tensor
    Zl: torch.Tensor
    Zu: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    soft_mask: torch.Tensor

    @property
    def dims(self) -> OcpQpDims:
        Np1, nx = self.q.shape[-2], self.q.shape[-1]
        return OcpQpDims(N=Np1 - 1, nx=nx, nu=self.r.shape[-1],
                         nc=self.lg.shape[-1])


def zero_qp(dims: OcpQpDims, batch: int = 1, dtype=torch.float64,
            device=None) -> OcpQp:
    """An all-zero batch of QPs of the given dimensions (masks off)."""
    N, nx, nu, nc = dims.N, dims.nx, dims.nu, dims.nc

    def z(*s):
        return torch.zeros((batch,) + s, dtype=dtype, device=device)

    return OcpQp(
        Q=z(N + 1, nx, nx), R=z(N, nu, nu), S=z(N, nu, nx),
        q=z(N + 1, nx), r=z(N, nu),
        A=z(N, nx, nx), B=z(N, nx, nu), b=z(N, nx),
        C=z(N + 1, nc, nx), D=z(N, nc, nu),
        lg=z(N + 1, nc), ug=z(N + 1, nc),
        mask_l=z(N + 1, nc), mask_u=z(N + 1, nc),
        Zl=z(N + 1, nc), Zu=z(N + 1, nc), zl=z(N + 1, nc), zu=z(N + 1, nc),
        soft_mask=z(N + 1, nc),
    )


@tensor_dataclass
class OcpQpSol:
    """Primal-dual solution of a batch of OCP-QPs (fields as in
    acados_tpu.ocp_qp.data.OcpQpSol, with a leading batch axis)."""

    x: torch.Tensor        # (B, N+1, nx)
    u: torch.Tensor        # (B, N,   nu)
    pi: torch.Tensor       # (B, N,   nx)
    lam_lg: torch.Tensor   # (B, N+1, nc)
    lam_ug: torch.Tensor
    t_lg: torch.Tensor
    t_ug: torch.Tensor
    sl: torch.Tensor
    su: torch.Tensor
