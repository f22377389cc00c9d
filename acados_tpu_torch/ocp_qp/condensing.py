"""Block condensing: eliminate the states inside a block of stages by
forward substitution, batch-first.

Counterpart of `acados_tpu/ocp_qp/condensing.py:54-123`, the two functions
full condensing needs: `_block_prop` (the within-block propagation
operators) and `_condense_block` (the condensed cost, dynamics and
rows). Inside a block of M stages with entry state x_bar and stacked
controls u_bar,

    x_{k0+i} = Gam_i x_bar + Phi_i u_bar + gam_i .

The JAX package's `lax.scan` over the block's stages is a Python loop
over (B, ., .) tensors here. Partial condensing (`partial_condense`,
`partial_expand`, `condense_warm` and the padding helpers) is not ported
yet and raises.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.ocp_qp.riccati import _mv

_PARTIAL = ("partial condensing is not ported yet (ROADMAP.md Queue 1, "
            "item 12: QP front-ends, partial condensing)")


def _block_prop(A, B, b):
    """Within-block state propagation operators.

    A (Bsz, M, nx, nx), B (Bsz, M, nx, nu), b (Bsz, M, nx) ->
      Gams (Bsz, M, nx, nx), Phis (Bsz, M, nx, M*nu), gams (Bsz, M, nx)
      for i = 0..M-1, plus the block-exit triple (Gam_M, Phi_M, gam_M),
      the condensed (A_bar, B_bar, b_bar).
    """
    Bsz, M, nx, nu = B.shape
    Gam = torch.eye(nx, dtype=A.dtype, device=A.device).expand(Bsz, nx, nx)
    Phi = torch.zeros((Bsz, nx, M * nu), dtype=A.dtype, device=A.device)
    gam = torch.zeros((Bsz, nx), dtype=A.dtype, device=A.device)
    Gams, Phis, gams = [], [], []
    for i in range(M):
        Gams.append(Gam)
        Phis.append(Phi)
        gams.append(gam)
        A_i = A[:, i]
        Gam = A_i @ Gam
        Phi = A_i @ Phi                  # a fresh tensor: set in place
        Phi[:, :, i * nu:(i + 1) * nu] = B[:, i]
        gam = _mv(A_i, gam) + b[:, i]
    return (torch.stack(Gams, 1), torch.stack(Phis, 1), torch.stack(gams, 1),
            Gam, Phi, gam)


def _blockdiag(X, M: int, rows: int, cols: int):
    """(Bsz, M, r, c) -> (Bsz, M, r, M, c) with X[:, i] at block (i, i)."""
    out = torch.zeros((X.shape[0], M, rows, M, cols), dtype=X.dtype,
                      device=X.device)
    for i in range(M):
        out[:, i, :, i, :] = X[:, i]
    return out


def _condense_block(A, B, b, Q, R, S, q, r, C, D, lg, ug):
    """Condense one block of M stages (every input holds the block's M
    stages, batch-first). Returns the condensed stage's (Q_bar, R_bar,
    S_bar, q_bar, r_bar, A_bar, B_bar, b_bar, C_bar, D_bar, lg_bar,
    ug_bar, (Gams, Phis, gams))."""
    Bsz, M, nx, nu = B.shape
    nc = C.shape[2]
    Gams, Phis, gams, A_bar, B_bar, b_bar = _block_prop(A, B, b)

    # cost: x_i = Gam_i xb + Phi_i ub + gam_i;  u_i = E_i ub
    Qg = torch.einsum("ziab,zib->zia", Q, gams) + q   # Q_i gam_i + q_i
    Q_bar = torch.einsum("ziax,ziab,ziby->zxy", Gams, Q, Gams)
    q_bar = torch.einsum("ziax,zia->zx", Gams, Qg)

    # R_bar = Phi'QPhi + blkdiag(R) + E'S Phi + (E'S Phi)'
    PQP = torch.einsum("ziau,ziab,zibv->zuv", Phis, Q, Phis)
    Rblk = _blockdiag(R, M, nu, nu).reshape(Bsz, M * nu, M * nu)
    SPhi = torch.einsum("ziux,zixv->ziuv", S, Phis).reshape(Bsz, M * nu,
                                                             M * nu)
    R_bar = PQP + Rblk + SPhi + SPhi.transpose(-1, -2)
    S_bar = (torch.einsum("ziau,ziab,zibx->zux", Phis, Q, Gams)
             + torch.einsum("ziux,zixy->ziuy", S, Gams).reshape(
                 Bsz, M * nu, nx))
    r_bar = (torch.einsum("ziau,zia->zu", Phis, Qg)
             + (torch.einsum("ziux,zix->ziu", S, gams) + r).reshape(
                 Bsz, M * nu))

    # rows: g_i = (C_i Gam_i) xb + (C_i Phi_i + D_i E_i) ub + C_i gam_i
    C_bar = torch.einsum("zica,ziax->zicx", C, Gams).reshape(Bsz, M * nc,
                                                             nx)
    CPhi = torch.einsum("zica,ziau->zicu", C, Phis)     # (Bsz, M, nc, M*nu)
    DE = _blockdiag(D, M, nc, nu).reshape(Bsz, M, nc, M * nu)
    D_bar = (CPhi + DE).reshape(Bsz, M * nc, M * nu)
    Cg = torch.einsum("zica,zia->zic", C, gams)
    lg_bar = (lg - Cg).reshape(Bsz, M * nc)
    ug_bar = (ug - Cg).reshape(Bsz, M * nc)

    return (Q_bar, R_bar, S_bar, q_bar, r_bar, A_bar, B_bar, b_bar,
            C_bar, D_bar, lg_bar, ug_bar, (Gams, Phis, gams))


def _not_ported(*args, **kwargs):
    raise NotImplementedError(_PARTIAL)


# the partial-condensing entry points and padding helpers of the JAX module
partial_condense = partial_expand = condense_warm = _not_ported
pad_qp_to_blocks = pad_warm_to_blocks = unpad_sol = _not_ported
