"""QP scaling: objective and constraint-row scaling, batch-first.

Counterpart of `acados_tpu/ocp_qp/qpscaling.py` (reference
ocp_nlp_qpscaling.c), with one objective factor and one set of row
scales per instance:
- objective (OBJECTIVE_GERSHGORIN): a Gershgorin bound on the largest
  absolute eigenvalue of the instance's stage Hessians (slack Z
  included); obj_factor = min(1, ub_max_abs_eig / bound), raised again
  where the scaled gradient's inf-norm would fall below
  lb_norm_inf_grad_obj;
- constraints: each row divided by the inf-norm of its coefficients
  (rows with coefficients at most 1, such as bounds, stay as they are);
  slack penalties follow the row's units (Z / s^2, z / s).

The scaled QP's solution maps back by pi -> pi / obj_factor,
lam_i -> lam_i s_i / obj_factor, sl_i -> sl_i / s_i, t_i -> t_i / s_i.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol


def _inst_max(t):
    """Largest entry of each instance: (B, ...) -> (B,)."""
    return t.reshape(t.shape[0], -1).amax(dim=1)


def scale_qp(qp: OcpQp, ub_max_abs_eig: float = 1e5,
             lb_norm_inf_grad_obj: float = 1e-4,
             scale_constraints: bool = True, unit_rows_0: int = 0):
    """Returns (qp_scaled, (obj_factor (B,), row_scales (B, N+1, nc))).

    unit_rows_0 > 0 keeps the first unit_rows_0 stage-0 row scales at 1:
    the x0-elimination path reads dx0 from lg on those rows (and they
    leave the barrier, so their conditioning does not matter)."""
    dt = qp.q.dtype
    gersh = lambda M: _inst_max(M.abs().sum(dim=-1))
    max_eig = torch.maximum(gersh(qp.Q), gersh(qp.R))
    max_eig = torch.maximum(max_eig, 2.0 * gersh(qp.S))
    max_eig = torch.maximum(max_eig, _inst_max(qp.Zl * qp.soft_mask))
    max_eig = torch.maximum(max_eig, _inst_max(qp.Zu * qp.soft_mask))
    obj_factor = torch.clamp(
        ub_max_abs_eig / torch.clamp(max_eig, min=1e-30), max=1.0)
    grad_norm = torch.maximum(_inst_max(qp.q.abs()), _inst_max(qp.r.abs()))
    # keep the scaled gradient above the floor (reference :522-535)
    lb_factor = lb_norm_inf_grad_obj / torch.clamp(grad_norm, min=1e-30)
    obj_factor = torch.maximum(obj_factor,
                               torch.clamp(lb_factor, max=1.0)).to(dt)

    if scale_constraints:
        coeff = qp.C.abs().amax(dim=-1)
        coeff = torch.cat([torch.maximum(coeff[:, :-1],
                                         qp.D.abs().amax(dim=-1)),
                           coeff[:, -1:]], dim=1)
        s = 1.0 / torch.clamp(coeff, min=1.0)
        s = torch.where((qp.mask_l + qp.mask_u) > 0, s, 1.0).to(dt)
        if unit_rows_0 > 0:
            s[:, 0, :unit_rows_0] = 1.0
    else:
        s = torch.ones_like(qp.lg)

    f2, f1 = obj_factor[:, None, None, None], obj_factor[:, None, None]
    qp_s = qp.replace(
        Q=f2 * qp.Q, R=f2 * qp.R, S=f2 * qp.S, q=f1 * qp.q, r=f1 * qp.r,
        C=s[..., None] * qp.C, D=s[:, :-1, :, None] * qp.D,
        lg=s * qp.lg, ug=s * qp.ug,
        Zl=f1 * qp.Zl / s ** 2, Zu=f1 * qp.Zu / s ** 2,
        zl=f1 * qp.zl / s, zu=f1 * qp.zu / s)
    return qp_s, (obj_factor, s)


def unscale_sol(sol: OcpQpSol, scales) -> OcpQpSol:
    """Map a batch of solutions of scaled QPs back to the QPs' units."""
    obj_factor, s = scales
    f1 = obj_factor[:, None, None]
    return OcpQpSol(
        x=sol.x, u=sol.u, pi=sol.pi / f1,
        lam_lg=sol.lam_lg * s / f1, lam_ug=sol.lam_ug * s / f1,
        t_lg=sol.t_lg / s, t_ug=sol.t_ug / s,
        sl=sol.sl / s, su=sol.su / s)
