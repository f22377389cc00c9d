"""ADMM first-order QP backend (OSQP-class), batch-first.

Counterpart of `acados_tpu/ocp_qp/admm.py`: the splitting keeps the OCP
structure. The w-update is an equality-constrained LQ problem solved by
the sequential Riccati factor/solve with a free initial state, so the
dynamics hold exactly at every iterate; only the inequality rows are
split:

    w+ = argmin 0.5 w'Hw + g'w + rho/2 ||Gw - z + y||^2  s.t. dynamics
    z+ = prox(Gw+ + y)     (a clip for hard rows, the exact prox of the
                            L1 + L2 slack penalty for soft rows)
    y+ = y + Gw+ - z+

with over-relaxation and OSQP's adaptive rho: every
`rho_update_interval` iterations rho is rescaled by sqrt(r_prim / r_dual)
(clipped) and the Riccati factor is redone.

The JAX package runs one `lax.while_loop` per instance and vmaps it. The
port loops in lockstep while any instance is active, with a per-instance
iteration count, residuals, rho scale and status; an instance that has
stopped is frozen by `where(active, new, old)`. Where any active
instance is due for a new rho, the batch is refactored at its new rho
scales and the old factor is kept where no update is due (the vmapped
`lax.cond`).
"""
from __future__ import annotations

import dataclasses

import torch

from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.ipm import (IpmInfo, _bc, _bmax, _ct_vec,
                                         _stage_g)
from acados_tpu_torch.ocp_qp.riccati import riccati_factor, riccati_solve
from acados_tpu_torch.utils.device import wait_any
from acados_tpu_torch.utils.struct import select_fields, where_batch


@dataclasses.dataclass(frozen=True)
class AdmmOpts:
    """ADMM options; names and defaults as
    acados_tpu.ocp_qp.admm.AdmmOpts (OSQP's names where they transfer).
    The JAX package's `matmul_precision` has no counterpart (see
    IpmOpts)."""

    iter_max: int = 1000
    rho: float = 1e-1
    sigma: float = 1e-6        # primal regularization
    alpha_relax: float = 1.6   # over-relaxation
    tol_prim: float = 1e-6
    tol_dual: float = 1e-6
    adaptive_rho: bool = True
    rho_update_interval: int = 50
    rho_min: float = 1e-6
    rho_max: float = 1e6

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def solve_ocp_qp_admm(qp: OcpQp, opts: AdmmOpts = None):
    """Solve a batch of OCP-QPs with structure-exploiting ADMM.

    Returns (OcpQpSol, IpmInfo), both batch-first, the contract of
    solve_ocp_qp, with each instance's true iteration count.
    """
    if opts is None:
        opts = AdmmOpts()
    dt, dev = qp.q.dtype, qp.q.device
    Bsz = qp.q.shape[0]
    nx, nu = qp.Q.shape[-1], qp.R.shape[-1]
    mask = torch.maximum(qp.mask_l, qp.mask_u)      # rows with any bound
    big = torch.tensor(1e20, dtype=dt, device=dev)
    # absolute-row form: row value t = g(w); bounds lo <= t <= hi
    lo = torch.where(qp.mask_l > 0, qp.lg, -big)
    hi = torch.where(qp.mask_u > 0, qp.ug, big)
    # equality rows (lg == ug, the x0 rows) get OSQP's 1e3 boost
    is_eq = ((qp.mask_l > 0) & (qp.mask_u > 0)
             & ((qp.ug - qp.lg).abs() < 1e-12))
    rho = opts.rho * torch.where(is_eq, 1e3, 1.0).to(dt)

    eye_x = torch.eye(nx, dtype=dt, device=dev) * opts.sigma
    eye_u = torch.eye(nu, dtype=dt, device=dev) * opts.sigma
    Ct, Dt = qp.C.transpose(-1, -2), qp.D.transpose(-1, -2)

    def factorize(rho_s):
        W = _bc(rho_s, rho) * rho * mask
        WC = W[..., None] * qp.C
        Qb = qp.Q + eye_x + Ct @ WC
        Rb = qp.R + eye_u + Dt @ (W[:, :-1, :, None] * qp.D)
        Sb = qp.S + Dt @ WC[:, :-1]
        return riccati_factor(Qb, Rb, Sb, qp.A, qp.B, reg_eps=0.0)

    soft = qp.soft_mask * mask

    def z_prox(v, rho_v):
        z_hard = torch.clamp(v, lo, hi)
        z_low = (rho_v * v + qp.zl + qp.Zl * lo) / (rho_v + qp.Zl)
        z_up = (rho_v * v - qp.zu + qp.Zu * hi) / (rho_v + qp.Zu)
        z_soft = torch.where(v < lo - qp.zl / rho_v, z_low,
                             torch.where(v > hi + qp.zu / rho_v, z_up,
                                         z_hard))
        return torch.where(soft > 0, z_soft, z_hard)

    z = torch.clamp(torch.zeros_like(qp.lg), lo, hi) * mask
    y = torch.zeros_like(qp.lg)
    dx, du, dpi = (torch.zeros_like(qp.q), torch.zeros_like(qp.r),
                   torch.zeros_like(qp.b))
    inf = torch.full((Bsz,), float("inf"), dtype=dt, device=dev)
    r_prim, r_dual = inf, inf
    k = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    rho_s = torch.ones(Bsz, dtype=dt, device=dev)
    fct = factorize(rho_s)

    while True:
        done = (r_prim < opts.tol_prim) & (r_dual < opts.tol_dual)
        active = (k < opts.iter_max) & ~done
        if not wait_any(active):
            break
        rho_v = rho * _bc(rho_s, rho)
        cv, dv = _ct_vec(qp, rho_v * mask * (y - z))
        dx_n, du_n, dpi_n = riccati_solve(fct, qp.A, qp.B, qp.q + cv,
                                          qp.r + dv, qp.b)
        t = _stage_g(qp, dx_n, du_n) * mask
        t_rel = opts.alpha_relax * t + (1 - opts.alpha_relax) * z
        z_n = z_prox(t_rel + y, rho_v) * mask
        y_n = (y + t_rel - z_n) * mask
        r_prim_n = _bmax(((t - z_n) * mask).abs())
        r_dual_n = _bmax(rho_v * (z_n - z).abs())
        rho_s_n = rho_s
        if opts.adaptive_rho:
            ratio = torch.sqrt(r_prim_n / torch.clamp(r_dual_n, min=1e-30))
            scale = torch.clamp(ratio, 0.2, 5.0)
            due = (((k + 1) % opts.rho_update_interval == 0)
                   & ((scale > 2.0) | (scale < 0.5)))
            rho_s_n = torch.where(
                due, torch.clamp(rho_s * scale, opts.rho_min / opts.rho,
                                 opts.rho_max / opts.rho), rho_s)
            # scaled dual y = lam / rho: rescale to keep lam continuous
            y_n = where_batch(due, y_n * _bc(rho_s, y_n)
                              / _bc(rho_s_n, y_n), y_n)
            refactor = due & active
            if wait_any(refactor):
                fct = select_fields(refactor, factorize(rho_s_n), fct)

        # lockstep freeze: only active instances take the new values
        z = where_batch(active, z_n, z)
        y = where_batch(active, y_n, y)
        dx = where_batch(active, dx_n, dx)
        du = where_batch(active, du_n, du)
        dpi = where_batch(active, dpi_n, dpi)
        r_prim = torch.where(active, r_prim_n, r_prim)
        r_dual = torch.where(active, r_dual_n, r_dual)
        rho_s = torch.where(active, rho_s_n, rho_s)
        k = torch.where(active, k + 1, k)

    lam = rho * _bc(rho_s, rho) * y  # scaled dual -> row multipliers
    t_val = _stage_g(qp, dx, du)
    sol = OcpQpSol(x=dx, u=du, pi=dpi,
                   lam_lg=torch.clamp(-lam, min=0.0) * qp.mask_l,
                   lam_ug=torch.clamp(lam, min=0.0) * qp.mask_u,
                   t_lg=t_val - qp.lg, t_ug=qp.ug - t_val,
                   sl=torch.clamp(lo - z, min=0.0) * soft,
                   su=torch.clamp(z - hi, min=0.0) * soft)
    converged = (r_prim < opts.tol_prim) & (r_dual < opts.tol_dual)
    info = IpmInfo(num_iter=k, mu=r_prim, res_stat=r_dual,
                   res_eq=torch.zeros_like(r_prim), res_ineq=r_prim,
                   status=torch.where(converged, 0, 2).to(torch.int32))
    return sol, info
