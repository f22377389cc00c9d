"""Mehrotra predictor-corrector IPM for dense QPs, batch-first.

Counterpart of `acados_tpu/dense_qp/ipm.py`: the same algorithm as the
OCP-structured IPM (two-sided rows, masks, soft slacks eliminated in
closed form), but the reduced Newton system is one (nv, nv) Cholesky of
H + G' diag(W) G per iteration, which serves the predictor and the
corrector. The factor is `chol_any`: one launch of the Cholesky kernel
K2 for the whole batch on the card.

The JAX package vmaps a per-instance `lax.while_loop`; the port loops in
lockstep over the batch and freezes each instance that has stopped, so
per-instance iteration counts and statuses are those of the vmapped
loop. Like the reference, the loop has no stall exit: it ends on
convergence, a NaN step, mu below its floor, or iter_max.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.dense_qp.data import DenseQp, DenseQpSol
from acados_tpu_torch.ocp_qp.ipm import (IpmInfo, IpmOpts, _apply, _bc,
                                         _bmax, _bsum, _comp_inf,
                                         _max_alpha, _mu_of, _row_weights)
from acados_tpu_torch.ocp_qp.riccati import _mTv, _mv
from acados_tpu_torch.ops.batched_chol import chol_any
from acados_tpu_torch.utils.struct import (select_fields, tensor_dataclass,
                                           where_batch)


@tensor_dataclass
class _It:
    w: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor
    t_l: torch.Tensor
    t_u: torch.Tensor
    sl: torch.Tensor
    su: torch.Tensor
    lam_sl: torch.Tensor
    lam_su: torch.Tensor


def _residuals(qp: DenseQp, it: _It):
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    g = _mv(qp.G, it.w)
    lam_d = ml * it.lam_l - mu_ * it.lam_u
    rw = _mv(qp.H, it.w) + qp.h - _mTv(qp.G, lam_d)
    r_l = ml * (g + sml * it.sl - it.t_l - qp.lg)
    r_u = mu_ * (g - smu * it.su + it.t_u - qp.ug)
    r_sl = sml * (qp.zl + qp.Zl * it.sl - it.lam_l - it.lam_sl)
    r_su = smu * (qp.zu + qp.Zu * it.su - it.lam_u - it.lam_su)
    return (rw, r_l, r_u, r_sl, r_su), _mu_of(qp, it)


def _norms(res):
    """(res_stat, res_ineq) inf-norms per instance."""
    rw, r_l, r_u, r_sl, r_su = res
    inf = lambda a: _bmax(a.abs())
    rs = torch.maximum(inf(rw), torch.maximum(inf(r_sl), inf(r_su)))
    return rs, torch.maximum(inf(r_l), inf(r_u))


def _newton(qp: DenseQp, chol, it: _It, res, weights,
            rhs_cl, rhs_cu, rhs_csl, rhs_csu) -> _It:
    """One reduced Newton solve for given complementarity right-hand
    sides, through the Cholesky factor of the barrier Hessian."""
    rw, r_l, r_u, r_sl, r_su = res
    _, (wl, wu, wsl, wsu, denom_l, denom_u) = weights
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_

    a_l = rhs_cl / it.t_l - wl * r_l
    a_u = rhs_cu / it.t_u + wu * r_u
    c_l = -r_sl + rhs_csl / it.sl
    c_u = -r_su + rhs_csu / it.su
    gamma_l = torch.where(sml > 0, a_l - wl * (a_l + c_l) / denom_l, a_l)
    gamma_u = torch.where(smu > 0, a_u - wu * (a_u + c_u) / denom_u, a_u)
    gamma = ml * gamma_l - mu_ * gamma_u

    rhs = -(rw - _mTv(qp.G, gamma))
    # the reference solves with XLA's triangular solves here, not K3
    dw = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    dg = _mv(qp.G, dw)

    dsl = sml * (a_l + c_l - wl * dg) / denom_l
    dsu = smu * (a_u + c_u + wu * dg) / denom_u
    dt_l = ml * (dg + dsl + r_l)
    dt_u = mu_ * (dsu - dg - r_u)
    dlam_l = ml * (rhs_cl - it.lam_l * dt_l) / it.t_l
    dlam_u = mu_ * (rhs_cu - it.lam_u * dt_u) / it.t_u
    dlam_sl = sml * (rhs_csl - it.lam_sl * dsl) / it.sl
    dlam_su = smu * (rhs_csu - it.lam_su * dsu) / it.su
    return _It(w=dw, lam_l=dlam_l, lam_u=dlam_u, t_l=dt_l, t_u=dt_u,
               sl=dsl, su=dsu, lam_sl=dlam_sl, lam_su=dlam_su)


def _init(qp: DenseQp, opts: IpmOpts, warm: DenseQpSol | None) -> _It:
    """Cold start (acados_tpu/dense_qp/ipm.py:_init); a warm start sets
    only the primal w."""
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    one = torch.ones_like(qp.lg)
    w = torch.zeros_like(qp.h) if warm is None else warm.w
    g = _mv(qp.G, w)
    t0 = torch.tensor(opts.t0_min, dtype=qp.h.dtype, device=qp.h.device)
    t_l = torch.where(ml > 0, torch.maximum(g - qp.lg, t0), one)
    t_u = torch.where(mu_ > 0, torch.maximum(qp.ug - g, t0), one)
    return _It(w=w, lam_l=torch.where(ml > 0, opts.mu0 / t_l, 0.0),
               lam_u=torch.where(mu_ > 0, opts.mu0 / t_u, 0.0),
               t_l=t_l, t_u=t_u, sl=one, su=one,
               lam_sl=torch.where(sml > 0, opts.mu0, one),
               lam_su=torch.where(smu > 0, opts.mu0, one))


def _barrier_hessian(qp: DenseQp, W, reg_eps: float) -> torch.Tensor:
    """Hb = H + G' diag(W) G + reg_eps I, (B, nv, nv)."""
    nv = qp.H.shape[-1]
    eye = torch.eye(nv, dtype=qp.H.dtype, device=qp.H.device)
    return (qp.H + (qp.G.transpose(-1, -2) * W[:, None, :]) @ qp.G
            + reg_eps * eye)


def solve_dense_qp(qp: DenseQp, opts: IpmOpts = None,
                   warm: DenseQpSol | None = None):
    """Solve a batch of dense QPs; every tensor of qp leads with the
    batch. Returns (DenseQpSol, IpmInfo), both batch-first (res_eq is
    0: the dense QP has no equality block)."""
    if opts is None:
        opts = IpmOpts()
    dt, dev = qp.h.dtype, qp.h.device
    Bsz = qp.h.shape[0]
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    mu_floor = max(opts.mu_min, 10 * torch.finfo(dt).eps)

    def err_of(res, it):
        rs, ri = _norms(res)
        return torch.stack([rs / opts.tol_stat, ri / opts.tol_ineq,
                            _comp_inf(qp, it) / opts.tol_comp]).amax(dim=0)

    it = _init(qp, opts, warm)
    res, mu = _residuals(qp, it)
    best_it = it
    best_err = err_of(res, it)
    k = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    status = torch.full((Bsz,), 2, dtype=torch.int32, device=dev)
    done = torch.zeros(Bsz, dtype=torch.bool, device=dev)

    while True:
        active = (k < opts.iter_max) & ~done
        if not bool(active.any()):
            break
        weights = _row_weights(qp, it)
        chol = chol_any(_barrier_hessian(qp, weights[0], opts.reg_eps))
        d_aff = _newton(qp, chol, it, res, weights,
                        -ml * it.lam_l * it.t_l, -mu_ * it.lam_u * it.t_u,
                        -sml * it.lam_sl * it.sl, -smu * it.lam_su * it.su)
        alpha_aff = _max_alpha(qp, it, d_aff, opts.tau)
        mu_aff = _mu_of(qp, _apply(it, d_aff, alpha_aff))
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                            0.0, 1.0)
        cmu = _bc(sigma * mu, ml)
        rhs_cl = ml * (cmu - it.lam_l * it.t_l - d_aff.lam_l * d_aff.t_l)
        rhs_cu = mu_ * (cmu - it.lam_u * it.t_u - d_aff.lam_u * d_aff.t_u)
        rhs_csl = sml * (cmu - it.lam_sl * it.sl - d_aff.lam_sl * d_aff.sl)
        rhs_csu = smu * (cmu - it.lam_su * it.su - d_aff.lam_su * d_aff.su)
        d = _newton(qp, chol, it, res, weights, rhs_cl, rhs_cu, rhs_csl,
                    rhs_csu)
        alpha = _max_alpha(qp, it, d, opts.tau)
        it_new = _apply(it, d, alpha)

        nan = ~torch.isfinite(_bsum(it_new.w))
        it_new = select_fields(nan, it, it_new)
        res_new, mu_new = _residuals(qp, it_new)
        err = err_of(res_new, it_new)
        improved = err < best_err
        converged = err <= 1.0
        status_new = torch.where(nan, 1, torch.where(converged, 0, status)
                                 ).to(torch.int32)
        done_new = converged | nan | (mu_new < mu_floor)

        # lockstep freeze: only active instances take the new values
        it = select_fields(active, it_new, it)
        res = tuple(where_batch(active, n, o) for n, o in zip(res_new, res))
        mu = torch.where(active, mu_new, mu)
        best_it = select_fields(active & improved, it_new, best_it)
        best_err = torch.where(active & improved, err, best_err)
        k = torch.where(active, k + 1, k)
        status = torch.where(active, status_new, status)
        done = torch.where(active, done_new, done)

    status = torch.where(best_err <= 1.0, 0, status).to(torch.int32)
    it = best_it   # the reference returns the best iterate
    res, mu = _residuals(qp, it)
    rs, ri = _norms(res)
    sol = DenseQpSol(w=it.w, lam_lg=it.lam_l * ml, lam_ug=it.lam_u * mu_,
                     t_lg=it.t_l, t_ug=it.t_u, sl=it.sl * sml,
                     su=it.su * smu)
    info = IpmInfo(num_iter=k, mu=mu, res_stat=rs,
                   res_eq=torch.zeros_like(rs), res_ineq=ri, status=status)
    return sol, info
