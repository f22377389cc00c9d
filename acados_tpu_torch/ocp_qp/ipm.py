"""Primal-dual interior-point method for OCP-structured QPs, batch-first.

Counterpart of `acados_tpu/ocp_qp/ipm.py`: the same infeasible-start
Mehrotra predictor-corrector, stage-wise reduced Newton systems (soft
slacks eliminated in closed form) solved by one backward Riccati
factorization and two solves per iteration (one with `abs_form`, HPIPM's
SPEED_ABS), sequential or parallel in time (`parallel_riccati`).

The JAX package runs one `lax.while_loop` per instance and vmaps it. The
port keeps the batch as the leading axis and loops in lockstep: an
iteration runs for the whole batch while any instance is active, and an
instance that has stopped is frozen by `where(active, new, old)`, which is
what a vmapped while_loop does. Iteration counts and statuses are per
instance.

`solve_ocp_qp_sens_frw` and `solve_ocp_qp_sens_adj` give the forward and
adjoint solution sensitivities at a converged solution (HPIPM's seed API).

Sign conventions: multiplier pi_k on (A x_k + B u_k + b_k - x_{k+1});
Lagrangian L = f - lam_lg'(g + sl - lg) - lam_ug'(ug - g + su)
              - lam_sl'sl - lam_su'su.
"""
from __future__ import annotations

import dataclasses

import torch

from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.riccati import (_mTv, _mv,
                                             parallel_riccati_factor,
                                             parallel_riccati_solve,
                                             riccati_factor, riccati_solve)
from acados_tpu_torch.utils.device import wait_any
from acados_tpu_torch.utils.struct import (jvp_fields, map_fields,
                                           select_fields, tensor_dataclass,
                                           vjp_fields, where_batch)


@dataclasses.dataclass(frozen=True)
class IpmOpts:
    """IPM options; names and defaults as acados_tpu.ocp_qp.ipm.IpmOpts
    (see there for the reasoning behind each). The JAX package's
    `matmul_precision` and `riccati_unroll` (the TPU's MXU passes and a
    lax.scan unroll factor) have no counterpart: float32 matmuls stay in
    full float32 through `utils.device.full_precision_matmul`, and the
    stage loops are Python loops."""

    iter_max: int = 30
    mu0: float = 1e2
    tol_stat: float = 1e-8
    tol_eq: float = 1e-8
    tol_ineq: float = 1e-8
    tol_comp: float = 1e-8
    tau: float = 0.995          # fraction-to-boundary
    reg_eps: float = 1e-11      # Cholesky diagonal regularization
    t0_min: float = 1e-1        # minimum initial slack distance (cold)
    warm_t_min: float = 1e-4    # floor for warm-start slacks/multipliers
    mu_min: float = 0.0         # effective floor max(mu_min, 10 eps)
    warm_comp_cap: float = -1.0  # -1: auto cap from the warm point
    stall_max: int = 4          # float32 only (lockstep stall exit)
    stall_alpha: float = 0.5
    # log-depth associative-scan Riccati (riccati.py parallel_*): about
    # 2 log2(N) combine levels a sweep in place of N stage steps
    parallel_riccati: bool = False
    # HPIPM SPEED_ABS: no affine predictor, one Newton solve an iteration
    # toward the fixed centering target sigma_abs * mu
    abs_form: bool = False
    sigma_abs: float = 0.1

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@tensor_dataclass
class IpmInfo:
    """Per-instance diagnostics, each (B,)."""

    num_iter: torch.Tensor
    mu: torch.Tensor
    res_stat: torch.Tensor
    res_eq: torch.Tensor
    res_ineq: torch.Tensor
    status: torch.Tensor  # 0 success, 1 NaN, 2 max_iter


@tensor_dataclass
class _Iterate:
    x: torch.Tensor
    u: torch.Tensor
    pi: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor
    t_l: torch.Tensor
    t_u: torch.Tensor
    sl: torch.Tensor
    su: torch.Tensor
    lam_sl: torch.Tensor
    lam_su: torch.Tensor


def _bmax(a: torch.Tensor) -> torch.Tensor:
    """Per-instance max over all but the leading axis ((B,) result)."""
    if a[0].numel() == 0:
        return torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    return a.reshape(a.shape[0], -1).amax(dim=1)


def _bmin(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).amin(dim=1)


def _bsum(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).sum(dim=1)


def _bc(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-instance (B,) value against `like`."""
    return s.reshape(s.shape + (1,) * (like.dim() - 1))


def _stage_g(qp: OcpQp, x, u):
    """g_k = C_k x_k + D_k u_k for all stages (D contributes for k < N)."""
    g = _mv(qp.C, x)
    return torch.cat([g[:, :-1] + _mv(qp.D, u), g[:, -1:]], dim=1)


def _ct_vec(qp: OcpQp, v):
    """(C'v, D'v) stage-wise: v (B, N+1, nc) -> ((B, N+1, nx), (B, N, nu))."""
    return _mTv(qp.C, v), _mTv(qp.D, v[:, :-1])


def _stat_x(qp: OcpQp, it: _Iterate, cv):
    """Q x + q - C'lam + S'u + A'pi - pi_prev per stage."""
    rx = _mv(qp.Q, it.x) + qp.q - cv
    head = rx[:, :-1] + _mTv(qp.S, it.u) + _mTv(qp.A, it.pi)
    rx = torch.cat([head, rx[:, -1:]], dim=1)
    return torch.cat([rx[:, :1], rx[:, 1:] - it.pi], dim=1)


def _residuals(qp: OcpQp, it: _Iterate, x0_fixed: bool = False):
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    g = _stage_g(qp, it.x, it.u)
    lam_d = ml * it.lam_l - mu_ * it.lam_u
    cv, dv = _ct_vec(qp, lam_d)

    rx = _stat_x(qp, it, cv)
    ru = (_mv(qp.S, it.x[:, :-1]) + _mv(qp.R, it.u) + qp.r
          + _mTv(qp.B, it.pi) - dv)
    r_dyn = _mv(qp.A, it.x[:, :-1]) + _mv(qp.B, it.u) + qp.b - it.x[:, 1:]

    r_l = ml * (g + sml * it.sl - it.t_l - qp.lg)
    r_u = mu_ * (g - smu * it.su + it.t_u - qp.ug)
    r_sl = sml * (qp.zl + qp.Zl * it.sl - it.lam_l - it.lam_sl)
    r_su = smu * (qp.zu + qp.Zu * it.su - it.lam_u - it.lam_su)

    mu = _mu_of(qp, it)
    if x0_fixed:
        # eliminated initial state: stage-0 x-stationarity defines the
        # eliminated x0-row multiplier instead of being a residual
        rx = torch.cat([torch.zeros_like(rx[:, :1]), rx[:, 1:]], dim=1)
    return (rx, ru, r_dyn, r_l, r_u, r_sl, r_su), mu


def _x0_row_multiplier(qp: OcpQp, it: _Iterate):
    """Multiplier of the eliminated stage-0 equality rows: the value that
    makes stage-0 x-stationarity exact."""
    lam_d = qp.mask_l * it.lam_l - qp.mask_u * it.lam_u
    return (_mv(qp.Q[:, 0], it.x[:, 0]) + qp.q[:, 0]
            + _mTv(qp.S[:, 0], it.u[:, 0]) + _mTv(qp.A[:, 0], it.pi[:, 0])
            - _mTv(qp.C[:, 0], lam_d[:, 0]))


def _comp_inf(qp: OcpQp, it: _Iterate):
    """Inf-norm of the complementarity products (the convergence check)."""
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    return torch.stack([
        _bmax(ml * it.lam_l * it.t_l), _bmax(mu_ * it.lam_u * it.t_u),
        _bmax(sml * it.lam_sl * it.sl),
        _bmax(smu * it.lam_su * it.su)]).amax(dim=0)


def _res_norms(res):
    rx, ru, r_dyn, r_l, r_u, r_sl, r_su = res
    inf = lambda a: _bmax(a.abs())
    res_stat = torch.maximum(torch.maximum(inf(rx), inf(ru)),
                             torch.maximum(inf(r_sl), inf(r_su)))
    res_eq = inf(r_dyn)
    res_ineq = torch.maximum(inf(r_l), inf(r_u))
    return res_stat, res_eq, res_ineq


def _row_weights(qp: OcpQp, it: _Iterate):
    """Barrier weights per constraint row (rhs-independent, so one
    factorization serves predictor and corrector)."""
    sml, smu = qp.soft_mask * qp.mask_l, qp.soft_mask * qp.mask_u
    wl = it.lam_l / it.t_l
    wu = it.lam_u / it.t_u
    wsl = it.lam_sl / it.sl
    wsu = it.lam_su / it.su
    denom_l = qp.Zl + wl + wsl
    denom_u = qp.Zu + wu + wsu
    W_l = torch.where(sml > 0, wl * (qp.Zl + wsl) / denom_l, wl)
    W_u = torch.where(smu > 0, wu * (qp.Zu + wsu) / denom_u, wu)
    W = qp.mask_l * W_l + qp.mask_u * W_u
    return W, (wl, wu, wsl, wsu, denom_l, denom_u)


def _barrier_hessian(qp: OcpQp, W):
    """Qb, Rb, Sb = stage Hessian + G' diag(W) G."""
    WC = W[..., None] * qp.C
    Qb = qp.Q + qp.C.transpose(-1, -2) @ WC
    WD = W[:, :-1, :, None] * qp.D
    Rb = qp.R + qp.D.transpose(-1, -2) @ WD
    Sb = qp.S + qp.D.transpose(-1, -2) @ WC[:, :-1]
    return Qb, Rb, Sb


def _newton_step(qp: OcpQp, fact, it: _Iterate, res, weights,
                 rhs_cl, rhs_cu, rhs_csl, rhs_csu, parallel=False,
                 dx0=None):
    """One reduced Newton solve for given complementarity right-hand
    sides."""
    rx, ru, r_dyn, r_l, r_u, r_sl, r_su = res
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

    cg, dg_ = _ct_vec(qp, gamma)
    solve = parallel_riccati_solve if parallel else riccati_solve
    dx, du, dpi = solve(fact, qp.A, qp.B, rx - cg, ru - dg_, r_dyn, dx0=dx0)
    dg = _stage_g(qp, dx, du)

    dsl = sml * (a_l + c_l - wl * dg) / denom_l
    dsu = smu * (a_u + c_u + wu * dg) / denom_u
    dt_l = ml * (dg + dsl + r_l)
    dt_u = mu_ * (dsu - dg - r_u)
    dlam_l = ml * (rhs_cl - it.lam_l * dt_l) / it.t_l
    dlam_u = mu_ * (rhs_cu - it.lam_u * dt_u) / it.t_u
    dlam_sl = sml * (rhs_csl - it.lam_sl * dsl) / it.sl
    dlam_su = smu * (rhs_csu - it.lam_su * dsu) / it.su

    return _Iterate(x=dx, u=du, pi=dpi, lam_l=dlam_l, lam_u=dlam_u,
                    t_l=dt_l, t_u=dt_u, sl=dsl, su=dsu,
                    lam_sl=dlam_sl, lam_su=dlam_su)


def _max_alpha(qp: OcpQp, it: _Iterate, d: _Iterate, tau):
    """Single fraction-to-boundary step length over all positive
    variables, per instance."""
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_

    def ratio(v, dv, mm):
        bad = (dv < 0) & (mm > 0)
        r = torch.where(bad, -v / torch.where(bad, dv, -1.0),
                        torch.full_like(v, float("inf")))
        return _bmin(r)

    cands = torch.stack([
        ratio(it.t_l, d.t_l, ml), ratio(it.t_u, d.t_u, mu_),
        ratio(it.lam_l, d.lam_l, ml), ratio(it.lam_u, d.lam_u, mu_),
        ratio(it.sl, d.sl, sml), ratio(it.su, d.su, smu),
        ratio(it.lam_sl, d.lam_sl, sml), ratio(it.lam_su, d.lam_su, smu),
    ])
    return torch.clamp(tau * cands.amin(dim=0), max=1.0)


def _apply(it: _Iterate, d: _Iterate, alpha) -> _Iterate:
    return map_fields(lambda v, dv: v + _bc(alpha, v) * dv, it, d)


def _mu_of(qp: OcpQp, it: _Iterate):
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    comp = (_bsum(ml * it.lam_l * it.t_l) + _bsum(mu_ * it.lam_u * it.t_u)
            + _bsum(sml * it.lam_sl * it.sl)
            + _bsum(smu * it.lam_su * it.su))
    ncomp = torch.clamp(_bsum(ml) + _bsum(mu_) + _bsum(sml) + _bsum(smu),
                        min=1.0)
    return comp / ncomp


def _init_iterate(qp: OcpQp, opts: IpmOpts, warm: OcpQpSol | None,
                  dx0=None) -> _Iterate:
    dt = qp.q.dtype
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    one = torch.ones_like(qp.lg)
    if warm is None:
        x = torch.zeros_like(qp.q)
        u = torch.zeros_like(qp.r)
        pi = torch.zeros_like(qp.b)
    else:
        x, u, pi = warm.x, warm.u, warm.pi
    if dx0 is not None:
        x = torch.cat([dx0[:, None], x[:, 1:]], dim=1)
    g = _stage_g(qp, x, u)
    t0 = torch.tensor(opts.t0_min, dtype=dt, device=qp.q.device)
    t_l = torch.where(ml > 0, torch.maximum(g - qp.lg, t0), one)
    t_u = torch.where(mu_ > 0, torch.maximum(qp.ug - g, t0), one)
    lam_l_cold = torch.where(ml > 0, opts.mu0 / t_l, 0.0)
    lam_u_cold = torch.where(mu_ > 0, opts.mu0 / t_u, 0.0)
    lam_sl_cold = torch.where(sml > 0, opts.mu0, one)
    lam_su_cold = torch.where(smu > 0, opts.mu0, one)
    if warm is None:
        return _Iterate(x=x, u=u, pi=pi, lam_l=lam_l_cold, lam_u=lam_u_cold,
                        t_l=t_l, t_u=t_u, sl=one, su=one,
                        lam_sl=lam_sl_cold, lam_su=lam_su_cold)
    # dual warm start (reference analog: HPIPM warm_start modes 1/2). Floors
    # use warm_t_min to preserve the warm point's centrality; instances
    # whose warm duals are identically zero fall back to the cold init.
    wt = torch.tensor(opts.warm_t_min, dtype=dt, device=qp.q.device)
    sl_w = torch.where(sml > 0, torch.maximum(warm.sl, wt), one)
    su_w = torch.where(smu > 0, torch.maximum(warm.su, wt), one)
    t_l_w = torch.where(ml > 0, torch.maximum(g + sml * sl_w - qp.lg, wt),
                        one)
    t_u_w = torch.where(mu_ > 0, torch.maximum(qp.ug + smu * su_w - g, wt),
                        one)
    # complementarity-consistent clip of each warm product lam*t at `cap`
    # (see acados_tpu/ocp_qp/ipm.py:367-386 for the reasoning)
    lam_max = torch.maximum(_bmax(ml * warm.lam_lg.abs()),
                            _bmax(mu_ * warm.lam_ug.abs()))
    eps = torch.finfo(dt).eps
    cap_auto = torch.clamp(10.0 * wt * torch.clamp(lam_max, min=1.0),
                           min=100 * eps, max=opts.mu0)
    cap = (torch.full_like(cap_auto, opts.warm_comp_cap)
           if opts.warm_comp_cap > 0 else cap_auto)
    cap = _bc(cap, qp.lg)
    lam_l_w = torch.where(
        ml > 0, torch.minimum(torch.maximum(warm.lam_lg, wt), cap / t_l_w),
        0.0)
    lam_u_w = torch.where(
        mu_ > 0, torch.minimum(torch.maximum(warm.lam_ug, wt), cap / t_u_w),
        0.0)
    lam_sl_w = torch.where(
        sml > 0, torch.maximum(qp.zl + qp.Zl * sl_w - lam_l_w, wt), one)
    lam_su_w = torch.where(
        smu > 0, torch.maximum(qp.zu + qp.Zu * su_w - lam_u_w, wt), one)
    is_warm = (_bmax(ml * warm.lam_lg.abs())
               + _bmax(mu_ * warm.lam_ug.abs())) > 0
    pick = lambda w, c: where_batch(is_warm, w, c)
    return _Iterate(x=x, u=u, pi=pi,
                    lam_l=pick(lam_l_w, lam_l_cold),
                    lam_u=pick(lam_u_w, lam_u_cold),
                    t_l=pick(t_l_w, t_l), t_u=pick(t_u_w, t_u),
                    sl=pick(sl_w, one), su=pick(su_w, one),
                    lam_sl=pick(lam_sl_w, lam_sl_cold),
                    lam_su=pick(lam_su_w, lam_su_cold))


def solve_ocp_qp(qp: OcpQp, opts: IpmOpts = None,
                 warm: OcpQpSol | None = None, x0_fixed: bool = False,
                 x0_rows: tuple = None):
    """Solve a batch of OCP-QPs; every tensor of qp leads with the batch.

    x0_fixed: eliminate the initial state (reference HPIPM
    d_ocp_qp_reduce_eq_dof). Requires nx stage-0 rows that are identity
    state rows with lg == ug; x0_rows gives their positions (default the
    first nx rows). Their multipliers are recovered from stage-0
    stationarity at the solution.

    Returns (OcpQpSol, IpmInfo), both batch-first.
    """
    if opts is None:
        opts = IpmOpts()
    dt = qp.q.dtype
    dev = qp.q.device
    nx = qp.q.shape[-1]
    Bsz = qp.q.shape[0]
    rows = None
    dx0 = dx0_zero = None
    if x0_fixed:
        rows = list(x0_rows if x0_rows is not None else range(nx))
        dx0 = qp.lg[:, 0, rows]
        dx0_zero = torch.zeros_like(dx0)
        ml, mu_ = qp.mask_l.clone(), qp.mask_u.clone()
        ml[:, 0, rows] = 0.0
        mu_[:, 0, rows] = 0.0
        qp = qp.replace(mask_l=ml, mask_u=mu_)
    it = _init_iterate(qp, opts, warm, dx0=dx0)
    mu_floor = max(opts.mu_min, 10 * torch.finfo(dt).eps)
    # stall detection is a float32 lockstep-batch mitigation; float64
    # keeps HPIPM semantics (acados_tpu/ocp_qp/ipm.py:462-465)
    stall_lim = (opts.stall_max if dt == torch.float32
                 else max(opts.stall_max, opts.iter_max))
    ml, mu_2 = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_2

    res, mu = _residuals(qp, it, x0_fixed)
    best_it = it
    best_err = torch.full((Bsz,), float("inf"), dtype=dt, device=dev)
    no_imp = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    k = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    status = torch.full((Bsz,), 2, dtype=torch.int32, device=dev)
    done = torch.zeros(Bsz, dtype=torch.bool, device=dev)

    while True:
        active = (k < opts.iter_max) & ~done
        if not wait_any(active):
            break
        weights = _row_weights(qp, it)
        Qb, Rb, Sb = _barrier_hessian(qp, weights[0])
        factor = (parallel_riccati_factor if opts.parallel_riccati
                  else riccati_factor)
        fact = factor(Qb, Rb, Sb, qp.A, qp.B, reg_eps=opts.reg_eps,
                      factor_p0=dx0_zero is None)
        if opts.abs_form:
            # SPEED_ABS: one centered Newton solve toward sigma_abs*mu
            cmu = _bc(opts.sigma_abs * mu, ml)
            rhs_cl = ml * (cmu - it.lam_l * it.t_l)
            rhs_cu = mu_2 * (cmu - it.lam_u * it.t_u)
            rhs_csl = sml * (cmu - it.lam_sl * it.sl)
            rhs_csu = smu * (cmu - it.lam_su * it.su)
        else:
            # affine (predictor) step: rc = 0 -> rhs = -lam*t
            d_aff = _newton_step(qp, fact, it, res, weights,
                                 -ml * it.lam_l * it.t_l,
                                 -mu_2 * it.lam_u * it.t_u,
                                 -sml * it.lam_sl * it.sl,
                                 -smu * it.lam_su * it.su,
                                 parallel=opts.parallel_riccati,
                                 dx0=dx0_zero)
            alpha_aff = _max_alpha(qp, it, d_aff, opts.tau)
            mu_aff = _mu_of(qp, _apply(it, d_aff, alpha_aff))
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                                0.0, 1.0)
            # corrector: rc = sigma*mu - dlam_aff*dt_aff
            cmu = _bc(sigma * mu, ml)
            rhs_cl = ml * (cmu - it.lam_l * it.t_l
                           - d_aff.lam_l * d_aff.t_l)
            rhs_cu = mu_2 * (cmu - it.lam_u * it.t_u
                             - d_aff.lam_u * d_aff.t_u)
            rhs_csl = sml * (cmu - it.lam_sl * it.sl
                             - d_aff.lam_sl * d_aff.sl)
            rhs_csu = smu * (cmu - it.lam_su * it.su
                             - d_aff.lam_su * d_aff.su)
        d = _newton_step(qp, fact, it, res, weights, rhs_cl, rhs_cu,
                         rhs_csl, rhs_csu, parallel=opts.parallel_riccati,
                         dx0=dx0_zero)
        alpha = _max_alpha(qp, it, d, opts.tau)
        it_new = _apply(it, d, alpha)

        nan = ~torch.isfinite(_bsum(it_new.x) + _bsum(it_new.u)
                              + _bsum(it_new.pi))
        it_new = select_fields(nan, it, it_new)

        res_new, mu_new = _residuals(qp, it_new, x0_fixed)
        rs, re, ri = _res_norms(res_new)
        err = torch.stack([rs / opts.tol_stat, re / opts.tol_eq,
                           ri / opts.tol_ineq,
                           _comp_inf(qp, it_new) / opts.tol_comp]
                          ).amax(dim=0)
        improved = err < best_err
        best_it_new = select_fields(improved, it_new, best_it)
        best_err_new = torch.where(improved, err, best_err)
        no_imp_new = torch.where(
            improved, 0, torch.where(alpha > opts.stall_alpha, no_imp + 1,
                                     no_imp)).to(torch.int32)
        converged = err <= 1.0
        status_new = torch.where(nan, 1, torch.where(converged, 0, status)
                                 ).to(torch.int32)
        done_new = (converged | nan | (mu_new < mu_floor)
                    | (no_imp_new >= stall_lim))

        # lockstep freeze: only active instances take the new values
        it = select_fields(active, it_new, it)
        res = tuple(where_batch(active, n, o) for n, o in zip(res_new, res))
        mu = torch.where(active, mu_new, mu)
        best_it = select_fields(active, best_it_new, best_it)
        best_err = torch.where(active, best_err_new, best_err)
        no_imp = torch.where(active, no_imp_new, no_imp)
        k = torch.where(active, k + 1, k)
        status = torch.where(active, status_new, status)
        done = torch.where(active, done_new, done)

    status = torch.where(best_err <= 1.0, 0, status).to(torch.int32)
    # return the best iterate: for converged instances it is the final one
    it = best_it
    res, mu = _residuals(qp, it, x0_fixed)
    rs, re, ri = _res_norms(res)
    lam_lg = it.lam_l * qp.mask_l
    lam_ug = it.lam_u * qp.mask_u
    t_lg, t_ug = it.t_l, it.t_u
    if x0_fixed:
        lam0 = _x0_row_multiplier(qp, it)
        lam_lg, lam_ug = lam_lg.clone(), lam_ug.clone()
        t_lg, t_ug = t_lg.clone(), t_ug.clone()
        lam_lg[:, 0, rows] = torch.clamp(lam0, min=0.0)
        lam_ug[:, 0, rows] = torch.clamp(-lam0, min=0.0)
        t_lg[:, 0, rows] = 0.0
        t_ug[:, 0, rows] = 0.0
    sol = OcpQpSol(x=it.x, u=it.u, pi=it.pi, lam_lg=lam_lg, lam_ug=lam_ug,
                   t_lg=t_lg, t_ug=t_ug,
                   sl=it.sl * qp.soft_mask * qp.mask_l,
                   su=it.su * qp.soft_mask * qp.mask_u)
    info = IpmInfo(num_iter=k, mu=mu, res_stat=rs, res_eq=re, res_ineq=ri,
                   status=status)
    return sol, info


# ---------------------------------------------------------------------------
# QP-level solution sensitivities (seed API)
# ---------------------------------------------------------------------------

_MASKS = ("mask_l", "mask_u", "soft_mask")


def _iterate_at_solution(qp: OcpQp, sol: OcpQpSol,
                         floor: float = 1e-12) -> _Iterate:
    """Converged solution -> strictly positive iterate without the warm
    start's t0_min centering floor, which would corrupt the barrier
    weights lam/t the implicit differentiation relies on
    (acados_tpu/ocp_qp/ipm.py:606-628)."""
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    f = torch.tensor(floor, dtype=qp.q.dtype, device=qp.q.device)
    lam_l = torch.where(ml > 0, torch.maximum(sol.lam_lg, f), 0.0)
    lam_u = torch.where(mu_ > 0, torch.maximum(sol.lam_ug, f), 0.0)
    t_l = torch.where(ml > 0, torch.maximum(sol.t_lg, f), 1.0)
    t_u = torch.where(mu_ > 0, torch.maximum(sol.t_ug, f), 1.0)
    sl = torch.where(sml > 0, torch.maximum(sol.sl, f), 1.0)
    su = torch.where(smu > 0, torch.maximum(sol.su, f), 1.0)
    lam_sl = torch.where(sml > 0,
                         torch.maximum(qp.zl + qp.Zl * sl - lam_l, f), 1.0)
    lam_su = torch.where(smu > 0,
                         torch.maximum(qp.zu + qp.Zu * su - lam_u, f), 1.0)
    return _Iterate(x=sol.x, u=sol.u, pi=sol.pi, lam_l=lam_l, lam_u=lam_u,
                    t_l=t_l, t_u=t_u, sl=sl, su=su, lam_sl=lam_sl,
                    lam_su=lam_su)


def solve_ocp_qp_sens_frw(qp: OcpQp, sol: OcpQpSol, d_qp: OcpQp,
                          opts: IpmOpts = None):
    """Forward QP solution sensitivity in the data direction d_qp, for
    every instance of the batch (acados_tpu/ocp_qp/ipm.py:631-655, HPIPM's
    d_ocp_qp_ipm_sens_frw): implicit differentiation of the barrier KKT
    system at the converged solution, K d(sol) = -d(res). d_qp is an OcpQp
    tangent; its masks are ignored, and a field that is None carries a
    zero tangent.

    Returns (dx, du, dpi)."""
    if opts is None:
        opts = IpmOpts()
    it = _iterate_at_solution(qp, sol)
    d_qp = d_qp.replace(**dict.fromkeys(_MASKS))
    _, d_res = jvp_fields(lambda q: _residuals(q, it)[0], qp, d_qp)
    weights = _row_weights(qp, it)
    Qb, Rb, Sb = _barrier_hessian(qp, weights[0])
    # the sequential factor whatever opts.parallel_riccati says, as the
    # JAX package does
    fact = riccati_factor(Qb, Rb, Sb, qp.A, qp.B, reg_eps=opts.reg_eps)
    zl = torch.zeros_like(qp.lg)
    d = _newton_step(qp, fact, it, d_res, weights, zl, zl, zl, zl)
    return d.x, d.u, d.pi


def solve_ocp_qp_sens_adj(qp: OcpQp, sol: OcpQpSol, seed_x, seed_u,
                          opts: IpmOpts = None) -> OcpQp:
    """Adjoint QP solution sensitivity: the gradient of <seed, (x, u)>
    with respect to the QP data of every instance, as the exact transpose
    of the forward map (torch.func.vjp of solve_ocp_qp_sens_frw, as
    acados_tpu/ocp_qp/ipm.py:658-674 takes jax.vjp; HPIPM's
    d_ocp_qp_ipm_sens_adj). Returns an OcpQp of gradients, zero in the
    masks."""
    zero = map_fields(torch.zeros_like, qp)
    names = [f.name for f in dataclasses.fields(qp) if f.name not in _MASKS]
    grad = vjp_fields(lambda d: solve_ocp_qp_sens_frw(qp, sol, d, opts),
                      zero, (torch.as_tensor(seed_x, dtype=qp.q.dtype,
                                             device=qp.q.device),
                             torch.as_tensor(seed_u, dtype=qp.q.dtype,
                                             device=qp.q.device),
                             torch.zeros_like(qp.b)), names=names)
    return grad.replace(**{m: torch.zeros_like(getattr(qp, m))
                           for m in _MASKS})
