"""SQP solver: linearize -> residuals -> regularize -> QP -> globalize ->
update, batch-first.

Counterpart of `acados_tpu/ocp_nlp/sqp.py` for SQP and SQP_RTI: the
FIXED_STEP, MERIT_BACKTRACKING (with the Armijo sufficient-descent test
and the second-order correction) and FUNNEL_L1PEN_LINESEARCH
globalizations, Anderson(1) acceleration of the fixed step, adaptive
Levenberg-Marquardt and the ADAPTIVE_CURRENT_RES_JOINT QP tolerances.
Each QP goes through the JAX package's front-end order: QP scaling,
then condensing (none, partial or full), then the Riccati IPM, the
registry's backend named by qp_solver_name or, with full condensing,
the dense IPM.

The JAX package runs one `lax.while_loop` per instance and vmaps it; the
port runs the whole batch in lockstep and freezes each instance that has
stopped with `where(active, new, old)`, so per-instance iteration counts
and statuses are those of the vmapped loop. The line searches' inner
`lax.while_loop`s become inner lockstep loops: each instance keeps its
own alpha and acceptance and stops on its own condition. Every sum and
maximum the reference takes of one instance's arrays reduces here over
all axes but the batch axis (`_bsum`, `_bmax`).

Multiplier update rule follows ocp_nlp_update_variables_sqp
(reference ocp_nlp_common.c:3292): duals blend (1-alpha)*old + alpha*new.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from acados_tpu_torch.ocp_nlp.formulation import NlpData, OcpNlpFormulation
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate, _stack_stages,
                                                build_static_rows,
                                                eval_constraints, eval_cost,
                                                eval_dyn_gap, is_multiphase,
                                                linearize)
from acados_tpu_torch.ocp_nlp.regularize import regularize_qp
from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.ipm import (IpmOpts, _bc, _bmax, _bsum,
                                         solve_ocp_qp)
from acados_tpu_torch.ocp_qp.qpscaling import scale_qp, unscale_sol
from acados_tpu_torch.ocp_qp.registry import get_qp_backend
from acados_tpu_torch.ocp_qp.riccati import _mTv, _mv
from acados_tpu_torch.ocp_qp.xcond import solve_ocp_qp_xcond
from acados_tpu_torch.utils.device import full_precision_matmul, wait_any
from acados_tpu_torch.utils.struct import (map_fields, select_fields,
                                           tensor_dataclass, where_batch)
from acados_tpu_torch.utils.types import ACADOS_INFTY

# stats matrix columns (reference ocp_nlp_sqp.c:579-585)
STAT_COLS = ("res_stat", "res_eq", "res_ineq", "res_comp", "qp_status",
             "qp_iter", "alpha", "step_norm")


@dataclasses.dataclass(frozen=True)
class SqpOpts:
    """SQP options; names and defaults as acados_tpu.ocp_nlp.sqp.SqpOpts."""

    max_iter: int = 50
    tol_stat: float = 1e-6
    tol_eq: float = 1e-6
    tol_ineq: float = 1e-6
    tol_comp: float = 1e-6
    tol_min_step_norm: float = 1e-12
    tol_unbounded: float = -1e10
    levenberg_marquardt: float = 0.0
    # adaptive LM: lm /= lam on a stationarity-residual decrease, *= lam
    # otherwise, floored at mu_min (reference acados_ocp_options.py:136)
    with_adaptive_levenberg_marquardt: bool = False
    adaptive_levenberg_marquardt_lam: float = 5.0
    adaptive_levenberg_marquardt_mu_min: float = 1e-16
    adaptive_levenberg_marquardt_mu0: float = 1e-3
    regularize_method: str = "NO_REGULARIZE"
    reg_epsilon: float = 1e-4
    # FIXED_STEP | MERIT_BACKTRACKING | FUNNEL_L1PEN_LINESEARCH
    globalization: str = "FIXED_STEP"
    alpha_min: float = 0.05
    alpha_reduction: float = 0.7
    full_step_dual: bool = False
    # Armijo test of the merit line search and the second-order
    # correction of a rejected full step (reference
    # globalization_merit_backtracking.c:336-353, ocp_nlp_common.c:4227)
    line_search_use_sufficient_descent: bool = False
    eps_sufficient_descent: float = 1e-4
    globalization_use_SOC: bool = False
    # funnel method parameters (reference globalization_funnel.c:73-96)
    funnel_initialization_increase_factor: float = 15.0
    funnel_initialization_upper_bound: float = 1.0
    funnel_sufficient_decrease_factor: float = 0.9
    funnel_kappa: float = 0.9
    funnel_fraction_switching_condition: float = 1e-3
    funnel_initial_penalty_parameter: float = 1.0
    funnel_penalty_contraction: float = 0.5
    funnel_penalty_eta: float = 1e-6
    rti: bool = False
    cond_N: int | None = None
    cond_block_size: tuple | None = None
    full_cond: bool = False
    # AS-RTI (used by ocp_nlp/rti.py only): STANDARD | A | B | C | D
    as_rti_level: str = "STANDARD"
    as_rti_iter: int = 1
    as_rti_advancement: str = "SIMULATE"  # SHIFT | NONE
    step_length: float = 1.0
    # the time of each phase of every round (linearize, regularize, QP,
    # the rest), measured in the loop: CUDA events on the card, read
    # after the loop's last synchronisation, the host clock on the CPU
    # (reference ocp_nlp_timings, ocp_nlp_common.h:410-428)
    collect_phase_times: bool = False
    # predictive in-loop timeout (reference ocp_nlp_sqp.c:436,611-635):
    # before each round, the elapsed time plus the predicted time of the
    # next one against the budget; one host clock for the whole batch,
    # read where the round's host sync already is (0 = no timeout)
    timeout_max_time: float = 0.0
    timeout_heuristic: str = "ZERO"   # ZERO | LAST | MAX | AVERAGE
    # Anderson(1) on the fixed-step update (reference
    # globalization_fixed_step.c:174-215)
    with_anderson_acceleration: bool = False
    anderson_activation_threshold: float = 1e1
    store_iterates: bool = False
    qpscaling: str = "NO_SCALING"
    warm_start_first_qp_from_nlp: bool = False
    qp_solver_name: str = "RICCATI_IPM"
    # FIXED_QP_TOL | ADAPTIVE_CURRENT_RES_JOINT (reference
    # nlp_qp_tol_strategy, ocp_nlp_common.c:4460)
    nlp_qp_tol_strategy: str = "FIXED_QP_TOL"
    nlp_qp_tol_reduction_factor: float = 1e-1
    nlp_qp_tol_safety_factor: float = 0.1
    eliminate_x0: bool = True
    qp_opts: IpmOpts = None

    def __post_init__(self):
        if self.qp_opts is None:
            object.__setattr__(self, "qp_opts", IpmOpts())

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@tensor_dataclass
class SqpStats:
    """Solve diagnostics, per instance (leading batch axis B)."""

    status: torch.Tensor     # utils.types.AcadosStatus
    sqp_iter: torch.Tensor
    qp_iter_total: torch.Tensor
    res_stat: torch.Tensor
    res_eq: torch.Tensor
    res_ineq: torch.Tensor
    res_comp: torch.Tensor
    stat: torch.Tensor       # (B, max_iter+1, 8) iteration table
    cost: torch.Tensor
    # (B, max_iter+1, N+1, nx) / (B, max_iter+1, N, nu) with
    # store_iterates, else None (reference mem->iterates,
    # ocp_nlp_common.h:452): row 0 the initial iterate, row k+1 the
    # iterate after round k; the rows after an instance stopped stay as
    # they were, as a vmapped while_loop leaves them
    iterates_x: torch.Tensor = None
    iterates_u: torch.Tensor = None
    # (4,) float64 seconds with collect_phase_times, else None: the
    # batch's [linearize, regularize, QP, the rest] summed over rounds
    phase_times: torch.Tensor = None


def _nlp_residuals(qp: OcpQp, it: NlpIterate):
    """NLP KKT residual inf-norms of every instance at the current
    iterate, from the fresh linearization (reference ocp_nlp_res_compute,
    ocp_nlp_common.c:3680)."""
    ml, mu_ = qp.mask_l, qp.mask_u
    sml, smu = qp.soft_mask * ml, qp.soft_mask * mu_
    Zl, Zu, zl, zu = qp.Zl, qp.Zu, qp.zl, qp.zu  # already cost-scaled
    lam_d = ml * it.lam_l - mu_ * it.lam_u

    rx = qp.q - _mTv(qp.C, lam_d)
    rx = torch.cat([rx[:, :-1] + _mTv(qp.A, it.pi), rx[:, -1:]], dim=1)
    rx = torch.cat([rx[:, :1], rx[:, 1:] - it.pi], dim=1)
    ru = qp.r + _mTv(qp.B, it.pi) - _mTv(qp.D, lam_d[:, :-1])

    # slack stationarity with the implicit slack multiplier eliminated:
    # its negative part is the violation
    r_sl = torch.clamp(-(sml * (zl + Zl * it.sl - it.lam_l)), min=0.0)
    r_su = torch.clamp(-(smu * (zu + Zu * it.su - it.lam_u)), min=0.0)

    res_stat = torch.maximum(_bmax(rx.abs()), _bmax(ru.abs()))
    res_stat = torch.maximum(res_stat,
                             torch.maximum(_bmax(r_sl), _bmax(r_su)))
    res_eq = _bmax(qp.b.abs())
    # delta-form bounds: lg = lb - g, ug = ub - g at the current point
    viol_l = ml * torch.clamp(qp.lg - sml * it.sl, min=0.0)
    viol_u = mu_ * torch.clamp(-qp.ug - smu * it.su, min=0.0)
    res_ineq = torch.maximum(_bmax(viol_l), _bmax(viol_u))
    t_l = -qp.lg + sml * it.sl
    t_u = qp.ug + smu * it.su
    res_comp = torch.maximum(_bmax(ml * (it.lam_l * t_l).abs()),
                             _bmax(mu_ * (it.lam_u * t_u).abs()))
    res_comp = torch.maximum(res_comp, _bmax(sml * (it.sl * torch.clamp(
        zl + Zl * it.sl - it.lam_l, min=0.0)).abs()))
    res_comp = torch.maximum(res_comp, _bmax(smu * (it.su * torch.clamp(
        zu + Zu * it.su - it.lam_u, min=0.0)).abs()))
    return res_stat, res_eq, res_ineq, res_comp


def _violations(form, data, soft_mask, x, u, sl, su, lb_all, ub_all):
    """Slack-relaxed bound violations (lower, upper) of every row."""
    g = eval_constraints(form, data, x, u)
    return (torch.clamp(lb_all - g - soft_mask * sl, min=0.0),
            torch.clamp(g - ub_all - soft_mask * su, min=0.0))


def _l1_infeasibility(form, data, soft_mask, x, u, sl, su, lb_all, ub_all):
    """Unweighted l1 infeasibility of every instance: |dynamics gaps|_1 +
    bound violations (reference ocp_nlp_get_l1_infeasibility)."""
    gap = eval_dyn_gap(form, data, x, u)
    viol_l, viol_u = _violations(form, data, soft_mask, x, u, sl, su,
                                 lb_all, ub_all)
    return _bsum(gap.abs()) + _bsum(viol_l + viol_u)


def _merit(form, data, soft_mask, x, u, sl, su, w_pi, w_lam, lb_all,
           ub_all):
    """l1 merit of every instance: objective + multiplier-weighted
    infeasibilities (reference merit_fun in
    globalization_merit_backtracking.c)."""
    cost = eval_cost(form, data, x, u, sl, su, soft_mask)
    gap = eval_dyn_gap(form, data, x, u)
    viol_l, viol_u = _violations(form, data, soft_mask, x, u, sl, su,
                                 lb_all, ub_all)
    return (cost + _bsum(w_pi * gap.abs())
            + _bsum(w_lam * (viol_l + viol_u)))


def _row_step(qp: OcpQp, sol):
    """C_k dx_k + D_k du_k of every stage (D for k < N)."""
    drow = _mv(qp.C, sol.x)
    return torch.cat([drow[:, :-1] + _mv(qp.D, sol.u), drow[:, -1:]], dim=1)


def _dgap_lin(qp: OcpQp, sol):
    """The linearized dynamics gap's change along the step."""
    return _mv(qp.A, sol.x[:, :-1]) + _mv(qp.B, sol.u) - sol.x[:, 1:]


def _merit_gradient(form, qp, sol, it, w_pi, w_lam, lb_all, ub_all,
                    soft_mask, data):
    """Directional derivative of the l1 merit along the QP step of every
    instance (reference ocp_nlp_compute_merit_gradient,
    globalization_merit_backtracking.c:140-280)."""
    g_cost = _bsum(qp.q * sol.x) + _bsum(qp.r * sol.u)
    gap = eval_dyn_gap(form, data, it.x, it.u)
    g_dyn = _bsum(w_pi * torch.sign(gap) * _dgap_lin(qp, sol))
    g = eval_constraints(form, data, it.x, it.u)
    drow = _row_step(qp, sol)
    dsl = sol.sl - it.sl
    dsu = sol.su - it.su
    act_l = (lb_all - g - soft_mask * it.sl) > 0
    act_u = (g - ub_all - soft_mask * it.su) > 0
    zero = torch.zeros_like(drow)
    g_ineq = (_bsum(torch.where(act_l, w_lam * (-drow - soft_mask * dsl),
                                zero))
              + _bsum(torch.where(act_u, w_lam * (drow - soft_mask * dsu),
                                  zero)))
    return g_cost + g_dyn + g_ineq


def _trial(it: NlpIterate, sol, alpha):
    """(x, u, sl, su) of every instance at step length alpha (a float or
    (B,)) along the QP solution sol."""
    a = (lambda v: _bc(alpha, v)) if torch.is_tensor(alpha) \
        else (lambda v: alpha)
    return (it.x + a(sol.x) * sol.x, it.u + a(sol.u) * sol.u,
            it.sl + a(sol.sl) * (sol.sl - it.sl),
            it.su + a(sol.su) * (sol.su - it.su))


def _backtrack(run0, accept, opts: SqpOpts, alpha0: float, like):
    """The line searches' inner `lax.while_loop` in lockstep: each
    instance where run0 starts at alpha0 and, while it has not accepted
    and alpha > alpha_min, takes accept(alpha) -> (ok, extras), keeping
    alpha where ok and shrinking it by alpha_reduction elsewhere. Returns
    each instance's exit alpha, acceptance and the extras of its last
    trial (zeros/False where it never ran)."""
    alpha = torch.full_like(like, alpha0)
    accepted = torch.zeros_like(run0)
    extras = None
    while True:
        run = run0 & ~accepted & (alpha > opts.alpha_min)
        if not wait_any(run):
            break
        ok, ex = accept(alpha)
        if extras is None:
            extras = tuple(torch.zeros_like(e) for e in ex)
        extras = tuple(torch.where(run, e, o) for e, o in zip(ex, extras))
        alpha = torch.where(run, torch.where(ok, alpha,
                                             alpha * opts.alpha_reduction),
                            alpha)
        accepted = torch.where(run, ok, accepted)
    return alpha, accepted, extras


def _funnel_search(form, opts: SqpOpts, data, soft_mask, lb_all, ub_all, qp,
                   it, sol, gstate, active):
    """Funnel l1-penalty line search of every active instance (reference
    globalization_funnel.c: backtracking_line_search +
    is_trial_iterate_acceptable_to_funnel; acados_tpu/ocp_nlp/sqp.py:
    319-403). gstate = (funnel width, penalty parameter, penalty mode),
    each (B,). Returns (alpha, new gstate)."""
    fw, pen, pmode = gstate
    eps_sd = opts.eps_sufficient_descent
    eta = opts.funnel_penalty_eta

    cur_inf = _l1_infeasibility(form, data, soft_mask, it.x, it.u, it.sl,
                                it.su, lb_all, ub_all)
    cur_cost = eval_cost(form, data, it.x, it.u, it.sl, it.su, soft_mask)
    # predicted reductions (ocp_nlp_sqp.c:757-758): the QP removes the
    # whole linearized infeasibility; objective via grad . step
    pred_inf = cur_inf
    pred_obj = -(_bsum(qp.q * sol.x) + _bsum(qp.r * sol.u))
    pred_obj = torch.where((pred_obj < 0) & (pred_obj > -1e-4),
                           torch.zeros_like(pred_obj), pred_obj)
    # penalty parameter update (update_funnel_penalty_parameter)
    shrink = pen * pred_obj + pred_inf < eta * pred_inf
    pen_new = torch.clamp(torch.minimum(
        opts.funnel_penalty_contraction * pen,
        (1.0 - eta) * pred_inf / (-pred_obj + 1e-9)), min=0.0)
    pen = torch.where(shrink, pen_new, pen)
    cur_merit = pen * cur_cost + cur_inf
    pred_merit = pen * pred_obj + pred_inf

    def classify(alpha):
        xt, ut, slt, sut = _trial(it, sol, alpha)
        t_inf = _l1_infeasibility(form, data, soft_mask, xt, ut, slt, sut,
                                  lb_all, ub_all)
        t_cost = eval_cost(form, data, xt, ut, slt, sut, soft_mask)
        inside = t_inf <= fw
        switching = (alpha * pred_obj
                     >= opts.funnel_fraction_switching_condition
                     * pred_inf)
        armijo_obj = (cur_cost - t_cost
                      >= eps_sd * alpha
                      * torch.clamp(pred_obj - 1e-9, min=0.0))
        h_ok = t_inf <= opts.funnel_sufficient_decrease_factor * fw
        t_merit = pen * t_cost + t_inf
        armijo_merit = (cur_merit - t_merit
                        >= eps_sd * alpha
                        * torch.clamp(pred_merit - 1e-9, min=0.0))
        f_type = ~pmode & inside & switching & armijo_obj
        h_type = ~pmode & inside & ~switching & h_ok
        b_type = (~pmode & inside & ~switching & ~h_ok
                  & (t_inf < cur_inf) & armijo_merit)
        p_type = pmode & inside & armijo_merit
        ok = f_type | h_type | b_type | p_type
        ok = ok & torch.isfinite(t_cost) & torch.isfinite(t_inf)
        return ok, (h_type, b_type, p_type, h_ok, t_inf)

    alpha, ok, (h_t, b_t, p_t, h_ok, t_inf) = _backtrack(
        active, classify, opts, 1.0, fw)
    # funnel / mode updates for the accepted step
    do_decrease = ok & (h_t | (p_t & h_ok))
    fw = torch.where(do_decrease,
                     (1.0 - opts.funnel_kappa) * t_inf
                     + opts.funnel_kappa * fw, fw)
    pmode = torch.where(ok & b_t, True,
                        torch.where(ok & p_t & h_ok, False, pmode))
    return alpha, (fw, pen, pmode)


def adaptive_qp_tol(opts: SqpOpts, qp_opts: IpmOpts, rs, re, ri, rc):
    """ADAPTIVE_CURRENT_RES_JOINT QP tolerances of every instance from its
    current NLP residuals (reference ocp_nlp_common.c:4460):
      tmp_tol_* = min(reduction_factor * res_*, 1e-2)
      joint     = max over tmp_tol_*
      tol_*     = max(joint, safety_factor * nlp_tol_*),
    each a (B,) tensor in the returned IpmOpts."""
    red = opts.nlp_qp_tol_reduction_factor
    joint = torch.stack([torch.clamp(red * r, max=1e-2)
                         for r in (rs, re, ri, rc)]).amax(dim=0)
    saf = opts.nlp_qp_tol_safety_factor
    return qp_opts.replace(
        tol_stat=torch.clamp(joint, min=saf * opts.tol_stat),
        tol_eq=torch.clamp(joint, min=saf * opts.tol_eq),
        tol_ineq=torch.clamp(joint, min=saf * opts.tol_ineq),
        tol_comp=torch.clamp(joint, min=saf * opts.tol_comp))


def use_x0_elimination(form: OcpNlpFormulation, opts: SqpOpts) -> bool:
    """Static eligibility for initial-state elimination (the HPIPM
    d_ocp_qp_reduce_eq_dof analog): the stage-0 rows start with a
    full-state identity equality block, none of them softened."""
    nx = form.nx
    return bool(
        opts.eliminate_x0
        and form.x0_equality
        and form.con_0.idxbx == tuple(range(nx))
        and not any(r < nx for r in form.con_0.soft_rows)
        and not opts.full_cond
        and opts.qp_solver_name == "RICCATI_IPM")


def keep_rows_of(form: OcpNlpFormulation):
    """Static real-row counts of the stage classes (con_0, con, con_e):
    partial condensing prunes the padding rows beyond them instead of
    carrying all nc rows of every eliminated stage. None for a multiphase
    form, whose path rows differ by phase (acados_tpu/ocp_nlp/sqp.py:
    463-465): every stage keeps its nc rows."""
    if is_multiphase(form):
        return None
    return (form.con_0.nrows, form.con.nrows, form.con_e.nrows)


def _set_at(stat, k, col, value):
    """stat[b, k[b], col] = value[b] for every instance b."""
    idx = torch.arange(stat.shape[0], device=stat.device)
    stat[idx, k.long(), col] = value.to(stat.dtype)


def _scaled(c, v):
    """c * v for a float c or a per-instance (B,) c."""
    return (_bc(c, v) if torch.is_tensor(c) else c) * v


def make_qp_solve(form: OcpNlpFormulation, opts: SqpOpts):
    """The QP dispatch of every SQP round (acados_tpu/ocp_nlp/sqp.py:
    468-500): solve_qp(qp, warm=None, qp_opts=None) -> (sol, info) takes
    the regularized QP through scaling, then full condensing (the dense
    IPM, cold), partial condensing (the Riccati IPM), the registry's
    backend where qp_solver_name names another, or the Riccati IPM.
    qp_opts overrides opts.qp_opts (the adaptive QP tolerances)."""
    x0_fixed = use_x0_elimination(form, opts)
    keep_rows = keep_rows_of(form)

    def solve_qp(qp, warm=None, qp_opts=None):
        qp_opts = opts.qp_opts if qp_opts is None else qp_opts
        scales = None
        if opts.qpscaling != "NO_SCALING":
            # x0 rows keep unit scales: the eliminated path reads dx0
            # from lg on those rows
            qp, scales = scale_qp(qp,
                                  unit_rows_0=form.nx if x0_fixed else 0)
            warm = None  # the warm point is in unscaled units
        if opts.full_cond:
            sol, info = solve_ocp_qp_xcond(qp, qp_opts, full_cond=True)
        elif opts.cond_N is not None:
            sol, info = solve_ocp_qp_xcond(
                qp, qp_opts, cond_N=opts.cond_N, warm=warm,
                keep_rows=keep_rows, cond_block_size=opts.cond_block_size,
                x0_fixed=x0_fixed)
        elif opts.qp_solver_name != "RICCATI_IPM":
            sol, info = get_qp_backend(opts.qp_solver_name)(
                qp, qp_opts, warm=warm)
        else:
            sol, info = solve_ocp_qp(qp, qp_opts, warm=warm,
                                     x0_fixed=x0_fixed)
        if scales is not None:
            sol = unscale_sol(sol, scales)
        return sol, info

    return solve_qp


def nlp_warm_start(qp: OcpQp, it: NlpIterate) -> OcpQpSol:
    """The QP's warm start at the NLP multipliers with zero primal steps
    (warm_start_first_qp_from_nlp)."""
    return OcpQpSol(
        x=torch.zeros_like(qp.q), u=torch.zeros_like(qp.r), pi=it.pi,
        lam_lg=it.lam_l, lam_ug=it.lam_u, t_lg=torch.ones_like(it.lam_l),
        t_ug=torch.ones_like(it.lam_u), sl=it.sl, su=it.su)


TIMEOUT_HEURISTICS = ("ZERO", "LAST", "MAX", "AVERAGE")


def _predict_round(heuristic: str, pred: float, round_time: float,
                   r: int) -> float:
    """The predicted time of the next round (acados_tpu/ocp_nlp/sqp.py:
    799-815): 0 before the first round has run, else by the heuristic
    from the last round's time and the last prediction."""
    if r == 0 or heuristic == "ZERO":
        return 0.0
    if heuristic == "LAST":
        return round_time
    if heuristic == "MAX":
        return max(pred, round_time)
    return 0.5 * (pred + round_time)


class _PhaseClock:
    """The phase marks of every round: CUDA events recorded in stream
    order on the card, the host clock on the CPU. totals() reads them
    once, after the loop's last synchronisation (the events have then
    completed, so reading them waits for nothing)."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.rounds = []

    def mark(self):
        if self.stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def totals(self) -> torch.Tensor:
        """[linearize, regularize, QP, the rest] in seconds, summed over
        the rounds."""
        out = [0.0] * 4
        for m in self.rounds:
            for i in range(4):
                out[i] += (m[i + 1] - m[i] if self.stream is None
                           else m[i].elapsed_time(m[i + 1]) / 1e3)
        return torch.tensor(out, dtype=torch.float64)


def make_sqp_solver(form: OcpNlpFormulation, opts: SqpOpts):
    """Build the batch-first SQP solve function.

    Returns solve(data: NlpData, init: NlpIterate) -> (NlpIterate,
    SqpStats), every tensor leading with the batch axis; it runs on the
    device its inputs lie on.
    """
    if opts.timeout_heuristic not in TIMEOUT_HEURISTICS:
        raise ValueError(f"timeout_heuristic {opts.timeout_heuristic!r}")
    full_precision_matmul()
    use_aa = (opts.with_anderson_acceleration
              and opts.globalization == "FIXED_STEP")
    adaptive_lm = opts.with_adaptive_levenberg_marquardt
    solve_qp = make_qp_solve(form, opts)

    def merit_search(data, it, qp, sol, qp_opts_k, soft_scaled, mask, lb_m,
                     ub_m, active):
        """MERIT_BACKTRACKING of every active instance (acados_tpu/ocp_nlp/
        sqp.py:608-683). Returns (alpha, the solution stepped along, the
        SOC QPs' iterations)."""
        w_pi = torch.maximum(it.pi.abs(), sol.pi.abs()) + 1e-4
        w_lam = (torch.maximum(torch.maximum(it.lam_l, sol.lam_lg),
                               torch.maximum(it.lam_u, sol.lam_ug))
                 + 1e-4) * mask
        merit = lambda x, u, sl, su: _merit(form, data, soft_scaled, x, u,
                                            sl, su, w_pi, w_lam, lb_m, ub_m)
        merit0 = merit(it.x, it.u, it.sl, it.su)
        if opts.line_search_use_sufficient_descent:
            dmerit = torch.clamp(_merit_gradient(
                form, qp, sol, it, w_pi, w_lam, lb_m, ub_m, soft_scaled,
                data), max=0.0)
        else:
            dmerit = torch.zeros_like(merit0)
        eps_sd = opts.eps_sufficient_descent

        m1 = merit(*_trial(it, sol, 1.0))
        full_ok = m1 < merit0 + eps_sd * dmerit
        soc_iter = None
        soc_ok = torch.zeros_like(full_ok)
        sol_used = sol
        if opts.globalization_use_SOC:
            # second-order correction of the QP rhs at the rejected full
            # step (ocp_nlp_common.c:4227), solved for every instance
            x_t, u_t = it.x + sol.x, it.u + sol.u
            gap_t = eval_dyn_gap(form, data, x_t, u_t)
            g_t = eval_constraints(form, data, x_t, u_t)
            g_cur = eval_constraints(form, data, it.x, it.u)
            delta2 = g_t - g_cur - _row_step(qp, sol)
            qp_soc = qp.replace(b=gap_t - _dgap_lin(qp, sol),
                                lg=qp.lg - delta2, ug=qp.ug - delta2)
            sol_soc, info_soc = solve_qp(qp_soc, qp_opts=qp_opts_k)
            soc_iter = info_soc.num_iter
            m_soc = merit(*_trial(it, sol_soc, 1.0))
            soc_ok = ~full_ok & (m_soc < merit0 + eps_sd * dmerit)
            sol_used = select_fields(soc_ok, sol_soc, sol)

        def armijo(alpha):
            mt = merit(*_trial(it, sol, alpha))
            return mt < merit0 + eps_sd * dmerit * alpha, ()

        alpha_bt, _, _ = _backtrack(active & ~(full_ok | soc_ok), armijo,
                                    opts, opts.alpha_reduction, merit0)
        alpha = torch.where(full_ok | soc_ok, torch.ones_like(alpha_bt),
                            alpha_bt)
        return alpha, sol_used, soc_iter

    def solve(data: NlpData, init: NlpIterate):
        dtype, dev = init.x.dtype, init.x.device
        Bsz = init.x.shape[0]
        static_rows = build_static_rows(form, dtype, dev)
        lm = torch.tensor(opts.levenberg_marquardt, dtype=dtype, device=dev)
        soft_scaled = static_rows["soft"] * static_rows["mask"]
        # bounds with disabled rows and absent sides masked off, for the
        # merit's violations (acados_tpu/ocp_nlp/sqp.py:507-517)
        lb_all = _stack_stages(data.lb_0, data.lb, data.lb_e)
        ub_all = _stack_stages(data.ub_0, data.ub, data.ub_e)
        big = torch.full_like(lb_all, 1e20)
        inf_thr = 0.5 * ACADOS_INFTY
        lb_m = torch.where((static_rows["mask"] > 0) & (lb_all > -inf_thr),
                           lb_all, -big)
        ub_m = torch.where((static_rows["mask"] > 0) & (ub_all < inf_thr),
                           ub_all, big)

        it = init
        k = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        status = torch.full((Bsz,), 2, dtype=torch.int32, device=dev)
        done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        qp_tot = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        stat = torch.zeros((Bsz, opts.max_iter + 1, len(STAT_COLS)),
                           dtype=dtype, device=dev)
        res_last = torch.zeros((4, Bsz), dtype=dtype, device=dev)
        lm_state = torch.full((Bsz,), opts.adaptive_levenberg_marquardt_mu0,
                              dtype=dtype, device=dev)
        zero_step = map_fields(torch.zeros_like, init)
        aa = (zero_step, zero_step)
        gstate = None
        if opts.globalization == "FUNNEL_L1PEN_LINESEARCH":
            inf0 = _l1_infeasibility(form, data, soft_scaled, init.x,
                                     init.u, init.sl, init.su, lb_m, ub_m)
            gstate = (torch.clamp(
                opts.funnel_initialization_increase_factor * inf0,
                min=opts.funnel_initialization_upper_bound),
                torch.full((Bsz,), opts.funnel_initial_penalty_parameter,
                           dtype=dtype, device=dev),
                torch.zeros(Bsz, dtype=torch.bool, device=dev))

        hist = None
        if opts.store_iterates:
            # the whole history at once: (B, max_iter+1, ...) per field
            hist = tuple(torch.zeros((Bsz, opts.max_iter + 1)
                                     + v.shape[1:], dtype=dtype, device=dev)
                         for v in (init.x, init.u))
            for h, v in zip(hist, (init.x, init.u)):
                h[:, 0] = v
        clock = _PhaseClock(dev) if opts.collect_phase_times else None
        timeout = opts.timeout_max_time > 0.0
        r = 0                   # lockstep rounds run
        t_start = t_prev = time.perf_counter()
        pred = 0.0

        while True:
            active = (k < opts.max_iter) & ~done
            if not wait_any(active):
                break
            if timeout:
                # the batch's clock, read after the round's sync above:
                # every active instance has run r rounds (its k == r)
                t_now = time.perf_counter()
                pred = _predict_round(opts.timeout_heuristic, pred,
                                      t_now - t_prev, r)
                t_prev = t_now
                if r > 0 and (t_now - t_start) + pred \
                        > opts.timeout_max_time:
                    status = torch.where(active, 7, status).to(torch.int32)
                    done = done | active
                    continue
            r += 1
            marks = [clock.mark()] if clock is not None else None
            lm_k = lm_state if adaptive_lm else lm
            qp = linearize(form, static_rows, data, it, lm_k)
            rs, re, ri, rc = _nlp_residuals(qp, it)
            stat_new = stat.clone()
            for col, v in enumerate((rs, re, ri, rc)):
                _set_at(stat_new, k, col, v)
            converged = ((rs < opts.tol_stat) & (re < opts.tol_eq)
                         & (ri < opts.tol_ineq) & (rc < opts.tol_comp))
            # unbounded-objective detection (ocp_nlp_sqp.c:411-417)
            cost_k = eval_cost(form, data, it.x, it.u, it.sl, it.su,
                               soft_scaled)
            unbounded = cost_k <= opts.tol_unbounded

            # regularize (sqp.py:568), then the QP backend (sqp.py:468-500)
            if clock is not None:
                marks.append(clock.mark())
            qp_solve = regularize_qp(qp, opts.regularize_method,
                                     opts.reg_epsilon)
            if clock is not None:
                marks.append(clock.mark())
            if opts.nlp_qp_tol_strategy == "ADAPTIVE_CURRENT_RES_JOINT":
                qp_opts_k = adaptive_qp_tol(opts, opts.qp_opts, rs, re, ri,
                                            rc)
            else:
                qp_opts_k = opts.qp_opts
            warm = (nlp_warm_start(qp, it)
                    if opts.warm_start_first_qp_from_nlp else None)
            sol, info = solve_qp(qp_solve, warm=warm, qp_opts=qp_opts_k)
            if clock is not None:
                marks.append(clock.mark())
            # a QP at its iteration limit may still be usable; only a NaN
            # QP is fatal (reference ocp_nlp_sqp.c:720-752)
            qp_fatal = info.status == 1
            qp_tot_new = qp_tot + info.num_iter
            _set_at(stat_new, k, 4, info.status)
            _set_at(stat_new, k, 5, info.num_iter)

            gstate_new = gstate
            if opts.globalization == "FIXED_STEP":
                alpha = opts.step_length
                alpha_col = torch.full((Bsz,), alpha, dtype=dtype,
                                       device=dev)
            elif opts.globalization == "FUNNEL_L1PEN_LINESEARCH":
                alpha, gstate_new = _funnel_search(
                    form, opts, data, soft_scaled, lb_m, ub_m, qp, it, sol,
                    gstate, active)
                alpha_col = alpha
            else:  # MERIT_BACKTRACKING
                alpha, sol, soc_iter = merit_search(
                    data, it, qp, sol, qp_opts_k, soft_scaled,
                    static_rows["mask"], lb_m, ub_m, active)
                alpha_col = alpha
                if soc_iter is not None:
                    qp_tot_new = qp_tot_new + soc_iter

            step_norm = _scaled(alpha, torch.maximum(_bmax(sol.x.abs()),
                                                     _bmax(sol.u.abs())))
            _set_at(stat_new, k, 6, alpha_col)
            _set_at(stat_new, k, 7, step_norm)

            beta = alpha if opts.full_step_dual is False else 1.0
            # delta primal-dual step (Anderson works on the delta form,
            # ocp_nlp_convert_primaldelta_absdual_step_to_delta_step)
            step = NlpIterate(
                x=sol.x, u=sol.u, pi=sol.pi - it.pi,
                lam_l=sol.lam_lg - it.lam_l, lam_u=sol.lam_ug - it.lam_u,
                sl=sol.sl - it.sl, su=sol.su - it.su)
            aa_new = aa
            if use_aa:
                prev_step, and_step = aa
                d_diff = map_fields(lambda n, o: n - o, step, prev_step)
                dots = sum(_bsum(getattr(step, f) * getattr(d_diff, f))
                           for f in _ITER_FIELDS)
                nrm2 = sum(_bsum(getattr(d_diff, f) ** 2)
                           for f in _ITER_FIELDS)
                gamma = dots / torch.clamp(nrm2, min=1e-30)
                res_inf = torch.maximum(torch.maximum(rs, re), ri)
                plain = (k == 0) | (res_inf
                                    > opts.anderson_activation_threshold)

                def mix(a_s, p_s, n_s):
                    g = _bc(gamma, n_s)
                    return where_batch(
                        plain, alpha * n_s,
                        -g * a_s + g * alpha * p_s
                        + (alpha - g * alpha) * n_s)

                and_new = map_fields(mix, and_step, prev_step, step)
                aa_new = (step, and_new)
                it_new = map_fields(lambda v, d: v + d, it, and_new)
            else:
                it_new = NlpIterate(
                    x=it.x + _scaled(alpha, step.x),
                    u=it.u + _scaled(alpha, step.u),
                    pi=it.pi + _scaled(beta, step.pi),
                    lam_l=it.lam_l + _scaled(beta, step.lam_l),
                    lam_u=it.lam_u + _scaled(beta, step.lam_u),
                    sl=it.sl + _scaled(beta, step.sl),
                    su=it.su + _scaled(beta, step.su))
            nan = ~torch.isfinite(_bsum(it_new.x) + _bsum(it_new.u))
            it_new = select_fields(nan | converged, it, it_new)

            small_step = step_norm < opts.tol_min_step_norm
            new_status = torch.where(
                converged, 0,
                torch.where(unbounded, 6,  # ACADOS_UNBOUNDED
                            torch.where(nan | qp_fatal,
                                        torch.where(qp_fatal, 4, 1),
                                        torch.where(small_step, 3, status))))
            done_new = converged | unbounded | nan | qp_fatal | small_step
            if hist is not None:
                # row k+1 of every active instance (acados_tpu/ocp_nlp/
                # sqp.py:770-777); a stopped one's rows stay
                idx = torch.arange(Bsz, device=dev)
                row = torch.clamp(k + 1, max=opts.max_iter).long()
                for h, v in zip(hist, (it_new.x, it_new.u)):
                    h[idx, row] = where_batch(active, v, h[idx, row])
            if clock is not None:
                marks.append(clock.mark())
                clock.rounds.append(marks)
            # k advances only when a step was taken
            k_new = torch.where(converged, k, k + 1)
            if adaptive_lm:
                # shrink on a stationarity-residual decrease, grow
                # otherwise (acados_tpu/ocp_nlp/sqp.py:749-761)
                lam_f = torch.full_like(lm_k,
                                        opts.adaptive_levenberg_marquardt_lam)
                mu_min = opts.adaptive_levenberg_marquardt_mu_min
                lm_next = torch.where(
                    k == 0, lm_k,
                    torch.where(rs < res_last[0],
                                torch.clamp(lm_k / lam_f, min=mu_min),
                                lm_k * lam_f))
                lm_state = torch.where(active, lm_next, lm_state)

            # lockstep freeze of the instances that had stopped
            it = select_fields(active, it_new, it)
            k = torch.where(active, k_new, k)
            status = torch.where(active, new_status, status).to(torch.int32)
            done = torch.where(active, done_new, done)
            qp_tot = torch.where(active, qp_tot_new, qp_tot)
            stat = where_batch(active, stat_new, stat)
            res_last = torch.where(active, torch.stack([rs, re, ri, rc]),
                                   res_last)
            if use_aa:
                aa = tuple(select_fields(active, n, o)
                           for n, o in zip(aa_new, aa))
            if gstate is not None:
                gstate = tuple(torch.where(active, n, o)
                               for n, o in zip(gstate_new, gstate))

        if opts.rti:
            # RTI semantics (reference ocp_nlp_sqp_rti.c): the reported
            # residuals are those at the preparation linearization point
            rs, re, ri, rc = res_last
        else:
            # final residuals at the returned iterate (ocp_nlp_sqp.c:556)
            qp = linearize(form, static_rows, data, it, lm)
            rs, re, ri, rc = _nlp_residuals(qp, it)
        for col, v in enumerate((rs, re, ri, rc)):
            _set_at(stat, k, col, v)
        converged = ((rs < opts.tol_stat) & (re < opts.tol_eq)
                     & (ri < opts.tol_ineq) & (rc < opts.tol_comp))
        status = torch.where(converged & (status != 7), 0, status)
        if opts.rti:
            # MAXITER / MINSTEP are success for the real-time iteration
            status = torch.where((status == 2) | (status == 3), 0, status)
        cost = eval_cost(form, data, it.x, it.u, it.sl, it.su, soft_scaled)
        stats = SqpStats(status=status.to(torch.int32), sqp_iter=k,
                         qp_iter_total=qp_tot, res_stat=rs, res_eq=re,
                         res_ineq=ri, res_comp=rc, stat=stat, cost=cost,
                         iterates_x=None if hist is None else hist[0],
                         iterates_u=None if hist is None else hist[1],
                         phase_times=(None if clock is None
                                      else clock.totals()))
        return it, stats

    return solve


_ITER_FIELDS = [f.name for f in dataclasses.fields(NlpIterate)]


def init_iterate(form: OcpNlpFormulation, batch: int = 1,
                 dtype=torch.float32, device=None, x_traj=None,
                 u_traj=None) -> NlpIterate:
    """Zero (or trajectory-warm-started) NLP iterate for a batch."""
    N, nx, nu, nc = form.N, form.nx, form.nu, form.nc

    def z(*s):
        return torch.zeros((batch,) + s, dtype=dtype, device=device)

    x = z(N + 1, nx) if x_traj is None else torch.as_tensor(
        x_traj, dtype=dtype, device=device).expand(batch, N + 1, nx).clone()
    u = z(N, nu) if u_traj is None else torch.as_tensor(
        u_traj, dtype=dtype, device=device).expand(batch, N, nu).clone()
    return NlpIterate(x=x, u=u, pi=z(N, nx), lam_l=z(N + 1, nc),
                      lam_u=z(N + 1, nc), sl=z(N + 1, nc), su=z(N + 1, nc))
