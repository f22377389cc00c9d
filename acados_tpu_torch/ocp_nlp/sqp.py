"""SQP solver: linearize -> residuals -> regularize -> QP -> step, batch-first.

Counterpart of `acados_tpu/ocp_nlp/sqp.py` for SQP and SQP_RTI with the
FIXED_STEP globalization, on the Riccati IPM or, with full condensing,
the dense IPM. The JAX package runs one `lax.while_loop` per
instance and vmaps it; the port runs the whole batch in lockstep and
freezes each instance that has stopped with `where(active, new, old)`, so
per-instance iteration counts and statuses are those of the vmapped loop.

Multiplier update rule follows ocp_nlp_update_variables_sqp
(reference ocp_nlp_common.c:3292): duals blend (1-alpha)*old + alpha*new.
"""
from __future__ import annotations

import dataclasses

import torch

from acados_tpu_torch.ocp_nlp.formulation import NlpData, OcpNlpFormulation
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate,
                                                build_static_rows, eval_cost,
                                                linearize)
from acados_tpu_torch.ocp_nlp.regularize import regularize_qp
from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.ipm import (IpmOpts, _bmax, _bsum,
                                         solve_ocp_qp)
from acados_tpu_torch.ocp_qp.riccati import _mTv
from acados_tpu_torch.ocp_qp.xcond import solve_ocp_qp_xcond
from acados_tpu_torch.utils.device import full_precision_matmul
from acados_tpu_torch.utils.struct import (select_fields, tensor_dataclass,
                                           where_batch)

# stats matrix columns (reference ocp_nlp_sqp.c:579-585)
STAT_COLS = ("res_stat", "res_eq", "res_ineq", "res_comp", "qp_status",
             "qp_iter", "alpha", "step_norm")


@dataclasses.dataclass(frozen=True)
class SqpOpts:
    """SQP options; names and defaults as acados_tpu.ocp_nlp.sqp.SqpOpts,
    for the options of the ported paths and of those that select a path
    not ported yet: those raise NotImplementedError in make_sqp_solver
    when set away from their default."""

    max_iter: int = 50
    tol_stat: float = 1e-6
    tol_eq: float = 1e-6
    tol_ineq: float = 1e-6
    tol_comp: float = 1e-6
    tol_min_step_norm: float = 1e-12
    tol_unbounded: float = -1e10
    levenberg_marquardt: float = 0.0
    with_adaptive_levenberg_marquardt: bool = False
    regularize_method: str = "NO_REGULARIZE"
    reg_epsilon: float = 1e-4
    globalization: str = "FIXED_STEP"
    full_step_dual: bool = False
    rti: bool = False
    cond_N: int | None = None
    full_cond: bool = False
    step_length: float = 1.0
    collect_phase_times: bool = False
    timeout_max_time: float = 0.0
    with_anderson_acceleration: bool = False
    store_iterates: bool = False
    qpscaling: str = "NO_SCALING"
    warm_start_first_qp_from_nlp: bool = False
    qp_solver_name: str = "RICCATI_IPM"
    nlp_qp_tol_strategy: str = "FIXED_QP_TOL"
    eliminate_x0: bool = True
    qp_opts: IpmOpts = None

    def __post_init__(self):
        if self.qp_opts is None:
            object.__setattr__(self, "qp_opts", IpmOpts())

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


# option -> (default, ROADMAP item) for the paths that wait
_NOT_PORTED = {
    "globalization": ("FIXED_STEP", "MERIT/FUNNEL globalization"),
    "with_anderson_acceleration": (False, "Anderson acceleration"),
    "with_adaptive_levenberg_marquardt": (False, "adaptive LM"),
    "qpscaling": ("NO_SCALING", "QP front-ends (qpscaling)"),
    "cond_N": (None, "QP front-ends (partial condensing)"),
    "qp_solver_name": ("RICCATI_IPM", "QP breadth (registry backends)"),
    "collect_phase_times": (False, "phase times"),
    "timeout_max_time": (0.0, "in-loop timeout"),
    "store_iterates": (False, "stored iterates"),
    "nlp_qp_tol_strategy": ("FIXED_QP_TOL", "adaptive QP tolerances"),
}


def _check_ported(opts: SqpOpts):
    for field, (default, item) in _NOT_PORTED.items():
        if getattr(opts, field) != default:
            raise NotImplementedError(
                f"SqpOpts.{field}={getattr(opts, field)!r} is not ported "
                f"yet (ROADMAP.md Queue 1: {item})")


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


def _set_at(stat, k, col, value):
    """stat[b, k[b], col] = value[b] for every instance b."""
    idx = torch.arange(stat.shape[0], device=stat.device)
    stat[idx, k.long(), col] = value.to(stat.dtype)


def make_sqp_solver(form: OcpNlpFormulation, opts: SqpOpts):
    """Build the batch-first SQP solve function.

    Returns solve(data: NlpData, init: NlpIterate) -> (NlpIterate,
    SqpStats), every tensor leading with the batch axis; it runs on the
    device its inputs lie on.
    """
    _check_ported(opts)
    full_precision_matmul()
    x0_fixed = use_x0_elimination(form, opts)

    def solve_qp(qp, warm=None):
        """QP backend dispatch (acados_tpu/ocp_nlp/sqp.py:482-500): full
        condensing -> the dense IPM, cold; else the Riccati IPM."""
        if opts.full_cond:
            return solve_ocp_qp_xcond(qp, opts.qp_opts, full_cond=True)
        return solve_ocp_qp(qp, opts.qp_opts, warm=warm, x0_fixed=x0_fixed)

    def solve(data: NlpData, init: NlpIterate):
        dtype, dev = init.x.dtype, init.x.device
        Bsz = init.x.shape[0]
        static_rows = build_static_rows(form, dtype, dev)
        lm = torch.tensor(opts.levenberg_marquardt, dtype=dtype, device=dev)
        soft_scaled = static_rows["soft"] * static_rows["mask"]

        it = init
        k = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        status = torch.full((Bsz,), 2, dtype=torch.int32, device=dev)
        done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        qp_tot = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        stat = torch.zeros((Bsz, opts.max_iter + 1, len(STAT_COLS)),
                           dtype=dtype, device=dev)
        res_last = torch.zeros((4, Bsz), dtype=dtype, device=dev)

        while True:
            active = (k < opts.max_iter) & ~done
            if not bool(active.any()):
                break
            qp = linearize(form, static_rows, data, it, lm)
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
            qp_solve = regularize_qp(qp, opts.regularize_method,
                                     opts.reg_epsilon)
            warm = None
            if opts.warm_start_first_qp_from_nlp:
                warm = OcpQpSol(
                    x=torch.zeros_like(qp.q), u=torch.zeros_like(qp.r),
                    pi=it.pi, lam_lg=it.lam_l, lam_ug=it.lam_u,
                    t_lg=torch.ones_like(it.lam_l),
                    t_ug=torch.ones_like(it.lam_u), sl=it.sl, su=it.su)
            sol, info = solve_qp(qp_solve, warm=warm)
            # a QP at its iteration limit may still be usable; only a NaN
            # QP is fatal (reference ocp_nlp_sqp.c:720-752)
            qp_fatal = info.status == 1
            qp_tot_new = qp_tot + info.num_iter
            _set_at(stat_new, k, 4, info.status)
            _set_at(stat_new, k, 5, info.num_iter)

            alpha = opts.step_length
            step_norm = alpha * torch.maximum(_bmax(sol.x.abs()),
                                              _bmax(sol.u.abs()))
            _set_at(stat_new, k, 6, torch.full_like(step_norm, alpha))
            _set_at(stat_new, k, 7, step_norm)

            beta = alpha if opts.full_step_dual is False else 1.0
            it_new = NlpIterate(
                x=it.x + alpha * sol.x,
                u=it.u + alpha * sol.u,
                pi=it.pi + beta * (sol.pi - it.pi),
                lam_l=it.lam_l + beta * (sol.lam_lg - it.lam_l),
                lam_u=it.lam_u + beta * (sol.lam_ug - it.lam_u),
                sl=it.sl + beta * (sol.sl - it.sl),
                su=it.su + beta * (sol.su - it.su))
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
            # k advances only when a step was taken
            k_new = torch.where(converged, k, k + 1)

            # lockstep freeze of the instances that had stopped
            it = select_fields(active, it_new, it)
            k = torch.where(active, k_new, k)
            status = torch.where(active, new_status, status).to(torch.int32)
            done = torch.where(active, done_new, done)
            qp_tot = torch.where(active, qp_tot_new, qp_tot)
            stat = where_batch(active, stat_new, stat)
            res_last = torch.where(active, torch.stack([rs, re, ri, rc]),
                                   res_last)

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
                         res_ineq=ri, res_comp=rc, stat=stat, cost=cost)
        return it, stats

    return solve


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
