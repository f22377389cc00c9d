"""SQP with feasible QPs (Byrd-Omojokun), batch-first.

Counterpart of `acados_tpu/ocp_nlp/wfqp.py` (the reference's
ocp_nlp_sqp_with_feasible_qp.c). Each iteration takes its direction from
two QPs:
  1. the feasibility QP: the linearization's constraints and dynamics,
     an L1 slack on every row the user did not soften except the stage-0
     state bounds and the control bounds (reference :1253-1257), the
     slack penalties as its only gradient and a small identity Hessian
     (_FEAS_HESSIAN_SCALAR);
  2. the nominal QP with its bounds relaxed by the feasibility QP's
     slacks times _RELAXATION_FACTOR, which makes it feasible.
As in the JAX package, the Byrd-Omojokun direction is taken every
iteration (a batched IPM gives no infeasibility certificate to switch
on), so each round runs two Riccati-IPM solves of the whole batch.

The loop runs the batch in lockstep and freezes each instance that has
stopped, as `sqp.py` does; the merit backtracking is lockstep too (each
trial alpha one merit evaluation of the whole batch). An instance that
converged in the round takes no backtracking and keeps its iterate, as
in the reference; its row of the stat table differs from the
reference's in the alpha and step-norm columns (6, 7): the port writes
alpha = 1 and that step's norm, where the reference writes the alpha
its line search found.
"""
from __future__ import annotations

import numpy as np
import torch

from acados_tpu_torch.ocp_nlp.formulation import NlpData, OcpNlpFormulation
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate, _stack_stages,
                                                build_static_rows, eval_cost,
                                                linearize, refuse_multiphase)
from acados_tpu_torch.ocp_nlp.regularize import regularize_qp
from acados_tpu_torch.ocp_nlp.sqp import (STAT_COLS, SqpOpts, SqpStats,
                                          _backtrack, _merit,
                                          _nlp_residuals, _scaled, _set_at,
                                          _trial)
from acados_tpu_torch.ocp_qp.data import OcpQp
from acados_tpu_torch.ocp_qp.ipm import _bmax, _bsum, solve_ocp_qp
from acados_tpu_torch.utils.device import full_precision_matmul, wait_any
from acados_tpu_torch.utils.struct import (select_fields, tensor_dataclass,
                                           where_batch)
from acados_tpu_torch.utils.types import ACADOS_INFTY

# the JAX package's defaults, which nothing there overrides: the Byrd-
# Omojokun slack relaxation factor and the feasibility QP's Hessian scale
_RELAXATION_FACTOR = 1.00001
_FEAS_HESSIAN_SCALAR = 1e-4


@tensor_dataclass
class WfqpStats(SqpStats):
    """SqpStats with the feasibility QPs' iterations of every instance,
    (B,); qp_iter_total counts both QPs'."""

    feas_qp_iter: torch.Tensor = None   # always given (after defaults)


def _slackable_rows(form: OcpNlpFormulation, dtype, device):
    """(N+1, nc) mask of the rows that get an L1 slack in the feasibility
    QP (the reference's idxns sets, :600-667): all but the stage-0 state
    bounds, the control bounds and the rows the user already softened."""
    nc, N = form.nc, form.N

    def cls_mask(spec, is_stage0):
        m = np.zeros(nc)
        if not is_stage0:
            m[:spec.nbx] = 1.0
        o = spec.nbx + spec.nbu
        m[o:o + spec.ng + spec.nh + spec.nphi] = 1.0
        for r in spec.soft_rows:
            m[r] = 0.0
        return m

    rows = np.concatenate([cls_mask(form.con_0, True)[None],
                           np.tile(cls_mask(form.con, False), (N - 1, 1)),
                           cls_mask(form.con_e, False)[None]])
    return torch.as_tensor(rows, dtype=dtype, device=device)


def make_wfqp_solver(form: OcpNlpFormulation, opts: SqpOpts):
    """Build the batch-first SQP-WFQP solve function.

    solve(data: NlpData, init: NlpIterate) -> (NlpIterate, WfqpStats),
    every tensor leading with the batch axis. The stat table's qp_status
    column is the nominal QP's status, its qp_iter column both QPs'
    iterations.
    """
    refuse_multiphase(form, "SQP_WITH_FEASIBLE_QP")
    full_precision_matmul()

    def feasibility_qp(qp: OcpQp, soft_new) -> OcpQp:
        """The feasibility QP of every instance (:1240-1280)."""
        Bsz, N1 = qp.Q.shape[0], qp.Q.shape[1]
        nx, nu = qp.Q.shape[-1], qp.R.shape[-1]
        eye = lambda n: (_FEAS_HESSIAN_SCALAR * torch.eye(
            n, dtype=qp.Q.dtype, device=qp.Q.device))
        new = soft_new > 0
        return qp.replace(
            Q=eye(nx).expand(Bsz, N1, nx, nx),
            R=eye(nu).expand(Bsz, N1 - 1, nu, nu),
            S=torch.zeros_like(qp.S), q=torch.zeros_like(qp.q),
            r=torch.zeros_like(qp.r),
            soft_mask=torch.maximum(qp.soft_mask, soft_new),
            zl=torch.where(new, 1.0, qp.zl), zu=torch.where(new, 1.0, qp.zu),
            Zl=torch.where(new, 0.0, qp.Zl), Zu=torch.where(new, 0.0, qp.Zu))

    def byrd_omojokun_step(qp: OcpQp, soft_new):
        """Feasibility QP -> nominal QP with its bounds relaxed by the
        feasibility slacks (setup_byrd_omojokun_bounds) -> direction."""
        sol_f, info_f = solve_ocp_qp(feasibility_qp(qp, soft_new),
                                     opts.qp_opts)
        relax = _RELAXATION_FACTOR * soft_new
        qp_adj = qp.replace(lg=qp.lg - relax * qp.mask_l * sol_f.sl,
                            ug=qp.ug + relax * qp.mask_u * sol_f.su)
        sol, info = solve_ocp_qp(qp_adj, opts.qp_opts)
        return sol, info, info_f

    def solve(data: NlpData, init: NlpIterate):
        dtype, dev = init.x.dtype, init.x.device
        Bsz = init.x.shape[0]
        static_rows = build_static_rows(form, dtype, dev)
        mask = static_rows["mask"]
        soft_scaled = static_rows["soft"] * mask
        soft_new = _slackable_rows(form, dtype, dev) * mask
        lm = torch.tensor(opts.levenberg_marquardt, dtype=dtype, device=dev)
        lb_all = _stack_stages(data.lb_0, data.lb, data.lb_e)
        ub_all = _stack_stages(data.ub_0, data.ub, data.ub_e)
        big = torch.full_like(lb_all, 1e20)
        inf_thr = 0.5 * ACADOS_INFTY
        lb_m = torch.where((mask > 0) & (lb_all > -inf_thr), lb_all, -big)
        ub_m = torch.where((mask > 0) & (ub_all < inf_thr), ub_all, big)

        it = init
        k = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        status = torch.full((Bsz,), 2, dtype=torch.int32, device=dev)
        done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        qp_tot = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        feas_tot = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        stat = torch.zeros((Bsz, opts.max_iter + 1, len(STAT_COLS)),
                           dtype=dtype, device=dev)

        while True:
            active = (k < opts.max_iter) & ~done
            if not wait_any(active):
                break
            qp = linearize(form, static_rows, data, it, lm)
            rs, re, ri, rc = _nlp_residuals(qp, it)
            stat_new = stat.clone()
            for col, v in enumerate((rs, re, ri, rc)):
                _set_at(stat_new, k, col, v)
            converged = ((rs < opts.tol_stat) & (re < opts.tol_eq)
                         & (ri < opts.tol_ineq) & (rc < opts.tol_comp))

            qp_solve = regularize_qp(qp, opts.regularize_method,
                                     opts.reg_epsilon)
            sol, info, info_f = byrd_omojokun_step(qp_solve, soft_new)
            qp_fatal = (info.status == 1) | (info_f.status == 1)
            qp_tot_new = qp_tot + info.num_iter + info_f.num_iter
            _set_at(stat_new, k, 4, info.status)
            _set_at(stat_new, k, 5, info.num_iter + info_f.num_iter)

            if opts.globalization == "FIXED_STEP":
                alpha = torch.ones(Bsz, dtype=dtype, device=dev)
            else:
                w_pi = torch.maximum(it.pi.abs(), sol.pi.abs()) + 1e-4
                w_lam = (torch.maximum(torch.maximum(it.lam_l, sol.lam_lg),
                                       torch.maximum(it.lam_u, sol.lam_ug))
                         + 1e-4) * mask
                merit = lambda x, u, sl, su: _merit(
                    form, data, soft_scaled, x, u, sl, su, w_pi, w_lam,
                    lb_m, ub_m)
                search = active & ~converged
                merit0 = (merit(it.x, it.u, it.sl, it.su)
                          if wait_any(search) else None)
                alpha, _, _ = _backtrack(
                    search,
                    lambda a: (merit(*_trial(it, sol, a)) < merit0, ()),
                    opts, 1.0, torch.zeros(Bsz, dtype=dtype, device=dev))

            step_norm = alpha * torch.maximum(_bmax(sol.x.abs()),
                                              _bmax(sol.u.abs()))
            _set_at(stat_new, k, 6, alpha)
            _set_at(stat_new, k, 7, step_norm)

            xt, ut, slt, sut = _trial(it, sol, alpha)
            blend = lambda old, new: (_scaled(1 - alpha, old)
                                      + _scaled(alpha, new))
            it_new = NlpIterate(
                x=xt, u=ut, pi=blend(it.pi, sol.pi),
                lam_l=blend(it.lam_l, sol.lam_lg),
                lam_u=blend(it.lam_u, sol.lam_ug), sl=slt, su=sut)
            nan = ~torch.isfinite(_bsum(it_new.x) + _bsum(it_new.u))
            it_new = select_fields(nan | converged, it, it_new)
            small_step = step_norm < opts.tol_min_step_norm
            new_status = torch.where(
                converged, 0,
                torch.where(nan | qp_fatal, torch.where(qp_fatal, 4, 1),
                            torch.where(small_step, 3, status)))
            done_new = converged | nan | qp_fatal | small_step
            k_new = torch.where(converged, k, k + 1)

            # lockstep freeze of the instances that had stopped
            it = select_fields(active, it_new, it)
            k = torch.where(active, k_new, k)
            status = torch.where(active, new_status, status).to(torch.int32)
            done = torch.where(active, done_new, done)
            qp_tot = torch.where(active, qp_tot_new, qp_tot)
            feas_tot = torch.where(active, feas_tot + info_f.num_iter,
                                   feas_tot)
            stat = where_batch(active, stat_new, stat)

        qp = linearize(form, static_rows, data, it, lm)
        rs, re, ri, rc = _nlp_residuals(qp, it)
        for col, v in enumerate((rs, re, ri, rc)):
            _set_at(stat, k, col, v)
        converged = ((rs < opts.tol_stat) & (re < opts.tol_eq)
                     & (ri < opts.tol_ineq) & (rc < opts.tol_comp))
        status = torch.where(converged, 0, status).to(torch.int32)
        cost = eval_cost(form, data, it.x, it.u, it.sl, it.su, soft_scaled)
        stats = WfqpStats(status=status, sqp_iter=k, qp_iter_total=qp_tot,
                          res_stat=rs, res_eq=re, res_ineq=ri, res_comp=rc,
                          stat=stat, cost=cost, feas_qp_iter=feas_tot)
        return it, stats

    return solve
