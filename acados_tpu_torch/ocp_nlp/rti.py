"""SQP-RTI with the preparation / feedback split, batch-first.

Counterpart of `acados_tpu/ocp_nlp/rti.py` (reference
ocp_nlp_sqp_rti.c): `prepare` linearizes at the current iterate (all
that does not depend on the coming x0 measurement) and solves the QP at
the predicted x0; `feedback` injects the fresh x0 into the stage-0 bound
rows, solves the prepared QP warm-started from the predicted solution,
and takes the full step (alpha = 1). Every tensor leads with the batch
axis, as in ocp_nlp/sqp.py.

AS-RTI levels (preparation_advanced_step, ocp_nlp_sqp_rti.c:797-1139),
run once a previous cycle's cache exists: the data are first advanced
to the predicted next x0 (SHIFT: x_1 of the iterate, SIMULATE: one
integrator step from (x_0, u_0), NONE), then
  A  re-solves the previous QP at the predicted x0 from the previous
     preparation's iterate;
  B  as_rti_iter zero-order iterations: constraint and dynamics values
     refreshed, matrices and gradients frozen with the Hessian
     correction q += H (w - w_lin);
  C  as_rti_iter iterations with the exact cost gradient and the
     adjoint correction (J_true - J_stale)' pi of the stale dynamics
     Jacobians (a vector-Jacobian product through the integrator step);
  D  as_rti_iter full SQP iterations;
and the standard preparation follows. Like the JAX package, both
phases solve the QP without condensing or scaling (the JAX module
imports the condensing front-end but does not call it).
"""
from __future__ import annotations

import torch
from torch.func import grad, vjp

from acados_tpu_torch.ocp_nlp.formulation import NlpData, OcpNlpFormulation
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate, _flat2,
                                                _stack_stages,
                                                build_static_rows,
                                                eval_constraints, eval_cost,
                                                eval_dyn_gap, linearize,
                                                refuse_multiphase)
from acados_tpu_torch.ocp_nlp.regularize import regularize_qp
from acados_tpu_torch.ocp_nlp.sqp import (SqpOpts, SqpStats, _nlp_residuals,
                                          adaptive_qp_tol,
                                          use_x0_elimination)
from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.ipm import _bsum, solve_ocp_qp
from acados_tpu_torch.ocp_qp.riccati import _mTv
from acados_tpu_torch.utils.device import full_precision_matmul
from acados_tpu_torch.utils.struct import select_fields, tensor_dataclass

AS_RTI_LEVELS = ("STANDARD", "A", "B", "C", "D")


@tensor_dataclass
class RtiCache:
    """Preparation output carried into the feedback phase (batch-first)."""

    qp: OcpQp            # linearization at the preparation iterate
    g0: torch.Tensor     # (B, nc) stage-0 row values (for x0 injection)
    it: NlpIterate       # the iterate the linearization was taken at
    sol_pred: OcpQpSol   # QP solution at the predicted x0 (warm start)


def make_rti_solver(form: OcpNlpFormulation, opts: SqpOpts):
    """Build (prepare, feedback), batch-first.

    prepare(data, it, prev_cache=None) -> RtiCache
      prev_cache (the previous cycle's cache) turns on the AS-RTI level
      of opts; with STANDARD or without it this is the plain preparation.
    feedback(cache, data, it) -> (NlpIterate, SqpStats)
      data's lb_0/ub_0 carry the fresh x0.
    """
    if opts.as_rti_level not in AS_RTI_LEVELS:
        raise ValueError(f"unknown as_rti_level {opts.as_rti_level!r}")
    if opts.as_rti_advancement not in ("SHIFT", "SIMULATE", "NONE"):
        raise ValueError(
            f"unknown as_rti_advancement {opts.as_rti_advancement!r}")
    if opts.as_rti_level == "C":
        # level C's adjoint correction steps every interval with
        # form.step_fn, which is phase 0's on a multiphase form
        refuse_multiphase(form, "AS-RTI level C",
                          "the JAX package's adjoint correction takes "
                          "phase 0's dynamics on every interval there")
    full_precision_matmul()
    nbx0 = form.con_0.nbx
    idxbx0 = list(form.con_0.idxbx)
    x0f = use_x0_elimination(form, opts)
    # the standard preparation's and the feedback's QPs take each
    # instance's tolerances from its NLP residuals under this strategy
    # (acados_tpu/ocp_nlp/rti.py:_qp_opts_at); AS-RTI's take qp_opts
    adaptive = opts.nlp_qp_tol_strategy == "ADAPTIVE_CURRENT_RES_JOINT"

    def _advance_data(data: NlpData, it: NlpIterate) -> NlpData:
        """Stage-0 state bounds at the predicted next x0
        (as_rti_advance_problem, ocp_nlp_sqp_rti.c:711-740)."""
        if opts.as_rti_advancement == "NONE" or nbx0 == 0:
            return data
        if opts.as_rti_advancement == "SHIFT":
            x0p = it.x[:, 1]
        else:
            x0p = form.step_fn(it.x[:, 0], it.u[:, 0], data.p[:, 0],
                               data.ts[:, 0], data.dts[:, 0])
        vals = x0p[:, idxbx0]
        lb_0, ub_0 = data.lb_0.clone(), data.ub_0.clone()
        lb_0[:, :nbx0] = vals
        ub_0[:, :nbx0] = vals
        return data.replace(lb_0=lb_0, ub_0=ub_0)

    def _inject_x0(qp: OcpQp, g0, data: NlpData) -> OcpQp:
        """Stage-0 rows' bounds from data (delta form)."""
        lg0 = torch.where(qp.mask_l[:, 0] > 0, data.lb_0 - g0, qp.lg[:, 0])
        ug0 = torch.where(qp.mask_u[:, 0] > 0, data.ub_0 - g0, qp.ug[:, 0])
        return qp.replace(lg=torch.cat([lg0[:, None], qp.lg[:, 1:]], 1),
                          ug=torch.cat([ug0[:, None], qp.ug[:, 1:]], 1))

    def _full_step(base: NlpIterate, sol: OcpQpSol):
        """(the iterate after a full step, the instances whose step went
        non-finite: they keep base)."""
        it_new = NlpIterate(
            x=base.x + sol.x, u=base.u + sol.u, pi=sol.pi,
            lam_l=sol.lam_lg, lam_u=sol.lam_ug, sl=sol.sl, su=sol.su)
        nan = ~torch.isfinite(_bsum(it_new.x) + _bsum(it_new.u))
        return select_fields(nan, base, it_new), nan

    def _refresh_vectors(qp0: OcpQp, it_lin: NlpIterate, data: NlpData,
                         it_i: NlpIterate, static_rows, level: str) -> OcpQp:
        """Inexact QP at it_i on qp0's stale matrices.

        B: gradient frozen at the linearization point with the Hessian
        correction q += H (w_i - w_lin) (ocp_nlp_zero_order_qp_update,
        ocp_nlp_common.c:3142-3190).
        C: the exact cost gradient at it_i plus the stale-Jacobian
        dynamics adjoint correction (J_true(it_i) - J_stale)' pi
        (ocp_nlp_level_c_update, ocp_nlp_common.c:3194-3265; inequality
        adjoints are left uncorrected, as in the reference).
        """
        b = eval_dyn_gap(form, data, it_i.x, it_i.u)
        g_all = eval_constraints(form, data, it_i.x, it_i.u)
        lb_all = _stack_stages(data.lb_0, data.lb, data.lb_e)
        ub_all = _stack_stages(data.ub_0, data.ub, data.ub_e)
        lg = torch.where(qp0.mask_l > 0, lb_all - g_all, -1.0)
        ug = torch.where(qp0.mask_u > 0, ub_all - g_all, 1.0)
        dx = it_i.x - it_lin.x
        du = it_i.u - it_lin.u
        if level == "B":
            # grad_x += Q dx + S' du (path only), grad_u += S dx + R du
            q = qp0.q + torch.einsum("zkij,zkj->zki", qp0.Q, dx)
            q = torch.cat([q[:, :-1] + torch.einsum("zkij,zki->zkj",
                                                    qp0.S, du),
                           q[:, -1:]], dim=1)
            r = (qp0.r + torch.einsum("zkij,zkj->zki", qp0.S, dx[:, :-1])
                 + torch.einsum("zkij,zkj->zki", qp0.R, du))
        else:  # "C"
            soft_scaled = static_rows["soft"] * static_rows["mask"]
            # instances are independent: the gradient of the batch's sum
            # is each instance's gradient
            q, r = grad(lambda x_, u_: eval_cost(
                form, data, x_, u_, it_i.sl, it_i.su, soft_scaled).sum(),
                argnums=(0, 1))(it_i.x, it_i.u)
            Bsz, N, nx = it_i.pi.shape
            _, pull = vjp(lambda x_, u_: form.step_fn(
                x_, u_, _flat2(data.p[:, :-1]), _flat2(data.ts[:, :-1]),
                _flat2(data.dts)), _flat2(it_i.x[:, :-1]), _flat2(it_i.u))
            jx_pi, ju_pi = pull(_flat2(it_i.pi))
            dt = it_i.x.dtype
            cq = jx_pi.to(dt).reshape(Bsz, N, nx) - _mTv(qp0.A, it_i.pi)
            cr = (ju_pi.to(dt).reshape(Bsz, N, -1)
                  - _mTv(qp0.B, it_i.pi))
            q = torch.cat([q[:, :-1] + cq, q[:, -1:]], dim=1)
            r = r + cr
        return qp0.replace(b=b, lg=lg, ug=ug, q=q, r=r)

    def _standard_prepare(data: NlpData, it: NlpIterate,
                          static_rows) -> RtiCache:
        lm = torch.tensor(opts.levenberg_marquardt, dtype=it.x.dtype,
                          device=it.x.device)
        qp = linearize(form, static_rows, data, it, lm)
        qp = regularize_qp(qp, opts.regularize_method, opts.reg_epsilon)
        # absolute stage-0 row values from the delta form: g = lb - lg on
        # rows with a lower side, ub - ug on upper-only rows
        g0 = torch.where(qp.mask_l[:, 0] > 0, data.lb_0 - qp.lg[:, 0],
                         torch.where(qp.mask_u[:, 0] > 0,
                                     data.ub_0 - qp.ug[:, 0], 0.0))
        # the QP at the predicted x0 (the bounds in data now): its
        # solution warm-starts the feedback IPM
        qp_opts = (adaptive_qp_tol(opts, opts.qp_opts,
                                   *_nlp_residuals(qp, it))
                   if adaptive else opts.qp_opts)
        sol_pred, _ = solve_ocp_qp(qp, qp_opts, x0_fixed=x0f)
        return RtiCache(qp=qp, g0=g0, it=it, sol_pred=sol_pred)

    def prepare(data: NlpData, it: NlpIterate,
                prev_cache: RtiCache | None = None) -> RtiCache:
        static_rows = build_static_rows(form, it.x.dtype, it.x.device)
        level = opts.as_rti_level
        if level != "STANDARD" and prev_cache is not None:
            data = _advance_data(data, it)
            if level == "A":
                # restore the preparation backup (tmp_nlp_out) and
                # re-solve the previous QP at the predicted x0
                qp_a = _inject_x0(prev_cache.qp, prev_cache.g0, data)
                sol, _ = solve_ocp_qp(qp_a, opts.qp_opts,
                                      warm=prev_cache.sol_pred,
                                      x0_fixed=x0f)
                it, _ = _full_step(prev_cache.it, sol)
            elif level in ("B", "C"):
                for _ in range(opts.as_rti_iter):
                    qp_i = _refresh_vectors(prev_cache.qp, prev_cache.it,
                                            data, it, static_rows, level)
                    sol, _ = solve_ocp_qp(qp_i, opts.qp_opts, x0_fixed=x0f)
                    it, _ = _full_step(it, sol)
            else:  # "D"
                lm = torch.tensor(opts.levenberg_marquardt,
                                  dtype=it.x.dtype, device=it.x.device)
                for _ in range(opts.as_rti_iter):
                    qp_i = regularize_qp(
                        linearize(form, static_rows, data, it, lm),
                        opts.regularize_method, opts.reg_epsilon)
                    sol, _ = solve_ocp_qp(qp_i, opts.qp_opts, x0_fixed=x0f)
                    it, _ = _full_step(it, sol)
        return _standard_prepare(data, it, static_rows)

    def feedback(cache: RtiCache, data: NlpData, it: NlpIterate):
        del it  # the step is taken from the preparation iterate
        x = cache.it.x
        dtype, dev, Bsz = x.dtype, x.device, x.shape[0]
        static_rows = build_static_rows(form, dtype, dev)
        soft_scaled = static_rows["soft"] * static_rows["mask"]
        # inject the current stage-0 bounds (fresh x0) into the delta rows
        qp = _inject_x0(cache.qp, cache.g0, data)
        rs, re, ri, rc = _nlp_residuals(qp, cache.it)
        qp_opts = (adaptive_qp_tol(opts, opts.qp_opts, rs, re, ri, rc)
                   if adaptive else opts.qp_opts)
        sol, info = solve_ocp_qp(qp, qp_opts, warm=cache.sol_pred,
                                 x0_fixed=x0f)
        qp_fatal = info.status == 1
        it_new, nan = _full_step(cache.it, sol)
        status = torch.where(nan, 1, torch.where(qp_fatal, 4, 0)).to(
            torch.int32)
        stat = torch.zeros((Bsz, opts.max_iter + 1, 8), dtype=dtype,
                           device=dev)
        for col, v in enumerate((rs, re, ri, rc, info.status.to(dtype),
                                 info.num_iter.to(dtype))):
            stat[:, 0, col] = v
        stat[:, 0, 6] = 1.0
        cost = eval_cost(form, data, it_new.x, it_new.u, it_new.sl,
                         it_new.su, soft_scaled)
        stats = SqpStats(status=status,
                         sqp_iter=torch.ones(Bsz, dtype=torch.int32,
                                             device=dev),
                         qp_iter_total=info.num_iter, res_stat=rs,
                         res_eq=re, res_ineq=ri, res_comp=rc, stat=stat,
                         cost=cost)
        return it_new, stats

    return prepare, feedback
