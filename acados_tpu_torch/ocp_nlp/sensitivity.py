"""Parametric solution sensitivities of the NLP solution (differentiable
MPC), batch-first.

Counterpart of `acados_tpu/ocp_nlp/sensitivity.py` (the reference's
ocp_nlp_common_eval_param_sens, eval_solution_sens_adj_p and the HPIPM
seeds behind AcadosOcpSolver.eval_solution_sensitivity /
eval_adjoint_solution_sensitivity / eval_param_sens). The method is the
same: the implicit function theorem on the barrier-smoothed KKT system at
the solved point, whose (lam, t) rows are eliminated into the symmetric
reduced KKT matrix H_bar = H_lagr + J' W J over (x, u, pi), factored by
one Riccati factorization (`riccati_factor` with a free initial state,
so P_0 is factored too: above nx = 12 that is `chol_any`, the kernel K2
on the card). Forward sensitivities push the data tangents
(torch.func.jvp) through the elimination; the adjoint solves the same
system and pulls back with one torch.func.vjp of the residual functions,
so every NlpData field is differentiable at once.

Every function takes the batch as the leading axis of every tensor; the
JAX package's functions take one instance and are vmapped. Exactness
requires the exact Lagrangian Hessian: `lagrangian_hessian` takes
`torch.func.hessian` of each stage's Lagrangian, vmapped over the
stages, through the integrator (the IRK step's implicit gradient) and
through the kernels' forward-mode rules.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import hessian, vmap

from acados_tpu_torch.ocp_nlp.formulation import (NlpData, OcpNlpFormulation,
                                                  cost_data_stage0,
                                                  cost_data_term)
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate, _flat2,
                                                _stack_stages,
                                                build_static_rows,
                                                eval_constraints, eval_cost,
                                                eval_dyn_gap, linearize,
                                                refuse_multiphase, step_one)
from acados_tpu_torch.ocp_qp.riccati import (_mTv, _mv, riccati_factor,
                                             riccati_solve)
from acados_tpu_torch.utils.struct import (jvp_fields, map_fields,
                                           vjp_fields)
from acados_tpu_torch.utils.types import ACADOS_INFTY


@dataclasses.dataclass(frozen=True)
class SensOpts:
    """t_lam_min mirrors the reference's solution_sens_qp_t_lam_min
    (ocp_nlp_common.h:337): slack/multiplier floor for the smoothed
    active-set weights."""

    t_lam_min: float = 1e-9
    reg_eps: float = 1e-11


# ---------------------------------------------------------------------------
# Exact Lagrangian Hessian (stage-separable)
# ---------------------------------------------------------------------------

def lagrangian_hessian(form: OcpNlpFormulation, data: NlpData,
                       it: NlpIterate) -> torch.Tensor:
    """Stage-blocked exact Hessian of the Lagrangian over w_k = (x_k, u_k),
    (B, N+1, nx+nu, nx+nu):

    L_k = scale_k cost_k(x, u) + pi_k' step_k(x, u)  (k < N)
          - (lam_l,k - lam_u,k)' g_k(x, u)

    The cross-stage terms pi_k' x_{k+1} are linear, so the Hessian is
    block-diagonal; the terminal block's u-part is zero. One
    `torch.func.hessian` of the per-instance stage Lagrangian, vmapped
    over the B (N - 1) path stages (stage 0 and the terminal stage over
    B each): the step is the batch-first one, called on a batch of one
    under the vmap, whose Functions fold the vmap back into one batch.
    """
    N, nx, nu = form.N, form.nx, form.nu
    Bsz = it.x.shape[0]
    lam_d = it.lam_l - it.lam_u

    def stage_hessian(cost_spec, con_spec, with_dyn):
        def f(w, pk, tk, dtk, scale, cdata, pi_k, lam_k):
            xk, uk = w[:nx], w[nx:]
            val = scale * cost_spec.value(xk, uk, pk, tk, cdata)
            if with_dyn:
                val = val + pi_k @ step_one(form, xk, uk, pk, tk, dtk)
            g = con_spec.eval_rows(xk, uk, pk, tk)
            if g.shape[0]:
                val = val - lam_k[:g.shape[0]] @ g
            return val

        return vmap(hessian(f))

    w0 = torch.cat([it.x[:, 0], it.u[:, 0]], dim=-1)
    H0 = stage_hessian(form.cost_0, form.con_0, True)(
        w0, data.p[:, 0], data.ts[:, 0], data.dts[:, 0],
        data.cost_scale[:, 0], cost_data_stage0(data), it.pi[:, 0],
        lam_d[:, 0])
    K = N - 1
    wp = torch.cat([it.x[:, 1:N], it.u[:, 1:N]], dim=-1)
    Hp = stage_hessian(form.cost, form.con, True)(
        _flat2(wp), _flat2(data.p[:, 1:N]), _flat2(data.ts[:, 1:N]),
        _flat2(data.dts[:, 1:N]), _flat2(data.cost_scale[:, 1:N]),
        {"yref": _flat2(data.yref), "W": _flat2(data.W)},
        _flat2(it.pi[:, 1:N]), _flat2(lam_d[:, 1:N]))
    Hp = Hp.reshape((Bsz, K) + tuple(Hp.shape[1:]))
    wN = torch.cat([it.x[:, N], it.x.new_zeros((Bsz, nu))], dim=-1)
    HN = stage_hessian(form.cost_e, form.con_e, False)(
        wN, data.p[:, N], data.ts[:, N], data.dts[:, N - 1],
        data.cost_scale[:, N], cost_data_term(data),
        it.x.new_zeros((Bsz, nx)), lam_d[:, N])
    return torch.cat([H0[:, None], Hp, HN[:, None]], dim=1)


# ---------------------------------------------------------------------------
# Residual functions of the smoothed KKT system (for jvp/vjp wrt data)
# ---------------------------------------------------------------------------

def _primal_residuals(form, static_rows, data: NlpData, it: NlpIterate):
    """F1: stationarity rows over (x, u) and the dynamics rows at fixed
    multipliers, from the QP linearization at the iterate (first
    derivatives only: d(F1)/d(theta) is exact because linearize itself is
    differentiated)."""
    qp = linearize(form, static_rows, data, it,
                   torch.zeros((), dtype=it.x.dtype, device=it.x.device))
    lam_d = qp.mask_l * it.lam_l - qp.mask_u * it.lam_u
    zx = torch.zeros_like(it.x[:, :1])
    rx = (qp.q - _mTv(qp.C, lam_d)
          + torch.cat([_mTv(qp.A, it.pi), zx], dim=1)
          - torch.cat([zx, it.pi], dim=1))
    ru = qp.r + _mTv(qp.B, it.pi) - _mTv(qp.D, lam_d[:, :-1])
    r_dyn = qp.b  # step(x, u) - x_next
    # soft-slack stationarity rows: zl + Zl sl - lam_l - lam_sl (lam_sl an
    # eliminated unknown; theta enters through Zl/zl)
    r_sl = qp.zl + qp.Zl * it.sl - it.lam_l
    r_su = qp.zu + qp.Zu * it.su - it.lam_u
    return rx, ru, r_dyn, r_sl, r_su


def _ineq_values(form, data: NlpData, it: NlpIterate):
    """F2, the theta-dependent part of the inequality rows:
    g(x, u; p) - bounds."""
    g = eval_constraints(form, data, it.x, it.u)
    r_l = g - _stack_stages(data.lb_0, data.lb, data.lb_e)
    r_u = _stack_stages(data.ub_0, data.ub, data.ub_e) - g
    return r_l, r_u


# ---------------------------------------------------------------------------
# The factorized smoothed-KKT solver
# ---------------------------------------------------------------------------

def _refuse_z(form, what: str) -> None:
    """lagrangian_hessian evaluates the cost and h rows without the
    algebraic states, as the JAX package's does (acados_tpu/ocp_nlp/
    sensitivity.py:84): a DAE whose cost or h rows read z would lose its
    z terms or fail on a shape, and the parameter gradient has no
    reference that reads z to be held to. Both refuse a DAE, and a
    multiphase OCP, whose single-phase stage classes they read."""
    refuse_multiphase(form, what)
    if form.nz > 0:
        raise NotImplementedError(
            f"{what} of a DAE (nz = {form.nz}) are not supported "
            "(ROADMAP.md, Queue 3: gaps in the JAX package)")


class KktFactor:
    """Riccati-factorized reduced KKT system at the solution of every
    instance, plus the row weights the elimination and reconstruction
    need."""

    def __init__(self, form, opts: SensOpts, data: NlpData,
                 it: NlpIterate):
        refuse_multiphase(form, "solution sensitivities")
        if form.cost_0.needs_dt or form.cost.needs_dt:
            # the JAX package's Lagrangian Hessian evaluates the cost
            # without the interval length an integrated cost takes
            # (acados_tpu/ocp_nlp/sensitivity.py:85), so it has no
            # reference to hold this path to
            raise NotImplementedError(
                "solution sensitivities with cost_discretization "
                "INTEGRATOR are not supported (ROADMAP.md, Queue 3: gaps "
                "in the JAX package)")
        _refuse_z(form, "solution sensitivities")
        dt, dev = it.x.dtype, it.x.device
        static_rows = build_static_rows(form, dt, dev)
        self.form, self.data, self.it = form, data, it
        self.static_rows = static_rows
        qp = linearize(form, static_rows, data, it,
                       torch.zeros((), dtype=dt, device=dev))
        self.qp = qp
        tmin = torch.tensor(opts.t_lam_min, dtype=dt, device=dev)

        r_l, r_u = _ineq_values(form, data, it)
        soft = static_rows["soft"]
        t_l = torch.maximum(r_l + soft * it.sl, tmin)
        t_u = torch.maximum(r_u + soft * it.su, tmin)
        lam_l = torch.maximum(it.lam_l, tmin)
        lam_u = torch.maximum(it.lam_u, tmin)
        ml, mu_ = qp.mask_l, qp.mask_u
        self.ml, self.mu_ = ml, mu_
        sml, smu = soft * ml, soft * mu_
        self.sml, self.smu = sml, smu
        self.t_l, self.t_u = t_l, t_u
        self.lam_l, self.lam_u = lam_l, lam_u

        wl = lam_l / t_l
        wu = lam_u / t_u
        # soft slacks: the smoothed pairing lam_sl sl = mu, w_sl = lam_sl/sl
        # with lam_sl from slack stationarity (>= 0 at the solution)
        sl_c = torch.maximum(it.sl, tmin)
        su_c = torch.maximum(it.su, tmin)
        lam_sl = torch.maximum(qp.zl + qp.Zl * it.sl - lam_l, tmin)
        lam_su = torch.maximum(qp.zu + qp.Zu * it.su - lam_u, tmin)
        wsl = lam_sl / sl_c
        wsu = lam_su / su_c
        self.denom_l = qp.Zl + wl + wsl
        self.denom_u = qp.Zu + wu + wsu
        self.wl, self.wu = wl, wu
        W_l = torch.where(sml > 0, wl * (qp.Zl + wsl) / self.denom_l, wl)
        W_u = torch.where(smu > 0, wu * (qp.Zu + wsu) / self.denom_u, wu)
        self.W = ml * W_l + mu_ * W_u

        # exact Lagrangian Hessian + barrier rows
        nx = form.nx
        H = lagrangian_hessian(form, data, it)
        CT, DT = qp.C.transpose(-1, -2), qp.D.transpose(-1, -2)
        WC = self.W[..., None] * qp.C
        Qb = H[:, :, :nx, :nx] + CT @ WC
        Rb = H[:, :-1, nx:, nx:] + DT @ (self.W[:, :-1, :, None] * qp.D)
        Sb = H[:, :-1, nx:, :nx] + DT @ WC[:, :-1]
        self.fact = riccati_factor(Qb, Rb, Sb, qp.A, qp.B,
                                   reg_eps=opts.reg_eps)

    def solve_reduced(self, rx, ru, rb):
        """Solve the symmetric reduced system K [dx; du; dpi] =
        -[rx; ru; rb]."""
        return riccati_solve(self.fact, self.qp.A, self.qp.B, rx, ru, rb)

    def row_gap(self, dx, du):
        dg = _mv(self.qp.C, dx)
        return torch.cat([dg[:, :-1] + _mv(self.qp.D, du), dg[:, -1:]],
                         dim=1)


def forward_sensitivity(kf: KktFactor, d_data: NlpData):
    """d(solution)/d(theta) of every instance in the direction d_data, an
    NlpData tangent whose None fields are zero (and not differentiated).
    The NLP counterpart of d_ocp_qp_ipm_sens_frw (ocp_qp_hpipm.c:489) by
    the implicit function theorem; returns (dx, du, dpi, dlam_l,
    dlam_u)."""
    form, data, it = kf.form, kf.data, kf.it
    _, (rx, ru, rdyn, rsl, rsu) = jvp_fields(
        lambda d: _primal_residuals(form, kf.static_rows, d, it), data,
        d_data)
    _, (dr_l, dr_u) = jvp_fields(lambda d: _ineq_values(form, d, it), data,
                                 d_data)

    ml, mu_, sml, smu = kf.ml, kf.mu_, kf.sml, kf.smu
    # eliminate (dlam, dt, dslack-duals): the comp rows' tangent is
    # lam dt + t dlam = 0, the ineq rows' dr + J dw + dsl - dt = 0; a_* in
    # the IPM's row-residual convention (ipm._newton_step), where the
    # upper row residual is -(ub - g), so dr_u flips
    a_l = -kf.wl * dr_l
    a_u = -kf.wu * dr_u
    c_l = -rsl
    c_u = -rsu
    gamma_l = torch.where(sml > 0, a_l - kf.wl * (a_l + c_l) / kf.denom_l,
                          a_l)
    gamma_u = torch.where(smu > 0, a_u - kf.wu * (a_u + c_u) / kf.denom_u,
                          a_u)
    gamma = ml * gamma_l - mu_ * gamma_u
    qb = rx - _mTv(kf.qp.C, gamma)
    rb = ru - _mTv(kf.qp.D, gamma[:, :-1])
    dx, du, dpi = kf.solve_reduced(qb, rb, rdyn)
    dg = kf.row_gap(dx, du)
    dsl = sml * (a_l + c_l - kf.wl * dg) / kf.denom_l
    dsu = smu * (a_u + c_u + kf.wu * dg) / kf.denom_u
    dt_l = ml * (dr_l + dg + dsl)
    dt_u = mu_ * (dr_u - dg + dsu)
    dlam_l = -ml * kf.wl * dt_l
    dlam_u = -mu_ * kf.wu * dt_u
    return dx, du, dpi, dlam_l, dlam_u


def adjoint_sensitivity(kf: KktFactor, seed_x, seed_u) -> NlpData:
    """Gradient of seed_x' x*(theta) + seed_u' u*(theta) of every instance
    with respect to every NlpData field (eval_solution_sens_adj_p,
    ocp_nlp_common.c:4108, generalized to every field). seed_x
    (B, N+1, nx), seed_u (B, N, nu); returns an NlpData of gradients."""
    form, data, it = kf.form, kf.data, kf.it
    # symmetric solve with the seed in the primal slots: solve_reduced
    # returns -K^-1 [input], so pass -seed to get z1 = K^-1 seed
    z_x, z_u, z_pi = kf.solve_reduced(-seed_x, -seed_u,
                                      torch.zeros_like(it.pi))
    # cotangents of the eliminated rows: c_lam = (A12' z1)_lam, then
    # z_comp = -c_lam / t, z_ineq = -W c_lam per side
    zg = kf.row_gap(z_x, z_u)
    ml, mu_, sml, smu = kf.ml, kf.mu_, kf.sml, kf.smu
    # the soft slacks' primal cotangents: K_red's (xu, sl) cross block is
    # +w_l J' (lower) / -w_u J' (upper) with diagonal sl block denom_l/u
    zsl = -sml * (kf.wl * zg) / kf.denom_l
    zsu = smu * (kf.wu * zg) / kf.denom_u
    c_lam_l = -ml * zg - sml * zsl
    c_lam_u = mu_ * zg - smu * zsu
    z_ineq_l = -kf.wl * c_lam_l * ml
    z_ineq_u = -kf.wu * c_lam_u * mu_
    # pull back through the theta-dependence of F1 and F2
    g1 = vjp_fields(lambda d: _primal_residuals(form, kf.static_rows, d,
                                                it), data,
                    (z_x, z_u, z_pi, zsl, zsu))
    g2 = vjp_fields(lambda d: _ineq_values(form, d, it), data,
                    (z_ineq_l, z_ineq_u))
    return map_fields(lambda a, b: -(a + b), g1, g2)


# ---------------------------------------------------------------------------
# Differentiable solver (autograd through the solve)
# ---------------------------------------------------------------------------

_DATA = [f.name for f in dataclasses.fields(NlpData)]
_ITER = [f.name for f in dataclasses.fields(NlpIterate)]


def make_diff_solver(form: OcpNlpFormulation, opts, sens_opts=None):
    """Build solve_diff(data, init) -> (x, u), batch-first, a
    `torch.autograd.Function` whose forward is the SQP solve and whose
    backward is one Riccati-factored adjoint IFT solve (KktFactor, then
    adjoint_sensitivity) instead of a differentiation of the SQP
    iterations: the counterpart of the JAX package's custom_vjp
    (acados_tpu/ocp_nlp/sensitivity.py:288-326). Every NlpData field gets
    its gradient; the warm start gets zero (the solution does not depend
    on it at convergence)."""
    from acados_tpu_torch.ocp_nlp.sqp import make_sqp_solver

    refuse_multiphase(form, "the differentiable solver")
    sens_opts = sens_opts or SensOpts()
    solve = make_sqp_solver(form, opts)
    nd = len(_DATA)

    class diff_solve(torch.autograd.Function):
        @staticmethod
        def forward(*args):
            data = NlpData(**dict(zip(_DATA, args[:nd])))
            init = NlpIterate(**dict(zip(_ITER, args[nd:])))
            it, _ = solve(data, init)
            return tuple(getattr(it, n) for n in _ITER)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.mark_non_differentiable(*output[2:])
            ctx.save_for_backward(*inputs[:nd], *output)
            ctx.init_like = [(a.shape, a.dtype, a.device)
                             for a in inputs[nd:]]

        @staticmethod
        def backward(ctx, ct_x, ct_u, *_):
            saved = ctx.saved_tensors
            data = NlpData(**dict(zip(_DATA, saved[:nd])))
            it = NlpIterate(**dict(zip(_ITER, saved[nd:])))
            ct_x = torch.zeros_like(it.x) if ct_x is None else ct_x
            ct_u = torch.zeros_like(it.u) if ct_u is None else ct_u
            kf = KktFactor(form, sens_opts, data, it)
            grad = adjoint_sensitivity(kf, ct_x, ct_u)
            return (*(getattr(grad, n) for n in _DATA),
                    *(torch.zeros(s, dtype=d, device=v)
                      for s, d, v in ctx.init_like))

    def solve_diff(data: NlpData, init: NlpIterate):
        out = diff_solve.apply(*(getattr(data, n) for n in _DATA),
                               *(getattr(init, n) for n in _ITER))
        return out[0], out[1]

    return solve_diff


# ---------------------------------------------------------------------------
# Optimal-value gradient (envelope theorem)
# ---------------------------------------------------------------------------

def eval_lagrange_grad_p(form: OcpNlpFormulation, data: NlpData,
                         it: NlpIterate) -> torch.Tensor:
    """Gradient of the Lagrangian with respect to the stage parameters at
    the fixed primal-dual point of every instance, (B, N+1, np): by the
    envelope theorem the optimal-value gradient dV/dp at a converged KKT
    point (reference eval_lagr_grad_p, ocp_nlp_common.c:4181). Sum over
    the stages for a global parameter."""
    _refuse_z(form, "optimal-value gradients")
    dt, dev = it.x.dtype, it.x.device
    static_rows = build_static_rows(form, dt, dev)
    soft_scaled = static_rows["soft"] * static_rows["mask"]
    lb_all = _stack_stages(data.lb_0, data.lb, data.lb_e)
    ub_all = _stack_stages(data.ub_0, data.ub, data.ub_e)
    thr = 0.5 * ACADOS_INFTY
    ml = static_rows["mask"] * (lb_all > -thr)
    mu_ = static_rows["mask"] * (ub_all < thr)
    lam_d = ml * it.lam_l - mu_ * it.lam_u

    def lagr(p_all):
        # L = f + pi'(phi - x+) - lam_l'(g - lb) - lam_u'(ub - g), summed
        # over the batch (the instances are independent)
        d = data.replace(p=p_all)
        cost = eval_cost(form, d, it.x, it.u, it.sl, it.su, soft_scaled)
        gap = eval_dyn_gap(form, d, it.x, it.u)
        g = eval_constraints(form, d, it.x, it.u)
        return cost.sum() + (it.pi * gap).sum() - (lam_d * g).sum()

    return torch.func.grad(lagr)(data.p)


def optimal_value_grad_x0(form: OcpNlpFormulation, data: NlpData,
                          it: NlpIterate) -> torch.Tensor:
    """dV/dx0 of every instance, (B, nbx0): the multipliers of the
    initial-state equality rows (reference
    eval_and_get_optimal_value_gradient with
    with_respect_to='initial_state'). Requires idxbx_0 == full state."""
    del data
    nbx0 = len(form.con_0.idxbx)
    return it.lam_l[:, 0, :nbx0] - it.lam_u[:, 0, :nbx0]
