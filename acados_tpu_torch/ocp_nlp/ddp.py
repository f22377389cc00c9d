"""DDP: differential dynamic programming for unconstrained OCPs,
batch-first.

Counterpart of `acados_tpu/ocp_nlp/ddp.py` (the reference's
ocp_nlp_ddp.c): each iteration linearizes cost and dynamics at the
current trajectory, takes the affine policy du = K dx + alpha k from one
Riccati factorization and backward sweep, and rolls the *nonlinear*
dynamics forward under it,
u_k = u_bar_k + alpha k_k + K_k (x_k - x_bar_k), x_{k+1} = f(x_k, u_k),
backtracking on the cost. After the first rollout the iterates are
dynamically feasible, so the merit is the objective itself. An
infeasible initial guess takes the first rollout at alpha = 1
(ocp_nlp_ddp.c:788-795). Multipliers come from the costate identity
pi_k = P_{k+1} dx_{k+1} + p_{k+1}.

The JAX package vmaps one `lax.while_loop` per instance; here the batch
runs in lockstep and an instance that has stopped is frozen, as in
`sqp.py`. The backtracking is lockstep too: each trial alpha is one
rollout of the whole batch (a loop over the N stages calling the
batch-first step on (B, nx)), and an instance that has accepted keeps
its alpha. The reference rolls out once more at the accepted alpha; the
port keeps each instance's trajectory from the trial it accepted (the
same computation on the same inputs, so the same bits) and rolls out
again only where an instance left the backtracking under alpha_min
without accepting. Instances whose first step is forced to alpha = 1
take no backtracking (the reference's is overridden). Instances that
converged in the round take none either and keep their iterate, as in
the reference; their row of the stat table differs from the
reference's in the alpha and step-norm columns (6, 7): the port writes
alpha = 1 and the alpha = 1 trial's step norm, where the reference
writes the alpha its line search found and that rollout's step norm.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.ocp_nlp.formulation import NlpData, OcpNlpFormulation
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate,
                                                build_static_rows, eval_cost,
                                                linearize, refuse_multiphase)
from acados_tpu_torch.ocp_nlp.regularize import regularize_qp
from acados_tpu_torch.ocp_nlp.sqp import (STAT_COLS, SqpOpts, SqpStats,
                                          _nlp_residuals, _set_at)
from acados_tpu_torch.ocp_qp.ipm import _bc, _bmax, _bsum
from acados_tpu_torch.ocp_qp.riccati import (_mv, riccati_backward,
                                             riccati_factor)
from acados_tpu_torch.utils.device import full_precision_matmul, wait_any
from acados_tpu_torch.utils.struct import select_fields, where_batch


def rollout(form: OcpNlpFormulation, data: NlpData, x0, u_bar, x_bar, K,
            kff, alpha):
    """Nonlinear forward sweep of every instance under the affine policy,
    from x0 (B, nx) at step length alpha (B,): returns (x (B, N+1, nx),
    u (B, N, nu))."""
    a = alpha[:, None]
    xs, us = [x0], []
    xk = x0
    for k in range(form.N):
        uk = u_bar[:, k] + a * kff[:, k] + _mv(K[:, k], xk - x_bar[:, k])
        xk = form.step_fn(xk, uk, data.p[:, k], data.ts[:, k],
                          data.dts[:, k])
        xs.append(xk)
        us.append(uk)
    return torch.stack(xs, 1), torch.stack(us, 1)


def make_ddp_solver(form: OcpNlpFormulation, opts: SqpOpts):
    """Build the batch-first DDP solve function.

    solve(data: NlpData, init: NlpIterate) -> (NlpIterate, SqpStats),
    every tensor leading with the batch axis; init.u seeds the first
    forward simulation (ocp_nlp_ddp_precompute, ocp_nlp_ddp.c:865).
    """
    refuse_multiphase(form, "DDP")
    if form.con.nrows > 0 or form.con_e.nrows > 0:
        raise ValueError(
            "DDP supports unconstrained OCPs only (initial-state constraint"
            " aside); reformulate constraints via penalties "
            "(reference: ocp_nlp_ddp + penalty_utils)")
    if form.con_0.nbx != form.nx or (form.con_0.nbu or form.con_0.ng
                                     or form.con_0.nh or form.con_0.nphi):
        raise ValueError("DDP needs exactly a full initial-state constraint"
                         " at stage 0 (lbx_0 == ubx_0)")
    full_precision_matmul()
    nx = form.nx
    idxbx0 = list(form.con_0.idxbx)

    def solve(data: NlpData, init: NlpIterate):
        dtype, dev = init.x.dtype, init.x.device
        Bsz = init.x.shape[0]
        static_rows = build_static_rows(form, dtype, dev)
        soft_scaled = static_rows["soft"] * static_rows["mask"]
        lm = torch.tensor(opts.levenberg_marquardt, dtype=dtype, device=dev)
        # the target initial state from the stage-0 bound rows
        x0_tgt = torch.zeros((Bsz, nx), dtype=dtype, device=dev)
        x0_tgt[:, idxbx0] = 0.5 * (data.lb_0[:, :nx] + data.ub_0[:, :nx])

        # feasible initialization: init.u simulated from the target x0
        # (ocp_nlp_ddp.c:865; a rollout without feedback), kept where it
        # stayed finite
        nu = form.nu
        x_init, _ = rollout(form, data, x0_tgt, init.u, init.x,
                            init.x.new_zeros((Bsz, form.N, nu, nx)),
                            init.u.new_zeros((Bsz, form.N, nu)),
                            init.x.new_zeros((Bsz,)))
        finite = torch.isfinite(x_init).reshape(Bsz, -1).all(dim=1)
        it = init.replace(x=where_batch(finite, x_init, init.x))

        k = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        status = torch.full((Bsz,), 2, dtype=torch.int32, device=dev)
        done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        first = torch.ones(Bsz, dtype=torch.bool, device=dev)
        qp_tot = torch.zeros(Bsz, dtype=torch.int32, device=dev)
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
            # ri covers the initial-state rows, the only inequality rows
            # DDP admits
            converged = ((rs < opts.tol_stat) & (re < opts.tol_eq)
                         & (ri < opts.tol_ineq))

            qp = regularize_qp(qp, opts.regularize_method, opts.reg_epsilon)
            fact = riccati_factor(qp.Q, qp.R, qp.S, qp.A, qp.B,
                                  reg_eps=opts.qp_opts.reg_eps,
                                  factor_p0=False)
            kff, p = riccati_backward(fact, qp.A, qp.B, qp.q, qp.r, qp.b)

            def try_alpha(alpha):
                x0 = it.x[:, 0] + _bc(alpha, it.x[:, 0]) * (x0_tgt
                                                             - it.x[:, 0])
                return rollout(form, data, x0, it.u, it.x, fact.K, kff,
                               alpha)

            # an infeasible initial guess takes its first rollout at
            # alpha = 1 (ocp_nlp_ddp.c:788); converged instances keep
            # their iterate, so neither backtracks
            infeas = (re > opts.tol_eq) | (ri > opts.tol_ineq)
            steps = active & ~converged
            search = steps & ~(first & infeas)
            if opts.globalization == "FIXED_STEP":
                search = torch.zeros_like(search)
            alpha = torch.ones(Bsz, dtype=dtype, device=dev)
            accepted = steps & ~search
            x_new, u_new = it.x, it.u
            if wait_any(steps):
                # the first trial is alpha = 1 for every instance
                x_t, u_t = try_alpha(alpha)
                x_new, u_new = x_t, u_t
                if wait_any(search):
                    cost0 = eval_cost(form, data, it.x, it.u, it.sl, it.su,
                                      soft_scaled)
                    while True:
                        run = search & ~accepted & (alpha > opts.alpha_min)
                        if not wait_any(run):
                            break
                        if x_t is None:
                            x_t, u_t = try_alpha(alpha)
                        c_t = eval_cost(form, data, x_t, u_t, it.sl, it.su,
                                        soft_scaled)
                        ok = run & (c_t < cost0)
                        x_new = where_batch(ok, x_t, x_new)
                        u_new = where_batch(ok, u_t, u_new)
                        alpha = torch.where(run & ~ok,
                                            alpha * opts.alpha_reduction,
                                            alpha)
                        accepted = accepted | ok
                        x_t = None
                    # left under alpha_min without accepting: the rollout
                    # at the alpha the loop ended at
                    below = search & ~accepted
                    if wait_any(below):
                        x_t, u_t = try_alpha(alpha)
                        x_new = where_batch(below, x_t, x_new)
                        u_new = where_batch(below, u_t, u_new)

            # multipliers from the costate identity at the linear step
            dx_new = x_new - it.x
            pi_new = (fact.P[:, 1:] @ dx_new[:, 1:, :, None])[..., 0] \
                + p[:, 1:]
            # the initial-state multiplier is the value function's
            # gradient dV/dx0 = P_0 dx_0 + p_0
            lam0 = (_mv(fact.P[:, 0], dx_new[:, 0]) + p[:, 0])[:, idxbx0]
            lam_l_new, lam_u_new = it.lam_l.clone(), it.lam_u.clone()
            lam_l_new[:, 0, :nx] = torch.clamp(lam0, min=0.0)
            lam_u_new[:, 0, :nx] = torch.clamp(-lam0, min=0.0)

            step_norm = torch.maximum(_bmax(dx_new.abs()),
                                      _bmax((u_new - it.u).abs()))
            _set_at(stat_new, k, 4, torch.zeros_like(alpha))
            _set_at(stat_new, k, 5, torch.ones_like(alpha))
            _set_at(stat_new, k, 6, alpha)
            _set_at(stat_new, k, 7, step_norm)

            it_new = NlpIterate(x=x_new, u=u_new, pi=pi_new,
                                lam_l=lam_l_new, lam_u=lam_u_new,
                                sl=it.sl, su=it.su)
            nan = ~torch.isfinite(_bsum(it_new.x) + _bsum(it_new.u))
            it_new = select_fields(nan | converged, it, it_new)
            small_step = step_norm < opts.tol_min_step_norm
            new_status = torch.where(
                converged, 0,
                torch.where(nan, 1, torch.where(small_step, 3, status)))
            done_new = converged | nan | small_step
            k_new = torch.where(converged, k, k + 1)

            # lockstep freeze of the instances that had stopped
            it = select_fields(active, it_new, it)
            k = torch.where(active, k_new, k)
            status = torch.where(active, new_status, status).to(torch.int32)
            done = torch.where(active, done_new, done)
            qp_tot = torch.where(active, qp_tot + 1, qp_tot)
            stat = where_batch(active, stat_new, stat)
            first = first & ~active

        qp = linearize(form, static_rows, data, it, lm)
        rs, re, ri, rc = _nlp_residuals(qp, it)
        for col, v in enumerate((rs, re, ri, rc)):
            _set_at(stat, k, col, v)
        converged = ((rs < opts.tol_stat) & (re < opts.tol_eq)
                     & (ri < opts.tol_ineq))
        status = torch.where(converged, 0, status).to(torch.int32)
        cost = eval_cost(form, data, it.x, it.u, it.sl, it.su, soft_scaled)
        stats = SqpStats(status=status, sqp_iter=k, qp_iter_total=qp_tot,
                         res_stat=rs, res_eq=re, res_ineq=ri, res_comp=rc,
                         stat=stat, cost=cost)
        return it, stats

    return solve
