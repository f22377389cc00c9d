"""Per-iteration QP approximation of the NLP (the SQP hot path),
batch-first.

Counterpart of `acados_tpu/ocp_nlp/linearize.py` on its `step_jac_fn`
branch (:115-124): the dynamics Jacobians of all B*N intervals come from
one call of the batch-first fused integrator step (where the IRK stage
inverses run as one batch), the cost quadratics and constraint rows from
per-instance module functions under `torch.func.vmap`. The result is the
delta-form OcpQp consumed by the Riccati IPM.

With the exact Hessian (:198-252) the pi-weighted dynamics Hessian of
all B*N intervals is one `torch.func.hessian` of the per-interval step,
vmapped (the IRK step's stage solves and implicit gradient fold the vmap
back into one batch, so each of their K1 launches serves every
interval), and the lam-weighted h Hessian one vmap per stage class.
BGP rows add their outer curvature Jr' phi'' Jr in both Hessian modes
(:173-197), and an integrated cost (cost_discretization INTEGRATOR)
takes its interval's length.

A DAE whose cost or h rows read z (form.nz > 0) takes the `use_z` branch
(:104-140): the fused step also returns z at each interval start and
dz/d(x, u), and the stage-0 and path modules see z through the affine
model z0 + Jz (w - w_k), so AD of the composition gives the reference's
dzduxt chain rule; the merit and residual evaluations re-solve z(t0)
exactly through form.z_fun (:315-330).

A multiphase formulation (ocp_nlp/multiphase.py) takes its own
functions at the JAX package's `_is_mp` hooks (:51-66, 95-97, 335-337,
363-365, 402-404): `is_multiphase` dispatches build_static_rows,
linearize and the three evaluations, so the SQP loops are
phase-agnostic.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from acados_tpu_torch.ocp_nlp.formulation import (NlpData, OcpNlpFormulation,
                                                  cost_data_stage0,
                                                  cost_data_term)
from acados_tpu_torch.ocp_qp.data import OcpQp
from acados_tpu_torch.utils.autodiff import hessian
from acados_tpu_torch.utils.struct import tensor_dataclass
from acados_tpu_torch.utils.types import ACADOS_INFTY


@tensor_dataclass
class NlpIterate:
    """Primal-dual NLP iterate, batch-first (reference iterate fields x,
    u, pi, lam, sl, su; lam split by bound side)."""

    x: torch.Tensor      # (B, N+1, nx)
    u: torch.Tensor      # (B, N, nu)
    pi: torch.Tensor     # (B, N, nx)
    lam_l: torch.Tensor  # (B, N+1, nc)
    lam_u: torch.Tensor  # (B, N+1, nc)
    sl: torch.Tensor     # (B, N+1, nc)
    su: torch.Tensor     # (B, N+1, nc)


def _pad_rows(arr, nc, dim=-1):
    """Pad a per-class row-block array up to the unified nc rows."""
    pad = nc - arr.shape[dim]
    if pad <= 0:
        return arr
    shape = list(arr.shape)
    shape[dim] = pad
    return torch.cat([arr, arr.new_zeros(shape)], dim=dim)


def _flat2(t):
    """(B, K, ...) -> (B*K, ...)."""
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def _path_vmap(fn, B, K, *args):
    """Apply a per-instance fn over the (B, K) leading axes of every
    argument (tensors or dicts of tensors); outputs come back (B, K, ...).
    """
    flat = [({k: _flat2(v) for k, v in a.items()} if isinstance(a, dict)
             else _flat2(a)) for a in args]
    out = vmap(fn)(*flat)
    unflat = lambda o: o.reshape((B, K) + tuple(o.shape[1:]))
    if isinstance(out, tuple):
        return tuple(unflat(o) for o in out)
    return unflat(out)


def is_multiphase(form) -> bool:
    """A multiphase formulation carries `segments` (acados_tpu/ocp_nlp/
    linearize.py:51-54): the entry points below dispatch on it, so the
    NLP solvers are phase-agnostic."""
    return getattr(form, "segments", None) is not None


def refuse_multiphase(form, what: str,
                      why: str = "the JAX package fails there too") -> None:
    """A path that reads the single-phase stage classes (form.con,
    form.cost) raises NotImplementedError on a multiphase formulation,
    where the JAX package fails on the missing attribute (or, as `why`
    says, computes something else)."""
    if is_multiphase(form):
        raise NotImplementedError(
            f"{what} of a multiphase OCP is not supported: {why} "
            "(ROADMAP.md, Queue 3: gaps in the JAX package)")


def build_static_rows(form: OcpNlpFormulation, dtype, device):
    """Constant row structure: base C/D blocks, row masks, soft masks
    (no batch axis)."""
    if is_multiphase(form):
        from acados_tpu_torch.ocp_nlp.multiphase import build_static_rows_mp
        return build_static_rows_mp(form, dtype, device)
    nc, N = form.nc, form.N

    def cls_const(spec):
        C0, D0 = spec.base_CD(dtype, device)
        mask = torch.cat([torch.ones(spec.nrows, dtype=dtype, device=device),
                          torch.zeros(nc - spec.nrows, dtype=dtype,
                                      device=device)])
        return (_pad_rows(C0, nc, 0), _pad_rows(D0, nc, 0), mask,
                _pad_rows(spec.soft_row_mask(dtype, device), nc, 0))

    C_0, D_0, m_0, s_0 = cls_const(form.con_0)
    C_p, D_p, m_p, s_p = cls_const(form.con)
    C_e, D_e, m_e, s_e = cls_const(form.con_e)
    mask = torch.cat([m_0[None], m_p[None].expand(N - 1, nc), m_e[None]])
    soft = torch.cat([s_0[None], s_p[None].expand(N - 1, nc), s_e[None]])
    return dict(C_0=C_0, D_0=D_0, C_p=C_p, D_p=D_p, C_e=C_e, D_e=D_e,
                mask=mask, soft=soft)


def _zlin(nx: int, z0, Jz, xk, uk):
    """Affine z model of one instance around its linearization point
    (acados_tpu/ocp_nlp/linearize.py:138-142)."""
    return lambda x_, u_: (z0 + Jz[:, :nx] @ (x_ - xk)
                           + Jz[:, nx:] @ (u_ - uk))


def _zconst(zk):
    """z of one instance fixed at its exact value (the merit's)."""
    return lambda *_: zk


def _stack_stages(first, path, last):
    """(B, ...), (B, K, ...), (B, ...) -> (B, K+2, ...)."""
    return torch.cat([first[:, None], path, last[:, None]], dim=1)


def _rows(spec, Cb, Db, nc, x, u, p, t, z=()):
    """Row values and row Jacobians of a (M,) batch of one stage class:
    (g (M, nc), C (M, nc, nx), D (M, nc, nu)); z: () or the (z0, Jz) of
    a z-dependent class."""
    M, nx = x.shape[0], x.shape[-1]

    def per(fn):
        if not z:
            return fn
        return lambda x_, u_, p_, t_, z0, Jz: fn(
            x_, u_, p_, t_, zlin=_zlin(nx, z0, Jz, x_, u_))

    g = _pad_rows(vmap(per(spec.eval_rows))(x, u, p, t, *z), nc)
    C = Cb.expand((M,) + tuple(Cb.shape))
    D = Db.expand((M,) + tuple(Db.shape))
    if spec.nh or spec.nphi:
        Jx, Ju = vmap(per(spec.h_jac))(x, u, p, t, *z)
        o, n = spec.nbx + spec.nbu + spec.ng, spec.nh + spec.nphi
        C, D = C.clone(), D.clone()
        C[:, o:o + n] = Jx
        D[:, o:o + n] = Ju
    return g, C, D


def step_one(form: OcpNlpFormulation, x, u, p, t, dt):
    """The batch-first step on one instance (a batch of one), as the
    per-instance functions under torch.func transforms call it."""
    return form.step_fn(x[None], u[None], p[None], t[None], dt[None])[0]


def dyn_hessian(form: OcpNlpFormulation, data: NlpData, x, u, pi):
    """Hessian over w_k = (x_k, u_k) of pi_k' step(x_k, u_k) for every
    interval, (B, N, nx+nu, nx+nu): one torch.func.hessian of the step,
    vmapped over the B*N intervals (acados_tpu/ocp_nlp/linearize.py:
    206-216)."""
    Bsz, N, nx = x.shape[0], form.N, form.nx

    def f(w, pk, tk, dtk, pik):
        return pik @ step_one(form, w[:nx], w[nx:], pk, tk, dtk)

    w = torch.cat([x[:, :-1], u], dim=-1)
    return _path_vmap(hessian(f), Bsz, N, w, data.p[:, :-1],
                      data.ts[:, :-1], data.dts, pi)


def linearize(form: OcpNlpFormulation, static_rows, data: NlpData,
              it: NlpIterate, lm) -> OcpQp:
    """Assemble the delta-form QP of every instance at the current
    iterate; lm is the Levenberg-Marquardt diagonal added to the
    Hessian (reference ocp_nlp_add_levenberg_marquardt_term), a scalar
    or one value an instance, (B,) (adaptive LM)."""
    if is_multiphase(form):
        from acados_tpu_torch.ocp_nlp.multiphase import linearize_mp
        return linearize_mp(form, static_rows, data, it, lm)
    N, nx, nu, nc = form.N, form.nx, form.nu, form.nc
    Bsz = it.x.shape[0]
    dt, dev = it.x.dtype, it.x.device
    x, u = it.x, it.u
    eyeW = torch.eye(nx + nu, dtype=dt, device=dev)
    zu_ = torch.zeros((Bsz, nu), dtype=dt, device=dev)
    lm_w = lm.reshape(-1, 1, 1, 1) if lm.dim() else lm
    lm_x = lm.reshape(-1, 1, 1) if lm.dim() else lm
    exact_cost = form.exact_hessian and form.exact_hess_cost
    exact_constr = form.exact_hessian and form.exact_hess_constr

    # ---- dynamics: A, B, b over all B*N intervals (one batch) ----------
    use_z = form.nz > 0
    out = form.step_jac_fn(
        _flat2(x[:, :-1]), _flat2(u), _flat2(data.p[:, :-1]),
        _flat2(data.ts[:, :-1]), _flat2(data.dts))
    xnext, A, B = out[:3]
    A = A.reshape(Bsz, N, nx, nx)
    B = B.reshape(Bsz, N, nx, nu)
    b = xnext.reshape(Bsz, N, nx) - x[:, 1:]
    # a DAE's z(t0) and dz0/d(x, u) per interval (reference dzduxt,
    # ocp_nlp_dynamics_cont.c:847-851): the stage-0 and path classes' z
    z_0 = z_p = ()
    if use_z:
        z0s = out[3].reshape(Bsz, N, form.nz)
        Jzs = out[4].reshape(Bsz, N, form.nz, nx + nu)
        z_0 = (z0s[:, 0], Jzs[:, 0])
        z_p = (z0s[:, 1:], Jzs[:, 1:])

    # ---- cost quadratics per stage class --------------------------------
    # (an integrated cost takes its interval's length, :145-166; the
    # terminal cost has no interval)
    def quad(spec):
        def qa(x_, u_, p_, t_, d_, dt_=None, *z):
            zlin = _zlin(nx, *z, x_, u_) if z else None
            return spec.quad_approx(x_, u_, p_, t_, d_, exact_cost, dt_,
                                    zlin)
        return qa

    H0, g0 = vmap(quad(form.cost_0))(
        x[:, 0], u[:, 0], data.p[:, 0], data.ts[:, 0], cost_data_stage0(data),
        data.dts[:, 0], *z_0)
    sc = data.cost_scale
    H0, g0 = sc[:, 0, None, None] * H0, sc[:, 0, None] * g0
    if N > 1:
        Hp, gp = _path_vmap(quad(form.cost), Bsz, N - 1,
                            x[:, 1:N], u[:, 1:N], data.p[:, 1:N],
                            data.ts[:, 1:N], {"yref": data.yref, "W": data.W},
                            data.dts[:, 1:N], *z_p)
        Hp = sc[:, 1:N, None, None] * Hp
        gp = sc[:, 1:N, None] * gp
    He, ge = vmap(quad(form.cost_e))(
        x[:, N], zu_, data.p[:, N], data.ts[:, N], cost_data_term(data))
    He, ge = sc[:, N, None, None] * He, sc[:, N, None] * ge

    # ---- BGP outer curvature, weighted by the phi rows' upper multipliers
    # (:173-197), in both Hessian modes ---------------------------------
    if form.con_0.nphi:
        H0 = H0 + vmap(form.con_0.bgp_hess)(x[:, 0], u[:, 0], data.p[:, 0],
                                            data.ts[:, 0], it.lam_u[:, 0])
    if form.con.nphi and N > 1:
        Hp = Hp + _path_vmap(form.con.bgp_hess, Bsz, N - 1, x[:, 1:N],
                             u[:, 1:N], data.p[:, 1:N], data.ts[:, 1:N],
                             it.lam_u[:, 1:N])
    if form.con_e.nphi:
        He = He + vmap(form.con_e.bgp_hess)(x[:, N], zu_, data.p[:, N],
                                            data.ts[:, N], it.lam_u[:, N])

    # ---- EXACT mode: dynamics and h curvature (linearize.py:198-252) ----
    if form.exact_hessian and form.exact_hess_dyn:
        Hd = dyn_hessian(form, data, x, u, it.pi)
        H0 = H0 + Hd[:, 0]
        if N > 1:
            Hp = Hp + Hd[:, 1:]
    if exact_constr:
        lam_d = it.lam_l - it.lam_u

        def h_hess(spec, z):
            if not z:
                return spec.h_hess
            return lambda x_, u_, p_, t_, ld, z0, Jz: spec.h_hess(
                x_, u_, p_, t_, ld, zlin=_zlin(nx, z0, Jz, x_, u_))

        if form.con_0.nh:
            H0 = H0 + vmap(h_hess(form.con_0, z_0))(
                x[:, 0], u[:, 0], data.p[:, 0], data.ts[:, 0], lam_d[:, 0],
                *z_0)
        if form.con.nh and N > 1:
            Hp = Hp + _path_vmap(h_hess(form.con, z_p), Bsz, N - 1,
                                 x[:, 1:N], u[:, 1:N], data.p[:, 1:N],
                                 data.ts[:, 1:N], lam_d[:, 1:N], *z_p)
        if form.con_e.nh:
            He = He + vmap(form.con_e.h_hess)(x[:, N], zu_, data.p[:, N],
                                              data.ts[:, N], lam_d[:, N])

    if N > 1:
        H_path = torch.cat([H0[:, None], Hp], dim=1) + lm_w * eyeW
        g_path = torch.cat([g0[:, None], gp], dim=1)
    else:
        H_path = H0[:, None] + lm_w * eyeW
        g_path = g0[:, None]

    # ---- constraint rows -------------------------------------------------
    sr = static_rows
    g0v, C0, D0 = _rows(form.con_0, sr["C_0"], sr["D_0"], nc, x[:, 0],
                        u[:, 0], data.p[:, 0], data.ts[:, 0], z_0)
    gev, Ce, _ = _rows(form.con_e, sr["C_e"], sr["D_e"], nc, x[:, N], zu_,
                       data.p[:, N], data.ts[:, N])
    if N > 1:
        K = N - 1
        gpv, Cp, Dp = _rows(form.con, sr["C_p"], sr["D_p"], nc,
                            _flat2(x[:, 1:N]), _flat2(u[:, 1:N]),
                            _flat2(data.p[:, 1:N]), _flat2(data.ts[:, 1:N]),
                            tuple(_flat2(a) for a in z_p))
        g_all = _stack_stages(g0v, gpv.reshape(Bsz, K, nc), gev)
        C = _stack_stages(C0, Cp.reshape(Bsz, K, nc, nx), Ce)
        D = torch.cat([D0[:, None], Dp.reshape(Bsz, K, nc, nu)], dim=1)
    else:
        g_all = torch.stack([g0v, gev], dim=1)
        C = torch.stack([C0, Ce], dim=1)
        D = D0[:, None]
    return _assemble_qp(data, sr, H_path, g_path, He, ge, lm_x, A, B, b,
                        g_all, C, D)


def _assemble_qp(data: NlpData, sr, H_path, g_path, He, ge, lm_x, A, B, b,
                 g_all, C, D) -> OcpQp:
    """The delta-form OcpQp of every instance from the stage Hessians
    and gradients over w = [x; u] (H_path/g_path of stages 0..N-1, He/ge
    of stage N, without its lm term), the dynamics blocks and the row
    values and Jacobians of all stages."""
    Bsz, N, nx = A.shape[0], A.shape[1], A.shape[-1]
    nc = g_all.shape[-1]
    eyeX = torch.eye(nx, dtype=A.dtype, device=A.device)
    Q = torch.cat([H_path[:, :, :nx, :nx],
                   (He[:, :nx, :nx] + lm_x * eyeX)[:, None]], dim=1)
    S = H_path[:, :, nx:, :nx]
    R = H_path[:, :, nx:, nx:]
    q = torch.cat([g_path[:, :, :nx], ge[:, None, :nx]], dim=1)
    r = g_path[:, :, nx:]

    lb_all = _stack_stages(data.lb_0, data.lb, data.lb_e)
    ub_all = _stack_stages(data.ub_0, data.ub, data.ub_e)
    # per-side enables: a row is one-sided when the other bound is at
    # +-ACADOS_INFTY; the absent side is masked out
    exists = sr["mask"]
    inf_thresh = 0.5 * ACADOS_INFTY
    mask_l = exists * (lb_all > -inf_thresh)
    mask_u = exists * (ub_all < inf_thresh)
    lg = torch.where(mask_l > 0, lb_all - g_all, -1.0)  # delta form
    ug = torch.where(mask_u > 0, ub_all - g_all, 1.0)

    sc_all = data.cost_scale[:, :, None]
    Zl = _stack_stages(data.Zl_0, data.Zl, data.Zl_e) * sc_all
    Zu = _stack_stages(data.Zu_0, data.Zu, data.Zu_e) * sc_all
    zl = _stack_stages(data.zl_0, data.zl, data.zl_e) * sc_all
    zu = _stack_stages(data.zu_0, data.zu, data.zu_e) * sc_all

    return OcpQp(Q=Q, R=R, S=S, q=q, r=r, A=A, B=B, b=b, C=C, D=D,
                 lg=lg, ug=ug, mask_l=mask_l, mask_u=mask_u,
                 Zl=Zl, Zu=Zu, zl=zl, zu=zu,
                 soft_mask=sr["soft"].expand(Bsz, N + 1, nc))


def _needs_z(form) -> bool:
    return form.nz > 0 and form.z_fun is not None and (
        form.con_0.with_z or form.con.with_z or form.cost_0.with_z
        or form.cost.with_z)


def _z_exact(form: OcpNlpFormulation, data: NlpData, x, u):
    """Exact z(t0) of every interval, (B, N, nz), for the merit and
    residual evaluations (acados_tpu/ocp_nlp/linearize.py:315-320): one
    call of form.z_fun over the B*N intervals."""
    Bsz, N = x.shape[0], form.N
    zs = form.z_fun(_flat2(x[:, :-1]), _flat2(u), _flat2(data.p[:, :-1]),
                    _flat2(data.ts[:, :-1]), _flat2(data.dts))
    return zs.reshape(Bsz, N, form.nz)


def _z_fixed(fn, z):
    """A per-instance module function with its z fixed to a trailing zk
    argument (z: the (B, K, nz) or (B, nz) values, or None)."""
    if z is None:
        return fn, ()
    return (lambda *a: fn(*a[:-1], zlin=_zconst(a[-1]))), (z,)


def eval_constraints(form: OcpNlpFormulation, data: NlpData, x, u):
    """Row values g_k(x_k, u_k) for all stages, (B, N+1, nc)."""
    if is_multiphase(form):
        from acados_tpu_torch.ocp_nlp.multiphase import eval_constraints_mp
        return eval_constraints_mp(form, data, x, u)
    N, nc, nu = form.N, form.nc, form.nu
    Bsz = x.shape[0]
    zs = _z_exact(form, data, x, u) if _needs_z(form) else None

    def ev(spec, z, *a):
        fn, za = _z_fixed(spec.eval_rows, z)
        return _pad_rows(vmap(fn)(*a, *za), nc)

    g0 = ev(form.con_0, None if zs is None else zs[:, 0], x[:, 0], u[:, 0],
            data.p[:, 0], data.ts[:, 0])
    ge = ev(form.con_e, None, x[:, N], x.new_zeros((Bsz, nu)), data.p[:, N],
            data.ts[:, N])
    gp = ev(form.con, None if zs is None else _flat2(zs[:, 1:]),
            _flat2(x[:, 1:N]), _flat2(u[:, 1:N]), _flat2(data.p[:, 1:N]),
            _flat2(data.ts[:, 1:N]))
    return _stack_stages(g0, gp.reshape(Bsz, N - 1, nc), ge)


def eval_cost(form: OcpNlpFormulation, data: NlpData, x, u, sl, su,
              soft_mask):
    """Total NLP objective of every instance incl. soft-slack penalties,
    (B,)."""
    if is_multiphase(form):
        from acados_tpu_torch.ocp_nlp.multiphase import eval_cost_mp
        return eval_cost_mp(form, data, x, u, sl, su, soft_mask)
    N, nu = form.N, form.nu
    Bsz = x.shape[0]
    sc = data.cost_scale
    zs = _z_exact(form, data, x, u) if _needs_z(form) else None
    fn0, z0a = _z_fixed(form.cost_0.value, None if zs is None else zs[:, 0])
    fnp, zpa = _z_fixed(form.cost.value, None if zs is None else zs[:, 1:])
    c0 = vmap(fn0)(x[:, 0], u[:, 0], data.p[:, 0], data.ts[:, 0],
                   cost_data_stage0(data), data.dts[:, 0], *z0a) * sc[:, 0]
    cp = _path_vmap(fnp, Bsz, N - 1, x[:, 1:N], u[:, 1:N],
                    data.p[:, 1:N], data.ts[:, 1:N],
                    {"yref": data.yref, "W": data.W}, data.dts[:, 1:N],
                    *zpa)
    cp = (cp * sc[:, 1:N]).sum(dim=1)
    ce = vmap(form.cost_e.value)(x[:, N], x.new_zeros((Bsz, nu)),
                                 data.p[:, N], data.ts[:, N],
                                 cost_data_term(data)) * sc[:, N]
    return c0 + cp + ce + _slack_cost(data, sl, su, soft_mask)


def _slack_cost(data: NlpData, sl, su, soft_mask):
    """The soft rows' slack penalties of every instance, (B,)."""
    Zl = _stack_stages(data.Zl_0, data.Zl, data.Zl_e)
    Zu = _stack_stages(data.Zu_0, data.Zu, data.Zu_e)
    zl = _stack_stages(data.zl_0, data.zl, data.zl_e)
    zu = _stack_stages(data.zu_0, data.zu, data.zu_e)
    scs = data.cost_scale[:, :, None] * soft_mask
    return (scs * (zl * sl + 0.5 * Zl * sl ** 2 + zu * su
                   + 0.5 * Zu * su ** 2)).reshape(sl.shape[0], -1).sum(dim=1)


def eval_dyn_gap(form: OcpNlpFormulation, data: NlpData, x, u):
    """phi(x_k, u_k) - x_{k+1} for all intervals, (B, N, nx)."""
    if is_multiphase(form):
        from acados_tpu_torch.ocp_nlp.multiphase import eval_dyn_gap_mp
        return eval_dyn_gap_mp(form, data, x, u)
    Bsz, N = x.shape[0], form.N
    xn = form.step_fn(_flat2(x[:, :-1]), _flat2(u), _flat2(data.p[:, :-1]),
                      _flat2(data.ts[:, :-1]), _flat2(data.dts))
    return xn.reshape(Bsz, N, form.nx) - x[:, 1:]
