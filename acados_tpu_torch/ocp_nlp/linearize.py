"""Per-iteration QP approximation of the NLP (the SQP hot path),
batch-first.

Counterpart of `acados_tpu/ocp_nlp/linearize.py` on its `step_jac_fn`
branch (:115-124): the dynamics Jacobians of all B*N intervals come from
one call of the batch-first fused integrator step (where the IRK stage
inverses run as one batch), the cost quadratics and constraint rows from
per-instance module functions under `torch.func.vmap`. The result is the
delta-form OcpQp consumed by the Riccati IPM.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from acados_tpu_torch.ocp_nlp.formulation import (NlpData, OcpNlpFormulation,
                                                  cost_data_stage0,
                                                  cost_data_term)
from acados_tpu_torch.ocp_qp.data import OcpQp
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


def build_static_rows(form: OcpNlpFormulation, dtype, device):
    """Constant row structure: base C/D blocks, row masks, soft masks
    (no batch axis)."""
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


def _stack_stages(first, path, last):
    """(B, ...), (B, K, ...), (B, ...) -> (B, K+2, ...)."""
    return torch.cat([first[:, None], path, last[:, None]], dim=1)


def _rows(spec, Cb, Db, nc, x, u, p, t):
    """Row values and row Jacobians of a (M,) batch of one stage class:
    (g (M, nc), C (M, nc, nx), D (M, nc, nu))."""
    M = x.shape[0]
    g = _pad_rows(vmap(spec.eval_rows)(x, u, p, t), nc)
    C = Cb.expand((M,) + tuple(Cb.shape))
    D = Db.expand((M,) + tuple(Db.shape))
    if spec.nh:
        Jx, Ju = vmap(spec.h_jac)(x, u, p, t)
        o = spec.nbx + spec.nbu + spec.ng
        C, D = C.clone(), D.clone()
        C[:, o:o + spec.nh] = Jx
        D[:, o:o + spec.nh] = Ju
    return g, C, D


def linearize(form: OcpNlpFormulation, static_rows, data: NlpData,
              it: NlpIterate, lm) -> OcpQp:
    """Assemble the delta-form QP of every instance at the current
    iterate; lm is the Levenberg-Marquardt diagonal added to the
    Hessian (reference ocp_nlp_add_levenberg_marquardt_term)."""
    N, nx, nu, nc = form.N, form.nx, form.nu, form.nc
    Bsz = it.x.shape[0]
    dt, dev = it.x.dtype, it.x.device
    x, u = it.x, it.u
    eyeW = torch.eye(nx + nu, dtype=dt, device=dev)
    zu_ = torch.zeros((Bsz, nu), dtype=dt, device=dev)

    # ---- dynamics: A, B, b over all B*N intervals (one batch) ----------
    xnext, A, B = form.step_jac_fn(
        _flat2(x[:, :-1]), _flat2(u), _flat2(data.p[:, :-1]),
        _flat2(data.ts[:, :-1]), _flat2(data.dts))
    A = A.reshape(Bsz, N, nx, nx)
    B = B.reshape(Bsz, N, nx, nu)
    b = xnext.reshape(Bsz, N, nx) - x[:, 1:]

    # ---- cost quadratics per stage class --------------------------------
    H0, g0 = vmap(form.cost_0.quad_approx)(
        x[:, 0], u[:, 0], data.p[:, 0], data.ts[:, 0], cost_data_stage0(data))
    sc = data.cost_scale
    H0, g0 = sc[:, 0, None, None] * H0, sc[:, 0, None] * g0
    if N > 1:
        Hp, gp = _path_vmap(form.cost.quad_approx, Bsz, N - 1,
                            x[:, 1:N], u[:, 1:N], data.p[:, 1:N],
                            data.ts[:, 1:N], {"yref": data.yref, "W": data.W})
        Hp = sc[:, 1:N, None, None] * Hp
        gp = sc[:, 1:N, None] * gp
        H_path = torch.cat([H0[:, None], Hp], dim=1) + lm * eyeW
        g_path = torch.cat([g0[:, None], gp], dim=1)
    else:
        H_path = H0[:, None] + lm * eyeW
        g_path = g0[:, None]
    He, ge = vmap(form.cost_e.quad_approx)(
        x[:, N], zu_, data.p[:, N], data.ts[:, N], cost_data_term(data))
    He, ge = sc[:, N, None, None] * He, sc[:, N, None] * ge

    eyeX = torch.eye(nx, dtype=dt, device=dev)
    Q = torch.cat([H_path[:, :, :nx, :nx],
                   (He[:, :nx, :nx] + lm * eyeX)[:, None]], dim=1)
    S = H_path[:, :, nx:, :nx]
    R = H_path[:, :, nx:, nx:]
    q = torch.cat([g_path[:, :, :nx], ge[:, None, :nx]], dim=1)
    r = g_path[:, :, nx:]

    # ---- constraint rows -------------------------------------------------
    sr = static_rows
    g0v, C0, D0 = _rows(form.con_0, sr["C_0"], sr["D_0"], nc, x[:, 0],
                        u[:, 0], data.p[:, 0], data.ts[:, 0])
    gev, Ce, _ = _rows(form.con_e, sr["C_e"], sr["D_e"], nc, x[:, N], zu_,
                       data.p[:, N], data.ts[:, N])
    if N > 1:
        K = N - 1
        gpv, Cp, Dp = _rows(form.con, sr["C_p"], sr["D_p"], nc,
                            _flat2(x[:, 1:N]), _flat2(u[:, 1:N]),
                            _flat2(data.p[:, 1:N]), _flat2(data.ts[:, 1:N]))
        g_all = _stack_stages(g0v, gpv.reshape(Bsz, K, nc), gev)
        C = _stack_stages(C0, Cp.reshape(Bsz, K, nc, nx), Ce)
        D = torch.cat([D0[:, None], Dp.reshape(Bsz, K, nc, nu)], dim=1)
    else:
        g_all = torch.stack([g0v, gev], dim=1)
        C = torch.stack([C0, Ce], dim=1)
        D = D0[:, None]

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

    sc_all = sc[:, :, None]
    Zl = _stack_stages(data.Zl_0, data.Zl, data.Zl_e) * sc_all
    Zu = _stack_stages(data.Zu_0, data.Zu, data.Zu_e) * sc_all
    zl = _stack_stages(data.zl_0, data.zl, data.zl_e) * sc_all
    zu = _stack_stages(data.zu_0, data.zu, data.zu_e) * sc_all

    return OcpQp(Q=Q, R=R, S=S, q=q, r=r, A=A, B=B, b=b, C=C, D=D,
                 lg=lg, ug=ug, mask_l=mask_l, mask_u=mask_u,
                 Zl=Zl, Zu=Zu, zl=zl, zu=zu,
                 soft_mask=sr["soft"].expand(Bsz, N + 1, nc))


def eval_constraints(form: OcpNlpFormulation, data: NlpData, x, u):
    """Row values g_k(x_k, u_k) for all stages, (B, N+1, nc)."""
    N, nc, nu = form.N, form.nc, form.nu
    Bsz = x.shape[0]
    ev = lambda spec, *a: _pad_rows(vmap(spec.eval_rows)(*a), nc)
    g0 = ev(form.con_0, x[:, 0], u[:, 0], data.p[:, 0], data.ts[:, 0])
    ge = ev(form.con_e, x[:, N], x.new_zeros((Bsz, nu)), data.p[:, N],
            data.ts[:, N])
    gp = ev(form.con, _flat2(x[:, 1:N]), _flat2(u[:, 1:N]),
            _flat2(data.p[:, 1:N]), _flat2(data.ts[:, 1:N]))
    return _stack_stages(g0, gp.reshape(Bsz, N - 1, nc), ge)


def eval_cost(form: OcpNlpFormulation, data: NlpData, x, u, sl, su,
              soft_mask):
    """Total NLP objective of every instance incl. soft-slack penalties,
    (B,)."""
    N, nu = form.N, form.nu
    Bsz = x.shape[0]
    sc = data.cost_scale
    c0 = vmap(form.cost_0.value)(x[:, 0], u[:, 0], data.p[:, 0],
                                 data.ts[:, 0], cost_data_stage0(data)) \
        * sc[:, 0]
    cp = _path_vmap(form.cost.value, Bsz, N - 1, x[:, 1:N], u[:, 1:N],
                    data.p[:, 1:N], data.ts[:, 1:N],
                    {"yref": data.yref, "W": data.W})
    cp = (cp * sc[:, 1:N]).sum(dim=1)
    ce = vmap(form.cost_e.value)(x[:, N], x.new_zeros((Bsz, nu)),
                                 data.p[:, N], data.ts[:, N],
                                 cost_data_term(data)) * sc[:, N]
    Zl = _stack_stages(data.Zl_0, data.Zl, data.Zl_e)
    Zu = _stack_stages(data.Zu_0, data.Zu, data.Zu_e)
    zl = _stack_stages(data.zl_0, data.zl, data.zl_e)
    zu = _stack_stages(data.zu_0, data.zu, data.zu_e)
    scs = sc[:, :, None] * soft_mask
    slack = (scs * (zl * sl + 0.5 * Zl * sl ** 2 + zu * su
                    + 0.5 * Zu * su ** 2)).reshape(Bsz, -1).sum(dim=1)
    return c0 + cp + ce + slack


def eval_dyn_gap(form: OcpNlpFormulation, data: NlpData, x, u):
    """phi(x_k, u_k) - x_{k+1} for all intervals, (B, N, nx)."""
    Bsz, N = x.shape[0], form.N
    xn = form.step_fn(_flat2(x[:, :-1]), _flat2(u), _flat2(data.p[:, :-1]),
                      _flat2(data.ts[:, :-1]), _flat2(data.dts))
    return xn.reshape(Bsz, N, form.nx) - x[:, 1:]
