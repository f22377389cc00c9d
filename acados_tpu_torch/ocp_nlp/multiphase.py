"""Multiphase OCP formulation: per-phase dynamics, cost and constraints,
batch-first.

Counterpart of `acados_tpu/ocp_nlp/multiphase.py`: the horizon is split
into contiguous phases, each with its own model, cost and constraint
modules; stage 0 takes the first phase's initial cost and constraints,
stage N the last phase's terminal ones; transition phases are N = 1
DISCRETE phases that map one state space onto another. Every phase is
padded to the global (nx_max, nu_max) (interface/multiphase.py).

The loop over phases stays a Python loop (a few phases, no per-stage
loop): each phase's stages go through one batch of its (B*K) intervals,
and the results are concatenated on the stage axis. A segment's
dynamics Jacobians come from the phase's own batch-first step Jacobian
on its unpadded coordinates, zero-padded (interface/multiphase.py:
_padded_step_jac); the padded coordinates enter and leave the padded
step as zeros, so this equals the JAX package's jacfwd of the padded
step (:157-162), and an IRK phase solves its stage systems with K1 as
the single-phase IRK does.

As in the JAX package, the multiphase linearization takes the cost's
exact Hessian under hessian_approx EXACT and no dynamics, h or BGP
curvature (:146-271).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch.func import vmap

from acados_tpu_torch.ocp_nlp.formulation import (ConstraintSpec, CostSpec,
                                                  NlpData, cost_data_stage0,
                                                  cost_data_term)
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate, _assemble_qp,
                                                _flat2, _pad_rows,
                                                _path_vmap, _rows,
                                                _slack_cost)
from acados_tpu_torch.ocp_qp.data import OcpQp


@dataclasses.dataclass(frozen=True)
class PhaseSegment:
    """One phase: intervals [start, stop) of the global horizon.

    Path stages owned by the phase are max(start, 1) .. min(stop, N) - 1
    (stage `start` of phase i > 0 belongs to phase i, the reference's
    stage-to-phase map). step_fn and step_jac_fn are batch-first on the
    padded coordinates: (x (M, nx), u (M, nu), p, t, dt) -> x_next
    (M, nx), and -> (x_next, A (M, nx, nx), B (M, nx, nu))."""

    start: int
    stop: int
    step_fn: Callable
    step_jac_fn: Callable
    cost: CostSpec
    con: ConstraintSpec


@dataclasses.dataclass(frozen=True)
class OcpNlpMpFormulation:
    """Multiphase analog of OcpNlpFormulation (the linearize and eval
    entry points of ocp_nlp/linearize.py dispatch on `segments`)."""

    N: int
    nx: int
    nu: int
    np_: int
    segments: Tuple[PhaseSegment, ...]
    cost_0: CostSpec = None
    con_0: ConstraintSpec = None
    cost_e: CostSpec = None
    con_e: ConstraintSpec = None
    exact_hessian: bool = False
    # the JAX package's multiphase formulation has no x0_equality, which
    # its use_x0_elimination reads as False: no initial-state elimination
    x0_equality = False

    @property
    def nc(self) -> int:
        rows = [self.con_0.nrows, self.con_e.nrows] \
            + [s.con.nrows for s in self.segments]
        return max(rows + [1])

    @property
    def step_fn(self):
        """Stage-dispatching batch-first dynamics, step(x, u, p, t, dt,
        k=0) with the step of the phase interval k lies in, the last
        phase's past the horizon (AS-RTI's SIMULATE advancement
        integrates interval 0)."""
        segs = self.segments

        def step(x, u, p, t, dt, k=0):
            for s in segs:
                if s.start <= k < s.stop:
                    return s.step_fn(x, u, p, t, dt)
            return segs[-1].step_fn(x, u, p, t, dt)

        return step

    def phase_of_interval(self, k: int) -> int:
        for i, s in enumerate(self.segments):
            if s.start <= k < s.stop:
                return i
        raise IndexError(k)


def _seg_path_count(form: OcpNlpMpFormulation, s: PhaseSegment) -> int:
    """Number of path stages (1..N-1) owned by segment s."""
    lo, hi = _seg_path_range(form, s)
    return max(hi - lo, 0)


def _seg_path_range(form: OcpNlpMpFormulation, s: PhaseSegment):
    return max(s.start, 1), min(s.stop, form.N)


def _path_segments(form: OcpNlpMpFormulation):
    """(segment, lo, hi) of every segment that owns path stages."""
    for s in form.segments:
        lo, hi = _seg_path_range(form, s)
        if hi > lo:
            yield s, lo, hi


def build_static_rows_mp(form: OcpNlpMpFormulation, dtype, device):
    """Per-stage constant row structure (the multiphase build_static_rows;
    no batch axis): stage 0's and N's base C/D blocks, each segment's,
    and the row and soft masks of every stage."""
    nc = form.nc

    def cls_const(spec):
        C0, D0 = spec.base_CD(dtype, device)
        mask = torch.cat([torch.ones(spec.nrows, dtype=dtype, device=device),
                          torch.zeros(nc - spec.nrows, dtype=dtype,
                                      device=device)])
        return (_pad_rows(C0, nc, 0), _pad_rows(D0, nc, 0), mask,
                _pad_rows(spec.soft_row_mask(dtype, device), nc, 0))

    C_0, D_0, m_0, s_0 = cls_const(form.con_0)
    C_e, D_e, m_e, s_e = cls_const(form.con_e)
    seg_rows, masks, softs = [], [m_0[None]], [s_0[None]]
    for s in form.segments:
        Cp, Dp, mp_, sp = cls_const(s.con)
        n_path = _seg_path_count(form, s)
        seg_rows.append((Cp, Dp))
        masks.append(mp_[None].expand(n_path, nc))
        softs.append(sp[None].expand(n_path, nc))
    masks.append(m_e[None])
    softs.append(s_e[None])
    return dict(C_0=C_0, D_0=D_0, C_e=C_e, D_e=D_e, seg_rows=seg_rows,
                mask=torch.cat(masks), soft=torch.cat(softs))


def _intervals(data: NlpData, x, u, s: PhaseSegment):
    """The (B*K, .) arguments of segment s's K intervals."""
    sl = slice(s.start, s.stop)
    return (_flat2(x[:, sl]), _flat2(u[:, sl]), _flat2(data.p[:, sl]),
            _flat2(data.ts[:, sl]), _flat2(data.dts[:, sl]))


def linearize_mp(form: OcpNlpMpFormulation, static_rows, data: NlpData,
                 it: NlpIterate, lm) -> OcpQp:
    """The delta-form QP of every instance for a multiphase problem
    (acados_tpu/ocp_nlp/multiphase.py:146-270): one batch per segment,
    results concatenated on the stage axis."""
    N, nx, nu, nc = form.N, form.nx, form.nu, form.nc
    Bsz = it.x.shape[0]
    dt, dev = it.x.dtype, it.x.device
    x, u = it.x, it.u
    eyeW = torch.eye(nx + nu, dtype=dt, device=dev)
    zu_ = torch.zeros((Bsz, nu), dtype=dt, device=dev)
    lm_w = lm.reshape(-1, 1, 1, 1) if lm.dim() else lm
    lm_x = lm.reshape(-1, 1, 1) if lm.dim() else lm

    # ---- dynamics: one step Jacobian call per segment --------------------
    A_parts, B_parts, b_parts = [], [], []
    for s in form.segments:
        K = s.stop - s.start
        xn, Ak, Bk = s.step_jac_fn(*_intervals(data, x, u, s))
        A_parts.append(Ak.reshape(Bsz, K, nx, nx))
        B_parts.append(Bk.reshape(Bsz, K, nx, nu))
        b_parts.append(xn.reshape(Bsz, K, nx) - x[:, s.start + 1:s.stop + 1])
    A = torch.cat(A_parts, dim=1)
    B = torch.cat(B_parts, dim=1)
    b = torch.cat(b_parts, dim=1)

    # ---- cost quadratics: stage 0, each segment's path stages, stage N -
    def quad(spec):
        return lambda x_, u_, p_, t_, d_: spec.quad_approx(
            x_, u_, p_, t_, d_, form.exact_hessian)

    sc = data.cost_scale
    H0, g0 = vmap(quad(form.cost_0))(x[:, 0], u[:, 0], data.p[:, 0],
                                     data.ts[:, 0], cost_data_stage0(data))
    H_parts = [sc[:, 0, None, None, None] * H0[:, None]]
    g_parts = [sc[:, 0, None, None] * g0[:, None]]
    for s, lo, hi in _path_segments(form):
        # data.yref/W carry path stages 1..N-1 at index k-1
        Hk, gk = _path_vmap(quad(s.cost), Bsz, hi - lo, x[:, lo:hi],
                            u[:, lo:hi], data.p[:, lo:hi], data.ts[:, lo:hi],
                            {"yref": data.yref[:, lo - 1:hi - 1],
                             "W": data.W[:, lo - 1:hi - 1]})
        H_parts.append(sc[:, lo:hi, None, None] * Hk)
        g_parts.append(sc[:, lo:hi, None] * gk)
    He, ge = vmap(quad(form.cost_e))(x[:, N], zu_, data.p[:, N],
                                     data.ts[:, N], cost_data_term(data))
    He, ge = sc[:, N, None, None] * He, sc[:, N, None] * ge
    H_path = torch.cat(H_parts, dim=1) + lm_w * eyeW
    g_path = torch.cat(g_parts, dim=1)

    # ---- constraint rows ---------------------------------------------------
    sr = static_rows
    g0v, C0, D0 = _rows(form.con_0, sr["C_0"], sr["D_0"], nc, x[:, 0],
                        u[:, 0], data.p[:, 0], data.ts[:, 0])
    g_rows, C_rows, D_rows = [g0v[:, None]], [C0[:, None]], [D0[:, None]]
    for s, (Cb, Db) in zip(form.segments, sr["seg_rows"]):
        lo, hi = _seg_path_range(form, s)
        if hi <= lo:
            continue
        K = hi - lo
        gk, Ck, Dk = _rows(s.con, Cb, Db, nc, _flat2(x[:, lo:hi]),
                           _flat2(u[:, lo:hi]), _flat2(data.p[:, lo:hi]),
                           _flat2(data.ts[:, lo:hi]))
        g_rows.append(gk.reshape(Bsz, K, nc))
        C_rows.append(Ck.reshape(Bsz, K, nc, nx))
        D_rows.append(Dk.reshape(Bsz, K, nc, nu))
    gev, Ce, _ = _rows(form.con_e, sr["C_e"], sr["D_e"], nc, x[:, N], zu_,
                       data.p[:, N], data.ts[:, N])
    g_all = torch.cat(g_rows + [gev[:, None]], dim=1)
    C = torch.cat(C_rows + [Ce[:, None]], dim=1)
    D = torch.cat(D_rows, dim=1)
    return _assemble_qp(data, sr, H_path, g_path, He, ge, lm_x, A, B, b,
                        g_all, C, D)


def eval_constraints_mp(form: OcpNlpMpFormulation, data: NlpData, x, u):
    """Row values of every stage, (B, N+1, nc)."""
    N, nc, nu = form.N, form.nc, form.nu
    Bsz = x.shape[0]
    ev = lambda spec, *a: _pad_rows(vmap(spec.eval_rows)(*a), nc)
    parts = [ev(form.con_0, x[:, 0], u[:, 0], data.p[:, 0],
                data.ts[:, 0])[:, None]]
    for s, lo, hi in _path_segments(form):
        parts.append(ev(s.con, _flat2(x[:, lo:hi]), _flat2(u[:, lo:hi]),
                        _flat2(data.p[:, lo:hi]), _flat2(data.ts[:, lo:hi])
                        ).reshape(Bsz, hi - lo, nc))
    parts.append(ev(form.con_e, x[:, N], x.new_zeros((Bsz, nu)),
                    data.p[:, N], data.ts[:, N])[:, None])
    return torch.cat(parts, dim=1)


def eval_cost_mp(form: OcpNlpMpFormulation, data: NlpData, x, u, sl, su,
                 soft_mask):
    """Total objective of every instance incl. soft-slack penalties,
    (B,)."""
    N, nu = form.N, form.nu
    Bsz = x.shape[0]
    sc = data.cost_scale
    c = vmap(form.cost_0.value)(x[:, 0], u[:, 0], data.p[:, 0],
                                data.ts[:, 0], cost_data_stage0(data)) \
        * sc[:, 0]
    for s, lo, hi in _path_segments(form):
        ck = _path_vmap(s.cost.value, Bsz, hi - lo, x[:, lo:hi], u[:, lo:hi],
                        data.p[:, lo:hi], data.ts[:, lo:hi],
                        {"yref": data.yref[:, lo - 1:hi - 1],
                         "W": data.W[:, lo - 1:hi - 1]})
        c = c + (ck * sc[:, lo:hi]).sum(dim=1)
    c = c + vmap(form.cost_e.value)(x[:, N], x.new_zeros((Bsz, nu)),
                                    data.p[:, N], data.ts[:, N],
                                    cost_data_term(data)) * sc[:, N]
    return c + _slack_cost(data, sl, su, soft_mask)


def eval_dyn_gap_mp(form: OcpNlpMpFormulation, data: NlpData, x, u):
    """phi(x_k, u_k) - x_{k+1} of every interval, (B, N, nx): one step
    call per segment."""
    Bsz, nx = x.shape[0], form.nx
    parts = []
    for s in form.segments:
        xn = s.step_fn(*_intervals(data, x, u, s))
        parts.append(xn.reshape(Bsz, s.stop - s.start, nx)
                     - x[:, s.start + 1:s.stop + 1])
    return torch.cat(parts, dim=1)
