"""MPC utilities: cost and constraint evaluation, cost-state augmentation,
constraint-structure detection and the control horizon.

Counterpart of `acados_tpu/interface/mpc_utils.py` (reference
mpc_utils.py: 43 AcadosCostConstraintEvaluator, :389
create_model_with_cost_state, :462 detect_constraint_structure, :649
J_to_idx, :665 create_ocp_with_control_horizon). Where the reference
builds CasADi functions from symbolic expressions, this reuses the
builder's cost and constraint specs (torch callables evaluated in
float64), and structure detection probes Jacobians numerically with
`torch.func.jacfwd` at the JAX package's seeded probe points, so both
packages classify the same rows.
"""
from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import (AcadosModel, AcadosOcp,
                                                   _dim_of)
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.interface.multiphase import AcadosMultiphaseOcp
from acados_tpu_torch.ocp_nlp.formulation import _const
from acados_tpu_torch.sim.integrator import normalize_dynamics
from acados_tpu_torch.utils.device import resolve_device

_F64 = torch.float64


def J_to_idx(J) -> np.ndarray:
    """Selection matrix -> index vector (reference mpc_utils.py:649)."""
    J = np.asarray(J)
    idx = np.zeros(J.shape[0], dtype=int)
    for i in range(J.shape[0]):
        nz = np.nonzero(J[i])[0]
        if len(nz) != 1 or J[i, nz[0]] != 1:
            raise ValueError(f"J row {i} is not a unit selection row")
        idx[i] = nz[0]
    return idx


def _violation_terms(con, rows, lb, ub, Zl, Zu, zl, zu):
    """(per-row violation, slack penalty) of one stage's rows."""
    nrows = rows.shape[0]
    lo_v = torch.clamp(lb[:nrows] - rows, min=0.0)
    up_v = torch.clamp(rows - ub[:nrows], min=0.0)
    sm = con.soft_row_mask(rows.dtype, rows.device)
    pen = (sm * (zl[:nrows] * lo_v + 0.5 * Zl[:nrows] * lo_v ** 2
                 + zu[:nrows] * up_v + 0.5 * Zu[:nrows] * up_v ** 2)).sum()
    return torch.maximum(lo_v, up_v), pen


class AcadosCostConstraintEvaluator:
    """Evaluate an AcadosOcp's cost (slack penalties included) and
    constraint violations outside the solver (reference mpc_utils.py:43),
    e.g. to account closed-loop performance with the stage cost the
    solver optimizes; in float64 on `device` (None means "cuda").

    evaluate(x, u, step=0) -> dict with 'cost' (slack-penalized, scaled
    as the solver scales it), 'cost_without_slacks' and the per-row
    'violation' of the unified constraint block.
    evaluate_ocp_cost(iterate) -> total cost of a trajectory
    {'x': (N+1, nx), 'u': (N, nu)}.
    """

    def __init__(self, ocp, device=None):
        self.device = resolve_device(device)
        self._form, data_np, _ = build_ocp(copy.deepcopy(ocp))
        self._data = data_to_torch(data_np, _F64, self.device, batch=1)
        self._N = self._form.N

    def update_all(self, solver):
        """Refresh the runtime data (yref, W, bounds, penalties) from a
        solver (reference update_all(acados_solver)); the JAX package
        keeps the solver's numpy dict, the port converts it."""
        if hasattr(solver, "_data"):
            self._data = data_to_torch(solver._data, _F64, self.device,
                                       batch=1)

    def _stage(self, x, u, k: int) -> dict:
        form, d, N = self._form, self._data, self._N
        if k == 0:
            spec, con = form.cost_0, form.con_0
            cd = {"yref": d.yref_0[0], "W": d.W_0[0]}
            bounds = (d.lb_0, d.ub_0, d.Zl_0, d.Zu_0, d.zl_0, d.zu_0)
            sel = lambda a: a[0]
        elif k == N:
            spec, con = form.cost_e, form.con_e
            cd = {"yref": d.yref_e[0], "W": d.W_e[0]}
            bounds = (d.lb_e, d.ub_e, d.Zl_e, d.Zu_e, d.zl_e, d.zu_e)
            sel = lambda a: a[0]
        else:
            spec, con = form.cost, form.con
            cd = {"yref": d.yref[0, k - 1], "W": d.W[0, k - 1]}
            bounds = (d.lb, d.ub, d.Zl, d.Zu, d.zl, d.zu)
            sel = lambda a: a[0, k - 1]
        p, t = d.p[0, k], d.ts[0, k]
        dt_ = d.dts[0, k] if k < N else None
        base = spec.value(x, u, p, t, cd, dt_)
        viol, pen = _violation_terms(con, con.eval_rows(x, u, p, t),
                                     *(sel(a) for a in bounds))
        scale = d.cost_scale[0, k]
        return {"cost_without_slacks": scale * base,
                "cost": scale * (base + pen), "violation": viol}

    def evaluate(self, x, u, step: int = 0) -> Dict[str, np.ndarray]:
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                         dtype=_F64, device=self.device)
        out = self._stage(as_t(x), as_t(u), int(step))
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    def evaluate_ocp_cost(self, iterate) -> float:
        """Total trajectory cost; iterate is a dict or an object with x
        (N+1, nx) and u (N, nu) (reference evaluate_ocp_cost)."""
        xs = np.asarray(iterate["x"] if isinstance(iterate, dict)
                        else iterate.x)
        us = np.asarray(iterate["u"] if isinstance(iterate, dict)
                        else iterate.u)
        total = 0.0
        for k in range(self._N):
            total += float(self.evaluate(xs[k], us[k], k)["cost"])
        total += float(self.evaluate(xs[self._N],
                                     np.zeros(self._form.nu),
                                     self._N)["cost"])
        return total


def create_model_with_cost_state(ocp) -> Tuple[AcadosModel, np.ndarray]:
    """Augment the model with a cost state that integrates the path cost
    and the slack penalties (reference mpc_utils.py:389).

    Returns (augmented AcadosModel, parameter_values): the explicit
    dynamics f_aug(x_aug, u, p, t) with x_aug = [x; cost_state] and
    d(cost_state)/dt = the path cost rate plus the l1 and quadratic
    penalties of the soft rows' violations, the terms the solver's soft
    constraints penalize, at the first path stage's data."""
    form, data, _ = build_ocp(copy.deepcopy(ocp))
    nx = form.nx
    f = normalize_dynamics(ocp.model.f_expl_expr)
    if f is None:
        raise ValueError("create_model_with_cost_state needs f_expl_expr")
    yref, W = data["yref"][0], data["W"][0]
    bounds = tuple(data[k][0] for k in ("lb", "ub", "Zl", "Zu", "zl", "zu"))

    def cost_rate(x, u, p, t):
        base = form.cost.value(x, u, p, t, {"yref": _const(yref, x),
                                            "W": _const(W, x)})
        _, pen = _violation_terms(form.con, form.con.eval_rows(x, u, p, t),
                                  *(_const(a, x) for a in bounds))
        return base + pen

    def f_aug(x_aug, u, p, t):
        x = x_aug[:nx]
        return torch.cat([f(x, u, p, t), cost_rate(x, u, p, t)[None]])

    model = copy.deepcopy(ocp.model)
    model.name = (model.name or "model") + "_with_cost_state"
    model.x = nx + 1
    model.f_expl_expr = f_aug
    model.f_impl_expr = None
    pv = (np.asarray(ocp.parameter_values)
          if getattr(ocp, "parameter_values", None) is not None
          else np.zeros(_dim_of(ocp.model.p)))
    return model, pv


def detect_constraint_structure(model, constraints, stage_type: str = "path",
                                n_probe: int = 6, tol: float = 1e-9,
                                seed: int = 0):
    """Classify each nonlinear row h_i(x, u) as a variable bound, a general
    linear row or a nonlinear row, and move it into that field (reference
    mpc_utils.py:462 does this symbolically; here by Jacobian-constancy
    probes at n_probe seeded random points, float64).

    Mutates `constraints` in place: rows found to be bounds extend
    idxbx/lbx/ubx (or idxbu/lbu/ubu), linear rows extend C/D/lg/ug, the
    rest stay in con_h_expr. stage_type in {'initial', 'path',
    'terminal'}."""
    sfx = {"initial": "_0", "path": "", "terminal": "_e"}[stage_type]
    h = getattr(model, "con_h_expr" + sfx, None)
    if h is None:
        return
    nx, nu = _dim_of(model.x), _dim_of(model.u)
    hf = normalize_dynamics(h)
    p0 = torch.zeros(_dim_of(model.p), dtype=_F64)
    rng = np.random.default_rng(seed)
    jac = torch.func.jacfwd(lambda xu: hf(xu[:nx], xu[nx:], p0, 0.0))
    Js = np.stack([jac(torch.as_tensor(rng.normal(size=nx + nu),
                                       dtype=_F64)).numpy()
                   for _ in range(n_probe)])
    nh = Js.shape[1]
    row_var = np.abs(Js - Js[0]).max(axis=(0, 2))
    J0 = Js[0]
    h0 = hf(torch.zeros(nx, dtype=_F64), torch.zeros(nu, dtype=_F64), p0,
            0.0).numpy()

    # moving h rows into bound or general-linear fields shifts every row
    # index; the soft-slack index layout (idxsh/idxsg offsets over
    # nbu + nbx + ng) would need remapping alongside: refuse rather than
    # slack the wrong rows
    for sname in ("idxsh" + sfx, "idxsg" + sfx):
        sidx = getattr(constraints, sname, None)
        if sidx is not None and np.asarray(sidx).size:
            raise NotImplementedError(
                f"detect_constraint_structure does not remap soft-slack "
                f"indices ({sname} is non-empty); detect before softening "
                f"or keep the rows in h")

    lh = np.atleast_1d(np.asarray(getattr(constraints, "lh" + sfx)))
    uh = np.atleast_1d(np.asarray(getattr(constraints, "uh" + sfx)))

    keep, bx, bu, lin = [], [], [], []
    for i in range(nh):
        if row_var[i] > tol:
            keep.append(i)
            continue
        nz = np.nonzero(np.abs(J0[i]) > tol)[0]
        if len(nz) == 1 and abs(J0[i, nz[0]] - 1.0) < tol \
                and abs(h0[i]) < tol:
            (bx if nz[0] < nx else bu).append(i)
        else:
            lin.append(i)

    def _append(name, arr):
        old = getattr(constraints, name, None)
        if old is None or np.asarray(old).size == 0:
            setattr(constraints, name, np.asarray(arr))
        else:
            setattr(constraints, name,
                    np.concatenate([np.atleast_1d(np.asarray(old)),
                                    np.atleast_1d(np.asarray(arr))]))

    col = lambda i: int(np.nonzero(np.abs(J0[i]) > tol)[0][0])
    for i in bx:
        _append("idxbx" + sfx, [col(i)])
        _append("lbx" + sfx, [lh[i]])
        _append("ubx" + sfx, [uh[i]])
    if stage_type != "terminal":
        for i in bu:
            _append("idxbu" + sfx, [col(i) - nx])
            _append("lbu" + sfx, [lh[i]])
            _append("ubu" + sfx, [uh[i]])
    else:
        keep = sorted(keep + bu)
    if lin:
        Cn = J0[lin][:, :nx]
        Dn = J0[lin][:, nx:]
        Cold = getattr(constraints, "C" + sfx, None)
        if Cold is None or np.asarray(Cold).size == 0:
            setattr(constraints, "C" + sfx, Cn)
            if stage_type != "terminal":
                setattr(constraints, "D" + sfx, Dn)
        else:
            setattr(constraints, "C" + sfx, np.vstack([np.asarray(Cold), Cn]))
            if stage_type != "terminal":
                setattr(constraints, "D" + sfx,
                        np.vstack([np.atleast_2d(getattr(constraints,
                                                         "D" + sfx)), Dn]))
        _append("lg" + sfx, lh[lin] - h0[lin])
        _append("ug" + sfx, uh[lin] - h0[lin])

    if keep:
        kept = list(keep)

        def h_kept(x, u, p=None, t=None):
            return hf(x, u, p0.to(x) if p is None else p,
                      0.0 if t is None else t)[kept]

        setattr(model, "con_h_expr" + sfx, h_kept)
        setattr(constraints, "lh" + sfx, lh[np.asarray(keep)])
        setattr(constraints, "uh" + sfx, uh[np.asarray(keep)])
    else:
        setattr(model, "con_h_expr" + sfx, None)
        setattr(constraints, "lh" + sfx, None)
        setattr(constraints, "uh" + sfx, None)


def create_ocp_with_control_horizon(ocp, Nc: int, Nr: int = None):
    """Move blocking: Nc shooting intervals with free controls, then the
    last applied control held over Nr remaining intervals (reference
    mpc_utils.py:665). Returns an AcadosMultiphaseOcp with the phases
    [original x Nc, transition x 1, held control x Nr]; the transition
    stage's control is the decision that is held.

    Takes ERK or DISCRETE dynamics and NONLINEAR_LS, LINEAR_LS or
    EXTERNAL path costs."""
    so = ocp.solver_options
    Np = so.N_horizon
    if Nr is None:
        Nr = Np - Nc
    if Nc == Np or Nr == 0:
        return copy.deepcopy(ocp)
    if Nc > Np:
        raise ValueError("control horizon cannot exceed prediction horizon")
    if Nc <= 0:
        raise ValueError("control horizon must be at least 1")
    if so.integrator_type not in ("ERK", "DISCRETE"):
        raise NotImplementedError(
            f"create_ocp_with_control_horizon: {so.integrator_type}")

    nx, nu = _dim_of(ocp.model.x), _dim_of(ocp.model.u)
    Ts = float(so.tf) / Np

    ph0 = copy.deepcopy(ocp)

    # transition: x -> [x; u], the stage's control becomes the held value
    ph1 = AcadosOcp()
    m1 = AcadosModel()
    m1.name = (ocp.model.name or "model") + "_trns"
    m1.x, m1.u = nx, nu
    m1.disc_dyn_expr = lambda x, u: torch.cat([x, u])
    ph1.model = m1
    ph1.cost.cost_type = "NONLINEAR_LS"
    m1.cost_y_expr = lambda x, u: u
    ph1.cost.W = np.zeros((nu, nu))  # a stage without cost
    ph1.cost.yref = np.zeros(nu)
    for f in ("lbu", "ubu", "idxbu"):
        setattr(ph1.constraints, f,
                copy.deepcopy(getattr(ocp.constraints, f)))

    # held-control phase: x_aug = [x; u], no controls
    ph2 = AcadosOcp()
    m2 = AcadosModel()
    m2.name = (ocp.model.name or "model") + "_held"
    m2.x, m2.u = nx + nu, 0
    if so.integrator_type == "ERK":
        f0 = normalize_dynamics(ocp.model.f_expl_expr)
        m2.f_expl_expr = lambda x, u, p, t: torch.cat(
            [f0(x[:nx], x[nx:], p, t), x.new_zeros((nu,))])
    else:
        d0 = normalize_dynamics(ocp.model.disc_dyn_expr)
        m2.disc_dyn_expr = lambda x, u, p, t: torch.cat(
            [d0(x[:nx], x[nx:], p, t), x[nx:]])
    ph2.model = m2
    ct = ocp.cost.cost_type
    ph2.cost.cost_type = "NONLINEAR_LS" if ct == "LINEAR_LS" else ct
    if ct == "NONLINEAR_LS":
        y0 = ocp.model.cost_y_expr
        m2.cost_y_expr = lambda x, u: y0(x[:nx], x[nx:])
        ph2.cost.W = copy.deepcopy(ocp.cost.W)
        ph2.cost.yref = copy.deepcopy(ocp.cost.yref)
    elif ct == "LINEAR_LS":
        Vaug = np.hstack([np.asarray(ocp.cost.Vx), np.asarray(ocp.cost.Vu)])
        m2.cost_y_expr = lambda x, u: _const(Vaug, x) @ x
        ph2.cost.W = copy.deepcopy(ocp.cost.W)
        ph2.cost.yref = copy.deepcopy(ocp.cost.yref)
    elif ct == "EXTERNAL":
        e0 = ocp.model.cost_expr_ext_cost
        m2.cost_expr_ext_cost = lambda x, u: e0(x[:nx], x[nx:])
    else:
        raise NotImplementedError(f"cost_type {ct}")
    # the terminal cost of the original OCP
    ph2.cost.cost_type_e = ocp.cost.cost_type_e
    if ocp.cost.cost_type_e == "NONLINEAR_LS":
        ye = ocp.model.cost_y_expr_e
        m2.cost_y_expr_e = lambda x: ye(x[:nx])
        ph2.cost.W_e = copy.deepcopy(ocp.cost.W_e)
        ph2.cost.yref_e = copy.deepcopy(ocp.cost.yref_e)
    elif ocp.cost.cost_type_e == "LINEAR_LS":
        Vxe = np.asarray(ocp.cost.Vx_e)
        Vxe_aug = np.hstack([Vxe, np.zeros((Vxe.shape[0], nu))])
        ph2.cost.cost_type_e = "NONLINEAR_LS"
        m2.cost_y_expr_e = lambda x: _const(Vxe_aug, x) @ x
        ph2.cost.W_e = copy.deepcopy(ocp.cost.W_e)
        ph2.cost.yref_e = copy.deepcopy(ocp.cost.yref_e)
    elif ocp.cost.cost_type_e == "EXTERNAL":
        ee = ocp.model.cost_expr_ext_cost_e
        m2.cost_expr_ext_cost_e = lambda x: ee(x[:nx])
    elif ocp.cost.cost_type_e is not None:
        raise NotImplementedError(
            f"cost_type_e {ocp.cost.cost_type_e} for control horizon")
    # state bounds carry over
    con0 = ocp.constraints
    if con0.idxbx is not None and np.asarray(con0.idxbx).size:
        ph2.constraints.idxbx = np.asarray(con0.idxbx)
        ph2.constraints.lbx = copy.deepcopy(con0.lbx)
        ph2.constraints.ubx = copy.deepcopy(con0.ubx)

    mocp = AcadosMultiphaseOcp([Nc, 1, Nr])
    mocp.set_phase(ph0, 0)
    mocp.set_phase(ph1, 1)
    mocp.set_phase(ph2, 2)
    mocp.solver_options = copy.deepcopy(so)
    mocp.solver_options.N_horizon = None
    mocp.solver_options.tf = float(so.tf) + 1.0
    mocp.solver_options.time_steps = np.array(
        Nc * [Ts] + [1.0] + Nr * [Ts])
    mocp.mocp_opts.integrator_type = [so.integrator_type, "DISCRETE",
                                      so.integrator_type]
    return mocp
