"""AcadosMultiphaseOcp: multiphase OCP description and builder.

Counterpart of `acados_tpu/interface/multiphase.py` (reference
acados_multiphase_ocp.py:95-247 and the mocp transition example,
examples/acados_python/mocp_transition_example/main.py): phases with
different nx/nu joined by N = 1 DISCRETE transition phases.

Phase-varying dims (static shapes): every phase is padded to
(nx_max, nu_max). Padded state and control coordinates get
  - zero dynamics output (they reset to 0 across every interval),
  - an eps least-squares penalty appended to the phase's cost residual
    (keeps the Riccati factorizations positive definite),
  - no constraint rows.
Cost residuals are padded to a common ny, so yref/W stay one
(N-1, ny)/(N-1, ny, ny) pair; the padding rows of W are zero except the
eps-regularization block.

A multiphase OCP solves through AcadosOcpSolver only, as in the JAX
package: AcadosOcpBatchSolver refuses it (the JAX package's batch solver
builds single-phase OCPs alone).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from acados_tpu_torch.interface.acados_ocp import (AcadosModel, AcadosOcp,
                                                   AcadosOcpConstraints,
                                                   AcadosOcpCost,
                                                   AcadosOcpOptions, _dim_of)
from acados_tpu_torch.interface.builder import (StageLayout, _build_con_specs,
                                                _build_cost_spec,
                                                _class_bounds,
                                                _class_slack_penalties,
                                                _norm4)
from acados_tpu_torch.ocp_nlp.multiphase import (OcpNlpMpFormulation,
                                                 PhaseSegment)
from acados_tpu_torch.sim.integrator import (SimOpts, make_step_fn,
                                             make_step_jac_fn, step_jac_of)

PAD_EPS = 1e-6


@dataclasses.dataclass
class AcadosMultiphaseOptions:
    """Phase-wise options (reference AcadosMultiphaseOptions,
    acados_multiphase_ocp.py:95-160)."""

    integrator_type: Optional[List[str]] = None
    collocation_type: Optional[List[str]] = None
    cost_discretization: Optional[List[str]] = None


class AcadosMultiphaseOcp:
    """Reference: acados_multiphase_ocp.py:190-247. The initial cost and
    constraints come from the first phase, the terminal ones from the
    last; the phases in between give dynamics and path cost and
    constraints."""

    def __init__(self, N_list: List[int]):
        if not N_list or any(int(n) < 1 for n in N_list):
            raise ValueError("N_list must be positive ints")
        self.N_list = [int(n) for n in N_list]
        self.n_phases = len(N_list)
        self.name = "mocp"
        self.model = [AcadosModel() for _ in N_list]
        self.cost = [AcadosOcpCost() for _ in N_list]
        self.constraints = [AcadosOcpConstraints() for _ in N_list]
        self.solver_options = AcadosOcpOptions()
        self.mocp_opts = AcadosMultiphaseOptions()
        self.parameter_values = [None for _ in N_list]

    def set_phase(self, ocp: AcadosOcp, phase_idx: int):
        """Install an AcadosOcp's model, cost and constraints as phase
        `phase_idx` (reference set_phase)."""
        self.model[phase_idx] = ocp.model
        self.cost[phase_idx] = ocp.cost
        self.constraints[phase_idx] = ocp.constraints
        self.parameter_values[phase_idx] = ocp.parameter_values
        return self


def _phase_dims(mocp) -> list:
    return [(_dim_of(m.x, 0), _dim_of(m.u, 0)) for m in mocp.model]


def phase_of_stage(mocp, stage: int) -> int:
    """The phase a stage belongs to (stage N to the last phase)."""
    starts = np.cumsum(mocp.N_list)
    return min(int(np.searchsorted(starts, stage, side="right")),
               mocp.n_phases - 1)


def _padded_step(step_i, nx_i, nu_i, nx_max):
    """A batch-first phase step on the padded coordinates: its output
    zero-padded to nx_max by a new tensor (it runs under vmap and
    jacfwd)."""
    def step(x, u, p, t, dt):
        out = step_i(x[:, :nx_i], u[:, :nu_i], p, t, dt)
        return F.pad(out, (0, nx_max - out.shape[-1]))
    return step


def _padded_step_jac(step_jac_i, nx_i, nu_i, nx_max, nu_max):
    """A batch-first phase step Jacobian on the padded coordinates: the
    phase's (x_next, A, B) on its own coordinates, zero-padded to
    (nx_max,), (nx_max, nx_max) and (nx_max, nu_max)."""
    def step_jac(x, u, p, t, dt):
        xn, A, B = step_jac_i(x[:, :nx_i], u[:, :nu_i], p, t, dt)[:3]
        pad_out = nx_max - xn.shape[-1]
        return (F.pad(xn, (0, pad_out)),
                F.pad(A, (0, nx_max - nx_i, 0, pad_out)),
                F.pad(B, (0, nu_max - nu_i, 0, pad_out)))
    return step_jac


def _pad_cost_spec(spec, nx_i, nu_i, nx_max, nu_max, ny_tot, n_reg):
    """A phase's CostSpec on the global dims: the residual padded to
    ny_tot, with the eps-regularization rows of the padded coordinates
    appended."""
    if spec.with_z:
        raise NotImplementedError(
            "a multiphase OCP whose cost reads z is not supported (the JAX "
            "package's padded cost drops z)")
    seps = float(np.sqrt(PAD_EPS))

    if spec.kind in ("LINEAR_LS", "NONLINEAR_LS", "CONL"):
        ny_i = spec.ny
        y0 = spec.y_fun

        def y_fun(x, u, p, t):
            y = y0(x[:nx_i], u[:nu_i], p, t)
            pads = torch.cat([x[nx_i:nx_max], u[nu_i:nu_max]])
            fill = x.new_zeros((ny_tot - ny_i - n_reg,))
            return torch.cat([y, seps * pads, fill])

        if spec.kind == "CONL":
            psi0 = spec.psi_fun

            def psi_fun(r, p):
                # a quadratic pass-through for the regularization rows
                return psi0(r[:ny_i], p) + 0.5 * (
                    r[ny_i:ny_i + n_reg] ** 2).sum()

            return dataclasses.replace(spec, ny=ny_tot, y_fun=y_fun,
                                       psi_fun=psi_fun)
        return dataclasses.replace(spec, kind="NONLINEAR_LS", ny=ny_tot,
                                   y_fun=y_fun, Vx=None, Vu=None)
    if spec.kind == "EXTERNAL":
        f0 = spec.ext_fun

        def ext_fun(x, u, p, t):
            pads = torch.cat([x[nx_i:nx_max], u[nu_i:nu_max]])
            return f0(x[:nx_i], u[:nu_i], p, t) \
                + 0.5 * PAD_EPS * (pads ** 2).sum()

        return dataclasses.replace(spec, ext_fun=ext_fun)
    raise ValueError(spec.kind)


def _pad_W_yref(W, yref, ny_i, ny_tot, n_reg):
    """Weight and reference padded to the common residual dim, with the
    identity on the eps-regularization rows (their scale is in y)."""
    Wp = np.zeros((ny_tot, ny_tot))
    Wp[:ny_i, :ny_i] = np.atleast_2d(W)
    for j in range(ny_i, ny_i + n_reg):
        Wp[j, j] = 1.0
    yp = np.zeros(ny_tot)
    yp[:ny_i] = np.atleast_1d(yref)
    return Wp, yp


def _pad_con_spec(spec, nx_i, nu_i, nx_max, nu_max):
    """Constraint rows act on the phase's own coordinates: only the h and
    r callables take sliced arguments; the box and general rows index
    the unpadded prefix already."""
    if spec.with_z:
        raise NotImplementedError(
            "a multiphase OCP whose h rows read z is not supported (the "
            "JAX package's padded rows drop z)")
    ch = {}
    if spec.h_fun is not None:
        h0 = spec.h_fun
        ch["h_fun"] = lambda x, u, p, t: h0(x[:nx_i], u[:nu_i], p, t)
    if spec.r_fun is not None:
        r0 = spec.r_fun
        ch["r_fun"] = lambda x, u, p, t: r0(x[:nx_i], u[:nu_i], p, t)
    if spec.Cg is not None:
        Cg = np.zeros((spec.Cg.shape[0], nx_max))
        Cg[:, :nx_i] = spec.Cg
        ch["Cg"] = Cg
    if spec.Dg is not None:
        Dg = np.zeros((spec.Dg.shape[0], nu_max))
        Dg[:, :nu_i] = spec.Dg
        ch["Dg"] = Dg
    return dataclasses.replace(spec, nx=nx_max, nu=nu_max, **ch)


def _phase_dynamics(m, itype, nx_i, nu_i, so, collocation_type):
    """(step, step_jac) of one phase on its own coordinates, batch-first:
    DISCRETE through vmap and jacfwd of disc_dyn_expr, ERK and IRK
    through the integrator factory (the step Jacobian the single-phase
    builder takes, without jac_reuse: the JAX package differentiates the
    plain step here)."""
    if itype == "DISCRETE":
        if m.disc_dyn_expr is None:
            raise ValueError("DISCRETE needs disc_dyn_expr")
        f = _norm4(m.disc_dyn_expr)
        one = lambda x, u, p, t, dt: f(x, u, p, t)
        return torch.func.vmap(one), step_jac_of(one, nx_i)
    if _dim_of(m.z, 0):
        raise NotImplementedError(
            "a multiphase OCP with a DAE phase (nz > 0) is not supported "
            "(the JAX package's padded step takes an ODE's x_next)")
    opts = SimOpts(integrator_type=itype,
                   num_stages=so.sim_method_num_stages,
                   num_steps=so.sim_method_num_steps,
                   newton_iter=so.sim_method_newton_iter,
                   collocation_type=collocation_type)
    kw = dict(f_expl=m.f_expl_expr, f_impl=m.f_impl_expr, nx=nx_i, nu=nu_i,
              opts=opts)
    return make_step_fn(**kw), make_step_jac_fn(**kw)


def build_mocp(mocp: AcadosMultiphaseOcp):
    """AcadosMultiphaseOcp -> (OcpNlpMpFormulation, data (numpy dict),
    layouts), the data keys and shapes as the JAX package's build_mocp."""
    n_ph = mocp.n_phases
    so = mocp.solver_options
    dims = _phase_dims(mocp)
    nx_max = max(d[0] for d in dims)
    nu_max = max(1, max(d[1] for d in dims))
    N = sum(mocp.N_list)
    starts = np.concatenate([[0], np.cumsum(mocp.N_list)]).astype(int)
    itypes = mocp.mocp_opts.integrator_type or \
        [so.integrator_type] * n_ph

    # time grid
    if so.time_steps is not None:
        dts = np.asarray(so.time_steps, np.float64)
        if dts.shape[0] != N:
            raise ValueError("time_steps must have sum(N_list) entries")
    elif so.tf is not None:
        dts = np.full(N, so.tf / N)
    else:
        raise ValueError("set solver_options.tf or time_steps")
    ts = np.concatenate([[0.0], np.cumsum(dts)])
    cost_scale = np.concatenate([dts, [1.0]])

    # per-phase specs from the single-phase builder's helpers
    phase_cost, phase_con0, phase_conp, phase_cone = [], [], [], []
    phase_cost0, phase_coste = [], []
    for i in range(n_ph):
        tmp = AcadosOcp()
        tmp.model = mocp.model[i]
        tmp.cost = mocp.cost[i]
        tmp.constraints = mocp.constraints[i]
        tmp.solver_options = so
        tmp.parameter_values = mocp.parameter_values[i]
        c0, cp, ce = _build_con_specs(tmp, dims[i][0], dims[i][1])
        phase_con0.append(c0)
        phase_conp.append(cp)
        phase_cone.append(ce)
        phase_cost0.append(_build_cost_spec(tmp, "0"))
        phase_cost.append(_build_cost_spec(tmp, "path"))
        phase_coste.append(_build_cost_spec(tmp, "e"))

    # residual padding bookkeeping
    ny_list = [max(s.ny, 0) for s in phase_cost]
    nreg_list = [(nx_max - d[0]) + (nu_max - d[1]) for d in dims]
    ny_tot = max(ny + nr for ny, nr in zip(ny_list, nreg_list))

    segments = []
    for i in range(n_ph):
        nx_i, nu_i = dims[i]
        coll = (mocp.mocp_opts.collocation_type[i]
                if mocp.mocp_opts.collocation_type else so.collocation_type)
        step_i, step_jac_i = _phase_dynamics(mocp.model[i], itypes[i], nx_i,
                                             nu_i, so, coll)
        segments.append(PhaseSegment(
            start=int(starts[i]), stop=int(starts[i + 1]),
            step_fn=_padded_step(step_i, nx_i, nu_i, nx_max),
            step_jac_fn=_padded_step_jac(step_jac_i, nx_i, nu_i, nx_max,
                                         nu_max),
            cost=_pad_cost_spec(phase_cost[i], nx_i, nu_i, nx_max, nu_max,
                                ny_tot, nreg_list[i]),
            con=_pad_con_spec(phase_conp[i], nx_i, nu_i, nx_max, nu_max)))

    (nx_0, nu_0), (nx_e, nu_e) = dims[0], dims[-1]
    form = OcpNlpMpFormulation(
        N=N, nx=nx_max, nu=nu_max, np_=0, segments=tuple(segments),
        cost_0=_pad_cost_spec(phase_cost0[0], nx_0, nu_0, nx_max, nu_max,
                              ny_tot, nreg_list[0]),
        con_0=_pad_con_spec(phase_con0[0], nx_0, nu_0, nx_max, nu_max),
        cost_e=_pad_cost_spec(phase_coste[-1], nx_e, nu_e, nx_max, nu_max,
                              ny_tot, nreg_list[-1]),
        con_e=_pad_con_spec(phase_cone[-1], nx_e, nu_e, nx_max, nu_max),
        exact_hessian=(so.hessian_approx == "EXACT"))

    nc = form.nc
    lay_0 = StageLayout(form.con_0)
    lay_e = StageLayout(form.con_e)
    lay_p = [StageLayout(s.con) for s in segments]

    # per-stage data arrays
    def class_bounds(i, which):
        con = mocp.constraints[i]
        if which == "0":
            lbx0 = con.lbx_0 if con.lbx_0 is not None else con.x0
            ubx0 = con.ubx_0 if con.ubx_0 is not None else con.x0
            return _class_bounds(
                lay_0, nc, lbx0, ubx0, con.lbu, con.ubu, con.lg, con.ug,
                con.lh_0 if con.lh_0 is not None else con.lh,
                con.uh_0 if con.uh_0 is not None else con.uh,
                con.lphi_0 if con.lphi_0 is not None else con.lphi,
                con.uphi_0 if con.uphi_0 is not None else con.uphi)
        if which == "e":
            return _class_bounds(lay_e, nc, con.lbx_e, con.ubx_e, None,
                                 None, con.lg_e, con.ug_e, con.lh_e,
                                 con.uh_e, con.lphi_e, con.uphi_e)
        return _class_bounds(lay_p[i], nc, con.lbx, con.ubx, con.lbu,
                             con.ubu, con.lg, con.ug, con.lh, con.uh,
                             con.lphi, con.uphi)

    lb_0, ub_0 = class_bounds(0, "0")
    lb_e, ub_e = class_bounds(n_ph - 1, "e")
    lb, ub = np.zeros((N - 1, nc)), np.zeros((N - 1, nc))
    yref, W = np.zeros((N - 1, ny_tot)), np.zeros((N - 1, ny_tot, ny_tot))
    Zl, Zu = np.zeros((N - 1, nc)), np.zeros((N - 1, nc))
    zl, zu = np.zeros((N - 1, nc)), np.zeros((N - 1, nc))
    for k in range(1, N):
        i = int(np.searchsorted(starts[1:], k, side="right"))
        lb[k - 1], ub[k - 1] = class_bounds(i, "p")
        c = mocp.cost[i]
        W[k - 1], yref[k - 1] = _pad_W_yref(
            c.W if c.W is not None else np.zeros((ny_list[i], ny_list[i])),
            c.yref if c.yref is not None else np.zeros(ny_list[i]),
            ny_list[i], ny_tot, nreg_list[i])
        Zl[k - 1], Zu[k - 1], zl[k - 1], zu[k - 1] = _class_slack_penalties(
            phase_conp[i], nc, c.Zl, c.Zu, c.zl, c.zu)

    c0, ce = mocp.cost[0], mocp.cost[-1]
    ny0, nye = phase_cost0[0].ny, phase_coste[-1].ny
    W_0, yref_0 = _pad_W_yref(
        (c0.W_0 if c0.W_0 is not None else c0.W) if ny0
        else np.zeros((0, 0)),
        (c0.yref_0 if c0.yref_0 is not None else c0.yref) if ny0
        else np.zeros(0), ny0, ny_tot, nreg_list[0])
    W_e, yref_e = _pad_W_yref(
        ce.W_e if ce.W_e is not None else np.zeros((nye, nye)),
        ce.yref_e if ce.yref_e is not None else np.zeros(nye),
        nye, ny_tot, nreg_list[-1])
    Zl_0, Zu_0, zl_0, zu_0 = _class_slack_penalties(
        phase_con0[0], nc, c0.Zl, c0.Zu, c0.zl, c0.zu)
    Zl_e, Zu_e, zl_e, zu_e = _class_slack_penalties(
        phase_cone[-1], nc, ce.Zl_e, ce.Zu_e, ce.zl_e, ce.zu_e)

    data = dict(
        p=np.zeros((N + 1, 0)), ts=ts, dts=dts, cost_scale=cost_scale,
        yref_0=yref_0, W_0=W_0, yref=yref, W=W, yref_e=yref_e, W_e=W_e,
        lb_0=lb_0, ub_0=ub_0, lb=lb, ub=ub, lb_e=lb_e, ub_e=ub_e,
        Zl_0=Zl_0, Zu_0=Zu_0, zl_0=zl_0, zu_0=zu_0,
        Zl=Zl, Zu=Zu, zl=zl, zu=zu,
        Zl_e=Zl_e, Zu_e=Zu_e, zl_e=zl_e, zu_e=zu_e)
    layouts = {"0": lay_0, "p": lay_p, "e": lay_e}
    return form, data, layouts
