"""AcadosOcp -> internal formulation + default runtime data.

Counterpart of `acados_tpu/interface/builder.py`: dimension inference,
folding box/general/nonlinear constraints into unified rows, and laying
out the runtime data. `build_ocp` returns the same numpy data dict (same
keys, same shapes) as the JAX package's, so either package's dict can be
turned into the port's batch-first `NlpData` by `data_to_torch`.

Ported: ERK and IRK dynamics, LINEAR_LS / NONLINEAR_LS / EXTERNAL costs
with the Gauss-Newton Hessian, BGH constraints with soft rows. The rest
raises NotImplementedError naming its ROADMAP.md item.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import AcadosOcp, _dim_of
from acados_tpu_torch.ocp_nlp.formulation import (ConstraintSpec, CostSpec,
                                                  NlpData, OcpNlpFormulation,
                                                  _const)
from acados_tpu_torch.sim.integrator import (SimOpts, make_step_fn,
                                             make_step_jac_fn)
from acados_tpu_torch.utils.types import ACADOS_INFTY


def _not_ported(what: str, item: str = "NLP breadth"):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, {item})")


def _norm4(f):
    """Normalize (x, u[, p[, t]]) callables to (x, u, p, t)."""
    if f is None:
        return None
    params = list(inspect.signature(f).parameters)
    if "z" in params:
        raise _not_ported("a cost/constraint expression of z",
                          "integrator breadth")
    n = len(params)
    if n == 2:
        return lambda x, u, p, t: f(x, u)
    if n == 3:
        return lambda x, u, p, t: f(x, u, p)
    return f


def _norm_term(f):
    """Normalize terminal (x[, p[, t]]) callables to (x, u, p, t)."""
    if f is None:
        return None
    n = len(inspect.signature(f).parameters)
    if n == 1:
        return lambda x, u, p, t: f(x)
    if n == 2:
        return lambda x, u, p, t: f(x, p)
    return lambda x, u, p, t: f(x, p, t)


class StageLayout:
    """Row offsets of the unified constraint block for one stage class."""

    def __init__(self, spec: ConstraintSpec):
        self.nbx, self.nbu = spec.nbx, spec.nbu
        self.ng, self.nh = spec.ng, spec.nh
        self.nphi = 0
        self.off_bx = 0
        self.off_bu = self.nbx
        self.off_g = self.nbx + self.nbu
        self.off_h = self.off_g + self.ng
        self.off_phi = self.off_h + self.nh
        self.nrows = spec.nrows


def _linear_ls_yfun(Vx, Vu):
    Vx = np.asarray(Vx, np.float64)
    Vu = None if Vu is None else np.asarray(Vu, np.float64)

    def y(x, u, p, t):
        out = _const(Vx, x) @ x
        if Vu is not None:
            out = out + _const(Vu, x) @ u
        return out

    return y, Vx.shape[0]


def _zero_cost(x, u, p, t):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _build_cost_spec(ocp: AcadosOcp, which: str):
    """which in {'0', 'path', 'e'}; the _0 variant falls back to the path
    cost (reference make_consistent behavior)."""
    c, m = ocp.cost, ocp.model
    if which == "0":
        kind = c.cost_type_0 or c.cost_type
        Vx = c.Vx_0 if c.Vx_0 is not None else c.Vx
        Vu = c.Vu_0 if c.Vu_0 is not None else c.Vu
        y_expr = m.cost_y_expr_0 or m.cost_y_expr
        yref = c.yref_0 if c.yref_0 is not None else c.yref
        ext = m.cost_expr_ext_cost_0 or m.cost_expr_ext_cost
        Vz = c.Vz_0 if c.Vz_0 is not None else c.Vz
    elif which == "path":
        kind = c.cost_type
        Vx, Vu, y_expr, yref = c.Vx, c.Vu, m.cost_y_expr, c.yref
        ext, Vz = m.cost_expr_ext_cost, c.Vz
    else:
        kind = c.cost_type_e or c.cost_type
        if kind == "LINEAR_LS":
            if c.Vx_e is None:
                # no terminal cost specified -> zero terminal cost
                return CostSpec(kind="EXTERNAL", ext_fun=_zero_cost)
            y, ny = _linear_ls_yfun(c.Vx_e, None)
            return CostSpec(kind="LINEAR_LS", ny=ny, y_fun=y,
                            Vx=np.asarray(c.Vx_e, np.float64))
        if kind == "NONLINEAR_LS":
            return CostSpec(kind=kind, ny=_dim_of(c.yref_e),
                            y_fun=_norm_term(m.cost_y_expr_e))
        if kind == "EXTERNAL":
            f = m.cost_expr_ext_cost_e
            return CostSpec(kind="EXTERNAL", ext_fun=(
                _zero_cost if f is None else _norm_term(f)))
        raise _not_ported(f"cost type {kind!r}")
    if Vz is not None:
        raise _not_ported("LINEAR_LS with a Vz block", "integrator breadth")
    if kind == "LINEAR_LS":
        y, ny = _linear_ls_yfun(Vx, Vu)
        return CostSpec(kind=kind, ny=ny, y_fun=y,
                        Vx=np.asarray(Vx, np.float64),
                        Vu=None if Vu is None else np.asarray(Vu, np.float64))
    if kind == "NONLINEAR_LS":
        return CostSpec(kind=kind, ny=_dim_of(yref), y_fun=_norm4(y_expr))
    if kind == "EXTERNAL":
        return CostSpec(kind=kind, ext_fun=_norm4(ext))
    raise _not_ported(f"cost type {kind!r}")


def _idx(v):
    return tuple(int(i) for i in np.atleast_1d(v)) if v is not None else ()


def _build_con_specs(ocp: AcadosOcp, nx, nu):
    con, m = ocp.constraints, ocp.model
    if any(getattr(m, f) is not None for f in (
            "con_phi_expr_0", "con_phi_expr", "con_phi_expr_e")):
        raise _not_ported("BGP (convex-over-nonlinear) constraints")

    idxbx_0 = _idx(con.idxbx_0)
    if con.x0 is not None and not idxbx_0:
        idxbx_0 = tuple(range(nx))
    h0 = _norm4(m.con_h_expr_0 or m.con_h_expr)
    nh0 = _dim_of(con.lh_0 if con.lh_0 is not None else con.lh) \
        if h0 is not None else 0
    hp = _norm4(m.con_h_expr)
    nhp = _dim_of(con.lh if con.lh is not None else con.uh) \
        if hp is not None else 0
    he = _norm_term(m.con_h_expr_e) if m.con_h_expr_e is not None else None
    nhe = _dim_of(con.lh_e if con.lh_e is not None else con.uh_e) \
        if he is not None else 0

    Cg = None if con.C is None else np.atleast_2d(con.C)
    Dg = None if con.D is None else np.atleast_2d(con.D)
    Ce = None if con.C_e is None else np.atleast_2d(con.C_e)
    ng = 0 if Cg is None else Cg.shape[0]

    def soft_rows(nbx, nbu, ng_, idxsbx, idxsbu, idxsg, idxsh):
        rows = [i for i in _idx(idxsbx)]
        rows += [nbx + i for i in _idx(idxsbu)]
        rows += [nbx + nbu + i for i in _idx(idxsg)]
        rows += [nbx + nbu + ng_ + i for i in _idx(idxsh)]
        return tuple(rows)

    idxbu = _idx(con.idxbu)
    idxbx = _idx(con.idxbx)
    con_0 = ConstraintSpec(
        nx=nx, nu=nu, idxbx=idxbx_0, idxbu=idxbu, Cg=Cg, Dg=Dg,
        nh=nh0, h_fun=h0,
        soft_rows=soft_rows(len(idxbx_0), len(idxbu), ng, None,
                            con.idxsbu, con.idxsg,
                            con.idxsh_0 if con.idxsh_0 is not None
                            else con.idxsh))
    con_p = ConstraintSpec(
        nx=nx, nu=nu, idxbx=idxbx, idxbu=idxbu, Cg=Cg, Dg=Dg,
        nh=nhp, h_fun=hp,
        soft_rows=soft_rows(len(idxbx), len(idxbu), ng, con.idxsbx,
                            con.idxsbu, con.idxsg, con.idxsh))
    idxbx_e = _idx(con.idxbx_e)
    con_e = ConstraintSpec(
        nx=nx, nu=nu, idxbx=idxbx_e, idxbu=(), Cg=Ce, Dg=None,
        nh=nhe, h_fun=he,
        soft_rows=soft_rows(len(idxbx_e), 0,
                            0 if Ce is None else Ce.shape[0],
                            con.idxsbx_e, None, None, con.idxsh_e))
    return con_0, con_p, con_e


def _class_bounds(layout: StageLayout, nc, lbx, ubx, lbu, ubu, lg, ug,
                  lh, uh):
    """Fold per-kind bound vectors into unified (nc,) lower/upper rows."""
    lb = np.full(nc, -ACADOS_INFTY)
    ub = np.full(nc, ACADOS_INFTY)

    def put(off, n, lo, hi):
        if n == 0:
            return
        if lo is not None:
            lb[off:off + n] = np.atleast_1d(lo)
        if hi is not None:
            ub[off:off + n] = np.atleast_1d(hi)

    put(layout.off_bx, layout.nbx, lbx, ubx)
    put(layout.off_bu, layout.nbu, lbu, ubu)
    put(layout.off_g, layout.ng, lg, ug)
    put(layout.off_h, layout.nh, lh, uh)
    # disable padded rows entirely
    lb[layout.nrows:] = -ACADOS_INFTY
    ub[layout.nrows:] = ACADOS_INFTY
    return lb, ub


def _class_slack_penalties(spec: ConstraintSpec, nc, Zl, Zu, zl, zu):
    """Scatter per-slack penalty vectors (ordered like the spec's
    soft_rows) onto the unified rows."""
    out = [np.zeros(nc) for _ in range(4)]
    for vec, dst in zip((Zl, Zu, zl, zu), out):
        if vec is None:
            continue
        vec = np.atleast_1d(vec)
        for j, row in enumerate(spec.soft_rows):
            dst[row] = vec[j] if j < len(vec) else vec[-1]
    return out


def _check_ported(ocp: AcadosOcp):
    m, c, so = ocp.model, ocp.cost, ocp.solver_options
    if "AUTO" in (c.cost_type, c.cost_type_0, c.cost_type_e):
        raise _not_ported("AUTO cost detection")
    if so.hessian_approx != "GAUSS_NEWTON":
        raise _not_ported(f"hessian_approx {so.hessian_approx!r}")
    if so.cost_discretization != "EULER":
        raise _not_ported("cost_discretization INTEGRATOR")
    if _dim_of(m.z):
        raise _not_ported("algebraic variables (model.z)",
                          "integrator breadth")
    if getattr(m, "p_global", None) is not None:
        raise _not_ported("global parameters (model.p_global)",
                          "interface utilities")
    if so.integrator_type not in ("ERK", "IRK"):
        raise _not_ported(f"integrator_type {so.integrator_type!r}",
                          "integrator breadth")


def build_ocp(ocp: AcadosOcp):
    """AcadosOcp -> (OcpNlpFormulation, data (numpy dict), layouts)."""
    _check_ported(ocp)
    m, c, con, so = ocp.model, ocp.cost, ocp.constraints, ocp.solver_options
    nx = _dim_of(m.x, ocp.dims.nx or 0)
    nu = _dim_of(m.u, ocp.dims.nu or 0)
    np_dim = _dim_of(m.p, ocp.dims.np or 0)
    N = so.N_horizon or ocp.dims.N
    if N is None:
        raise ValueError("set solver_options.N_horizon")

    # ---- time grid --------------------------------------------------------
    if so.time_steps is not None:
        dts = np.asarray(so.time_steps, np.float64)
    elif so.shooting_nodes is not None:
        dts = np.diff(np.asarray(so.shooting_nodes, np.float64))
    else:
        if so.tf is None:
            raise ValueError("set solver_options.tf")
        dts = np.full(N, float(so.tf) / N)
    ts = np.concatenate([[0.0], np.cumsum(dts)])

    # ---- dynamics step functions (batch-first) ------------------------------
    sim_opts = SimOpts(
        integrator_type=so.integrator_type,
        num_stages=so.sim_method_num_stages,
        num_steps=so.sim_method_num_steps,
        newton_iter=so.sim_method_newton_iter,
        collocation_type=so.collocation_type)
    step_fn = make_step_fn(f_expl=m.f_expl_expr, f_impl=m.f_impl_expr,
                           nx=nx, opts=sim_opts)
    step_jac_fn = make_step_jac_fn(
        f_expl=m.f_expl_expr, f_impl=m.f_impl_expr, nx=nx, opts=sim_opts,
        jac_reuse=bool(so.sim_method_jac_reuse))

    con_0, con_p, con_e = _build_con_specs(ocp, nx, nu)
    cost_0 = _build_cost_spec(ocp, "0")
    cost_p = _build_cost_spec(ocp, "path")
    cost_e = _build_cost_spec(ocp, "e")

    # stage-0 full-state equality (reference idxbxe_0; x0 sugar implies
    # it): the static license for QP initial-state elimination
    idxbxe_0 = _idx(con.idxbxe_0)
    if con.x0 is not None and not idxbxe_0:
        idxbxe_0 = tuple(range(nx))
    x0_equality = (con_0.idxbx == tuple(range(nx))
                   and idxbxe_0 == tuple(range(nx)))

    form = OcpNlpFormulation(
        N=N, nx=nx, nu=nu, np_=np_dim, step_fn=step_fn,
        step_jac_fn=step_jac_fn, cost_0=cost_0, cost=cost_p, cost_e=cost_e,
        con_0=con_0, con=con_p, con_e=con_e, x0_equality=x0_equality)
    nc = form.nc
    lay_0, lay_p, lay_e = (StageLayout(con_0), StageLayout(con_p),
                           StageLayout(con_e))

    # ---- bounds -------------------------------------------------------------
    lbx_0 = con.lbx_0 if con.lbx_0 is not None else con.x0
    ubx_0 = con.ubx_0 if con.ubx_0 is not None else con.x0
    lb_0, ub_0 = _class_bounds(
        lay_0, nc, lbx_0, ubx_0, con.lbu, con.ubu, con.lg, con.ug,
        con.lh_0 if con.lh_0 is not None else con.lh,
        con.uh_0 if con.uh_0 is not None else con.uh)
    lb_p, ub_p = _class_bounds(lay_p, nc, con.lbx, con.ubx, con.lbu,
                               con.ubu, con.lg, con.ug, con.lh, con.uh)
    lb_e, ub_e = _class_bounds(lay_e, nc, con.lbx_e, con.ubx_e, None, None,
                               con.lg_e, con.ug_e, con.lh_e, con.uh_e)

    # ---- slack penalties ----------------------------------------------------
    Zl_0, Zu_0, zl_0, zu_0 = _class_slack_penalties(
        con_0, nc, c.Zl_0 if c.Zl_0 is not None else c.Zl,
        c.Zu_0 if c.Zu_0 is not None else c.Zu,
        c.zl_0 if c.zl_0 is not None else c.zl,
        c.zu_0 if c.zu_0 is not None else c.zu)
    Zl_p, Zu_p, zl_p, zu_p = _class_slack_penalties(con_p, nc, c.Zl, c.Zu,
                                                    c.zl, c.zu)
    Zl_e, Zu_e, zl_e, zu_e = _class_slack_penalties(con_e, nc, c.Zl_e,
                                                    c.Zu_e, c.zl_e, c.zu_e)

    # ---- cost data ------------------------------------------------------------
    ny0, nyp, nye = form.cost_0.ny, form.cost.ny, form.cost_e.ny
    yref_0 = np.zeros(ny0) if ny0 else np.zeros(0)
    if c.yref_0 is not None:
        yref_0 = np.asarray(c.yref_0, np.float64)
    elif c.yref is not None and ny0 == _dim_of(c.yref):
        yref_0 = np.asarray(c.yref, np.float64)
    W_0 = np.asarray(c.W_0 if c.W_0 is not None else
                     (c.W if c.W is not None else np.zeros((ny0, ny0))),
                     np.float64)
    yref_p = np.asarray(c.yref if c.yref is not None else np.zeros(nyp),
                        np.float64)
    W_p = np.asarray(c.W if c.W is not None else np.zeros((nyp, nyp)),
                     np.float64)
    yref_e = np.asarray(c.yref_e if c.yref_e is not None else np.zeros(nye),
                        np.float64)
    W_e = np.asarray(c.W_e if c.W_e is not None else np.zeros((nye, nye)),
                     np.float64)
    if c.cost_scaling is not None:
        cost_scale = np.asarray(c.cost_scaling, np.float64)
    else:
        # reference default: Lagrange term scaled by time step, Mayer by 1
        cost_scale = np.concatenate([dts, [1.0]])
    p0 = np.zeros(np_dim) if ocp.parameter_values is None \
        else np.asarray(ocp.parameter_values, np.float64)

    data = dict(
        p=np.tile(p0, (N + 1, 1)),
        ts=ts, dts=dts, cost_scale=cost_scale,
        yref_0=yref_0, W_0=W_0,
        yref=np.tile(yref_p, (N - 1, 1)),
        W=np.tile(W_p, (N - 1, 1, 1)),
        yref_e=yref_e, W_e=W_e,
        lb_0=lb_0, ub_0=ub_0,
        lb=np.tile(lb_p, (N - 1, 1)), ub=np.tile(ub_p, (N - 1, 1)),
        lb_e=lb_e, ub_e=ub_e,
        Zl_0=Zl_0, Zu_0=Zu_0, zl_0=zl_0, zu_0=zu_0,
        Zl=np.tile(Zl_p, (N - 1, 1)), Zu=np.tile(Zu_p, (N - 1, 1)),
        zl=np.tile(zl_p, (N - 1, 1)), zu=np.tile(zu_p, (N - 1, 1)),
        Zl_e=Zl_e, Zu_e=Zu_e, zl_e=zl_e, zu_e=zu_e,
    )
    layouts = {"0": lay_0, "p": lay_p, "e": lay_e}
    return form, data, layouts


def data_to_torch(data: dict, dtype, device, batch: int | None = None
                  ) -> NlpData:
    """Numpy data dict -> batch-first NlpData on `device`.

    data: the dict of `build_ocp` (of either package), with a leading
    batch axis on every entry when batch is None, or of one instance,
    broadcast to `batch` instances otherwise. The tensors are copies: they
    never alias the dict, which `set` keeps changing on the host."""
    def conv(v):
        t = torch.tensor(np.asarray(v), dtype=dtype, device=device)
        if batch is not None:
            t = t.expand((batch,) + tuple(t.shape)).contiguous()
        return t
    return NlpData(**{k: conv(v) for k, v in data.items()})
