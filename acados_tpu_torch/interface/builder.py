"""AcadosOcp -> internal formulation + default runtime data.

Counterpart of `acados_tpu/interface/builder.py`: dimension inference,
folding box/general/nonlinear constraints into unified rows, and laying
out the runtime data. `build_ocp` returns the same numpy data dict (same
keys, same shapes) as the JAX package's, so either package's dict can be
turned into the port's batch-first `NlpData` by `data_to_torch`.

Ported: ERK, IRK, GNSF and DISCRETE dynamics (LIFTED_IRK integrates as
IRK in the OCP, as in the JAX package), DAEs (nz > 0) whose costs and h
rows may read z, global parameters (model.p_global with
p_global_precompute_fun), LINEAR_LS (with Vz) / NONLINEAR_LS / CONL /
EXTERNAL costs and AUTO cost detection, cost_discretization EULER and
INTEGRATOR (ERK and IRK), the Gauss-Newton and the exact Hessian (with
the exact_hess_cost/dyn/constr switches), BGH and BGP constraints with
soft rows.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import AcadosOcp, _dim_of
from acados_tpu_torch.ocp_nlp.formulation import (ConstraintSpec, CostSpec,
                                                  NlpData, OcpNlpFormulation,
                                                  _const)
from acados_tpu_torch.sim.butcher import erk_tableau
from acados_tpu_torch.sim.integrator import (SimOpts, make_step_fn,
                                             make_step_jac_fn,
                                             normalize_dynamics,
                                             normalize_implicit_dynamics,
                                             step_jac_of)
from acados_tpu_torch.sim.irk import (implicit_from_explicit,
                                      make_irk_stage_points,
                                      make_irk_z0_fun)
from acados_tpu_torch.utils.types import ACADOS_INFTY


def _norm4(f):
    """Normalize (x, u[, p[, t]]) callables to (x, u, p, t)."""
    if f is None:
        return None
    n = len(inspect.signature(f).parameters)
    if n == 2:
        return lambda x, u, p, t: f(x, u)
    if n == 3:
        return lambda x, u, p, t: f(x, u, p)
    return f


def _norm_z(f):
    """Normalize a stage callable that may read the algebraic variable z
    (acados_tpu/interface/builder.py:36-60). Returns (fn, with_z):
    with_z False: fn(x, u, p, t); with_z True: fn(x, u, z, p, t). A
    parameter literally named 'z' declares that the callable reads z."""
    if f is None:
        return None, False
    params = list(inspect.signature(f).parameters)
    if "z" not in params:
        return _norm4(f), False
    n = len(params)
    if n == 3:    # (x, u, z)
        return (lambda x, u, z, p, t: f(x, u, z)), True
    if n == 4:    # (x, u, z, p)
        return (lambda x, u, z, p, t: f(x, u, z, p)), True
    if n == 5:    # (x, u, z, p, t)
        return f, True
    raise ValueError("z-dependent expressions must take "
                     "(x, u, z[, p[, t]])")


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
        self.nphi = spec.nphi
        self.off_bx = 0
        self.off_bu = self.nbx
        self.off_g = self.nbx + self.nbu
        self.off_h = self.off_g + self.ng
        self.off_phi = self.off_h + self.nh
        self.nrows = spec.nrows


def _linear_ls_yfun_z(Vx, Vu, Vz):
    """LINEAR_LS with an algebraic block: y = Vx x + Vu u + Vz z
    (reference ocp_nlp_cost_ls.c:243 Vz; acados_tpu/interface/
    builder.py:88-101)."""
    Vx = np.asarray(Vx, np.float64)
    Vu = None if Vu is None else np.asarray(Vu, np.float64)
    Vz = np.asarray(Vz, np.float64)

    def y(x, u, z, p, t):
        out = _const(Vx, x) @ x + _const(Vz, x) @ z
        if Vu is not None:
            out = out + _const(Vu, x) @ u
        return out

    return y, Vx.shape[0]


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


def _resolve_auto_cost(ocp: AcadosOcp) -> None:
    """'AUTO' cost detection (reference acados_ocp.py:2399
    detect_cost_type; acados_tpu/interface/builder.py:117-194): a stage
    cost declared AUTO whose EXTERNAL expression has a constant Hessian
    over (x, u) (checked at zero and three seeded random probes, float64)
    and a linear term in the Hessian's range is rewritten as LINEAR_LS
    (Vx/Vu/W/yref, checked by reconstructing the cost at a random point);
    otherwise it stays EXTERNAL."""
    c, m = ocp.cost, ocp.model
    nx, nu = _dim_of(m.x), _dim_of(m.u)
    rng = np.random.default_rng(0)
    f64 = dict(dtype=torch.float64)

    def detect(which):
        sfx = {"0": "_0", "path": "", "e": "_e"}[which]
        ext = getattr(m, "cost_expr_ext_cost" + sfx, None)
        if ext is None and which in ("0", "e"):
            ext = m.cost_expr_ext_cost
        if ext is None:
            raise ValueError(
                "AUTO cost detection requires cost_expr_ext_cost"
                f"{sfx} (reference acados_ocp.py:2427)")
        f4 = _norm4(ext)
        nu_eff = 0 if which == "e" else nu
        nw = nx + nu_eff
        p0 = torch.zeros((_dim_of(m.p),), **f64)
        t0 = torch.zeros((), **f64)

        def fw(w):
            return f4(w[:nx], torch.cat(
                [w[nx:], torch.zeros((nu - nu_eff,), **f64)]), p0, t0)

        hess = lambda w: torch.func.hessian(fw)(
            torch.as_tensor(w, **f64)).numpy()
        H0 = hess(np.zeros(nw))
        for _ in range(3):
            Hp = hess(rng.normal(size=nw))
            if not np.allclose(Hp, H0, rtol=1e-8, atol=1e-10):
                return "EXTERNAL", None
        g0 = torch.func.grad(fw)(torch.zeros(nw, **f64)).numpy()
        idx = [i for i in range(nw) if np.any(np.abs(H0[i]) > 1e-12)]
        if not idx:
            return "EXTERNAL", None  # zero/linear cost: keep as-is
        Hs = H0[np.ix_(idx, idx)]
        gs = g0[idx]
        try:
            yref = -np.linalg.solve(Hs, gs)
        except np.linalg.LinAlgError:
            return "EXTERNAL", None
        if np.any(np.abs(np.delete(g0, idx)) > 1e-10):
            return "EXTERNAL", None  # linear term outside Hessian range
        V = np.zeros((len(idx), nw))
        for r, i in enumerate(idx):
            V[r, i] = 1.0
        # reconstruction check incl. the constant offset
        w = rng.normal(size=nw)
        ls_val = 0.5 * (V @ w - yref) @ Hs @ (V @ w - yref)
        f_val = float(fw(torch.as_tensor(w, **f64))) \
            - float(fw(torch.zeros(nw, **f64))) + 0.5 * yref @ Hs @ yref
        if not np.isclose(ls_val, f_val, rtol=1e-8, atol=1e-8):
            return "EXTERNAL", None
        return "LINEAR_LS", (V[:, :nx], V[:, nx:] if nu_eff else None,
                             Hs, yref)

    for which, attr in (("0", "cost_type_0"), ("path", "cost_type"),
                        ("e", "cost_type_e")):
        if getattr(c, attr, None) != "AUTO":
            continue
        kind, ls = detect(which)
        sfx = {"0": "_0", "path": "", "e": "_e"}[which]
        setattr(c, attr, kind)
        if kind == "LINEAR_LS":
            Vx, Vu, W, yref = ls
            setattr(c, "Vx" + sfx, Vx)
            if which != "e":
                setattr(c, "Vu" + sfx, Vu)
            setattr(c, "W" + sfx, W)
            setattr(c, "yref" + sfx, yref)


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
        psi = m.cost_psi_expr_0 or m.cost_psi_expr
    elif which == "path":
        kind = c.cost_type
        Vx, Vu, y_expr, yref = c.Vx, c.Vu, m.cost_y_expr, c.yref
        ext, Vz, psi = m.cost_expr_ext_cost, c.Vz, m.cost_psi_expr
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
        if kind == "CONL":
            return CostSpec(kind=kind, ny=_dim_of(c.yref_e),
                            y_fun=_norm_term(m.cost_y_expr_e),
                            psi_fun=m.cost_psi_expr_e)
        raise ValueError(f"unsupported cost type {kind!r}")
    if kind == "LINEAR_LS":
        if Vz is not None:
            y, ny = _linear_ls_yfun_z(Vx, Vu, Vz)
            return CostSpec(kind=kind, ny=ny, y_fun=y, with_z=True)
        y, ny = _linear_ls_yfun(Vx, Vu)
        return CostSpec(kind=kind, ny=ny, y_fun=y,
                        Vx=np.asarray(Vx, np.float64),
                        Vu=None if Vu is None else np.asarray(Vu, np.float64))
    if kind == "NONLINEAR_LS":
        f, wz = _norm_z(y_expr)
        return CostSpec(kind=kind, ny=_dim_of(yref), y_fun=f, with_z=wz)
    if kind == "CONL":
        f, wz = _norm_z(y_expr)
        return CostSpec(kind=kind, ny=_dim_of(yref), y_fun=f, psi_fun=psi,
                        with_z=wz)
    if kind == "EXTERNAL":
        f, wz = _norm_z(ext)
        return CostSpec(kind=kind, ext_fun=f, with_z=wz)
    raise ValueError(f"unsupported cost type {kind!r}")


def _wrap_cost_integrator(spec: CostSpec, points_fn, weights) -> CostSpec:
    """cost_discretization INTEGRATOR (acados_tpu/interface/builder.py:
    279-336): the Lagrange cost at the integrator's quadrature points
    points_fn(x, u, p, t, dt) -> (Xs (nq, nx), Zs (nq, nz) or None,
    Ts (nq,)) with the weights (nq,), which sum to 1 (the dt factor is
    NlpData.cost_scale). The LS family becomes a NONLINEAR_LS over the
    stacked point residuals, whose Gauss-Newton Hessian is the integrated
    one; CONL keeps psi at each point (the stacked generalized
    Gauss-Newton); EXTERNAL is the weighted sum of the cost at the
    points. A z-dependent integrand reads the IRK's algebraic stage
    values Zs at its points."""
    wq = np.asarray(weights, np.float64)

    def call_pt(f0, x, u, p, t, dtk):
        Xs, Zs, Ts = points_fn(x, u, p, t, dtk)
        if spec.with_z:
            return torch.stack([f0(Xs[q], u, Zs[q], p, Ts[q])
                                for q in range(Xs.shape[0])])
        return torch.stack([f0(Xs[q], u, p, Ts[q])
                            for q in range(Xs.shape[0])])

    if spec.kind in ("LINEAR_LS", "NONLINEAR_LS", "CONL"):
        y0 = spec.y_fun
        return dataclasses.replace(
            spec, kind="CONL" if spec.kind == "CONL" else "NONLINEAR_LS",
            y_fun=lambda x, u, p, t, dtk: call_pt(y0, x, u, p, t, dtk),
            Vx=None, Vu=None, needs_dt=True, quad_weights=wq, with_z=False)
    if spec.kind == "EXTERNAL":
        e0 = spec.ext_fun

        def e_int(x, u, p, t, dtk):
            return (_const(wq, x) * call_pt(e0, x, u, p, t, dtk)).sum()

        return dataclasses.replace(spec, ext_fun=e_int, needs_dt=True,
                                   with_z=False)
    raise ValueError(spec.kind)


def _erk_points_fn(f4, num_stages: int, num_steps: int):
    """The quadrature points of the explicit RK chain (the JAX package's
    ERK extension of the reference's IRK-only INTEGRATOR,
    acados_tpu/interface/builder.py:339-366): every stage's evaluation
    point and time, with the weights b / num_steps."""
    A_t, b_t, c_t = erk_tableau(num_stages)
    ns, m = num_stages, num_steps

    def points(x, u, p, t, dtk):
        h = dtk / m
        pts_x, pts_t = [], []
        for s_ in range(m):
            t0 = t + s_ * h
            ks = []
            for si in range(ns):
                xi = x
                for sj in range(si):
                    if A_t[si, sj] != 0.0:
                        xi = xi + (h * float(A_t[si, sj])) * ks[sj]
                ks.append(f4(xi, u, p, t0 + float(c_t[si]) * h))
                pts_x.append(xi)
                pts_t.append(t0 + float(c_t[si]) * h)
            for sj in range(ns):
                x = x + (h * float(b_t[sj])) * ks[sj]
        return torch.stack(pts_x), None, torch.stack(pts_t)

    return points, np.tile(np.asarray(b_t, np.float64) / m, m)


def _integrated_costs(ocp: AcadosOcp, nx: int, cost_0, cost_p):
    """The stage-0 and path costs of cost_discretization INTEGRATOR at
    the dynamics integrator's points (acados_tpu/interface/builder.py:
    562-590); the terminal (Mayer) cost has no integral."""
    m, so = ocp.model, ocp.solver_options
    if so.integrator_type == "ERK":
        pts_fn, wts = _erk_points_fn(normalize_dynamics(m.f_expl_expr),
                                     so.sim_method_num_stages,
                                     so.sim_method_num_steps)
    elif so.integrator_type in ("IRK", "LIFTED_IRK"):
        pts_fn, wts = make_irk_stage_points(
            _f_impl(m), nx=nx, nz=_dim_of(m.z),
            num_stages=so.sim_method_num_stages,
            num_steps=so.sim_method_num_steps,
            newton_iter=so.sim_method_newton_iter,
            collocation=so.collocation_type)
    else:
        raise NotImplementedError(
            "cost_discretization INTEGRATOR supports ERK and IRK (the "
            "reference supports IRK only, acados_ocp_options.py:2285); got "
            f"{so.integrator_type}")
    return (_wrap_cost_integrator(cost_0, pts_fn, wts),
            _wrap_cost_integrator(cost_p, pts_fn, wts))


def _idx(v):
    return tuple(int(i) for i in np.atleast_1d(v)) if v is not None else ()


def _build_con_specs(ocp: AcadosOcp, nx, nu):
    con, m = ocp.constraints, ocp.model

    idxbx_0 = _idx(con.idxbx_0)
    if con.x0 is not None and not idxbx_0:
        idxbx_0 = tuple(range(nx))
    h0, h0_wz = _norm_z(m.con_h_expr_0 or m.con_h_expr)
    nh0 = _dim_of(con.lh_0 if con.lh_0 is not None else con.lh) \
        if h0 is not None else 0
    hp, hp_wz = _norm_z(m.con_h_expr)
    nhp = _dim_of(con.lh if con.lh is not None else con.uh) \
        if hp is not None else 0
    he = _norm_term(m.con_h_expr_e) if m.con_h_expr_e is not None else None
    nhe = _dim_of(con.lh_e if con.lh_e is not None else con.uh_e) \
        if he is not None else 0

    # BGP phi(r) rows (reference con_phi_expr / con_r_expr with lphi /
    # uphi; acados_tpu/interface/builder.py:389-405)
    def bgp(phi_expr, r_expr, lphi, uphi, term=False):
        if phi_expr is None or r_expr is None:
            return dict(nphi=0)
        return dict(nphi=_dim_of(lphi if lphi is not None else uphi),
                    phi_fun=phi_expr,
                    r_fun=_norm_term(r_expr) if term else _norm4(r_expr))

    bgp_0 = bgp(m.con_phi_expr_0 or m.con_phi_expr,
                m.con_r_expr_0 or m.con_r_expr,
                con.lphi_0 if con.lphi_0 is not None else con.lphi,
                con.uphi_0 if con.uphi_0 is not None else con.uphi)
    bgp_p = bgp(m.con_phi_expr, m.con_r_expr, con.lphi, con.uphi)
    bgp_e = bgp(m.con_phi_expr_e, m.con_r_expr_e, con.lphi_e, con.uphi_e,
                term=True)

    Cg = None if con.C is None else np.atleast_2d(con.C)
    Dg = None if con.D is None else np.atleast_2d(con.D)
    Ce = None if con.C_e is None else np.atleast_2d(con.C_e)
    ng = 0 if Cg is None else Cg.shape[0]

    def soft_rows(nbx, nbu, ng_, nh_, idxsbx, idxsbu, idxsg, idxsh,
                  idxsphi):
        rows = [i for i in _idx(idxsbx)]
        rows += [nbx + i for i in _idx(idxsbu)]
        rows += [nbx + nbu + i for i in _idx(idxsg)]
        rows += [nbx + nbu + ng_ + i for i in _idx(idxsh)]
        rows += [nbx + nbu + ng_ + nh_ + i for i in _idx(idxsphi)]
        return tuple(rows)

    idxbu = _idx(con.idxbu)
    idxbx = _idx(con.idxbx)
    con_0 = ConstraintSpec(
        nx=nx, nu=nu, idxbx=idxbx_0, idxbu=idxbu, Cg=Cg, Dg=Dg,
        nh=nh0, h_fun=h0, with_z=h0_wz, **bgp_0,
        soft_rows=soft_rows(len(idxbx_0), len(idxbu), ng, nh0, None,
                            con.idxsbu, con.idxsg,
                            con.idxsh_0 if con.idxsh_0 is not None
                            else con.idxsh,
                            con.idxsphi_0 if con.idxsphi_0 is not None
                            else con.idxsphi))
    con_p = ConstraintSpec(
        nx=nx, nu=nu, idxbx=idxbx, idxbu=idxbu, Cg=Cg, Dg=Dg,
        nh=nhp, h_fun=hp, with_z=hp_wz, **bgp_p,
        soft_rows=soft_rows(len(idxbx), len(idxbu), ng, nhp, con.idxsbx,
                            con.idxsbu, con.idxsg, con.idxsh, con.idxsphi))
    idxbx_e = _idx(con.idxbx_e)
    con_e = ConstraintSpec(
        nx=nx, nu=nu, idxbx=idxbx_e, idxbu=(), Cg=Ce, Dg=None,
        nh=nhe, h_fun=he, **bgp_e,
        soft_rows=soft_rows(len(idxbx_e), 0,
                            0 if Ce is None else Ce.shape[0], nhe,
                            con.idxsbx_e, None, None, con.idxsh_e,
                            con.idxsphi_e))
    return con_0, con_p, con_e


def _class_bounds(layout: StageLayout, nc, lbx, ubx, lbu, ubu, lg, ug,
                  lh, uh, lphi=None, uphi=None):
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
    put(layout.off_phi, layout.nphi, lphi, uphi)
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


def _check_options(ocp: AcadosOcp):
    so = ocp.solver_options
    if so.hessian_approx not in ("GAUSS_NEWTON", "EXACT"):
        raise ValueError(f"hessian_approx {so.hessian_approx!r}")
    if so.cost_discretization not in ("EULER", "INTEGRATOR"):
        raise ValueError(
            f"cost_discretization {so.cost_discretization!r}")


def _f_impl(m):
    """The model's implicit dynamics f(xdot, x, z, u, p, t), or its
    explicit ODE wrapped as one."""
    if m.f_impl_expr is not None:
        return normalize_implicit_dynamics(m.f_impl_expr)
    return implicit_from_explicit(normalize_dynamics(m.f_expl_expr))


def _global_data(m, pg: np.ndarray) -> np.ndarray:
    """p_global_precompute_fun(p_global) as a flat float64 array (the
    reference's generated p_global_precompute_fun.in.h)."""
    fn = getattr(m, "p_global_precompute_fun", None)
    if fn is None:
        return np.zeros(0)
    out = fn(torch.as_tensor(np.asarray(pg, np.float64),
                             dtype=torch.float64))
    return np.asarray(torch.as_tensor(out).detach().cpu(),
                      np.float64).reshape(-1)


def _dynamics(ocp: AcadosOcp, nx: int, nu: int, nz: int):
    """(step_fn, step_jac_fn), batch-first (acados_tpu/interface/
    builder.py:529-557). DISCRETE: disc_dyn_expr(x, u, p, t), which
    ignores dt, with the jacfwd step Jacobian the port builds for ERK;
    LIFTED_IRK integrates as IRK (its payoff, stage memory across calls,
    is the simulator's); a DAE's step_fn returns x_next alone."""
    m, so = ocp.model, ocp.solver_options
    if so.integrator_type == "DISCRETE":
        disc = _norm4(m.disc_dyn_expr)
        one = lambda x, u, p, t, dt: disc(x, u, p, t)
        return torch.func.vmap(one), step_jac_of(one, nx)
    itype = ("IRK" if so.integrator_type == "LIFTED_IRK"
             else so.integrator_type)
    sim_opts = SimOpts(
        integrator_type=itype,
        num_stages=so.sim_method_num_stages,
        num_steps=so.sim_method_num_steps,
        newton_iter=so.sim_method_newton_iter,
        collocation_type=so.collocation_type)
    step_fn = make_step_fn(f_expl=m.f_expl_expr, f_impl=m.f_impl_expr,
                           nx=nx, nu=nu, nz=nz, opts=sim_opts)
    if nz:
        dae_step = step_fn
        step_fn = lambda x, u, p, t, dt: dae_step(x, u, p, t, dt)[0]
    step_jac_fn = make_step_jac_fn(
        f_expl=m.f_expl_expr, f_impl=m.f_impl_expr, nx=nx, nu=nu, nz=nz,
        opts=sim_opts, jac_reuse=bool(so.sim_method_jac_reuse))
    return step_fn, step_jac_fn


def build_ocp(ocp: AcadosOcp):
    """AcadosOcp -> (OcpNlpFormulation, data (numpy dict), layouts)."""
    _check_options(ocp)
    m, c, con, so = ocp.model, ocp.cost, ocp.constraints, ocp.solver_options
    if "AUTO" in (c.cost_type, c.cost_type_0, c.cost_type_e):
        _resolve_auto_cost(ocp)
    nx = _dim_of(m.x, ocp.dims.nx or 0)
    nu = _dim_of(m.u, ocp.dims.nu or 0)
    nz = _dim_of(m.z)
    np_stage = _dim_of(m.p, ocp.dims.np or 0)
    # p_global tail (acados_tpu/interface/builder.py:502-512): the stage
    # callables receive p = [p_stage | p_global | global_data]
    npg = _dim_of(getattr(m, "p_global", None))
    if getattr(m, "p_global_precompute_fun", None) is not None \
            and npg == 0:
        raise ValueError("p_global_precompute_fun needs model.p_global")
    ngd = _global_data(m, np.zeros(npg)).shape[0] if npg else 0
    np_dim = np_stage + npg + ngd
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
    step_fn, step_jac_fn = _dynamics(ocp, nx, nu, nz)

    con_0, con_p, con_e = _build_con_specs(ocp, nx, nu)
    cost_0 = _build_cost_spec(ocp, "0")
    cost_p = _build_cost_spec(ocp, "path")
    cost_e = _build_cost_spec(ocp, "e")
    if so.cost_discretization == "INTEGRATOR":
        cost_0, cost_p = _integrated_costs(ocp, nx, cost_0, cost_p)

    # ---- algebraic variables in the NLP (acados_tpu/interface/builder.py:
    # 595-623): z-dependent modules read z through the linearization's
    # affine model and the exact z(t0) evaluator
    any_z = (cost_0.with_z or cost_p.with_z or con_0.with_z
             or con_p.with_z)
    z_fun = None
    if any_z:
        if nz == 0:
            raise ValueError("cost/constraint expressions reference z "
                             "but model.z declares nz == 0")
        if so.integrator_type not in ("IRK", "LIFTED_IRK"):
            raise ValueError(
                "z-dependent cost/constraints need an implicit DAE "
                f"integrator (IRK/LIFTED_IRK); got {so.integrator_type}")
        z0_fun = make_irk_z0_fun(
            normalize_implicit_dynamics(m.f_impl_expr), nx=nx, nz=nz,
            num_stages=so.sim_method_num_stages,
            newton_iter=so.sim_method_newton_iter,
            collocation=so.collocation_type)
        nsteps = so.sim_method_num_steps
        z_fun = lambda x, u, p, t, dt: z0_fun(x, u, p, t, dt / nsteps)
    elif nz and step_jac_fn is not None:
        # a DAE whose cost and constraints never read z: the linearizer
        # takes the 3-tuple of an ODE
        dae_jac = step_jac_fn
        step_jac_fn = lambda x, u, p, t, dt: dae_jac(x, u, p, t, dt)[:3]

    # stage-0 full-state equality (reference idxbxe_0; x0 sugar implies
    # it): the static license for QP initial-state elimination
    idxbxe_0 = _idx(con.idxbxe_0)
    if con.x0 is not None and not idxbxe_0:
        idxbxe_0 = tuple(range(nx))
    x0_equality = (con_0.idxbx == tuple(range(nx))
                   and idxbxe_0 == tuple(range(nx)))

    form = OcpNlpFormulation(
        N=N, nx=nx, nu=nu, np_=np_dim, step_fn=step_fn,
        step_jac_fn=step_jac_fn, nz=nz if any_z else 0, z_fun=z_fun,
        cost_0=cost_0, cost=cost_p, cost_e=cost_e,
        con_0=con_0, con=con_p, con_e=con_e,
        exact_hessian=(so.hessian_approx == "EXACT"),
        exact_hess_cost=bool(so.exact_hess_cost),
        exact_hess_dyn=bool(so.exact_hess_dyn),
        exact_hess_constr=bool(so.exact_hess_constr),
        x0_equality=x0_equality)
    nc = form.nc
    lay_0, lay_p, lay_e = (StageLayout(con_0), StageLayout(con_p),
                           StageLayout(con_e))

    # ---- bounds -------------------------------------------------------------
    lbx_0 = con.lbx_0 if con.lbx_0 is not None else con.x0
    ubx_0 = con.ubx_0 if con.ubx_0 is not None else con.x0
    lb_0, ub_0 = _class_bounds(
        lay_0, nc, lbx_0, ubx_0, con.lbu, con.ubu, con.lg, con.ug,
        con.lh_0 if con.lh_0 is not None else con.lh,
        con.uh_0 if con.uh_0 is not None else con.uh,
        con.lphi_0 if con.lphi_0 is not None else con.lphi,
        con.uphi_0 if con.uphi_0 is not None else con.uphi)
    lb_p, ub_p = _class_bounds(lay_p, nc, con.lbx, con.ubx, con.lbu,
                               con.ubu, con.lg, con.ug, con.lh, con.uh,
                               con.lphi, con.uphi)
    lb_e, ub_e = _class_bounds(lay_e, nc, con.lbx_e, con.ubx_e, None, None,
                               con.lg_e, con.ug_e, con.lh_e, con.uh_e,
                               con.lphi_e, con.uphi_e)

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
    p0 = np.zeros(np_stage) if ocp.parameter_values is None \
        else np.asarray(ocp.parameter_values, np.float64)
    if npg:
        pg0 = (np.zeros(npg)
               if getattr(ocp, "p_global_values", None) is None
               else np.asarray(ocp.p_global_values, np.float64))
        p0 = np.concatenate([p0, pg0, _global_data(m, pg0)])

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
