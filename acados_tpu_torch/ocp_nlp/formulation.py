"""NLP formulation: per-stage cost and constraint modules, runtime data.

Counterpart of `acados_tpu/ocp_nlp/formulation.py`. Cost and constraint
callables are per-instance torch functions of (x, u, p, t); the
derivatives the reference gets from CasADi come from `torch.func.jacfwd`
and the linearizer batches them with `torch.func.vmap`. Box bounds,
general linear rows (C/D) and nonlinear h rows are folded into one
unified row block per stage class, as in the JAX package.

Ported: cost kinds LINEAR_LS, NONLINEAR_LS, CONL (generalized
Gauss-Newton) and EXTERNAL, with the exact cost Hessian where the JAX
package takes it, and their integrated forms over the integrator's
quadrature points (cost_discretization INTEGRATOR); BGH constraint rows
and BGP convex-over-nonlinear rows phi(r(x, u)), with soft rows. Cost
and h callables of a DAE may read the algebraic variable z (with_z):
the linearizer hands them z through an affine model around the
linearization point (`zlin`), the merit and residual evaluations the
exact z(t0) of the formulation's z_fun.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from acados_tpu_torch.utils.autodiff import hessian, jacfwd, value_and_jacfwd
from acados_tpu_torch.utils.struct import tensor_dataclass


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                           device=like.device)


def _z_of(zlin, x, u):
    """z for a z-dependent callable: the affine model's value at (x, u),
    or the empty vector where none is given (acados_tpu/ocp_nlp/
    formulation.py:79-81)."""
    return zlin(x, u) if zlin is not None else x.new_zeros((0,))


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """One stage-class cost module.

    kind: 'LINEAR_LS' | 'NONLINEAR_LS' | 'CONL' | 'EXTERNAL'
      LINEAR_LS / NONLINEAR_LS: 0.5 * ||y(x,u,p,t) - yref||^2_W with the
        Gauss-Newton Hessian (NONLINEAR_LS adds the residual curvature
        under the exact Hessian).
      CONL: psi(y(x,u,p,t) - yref, p) with the generalized Gauss-Newton
        Hessian J' psi'' J.
      EXTERNAL: arbitrary scalar cost, Hessian by AD (symmetrized unless
        the exact Hessian is asked for).
    y_fun: per-instance (x, u, p, t) -> y; psi_fun: (r, p) -> scalar
      (CONL only); ext_fun: (x, u, p, t) -> scalar.
    needs_dt / quad_weights: cost integration (cost_discretization
      INTEGRATOR, interface/builder.py:_wrap_cost_integrator): the
      callables take a trailing interval length dt, and with quad_weights
      (nq,) y_fun returns the residuals stacked at the integrator's nq
      quadrature points, (nq, ny), combined with the weights, so the
      Gauss-Newton Hessian is the integrated sum_q w_q J_q' W J_q
      (acados_tpu/ocp_nlp/formulation.py:69-77).
    Vx/Vu: LINEAR_LS constant Jacobian blocks (numpy); when set the
      Jacobian is a constant and no AD pass runs.
    with_z: the callables read the algebraic variable z and take
      (x, u, z, p, t); `zlin` (x, u) -> z supplies it (formulation.py:
      66-72).
    """

    kind: str
    ny: int = 0
    y_fun: Optional[Callable] = None
    psi_fun: Optional[Callable] = None
    ext_fun: Optional[Callable] = None
    needs_dt: bool = False
    quad_weights: Optional[np.ndarray] = None
    Vx: Optional[np.ndarray] = None
    Vu: Optional[np.ndarray] = None
    with_z: bool = False

    def _call(self, fn, x, u, p, t, dt_, zlin=None):
        if self.with_z:
            return fn(x, u, _z_of(zlin, x, u), p, t)
        return fn(x, u, p, t, dt_) if self.needs_dt else fn(x, u, p, t)

    def value(self, x, u, p, t, data, dt_=None, zlin=None) -> torch.Tensor:
        """Stage cost value of one instance (without slack penalties);
        dt_ is the interval length an integrated cost takes, zlin the z
        of a z-dependent cost."""
        if self.kind in ("LINEAR_LS", "NONLINEAR_LS"):
            r = self._call(self.y_fun, x, u, p, t, dt_, zlin) - data["yref"]
            if self.quad_weights is not None:
                wq = _const(self.quad_weights, x)
                return 0.5 * torch.einsum("q,qi,ij,qj->", wq, r, data["W"],
                                          r)
            return 0.5 * r @ data["W"] @ r
        if self.kind == "CONL":
            r = self._call(self.y_fun, x, u, p, t, dt_, zlin) - data["yref"]
            if self.quad_weights is not None:
                # psi applied at each quadrature point
                vals = vmap(lambda r_: self.psi_fun(r_, p))(r)
                return (_const(self.quad_weights, x) * vals).sum()
            return self.psi_fun(r, p)
        if self.kind == "EXTERNAL":
            return self._call(self.ext_fun, x, u, p, t, dt_, zlin)
        raise ValueError(self.kind)

    def quad_approx(self, x, u, p, t, data, exact_hessian: bool = False,
                    dt_=None, zlin=None):
        """Quadratic approximation of one instance at (x, u): (H, grad)
        over w = [x; u] (reference cost update_qp_matrices;
        acados_tpu/ocp_nlp/formulation.py:120-213). zlin: the affine
        z(x, u) model of a z-dependent cost; AD through it gives the
        reference's dzduxt chain rule (and no second derivative of z)."""
        nx = x.shape[-1]
        w = torch.cat([x, u])
        if self.kind == "LINEAR_LS" and self.Vx is not None:
            Vx = _const(self.Vx, w)
            Vu = (torch.zeros((Vx.shape[0], u.shape[-1]), dtype=w.dtype,
                              device=w.device)
                  if self.Vu is None else _const(self.Vu, w))
            J = torch.cat([Vx, Vu], dim=1)
            r = Vx @ x + Vu @ u - data["yref"]
            Wr = data["W"] @ r
            return J.T @ data["W"] @ J, J.T @ Wr
        yf = lambda w_: self._call(self.y_fun, w_[:nx], w_[nx:], p, t, dt_,
                                   zlin)
        if self.quad_weights is not None and self.kind in (
                "LINEAR_LS", "NONLINEAR_LS", "CONL"):
            # the integrated (generalized) Gauss-Newton over the
            # quadrature points (formulation.py:138-157, 175-187); the
            # residuals and their Jacobian come from one forward pass, as
            # each evaluation runs the integrator's stage solves
            Y, J = value_and_jacfwd(yf)(w)          # (nq, ny), (nq, ny, nw)
            R = Y - data["yref"][None, :]
            wq = _const(self.quad_weights, w)
            if self.kind == "CONL":
                psi = lambda r_: self.psi_fun(r_, p)
                gpsi = vmap(jacfwd(psi))(R)
                Hpsi = vmap(hessian(psi))(R)
                grad = torch.einsum("q,qiw,qi->w", wq, J, gpsi)
                H = torch.einsum("q,qiw,qij,qjv->wv", wq, J, Hpsi, J)
                return H, grad
            WR = torch.einsum("ij,qj->qi", data["W"], R)
            grad = torch.einsum("q,qiw,qi->w", wq, J, WR)
            H = torch.einsum("q,qiw,ij,qjv->wv", wq, J, data["W"], J)
            if exact_hessian:
                # WR is a constant of the inner transform, as the
                # reference's stop_gradient
                H = H + hessian(lambda w_: torch.einsum(
                    "q,qi,qi->", wq, yf(w_), WR))(w)
            return H, grad
        if self.kind in ("LINEAR_LS", "NONLINEAR_LS"):
            r = yf(w) - data["yref"]
            J = jacfwd(yf)(w)
            Wr = data["W"] @ r
            H = J.T @ data["W"] @ J
            if exact_hessian and self.kind == "NONLINEAR_LS":
                # exact = GN + sum_i (W r)_i hess(y_i): W r is a constant
                # of the inner transform, as the reference's stop_gradient
                H = H + hessian(lambda w_: yf(w_) @ Wr)(w)
            return H, J.T @ Wr
        if self.kind == "CONL":
            # generalized Gauss-Newton in both Hessian modes
            r = yf(w) - data["yref"]
            J = jacfwd(yf)(w)
            psi = lambda r_: self.psi_fun(r_, p)
            gpsi = jacfwd(psi)(r)
            Hpsi = hessian(psi)(r)
            return J.T @ Hpsi @ J, J.T @ gpsi
        if self.kind == "EXTERNAL":
            f = lambda w_: self._call(self.ext_fun, w_[:nx], w_[nx:], p, t,
                                      dt_, zlin)
            grad = jacfwd(f)(w)
            # an integrated cost's points run the IRK stage solves, whose
            # implicit gradient takes forward over reverse
            H = (hessian(f) if self.needs_dt else jacfwd(jacfwd(f)))(w)
            if exact_hessian:
                return H, grad
            return 0.5 * (H + H.T), grad
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """One stage-class constraint block, folded to unified rows.

    Row layout: [box-x rows | box-u rows | general C/D rows | h rows |
    phi rows]. idxbx/idxbu: bounded state/input indices; Cg, Dg: general
    linear rows (numpy); h_fun: per-instance (x, u, p, t) -> (nh,);
    soft_rows: indices into the unified row block that are softened.
    BGP (convex over nonlinear, reference ocp_nlp_constraints_bgp.c):
    nphi rows phi(r(x, u, p, t)) with phi_fun: (nr,) -> (nphi,) convex
    and r_fun: per-instance (x, u, p, t) -> (nr,). The QP rows take the
    chain-rule Jacobian; the outer curvature enters the stage Hessian
    through `bgp_hess`. with_z: h_fun reads the algebraic variable z and
    takes (x, u, z, p, t); `zlin` supplies z as for the costs.
    """

    nx: int
    nu: int
    idxbx: tuple = ()
    idxbu: tuple = ()
    Cg: Optional[np.ndarray] = None
    Dg: Optional[np.ndarray] = None
    nh: int = 0
    h_fun: Optional[Callable] = None
    soft_rows: tuple = ()
    nphi: int = 0
    phi_fun: Optional[Callable] = None
    r_fun: Optional[Callable] = None
    with_z: bool = False

    @property
    def nbx(self):
        return len(self.idxbx)

    @property
    def nbu(self):
        return len(self.idxbu)

    @property
    def ng(self):
        return 0 if self.Cg is None else self.Cg.shape[0]

    @property
    def nrows(self):
        return self.nbx + self.nbu + self.ng + self.nh + self.nphi

    def base_CD(self, dtype, device):
        """Constant part of the unified rows (box selectors + general)."""
        nr = self.nrows
        C = np.zeros((nr, self.nx))
        D = np.zeros((nr, self.nu))
        for i, j in enumerate(self.idxbx):
            C[i, j] = 1.0
        for i, j in enumerate(self.idxbu):
            D[self.nbx + i, j] = 1.0
        o = self.nbx + self.nbu
        if self.ng:
            C[o:o + self.ng] = self.Cg
            if self.Dg is not None:
                D[o:o + self.ng] = self.Dg
        return (torch.as_tensor(C, dtype=dtype, device=device),
                torch.as_tensor(D, dtype=dtype, device=device))

    def eval_rows(self, x, u, p, t, zlin=None):
        """Row values g(x, u) of one instance."""
        vals = []
        if self.nbx:
            vals.append(x[list(self.idxbx)])
        if self.nbu:
            vals.append(u[list(self.idxbu)])
        if self.ng:
            gv = _const(self.Cg, x) @ x
            if self.Dg is not None:
                gv = gv + _const(self.Dg, x) @ u
            vals.append(gv)
        if self.nh:
            vals.append(self._call_h(x, u, p, t, zlin))
        if self.nphi:
            vals.append(self.phi_fun(self.r_fun(x, u, p, t)))
        if not vals:
            return torch.zeros((0,), dtype=x.dtype, device=x.device)
        return torch.cat(vals)

    def _call_h(self, x, u, p, t, zlin=None):
        """The h rows of one instance (acados_tpu/ocp_nlp/formulation.py:
        283-288)."""
        if self.with_z:
            return self.h_fun(x, u, _z_of(zlin, x, u), p, t)
        return self.h_fun(x, u, p, t)

    def h_jac(self, x, u, p, t, zlin=None):
        """(nh + nphi, nx), (nh + nphi, nu) Jacobians of the nonlinear
        rows: the h block, then the phi(r) block by the chain rule."""
        nx = self.nx

        def nl(w_):
            vals = []
            if self.nh:
                vals.append(self._call_h(w_[:nx], w_[nx:], p, t, zlin))
            if self.nphi:
                vals.append(self.phi_fun(self.r_fun(w_[:nx], w_[nx:], p,
                                                    t)))
            return torch.cat(vals)

        J = jacfwd(nl)(torch.cat([x, u]))
        return J[:, :nx], J[:, nx:]

    def h_hess(self, x, u, p, t, lam_d, zlin=None):
        """Hessian over w = [x; u] of -(lam_l - lam_u)' h at one instance:
        the constraint term of the exact Lagrangian Hessian
        (acados_tpu/ocp_nlp/linearize.py:221-230). lam_d: the stage's
        (nc,) lam_l - lam_u, of which the h rows are read."""
        nx, off = self.nx, self.nbx + self.nbu + self.ng
        wh = lam_d[off:off + self.nh]
        return hessian(lambda w_: -(wh @ self._call_h(
            w_[:nx], w_[nx:], p, t, zlin)))(torch.cat([x, u]))

    def bgp_hess(self, x, u, p, t, lam_u):
        """The BGP rows' outer curvature over w = [x; u] at one instance:
        Jr' (sum_i w_i phi_i'') Jr, never d2r (reference
        ocp_nlp_constraints_bgp.c; acados_tpu/ocp_nlp/formulation.py:
        328-340). The weights w are the phi rows' UPPER multipliers only,
        read from the stage's (nc,) lam_u (reference bgp.c:1303): with
        phi convex and lam_u >= 0 the term stays positive semidefinite
        (acados_tpu/ocp_nlp/linearize.py:173-182)."""
        nx, off = self.nx, self.nbx + self.nbu + self.ng + self.nh
        w_phi = lam_u[off:off + self.nphi]
        r = self.r_fun(x, u, p, t)
        Hphi = hessian(lambda r_: w_phi @ self.phi_fun(r_))(r)
        Jr = jacfwd(lambda w_: self.r_fun(w_[:nx], w_[nx:], p, t))(
            torch.cat([x, u]))
        return Jr.T @ Hphi @ Jr

    def soft_row_mask(self, dtype, device):
        m = np.zeros(self.nrows)
        for i in self.soft_rows:
            m[i] = 1.0
        return torch.as_tensor(m, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class OcpNlpFormulation:
    """Static description of the discretized OCP (multiple shooting).

    step_fn / step_jac_fn are batch-first (see sim/integrator.py):
    step_fn(x, u, p, t, dt) -> x_next and step_jac_fn(...) ->
    (x_next, A, B) on (M, .) tensors; with nz > 0 (a DAE whose cost or
    constraints read z) step_jac_fn returns (x_next, A, B, z0, Jz), z at
    the interval start and dz0/d(x, u), and z_fun(x, u, p, t, dt) -> z0
    (M, nz) is the exact z(t0) for the merit and residual evaluations
    (acados_tpu/ocp_nlp/formulation.py:371-380). exact_hessian selects
    the exact Lagrangian Hessian (hessian_approx EXACT) over Gauss-Newton,
    with each term's curvature switched by exact_hess_cost/dyn/constr
    (reference acados_ocp_options.py:96-98; all on by default).
    """

    N: int
    nx: int
    nu: int
    np_: int  # parameter dimension
    step_fn: Callable
    step_jac_fn: Optional[Callable] = None
    nz: int = 0
    z_fun: Optional[Callable] = None
    cost_0: CostSpec = None
    cost: CostSpec = None
    cost_e: CostSpec = None
    con_0: ConstraintSpec = None
    con: ConstraintSpec = None
    con_e: ConstraintSpec = None
    exact_hessian: bool = False
    exact_hess_cost: bool = True
    exact_hess_dyn: bool = True
    exact_hess_constr: bool = True
    # stage-0 box rows are a full-state equality (constraints.x0 /
    # idxbxe_0 == range(nx)): enables initial-state elimination in the QP
    x0_equality: bool = False

    @property
    def nc(self) -> int:
        """Unified constraint rows, padded across stage classes."""
        return max(self.con_0.nrows, self.con.nrows, self.con_e.nrows, 1)


@tensor_dataclass
class NlpData:
    """Runtime-changeable problem data, batch-first (fields as
    acados_tpu.ocp_nlp.formulation.NlpData with a leading batch axis B).
    Row-bound arrays are in unified row layout per stage class; path
    arrays lead with (B, N-1, ...)."""

    p: torch.Tensor          # (B, N+1, np)
    ts: torch.Tensor         # (B, N+1) stage times
    dts: torch.Tensor        # (B, N) interval lengths
    cost_scale: torch.Tensor  # (B, N+1)
    yref_0: Any
    W_0: Any
    yref: Any                # (B, N-1, ny)
    W: Any                   # (B, N-1, ny, ny)
    yref_e: Any
    W_e: Any
    lb_0: torch.Tensor       # (B, nc)
    ub_0: torch.Tensor
    lb: torch.Tensor         # (B, N-1, nc)
    ub: torch.Tensor
    lb_e: torch.Tensor
    ub_e: torch.Tensor
    Zl_0: torch.Tensor
    Zu_0: torch.Tensor
    zl_0: torch.Tensor
    zu_0: torch.Tensor
    Zl: torch.Tensor
    Zu: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    Zl_e: torch.Tensor
    Zu_e: torch.Tensor
    zl_e: torch.Tensor
    zu_e: torch.Tensor


def cost_data_stage0(data: NlpData):
    return {"yref": data.yref_0, "W": data.W_0}


def cost_data_path(data: NlpData):
    return {"yref": data.yref, "W": data.W}


def cost_data_term(data: NlpData):
    return {"yref": data.yref_e, "W": data.W_e}
