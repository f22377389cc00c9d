"""NLP formulation: per-stage cost and constraint modules, runtime data.

Counterpart of `acados_tpu/ocp_nlp/formulation.py`. Cost and constraint
callables are per-instance torch functions of (x, u, p, t); the
derivatives the reference gets from CasADi come from `torch.func.jacfwd`
and the linearizer batches them with `torch.func.vmap`. Box bounds,
general linear rows (C/D) and nonlinear h rows are folded into one
unified row block per stage class, as in the JAX package.

Ported: cost kinds LINEAR_LS, NONLINEAR_LS, CONL (generalized
Gauss-Newton) and EXTERNAL, with the exact cost Hessian where the JAX
package takes it; BGH constraint rows with soft rows. Cost integration
and BGP rows wait (ROADMAP.md Queue 1, item 16b), z-dependent modules
too (item 17).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from acados_tpu_torch.utils.autodiff import hessian, jacfwd
from acados_tpu_torch.utils.struct import tensor_dataclass


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                           device=like.device)


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
    Vx/Vu: LINEAR_LS constant Jacobian blocks (numpy); when set the
      Jacobian is a constant and no AD pass runs.
    """

    kind: str
    ny: int = 0
    y_fun: Optional[Callable] = None
    psi_fun: Optional[Callable] = None
    ext_fun: Optional[Callable] = None
    Vx: Optional[np.ndarray] = None
    Vu: Optional[np.ndarray] = None

    def value(self, x, u, p, t, data) -> torch.Tensor:
        """Stage cost value of one instance (without slack penalties)."""
        if self.kind in ("LINEAR_LS", "NONLINEAR_LS"):
            r = self.y_fun(x, u, p, t) - data["yref"]
            return 0.5 * r @ data["W"] @ r
        if self.kind == "CONL":
            return self.psi_fun(self.y_fun(x, u, p, t) - data["yref"], p)
        if self.kind == "EXTERNAL":
            return self.ext_fun(x, u, p, t)
        raise ValueError(self.kind)

    def quad_approx(self, x, u, p, t, data, exact_hessian: bool = False):
        """Quadratic approximation of one instance at (x, u): (H, grad)
        over w = [x; u] (reference cost update_qp_matrices;
        acados_tpu/ocp_nlp/formulation.py:120-213)."""
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
        if self.kind in ("LINEAR_LS", "NONLINEAR_LS"):
            yf = lambda w_: self.y_fun(w_[:nx], w_[nx:], p, t)
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
            yf = lambda w_: self.y_fun(w_[:nx], w_[nx:], p, t) - data["yref"]
            r = yf(w)
            J = jacfwd(yf)(w)
            psi = lambda r_: self.psi_fun(r_, p)
            gpsi = jacfwd(psi)(r)
            Hpsi = hessian(psi)(r)
            return J.T @ Hpsi @ J, J.T @ gpsi
        if self.kind == "EXTERNAL":
            f = lambda w_: self.ext_fun(w_[:nx], w_[nx:], p, t)
            grad = jacfwd(f)(w)
            H = jacfwd(jacfwd(f))(w)
            if exact_hessian:
                return H, grad
            return 0.5 * (H + H.T), grad
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """One stage-class BGH constraint block, folded to unified rows.

    Row layout: [box-x rows | box-u rows | general C/D rows | h rows].
    idxbx/idxbu: bounded state/input indices; Cg, Dg: general linear rows
    (numpy); h_fun: per-instance (x, u, p, t) -> (nh,); soft_rows: indices
    into the unified row block that are softened.
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
        return self.nbx + self.nbu + self.ng + self.nh

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

    def eval_rows(self, x, u, p, t):
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
            vals.append(self._call_h(x, u, p, t))
        if not vals:
            return torch.zeros((0,), dtype=x.dtype, device=x.device)
        return torch.cat(vals)

    def _call_h(self, x, u, p, t):
        """The h rows of one instance (acados_tpu/ocp_nlp/formulation.py:
        283; its z-dependent branch waits, ROADMAP.md Queue 1, item 17)."""
        return self.h_fun(x, u, p, t)

    def h_jac(self, x, u, p, t):
        """(nh, nx), (nh, nu) Jacobians of the nonlinear rows."""
        nx = self.nx
        J = jacfwd(lambda w_: self._call_h(w_[:nx], w_[nx:], p, t))(
            torch.cat([x, u]))
        return J[:, :nx], J[:, nx:]

    def h_hess(self, x, u, p, t, lam_d):
        """Hessian over w = [x; u] of -(lam_l - lam_u)' h at one instance:
        the constraint term of the exact Lagrangian Hessian
        (acados_tpu/ocp_nlp/linearize.py:221-230). lam_d: the stage's
        (nc,) lam_l - lam_u, of which the h rows are read."""
        nx, off = self.nx, self.nbx + self.nbu + self.ng
        wh = lam_d[off:off + self.nh]
        return hessian(lambda w_: -(wh @ self._call_h(w_[:nx], w_[nx:], p,
                                                      t)))(torch.cat([x, u]))

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
    (x_next, A, B) on (M, .) tensors. exact_hessian selects the exact
    Lagrangian Hessian (hessian_approx EXACT) over Gauss-Newton, with
    each term's curvature switched by exact_hess_cost/dyn/constr
    (reference acados_ocp_options.py:96-98; all on by default).
    """

    N: int
    nx: int
    nu: int
    np_: int  # parameter dimension
    step_fn: Callable
    step_jac_fn: Optional[Callable] = None
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
