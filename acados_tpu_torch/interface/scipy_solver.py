"""Independent cross-check solver on scipy (general-purpose NLP).

Counterpart of `acados_tpu/interface/scipy_solver.py` (the analog of
the reference's AcadosCasadiOcpSolver, acados_casadi_ocp_solver.py:
41-398): the SAME AcadosOcp, transcribed into one dense NLP over
w = [x_0..x_N, u_0..u_{N-1}] and handed to scipy.optimize's SLSQP, with
the objective's gradient from torch.func.grad and the constraint
Jacobians from torch.func.jacfwd of the port's own evaluation functions.

Not a production path: dense and single-instance. The functions are
evaluated on the solver's device (the card unless device="cpu"), in
float64, and each SLSQP evaluation hands numpy to scipy, so each is a
host round trip. Use it to validate the structure-exploiting solvers on
small problems.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.func
from scipy import optimize

from acados_tpu_torch.interface.acados_ocp import AcadosOcp
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.ocp_nlp.linearize import (build_static_rows,
                                                eval_constraints, eval_cost,
                                                eval_dyn_gap)
from acados_tpu_torch.utils.device import (full_precision_matmul,
                                           resolve_device)

_INF_THR = 0.5e10   # bounds beyond this are absent


class AcadosScipyOcpSolver:
    """Drop-in cross-check solver: the same AcadosOcp in, an independent
    optimizer underneath. Soft constraints are treated as hard (the
    oracle solves the idealized problem); `device` None means "cuda"."""

    def __init__(self, ocp: AcadosOcp, tol=1e-9, maxiter=500, device=None):
        self.device = resolve_device(device)
        full_precision_matmul()
        self.acados_ocp = ocp
        self.form, self._data, self.layouts = build_ocp(ocp)
        self.tol = tol
        self.maxiter = maxiter
        self.N = self.form.N
        self._x = None
        self._u = None

        form, dev, f64 = self.form, self.device, torch.float64
        N, nx, nu = form.N, form.nx, form.nu
        data = data_to_torch(self._data, f64, dev, batch=1)
        mask = build_static_rows(form, f64, dev)["mask"].cpu().numpy()
        zero_soft = torch.zeros((1, N + 1, form.nc), dtype=f64, device=dev)

        def unpack(w):
            return (w[:(N + 1) * nx].reshape(1, N + 1, nx),
                    w[(N + 1) * nx:].reshape(1, N, nu))

        def f_obj(w):
            x, u = unpack(w)
            return eval_cost(form, data, x, u, zero_soft, zero_soft,
                             zero_soft)[0]

        def f_dyn(w):
            return eval_dyn_gap(form, data, *unpack(w)).reshape(-1)

        def f_rows(w):
            return eval_constraints(form, data, *unpack(w))[0]

        self._fns = dict(obj=f_obj, g_obj=torch.func.grad(f_obj),
                         dyn=f_dyn, J_dyn=torch.func.jacfwd(f_dyn),
                         rows=f_rows, J_rows=torch.func.jacfwd(f_rows))
        lb_all = np.concatenate([self._data["lb_0"][None], self._data["lb"],
                                 self._data["lb_e"][None]])
        ub_all = np.concatenate([self._data["ub_0"][None], self._data["ub"],
                                 self._data["ub_e"][None]])
        self._rows_l = (mask > 0) & (lb_all > -_INF_THR)
        self._rows_u = (mask > 0) & (ub_all < _INF_THR)
        self._lb = lb_all
        self._ub = ub_all

    def _eval(self, name, w) -> np.ndarray:
        """One of the transcription's functions at a numpy w, on the
        device, back as numpy."""
        wt = torch.as_tensor(w, dtype=torch.float64, device=self.device)
        return self._fns[name](wt).detach().cpu().numpy()

    def solve(self, x_init=None, u_init=None) -> int:
        form = self.form
        N, nx, nu = form.N, form.nx, form.nu
        x0 = np.zeros((N + 1, nx)) if x_init is None else \
            np.asarray(x_init, np.float64)
        u0 = np.zeros((N, nu)) if u_init is None else \
            np.asarray(u_init, np.float64)
        w0 = np.concatenate([x0.reshape(-1), u0.reshape(-1)])
        rl, ru = self._rows_l, self._rows_u

        def ineq(w):
            g = self._eval("rows", w)
            return np.concatenate([(g - self._lb)[rl], (self._ub - g)[ru]])

        def ineq_jac(w):
            J = self._eval("J_rows", w)
            return np.concatenate([J[rl], -J[ru]])

        res = optimize.minimize(
            lambda w: float(self._eval("obj", w)), w0,
            jac=lambda w: self._eval("g_obj", w),
            constraints=[
                dict(type="eq", fun=lambda w: self._eval("dyn", w),
                     jac=lambda w: self._eval("J_dyn", w)),
                dict(type="ineq", fun=ineq, jac=ineq_jac),
            ],
            method="SLSQP",
            options=dict(maxiter=self.maxiter, ftol=self.tol))
        w = res.x
        self._x = w[:(N + 1) * nx].reshape(N + 1, nx)
        self._u = w[(N + 1) * nx:].reshape(N, nu)
        self._result = res
        return 0 if res.success else 2

    def get(self, stage: int, field: str):
        if field == "x":
            return self._x[stage].copy()
        if field == "u":
            return self._u[stage].copy()
        raise ValueError(field)

    def get_cost(self) -> float:
        return float(self._result.fun)
