"""AcadosSim / AcadosSimSolver / AcadosSimBatchSolver: the standalone
integrator interface.

Counterpart of `acados_tpu/interface/sim_solver.py` (API mirror of the
reference acados_sim.py and acados_sim_solver.py:348: `simulate(x, u,
p)` plus set/get of seeds and sensitivity options), backed by the
batch-first integrators of `acados_tpu_torch.sim` and
`sim.integrator.simulate`. The solver runs on the card unless `device`
is "cpu". The batch solver is one batch-first call over all instances,
not a loop of per-instance solvers. GNSF, LIFTED_IRK and DAEs (nz > 0)
raise, naming ROADMAP.md item 17.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import AcadosModel, _dim_of
from acados_tpu_torch.sim.integrator import SimOpts, make_step_fn, simulate
from acados_tpu_torch.utils.device import (full_precision_matmul,
                                           resolve_device)


@dataclasses.dataclass
class AcadosSimOpts:
    """Reference: acados_sim.py sim options."""

    T: Optional[float] = None
    integrator_type: str = "ERK"
    num_stages: int = 4
    num_steps: int = 1
    newton_iter: int = 3
    collocation_type: str = "GAUSS_LEGENDRE"
    sens_forw: bool = True
    sens_adj: bool = False
    sens_hess: bool = False
    dtype: str = "float64"


@dataclasses.dataclass
class AcadosSim:
    model: AcadosModel = dataclasses.field(default_factory=AcadosModel)
    solver_options: AcadosSimOpts = dataclasses.field(
        default_factory=AcadosSimOpts)
    parameter_values: Optional[np.ndarray] = None


def _check_ported(sim: AcadosSim, nz: int):
    itype = sim.solver_options.integrator_type
    if itype in ("GNSF", "LIFTED_IRK") or nz > 0:
        what = (f"integrator_type {itype!r}" if nz == 0
                else "a DAE model (nz > 0)")
        raise NotImplementedError(
            f"the simulator with {what} is not ported yet (ROADMAP.md "
            "Queue 1, item 17, integrator breadth)")


class AcadosSimSolver:
    """Reference: acados_sim_solver.py. simulate() returns x_next; the
    whole sim_out surface (xn, S_forw, Sx, Su, S_adj, S_hess, zn) is
    reachable through get(). One instance runs as a batch of one."""

    def __init__(self, sim: AcadosSim, json_file=None, build=None,
                 generate=None, verbose=False, device=None):
        del json_file, build, generate, verbose  # codegen-era args accepted
        self.device = resolve_device(device)
        full_precision_matmul()
        self.acados_sim = sim
        so = sim.solver_options
        self.nx = _dim_of(sim.model.x)
        self.nu = _dim_of(sim.model.u)
        self.nz = _dim_of(sim.model.z)
        self.np = _dim_of(sim.model.p)
        _check_ported(sim, self.nz)
        self.dtype = torch.float64 if so.dtype == "float64" \
            else torch.float32
        self.T = float(so.T)
        self._p = np.zeros(self.np) if sim.parameter_values is None \
            else np.asarray(sim.parameter_values, np.float64)
        self._step = make_step_fn(
            f_expl=sim.model.f_expl_expr, f_impl=sim.model.f_impl_expr,
            nx=self.nx, nz=self.nz,
            opts=SimOpts(integrator_type=so.integrator_type,
                         num_stages=so.num_stages, num_steps=so.num_steps,
                         newton_iter=so.newton_iter,
                         collocation_type=so.collocation_type))
        self._seed_adj = np.zeros(self.nx)
        self._x = np.zeros(self.nx)
        self._u = np.zeros(self.nu)
        self._out = None

    def _run(self, x, u, p, seed_adj=None):
        """simulate() over a batch of host arrays."""
        so = self.acados_sim.solver_options
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                         device=self.device)
        out = simulate(self._step, as_t(x), as_t(u), as_t(p), t0=0.0,
                       dt=self.T,
                       seed_adj=None if seed_adj is None else as_t(seed_adj),
                       sens_forw=so.sens_forw, sens_adj=so.sens_adj,
                       sens_hess=so.sens_hess, nz=self.nz)
        if out.xn.is_cuda:
            torch.cuda.synchronize(out.xn.device)
        return out

    def set(self, field: str, value):
        value = np.atleast_1d(np.asarray(value, np.float64))
        if field == "x":
            self._x = value
        elif field == "u":
            self._u = value
        elif field == "p":
            self._p = value
        elif field == "seed_adj":
            self._seed_adj = value
        elif field == "T":
            self.T = float(value[0])
        else:
            raise ValueError(field)

    def solve(self) -> int:
        self._out = self._run(self._x[None], self._u[None], self._p[None],
                              self._seed_adj[None])
        return 0

    def get(self, field: str):
        if self._out is None:
            raise RuntimeError("call solve()/simulate() first")
        return _get(self._out, field, self.nx)[0]

    def simulate(self, x=None, u=None, p=None, xdot=None, z=None):
        """Reference: acados_sim_solver.py simulate() convenience."""
        del xdot, z
        if x is not None:
            self.set("x", x)
        if u is not None:
            self.set("u", u)
        if p is not None:
            self.set("p", p)
        status = self.solve()
        if status != 0:
            raise RuntimeError(f"sim solver status {status}")
        return self.get("xn")


def _get(out, field: str, nx: int) -> np.ndarray:
    """A sim_out field of every instance as a numpy array."""
    pick = {"x": "xn", "xn": "xn", "S_forw": "S_forw", "Sx": "S_forw",
            "Su": "S_forw", "S_adj": "S_adj", "S_hess": "S_hess",
            "z": "zn", "zn": "zn"}
    if field not in pick:
        raise ValueError(field)
    v = getattr(out, pick[field]).detach().cpu().numpy()
    if field == "Sx":
        return v[:, :, :nx]
    if field == "Su":
        return v[:, :, nx:]
    return v


class AcadosSimBatchSolver:
    """Batched standalone integrator (reference AcadosSimBatchSolver,
    acados_sim_batch_solver.py: N_batch capsules and an OpenMP
    parallel-for). Here one batch-first `simulate` call takes every
    instance; no per-instance solver runs."""

    def __init__(self, sim: AcadosSim, N_batch: int,
                 num_threads_in_batch_solve: int = None, device=None):
        del num_threads_in_batch_solve  # OpenMP knob: one call here
        if N_batch < 1:
            raise ValueError("N_batch must be positive")
        self.N_batch = N_batch
        self._one = AcadosSimSolver(sim, device=device)
        self.nx, self.nu, self.np = self._one.nx, self._one.nu, self._one.np
        self.dtype, self.device = self._one.dtype, self._one.device
        self._out = None

    def simulate(self, x, u, p=None):
        """x: (N_batch, nx), u: (N_batch, nu) -> xn (N_batch, nx), with
        S_forw as the options ask (the reference batch solver computes
        only xn and S_forw)."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        u = np.atleast_2d(np.asarray(u, np.float64))
        p = (np.zeros((x.shape[0], self.np)) if p is None
             else np.atleast_2d(np.asarray(p, np.float64)))
        so = self._one.acados_sim.solver_options
        self._out = simulate(
            self._one._step,
            *(torch.as_tensor(a, dtype=self.dtype, device=self.device)
              for a in (x, u, p)),
            t0=0.0, dt=self._one.T, sens_forw=so.sens_forw,
            nz=self._one.nz)
        return self.get("xn")

    def get(self, field: str):
        if self._out is None:
            raise RuntimeError("call simulate() first")
        if field not in ("x", "xn", "S_forw"):
            raise ValueError(field)
        return _get(self._out, field, self.nx)

    @property
    def sim_solvers(self):
        """Reference API parity: the batch is one call, so the prototype
        solver stands for every instance."""
        return [self._one]
