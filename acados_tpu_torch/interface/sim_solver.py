"""AcadosSim / AcadosSimSolver / AcadosSimBatchSolver: the standalone
integrator interface.

Counterpart of `acados_tpu/interface/sim_solver.py` (API mirror of the
reference acados_sim.py and acados_sim_solver.py:348: `simulate(x, u,
p)` plus set/get of seeds and sensitivity options), backed by the
batch-first integrators of `acados_tpu_torch.sim` and
`sim.integrator.simulate`. The solver runs on the card unless `device`
is "cpu". The batch solver is one batch-first call over all instances,
not a loop of per-instance solvers. Integrators: ERK, IRK (ODEs and DAEs,
whose z at the interval end is get("z")), GNSF (IRK where no structure is
detected) and LIFTED_IRK, whose stage variables the solver holds between
simulate() calls (single solver only, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import AcadosModel, _dim_of
from acados_tpu_torch.sim.integrator import (SimOpts, make_step_fn,
                                             normalize_dynamics,
                                             normalize_implicit_dynamics,
                                             simulate)
from acados_tpu_torch.sim.irk import implicit_from_explicit
from acados_tpu_torch.sim.lifted_irk import make_lifted_irk_step
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


class AcadosSimSolver:
    """Reference: acados_sim_solver.py. simulate() returns x_next; the
    whole sim_out surface (xn, S_forw, Sx, Su, S_adj, S_hess, zn) is
    reachable through get(). One instance runs as a batch of one.
    LIFTED_IRK keeps its lifted stage variables K between calls
    (reference sim_lifted_irk_memory; acados_tpu/interface/sim_solver.py:
    62-80, 97-112): each simulate() runs one Newton iteration from the
    previous call's K."""

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
        self.dtype = torch.float64 if so.dtype == "float64" \
            else torch.float32
        self.T = float(so.T)
        self._p = np.zeros(self.np) if sim.parameter_values is None \
            else np.asarray(sim.parameter_values, np.float64)
        self._lifted_K = None
        if so.integrator_type == "LIFTED_IRK":
            m = sim.model
            fi = (normalize_implicit_dynamics(m.f_impl_expr)
                  if m.f_impl_expr is not None else
                  implicit_from_explicit(normalize_dynamics(m.f_expl_expr)))
            self._lstep, K0 = make_lifted_irk_step(
                fi, nx=self.nx, nz=self.nz, num_stages=so.num_stages,
                num_steps=so.num_steps, collocation=so.collocation_type)
            self._lifted_K = K0.to(device=self.device, dtype=self.dtype)[None]
            self._step = None
        else:
            self._step = make_step_fn(
                f_expl=sim.model.f_expl_expr, f_impl=sim.model.f_impl_expr,
                nx=self.nx, nu=self.nu, nz=self.nz, p=self._p,
                opts=SimOpts(integrator_type=so.integrator_type,
                             num_stages=so.num_stages,
                             num_steps=so.num_steps,
                             newton_iter=so.newton_iter,
                             collocation_type=so.collocation_type))
        self._seed_adj = np.zeros(self.nx)
        self._x = np.zeros(self.nx)
        self._u = np.zeros(self.nu)
        self._out = None

    def _run(self, x, u, p, seed_adj=None):
        """simulate() over a batch of host arrays; LIFTED_IRK also moves
        its lifted state on to the next call's."""
        so = self.acados_sim.solver_options
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                         device=self.device)
        x, u, p = as_t(x), as_t(u), as_t(p)
        step = self._step
        if self._lifted_K is not None:
            K = self._lifted_K
            step = lambda *a: self._lstep(*a, K)[0]
        out = simulate(step, x, u, p, t0=0.0, dt=self.T,
                       seed_adj=None if seed_adj is None else as_t(seed_adj),
                       sens_forw=so.sens_forw, sens_adj=so.sens_adj,
                       sens_hess=so.sens_hess,
                       nz=0 if self._lifted_K is not None else self.nz)
        if self._lifted_K is not None:
            T = torch.full((x.shape[0],), self.T, dtype=self.dtype,
                           device=self.device)
            self._lifted_K = self._lstep(x, u, p, torch.zeros_like(T), T,
                                         K)[1]
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
        if sim.solver_options.integrator_type == "LIFTED_IRK":
            raise NotImplementedError(
                "batched lifted IRK: call sim.lifted_irk.make_lifted_irk_"
                "step on the batch directly (its step is batch-first)")
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
