"""Lifted implicit Runge-Kutta integrator, batch-first.

Counterpart of `acados_tpu/sim/lifted_irk.py` (reference
sim_lifted_irk_integrator.c:655): the collocation stage variables K are
lifted into the caller's memory and carried across calls, so each call
runs a single Newton iteration on the stage equations (the reference's
one), warm-started from the previous call. At a fixed point of the calls the lifted stage values
are IRK's converged ones.

The lifted state is an explicit argument, step(x, u, p, t0, dt, K) ->
(x_next, K_next), with K (M, num_steps, ns (nx + nz)); `AcadosSimSolver`
holds it between `simulate()` calls as the reference's solver memory.
The Newton solve is the reference's `jnp.linalg.solve`, here
`utils.autodiff.inv_solve`; `torch.func` transforms differentiate the
lifted map itself, K's dependence included (the Newton-type sensitivity
the lifted scheme defines).
"""
from __future__ import annotations

import torch
from torch.func import vmap

from acados_tpu_torch.sim.irk import _stage_residual, _tableau
from acados_tpu_torch.utils.autodiff import inv_solve, jacfwd


def make_lifted_irk_step(f_impl, nx: int, nz: int = 0, num_stages: int = 3,
                         num_steps: int = 1,
                         collocation: str = "GAUSS_LEGENDRE"):
    """Build the lifted-IRK step with its lifted state explicit.

    f_impl: per-instance f(xdot, x, z, u, p, t) -> (nx + nz,) residual.

    Returns (step, K0): step(x (M, nx), u (M, nu), p (M, np), t0 (M,),
    dt (M,), K (M, num_steps, nw)) -> (x_next (M, nx), K_next), and K0
    the zero lifted state of one instance, (num_steps, nw) float64."""
    A_t, b_t, c_t = _tableau(collocation, num_stages)
    ns = num_stages
    nw = ns * (nx + nz)
    res_one = _stage_residual(f_impl, A_t, c_t, nx, nz)
    res_b = vmap(res_one)
    jac_w = vmap(jacfwd(res_one, argnums=0))

    def step(x, u, p, t0, dt, K):
        M = x.shape[0]
        b_ = torch.as_tensor(b_t, dtype=x.dtype, device=x.device)
        h = dt / num_steps
        x_k, K_next = x, []
        for i in range(num_steps):
            t = t0 + i * h
            w = K[:, i]
            w = w - inv_solve(jac_w(w, x_k, u, p, t, h),
                              res_b(w, x_k, u, p, t, h))
            x_k = x_k + h[:, None] * (b_ @ w[:, : ns * nx].reshape(M, ns,
                                                                    nx))
            K_next.append(w)
        return x_k, torch.stack(K_next, dim=1)

    return step, torch.zeros((num_steps, nw), dtype=torch.float64)
