"""Explicit Runge-Kutta integrator.

Counterpart of `acados_tpu/sim/erk.py`. The step of one instance is a
plain torch function of (x, u, p, t0, dt); `torch.func.vmap` batches it
and `torch.func.jacfwd` of it gives the forward sensitivities (the
reference's forward VDE).
"""
from __future__ import annotations

import torch

from acados_tpu_torch.sim.butcher import erk_tableau


def make_erk_step_one(f, num_stages: int = 4, num_steps: int = 1):
    """Per-instance explicit-RK step: step(x, u, p, t0, dt) -> x_next,
    integrating f(x, u, p, t) over [t0, t0 + dt] in num_steps steps."""
    A, b, c = erk_tableau(num_stages)

    def step(x, u, p, t0, dt):
        h = dt / num_steps
        for i in range(num_steps):
            t = t0 + i * h
            ks = []
            for si in range(num_stages):
                xi = x
                for sj in range(si):
                    if A[si, sj] != 0.0:
                        xi = xi + (h * float(A[si, sj])) * ks[sj]
                ks.append(f(xi, u, p, t + float(c[si]) * h))
            x_next = x
            for sj in range(num_stages):
                x_next = x_next + (h * float(b[sj])) * ks[sj]
            x = x_next
        return x

    return step


def make_erk_step(f, num_stages: int = 4, num_steps: int = 1):
    """Batch-first explicit-RK step: step(x (M, nx), u (M, nu), p (M, np),
    t0 (M,), dt (M,)) -> x_next (M, nx)."""
    return torch.func.vmap(make_erk_step_one(f, num_stages, num_steps))
