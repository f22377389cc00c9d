"""Integrator factory.

Counterpart of `acados_tpu/sim/integrator.py`: builds the batch-first
one-interval step function, and the fused step + Jacobian function the
SQP linearization uses, from model functions and options.

Model functions are per-instance torch callables (x (nx,), u (nu,), ...);
every step function here is batch-first: step(x (M, nx), u (M, nu),
p (M, np), t0 (M,), dt (M,)).
"""
from __future__ import annotations

import dataclasses
import inspect

import torch
from torch.func import vmap

from acados_tpu_torch.sim.erk import make_erk_step, make_erk_step_one
from acados_tpu_torch.sim.irk import (implicit_from_explicit, make_irk_step,
                                      make_irk_step_jac)
from acados_tpu_torch.utils.autodiff import jacfwd


def normalize_dynamics(f):
    """Accept f(x, u), f(x, u, p) or f(x, u, p, t); return f(x, u, p, t)."""
    if f is None:
        return None
    nargs = len(inspect.signature(f).parameters)
    if nargs == 2:
        return lambda x, u, p, t: f(x, u)
    if nargs == 3:
        return lambda x, u, p, t: f(x, u, p)
    if nargs == 4:
        return f
    raise ValueError("dynamics must take (x,u[,p[,t]])")


def normalize_implicit_dynamics(f):
    """Accept f(xdot, x, z, u[, p[, t]]); return f(xdot, x, z, u, p, t)."""
    if f is None:
        return None
    nargs = len(inspect.signature(f).parameters)
    if nargs == 4:
        return lambda xd, x, z, u, p, t: f(xd, x, z, u)
    if nargs == 5:
        return lambda xd, x, z, u, p, t: f(xd, x, z, u, p)
    if nargs == 6:
        return f
    raise ValueError("implicit dynamics must take (xdot,x,z,u[,p[,t]])")


@dataclasses.dataclass(frozen=True)
class SimOpts:
    """Integrator options (reference sim opts, sim_common.h:120-158)."""

    integrator_type: str = "ERK"   # ERK | IRK (GNSF, LIFTED_IRK wait)
    num_stages: int = 4
    num_steps: int = 1
    newton_iter: int = 3
    collocation_type: str = "GAUSS_LEGENDRE"


def _not_ported(itype: str):
    return NotImplementedError(
        f"integrator_type {itype!r} is not ported yet (ROADMAP.md Queue 1, "
        "integrator breadth)")


def _implicit(f_expl, f_impl):
    if f_impl is not None:
        return normalize_implicit_dynamics(f_impl), False
    return implicit_from_explicit(normalize_dynamics(f_expl)), True


def make_step_fn(f_expl=None, f_impl=None, nx=None, nz=0,
                 opts: SimOpts = None):
    """Batch-first step(x, u, p, t0, dt) -> x_next (ODE)."""
    opts = opts or SimOpts()
    if opts.integrator_type == "ERK":
        if f_expl is None:
            raise ValueError("ERK requires explicit dynamics f_expl")
        return make_erk_step(normalize_dynamics(f_expl),
                             num_stages=opts.num_stages,
                             num_steps=opts.num_steps)
    if opts.integrator_type == "IRK":
        fi, _ = _implicit(f_expl, f_impl)
        irk = make_irk_step(fi, nx=nx, nz=nz, num_stages=opts.num_stages,
                            num_steps=opts.num_steps,
                            newton_iter=opts.newton_iter,
                            collocation=opts.collocation_type)
        return lambda x, u, p, t0, dt: irk(x, u, p, t0, dt)[0]
    raise _not_ported(opts.integrator_type)


def make_step_jac_fn(f_expl=None, f_impl=None, nx=None, nz=0,
                     opts: SimOpts = None, jac_reuse: bool = False):
    """Batch-first step_jac(x, u, p, t0, dt) -> (x_next, A, B).

    IRK: the fused path of sim/irk.py (one stage inverse serves all
    sensitivity columns). ERK: jacfwd of the step, which is what the JAX
    package's linearizer does when it gets no fused function."""
    opts = opts or SimOpts()
    if opts.integrator_type == "IRK":
        fi, explicit_ode = _implicit(f_expl, f_impl)
        return make_irk_step_jac(
            fi, nx=nx, nz=nz, num_stages=opts.num_stages,
            num_steps=opts.num_steps, newton_iter=opts.newton_iter,
            collocation=opts.collocation_type, jac_reuse=jac_reuse,
            explicit_ode=explicit_ode)
    if opts.integrator_type == "ERK":
        step_one = make_erk_step_one(normalize_dynamics(f_expl),
                                     num_stages=opts.num_stages,
                                     num_steps=opts.num_steps)

        def phi(w, p, t0, dt):
            return step_one(w[:nx], w[nx:], p, t0, dt)

        step_b, jac_b = vmap(phi), vmap(jacfwd(phi))

        def step_jac(x, u, p, t0, dt):
            w = torch.cat([x, u], dim=-1)
            J = jac_b(w, p, t0, dt)
            return step_b(w, p, t0, dt), J[:, :, :nx], J[:, :, nx:]

        return step_jac
    raise _not_ported(opts.integrator_type)


def simulate(*args, **kwargs):
    raise NotImplementedError(
        "the standalone simulator with S_forw/S_adj/S_hess is not ported "
        "yet (ROADMAP.md Queue 1, integrator breadth)")
