"""Integrator factory.

Counterpart of `acados_tpu/sim/integrator.py`: builds the batch-first
one-interval step function, and the fused step + Jacobian function the
SQP linearization uses, from model functions and options, and evaluates
the reference's `sim_out` surface (xn, S_forw, S_adj, S_hess, zn) with
`torch.func` on the batch-first step (`simulate`).

Model functions are per-instance torch callables (x (nx,), u (nu,), ...);
every step function here is batch-first: step(x (M, nx), u (M, nu),
p (M, np), t0 (M,), dt (M,)). Integrators: ERK, IRK (ODEs and DAEs; a
DAE's step returns (x_next, z_end)) and GNSF (with the reference's
fallback to IRK where no structure is detected); LIFTED_IRK carries
stage memory across calls and lives in `sim/lifted_irk.py`.
"""
from __future__ import annotations

import dataclasses
import inspect

import torch
from torch.func import vmap

from acados_tpu_torch.sim.erk import make_erk_step, make_erk_step_one
from acados_tpu_torch.sim.gnsf import detect_gnsf_structure, make_gnsf_step
from acados_tpu_torch.sim.irk import (implicit_from_explicit, make_irk_step,
                                      make_irk_step_jac)
from acados_tpu_torch.utils.autodiff import jacfwd
from acados_tpu_torch.utils.struct import tensor_dataclass


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

    integrator_type: str = "ERK"   # ERK | IRK | GNSF | LIFTED_IRK
    num_stages: int = 4
    num_steps: int = 1
    newton_iter: int = 3
    collocation_type: str = "GAUSS_LEGENDRE"


def _implicit(f_expl, f_impl):
    if f_impl is not None:
        return normalize_implicit_dynamics(f_impl), False
    return implicit_from_explicit(normalize_dynamics(f_expl)), True


def _gnsf_step_one(f_expl, nx, nu, p, opts: SimOpts):
    """The per-instance GNSF step of an explicit ODE, or None where no
    structure is detected (acados_tpu/sim/integrator.py:89-111: the
    reference's documented fallback is IRK)."""
    if f_expl is None:
        raise ValueError("GNSF requires explicit dynamics f_expl")
    if nu is None:
        raise ValueError("GNSF structure detection needs nu")
    model = detect_gnsf_structure(normalize_dynamics(f_expl), nx=nx, nu=nu,
                                  p=p)
    if model is None:
        return None
    return make_gnsf_step(model, num_stages=opts.num_stages,
                          num_steps=opts.num_steps,
                          newton_iter=max(opts.newton_iter, 3))


def make_step_fn(f_expl=None, f_impl=None, nx=None, nz=0,
                 opts: SimOpts = None, nu=None, p=None):
    """Batch-first step(x, u, p, t0, dt) -> x_next for an ODE; for an IRK
    DAE (nz > 0) -> (x_next, z_end) (acados_tpu/sim/integrator.py:
    59-118). nu and p are what GNSF's structure detection probes with."""
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
        if nz == 0:
            return lambda x, u, p, t0, dt: irk(x, u, p, t0, dt)[0]
        return irk
    if opts.integrator_type == "GNSF":
        one = _gnsf_step_one(f_expl, nx, nu, p, opts)
        if one is None:
            return make_step_fn(f_expl=f_expl, nx=nx, nz=nz,
                                opts=dataclasses.replace(
                                    opts, integrator_type="IRK"))
        return vmap(one)
    if opts.integrator_type == "LIFTED_IRK":
        raise ValueError(
            "LIFTED_IRK carries stage memory across calls; use "
            "sim.lifted_irk.make_lifted_irk_step (explicit lifted state) "
            "or AcadosSimSolver(integrator_type='LIFTED_IRK'), which holds "
            "the lifted variables between simulate() calls")
    raise ValueError(f"unknown integrator_type {opts.integrator_type}")


def step_jac_of(step_one, nx: int):
    """Batch-first step_jac(x, u, p, t0, dt) -> (x_next, A, B) from a
    per-instance step_one(x, u, p, t0, dt) -> x_next: vmap of its value
    and its jacfwd over w = (x, u), the JAX package's linearizer branch
    without a fused function (acados_tpu/ocp_nlp/linearize.py:128-136)."""
    def phi(w, p, t0, dt):
        return step_one(w[:nx], w[nx:], p, t0, dt)

    step_b, jac_b = vmap(phi), vmap(jacfwd(phi))

    def step_jac(x, u, p, t0, dt):
        w = torch.cat([x, u], dim=-1)
        J = jac_b(w, p, t0, dt)
        return step_b(w, p, t0, dt), J[:, :, :nx], J[:, :, nx:]

    return step_jac


def make_step_jac_fn(f_expl=None, f_impl=None, nx=None, nz=0,
                     opts: SimOpts = None, jac_reuse: bool = False,
                     nu=None):
    """Batch-first step_jac(x, u, p, t0, dt) -> (x_next, A, B), and for
    an IRK DAE (x_next, A, B, z0, Jz).

    IRK (and LIFTED_IRK, which the OCP integrates as IRK): the fused path
    of sim/irk.py (one stage inverse serves all sensitivity columns).
    ERK and GNSF: jacfwd of the step, which is what the JAX package's
    linearizer does when it gets no fused function (a GNSF model without
    structure integrates with IRK, as in make_step_fn)."""
    opts = opts or SimOpts()
    itype = opts.integrator_type
    if itype == "GNSF":
        one = _gnsf_step_one(f_expl, nx, nu, None, opts)
        if one is not None:
            return step_jac_of(one, nx)
        itype = "IRK"
    if itype in ("IRK", "LIFTED_IRK"):
        fi, explicit_ode = _implicit(f_expl, f_impl)
        return make_irk_step_jac(
            fi, nx=nx, nz=nz, num_stages=opts.num_stages,
            num_steps=opts.num_steps, newton_iter=opts.newton_iter,
            collocation=opts.collocation_type, jac_reuse=jac_reuse,
            explicit_ode=explicit_ode)
    if itype == "ERK":
        return step_jac_of(make_erk_step_one(normalize_dynamics(f_expl),
                                             num_stages=opts.num_stages,
                                             num_steps=opts.num_steps), nx)
    raise ValueError(f"unknown integrator_type {itype}")


@tensor_dataclass
class SimOut:
    """The reference's sim_out (sim_common.h:102-117), batch-first."""

    xn: torch.Tensor      # (M, nx)
    S_forw: torch.Tensor  # (M, nx, nx+nu) forward sens. [dx/dx0, dx/du]
    S_adj: torch.Tensor   # (M, nx+nu)     seed_adj' S_forw
    S_hess: torch.Tensor  # (M, nx+nu, nx+nu) second-order adjoint sensitivity
    zn: torch.Tensor      # (M, nz)


def _per_instance(v, M: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (M,) value as an (M,) tensor of like's dtype/device."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.expand(M) if v.dim() == 0 else v


def simulate(step, x, u, p=None, t0=0.0, dt=1.0, seed_adj=None,
             sens_forw=True, sens_adj=False, sens_hess=False,
             nz=0) -> SimOut:
    """One integration interval of a batch and the sensitivities asked
    for (reference sim_in seeds, sim_common.h:71-88; opts sens_*,
    sim_common.h:129-133), as acados_tpu/sim/integrator.py:169-201 takes
    them with `jax.jacfwd` and `jax.vjp`, here batch-first.

    step: a batch-first step (make_step_fn); x (M, nx), u (M, nu), p
    (M, np) or None, t0 and dt scalars or (M,), seed_adj (M, nx) or
    (nx,). S_forw is the jvp of the step along each of the nx + nu unit
    directions, vmapped over them (one batched pass: the IRK's Newton
    loop runs once); S_adj the vjp with seed_adj; S_hess the jvp of that
    vjp along the same directions (forward over reverse), which yields
    xn, S_forw and S_adj on the way. For a DAE (nz > 0) the step returns
    (x_next, z_end) and zn is z_end from one more plain call, as the JAX
    package takes it.
    """
    M, nx, nu = x.shape[0], x.shape[-1], u.shape[-1]
    dt_, dev = x.dtype, x.device
    nxu = nx + nu
    if p is None:
        p = torch.zeros((M, 0), dtype=dt_, device=dev)
    t0 = _per_instance(t0, M, x)
    dt = _per_instance(dt, M, x)
    if seed_adj is None:
        seed_adj = torch.zeros((M, nx), dtype=dt_, device=dev)
    seed_adj = torch.as_tensor(seed_adj, dtype=dt_, device=dev).expand(
        M, nx)

    def fwd(xu):
        out = step(xu[:, :nx], xu[:, nx:], p, t0, dt)
        return out[0] if isinstance(out, tuple) else out

    def adj(xu):
        xn_, pull = torch.func.vjp(fwd, xu)
        return pull(seed_adj)[0], xn_

    xu = torch.cat([x, u], dim=-1)
    # direction j: the unit vector e_j for every instance, (nxu, M, nxu)
    E = torch.eye(nxu, dtype=dt_, device=dev)[:, None].expand(nxu, M, nxu)
    cols = lambda d: d.to(dt_).permute(1, 2, 0)  # (nxu, M, n) -> (M, n, nxu)
    zeros = lambda *s: torch.zeros((M,) + s, dtype=dt_, device=dev)
    S_forw, S_adj, S_hess = zeros(nx, nxu), zeros(nxu), zeros(nxu, nxu)
    if sens_hess:
        (S_adj, xn), (dadj, dxn) = torch.func.vmap(
            lambda e: torch.func.jvp(adj, (xu,), (e,)),
            out_dims=((None, None), (0, 0)))(E)
        S_hess = cols(dadj)
        if sens_forw:
            S_forw = cols(dxn)
    else:
        if sens_forw:
            xn, dxn = torch.func.vmap(
                lambda e: torch.func.jvp(fwd, (xu,), (e,)),
                out_dims=(None, 0))(E)
            S_forw = cols(dxn)
        if sens_adj:
            S_adj, xn = adj(xu)
        elif not sens_forw:
            xn = fwd(xu)
    zn = step(x, u, p, t0, dt)[1] if nz > 0 else zeros(0)
    return SimOut(xn=xn, S_forw=S_forw, S_adj=S_adj.to(dt_),
                  S_hess=S_hess, zn=zn)
