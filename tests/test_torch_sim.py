"""PyTorch port, the simulator: `sim/integrator.py:simulate`, the
implicit gradient of `sim/irk.py:make_irk_step` and
`interface/sim_solver.py`, against the JAX package in float64 on the CPU.

The reference differentiates its IRK step through `jax.lax.custom_root`
(the implicit function theorem at the final Newton iterate); the port's
`_stage_root` gives the same derivatives through an autograd Function,
so S_forw (jacfwd), S_adj (vjp) and S_hess (jacfwd of vjp) agree to
rounding (1e-9 relative). The JAX side is jitted once per configuration.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu import AcadosModel as JaxModel
from acados_tpu import AcadosSim as JaxSim
from acados_tpu import AcadosSimSolver as JaxSimSolver
from acados_tpu.models.pendulum import pendulum_ode as jax_pendulum_ode
from acados_tpu.sim.integrator import SimOpts as JaxSimOpts
from acados_tpu.sim.integrator import make_step_fn as jax_make_step_fn
from acados_tpu.sim.integrator import simulate as jax_simulate
from acados_tpu.sim.irk import implicit_from_explicit as jax_implicit
from acados_tpu.sim.irk import make_irk_step as jax_make_irk_step
from acados_tpu_torch import (AcadosModel, AcadosSim, AcadosSimBatchSolver,
                              AcadosSimSolver)
from acados_tpu_torch.models.pendulum import pendulum_ode
from acados_tpu_torch.sim.integrator import SimOpts, make_step_fn, simulate
from acados_tpu_torch.sim.irk import implicit_from_explicit, make_irk_step
from acados_tpu_torch.testing import param_pendulum_ode
from test_sensitivity import parametric_pendulum_ode as jax_param_ode

torch.set_num_threads(1)

M, NX, NU, DT = 3, 4, 1, 0.05
REL = 1e-9


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = np.array([0.0, np.pi, 0.0, 0.0]) + 0.3 * rng.normal(size=(M, NX))
    u = 5.0 * rng.normal(size=(M, NU))
    seed_adj = rng.normal(size=(M, NX))
    return x, u, seed_adj


def _close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    if ref.size == 0:
        return
    assert np.max(np.abs(ours - ref)) <= rel * max(np.max(np.abs(ref)),
                                                   1e-300)


# (integrator, stages, steps, collocation): every family, every number of
# stages 1-4 and of steps 1-3 at least once
CONFIGS = [("ERK", 1, 3, None), ("ERK", 4, 2, None),
           ("IRK", 1, 1, "GAUSS_LEGENDRE"), ("IRK", 4, 2, "GAUSS_LEGENDRE"),
           ("IRK", 2, 3, "RADAU_IIA"), ("IRK", 3, 1, "RADAU_IIA")]


@pytest.mark.parametrize("itype,ns,nsteps,coll", CONFIGS)
def test_simulate_matches_jax(itype, ns, nsteps, coll):
    """xn, S_forw, S_adj and S_hess of the batch-first simulate against
    jax.vmap of the JAX package's per-instance simulate."""
    x, u, seed_adj = _inputs(ns + 10 * nsteps)
    kw = dict(integrator_type=itype, num_stages=ns, num_steps=nsteps)
    if coll:
        kw["collocation_type"] = coll
    jstep = jax_make_step_fn(f_expl=lambda x, u: jax_pendulum_ode(x, u),
                             nx=NX, opts=JaxSimOpts(**kw))
    ref = jax.jit(jax.vmap(lambda a, b, s: jax_simulate(
        jstep, a, b, None, 0.0, DT, s, True, True, True)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(seed_adj))
    step = make_step_fn(f_expl=lambda x, u: pendulum_ode(x, u), nx=NX,
                        opts=SimOpts(**kw))
    out = simulate(step, torch.as_tensor(x), torch.as_tensor(u), None, 0.0,
                   DT, torch.as_tensor(seed_adj), True, True, True)
    for f in ("xn", "S_forw", "S_adj", "S_hess"):
        _close(getattr(out, f).numpy(), getattr(ref, f))
    # the same without S_hess: S_forw by jvp, S_adj by vjp
    out2 = simulate(step, torch.as_tensor(x), torch.as_tensor(u), None,
                    0.0, DT, torch.as_tensor(seed_adj), True, True, False)
    for f in ("xn", "S_forw", "S_adj"):
        _close(getattr(out2, f).numpy(), getattr(ref, f))
    assert not out2.S_hess.any()


def _param_steps(ns=3, nsteps=2):
    jstep = jax_make_irk_step(jax_implicit(jax_param_ode), NX, 0, ns,
                              nsteps, 3)
    step = make_irk_step(implicit_from_explicit(param_pendulum_ode), NX,
                         0, ns, nsteps, 3)
    rng = np.random.default_rng(7)
    x = np.array([0.0, 2.5, 0.0, 0.0]) + 0.3 * rng.normal(size=(M, NX))
    u = 5.0 * rng.normal(size=(M, NU))
    p = np.array([0.1, 0.8]) + 0.02 * rng.normal(size=(M, 2))
    lam = rng.normal(size=(M, NX))
    return jstep, step, x, u, p, lam


def _one(step):
    """The batch-first step as a per-instance function of (x, u, p)."""
    def f(x, u, p):
        t = x.new_zeros((1,))
        return step(x[None], u[None], p[None], t, t + DT)[0][0]
    return f


def test_irk_implicit_gradient_matches_jax_jacfwd():
    """jacfwd of make_irk_step with respect to x, u and the parameters p
    (vmapped over the instances) against jax.jacfwd through the
    reference's custom_root."""
    jstep, step, x, u, p, _ = _param_steps()
    ref = jax.jit(jax.vmap(jax.jacfwd(
        lambda a, b, c: jstep(a, b, c, 0.0, DT)[0], argnums=(0, 1, 2))))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(p))
    out = torch.func.vmap(torch.func.jacfwd(_one(step), argnums=(0, 1, 2)))(
        *map(torch.as_tensor, (x, u, p)))
    for o, r in zip(out, ref):
        _close(o.numpy(), r)


def test_irk_hessian_matches_jax_hessian():
    """torch.func.hessian (forward over reverse, through the implicit
    gradient's own rules) of lam' x_next in (x, u, p) against
    jax.hessian."""
    jstep, step, x, u, p, lam = _param_steps(ns=2, nsteps=2)

    def jf(w, c, l):
        return l @ jstep(w[:NX], w[NX:], c, 0.0, DT)[0]

    def tf(w, c, l):
        return l @ _one(step)(w[:NX], w[NX:], c)

    w = np.concatenate([x, u], axis=1)
    ref = jax.jit(jax.vmap(jax.hessian(jf, argnums=(0, 1))))(
        jnp.asarray(w), jnp.asarray(p), jnp.asarray(lam))
    out = torch.func.vmap(torch.func.hessian(tf, argnums=(0, 1)))(
        *map(torch.as_tensor, (w, p, lam)))
    for o_row, r_row in zip(out, ref):
        for o, r in zip(o_row, r_row):
            _close(o.numpy(), r)


def test_irk_step_gradcheck():
    """Reverse mode, batched, and second order (gradgradcheck runs the
    backward's own backward)."""
    _, step, x, u, p, _ = _param_steps(ns=2, nsteps=1)
    t = torch.zeros(2, dtype=torch.float64)

    def f(x, u, p):
        return step(x, u, p, t, t + DT)[0]

    args = [torch.tensor(a[:2], requires_grad=True) for a in (x, u, p)]
    assert torch.autograd.gradcheck(f, args, check_batched_grad=True)
    assert torch.autograd.gradgradcheck(f, args, check_batched_grad=True)


def test_irk_forward_is_unchanged_by_the_root():
    """The Newton iterates are the forward-only loop's, bit for bit."""
    from acados_tpu_torch.sim.irk import _stage_residual, _tableau
    from acados_tpu_torch.ops.linsolve import linsolve
    from acados_tpu_torch.utils.autodiff import jacfwd
    _, step, x, u, p, _ = _param_steps(ns=3, nsteps=2)
    x, u, p = map(torch.as_tensor, (x, u, p))
    t0, dt = torch.zeros(M, dtype=torch.float64), torch.full(
        (M,), DT, dtype=torch.float64)
    A_t, b_t, c_t = _tableau("GAUSS_LEGENDRE", 3)
    res = _stage_residual(implicit_from_explicit(param_pendulum_ode), A_t,
                          c_t, NX, 0)
    res_b, jac_w = torch.func.vmap(res), torch.func.vmap(jacfwd(res))
    h = dt / 2
    w = torch.zeros((M, 3 * NX), dtype=torch.float64)
    x_k = x
    for i in range(2):
        t = t0 + i * h
        for _ in range(3):
            w = w - linsolve(jac_w(w, x_k, u, p, t, h),
                             res_b(w, x_k, u, p, t, h))
        x_k = x_k + h[:, None] * (torch.as_tensor(b_t) @ w.reshape(M, 3,
                                                                   NX))
    assert torch.equal(step(x, u, p, t0, dt)[0], x_k)


def _sims(itype="IRK"):
    """The same simulator in both packages: the pendulum, 4 stages, 2
    steps, every sensitivity."""
    jm, tm = JaxModel(), AcadosModel()
    jm.x, jm.u, tm.x, tm.u = NX, NU, NX, NU
    jm.f_expl_expr = lambda x, u: jax_pendulum_ode(x, u)
    tm.f_expl_expr = lambda x, u: pendulum_ode(x, u)
    out = []
    for sim, model in ((JaxSim(), jm), (AcadosSim(), tm)):
        sim.model = model
        so = sim.solver_options
        so.T, so.integrator_type, so.num_stages, so.num_steps = \
            DT, itype, 4, 2
        so.sens_forw = so.sens_adj = so.sens_hess = True
        out.append(sim)
    return out


FIELDS = ("xn", "x", "S_forw", "Sx", "Su", "S_adj", "S_hess", "z", "zn")


def test_sim_solver_set_get_matches_jax():
    """Every settable field (x, u, p, seed_adj, T) and every gettable one
    against the JAX package's AcadosSimSolver."""
    jsim, tsim = _sims()
    js, ts = JaxSimSolver(jsim), AcadosSimSolver(tsim, device="cpu")
    x, u, seed_adj = _inputs(5)
    for s in (js, ts):
        s.set("x", x[0])
        s.set("u", u[0])
        s.set("p", np.zeros(0))
        s.set("seed_adj", seed_adj[0])
        s.set("T", 0.04)
        assert s.solve() == 0
    for f in FIELDS:
        _close(ts.get(f), js.get(f))
    # simulate() convenience: set and solve in one call
    _close(ts.simulate(x=x[1], u=u[1]), js.simulate(x=x[1], u=u[1]))
    with pytest.raises(ValueError):
        ts.set("xdot", x[0])
    with pytest.raises(ValueError):
        ts.get("lam")


def test_sim_batch_solver_equals_serial():
    """One batch-first call equals a loop of the serial solver."""
    _, tsim = _sims()
    tsim.solver_options.sens_adj = tsim.solver_options.sens_hess = False
    x, u, _ = _inputs(6)
    batch = AcadosSimBatchSolver(tsim, M, device="cpu")
    xn = batch.simulate(x, u)
    S = batch.get("S_forw")
    one = AcadosSimSolver(tsim, device="cpu")
    for i in range(M):
        _close(xn[i], one.simulate(x=x[i], u=u[i]), 1e-14)
        _close(S[i], one.get("S_forw"), 1e-14)
    assert batch.sim_solvers[0].nx == NX


def test_not_ported_integrators_raise_naming_item_17():
    """Item 17 ported GNSF and LIFTED_IRK into the simulator
    (tests/test_torch_gnsf.py, test_torch_lifted_irk.py): both build and
    simulate; what stays refused is the JAX package's refusal, a batch of
    lifted simulators, and LIFTED_IRK as a plain step function."""
    _, tsim = _sims()
    x, u, _ = _inputs(8)
    for itype in ("GNSF", "LIFTED_IRK"):
        tsim.solver_options.integrator_type = itype
        xn = AcadosSimSolver(tsim, device="cpu").simulate(x=x[0], u=u[0])
        assert xn.shape == (NX,) and np.isfinite(xn).all()
    with pytest.raises(NotImplementedError, match="lifted"):
        AcadosSimBatchSolver(tsim, 4, device="cpu")
    with pytest.raises(ValueError, match="stage memory"):
        make_step_fn(f_expl=lambda x, u: pendulum_ode(x, u), nx=NX,
                     opts=SimOpts(integrator_type="LIFTED_IRK"))
