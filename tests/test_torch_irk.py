"""PyTorch port, integrators: the batch-first IRK and ERK steps against
`jax.vmap` of the JAX package's per-instance steps on the pendulum.

The canonical IRK config: Gauss-Legendre with 4 stages (the
AcadosOcpOptions default), 2 substeps, 3 Newton iterations, so the stage
matrix is (16, 16). The JAX side inverts it with LAPACK on the CPU
(acados_tpu/sim/irk.py:291), the port with the plain Gauss-Jordan (the
kernel's CPU version): the difference is rounding.
"""
import numpy as np
import pytest
import torch

import jax

from acados_tpu.models.pendulum import pendulum_ode as jax_pendulum_ode
from acados_tpu.sim.erk import make_erk_step as jax_make_erk_step
from acados_tpu.sim.irk import implicit_from_explicit as jax_implicit
from acados_tpu.sim.irk import make_irk_step as jax_make_irk_step
from acados_tpu.sim.irk import make_irk_step_jac as jax_make_irk_step_jac
from acados_tpu_torch.models.pendulum import pendulum_ode
from acados_tpu_torch.sim.integrator import (SimOpts, make_step_fn,
                                             make_step_jac_fn)
from acados_tpu_torch.sim.irk import implicit_from_explicit
from acados_tpu_torch.sim.irk import make_irk_step, make_irk_step_jac

torch.set_num_threads(1)

NX, NU, NS, NSTEPS, NEWTON = 4, 1, 4, 2, 3


def _inputs(seed, M=12):
    rng = np.random.default_rng(seed)
    x = np.array([0.0, np.pi, 0.0, 0.0]) + rng.normal(size=(M, NX))
    u = 20.0 * rng.normal(size=(M, NU))
    p = np.zeros((M, 0))
    t0 = rng.uniform(0.0, 1.0, size=M)
    dt = np.full(M, 0.05)
    return x, u, p, t0, dt


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jax_impl():
    return jax_implicit(lambda x, u, p, t: jax_pendulum_ode(x, u))


def _torch_impl():
    return implicit_from_explicit(lambda x, u, p, t: pendulum_ode(x, u))


@pytest.mark.parametrize("jac_reuse", [False, True])
def test_irk_step_jac_matches_jax(jac_reuse):
    args = _inputs(0)
    jf = jax_make_irk_step_jac(_jax_impl(), NX, 0, NS, NSTEPS, NEWTON,
                               jac_reuse=jac_reuse, explicit_ode=True)
    tf = make_irk_step_jac(_torch_impl(), NX, 0, NS, NSTEPS, NEWTON,
                           jac_reuse=jac_reuse, explicit_ode=True)
    ref = jax.vmap(jf)(*args)
    out = tf(*_torch(*args))
    for name, a, b in zip(("x_next", "A", "B"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-11, err_msg=name)


def test_irk_step_forward_matches_jax():
    args = _inputs(1)
    jf = jax_make_irk_step(_jax_impl(), NX, 0, NS, NSTEPS, NEWTON)
    tf = make_irk_step(_torch_impl(), NX, 0, NS, NSTEPS, NEWTON)
    ref = jax.vmap(jf)(*args)[0]
    np.testing.assert_allclose(tf(*_torch(*args))[0].numpy(),
                               np.asarray(ref), rtol=0, atol=1e-12)


def test_erk_step_matches_jax():
    args = _inputs(2)
    jf = jax_make_erk_step(lambda x, u, p, t: jax_pendulum_ode(x, u),
                           num_stages=4, num_steps=NSTEPS)
    opts = SimOpts(integrator_type="ERK", num_stages=4, num_steps=NSTEPS)
    step = make_step_fn(f_expl=lambda x, u: pendulum_ode(x, u), nx=NX,
                        opts=opts)
    ref = jax.vmap(jf)(*args)
    np.testing.assert_allclose(step(*_torch(*args)).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-12)
    # the ERK step_jac is jacfwd of the step, as the JAX linearizer's
    # fallback computes it
    step_jac = make_step_jac_fn(f_expl=lambda x, u: pendulum_ode(x, u),
                                nx=NX, opts=opts)
    xn, A, B = step_jac(*_torch(*args))
    J = jax.vmap(jax.jacfwd(lambda w, p, t, dt: jf(w[:NX], w[NX:], p, t,
                                                   dt)))(
        np.concatenate(args[:2], axis=1), *args[2:])
    np.testing.assert_allclose(xn.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(A.numpy(), np.asarray(J)[:, :, :NX],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(B.numpy(), np.asarray(J)[:, :, NX:],
                               rtol=0, atol=1e-12)


def test_float32_jacobians_stay_float32():
    """A float32 model gives float32 Jacobians (torch.func.jacfwd alone
    would promote `python float * 0-dim tensor` tangents to float64)."""
    x, u, p, t0, dt = (torch.as_tensor(a, dtype=torch.float32)
                       for a in _inputs(3, M=3))
    tf = make_irk_step_jac(_torch_impl(), NX, 0, NS, NSTEPS, NEWTON)
    assert all(o.dtype == torch.float32 for o in tf(x, u, p, t0, dt))


def test_unported_paths_raise():
    """The paths the JAX package refuses, refused alike: the Kronecker
    path (ported, tests/test_torch_chain.py) with algebraic variables,
    LIFTED_IRK as a plain step (its stage memory lives in
    sim/lifted_irk.py and the simulator) and an unknown integrator. DAEs
    and GNSF are ported (tests/test_torch_dae.py, test_torch_gnsf.py)."""
    with pytest.raises(ValueError, match="nz == 0"):
        make_irk_step_jac(_torch_impl(), NX, nz=1, num_stages=2,
                          kron_path=True)
    for itype, match in (("LIFTED_IRK", "stage memory"),
                         ("RK45", "unknown")):
        with pytest.raises(ValueError, match=match):
            make_step_fn(f_expl=lambda x, u: pendulum_ode(x, u), nx=NX,
                         opts=SimOpts(integrator_type=itype))
