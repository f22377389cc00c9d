"""The float32 bound of chip_smoke.py's phase 21: the forward-adjoint
consistency of the batched sensitivities on bench.py's
bench_pendulum_irk_sqp config (SQP, IRK Gauss-Legendre 4 stages, 2
substeps, N = 20, float32) at the first 4 of the card's x0s.

The bound on the card is 10 x the gap the JAX package shows in float32
(`acados_tpu_torch.testing.JAX_SENS_F32_GAP`): its forward sensitivities
d u_0 / d x0 against its adjoint seeded on u_0, instance by instance,
max|adj - fwd| / max|fwd|. Both come from one factorization of the KKT
system, so in float64 the two agree to rounding; in float32 they part by
the float32 rounding of two different solves with that factor. This file
measures the JAX package's gap (one jitted call of its functions) and
holds the port's on the CPU to the same bound.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from acados_tpu import AcadosOcpBatchSolver as JaxBatchSolver
from acados_tpu.interface.builder import data_to_jax
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_ocp
from acados_tpu.ocp_nlp.linearize import NlpIterate as JaxIterate
from acados_tpu.ocp_nlp.sensitivity import (KktFactor, SensOpts,
                                            adjoint_sensitivity,
                                            forward_sensitivity)
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.testing import JAX_SENS_F32_GAP, rti_batch

torch.set_num_threads(1)

B, N = 4, 20
KW = dict(N=N, dtype="float32", nlp_solver_type="SQP",
          integrator_type="IRK")


def _x0s():
    """chip_smoke.py's x0s (seed 0, spread 0.05 around [0, pi, 0, 0]):
    the first B rows of its B = 4096 draw."""
    rng = np.random.default_rng(0)
    return np.array([0.0, np.pi, 0.0, 0.0]) + rng.normal(0.0, 0.05, (B, 4))


def _set_up(solver, x0s):
    for i, view in enumerate(solver.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(N + 1):
            view.set(k, "x", x0s[i])


def _gap(fwd, adj):
    return np.abs(adj - fwd).max(axis=1) / np.abs(fwd).max(axis=1)


def test_jax_float32_consistency_gap():
    """The JAX package's own float32 gap is the constant the card's bound
    is made of (within a factor of 2 below it)."""
    jb = JaxBatchSolver(jax_ocp(**KW), N_batch=B)
    _set_up(jb, _x0s())
    assert np.all(jb.solve() == 0)
    form, off = jb.form, jb._layout(0).off_bx

    def reference(data, it):
        kf = KktFactor(form, SensOpts(), data, it)
        zero = jax.tree.map(jnp.zeros_like, data)
        dirs = []
        for i in range(4):
            e = zero.lb_0.at[off + i].set(1.0)
            dirs.append(zero.replace(lb_0=e, ub_0=e))
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *dirs)
        _, du = jax.vmap(lambda d: forward_sensitivity(kf, d)[:2])(stacked)
        g = adjoint_sensitivity(kf, jnp.zeros_like(it.x),
                                jnp.zeros_like(it.u).at[0].set(1.0))
        return du[:, 0, 0], (g.lb_0 + g.ub_0)[off:off + 4]

    it = JaxIterate(**{k: jnp.asarray(v, jnp.float32)
                       for k, v in jb._iterate.items()})
    fwd, adj = jax.jit(jax.vmap(reference))(
        data_to_jax(jb._data, jnp.float32), it)
    gap = _gap(np.asarray(fwd), np.asarray(adj))
    assert JAX_SENS_F32_GAP / 2 <= gap.max() <= JAX_SENS_F32_GAP, gap


def test_port_float32_consistency_within_the_card_bound():
    """The port's float32 gap on the CPU at the same x0s, against the
    card's bound of 10 x the JAX package's."""
    solver = rti_batch(make_pendulum_ocp(**KW), _x0s(), "cpu")
    assert np.all(solver.solve() == 0)
    _, su = solver.eval_solution_sensitivity([0], "initial_state")
    adj = solver.eval_adjoint_solution_sensitivity(
        None, [(0, np.ones((B, 1)))], with_respect_to="initial_state")
    gap = _gap(su[:, 0, 0], adj)
    assert np.isfinite(gap).all() and gap.max() <= 10 * JAX_SENS_F32_GAP, \
        gap
