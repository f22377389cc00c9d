"""PyTorch port, LIFTED_IRK (sim/lifted_irk.py): the lifted step with its
stage memory K threaded explicitly, the simulator that holds K between
simulate() calls, the batch simulator's refusal, and LIFTED_IRK in the
OCP (integrated as IRK, as in the JAX package), after
tests/test_sim.py::TestLiftedIrk.

Held: each call's x_next and K against the JAX package's lifted step
within a relative 1e-9 (float64, CPU), the calls' fixed point at IRK's
converged x_next, and the OCP bit for bit equal to IRK's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.sim.irk import implicit_from_explicit as jax_implicit
from acados_tpu.sim.lifted_irk import make_lifted_irk_step as jax_lifted
from acados_tpu_torch import AcadosModel, AcadosSimBatchSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.interface.sim_solver import AcadosSim, AcadosSimSolver
from acados_tpu_torch.models.pendulum import make_pendulum_ocp, pendulum_ode
from acados_tpu_torch.ocp_nlp.linearize import build_static_rows, linearize
from acados_tpu_torch.sim.irk import implicit_from_explicit, make_irk_step
from acados_tpu_torch.sim.lifted_irk import make_lifted_irk_step
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_sim import X0, U0, DT, scipy_ref
from test_sim import pendulum_ode as jax_pendulum_ode
from test_torch_globalization import batch_data, rel_gap, zero_iterate

torch.set_num_threads(1)


def batch(*arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float64))[None]
                 for a in arrays)


def test_converges_to_irk_fixed_point_as_jax():
    """tests/test_sim.py::TestLiftedIrk::test_converges_to_irk_fixed_point:
    one Newton iteration a call on the lifted stage values converges to
    IRK's x_next (8 Newton iterations); every call's x_next and K equal
    the JAX package's lifted step's."""
    fi = implicit_from_explicit(pendulum_ode)
    f64 = dict(dtype=torch.float64)
    args = (*batch(X0, U0), torch.zeros((1, 0), **f64),
            torch.zeros(1, **f64), torch.full((1,), DT, **f64))
    x_ref = make_irk_step(fi, nx=4, num_stages=3, newton_iter=8)(*args)[0]
    lstep, K0 = make_lifted_irk_step(fi, nx=4, num_stages=3)
    jstep, jK = jax_lifted(jax_implicit(jax_pendulum_ode), nx=4,
                           num_stages=3)
    K = K0[None]
    errs = []
    for _ in range(10):
        x, K = lstep(*args, K)
        jx, jK = jstep(jnp.asarray(X0), jnp.asarray(U0), None, 0.0, DT, jK)
        assert rel_gap(x[0].numpy(), jx) <= 1e-9
        assert rel_gap(K[0].numpy(), jK) <= 1e-9
        errs.append(float((x - x_ref).abs().max()))
    assert errs[-1] < 1e-10 and errs[0] > errs[-1]


def test_sim_solver_lifted():
    """tests/test_sim.py::TestLiftedIrk::test_sim_solver_lifted: the
    simulator holds K between calls (10 calls converge to the scipy
    reference within 1e-5, S_forw of shape (4, 5)); a new solver starts
    again from K = 0, and the batch simulator refuses LIFTED_IRK."""
    sim = AcadosSim()
    sim.model = AcadosModel(name="pend", x=4, u=1, f_expl_expr=pendulum_ode)
    sim.solver_options.T = DT
    sim.solver_options.integrator_type = "LIFTED_IRK"
    sim.solver_options.num_stages = 3
    solver = AcadosSimSolver(sim, device="cpu")
    first = solver.simulate(x=X0, u=U0)
    for _ in range(9):
        xn = solver.simulate(x=X0, u=U0)
    np.testing.assert_allclose(xn, scipy_ref(), atol=1e-5)
    assert solver.get("S_forw").shape == (4, 5)
    assert np.abs(first - xn).max() > 1e-8
    again = AcadosSimSolver(sim, device="cpu")
    np.testing.assert_array_equal(again.simulate(x=X0, u=U0), first)
    with pytest.raises(NotImplementedError, match="lifted"):
        AcadosSimBatchSolver(sim, 4, device="cpu")


def test_ocp_lifted_irk_is_irk():
    """LIFTED_IRK in the OCP integrates as IRK (acados_tpu/interface/
    builder.py:535-542): its linearization at a seeded iterate equals
    IRK's bit for bit."""
    x0s = np.array([[0.0, np.pi, 0.0, 0.0], [0.1, 2.8, -0.2, 0.3]])
    qps = []
    for itype in ("LIFTED_IRK", "IRK"):
        ocp = make_pendulum_ocp(N=4, dtype="float64", integrator_type=itype)
        form, dnp, _ = build_ocp(ocp)
        init = zero_iterate(form, x0s)
        init["u"] = np.random.default_rng(0).normal(0.0, 5.0, init["u"].shape)
        qps.append(linearize(
            form, build_static_rows(form, torch.float64, "cpu"),
            data_to_torch(batch_data(dnp, x0s, 4), torch.float64, "cpu"),
            iterate_from_numpy(init, torch.float64, "cpu"),
            torch.tensor(0.0, dtype=torch.float64)))
    for f in ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg", "ug"):
        assert torch.equal(getattr(qps[0], f), getattr(qps[1], f)), f
