"""PyTorch port, GNSF (sim/gnsf.py): the numeric structure detection, the
structure-exploiting step, its fallback to IRK, and GNSF through the
simulator and the OCP, against the JAX package (float64, CPU), after
tests/test_sim.py::TestGnsf.

Held: the detected structure equal to the JAX package's (both draw
their probes from np.random.default_rng(0) in the same order), the step
and its sensitivities within a relative 1e-9 of the JAX step and
jax.jacfwd; the simulator and the OCP with GNSF against the JAX
package's GNSF simulator and GNSF OCP within a relative 1e-9, with equal
statuses and iteration counts, and beside IRK on the same collocation
(the same discretization at Newton convergence) within 1e-9.
"""
import numpy as np
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp

from acados_tpu.interface.acados_ocp import AcadosModel as JaxModel
from acados_tpu.interface.sim_solver import AcadosSim as JaxSim
from acados_tpu.interface.sim_solver import AcadosSimSolver as JaxSimSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.sim.gnsf import detect_gnsf_structure as jax_detect
from acados_tpu.sim.integrator import SimOpts as JSimOpts
from acados_tpu.sim.integrator import make_step_fn as jax_make_step_fn
from acados_tpu_torch import AcadosModel
from acados_tpu_torch.interface.sim_solver import AcadosSim, AcadosSimSolver
from acados_tpu_torch.models.pendulum import make_pendulum_ocp, pendulum_ode
from acados_tpu_torch.sim.gnsf import detect_gnsf_structure, make_gnsf_step
from acados_tpu_torch.sim.integrator import SimOpts, make_step_fn, simulate
from test_sim import X0, U0, DT, scipy_ref
from test_sim import pendulum_ode as jax_pendulum_ode
from test_torch_globalization import (assert_same_solve, jax_solve,
                                      port_solve, rel_gap)

torch.set_num_threads(1)

MODEL_FIELDS = ("A", "B", "C", "c", "E", "L_x", "L_xdot", "L_z", "L_u",
                "A_LO", "B_LO", "E_LO", "c_LO", "perm", "iperm")


def _b(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def one(a):
    """A single input as a batch of one."""
    return _b(a)[None]


def test_detects_pendulum_structure_as_jax():
    """tests/test_sim.py::TestGnsf::test_detects_pendulum_structure: a
    nontrivial split, and every field of the structure equal to the JAX
    package's detection."""
    mdl = detect_gnsf_structure(pendulum_ode, nx=4, nu=1)
    ref = jax_detect(jax_pendulum_ode, nx=4, nu=1)
    assert mdl is not None and 0 < mdl.n_out < 4
    assert mdl.nx1 + mdl.nx2 == 4
    for f in ("nx1", "nx2", "nz1", "n_out", "nu"):
        assert getattr(mdl, f) == getattr(ref, f), f
    for f in MODEL_FIELDS:
        np.testing.assert_allclose(getattr(mdl, f), getattr(ref, f),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    y, uh = np.array([0.3, -0.4, 1.2]), np.array([2.0])
    assert rel_gap(mdl.phi(_b(y), _b(uh)).numpy(),
                   ref.phi(jnp.asarray(y), jnp.asarray(uh))) <= 1e-12


def test_step_and_sensitivities_match_scipy_and_jax():
    """tests/test_sim.py::TestGnsf::test_matches_scipy (4 stages, 6 Newton
    iterations; 10 steps, where the reference takes 20), and at 2 steps
    and 3 iterations the step
    and its forward sensitivities through the unrolled Newton iterations
    against the JAX step and jax.jacfwd."""
    opts = dict(integrator_type="GNSF", num_stages=4, num_steps=10,
                newton_iter=6)
    args = (one(X0), one(U0), torch.zeros((1, 0), dtype=torch.float64),
            torch.zeros(1, dtype=torch.float64),
            torch.full((1,), DT, dtype=torch.float64))
    mdl = detect_gnsf_structure(pendulum_ode, nx=4, nu=1)
    xn = vmap(make_gnsf_step(mdl, num_stages=4, num_steps=10,
                             newton_iter=6))(*args)
    np.testing.assert_allclose(xn[0].numpy(), scipy_ref(), atol=1e-8)
    opts.update(num_steps=2, newton_iter=3)
    step = make_step_fn(f_expl=pendulum_ode, nx=4, nu=1, opts=SimOpts(**opts))
    jstep = jax_make_step_fn(f_expl=jax_pendulum_ode, nx=4, nu=1,
                             opts=JSimOpts(**opts))
    out = simulate(step, one(X0), one(U0), dt=DT)
    xu = jnp.concatenate([jnp.asarray(X0), jnp.asarray(U0)])
    phi = lambda xu: jstep(xu[:4], xu[4:], None, 0.0, DT)
    assert rel_gap(out.xn[0].numpy(), phi(xu)) <= 1e-9
    assert rel_gap(out.S_forw[0].numpy(), jax.jacfwd(phi)(xu)) <= 1e-9


def test_linear_model_and_fallback_to_irk():
    """tests/test_sim.py::TestGnsf::test_matches_irk_exactly_linear (a
    fully linear ODE is a pure linear-output system, n_out = 0, and GNSF
    equals IRK) and ::test_non_gnsf_falls_back_none (phi takes every
    state); a time-dependent model has no structure, and make_step_fn
    integrates it with IRK, the reference's fallback."""
    A = torch.tensor([[0.0, 1.0], [-4.0, -0.4]], dtype=torch.float64)
    B = torch.tensor([[0.0], [1.0]], dtype=torch.float64)
    flin = lambda x, u, p, t: A @ x + B @ u
    mdl = detect_gnsf_structure(flin, nx=2, nu=1)
    assert mdl.n_out == 0 and mdl.nx2 == 2 and list(mdl.perm) == [0, 1]
    g = vmap(make_gnsf_step(mdl, num_stages=3))
    i = make_step_fn(f_expl=flin, nx=2, nu=1,
                     opts=SimOpts(integrator_type="IRK", num_stages=3,
                                  newton_iter=6))
    args = (one([1.0, 0.5]), one([0.3]),
            torch.zeros((1, 0), dtype=torch.float64),
            torch.zeros(1, dtype=torch.float64),
            torch.full((1,), 0.1, dtype=torch.float64))
    np.testing.assert_allclose(g(*args).numpy(), i(*args).numpy(),
                               atol=1e-12)
    f = lambda x, u, p, t: torch.stack([torch.sin(x[1]) * x[0],
                                        torch.cos(x[0]) + u[0]])
    mdl = detect_gnsf_structure(f, nx=2, nu=1)
    assert mdl is not None and mdl.nx1 == 2
    ft = lambda x, u, p, t: torch.stack([x[1], -x[0] + torch.sin(t)])
    assert detect_gnsf_structure(ft, nx=2, nu=1) is None
    opts = dict(num_stages=3, num_steps=2)
    g = make_step_fn(f_expl=ft, nx=2, nu=1,
                     opts=SimOpts(integrator_type="GNSF", **opts))
    i = make_step_fn(f_expl=ft, nx=2, nu=1,
                     opts=SimOpts(integrator_type="IRK", **opts))
    np.testing.assert_array_equal(g(*args).numpy(), i(*args).numpy())


def test_sim_solver_gnsf_beside_irk():
    """AcadosSimSolver with GNSF (the detection with the solver's
    parameters; 3 stages, 2 substeps, 4 Newton iterations) against the
    JAX package's AcadosSimSolver with GNSF on the same inputs, and
    beside the port's IRK on the same collocation: xn, S_forw and S_adj
    within 1e-9."""
    seed = np.array([1.0, -0.5, 0.25, 2.0])

    def solver(itype, sim, model, make):
        sim.model = model
        so = sim.solver_options
        so.T, so.integrator_type, so.num_stages, so.num_steps = \
            0.1, itype, 3, 2
        so.newton_iter, so.sens_adj = 4, True
        out = make(sim)
        out.set("seed_adj", seed)
        out.simulate(x=X0, u=U0)
        return out

    port = lambda itype: solver(
        itype, AcadosSim(),
        AcadosModel(name="p", x=4, u=1, f_expl_expr=pendulum_ode),
        lambda sim: AcadosSimSolver(sim, device="cpu"))
    ours, irk = port("GNSF"), port("IRK")
    ref = solver("GNSF", JaxSim(),
                 JaxModel(name="p", x=4, u=1, f_expl_expr=jax_pendulum_ode),
                 JaxSimSolver)
    for f in ("xn", "S_forw", "S_adj"):
        assert rel_gap(ours.get(f), ref.get(f)) <= 1e-9, f"JAX {f}"
        assert rel_gap(ours.get(f), irk.get(f)) <= 1e-9, f"IRK {f}"


def test_gnsf_ocp_beside_irk():
    """The pendulum OCP with integrator_type GNSF (build_ocp's step and
    its jacfwd through the unrolled Newton iterations, as the JAX
    package's linearizer takes it without a fused Jacobian) by SQP, cut
    at 2 iterations, B = 2, N = 6, against jax.vmap of the JAX package's
    SQP on its own GNSF pendulum OCP, and beside the port's IRK on the
    same collocation: equal statuses and iterations, iterates within
    1e-9."""
    x0s = np.array([[0.0, np.pi, 0.0, 0.0], [0.1, 2.8, -0.2, 0.3]])
    cut = dict(max_iter=2)
    data, init, it_ref, st_ref = jax_solve(
        jax_pendulum_ocp(N=6, dtype="float64", integrator_type="GNSF"),
        x0s, opts_update=cut)
    runs = {itype: port_solve(make_pendulum_ocp(N=6, dtype="float64",
                                                integrator_type=itype),
                              data, init, opts_update=cut)
            for itype in ("GNSF", "IRK")}
    assert_same_solve(*runs["GNSF"], it_ref, st_ref, "GNSF against JAX")
    assert_same_solve(*runs["GNSF"], *runs["IRK"], "GNSF beside IRK")
