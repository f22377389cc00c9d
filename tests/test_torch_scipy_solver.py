"""PyTorch port, the scipy cross-check oracle (interface/scipy_solver.py,
AcadosScipyOcpSolver) against the JAX package's oracle and against the
port's AcadosOcpSolver, at atol 1e-4 (the tolerance of
tests/test_admm.py::TestScipyCrossCheck), on the pendulum and on the
DAE cart of tests/test_dae_nlp.py (float64, CPU).

As in the JAX tests, each oracle starts at the SQP solution: an
independent optimizer started at a KKT point must stay there. The DAE
cart's oracle solves the substituted ODE (z = c v^3 in the dynamics, the
cost and the h row), tests/test_dae_nlp.py:make_ode_ocp.
"""
import numpy as np
import torch

from acados_tpu.interface.scipy_solver import \
    AcadosScipyOcpSolver as JaxScipy
from acados_tpu.interface.solver import AcadosOcpSolver as JaxSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu_torch import AcadosOcpSolver, AcadosScipyOcpSolver
from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.testing import DAE_ZBOUND, dae_ocp
from test_dae_nlp import make_ode_ocp as jax_ode_ocp

torch.set_num_threads(1)

ATOL = 1e-4
N_DAE, TF_DAE = 10, 1.0


def _traj(solver, N):
    return (np.array([solver.get(k, "x") for k in range(N + 1)]),
            np.array([solver.get(k, "u") for k in range(N)]))


def test_pendulum_oracle_matches_jax_and_sqp():
    """The pendulum (N = 20): the port's oracle from the port's SQP
    solution stays there (atol 1e-4), agrees with the JAX oracle from
    the JAX SQP solution, and its cost with the port solver's."""
    ocp = make_pendulum_ocp(dtype="float64", nlp_solver_type="SQP")
    s = AcadosOcpSolver(ocp, device="cpu")
    assert s.solve() == 0
    x_sqp, u_sqp = _traj(s, 20)
    oracle = AcadosScipyOcpSolver(ocp, device="cpu")
    assert oracle.solve(x_init=x_sqp, u_init=u_sqp) == 0
    x_orc, u_orc = _traj(oracle, 20)
    np.testing.assert_allclose(x_orc, x_sqp, atol=ATOL)
    np.testing.assert_allclose(u_orc, u_sqp, atol=ATOL)

    jocp = jax_pendulum_ocp(dtype="float64", nlp_solver_type="SQP")
    js = JaxSolver(jocp)
    assert js.solve() == 0
    jx, ju = _traj(js, 20)
    joracle = JaxScipy(jocp)
    assert joracle.solve(x_init=jx, u_init=ju) == 0
    np.testing.assert_allclose(x_orc, _traj(joracle, 20)[0], atol=ATOL)
    assert abs(oracle.get_cost() - joracle.get_cost()) <= ATOL * (
        1 + abs(joracle.get_cost()))
    assert abs(oracle.get_cost() - s.get_cost()) <= ATOL * (
        1 + abs(s.get_cost()))


def ode_ocp():
    """tests/test_dae_nlp.py:make_ode_ocp in torch: the DAE cart with
    z = c v^3 substituted, N = N_DAE over TF_DAE."""
    ocp, m = AcadosOcp(), AcadosModel()
    m.name, m.x, m.u = "ode_fric", 2, 1
    c = 0.7
    m.f_expl_expr = lambda x, u, p, t: torch.cat([x[1:2],
                                                  u - c * x[1:2] ** 3])
    m.cost_y_expr = lambda x, u: torch.cat([x, u, c * x[1:2] ** 3])
    m.con_h_expr = lambda x, u: c * x[1:2] ** 3
    ocp.model = m
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N_DAE, TF_DAE, "float64"
    so.nlp_solver_type, so.nlp_solver_max_iter = "SQP", 60
    so.integrator_type = "IRK"
    so.sim_method_num_stages, so.sim_method_num_steps = 3, 2
    ocp.constraints.x0 = np.array([1.0, 0.0])
    ocp.constraints.idxbu = np.array([0])
    ocp.constraints.lbu, ocp.constraints.ubu = np.array([-2.5]), \
        np.array([2.5])
    ocp.constraints.lh, ocp.constraints.uh = np.array([-DAE_ZBOUND]), \
        np.array([DAE_ZBOUND])
    cst = ocp.cost
    cst.cost_type, cst.cost_type_e = "NONLINEAR_LS", "LINEAR_LS"
    cst.W, cst.yref = np.diag([1.0, 0.5, 0.05, 0.3]), np.zeros(4)
    cst.Vx_e, cst.W_e, cst.yref_e = np.eye(2), 5.0 * np.eye(2), np.zeros(2)
    return ocp


def test_dae_cart_oracle_matches_jax_and_sqp():
    """The DAE cart (N = 10 over 1 s): the port's SQP on the DAE, the
    port's oracle on the substituted ODE from that solution, and the JAX
    oracle on its own substituted ODE from the same start agree at atol
    1e-4; the z bound is active."""
    s = AcadosOcpSolver(dae_ocp(N=N_DAE, tf=TF_DAE), device="cpu")
    assert s.solve() == 0
    x_d, u_d = _traj(s, N_DAE)
    z = np.array([s.get(k, "z")[0] for k in range(N_DAE)])
    assert np.max(np.abs(z)) > 0.9 * DAE_ZBOUND
    oracle = AcadosScipyOcpSolver(ode_ocp(), device="cpu")
    assert oracle.solve(x_init=x_d, u_init=u_d) == 0
    x_orc, _ = _traj(oracle, N_DAE)
    np.testing.assert_allclose(x_orc, x_d, atol=ATOL)

    jocp = jax_ode_ocp()
    jocp.solver_options.N_horizon, jocp.solver_options.tf = N_DAE, TF_DAE
    joracle = JaxScipy(jocp)
    assert joracle.solve(x_init=x_d, u_init=u_d) == 0
    np.testing.assert_allclose(x_orc, _traj(joracle, N_DAE)[0], atol=ATOL)
