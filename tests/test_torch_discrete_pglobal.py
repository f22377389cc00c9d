"""PyTorch port, DISCRETE dynamics and global parameters (p_global):
disc_dyn_expr with interface/builder.py's jacfwd step Jacobian, and
[p_stage | p_global | global_data] stage parameters with
p_global_precompute_fun and set_p_global_and_precompute_dependencies,
after tests/test_formulations.py::TestDiscreteDynamics and
tests/test_interface.py::TestPGlobal, and the "p_global" gradient of
tests/test_sensitivity.py.

Each model is written twice, in torch for the port
(acados_tpu_torch.testing) and in jnp here for the JAX package, and both
packages solve it on the same inputs (float64, CPU): equal statuses,
sqp_iter and qp_iter, x, u and pi within a relative 1e-9; the parameter
vectors set_p_global_and_precompute_dependencies leaves, and the
optimal-value gradient, within 1e-9 of the JAX package's. The
reference tests' own checks stand beside them: DISCRETE's RK4 equal to
ERK, the p_global solves equal to a baked parameter, the gradient
against central differences.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.interface.acados_ocp import AcadosModel as JaxModel
from acados_tpu.interface.acados_ocp import AcadosOcp as JaxOcp
from acados_tpu.interface.batch_solver import (
    AcadosOcpBatchSolver as JaxBatchSolver)
from acados_tpu.interface.solver import AcadosOcpSolver as JaxOcpSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.models.pendulum import pendulum_ode as jax_pendulum_ode
from acados_tpu_torch import AcadosOcpSolver
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.testing import pendulum_rk4, pglobal_ocp, rti_batch
from test_torch_globalization import rel_gap

torch.set_num_threads(1)

N = 20
X0 = np.array([0.0, np.pi, 0.0, 0.0])


def stages(s, field, n):
    return np.array([s.get(k, field) for k in range(n)])


def jax_rk4(dt: float):
    """acados_tpu_torch.testing.pendulum_rk4 in jnp."""
    def rk4(x, u):
        f = lambda x_: jax_pendulum_ode(x_, u, None, 0.0)
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    return rk4


def jax_pglobal_ocp(N=10):
    """acados_tpu_torch.testing.pglobal_ocp in jnp (the "pglob" model of
    tests/test_interface.py::TestPGlobal)."""
    ocp, m = JaxOcp(), JaxModel()
    m.name, m.x, m.u, m.p = "pglob", 2, 1, 1
    m.p_global = 2
    m.p_global_precompute_fun = lambda pg: jnp.array([pg[0] * pg[1] ** 2])
    m.f_expl_expr = lambda x, u, p, t: jnp.concatenate(
        [x[1:2], (u - p[0] * x[1:2]) / p[3]])
    ocp.model = m
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N, 1.0, "float64"
    so.nlp_solver_type = "SQP"
    ocp.parameter_values = np.array([0.1])
    ocp.p_global_values = np.array([1.0, 1.0])
    ocp.constraints.x0 = np.array([1.0, 0.0])
    c = ocp.cost
    c.cost_type = c.cost_type_e = "LINEAR_LS"
    c.Vx = np.vstack([np.eye(2), np.zeros((1, 2))])
    c.Vu = np.vstack([np.zeros((2, 1)), np.eye(1)])
    c.W, c.yref = np.diag([1.0, 1.0, 0.1]), np.zeros(3)
    c.Vx_e, c.W_e, c.yref_e = np.eye(2), np.eye(2), np.zeros(2)
    return ocp


def assert_same_solve(ours, ref, n, label):
    """Single solvers: equal sqp_iter and qp_iter, x, u and pi within a
    relative 1e-9."""
    for f in ("sqp_iter", "qp_iter"):
        assert ours.get_stats(f) == ref.get_stats(f), f"{label}: {f}"
    for f, m in (("x", n + 1), ("u", n), ("pi", n)):
        gap = rel_gap(stages(ours, f, m), stages(ref, f, m))
        assert gap <= 1e-9, f"{label}: {f} {gap:.3e}"


def test_discrete_rk4_matches_erk():
    """tests/test_formulations.py::TestDiscreteDynamics: a hand-rolled
    RK4 disc_dyn_expr against the JAX package's solve of its jnp twin
    (equal status and iterations, iterates within 1e-9), and equal to
    the port's ERK with 4 stages and 1 step (x within 1e-10, u within
    1e-8, the reference test's bounds)."""
    def solve(ocp, make, **kw):
        ocp.solver_options.sim_method_num_stages = 4
        ocp.solver_options.sim_method_num_steps = 1
        s = make(ocp, **kw)
        for k in range(N + 1):
            s.set(k, "x", X0)
        assert s.solve() == 0
        return s

    erk = solve(make_pendulum_ocp(dtype="float64"), AcadosOcpSolver,
                device="cpu")
    ocp = make_pendulum_ocp(dtype="float64", integrator_type="DISCRETE")
    ocp.model.disc_dyn_expr = pendulum_rk4(1.0 / N)
    disc = solve(ocp, AcadosOcpSolver, device="cpu")
    jocp = jax_pendulum_ocp(dtype="float64")
    jocp.model.disc_dyn_expr = jax_rk4(1.0 / N)
    jocp.solver_options.integrator_type = "DISCRETE"
    assert_same_solve(disc, solve(jocp, JaxOcpSolver), N, "DISCRETE")
    np.testing.assert_allclose(stages(disc, "x", N + 1),
                               stages(erk, "x", N + 1), atol=1e-10)
    np.testing.assert_allclose(stages(disc, "u", N), stages(erk, "u", N),
                               atol=1e-8)
    assert disc.get_stats("sqp_iter") == erk.get_stats("sqp_iter")


def test_p_global_precompute():
    """tests/test_interface.py::TestPGlobal::test_p_global_precompute
    through both packages: the first solve, the parameter vectors that
    set_p_global_and_precompute_dependencies leaves (the precomputed
    inertia as the tail) and the solve after it equal the JAX package's;
    the solution moves, baking the tail into p gives the same, a stage
    part set alone keeps the tail; the errors of a model without
    p_global and of a wrong length."""
    s = AcadosOcpSolver(pglobal_ocp(), device="cpu")
    js = JaxOcpSolver(jax_pglobal_ocp())
    assert s.solve() == 0 and js.solve() == 0
    assert_same_solve(s, js, 10, "p_global, first solve")
    u1 = stages(s, "u", 10)
    for solver in (s, js):
        solver.set_p_global_and_precompute_dependencies(np.array([2.0, 1.5]))
    assert rel_gap(s._data["p"], np.asarray(js._data["p"])) <= 1e-12
    for solver in (s, js):
        solver.reset()
        assert solver.solve() == 0
    assert_same_solve(s, js, 10, "p_global, after the precompute")
    u_heavy = stages(s, "u", 10)
    assert np.max(np.abs(u_heavy - u1)) > 1e-3
    s2 = AcadosOcpSolver(pglobal_ocp(), device="cpu")
    for k in range(11):
        s2.set(k, "p", np.array([0.1, 2.0, 1.5, 4.5]))
    assert s2.solve() == 0
    np.testing.assert_allclose(u_heavy, stages(s2, "u", 10), atol=1e-8)
    s.set(3, "p", np.array([0.7]))
    assert np.allclose(s._data["p"][3], [0.7, 2.0, 1.5, 4.5])
    with pytest.raises(ValueError, match="expected 2"):
        s.set_p_global_and_precompute_dependencies(np.ones(3))
    ocp = pglobal_ocp()
    ocp.model.p_global = ocp.model.p_global_precompute_fun = None
    ocp.model.p = 4
    ocp.parameter_values = np.array([0.1, 1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="p_global"):
        AcadosOcpSolver(ocp, device="cpu") \
            .set_p_global_and_precompute_dependencies(np.ones(2))


def test_p_global_optimal_value_gradient_vs_fd():
    """The optimal value's gradient with respect to 'p_global' (the
    parameter summed over the stages: here [p_stage | p_global |
    global_data]) by the envelope theorem: within 1e-9 of the JAX
    package's on the same solve, and against central differences of the
    re-solved cost as tests/test_sensitivity.py:281 holds it."""
    s = AcadosOcpSolver(pglobal_ocp(), device="cpu")
    js = JaxOcpSolver(jax_pglobal_ocp())
    p0 = np.array([0.1, 1.3, 1.2, 1.3 * 1.2 ** 2])

    def vcost(p, solver=s):
        solver.reset()
        for k in range(11):
            solver.set(k, "p", p)
        assert solver.solve() == 0
        return solver.get_cost()

    vcost(p0)
    vcost(p0, js)
    assert_same_solve(s, js, 10, "p_global gradient's solve")
    g = s.eval_and_get_optimal_value_gradient("p_global")
    assert g.shape == (4,)
    g_ref = np.asarray(js.eval_and_get_optimal_value_gradient("p_global"))
    assert rel_gap(g, g_ref) <= 1e-9, (g, g_ref)
    for i in range(4):
        e = np.zeros(4)
        e[i] = 1e-5
        fd = (vcost(p0 + e) - vcost(p0 - e)) / 2e-5
        assert abs(g[i] - fd) < 2e-3 * max(1.0, abs(fd)), (i, g[i], fd)


def test_p_global_batch_per_instance():
    """The batch solver has no set_p_global: per instance, set("p") sets
    the full [p_stage | p_global | global_data] vector (acados_tpu/
    interface/batch_solver.py:40). The port's batch against the JAX
    package's batch on the same vectors (equal statuses, sqp_iter and
    qp_iter per instance, x, u and pi within 1e-9), and each instance
    against its own single solve."""
    pgs = np.array([[1.0, 1.0], [2.0, 1.5], [1.2, 0.8]])
    x0s = np.tile([1.0, 0.0], (3, 1))
    batch = rti_batch(pglobal_ocp(), x0s, "cpu")
    jbatch = JaxBatchSolver(jax_pglobal_ocp(), len(pgs))
    for views in (batch.ocp_solvers, jbatch.ocp_solvers):
        for view, x0, pg in zip(views, x0s, pgs):
            view.set(0, "lbx", x0)
            view.set(0, "ubx", x0)
            for k in range(11):
                view.set(k, "x", x0)
                view.set(k, "p", [0.1, *pg, pg[0] * pg[1] ** 2])
    status = batch.solve()
    assert np.all(status == 0)
    np.testing.assert_array_equal(status, jbatch.solve())
    for f in ("sqp_iter", "qp_iter"):
        np.testing.assert_array_equal(batch.get_stats(f),
                                      jbatch.get_stats(f), err_msg=f)
    for f, n in (("x", 11), ("u", 10), ("pi", 10)):
        gap = rel_gap([[v.get(k, f) for k in range(n)]
                       for v in batch.ocp_solvers],
                      [[v.get(k, f) for k in range(n)]
                       for v in jbatch.ocp_solvers])
        assert gap <= 1e-9, f"batch {f} {gap:.3e}"
    for i, pg in enumerate(pgs):
        one = AcadosOcpSolver(pglobal_ocp(), device="cpu")
        one.set_p_global_and_precompute_dependencies(pg)
        assert one.solve() == 0
        np.testing.assert_allclose(
            [batch.ocp_solvers[i].get(k, "u") for k in range(10)],
            stages(one, "u", 10), rtol=1e-9, atol=1e-12)
