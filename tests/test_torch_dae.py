"""PyTorch port, DAEs (nz > 0) in the integrator and in the NLP: the
algebraic stage unknowns of sim/irk.py (make_irk_step's z at the interval
end, make_irk_step_jac's z0 and dz0/d(x, u), make_irk_stage_points' Zs,
make_irk_z0_fun), simulate's zn and the simulator's get("z"), and the
DAE-constrained OCP whose cost and h rows read z (builder, formulation,
linearize's affine z model, AcadosOcpSolver.get(stage, "z")), against the
JAX package (float64, CPU), after tests/test_dae_nlp.py and
tests/test_sim.py::TestDae.

Held: equal statuses and iteration counts, iterates and z within a
relative 1e-9; the DAE against the equivalent substituted ODE within
1e-5 (tests/test_dae_nlp.py's own bound); one float32 batch in the
reference's plateau class (every status 0 in both packages, both in
the main path's float32 tolerances, res_stat plateaus within 5 %); and
the K1 calls of a DAE solve against chip_smoke.py's dae_k1_expected.
"""
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

import jax
import jax.numpy as jnp

import chip_smoke
from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.interface.builder import data_to_jax
from acados_tpu.interface.solver import AcadosOcpSolver as JaxOcpSolver
from acados_tpu.ocp_nlp.linearize import NlpIterate as JNlpIterate
from acados_tpu.ocp_nlp.linearize import build_static_rows as jax_rows
from acados_tpu.ocp_nlp.linearize import linearize as jax_linearize
from acados_tpu.sim import irk as jirk
from acados_tpu_torch import AcadosModel, AcadosOcpSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.interface.sim_solver import AcadosSim, AcadosSimSolver
from acados_tpu_torch.interface.solver import _sqp_opts_from
from acados_tpu_torch.models.pendulum import pendulum_ode
from acados_tpu_torch.ocp_nlp.linearize import build_static_rows, linearize
from acados_tpu_torch.ocp_nlp.sqp import make_sqp_solver
from acados_tpu_torch.sim import irk
from acados_tpu_torch.sim.integrator import simulate
from acados_tpu_torch.testing import (DAE_ZBOUND, dae_ocp, rti_batch)
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_dae_nlp import C_FRIC, make_dae_ocp
from test_sim import pendulum_ode as jax_pendulum_ode
from test_torch_globalization import (batch_data, jax_solve, rel_gap,
                                      zero_iterate)

torch.set_num_threads(1)

N = 20
F32_TOLS = dict(nlp_solver_tol_stat=2e-3, nlp_solver_tol_eq=1e-4,
                nlp_solver_tol_ineq=1e-4, nlp_solver_tol_comp=1e-3)


def ode_ocp():
    """tests/test_dae_nlp.py:make_ode_ocp in the port: z = c v^3
    substituted into the dynamics, the cost and h."""
    ocp = dae_ocp()
    m = AcadosModel()
    m.name, m.x, m.u = "ode_fric", 2, 1
    m.f_expl_expr = lambda x, u, p, t: torch.cat(
        [x[1:2], u - C_FRIC * x[1:2] ** 3])
    m.cost_y_expr = lambda x, u: torch.cat([x, u, C_FRIC * x[1:2] ** 3])
    m.con_h_expr = lambda x, u: C_FRIC * x[1:2] ** 3
    ocp.model = m
    return ocp


def stages(s, field, n):
    return np.array([s.get(k, field) for k in range(n)])


def assert_single_solves_agree(ours, ref, label):
    assert ours.get_stats("sqp_iter") == ref.get_stats("sqp_iter"), label
    assert ours.get_stats("qp_iter") == ref.get_stats("qp_iter"), label
    for f, n in (("x", N + 1), ("u", N), ("pi", N), ("z", N)):
        gap = rel_gap(stages(ours, f, n), stages(ref, f, n))
        assert gap <= 1e-9, f"{label}: {f} {gap:.3e}"


@pytest.fixture(scope="module")
def dae_solved():
    """The port's DAE cart, solved (tests/test_dae_nlp.py's config)."""
    s = AcadosOcpSolver(dae_ocp(), device="cpu")
    assert s.solve() == 0
    return s


def test_dae_matches_jax_and_substituted_ode(dae_solved):
    """tests/test_dae_nlp.py::test_dae_matches_substituted_ode through the
    port, held to the JAX package's DAE solve: equal statuses and
    iterations, x, u, pi and get(k, "z") within 1e-9."""
    ours = dae_solved
    ref = JaxOcpSolver(make_dae_ocp())
    assert ref.solve() == 0
    assert_single_solves_agree(ours, ref, "DAE")
    ode = AcadosOcpSolver(ode_ocp(), device="cpu")
    assert ode.solve() == 0
    np.testing.assert_allclose(stages(ours, "x", N + 1),
                               stages(ode, "x", N + 1), atol=1e-5)
    np.testing.assert_allclose(stages(ours, "u", N), stages(ode, "u", N),
                               atol=1e-5)
    z = stages(ours, "z", N)[:, 0]
    assert np.max(np.abs(z)) > 0.9 * DAE_ZBOUND
    np.testing.assert_allclose(z, C_FRIC * stages(ours, "x", N)[:, 1] ** 3,
                               atol=1e-4)
    assert ours.get(N, "z").shape == (0,)


def test_dae_sensitivities_refused(dae_solved):
    """The solution sensitivities and the parameter gradient of the
    optimal value refuse a DAE: their Lagrangian Hessian reads no z, as
    the JAX package's does not (ocp_nlp/sensitivity.py:_refuse_z)."""
    with pytest.raises(NotImplementedError, match="DAE"):
        dae_solved.eval_solution_sensitivity(0, "initial_state")
    with pytest.raises(NotImplementedError, match="DAE"):
        dae_solved.eval_adjoint_solution_sensitivity(
            None, [(0, np.ones(1))], with_respect_to="initial_state")
    with pytest.raises(NotImplementedError, match="DAE"):
        dae_solved.eval_and_get_optimal_value_gradient("p_global")


def test_soft_z_constraint():
    """tests/test_dae_nlp.py::test_soft_z_constraint: the z rows, softened
    and tightened to half the bound, route through the slack machinery:
    status 0, nonnegative slacks, and every node's z within the tightened
    bound plus its slack."""
    ocp = dae_ocp()
    ocp.constraints.uh = np.array([0.5 * DAE_ZBOUND])
    ocp.constraints.lh = np.array([-0.5 * DAE_ZBOUND])
    ocp.constraints.idxsh = np.array([0])
    ocp.cost.Zl = ocp.cost.Zu = np.array([1e2])
    ocp.cost.zl = ocp.cost.zu = np.array([1e1])
    s = AcadosOcpSolver(ocp, device="cpu")
    assert s.solve() == 0
    z = stages(s, "z", N)[:, 0]
    sl, su = stages(s, "sl", N)[:, 0], stages(s, "su", N)[:, 0]
    assert sl.min() >= -1e-12 and su.min() >= -1e-12
    assert np.all(z <= 0.5 * DAE_ZBOUND + su + 1e-6)
    assert np.all(z >= -0.5 * DAE_ZBOUND - sl - 1e-6)


def test_dae_vs_scipy_oracle(dae_solved):
    """tests/test_dae_nlp.py::test_dae_vs_scipy_oracle: the JAX package's
    general-purpose scipy solver on the substituted ODE, started from the
    port's DAE solution, confirms its KKT point."""
    from acados_tpu.interface.scipy_solver import AcadosScipyOcpSolver
    from test_dae_nlp import make_ode_ocp
    s = dae_solved
    x_d, u_d = stages(s, "x", N + 1), stages(s, "u", N)
    oracle = AcadosScipyOcpSolver(make_ode_ocp())
    assert oracle.solve(x_init=x_d, u_init=u_d) == 0
    np.testing.assert_allclose(
        x_d, np.array([oracle.get(k, "x") for k in range(N + 1)]),
        atol=1e-4)


def test_linearize_with_z_and_vz_matches_jax():
    """The use_z branch of linearize (the affine z model: the reference's
    dzduxt chain rule in the cost's Gauss-Newton blocks and the h rows)
    at a seeded iterate, with LINEAR_LS on a Vz block and the exact
    Hessian's h curvature (the NONLINEAR_LS z cost is the solves')."""
    rng = np.random.default_rng(0)
    ocps = [dae_ocp(N=4, tf=0.4), make_dae_ocp()]
    for o in ocps:
        o.solver_options.N_horizon, o.solver_options.tf = 4, 0.4
        o.cost.cost_type = "LINEAR_LS"
        o.cost.Vx = np.vstack([np.eye(2), np.zeros((2, 2))])
        o.cost.Vu = np.array([[0.0], [0.0], [1.0], [0.0]])
        o.cost.Vz = np.array([[0.0], [0.0], [0.0], [1.0]])
        o.solver_options.hessian_approx = "EXACT"
        o.solver_options.exact_hess_dyn = False
    form, dnp, _ = build_ocp(ocps[0])
    jform, _, _ = jax_build_ocp(ocps[1])
    assert form.nz == 1 and form.cost.with_z and form.con.with_z
    it = {"x": rng.normal(0, 0.3, (5, 2)), "u": rng.normal(0, 1, (4, 1)),
          "pi": rng.normal(size=(4, 2)),
          "lam_l": np.abs(rng.normal(size=(5, form.nc))),
          "lam_u": np.abs(rng.normal(size=(5, form.nc))),
          "sl": np.zeros((5, form.nc)), "su": np.zeros((5, form.nc))}
    qp = linearize(form, build_static_rows(form, torch.float64, "cpu"),
                   data_to_torch(dnp, torch.float64, "cpu", batch=1),
                   iterate_from_numpy({k: v[None] for k, v in
                                       it.items()}, torch.float64, "cpu"),
                   torch.tensor(0.0, dtype=torch.float64))
    jqp = jax.jit(lambda d, i: jax_linearize(
        jform, jax_rows(jform, jnp.float64), d, i, 0.0))(
        data_to_jax(dnp, jnp.float64),
        JNlpIterate(**{k: jnp.asarray(v) for k, v in it.items()}))
    for f in ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg",
              "ug"):
        gap = rel_gap(getattr(qp, f)[0].numpy(), getattr(jqp, f))
        assert gap <= 1e-9, f"linearize: {f} {gap:.3e}"


def f_impl_pend(xdot, x, z, u, p, t):
    """tests/test_sim.py::TestDae's index-1 DAE: the pendulum and
    z = v^2 + dtheta^2."""
    return torch.cat([xdot - pendulum_ode(x, u, p, t),
                      z - (x[2:3] ** 2 + x[3:4] ** 2)])


def jax_f_impl_pend(xdot, x, z, u, p, t):
    return jnp.concatenate([xdot - jax_pendulum_ode(x, u, p, t),
                            z - jnp.array([x[2] ** 2 + x[3] ** 2])])


X0S = np.array([[0.1, 0.5, -0.2, 0.3], [-0.3, 2.0, 0.4, -1.1]])
U0S = np.array([[2.0], [-4.0]])


def _b(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_irk_dae_step_matches_jax_and_scipy():
    """tests/test_sim.py::TestDae: make_irk_step on the index-1 DAE
    (Radau IIA, 3 stages, 20 steps) against scipy's integration and the
    JAX step; x_next and z at the interval end."""
    kw = dict(nx=4, nz=1, num_stages=3, num_steps=20, newton_iter=6,
              collocation="RADAU_IIA")
    xn, zn = irk.make_irk_step(f_impl_pend, **kw)(
        _b(X0S), _b(U0S), torch.zeros((2, 0), dtype=torch.float64),
        torch.zeros(2, dtype=torch.float64),
        torch.full((2,), 0.25, dtype=torch.float64))
    jstep = jirk.make_irk_step(jax_f_impl_pend, **kw)
    for i in range(2):
        jx, jz = jstep(jnp.asarray(X0S[i]), jnp.asarray(U0S[i]), None, 0.0,
                       0.25)
        assert rel_gap(xn[i].numpy(), jx) <= 1e-9
        assert rel_gap(zn[i].numpy(), jz) <= 1e-9
    f = lambda t, x: pendulum_ode(_b(x), _b(U0S[0])).numpy()
    x_ref = solve_ivp(f, (0, 0.25), X0S[0], rtol=1e-12, atol=1e-12).y[:, -1]
    np.testing.assert_allclose(xn[0].numpy(), x_ref, atol=1e-7)
    np.testing.assert_allclose(zn[0, 0].item(),
                               x_ref[2] ** 2 + x_ref[3] ** 2, atol=1e-6)


def test_irk_dae_jacobians_points_z0_match_jax():
    """make_irk_step_jac's (x_next, A, B, z0, Jz) on the index-1 DAE
    (Gauss-Legendre 3 stages, 2 substeps) against the JAX function, and
    what must equal its first substep: make_irk_z0_fun's z(t0) at dt / 2
    and make_irk_stage_points' first Xs, Zs (the same Newton iterations
    from zero), the points' weights the JAX package's."""
    kw = dict(nx=4, nz=1, num_stages=3, num_steps=2, newton_iter=4)
    args = (_b(X0S), _b(U0S), torch.zeros((2, 0), dtype=torch.float64),
            torch.zeros(2, dtype=torch.float64),
            torch.full((2,), 0.1, dtype=torch.float64))
    ours = irk.make_irk_step_jac(f_impl_pend, **kw)(*args)
    assert len(ours) == 5
    irk_jax = jirk.make_irk_step_jac(jax_f_impl_pend, **kw)
    for i in range(2):
        ref = irk_jax(jnp.asarray(X0S[i]), jnp.asarray(U0S[i]), jnp.zeros(0),
                      0.0, 0.1)
        for o, r in zip(ours, ref):
            assert rel_gap(o[i].numpy(), r) <= 1e-9
    z0 = irk.make_irk_z0_fun(f_impl_pend, nx=4, nz=1, num_stages=3,
                             newton_iter=4)(*args[:4], args[4] / 2)
    assert rel_gap(z0.numpy(), ours[3].numpy()) <= 1e-12
    pts, w = irk.make_irk_stage_points(f_impl_pend, **kw)
    np.testing.assert_array_equal(
        w, jirk.make_irk_stage_points(jax_f_impl_pend, **kw)[1])
    Xs, Zs, Ts = pts(*(a[0] for a in args))
    assert Xs.shape == (6, 4) and Zs.shape == (6, 1) and Ts.shape == (6,)
    # the algebraic stage values extrapolated to tau = 0 are z0
    zw0 = torch.as_tensor(irk._z_weights(irk._tableau("GAUSS", 3)[2], 0.0))
    assert rel_gap((zw0 @ Zs[:3]).numpy(), ours[3][0].numpy()) <= 1e-12


def test_simulate_zn_and_sim_solver_get_z():
    """simulate's zn (acados_tpu/sim/integrator.py:196-200): the step's z
    at the interval end, and the simulator's get("z"/"zn") equal to it."""
    kw = dict(nx=4, nz=1, num_stages=3, num_steps=2, newton_iter=4)
    step = irk.make_irk_step(f_impl_pend, **kw)
    out = simulate(step, _b(X0S), _b(U0S), dt=0.1, nz=1)
    xn, zn = step(_b(X0S), _b(U0S), torch.zeros((2, 0), dtype=torch.float64),
                  torch.zeros(2, dtype=torch.float64),
                  torch.full((2,), 0.1, dtype=torch.float64))
    np.testing.assert_array_equal(out.zn.numpy(), zn.numpy())
    np.testing.assert_array_equal(out.xn.numpy(), xn.numpy())
    assert out.S_forw.shape == (2, 4, 5)
    sim = AcadosSim()
    sim.model = AcadosModel(name="dae", x=4, u=1, z=1, f_impl_expr=f_impl_pend)
    so = sim.solver_options
    so.T, so.integrator_type, so.num_stages, so.num_steps = 0.1, "IRK", 3, 2
    so.newton_iter = 4
    s = AcadosSimSolver(sim, device="cpu")
    s.simulate(x=X0S[0], u=U0S[0])
    np.testing.assert_array_equal(s.get("z"), zn[0].numpy())
    np.testing.assert_array_equal(s.get("zn"), zn[0].numpy())


def test_dae_float32_plateau_matches_jax():
    """Float32, B = 8, the DAE cart from x0 = (1, 0) + N(0, 0.05) at the
    main path's float32 tolerances through both packages: every status 0
    in both, both in tolerance, and the port's res_stat plateau within
    5 % of the reference's (the float32 class of tests/
    test_torch_pendulum.py::test_irk_rti_float32_plateau_matches_jax:
    float32 rounding moves single iterations, not the plateau)."""
    x0s = np.array([1.0, 0.0]) + np.random.default_rng(0).normal(
        0.0, 0.05, (8, 2))
    ocps = [dae_ocp(dtype="float32"), make_dae_ocp()]
    for o in ocps:
        o.solver_options.dtype = "float32"
        for k, v in F32_TOLS.items():
            setattr(o.solver_options, k, v)
    jform, dnp, _ = jax_build_ocp(ocps[1])
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    _, _, _, st = jax_solve(ocps[1], x0s, data=f32(batch_data(dnp, x0s, 2)),
                            init=f32(zero_iterate(jform, x0s)))
    solver = rti_batch(ocps[0], x0s, "cpu")
    assert np.all(solver.solve() == 0) and np.all(st["status"] == 0)
    res = solver.get_stats("residuals")
    tols = np.array(list(F32_TOLS.values()))
    assert np.all(res <= tols)
    plateau, ref = res[:, 0].max(), st["res_stat"].max()
    assert ref <= tols[0]
    assert abs(plateau - ref) <= 0.05 * ref, (plateau, ref)


def test_dae_k1_calls(monkeypatch):
    """The DAE SQP's K1 calls (a counting linsolve / gj_inverse_any in
    sim/irk.py) against chip_smoke.py's dae_k1_expected: each lockstep
    round and the final pass a linearization (2 substeps x 4 stage
    inverses) and the cost's exact z(t0) (3 Newton solves), at two batch
    sizes and horizons; every K1 call on (B N, 9, 9)."""
    shapes = []
    for name in ("linsolve", "gj_inverse_any"):
        orig = getattr(irk, name)
        monkeypatch.setattr(irk, name, lambda *a, _o=orig: (
            shapes.append(tuple(a[0].shape)), _o(*a))[1])
    for B, n, iters in ((2, 4, 60), (3, 6, 2)):
        ocp = dae_ocp(N=n, tf=0.1 * n)
        ocp.solver_options.nlp_solver_max_iter = iters
        form, dnp, _ = build_ocp(ocp)
        opts = _sqp_opts_from(ocp)
        x0s = np.array([1.0, 0.0]) + np.random.default_rng(B).normal(
            0.0, 0.05, (B, 2))
        shapes.clear()
        _, st = make_sqp_solver(form, opts)(
            data_to_torch(batch_data(dnp, x0s, 2), torch.float64, "cpu"),
            iterate_from_numpy(zero_iterate(form, x0s), torch.float64,
                               "cpu"))
        assert len(shapes) == chip_smoke.dae_k1_expected(st, opts)
        assert set(shapes) == {(B * n, chip_smoke.DAE_STAGE_N,
                                chip_smoke.DAE_STAGE_N)}
