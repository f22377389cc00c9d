"""PyTorch port, cost_discretization="INTEGRATOR" (interface/builder.py,
ocp_nlp/formulation.py, sim/irk.py:make_irk_stage_points), against the
JAX package (float64, CPU), after tests/test_cost_integration.py: the
exact-value oracles (ERK EXTERNAL, IRK CONL, IRK NONLINEAR_LS: the
integrated cost of a fixed trajectory equals its analytic integral to
1e-10), the linearization's cost blocks at a seeded iterate for IRK and
ERK NONLINEAR_LS, IRK CONL, the EXACT Hessian and EXTERNAL, the IRK
stage points and their forward-mode Jacobian, the IRK INTEGRATOR RTI
batch at B = 3 through AcadosOcpBatchSolver with its K1 calls, and the
sensitivities' refusal.
"""
import numpy as np
import pytest
import scipy.integrate as si
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.acados_ocp import AcadosModel as JModel
from acados_tpu.interface.acados_ocp import AcadosOcp as JOcp
from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.interface.builder import data_to_jax
from acados_tpu.interface.solver import _sqp_opts_from as jax_opts_from
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_nlp.formulation import NlpData as JNlpData
from acados_tpu.ocp_nlp.linearize import NlpIterate as JNlpIterate
from acados_tpu.ocp_nlp.linearize import build_static_rows as jax_rows
from acados_tpu.ocp_nlp.linearize import eval_cost as jax_eval_cost
from acados_tpu.ocp_nlp.linearize import linearize as jax_linearize
from acados_tpu.ocp_nlp.sqp import make_sqp_solver as jax_make_sqp_solver
from acados_tpu.sim.irk import make_irk_stage_points as jax_stage_points
from acados_tpu_torch import AcadosModel, AcadosOcp, AcadosOcpSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.linearize import (build_static_rows, eval_cost,
                                                linearize)
from acados_tpu_torch.sim.irk import implicit_from_explicit
from acados_tpu_torch.sim.irk import make_irk_stage_points
from acados_tpu_torch.testing import rti_batch
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_torch_globalization import (FIELDS, assert_same_solve,
                                      batch_data, zero_iterate)

torch.set_num_threads(1)

N = 4
DT = 0.25


def dint_ocp(pkg, integrator="ERK", cost_type="EXTERNAL", num_stages=4,
             hessian="GAUSS_NEWTON"):
    """tests/test_cost_integration.py's double integrator at N = 4, tf = 1
    with an INTEGRATOR cost: EXTERNAL x1^3 + x0 + u^2/2, NONLINEAR_LS on
    (x, u) with W = diag(1, 2, 0.1), or CONL psi(y) = y1^2/2 + y2^2/4 on
    y = (x1, u); the IRK with 8 Newton iterations and no terminal
    weight."""
    cat = jnp.concatenate if pkg == "jax" else torch.cat
    ocp, m = (JOcp(), JModel()) if pkg == "jax" else (AcadosOcp(),
                                                      AcadosModel())
    m.name, m.x, m.u = "dint", 2, 1
    m.f_expl_expr = lambda x, u: cat([x[1:2], u])
    ocp.model = m
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N, 1.0, "float64"
    so.integrator_type = integrator
    so.sim_method_num_stages, so.sim_method_num_steps = num_stages, 1
    so.sim_method_newton_iter = 8
    so.cost_discretization = "INTEGRATOR"
    so.nlp_solver_type, so.hessian_approx = "SQP", hessian
    ocp.constraints.x0 = np.array([1.0, 0.5])
    if cost_type == "EXTERNAL":
        ocp.cost.cost_type = ocp.cost.cost_type_e = "EXTERNAL"
        m.cost_expr_ext_cost = lambda x, u: x[1] ** 3 + x[0] + 0.5 * u[0] ** 2
        m.cost_expr_ext_cost_e = lambda x: 0.0 * x[0]
        return ocp
    ocp.cost.cost_type = cost_type
    if cost_type == "CONL":
        m.cost_y_expr = lambda x, u: cat([x[1:2], u])
        m.cost_psi_expr = lambda r, p: 0.5 * r[0] ** 2 + 0.25 * r[1] ** 2
        ocp.cost.yref = np.zeros(2)
    else:
        m.cost_y_expr = lambda x, u: cat([x, u])
        ocp.cost.W, ocp.cost.yref = np.diag([1.0, 2.0, 0.1]), np.zeros(3)
    ocp.cost.cost_type_e = "LINEAR_LS"
    ocp.cost.Vx_e, ocp.cost.yref_e = np.eye(2), np.zeros(2)
    ocp.cost.W_e = np.zeros((2, 2)) if integrator == "IRK" else np.eye(2)
    return ocp


def fixed_traj():
    """The oracle's trajectory: u constant a interval, x exact."""
    u = np.array([[0.3], [-0.7], [1.1], [0.2]])
    x = np.zeros((N + 1, 2))
    x[0] = [1.0, 0.5]
    for k in range(N):
        p, v = x[k]
        x[k + 1] = [p + v * DT + 0.5 * u[k, 0] * DT ** 2, v + u[k, 0] * DT]
    return x, u


def port_cost(ocp, x, u):
    form, dnp, _ = build_ocp(ocp)
    zeros = torch.zeros((1, N + 1, form.nc), dtype=torch.float64)
    return float(eval_cost(
        form, data_to_torch(dnp, torch.float64, "cpu", batch=1),
        torch.as_tensor(x)[None], torch.as_tensor(u)[None], zeros, zeros,
        build_static_rows(form, torch.float64, "cpu")["soft"])[0])


def jax_cost(ocp, x, u):
    form, dnp, _ = jax_build_ocp(ocp)
    zeros = jnp.zeros((N + 1, form.nc))
    return float(jax_eval_cost(form, data_to_jax(dnp, jnp.float64),
                               jnp.asarray(x), jnp.asarray(u), zeros, zeros,
                               jax_rows(form, jnp.float64)["soft"]))


def analytic(kind, x, u):
    """The integral of the oracle's integrand over the 4 intervals."""
    ref = 0.0
    for k in range(N):
        p, v = x[k]
        uk = u[k, 0]
        if kind == "EXTERNAL":
            # int (v + u t)^3 + (p + v t + u t^2/2) + u^2/2
            ref += (((v + uk * DT) ** 4 - v ** 4) / (4 * uk)
                    + p * DT + 0.5 * v * DT ** 2 + uk * DT ** 3 / 6
                    + 0.5 * uk ** 2 * DT)
        elif kind == "CONL":
            ref += (((v + uk * DT) ** 3 - v ** 3) / (6 * uk)
                    + 0.25 * uk ** 2 * DT)
        else:
            f = lambda t: 0.5 * ((p + v * t + 0.5 * uk * t * t) ** 2
                                 + 2.0 * (v + uk * t) ** 2 + 0.1 * uk ** 2)
            ref += si.quad(f, 0.0, DT, epsabs=1e-13, epsrel=1e-13)[0]
    return ref


ORACLES = {"ERK EXTERNAL": ("ERK", "EXTERNAL", 4),
           "IRK CONL": ("IRK", "CONL", 2),
           "IRK NONLINEAR_LS": ("IRK", "NONLINEAR_LS", 3)}


@pytest.mark.parametrize("name", list(ORACLES))
def test_value_oracle(name):
    """The integrated cost of the fixed trajectory equals the analytic
    integral to 1e-10 (the quadrature is exact on these integrands) and
    the JAX package's value to 1e-13."""
    integrator, kind, ns = ORACLES[name]
    x, u = fixed_traj()
    got = port_cost(dint_ocp("torch", integrator, kind, ns), x, u)
    assert abs(got - analytic(kind, x, u)) < 1e-10
    assert abs(got - jax_cost(dint_ocp("jax", integrator, kind, ns), x, u)) \
        < 1e-13


LINEARIZE = {"IRK NONLINEAR_LS": ("IRK", "NONLINEAR_LS", "GAUSS_NEWTON"),
             "IRK CONL": ("IRK", "CONL", "GAUSS_NEWTON"),
             "ERK NONLINEAR_LS": ("ERK", "NONLINEAR_LS", "GAUSS_NEWTON"),
             "IRK NONLINEAR_LS EXACT": ("IRK", "NONLINEAR_LS", "EXACT"),
             "IRK EXTERNAL EXACT": ("IRK", "EXTERNAL", "EXACT")}


@pytest.mark.parametrize("name", list(LINEARIZE))
def test_linearize_matches_jax(name):
    """The QP blocks (the integrated cost's H and g among them) at a
    seeded iterate, against the JAX linearize, within 1e-12."""
    integrator, kind, hess = LINEARIZE[name]
    ns = 4 if integrator == "ERK" else 2 if kind == "CONL" else 3
    rng = np.random.default_rng(10)
    form, dnp, _ = build_ocp(dint_ocp("torch", integrator, kind, ns, hess))
    jform, jd, _ = jax_build_ocp(dint_ocp("jax", integrator, kind, ns,
                                          hess))
    nc = form.nc
    it = dict(x=rng.normal(size=(N + 1, 2)), u=rng.normal(size=(N, 1)),
              pi=rng.normal(size=(N, 2)), lam_l=np.zeros((N + 1, nc)),
              lam_u=np.zeros((N + 1, nc)), sl=np.zeros((N + 1, nc)),
              su=np.zeros((N + 1, nc)))
    ref = jax.jit(lambda *a: jax_linearize(jform, *a))(
        jax_rows(jform, jnp.float64), data_to_jax(jd, jnp.float64),
        JNlpIterate(**{k: jnp.asarray(v) for k, v in it.items()}),
        jnp.asarray(0.0))
    qp = linearize(form, build_static_rows(form, torch.float64, "cpu"),
                   data_to_torch(dnp, torch.float64, "cpu", batch=1),
                   iterate_from_numpy({k: v[None] for k, v in it.items()},
                                      torch.float64, "cpu"),
                   torch.zeros((), dtype=torch.float64))
    for f in ("Q", "R", "S", "q", "r", "A", "B", "b"):
        np.testing.assert_allclose(getattr(qp, f)[0].numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)


def test_stage_points_match_jax():
    """make_irk_stage_points (GL3, 2 substeps) on the pendulum: the
    points, times and weights, and torch.func.jacfwd of the points
    (through the implicit gradient of the stage solves) against
    jax.jacfwd of the JAX function, vmapped over 3 instances."""
    from acados_tpu.models.pendulum import pendulum_ode as jax_ode
    from acados_tpu.sim.integrator import \
        implicit_from_explicit as jax_implicit
    from acados_tpu_torch.models.pendulum import pendulum_ode

    kw = dict(nx=4, num_stages=3, num_steps=2, newton_iter=3)
    pts, w = make_irk_stage_points(implicit_from_explicit(
        lambda x, u, p, t: pendulum_ode(x, u, p, t)), **kw)
    jpts, jw = jax_stage_points(jax_implicit(
        lambda x, u, p, t: jax_ode(x, u, p, t)), **kw)
    np.testing.assert_array_equal(w, jw)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 4))
    u = rng.normal(size=(3, 1))
    t0 = np.array([0.0, 0.1, 0.3])
    dt = np.array([0.05, 0.1, 0.02])
    xu = np.concatenate([x, u], axis=1)

    def port_xs(xu_, t_, dt_):
        Xs, _, Ts = pts(xu_[:4], xu_[4:], xu_.new_zeros((0,)), t_, dt_)
        return Xs, Ts

    def jax_xs(xu_, t_, dt_):
        Xs, _, Ts = jpts(xu_[:4], xu_[4:], jnp.zeros((0,)), t_, dt_)
        return Xs, Ts

    T = lambda a: torch.as_tensor(a)
    Xs, Ts = torch.func.vmap(port_xs)(T(xu), T(t0), T(dt))
    J = torch.func.vmap(torch.func.jacfwd(
        lambda a, t_, d_: port_xs(a, t_, d_)[0]))(T(xu), T(t0), T(dt))
    jXs, jTs = jax.vmap(jax_xs)(xu, t0, dt)
    jJ = jax.vmap(jax.jacfwd(lambda a, t_, d_: jax_xs(a, t_, d_)[0]))(
        xu, t0, dt)
    assert Xs.shape == (3, 6, 4) and J.shape == (3, 6, 4, 5)
    for got, ref in ((Xs, jXs), (Ts, jTs), (J, jJ)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-13)


def test_irk_rti_batch_matches_jax(monkeypatch):
    """The main path's OCP (IRK GL4, 2 substeps, SQP_RTI) with the
    INTEGRATOR cost at N = 6, B = 3 through AcadosOcpBatchSolver, three
    RTI calls, against the vmapped JAX RTI (one jit, three calls); each
    call's K1 calls (a counting `linsolve`) equal chip_smoke.py's
    K1_PER_INTEGRATOR_RTI."""
    import chip_smoke
    from test_torch_exact_hessian import _counting

    x0s = np.array([0.0, np.pi, 0.0, 0.0]) + np.random.default_rng(
        12).normal(0.0, 0.05, (3, 4))

    def ocp(make):
        o = make(N=6, dtype="float64", nlp_solver_type="SQP_RTI",
                 integrator_type="IRK")
        o.solver_options.cost_discretization = "INTEGRATOR"
        return o

    jform, jd, _ = jax_build_ocp(ocp(jax_pendulum_ocp))
    jsolve = jax.jit(jax.vmap(jax_make_sqp_solver(
        jform, jax_opts_from(ocp(jax_pendulum_ocp)))))
    data = JNlpData(**{k: jnp.asarray(v) for k, v in
                       batch_data(jd, x0s, 4).items()})
    it_ref = JNlpIterate(**{k: jnp.asarray(v) for k, v in
                            zero_iterate(jform, x0s).items()})
    batch = rti_batch(ocp(make_pendulum_ocp), x0s, "cpu")
    calls = _counting(monkeypatch)
    for c in range(3):
        it_ref, st_ref = jsolve(data, it_ref)
        before = len(calls)
        status = batch.solve()
        assert len(calls) - before == chip_smoke.K1_PER_INTEGRATOR_RTI
        assert_same_solve(
            {f: getattr(batch._it_dev, f).numpy() for f in FIELDS},
            {"status": status, "sqp_iter": batch.get_stats("sqp_iter"),
             "qp_iter_total": batch.get_stats("qp_iter"),
             "stat": batch._stats.stat.numpy()},
            {f: np.asarray(getattr(it_ref, f)) for f in FIELDS},
            {f: np.asarray(getattr(st_ref, f)) for f in (
                "status", "sqp_iter", "qp_iter_total", "stat")},
            f"RTI call {c}")
    assert np.all(status == 0)


def test_sensitivities_refuse_integrated_cost():
    """The JAX package's sensitivities evaluate the cost without the
    interval length (acados_tpu/ocp_nlp/sensitivity.py:85): the port
    refuses the path, naming it."""
    solver = AcadosOcpSolver(dint_ocp("torch", "ERK", "NONLINEAR_LS"),
                             device="cpu")
    assert solver.solve() == 0
    with pytest.raises(NotImplementedError, match="INTEGRATOR"):
        solver.eval_solution_sensitivity(0, "initial_state")
