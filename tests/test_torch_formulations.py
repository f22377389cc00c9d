"""PyTorch port, the cost formulations this slice adds: CONL (convex over
nonlinear, the generalized Gauss-Newton Hessian) at the initial, path and
terminal stages, and AUTO cost detection (interface/builder.py), against
the JAX package (float64, CPU), after tests/test_formulations.py:102-150
and tests/test_options.py:165-230: per-instance status, sqp_iter,
qp_iter_total, stat table and iterates as in
tests/test_torch_globalization.py, the detected cost fields equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu_torch.interface.builder import build_ocp
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from test_torch_globalization import (assert_same_solve, jax_solve,
                                      port_solve, rel_gap)

torch.set_num_threads(1)

N = 8
X0S = (np.array([0.0, np.pi, 0.0, 0.0])
       + np.random.default_rng(4).normal(0.0, 0.1, (3, 4)))
Q = 2 * np.diag([1e3, 1e3, 1e-2, 1e-2])
R = 2 * np.diag([1e-2])
W = np.block([[Q, np.zeros((4, 1))], [np.zeros((1, 4)), R]])


def conl_pendulum(pkg, quartic):
    """The pendulum's NONLINEAR_LS cost rewritten as CONL on the same
    residuals r = y - yref: psi = 0.5 r' W r (the same objective), or
    with a convex quartic term 0.01 sum(r^4) added (psi'' then changes
    with r; at 0.05 the full-step SQP cycles to its 100 iterations in
    both packages)."""
    lib = jnp if pkg == "jax" else torch
    ocp = (jax_pendulum_ocp if pkg == "jax" else make_pendulum_ocp)(
        N=N, dtype="float64", nlp_solver_type="SQP")
    Wt, Qt = lib.asarray(W), lib.asarray(Q)
    extra = (lambda r: 0.01 * lib.sum(r ** 4)) if quartic \
        else (lambda r: 0.0)
    m = ocp.model
    m.cost_psi_expr = lambda r, p: 0.5 * r @ Wt @ r + extra(r)
    m.cost_psi_expr_e = lambda r, p: 0.5 * r @ Qt @ r + extra(r)
    ocp.cost.cost_type = "CONL"
    ocp.cost.cost_type_e = "CONL"
    return ocp


@pytest.mark.parametrize("quartic", [False, True])
def test_conl_matches_jax(quartic):
    data, init, it_ref, st_ref = jax_solve(conl_pendulum("jax", quartic),
                                           X0S)
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    it, st = port_solve(conl_pendulum("torch", quartic), data, init)
    assert_same_solve(it, st, it_ref, st_ref, f"CONL quartic={quartic}")
    if not quartic:
        # psi = 0.5 r' W r: the generalized Gauss-Newton QP is the
        # NONLINEAR_LS one, so is the solution
        it_nls, _ = port_solve(make_pendulum_ocp(
            N=N, dtype="float64", nlp_solver_type="SQP"), data, init)
        assert rel_gap(it["x"], it_nls["x"]) <= 1e-9


def auto_pendulum(pkg, quadratic):
    """tests/test_options.py's AUTO pendulum (N = 10, Tf = 0.5, near the
    upright): a quadratic EXTERNAL cost, which AUTO rewrites as
    LINEAR_LS, or cos(theta) + 0.01 F^2, which stays EXTERNAL (with the
    exact Hessian and PROJECT)."""
    lib = jnp if pkg == "jax" else torch
    ocp = (jax_pendulum_ocp if pkg == "jax" else make_pendulum_ocp)(
        N=10, Tf=0.5, x0=np.array([0.0, 0.5, 0.0, 0.0]), dtype="float64",
        nlp_solver_type="SQP")
    Qd, Rd = lib.asarray(np.diag([1e3, 1e3, 1e-2, 1e-2])), lib.asarray(
        np.diag([1e-2]))
    m = ocp.model
    if quadratic:
        m.cost_expr_ext_cost = lambda x, u: x @ Qd @ x + u @ Rd @ u + 3.0
        m.cost_expr_ext_cost_e = lambda x, u: x @ Qd @ x
        ocp.cost.cost_type_e = "AUTO"
    else:
        m.cost_expr_ext_cost = lambda x, u: lib.cos(x[1]) + 0.01 * u[0] ** 2
        ocp.solver_options.hessian_approx = "EXACT"
        ocp.solver_options.regularize_method = "PROJECT"
    ocp.cost.cost_type = "AUTO"
    return ocp


@pytest.mark.parametrize("quadratic", [True, False])
def test_auto_cost_matches_jax(quadratic):
    """Both packages detect the same cost type and, for the quadratic
    cost, the same Vx, Vu, W and yref (the constant offset dropped); the
    solves agree."""
    x0s = np.array([0.0, 0.5, 0.0, 0.0]) + np.random.default_rng(4).normal(
        0.0, 0.05, (3, 4))
    jocp, tocp = auto_pendulum("jax", quadratic), auto_pendulum("torch",
                                                                quadratic)
    jax_build_ocp(jocp)
    build_ocp(tocp)
    want = "LINEAR_LS" if quadratic else "EXTERNAL"
    for attr in ("cost_type", "cost_type_0", "cost_type_e"):
        assert getattr(tocp.cost, attr) == getattr(jocp.cost, attr)
    assert tocp.cost.cost_type == want
    if quadratic:
        assert tocp.cost.cost_type_e == "LINEAR_LS"
        for f in ("Vx", "Vu", "W", "yref", "Vx_e", "W_e", "yref_e"):
            np.testing.assert_allclose(getattr(tocp.cost, f),
                                       getattr(jocp.cost, f), rtol=1e-12,
                                       atol=1e-12, err_msg=f)
    data, init, it_ref, st_ref = jax_solve(auto_pendulum("jax", quadratic),
                                           x0s)
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    it, st = port_solve(auto_pendulum("torch", quadratic), data, init)
    assert_same_solve(it, st, it_ref, st_ref, f"AUTO quadratic={quadratic}")
