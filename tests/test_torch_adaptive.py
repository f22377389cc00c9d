"""PyTorch port, the SQP loop's adaptive options (ocp_nlp/sqp.py):
FIXED_STEP with Anderson(1) acceleration, adaptive Levenberg-Marquardt
(a per-instance lm through linearize) and the ADAPTIVE_CURRENT_RES_JOINT
QP tolerances (per-instance IPM tolerances), against jax.vmap of the JAX
package's make_sqp_solver on the pendulum ERK SQP (float64, CPU), each
through make_sqp_solver, AcadosOcpBatchSolver and AcadosOcpSolver, with
tests/test_torch_globalization.py's checks: equal per-instance status,
sqp_iter, qp_iter_total and stat table, iterates within 1e-9.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.ocp_nlp.sqp import SqpOpts as JSqpOpts
from acados_tpu.ocp_nlp.sqp import adaptive_qp_tol as jax_adaptive_qp_tol
from acados_tpu.ocp_qp.ipm import IpmOpts as JIpmOpts
from acados_tpu_torch.ocp_nlp.sqp import SqpOpts, adaptive_qp_tol
from acados_tpu_torch.ocp_qp.ipm import IpmOpts
from test_torch_globalization import check_three_routes

torch.set_num_threads(1)

VARIANTS = {
    "anderson": dict(with_anderson_acceleration=True),
    "adaptive_lm": dict(with_adaptive_levenberg_marquardt=True,
                        adaptive_levenberg_marquardt_mu0=1e-2),
    "adaptive_qp_tol": dict(nlp_qp_tol_strategy="ADAPTIVE_CURRENT_RES_JOINT"),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_adaptive_option_matches_jax(name):
    check_three_routes(name, VARIANTS[name])


def test_adaptive_qp_tol_matches_jax():
    """The per-instance QP tolerances of ADAPTIVE_CURRENT_RES_JOINT from
    (B,) residuals, against jax.vmap of the JAX function."""
    rng = np.random.default_rng(0)
    res = 10.0 ** rng.uniform(-9, 0, (4, 6))
    opts = SqpOpts(nlp_qp_tol_reduction_factor=0.2,
                   nlp_qp_tol_safety_factor=0.3)
    jopts = JSqpOpts(nlp_qp_tol_reduction_factor=0.2,
                     nlp_qp_tol_safety_factor=0.3)
    ref = jax.vmap(lambda r: jax_adaptive_qp_tol(
        jopts, JIpmOpts(), r[0], r[1], r[2], r[3]))(jnp.asarray(res.T))
    got = adaptive_qp_tol(opts, IpmOpts(),
                          *torch.as_tensor(res))
    for f in ("tol_stat", "tol_eq", "tol_ineq", "tol_comp"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_waiting_paths_raise():
    """What used to wait now builds: the options of the interface
    utilities (phase times, in-loop timeouts, stored iterates) build the
    SQP and are taken by options_set, and no raise names a ROADMAP item
    any more. Multiphase OCPs (item 16c) build,
    and AcadosOcpBatchSolver refuses them as the JAX package's does;
    DISCRETE dynamics and global parameters (item 17) build: the
    parameter is [p_stage | p_global]."""
    from acados_tpu_torch import (AcadosMultiphaseOcp, AcadosOcpBatchSolver,
                                  AcadosOcpSolver)
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.ocp_nlp.sqp import make_sqp_solver
    from acados_tpu_torch.interface.builder import build_ocp

    mocp = AcadosMultiphaseOcp([5, 5])
    assert mocp.N_list == [5, 5]
    with pytest.raises(NotImplementedError, match="single-phase"):
        AcadosOcpBatchSolver(mocp, 2, device="cpu")
    ocp = make_pendulum_ocp()
    ocp.solver_options.integrator_type = "DISCRETE"
    ocp.model.disc_dyn_expr = lambda x, u: x
    assert build_ocp(ocp)[0].step_jac_fn is not None
    ocp = make_pendulum_ocp()
    ocp.model.p_global = np.zeros(1)
    form, data, _ = build_ocp(ocp)
    assert form.np_ == 1 and data["p"].shape == (form.N + 1, 1)
    form = build_ocp(make_pendulum_ocp())[0]
    for field, value in (("collect_phase_times", True),
                         ("timeout_max_time", 1.0),
                         ("store_iterates", True)):
        assert callable(make_sqp_solver(form, SqpOpts(**{field: value})))
    solver = AcadosOcpSolver(make_pendulum_ocp(), device="cpu")
    for field, value in (("timeout_max_time", 1.0),
                         ("timeout_heuristic", "AVERAGE"),
                         ("store_iterates", 1)):
        solver.options_set(field, value)
        assert getattr(solver.opts, field) == (
            True if field == "store_iterates" else value)
    solver.options_set("print_level", 1)
    assert solver._print_level == 1
