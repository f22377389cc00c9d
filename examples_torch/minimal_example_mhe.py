"""Moving-horizon estimation (MHE) for the pendulum-on-cart.

Port of examples/minimal_example_mhe.py (the reference's MHE example
family, pendulum_on_cart/mhe): the estimator is an OCP whose "controls"
are the process noise w, whose parameter is the known input force F, and
whose least-squares residual stacks the state measurements and the
noise (stage 0 adds the arrival cost):

    min  sum_k ||x_k - y_meas_k||_R^2 + ||w_k||_Q^2  (+ arrival term)
    s.t. x_{k+1} = f(x_k, F_k) + w_k

The measurements are made from a seed with numpy.

    python examples_torch/minimal_example_mhe.py [--device cpu]
"""
import numpy as np
import torch

import _example_env

from acados_tpu_torch import (AcadosModel, AcadosOcp, AcadosOcpSolver,
                              AcadosSim, AcadosSimSolver)
from acados_tpu_torch.models.pendulum import (export_pendulum_model,
                                              pendulum_ode)

N = 25
H = 0.05


def export_mhe_ocp():
    """MHE OCP: x = plant state, u = process noise w, p = applied force."""
    nx = 4
    model = AcadosModel()
    model.name = "mhe_pendulum"
    model.x = nx
    model.u = nx              # process noise w
    model.p = 1               # known force F
    model.f_expl_expr = lambda x, w, p: pendulum_ode(x, p) + w

    ocp = AcadosOcp()
    ocp.model = model
    ocp.solver_options.N_horizon = N
    ocp.solver_options.tf = N * H

    Q = 10.0 * np.eye(nx)         # noise penalty
    R = 100.0 * np.eye(nx)        # measurement fit
    Q0 = 0.1 * np.eye(nx)         # arrival cost
    Z = np.zeros((nx, nx))

    # path: y = [x; w]
    ocp.cost.cost_type = "NONLINEAR_LS"
    model.cost_y_expr = lambda x, w: torch.cat([x, w])
    ocp.cost.W = np.block([[R, Z], [Z, Q]])
    ocp.cost.yref = np.zeros(2 * nx)
    # stage 0: y = [x; w; x] (the arrival-cost block)
    ocp.cost.cost_type_0 = "NONLINEAR_LS"
    model.cost_y_expr_0 = lambda x, w: torch.cat([x, w, x])
    ocp.cost.W_0 = np.block([[R, Z, Z], [Z, Q, Z], [Z, Z, Q0]])
    ocp.cost.yref_0 = np.zeros(3 * nx)
    # terminal: the measurement fit only
    ocp.cost.cost_type_e = "NONLINEAR_LS"
    model.cost_y_expr_e = lambda x: x
    ocp.cost.W_e = R
    ocp.cost.yref_e = np.zeros(nx)

    # the estimation cost is not scaled by the time step (reference
    # cost_scaling = ones)
    ocp.cost.cost_scaling = np.ones(N + 1)

    ocp.parameter_values = np.zeros(1)
    ocp.solver_options.nlp_solver_type = "SQP"
    ocp.solver_options.nlp_solver_max_iter = 100
    ocp.solver_options.dtype = "float64"
    return ocp


def main(device="cuda", seed=0):
    rng = np.random.default_rng(seed)

    # simulate the true plant under a known force sequence
    sim = AcadosSim()
    sim.model = export_pendulum_model()
    sim.solver_options.T = H
    sim.solver_options.num_steps = 4
    plant = AcadosSimSolver(sim, device=device)

    x_true = np.zeros((N + 1, 4))
    x_true[0] = [0.0, 0.3, 0.0, 0.0]
    F = 2.0 * np.sin(0.5 * np.arange(N))
    for k in range(N):
        x_true[k + 1] = plant.simulate(x=x_true[k], u=np.array([F[k]]))
    sigma = 0.01
    y_meas = x_true + sigma * rng.standard_normal(x_true.shape)

    # the MHE solve: measurements enter through yref, the force through p
    mhe = AcadosOcpSolver(export_mhe_ocp(), device=device)
    mhe.cost_set(0, "yref",
                 np.concatenate([y_meas[0], np.zeros(4), y_meas[0]]))
    for k in range(1, N):
        mhe.cost_set(k, "yref", np.concatenate([y_meas[k], np.zeros(4)]))
    mhe.cost_set(N, "yref", y_meas[N])
    for k in range(N + 1):
        mhe.set(k, "p", np.array([F[min(k, N - 1)]]))
        mhe.set(k, "x", y_meas[k])

    status = mhe.solve()
    assert status == 0, status
    x_est = np.array([mhe.get(k, "x") for k in range(N + 1)])
    err_est = np.abs(x_est - x_true).max()
    err_meas = np.abs(y_meas - x_true).max()
    print(f"max estimation error {err_est:.2e} vs measurement noise "
          f"{err_meas:.2e}")
    assert err_est < err_meas  # the estimator beats the raw measurements
    return x_est, x_true


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
