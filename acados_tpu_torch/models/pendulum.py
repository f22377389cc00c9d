"""Pendulum-on-cart: the canonical acados example model.

Counterpart of `acados_tpu/models/pendulum.py` (reference
getting_started/pendulum_model.py and minimal_example_ocp.py:15-44: N=20,
Tf=1.0, NONLINEAR_LS cost, |u| <= 80), with the model as a per-instance
torch callable.
"""
from __future__ import annotations

import numpy as np
import torch

# model constants (pendulum_model.py: M=1, m=0.1, l=0.8, g=9.81)
M_CART = 1.0
M_PEND = 0.1
LENGTH = 0.8
GRAV = 9.81


def pendulum_ode(x, u, p=None, t=None):
    """x = [pos, theta, v, dtheta]; theta = 0 is upright. Explicit ODE of
    one instance, matching the reference pendulum_model.py dynamics."""
    del p, t
    theta, v, dtheta = x[1], x[2], x[3]
    F = u[0]
    s, c = torch.sin(theta), torch.cos(theta)
    m, M, l, g = M_PEND, M_CART, LENGTH, GRAV
    denom = M + m - m * c * c
    a = (-m * l * s * dtheta * dtheta + m * g * c * s + F) / denom
    dd = (-m * l * c * s * dtheta * dtheta + F * c + (M + m) * g * s) \
        / (l * denom)
    return torch.stack([v, dtheta, a, dd])


def export_pendulum_model():
    """AcadosModel for the pendulum (reference export_pendulum_ode_model)."""
    from acados_tpu_torch.interface.acados_ocp import AcadosModel
    model = AcadosModel()
    model.name = "pendulum_ode"
    model.x = 4
    model.u = 1
    model.f_expl_expr = lambda x, u: pendulum_ode(x, u)
    return model


def make_pendulum_ocp(N=20, Tf=1.0, Fmax=80.0, x0=None,
                      nlp_solver_type="SQP", integrator_type="ERK",
                      dtype="float64"):
    """The getting-started NMPC config (minimal_example_ocp.py:15-44)."""
    from acados_tpu_torch.interface.acados_ocp import AcadosOcp

    ocp = AcadosOcp()
    model = export_pendulum_model()
    ocp.model = model
    nx, nu = 4, 1

    ocp.solver_options.N_horizon = N
    ocp.solver_options.tf = Tf

    Q_mat = 2 * np.diag([1e3, 1e3, 1e-2, 1e-2])
    R_mat = 2 * np.diag([1e-2])

    ocp.cost.cost_type = "NONLINEAR_LS"
    model.cost_y_expr = lambda x, u: torch.cat([x, u])
    ocp.cost.yref = np.zeros(nx + nu)
    ocp.cost.W = np.block([[Q_mat, np.zeros((nx, nu))],
                           [np.zeros((nu, nx)), R_mat]])
    ocp.cost.cost_type_e = "NONLINEAR_LS"
    model.cost_y_expr_e = lambda x: x
    ocp.cost.yref_e = np.zeros(nx)
    ocp.cost.W_e = Q_mat

    ocp.constraints.lbu = np.array([-Fmax])
    ocp.constraints.ubu = np.array([+Fmax])
    ocp.constraints.idxbu = np.array([0])
    ocp.constraints.x0 = np.array([0.0, np.pi, 0.0, 0.0]) \
        if x0 is None else np.asarray(x0, np.float64)

    ocp.solver_options.hessian_approx = "GAUSS_NEWTON"
    ocp.solver_options.integrator_type = integrator_type
    ocp.solver_options.sim_method_num_steps = 2
    ocp.solver_options.nlp_solver_type = nlp_solver_type
    ocp.solver_options.dtype = dtype
    if dtype == "float32":
        # float32 path: tolerances at the machine-precision plateau plus a
        # small Levenberg-Marquardt damping against active-set chattering
        # of borderline bang-bang instances (acados_tpu/models/
        # pendulum.py:86-99)
        ocp.solver_options.levenberg_marquardt = 1e-4
        ocp.solver_options.nlp_solver_tol_stat = 2e-3
        ocp.solver_options.nlp_solver_tol_eq = 1e-4
        ocp.solver_options.nlp_solver_tol_ineq = 1e-4
        ocp.solver_options.nlp_solver_tol_comp = 1e-3
    return ocp
