"""Quadrotor NMPC with soft state constraints (BASELINE.json config 2).

Counterpart of `acados_tpu/models/quadrotor.py` (reference quadrotor_nav
workload): a 3-D quadrotor with thrust + body-rate control, 9 states
[p (3), v (3), eta = roll/pitch/yaw (3)] and 4 controls [T, wx, wy, wz];
position-tracking NONLINEAR_LS cost, hard thrust/rate bounds and soft
velocity/corridor bounds with slack penalties, SQP-RTI. The ODE is a
per-instance torch callable.
"""
from __future__ import annotations

import numpy as np
import torch

GRAV = 9.81
MASS = 1.0


def quadrotor_ode(x, u, p=None, t=None):
    del p, t
    v = x[3:6]
    phi, th, psi = x[6], x[7], x[8]
    T = u[0]
    w = u[1:4]
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(th), torch.sin(th)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    # body-z thrust direction in world frame (ZYX Euler)
    ez = torch.stack([cphi * sth * cpsi + sphi * spsi,
                      cphi * sth * spsi - sphi * cpsi,
                      cphi * cth])
    grav = torch.tensor([0.0, 0.0, GRAV], dtype=x.dtype, device=x.device)
    acc = (T / MASS) * ez - grav
    # Euler-angle kinematics: deta = W(eta) @ w, row by row
    one, zero = torch.ones_like(phi), torch.zeros_like(phi)
    W = torch.stack([
        torch.stack([one, sphi * sth / cth, cphi * sth / cth]),
        torch.stack([zero, cphi, -sphi]),
        torch.stack([zero, sphi / cth, cphi / cth]),
    ])
    deta = W @ w
    return torch.cat([v, acc, deta])


def export_quadrotor_model():
    from acados_tpu_torch.interface.acados_ocp import AcadosModel

    model = AcadosModel()
    model.name = "quadrotor"
    model.x, model.u = 9, 4
    model.f_expl_expr = lambda x, u: quadrotor_ode(x, u)
    return model


def make_quadrotor_ocp(N=20, Tf=1.0, p_ref=None, dtype="float64"):
    import scipy.linalg

    from acados_tpu_torch.interface.acados_ocp import AcadosOcp

    ocp = AcadosOcp()
    model = export_quadrotor_model()
    ocp.model = model
    nx, nu = 9, 4
    if p_ref is None:
        p_ref = np.array([1.0, 1.0, 1.0])

    ocp.solver_options.N_horizon = N
    ocp.solver_options.tf = Tf

    ny = nx + nu
    Q = np.diag([10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.5])
    R = np.diag([0.1, 0.5, 0.5, 0.5])
    ocp.cost.cost_type = "NONLINEAR_LS"
    model.cost_y_expr = lambda x, u: torch.cat([x, u])
    yref = np.zeros(ny)
    yref[:3] = p_ref
    yref[nx] = MASS * GRAV  # hover thrust reference
    ocp.cost.yref = yref
    ocp.cost.W = scipy.linalg.block_diag(Q, R)
    ocp.cost.cost_type_e = "NONLINEAR_LS"
    model.cost_y_expr_e = lambda x: x
    ocp.cost.yref_e = yref[:nx]
    ocp.cost.W_e = 5.0 * Q

    # hard input bounds: thrust + body rates
    ocp.constraints.lbu = np.array([0.1, -3.0, -3.0, -2.0])
    ocp.constraints.ubu = np.array([25.0, 3.0, 3.0, 2.0])
    ocp.constraints.idxbu = np.arange(nu)
    # soft velocity and altitude-corridor bounds with slack penalties
    ocp.constraints.idxbx = np.array([2, 3, 4, 5])
    ocp.constraints.lbx = np.array([0.0, -2.0, -2.0, -2.0])
    ocp.constraints.ubx = np.array([2.0, 2.0, 2.0, 2.0])
    ocp.constraints.idxsbx = np.arange(4)
    ocp.cost.Zl = 5e2 * np.ones(4)
    ocp.cost.Zu = 5e2 * np.ones(4)
    ocp.cost.zl = 1e1 * np.ones(4)
    ocp.cost.zu = 1e1 * np.ones(4)

    ocp.constraints.x0 = np.zeros(nx)

    ocp.solver_options.integrator_type = "ERK"
    ocp.solver_options.sim_method_num_steps = 2
    ocp.solver_options.nlp_solver_type = "SQP_RTI"
    ocp.solver_options.dtype = dtype
    return ocp
