"""Race car: spatial bicycle model on a curved track (BASELINE.json
config 3).

Counterpart of `acados_tpu/models/race_car.py` (reference race_cars/
bicycle_model.py:58-142: curvilinear-coordinate bicycle with drivetrain
force Fxd, states [s, n, alpha, v, D, delta], controls [derD, derDelta],
nonlinear constraints on longitudinal/lateral acceleration and track
bounds; acados_settings.py:80-148: LINEAR_LS progress-tracking cost, soft
nonlinear rows via idxsh, SQP_RTI). The track curvature kappa(s) is the
JAX package's smooth sum of sines, here a torch function; the ODE and
the constraints are per-instance torch callables.
"""
from __future__ import annotations

import numpy as np
import torch

# vehicle parameters (bicycle_model.py:58-64)
M_CAR = 0.043
C1 = 0.5
C2 = 15.5
CM1 = 0.28
CM2 = 0.05
CR0 = 0.011
CR2 = 0.006


def default_kappa(s):
    """Smooth periodic track curvature (stand-in for the reference's
    spline-interpolated track data)."""
    return 0.8 * torch.sin(0.5 * s) + 0.5 * torch.cos(1.1 * s + 0.4)


def _drive_force(v, D):
    return (CM1 - CM2 * v) * D - CR2 * v * v - CR0 * torch.tanh(5 * v)


def race_car_ode(kappa=default_kappa):
    def f_expl(x, u, p=None, t=None):
        del p, t
        s, n, alpha, v, D, delta = x
        derD, derDelta = u
        Fxd = _drive_force(v, D)
        sdot = (v * torch.cos(alpha + C1 * delta)) / (1 - kappa(s) * n)
        return torch.stack([
            sdot,
            v * torch.sin(alpha + C1 * delta),
            v * C2 * delta - kappa(s) * sdot,
            Fxd / M_CAR * torch.cos(C1 * delta),
            derD,
            derDelta,
        ])
    return f_expl


def race_car_constraints(kappa=default_kappa):
    """h(x, u) = [a_long, a_lat, n, D, delta] (bicycle_model.py:142)."""
    del kappa  # h does not depend on the track (as in the JAX package)

    def h(x, u, p=None, t=None):
        del p, t
        s, n, alpha, v, D, delta = x
        Fxd = _drive_force(v, D)
        a_long = Fxd / M_CAR
        a_lat = C2 * v * v * delta + Fxd * torch.sin(C1 * delta) / M_CAR
        return torch.stack([a_long, a_lat, n, D, delta])
    return h


def make_race_car_ocp(N=50, Tf=1.0, kappa=default_kappa, dtype="float64"):
    """acados_settings.py config: progress-maximizing LINEAR_LS cost with
    soft acceleration rows and hard track/actuator bounds."""
    import scipy.linalg

    from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp

    ocp = AcadosOcp()
    model = AcadosModel()
    model.name = "race_car"
    model.x, model.u = 6, 2
    model.f_expl_expr = race_car_ode(kappa)
    model.con_h_expr = race_car_constraints(kappa)
    ocp.model = model
    nx, nu = 6, 2

    ocp.solver_options.N_horizon = N
    ocp.solver_options.tf = Tf

    # LINEAR_LS: track a progress reference on s (yref[0]), regularize the
    # rest (acados_settings.py:83-107)
    ny = nx + nu
    Q = np.diag([1e-1, 1e-8, 1e-8, 1e-8, 1e-3, 5e-3])
    R = np.eye(nu) * 1e-3
    ocp.cost.cost_type = "LINEAR_LS"
    ocp.cost.cost_type_e = "LINEAR_LS"
    ocp.cost.W = scipy.linalg.block_diag(Q, R)
    ocp.cost.W_e = Q * 5.0
    Vx = np.zeros((ny, nx))
    Vx[:nx, :nx] = np.eye(nx)
    Vu = np.zeros((ny, nu))
    Vu[nx:, :] = np.eye(nu)
    ocp.cost.Vx = Vx
    ocp.cost.Vu = Vu
    ocp.cost.Vx_e = np.eye(nx)
    ocp.cost.yref = np.array([1.0, 0, 0, 0, 0, 0, 0, 0])
    ocp.cost.yref_e = np.array([0.0, 0, 0, 0, 0, 0])

    # track half-width bound on n (hard, acados_settings.py:110-112)
    ocp.constraints.idxbx = np.array([1])
    ocp.constraints.lbx = np.array([-0.12])
    ocp.constraints.ubx = np.array([0.12])
    # input rate bounds
    ocp.constraints.lbu = np.array([-10.0, -2.0])
    ocp.constraints.ubu = np.array([10.0, 2.0])
    ocp.constraints.idxbu = np.array([0, 1])
    # nonlinear constraints, accelerations soft (idxsh = [0, 1]),
    # n/D/delta hard (acados_settings.py:119-139)
    ocp.constraints.lh = np.array([-4.0, -4.0, -0.12, -1.0, -0.4])
    ocp.constraints.uh = np.array([4.0, 4.0, 0.12, 1.0, 0.4])
    ocp.constraints.idxsh = np.array([0, 1])
    ocp.cost.Zl = 1e0 * np.ones(2)
    ocp.cost.Zu = 1e0 * np.ones(2)
    ocp.cost.zl = 1e1 * np.ones(2)
    ocp.cost.zu = 1e1 * np.ones(2)

    ocp.constraints.x0 = np.array([-2.0, 0, 0, 0, 0, 0])

    ocp.solver_options.integrator_type = "ERK"
    ocp.solver_options.sim_method_num_steps = 2
    ocp.solver_options.nlp_solver_type = "SQP_RTI"
    ocp.solver_options.dtype = dtype
    return ocp
