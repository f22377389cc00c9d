"""Chain-of-masses NMPC: the scaling benchmark model family.

Counterpart of `acados_tpu/models/chain_mass.py` (reference chain_mass/
export_chain_mass_model.py and main.py:94-165: n_mass balls joined by
springs, the first fixed at the wall, the last actuated by velocity
control; LINEAR_LS cost to the resting steady state, input bounds, a
soft wall on the y-position of the free masses). nx = (2*(n_mass-2)+1)*3
grows with n_mass: the BASELINE.json "chain-of-masses scaling sweep"
config. The ODE is a per-instance torch callable; the steady state is
numpy + scipy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def chain_mass_ode(n_mass: int, m=0.033, D=1.0, L=0.033):
    """Explicit ODE f(x, u) for the chain. x = [xpos ((M+1)*3), xvel (M*3)],
    u = velocity of the last (actuated) mass. M = n_mass - 2 intermediate
    masses; the first mass is fixed at the origin."""
    M = n_mass - 2

    def f_expl(x, u, p=None, t=None):
        del p, t
        xpos = x[: (M + 1) * 3].reshape(M + 1, 3)
        xvel = x[(M + 1) * 3:].reshape(M, 3)
        # spring force between consecutive masses (first fixed at 0)
        prev = torch.cat([torch.zeros((1, 3), dtype=x.dtype,
                                      device=x.device), xpos[:-1]])
        dist = xpos - prev                        # (M+1, 3)
        # sqrt(sum(d * d)), the sum jnp.linalg.norm takes, with the
        # derivative d / |d| under jacfwd
        nrm = torch.sqrt(torch.sum(dist * dist, dim=1, keepdim=True))
        F = (D / m) * (1.0 - L / nrm) * dist      # (M+1, 3)
        # force balance on intermediate masses: F_{i+1} - F_i + gravity
        grav = torch.tensor([0.0, 0.0, -9.81], dtype=x.dtype,
                            device=x.device)
        f = F[1:] - F[:-1] + grav
        return torch.cat([xvel.reshape(-1), u, f.reshape(-1)])

    return f_expl


def chain_steady_state(n_mass: int, m=0.033, D=1.0, L=0.033,
                       x_end=None):
    """Resting positions with the last mass held at x_end (reference
    utils.compute_steady_state). Solved by scipy root-finding on the
    force balance of the intermediate masses."""
    from scipy.optimize import fsolve

    M = n_mass - 2
    if x_end is None:
        x_end = np.array([L * (M + 1) * 6, 0.0, 0.0])

    def force_balance(pos_flat):
        pos = pos_flat.reshape(M, 3)
        chain = np.vstack([np.zeros(3), pos, x_end])  # (M+2, 3)
        dist = chain[1:] - chain[:-1]                 # (M+1, 3)
        nrm = np.linalg.norm(dist, axis=1, keepdims=True)
        F = (D / m) * (1.0 - L / nrm) * dist
        f = F[1:] - F[:-1] + np.array([0.0, 0.0, -9.81])
        return f.reshape(-1)

    guess = np.linspace(np.zeros(3), x_end, M + 2)[1:-1].reshape(-1)
    pos = fsolve(force_balance, guess, xtol=1e-12).reshape(M, 3)
    xpos = np.vstack([pos, x_end]).reshape(-1)
    return np.concatenate([xpos, np.zeros(3 * M)])


def export_chain_mass_model(n_mass: int, m=0.033, D=1.0, L=0.033):
    from acados_tpu_torch.interface.acados_ocp import AcadosModel

    M = n_mass - 2
    model = AcadosModel()
    model.name = f"chain_mass_{n_mass}"
    model.x = (2 * M + 1) * 3
    model.u = 3
    model.f_expl_expr = chain_mass_ode(n_mass, m, D, L)
    return model


def make_chain_mass_ocp(n_mass=5, N=40, Ts=0.2, with_wall=True,
                        y_pos_wall=-0.05, u_max=1.0, dtype="float64"):
    """The chain_mass/main.py OCP config (reference main.py:94-165);
    returns (ocp, xrest)."""
    import scipy.linalg

    from acados_tpu_torch.interface.acados_ocp import AcadosOcp

    M = n_mass - 2
    nx = (2 * M + 1) * 3
    nu = 3
    xrest = chain_steady_state(n_mass)

    ocp = AcadosOcp()
    ocp.model = export_chain_mass_model(n_mass)
    ocp.solver_options.N_horizon = N
    ocp.solver_options.tf = N * Ts

    # LINEAR_LS to the steady state (main.py:106-133)
    Q = 2 * np.diagflat(np.ones((nx, 1)))
    R = 2 * np.diagflat(1e-2 * np.ones((nu, 1)))
    ocp.cost.cost_type = "LINEAR_LS"
    ocp.cost.cost_type_e = "LINEAR_LS"
    ocp.cost.W = scipy.linalg.block_diag(Q, R)
    ocp.cost.W_e = Q
    Vx = np.zeros(((nx + nu), nx))
    Vx[:nx, :nx] = np.eye(nx)
    Vu = np.zeros(((nx + nu), nu))
    Vu[nx:, :] = np.eye(nu)
    ocp.cost.Vx = Vx
    ocp.cost.Vu = Vu
    ocp.cost.Vx_e = np.eye(nx)
    ocp.cost.yref = np.concatenate([xrest, np.zeros(nu)])
    ocp.cost.yref_e = xrest

    ocp.constraints.lbu = -u_max * np.ones(nu)
    ocp.constraints.ubu = u_max * np.ones(nu)
    ocp.constraints.idxbu = np.arange(nu)
    ocp.constraints.x0 = xrest

    if with_wall:
        # soft bound on the y-position of every free mass (main.py:147-165)
        nbx = M + 1
        idxbx = np.array([3 * i + 1 for i in range(nbx)])
        ocp.constraints.idxbx = idxbx
        ocp.constraints.lbx = y_pos_wall * np.ones(nbx)
        ocp.constraints.ubx = 1e9 * np.ones(nbx)
        ocp.constraints.idxsbx = np.arange(nbx)
        ocp.cost.Zl = 1e3 * np.ones(nbx)
        ocp.cost.Zu = 1e3 * np.ones(nbx)
        ocp.cost.zl = 1e2 * np.ones(nbx)
        ocp.cost.zu = 1e2 * np.ones(nbx)

    # 2 Gauss-Legendre stages with one stage-Jacobian factorization per
    # integration step (jac_reuse): the Kronecker IRK path
    ocp.solver_options.integrator_type = "IRK"
    ocp.solver_options.sim_method_num_stages = 2
    ocp.solver_options.sim_method_num_steps = 2
    ocp.solver_options.sim_method_jac_reuse = True
    ocp.solver_options.nlp_solver_type = "SQP_RTI"
    # dual warm start of each RTI QP at the NLP multipliers (2 IPM
    # iterations at the steady state instead of 7-8; the JAX package's
    # chain_mass.py:136-142 gives the reasoning)
    ocp.solver_options.nlp_solver_warm_start_first_qp_from_nlp = True
    ocp.solver_options.dtype = dtype
    return ocp, xrest
