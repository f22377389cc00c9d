"""DAE-constrained OCP: algebraic variables z in cost and constraints.

Port of examples/dae_constrained_ocp.py (the reference's DAE examples:
implicit DAE dynamics f(xdot, x, z, u) = 0 with cost l(x, u, z) and
constraints h(x, u, z)): a cart with a nonlinear friction force defined
by an algebraic equation z = c v^3. The friction force (an algebraic
variable, not a state) is penalized in the cost and bounded by a path
constraint; the solver supplies z and dz/d(x, u) from the IRK stage
system, whose Newton matrices go to the Gauss-Jordan kernel on the card.

    python examples_torch/dae_constrained_ocp.py [--device cpu]
"""
import numpy as np
import torch

import _example_env

from acados_tpu_torch import AcadosModel, AcadosOcp, AcadosOcpSolver

C_FRIC = 0.7


def main(device="cuda"):
    ocp = AcadosOcp()
    m = AcadosModel()
    m.name = "dae_cart"
    m.x, m.u, m.z = 2, 1, 1

    def f_impl(xdot, x, z, u, p, t):
        return torch.cat([
            xdot[:1] - x[1:2],            # pos' = vel
            xdot[1:2] - (u - z),          # vel' = u - friction
            z - C_FRIC * x[1:2] ** 3,     # algebraic: z = c v^3
        ])

    m.f_impl_expr = f_impl
    # the cost and the constraint both read z
    m.cost_y_expr = lambda x, u, z: torch.cat([x, u, z])
    m.con_h_expr = lambda x, u, z: z
    ocp.model = m

    N = 20
    ocp.solver_options.N_horizon = N
    ocp.solver_options.tf = 2.0
    ocp.solver_options.integrator_type = "IRK"
    ocp.solver_options.sim_method_num_stages = 3
    ocp.solver_options.nlp_solver_type = "SQP"
    ocp.solver_options.dtype = "float64"

    ocp.cost.cost_type = "NONLINEAR_LS"
    ocp.cost.W = np.diag([1.0, 0.5, 0.05, 0.3])
    ocp.cost.yref = np.zeros(4)
    ocp.cost.cost_type_e = "LINEAR_LS"
    ocp.cost.Vx_e = np.eye(2)
    ocp.cost.W_e = 5.0 * np.eye(2)
    ocp.cost.yref_e = np.zeros(2)

    ocp.constraints.x0 = np.array([1.0, 0.0])
    ocp.constraints.idxbu = np.array([0])
    ocp.constraints.lbu = np.array([-2.5])
    ocp.constraints.ubu = np.array([2.5])
    # bound the friction force (the algebraic variable), not the state
    ocp.constraints.lh = np.array([-0.12])
    ocp.constraints.uh = np.array([0.12])

    solver = AcadosOcpSolver(ocp, device=device)
    status = solver.solve()
    assert status == 0, solver.get_residuals()

    z = np.array([solver.get(k, "z")[0] for k in range(N)])
    v = np.array([solver.get(k, "x")[1] for k in range(N)])
    print(f"status {status}, max |z| = {np.abs(z).max():.4f} "
          f"(bound 0.12), algebraic-consistency error = "
          f"{np.abs(z - C_FRIC * v ** 3).max():.2e}")
    assert np.abs(z).max() <= 0.12 + 1e-6
    assert np.abs(z).max() > 0.1   # the z bound shapes the solution


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
