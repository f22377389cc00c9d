"""Getting-started NMPC: pendulum-on-cart swing-up.

Port of examples/minimal_example_ocp.py (the reference's getting-started
example, minimal_example_ocp.py): NONLINEAR_LS cost, |u| <= 80, N = 20,
Tf = 1 s, float64, solved by SQP on the card (--device cpu for the
host), then the iteration table of print_statistics().

    python examples_torch/minimal_example_ocp.py [--device cpu]
"""
import numpy as np

import _example_env

from acados_tpu_torch import AcadosOcpSolver
from acados_tpu_torch.models.pendulum import make_pendulum_ocp


def main(device="cuda"):
    ocp = make_pendulum_ocp(N=20, Tf=1.0, dtype="float64",
                            nlp_solver_type="SQP")
    solver = AcadosOcpSolver(ocp, device=device)

    status = solver.solve()
    assert status == 0, f"solve failed with status {status}"
    solver.print_statistics()

    N = ocp.solver_options.N_horizon
    x_traj = np.array([solver.get(k, "x") for k in range(N + 1)])
    u_traj = np.array([solver.get(k, "u") for k in range(N)])
    print("initial state:", x_traj[0])
    print("final state:  ", x_traj[-1])
    print("max |u|:      ", np.abs(u_traj).max())
    assert np.abs(x_traj[-1][1]) < 0.2  # pendulum near upright
    assert np.abs(u_traj).max() <= 80.0 + 1e-6
    return x_traj, u_traj


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
