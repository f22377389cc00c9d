"""Multi-phase OCP with a dimension-changing transition.

Port of examples/mocp_transition_example.py (the reference's
mocp_transition_example/main.py): phase 0 a double integrator (nx = 2),
an N = 1 DISCRETE transition dropping the velocity state, phase 2 a
single integrator (nx = 1) with weaker actuation; solved by SQP for
three transition times. The problem is acados_tpu_torch.testing's
transition_mocp (tests/test_multiphase.py's).

    python examples_torch/mocp_transition_example.py [--device cpu]
"""
import _example_env

from acados_tpu_torch import AcadosOcpSolver
from acados_tpu_torch.testing import MOCP_N_H, transition_mocp


def main(device="cuda"):
    for t1 in (0.2, 0.4, 0.6):
        solver = AcadosOcpSolver(transition_mocp(t1), device=device)
        assert solver.solve() == 0
        xN = solver.get(2 * MOCP_N_H + 1, "x")
        print(f"t1 = {t1:.1f}: cost {solver.get_cost():9.4f}, "
              f"terminal position {float(xN[0]):+.4f}")
    return solver


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
