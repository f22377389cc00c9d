"""Closed-loop NMPC with the real-time iteration (RTI) phase split.

Port of examples/minimal_example_closed_loop.py (the reference's
minimal_example_closed_loop.py): the preparation / feedback split
(rti_phase, ocp_nlp_sqp_rti.c:461,523) with AS-RTI level A advancement,
60 samples of the pendulum swing-up, the plant a finer simulator.

    python examples_torch/minimal_example_closed_loop.py [--device cpu]
"""
import numpy as np

import _example_env

from acados_tpu_torch import AcadosOcpSolver, AcadosSim, AcadosSimSolver
from acados_tpu_torch.models.pendulum import (export_pendulum_model,
                                              make_pendulum_ocp)


def main(device="cuda", n_steps=60, as_rti_level="A"):
    ocp = make_pendulum_ocp(N=20, Tf=1.0, dtype="float64",
                            nlp_solver_type="SQP_RTI")
    ocp.solver_options.as_rti_level = as_rti_level
    solver = AcadosOcpSolver(ocp, device=device)

    sim = AcadosSim()
    sim.model = export_pendulum_model()
    sim.solver_options.T = 1.0 / 20
    sim.solver_options.num_steps = 4
    plant = AcadosSimSolver(sim, device=device)

    x = np.array([0.0, np.pi, 0.0, 0.0])
    for _ in range(n_steps):
        # preparation runs before the measurement arrives
        solver.options_set("rti_phase", 1)
        assert solver.solve() == 0
        # measurement -> feedback (the latency-critical phase)
        solver.set(0, "lbx", x)
        solver.set(0, "ubx", x)
        solver.options_set("rti_phase", 2)
        assert solver.solve() == 0
        x = plant.simulate(x=x, u=solver.get(0, "u"))
    print("final state:", x, "| feedback qp_iter:",
          solver.get_stats("qp_iter"))
    assert np.linalg.norm(x) < 0.5
    return x


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
