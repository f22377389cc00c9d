"""Batched RTI with the preparation / feedback split: the deployment
shape of an RL / scenario-MPC pipeline.

Port of examples/batched_rti_phases.py (the reference capsule's batched
phase entries, batch_setup_qp_matrices_and_factorize,
acados_solver.in.c:3246), driven once a sample period: prepare between
samples (linearize and the predictor QP of every instance, the data and
the iterate staying on the card), then inject the measured x0 batch and
run the feedback solve, warm-started from the predictor solutions. The
plant is the batch simulator, one call for every instance.

    python examples_torch/batched_rti_phases.py [--device cpu]
"""
import numpy as np

import _example_env

from acados_tpu_torch import (AcadosOcpBatchSolver, AcadosSim,
                              AcadosSimBatchSolver)
from acados_tpu_torch.models.pendulum import make_pendulum_ocp

B, N, STEPS = 8, 10, 20


def main(device="cuda"):
    ocp = make_pendulum_ocp(N=N, dtype="float64")
    ocp.solver_options.nlp_solver_type = "SQP_RTI"
    bs = AcadosOcpBatchSolver(ocp, B, device=device)

    sim = AcadosSim()
    sim.model = ocp.model
    sim.solver_options.T = float(ocp.solver_options.tf) / N
    plant = AcadosSimBatchSolver(sim, B, device=device)

    rng = np.random.default_rng(0)
    # a batch of perturbed initial states near the upright reference
    x = (np.array([0.0, 0.2, 0.0, 0.0])[None, :]
         + rng.normal(0.0, 0.03, (B, 4)))
    for i, view in enumerate(bs.ocp_solvers):
        view.set(0, "lbx", x[i])
        view.set(0, "ubx", x[i])
    bs.set_flat("x", np.tile(x[:, None, :], (1, N + 1, 1)).reshape(B, -1))

    for _ in range(STEPS):
        bs.prepare()                  # between samples: linearize, factor
        status = bs.feedback(x0=x)    # at the sample: inject x0, solve
        assert np.all(status == 0), status
        u0 = bs.get_flat("u")[:, :1]
        x = plant.simulate(x, u0)

    theta = np.abs(x[:, 1])
    print(f"after {STEPS} steps: max |theta| = {theta.max():.4f} "
          f"(upright reference), time_feedback "
          f"{bs.get_stats('time_feedback') * 1e3:.1f} ms")
    assert np.all(theta < 0.05), theta
    print("OK")
    return x


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
