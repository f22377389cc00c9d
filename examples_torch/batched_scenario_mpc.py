"""Batched NMPC: hundreds of OCP instances in one lockstep solve.

Port of examples/batched_scenario_mpc.py, the replacement for the
reference's OpenMP batch solver (AcadosOcpBatchSolver,
acados_solver.in.c:3223 `#pragma omp parallel for`): the instances are
the leading batch axis of every tensor of one batch-first SQP solve
(FUNNEL_L1PEN_LINESEARCH, up to 200 iterations), each instance stopping
on its own while the batch runs in lockstep: the RL / scenario-MPC /
parameter-sweep workload shape, on one card.

    python examples_torch/batched_scenario_mpc.py [--device cpu]
"""
import numpy as np
import torch

import _example_env

from acados_tpu_torch.interface.builder import (StageLayout, build_ocp,
                                                data_to_torch)
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.sqp import (SqpOpts, init_iterate,
                                          make_sqp_solver)


def main(device="cuda", B=256):
    ocp = make_pendulum_ocp(N=20, dtype="float64")
    form, data_np, _ = build_ocp(ocp)
    solve = make_sqp_solver(
        form, SqpOpts(max_iter=200,
                      globalization="FUNNEL_L1PEN_LINESEARCH"))

    # a batch of perturbed initial states
    rng = np.random.default_rng(0)
    x0s = np.array([0.0, np.pi, 0.0, 0.0]) \
        + 0.05 * rng.standard_normal((B, 4))
    data = data_to_torch(data_np, torch.float64, device, batch=B)
    lay = StageLayout(form.con_0)
    lb0 = data.lb_0.clone()
    lb0[:, lay.off_bx:lay.off_bx + 4] = torch.as_tensor(x0s)
    data = data.replace(lb_0=lb0, ub_0=lb0.clone())
    init = init_iterate(form, batch=B, dtype=torch.float64, device=device)
    init = init.replace(x=torch.as_tensor(
        np.tile(x0s[:, None, :], (1, form.N + 1, 1)), device=device))

    it, stats = solve(data, init)
    ok = int((stats.status == 0).sum())
    print(f"{ok}/{B} instances converged; "
          f"max res_stat {float(stats.res_stat.max()):.2e}")
    assert ok == B
    return it


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
