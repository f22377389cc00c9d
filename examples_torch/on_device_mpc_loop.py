"""Closed-loop NMPC of a batch of plants, the controller's data and
iterate on the card.

Port of examples/on_device_mpc_loop.py. There the whole closed loop
(RTI solve -> apply u0 -> plant step -> new measurement) is one
`jax.lax.scan` on the device, vmapped over B loops. Here it is a host
loop over the samples on AcadosOcpBatchSolver: the B loops are the
batch, the iterate stays on the card between calls, and each sample
moves only the B measured states and first controls across (the port's
lockstep loop syncs once a round anyway). Capturing a sample in a CUDA
graph, which would take the host out of the loop, is ROADMAP item 22.

Each sample runs two RTI iterations (the counterpart of the AS-RTI
level-A configuration of minimal_example_closed_loop.py: a single
iteration is too inexact for this swing-up at 20 Hz), and the plant is
a finer RK4 than the controller's model, batch-first on the card.

    python examples_torch/on_device_mpc_loop.py [--device cpu]
"""
import numpy as np
import torch

import _example_env

from acados_tpu_torch import AcadosOcpBatchSolver
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.sim.integrator import SimOpts, make_step_fn


def main(device="cuda", n_steps=60, B=4):
    ocp = make_pendulum_ocp(N=20, Tf=1.0, dtype="float64",
                            nlp_solver_type="SQP_RTI")
    bs = AcadosOcpBatchSolver(ocp, B, device=device)
    N, nx = bs.N, bs.form.nx

    # the plant: a finer integration than the controller's model
    plant_step = make_step_fn(
        f_expl=ocp.model.f_expl_expr, nx=nx,
        opts=SimOpts(integrator_type="ERK", num_stages=4, num_steps=4))
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                     device=bs.device)
    p0, t0, dt = as_t(np.zeros((B, 0))), as_t(np.zeros(B)), \
        as_t(np.full(B, 1.0 / 20))

    # B loops from perturbed initial states
    rng = np.random.default_rng(0)
    x = (np.array([0.0, np.pi, 0.0, 0.0])[None, :]
         + rng.normal(0, 0.05, (B, 4)))
    bs.set_flat("x", np.tile(x[:, None, :], (1, N + 1, 1)).reshape(B, -1))
    xs, res = [], []
    for _ in range(n_steps):
        # the measurement into the stage-0 bounds (the feedback x0)
        for i, view in enumerate(bs.ocp_solvers):
            view.set(0, "lbx", x[i])
            view.set(0, "ubx", x[i])
        assert np.all(bs.solve() == 0)
        assert np.all(bs.solve() == 0)
        u0 = bs.get_flat("u")[:, :1]
        xs.append(x)
        res.append(bs.get_stats("residuals")[:, 0])
        x = plant_step(as_t(x), as_t(u0), p0, t0, dt).cpu().numpy()

    theta_final = np.stack(xs)[-1, :, 1]
    print(f"{B} closed loops x {n_steps} samples:")
    print("  final theta per loop:", np.round(theta_final, 4))
    print("  final RTI residuals :", np.round(res[-1], 6))
    assert np.all(np.abs(theta_final) < 1e-2), "swing-up failed"
    return np.stack(xs)


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
