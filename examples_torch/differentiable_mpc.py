"""Differentiable MPC: gradients through the solver by the implicit
function theorem.

Port of examples/differentiable_mpc.py (the reference's
eval_adjoint_solution_sensitivity / eval_solution_sensitivity,
acados_ocp_solver.py; ocp_nlp_common.c:4039, 4108, used for RL, policy
gradients and learning-based MPC). The solve is a
torch.autograd.Function (ocp_nlp/sensitivity.py:make_diff_solver) whose
backward is one Riccati-factored adjoint solve, so the MPC layer
composes with autograd like any other differentiable function.

    python examples_torch/differentiable_mpc.py [--device cpu]
"""
import numpy as np
import torch

import _example_env

from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.sensitivity import make_diff_solver
from acados_tpu_torch.ocp_nlp.sqp import SqpOpts, init_iterate


def main(device="cuda"):
    ocp = make_pendulum_ocp(N=20, dtype="float64")
    form, data_np, _ = build_ocp(ocp)
    data = data_to_torch(data_np, torch.float64, device, batch=1)
    x0 = np.array([0.0, np.pi, 0.0, 0.0])
    init = init_iterate(form, batch=1, dtype=torch.float64, device=device,
                        x_traj=np.tile(x0, (form.N + 1, 1)))
    solve = make_diff_solver(form, SqpOpts(max_iter=50))

    # the stage-10 control: away from the |u| <= 80 bound, so its
    # sensitivity is informative (at an active bound it would be zero)
    def control_10(d):
        _, u = solve(d, init)
        return u[0, 10, 0]

    lb_0 = data.lb_0.clone().requires_grad_()
    ub_0 = data.ub_0.clone().requires_grad_()
    u10 = control_10(data.replace(lb_0=lb_0, ub_0=ub_0))
    u10.backward()
    # the gradient of u10 with respect to the measured x0 (lbx_0 = ubx_0)
    g_x0 = (lb_0.grad + ub_0.grad)[0, :4].cpu().numpy()
    print("u10 =", float(u10.detach()))
    print("du10/dx0 =", g_x0)

    # against a finite difference on one entry
    eps = 1e-5
    with torch.no_grad():
        e = torch.zeros_like(data.lb_0)
        e[0, 1] = eps
        fd = (float(control_10(data.replace(lb_0=data.lb_0 + e,
                                            ub_0=data.ub_0 + e)))
              - float(u10.detach())) / eps
    print("finite-difference check (entry 1):", fd, "vs", g_x0[1])
    assert abs(fd - g_x0[1]) < 1e-2 * max(1.0, abs(g_x0[1]))
    return g_x0


if __name__ == "__main__":
    main(_example_env.device_arg(__doc__))
