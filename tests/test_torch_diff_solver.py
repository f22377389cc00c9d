"""PyTorch port, the differentiable solver (`ocp_nlp/sensitivity.py:
make_diff_solver`, a torch.autograd.Function whose backward is one
KktFactor and adjoint_sensitivity) against the JAX package's custom_vjp
in float64 on the CPU, on the parametric pendulum of
tests/test_sensitivity.py.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.builder import data_to_jax
from acados_tpu_torch.ocp_nlp import sensitivity as sens
from acados_tpu_torch.testing import param_pendulum_ocp
from test_sensitivity import make_param_ocp

torch.set_num_threads(1)

N = 20


def test_diff_solver_gradient_matches_jax():
    """The gradient of 0.5 |u_0|^2 with respect to every stage's p
    through make_diff_solver (torch.autograd, one KktFactor + adjoint in
    the backward) against jax.grad through the JAX custom_vjp; both
    solve from the same initial iterate."""
    from acados_tpu.interface.builder import build_ocp as jax_build_ocp
    from acados_tpu.interface.solver import _sqp_opts_from as jax_opts
    from acados_tpu.ocp_nlp.sensitivity import \
        make_diff_solver as jax_make_diff_solver
    from acados_tpu.ocp_nlp.sqp import init_iterate as jax_init_iterate
    from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
    from acados_tpu_torch.interface.solver import _sqp_opts_from
    from acados_tpu_torch.ocp_nlp.sqp import init_iterate
    x_traj = np.tile(np.array([0.0, np.pi / 2, 0.0, 0.0]), (N + 1, 1))

    jocp = make_param_ocp()
    form, data_np, _ = jax_build_ocp(jocp)
    solve_j = jax_make_diff_solver(form, jax_opts(jocp))
    data = data_to_jax(data_np, jnp.float64)
    init = jax_init_iterate(form, jnp.float64, x_traj=x_traj)
    ref = jax.grad(lambda p: 0.5 * jnp.sum(
        solve_j(data.replace(p=p), init)[1][0] ** 2))(data.p)

    tocp = param_pendulum_ocp()
    tform, tdata_np, _ = build_ocp(tocp)
    solve_t = sens.make_diff_solver(tform, _sqp_opts_from(tocp))
    tdata = data_to_torch(tdata_np, torch.float64, "cpu", batch=2)
    tinit = init_iterate(tform, 2, torch.float64, "cpu", x_traj=x_traj)
    p = tdata.p.clone().requires_grad_()
    xs, us = solve_t(tdata.replace(p=p), tinit)
    (g,) = torch.autograd.grad(0.5 * (us[:, 0] ** 2).sum(), p)
    ref = np.asarray(ref)
    for i in range(2):
        assert np.max(np.abs(g[i].numpy() - ref)) <= 1e-9 * np.max(
            np.abs(ref))
    # the warm start gets a zero gradient
    x0 = tinit.x.clone().requires_grad_()
    _, us = solve_t(tdata, tinit.replace(x=x0))
    (gx,) = torch.autograd.grad(us.sum(), x0)
    assert not gx.any()
