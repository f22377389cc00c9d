"""PyTorch port, the two other BASELINE models: the quadrotor (config 2,
nx = 9, nu = 4, soft bx rows) and the race car (config 3, nx = 6, nu = 2,
nonlinear h rows with soft rows), both ERK SQP-RTI. Each OCP built by
both packages gives the same data dict, and a float64 RTI batch as
bench.py's bench_quadrotor_rti / bench_race_car_rti set it up (x0
spreads 0.05 and 0.01 from seed 0) matches jax.vmap of the JAX solver.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.models.quadrotor import make_quadrotor_ocp as jax_quad_ocp
from acados_tpu.models.race_car import make_race_car_ocp as jax_car_ocp
from acados_tpu_torch.interface.builder import build_ocp
from acados_tpu_torch.models import make_quadrotor_ocp, make_race_car_ocp
from acados_tpu_torch.testing import rti_batch

torch.set_num_threads(1)

# (port builder, JAX builder, x0 center, x0 spread, OCP keywords) as in
# bench.py:524-555
MODELS = {
    "quadrotor": (make_quadrotor_ocp, jax_quad_ocp, np.zeros(9), 0.05,
                  dict(N=20)),
    "race_car": (make_race_car_ocp, jax_car_ocp, np.zeros(6), 0.01,
                 dict(N=30, Tf=0.6)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ocp_data_matches_jax(name):
    ours, ref = MODELS[name][:2]
    kw = MODELS[name][4]
    form, data, _ = build_ocp(ours(dtype="float64", **kw))
    jform, jdata, _ = jax_build_ocp(ref(dtype="float64", **kw))
    assert (form.nx, form.nu, form.nc, form.N) == (jform.nx, jform.nu,
                                                   jform.nc, jform.N)
    assert form.con.soft_rows == jform.con.soft_rows
    assert data.keys() == jdata.keys()
    for k in data:
        np.testing.assert_array_equal(data[k], np.asarray(jdata[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rti_batch_matches_jax_float64(name):
    """B = 4, 3 RTI calls: equal statuses, sqp_iter and qp_iter per
    instance, x, u and pi within 1e-9 relative."""
    ours, ref, center, sigma, kw = MODELS[name]
    solve_batch, data, it, _, form, _ = bench._build_rti(
        ref, center, sigma, 4, jnp.float64, seed=0, dtype="float64", **kw)
    x0s = np.asarray(data.lb_0, np.float64)[:, :form.nx]
    solver = rti_batch(ours(dtype="float64", **kw), x0s, "cpu")
    for _ in range(3):
        it, stats = solve_batch(data, it)
        status = solver.solve()
        np.testing.assert_array_equal(status, np.asarray(stats.status))
        np.testing.assert_array_equal(solver.get_stats("sqp_iter"),
                                      np.asarray(stats.sqp_iter))
        np.testing.assert_array_equal(solver.get_stats("qp_iter"),
                                      np.asarray(stats.qp_iter_total))
        for f in ("x", "u", "pi"):
            r = np.asarray(getattr(it, f))
            got = getattr(solver._it_dev, f).numpy()
            assert np.all(np.abs(got - r) <= 1e-9 * (1 + np.abs(r))), f
    assert np.all(status == 0)
