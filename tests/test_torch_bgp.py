"""PyTorch port, BGP constraint rows phi(r(x, u)) (ocp_nlp/formulation.py,
ocp_nlp/linearize.py, interface/builder.py), against the JAX package
(float64, CPU), after tests/test_formulations.py:35-100: the obstacle as
BGP rows solved by WFQP against the same obstacle as BGH rows and against
the JAX package's BGP solve, the soft BGP obstacle, and the
linearization's outer-curvature term Jr' phi'' Jr at a seeded iterate,
weighted by the phi rows' upper multipliers only.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.interface.builder import data_to_jax
from acados_tpu.ocp_nlp.linearize import NlpIterate as JNlpIterate
from acados_tpu.ocp_nlp.linearize import build_static_rows as jax_rows
from acados_tpu.ocp_nlp.linearize import linearize as jax_linearize
from acados_tpu.ocp_nlp.wfqp import make_wfqp_solver as jax_make_wfqp_solver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.ocp_nlp.linearize import build_static_rows, linearize
from acados_tpu_torch.ocp_nlp.wfqp import make_wfqp_solver
from acados_tpu_torch.utils.convert import iterate_from_numpy
from test_torch_globalization import assert_same_solve, jax_solve, port_solve
from test_torch_wfqp import MERIT, X0S_OBS, obstacle_ocp, zero_init

torch.set_num_threads(1)


def soft(ocp):
    """The BGP obstacle softened (tests/test_formulations.py:85-100): an
    L1 + L2 penalty on the path's phi row."""
    ocp.constraints.idxsphi = np.array([0])
    ocp.cost.Zl = ocp.cost.Zu = np.array([1.0])
    ocp.cost.zl = ocp.cost.zu = np.array([50.0])
    return ocp


def bgp_both(make_ocp):
    form = build_ocp(make_ocp("torch"))[0]
    init = zero_init(form, len(X0S_OBS))
    data, init, it_ref, st_ref = jax_solve(
        make_ocp("jax"), X0S_OBS, opts_update=MERIT, init=init,
        make=jax_make_wfqp_solver)
    it, st = port_solve(make_ocp("torch"), data, init, opts_update=MERIT,
                        make=make_wfqp_solver)
    return data, init, it, st, it_ref, st_ref


@pytest.fixture(scope="module")
def hard():
    return bgp_both(lambda pkg: obstacle_ocp(pkg, "bgp"))


def test_bgp_matches_jax(hard):
    _, _, it, st, it_ref, st_ref = hard
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    assert_same_solve(it, st, it_ref, st_ref, "BGP obstacle WFQP")
    assert np.all(np.sum(it["x"] ** 2, axis=-1) >= 1.0 - 1e-8)


def test_bgp_matches_bgh(hard):
    """The same NLP as BGH rows, both by the port's WFQP: the same
    solution (tests/test_formulations.py: within 1e-5)."""
    data, init, it, st = hard[:4]
    it_h, st_h = port_solve(obstacle_ocp("torch", "h"), data, init,
                            opts_update=MERIT, make=make_wfqp_solver)
    assert np.all(st["status"] == 0) and np.all(st_h["status"] == 0)
    np.testing.assert_allclose(it["x"], it_h["x"], atol=1e-5)


def test_soft_bgp_matches_jax():
    _, _, it, st, it_ref, st_ref = bgp_both(
        lambda pkg: soft(obstacle_ocp(pkg, "bgp")))
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    assert_same_solve(it, st, it_ref, st_ref, "soft BGP obstacle WFQP")
    # the penalty keeps the path close to the disc
    assert np.min(np.sum(it["x"] ** 2, axis=-1)) > 0.5


def test_bgp_hessian_term():
    """The linearization at a seeded iterate (random x, u and
    multipliers) against the JAX linearize: Q, R, S, q, r and the row
    Jacobians C, D within 1e-12. The Hessian's BGP term reads the phi
    rows' upper multipliers only: changing lam_l leaves Q, R, S as they
    are, changing lam_u of the phi rows moves them."""
    rng = np.random.default_rng(9)
    ocp = soft(obstacle_ocp("torch", "bgp", N_=4))
    form, dnp, _ = build_ocp(ocp)
    jform, _, _ = jax_build_ocp(soft(obstacle_ocp("jax", "bgp", N_=4)))
    N_, nc = form.N, form.nc
    it = dict(x=rng.normal(size=(N_ + 1, 2)), u=rng.normal(size=(N_, 2)),
              pi=rng.normal(size=(N_, 2)),
              lam_l=rng.uniform(0.1, 2.0, (N_ + 1, nc)),
              lam_u=rng.uniform(0.1, 2.0, (N_ + 1, nc)),
              sl=rng.uniform(0, 0.1, (N_ + 1, nc)),
              su=rng.uniform(0, 0.1, (N_ + 1, nc)))
    lm = jnp.asarray(0.0)
    ref = jax_linearize(jform, jax_rows(jform, jnp.float64),
                        data_to_jax(dnp, jnp.float64),
                        JNlpIterate(**{k: jnp.asarray(v)
                                       for k, v in it.items()}), lm)

    def port_qp(it_):
        return linearize(form, build_static_rows(form, torch.float64, "cpu"),
                         data_to_torch(dnp, torch.float64, "cpu", batch=1),
                         iterate_from_numpy({k: v[None] for k, v in
                                             it_.items()}, torch.float64,
                                            "cpu"),
                         torch.zeros((), dtype=torch.float64))

    qp = port_qp(it)
    for f in ("Q", "R", "S", "q", "r", "C", "D", "lg", "ug"):
        np.testing.assert_allclose(getattr(qp, f)[0].numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    moved_l = port_qp(dict(it, lam_l=it["lam_l"] + 1.0))
    moved_u = port_qp(dict(it, lam_u=it["lam_u"] + 1.0))
    for f in ("Q", "R", "S"):
        assert torch.equal(getattr(moved_l, f), getattr(qp, f)), f
    assert not torch.equal(moved_u.Q, qp.Q)
