"""PyTorch port, the Hessian regularizations (ocp_nlp/regularize.py):
NO_REGULARIZE, MIRROR, PROJECT, GLM, CONVEXIFY and PROJECT_REDUC_HESS
against jax.vmap of the JAX package's regularize_qp on seeded indefinite
OCP-QPs, and the nonconvex EXTERNAL-cost OCPs of tests/test_regularize.py
solved with the exact Hessian and MERIT_BACKTRACKING through both
packages (float64, CPU).

The eigenvalue methods are compared on the regularized matrices
V diag(w) V', never on V (eigenvectors are defined up to sign and
order): within 1e-9 of the largest entry of each block, at the floors
eps = 1e-4 (the reference's default) and 1e-6. PROJECT_REDUC_HESS solves
with Muu + dR + eps I, whose smallest eigenvalue is about 2 eps where
the lift acts, so one rounding step of its inputs moves the JAX
package's own result by up to ~4e-9 at eps = 1e-6: it is held to 4x
that spread where it exceeds 1e-9.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.acados_ocp import AcadosModel as JModel
from acados_tpu.interface.acados_ocp import AcadosOcp as JOcp
from acados_tpu.ocp_nlp.regularize import regularize_qp as jax_regularize
from acados_tpu.ocp_qp import data as jdata
from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
from acados_tpu_torch.ocp_nlp.regularize import REG_METHODS, regularize_qp
from acados_tpu_torch.ocp_qp.data import OcpQp
from acados_tpu_torch.testing import random_qp_batch
from test_torch_globalization import (assert_same_solve, jax_solve,
                                      port_solve)

torch.set_num_threads(1)

QP_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg", "ug",
             "mask_l", "mask_u", "Zl", "Zu", "zl", "zu", "soft_mask")


def _indefinite_qps(seed):
    """random_qp_batch with the R blocks and Q_N negated (indefinite
    coupled blocks, as tests/test_regularize.py makes them) and an
    indefinite symmetric perturbation of every Q_k."""
    d = random_qp_batch(seed, B=4, N=6, nx=3, nu=2, nc=2)
    rng = np.random.default_rng(seed + 100)
    P = rng.normal(size=d["Q"].shape)
    d["Q"] = d["Q"] + 1.5 * (P + np.swapaxes(P, -1, -2))
    d["R"] = -d["R"]
    d["Q"][:, -1] = -d["Q"][:, -1]
    return d


def _blocks(qp):
    """The stage blocks [[Q_k, S_k'], [S_k, R_k]] (k < N) and Q_N."""
    Q, R, S = (np.asarray(getattr(qp, f)) for f in ("Q", "R", "S"))
    H = np.concatenate([
        np.concatenate([Q[:, :-1], np.swapaxes(S, -1, -2)], axis=-1),
        np.concatenate([S, R], axis=-1)], axis=-2)
    return H, Q[:, -1:]


def _gap(got, ref):
    """max |got - ref| / max |ref| per block, the largest over the batch."""
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    return float((np.abs(got - ref) / scale).max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("method", REG_METHODS)
def test_regularize_qp_matches_jax(method, seed):
    d = _indefinite_qps(seed)
    eps = 1e-4 if seed == 0 else 1e-6
    jax_reg = jax.jit(jax.vmap(lambda q: jax_regularize(q, method, eps)))
    ref = jax_reg(jdata.OcpQp(**{k: jnp.asarray(d[k]) for k in QP_FIELDS}))
    got = regularize_qp(OcpQp(**{k: torch.as_tensor(d[k])
                                 for k in QP_FIELDS}), method, eps)
    got = got.replace(**{f: getattr(got, f).numpy() for f in ("Q", "R",
                                                               "S")})
    bound = 1e-9
    if method == "PROJECT_REDUC_HESS":
        # the JAX package's own spread under one rounding step of the
        # matrices it reads
        rng = np.random.default_rng(seed)
        moved = {k: v * (1 + np.finfo(np.float64).eps * rng.choice(
            (-1.0, 1.0), v.shape)) if k in "QRSAB" else v
            for k, v in d.items()}
        ref_moved = jax_reg(jdata.OcpQp(**{k: jnp.asarray(moved[k])
                                           for k in QP_FIELDS}))
        spread = max(_gap(a, b) for a, b in zip(_blocks(ref_moved),
                                                _blocks(ref)))
        bound = max(bound, 4 * spread)
    for name, g, r in zip(("stage blocks", "Q_N"), _blocks(got),
                          _blocks(ref)):
        gap = _gap(g, r)
        assert gap <= bound, f"{method} {name}: {gap:.3e} > {bound:.3e}"
    if method in ("MIRROR", "PROJECT", "GLM"):
        # every block the QP sees has its smallest eigenvalue at eps or
        # above (up to rounding)
        for blk in _blocks(got):
            lo = np.linalg.eigvalsh(blk).min(axis=-1)
            assert np.all(lo >= eps - 1e-12 * np.abs(blk).max()), method


def test_unknown_method_raises():
    d = _indefinite_qps(0)
    with pytest.raises(ValueError, match="regularize_method"):
        regularize_qp(OcpQp(**{k: torch.as_tensor(d[k])
                               for k in QP_FIELDS}), "NOT_A_METHOD", 1e-4)


def _nonconvex_ocp(pkg, method, u_nonconvex=False):
    """tests/test_regularize.py:68-105 (x-nonconvex, -cos(3 x0)) and its
    u-nonconvex PROJECT_REDUC_HESS problem (:187-220), at N = 10, EXACT
    Hessian, MERIT_BACKTRACKING, float64, for either package."""
    lib = jnp if pkg == "jax" else torch
    cat = jnp.concatenate if pkg == "jax" else torch.cat
    ocp = JOcp() if pkg == "jax" else AcadosOcp()
    m = JModel() if pkg == "jax" else AcadosModel()
    m.name = "nonconvex"
    m.x, m.u = 2, 1
    m.f_expl_expr = lambda x, u: cat([x[1:2], u])
    if u_nonconvex:
        m.cost_expr_ext_cost = lambda x, u: (
            x @ x + 4.0 * (1.0 - lib.cos(2.0 * u[0])) + 0.05 * u[0] ** 2)
        m.cost_expr_ext_cost_e = lambda x: 5.0 * (x @ x)
    else:
        m.cost_expr_ext_cost = lambda x, u: (
            x[0] ** 2 + 0.1 * x[1] ** 2 + 1e-2 * u[0] ** 2
            + 2.0 * lib.cos(3.0 * x[0]))
        m.cost_expr_ext_cost_e = lambda x: x[0] ** 2 + 0.1 * x[1] ** 2
        ocp.constraints.idxbu = np.array([0])
        ocp.constraints.lbu = np.array([-10.0])
        ocp.constraints.ubu = np.array([10.0])
    ocp.model = m
    ocp.cost.cost_type = "EXTERNAL"
    ocp.cost.cost_type_e = "EXTERNAL"
    ocp.constraints.x0 = np.array([1.5, 0.0])
    so = ocp.solver_options
    so.N_horizon = 10
    so.tf = 1.0
    so.hessian_approx = "EXACT"
    so.nlp_solver_type = "SQP"
    so.nlp_solver_max_iter = 100
    so.globalization = "MERIT_BACKTRACKING"
    so.regularize_method = method
    so.dtype = "float64"
    return ocp


# x0 per instance around [1.5, 0]: the x-nonconvex problem's and the
# u-nonconvex one's (whose QPs fail at some of the former under
# PROJECT_REDUC_HESS, as GLM stalls at some of the latter, in both
# packages)
X0S = (np.array([1.5, 0.0])
       + np.random.default_rng(5).normal(0.0, 0.1, (3, 2)))
X0S_U = (np.array([1.5, 0.0])
         + np.random.default_rng(1).normal(0.0, 0.2, (3, 2)))


@pytest.mark.parametrize("method,u_nonconvex", [
    ("MIRROR", False), ("PROJECT", False), ("GLM", False),
    ("CONVEXIFY", False), ("PROJECT_REDUC_HESS", True)])
def test_nonconvex_ocp_matches_jax(method, u_nonconvex):
    """Every instance converges (status 0) in both packages with equal
    sqp_iter, qp_iter_total, QP columns and step lengths, iterates within
    1e-9."""
    data, init, it_ref, st_ref = jax_solve(
        _nonconvex_ocp("jax", method, u_nonconvex),
        X0S_U if u_nonconvex else X0S)
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    it, st = port_solve(_nonconvex_ocp("torch", method, u_nonconvex), data,
                        init)
    assert_same_solve(it, st, it_ref, st_ref, method)
