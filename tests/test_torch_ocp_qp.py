"""PyTorch port, ocp_qp: batch-first Riccati and Riccati IPM against
`jax.vmap` of the JAX package's functions on seeded random QPs.

The port runs the batch in lockstep with a per-instance done mask; the
vmapped JAX while_loop freezes finished instances the same way, so the
per-instance iteration counts and statuses must be equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.ocp_qp import data as jdata
from acados_tpu.ocp_qp.ipm import IpmOpts as JIpmOpts
from acados_tpu.ocp_qp.ipm import solve_ocp_qp as jax_solve_ocp_qp
from acados_tpu.ocp_qp.riccati import riccati_factor as jax_factor
from acados_tpu.ocp_qp.riccati import riccati_solve as jax_rsolve
from acados_tpu_torch.ocp_qp import data as tdata
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
from acados_tpu_torch.ocp_qp.riccati import riccati_factor, riccati_solve
from acados_tpu_torch.testing import random_qp_batch

torch.set_num_threads(1)

QP_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg", "ug",
             "mask_l", "mask_u", "Zl", "Zu", "zl", "zu", "soft_mask")
SOL_FIELDS = ("x", "u", "pi", "lam_lg", "lam_ug", "t_lg", "t_ug", "sl", "su")


def to_jax(d):
    return jdata.OcpQp(**{k: jnp.asarray(d[k]) for k in QP_FIELDS})


def to_torch(d):
    return tdata.OcpQp(**{k: torch.as_tensor(d[k]) for k in QP_FIELDS})


def barrier_free_blocks(d):
    return [d[k] for k in ("Q", "R", "S", "A", "B")]


def test_riccati_factor_and_solve_match_vmap():
    d = random_qp_batch(0, B=8, N=10)
    Q, R, S, A, B = barrier_free_blocks(d)
    jf = jax.vmap(jax_factor)(*(jnp.asarray(a) for a in (Q, R, S, A, B)))
    tf = riccati_factor(*(torch.as_tensor(a) for a in (Q, R, S, A, B)))
    for f in ("P", "Luu", "K", "LP0"):
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)),
                                   rtol=0, atol=1e-11)
    rhs = (d["q"], d["r"], d["b"])
    jsol = jax.vmap(jax_rsolve)(jf, jnp.asarray(A), jnp.asarray(B),
                                *(jnp.asarray(a) for a in rhs))
    tsol = riccati_solve(tf, torch.as_tensor(A), torch.as_tensor(B),
                         *(torch.as_tensor(a) for a in rhs))
    for a, b in zip(tsol, jsol):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-11)


def _solve_both(d, x0_fixed, warm=None, iter_max=50):
    jopts, topts = JIpmOpts(iter_max=iter_max), IpmOpts(iter_max=iter_max)
    jsolve = jax.jit(jax.vmap(
        lambda qp, w: jax_solve_ocp_qp(qp, jopts, warm=w,
                                       x0_fixed=x0_fixed)))
    jwarm = None if warm is None else jdata.OcpQpSol(
        **{k: jnp.asarray(warm[k]) for k in SOL_FIELDS})
    twarm = None if warm is None else tdata.OcpQpSol(
        **{k: torch.tensor(warm[k]) for k in SOL_FIELDS})
    jsol, jinfo = jsolve(to_jax(d), jwarm)
    tsol, tinfo = solve_ocp_qp(to_torch(d), topts, warm=twarm,
                               x0_fixed=x0_fixed)
    return jsol, jinfo, tsol, tinfo


def _assert_same(jsol, jinfo, tsol, tinfo, tol=1e-9):
    np.testing.assert_array_equal(tinfo.num_iter.numpy(),
                                  np.asarray(jinfo.num_iter))
    np.testing.assert_array_equal(tinfo.status.numpy(),
                                  np.asarray(jinfo.status))
    for f in SOL_FIELDS:
        np.testing.assert_allclose(getattr(tsol, f).numpy(),
                                   np.asarray(getattr(jsol, f)),
                                   rtol=0, atol=tol, err_msg=f)


@pytest.mark.parametrize("x0_fixed", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_ipm_cold_matches_vmap(x0_fixed, soft):
    """x0_fixed=False solves x0 as a free variable from P_0; x0_fixed
    eliminates the x0 rows."""
    d = random_qp_batch(1 + soft, B=8, N=8, soft=soft, x0_rows=x0_fixed)
    jsol, jinfo, tsol, tinfo = _solve_both(d, x0_fixed)
    assert np.all(np.asarray(jinfo.status) == 0)
    _assert_same(jsol, jinfo, tsol, tinfo)


@pytest.mark.parametrize("x0_fixed", [False, True])
def test_ipm_warm_start_matches_vmap(x0_fixed):
    """Warm start from the solution of a perturbed QP (the auto
    complementarity cap path of _init_iterate)."""
    d = random_qp_batch(3, B=8, N=8, x0_rows=x0_fixed)
    jsol0, _, _, _ = _solve_both(d, x0_fixed)
    warm = {k: np.asarray(getattr(jsol0, k)) for k in SOL_FIELDS}
    d2 = dict(d, q=d["q"] + 0.05 * np.random.default_rng(4).normal(
        size=d["q"].shape))
    jsol, jinfo, tsol, tinfo = _solve_both(d2, x0_fixed, warm=warm)
    assert np.all(np.asarray(jinfo.status) == 0)
    _assert_same(jsol, jinfo, tsol, tinfo)


def test_lockstep_freezes_early_finishers():
    """One instance needs many more IPM iterations than the rest: its
    softened rows are shifted far from where the dynamics can reach. The
    early finishers are frozen bit for bit once done (stopping the batch
    when the last of them is done gives the same bits as running on), and
    every instance's num_iter equals jax.vmap(solve_ocp_qp)'s."""
    slow = 5
    d = random_qp_batch(10, B=8, N=8, soft=True)
    d["lg"][slow, :, 4:] += 200.0
    d["ug"][slow, :, 4:] += 200.0
    jsol, jinfo, tsol, tinfo = _solve_both(d, x0_fixed=True)
    _assert_same(jsol, jinfo, tsol, tinfo)
    assert np.all(tinfo.status.numpy() == 0)
    iters = tinfo.num_iter.numpy()
    early = np.arange(8) != slow
    assert iters[slow] >= iters[early].max() + 8, iters
    cut = int(iters[early].max())
    tsol_cut, tinfo_cut = solve_ocp_qp(to_torch(d), IpmOpts(iter_max=cut),
                                       x0_fixed=True)
    np.testing.assert_array_equal(tinfo_cut.num_iter.numpy()[early],
                                  iters[early])
    assert tinfo_cut.num_iter.numpy()[slow] == cut
    for f in SOL_FIELDS:
        np.testing.assert_array_equal(getattr(tsol_cut, f).numpy()[early],
                                      getattr(tsol, f).numpy()[early],
                                      err_msg=f)


def test_zero_qp_shapes():
    qp = tdata.zero_qp(tdata.OcpQpDims(N=5, nx=3, nu=2, nc=4), batch=2)
    assert qp.Q.shape == (2, 6, 3, 3) and qp.D.shape == (2, 5, 4, 2)
    assert qp.dims == tdata.OcpQpDims(N=5, nx=3, nu=2, nc=4)


def test_ipm_x0_free_nx14_factors_P0_through_chol_any(monkeypatch):
    """nx = 14 > 12: the free-initial-state Riccati solve factors P_0 with
    chol_any (the kernel K2 on the card, its plain version here), once
    per lockstep IPM round, as the JAX package takes its Pallas Cholesky
    there on the TPU; iterations, statuses and solution equal
    jax.vmap(solve_ocp_qp)'s."""
    from acados_tpu_torch.ocp_qp import riccati
    calls = []
    orig = riccati.chol_any

    def spy(H):
        calls.append(tuple(H.shape))
        return orig(H)

    monkeypatch.setattr(riccati, "chol_any", spy)
    d = random_qp_batch(12, B=8, N=6, nx=14, nu=2, x0_rows=False)
    jsol, jinfo, tsol, tinfo = _solve_both(d, x0_fixed=False)
    assert np.all(np.asarray(jinfo.status) == 0)
    np.testing.assert_array_equal(tinfo.num_iter.numpy(),
                                  np.asarray(jinfo.num_iter))
    np.testing.assert_array_equal(tinfo.status.numpy(),
                                  np.asarray(jinfo.status))
    for f in SOL_FIELDS:   # relative 1e-9: |pi| reaches ~4 at nx = 14
        ref = np.asarray(getattr(jsol, f))
        gap = np.abs(getattr(tsol, f).numpy() - ref) / (1 + np.abs(ref))
        assert gap.max() <= 1e-9, (f, gap.max())
    assert calls == [(8, 14, 14)] * int(tinfo.num_iter.max())
