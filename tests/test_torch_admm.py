"""PyTorch port, the ADMM QP backend (ocp_qp/admm.py) and the QP backend
registry (ocp_qp/registry.py) with its SQP branch, against the JAX
package (tests/test_admm.py's cases) on seeded inputs made with numpy, in
float64 on the CPU.

ADMM runs the batch in lockstep with a per-instance iteration count,
residuals, rho scale and status; jax.vmap of the JAX package's
while_loop freezes finished instances the same way, so per-instance
iteration counts and statuses are equal and every solution field agrees
within 1e-9.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_qp import data as jdata
from acados_tpu.ocp_qp.admm import AdmmOpts as JAdmmOpts
from acados_tpu.ocp_qp.admm import solve_ocp_qp_admm as jax_admm
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_qp import admm
from acados_tpu_torch.ocp_qp import data as tdata
from acados_tpu_torch.ocp_qp.admm import AdmmOpts, solve_ocp_qp_admm
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
from acados_tpu_torch.ocp_qp.registry import (available_qp_backends,
                                              get_qp_backend,
                                              register_qp_backend)
from acados_tpu_torch.testing import random_qp_batch, rti_batch
from test_torch_parallel_riccati import (PENDULUM_X0S, calls_agree,
                                         jax_rti_batch)

torch.set_num_threads(1)

QP_FIELDS = tuple(tdata.OcpQp.__dataclass_fields__)
SOL_FIELDS = tuple(tdata.OcpQpSol.__dataclass_fields__)


def _close(got, ref, err_msg="", rel=1e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (err_msg, got.shape, ref.shape)
    gap = np.max(np.abs(got - ref) / (1 + np.abs(ref)), initial=0.0)
    assert gap <= rel, f"{err_msg}: {gap:.3e} > {rel:g}"


def to_torch(d):
    return tdata.OcpQp(**{k: torch.as_tensor(d[k]) for k in QP_FIELDS})


def _admm_both(d, **kw):
    jsol, jinfo = jax.jit(jax.vmap(lambda q: jax_admm(q, JAdmmOpts(**kw))))(
        jdata.OcpQp(**{k: jnp.asarray(d[k]) for k in QP_FIELDS}))
    tsol, tinfo = solve_ocp_qp_admm(to_torch(d), AdmmOpts(**kw))
    return jsol, jinfo, tsol, tinfo


def _assert_same(jsol, jinfo, tsol, tinfo):
    for f in ("num_iter", "status"):
        np.testing.assert_array_equal(getattr(tinfo, f).numpy(),
                                      np.asarray(getattr(jinfo, f)), f)
    for f in ("mu", "res_stat", "res_ineq"):
        _close(getattr(tinfo, f).numpy(), getattr(jinfo, f), f)
    for f in SOL_FIELDS:
        _close(getattr(tsol, f).numpy(), getattr(jsol, f), f)


@pytest.mark.parametrize("opts", [{}, dict(iter_max=3000, rho=1.0)],
                         ids=["default", "rho1"])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("x0_rows", [False, True])
def test_admm_matches_jax(x0_rows, soft, opts):
    """solve_ocp_qp_admm against jax.vmap of the JAX function on random
    hard and soft QPs, with and without x0 equality rows (OSQP's 1e3
    penalty boost): per-instance iteration counts (tens to ~180, with
    rho updates at 50, 100, 150) and statuses equal, the residuals and
    every solution field within 1e-9."""
    d = random_qp_batch(5 + soft, B=6, N=10, soft=soft, x0_rows=x0_rows)
    jsol, jinfo, tsol, tinfo = _admm_both(d, **opts)
    assert np.all(np.asarray(jinfo.status) == 0)
    _assert_same(jsol, jinfo, tsol, tinfo)


def test_admm_lockstep_stops_and_refactors_per_instance(monkeypatch):
    """A batch whose instances stop and update rho at different
    iterations: alone, each instance takes its own iteration count and
    its own number of Riccati factorizations; in the batch, every
    instance ends exactly as it does alone (frozen once done, the old
    factor kept where no update is due), and the batch refactors once
    for each iteration at which any active instance is due."""
    d = random_qp_batch(5, B=6, N=10, x0_rows=True)
    calls = []
    orig = admm.riccati_factor
    monkeypatch.setattr(admm, "riccati_factor", lambda *a, **k: (
        calls.append(a[0].shape[0]), orig(*a, **k))[1])
    tsol, tinfo = solve_ocp_qp_admm(to_torch(d))
    batch_calls = len(calls)
    alone = []
    for i in range(6):
        del calls[:]
        s, info = solve_ocp_qp_admm(to_torch({k: v[i:i + 1]
                                              for k, v in d.items()}))
        alone.append(len(calls))
        assert int(info.num_iter[0]) == int(tinfo.num_iter[i])
        assert int(info.status[0]) == int(tinfo.status[i]) == 0
        for f in SOL_FIELDS:
            _close(getattr(s, f).numpy()[0], getattr(tsol, f).numpy()[i],
                   f, rel=1e-12)
    iters = tinfo.num_iter.tolist()
    assert len(set(iters)) > 1 and len(set(alone)) > 1, (iters, alone)
    assert max(alone) <= batch_calls <= sum(a - 1 for a in alone) + 1


@pytest.mark.parametrize("iter_max", [1, 7, 50])
def test_admm_dynamics_exact_every_iterate(iter_max):
    """The structural property: the w-update meets the dynamics exactly
    at every iterate (only the inequality rows are split), whatever
    iteration the solve is stopped at."""
    d = random_qp_batch(7, B=4, N=10)
    sol, _ = solve_ocp_qp_admm(to_torch(d), AdmmOpts(iter_max=iter_max))
    x, u = sol.x.numpy(), sol.u.numpy()
    gap = (np.einsum("bkij,bkj->bki", d["A"], x[:, :-1])
           + np.einsum("bkij,bkj->bki", d["B"], u) + d["b"] - x[:, 1:])
    assert np.max(np.abs(gap)) < 1e-10


def test_admm_soft_rows_match_ipm():
    """Soft rows take the exact prox of the L1 + L2 slack penalty: at
    tight tolerances ADMM reaches the IPM's solution, whose slacks are
    eliminated in closed form (tests/test_admm.py::TestAdmmHonest::
    test_soft_rows_match_ipm), and it matches the JAX ADMM iteration for
    iteration."""
    d = random_qp_batch(8, B=3, N=6, nx=3, nu=2, nc=2, soft=True)
    kw = dict(iter_max=20000, rho=1.0, tol_prim=1e-8, tol_dual=1e-8)
    jsol, jinfo, tsol, tinfo = _admm_both(d, **kw)
    _assert_same(jsol, jinfo, tsol, tinfo)
    isol, iinfo = solve_ocp_qp(to_torch(d), IpmOpts(iter_max=60))
    assert np.all(iinfo.status.numpy() == 0)
    assert np.all(tinfo.status.numpy() == 0)
    for f in ("x", "u", "sl", "su"):
        np.testing.assert_allclose(getattr(tsol, f).numpy(),
                                   getattr(isol, f).numpy(), atol=5e-4,
                                   err_msg=f)
    assert float(tsol.sl.max()) > 1e-3   # the slacks are in play


def test_builtins_and_aliases():
    assert {"RICCATI_IPM", "ADMM"} <= set(available_qp_backends())
    assert get_qp_backend("PARTIAL_CONDENSING_HPIPM") is \
        get_qp_backend("RICCATI_IPM")
    assert get_qp_backend("FULL_CONDENSING_QPOASES") is \
        get_qp_backend("RICCATI_IPM")
    assert get_qp_backend("PARTIAL_CONDENSING_OSQP") is \
        get_qp_backend("ADMM")
    with pytest.raises(ValueError, match="unknown QP backend"):
        get_qp_backend("NO_SUCH_BACKEND")


def test_backends_take_ipm_opts():
    """The built-ins as the SQP calls them, (qp, IpmOpts, warm=): the IPM
    backend is solve_ocp_qp; the ADMM backend translates the IPM's
    tolerances (iter_max 500, floored at 2e-5) and ignores the warm
    start."""
    d = to_torch(random_qp_batch(9, B=3, N=6))
    opts = IpmOpts(tol_stat=1e-8, tol_ineq=1e-4)
    sol, info = get_qp_backend("RICCATI_IPM")(d, opts, warm=None)
    ref, rinfo = solve_ocp_qp(d, opts)
    assert torch.equal(info.num_iter, rinfo.num_iter)
    assert torch.equal(sol.x, ref.x)
    sol, info = get_qp_backend("ADMM")(d, opts, warm=ref)
    ref, rinfo = solve_ocp_qp_admm(d, AdmmOpts(iter_max=500, tol_prim=1e-4,
                                               tol_dual=2e-5))
    assert torch.equal(info.num_iter, rinfo.num_iter)
    assert torch.equal(sol.x, ref.x)


def test_admm_rti_pendulum_matches_jax():
    """bench.py's bench_admm_backend variant at B = 3 in float64: the
    pendulum ERK SQP-RTI (N = 20) with qp_solver_name="ADMM" (no x0
    elimination: it needs the Riccati IPM), three warm calls: equal
    statuses and ADMM iterations per instance, iterates within 1e-9."""
    kw = dict(N=20, dtype="float64", nlp_solver_type="SQP_RTI")
    ours = rti_batch(make_pendulum_ocp(**kw), PENDULUM_X0S, "cpu",
                     opts_update=dict(qp_solver_name="ADMM"))
    ref = jax_rti_batch(jax_pendulum_ocp(**kw), PENDULUM_X0S,
                        opts_update=dict(qp_solver_name="ADMM"))
    calls_agree(ours, ref, 3)


def test_custom_backend_through_sqp():
    """A backend registered under a new name is what the SQP calls for
    every QP; here it wraps the Riccati IPM, so the solve equals the
    JAX package's SQP with the same registration."""
    from acados_tpu.ocp_qp.registry import get_qp_backend as jax_get
    from acados_tpu.ocp_qp.registry import \
        register_qp_backend as jax_register
    calls = []
    ipm, jipm = get_qp_backend("RICCATI_IPM"), jax_get("RICCATI_IPM")
    register_qp_backend("SPY", lambda qp, opts=None, warm=None: (
        calls.append(qp.q.shape[0]), ipm(qp, opts, warm=warm))[1])
    jax_register("SPY", lambda qp, opts=None, warm=None: jipm(
        qp, opts, warm=warm))
    kw = dict(N=16, dtype="float64", nlp_solver_type="SQP")
    ours = rti_batch(make_pendulum_ocp(**kw), PENDULUM_X0S, "cpu",
                     opts_update=dict(qp_solver_name="SPY"))
    ref = jax_rti_batch(jax_pendulum_ocp(**kw), PENDULUM_X0S,
                        opts_update=dict(qp_solver_name="SPY"))
    calls_agree(ours, ref, 1)
    # one QP a lockstep round, the round that finds the last instance
    # converged included
    assert set(calls) == {3}
    assert len(calls) == int(ours.get_stats("sqp_iter").max()) + 1
