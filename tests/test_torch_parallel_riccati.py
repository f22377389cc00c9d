"""PyTorch port, the parallel-in-time Riccati (ocp_qp/riccati.py
parallel_*, utils/scan.py) and the IPM's parallel_riccati and abs_form
(SPEED_ABS) options, against the JAX package on seeded inputs made with
numpy, in float64 on the CPU.

The scan combines in jax.lax.associative_scan's tree, so the factor and
solve agree with the JAX functions (and with the port's sequential ones)
to rounding; the IPM with either option runs the same iterations per
instance as jax.vmap of the JAX solver.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.batch_solver import AcadosOcpBatchSolver as JaxBatch
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_nlp.sqp import make_sqp_solver as jax_make_sqp
from acados_tpu.ocp_qp import data as jdata
from acados_tpu.ocp_qp import riccati as jric
from acados_tpu.ocp_qp.ipm import IpmOpts as JIpmOpts
from acados_tpu.ocp_qp.ipm import solve_ocp_qp as jax_solve_ocp_qp
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_qp import data as tdata
from acados_tpu_torch.ocp_qp import riccati
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
from acados_tpu_torch.testing import random_qp_batch, rti_batch
from acados_tpu_torch.utils.scan import associative_scan

torch.set_num_threads(1)

QP_FIELDS = tuple(tdata.OcpQp.__dataclass_fields__)
SOL_FIELDS = tuple(tdata.OcpQpSol.__dataclass_fields__)
ITERATE = ("x", "u", "pi", "lam_l", "lam_u", "sl", "su")


def _close(got, ref, err_msg="", rel=1e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (err_msg, got.shape, ref.shape)
    gap = np.max(np.abs(got - ref) / (1 + np.abs(ref)), initial=0.0)
    assert gap <= rel, f"{err_msg}: {gap:.3e} > {rel:g}"


def _counting_linsolve(monkeypatch):
    """Record the (B, m) of every linsolve call of the parallel factor."""
    calls = []
    orig = riccati.linsolve
    monkeypatch.setattr(riccati, "linsolve", lambda M, X: (
        calls.append(tuple(M.shape[:2])), orig(M, X))[1])
    return calls


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", list(range(1, 10)) + [21, 129])
def test_associative_scan_matches_jax(n, reverse):
    """A non-commutative combine (2 x 2 matrix products) and one that is
    not even associative (tanh of the product), whose result depends on
    the tree the elements are combined in: both agree with
    jax.lax.associative_scan along axis 1 of a batch of 3, forward and
    reverse, and fn never sees an empty batch."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(3, n, 2, 2)) / np.sqrt(2)
    sizes = []

    def record(f):
        def fn(a, b):
            sizes.append(a[0].shape[1])
            return (f(a[0] @ b[0]),)
        return fn

    for f, jf in ((lambda m: m, lambda m: m), (torch.tanh, jnp.tanh)):
        ref = jax.lax.associative_scan(lambda a, b: jf(a @ b),
                                       jnp.asarray(X), reverse=reverse,
                                       axis=1)
        (got,) = associative_scan(record(f), (torch.as_tensor(X),),
                                  reverse=reverse, dim=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-13)
    assert all(m > 0 for m in sizes)


def _random_lq(N, nx=4, nu=2, B=3, seed=0):
    """tests/test_parallel_riccati.py's random_lq, a batch of B."""
    rng = np.random.default_rng(seed)

    def spd(*s):
        M = rng.normal(0, 1, s + (s[-1],))
        return M @ np.swapaxes(M, -1, -2) + np.eye(s[-1])

    return dict(A=rng.normal(0, 0.4, (B, N, nx, nx)) + 0.8 * np.eye(nx),
                B=rng.normal(0, 0.5, (B, N, nx, nu)),
                Q=spd(B, N + 1, nx), R=spd(B, N, nu),
                S=rng.normal(0, 0.3, (B, N, nu, nx)),
                q=rng.normal(0, 1, (B, N + 1, nx)),
                r=rng.normal(0, 1, (B, N, nu)),
                b=rng.normal(0, 1, (B, N, nx)))


@pytest.mark.parametrize("N", [1, 2, 3, 17, 64, 128])
def test_parallel_factor_and_solve_match(N):
    """parallel_riccati_factor/solve against jax.vmap of the JAX
    functions and against the port's sequential riccati_factor/solve,
    with dx0 free and fixed (tests/test_parallel_riccati.py:40-53)."""
    d = _random_lq(N, seed=N)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    fp = riccati.parallel_riccati_factor(t["Q"], t["R"], t["S"], t["A"],
                                         t["B"])
    fs = riccati.riccati_factor(t["Q"], t["R"], t["S"], t["A"], t["B"])
    fj = jax.jit(jax.vmap(jric.parallel_riccati_factor))(
        j["Q"], j["R"], j["S"], j["A"], j["B"])
    for f in ("P", "Luu", "K", "LP0"):
        _close(getattr(fp, f), getattr(fj, f), f)
        _close(getattr(fp, f), getattr(fs, f), f + " (sequential)")
    for dx0 in (None, np.ones((3, 4))):
        args = (t["A"], t["B"], t["q"], t["r"], t["b"])
        op = riccati.parallel_riccati_solve(
            fp, *args, dx0=None if dx0 is None else torch.as_tensor(dx0))
        os_ = riccati.riccati_solve(
            fs, *args, dx0=None if dx0 is None else torch.as_tensor(dx0))
        oj = jax.jit(jax.vmap(
            jric.parallel_riccati_solve,
            in_axes=(0,) * 6 + (None if dx0 is None else 0,)))(
            fj, j["A"], j["B"], j["q"], j["r"], j["b"],
            None if dx0 is None else jnp.asarray(dx0))
        for name, a, b, c in zip(("dx", "du", "dpi"), op, oj, os_):
            _close(a, b, name)
            _close(a, c, name + " (sequential)")


@pytest.mark.parametrize("N,levels", [
    (128, [64, 32, 16, 8, 4, 2, 1, 1, 3, 7, 15, 31, 64]),
    (20, [10, 5, 2, 1, 2, 4, 10])])
def test_linsolve_once_a_nonempty_combine(N, levels, monkeypatch):
    """One linsolve call (one K1 launch on the card, at (B m, nx, nx))
    for each non-empty combine of the factor: 13 at N = 128, 7 at
    N = 20, in the recursion's order (the reduce combines down, then the
    even combines up; the even combine of the 2-element level is empty
    and makes no call). The solve's affine scans make none."""
    calls = _counting_linsolve(monkeypatch)
    d = _random_lq(N, B=2, seed=1)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    f = riccati.parallel_riccati_factor(t["Q"], t["R"], t["S"], t["A"],
                                        t["B"], factor_p0=False)
    assert calls == [(2, m) for m in levels]
    assert f.LP0 is None
    riccati.parallel_riccati_solve(f, t["A"], t["B"], t["q"], t["r"],
                                   t["b"], dx0=t["q"][:, 0])
    assert len(calls) == len(levels)


def _jax_ipm(d, x0_fixed, moved=0, **kw):
    """jax.vmap of the JAX IPM on the batch d (moved > 0: on d's data
    moved by one rounding step, up or down at random in every entry, the
    draw seeded by `moved`)."""
    rng = np.random.default_rng(moved)
    step = lambda k, v: v if moved == 0 or k.startswith(("mask", "soft")) \
        else v * (1 + np.finfo(np.float64).eps
                  * rng.choice((-1.0, 1.0), v.shape))
    return jax.jit(jax.vmap(lambda q: jax_solve_ocp_qp(
        q, JIpmOpts(iter_max=50, **kw), x0_fixed=x0_fixed)))(
        jdata.OcpQp(**{k: jnp.asarray(step(k, d[k])) for k in QP_FIELDS}))


def _port_ipm(d, x0_fixed, **kw):
    return solve_ocp_qp(
        tdata.OcpQp(**{k: torch.as_tensor(d[k]) for k in QP_FIELDS}),
        IpmOpts(iter_max=50, **kw), x0_fixed=x0_fixed)


@pytest.mark.parametrize("option", ["parallel_riccati", "abs_form"])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("x0_fixed", [False, True])
def test_ipm_options_match_jax(option, soft, x0_fixed):
    """The IPM with parallel_riccati (both Newton solves through the
    parallel factor and solve) or abs_form (one Newton solve an
    iteration toward sigma_abs * mu, no predictor) on random hard and
    soft QPs with x0 free or eliminated: equal iteration counts and
    statuses, every solution field within 1e-9. Batches of seed 2: on
    those of seeds 1 and 3 the parallel factor's conditioning makes the
    JAX package's own outcome change under one rounding step of the
    data (the next test)."""
    d = random_qp_batch(2, B=6, N=8, soft=soft, x0_rows=x0_fixed)
    jsol, jinfo = _jax_ipm(d, x0_fixed, **{option: True})
    tsol, tinfo = _port_ipm(d, x0_fixed, **{option: True})
    assert np.all(np.asarray(jinfo.status) == 0)
    np.testing.assert_array_equal(tinfo.num_iter.numpy(),
                                  np.asarray(jinfo.num_iter))
    np.testing.assert_array_equal(tinfo.status.numpy(),
                                  np.asarray(jinfo.status))
    for f in SOL_FIELDS:
        _close(getattr(tsol, f).numpy(), getattr(jsol, f), f)


@pytest.mark.parametrize("seed,soft,x0_fixed", [
    (1, False, False), (1, True, False), (3, False, False),
    (3, False, True)])
def test_parallel_ipm_where_jax_is_unsettled(seed, soft, x0_fixed):
    """As the barrier weights of active rows grow (Qb ~ 1e13 at the last
    iterations), the parallel factor's P parts from the sequential one by
    ~1e-16 x max Qb (I + C_i J_j ill-conditioned), the Cholesky of
    Huu may meet a matrix that is no longer positive definite, and the
    IPM stops with status 1 (NaN) or one iteration later. On these
    batches the JAX package's own statuses or iteration counts change
    under one rounding step of the data, so the port is not held to its
    exact iterations here. It is held to the solution instead: every
    status is 0 or 1, and where the port reports 0 its solution is that
    of its sequential IPM (held to the JAX package at 1e-9 by
    tests/test_torch_ocp_qp.py) within 1e-8."""
    d = random_qp_batch(seed, B=6, N=8, soft=soft, x0_rows=x0_fixed)
    outcome = lambda info: (np.asarray(info.status).tolist(),
                            np.asarray(info.num_iter).tolist())
    ref = outcome(_jax_ipm(d, x0_fixed, parallel_riccati=True)[1])
    assert any(outcome(_jax_ipm(d, x0_fixed, moved=m,
                                parallel_riccati=True)[1]) != ref
               for m in (1, 2, 3, 4, 5))
    tsol, tinfo = _port_ipm(d, x0_fixed, parallel_riccati=True)
    ssol, sinfo = _port_ipm(d, x0_fixed)
    assert np.all(sinfo.status.numpy() == 0)
    ok = tinfo.status.numpy() == 0
    assert np.all(ok | (tinfo.status.numpy() == 1)) and ok.sum() >= 4
    for f in ("x", "u", "pi", "lam_lg", "lam_ug"):
        _close(getattr(tsol, f).numpy()[ok], getattr(ssol, f).numpy()[ok],
               f, rel=1e-8)


def test_parallel_ipm_ill_conditioned_combine_fails_in_both():
    """The failure of the previous test where both packages meet it:
    instance 0 of this batch (x0 eliminated) stops at status 1 in the
    JAX package and in the port alike, after the same iterations, where
    the sequential factor converges (the other instances converge)."""
    d = random_qp_batch(5, B=6, N=10, x0_rows=True)
    _, jinfo = _jax_ipm(d, True, parallel_riccati=True)
    _, tinfo = _port_ipm(d, True, parallel_riccati=True)
    np.testing.assert_array_equal(tinfo.status.numpy(),
                                  np.asarray(jinfo.status))
    np.testing.assert_array_equal(tinfo.num_iter.numpy(),
                                  np.asarray(jinfo.num_iter))
    assert tinfo.status.tolist() == [1, 0, 0, 0, 0, 0]
    _, seq = _port_ipm({k: v[:1] for k, v in d.items()}, True)
    assert seq.status.tolist() == [0]


PENDULUM_X0S = (np.array([0.0, np.pi, 0.0, 0.0])
                + np.random.default_rng(0).normal(0.0, 0.05, (3, 4)))


def jax_rti_batch(ocp, x0s, opts_update=None, qp_opts_update=None):
    """The JAX package's batch solver set up as
    acados_tpu_torch.testing.rti_batch sets up the port's, with SqpOpts
    and IpmOpts fields replaced (bench.py's _build_rti opts_update and
    qp_opts_update)."""
    s = JaxBatch(ocp, len(x0s))
    for i, view in enumerate(s.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(s.N + 1):
            view.set(k, "x", x0s[i])
    s.opts = s.opts.replace(**(opts_update or {}))
    s.opts = s.opts.replace(qp_opts=s.opts.qp_opts.replace(
        **(qp_opts_update or {})))
    s._solve_fn = jax.jit(jax.vmap(jax_make_sqp(s.form, s.opts)))
    return s


def calls_agree(ours, ref, calls):
    """`calls` solves of both batches: equal statuses (all 0), SQP and QP
    iterations per instance, iterates within 1e-9."""
    for _ in range(calls):
        st, st_ref = ours.solve(), ref.solve()
        np.testing.assert_array_equal(st, st_ref)
        assert np.all(st == 0)
        np.testing.assert_array_equal(ours.get_stats("sqp_iter"),
                                      np.asarray(ref._stats.sqp_iter))
        np.testing.assert_array_equal(ours.get_stats("qp_iter"),
                                      np.asarray(ref._stats.qp_iter_total))
        it = ours._host_iterate()
        for f in ITERATE:
            _close(it[f], ref._iterate[f], f)


@pytest.mark.parametrize("solver_type,calls", [("SQP", 1),
                                                ("SQP_RTI", 3)])
def test_pendulum_parallel_and_abs_form_match_jax(solver_type, calls):
    """The pendulum (N = 16, ERK, float64, B = 3) with parallel_riccati
    and abs_form together, SQP to convergence (tests/
    test_parallel_riccati.py:55) and three RTI calls: equal statuses,
    SQP and QP iterations per instance, iterates within 1e-9."""
    kw = dict(N=16, dtype="float64", nlp_solver_type=solver_type)
    upd = dict(parallel_riccati=True, abs_form=True)
    ours = rti_batch(make_pendulum_ocp(**kw), PENDULUM_X0S, "cpu",
                     qp_opts_update=upd)
    ref = jax_rti_batch(jax_pendulum_ocp(**kw), PENDULUM_X0S,
                        qp_opts_update=upd)
    assert ours.opts.qp_opts.parallel_riccati and ours.opts.qp_opts.abs_form
    calls_agree(ours, ref, calls)


def test_long_horizon_rti_parallel_matches_sequential(monkeypatch):
    """bench.py's long-horizon pendulum (N = 128, Tf = 1, ERK, SQP-RTI)
    at B = 4 in float64, three calls with parallel_riccati beside the
    plain sequential Riccati (the JAX package's compiles at N = 128 are
    held to the LQ functions above): equal statuses and QP iterations,
    iterates within 1e-9, and linsolve exactly 13 times the batch's
    largest qp_iter in every call."""
    calls = _counting_linsolve(monkeypatch)
    kw = dict(N=128, Tf=1.0, dtype="float64", nlp_solver_type="SQP_RTI")
    x0s = (np.array([0.0, np.pi, 0.0, 0.0])
           + np.random.default_rng(0).normal(0.0, 0.02, (4, 4)))
    par = rti_batch(make_pendulum_ocp(**kw), x0s, "cpu",
                    qp_opts_update=dict(parallel_riccati=True))
    seq = rti_batch(make_pendulum_ocp(**kw), x0s, "cpu")
    for _ in range(3):
        del calls[:]
        st = par.solve()
        assert len(calls) == 13 * int(par.get_stats("qp_iter").max())
        np.testing.assert_array_equal(st, seq.solve())
        assert np.all(st == 0)
        np.testing.assert_array_equal(par.get_stats("qp_iter"),
                                      seq.get_stats("qp_iter"))
        a, b = par._host_iterate(), seq._host_iterate()
        for f in ITERATE:
            _close(a[f], b[f], f)
