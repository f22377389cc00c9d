"""PyTorch port, the QP front-ends: partial condensing
(ocp_qp/condensing.py), its branch of ocp_qp/xcond.py, QP scaling
(ocp_qp/qpscaling.py) and the SQP's QP dispatch, against the JAX
package's functions (vmapped over the batch) and its batch solver, on
seeded inputs made with numpy, in float64 on the CPU.

Where x0 stays a variable held by barrier rows, the rows' multipliers
are ill-determined (tests/test_torch_dense_qp.py's docstring); the QP
cases here therefore either free x0 (no x0 rows) or eliminate it through
the condensing (x0_fixed), and hold every field at a relative gap of
1e-9 with equal per-instance iteration counts and statuses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.batch_solver import AcadosOcpBatchSolver as JaxBatch
from acados_tpu.models.chain_mass import make_chain_mass_ocp as jax_chain_ocp
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_qp import condensing as jcond
from acados_tpu.ocp_qp import data as jdata
from acados_tpu.ocp_qp import qpscaling as jscal
from acados_tpu.ocp_qp.ipm import IpmOpts as JIpmOpts
from acados_tpu.ocp_qp.xcond import solve_ocp_qp_xcond as jax_xcond
from acados_tpu_torch.interface.batch_solver import AcadosOcpBatchSolver
from acados_tpu_torch.models.chain_mass import make_chain_mass_ocp
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.sqp import use_x0_elimination
from acados_tpu_torch.ocp_qp import condensing as tcond
from acados_tpu_torch.ocp_qp import data as tdata
from acados_tpu_torch.ocp_qp import qpscaling as tscal
from acados_tpu_torch.ocp_qp import riccati
from acados_tpu_torch.ocp_qp.ipm import IpmOpts
from acados_tpu_torch.ocp_qp.xcond import cond_x0_rows, solve_ocp_qp_xcond
from acados_tpu_torch.testing import random_qp_batch

torch.set_num_threads(1)

QP_FIELDS = tuple(tdata.OcpQp.__dataclass_fields__)
SOL_FIELDS = tuple(tdata.OcpQpSol.__dataclass_fields__)
NX, NU, NC = 3, 2, 2
REL = 1e-9


def to_jax(d, cls=jdata.OcpQp):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def to_torch(d, cls=tdata.OcpQp):
    return cls(**{k: torch.as_tensor(v) for k, v in d.items()})


def _close(got, ref, err_msg="", rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (err_msg, got.shape, ref.shape)
    gap = np.max(np.abs(got - ref) / (1 + np.abs(ref)), initial=0.0)
    assert gap <= rel, f"{err_msg}: {gap:.3e} > {rel:g}"


def _fields_close(tobj, jobj, fields, err=""):
    for f in fields:
        _close(getattr(tobj, f).numpy(), getattr(jobj, f), f"{err}{f}")


def qp_batch(seed, N=12, B=4, soft=False, x0_rows=True, npath=None,
             nterm=None):
    """random_qp_batch with rows [x0 rows (nx), inequality rows (nc)].
    npath / nterm: path rows >= npath and terminal rows >= nterm masked
    off, so keep_rows = (nx + nc, npath, nterm) prunes only padding."""
    d = random_qp_batch(seed, B=B, N=N, nx=NX, nu=NU, nc=NC, soft=soft,
                        x0_rows=x0_rows)
    for key in ("mask_l", "mask_u"):
        if npath is not None:
            d[key][:, 1:N, npath:] = 0.0
        if nterm is not None:
            d[key][:, N, nterm:] = 0.0
    return d


def random_sol(rng, B, N, nx, nu, nc):
    """A primal-dual point of the given horizon (distances positive)."""
    n = lambda *s: rng.normal(size=(B,) + s)
    return dict(x=n(N + 1, nx), u=n(N, nu), pi=n(N, nx),
                lam_lg=n(N + 1, nc) ** 2, lam_ug=n(N + 1, nc) ** 2,
                t_lg=1 + n(N + 1, nc) ** 2, t_ug=1 + n(N + 1, nc) ** 2,
                sl=n(N + 1, nc) ** 2, su=n(N + 1, nc) ** 2)


@pytest.mark.parametrize("N2,soft,keep", [
    (3, False, None), (4, True, None), (12, False, None),
    (2, False, (5, 4, 5)), (6, True, (5, 4)), (4, False, (5, 3, 4))])
def test_partial_condense_expand_warm_match_jax(N2, soft, keep):
    """partial_condense's QP and cache, partial_expand of a random
    condensed point and condense_warm of a random full-horizon point."""
    npath = None if keep is None else keep[1]
    nterm = None if keep is None or len(keep) == 2 else keep[2]
    d = qp_batch(3 + N2, soft=soft, npath=npath, nterm=nterm)
    jqp, tqp = to_jax(d), to_torch(d)
    jc, jcache = jax.jit(jax.vmap(
        lambda q: jcond.partial_condense(q, N2, keep)))(jqp)
    tc, tcache = tcond.partial_condense(tqp, N2, keep)
    _fields_close(tc, jc, QP_FIELDS, "condensed ")
    _fields_close(tcache, jcache, ("Gams", "Phis", "gams"), "cache ")

    rng = np.random.default_rng(N2)
    M, ncb = 12 // N2, tc.lg.shape[-1]
    sol_c = random_sol(rng, 4, N2, NX, M * NU, ncb)
    jexp = jax.jit(jax.vmap(
        lambda q, c, s: jcond.partial_expand(q, c, s, keep)))(
        jqp, jcache, to_jax(sol_c, jdata.OcpQpSol))
    texp = tcond.partial_expand(tqp, tcache,
                                to_torch(sol_c, tdata.OcpQpSol), keep)
    _fields_close(texp, jexp, SOL_FIELDS, "expanded ")

    warm = random_sol(rng, 4, 12, NX, NU, NX + NC)
    jw = jax.jit(jax.vmap(lambda w: jcond.condense_warm(w, N2, keep)))(
        to_jax(warm, jdata.OcpQpSol))
    tw = tcond.condense_warm(to_torch(warm, tdata.OcpQpSol), N2, keep)
    _fields_close(tw, jw, SOL_FIELDS, "warm ")


@pytest.mark.parametrize("N2,sizes", [(3, None), (6, None),
                                      (4, (6, 6, 5, 3))])
def test_padding_to_blocks_matches_jax(N2, sizes):
    """Ragged blocks at N = 20: HPIPM's remainder rule and explicit
    block sizes, the padded QP, the lifted warm start and the
    restriction back."""
    N = 20
    assert tcond.hpipm_block_sizes(N, N2) == jcond.hpipm_block_sizes(N, N2)
    for a, b in zip(tcond._pad_maps(N, N2, sizes),
                    jcond._pad_maps(N, N2, sizes)):
        np.testing.assert_array_equal(a, b)
    d = qp_batch(20 + N2, N=N, soft=True)
    jp = jax.jit(jax.vmap(
        lambda q: jcond.pad_qp_to_blocks(q, N2, sizes)[0]))(
        to_jax(d))
    tp, maps = tcond.pad_qp_to_blocks(to_torch(d), N2, sizes)
    _fields_close(tp, jp, QP_FIELDS, "padded ")

    rng = np.random.default_rng(N2)
    warm = random_sol(rng, 4, N, NX, NU, NX + NC)
    jw = jax.vmap(lambda w: jcond.pad_warm_to_blocks(w, maps))(
        to_jax(warm, jdata.OcpQpSol))
    tw = tcond.pad_warm_to_blocks(to_torch(warm, tdata.OcpQpSol), maps)
    _fields_close(tw, jw, SOL_FIELDS, "padded warm ")

    Np = tp.dims.N
    sol_p = random_sol(rng, 4, Np, NX, NU, NX + NC)
    ju = jax.vmap(lambda s: jcond.unpad_sol(s, maps))(
        to_jax(sol_p, jdata.OcpQpSol))
    tu = tcond.unpad_sol(to_torch(sol_p, tdata.OcpQpSol), maps)
    _fields_close(tu, ju, SOL_FIELDS, "unpadded ")


def _xcond_both(d, warm=None, **kw):
    jopts, topts = JIpmOpts(iter_max=50), IpmOpts(iter_max=50)
    jw = None if warm is None else to_jax(warm, jdata.OcpQpSol)
    tw = None if warm is None else to_torch(warm, tdata.OcpQpSol)
    jsol, jinfo = jax.jit(jax.vmap(lambda q, w: jax_xcond(
        q, jopts, warm=w, **kw)))(to_jax(d), jw)
    tsol, tinfo = solve_ocp_qp_xcond(to_torch(d), topts, warm=tw, **kw)
    np.testing.assert_array_equal(tinfo.num_iter.numpy(),
                                  np.asarray(jinfo.num_iter))
    np.testing.assert_array_equal(tinfo.status.numpy(),
                                  np.asarray(jinfo.status))
    _fields_close(tsol, jsol, SOL_FIELDS)
    return tsol, tinfo.status.numpy()


@pytest.mark.parametrize("x0_fixed,N,soft,kw", [
    (False, 12, False, dict(cond_N=3)),
    (False, 12, True, dict(cond_N=4)),
    (False, 20, False, dict(cond_N=3)),
    (False, 20, True, dict(cond_N=6)),
    (False, 20, False, dict(cond_block_size=(6, 6, 5, 3))),
    (True, 12, False, dict(cond_N=4)),
    (True, 12, True, dict(cond_N=3, keep_rows=(5, 4))),
    (True, 20, False, dict(cond_N=6, keep_rows=(5, 4, 5))),
    (True, 20, True, dict(cond_N=4, cond_block_size=(6, 6, 5, 3))),
])
def test_xcond_partial_matches_jax(x0_fixed, N, soft, kw):
    """solve_ocp_qp_xcond's partial branch, uniform and ragged, with
    pruned rows, x0 free or eliminated through the condensing. In the
    soft case at N = 12, cond_N = 3, instance 3 stops at iter_max in both
    packages (status 2; uncondensed and at cond_N = 4 it converges in 12
    and 16 iterations): the reference's own behaviour, held as it is."""
    keep = kw.get("keep_rows")
    d = qp_batch(40 + N + 3 * soft, N=N, soft=soft, x0_rows=x0_fixed,
                 npath=None if keep is None else keep[1],
                 nterm=None if keep is None or len(keep) == 2 else keep[2])
    _, status = _xcond_both(d, x0_fixed=x0_fixed, **kw)
    stalled = (x0_fixed, N, soft, kw.get("cond_N")) == (True, 12, True, 3)
    np.testing.assert_array_equal(status, [0, 0, 0, 2] if stalled else 0)


@pytest.mark.parametrize("cond_N", [3, 6])
def test_xcond_partial_warm_start_matches_jax(cond_N):
    """A warm start carried through condense_warm (uniform) and
    pad_warm_to_blocks (ragged, N = 20, cond_N = 6): the solution of the
    unperturbed QP warm-starts a perturbed one."""
    N = 12 if cond_N == 3 else 20
    d = qp_batch(60 + cond_N, N=N, x0_rows=True)
    sol0, status = _xcond_both(d, cond_N=cond_N, x0_fixed=True)
    warm = {k: getattr(sol0, k).numpy() for k in SOL_FIELDS}
    d2 = dict(d, q=d["q"] + 0.05 * np.random.default_rng(cond_N).normal(
        size=d["q"].shape))
    _, status_warm = _xcond_both(d2, warm=warm, cond_N=cond_N,
                                 x0_fixed=True)
    assert np.all(status == 0) and np.all(status_warm == 0)


def test_cond_x0_rows_and_backend():
    """The x0 rows' positions after condensing, as the JAX package's
    function gives them; the condensed QPs (N = 12, cond_N = 3, x0 rows
    kept as equality rows) solved by the registry's ADMM backend, against
    the JAX package's front-end with its ADMM (the undecorated function
    under jax.jit with the backend closed over: the JAX package's jit
    does not mark `backend` static): equal iteration counts and
    statuses, every field within 1e-9; x0_fixed needs the Riccati IPM,
    as in the JAX package."""
    from acados_tpu.ocp_qp.registry import get_qp_backend as jax_backend
    from acados_tpu.ocp_qp.xcond import cond_x0_rows as jax_rows
    from acados_tpu_torch.ocp_qp.registry import get_qp_backend
    for args in ((7, 3, 4, None), (7, 3, 4, (7, 2)), (7, 3, 5, (7, 5, 4))):
        assert cond_x0_rows(*args) == jax_rows(*args)
    d = qp_batch(1)
    jadmm = jax_backend("ADMM")
    jsol, jinfo = jax.jit(jax.vmap(lambda q: jax_xcond.__wrapped__(
        q, JIpmOpts(), cond_N=3, backend=jadmm)))(to_jax(d))
    sol, info = solve_ocp_qp_xcond(to_torch(d), IpmOpts(), cond_N=3,
                                   backend=get_qp_backend("ADMM"))
    assert np.all(np.asarray(jinfo.status) == 0)
    for f in ("num_iter", "status"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      np.asarray(getattr(jinfo, f)))
    _fields_close(sol, jsol, SOL_FIELDS)
    with pytest.raises(ValueError, match="x0_fixed"):
        solve_ocp_qp_xcond(to_torch(d), cond_N=3, x0_fixed=True,
                           backend=get_qp_backend("ADMM"))


@pytest.mark.parametrize("soft,unit_rows_0,large", [
    (False, 0, False), (True, NX, False), (True, 0, True)])
def test_scale_qp_matches_jax(soft, unit_rows_0, large):
    """scale_qp's objective factor, row scales and scaled QP, and
    unscale_sol of a random point. large: Hessians and rows scaled up so
    the Gershgorin factor and the row scales leave 1."""
    d = qp_batch(70 + soft, soft=soft)
    if large:
        for key in ("Q", "R", "S"):
            d[key] = d[key] * 1e6
        d["C"] = d["C"] * 30.0
        d["Zl"] = d["Zl"] * 1e5
    (js, (jf, jsc)) = jax.vmap(lambda q: jscal.scale_qp(
        q, unit_rows_0=unit_rows_0))(to_jax(d))
    ts, (tf, tsc) = tscal.scale_qp(to_torch(d), unit_rows_0=unit_rows_0)
    _close(tf.numpy(), jf, "obj_factor")
    _close(tsc.numpy(), jsc, "row scales")
    assert (tf.numpy() < 1).all() == large
    _fields_close(ts, js, QP_FIELDS, "scaled ")
    sol = random_sol(np.random.default_rng(5), 4, 12, NX, NU, NX + NC)
    ju = jax.vmap(jscal.unscale_sol)(to_jax(sol, jdata.OcpQpSol), (jf, jsc))
    tu = tscal.unscale_sol(to_torch(sol, tdata.OcpQpSol), (tf, tsc))
    _fields_close(tu, ju, SOL_FIELDS, "unscaled ")


def _batch_at(solver_cls, ocp, x0s, **kw):
    """A batch solver with each instance's x0 as lbx = ubx at stage 0 and
    as its initial x, set through the per-instance views."""
    s = solver_cls(ocp, len(x0s), **kw)
    for i, view in enumerate(s.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(s.N + 1):
            view.set(k, "x", x0s[i])
    return s


def _both_batches(make_port, make_jax, x0s, **so):
    """The same OCP through both packages' batch solvers, with the
    solver options `so` set on both."""
    ocps = []
    for make in (make_jax, make_port):
        ocp = make()
        for k, v in so.items():
            setattr(ocp.solver_options, k, v)
        ocps.append(ocp)
    return (_batch_at(AcadosOcpBatchSolver, ocps[1], x0s, device="cpu"),
            _batch_at(JaxBatch, ocps[0], x0s))


def _calls_agree(ours, ref, calls):
    for _ in range(calls):
        st, st_ref = ours.solve(), ref.solve()
        np.testing.assert_array_equal(st, st_ref)
        assert np.all(st == 0)
        for field, ref_field in (("sqp_iter", "sqp_iter"),
                                 ("qp_iter", "qp_iter_total")):
            np.testing.assert_array_equal(
                ours.get_stats(field),
                np.asarray(getattr(ref._stats, ref_field)))
        it = ours._host_iterate()
        for f in ("x", "u", "pi", "lam_l", "lam_u", "sl", "su"):
            _close(it[f], ref._iterate[f], f)


PENDULUM_X0S = (np.array([0.0, np.pi, 0.0, 0.0])
                + np.random.default_rng(0).normal(0.0, 0.05, (3, 4)))


@pytest.mark.parametrize("so", [
    dict(qp_solver_cond_N=5),
    dict(qp_solver_cond_N=3),
    dict(qpscaling_scale_objective="OBJECTIVE_GERSHGORIN"),
    dict(qp_solver_cond_N=4,
         qpscaling_scale_objective="OBJECTIVE_GERSHGORIN"),
    dict(qp_solver_cond_N=4, qp_solver_cond_block_size=[6, 6, 5, 3]),
], ids=["cond5", "cond3_ragged", "qpscaling", "cond4_qpscaling",
        "block_sizes"])
def test_pendulum_sqp_front_ends_match_jax(so):
    """The pendulum SQP at N = 20 with x0 eliminated through the
    front-ends (tests/test_x0_elim.py:189-230's cases): partial
    condensing uniform and ragged, QP scaling, both, explicit block
    sizes."""
    kw = dict(N=20, dtype="float64", nlp_solver_type="SQP")
    ours, ref = _both_batches(lambda: make_pendulum_ocp(**kw),
                              lambda: jax_pendulum_ocp(**kw),
                              PENDULUM_X0S, **so)
    assert use_x0_elimination(ours.form, ours.opts)
    assert ours.opts.cond_N == ref.opts.cond_N
    assert ours.opts.cond_block_size == ref.opts.cond_block_size
    _calls_agree(ours, ref, 1)


def test_pendulum_rti_cond_N4_matches_jax():
    """The pendulum SQP-RTI batch at N = 16 with cond_N = 4 (blocks of
    M = 4 stages), three warm calls."""
    kw = dict(N=16, dtype="float64", nlp_solver_type="SQP_RTI")
    ours, ref = _both_batches(lambda: make_pendulum_ocp(**kw),
                              lambda: jax_pendulum_ocp(**kw),
                              PENDULUM_X0S, qp_solver_cond_N=4)
    _calls_agree(ours, ref, 3)


def test_chain_cond_N2_matches_jax(monkeypatch):
    """The chain (n_mass = 3, nx = 9, nu = 3) at N = 10 with cond_N = 2:
    blocks of M = 5 stages, condensed nu = 15 > UNROLL_MAX_N, so every
    Riccati factorization of a condensed stage goes through `_chol`'s
    chol_any branch (the kernel K2 on the card; the JAX package takes
    LAPACK on the CPU, as its own tests run it). One factorization per
    condensed stage per IPM round of the batch."""
    shapes = []
    orig = riccati.chol_any
    monkeypatch.setattr(riccati, "chol_any", lambda H: (
        shapes.append(tuple(H.shape)), orig(H))[1])
    kw = dict(n_mass=3, N=10, dtype="float64")
    _, xrest = make_chain_mass_ocp(**kw)
    x0s = xrest + np.random.default_rng(0).normal(0.0, 0.02,
                                                  (2, len(xrest)))
    ours, ref = _both_batches(lambda: make_chain_mass_ocp(**kw)[0],
                              lambda: jax_chain_ocp(**kw)[0], x0s,
                              qp_solver_cond_N=2)
    rounds = 0
    for _ in range(3):
        _calls_agree(ours, ref, 1)
        rounds += int(ours.get_stats("qp_iter").max())
    assert shapes == [(2, 15, 15)] * (2 * rounds), shapes
