"""PyTorch port, the chain-of-masses slice: the model, the Kronecker IRK
path of make_irk_step_jac, the RTI batch as a whole, and the Riccati
factorization without the P_0 factor when x0 is eliminated.

The chain sets 2 Gauss-Legendre stages with jac_reuse on an explicit
ODE, which selects the Kronecker path: one (nx, nx) block-determinant
inverse per substep. The JAX side inverts it with LAPACK on the CPU
(acados_tpu/sim/irk.py:291), the port with the plain Gauss-Jordan (K1's
CPU version): the difference is rounding. The RTI batches are set up as
bench.py's bench_chain_rti sets up the JAX package's (x0 = steady state
+ N(0, 0.02) from a seed).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.models.chain_mass import chain_mass_ode as jax_chain_ode
from acados_tpu.models.chain_mass import \
    make_chain_mass_ocp as jax_chain_ocp
from acados_tpu.sim.irk import implicit_from_explicit as jax_implicit
from acados_tpu.sim.irk import make_irk_step_jac as jax_make_irk_step_jac
from acados_tpu_torch.interface.builder import build_ocp
from acados_tpu_torch.interface.solver import _sqp_opts_from
from acados_tpu_torch.models.chain_mass import (chain_mass_ode,
                                                chain_steady_state,
                                                make_chain_mass_ocp)
from acados_tpu_torch.ocp_qp import riccati
from acados_tpu_torch.ocp_qp.data import OcpQp
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
from acados_tpu_torch.sim import irk
from acados_tpu_torch.sim.irk import implicit_from_explicit, make_irk_step_jac
from acados_tpu_torch.testing import random_qp_batch, rti_batch

torch.set_num_threads(1)

# bench.py's float32 tolerances of the chain entry
CHAIN_TOLS = dict(tol_stat=1e-2, tol_eq=1e-4, tol_ineq=1e-3, tol_comp=1e-2)


def _nx(n_mass):
    return (2 * (n_mass - 2) + 1) * 3


@pytest.mark.parametrize("n_mass", [3, 5, 8, 11])
def test_steady_state_is_an_equilibrium(n_mass):
    xr = chain_steady_state(n_mass)
    assert xr.shape == (_nx(n_mass),)
    f = chain_mass_ode(n_mass)
    xdot = f(torch.as_tensor(xr), torch.zeros(3, dtype=torch.float64))
    np.testing.assert_allclose(xdot.numpy(), 0.0, atol=1e-8)


@pytest.mark.parametrize("n_mass", [4, 8])
def test_ode_and_jacobian_match_jax(n_mass):
    nx = _nx(n_mass)
    rng = np.random.default_rng(n_mass)
    x = chain_steady_state(n_mass) + 0.05 * rng.normal(size=(6, nx))
    u = 0.3 * rng.normal(size=(6, 3))
    tf, jf = chain_mass_ode(n_mass), jax_chain_ode(n_mass)
    got = torch.func.vmap(tf)(torch.as_tensor(x), torch.as_tensor(u))
    ref = jax.vmap(jf)(x, u)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    Jx, Ju = torch.func.vmap(torch.func.jacfwd(tf, argnums=(0, 1)))(
        torch.as_tensor(x), torch.as_tensor(u))
    Jx_ref, Ju_ref = jax.vmap(jax.jacfwd(jf, argnums=(0, 1)))(x, u)
    np.testing.assert_allclose(Jx.numpy(), np.asarray(Jx_ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(Ju.numpy(), np.asarray(Ju_ref))
    # float32 in, float32 out (gravity is made in the argument's dtype)
    x32 = torch.as_tensor(x[0], dtype=torch.float32)
    assert tf(x32, torch.zeros(3)).dtype == torch.float32


@pytest.mark.parametrize("n_mass", [4, 8])
def test_kron_step_jac_matches_jax(n_mass):
    """The chain's own integrator options: 2 stages, 2 substeps, 3 Newton
    iterations, jac_reuse, an explicit ODE; float64, B = 8."""
    nx = _nx(n_mass)
    rng = np.random.default_rng(10 + n_mass)
    args = (chain_steady_state(n_mass) + 0.05 * rng.normal(size=(8, nx)),
            0.3 * rng.normal(size=(8, 3)), np.zeros((8, 0)),
            rng.uniform(0.0, 1.0, size=8), np.full(8, 0.2))
    jf = jax_make_irk_step_jac(jax_implicit(jax_chain_ode(n_mass)), nx, 0,
                               2, 2, 3, jac_reuse=True, explicit_ode=True)
    calls = []
    orig = irk.gj_inverse_any
    tf = make_irk_step_jac(implicit_from_explicit(chain_mass_ode(n_mass)),
                           nx, 0, 2, 2, 3, jac_reuse=True, explicit_ode=True)
    try:
        irk.gj_inverse_any = lambda A: (calls.append(tuple(A.shape)),
                                        orig(A))[1]
        out = tf(*(torch.as_tensor(a) for a in args))
    finally:
        irk.gj_inverse_any = orig
    # one (nx, nx) inverse per substep, none of the (2nx, 2nx) stage matrix
    assert calls == [(8, nx, nx)] * 2
    ref = jax.vmap(jf)(*args)
    for name, a, b in zip(("x_next", "A", "B"), out, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert np.max(np.abs(a.numpy() - b)) <= 1e-10 * np.max(np.abs(b)), \
            name
    out32 = tf(*(torch.as_tensor(a, dtype=torch.float32) for a in args))
    assert all(o.dtype == torch.float32 for o in out32)


def test_kron_path_selection_and_errors():
    """The auto rule (2 stages, nz == 0, jac_reuse, explicit ODE) and the
    JAX package's two ValueErrors."""
    f = implicit_from_explicit(chain_mass_ode(4))
    nx = _nx(4)
    calls = []
    orig = irk.gj_inverse_any
    args = (torch.as_tensor(chain_steady_state(4))[None],
            torch.zeros((1, 3), dtype=torch.float64),
            torch.zeros((1, 0), dtype=torch.float64),
            torch.zeros(1, dtype=torch.float64),
            torch.full((1,), 0.2, dtype=torch.float64))
    try:
        irk.gj_inverse_any = lambda A: (calls.append(A.shape[-1]),
                                        orig(A))[1]
        for kw, sizes in (
                (dict(jac_reuse=True, explicit_ode=True), [nx] * 2),
                (dict(jac_reuse=False, explicit_ode=True), [2 * nx] * 8),
                (dict(jac_reuse=True, explicit_ode=False), [2 * nx] * 2),
                (dict(jac_reuse=True, explicit_ode=True, kron_path=False),
                 [2 * nx] * 2)):
            calls.clear()
            make_irk_step_jac(f, nx, 0, num_stages=2, num_steps=2,
                              **kw)(*args)
            assert calls == sizes, kw
    finally:
        irk.gj_inverse_any = orig
    with pytest.raises(ValueError, match="num_stages == 2 and nz == 0"):
        make_irk_step_jac(f, nx, 0, num_stages=3, kron_path=True,
                          explicit_ode=True)
    with pytest.raises(ValueError, match="num_stages == 2 and nz == 0"):
        make_irk_step_jac(f, nx, 1, num_stages=2, kron_path=True,
                          explicit_ode=True)
    with pytest.raises(ValueError, match="explicit ODE"):
        make_irk_step_jac(f, nx, 0, num_stages=2, kron_path=True,
                          explicit_ode=False)


def test_chain_ocp_data_matches_jax():
    """The builder takes the chain's soft bx rows (lbx at the wall, ubx at
    1e9, idxsbx over all of them) and Zl/Zu/zl/zu as the JAX builder
    does, and the interface maps the first QP's warm start from the NLP
    multipliers."""
    ocp, _ = make_chain_mass_ocp(n_mass=5, N=10)
    form, data, _ = build_ocp(ocp)
    jform, jdata, _ = jax_build_ocp(jax_chain_ocp(n_mass=5, N=10)[0])
    assert form.con.soft_rows == jform.con.soft_rows == tuple(range(4))
    assert form.x0_equality and jform.x0_equality
    assert data.keys() == jdata.keys()
    for k in data:
        np.testing.assert_array_equal(data[k], np.asarray(jdata[k]),
                                      err_msg=k)
    assert _sqp_opts_from(ocp).warm_start_first_qp_from_nlp


def _both_batches(n_mass, N, B, dtype):
    """The JAX package's batched RTI solve as bench_chain_rti builds it,
    and the port's batch solver on the same x0s."""
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    solve_batch, data, it, _, form, _ = bench._build_rti(
        jax_chain_ocp, chain_steady_state(n_mass), 0.02, B, jdt, seed=0,
        n_mass=n_mass, N=N, dtype=dtype)
    x0s = np.asarray(data.lb_0, np.float64)[:, :form.nx]
    ocp, xrest = make_chain_mass_ocp(n_mass=n_mass, N=N, dtype=dtype)
    np.testing.assert_array_equal(xrest, chain_steady_state(n_mass))
    return solve_batch, data, it, rti_batch(ocp, x0s, "cpu")


def test_chain_rti_batch_matches_jax_float64():
    """The slice as a whole: n_mass = 4 (nx = 15 > 12, so the Riccati
    would factor P_0 through chol_any were it not skipped), N = 10, B = 4,
    3 RTI calls; equal statuses, sqp_iter and qp_iter per instance, x, u
    and pi within 1e-9 relative."""
    N = 10
    solve_batch, data, it, solver = _both_batches(4, N, 4, "float64")
    assert solver.opts.warm_start_first_qp_from_nlp
    for _ in range(3):
        it, stats = solve_batch(data, it)
        status = solver.solve()
        np.testing.assert_array_equal(status, np.asarray(stats.status))
        np.testing.assert_array_equal(solver.get_stats("sqp_iter"),
                                      np.asarray(stats.sqp_iter))
        np.testing.assert_array_equal(solver.get_stats("qp_iter"),
                                      np.asarray(stats.qp_iter_total))
        for f in ("x", "u", "pi"):
            ref = np.asarray(getattr(it, f))
            got = getattr(solver._it_dev, f).numpy()
            assert np.all(np.abs(got - ref) <= 1e-9 * (1 + np.abs(ref))), f
    assert np.all(status == 0)


def test_chain_rti_float32_in_tolerance_like_jax():
    """Float32, n_mass = 5, N = 20, B = 8, 1 cold + 7 warm calls: every
    status 0 in both packages and both inside bench.py's chain
    tolerances."""
    solve_batch, data, it, solver = _both_batches(5, 20, 8, "float32")
    for _ in range(8):
        it, stats = solve_batch(data, it)
        status = solver.solve()
        np.testing.assert_array_equal(status, np.asarray(stats.status))
        assert np.all(status == 0)
    res = solver.get_stats("residuals")
    ours = bench._residual_fields(type("Stats", (), dict(
        res_stat=res[:, 0], res_eq=res[:, 1], res_ineq=res[:, 2],
        res_comp=res[:, 3])), CHAIN_TOLS)
    ref = bench._residual_fields(stats, CHAIN_TOLS)
    assert ours["in_tolerance"] and ref["in_tolerance"], (ours, ref)


def test_riccati_without_p0_factor():
    """factor_p0=False: the same P, Luu and K, no LP0, and a solve that
    would need it raises; the x0-eliminated IPM at nx = 14 (> 12, where
    P_0 would go through chol_any) never factors an (nx, nx) matrix."""
    d = random_qp_batch(5, B=4, N=6, nx=14, nu=2)
    Q, R, S, A, B = (torch.as_tensor(d[k]) for k in ("Q", "R", "S", "A",
                                                     "B"))
    full = riccati.riccati_factor(Q, R, S, A, B)
    lean = riccati.riccati_factor(Q, R, S, A, B, factor_p0=False)
    assert full.LP0 is not None and lean.LP0 is None
    for f in ("P", "Luu", "K"):
        assert torch.equal(getattr(full, f), getattr(lean, f)), f
    rhs = (torch.as_tensor(d[k]) for k in ("q", "r", "b"))
    with pytest.raises(ValueError, match="factor_p0=True"):
        riccati.riccati_solve(lean, A, B, *rhs)

    sizes = []
    orig = riccati._chol
    try:
        riccati._chol = lambda H: (sizes.append(H.shape[-1]), orig(H))[1]
        qp = OcpQp(**{k: torch.as_tensor(v) for k, v in d.items()})
        _, info = solve_ocp_qp(qp, IpmOpts(), x0_fixed=True)
    finally:
        riccati._chol = orig
    assert bool((info.status == 0).all())
    rounds = int(info.num_iter.max())
    assert sizes == [2] * (6 * rounds)   # the Luu factors only
