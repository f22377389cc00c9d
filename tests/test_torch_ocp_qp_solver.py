"""PyTorch port, the standalone OCP-QP interface
(interface/ocp_qp_solver.py: AcadosOcpQp, AcadosOcpQpSolver) against the
JAX package's classes on tests/test_utils_interface.py's QP (a double
integrator with state and input rows, x0 pinned by equal bounds), in
float64 on the CPU: the solution of every stage, the statistics and the
QP sensitivities within 1e-9, with equal iteration counts and statuses,
for each backend and condensing choice.

The IPM holds x0 by the barrier of the two equal-bound rows of stage 0:
their multipliers lam_lg and lam_ug (~1.5e3 each) are ill-determined,
only their difference is fixed by stationarity (tests/
test_torch_dense_qp.py's docstring). There the difference is held at
1e-9 and each multiplier at 1e-5 (measured 1.3e-6); the adjoint's
gradients with respect to those rows' lg and ug likewise through their
sum (the gradient with respect to x0) at 1e-9, each at 1e-8 (measured
4.0e-9).

The JAX package's jit of solve_ocp_qp_xcond does not mark `backend`
static, so its AcadosOcpQpSolver with cond_N raises a TypeError; the
reference for those cases is the undecorated function under jax.jit
with the backend closed over.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.ocp_qp_solver import AcadosOcpQp as JaxQp
from acados_tpu.interface.ocp_qp_solver import AcadosOcpQpSolver as JaxQpSolver
from acados_tpu.ocp_qp.data import zero_qp as jax_zero_qp
from acados_tpu.ocp_qp.registry import get_qp_backend as jax_backend
from acados_tpu.ocp_qp.xcond import solve_ocp_qp_xcond as jax_xcond
from acados_tpu_torch import AcadosOcpQp, AcadosOcpQpSolver
from acados_tpu_torch.ocp_qp.admm import AdmmOpts
from acados_tpu_torch.ocp_qp.data import zero_qp

torch.set_num_threads(1)

N, NX, NU, NC = 8, 2, 1, 3
SOL = ("x", "u", "pi", "lam_lg", "lam_ug", "sl", "su")


def _close(got, ref, err_msg="", rel=1e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (err_msg, got.shape, ref.shape)
    gap = np.max(np.abs(got - ref) / (1 + np.abs(ref)), initial=0.0)
    assert gap <= rel, f"{err_msg}: {gap:.3e} > {rel:g}"


def _describe(desc):
    """tests/test_utils_interface.py:199-233's QP, set stage by stage."""
    rng = np.random.default_rng(0)
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    Bm = np.array([[0.005], [0.1]])
    C = np.zeros((NC, NX))
    C[0, 0] = C[1, 1] = 1.0
    D = np.zeros((NC, NU))
    D[2, 0] = 1.0
    for k in range(N + 1):
        desc.set(k, "Q", np.eye(NX))
        desc.set(k, "q", rng.normal(size=NX) * 0.1)
        desc.set(k, "C", C)
        desc.set(k, "lg", np.array([-1.0, -1.0, -0.5]))
        desc.set(k, "ug", np.array([1.0, 1.0, 0.5]))
        desc.set(k, "mask_l", np.ones(NC))
        desc.set(k, "mask_u", np.ones(NC))
    for k in range(N):
        desc.set(k, "R", 0.1 * np.eye(NU))
        desc.set(k, "A", A)
        desc.set(k, "B", Bm)
        desc.set(k, "D", D)
    desc.set(0, "lg", np.array([0.8, 0.0, -0.5]))
    desc.set(0, "ug", np.array([0.8, 0.0, 0.5]))
    return desc


def _both(solver, cond_N, opts=None, jax_opts=None):
    ours = AcadosOcpQpSolver(
        _describe(AcadosOcpQp(N, NX, NU, NC, device="cpu")), solver=solver,
        cond_N=cond_N, opts=opts)
    ref = JaxQpSolver(_describe(JaxQp(N, NX, NU, NC)), solver=solver,
                      opts=jax_opts)
    if cond_N is not None:
        backend = jax_backend(solver)
        ref._solve = jax.jit(lambda q: jax_xcond.__wrapped__(
            q, ref.opts, cond_N=cond_N, backend=backend))
    return ours, ref


def _x0_rows_close(got, ref, err_msg, rel_each, net):
    """Stage 0's rows 0 and 1 (the x0 rows) of two row fields of both
    packages: net(a, b) of each within 1e-9, each field within
    rel_each; every other row within 1e-9."""
    (ga, gb), (ra, rb) = got, ref
    _close(net(ga[0, :NX], gb[0, :NX]), net(ra[0, :NX], rb[0, :NX]),
           err_msg + " x0 rows")
    for g, r, name in ((ga, ra, "a"), (gb, rb, "b")):
        _close(g[0, :NX], r[0, :NX], f"{err_msg} x0 rows {name}",
               rel=rel_each)
        _close(g[0, NX:], r[0, NX:], f"{err_msg} {name}")
        _close(g[1:], r[1:], f"{err_msg} {name}")


CASES = [("RICCATI_IPM", None), ("ADMM", None), ("ADMM", 4),
         ("RICCATI_IPM", 4), ("PARTIAL_CONDENSING_OSQP", None)]


@pytest.mark.parametrize("solver,cond_N", CASES)
def test_solve_matches_jax(solver, cond_N):
    """solve(), get() of every field at every stage and get_stats(),
    with the Riccati IPM or ADMM, directly or through partial condensing
    (blocks of 2 stages), and the reference's plan name for OSQP."""
    ours, ref = _both(solver, cond_N)
    assert ours.solve() == ref.solve() == 0
    for f in ("num_iter", "status"):
        assert ours.get_stats(f) == ref.get_stats(f)
    for f in ("mu", "res_stat", "res_eq", "res_ineq"):
        _close(ours.get_stats(f), ref.get_stats(f), f)
    stages = lambda s, f: np.stack([
        s.get(k, f) for k in range(N + 1 if f not in ("u", "pi") else N)])
    for f in ("x", "u", "pi", "sl", "su"):
        _close(stages(ours, f), stages(ref, f), f)
    lam = lambda s: (stages(s, "lam_lg"), stages(s, "lam_ug"))
    _x0_rows_close(lam(ours), lam(ref), "lam", 1e-5, lambda a, b: a - b)
    np.testing.assert_allclose(ours.get(0, "x"), [0.8, 0.0], atol=1e-6
                               if solver == "RICCATI_IPM" else 1e-3)


@pytest.mark.parametrize("solver,cond_N", CASES[:3])
def test_sensitivities_match_jax(solver, cond_N):
    """eval_sens_forw in a direction of q and of the bounds, and
    eval_sens_adj seeded on x and u, at the solution of each backend
    (the IPM's options: the seeds run HPIPM's sens_frw/adj)."""
    ours, ref = _both(solver, cond_N)
    ours.solve(), ref.solve()
    rng = np.random.default_rng(1)
    dq, dlg = rng.normal(size=(N + 1, NX)), rng.normal(size=(N + 1, NC))
    d_t = zero_qp(ours.qp_desc.dims, batch=1).replace(
        q=torch.as_tensor(dq)[None], lg=torch.as_tensor(dlg)[None],
        ug=torch.as_tensor(dlg)[None])
    d_j = jax_zero_qp(ref.qp_desc.dims, jnp.float64).replace(
        q=jnp.asarray(dq), lg=jnp.asarray(dlg), ug=jnp.asarray(dlg))
    for name, a, b in zip(("dx", "du", "dpi"), ours.eval_sens_forw(d_t),
                          ref.eval_sens_forw(d_j)):
        _close(a.numpy(), b, name)
    sx, su = rng.normal(size=(N + 1, NX)), rng.normal(size=(N, NU))
    g_t, g_j = ours.eval_sens_adj(sx, su), ref.eval_sens_adj(sx, su)
    for f in ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "Zl",
              "Zu", "zl", "zu"):
        _close(getattr(g_t, f).numpy()[0], getattr(g_j, f), f)
    _x0_rows_close((g_t.lg.numpy()[0], g_t.ug.numpy()[0]),
                   (np.asarray(g_j.lg), np.asarray(g_j.ug)), "d/d(lg, ug)",
                   1e-8, lambda a, b: a + b)


def test_admm_opts_and_set_get():
    """AdmmOpts pass through to the ADMM backend; set() replaces a stage's
    block (a smaller value zero-padded, as in the JAX package) and get()
    reads it back; the errors."""
    from acados_tpu.ocp_qp.admm import AdmmOpts as JAdmmOpts
    ours, ref = _both("ADMM", None, opts=AdmmOpts(iter_max=3000, rho=1.0),
                      jax_opts=JAdmmOpts(iter_max=3000, rho=1.0))
    assert ours.solve() == ref.solve() == 0
    assert ours.get_stats("num_iter") == ref.get_stats("num_iter")
    _close(ours.get(2, "x"), ref.get(2, "x"), "x 2")
    desc = ours.qp_desc
    for d in (desc, ref.qp_desc):
        d.set(3, "lg", [-2.0])
    np.testing.assert_array_equal(desc.get(3, "lg"), [-2.0, 0.0, 0.0])
    np.testing.assert_array_equal(desc.get(3, "lg"),
                                  ref.qp_desc.get(3, "lg"))
    np.testing.assert_array_equal(desc.get(3, "C"), ref.qp_desc.get(3, "C"))
    assert desc.qp.q.shape == (1, N + 1, NX)
    with pytest.raises(ValueError, match="unknown QP field"):
        desc.set(0, "nope", 1.0)
    with pytest.raises(ValueError):
        ours.get(0, "t_lg")
    fresh = AcadosOcpQpSolver(desc)
    with pytest.raises(RuntimeError, match="solve"):
        fresh.get(0, "x")
    with pytest.raises(RuntimeError, match="solve"):
        fresh.get_stats("status")


def test_device_defaults_to_the_card():
    """The description lives on the card unless the caller asks for the
    CPU; without CUDA the default raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert AcadosOcpQp(N, NX, NU, NC).qp.q.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AcadosOcpQp(N, NX, NU, NC)
    assert AcadosOcpQp(N, NX, NU, device="cpu").dims.nc == 1
