"""PyTorch port, the zoRO custom update (interface/zoro.py and
AcadosOcpSolver.custom_update) against the JAX package's
make_zoro_update and zoro_custom_update (float64, CPU): the tightened
bounds on tests/test_zoro.py's double integrator and on the IRK pendulum
at N = 4 within 1e-9, the hand recursion beside them, the K1 calls of
one update on the IRK (a counting linsolve: 8, the linearization's), and
the tightened solve against the JAX one.
"""
import numpy as np
import pytest
import torch

from acados_tpu.interface.solver import AcadosOcpSolver as JaxSolver
from acados_tpu.interface.zoro import ZoroDescription as JaxZoro
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu_torch import AcadosOcpSolver, ZoroDescription
from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from test_torch_exact_hessian import _counting
from test_torch_globalization import rel_gap
from test_zoro import make_di_ocp as jax_di_ocp

torch.set_num_threads(1)

BOUNDS = ("lb", "ub", "lb_e", "ub_e")


def di_ocp():
    """tests/test_zoro.py:make_di_ocp in torch: the double integrator at
    N = 10, a path bound |position| <= 2 to tighten."""
    ocp, m = AcadosOcp(), AcadosModel()
    m.name, m.x, m.u = "di", 2, 1
    m.f_expl_expr = lambda x, u: torch.stack([x[1], u[0]])
    ocp.model = m
    ocp.solver_options.N_horizon = 10
    ocp.solver_options.tf = 1.0
    ocp.cost.cost_type = "NONLINEAR_LS"
    m.cost_y_expr = lambda x, u: torch.cat([x, u])
    ocp.cost.yref = np.zeros(3)
    ocp.cost.W = np.diag([1.0, 1.0, 0.1])
    ocp.cost.cost_type_e = "NONLINEAR_LS"
    m.cost_y_expr_e = lambda x: x
    ocp.cost.yref_e = np.zeros(2)
    ocp.cost.W_e = np.eye(2)
    ocp.constraints.x0 = np.array([1.0, 0.0])
    ocp.constraints.idxbx = np.array([0])
    ocp.constraints.lbx = np.array([-2.0])
    ocp.constraints.ubx = np.array([2.0])
    ocp.solver_options.dtype = "float64"
    return ocp


def irk_pendulum(make, desc_cls, N=4):
    """The pendulum with the main path's IRK (GL4, 2 substeps) at N = 4,
    a path bound on the cart position beside the force bound, and a
    zoRO description with a state-feedback gain."""
    ocp = make(N=N, dtype="float64", nlp_solver_type="SQP",
               integrator_type="IRK")
    ocp.constraints.idxbx = np.array([0])
    ocp.constraints.lbx = np.array([-3.0])
    ocp.constraints.ubx = np.array([3.0])
    ocp.zoro_description = desc_cls(
        backoff_scaling_gamma=2.0, P0_mat=1e-4 * np.eye(4),
        W_mat=np.diag([1e-4, 1e-3, 1e-4, 1e-3]),
        fdbk_K_mat=np.array([[2.0, -20.0, 1.0, -2.0]]))
    return ocp


def _zoro(desc_cls, gamma, P0, W, K):
    return desc_cls(backoff_scaling_gamma=gamma, P0_mat=P0, W_mat=W,
                    fdbk_K_mat=K)


@pytest.mark.parametrize("gamma,P0,W", [
    (2.0, np.zeros((2, 2)), 1e-4 * np.eye(2)),
    (3.0, 1e-3 * np.eye(2), 1e-3 * np.eye(2))])
def test_double_integrator_backoff_matches_jax(gamma, P0, W):
    """The tightened bounds after one custom_update within 1e-9 of the
    JAX package's, the position row's backoff the hand recursion's
    (tests/test_zoro.py: the ERK4 discretization of the double
    integrator is exact), growing along the horizon; the tightened
    solves agree and keep the tightened bound."""
    K = np.array([[-1.0, -1.5]])
    ocp, jocp = di_ocp(), jax_di_ocp()
    ocp.zoro_description = _zoro(ZoroDescription, gamma, P0, W, K)
    jocp.zoro_description = _zoro(JaxZoro, gamma, P0, W, K)
    ours, ref = AcadosOcpSolver(ocp, device="cpu"), JaxSolver(jocp)
    assert ours.solve() == ref.solve() == 0
    ub0 = ours._data["ub"].copy()
    assert ours.custom_update() == ref.custom_update() == 0
    for k in BOUNDS:
        assert ours._data[k].shape == ref._data[k].shape
        assert rel_gap(ours._data[k], ref._data[k]) <= 1e-9, k
    dt = 0.1
    Acl = np.array([[1.0, dt], [0.0, 1.0]]) \
        + np.array([[dt ** 2 / 2], [dt]]) @ K
    P, hand = P0.copy(), []
    for _ in range(10):
        P = Acl @ P @ Acl.T + W
        hand.append(gamma * np.sqrt(P[0, 0]))
    got = ub0[:, 0] - ours._data["ub"][:, 0]
    np.testing.assert_allclose(got, hand[:9], rtol=1e-6)
    assert np.all(np.diff(got) > 0)
    # the infinite sides stay untouched
    assert np.array_equal(np.abs(ours._data["ub"]) > 1e9, np.abs(ub0) > 1e9)
    assert ours.solve() == ref.solve() == 0
    x = np.array([ours.get(k, "x") for k in range(11)])
    x_ref = np.array([ref.get(k, "x") for k in range(11)])
    assert rel_gap(x, x_ref) <= 1e-9
    assert np.max(x[1:10, 0]) <= np.max(ours._data["ub"][:, 0]) + 1e-8


def test_irk_pendulum_backoff_matches_jax(monkeypatch):
    """The IRK pendulum at N = 4: one custom_update makes the 8 K1 calls
    of its linearization (chip_smoke.py's LAUNCHES_PER_RTI) and tightens
    the force and position rows as the JAX package does (within 1e-9),
    the backoff growing along the horizon; a second update starts from
    the original bounds again; the tightened solves agree."""
    ours = AcadosOcpSolver(irk_pendulum(make_pendulum_ocp, ZoroDescription),
                           device="cpu")
    ref = JaxSolver(irk_pendulum(jax_pendulum_ocp, JaxZoro))
    assert ours.solve() == ref.solve() == 0
    base = {k: ours._data[k].copy() for k in BOUNDS}
    calls = _counting(monkeypatch)
    assert ours.custom_update() == 0
    assert len(calls) == 8
    ref.custom_update()
    for k in BOUNDS:
        assert rel_gap(ours._data[k], ref._data[k]) <= 1e-9, k
    lay = ours.layouts["p"]
    rows = [lay.off_bu, lay.off_bx]
    back = base["ub"][:, rows] - ours._data["ub"][:, rows]
    assert np.all(np.isfinite(back)) and np.all(back > 0)
    assert np.all(np.diff(back, axis=0) > 0)
    np.testing.assert_allclose(ours._data["lb"][:, rows] - base["lb"][:, rows],
                               back, rtol=1e-12)
    assert ours.solve() == ref.solve() == 0
    assert ours.get_stats("sqp_iter") == ref.get_stats("sqp_iter")
    for f in ("x", "u", "pi", "lam"):
        assert rel_gap(ours.get_flat(f), ref.get_flat(f)) <= 1e-9, f
    # the base is the original bounds: a second update at the new
    # iterate tightens from there, as the JAX one does
    ours.custom_update()
    ref.custom_update()
    for k in BOUNDS:
        assert rel_gap(ours._data[k], ref._data[k]) <= 1e-9, k


def test_custom_update_without_description():
    """Without a ZoroDescription, custom_update runs a callable(solver)
    or raises ValueError, as the JAX solver does."""
    s = AcadosOcpSolver(di_ocp(), device="cpu")
    seen = []
    assert s.custom_update(lambda solver: seen.append(solver)) == 0
    assert seen == [s]
    with pytest.raises(ValueError, match="zoro_description"):
        s.custom_update()
