"""PyTorch port, the exact Hessian through the IRK step (Gauss-Legendre,
4 stages, 2 substeps: the main path's integrator): the EXACT branch of
ocp_nlp/linearize.py against jax.vmap of the JAX package's linearize at
an iterate with nonzero multipliers, as tests/test_torch_exact_hessian.py
holds the ERK one (float64, CPU, every QP field within 1e-9); and the
K1 count of chip_smoke.py's Newton SQP phase on the CPU. The
dynamics Hessian is the IRK-specific term (torch.func.hessian through
the stage solves' implicit gradient); the cost and h terms and their
switches run the same code as with ERK, so here the dynamics switch
alone is turned off, beside Gauss-Newton.
"""
import torch

from test_torch_exact_hessian import VARIANTS, check_linearize

torch.set_num_threads(1)


def test_exact_linearize_irk_matches_jax():
    check_linearize("IRK", {k: VARIANTS[k] for k in
                            ("all", "no_dyn", "gauss_newton")})


def test_newton_k1_count_matches_chip_smoke(monkeypatch):
    """chip_smoke.py's phase 27 holds the K1 launches of an EXACT +
    MERIT_BACKTRACKING solve() call (its NEWTON_SO) to
    newton_k1_expected, which works them out from the call's stat table:
    here the count of K1 wrapper calls of such a call on the CPU (IRK
    GL4, N = 3, B = 3, cut at 6 iterations, with backtracking) equals
    it."""
    import numpy as np

    import chip_smoke
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import rti_batch
    from test_torch_exact_hessian import _counting

    ocp = make_pendulum_ocp(N=3, dtype="float64", nlp_solver_type="SQP",
                            integrator_type="IRK")
    for k, v in dict(chip_smoke.NEWTON_SO, nlp_solver_max_iter=6).items():
        setattr(ocp.solver_options, k, v)
    x0s = np.array([0.0, 1.0, 0.0, 0.0]) + np.random.default_rng(0).normal(
        0.0, 0.4, (3, 4))
    solver = rti_batch(ocp, x0s, "cpu")
    calls = _counting(monkeypatch)
    solver.solve()
    alpha = solver._stats.stat[:, :, 6].numpy()
    assert np.any((alpha > 0) & (alpha < 1)), alpha
    assert len(calls) == chip_smoke.newton_k1_expected(solver._stats,
                                                        solver.opts)
