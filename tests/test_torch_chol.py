"""PyTorch port, kernel module ops/batched_chol.py (K2, K3, K4).

The plain versions run the recurrences of the Pallas kernels
`_chol_kernel` / `_solve_kernel` in the same order, so they agree with
the kernels in interpret mode (as tests/test_ops.py runs them) to
rounding. Interpret mode grows steeply with n here, so larger n are held
against the JAX package's `chol_any`, which is LAPACK on the CPU. The
CUDA kernels run only on the card (chip_smoke.py holds them against the
plain versions there); here the wrappers must refuse, not fall back.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.ops import batched_chol as jchol
from acados_tpu_torch.ops import (batched_chol, chol_factor_batched,
                                  chol_factor_solve_batched,
                                  chol_solve_batched, cuda_build)

torch.set_num_threads(1)


def _spd(rng, B, n):
    A = rng.normal(size=(B, n, n))
    return A @ np.swapaxes(A, 1, 2) + 3 * np.eye(n)


@pytest.mark.parametrize("n", [2, 5, 11])
@pytest.mark.parametrize("B", [7, 300])
def test_plain_factor_matches_pallas(n, B):
    H = _spd(np.random.default_rng(n * 100 + B), B, n)
    ours = chol_factor_batched(torch.as_tensor(H)).numpy()
    pallas = np.asarray(jchol.chol_factor_batched(jnp.asarray(H),
                                                  tile_b=128))
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-13)
    assert np.all(np.triu(ours, 1) == 0)


@pytest.mark.parametrize("n", [2, 5])
def test_plain_solve_and_fused_match_pallas(n):
    rng = np.random.default_rng(n)
    H, b = _spd(rng, 64, n), rng.normal(size=(64, n))
    L = np.asarray(jchol.chol_factor_batched(jnp.asarray(H), tile_b=128))
    x = chol_solve_batched(torch.as_tensor(L), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(
        x, np.asarray(jchol.chol_solve_batched(jnp.asarray(L),
                                               jnp.asarray(b), tile_b=128)),
        rtol=0, atol=1e-13)
    x2, L2 = chol_factor_solve_batched(torch.as_tensor(H),
                                       torch.as_tensor(b))
    xj, Lj = jchol.chol_factor_solve_batched(jnp.asarray(H), jnp.asarray(b),
                                             tile_b=128)
    np.testing.assert_allclose(x2.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(L2.numpy(), np.asarray(Lj), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(
        x, np.linalg.solve(H, b[..., None])[..., 0], atol=1e-12)


@pytest.mark.parametrize("n", [24, 39, 64, 70])
def test_chol_any_matches_jax_at_larger_n(n):
    """n = 24 is the dense IPM's nv on the pendulum; 70 is past the
    kernel's limit (the library's Cholesky, as the JAX package's XLA
    one). Solve and fused solve against LAPACK at n <= 64."""
    rng = np.random.default_rng(n)
    H, b = _spd(rng, 9, n), rng.normal(size=(9, n))
    L = batched_chol.chol_any(torch.as_tensor(H)).numpy()
    ref = np.asarray(jchol.chol_any(jnp.asarray(H)))
    assert np.max(np.abs(L - ref)) <= 1e-13 * np.max(np.abs(ref))
    if n <= batched_chol.CHOL_MAX_N:
        x_ref = np.linalg.solve(H, b[..., None])[..., 0]
        x = chol_solve_batched(torch.as_tensor(L), torch.as_tensor(b))
        x2, _ = chol_factor_solve_batched(torch.as_tensor(H),
                                          torch.as_tensor(b))
        for got in (x, x2):
            assert np.max(np.abs(got.numpy() - x_ref)) <= 1e-12 * np.max(
                np.abs(x_ref))


def test_not_positive_definite_is_nan_throughout():
    """A batch mixing SPD matrices with an indefinite one, a singular
    one, and ones holding NaN or inf in the lower triangle: every bad
    matrix comes back NaN in every entry (K2, and K3/K4 through it), the
    good ones are untouched. The JAX package's CPU Cholesky NaNs the
    lower triangle of the indefinite and the singular one (for the
    non-finite ones LAPACK propagates a few NaNs or keeps an infinite
    pivot); the TPU kernel NaNs from the first bad pivot on. A NaN
    factor makes the dense IPM report status 1 in both packages
    (tests/test_torch_dense_qp.py)."""
    rng = np.random.default_rng(5)
    n = 6
    H = _spd(rng, 8, n)
    H[1] = np.diag([1.0, 2.0, -1.0, 1.0, 1.0, 1.0])
    H[3] = np.ones((n, n))                          # rank one
    H[4, 5, 2] = np.nan
    H[6, 3, 3] = np.inf
    bad = np.zeros(8, bool)
    bad[[1, 3, 4, 6]] = True
    b = rng.normal(size=(8, n))
    L = chol_factor_batched(torch.as_tensor(H)).numpy()
    x = chol_solve_batched(torch.as_tensor(L), torch.as_tensor(b)).numpy()
    x2, L2 = (t.numpy() for t in chol_factor_solve_batched(
        torch.as_tensor(H), torch.as_tensor(b)))
    for a in (L, x, L2, x2):
        assert np.all(np.isnan(a[bad]))
        assert np.all(np.isfinite(a[~bad]))
    np.testing.assert_allclose(L[~bad], np.linalg.cholesky(H[~bad]),
                               atol=1e-13)
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(H)))
    low = np.tril_indices(n)
    assert np.all(np.isnan(Lj[[1, 3]][:, low[0], low[1]]))
    # through chol_any too (the solvers' entry point)
    La = batched_chol.chol_any(torch.as_tensor(H)).numpy()
    np.testing.assert_array_equal(np.isnan(La), np.isnan(L))


def _sym_input(X, n):
    """X X' + n I, for a torch tensor or a JAX array."""
    if isinstance(X, torch.Tensor):
        return X @ X.transpose(-1, -2) + n * torch.eye(n, dtype=X.dtype)
    return X @ jnp.swapaxes(X, -1, -2) + n * jnp.eye(n, dtype=X.dtype)


@pytest.mark.parametrize("n", [5, 24])
def test_chol_any_gradient_matches_jax(n):
    """The backward of chol_any against jax.grad of the JAX chol_any
    through H = X X' + n I (a symmetric input, where the symmetrised
    gradient and the JAX tangent's transpose agree)."""
    rng = np.random.default_rng(10 + n)
    X = rng.normal(size=(3, n, n))
    Wt = rng.normal(size=(3, n, n))

    def jf(X):
        return jnp.sum(jnp.asarray(Wt) * jchol.chol_any(_sym_input(X, n)))

    ref = np.asarray(jax.grad(jf)(jnp.asarray(X)))
    Xt = torch.tensor(X, requires_grad=True)
    (torch.as_tensor(Wt) * batched_chol.chol_any(_sym_input(Xt, n))
     ).sum().backward()
    assert np.max(np.abs(Xt.grad.numpy() - ref)) <= 1e-11 * np.max(
        np.abs(ref))


def test_chol_any_gradcheck():
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.normal(size=(2, 3, 4, 4)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda X: batched_chol.chol_any(_sym_input(X, 4)), (X,))


def test_leading_axes_flatten_into_one_batch():
    H = torch.as_tensor(_spd(np.random.default_rng(4), 6, 5))
    out = batched_chol.chol_any(H.reshape(2, 3, 5, 5))
    assert out.shape == (2, 3, 5, 5)
    np.testing.assert_array_equal(out.reshape(6, 5, 5).numpy(),
                                  chol_factor_batched(H).numpy())


def test_cpu_tensors_take_plain_versions_without_launch():
    before = dict(batched_chol.LAUNCHES)
    H = torch.eye(4, dtype=torch.float64)[None] * 4.0
    b = torch.ones((1, 4), dtype=torch.float64)
    chol_factor_batched(H)
    chol_solve_batched(H, b)
    chol_factor_solve_batched(H, b)
    batched_chol.chol_any(H)
    assert batched_chol.LAUNCHES == before


def test_wrappers_refuse_instead_of_falling_back(monkeypatch, tmp_path):
    H = torch.eye(4)[None]
    b = torch.ones((1, 4))
    # the launch path never takes a CPU tensor
    for name, inputs, outputs in (("chol_factor", (H,), (H,)),
                                  ("chol_solve", (H, b), (b,)),
                                  ("chol_factor_solve", (H, b), (b, H))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            batched_chol._launch(name, inputs, outputs, 4)
    # a tensor on neither device, a wrong dtype or size is refused
    with pytest.raises(ValueError, match="unsupported device"):
        chol_factor_batched(torch.empty((1, 4, 4), device="meta"))
    with pytest.raises(TypeError, match="float32/float64"):
        chol_factor_batched(torch.eye(4, dtype=torch.float16)[None])
    with pytest.raises(ValueError, match="n <= 64"):
        chol_factor_batched(torch.eye(65)[None])
    with pytest.raises(ValueError, match="b must be"):
        chol_solve_batched(H, torch.ones((1, 3)))
    # no toolkit: the build raises rather than returning a stand-in
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all(["batched_chol"])
