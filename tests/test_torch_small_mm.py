"""PyTorch port, kernel module ops/small_mm.py (K5).

The Pallas kernel `_mm_kernel` lives in a microbenchmark outside the JAX
package (scratch/bench_smallmm39.py); it is loaded here by path and run
in interpret mode on the CPU, with that file's BlockSpecs and batch
block, against the port's plain version. XLA's CPU path contracts or
reorders the kernel's unrolled sum, so the two agree to rounding, not
bit for bit: max |P - J| / max |X @ Y| is about 3e-7 in float32 and
4e-16 in float64. On the card the kernel equals the plain version bit
for bit (chip_smoke.py); here the wrapper must refuse, not fall back.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu_torch.ops import small_mm, small_mm_batched

torch.set_num_threads(1)

_BENCH = Path(__file__).resolve().parents[1] / "scratch" / "bench_smallmm39.py"


@functools.lru_cache(maxsize=1)
def _pallas_module():
    spec = importlib.util.spec_from_file_location("bench_smallmm39", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_mm_interpret(X, Y):
    """`pallas_mm` of the microbenchmark with interpret=True: the batch
    moved onto the last axis, padded to the batch block, one grid step
    per block."""
    mod = _pallas_module()
    B, n, _ = X.shape
    a, b = jnp.moveaxis(X, 0, -1), jnp.moveaxis(Y, 0, -1)
    pad = (-B) % mod._TB
    if pad:
        a = jnp.pad(a, ((0, 0), (0, 0), (0, pad)))
        b = jnp.pad(b, ((0, 0), (0, 0), (0, pad)))
    Bp = a.shape[-1]
    block = mod.pl.BlockSpec((n, n, mod._TB), lambda i: (0, 0, i),
                             memory_space=mod.pltpu.VMEM)
    out = mod.pl.pallas_call(
        functools.partial(mod._mm_kernel, n=n),
        out_shape=jax.ShapeDtypeStruct((n, n, Bp), X.dtype),
        grid=(Bp // mod._TB,), in_specs=[block, block], out_specs=block,
        interpret=True)(a, b)
    return np.asarray(jnp.moveaxis(out[:, :, :B], -1, 0))


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-6),
                                         (np.float64, 1e-13)])
@pytest.mark.parametrize("n,B", [(1, 130), (20, 131), (39, 200), (64, 129)])
def test_plain_matches_pallas_interpret(n, B, dtype, bound):
    """B ragged against the 128-wide batch block."""
    rng = np.random.default_rng(1000 * n + B)
    X = rng.normal(size=(B, n, n)).astype(dtype)
    Y = rng.normal(size=(B, n, n)).astype(dtype)
    ref = _pallas_mm_interpret(jnp.asarray(X), jnp.asarray(Y))
    ours = small_mm.small_mm_plain(torch.as_tensor(X), torch.as_tensor(Y))
    assert ours.dtype == torch.from_numpy(X).dtype
    scale = np.max(np.abs(X.astype(np.float64) @ Y.astype(np.float64)))
    assert np.max(np.abs(ours.numpy() - ref)) <= bound * scale


def test_wrapper_on_cpu_is_the_plain_version_without_launch():
    rng = np.random.default_rng(3)
    before = small_mm.LAUNCHES
    for dtype in (torch.float32, torch.float64):
        X = torch.as_tensor(rng.normal(size=(7, 39, 39)), dtype=dtype)
        Y = torch.as_tensor(rng.normal(size=(7, 39, 39)), dtype=dtype)
        got = small_mm_batched(X, Y)
        assert torch.equal(got, small_mm.small_mm_plain(X, Y))
        torch.testing.assert_close(got, X @ Y)
    # NaN and infinity go through the same recurrence
    X = torch.ones((2, 3, 3), dtype=torch.float64)
    X[0, 1, 2] = float("nan")
    X[1, 0, 0] = float("inf")
    Y = torch.ones((2, 3, 3), dtype=torch.float64)
    Y[1, 0, 1] = -1.0
    got = small_mm_batched(X, Y)
    assert torch.isnan(got[0, 1]).all() and torch.isfinite(got[0, [0, 2]]).all()
    assert got[1, 0, 0] == float("inf") and got[1, 0, 1] == -float("inf")
    assert small_mm.LAUNCHES == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    X = torch.ones((2, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        small_mm._small_mm_cuda(X, X, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        small_mm_batched(torch.empty((1, 4, 4), device="meta"),
                         torch.empty((1, 4, 4), device="meta"))
    with pytest.raises(TypeError, match="float32/float64"):
        small_mm_batched(X.half(), X.half())
    with pytest.raises(TypeError, match="float32/float64"):
        small_mm_batched(X, X.double())
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        small_mm_batched(torch.ones((2, 4, 3)), torch.ones((2, 3, 4)))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        small_mm_batched(X, torch.ones((3, 4, 4)))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        small_mm_batched(X[0], X[0])
    with pytest.raises(ValueError, match="n <= 64"):
        small_mm_batched(torch.ones((1, 65, 65)), torch.ones((1, 65, 65)))
