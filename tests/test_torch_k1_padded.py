"""PyTorch port, K1's padded group branch (csrc/gj_inverse.cu).

At n = 3, 5-7 and 9-15 the kernel's group branch inverts the padded
matrix [[A, 0], [0, I]] in the band the next power of two (4, 8, 16):
the identity block never pivots, only the first n steps run, and the
top-left block is A^-1. Here the PyTorch model of the group and warp
branches' schedule (tests/test_torch_ops.py:_row_owned_schedule) runs on
that padded matrix, stopped at step n, and must give gj_inverse_plain's
result bit for bit, the identity's rows losing every pivot search (the
warp branch pads the same way up to its band and runs every step, so
both branches compute the same bits). The kernel itself runs only on the
card, where chip_smoke.py and k1_compare.py hold it against the plain
version and against the warp branch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.ops.batched_inv import _gj_inverse_pallas
from acados_tpu_torch.ops import batched_inv
from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
from test_torch_ops import _row_owned_schedule, _well_conditioned

torch.set_num_threads(1)

PADDED_N = (3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15)


def _band(n: int) -> int:
    """The group branch's band of a padded n: the next power of two."""
    return 1 << (n - 1).bit_length()


def _batch(kind: str, n: int, rng) -> np.ndarray:
    if kind == "random":
        return _well_conditioned(rng, 64, n)
    if kind == "rows_permuted":
        return row_permuted_batch(rng, 64, n)
    A, _ = pivot_tie_batch(rng, 256, n)
    return A


def _padded(A: torch.Tensor, band: int) -> torch.Tensor:
    """[[A, 0], [0, I]] of order band."""
    B, n, _ = A.shape
    P = torch.eye(band, dtype=A.dtype).repeat(B, 1, 1)
    P[:, :n, :n] = A
    return P


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["random", "rows_permuted", "ties"])
@pytest.mark.parametrize("n", PADDED_N)
def test_padded_schedule_is_bit_for_bit_plain(n, kind, dtype):
    """The schedule on the padded matrix, stopped at step n, on A and on
    A as a transposed view (strides (n^2, 1, n), the layout the IRK hands
    K1): its top-left block is gj_inverse_plain(A) bit for bit, the rest
    the identity's, and no identity row wins a pivot before step n."""
    rng = np.random.default_rng(600 + n)
    A = torch.as_tensor(_batch(kind, n, rng), dtype=dtype)
    assert len(A) >= 16
    if kind != "random":
        col0 = A[:, :, 0].abs()
        assert bool((col0.argmax(dim=1) != 0).any())       # rows swap
    plain = batched_inv.gj_inverse_plain(A)
    view = A.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert batched_inv.input_layout(view) == "transposed"
    band = _band(n)
    for X in (A, view):
        winners = []
        out = _row_owned_schedule(_padded(X, band), steps=n, winners=winners)
        assert len(winners) == n
        assert all(bool((w < n).all()) for w in winners)
        np.testing.assert_array_equal(out[:, :n, :n].numpy(), plain.numpy())
        np.testing.assert_array_equal(
            out[:, n:, n:].numpy(),
            np.broadcast_to(np.eye(band - n), (len(A), band - n, band - n)))
        assert float(out[:, n:, :n].abs().max()) == 0.0
        np.testing.assert_array_equal(
            batched_inv.gj_inverse_any(X).numpy(), plain.numpy())


@pytest.mark.parametrize("n", PADDED_N)
def test_padded_schedule_full_band_matches(n):
    """The steps past n change nothing: the schedule run through the
    whole band, as the warp branch runs its padding, gives the same
    top-left block bit for bit as the one stopped at n."""
    rng = np.random.default_rng(700 + n)
    A = torch.as_tensor(row_permuted_batch(rng, 64, n))
    P = _padded(A, _band(n))
    stopped = _row_owned_schedule(P, steps=n)
    full = _row_owned_schedule(P)
    np.testing.assert_array_equal(full[:, :n, :n].numpy(),
                                  stopped[:, :n, :n].numpy())


@pytest.mark.parametrize("n,B", [(9, 12), (15, 6)])
def test_plain_matches_jax_gauss_jordan_padded_orders(n, B):
    """gj_inverse_plain against the Pallas kernel in interpret mode at
    two orders of the padded branch's largest band, as
    tests/test_torch_ops.py::test_plain_matches_jax_gauss_jordan runs
    it."""
    rng = np.random.default_rng(100 + n)
    A = _well_conditioned(rng, B, n)
    ours = batched_inv.gj_inverse_plain(torch.as_tensor(A)).numpy()
    pallas = np.asarray(_gj_inverse_pallas(jnp.asarray(A)))
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-12)


def test_gj_route_reads_the_library(monkeypatch):
    """gj_route decodes the library's gj_inverse_route (16 x band + rows a
    lane, 16 x band for the warp branch, -1 off the kernel's range); the
    library here is a stand-in that follows csrc/gj_inverse.cu's
    group_band and group_rows."""
    def route(n):
        if not 1 <= n <= 48:
            return -1
        if 2 <= n <= 16:
            band = _band(n)
            return 16 * band + (1 if n == 2 or n >= 9 else 2)
        return 16 * (-(-n // 8) * 8)

    class Lib:
        gj_inverse_route = staticmethod(route)

    monkeypatch.setattr(batched_inv.cuda_build, "load", lambda name: Lib)
    assert batched_inv.gj_route(9) == ("group", 16, 1)
    assert batched_inv.gj_route(3) == ("group", 4, 2)
    assert batched_inv.gj_route(16) == ("group", 16, 1)
    assert batched_inv.gj_route(1) == ("warp", 8, None)
    assert batched_inv.gj_route(39) == ("warp", 40, None)
    with pytest.raises(ValueError):
        batched_inv.gj_route(49)
