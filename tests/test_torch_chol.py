"""PyTorch port, kernel module ops/batched_chol.py (K2, K3, K4).

The plain versions run the recurrences of the Pallas kernels
`_chol_kernel` / `_solve_kernel` in the same order, so they agree with
the kernels in interpret mode (as tests/test_ops.py runs them) to
rounding. Interpret mode grows steeply with n here, so larger n are held
against the JAX package's `chol_any`, which is LAPACK on the CPU. The
CUDA kernels run only on the card (chip_smoke.py holds them against the
plain versions there); here the wrappers must refuse, not fall back, and
PyTorch models of the row branch's schedule (K2, K3, K4 at n <= 32) and
of K2's block branch (n = 33..64) are held bit for bit against the plain
versions.
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


@pytest.mark.parametrize("n", [1, 2, 5, 8, 11])
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


@pytest.mark.parametrize("n", [16, 24, 32, 39, 64, 70])
def test_chol_any_matches_jax_at_larger_n(n):
    """n = 24 is the dense IPM's nv on the pendulum, 16 and 32 are the
    ends of the kernel's row branch (n <= 32); 70 is past the
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


def test_launch_passes_its_source_to_the_build(monkeypatch):
    """_launch(..., source=path) loads the library built from that path
    (a copy of the kernels' source), and the wrappers default to the
    package's own."""
    asked = []

    class Loaded(Exception):
        pass

    def load(name):
        asked.append(name)
        raise Loaded

    class OnCard:  # reaches the build without a card
        device = torch.device("cuda")
        dtype = torch.float32
        shape = (3, 4, 4)

    monkeypatch.setattr(cuda_build, "load", load)
    for source in ("/some/copy/batched_chol.cu", "batched_chol"):
        with pytest.raises(Loaded):
            batched_chol._launch("chol_factor", (OnCard(),), (OnCard(),), 4,
                                 source=source)
    with pytest.raises(Loaded):
        batched_chol._launch("chol_solve", (OnCard(), OnCard()), (OnCard(),),
                             4)
    assert asked == ["/some/copy/batched_chol.cu", "batched_chol",
                     "batched_chol"]


class _Warps:
    """The row branch's lane layout (csrc/batched_chol.cu, chol_rows) for
    a (B, n, n) batch: n is padded with the identity to its band NP (4, 8,
    16, 24, 32) and the batch with identity matrices to whole warps; a
    group of W lanes (the power of two at or above NP) holds a matrix,
    lane l row l % W of matrix l // W, rows past NP zero. `S` holds each
    lane's whole row (upper triangle included, which the kernel may read
    and must not use) as (warps, 32, NP); `r` its entry of b (0 from n
    on)."""

    def __init__(self, M: torch.Tensor, b: torch.Tensor | None = None):
        self.B, self.n, _ = M.shape
        self.NP = next(band for band in (4, 8, 16, 24, 32) if self.n <= band)
        self.W = 1 << (self.NP - 1).bit_length()
        G = 32 // self.W
        self.warps = -(-self.B // G)
        lane = torch.arange(32)
        self.gl, self.grp = lane % self.W, lane // self.W
        self.row = self.gl < self.NP
        Mp = torch.eye(self.NP, dtype=M.dtype).repeat(self.warps * G, 1, 1)
        Mp[:self.B, :self.n, :self.n] = M
        self.S = torch.zeros((self.warps, 32, self.NP), dtype=M.dtype)
        self.S[:, self.row] = Mp.reshape(self.warps, G, self.NP, self.NP)[
            :, self.grp[self.row], self.gl[self.row]]
        bp = torch.zeros((self.warps * G, self.NP), dtype=M.dtype)
        if b is not None:
            bp[:self.B, :self.n] = b
        self.r = torch.zeros((self.warps, 32), dtype=M.dtype)
        self.r[:, self.row] = bp.reshape(self.warps, G, self.NP)[
            :, self.grp[self.row], self.gl[self.row]]

    def lane_of(self, i):
        """Lane i of each lane's group (what __shfl_sync(v, i, W) reads)."""
        return self.grp * self.W + i

    def factor(self) -> torch.Tensor:
        """The factor's steps on S in place; returns each lane's failure
        flag (False where a pivot was <= 0 or not finite). At step j the
        group's diagonal comes from lane j; every lane takes d = sqrt and
        1 / d, scales its entry j (lane j keeps d), publishes it in the
        group's column slot and subtracts L[i][j] L[c][j] from every entry
        c > j."""
        S, gl, NP = self.S, self.gl, self.NP
        ok = torch.ones((self.warps, 32), dtype=torch.bool)
        for j in range(NP):
            piv = S[:, self.lane_of(j), j]
            ok = ok & (piv > 0) & torch.isfinite(piv)
            d = torch.sqrt(piv)
            S[:, :, j] = torch.where(gl == j, d, S[:, :, j] * (1.0 / d))
            slot = S[:, :, j]                     # the group's column slot
            Lc = slot[:, self.grp[:, None] * self.W + torch.arange(j + 1, NP)]
            S[:, :, j + 1:] = S[:, :, j + 1:] - slot[..., None] * Lc
        return ok

    def solve(self) -> torch.Tensor:
        """The substitutions on the rows of L in S and b in r; returns
        each lane's x. Forward: at step i every lane divides lane i's r by
        lane i's L[i][i], lanes below subtract L[c][i] y_i, lane i keeps
        y_i. Back: at step i every lane k publishes L[k][i] x_k in the
        group's slot (+0 for a row past n), and every lane subtracts the
        slot's entries k > i from y_i in ascending k and divides by
        L[i][i]; lane i keeps x_i."""
        S, gl, r = self.S, self.gl, self.r.clone()
        for i in range(self.NP):
            y = r[:, self.lane_of(i)] / S[:, self.lane_of(i), i]
            r = torch.where(gl > i, r - S[:, :, i] * y, r)
            r = torch.where(gl == i, y, r)
        x = torch.zeros_like(r)
        for i in reversed(range(self.NP)):
            slot = torch.where(gl < self.n, S[:, :, i] * x, 0.0)
            s = r[:, self.lane_of(i)]
            for k in range(i + 1, self.NP):
                s = s - slot[:, self.lane_of(k)]
            x = torch.where(gl == i, s / S[:, self.lane_of(i), i], x)
        return x

    def rows(self, R: torch.Tensor) -> torch.Tensor:
        """A value a lane, (warps, 32, ...) -> the batch's (B, n, ...)."""
        out = R[:, self.row].reshape((-1, self.NP) + R.shape[2:])
        return out[:self.B, :self.n]

    def stored(self, ok: torch.Tensor) -> torch.Tensor:
        """L as the kernel stores it: each row's lower triangle, 0 above,
        NaN throughout where the group's failure flag fell."""
        lower = torch.where(torch.arange(self.NP) <= self.gl[:, None],
                            self.S, 0.0)
        L = torch.where(ok[..., None], lower, float("nan"))
        return self.rows(L)[..., :self.n]


def _row_branch_schedule(H: torch.Tensor) -> torch.Tensor:
    """A PyTorch model of K2's row branch as a warp of 32 lanes runs it
    (_Warps): the factor's steps, then L as stored."""
    w = _Warps(H)
    return w.stored(w.factor())


def _row_solve_schedule(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3's row branch: the substitutions on L's rows as loaded."""
    w = _Warps(L, b)
    return w.rows(w.solve())


def _row_factor_solve_schedule(H: torch.Tensor, b: torch.Tensor):
    """K4's row branch: the factor's steps, then the substitutions on the
    rows the factor leaves in the registers (garbage above the diagonal
    included); x and L NaN throughout where the failure flag fell."""
    w = _Warps(H, b)
    ok = w.factor()
    return w.rows(torch.where(ok, w.solve(), float("nan"))), w.stored(ok)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 13, 16, 21, 24, 31, 32])
def test_row_branch_schedule_is_bit_for_bit_plain(n, dtype):
    """The row branch's schedule (right-looking order, identity padding to
    the band, groups of matrices a warp, a failure flag a group) equals
    chol_factor_plain to the last bit, NaN in exactly the same matrices:
    SPD ones, indefinite ones, ones with NaN or inf in the lower triangle,
    and SPD ones with NaN or inf above the diagonal (never read), in a
    batch that ends inside a warp."""
    rng = np.random.default_rng(700 + n)
    B = 37
    H = _spd(rng, B, n) / n
    H[1::5, n // 2, n // 2] = -1.0
    H[2::7, n - 1, 0] = np.nan
    H[3::11, n // 3, n // 3] = np.inf
    if n > 1:
        H[4::6, 0, n - 1] = np.nan
        H[5::9, 0, 1] = -np.inf
    Ht = torch.as_tensor(H, dtype=dtype)
    ours = _row_branch_schedule(Ht)
    plain = batched_chol.chol_factor_plain(Ht)
    bad = torch.isnan(plain).flatten(1).all(1)
    assert bool(bad.any()) and not bool(bad.all())
    assert torch.equal(torch.isnan(ours), torch.isnan(plain))
    assert torch.equal(ours[~bad], plain[~bad])


def _bad_matrices(H, n):
    """Indefinite matrices, NaN and inf in the lower triangle, NaN and inf
    above the diagonal (never read), as rows of a batch of 37."""
    H[1::5, n // 2, n // 2] = -1.0
    H[2::7, n - 1, 0] = np.nan
    H[3::11, n // 3, n // 3] = np.inf
    if n > 1:
        H[4::6, 0, n - 1] = np.nan
        H[5::9, 0, 1] = -np.inf
    return H


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 13, 16, 21, 24, 31, 32])
def test_row_solve_schedule_is_bit_for_bit_plain(n, dtype, kernel):
    """The row branch's substitutions (forward: y_i by one broadcast;
    back: products in the group's slot, +0 from row n on, subtracted in
    ascending k; identity padding to the band, groups of matrices a warp)
    equal chol_solve_plain (K3) and chol_factor_solve_plain (K4) to the
    last bit, NaN in exactly the same entries, in a batch that ends
    inside a warp. K4 on the bad matrices of the factor's test, which
    come back NaN in x and L; K3 on factors with NaN and inf above the
    diagonal (never read) and with a zero or a NaN on the diagonal."""
    rng = np.random.default_rng(900 + n)
    B = 37
    H = _spd(rng, B, n) / n
    b = torch.as_tensor(rng.normal(size=(B, n)), dtype=dtype)
    if kernel == "K4":
        Ht = torch.as_tensor(_bad_matrices(H, n), dtype=dtype)
        x, L = _row_factor_solve_schedule(Ht, b)
        xp, Lp = batched_chol.chol_factor_solve_plain(Ht, b)
        bad = torch.isnan(Lp).flatten(1).all(1)
        assert bool(bad.any()) and not bool(bad.all())
        assert torch.equal(torch.isnan(x).all(1), bad)
        pairs = ((x, xp), (L, Lp))
    else:
        L = batched_chol.chol_factor_plain(torch.as_tensor(H, dtype=dtype))
        above = torch.ones(n, n, dtype=torch.bool).triu(1)
        L[1::3, above] = float("nan")
        L[2::3, above] = float("inf")
        L[3::4, n - 1, n - 1] = 0.0
        L[4::5, n // 2, n // 2] = float("nan")
        xp = batched_chol.chol_solve_plain(L, b)
        assert bool(torch.isnan(xp).any()) and bool(torch.isfinite(xp).any())
        pairs = ((_row_solve_schedule(L, b), xp),)
    for ours, plain in pairs:
        nan = torch.isnan(plain)
        assert torch.equal(torch.isnan(ours), nan)
        assert torch.equal(ours[~nan], plain[~nan])


_CU = batched_chol.cuda_build.CSRC / "batched_chol.cu"


def _block_threads():
    """(general threads, entries a thread) of the block branch, as
    csrc/batched_chol.cu sets them."""
    import re
    src = _CU.read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       src).group(1))
    general, group = const("kBlockGeneral"), const("kBlockGroup")
    per = -(-(64 * 63 // 2 - 1) // general)
    return general, -(-per // group) * group


def _block_entries(n: int) -> list:
    """(q, i, k) of every general thread's entries, numbered as chol_block
    numbers them: q counts a trailing triangle from its bottom-right
    corner column by column (k' = n-1-k, i' = n-1-i, q = k'(k'+1)/2 + i'),
    and thread t owns q = t + e * general."""
    import math
    general, per = _block_threads()
    out = []
    for t in range(general):
        for e in range(per):
            q = t + e * general
            kp = (math.isqrt(8 * q + 1) - 1) // 2
            out.append((q, n - 1 - (q - kp * (kp + 1) // 2), n - 1 - kp))
    return out


def _block_schedule(H: torch.Tensor) -> torch.Tensor:
    """A PyTorch model of K2's block branch (chol_block) on a (B, n, n)
    batch, a block a matrix: the lower triangle loaded (the upper read as
    NaN, so a read of it would show), pivots 0 and 1 taken from it; then
    two columns j, j + 1 a step: the pivot thread gives the next corner,
    (j+2, j+2), (j+3, j+2) and (j+3, j+3), the step's products (L[i][j+1]
    = (S[i][j+1] - L[i][j] L[j+1][j]) / d_j+1 taken from column j + 1 as
    it lies, never updated), takes pivots j + 2 and j + 3 and writes
    (j+3, j+2); the general threads subtract both columns' products from
    their entries q < P - 2 but the corner (j+3, j+3) of the triangle of
    rows and columns >= j + 2; a failed pivot sets the block's flag and
    the steps run on; then L as stored, an odd column taking column
    c - 1's product first. Asserts at each step that the general entries
    are that triangle less its corner, each once."""
    B, n = H.shape[0], H.shape[-1]
    entries = _block_entries(n)
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    S = torch.where(lower, H, float("nan"))
    dg = torch.zeros((B, n), dtype=H.dtype)
    iv = torch.zeros_like(dg)

    def pivot(p, j):
        d = torch.sqrt(p)
        dg[:, j], iv[:, j] = d, 1.0 / d
        return (p > 0) & torch.isfinite(p)

    ok = pivot(S[:, 0, 0], 0)
    if n > 1:
        l = S[:, 1, 0] * iv[:, 0]
        ok &= pivot(S[:, 1, 1] - l * l, 1)
    for j in range(0, n - 2, 2):
        m = n - 2 - j
        P = m * (m + 1) // 2
        i0, i1 = iv[:, j].clone(), iv[:, j + 1].clone()
        lc = S[:, j + 1, j] * i0
        # the pivot thread
        l20 = S[:, j + 2, j] * i0
        l21 = (S[:, j + 2, j + 1] - l20 * lc) * i1
        ok &= pivot((S[:, j + 2, j + 2] - l20 * l20) - l21 * l21, j + 2)
        corner = [(j + 2, j + 2)]
        if m > 1:
            l30 = S[:, j + 3, j] * i0
            l31 = (S[:, j + 3, j + 1] - l30 * lc) * i1
            s32 = (S[:, j + 3, j + 2] - l30 * l20) - l31 * l21
            l32 = s32 * iv[:, j + 2]
            ok &= pivot(((S[:, j + 3, j + 3] - l30 * l30) - l31 * l31)
                        - l32 * l32, j + 3)
            corner += [(j + 3, j + 2), (j + 3, j + 3)]
        # the general threads
        act = [(i, k) for q, i, k in entries
               if q < P - 2 and q != P - m - 1]
        assert sorted(act) == [(i, k) for i in range(j + 2, n)
                               for k in range(j + 2, i + 1)
                               if (i, k) not in corner]
        if act:
            i_, k_ = torch.tensor(act).T
            li0 = S[:, i_, j] * i0[:, None]
            lk0 = S[:, k_, j] * i0[:, None]
            li1 = (S[:, i_, j + 1] - li0 * lc[:, None]) * i1[:, None]
            lk1 = (S[:, k_, j + 1] - lk0 * lc[:, None]) * i1[:, None]
            S[:, i_, k_] = (S[:, i_, k_] - li0 * lk0) - li1 * lk1
        if m > 1:
            S[:, j + 3, j + 2] = s32
    L = torch.diag_embed(dg)
    for c in range(n - 1):
        s = S[:, c + 1:, c]
        if c % 2:
            s = s - (S[:, c + 1:, c - 1] * iv[:, c - 1, None]) * (
                S[:, c, c - 1] * iv[:, c - 1])[:, None]
        L[:, c + 1:, c] = s * iv[:, c, None]
    return torch.where(ok[:, None, None], L, float("nan"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 15, 33, 39, 48, 63, 64])
def test_block_branch_schedule_is_bit_for_bit_plain(n, dtype):
    """K2's block branch (n = 33..64 up to 512 matrices; n <= 32 only in
    k2_compare.py's "allblock" build): its schedule (right-looking, two
    columns a step, the entries of each trailing triangle owned by the
    same threads every step, the next two pivots taken beside the update,
    a failed pivot flagging the block) equals chol_factor_plain to the last bit, NaN in exactly the same
    matrices: SPD ones, indefinite ones, ones with NaN or inf in the lower
    triangle, and SPD ones with NaN or inf above the diagonal (never
    read)."""
    rng = np.random.default_rng(1100 + n)
    H = _bad_matrices(_spd(rng, 37, n) / n, n)
    Ht = torch.as_tensor(H, dtype=dtype)
    ours = _block_schedule(Ht)
    plain = batched_chol.chol_factor_plain(Ht)
    bad = torch.isnan(plain).flatten(1).all(1)
    assert bool(bad.any()) and not bool(bad.all())
    assert torch.equal(torch.isnan(ours), torch.isnan(plain))
    assert torch.equal(ours[~bad], plain[~bad])


def test_block_branch_fails_at_every_pivot():
    """A failed pivot at each column j of n = 39 (H[j][j] = -1, an inf or
    a NaN on the diagonal, a NaN below it in column j): the block stores
    NaN throughout, as chol_factor_plain returns; the matrix beside them
    stays bit for bit."""
    n = 39
    rng = np.random.default_rng(1200)
    H = _spd(rng, 4 * n + 1, n) / n
    for j in range(n):
        H[j, j, j] = -1.0
        H[n + j, j, j] = np.inf
        H[2 * n + j, j, j] = np.nan
        H[3 * n + j, n - 1, j] = np.nan if j < n - 1 else -np.inf
    Ht = torch.as_tensor(H, dtype=torch.float32)
    ours = _block_schedule(Ht)
    plain = batched_chol.chol_factor_plain(Ht)
    bad = torch.isnan(plain).flatten(1).all(1)
    assert bad[:-1].all() and not bad[-1]
    assert torch.isnan(ours[:-1]).all()
    assert torch.equal(ours[-1], plain[-1])


def test_k2_step_mix_reads_the_row_branch():
    """k2_compare.step_mix on a listing holding K2's and K3's kernels of
    the row branch (and an earlier source's K2 name) beside another
    kernel: a step is the span between the first and the last division's
    reciprocal before the final EXIT (the slow paths' subroutines follow
    it) over their count less one, other functions are skipped;
    step_listing gives one step's instructions, reciprocal to
    reciprocal."""
    import k2_compare

    def function(name, ops):
        return "\n".join(
            [f"\t\tFunction : {name}"]
            + [f"        /*{16 * i:04x}*/                   {op} ;"
               f"   /* 0x000000000000000000000000000000 */"
               for i, op in enumerate(ops)])

    step = (["MUFU.RCP R4, R3", "SHFL.IDX PT, R3, R2, 0x1, 0x1f"]
            + ["FMUL R5, R6, R7", "FADD R8, R8, -R5"] * 10
            + ["STS [R9], R5", "LDS.128 R12, [R10]", "@!P0 BRA 0x10"])
    rows = ["LDG.E.128 R12, [R2.64]"] + step * 4 + [
        "MUFU.RCP R4, R3", "STG.E [R2.64], R3", "EXIT",
        "MUFU.RCP R4, R3", "RET.REL.NODEC R4 0x0"]  # a slow path's call
    back = (["SHFL.IDX PT, R3, R2, 0x1, 0x1f", "MUFU.RCP R4, R3",
             "STS [R9], R5", "LDS.128 R12, [R10]"]
            + ["FADD R8, R8, -R5"] * 4)
    solve = ["LDG.E R12, [R2.64]"] + back * 8 + ["STG.E [R2.64], R3", "EXIT"]
    sass = "\n".join([
        "\tcode for sm_90a",
        function("_ZN12_GLOBAL__N_19chol_rowsIfLi4ELNS_2OpE0EEEvPKT_S4_PS2_"
                 "S5_xib", rows),
        function("_ZN12_GLOBAL__N_19chol_rowsIfLi4ELNS_2OpE1EEEvPKT_S4_PS2_"
                 "S5_xib", solve),
        function("_ZN12_GLOBAL__N_116chol_factor_rowsIdLi8EEEvPKT_PS1_xib",
                 rows),
        function("_ZN12_GLOBAL__N_111chol_kernelIfLNS_2OpE0EEEvPKT_S4_PS2_"
                 "S5_xi", ["MUFU.RCP R4, R3"] * 3)])
    k2, k3, d8 = k2_compare.step_mix(sass)
    assert (k2["band"], k3["band"], d8["band"]) == ("f4", "f4 K3", "d8")
    assert k2["instructions"] == len(rows) and k2["steps"] == 5
    assert k2["per_step"] == len(step) and d8 == dict(k2, band="d8")
    assert (k2["mul_add"], k2["mufu"], k2["shuffle"]) == (20, 1, 1)
    assert k2["shared"] == 2 and k2["branch"] == 1
    assert k3["steps"] == 8 and k3["per_step"] == len(back)
    assert (k3["shared"], k3["mul_add"], k3["shuffle"]) == (2, 4, 1)
    listing = k2_compare.step_listing(sass, band="f4", step=1)
    assert listing == [op.strip() for op in step] + [step[0]]
    listing = k2_compare.step_listing(sass, band="f4 K3", step=2)
    assert listing == back[1:] + back[:2]


# ---------------------------------------------------------------------------
# K2's forward-mode and vmap rules (the JAX package's custom_jvp and
# custom_vmap of chol_any)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 24])
def test_chol_any_jvp_matches_jax_custom_jvp(n):
    """torch.func.jvp through the port's rule (dL = L phi(L^-1 dH L^-T))
    against jax.jvp through the JAX custom_jvp, symmetric tangents."""
    rng = np.random.default_rng(30 + n)
    H = _spd(rng, 3, n)
    dH = rng.normal(size=(3, n, n))
    dH = dH + np.swapaxes(dH, 1, 2)
    ref_p, ref_t = jax.jvp(jchol.chol_any, (jnp.asarray(H),),
                           (jnp.asarray(dH),))
    out_p, out_t = torch.func.jvp(batched_chol.chol_any,
                                  (torch.as_tensor(H),),
                                  (torch.as_tensor(dH),))
    for o, r in ((out_p, ref_p), (out_t, ref_t)):
        r = np.asarray(r)
        assert np.max(np.abs(o.numpy() - r)) <= 1e-11 * np.max(np.abs(r))


def test_chol_any_hessian_matches_jax():
    """torch.func.hessian of a scalar of chol(X X' + n I) against
    jax.hessian through the JAX custom_jvp."""
    n = 3
    rng = np.random.default_rng(33)
    X, W = rng.normal(size=(n, n)), rng.normal(size=(n, n))
    ref = np.asarray(jax.hessian(
        lambda X: jnp.sum(jnp.asarray(W) * jchol.chol_any(
            _sym_input(X, n))) ** 2)(jnp.asarray(X)))
    out = torch.func.hessian(
        lambda X: (torch.as_tensor(W) * batched_chol.chol_any(
            _sym_input(X, n))).sum() ** 2)(torch.as_tensor(X))
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_chol_any_vmap_matches_unbatched():
    H = torch.as_tensor(_spd(np.random.default_rng(34), 24, 5)).reshape(
        2, 3, 4, 5, 5)
    out = torch.func.vmap(torch.func.vmap(torch.func.vmap(
        batched_chol.chol_any)))(H)
    np.testing.assert_array_equal(
        out.reshape(24, 5, 5).numpy(),
        chol_factor_batched(H.reshape(24, 5, 5)).numpy())


def test_chol_any_forward_ad_gradcheck():
    """Forward and reverse mode, batched, and second order, through a
    symmetric input."""
    X = torch.tensor(np.random.default_rng(35).normal(size=(2, 4, 4)),
                     requires_grad=True)
    f = lambda X: batched_chol.chol_any(_sym_input(X, 4))
    assert torch.autograd.gradcheck(f, (X,), check_forward_ad=True,
                                    check_batched_grad=True,
                                    check_batched_forward_grad=True)
    assert torch.autograd.gradgradcheck(f, (X,), check_fwd_over_rev=True,
                                        check_batched_grad=True)


def test_vmap_over_three_axes_is_one_kernel_call(monkeypatch):
    """A vmap over 3 axes, and a jacfwd's tangent axis, reach K2's
    wrapper once each."""
    calls = []
    orig = batched_chol.chol_factor_batched

    def counting(H, source="batched_chol"):
        calls.append(tuple(H.shape))
        return orig(H, source)

    monkeypatch.setattr(batched_chol, "chol_factor_batched", counting)
    H = torch.as_tensor(_spd(np.random.default_rng(36), 24, 5)).reshape(
        2, 3, 4, 5, 5)
    torch.func.vmap(torch.func.vmap(torch.func.vmap(
        batched_chol.chol_any)))(H)
    assert calls == [(24, 5, 5)]
    calls.clear()
    torch.func.vmap(torch.func.jacfwd(batched_chol.chol_any))(H[0, 0])
    assert calls == [(4, 5, 5)]
