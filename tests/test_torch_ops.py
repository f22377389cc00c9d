"""PyTorch port, kernel module ops/batched_inv.py and ops/linsolve.py.

The plain version of the Gauss-Jordan kernel K1 runs the same algorithm
as the Pallas kernel (here in interpret mode, as tests/test_ops.py runs
it) and as the JAX in-line Gauss-Jordan, so they agree to rounding. The
CUDA kernel itself runs only on the card (chip_smoke.py holds it against
this plain version there); here the wrapper must refuse, not fall back.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acados_tpu.ops.batched_inv import _gj_inverse_pallas
from acados_tpu.ops.batched_inv import _schur_inverse as jax_schur_inverse
from acados_tpu.ops.linsolve import gj_inverse as jax_gj_inverse
from acados_tpu.ops.linsolve import linsolve as jax_linsolve
from acados_tpu_torch.ops import batched_inv, cuda_build
from acados_tpu_torch.ops.linsolve import linsolve
from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
from acados_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)


def _well_conditioned(rng, B, n):
    """Seeded batch with a forced row swap at instance 0."""
    A = rng.normal(size=(B, n, n)) + 0.5 * n * np.eye(n)
    if n > 1:
        A[0, 0, 0] = 0.0
    return A


@pytest.mark.parametrize("n,B", [(2, 17), (3, 40), (4, 33), (8, 17),
                                 (16, 33), (21, 9), (29, 9), (39, 9)])
def test_plain_matches_jax_gauss_jordan(n, B):
    rng = np.random.default_rng(100 + n)
    A = _well_conditioned(rng, B, n)
    ours = batched_inv.gj_inverse_plain(torch.as_tensor(A)).numpy()
    pallas = np.asarray(_gj_inverse_pallas(jnp.asarray(A)))
    inline = np.asarray(jax_gj_inverse(jnp.asarray(A)))
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours, inline, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [3, 8, 16])
def test_plain_matches_lapack(n):
    rng = np.random.default_rng(n)
    A = _well_conditioned(rng, 25, n)
    ours = batched_inv.gj_inverse_any(torch.as_tensor(A)).numpy()
    ref = np.linalg.inv(A)
    assert np.max(np.abs(ours - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_pivot_ties_pick_lowest_row():
    """Equal magnitudes in the pivot column: the lowest row index wins,
    as jnp.argmax picks, so the port and the JAX in-line version swap the
    same rows and agree to the last bits (the JAX version swaps by
    one-hot blending, which rounds differently from a plain swap)."""
    A = np.array([[[1.0, 2.0, 0.5], [-1.0, 3.0, 1.0], [1.0, 0.0, 4.0]],
                  [[0.0, 1.0, 2.0], [2.0, 1.0, 0.0], [-2.0, 0.5, 1.0]]])
    ours = batched_inv.gj_inverse_plain(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jax_gj_inverse(jnp.asarray(A))), rtol=0, atol=1e-15)
    np.testing.assert_allclose(ours, np.linalg.inv(A), atol=1e-14)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_pivot_ties_and_swaps_exact(n):
    """On the tie batch (pivot_tie_batch) the plain version, in float64
    and float32, the Pallas kernel (interpret mode) and the JAX in-line
    version all give the exact integer inverse bit for bit; the batch does
    swap rows and meet ties at step 0. A plain version that took the
    highest index among equal magnitudes fails this at each n."""
    A, X = pivot_tie_batch(np.random.default_rng(200 + n), 1024, n)
    assert len(A) >= 128
    np.testing.assert_array_equal(
        batched_inv.gj_inverse_plain(torch.as_tensor(A)).numpy(), X)
    col0 = np.abs(A[:, :, 0])
    assert np.any(np.argmax(col0, axis=1) != 0)          # step-0 swaps
    assert np.any(np.sum(col0 == col0.max(1, keepdims=True), 1) > 1)
    ours32 = batched_inv.gj_inverse_plain(torch.as_tensor(A).float())
    np.testing.assert_array_equal(ours32.numpy(), X.astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(_gj_inverse_pallas(jnp.asarray(A))), X)
    np.testing.assert_array_equal(np.asarray(jax_gj_inverse(jnp.asarray(A))),
                                  X)


@pytest.mark.parametrize("n", [4, 16])
def test_row_permuted_batch_swaps_and_matches(n):
    """Rows in a random order: swaps at most steps, and the plain version
    still agrees with the Pallas kernel and with LAPACK."""
    A = row_permuted_batch(np.random.default_rng(300 + n), 40, n)
    assert np.mean(np.argmax(np.abs(A[:, :, 0]), axis=1) != 0) > 0.5
    ours = batched_inv.gj_inverse_plain(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(_gj_inverse_pallas(jnp.asarray(A))), rtol=0,
        atol=1e-12)
    ref = np.linalg.inv(A)
    assert np.max(np.abs(ours - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_schur_path_n50():
    rng = np.random.default_rng(50)
    A = np.eye(50) - 0.05 * rng.normal(size=(4, 50, 50))
    ours = batched_inv.gj_inverse_any(torch.as_tensor(A)).numpy()
    ref = np.linalg.inv(A)
    assert np.max(np.abs(ours - ref)) <= 1e-9 * np.max(np.abs(ref))
    jax_ref = np.asarray(jax_schur_inverse(jnp.asarray(A)))
    assert np.max(np.abs(ours - jax_ref)) <= 1e-9 * np.max(np.abs(ref))


def test_gradient_gradcheck():
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.normal(size=(3, 2, 4, 4)) + 3 * np.eye(4),
                     requires_grad=True)
    assert torch.autograd.gradcheck(batched_inv.gj_inverse_any, (A,))


def test_leading_axes_flatten_into_one_batch():
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.normal(size=(2, 3, 5, 5)) + 3 * np.eye(5))
    out = batched_inv.gj_inverse_any(A)
    assert out.shape == A.shape
    flat = batched_inv.gj_inverse_any(A.reshape(6, 5, 5))
    np.testing.assert_array_equal(out.reshape(6, 5, 5).numpy(),
                                  flat.numpy())


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_linsolve_cpu(rhs):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(12, 7, 7)) + 3 * np.eye(7)
    b = rng.normal(size=(12, 7) if rhs == "vector" else (12, 7, 3))
    x = linsolve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(
        x, np.asarray(jax_linsolve(jnp.asarray(A), jnp.asarray(b))),
        rtol=0, atol=1e-12)
    ref = (np.linalg.solve(A, b[..., None])[..., 0] if rhs == "vector"
           else np.linalg.solve(A, b))
    np.testing.assert_allclose(x, ref, atol=1e-12)


@pytest.mark.parametrize("n", [4, 16])
def test_linsolve_off_cpu_goes_through_kernel_wrapper(n):
    """Off the CPU linsolve inverts through the kernel wrapper at every n
    (no in-line loop for small n), so a tensor the wrapper does not take
    is refused."""
    A = torch.empty((2, n, n), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        linsolve(A, torch.empty((2, n), device="meta"))


def test_cpu_tensor_takes_plain_version_without_launch():
    before = batched_inv.LAUNCHES
    batched_inv.gj_inverse_any(torch.eye(16, dtype=torch.float64)[None])
    assert batched_inv.LAUNCHES == before


def test_wrapper_refuses_instead_of_falling_back(monkeypatch, tmp_path):
    A = torch.eye(16)[None]
    # the CUDA path never takes a CPU tensor
    with pytest.raises(ValueError, match="CUDA tensor"):
        batched_inv._gj_inverse_cuda(A)
    # a tensor on neither device is refused, not routed to the plain loop
    with pytest.raises(ValueError, match="unsupported device"):
        batched_inv.gj_inverse_any(torch.empty((1, 4, 4), device="meta"))
    # no toolkit: the build raises rather than returning a stand-in
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()


def test_build_names_a_copy_of_a_source_by_path(tmp_path):
    """A library named by the path of a copy of a source is built beside
    the named one: the same file name, its own hash, so an identical copy
    shares the named library and an edited one does not."""
    src = cuda_build.CSRC / cuda_build.SOURCES["gj_inverse"]
    same = tmp_path / "gj_inverse.cu"
    same.write_bytes(src.read_bytes())
    edited = tmp_path / "edited" / "gj_inverse.cu"
    edited.parent.mkdir()
    edited.write_bytes(src.read_bytes() + b"\n// edited\n")
    named = cuda_build.target("gj_inverse")
    assert named.parent == cuda_build.BUILD_DIR
    assert named.name.startswith("libgj_inverse-")
    assert cuda_build.target(str(same)) == named
    assert cuda_build.target(str(edited)) != named
    assert cuda_build.target(str(edited)).name.startswith("libgj_inverse-")


def test_build_runs_one_nvcc_per_distinct_source(monkeypatch, tmp_path):
    """Two names of one source (a name and an identical copy) start one
    nvcc; an edited copy starts its own."""
    src = cuda_build.CSRC / cuda_build.SOURCES["gj_inverse"]
    same = tmp_path / "same" / "gj_inverse.cu"
    edited = tmp_path / "edited" / "gj_inverse.cu"
    for path, extra in ((same, b""), (edited, b"\n// edited\n")):
        path.parent.mkdir()
        path.write_bytes(src.read_bytes() + extra)
    started = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            out = Path(cmd[cmd.index("-o") + 1])
            out.write_bytes(b"")
            started.append(cmd[-1])

        def communicate(self):
            return "", None

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    cuda_build.build_all(["gj_inverse", str(same), str(edited)])
    assert started == [str(src), str(edited)]
    assert cuda_build.target(str(same)).exists()
    assert cuda_build.target(str(edited)).exists()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def _row_owned_schedule(A: torch.Tensor, steps=None,
                        winners=None) -> torch.Tensor:
    """A PyTorch model of the schedule of K1's warp and group branches
    (csrc/gj_inverse.cu, gj_inv_warp and gj_inv_group, which differ only
    in how many lanes hold a matrix): row i stays where it is and
    carries its logical position pos[i]; a swap exchanges two positions,
    and among equal magnitudes the lowest position wins. Each row holds n
    slots: slot j < k holds the inverse's column p_j (p_j the row that
    pivoted at step j), slot j >= k the matrix's column j. At step k the
    pivot row's slots are divided by the pivot, slot k becoming 1 / piv,
    and every other row takes R[j] - f R_piv[j] with f = R[k], slot k
    becoming 0 - f (1 / piv). At the end out[pos[i], p_k] = R[i, k].
    steps: the steps run (default n; the padded group branch stops at
    the order of the matrix it pads, p_k = k past it); winners: a list
    that receives each step's winning position."""
    Bsz, n, _ = A.shape
    R = A.clone()
    b = torch.arange(Bsz)
    rows = torch.arange(n)
    pos = rows.expand(Bsz, n).clone()
    pk = rows.expand(Bsz, n).clone()
    for k in range(n if steps is None else steps):
        neg = torch.tensor(-1.0, dtype=A.dtype)
        mag = torch.where(pos >= k, R[:, :, k].abs(), neg)
        best = mag.max(dim=1, keepdim=True).values
        wpos = torch.where(mag == best, pos, n).min(dim=1).values
        if winners is not None:
            winners.append(wpos)
        p = torch.argmax((pos == wpos[:, None]).int(), dim=1)
        pk[:, k] = p
        raw = R[b, p].clone()
        piv = raw[:, k:k + 1].clone()
        raw[:, k] = 1.0
        nk = raw / piv
        f = R[:, :, k:k + 1]
        upd = R - f * nk[:, None, :]
        upd[:, :, k] = 0.0 - f[..., 0] * nk[:, None, k]
        upd[b, p] = nk
        R = upd
        pos = torch.where(pos == wpos[:, None], k,
                          torch.where(pos == k, wpos[:, None], pos))
    out = torch.empty_like(R)
    out[b[:, None, None], pos[:, :, None], pk[:, None, :]] = R
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["random", "rows_permuted"])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 9, 16, 21, 29, 39, 48])
def test_row_owned_schedule_is_bit_for_bit_plain(n, kind, dtype):
    """The warp and group branches' schedule (rows never move, n slots in
    place,
    logical positions) computes what gj_inverse_plain computes, to the
    last bit: it drops only the columns that hold 0 or 1 and the updates
    that leave them so. The kernel differs from both only by fused
    multiply-adds."""
    rng = np.random.default_rng(400 + n)
    A = (_well_conditioned(rng, 64, n) if kind == "random"
         else row_permuted_batch(rng, 64, n))
    At = torch.as_tensor(A, dtype=dtype)
    ours = _row_owned_schedule(At)
    plain = batched_inv.gj_inverse_plain(At)
    assert float((ours - plain).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 16, 21, 39])
def test_row_owned_schedule_breaks_ties_as_plain(n, dtype):
    """On the pivot-tie batch the schedule, the plain version and the
    exact inverse agree bit for bit: positions, not rows, break ties."""
    A, X = pivot_tie_batch(np.random.default_rng(500 + n), 512, n)
    col0 = np.abs(A[:, :, 0])
    assert np.any(np.argmax(col0, axis=1) != 0)
    assert np.any(np.sum(col0 == col0.max(1, keepdims=True), 1) > 1)
    At = torch.as_tensor(A, dtype=dtype)
    ours = _row_owned_schedule(At)
    np.testing.assert_array_equal(ours.numpy(),
                                  batched_inv.gj_inverse_plain(At).numpy())
    np.testing.assert_array_equal(ours.numpy(), X.astype(ours.numpy().dtype))


def _sass_function(name: str, ops: list) -> str:
    """A function of a cuobjdump -sass listing, one instruction a line."""
    lines = [f"\t\tFunction : {name}",
             "\t.headerflags\t@\"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\""]
    for i, op in enumerate(ops):
        lines.append(f"        /*{16 * i:04x}*/                   {op} ;"
                     f"   /* 0x000000000000000000000000000000 */")
    return "\n".join(lines)


def test_step_mix_reads_both_branches():
    """k1_compare.step_mix on a listing holding both kernels and another:
    the warp branch's step is averaged between its REDUX.MIN marks, the
    group branch's is its body up to the first unpredicated EXIT over its
    band (the division's slow path after it is left out), a padded
    instance of the group branch's over its order n, and other functions
    are skipped."""
    import k1_compare
    group = (["LDC R1, c[0x0][0x28]", "@P0 EXIT"]
             + ["SHFL.BFLY PT, R3, R2, 0x1, 0x1e1f"] * 128
             + ["FFMA R4, R5, R6, R4"] * 256 + ["LDS.128 R8, [R2]"] * 64
             + ["FSEL R4, R5, R6, P0"] * 16 + ["EXIT"]
             + ["BRA 0x10"] + ["FFMA R4, R5, R6, R4"] * 32
             + ["RET.REL.NODEC R2 0x0"])
    warp = (["S2R R0, SR_TID.X"] * 5
            + (["REDUX.MIN UR4, R3"] + ["FFMA R4, R5, R6, R4"] * 40
               + ["REDUX.MAX UR5, R3"] * 2 + ["LDS.128 R8, [R2]"] * 10)
            * 3 + ["REDUX.MIN UR4, R3", "EXIT"])
    other = ["FFMA R4, R5, R6, R4"] * 7 + ["EXIT"]
    sass = "\n".join([
        "\tcode for sm_90a",
        _sass_function("_ZN12_GLOBAL__N_112gj_inv_groupIfLi16ELi1EEEvPKT_"
                       "PS2_xb", group),
        _sass_function("_ZN12_GLOBAL__N_111chol_factorIfEEvPKT_PS1_xi",
                       other),
        _sass_function("_ZN12_GLOBAL__N_111gj_inv_warpIdLi40EEEvPKT_PS1_xi",
                       warp),
        _sass_function("_ZN12_GLOBAL__N_112gj_inv_groupIdLi16ELi2ELi9EEEvPKT_"
                       "PS2_xNS_4LoadE", group)])
    rows = {row["band"]: row for row in k1_compare.step_mix(sass)}
    assert sorted(rows) == ["d16 RL=2 n=9", "d40", "f16 RL=1"]
    assert rows["d16 RL=2 n=9"]["per_step"] == 467 / 9
    g = rows["f16 RL=1"]
    assert g["instructions"] == len(group)
    assert g["per_step"] == 467 / 16
    assert (g["fma"], g["shuffle"], g["shared"], g["select"]) == (16, 8, 4, 1)
    w = rows["d40"]
    assert w["instructions"] == len(warp)
    assert (w["per_step"], w["fma"], w["reduce"], w["shared"]) == (53, 40, 3,
                                                                   10)
    assert w["shuffle"] == 0


# ---------------------------------------------------------------------------
# K1's forward-mode and vmap rules (the JAX package's custom_jvp and
# custom_vmap of gj_inverse_any)
# ---------------------------------------------------------------------------

def _k1_input(seed, shape, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape + (n, n)) + n * np.eye(n)


def test_gj_inverse_jvp_matches_jax_custom_jvp():
    """torch.func.jvp through the port's rule against jax.jvp through the
    JAX custom_jvp, at 1e-12 relative."""
    import jax

    from acados_tpu.ops.batched_inv import gj_inverse_any as jax_inv_any
    A, dA = _k1_input(20, (3,), 6), np.random.default_rng(21).normal(
        size=(3, 6, 6))
    ref_p, ref_t = jax.jvp(jax_inv_any, (jnp.asarray(A),),
                           (jnp.asarray(dA),))
    out_p, out_t = torch.func.jvp(batched_inv.gj_inverse_any,
                                  (torch.as_tensor(A),),
                                  (torch.as_tensor(dA),))
    for o, r in ((out_p, ref_p), (out_t, ref_t)):
        r = np.asarray(r)
        assert np.max(np.abs(o.numpy() - r)) <= 1e-12 * np.max(np.abs(r))


def test_gj_inverse_hessian_matches_jax():
    """torch.func.hessian (forward over reverse) of a scalar of A^-1
    against jax.hessian through the JAX custom_jvp."""
    import jax

    from acados_tpu.ops.batched_inv import gj_inverse_any as jax_inv_any
    A = _k1_input(22, (), 4)
    W = np.random.default_rng(23).normal(size=(4, 4))
    ref = jax.hessian(lambda a: jnp.sum(jnp.asarray(W) * jax_inv_any(a))
                      ** 2)(jnp.asarray(A))
    out = torch.func.hessian(lambda a: (torch.as_tensor(W) *
                                        batched_inv.gj_inverse_any(a)
                                        ).sum() ** 2)(torch.as_tensor(A))
    ref = np.asarray(ref)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_gj_inverse_vmap_matches_unbatched():
    A = torch.as_tensor(_k1_input(24, (2, 3, 4), 5))
    out = torch.func.vmap(torch.func.vmap(torch.func.vmap(
        batched_inv.gj_inverse_any)))(A)
    ref = batched_inv.gj_inverse_any(A.reshape(24, 5, 5)).reshape(A.shape)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_gj_inverse_forward_ad_gradcheck():
    """Forward and reverse mode, batched, and second order."""
    A = torch.tensor(_k1_input(25, (2,), 4), requires_grad=True)
    assert torch.autograd.gradcheck(
        batched_inv.gj_inverse_any, (A,), check_forward_ad=True,
        check_batched_grad=True, check_batched_forward_grad=True)
    assert torch.autograd.gradgradcheck(
        batched_inv.gj_inverse_any, (A,), check_fwd_over_rev=True,
        check_batched_grad=True)


def test_vmap_over_three_axes_is_one_kernel_call(monkeypatch):
    """A vmap over 3 axes (and a jacfwd's tangent axis beside them)
    reaches the kernel wrapper once: the vmap rule folds every axis into
    its batch, as the JAX package's custom_vmap collapse does."""
    calls = []
    orig = batched_inv._gj_inverse_kernel

    def counting(A):
        calls.append(tuple(A.shape))
        return orig(A)

    monkeypatch.setattr(batched_inv, "_gj_inverse_kernel", counting)
    A = torch.as_tensor(_k1_input(26, (2, 3, 4), 5))
    torch.func.vmap(torch.func.vmap(torch.func.vmap(
        batched_inv.gj_inverse_any)))(A)
    assert calls == [(24, 5, 5)]
    calls.clear()
    torch.func.vmap(torch.func.jacfwd(batched_inv.gj_inverse_any))(A[0, 0])
    assert calls == [(4, 5, 5)]
