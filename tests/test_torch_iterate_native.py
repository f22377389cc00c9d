"""PyTorch port, the iterate I/O: native/ (the flat pack and the '.atni'
checkpoint format), interface/iterate.py, and the solvers' flat
get/set, object, JSON and '.atni' store/load, against the JAX package
on the same seeded inputs (float64, CPU).

The '.atni' files the two packages write for the same arrays are equal
byte for byte, and each package loads the other's; an iterate moved
from one port solver to another gives the same next call bit for bit.
"""
import numpy as np
import pytest
import torch

from acados_tpu import native as jnative
from acados_tpu.interface import iterate as jiterate
from acados_tpu.interface.batch_solver import AcadosOcpBatchSolver as JaxBatch
from acados_tpu.interface.solver import AcadosOcpSolver as JaxSolver
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu_torch import (AcadosOcpBatchSolver, AcadosOcpFlattenedIterate,
                              AcadosOcpSolver, native)
from acados_tpu_torch.interface import iterate
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from test_torch_globalization import rel_gap
from test_torch_rti import _batch_at

torch.set_num_threads(1)

B, N = 3, 8
X0S = (np.array([0.0, np.pi, 0.0, 0.0])
       + np.random.default_rng(3).normal(0.0, 0.05, (B, 4)))
FLAT = ("x", "u", "pi", "lam", "sl", "su")


def _fields(rng, dtype=np.float64):
    return {"x": rng.normal(size=(N + 1, 4)).astype(dtype),
            "u": rng.normal(size=(N, 1)).astype(dtype),
            "lam_l": rng.normal(size=(B, N + 1, 5)).astype(dtype),
            "empty": np.zeros((0, 3), dtype)}


def test_native_helpers_match_jax():
    assert native.native_available() is jnative.native_available() is False
    t0 = native.monotonic_time()
    assert native.monotonic_time() >= t0
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=s) for s in [(21, 4), (20, 1), (20, 4), (3,)]]
    arrs.append(rng.normal(size=(5, 2)).astype(np.float32))
    flat = native.pack_flat(arrs)
    np.testing.assert_array_equal(flat, jnative.pack_flat(arrs))
    assert flat.dtype == np.float64
    for got, ref, a in zip(native.unpack_flat(flat, [a.shape for a in arrs]),
                           jnative.unpack_flat(flat, [a.shape for a in arrs]),
                           arrs):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, a)
    assert native.pack_flat([]).shape == (0,)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_atni_bytes_equal_and_cross_load(tmp_path, dtype):
    """The same arrays written by both packages: equal bytes (a float32
    array widened to float64, as the JAX writer widens it); each package
    loads the other's file with names and shapes."""
    fields = _fields(np.random.default_rng(1), dtype)
    ours, theirs = str(tmp_path / "ours.atni"), str(tmp_path / "jax.atni")
    native.save_iterate_bin(ours, fields)
    jnative.save_iterate_bin(theirs, fields)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for got in (native.load_iterate_bin(theirs),
                jnative.load_iterate_bin(ours)):
        assert set(got) == set(fields)
        for k, v in fields.items():
            assert got[k].shape == v.shape and got[k].dtype == np.float64
            np.testing.assert_array_equal(got[k], v.astype(np.float64))
    bad = tmp_path / "bad.atni"
    bad.write_bytes(b"\0" * 12)
    with pytest.raises(IOError):
        native.load_iterate_bin(str(bad))


def test_iterate_classes_match_jax():
    """iterate_from_arrays, flatten and arrays_from_flat against the JAX
    package's on a seeded iterate dict."""
    rng = np.random.default_rng(2)
    nc = 5
    it = {k: rng.normal(size=s) for k, s in (
        ("x", (N + 1, 4)), ("u", (N, 1)), ("pi", (N, 4)),
        ("lam_l", (N + 1, nc)), ("lam_u", (N + 1, nc)),
        ("sl", (N + 1, nc)), ("su", (N + 1, nc)))}
    ours, ref = iterate.iterate_from_arrays(it), \
        jiterate.iterate_from_arrays(it)
    for f in ("x_traj", "u_traj", "pi_traj", "lam_traj", "sl_traj",
              "su_traj"):
        for a, b in zip(getattr(ours, f), getattr(ref, f), strict=True):
            np.testing.assert_array_equal(a, b)
    flat, flat_ref = ours.flatten(), ref.flatten()
    for f in FLAT:
        np.testing.assert_array_equal(getattr(flat, f), getattr(flat_ref, f))
    assert flat.allclose(AcadosOcpFlattenedIterate(
        **{f: getattr(flat_ref, f) for f in FLAT}))
    back, back_ref = iterate.arrays_from_flat(flat, N, 4, 1, nc), \
        jiterate.arrays_from_flat(flat_ref, N, 4, 1, nc)
    for k in it:
        np.testing.assert_array_equal(back[k], it[k])
        np.testing.assert_array_equal(back[k], back_ref[k])


def test_solver_iterate_io_matches_jax(tmp_path):
    """AcadosOcpSolver after one SQP solve in both packages: get_flat of
    every field within 1e-9 of the JAX solver's; set_flat round trips;
    the flat object, the object, JSON and '.atni' move the iterate to a
    second port solver exactly; '.atni' files cross between the two
    packages' solvers; the moved iterate gives the same next solve."""
    ours = AcadosOcpSolver(make_pendulum_ocp(N=N, dtype="float64"),
                           device="cpu")
    ref = JaxSolver(jax_pendulum_ocp(N=N, dtype="float64"))
    assert ours.solve() == ref.solve() == 0
    for f in FLAT:
        assert rel_gap(ours.get_flat(f), ref.get_flat(f)) <= 1e-9, f
    flat = ours.store_iterate_to_flat_obj()
    assert isinstance(flat, AcadosOcpFlattenedIterate)
    assert flat.lam.shape == ((N + 1) * 2 * ours.form.nc,)
    for f in FLAT:
        ours.set_flat(f, getattr(flat, f))
        np.testing.assert_array_equal(ours.get_flat(f), getattr(flat, f))
    with pytest.raises(ValueError):
        ours.get_flat("z")

    def fresh():
        return AcadosOcpSolver(make_pendulum_ocp(N=N, dtype="float64"),
                               device="cpu")

    moved = []
    s = fresh()
    s.load_iterate_from_flat_obj(flat)
    moved.append(s)
    s = fresh()
    s.load_iterate_from_obj(ours.store_iterate_to_obj())
    moved.append(s)
    for name in ("it.json", "it.atni"):
        ours.store_iterate(str(tmp_path / name))
        s = fresh()
        s.load_iterate(str(tmp_path / name))
        moved.append(s)
    for s in moved:
        for f in FLAT:
            np.testing.assert_array_equal(s.get_flat(f), ours.get_flat(f))
    # '.atni' across the packages, both ways
    ref.store_iterate(str(tmp_path / "jax.atni"))
    s = fresh()
    s.load_iterate(str(tmp_path / "jax.atni"))
    j = JaxSolver(jax_pendulum_ocp(N=N, dtype="float64"))
    j.load_iterate(str(tmp_path / "it.atni"))
    for f in FLAT:
        np.testing.assert_array_equal(s.get_flat(f), ref.get_flat(f))
        np.testing.assert_array_equal(j.get_flat(f), ours.get_flat(f))
    # the moved iterate: a converged start, the same next solve
    assert ours.solve() == moved[0].solve() == 0
    assert ours.get_stats("sqp_iter") == moved[0].get_stats("sqp_iter") <= 1
    for f in FLAT:
        np.testing.assert_array_equal(moved[0].get_flat(f), ours.get_flat(f))


def test_batch_flat_matches_jax():
    """AcadosOcpBatchSolver's flat API after two RTI calls in both
    packages: (B, n) arrays within 1e-9 of the JAX batch solver's;
    set_flat round trips; a flat batch iterate moved to a second port
    batch solver (with the same x0s) gives the same next call bit for
    bit, and statuses equal to the JAX batch's."""
    def ocp(make):
        return make(N=N, dtype="float64", nlp_solver_type="SQP_RTI")

    ours = _batch_at(AcadosOcpBatchSolver(ocp(make_pendulum_ocp), B,
                                          device="cpu"), X0S)
    ref = _batch_at(JaxBatch(ocp(jax_pendulum_ocp), B), X0S)
    for _ in range(2):
        np.testing.assert_array_equal(ours.solve(), np.asarray(ref.solve()))
    for f in FLAT:
        got = ours.get_flat(f)
        assert got.shape[0] == B
        assert rel_gap(got, ref.get_flat(f)) <= 1e-9, f
    flat = ours.store_iterate_to_flat_obj()
    assert flat.N_batch == B and flat.x.shape == (B, (N + 1) * 4)
    other = _batch_at(AcadosOcpBatchSolver(ocp(make_pendulum_ocp), B,
                                           device="cpu"), X0S)
    other.load_iterate_from_flat_obj(flat)
    for f in FLAT:
        np.testing.assert_array_equal(other.get_flat(f), getattr(flat, f))
    ref.load_iterate_from_flat_obj(ref.store_iterate_to_flat_obj())
    st = ours.solve()
    np.testing.assert_array_equal(st, other.solve())
    np.testing.assert_array_equal(st, np.asarray(ref.solve()))
    for f in ("x", "u", "pi", "lam_l", "lam_u", "sl", "su"):
        assert torch.equal(getattr(ours._it_dev, f),
                           getattr(other._it_dev, f)), f
    # set_flat on a stale host copy keeps the other fields current
    x = ours.get_flat("x")
    ours.solve()
    u_dev = ours._it_dev.u.clone()
    ours.set_flat("x", x)
    np.testing.assert_array_equal(ours.get_flat("x"), x)
    np.testing.assert_array_equal(ours.get_flat("u"),
                                  u_dev.reshape(B, -1).numpy())
