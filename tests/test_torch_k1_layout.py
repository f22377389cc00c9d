"""PyTorch port, the layout in which K1 (ops/batched_inv.py) reads its
input.

The IRK builds its stage Jacobians with torch.func's jacfwd under vmap,
which hands them over transposed: strides (n^2, 1, n). The kernel reads
that layout in place (`input_layout` "transposed"), a contiguous input
as it is ("rows"), and the wrapper copies any other layout to rows
first. Here: the IRK's layout at the main path's shape (a PyTorch upgrade
that changes it shows here), every K1 input of an RTI and of an EXACT
linearization of the main path's pendulum, routed as on the card
(`linsolve` through the kernel wrapper), reaching the kernel with no
copy, the layout decision on its own, and `gj_inverse_any` with its jvp
and vmap rules on a transposed view against its contiguous copy and the
JAX package's `gj_inverse_any`. The kernel itself runs only on the card,
where chip_smoke.py holds it on transposed views bit for bit against its
contiguous copies.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.ops.batched_inv import gj_inverse_any as jax_inv_any
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.linearize import build_static_rows, linearize
from acados_tpu_torch.ops import batched_inv
from acados_tpu_torch.ops.batched_inv import gj_inverse_any, input_layout
from acados_tpu_torch.sim import irk
from acados_tpu_torch.utils.convert import iterate_from_numpy

torch.set_num_threads(1)

# the main path: the pendulum, IRK GL4, N = 20, B = 4096, float32
B_MAIN, N_MAIN, NX = 4096, 20, 4
X0 = np.array([0.0, np.pi, 0.0, 0.0])


class _Stop(Exception):
    pass


def _main_form(dtype="float32", **so):
    ocp = make_pendulum_ocp(N=N_MAIN, dtype=dtype, integrator_type="IRK",
                            nlp_solver_type="SQP")
    for k, v in so.items():
        setattr(ocp.solver_options, k, v)
    return ocp, *build_ocp(ocp)[:2]


def _inputs(form, data1, B, dtype):
    """Data and iterate of B instances, x0 = X0 + N(0, 0.05), x at x0."""
    x0s = X0 + np.random.default_rng(0).normal(0.0, 0.05, (B, NX))
    data = {k: np.tile(v, (B,) + (1,) * np.ndim(v)) for k, v in data1.items()}
    data["lb_0"][:, :NX] = data["ub_0"][:, :NX] = x0s
    z = lambda *s: np.zeros((B,) + s)
    nc = form.nc
    it = dict(x=np.repeat(x0s[:, None], N_MAIN + 1, axis=1),
              u=z(N_MAIN, 1), pi=z(N_MAIN, NX), lam_l=z(N_MAIN + 1, nc),
              lam_u=z(N_MAIN + 1, nc), sl=z(N_MAIN + 1, nc),
              su=z(N_MAIN + 1, nc))
    return (data_to_torch(data, dtype, "cpu"),
            iterate_from_numpy(it, dtype, "cpu"), x0s)


def test_irk_stage_jacobians_come_transposed_at_main_path_shape(
        monkeypatch):
    """The first K1 input of the main path's IRK step, (B N, 16, 16)
    float32, is the transpose of a contiguous block: strides (256, 1, 16),
    which the kernel reads in place."""
    _, form, _ = _main_form()
    M = B_MAIN * N_MAIN
    seen = []

    def record(A):
        seen.append((tuple(A.shape), A.stride(), A.dtype))
        raise _Stop

    monkeypatch.setattr(batched_inv, "_gj_inverse_kernel", record)
    x = torch.as_tensor(X0, dtype=torch.float32).expand(M, NX).clone()
    with pytest.raises(_Stop):
        form.step_jac_fn(x, torch.zeros((M, 1)), torch.zeros((M, 0)),
                         torch.zeros(M), torch.full((M,), 0.05))
    assert seen == [((M, 16, 16), (256, 1, 16), torch.float32)]
    assert input_layout(torch.empty((M, 16, 16)).transpose(-1, -2)) \
        == "transposed"


def _card_linsolve(A, b):
    """ops.linsolve as it runs on the card: through the kernel wrapper."""
    vec = b.dim() == A.dim() - 1
    Ainv = gj_inverse_any(A)
    return (Ainv @ b[..., None])[..., 0] if vec else Ainv @ b


@pytest.mark.parametrize("hessian", ["GAUSS_NEWTON", "EXACT"])
def test_linearization_hands_k1_no_layout_it_copies(monkeypatch, hessian):
    """Every K1 input of one linearization of the main path's pendulum
    (B = 2, float32), with linsolve routed as on the card, is read in
    place: the IRK step's 8 inverses transposed; EXACT's dynamics Hessian
    (under torch.func.hessian and the vmap rules' folds) 8 more
    transposed and 6 row-major (the adjoint solves' J')."""
    monkeypatch.setattr(irk, "linsolve", _card_linsolve)
    seen = []
    orig = batched_inv._gj_inverse_kernel

    def record(A):
        seen.append(input_layout(A))
        return orig(A)

    monkeypatch.setattr(batched_inv, "_gj_inverse_kernel", record)
    _, form, data1 = _main_form(hessian_approx=hessian)
    data, it, _ = _inputs(form, data1, 2, torch.float32)
    linearize(form, build_static_rows(form, torch.float32, "cpu"), data, it,
              torch.zeros((), dtype=torch.float32))
    want = {"GAUSS_NEWTON": ["transposed"] * 8,
            "EXACT": ["transposed"] * 16 + ["rows"] * 6}[hessian]
    assert sorted(seen, reverse=True) == want


def _view(kind, B=5, n=6, dtype=torch.float64):
    A = torch.arange(B * n * n, dtype=dtype).reshape(B, n, n)
    if kind == "contiguous":
        return A
    if kind == "transposed":
        return A.transpose(-1, -2)
    if kind == "one transposed":
        return A[:1].transpose(-1, -2)
    if kind == "misaligned transposed":
        flat = torch.zeros(B * n * n + 1, dtype=dtype)
        return flat[1:].view(B, n, n).transpose(-1, -2)
    if kind == "strided slice":
        return A[:, ::2, ::2]
    if kind == "corner":
        return A[:, :3, :3]
    if kind == "every other matrix transposed":
        return A[::2].transpose(-1, -2)
    if kind == "expanded":
        return A[:1].expand(B, n, n)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,layout", [
    ("contiguous", "rows"), ("transposed", "transposed"),
    ("one transposed", "transposed"),
    ("misaligned transposed", "transposed"), ("strided slice", "copy"),
    ("corner", "copy"), ("every other matrix transposed", "copy"),
    ("expanded", "copy")])
def test_layout_decision(kind, layout):
    """input_layout: a contiguous input and the transpose of a contiguous
    block (at any base, a single matrix too) are read in place; any other
    strides are copied to rows first."""
    assert input_layout(_view(kind)) == layout


@pytest.mark.parametrize("n", [9, 16])
def test_transposed_view_inverts_as_its_copy_and_as_jax(n):
    """gj_inverse_any, its jvp and its vmap rule give on a transposed view
    what they give on its contiguous copy, bit for bit, and match the JAX
    package's gj_inverse_any (and jax.jvp, jax.vmap through it) within
    1e-12 relative, float64, on the same numpy matrices."""
    rng = np.random.default_rng(30 + n)
    A = rng.normal(size=(3, 7, n, n)) + n * np.eye(n)
    dA = rng.normal(size=A.shape)
    At = torch.as_tensor(A).transpose(-1, -2).contiguous().transpose(-1, -2)
    dAt = torch.as_tensor(dA)
    assert input_layout(At.reshape(-1, n, n)) == "transposed"
    Ac = At.contiguous()
    inv = lambda X: gj_inverse_any(X)
    vinv = torch.func.vmap(inv)
    got = {"inverse": inv(At), "vmap": vinv(At),
           "jvp": torch.func.jvp(inv, (At,), (dAt,))[1]}
    copy = {"inverse": inv(Ac), "vmap": vinv(Ac),
            "jvp": torch.func.jvp(inv, (Ac,), (dAt,))[1]}
    ja, jda = jnp.asarray(A), jnp.asarray(dA)
    ref = {"inverse": jax_inv_any(ja), "vmap": jax.vmap(jax_inv_any)(ja),
           "jvp": jax.jvp(jax_inv_any, (ja,), (jda,))[1]}
    for k, r in ref.items():
        assert torch.equal(got[k], copy[k]), k
        r = np.asarray(r)
        gap = np.max(np.abs(got[k].numpy() - r)) / np.max(np.abs(r))
        assert gap <= 1e-12, f"{k}: {gap:.3e}"
