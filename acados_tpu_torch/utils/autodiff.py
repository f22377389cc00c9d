"""Forward-mode Jacobians and Hessians for per-instance model functions,
and the vmap rule of the batch-first autograd Functions.

`torch.func.jacfwd` returns float64 Jacobians for float32 functions that
multiply a 0-dim tensor by a Python float (e.g. `0.1 * x[1]` in a model):
the saved scalar loses its wrapped-number status and promotes the
tangent. JAX's weak types keep such tangents in float32. `jacfwd` here
casts every Jacobian to the dtype of its differentiated argument, so a
float32 model keeps float32 derivatives downstream; `hessian` does the
same for `torch.func.hessian`.
"""
from __future__ import annotations

import torch
import torch.func


def jacfwd(f, argnums=0):
    jf = torch.func.jacfwd(f, argnums=argnums)
    first = argnums if isinstance(argnums, int) else argnums[0]

    def jac(*args):
        J = jf(*args)
        dt = args[first].dtype
        if isinstance(J, tuple):
            return tuple(j.to(dt) for j in J)
        return J.to(dt)

    return jac


def value_and_jacfwd(f):
    """(f(x), jacfwd(f)(x)) from one forward pass: the value is the primal
    of the Jacobian's jvps, so f's work is not done twice."""
    def twice(x):
        y = f(x)
        return y, y

    jf = torch.func.jacfwd(twice, has_aux=True)

    def both(x):
        J, y = jf(x)
        return y, J.to(x.dtype)

    return both


def hessian(f):
    """torch.func.hessian (forward over reverse, as jax.hessian) of f with
    respect to its first argument, cast to that argument's dtype."""
    hf = torch.func.hessian(f)

    def hess(*args):
        return hf(*args).to(args[0].dtype)

    return hess


def inv_solve(A, b):
    """A^-1 b for batched square A and b (..., n), through the explicit
    inverse. Where A is batched under torch.func.vmap, the forward-mode
    rule of torch.linalg.solve gives wrong tangents for every instance
    but the first (PyTorch 2.13, vmap over jacfwd); `torch.linalg.inv`
    and matmul take the transforms exactly. For the solves the JAX
    package leaves to jnp.linalg.solve (GNSF, lifted IRK), not for the
    kernel's: those go through ops.linsolve."""
    return (torch.linalg.inv(A) @ b[..., None])[..., 0]


def fold_vmap(apply, info, in_dims, *args):
    """The vmap rule of a batch-first `torch.autograd.Function`: every
    vmapped axis folds into the leading batch axis, so `apply` (the
    Function's own `apply`) runs once on the whole batch, as the JAX
    package's `custom_vmap` collapse does.

    Arguments that are not vmapped are expanded to the vmap size; every
    output comes back with the vmapped axis in front (out_dims 0). The
    rows of a batch-first Function are independent, so the folded call
    computes what the vmap would.
    """
    V = info.batch_size

    def fold(a, d):
        if not torch.is_tensor(a):
            return a
        a = a.movedim(d, 0) if d is not None else a.expand(
            (V,) + tuple(a.shape))
        return a.reshape((V * a.shape[1],) + tuple(a.shape[2:]))

    out = apply(*(fold(a, d) for a, d in zip(args, in_dims)))

    def unfold(o):
        return o.reshape((V, o.shape[0] // V) + tuple(o.shape[1:]))

    if isinstance(out, tuple):
        return tuple(unfold(o) for o in out), (0,) * len(out)
    return unfold(out), 0
