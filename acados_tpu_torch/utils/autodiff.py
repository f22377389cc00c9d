"""Forward-mode Jacobians for per-instance model functions.

`torch.func.jacfwd` returns float64 Jacobians for float32 functions that
multiply a 0-dim tensor by a Python float (e.g. `0.1 * x[1]` in a model):
the saved scalar loses its wrapped-number status and promotes the
tangent. JAX's weak types keep such tangents in float32. `jacfwd` here
casts every Jacobian to the dtype of its differentiated argument, so a
float32 model keeps float32 derivatives downstream.
"""
from __future__ import annotations

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
