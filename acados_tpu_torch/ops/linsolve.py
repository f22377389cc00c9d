"""Batched small-matrix general linear solves.

Counterpart of `acados_tpu/ops/linsolve.py`. On the CPU, A x = b goes to
LAPACK through `torch.linalg.solve` (linsolve.py:74-77). On the card it
goes through an explicit inverse by the Gauss-Jordan kernel and a matmul,
for every n. The reference takes its in-line Gauss-Jordan for n <= 8
(linsolve.py:78-81) because XLA fuses it into the surrounding program;
eager PyTorch fuses nothing, so the in-line loop would be about 10 n
small launches where the kernel is one.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.ops.batched_inv import gj_inverse_any

__all__ = ["gj_inverse", "linsolve"]

# the reference's public name: the kernel wrapper (plain version on the CPU)
gj_inverse = gj_inverse_any


def linsolve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for batched small A; b: (..., n) or (..., n, m)."""
    vec = b.dim() == A.dim() - 1
    if A.device.type == "cpu":
        if vec:
            return torch.linalg.solve(A, b[..., None])[..., 0]
        return torch.linalg.solve(A, b)
    Ainv = gj_inverse_any(A)
    if vec:
        return (Ainv @ b[..., None])[..., 0]
    return Ainv @ b
