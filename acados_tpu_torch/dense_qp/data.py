"""Dense QP data model, batch-first.

Counterpart of `acados_tpu/dense_qp/data.py`: one flat variable vector w
with two-sided, maskable, softenable general rows,

    min   1/2 w'H w + h'w  +  soft-slack penalties
    s.t.  lg <= G w <= ug   (per-side masks; soft rows get sl, su >= 0)

with a leading batch axis B on every tensor.
"""
from __future__ import annotations

import torch

from acados_tpu_torch.utils.struct import tensor_dataclass


@tensor_dataclass
class DenseQp:
    """A batch of dense QPs. Shapes: H (B, nv, nv), h (B, nv),
    G (B, ng, nv), everything else (B, ng)."""

    H: torch.Tensor
    h: torch.Tensor
    G: torch.Tensor
    lg: torch.Tensor
    ug: torch.Tensor
    mask_l: torch.Tensor
    mask_u: torch.Tensor
    Zl: torch.Tensor
    Zu: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    soft_mask: torch.Tensor


@tensor_dataclass
class DenseQpSol:
    """Primal-dual solution of a batch of dense QPs: w (B, nv), the rest
    (B, ng)."""

    w: torch.Tensor
    lam_lg: torch.Tensor
    lam_ug: torch.Tensor
    t_lg: torch.Tensor
    t_ug: torch.Tensor
    sl: torch.Tensor
    su: torch.Tensor
