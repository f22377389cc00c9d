"""Device selection and float32 matmul precision for the entry points.

Entry points run on the card unless the caller asks for the CPU: a
`device` of None means "cuda", and without CUDA that raises instead of
quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def full_precision_matmul() -> None:
    """Keep float32 matmuls in full float32.

    The reference pins matmul precision to "highest" for every solver
    product (acados_tpu ocp_qp/ipm.py:81,440, ocp_nlp/sqp.py:457,
    ops/batched_inv.py:110,203). On Hopper, TF32 would keep only about
    three decimal digits of the Newton directions, so the entry points
    switch it off explicitly for matmuls and for cuDNN.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
