"""Device selection and float32 matmul precision for the entry points,
and the lockstep loops' host sync.

Entry points run on the card unless the caller asks for the CPU: a
`device` of None means "cuda", and without CUDA that raises instead of
quietly running on the CPU.

The shards of `parallel/mesh.py:map_shards` run in threads that take
turns: a shard's thread holds the turn while it runs host code and hands
it on while the host waits for its device in `wait_any`, the round's
sync. With the GIL, threads cannot run Python at once anyway, and
threads that all run hand the interpreter over at every torch op (each
releases the GIL), so free-running CPU shards took many times as long
as the same shards one after another. PyTorch's forward-mode AD
also keeps process-wide state (torch.autograd.forward_ad's dual level,
torch.func's jvp nesting count), which two threads inside transforms at
once corrupt ("no level exists"); no transform of the port waits in
`wait_any`.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_TURN = threading.Lock()
_SHARD = threading.local()


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


@contextmanager
def shard_turn():
    """Run the block as a shard: holding the turn, which `wait_any`
    hands on while the host waits for the device."""
    with _TURN:
        _SHARD.on = True
        try:
            yield
        finally:
            _SHARD.on = False


def wait_any(mask: torch.Tensor) -> bool:
    """bool(mask.any()): the host waits for the device. In a shard's
    thread the other shards run their host code meanwhile."""
    found = mask.any()
    if not getattr(_SHARD, "on", False):
        return bool(found)
    _TURN.release()
    try:
        return bool(found)
    finally:
        _TURN.acquire()
