"""Several processes, each solving its slice of a global batch, and the
cross-process reductions a fleet of MPC solvers needs.

Counterpart of `acados_tpu/parallel/distributed.py` over
`torch.distributed`: an idempotent start of the process group, the slice
of the global batch this process feeds, and the global status histogram
and residual maximum. The solves themselves exchange nothing (the
instances are independent); only those few host numbers cross processes.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from acados_tpu_torch.parallel.mesh import make_batch_mesh

_TORCHRUN_ENV = ("RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> int:
    """Idempotent start of the process group; returns the process count.

    Multi-process when given arguments (coordinator_address: an init
    method such as "tcp://host:port" or "file:///path", or "host:port";
    num_processes and process_id default to WORLD_SIZE and RANK), or
    under torchrun's environment (WORLD_SIZE > 1 with RANK, MASTER_ADDR
    and MASTER_PORT). Otherwise single-process: 1, as the JAX function
    returns without a coordinator. A rendezvous that fails raises.

    The backend is gloo: what crosses processes is a handful of host
    numbers (`all_reduce_status_counts`, `global_max_residual`), and NCCL
    refuses two ranks on one card."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    explicit = (coordinator_address, num_processes, process_id) \
        != (None, None, None)
    if not explicit:
        if int(env.get("WORLD_SIZE", "1")) <= 1 \
                or not all(k in env for k in _TORCHRUN_ENV):
            return 1
        dist.init_process_group("gloo", init_method="env://")
        return dist.get_world_size()
    if coordinator_address is None:
        coordinator_address = "env://"
    elif "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    world = num_processes if num_processes is not None \
        else int(env["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(env["RANK"])
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=world, rank=rank)
    return dist.get_world_size()


def _count_and_index() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_batch_mesh():
    """The mesh of the cards this process feeds. torch.distributed has no
    global device array (the JAX function's `jax.devices()` over every
    host): each process shards over its own cards, `cuda:LOCAL_RANK`
    under a one-process-per-card launch (torchrun sets LOCAL_RANK), else
    every visible card."""
    local = os.environ.get("LOCAL_RANK")
    if dist.is_initialized() and local is not None:
        return make_batch_mesh([f"cuda:{int(local)}"])
    return make_batch_mesh(None)


def process_local_batch_slice(n_batch_global: int):
    """Half-open [start, stop) of the global batch this process feeds."""
    n, index = _count_and_index()
    per = -(-n_batch_global // n)
    start = index * per
    return start, min(start + per, n_batch_global)


def _host(values) -> np.ndarray:
    if torch.is_tensor(values):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def all_reduce_status_counts(statuses) -> np.ndarray:
    """Global histogram of solver status codes 0-7 across processes: the
    fleet health signal (reference status contract, utils/types.h:77-84)."""
    st = _host(statuses)
    local = np.array([np.sum(st == s) for s in range(8)], np.int64)
    if _count_and_index()[0] == 1:
        return local
    t = torch.from_numpy(local)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def global_max_residual(res) -> float:
    """Max KKT residual across every instance of every process."""
    local = float(np.max(_host(res)))
    if _count_and_index()[0] == 1:
        return local
    t = torch.tensor([local], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])
