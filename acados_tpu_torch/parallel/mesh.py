"""Batch sharding over devices.

Counterpart of `acados_tpu/parallel/mesh.py`. The JAX package shards the
batch axis of a vmapped solve over a 1-D `jax.sharding.Mesh` and jits the
solve SPMD. PyTorch has no SPMD jit, so here a mesh is an ordered tuple
of `torch.device`s, one shard each: `shard_batch` splits the leading
axis into one piece per entry, and `map_shards` runs a batch-first
function on every piece and concatenates the results. The instances are
independent, so no shard waits for another.

A device may repeat: `("cpu",) * 8` stands where the JAX tests use 8
virtual CPU devices, and `("cuda:0", "cuda:0")` runs two shards on one
card.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

from acados_tpu_torch.utils.device import resolve_device, shard_turn

BATCH_AXIS = "batch"

# the side stream of each (card, shard position), made at first use and
# kept: PyTorch's caching allocator keeps one pool of blocks a stream,
# so a new stream each call would allocate a shard's memory anew (and
# keep it) on every stream of torch's round-robin pool
_STREAMS: dict[tuple[int, int], torch.cuda.Stream] = {}


def make_batch_mesh(devices=None) -> tuple[torch.device, ...]:
    """1-D mesh over every visible CUDA device, or over `devices` (any
    torch.device specs, repeats allowed); raises without CUDA where a
    CUDA device is asked for, as `utils.device.resolve_device` does."""
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    mesh = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if not mesh:
        raise ValueError("a batch mesh needs at least one device")
    return tuple(mesh)


def batch_pad(n_batch: int, n_devices: int) -> int:
    """Padded batch size divisible by the device count."""
    return int(-(-n_batch // n_devices) * n_devices)


def shard_batch(tree, mesh) -> list:
    """One piece of `tree` per mesh entry, piece i on mesh[i]: the
    leading axis of every tensor split in len(mesh) equal parts. tree: a
    tensor, a tuple, or a dataclass of these (None fields stay None). As
    in the JAX package, the batch must divide by the mesh size (pad it to
    `batch_pad`)."""
    n = len(mesh)

    def split(x):
        if x is None:
            return [None] * n
        if torch.is_tensor(x):
            if x.shape[0] % n:
                raise ValueError(
                    f"batch {x.shape[0]} does not divide over {n} devices; "
                    f"pad it to batch_pad({x.shape[0]}, {n})")
            return [p.to(dev) for p, dev in zip(x.chunk(n), mesh)]
        if isinstance(x, tuple):
            return [tuple(ps) for ps in zip(*map(split, x))]
        names = [f.name for f in dataclasses.fields(x)]
        cols = [split(getattr(x, k)) for k in names]
        return [type(x)(**dict(zip(names, ps))) for ps in zip(*cols)]

    return split(tree)


def gather_batch(pieces, device):
    """The inverse of shard_batch: every tensor of the pieces (of one
    structure) concatenated along the leading axis on `device`, in order.
    A CUDA piece (made on a shard's stream) is marked as used by its
    device's current stream, which copies it, so that its memory is not
    reused before the copy has run."""
    first = pieces[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        for p in pieces:
            if p.is_cuda:
                p.record_stream(torch.cuda.current_stream(p.device))
        return torch.cat([p.to(device) for p in pieces])
    if isinstance(first, tuple):
        return tuple(gather_batch(ps, device) for ps in zip(*pieces))
    return type(first)(**{
        f.name: gather_batch([getattr(p, f.name) for p in pieces], device)
        for f in dataclasses.fields(first)})


def _run_shard(fn, device: torch.device, args, stream, caller_stream):
    """fn(*args) on one shard, as a shard taking turns with the others
    (`utils.device.shard_turn`). On a CUDA device it runs on `stream`,
    after the caller's stream (where the pieces were made), and ends
    with that stream's work done."""
    if device.type != "cuda":
        with shard_turn():
            return fn(*args)
    with torch.cuda.device(device):
        stream.wait_stream(caller_stream)
        with torch.cuda.stream(stream), shard_turn():
            out = fn(*args)
        stream.synchronize()
    return out


def map_shards(fn, mesh, *trees):
    """fn(*trees) computed shard by shard: every tree split over the mesh
    by `shard_batch`, fn called on each shard's pieces on its device, and
    the outputs (a tensor, a tuple or a dataclass of tensors, batch-first)
    concatenated on mesh[0] in shard order by `gather_batch`. The
    port's counterpart of `jax.jit` over inputs sharded on a mesh.

    Each shard runs in a host thread of its own. The port's solvers loop
    in lockstep and sync with the host every round (`wait_any` in
    ocp_nlp/sqp.py, ocp_qp/ipm.py and the other loops), and most of a
    round is host dispatch; shards run one after another would each wait
    for their device in turn, while threads taking turns at those syncs
    (`utils.device.shard_turn`) overlap one shard's dispatch with
    another's device work. On a CUDA entry the thread runs under
    `torch.cuda.device(dev)` on a stream of its own. An exception in any
    shard is raised here, the first shard's first, after every shard
    has stopped."""
    mesh = tuple(mesh)
    pieces = [shard_batch(t, mesh) for t in trees]
    streams, caller = [], {}
    for i, dev in enumerate(mesh):
        if dev.type != "cuda":
            streams.append(None)
            continue
        if (dev.index, i) not in _STREAMS:
            _STREAMS[dev.index, i] = torch.cuda.Stream(dev)
        streams.append(_STREAMS[dev.index, i])
        caller[dev] = torch.cuda.current_stream(dev)
    with ThreadPoolExecutor(max_workers=len(mesh),
                            thread_name_prefix="shard") as pool:
        futures = [pool.submit(_run_shard, fn, dev, [p[i] for p in pieces],
                               streams[i], caller.get(dev))
                   for i, dev in enumerate(mesh)]
    return gather_batch([f.result() for f in futures], mesh[0])
