"""Host-side runtime support: timers, flat-iterate pack, binary
checkpoint I/O (the '.atni' format).

Counterpart of `acados_tpu/native/__init__.py` (itself the counterpart
of the reference's C runtime layer: utils/timing.h:43-86,
ocp_nlp_get_all/set_all ocp_nlp_interface.c:1914-2018, iterate save/load
acados_ocp_iterate.py). Pure numpy, as there: these helpers are
memcpy/IO-bound. A '.atni' file written here is byte for byte the one
the JAX package writes for the same arrays, and each package reads the
other's.
"""
from __future__ import annotations

import struct
import time
from typing import Dict

import numpy as np

_MAGIC = 0x494E5441
_VERSION = 1


def native_available() -> bool:
    """Kept for API compatibility: the runtime is pure host Python."""
    return False


def monotonic_time() -> float:
    """Monotonic timer (reference acados_tic/toc analog)."""
    return time.monotonic()


def pack_flat(arrays) -> np.ndarray:
    """Concatenate f64 arrays into one flat vector (ocp_nlp_get_all
    analog: one contiguous iterate buffer)."""
    arrays = [np.ascontiguousarray(a, np.float64) for a in arrays]
    return (np.concatenate([a.ravel() for a in arrays])
            if arrays else np.zeros(0))


def unpack_flat(flat: np.ndarray, shapes) -> list:
    """Split a flat vector back into arrays of the given shapes
    (ocp_nlp_set_all analog)."""
    flat = np.ascontiguousarray(flat, np.float64)
    outs = []
    off = 0
    for s in shapes:
        o = np.empty(s, np.float64)
        o[...] = flat[off:off + o.size].reshape(o.shape)
        off += o.size
        outs.append(o)
    return outs


def save_iterate_bin(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write an 'ATNI' binary iterate checkpoint: little-endian header
    (magic, version, count), then per field its 'name|shape' key and its
    values widened to float64."""
    items = [(f"{k}|{','.join(map(str, np.asarray(v).shape))}",
              np.ascontiguousarray(v, np.float64))
             for k, v in fields.items()]
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _MAGIC, _VERSION, len(items)))
        for k, v in items:
            kb = k.encode()
            f.write(struct.pack("<I", len(kb)))
            f.write(kb)
            f.write(struct.pack("<Q", v.size))
            f.write(v.tobytes())


def load_iterate_bin(path: str) -> Dict[str, np.ndarray]:
    """Read an 'ATNI' binary iterate checkpoint back into named arrays."""
    out = {}
    with open(path, "rb") as f:
        magic, ver, count = struct.unpack("<III", f.read(12))
        if magic != _MAGIC or ver != _VERSION:
            raise IOError("bad ATNI file")
        for _ in range(count):
            (klen,) = struct.unpack("<I", f.read(4))
            key = f.read(klen).decode()
            (numel,) = struct.unpack("<Q", f.read(8))
            out[key] = np.frombuffer(f.read(numel * 8), np.float64).copy()
    return dict(_restore_shape(k, v) for k, v in out.items())


def _restore_shape(key: str, flat: np.ndarray):
    if "|" not in key:
        return key, flat
    name, shp = key.rsplit("|", 1)
    shape = tuple(int(s) for s in shp.split(",") if s)
    return name, flat.reshape(shape)
