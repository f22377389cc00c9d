"""Build the hand-written CUDA kernels and load them through ctypes.

Each source under `acados_tpu_torch/csrc/` is compiled at first use by
`nvcc` for `sm_90a` into a shared library with a plain C interface, in
`build/kernels/` at the root of the checkout, named by a hash of the
source so an edited source is rebuilt. Nothing is built when a module is
imported: the first call of a kernel wrapper on a CUDA tensor builds its
library, and `build_all()` builds every source at once (one `nvcc` each,
all started together). A library may also be named by the path of a copy
of a source (an earlier version, say), which is built the same way beside
the others, so two versions of a kernel can run side by side.

Builds, loads and the wrappers' launch counts are safe under threads
(the shards of `parallel/mesh.py:map_shards` call the wrappers from
threads of their own): one process-wide lock serialises every build and
load, and `count_launch` adds to a counter under another.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel library name -> source file in csrc/
SOURCES = {"gj_inverse": "gj_inverse.cu", "batched_chol": "batched_chol.cu",
           "small_mm": "small_mm.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


def count_launch(counts: dict, key: str) -> None:
    """counts[key] += 1 under a process-wide lock: a read-modify-write
    that two threads could otherwise interleave, losing a launch. counts:
    a dict of counters, or a module's globals() for a module-level
    counter."""
    with _COUNT_LOCK:
        counts[key] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _source(name: str) -> Path:
    """The source of a library: a name of SOURCES, or a path to a .cu."""
    return CSRC / SOURCES[name] if name in SOURCES else Path(name).resolve()


def target(name: str) -> Path:
    """The library built from a source (a name of SOURCES or a path):
    named by the source's file name and a hash of its contents."""
    src = _source(name)
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile the named kernel sources (default: all of SOURCES; a name
    may be a path to a copy of a source) in parallel.

    Returns {name: nvcc's -Xptxas -v report} for the sources it compiled;
    raises RuntimeError naming every source that failed.
    """
    with _BUILD_LOCK:
        return _build(list(SOURCES if names is None else names))


def _build(names) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = target(name)
        if out.exists() or any(out == o for _, _, o in procs.values()):
            continue  # built, or one nvcc already builds this source
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of a kernel library (a name of SOURCES or a path
    to a copy of a source), building it if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            out = target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            _LOADED[name] = lib
    return lib
