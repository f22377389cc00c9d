"""Iterate container classes and flat packing.

Counterpart of `acados_tpu/interface/iterate.py` (reference
acados_ocp_iterate.py:40-342): AcadosOcpIterate (per-stage arrays),
AcadosOcpFlattenedIterate (one flat vector per field) and
AcadosOcpFlattenedBatchIterate (a leading batch axis), the host-side
form in which iterates are saved, loaded and moved between solvers.

The dual convention is the internal NlpIterate's: the bound multipliers
are split per side (lam_l / lam_u over the unified constraint rows), and
`lam` packs them reference-style as [lam_l_k, lam_u_k] per stage.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class AcadosOcpIterate:
    """Per-stage iterate (reference class of the same name)."""

    x_traj: List[np.ndarray]
    u_traj: List[np.ndarray]
    pi_traj: List[np.ndarray]
    lam_traj: List[np.ndarray]   # per stage: [lam_l_k, lam_u_k]
    sl_traj: List[np.ndarray]
    su_traj: List[np.ndarray]

    def flatten(self) -> "AcadosOcpFlattenedIterate":
        cat = lambda t: np.concatenate(t) if t else np.zeros(0)
        return AcadosOcpFlattenedIterate(
            x=cat(self.x_traj), u=cat(self.u_traj), pi=cat(self.pi_traj),
            lam=cat(self.lam_traj), sl=cat(self.sl_traj),
            su=cat(self.su_traj))


@dataclasses.dataclass
class AcadosOcpFlattenedIterate:
    """All stages concatenated per field (reference class)."""

    x: np.ndarray
    u: np.ndarray
    pi: np.ndarray
    lam: np.ndarray
    sl: np.ndarray
    su: np.ndarray

    def allclose(self, other, atol=1e-12) -> bool:
        return all(np.allclose(getattr(self, f.name),
                               getattr(other, f.name), atol=atol)
                   for f in dataclasses.fields(self))


@dataclasses.dataclass
class AcadosOcpFlattenedBatchIterate:
    """Batch variant: fields of shape (N_batch, n_field) (reference
    class; used by AcadosOcpBatchSolver)."""

    x: np.ndarray
    u: np.ndarray
    pi: np.ndarray
    lam: np.ndarray
    sl: np.ndarray
    su: np.ndarray
    N_batch: int


def iterate_from_arrays(it: dict) -> AcadosOcpIterate:
    """Internal iterate dict {x (N+1, nx), u (N, nu), pi, lam_l, lam_u,
    sl, su} -> AcadosOcpIterate."""
    N = it["u"].shape[0]
    return AcadosOcpIterate(
        x_traj=[it["x"][k].copy() for k in range(N + 1)],
        u_traj=[it["u"][k].copy() for k in range(N)],
        pi_traj=[it["pi"][k].copy() for k in range(N)],
        lam_traj=[np.concatenate([it["lam_l"][k], it["lam_u"][k]])
                  for k in range(N + 1)],
        sl_traj=[it["sl"][k].copy() for k in range(N + 1)],
        su_traj=[it["su"][k].copy() for k in range(N + 1)])


def arrays_from_flat(flat: AcadosOcpFlattenedIterate, N, nx, nu,
                     nc) -> dict:
    """Flat iterate -> internal arrays dict (inverse of get_flat)."""
    f64 = lambda a, *s: np.asarray(a, np.float64).reshape(s)
    lam = f64(flat.lam, N + 1, 2 * nc)
    return {"x": f64(flat.x, N + 1, nx), "u": f64(flat.u, N, nu),
            "pi": f64(flat.pi, N, nx), "lam_l": lam[:, :nc].copy(),
            "lam_u": lam[:, nc:].copy(), "sl": f64(flat.sl, N + 1, nc),
            "su": f64(flat.su, N + 1, nc)}
