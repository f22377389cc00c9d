"""Named, per-stage parameter management.

Counterpart of `acados_tpu/interface/param_manager.py` (reference
AcadosParamManager, acados_param_manager.py:41-45): users declare named
parameter blocks; the manager owns the flat per-stage parameter layout
(the `p` the solver sees at each stage), the per-stage values and named
get/set, in place of index bookkeeping by hand.

Where the reference builds CasADi symbols per block, the model gets a
`slice_fn(p)` view: a dict of named slices of the flat stage parameter
tensor, for use inside torch model callables.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class AcadosParam:
    """One named parameter block (reference acados_param_manager.py:41)."""

    name: str
    value: np.ndarray


class AcadosParamManager:
    """Flat-layout manager over named parameter blocks."""

    def __init__(self, params: List[AcadosParam], N_horizon: int = 0):
        self._order = OrderedDict()
        off = 0
        self._defaults = {}
        for prm in params:
            v = np.atleast_1d(np.asarray(prm.value, np.float64)).ravel()
            self._order[prm.name] = (off, v.size)
            self._defaults[prm.name] = v
            off += v.size
        self._np = off
        self._N = N_horizon
        # (N+1, np) stage-stacked values, every stage at the defaults
        self._values = np.tile(self._flatten(self._defaults),
                               (N_horizon + 1, 1))

    # ---- layout -----------------------------------------------------------
    @property
    def np_total(self) -> int:
        """Flat per-stage parameter dimension (the model's np)."""
        return self._np

    @property
    def N_horizon(self) -> int:
        return self._N

    @N_horizon.setter
    def N_horizon(self, N: int):
        if not isinstance(N, int) or N < 0:
            raise ValueError("N_horizon must be a non-negative integer")
        if N > self._N:
            extra = np.tile(self._values[:1], (N - self._N, 1))
            self._values = np.vstack([self._values, extra])
        else:
            self._values = self._values[: N + 1]
        self._N = N

    def _flatten(self, d: Dict[str, np.ndarray]) -> np.ndarray:
        out = np.zeros(self._np)
        for name, (off, sz) in self._order.items():
            out[off:off + sz] = np.asarray(d[name]).ravel()
        return out

    # ---- named access -----------------------------------------------------
    def get_value(self, name: str, stage: int = 0) -> np.ndarray:
        off, sz = self._order[name]
        return self._values[stage, off:off + sz].copy()

    def set_value(self, name: str, value, stage: int = None):
        """Set a block at one stage, or (stage=None) at every stage."""
        off, sz = self._order[name]
        v = np.atleast_1d(np.asarray(value, np.float64)).ravel()
        if v.size != sz:
            raise ValueError(f"{name}: expected size {sz}, got {v.size}")
        if stage is None:
            self._values[:, off:off + sz] = v
        else:
            self._values[stage, off:off + sz] = v

    def slice_fn(self):
        """f(p) -> {name: block}, for use inside model callables; a p
        that is no tensor becomes a float64 one."""
        order = dict(self._order)

        def slc(p):
            if not torch.is_tensor(p):
                p = torch.as_tensor(np.asarray(p, np.float64))
            return {name: p[off:off + sz]
                    for name, (off, sz) in order.items()}

        return slc

    # ---- solver wiring ----------------------------------------------------
    def stage_values(self) -> np.ndarray:
        """(N+1, np) stacked parameter matrix for the solver's data."""
        return self._values.copy()

    def apply_to(self, solver):
        """Push every stage's values into an AcadosOcpSolver by
        set(k, 'p')."""
        for k in range(self._values.shape[0]):
            solver.set(k, "p", self._values[k])
