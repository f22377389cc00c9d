"""Carry state across from the JAX package through numpy.

The solver has no weights: its state is the problem data and the
iterate. `interface.builder.data_to_torch` takes the numpy data dict that
either package's `build_ocp` returns; `iterate_from_numpy` takes an NLP
iterate given as numpy arrays (a mapping, or any object with the fields
as attributes, e.g. the JAX package's NlpIterate after np.asarray of each
field) and returns the port's batch-first NlpIterate.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from acados_tpu_torch.ocp_nlp.linearize import NlpIterate

_FIELDS = ("x", "u", "pi", "lam_l", "lam_u", "sl", "su")


def iterate_from_numpy(d, dtype, device) -> NlpIterate:
    get = d.__getitem__ if isinstance(d, Mapping) else (
        lambda k: getattr(d, k))
    return NlpIterate(**{k: torch.tensor(np.asarray(get(k)), dtype=dtype,
                                         device=device)
                         for k in _FIELDS})
