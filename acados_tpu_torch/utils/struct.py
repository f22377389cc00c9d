"""Frozen dataclass containers for tensors.

The PyTorch counterpart of `acados_tpu.utils.struct.pytree_dataclass`:
plain frozen dataclasses with `.replace`, plus `map_fields`, which applies
a function field by field across containers of one class (what
`jax.tree.map` does for a pytree dataclass). Fields that are None in the
first container stay None.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, TypeVar

import torch

_T = TypeVar("_T")


def tensor_dataclass(cls: type[_T]) -> type[_T]:
    """Make `cls` a frozen dataclass with a `.replace(**changes)` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    if "replace" not in cls.__dict__:
        cls.replace = lambda self, **ch: dataclasses.replace(self, **ch)
    return cls


def map_fields(fn: Callable, first, *rest):
    """New container of `first`'s class with fn(first.f, *(r.f ...)) per
    field."""
    out = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        out[f.name] = (None if v is None
                       else fn(v, *(getattr(r, f.name) for r in rest)))
    return type(first)(**out)


def where_batch(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with a per-instance (B,) mask broadcast over the
    trailing axes of a and b."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                       a, b)


def select_fields(mask: torch.Tensor, new, old):
    """Per-instance select across two containers: new where mask."""
    return map_fields(lambda n, o: where_batch(mask, n, o), new, old)
