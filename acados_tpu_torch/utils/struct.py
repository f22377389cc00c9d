"""Frozen dataclass containers for tensors.

The PyTorch counterpart of `acados_tpu.utils.struct.pytree_dataclass`:
plain frozen dataclasses with `.replace`, plus `map_fields`, which applies
a function field by field across containers of one class (what
`jax.tree.map` does for a pytree dataclass), and `jvp_fields` and
`vjp_fields`, which differentiate a function of a container along its
fields (`jax.jvp`/`jax.vjp` of a pytree). Fields that are None in the
first container stay None.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, TypeVar

import torch
import torch.func

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


def jvp_fields(fn: Callable, obj, tangent):
    """torch.func.jvp of fn(obj) along a tangent container of obj's class:
    the fields of `tangent` that are None carry a zero tangent and stay
    constants of fn, so nothing is differentiated along them (what
    `jax.jvp` does for a pytree dataclass with zero leaves, without the
    zero work). Returns (fn(obj), its tangent)."""
    names = [f.name for f in dataclasses.fields(tangent)
             if getattr(tangent, f.name) is not None]

    def of(*vals):
        return fn(obj.replace(**dict(zip(names, vals))))

    return torch.func.jvp(of, tuple(getattr(obj, n) for n in names),
                          tuple(getattr(tangent, n) for n in names))


def vjp_fields(fn: Callable, obj, cotangent, names=None):
    """torch.func.vjp of fn(obj) with `cotangent`, differentiated along
    every field of obj (or the fields `names`): the gradient container of
    obj's class, None in the fields not differentiated."""
    if names is None:
        names = [f.name for f in dataclasses.fields(obj)
                 if getattr(obj, f.name) is not None]

    def of(*vals):
        return fn(obj.replace(**dict(zip(names, vals))))

    _, pull = torch.func.vjp(of, *(getattr(obj, n) for n in names))
    grads = dict(zip(names, pull(cotangent)))
    return type(obj)(**{f.name: grads.get(f.name)
                        for f in dataclasses.fields(obj)})
