"""Associative scan along one axis of batch-first tensors.

Counterpart of `jax.lax.associative_scan` (jax 0.9.0,
jax/_src/lax/control_flow/loops.py:2605-2758) with the same odd/even
recursion: combine the stride-2 pairs [0:-1:2] and [1::2], scan those
recursively, combine the results with the remaining elements ("even"),
prepend element 0 and interleave. Every element is therefore combined in
the same tree as in the JAX package, and float64 results agree with its
scans to rounding.

A combine over zero elements (the "even" combine of a level with 2
elements) is skipped: `fn` is never called on an empty batch, so nothing
is launched for it.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def _slice(e: torch.Tensor, dim: int, start, stop, step) -> torch.Tensor:
    return e[(slice(None),) * dim + (slice(start, stop, step),)]


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     reverse: bool = False, dim: int = 1) -> tuple:
    """Inclusive scan of `elems` (a sequence of tensors sharing their size
    along `dim`) with the associative fn(a, b) -> tuple of tensors shaped
    like a and b; element k of the result combines elements 0..k, as
    fn(fn(e0, e1), e2) ... . fn must act elementwise along `dim` and
    any axis before it.

    reverse=True scans from the last element: the inputs are flipped,
    scanned and flipped back, so fn receives (later, earlier), as in
    the JAX package.
    """
    elems = [e.flip(dim) if reverse else e for e in elems]

    def combine(a, b):
        if a[0].shape[dim] == 0:
            return a            # empty: no call, no launch
        return list(fn(tuple(a), tuple(b)))

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        odd = scan(combine([_slice(e, dim, 0, -1, 2) for e in elems],
                           [_slice(e, dim, 1, None, 2) for e in elems]))
        later = [_slice(e, dim, 2, None, 2) for e in elems]
        if n % 2 == 0:
            even = combine([_slice(e, dim, 0, -1, 1) for e in odd], later)
        else:
            even = combine(odd, later)
        out = []
        for e, ev, od in zip(elems, even, odd):
            r = e.new_empty(e.shape)
            _slice(r, dim, 0, 1, 1).copy_(_slice(e, dim, 0, 1, 1))
            _slice(r, dim, 2, None, 2).copy_(ev)
            _slice(r, dim, 1, None, 2).copy_(od)
            out.append(r)
        return out

    out = scan(elems)
    return tuple(e.flip(dim) if reverse else e for e in out)
