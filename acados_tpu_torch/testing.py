"""Seeded test matrices for the Gauss-Jordan inverse (K1).

Shared by the CPU tests (tests/test_torch_ops.py) and the card's check
(chip_smoke.py), so both hold the kernel and its plain version to the
same cases. numpy only; nothing here runs in the solver.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pivot_tie_batch", "row_permuted_batch"]


def row_permuted_batch(rng: np.random.Generator, B: int,
                       n: int) -> np.ndarray:
    """(B, n, n) well-conditioned matrices (N(0, 1) + n I) with their rows
    in a random order per matrix: the dominant entry of a column sits off
    the diagonal, so the pivot search swaps rows at most steps."""
    A = rng.normal(size=(B, n, n)) + n * np.eye(n)
    return np.take_along_axis(A, np.argsort(rng.random((B, n)))[..., None],
                              1)


def pivot_tie_batch(rng: np.random.Generator, B: int,
                    n: int) -> tuple[np.ndarray, np.ndarray]:
    """Matrices with many equal magnitudes in their pivot columns, and
    their exact inverses: (A, A^-1), at most B of them.

    A = Q L U with unit triangular L, U of entries in {-1, 0, 1} and a
    random row order Q, so column entries tie at +-1 and rows swap. Kept
    are the matrices whose pivots under the lowest-index rule are all
    +-1: Gauss-Jordan then runs in exact integer arithmetic in float32
    and float64 alike, and A^-1 is an integer matrix computed without
    rounding. Another choice among equal magnitudes can meet other
    pivots and round, so it shows as a difference."""
    d = min(0.7, 3.0 / n)
    sign = lambda: (rng.random((B, n, n)) < d) * rng.choice([-1.0, 1.0],
                                                               (B, n, n))
    A = (np.tril(sign(), -1) + np.eye(n)) @ (np.triu(sign(), 1) + np.eye(n))
    A = np.take_along_axis(A, np.argsort(rng.random((B, n)))[..., None], 1)
    M, b, unit = A.copy(), np.arange(B), np.ones(B, bool)
    for k in range(n):   # forward elimination: the pivots Gauss-Jordan meets
        p = k + np.argmax(np.abs(M[:, k:, k]), axis=1)
        M[b, k], M[b, p] = M[b, p], M[b, k]
        unit &= np.abs(M[:, k, k]) == 1
        M[:, k + 1:] -= M[:, k + 1:, k:k + 1] * M[:, k, None, :] / \
            M[:, k, None, k:k + 1]
    A = A[unit]
    X = np.linalg.inv(A).round()
    unit = np.all(A @ X == np.eye(n), axis=(1, 2)) & \
        (np.abs(X).max(axis=(1, 2), initial=0.0) < 2.0 ** 20)
    return A[unit], X[unit]
