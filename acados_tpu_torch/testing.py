"""Seeded test inputs: matrices for the Gauss-Jordan inverse (K1),
batches of OCP-QPs, and RTI batches set up from per-instance x0s.

Shared by the CPU tests (tests/test_torch_*.py) and the card's check
(chip_smoke.py), so both hold the port to the same cases. Nothing here
runs in the solver.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pivot_tie_batch", "random_qp_batch", "row_permuted_batch",
           "rti_batch"]


def rti_batch(ocp, x0s: np.ndarray, device):
    """AcadosOcpBatchSolver of len(x0s) instances of `ocp`, set up as
    bench.py's _build_rti sets up the JAX package's batch: each
    instance's x0 as lbx = ubx at stage 0 and as its initial x at every
    stage, through the per-instance views as a user would."""
    from acados_tpu_torch.interface.batch_solver import AcadosOcpBatchSolver
    solver = AcadosOcpBatchSolver(ocp, len(x0s), device=device)
    for i, view in enumerate(solver.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(solver.N + 1):
            view.set(k, "x", x0s[i])
    return solver


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


def random_qp_batch(seed, B=8, N=8, nx=4, nu=2, nc=3, soft=False,
                    x0_rows=True):
    """Seeded batch of well-conditioned box/general-constrained OCP-QPs
    (numpy, float64). With x0_rows, the first nx stage-0 rows pin x0
    (lg == ug, the rows x0 elimination removes); without, those rows are
    masked off and x0 is free. The other rows are centred on the
    zero-input rollout so u = 0 is strictly feasible."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=(B,) + s)
    Qs, Rs = 0.3 * n(N + 1, nx, nx), 0.3 * n(N, nu, nu)
    d = dict(
        Q=np.einsum("bkij,bkil->bkjl", Qs, Qs) + np.eye(nx),
        R=np.einsum("bkij,bkil->bkjl", Rs, Rs) + np.eye(nu),
        S=0.05 * n(N, nu, nx),
        q=n(N + 1, nx), r=n(N, nu),
        A=np.eye(nx) + 0.1 * n(N, nx, nx),
        B=0.3 * n(N, nx, nu), b=0.1 * n(N, nx))
    nct = nc + nx
    C = np.zeros((B, N + 1, nct, nx))
    D = np.zeros((B, N, nct, nu))
    x0 = 0.5 * n(nx)
    C[:, 0, :nx] = np.eye(nx)
    Cr, Dr = n(N + 1, nc, nx), n(N, nc, nu)
    C[:, :, nx:], D[:, :, nx:] = Cr, Dr
    x_roll = [x0]
    for k in range(N):
        x_roll.append(np.einsum("bij,bj->bi", d["A"][:, k], x_roll[-1])
                      + d["b"][:, k])
    g0 = np.einsum("bkij,bkj->bki", Cr, np.stack(x_roll, 1))
    widths = 0.2 + 1.5 * rng.uniform(size=(2, B, N + 1, nc))
    lg = np.zeros((B, N + 1, nct))
    ug = np.zeros((B, N + 1, nct))
    lg[:, 0, :nx] = ug[:, 0, :nx] = x0
    lg[:, :, nx:] = g0 - widths[0]
    ug[:, :, nx:] = g0 + widths[1]
    mask = np.zeros((B, N + 1, nct))
    mask[:, 0, :nx] = 1.0 if x0_rows else 0.0
    mask[:, :, nx:] = 1.0
    z = np.zeros((B, N + 1, nct))
    soft_mask, Zl, zl = z.copy(), z.copy(), z.copy()
    if soft:
        soft_mask[:, :, nx:] = 1.0
        Zl[:, :, nx:] = 10.0
        zl[:, :, nx:] = 1.0
    d.update(C=C, D=D, lg=lg, ug=ug, mask_l=mask, mask_u=mask.copy(),
             Zl=Zl, Zu=Zl.copy(), zl=zl, zu=zl.copy(), soft_mask=soft_mask)
    return d
