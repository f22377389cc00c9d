"""Butcher tableaus for explicit and implicit (collocation) Runge-Kutta.

Copy of `acados_tpu/sim/butcher.py` (the port imports nothing of the JAX
package): tableaus are built host-side with numpy when an integrator is
made, and enter the step functions as constants.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "erk_tableau",
    "gauss_legendre_tableau",
    "radau_iia_tableau",
    "tableau_from_nodes",
]


def erk_tableau(num_stages: int):
    """Explicit RK tableaus used by the reference ERK integrator
    (sim_erk_integrator.c supports 1, 2, 4 stages)."""
    if num_stages == 1:  # explicit Euler
        A = np.zeros((1, 1))
        b = np.array([1.0])
        c = np.array([0.0])
    elif num_stages == 2:  # Heun / explicit midpoint family (Heun)
        A = np.array([[0.0, 0.0], [1.0, 0.0]])
        b = np.array([0.5, 0.5])
        c = np.array([0.0, 1.0])
    elif num_stages == 4:  # classic RK4
        A = np.array([
            [0.0, 0.0, 0.0, 0.0],
            [0.5, 0.0, 0.0, 0.0],
            [0.0, 0.5, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
        ])
        b = np.array([1, 2, 2, 1]) / 6.0
        c = np.array([0.0, 0.5, 0.5, 1.0])
    else:
        raise ValueError(
            f"ERK supports 1, 2 or 4 stages (got {num_stages}); "
            "matches the reference sim_erk_integrator.")
    return A, b, c


def tableau_from_nodes(c: np.ndarray):
    """Collocation tableau from nodes c in (0, 1]:
    A_ij = int_0^{c_i} l_j(t) dt,  b_j = int_0^1 l_j(t) dt
    with l_j the Lagrange basis on the nodes (reference:
    calculate_butcher_tableau, sim_collocation_utils.c:537)."""
    c = np.asarray(c, dtype=np.float64)
    ns = len(c)
    A = np.zeros((ns, ns))
    b = np.zeros(ns)
    for j in range(ns):
        # Lagrange basis polynomial l_j as coefficients
        others = np.delete(c, j)
        poly = np.poly1d(np.poly(others) / np.prod(c[j] - others))
        P = np.polyint(poly)
        b[j] = P(1.0) - P(0.0)
        for i in range(ns):
            A[i, j] = P(c[i]) - P(0.0)
    return A, b, c


def gauss_legendre_tableau(num_stages: int):
    """Gauss-Legendre collocation (order 2*ns), nodes on (0, 1)."""
    nodes, _ = np.polynomial.legendre.leggauss(num_stages)
    c = 0.5 * (nodes + 1.0)
    return tableau_from_nodes(np.sort(c))


def radau_iia_tableau(num_stages: int):
    """Radau IIA collocation (order 2*ns - 1), right endpoint included.

    Nodes are the roots of d^{s-1}/dt^{s-1} [ t^{s-1} (t-1)^s ].
    """
    s = num_stages
    if s == 1:
        return tableau_from_nodes(np.array([1.0]))
    poly = np.poly1d(np.poly(np.concatenate(
        [np.zeros(s - 1), np.ones(s)])))  # t^{s-1} (t-1)^s (monic)
    for _ in range(s - 1):
        poly = np.polyder(poly)
    c = np.sort(np.roots(poly).real)
    c[-1] = 1.0  # right endpoint, exact
    return tableau_from_nodes(c)
