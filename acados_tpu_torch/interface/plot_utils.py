"""Plotting helpers for solver diagnostics and trajectories.

Counterpart of `acados_tpu/interface/plot_utils.py` (reference
plot_utils.py: 40 latexify_plot, :57 plot_convergence,
:103 plot_contraction_rates, :124 plot_trajectories). matplotlib is
imported lazily, and its absence raises ImportError when a function is
called, so the package imports without it (the card's machine has none;
nothing else in the package imports this module). Every function takes
`show=False` and returns the figure; the inputs are numpy arrays, e.g.
get_stats("statistics") or get_iterates().
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("plot_utils requires matplotlib") from e


def latexify_plot() -> None:
    """Reference plot_utils.py:40: LaTeX-styled matplotlib rc params."""
    plt = _mpl()
    plt.rcParams.update({
        "font.family": "serif",
        "mathtext.fontset": "cm",
        "axes.labelsize": 10,
        "font.size": 10,
        "legend.fontsize": 9,
        "xtick.labelsize": 9,
        "ytick.labelsize": 9,
    })


def plot_convergence(residuals, labels: Optional[Sequence[str]] = None,
                     show: bool = True, fig_filename: Optional[str] = None):
    """Semilog KKT-residual-vs-iteration plot (reference plot_utils.py:57).

    residuals: (iters, k) array or list of such arrays (one per run); the
    stat/eq/ineq/comp columns of the solver's `stat` matrix slot in
    directly.
    """
    plt = _mpl()
    if not isinstance(residuals, (list, tuple)):
        residuals = [residuals]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for i, r in enumerate(residuals):
        r = np.atleast_2d(np.asarray(r, float))
        if r.shape[0] == 1:
            r = r.T
        for j in range(r.shape[1]):
            lbl = (labels[j] if labels and len(residuals) == 1
                   else (labels[i] if labels else None))
            ax.semilogy(np.maximum(np.abs(r[:, j]), 1e-300),
                        marker="o", ms=3, label=lbl)
    ax.set_xlabel("iteration")
    ax.set_ylabel("KKT residual")
    ax.grid(True, which="both", alpha=0.3)
    if labels:
        ax.legend()
    fig.tight_layout()
    if fig_filename:
        fig.savefig(fig_filename, dpi=150)
    if show:
        plt.show()
    return fig


def plot_contraction_rates(rates_list: List[np.ndarray],
                           labels: Optional[Sequence[str]] = None,
                           show: bool = True):
    """Per-iteration contraction-rate plot (reference plot_utils.py:103):
    rate_k = res_{k+1} / res_k of each run's residual sequence."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for i, res in enumerate(rates_list):
        res = np.asarray(res, float).ravel()
        rates = res[1:] / np.maximum(res[:-1], 1e-300)
        ax.plot(rates, marker="o", ms=3,
                label=labels[i] if labels else None)
    ax.set_xlabel("iteration")
    ax.set_ylabel("contraction rate")
    ax.grid(True, alpha=0.3)
    if labels:
        ax.legend()
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def plot_trajectories(ts, X, U=None, x_labels=None, u_labels=None,
                      lbu=None, ubu=None, x_ref=None, show: bool = True,
                      fig_filename: Optional[str] = None):
    """Stacked state/control trajectory subplots (reference
    plot_utils.py:124): one axis per state, step-plotted controls with
    bound lines."""
    plt = _mpl()
    ts = np.asarray(ts, float)
    X = np.atleast_2d(np.asarray(X, float))
    nx = X.shape[1]
    nu = 0 if U is None else np.atleast_2d(np.asarray(U, float)).shape[1]
    fig, axes = plt.subplots(nx + nu, 1, sharex=True,
                             figsize=(6, 1.4 * (nx + nu)))
    axes = np.atleast_1d(axes)
    for i in range(nx):
        axes[i].plot(ts, X[:, i])
        if x_ref is not None:
            axes[i].plot(ts, np.broadcast_to(
                np.asarray(x_ref, float)[i], ts.shape), "k--", lw=0.8)
        axes[i].set_ylabel(x_labels[i] if x_labels else f"x{i}")
        axes[i].grid(True, alpha=0.3)
    if U is not None:
        U = np.atleast_2d(np.asarray(U, float))
        for j in range(nu):
            ax = axes[nx + j]
            ax.step(ts[:-1], U[:, j], where="post")
            for b in (lbu, ubu):
                if b is not None:
                    ax.axhline(np.atleast_1d(b)[j], color="r", ls=":",
                               lw=0.8)
            ax.set_ylabel(u_labels[j] if u_labels else f"u{j}")
            ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("t [s]")
    fig.tight_layout()
    if fig_filename:
        fig.savefig(fig_filename, dpi=150)
    if show:
        plt.show()
    return fig
