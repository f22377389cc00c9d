"""PyTorch port, interface/plot_utils.py: a headless smoke test as
tests/test_utils_interface.py::TestPlotUtils runs the JAX module's,
skipped where matplotlib is missing (the card's machine has none), and
the plots of a port solve's statistics and trajectories. The package
imports without matplotlib: plot_utils is imported by nothing else."""
import subprocess
import sys

import numpy as np
import pytest


def test_smoke_headless(tmp_path):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    from acados_tpu_torch import AcadosOcpSolver
    from acados_tpu_torch.interface.plot_utils import (latexify_plot,
                                                       plot_contraction_rates,
                                                       plot_convergence,
                                                       plot_trajectories)
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    latexify_plot()
    res = np.array([[1e2, 1e1], [1e0, 1e-1], [1e-4, 1e-5]])
    plot_convergence(res, labels=["stat", "eq"], show=False,
                     fig_filename=str(tmp_path / "conv.png"))
    assert (tmp_path / "conv.png").exists()
    plot_contraction_rates([res[:, 0]], labels=["run"], show=False)
    ts = np.linspace(0, 1, 11)
    X = np.random.default_rng(0).normal(size=(11, 3))
    U = np.random.default_rng(1).normal(size=(10, 1))
    plot_trajectories(ts, X, U, lbu=[-1], ubu=[1], show=False,
                      fig_filename=str(tmp_path / "traj.png"))
    assert (tmp_path / "traj.png").exists()
    # a port solve's statistics and trajectories
    s = AcadosOcpSolver(make_pendulum_ocp(N=8), device="cpu")
    assert s.solve() == 0
    stat = s.get_stats("statistics")
    fig = plot_convergence(stat[1:5].T, show=False)
    assert len(fig.axes[0].lines) == 4
    x = np.array([s.get(k, "x") for k in range(9)])
    u = np.array([s.get(k, "u") for k in range(8)])
    fig = plot_trajectories(np.linspace(0, 1, 9), x, u, lbu=[-80],
                            ubu=[80], show=False)
    assert len(fig.axes) == 5
    plt.close("all")


def test_package_does_not_import_matplotlib():
    """Importing acados_tpu_torch loads no matplotlib."""
    code = ("import sys, acados_tpu_torch; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
