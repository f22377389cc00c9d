"""acados_tpu_torch: the PyTorch/CUDA port of acados_tpu.

The same module tree and public names as the JAX package, with PyTorch
inside: batch-first solvers that loop in lockstep over a per-instance
done mask, model functions as torch callables, and hand-written CUDA
kernels for Hopper where the JAX package has Pallas kernels for the TPU.
Entry points run on the card unless the caller passes device="cpu".

The quickstart of the README works with this package in place of
acados_tpu:

    from acados_tpu_torch import AcadosOcpSolver
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp

    solver = AcadosOcpSolver(make_pendulum_ocp(dtype="float32"))
    assert solver.solve() == 0
    u0 = solver.get(0, "u")
"""

from acados_tpu_torch.interface.acados_ocp import (AcadosModel, AcadosOcp,
                                                   AcadosOcpConstraints,
                                                   AcadosOcpCost,
                                                   AcadosOcpDims,
                                                   AcadosOcpOptions)
from acados_tpu_torch.interface.batch_solver import AcadosOcpBatchSolver
from acados_tpu_torch.interface.solver import AcadosOcpSolver
from acados_tpu_torch.utils.types import ACADOS_INFTY, AcadosStatus

__version__ = "0.1.0"

__all__ = [
    "AcadosModel", "AcadosOcp", "AcadosOcpConstraints", "AcadosOcpCost",
    "AcadosOcpDims", "AcadosOcpOptions", "AcadosOcpSolver",
    "AcadosOcpBatchSolver", "ACADOS_INFTY", "AcadosStatus",
]
