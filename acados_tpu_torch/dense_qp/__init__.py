"""Dense QP layer: data model and the dense IPM backend, the target of
full condensing (counterpart of `acados_tpu/dense_qp/`)."""
from acados_tpu_torch.dense_qp.data import DenseQp, DenseQpSol
from acados_tpu_torch.dense_qp.ipm import solve_dense_qp

__all__ = ["DenseQp", "DenseQpSol", "solve_dense_qp"]
