"""Hand-written CUDA kernels for the small-matrix linear algebra, each
with its plain PyTorch version (the counterpart of `acados_tpu/ops/`):
the Gauss-Jordan inverse (`batched_inv`) and the batched Cholesky factor
and solve (`batched_chol`)."""
from acados_tpu_torch.ops.batched_chol import (chol_factor_batched,
                                               chol_factor_solve_batched,
                                               chol_solve_batched)

__all__ = ["chol_factor_batched", "chol_solve_batched",
           "chol_factor_solve_batched"]
