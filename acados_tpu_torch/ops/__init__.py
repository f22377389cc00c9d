"""Hand-written CUDA kernels for the small-matrix linear algebra, each
with its plain PyTorch version (the counterpart of `acados_tpu/ops/`):
the Gauss-Jordan inverse (`batched_inv`), the batched Cholesky factor
and solve (`batched_chol`) and the batched small-matrix product
(`small_mm`)."""
from acados_tpu_torch.ops.batched_chol import (chol_factor_batched,
                                               chol_factor_solve_batched,
                                               chol_solve_batched)
from acados_tpu_torch.ops.small_mm import small_mm_batched

__all__ = ["chol_factor_batched", "chol_solve_batched",
           "chol_factor_solve_batched", "small_mm_batched"]
