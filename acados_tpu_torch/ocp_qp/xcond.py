"""Condensing QP front-end: {none, full} x backend dispatch, batch-first.

Counterpart of `acados_tpu/ocp_qp/xcond.py`: the one QP entry the NLP
layer calls, wrapping condense -> backend solve -> expand. Ported: no
condensing (the Riccati IPM on the OCP-QP as it is) and full condensing
(the dense IPM on the condensed QP). Partial condensing raises.
"""
from __future__ import annotations

from acados_tpu_torch.dense_qp.ipm import solve_dense_qp
from acados_tpu_torch.ocp_qp.condensing import _PARTIAL
from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.full_condensing import (full_condense,
                                                     full_expand)
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp


def resolve_cond_N(N: int, cond_N) -> int | None:
    """The partial-condensing horizon for a requested cond_N: None (no
    condensing, HPIPM's N2 == N) when it is None or at least N, else
    clamped to at least 1 (acados_tpu/ocp_qp/xcond.py:resolve_cond_N)."""
    if cond_N is None or cond_N >= N:
        return None
    return max(int(cond_N), 1)


def solve_ocp_qp_xcond(qp: OcpQp, opts: IpmOpts = None, cond_N: int = None,
                       full_cond: bool = False,
                       warm: OcpQpSol | None = None,
                       x0_fixed: bool = False):
    """Solve a batch of OcpQps through the condensing front-end.

    full_cond: condense to dense QPs and solve them with the dense IPM
      (cold: the reference passes no warm start on this path).
    cond_N: None or >= N solves the OCP-QP directly with the Riccati IPM
      (warm and x0_fixed as solve_ocp_qp takes them); a smaller cond_N is
      partial condensing, not ported yet.
    Returns (OcpQpSol in the original coordinates, IpmInfo).
    """
    if opts is None:
        opts = IpmOpts()
    if full_cond:
        if x0_fixed:
            raise ValueError("x0_fixed is not supported with full "
                             "condensing (the dense path has its own "
                             "state elimination)")
        dense, cache = full_condense(qp)
        sol_d, info = solve_dense_qp(dense, opts)
        return full_expand(qp, cache, sol_d), info
    if cond_N is None or cond_N >= qp.dims.N:
        return solve_ocp_qp(qp, opts, warm=warm, x0_fixed=x0_fixed)
    raise NotImplementedError(_PARTIAL)
