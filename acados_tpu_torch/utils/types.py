"""Status codes and framework-wide constants.

Same integer contract as the reference C framework (utils/types.h:59,77-84)
and as `acados_tpu.utils.types`; statuses are per-instance integer tensors,
so a batch of solves reports independent outcomes.
"""
from __future__ import annotations

import enum

# reference: utils/types.h:59  (#define ACADOS_INFTY 1e10)
ACADOS_INFTY = 1e10


class AcadosStatus(enum.IntEnum):
    """Solver return codes (reference: utils/types.h:77-84)."""

    ACADOS_SUCCESS = 0
    ACADOS_NAN_DETECTED = 1
    ACADOS_MAXITER = 2
    ACADOS_MINSTEP = 3
    ACADOS_QP_FAILURE = 4
    ACADOS_READY = 5
    ACADOS_UNBOUNDED = 6
    ACADOS_TIMEOUT = 7


ACADOS_SUCCESS = int(AcadosStatus.ACADOS_SUCCESS)
ACADOS_NAN_DETECTED = int(AcadosStatus.ACADOS_NAN_DETECTED)
ACADOS_MAXITER = int(AcadosStatus.ACADOS_MAXITER)
ACADOS_MINSTEP = int(AcadosStatus.ACADOS_MINSTEP)
ACADOS_QP_FAILURE = int(AcadosStatus.ACADOS_QP_FAILURE)
ACADOS_READY = int(AcadosStatus.ACADOS_READY)
ACADOS_UNBOUNDED = int(AcadosStatus.ACADOS_UNBOUNDED)
ACADOS_TIMEOUT = int(AcadosStatus.ACADOS_TIMEOUT)
