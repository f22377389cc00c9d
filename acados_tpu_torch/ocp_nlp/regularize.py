"""Hessian regularization.

Counterpart of `acados_tpu/ocp_nlp/regularize.py`. Ported: NO_REGULARIZE
(the pendulum's setting). MIRROR, PROJECT, GLM, CONVEXIFY and
PROJECT_REDUC_HESS wait (ROADMAP.md Queue 1, NLP breadth).
"""
from __future__ import annotations

from acados_tpu_torch.ocp_qp.data import OcpQp

REG_METHODS = ("NO_REGULARIZE", "MIRROR", "PROJECT", "GLM",
               "CONVEXIFY", "PROJECT_REDUC_HESS")


def regularize_qp(qp: OcpQp, method: str, eps: float) -> OcpQp:
    """Regularize the QP's stage Hessian blocks (reference
    regularize->regularize hook, ocp_nlp_sqp.c:602)."""
    del eps
    if method == "NO_REGULARIZE":
        return qp
    if method in REG_METHODS:
        raise NotImplementedError(
            f"regularize_method {method!r} is not ported yet "
            "(ROADMAP.md Queue 1, NLP breadth)")
    raise ValueError(
        f"regularize_method {method!r}; supported {REG_METHODS}")
