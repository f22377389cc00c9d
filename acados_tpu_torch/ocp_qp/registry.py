"""Pluggable QP backend registry.

Counterpart of `acados_tpu/ocp_qp/registry.py` (the reference's QP solver
plan enum, interfaces/acados_c/ocp_qp_interface.h:60-106): backends
register under a name and the NLP layer resolves them by name. A backend
is any callable (qp: OcpQp, opts, warm=None) -> (OcpQpSol, IpmInfo-like)
on a batch of QPs.

Built-ins:
  RICCATI_IPM   the batched Mehrotra IPM (ocp_qp/ipm.py, HPIPM analog)
  ADMM          the structure-exploiting first-order splitting
                (ocp_qp/admm.py, OSQP analog), a parity and robustness
                fallback
The reference's backend names map onto these (PARTIAL_CONDENSING_HPIPM ->
RICCATI_IPM, PARTIAL_CONDENSING_OSQP -> ADMM, ...).
"""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}

# the reference's plan-enum names -> built-in backends
_ALIASES = {
    "PARTIAL_CONDENSING_HPIPM": "RICCATI_IPM",
    "FULL_CONDENSING_HPIPM": "RICCATI_IPM",
    "FULL_CONDENSING_QPOASES": "RICCATI_IPM",
    "FULL_CONDENSING_DAQP": "RICCATI_IPM",
    "PARTIAL_CONDENSING_OSQP": "ADMM",
    "PARTIAL_CONDENSING_QPDUNES": "ADMM",
}


def register_qp_backend(name: str, solve_fn: Callable) -> None:
    """Register a QP backend under `name` (a registered name is
    replaced)."""
    _REGISTRY[name] = solve_fn


def get_qp_backend(name: str) -> Callable:
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown QP backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_qp_backends():
    return sorted(_REGISTRY)


def _register_builtins():
    from acados_tpu_torch.ocp_qp.admm import AdmmOpts, solve_ocp_qp_admm
    from acados_tpu_torch.ocp_qp.ipm import solve_ocp_qp

    def ipm_backend(qp, opts=None, warm=None):
        return solve_ocp_qp(qp, opts, warm=warm)

    def admm_backend(qp, opts=None, warm=None):
        del warm  # ADMM restarts from zero, as in the JAX package
        if isinstance(opts, AdmmOpts):
            admm_opts = opts
        elif opts is not None:
            # IPM tolerances, floored at what a first-order method reaches
            # in float32 (pass AdmmOpts for tighter control)
            admm_opts = AdmmOpts(
                iter_max=500,
                tol_prim=max(float(opts.tol_ineq), 2e-5),
                tol_dual=max(float(opts.tol_stat), 2e-5))
        else:
            admm_opts = None
        return solve_ocp_qp_admm(qp, admm_opts)

    register_qp_backend("RICCATI_IPM", ipm_backend)
    register_qp_backend("ADMM", admm_backend)


_register_builtins()
