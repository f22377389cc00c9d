"""Standalone OCP-QP description and solver (no NLP around it).

Counterpart of `acados_tpu/interface/ocp_qp_solver.py` (the reference's
acados_ocp_qp.py and acados_ocp_qp_solver.py): describe a linear-quadratic
OCP directly (Q/R/S/q/r, A/B/b, the unified rows C/D/lg/ug with their
masks, soft slacks) and solve it with a registered QP backend, through
partial condensing where cond_N is given.

The QP is a batch of one of the port's batch-first QPs; `get` and the
sensitivities return that one instance.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpDims, zero_qp
from acados_tpu_torch.ocp_qp.ipm import (IpmOpts, solve_ocp_qp,
                                         solve_ocp_qp_sens_adj,
                                         solve_ocp_qp_sens_frw)
from acados_tpu_torch.ocp_qp.registry import get_qp_backend
from acados_tpu_torch.ocp_qp.xcond import solve_ocp_qp_xcond
from acados_tpu_torch.utils.device import (full_precision_matmul,
                                           resolve_device)

_STAGE_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg",
                 "ug", "Zl", "Zu", "zl", "zu", "mask_l", "mask_u",
                 "soft_mask")
_SOL_FIELDS = ("x", "u", "pi", "lam_lg", "lam_ug", "sl", "su")


class AcadosOcpQp:
    """QP description with per-stage set/get. Box bounds and general
    rows both live in the rows (C, D, lg, ug, mask_l, mask_u); a value
    smaller than its field's stage block fills its leading corner.
    `device` None means "cuda"."""

    def __init__(self, N: int, nx: int, nu: int, nc: int = 0,
                 dtype=torch.float64, device=None):
        self.dims = OcpQpDims(N=N, nx=nx, nu=nu, nc=max(nc, 1))
        self.device = resolve_device(device)
        self._qp = zero_qp(self.dims, batch=1, dtype=dtype,
                           device=self.device)

    def set(self, stage: int, field: str, value):
        if field not in _STAGE_FIELDS:
            raise ValueError(f"unknown QP field {field}")
        arr = getattr(self._qp, field)
        v = torch.as_tensor(np.asarray(value, np.float64), dtype=arr.dtype,
                            device=arr.device)
        padded = torch.zeros(arr.shape[2:], dtype=arr.dtype,
                             device=arr.device)
        padded[tuple(slice(0, s) for s in v.shape)] = v
        arr = arr.clone()
        arr[0, stage] = padded
        self._qp = self._qp.replace(**{field: arr})

    def get(self, stage: int, field: str):
        if field not in _STAGE_FIELDS:
            raise ValueError(f"unknown QP field {field}")
        return getattr(self._qp, field)[0, stage].cpu().numpy()

    @property
    def qp(self) -> OcpQp:
        """The QP as a batch of one."""
        return self._qp


class AcadosOcpQpSolver:
    """Solve an AcadosOcpQp with a registered backend ("RICCATI_IPM",
    "ADMM" or the reference's plan names), through partial condensing
    where cond_N is given. opts: IpmOpts (or AdmmOpts for "ADMM")."""

    def __init__(self, qp: AcadosOcpQp, solver: str = "RICCATI_IPM",
                 opts: Optional[IpmOpts] = None,
                 cond_N: Optional[int] = None):
        full_precision_matmul()
        self.qp_desc = qp
        self.opts = opts or IpmOpts()
        self.cond_N = cond_N
        if solver == "RICCATI_IPM" and cond_N is None:
            self._solve = lambda q: solve_ocp_qp(q, self.opts)
        else:
            backend = get_qp_backend(solver)
            if cond_N is not None:
                self._solve = lambda q: solve_ocp_qp_xcond(
                    q, self.opts, cond_N=cond_N, backend=backend)
            else:
                self._solve = lambda q: backend(q, self.opts)
        self.sol = None
        self.info = None

    def solve(self) -> int:
        self.sol, self.info = self._solve(self.qp_desc.qp)
        return int(self.info.status[0])

    def get(self, stage: int, field: str):
        if self.sol is None:
            raise RuntimeError("call solve() first")
        if field in _SOL_FIELDS:
            return getattr(self.sol, field)[0, stage].cpu().numpy()
        raise ValueError(field)

    def get_stats(self, field: str):
        if self.info is None:
            raise RuntimeError("call solve() first")
        return getattr(self.info, field)[0].cpu().numpy()

    # -- QP solution sensitivities (HPIPM's sens_frw/adj) --------------------
    def eval_sens_forw(self, d_qp: OcpQp):
        """Forward sensitivity in the data direction d_qp (an OcpQp batch
        of one; a field that is None carries a zero tangent). Returns
        (dx (N+1, nx), du (N, nu), dpi (N, nx))."""
        out = solve_ocp_qp_sens_frw(self.qp_desc.qp, self.sol, d_qp,
                                    self.opts)
        return tuple(t[0] for t in out)

    def eval_sens_adj(self, seed_x, seed_u):
        """Adjoint sensitivity for the seeds (N+1, nx) and (N, nu): the
        gradient of <seed, (x, u)> with respect to the QP data, an OcpQp
        batch of one (zero in the masks)."""
        q = self.qp_desc.qp.q
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=q.dtype,
                                         device=q.device)[None]
        return solve_ocp_qp_sens_adj(self.qp_desc.qp, self.sol,
                                     as_t(seed_x), as_t(seed_u), self.opts)
