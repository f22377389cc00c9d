"""zoRO: zero-order robust optimization custom update.

Counterpart of `acados_tpu/interface/zoro.py` (reference
zoro_description.py:42-103 and custom_update_function_zoro_template.in.c):
between solver calls, propagate the uncertainty covariance

    P_{k+1} = (A_k + B_k K) P_k (A_k + B_k K)' + W

along the current linearization and tighten the finite constraint bounds
by backoff_scaling_gamma * sqrt(row variance), so the nominal NMPC keeps
the constraints for the disturbed system.

The linearization is the solver's own (ocp_nlp/linearize.py), on the
solver's device: on an IRK OCP its stage systems go to the Gauss-Jordan
kernel K1. The propagation is a short loop over the N stages, batch-first
like everything in the port. `AcadosOcpSolver.custom_update()` calls it
when a ZoroDescription is attached (ocp.zoro_description).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from acados_tpu_torch.interface.builder import data_to_torch
from acados_tpu_torch.ocp_nlp.formulation import NlpData
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate,
                                                build_static_rows, linearize)

_INF_THR = 0.5e10   # bounds beyond this are infinite and stay untouched


@dataclasses.dataclass
class ZoroDescription:
    """Reference: zoro_description.py:42-103 (the W/P0/K covariance
    propagation and the bound backoff)."""

    backoff_scaling_gamma: float = 1.0
    P0_mat: Optional[np.ndarray] = None      # initial covariance
    W_mat: Optional[np.ndarray] = None       # process noise covariance
    fdbk_K_mat: Optional[np.ndarray] = None  # feedback gain (nu, nx)


def make_zoro_update(solver):
    """The covariance propagation of `solver`'s formulation:
    propagate(data, it) -> backoff (B, N+1, nc), every instance of the
    batch-first data and iterate at once."""
    form = solver.form
    desc = solver.acados_ocp.zoro_description
    nx, nu, N = form.nx, form.nu, form.N
    dt, dev = solver.dtype, solver.device
    mat = lambda m, shape: torch.as_tensor(
        np.zeros(shape) if m is None else np.asarray(m, np.float64),
        dtype=dt, device=dev)
    P0 = mat(desc.P0_mat, (nx, nx))
    Wm = mat(desc.W_mat, (nx, nx))
    K = mat(desc.fdbk_K_mat, (nu, nx))

    def propagate(data: NlpData, it: NlpIterate) -> torch.Tensor:
        static_rows = build_static_rows(form, dt, dev)
        qp = linearize(form, static_rows, data, it,
                       torch.zeros((), dtype=dt, device=dev))
        Acl = qp.A + qp.B @ K                       # (B, N, nx, nx)
        P = P0.expand(Acl.shape[0], nx, nx)
        Ps = [P]
        for k in range(N):
            P = Acl[:, k] @ P @ Acl[:, k].mT + Wm
            Ps.append(P)
        P_all = torch.stack(Ps, dim=1)              # (B, N+1, nx, nx)
        # row variances diag(G P G') with G = C + D K on the stages with
        # controls (u = K dx feedback), C at the terminal stage
        G = torch.cat([qp.C[:, :-1] + qp.D @ K, qp.C[:, -1:]], dim=1)
        var = torch.einsum("bkij,bkjl,bkil->bki", G, P_all, G)
        return desc.backoff_scaling_gamma * torch.sqrt(
            torch.clamp(var, min=0.0))

    return propagate


def zoro_custom_update(solver) -> None:
    """Tighten the solver's bound data in place (the reference's
    custom_update C function): path bounds at stages 1..N-1 and the
    terminal ones, from the bounds the first call found."""
    if getattr(solver, "_zoro_fn", None) is None:
        solver._zoro_fn = make_zoro_update(solver)
        # the original (untightened) bounds are the base of every call
        solver._zoro_base = {k: solver._data[k].copy()
                             for k in ("lb", "ub", "lb_e", "ub_e")}
    data = data_to_torch(solver._data, solver.dtype, solver.device,
                         batch=1)
    it = NlpIterate(**{k: torch.as_tensor(v[None], dtype=solver.dtype,
                                          device=solver.device)
                       for k, v in solver._iterate.items()})
    backoff = solver._zoro_fn(data, it)[0].cpu().numpy().astype(np.float64)
    N = solver.N
    for key, b, sign in (("lb", backoff[1:N], 1.0), ("ub", backoff[1:N], -1.0),
                         ("lb_e", backoff[N], 1.0),
                         ("ub_e", backoff[N], -1.0)):
        base = solver._zoro_base[key]
        solver._data[key] = np.where(np.abs(base) < _INF_THR,
                                     base + sign * b, base)
