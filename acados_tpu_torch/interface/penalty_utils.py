"""Huber penalty builders for moving constraints into the cost.

Counterpart of `acados_tpu/interface/penalty_utils.py` (reference
penalty_utils.py:34, 49, 93): the Huber loss and the one-sided and
symmetric Huber penalties that move inequality constraints into the
cost (e.g. for DDP, which takes unconstrained OCPs only).

The reference returns CasADi expressions (value, gradient, Hessian, XGN
Hessian). Here each builder returns elementwise torch callables; the
gradient and Hessian come from `torch.func.grad`, and the XGN (extended
Gauss-Newton) Hessian, the convex surrogate grad / v used in place of
the exact piecewise Hessian, is given explicitly since it is no
derivative. A value that is no tensor is taken as float64.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.func import grad as _grad


def _t(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.as_tensor(v,
                                                        dtype=torch.float64)


def _floor(h, min_hess: float):
    return torch.clamp(h, min=min_hess) if min_hess > 0 else h


def huber_loss(delta: float, tau: float) -> Tuple[Callable, Callable]:
    """Scalar Huber loss (reference penalty_utils.py:34).

    loss(v) = (tau/delta) * ( 0.5 v^2            if |v| < delta
                              delta(|v|-delta/2)  otherwise )

    Returns (loss, xgn_hess), both elementwise."""
    if delta <= 0:
        raise ValueError("delta must be positive")

    def loss(v):
        v = _t(v)
        a = torch.abs(v)
        quad = 0.5 * v * v
        lin = delta * (a - 0.5 * delta)
        return (tau / delta) * torch.where(a < delta, quad, lin)

    def xgn_hess(v):
        # grad / v: tau / delta in the quadratic region, tau / |v| outside
        v1 = torch.atleast_1d(_t(v))
        g = _grad(lambda s: loss(s).sum())(v1)
        return torch.where(v1 == 0, tau / delta,
                           g / torch.where(v1 == 0, 1.0, v1))

    return loss, xgn_hess


def _resolve_tau(delta: float, tau: Optional[float], w: Optional[float]):
    if tau is None:
        if w is None:
            raise ValueError("specify either w or tau")
        return 2.0 * w * delta
    if w is not None:
        raise ValueError("specify either w or tau, not both")
    return tau


def _with_derivatives(penalty, xgn_hess, min_hess: float):
    """(penalty, grad, hess, xgn_hess): the elementwise gradient and
    Hessian by torch.func.grad of the sum, the Hessians floored at
    min_hess where it is positive."""
    grad_raw = _grad(lambda u: penalty(u).sum())

    def grad(u):
        return grad_raw(_t(u))

    def hess(u):
        h = _grad(lambda s: grad_raw(s).sum())(torch.atleast_1d(_t(u)))
        return _floor(h, min_hess)

    return penalty, grad, hess, lambda u: _floor(xgn_hess(u), min_hess)


def one_sided_huber_penalty(delta: float, tau: Optional[float] = None,
                            w: Optional[float] = None,
                            min_hess: float = 0.0):
    """Penalty for a constraint u <= 0 (reference penalty_utils.py:49):
    smooth near 0 (a quadratic ramp of width delta), asymptotically
    linear with slope tau. Returns (penalty, grad, hess, xgn_hess)."""
    tau = _resolve_tau(delta, tau, w)
    loss, loss_xgn = huber_loss(delta, tau)

    def penalty_raw(u):
        u = _t(u)
        return 0.5 * (loss(u - delta) + tau * u)

    p0 = float(penalty_raw(0.0))

    def penalty(u):
        return penalty_raw(u) - p0

    def xgn_hess(u):
        return 0.5 * loss_xgn(_t(u) - delta)

    return _with_derivatives(penalty, xgn_hess, min_hess)


def symmetric_huber_penalty(delta: float, tau: Optional[float] = None,
                            w: Optional[float] = None,
                            min_hess: float = 0.0):
    """Penalty for -1 <= u <= 1 (reference penalty_utils.py:93): zero to
    first order inside the band, a quadratic ramp of width delta around
    |u| = 1, asymptotically linear with slope tau outside. Returns
    (penalty, grad, hess, xgn_hess)."""
    tau = _resolve_tau(delta, tau, w)
    loss, loss_xgn = huber_loss(delta, tau)
    c_lo, c_hi = float(loss(-(1 + delta))), float(loss(1 - delta))

    def penalty_raw(u):
        u = _t(u)
        return 0.5 * (loss(u - (1 + delta)) + loss(u + (1 + delta))
                      - c_lo - c_hi)

    p0 = float(penalty_raw(0.0))

    def penalty(u):
        return penalty_raw(u) - p0

    def xgn_hess(u):
        u1 = torch.atleast_1d(_t(u))
        return 0.5 * torch.where(u1 < 0, loss_xgn(u1 + 1 + delta),
                                 loss_xgn(u1 - (1 + delta)))

    return _with_derivatives(penalty, xgn_hess, min_hess)
