"""Implicit Runge-Kutta (collocation) integrator, batch-first.

Counterpart of `acados_tpu/sim/irk.py` for ODEs (nz == 0): Gauss-Legendre
or Radau IIA collocation with a fixed number of Newton iterations over
the stacked stage equations.

The stage residual of one instance is a plain torch function; its
Jacobians come from `torch.func.vmap(torch.func.jacfwd(...))`. The
inverse of the stage Jacobian is taken outside those transforms, on the
whole (M, nw, nw) batch at once through `ops.batched_inv.gj_inverse_any`:
on the card that is the hand-written Gauss-Jordan kernel, launched
newton_iter (+1 without jac_reuse) times per substep. The Kronecker path
(2 stages, jac_reuse, explicit ODE) inverts one (M, nx, nx) block
determinant per substep instead.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from acados_tpu_torch.ops.batched_inv import gj_inverse_any
from acados_tpu_torch.ops.linsolve import linsolve
from acados_tpu_torch.sim.butcher import (gauss_legendre_tableau,
                                          radau_iia_tableau)
from acados_tpu_torch.utils.autodiff import jacfwd


def _tableau(collocation: str, num_stages: int):
    if collocation.upper() in ("GAUSS_LEGENDRE", "GAUSS"):
        return gauss_legendre_tableau(num_stages)
    if collocation.upper() in ("RADAU_IIA", "RADAU"):
        return radau_iia_tableau(num_stages)
    raise ValueError(f"unknown collocation {collocation}")


def _require_ode(nz: int, what: str):
    if nz:
        raise NotImplementedError(
            f"{what} with algebraic variables (nz > 0) is not ported yet "
            "(ROADMAP.md Queue 1, integrator breadth)")


def _stage_residual(f_impl, A_t, c_t, nx: int, nz: int):
    """Per-instance stage residual res(w, x0, u, p, t, h) of the stacked
    stage unknowns w = [K_1..K_ns, Z_1..Z_ns]."""
    ns = len(c_t)

    def res(w, x0, u, p, t, h):
        A_ = torch.as_tensor(A_t, dtype=w.dtype, device=w.device)
        K = w[: ns * nx].reshape(ns, nx)
        Z = w[ns * nx:].reshape(ns, nz)
        xi = x0[None, :] + h * (A_ @ K)
        return torch.cat([f_impl(K[i], xi[i], Z[i], u, p,
                                 t + float(c_t[i]) * h)
                          for i in range(ns)])

    return res


def make_irk_step(f_impl, nx: int, nz: int = 0, num_stages: int = 3,
                  num_steps: int = 1, newton_iter: int = 3,
                  collocation: str = "GAUSS_LEGENDRE"):
    """Batch-first IRK step (forward only): step(x (M, nx), u, p, t0 (M,),
    dt (M,)) -> (x_next (M, nx), z_out (M, nz)).

    The Newton start of each substep is the previous substep's stage
    solution, as in the reference's custom_root carry. Its implicit
    gradient (custom_root's tangent solve) waits for the sensitivity
    slice (ROADMAP.md Queue 1)."""
    _require_ode(nz, "make_irk_step")
    A_t, b_t, c_t = _tableau(collocation, num_stages)
    ns = num_stages
    nw = ns * (nx + nz)
    res_one = _stage_residual(f_impl, A_t, c_t, nx, nz)
    res_b = vmap(res_one)
    jac_w = vmap(jacfwd(res_one, argnums=0))

    def step(x, u, p, t0, dt):
        M = x.shape[0]
        b_ = torch.as_tensor(b_t, dtype=x.dtype, device=x.device)
        h = dt / num_steps
        w = torch.zeros((M, nw), dtype=x.dtype, device=x.device)
        x_k = x
        for i in range(num_steps):
            t = t0 + i * h
            for _ in range(newton_iter):
                J = jac_w(w, x_k, u, p, t, h)
                w = w - linsolve(J, res_b(w, x_k, u, p, t, h))
            K = w[:, : ns * nx].reshape(M, ns, nx)
            x_k = x_k + h[:, None] * (b_ @ K)
        return x_k, torch.zeros((M, nz), dtype=x.dtype, device=x.device)

    return step


def make_irk_step_jac(f_impl, nx: int, nz: int = 0, num_stages: int = 3,
                      num_steps: int = 1, newton_iter: int = 3,
                      collocation: str = "GAUSS_LEGENDRE",
                      jac_reuse: bool = False,
                      kron_path: bool | None = None,
                      explicit_ode: bool = False):
    """Batch-first IRK step that also returns the step Jacobians:
    step_jac(x (M, nx), u (M, nu), p (M, np), t0 (M,), dt (M,)) ->
    (x_next (M, nx), A (M, nx, nx), B (M, nx, nu)).

    The generic path of acados_tpu/sim/irk.py:196-327: the stage Jacobian
    is built and inverted newton_iter times per substep (once with
    jac_reuse) and once more at the converged root without jac_reuse, and
    that one inverse serves all nx + nu sensitivity columns.

    kron_path (None = auto: 2 stages, nz == 0, jac_reuse, explicit ODE)
    takes the Kronecker path of acados_tpu/sim/irk.py:328-391 instead
    (`_kron_step_jac`).
    """
    A_t, b_t, c_t = _tableau(collocation, num_stages)
    if kron_path is None:
        kron_path = (num_stages == 2 and nz == 0 and jac_reuse
                     and explicit_ode)
    if kron_path and (num_stages != 2 or nz != 0):
        raise ValueError("kron_path requires num_stages == 2 and nz == 0")
    # the Kronecker split assumes d f_impl / d xdot == I (an
    # explicit-wrapped ODE); a mass-matrix model must use the generic
    # stage factorization
    if kron_path and not explicit_ode:
        raise ValueError("kron_path requires an explicit ODE model")
    _require_ode(nz, "make_irk_step_jac")
    if kron_path:
        return _kron_step_jac(f_impl, nx, A_t, b_t, c_t, num_steps,
                              newton_iter)
    ns = num_stages
    nw = ns * (nx + nz)
    res_one = _stage_residual(f_impl, A_t, c_t, nx, nz)
    res_b = vmap(res_one)
    jac_w = vmap(jacfwd(res_one, argnums=0))
    jac_xu = vmap(jacfwd(res_one, argnums=(1, 2)))

    def step_jac(x, u, p, t0, dt):
        M, nu = x.shape[0], u.shape[-1]
        dev, dt_ = x.device, x.dtype
        b_ = torch.as_tensor(b_t, dtype=dt_, device=dev)
        h = dt / num_steps
        eye = torch.eye(nx, dtype=dt_, device=dev)
        x_k = x
        Sx = eye.expand(M, nx, nx)
        Su = torch.zeros((M, nx, nu), dtype=dt_, device=dev)
        w = torch.zeros((M, nw), dtype=dt_, device=dev)
        for i in range(num_steps):
            t = t0 + i * h
            Ji = None
            for it_ in range(newton_iter):
                if it_ == 0 or not jac_reuse:
                    Ji = gj_inverse_any(jac_w(w, x_k, u, p, t, h))
                w = w - (Ji @ res_b(w, x_k, u, p, t, h)[..., None])[..., 0]
            if not jac_reuse:
                # refresh at the converged root so the implicit-function
                # sensitivities are exact there
                Ji = gj_inverse_any(jac_w(w, x_k, u, p, t, h))
            Rx, Ru = jac_xu(w, x_k, u, p, t, h)
            dW = -(Ji @ torch.cat([Rx, Ru], dim=-1))
            dK = dW[:, : ns * nx].reshape(M, ns, nx, nx + nu)
            x_next = x_k + h[:, None] * (b_ @ w[:, : ns * nx].reshape(
                M, ns, nx))
            G = h[:, None, None] * torch.einsum("s,msij->mij", b_, dK)
            A_sub = eye + G[:, :, :nx]
            x_k, Sx, Su = x_next, A_sub @ Sx, A_sub @ Su + G[:, :, nx:]
        return x_k, Sx, Su

    return step_jac


def _kron_step_jac(f_impl, nx: int, A_t, b_t, c_t, num_steps: int,
                   newton_iter: int):
    """The 2-stage frozen-Jacobian step of acados_tpu/sim/irk.py:328-391,
    batch-first.

    With one ODE Jacobian per substep, the stage Jacobian is
    J = I (x) I - h A (x) Jf, whose nx-blocks are polynomials in Jf and
    commute, so J^-1 = blockdiag(D^-1, D^-1) adj(J) with the block
    determinant D = I - tr(A) hJ + det(A) hJ^2, hJ = h Jf. Jf is the mean
    of the ODE Jacobians at the two predictor stage points. One inverse
    of D per substep (`gj_inverse_any` on (M, nx, nx): one K1 launch on
    the card, two through the Schur recursion for nx > 48) serves the
    Newton iterations and all nx + nu sensitivity columns. The products
    stay `torch.matmul`, as the JAX package leaves them to XLA.

    Stage quantities are batched as (M, 2, ...) and evaluated as one
    (2M, ...) batch of per-instance calls.
    """
    ns = 2
    trA = float(np.trace(np.asarray(A_t)))
    detA = float(np.linalg.det(np.asarray(A_t)))
    a11, a12 = float(A_t[0][0]), float(A_t[0][1])
    a21, a22 = float(A_t[1][0]), float(A_t[1][1])

    def stage_one(k, xi, u, p, t):
        return f_impl(k, xi, k.new_zeros((0,)), u, p, t)

    res_b = vmap(stage_one)
    fx_b = vmap(jacfwd(stage_one, argnums=1))
    fxu_b = vmap(jacfwd(stage_one, argnums=(1, 2)))

    def step_jac(x, u, p, t0, dt):
        M, nu = x.shape[0], u.shape[-1]
        dev, dt_ = x.device, x.dtype
        A_ = torch.as_tensor(A_t, dtype=dt_, device=dev)
        b_ = torch.as_tensor(b_t, dtype=dt_, device=dev)
        c_ = torch.as_tensor(c_t, dtype=dt_, device=dev)
        h = dt / num_steps
        eye = torch.eye(nx, dtype=dt_, device=dev)
        # per-instance inputs repeated for the two stages
        u2 = u[:, None].expand(M, ns, nu).reshape(M * ns, nu)
        p2 = p[:, None].expand((M, ns) + p.shape[1:]).reshape(
            (M * ns,) + p.shape[1:])

        def stages(w, x_k):
            """The stage values K and stage points xi as (2M, nx)."""
            K = w.reshape(M, ns, nx)
            xi = x_k[:, None] + h[:, None, None] * (A_ @ K)
            return K.reshape(M * ns, nx), xi.reshape(M * ns, nx)

        def both(R):
            """(2M, ...) stage batch -> the two stages' (M, ...) parts."""
            R = R.reshape((M, ns) + R.shape[1:])
            return R[:, 0], R[:, 1]

        x_k = x
        Sx = eye.expand(M, nx, nx)
        Su = torch.zeros((M, nx, nu), dtype=dt_, device=dev)
        w = torch.zeros((M, ns * nx), dtype=dt_, device=dev)
        for i in range(num_steps):
            t = t0 + i * h
            ti = (t[:, None] + c_ * h[:, None]).reshape(M * ns)
            # Jf from the predictor stage points (jac_reuse semantics: the
            # Newton preconditioner is frozen at the carried w)
            F1, F2 = both(fx_b(*stages(w, x_k), u2, p2, ti))
            hJ = -(h * 0.5)[:, None, None] * (F1 + F2)
            D = eye - trA * hJ + detA * (hJ @ hJ)
            Di = gj_inverse_any(D)

            def jinv_apply(r1, r2):
                """blockdiag(Di, Di) adj(J) applied to the stacked right-
                hand sides r1, r2 (each (M, nx, ncol))."""
                g1 = hJ @ r1
                g2 = hJ @ r2
                v1 = r1 - a22 * g1 + a12 * g2
                v2 = r2 - a11 * g2 + a21 * g1
                return Di @ v1, Di @ v2

            for _ in range(newton_iter):
                r1, r2 = both(res_b(*stages(w, x_k), u2, p2, ti))
                d1, d2 = jinv_apply(r1[..., None], r2[..., None])
                w = w - torch.cat([d1[..., 0], d2[..., 0]], dim=-1)

            # exact sensitivity right-hand sides at the converged stage
            # points, through the same frozen inverse
            Fx, Fu = fxu_b(*stages(w, x_k), u2, p2, ti)
            R1, R2 = both(torch.cat([Fx, Fu], dim=-1))
            d1, d2 = jinv_apply(R1, R2)
            dK = torch.stack([-d1, -d2], dim=1)        # (M, 2, nx, nx+nu)
            x_next = x_k + h[:, None] * (b_ @ w.reshape(M, ns, nx))
            G = h[:, None, None] * torch.einsum("s,msij->mij", b_, dK)
            A_sub = eye + G[:, :, :nx]
            x_k, Sx, Su = x_next, A_sub @ Sx, A_sub @ Su + G[:, :, nx:]
        return x_k, Sx, Su

    return step_jac


def make_irk_stage_points(*args, **kwargs):
    raise NotImplementedError(
        "cost_discretization INTEGRATOR (IRK stage points) is not ported "
        "yet (ROADMAP.md Queue 1, NLP breadth)")


def make_irk_z0_fun(*args, **kwargs):
    raise NotImplementedError(
        "the DAE z(t0) evaluator is not ported yet (ROADMAP.md Queue 1, "
        "integrator breadth)")


def implicit_from_explicit(f_expl):
    """Wrap an explicit ODE f(x, u, p, t) -> xdot as an implicit
    residual."""
    def f_impl(xdot, x, z, u, p, t):
        return xdot - f_expl(x, u, p, t)
    return f_impl
