"""Implicit Runge-Kutta (collocation) integrator for ODEs and DAEs,
batch-first.

Counterpart of `acados_tpu/sim/irk.py`: Gauss-Legendre or Radau IIA
collocation with a fixed number of Newton iterations over the stacked
stage equations of nx differential and nz algebraic unknowns a stage,
f_impl(xdot, x, z, u, p, t) = 0. `make_irk_step` differentiates through
its stage solves by the implicit function theorem (`_stage_root`, the
reference's custom_root); `make_irk_step_jac` builds the step Jacobians
itself for the SQP linearization, and for a DAE also z at the interval
start and its Jacobian (the reference's dzduxt); `make_irk_z0_fun`
solves the first stage system alone for z(t0).

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
from acados_tpu_torch.utils.autodiff import fold_vmap, jacfwd


def _tableau(collocation: str, num_stages: int):
    if collocation.upper() in ("GAUSS_LEGENDRE", "GAUSS"):
        return gauss_legendre_tableau(num_stages)
    if collocation.upper() in ("RADAU_IIA", "RADAU"):
        return radau_iia_tableau(num_stages)
    raise ValueError(f"unknown collocation {collocation}")


def _z_weights(c_t, tau: float) -> np.ndarray:
    """Lagrange weights of the collocation basis at tau: the algebraic
    stage values extrapolated to tau = 1 (z(T), the reference's
    `_z_end_weights`, acados_tpu/sim/irk.py:25) or tau = 0 (z(t0))."""
    ns = len(c_t)
    w = np.zeros(ns)
    for j in range(ns):
        others = np.delete(np.asarray(c_t), j)
        w[j] = (np.prod((tau - others) / (c_t[j] - others))
                if ns > 1 else 1.0)
    return w


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


def _stage_root(res_one, newton_iter: int):
    """The stage solve of one substep as an autograd Function with the
    implicit gradient of the reference's `jax.lax.custom_root`
    (acados_tpu/sim/irk.py:84-107).

    root(x, u, p, t, h, w0) -> w* runs `newton_iter` Newton iterations
    on res(w, x, u, p, t, h) = 0 from w0 (batch-first: every argument
    leads with the batch). Its derivatives are those of the implicit
    function theorem at the final iterate, never of the iterations, with
    theta = (x, u, p, t, h) and J = d res / dw at w*:
    - jvp: dw = -J^-1 (d res / d theta) dtheta, one solve for every
      tangent column;
    - backward: grad_theta = -(d res / d theta)' J^-T grad (the Function
      `theta_vjp` below, whose own jvp makes backward differentiable in
      forward mode: jacfwd of vjp, as S_hess and hessian take it, is
      exact);
    - vmap: every vmapped axis folds into the batch, so the Newton loop
      runs once however many axes or tangent columns are vmapped.
    The Newton start w0 carries no derivative. The solves are `linsolve`:
    the Gauss-Jordan kernel K1 on the card, LAPACK on the CPU.

    A reverse-mode transform (torch.func.vjp) cannot run inside a
    Function's backward under torch.func, so every reverse product of
    the residual runs in a Function's forward or jvp, where it can.
    """
    res_b = vmap(res_one)
    jac_w = vmap(jacfwd(res_one, argnums=0))

    def zeros_for(tangents, primals):
        return tuple(torch.zeros_like(p) if d is None else d.to(p.dtype)
                     for d, p in zip(tangents, primals))

    def pull_theta(w, theta, cot):
        """(d res / d theta)' cot at (w, theta), one tensor per theta."""
        _, pull = torch.func.vjp(lambda *a: res_b(w, *a), *theta)
        return tuple(g.to(p.dtype) for g, p in zip(pull(cot), theta))

    class second(torch.autograd.Function):
        """The gradient of theta_vjp's output along its cotangents
        (double backward): with lam = J^-T g, v = (d res / d theta) obar
        and mu = J^-1 v, grad_g = -mu and grad_(w, theta) = d/d(w, theta)
        of lam' (d res) . (mu, -obar) at fixed lam, mu."""

        @staticmethod
        def forward(g, w, *args):
            theta, obar = args[:5], args[5:]
            J = jac_w(w, *theta)
            lam = linsolve(J.transpose(-1, -2), g)
            _, v = torch.func.jvp(lambda *a: res_b(w, *a), theta, obar)
            mu = linsolve(J, v.to(w.dtype))

            def s(w_, *a):
                _, r = torch.func.jvp(
                    res_b, (w_, *a), (mu, *(-o for o in obar)))
                return (lam * r).sum()

            grads = torch.func.grad(s, argnums=tuple(range(6)))(w, *theta)
            return (-mu, *(gr.to(p.dtype)
                           for gr, p in zip(grads, (w, *theta))))

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def vmap(info, in_dims, *args):
            return fold_vmap(second.apply, info, in_dims, *args)

    class theta_vjp(torch.autograd.Function):
        """(g, w, *theta) -> -(d res / d theta)' lam, lam = J^-T g: the
        root's backward. jvp: with phi(w, theta) = (d res / d(w,
        theta))' lam, a forward-over-reverse product of the residual (no
        derivative of J is formed), dlam = J^-T (dg - dphi_w) and the
        output's tangent is -(dphi_theta + (d res / d theta)' dlam)."""

        @staticmethod
        def forward(g, w, *theta):
            J = jac_w(w, *theta)
            lam = linsolve(J.transpose(-1, -2), g)
            return pull_theta(w, theta, -lam)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)
            ctx.save_for_forward(*inputs)

        @staticmethod
        def jvp(ctx, dg, dw, *dtheta):
            g, w, *theta = ctx.saved_tensors
            theta = tuple(theta)
            J = jac_w(w, *theta)
            lam = linsolve(J.transpose(-1, -2), g)

            def phi(w_, *a):
                _, pull = torch.func.vjp(res_b, w_, *a)
                return pull(lam)

            _, dphi = torch.func.jvp(phi, (w, *theta),
                                     zeros_for((dw, *dtheta), (w, *theta)))
            dg = torch.zeros_like(g) if dg is None else dg
            dlam = linsolve(J.transpose(-1, -2), dg - dphi[0].to(g.dtype))
            pulled = pull_theta(w, theta, dlam)
            return tuple(-(d.to(p.dtype) + q)
                         for d, q, p in zip(dphi[1:], pulled, theta))

        @staticmethod
        def backward(ctx, *obar):
            g, w, *theta = ctx.saved_tensors
            obar = zeros_for(obar, theta)
            return second.apply(g, w, *theta, *obar)

        @staticmethod
        def vmap(info, in_dims, *args):
            return fold_vmap(theta_vjp.apply, info, in_dims, *args)

    class root(torch.autograd.Function):
        @staticmethod
        def forward(x, u, p, t, h, w0):
            w = w0
            for _ in range(newton_iter):
                J = jac_w(w, x, u, p, t, h)
                w = w - linsolve(J, res_b(w, x, u, p, t, h))
            return w

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs[:5], output)
            ctx.save_for_forward(*inputs[:5], output)

        @staticmethod
        def jvp(ctx, dx, du, dp, dt, dh, dw0):
            *theta, w = ctx.saved_tensors
            theta = tuple(theta)
            _, r_dot = torch.func.jvp(
                lambda *a: res_b(w, *a), theta,
                zeros_for((dx, du, dp, dt, dh), theta))
            J = jac_w(w, *theta)
            return -linsolve(J, r_dot.to(w.dtype))

        @staticmethod
        def backward(ctx, grad):
            *theta, w = ctx.saved_tensors
            return (*theta_vjp.apply(grad, w, *theta), None)

        @staticmethod
        def vmap(info, in_dims, *args):
            return fold_vmap(root.apply, info, in_dims, *args)

    return root.apply


def make_irk_step(f_impl, nx: int, nz: int = 0, num_stages: int = 3,
                  num_steps: int = 1, newton_iter: int = 3,
                  collocation: str = "GAUSS_LEGENDRE"):
    """Batch-first IRK step: step(x (M, nx), u, p, t0 (M,), dt (M,)) ->
    (x_next (M, nx), z_out (M, nz)).

    Each substep's stage solve is `_stage_root`: a fixed `newton_iter`
    Newton iterations from the previous substep's stage solution, as in
    the reference's custom_root carry, with the implicit gradient at the
    final iterate, so `torch.func` transforms (jvp, vjp, jacfwd, hessian,
    vmap) differentiate the step as `jax` differentiates the reference's
    (acados_tpu/sim/irk.py:84-107). z_out is the algebraic variable at
    the interval end, the last substep's stage values extrapolated to
    tau = 1 (zeros (M, 0) for an ODE)."""
    A_t, b_t, c_t = _tableau(collocation, num_stages)
    ns = num_stages
    nw = ns * (nx + nz)
    zw = _z_weights(c_t, 1.0)
    root = _stage_root(_stage_residual(f_impl, A_t, c_t, nx, nz),
                       newton_iter)

    def step(x, u, p, t0, dt):
        M = x.shape[0]
        b_ = torch.as_tensor(b_t, dtype=x.dtype, device=x.device)
        h = dt / num_steps
        w = torch.zeros((M, nw), dtype=x.dtype, device=x.device)
        x_k = x
        for i in range(num_steps):
            t = t0 + i * h
            w = root(x_k, u, p, t, h, w)
            K = w[:, : ns * nx].reshape(M, ns, nx)
            x_k = x_k + h[:, None] * (b_ @ K)
        if nz == 0:
            return x_k, torch.zeros((M, 0), dtype=x.dtype, device=x.device)
        zw_ = torch.as_tensor(zw, dtype=x.dtype, device=x.device)
        return x_k, zw_ @ w[:, ns * nx:].reshape(M, ns, nz)

    return step


def make_irk_step_jac(f_impl, nx: int, nz: int = 0, num_stages: int = 3,
                      num_steps: int = 1, newton_iter: int = 3,
                      collocation: str = "GAUSS_LEGENDRE",
                      jac_reuse: bool = False,
                      kron_path: bool | None = None,
                      explicit_ode: bool = False):
    """Batch-first IRK step that also returns the step Jacobians:
    step_jac(x (M, nx), u (M, nu), p (M, np), t0 (M,), dt (M,)) ->
    (x_next (M, nx), A (M, nx, nx), B (M, nx, nu)), and for a DAE
    (nz > 0) (x_next, A, B, z0 (M, nz), Jz (M, nz, nx + nu)): z at the
    interval start (the first substep's algebraic stage values
    extrapolated to tau = 0) and dz0/d(x, u), the reference's dzduxt
    (acados_tpu/sim/irk.py:316-336, 399-405).

    The generic path of acados_tpu/sim/irk.py:196-327: the stage Jacobian
    is built and inverted newton_iter times per substep (once with
    jac_reuse) and once more at the converged root without jac_reuse, and
    that one inverse serves all nx + nu sensitivity columns. At a DAE's
    stage size ns (nx + nz) = 9 (3 stages, nx 2, nz 1) the inverses run
    on K1's warp branch.

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
    if kron_path:
        return _kron_step_jac(f_impl, nx, A_t, b_t, c_t, num_steps,
                              newton_iter)
    ns = num_stages
    nw = ns * (nx + nz)
    zw0 = _z_weights(c_t, 0.0)
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
            if nz and i == 0:
                # z(t0) and dz0/d(x, u) at the first substep, where
                # d(x_k, u)/d(x, u) is the identity
                zw0_ = torch.as_tensor(zw0, dtype=dt_, device=dev)
                z0 = zw0_ @ w[:, ns * nx:].reshape(M, ns, nz)
                Jz = torch.einsum("s,mszj->mzj", zw0_,
                                  dW[:, ns * nx:].reshape(M, ns, nz,
                                                          nx + nu))
            x_k, Sx, Su = x_next, A_sub @ Sx, A_sub @ Su + G[:, :, nx:]
        if nz:
            return x_k, Sx, Su, z0, Jz
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


def make_irk_stage_points(f_impl, nx: int, nz: int = 0,
                          num_stages: int = 3, num_steps: int = 1,
                          newton_iter: int = 3,
                          collocation: str = "GAUSS_LEGENDRE"):
    """Collocation stage points for cost_discretization INTEGRATOR
    (acados_tpu/sim/irk.py:119-190).

    Returns (points, weights): the per-instance points(x, u, p, t0, dt)
    -> (Xs (nq, nx), Zs (nq, nz) or None for an ODE, Ts (nq,)), the stage
    states, algebraic stage values and stage times of all num_steps
    substeps (nq = num_steps * num_stages), and the
    quadrature weights b / num_steps tiled over the substeps (they sum to
    1). Each substep's stage solve is `_stage_root` on a batch of one,
    started from the previous substep's solution as the reference's scan
    carries it: under torch.func.vmap the instances fold into one batch
    of Newton solves, and torch.func.jacfwd through the points takes the
    implicit gradient, as jax.lax.custom_root does."""
    A_t, b_t, c_t = _tableau(collocation, num_stages)
    ns = num_stages
    root = _stage_root(_stage_residual(f_impl, A_t, c_t, nx, nz),
                       newton_iter)
    weights = np.tile(np.asarray(b_t, np.float64) / num_steps, num_steps)

    def points(x, u, p, t0, dt):
        A_ = torch.as_tensor(A_t, dtype=x.dtype, device=x.device)
        c_ = torch.as_tensor(c_t, dtype=x.dtype, device=x.device)
        b_ = torch.as_tensor(b_t, dtype=x.dtype, device=x.device)
        h = dt / num_steps
        w = x.new_zeros((ns * (nx + nz),))
        Xs, Zs, Ts = [], [], []
        for i in range(num_steps):
            t = t0 + i * h
            w = root(x[None], u[None], p[None], t[None], h[None],
                     w[None])[0]
            K = w[: ns * nx].reshape(ns, nx)
            Xs.append(x[None, :] + h * (A_ @ K))
            Zs.append(w[ns * nx:].reshape(ns, nz))
            Ts.append(t + c_ * h)
            x = x + h * (b_ @ K)
        return torch.cat(Xs), torch.cat(Zs) if nz else None, torch.cat(Ts)

    return points, weights


def make_irk_z0_fun(f_impl, nx: int, nz: int, num_stages: int = 3,
                    newton_iter: int = 3,
                    collocation: str = "GAUSS_LEGENDRE"):
    """Batch-first z(t0) evaluator z0_fun(x (M, nx), u, p, t0 (M,),
    dt (M,)) -> (M, nz) (acados_tpu/sim/irk.py:409-456): newton_iter
    Newton iterations on the first collocation stage system at (x, u)
    from zero, with the step dt as given, and the algebraic stage values
    extrapolated to tau = 0. The merit and residual evaluations of an NLP
    whose cost or constraints read z call it at trial points. Each
    iteration is one `linsolve` over the whole batch: one K1 launch on
    the card."""
    A_t, _, c_t = _tableau(collocation, num_stages)
    ns = num_stages
    nw = ns * (nx + nz)
    zw0 = _z_weights(c_t, 0.0)
    res_one = _stage_residual(f_impl, A_t, c_t, nx, nz)
    res_b = vmap(res_one)
    jac_w = vmap(jacfwd(res_one, argnums=0))

    def z0_fun(x, u, p, t0, dt):
        M = x.shape[0]
        w = torch.zeros((M, nw), dtype=x.dtype, device=x.device)
        for _ in range(newton_iter):
            w = w - linsolve(jac_w(w, x, u, p, t0, dt),
                             res_b(w, x, u, p, t0, dt))
        zw0_ = torch.as_tensor(zw0, dtype=x.dtype, device=x.device)
        return zw0_ @ w[:, ns * nx:].reshape(M, ns, nz)

    return z0_fun


def implicit_from_explicit(f_expl):
    """Wrap an explicit ODE f(x, u, p, t) -> xdot as an implicit
    residual."""
    def f_impl(xdot, x, z, u, p, t):
        return xdot - f_expl(x, u, p, t)
    return f_impl
