"""GNSF structure-exploiting implicit RK integrator and its numeric
structure detection.

Counterpart of `acados_tpu/sim/gnsf.py` (reference sim_gnsf.c, dims and
model sim_gnsf.h:57-110, and the detection of gnsf.py:483, 758). Model
structure, states ordered x = [x1; x2]:

  nonlinear subsystem  (x1 in R^nx1, z1 in R^nz1):
      E [x1dot; z1] = A x1 + B u + C phi(y, uhat) + c
      y    = L_x x1 + L_xdot x1dot + L_z z1          (ny,)
      uhat = L_u u                                    (nuhat,)
  linear-output subsystem (x2 in R^nx2):
      E_LO x2dot = A_LO x2 + B_LO u + f_lo(x1, x1dot, z1, u) + c_LO

Under collocation the nonlinear subsystem's stage equations are linear
in the stage derivatives once the stage values of phi are fixed, so the
Newton iteration runs on the ns * n_out stacked phi values only; the
linear-output subsystem takes one linear solve. The solves are the
reference's `jnp.linalg.solve`; here `utils.autodiff.inv_solve`
(torch.linalg.inv, whose transforms are exact under vmap), and no kernel
of the repo runs.

The step of one instance is a plain torch function in the original state
order; `sim/integrator.py` batches it with `torch.func.vmap`, and the SQP
linearization takes `torch.func.jacfwd` of it through the unrolled Newton
iterations, as the reference's `jax.jacfwd` does. The collocation is
Gauss-Legendre, the reference's only one for GNSF. Model functions are
per-instance torch callables; the detection probes them in float64 on
the CPU at the same seeded points as the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from acados_tpu_torch.sim.butcher import gauss_legendre_tableau
from acados_tpu_torch.utils.autodiff import inv_solve, jacfwd

# the detection's Jacobian probes, their seed and the tolerance that
# tells a varying Jacobian row or a p / t dependence (the reference's
# defaults, acados_tpu/sim/gnsf.py:199-201)
N_PROBE, PROBE_SEED, PROBE_TOL = 8, 0, 1e-8


@dataclass
class GnsfModel:
    """GNSF structured model (reference sim_gnsf.h:72-110). All matrices
    are numpy (static model data)."""

    nx1: int
    nx2: int
    nz1: int
    n_out: int
    nu: int
    # nonlinear subsystem
    A: np.ndarray        # (nx1+nz1, nx1)
    B: np.ndarray        # (nx1+nz1, nu)
    C: np.ndarray        # (nx1+nz1, n_out)
    c: np.ndarray        # (nx1+nz1,)
    E: np.ndarray        # (nx1+nz1, nx1+nz1) on [x1dot; z1]
    L_x: np.ndarray      # (ny, nx1)
    L_xdot: np.ndarray   # (ny, nx1)
    L_z: np.ndarray      # (ny, nz1)
    L_u: np.ndarray      # (nuhat, nu)
    phi: Callable = None            # phi(y, uhat) -> (n_out,)
    # linear-output subsystem
    A_LO: np.ndarray = None         # (nx2, nx2)
    B_LO: np.ndarray = None         # (nx2, nu)
    E_LO: np.ndarray = None         # (nx2, nx2)
    c_LO: np.ndarray = None         # (nx2,)
    f_lo: Callable = None           # f_lo(x1, x1dot, z1, u) -> (nx2,)

    @property
    def ny(self):
        return self.L_x.shape[0]

    @property
    def nuhat(self):
        return self.L_u.shape[0]


class _keep_dtype(torch.autograd.Function):
    """Identity whose tangents and cotangents keep the primal's dtype.
    A float32 model that multiplies a 0-dim tensor by a Python float
    gets float64 tangents under torch.func (utils/autodiff.py); the
    Newton solve below would then see a float32 matrix and a float64
    tangent of its right-hand side."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dtype = inputs[0].dtype

    @staticmethod
    def jvp(ctx, dx):
        return dx.to(ctx.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def make_gnsf_step(model: GnsfModel, num_stages: int = 3,
                   num_steps: int = 1, newton_iter: int = 5):
    """Per-instance GNSF step of a detected model (acados_tpu/sim/gnsf.py:
    84-196, with the state permutation of :359-378): step(x, u, p, t0,
    dt) -> x_next, in the original state order. p and t0 are accepted
    for the other integrators' interface; the structure is autonomous in
    them. The detection finds no algebraic states (nz1 = 0), so there is
    no z to return."""
    Ab, bb, _ = gauss_legendre_tableau(num_stages)
    ns = num_stages
    m = model
    nx1, nx2, nz1, n_out = m.nx1, m.nx2, m.nz1, m.n_out
    nk = nx1 + nz1
    perm, iperm = torch.as_tensor(m.perm), torch.as_tensor(m.iperm)

    # condensed linear operators (the reference's sim_gnsf precompute):
    # M(h) = blockdiag(E) - h (a_butcher (x) [A, 0]) on the K part
    E_blk = np.kron(np.eye(ns), m.E)
    AK = np.zeros((ns * nk, ns * nk))
    for i in range(ns):
        for j in range(ns):
            blk = np.zeros((nk, nk))
            blk[:, :nx1] = m.A @ np.eye(nx1)
            AK[i * nk:(i + 1) * nk, j * nk:(j + 1) * nk] = Ab[i, j] * blk
    if nx2 > 0:
        E2_blk = np.kron(np.eye(ns), m.E_LO)
        A2K = np.kron(Ab, m.A_LO)

    def step(x, u, p, t0, dt):
        del p, t0
        h = dt / num_steps
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                         dtype=x.dtype, device=x.device)
        Mw = as_t(E_blk) - h * as_t(AK)
        A_, B_, C_, c_ = as_t(m.A), as_t(m.B), as_t(m.C), as_t(m.c)
        Lx, Lxd, Lz, Lu = as_t(m.L_x), as_t(m.L_xdot), as_t(m.L_z), \
            as_t(m.L_u)
        ab, bb_ = as_t(Ab), as_t(bb)
        uhat = Lu @ u

        def w_of_phi(Phi, x1_0):
            """Stage derivatives from the phi values (one linear solve)."""
            rhs = (A_ @ x1_0 + B_ @ u + c_)[None, :] + Phi @ C_.T
            return inv_solve(Mw, rhs.reshape(-1)).reshape(ns, nk)

        def substep_nl(x1_0):
            def newton_res(Phi_flat):
                Phi = Phi_flat.reshape(ns, n_out)
                W = w_of_phi(Phi, x1_0)
                K1, Z1 = W[:, :nx1], W[:, nx1:]
                X1 = x1_0[None, :] + h * (ab @ K1)
                Y = X1 @ Lx.T + K1 @ Lxd.T + Z1 @ Lz.T      # (ns, ny)
                phi_val = torch.stack([_keep_dtype.apply(m.phi(Y[s], uhat))
                                       for s in range(ns)])
                return (Phi - phi_val).reshape(-1)

            Phi_flat = x.new_zeros((ns * n_out,))
            # no unknowns without a nonlinearity (n_out == 0): Phi stays
            # the empty vector the reference's iterations leave it
            for _ in range(newton_iter if n_out else 0):
                J = jacfwd(newton_res)(Phi_flat)
                Phi_flat = Phi_flat - inv_solve(J, newton_res(Phi_flat))
            W = w_of_phi(Phi_flat.reshape(ns, n_out), x1_0)
            K1, Z1 = W[:, :nx1], W[:, nx1:]
            return x1_0 + h * (bb_ @ K1), K1, Z1

        xg = x[perm.to(x.device)]
        x1, x2 = xg[:nx1], xg[nx1:]
        for _ in range(num_steps):
            x1_next, K1, Z1 = substep_nl(x1)
            if nx2 > 0:
                X1 = x1[None, :] + h * (ab @ K1)
                Flo = torch.stack([m.f_lo(X1[s], K1[s], Z1[s], u)
                                   for s in range(ns)])      # (ns, nx2)
                M2 = as_t(E2_blk) - h * as_t(A2K)
                rhs2 = (as_t(m.A_LO) @ x2 + as_t(m.B_LO) @ u
                        + as_t(m.c_LO))[None, :] + Flo
                K2 = inv_solve(M2, rhs2.reshape(-1)).reshape(ns, nx2)
                x2 = x2 + h * (bb_ @ K2)
            x1 = x1_next
        return torch.cat([x1, x2])[iperm.to(x.device)]

    return step


def detect_gnsf_structure(f_expl, nx: int, nu: int,
                          p=None) -> Optional[GnsfModel]:
    """Numeric GNSF structure of an explicit ODE f_expl(x, u, p, t)
    (acados_tpu/sim/gnsf.py:199-356; reference gnsf.py:758 detects it
    symbolically): Jacobian-constancy probes classify each state equation
    as linear or nonlinear, the nonlinear block (and every state its
    equations read) becomes x1, the linear part is taken at the origin and
    the rest of each nonlinear row is phi. The probes come from
    np.random.default_rng(PROBE_SEED) in the reference's order, so both
    packages probe the same points. Returns None for dynamics that depend
    on p or t, or when the reconstruction fails its check on random
    samples (the caller then integrates with IRK).

    Structure: E = I, y = x1, uhat = u, n_out = the nonlinear equations.
    """
    f64 = dict(dtype=torch.float64)
    p = np.zeros((0,)) if p is None else np.asarray(p, np.float64)
    p_t = torch.as_tensor(p, **f64)
    rng = np.random.default_rng(PROBE_SEED)
    t_zero = torch.zeros((), **f64)

    def f(x, u, pp=p_t, t=t_zero):
        return f_expl(torch.as_tensor(x, **f64), torch.as_tensor(u, **f64),
                      pp, t).detach().numpy()

    # the structure is baked at the probe parameter and time: dynamics
    # that depend on p or t fall back to IRK
    xs = rng.normal(size=(3, nx))
    us = rng.normal(size=(3, nu))
    for xk, uk in zip(xs, us):
        f0 = f(xk, uk)
        ft = f(xk, uk, t=torch.tensor(0.7321, **f64))
        if np.abs(ft - f0).max() > PROBE_TOL:
            return None
        if len(np.atleast_1d(p)):
            p2 = p + rng.normal(size=np.atleast_1d(p).shape)
            if np.abs(f(xk, uk, pp=torch.as_tensor(p2, **f64))
                      - f0).max() > PROBE_TOL:
                return None
    jac_t = jacfwd(lambda xu: f_expl(xu[:nx], xu[nx:], p_t, t_zero))
    jac = lambda xu: jac_t(torch.as_tensor(xu, **f64)).numpy()

    # Jacobian-constancy probe: rows whose Jacobian varies are nonlinear
    Js = np.stack([jac(rng.normal(size=nx + nu)) for _ in range(N_PROBE)])
    row_var = np.abs(Js - Js[0]).max(axis=(0, 2))
    nonlin_rows = np.where(row_var > PROBE_TOL)[0]

    # states read by nonlinear equations live in x1, and so does every
    # state an x1 equation reads (fixed point)
    dep = np.abs(Js).max(axis=0)
    x1_set = set(nonlin_rows.tolist())
    for r in nonlin_rows:
        x1_set |= set(np.where(dep[r, :nx] > PROBE_TOL)[0].tolist())
    changed = True
    while changed:
        changed = False
        for r in sorted(x1_set):
            reads = set(np.where(dep[r, :nx] > PROBE_TOL)[0].tolist())
            if not reads <= x1_set:
                x1_set |= reads
                changed = True
    x1_idx = np.array(sorted(x1_set), dtype=int)
    x2_idx = np.array([i for i in range(nx) if i not in x1_set], dtype=int)
    nx1, nx2 = len(x1_idx), len(x2_idx)
    perm = np.concatenate([x1_idx, x2_idx]).astype(int)
    nl_in_x1 = np.array([np.where(x1_idx == r)[0][0] for r in nonlin_rows],
                        dtype=int)
    n_out = len(nonlin_rows)

    # linear part at the origin
    J0 = jac(np.zeros(nx + nu))
    f0 = f(np.zeros(nx), np.zeros(nu))
    Jx = J0[:, :nx][np.ix_(perm, perm)]
    Ju = J0[:, nx:][perm]
    f0p = f0[perm]
    A = np.array(Jx[:nx1, :nx1])
    B = Ju[:nx1]
    cvec = f0p[:nx1]
    C = np.zeros((nx1, n_out))
    for k, r in enumerate(nl_in_x1):
        C[r, k] = 1.0

    # y = x1 scattered back to the full state by a 0/1 matrix (exact)
    S1 = np.zeros((nx, nx1))
    S1[x1_idx, np.arange(nx1)] = 1.0
    nl_rows = [int(r) for r in nonlin_rows]
    A_lin0 = J0[np.ix_(nonlin_rows, np.arange(nx))] if n_out else None
    B_lin0 = J0[np.ix_(nonlin_rows, nx + np.arange(nu))] if n_out else None
    f0_nl = f0[nonlin_rows] if n_out else None

    def phi(y, uhat):
        as_t = lambda a: torch.as_tensor(a, dtype=y.dtype, device=y.device)
        x_full = as_t(S1) @ y
        fx = f_expl(x_full, uhat, as_t(p), y.new_zeros(()))
        lin = as_t(A_lin0) @ x_full + as_t(B_lin0) @ uhat + as_t(f0_nl)
        return fx[nl_rows] - lin

    A_LO = Jx[nx1:, nx1:]
    B_LO = Ju[nx1:]
    c_LO = f0p[nx1:]
    Jx2_x1 = Jx[nx1:, :nx1]

    def f_lo(x1, x1dot, z1, u):
        del x1dot, z1, u
        return torch.as_tensor(Jx2_x1, dtype=x1.dtype,
                               device=x1.device) @ x1

    model = GnsfModel(
        nx1=nx1, nx2=nx2, nz1=0, n_out=n_out, nu=nu,
        A=A, B=B, C=C, c=cvec, E=np.eye(nx1),
        L_x=np.eye(nx1), L_xdot=np.zeros((nx1, nx1)),
        L_z=np.zeros((nx1, 0)), L_u=np.eye(nu),
        phi=phi if n_out else (lambda y, uh: y.new_zeros((0,))),
        A_LO=A_LO, B_LO=B_LO, E_LO=np.eye(nx2), c_LO=c_LO, f_lo=f_lo)

    def reconstruct(x, u):
        x1 = x[perm[:nx1]] if nx1 else np.zeros(0)
        xd = np.zeros(nx)
        ph = (model.phi(torch.as_tensor(x1, **f64),
                        torch.as_tensor(u, **f64)).numpy()
              if n_out else np.zeros(0))
        r1 = A @ x1 + B @ u + (C @ ph if n_out else 0.0) + cvec
        x2 = x[perm[nx1:]] if nx2 else np.zeros(0)
        r2 = (A_LO @ x2 + B_LO @ u + c_LO + Jx2_x1 @ x1) if nx2 \
            else np.zeros(0)
        xd[perm[:nx1]] = r1
        if nx2:
            xd[perm[nx1:]] = r2
        return xd

    for _ in range(4):
        xs = rng.normal(size=nx)
        us = rng.normal(size=nu)
        if not np.allclose(reconstruct(xs, us), f(xs, us),
                           rtol=1e-6, atol=1e-6):
            return None
    model.perm = perm       # state permutation: x_gnsf = x[perm]
    model.iperm = np.argsort(perm)
    return model
