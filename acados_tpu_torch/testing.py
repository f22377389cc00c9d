"""Seeded test inputs: matrices for the Gauss-Jordan inverse (K1),
batches of OCP-QPs, RTI batches set up from per-instance x0s, the
parametric pendulum of the sensitivity tests, the unconstrained pendulum
of the DDP tests, the obstacle OCP of the WFQP and BGP tests, the
DAE-constrained cart of the DAE tests, the p_global model, the
pendulum's hand-rolled RK4 step for DISCRETE dynamics, the multiphase
transition example, the control-horizon pendulum, a batch-first
runner of multiphase OCPs, and one process of a batch split over
processes.

Shared by the CPU tests (tests/test_torch_*.py) and the card's check
(chip_smoke.py), so both hold the port to the same cases. Nothing here
runs in the solver.
"""
from __future__ import annotations

import numpy as np

__all__ = ["JAX_SENS_F32_GAP", "DAE_ZBOUND", "MOCP_X0", "MocpBatch",
           "control_horizon_mocp", "dae_ocp", "ddp_pendulum_ocp",
           "obstacle_ocp", "pendulum_rk4", "pglobal_ocp",
           "param_pendulum_ocp", "pivot_tie_batch", "random_qp_batch",
           "row_permuted_batch", "rti_batch", "slice_solve_worker",
           "transition_mocp"]

# The JAX package's forward-adjoint gap in float32: max over instances of
# max|adj - fwd| / max|fwd|, fwd = d u_0 / d x0 from its forward
# sensitivities, adj from its adjoint seeded on u_0, on bench.py's
# bench_pendulum_irk_sqp config at the first 4 of chip_smoke.py's x0s
# (tests/test_torch_sens_f32.py measures it and holds it between half
# this value and this value).
# chip_smoke.py holds the port's gap on the card to 10 x this.
JAX_SENS_F32_GAP = 1.01e-7


def rti_batch(ocp, x0s: np.ndarray, device, opts_update=None,
              qp_opts_update=None, devices=None):
    """AcadosOcpBatchSolver of len(x0s) instances of `ocp`, set up as
    bench.py's _build_rti sets up the JAX package's batch: each
    instance's x0 as lbx = ubx at stage 0 and as its initial x at every
    stage, through the per-instance views as a user would.

    opts_update / qp_opts_update: SqpOpts and IpmOpts fields that
    replace those the solver derived from the OCP (bench.py's keywords
    of the same names, e.g. qp_solver_name="ADMM" or
    parallel_riccati=True); the solve function is rebuilt with them.
    devices: the solver's mesh, given with device None."""
    from acados_tpu_torch.interface.batch_solver import AcadosOcpBatchSolver
    from acados_tpu_torch.interface.solver import make_nlp_solver
    solver = AcadosOcpBatchSolver(ocp, len(x0s), device=device,
                                  devices=devices)
    if opts_update or qp_opts_update:
        opts = solver.opts.replace(**(opts_update or {}))
        opts = opts.replace(qp_opts=opts.qp_opts.replace(
            **(qp_opts_update or {})))
        solver.opts = opts
        solver._solve_fn = make_nlp_solver(
            solver.form, opts, ocp.solver_options.nlp_solver_type)
    for i, view in enumerate(solver.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(solver.N + 1):
            view.set(k, "x", x0s[i])
    return solver


def row_permuted_batch(rng: np.random.Generator, B: int,
                       n: int) -> np.ndarray:
    """(B, n, n) well-conditioned matrices (N(0, 1) + n I) with their rows
    in a random order per matrix: the dominant entry of a column sits off
    the diagonal, so the pivot search swaps rows at most steps."""
    A = rng.normal(size=(B, n, n)) + n * np.eye(n)
    return np.take_along_axis(A, np.argsort(rng.random((B, n)))[..., None],
                              1)


def pivot_tie_batch(rng: np.random.Generator, B: int,
                    n: int) -> tuple[np.ndarray, np.ndarray]:
    """Matrices with many equal magnitudes in their pivot columns, and
    their exact inverses: (A, A^-1), at most B of them.

    A = Q L U with unit triangular L, U of entries in {-1, 0, 1} and a
    random row order Q, so column entries tie at +-1 and rows swap. Kept
    are the matrices whose pivots under the lowest-index rule are all
    +-1: Gauss-Jordan then runs in exact integer arithmetic in float32
    and float64 alike, and A^-1 is an integer matrix computed without
    rounding. Another choice among equal magnitudes can meet other
    pivots and round, so it shows as a difference."""
    d = min(0.7, 3.0 / n)
    sign = lambda: (rng.random((B, n, n)) < d) * rng.choice([-1.0, 1.0],
                                                               (B, n, n))
    A = (np.tril(sign(), -1) + np.eye(n)) @ (np.triu(sign(), 1) + np.eye(n))
    A = np.take_along_axis(A, np.argsort(rng.random((B, n)))[..., None], 1)
    M, b, unit = A.copy(), np.arange(B), np.ones(B, bool)
    for k in range(n):   # forward elimination: the pivots Gauss-Jordan meets
        p = k + np.argmax(np.abs(M[:, k:, k]), axis=1)
        M[b, k], M[b, p] = M[b, p], M[b, k]
        unit &= np.abs(M[:, k, k]) == 1
        M[:, k + 1:] -= M[:, k + 1:, k:k + 1] * M[:, k, None, :] / \
            M[:, k, None, k:k + 1]
    A = A[unit]
    X = np.linalg.inv(A).round()
    unit = np.all(A @ X == np.eye(n), axis=(1, 2)) & \
        (np.abs(X).max(axis=(1, 2), initial=0.0) < 2.0 ** 20)
    return A[unit], X[unit]


def random_qp_batch(seed, B=8, N=8, nx=4, nu=2, nc=3, soft=False,
                    x0_rows=True):
    """Seeded batch of well-conditioned box/general-constrained OCP-QPs
    (numpy, float64). With x0_rows, the first nx stage-0 rows pin x0
    (lg == ug, the rows x0 elimination removes); without, those rows are
    masked off and x0 is free. The other rows are centred on the
    zero-input rollout so u = 0 is strictly feasible."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=(B,) + s)
    Qs, Rs = 0.3 * n(N + 1, nx, nx), 0.3 * n(N, nu, nu)
    d = dict(
        Q=np.einsum("bkij,bkil->bkjl", Qs, Qs) + np.eye(nx),
        R=np.einsum("bkij,bkil->bkjl", Rs, Rs) + np.eye(nu),
        S=0.05 * n(N, nu, nx),
        q=n(N + 1, nx), r=n(N, nu),
        A=np.eye(nx) + 0.1 * n(N, nx, nx),
        B=0.3 * n(N, nx, nu), b=0.1 * n(N, nx))
    nct = nc + nx
    C = np.zeros((B, N + 1, nct, nx))
    D = np.zeros((B, N, nct, nu))
    x0 = 0.5 * n(nx)
    C[:, 0, :nx] = np.eye(nx)
    Cr, Dr = n(N + 1, nc, nx), n(N, nc, nu)
    C[:, :, nx:], D[:, :, nx:] = Cr, Dr
    x_roll = [x0]
    for k in range(N):
        x_roll.append(np.einsum("bij,bj->bi", d["A"][:, k], x_roll[-1])
                      + d["b"][:, k])
    g0 = np.einsum("bkij,bkj->bki", Cr, np.stack(x_roll, 1))
    widths = 0.2 + 1.5 * rng.uniform(size=(2, B, N + 1, nc))
    lg = np.zeros((B, N + 1, nct))
    ug = np.zeros((B, N + 1, nct))
    lg[:, 0, :nx] = ug[:, 0, :nx] = x0
    lg[:, :, nx:] = g0 - widths[0]
    ug[:, :, nx:] = g0 + widths[1]
    mask = np.zeros((B, N + 1, nct))
    mask[:, 0, :nx] = 1.0 if x0_rows else 0.0
    mask[:, :, nx:] = 1.0
    z = np.zeros((B, N + 1, nct))
    soft_mask, Zl, zl = z.copy(), z.copy(), z.copy()
    if soft:
        soft_mask[:, :, nx:] = 1.0
        Zl[:, :, nx:] = 10.0
        zl[:, :, nx:] = 1.0
    d.update(C=C, D=D, lg=lg, ug=ug, mask_l=mask, mask_u=mask.copy(),
             Zl=Zl, Zu=Zl.copy(), zl=zl, zu=zl.copy(), soft_mask=soft_mask)
    return d


def param_pendulum_ode(x, u, p, t=None):
    """The pendulum with parametric pendulum mass m = p[0] and length
    l = p[1] (tests/test_sensitivity.py:12-24)."""
    import torch
    theta, v, dtheta = x[1], x[2], x[3]
    F = u[0]
    s, c = torch.sin(theta), torch.cos(theta)
    m, l = p[0], p[1]
    M, g = 1.0, 9.81
    denom = M + m - m * c * c
    a = (-m * l * s * dtheta * dtheta + m * g * c * s + F) / denom
    dd = (-m * l * c * s * dtheta * dtheta + F * c + (M + m) * g * s) \
        / (l * denom)
    return torch.stack([v, dtheta, a, dd])


def param_pendulum_ocp(soft=False, N=20, dtype="float64",
                       integrator_type="ERK"):
    """The parametric pendulum OCP of tests/test_sensitivity.py:27-72:
    NONLINEAR_LS on (x, u), |F| <= 50, x0 = [0, pi/2, 0, 0], p = [0.1,
    0.8], SQP to tol 1e-11; soft: a softened bound |x_0| <= 0.9."""
    import torch

    from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
    ocp = AcadosOcp()
    m = AcadosModel()
    m.name = "param_pendulum"
    m.x, m.u, m.p = 4, 1, 2
    m.f_expl_expr = lambda x, u, p: param_pendulum_ode(x, u, p)
    ocp.model = m
    nx, nu = 4, 1
    ocp.solver_options.N_horizon = N
    ocp.solver_options.tf = 1.0
    Q = 2 * np.diag([1e3, 1e3, 1e-2, 1e-2])
    R = 2 * np.diag([1e-2])
    ocp.cost.cost_type = "NONLINEAR_LS"
    m.cost_y_expr = lambda x, u: torch.cat([x, u])
    ocp.cost.yref = np.zeros(nx + nu)
    ocp.cost.W = np.block([[Q, np.zeros((nx, nu))],
                           [np.zeros((nu, nx)), R]])
    ocp.cost.cost_type_e = "NONLINEAR_LS"
    m.cost_y_expr_e = lambda x: x
    ocp.cost.yref_e = np.zeros(nx)
    ocp.cost.W_e = Q
    ocp.constraints.lbu = np.array([-50.0])
    ocp.constraints.ubu = np.array([50.0])
    ocp.constraints.idxbu = np.array([0])
    if soft:
        ocp.constraints.idxbx = np.array([0])
        ocp.constraints.lbx = np.array([-0.9])
        ocp.constraints.ubx = np.array([0.9])
        ocp.constraints.idxsbx = np.array([0])
        ocp.cost.Zl = np.array([1e3])
        ocp.cost.Zu = np.array([1e3])
        ocp.cost.zl = np.array([1e2])
        ocp.cost.zu = np.array([1e2])
    ocp.constraints.x0 = np.array([0.0, np.pi / 2, 0.0, 0.0])
    ocp.parameter_values = np.array([0.1, 0.8])
    so = ocp.solver_options
    so.integrator_type = integrator_type
    so.sim_method_num_steps = 1
    so.nlp_solver_type = "SQP"
    so.nlp_solver_max_iter = 200
    so.tol = 1e-11
    so.dtype = dtype
    return ocp


def ddp_pendulum_ocp(N=10, dtype="float64", integrator_type="ERK",
                     weight=1.0):
    """The unconstrained pendulum swing-up of tests/test_ddp.py:41-66 for
    nlp_solver_type="DDP" (MERIT_BACKTRACKING, 100 iterations):
    NONLINEAR_LS on (x, u) with Q = 2 diag(1e3, 1e3, 1e-2, 1e-2), a
    control weight 2, the weights scaled by `weight`; x0 = [0, pi, 0, 0]
    its only constraint; 2 substeps of ERK or of the main path's IRK."""
    import torch

    from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
    from acados_tpu_torch.models.pendulum import pendulum_ode
    ocp, m = AcadosOcp(), AcadosModel()
    m.name, m.x, m.u = "pend", 4, 1
    m.f_expl_expr = lambda x, u: pendulum_ode(x, u, None, 0.0)
    m.cost_y_expr = lambda x, u: torch.cat([x, u])
    m.cost_y_expr_e = lambda x: x
    ocp.model = m
    Q = 2 * np.diag([1e3, 1e3, 1e-2, 1e-2])
    W = np.zeros((5, 5))
    W[:4, :4] = Q
    W[4, 4] = 2.0
    ocp.cost.cost_type = ocp.cost.cost_type_e = "NONLINEAR_LS"
    ocp.cost.yref, ocp.cost.W = np.zeros(5), weight * W
    ocp.cost.yref_e, ocp.cost.W_e = np.zeros(4), weight * Q
    ocp.constraints.x0 = np.array([0.0, np.pi, 0.0, 0.0])
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N, 1.0, dtype
    so.integrator_type, so.sim_method_num_steps = integrator_type, 2
    so.nlp_solver_type, so.globalization = "DDP", "MERIT_BACKTRACKING"
    so.nlp_solver_max_iter = 100
    return ocp


def obstacle_ocp(rows="h", N=10, dtype="float64"):
    """The point mass of tests/test_wfqp.py:24-56 from (-2, 0.01) to
    (2, 0) outside the unit disc, ||x||^2 >= 1 on the path and at the
    end, as BGH h rows (rows="h") or as BGP rows phi(r) = r1^2 + r2^2,
    r = x (rows="bgp", tests/test_formulations.py:35-74), the same NLP;
    SQP_WITH_FEASIBLE_QP with MERIT_BACKTRACKING, 100 iterations."""
    import torch

    from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
    ocp, m = AcadosOcp(), AcadosModel()
    goal = torch.tensor([2.0, 0.0], dtype=torch.float64)
    m.name, m.x, m.u = "pt", 2, 2
    m.f_expl_expr = lambda x, u: u
    m.cost_y_expr = lambda x, u: torch.cat([x - goal.to(x), 0.3 * u])
    m.cost_y_expr_e = lambda x: x - goal.to(x)
    ocp.model = m
    ocp.cost.cost_type = ocp.cost.cost_type_e = "NONLINEAR_LS"
    ocp.cost.yref, ocp.cost.W = np.zeros(4), np.eye(4)
    ocp.cost.yref_e, ocp.cost.W_e = np.zeros(2), 10 * np.eye(2)
    ocp.constraints.x0 = np.array([-2.0, 0.01])
    c = ocp.constraints
    disc = lambda v: torch.stack([v[0] ** 2 + v[1] ** 2])
    if rows == "bgp":
        m.con_phi_expr = m.con_phi_expr_e = disc
        m.con_r_expr = lambda x, u: x
        m.con_r_expr_e = lambda x: x
        c.lphi, c.uphi = np.array([1.0]), np.array([1e10])
        c.lphi_e, c.uphi_e = np.array([1.0]), np.array([1e10])
    else:
        m.con_h_expr = lambda x, u: disc(x)
        m.con_h_expr_e = disc
        c.lh, c.uh = np.array([1.0]), np.array([1e10])
        c.lh_e, c.uh_e = np.array([1.0]), np.array([1e10])
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N, 4.0, dtype
    so.nlp_solver_type = "SQP_WITH_FEASIBLE_QP"
    so.globalization, so.nlp_solver_max_iter = "MERIT_BACKTRACKING", 100
    return ocp


# tests/test_dae_nlp.py's cart with Coulomb-like friction z = c v^3
DAE_C_FRIC, DAE_ZBOUND, DAE_UMAX = 0.7, 0.12, 2.5


def dae_ocp(N=20, dtype="float64", tf=2.0):
    """tests/test_dae_nlp.py:make_dae_ocp (examples/dae_constrained_ocp.py):
    x = (position, velocity), u the force, the algebraic z = c v^3 of the
    implicit DAE 0 = z - c v^3; NONLINEAR_LS on (x, u, z) with W =
    diag(1, 0.5, 0.05, 0.3) and |z| <= DAE_ZBOUND as an h row, both reading
    z; IRK Gauss-Legendre 3 stages, 2 substeps (a stage system of
    3 (2 + 1) = 9 unknowns); SQP, 60 iterations; x0 = (1, 0), |u| <= 2.5.
    The horizon is tf / N a step: tf scales with N where N is cut."""
    import torch

    from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
    ocp, m = AcadosOcp(), AcadosModel()
    m.name, m.x, m.u, m.z = "dae_fric", 2, 1, 1

    def f_impl(xdot, x, z, u, p, t):
        return torch.cat([xdot[:1] - x[1:2], xdot[1:2] - (u - z),
                          z - DAE_C_FRIC * x[1:2] ** 3])

    m.f_impl_expr = f_impl
    m.cost_y_expr = lambda x, u, z: torch.cat([x, u, z])
    m.con_h_expr = lambda x, u, z: z
    ocp.model = m
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N, tf, dtype
    so.nlp_solver_type, so.nlp_solver_max_iter = "SQP", 60
    so.integrator_type = "IRK"
    so.sim_method_num_stages, so.sim_method_num_steps = 3, 2
    ocp.constraints.x0 = np.array([1.0, 0.0])
    ocp.constraints.idxbu = np.array([0])
    ocp.constraints.lbu = np.array([-DAE_UMAX])
    ocp.constraints.ubu = np.array([DAE_UMAX])
    ocp.constraints.lh = np.array([-DAE_ZBOUND])
    ocp.constraints.uh = np.array([DAE_ZBOUND])
    c = ocp.cost
    c.cost_type, c.cost_type_e = "NONLINEAR_LS", "LINEAR_LS"
    c.W, c.yref = np.diag([1.0, 0.5, 0.05, 0.3]), np.zeros(4)
    c.Vx_e, c.W_e, c.yref_e = np.eye(2), 5.0 * np.eye(2), np.zeros(2)
    return ocp


def pglobal_ocp(N=10, dtype="float64"):
    """The "pglob" model of tests/test_interface.py::TestPGlobal: a double
    integrator with a damping stage parameter p[0], global parameters
    (mass, length) and their precomputed inertia m l^2 as the parameter
    tail, p = [p_stage | p_global | global_data]; LINEAR_LS on (x, u),
    x0 = (1, 0), tf = 1, SQP."""
    import torch

    from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
    ocp, m = AcadosOcp(), AcadosModel()
    m.name, m.x, m.u, m.p = "pglob", 2, 1, 1
    m.p_global = 2
    m.p_global_precompute_fun = lambda pg: torch.stack([pg[0] * pg[1] ** 2])

    def f_expl(x, u, p, t):
        return torch.cat([x[1:2], (u - p[0] * x[1:2]) / p[3]])

    m.f_expl_expr = f_expl
    ocp.model = m
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = N, 1.0, dtype
    so.nlp_solver_type = "SQP"
    ocp.parameter_values = np.array([0.1])
    ocp.p_global_values = np.array([1.0, 1.0])
    ocp.constraints.x0 = np.array([1.0, 0.0])
    c = ocp.cost
    c.cost_type = c.cost_type_e = "LINEAR_LS"
    c.Vx = np.vstack([np.eye(2), np.zeros((1, 2))])
    c.Vu = np.vstack([np.zeros((2, 1)), np.eye(1)])
    c.W, c.yref = np.diag([1.0, 1.0, 0.1]), np.zeros(3)
    c.Vx_e, c.W_e, c.yref_e = np.eye(2), np.eye(2), np.zeros(2)
    return ocp


def pendulum_rk4(dt: float):
    """tests/test_formulations.py::TestDiscreteDynamics' hand-rolled
    classical RK4 step of the pendulum over dt, a disc_dyn_expr(x, u)."""
    from acados_tpu_torch.models.pendulum import pendulum_ode

    def rk4(x, u):
        f = lambda x_: pendulum_ode(x_, u, None, 0.0)
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    return rk4


# tests/test_multiphase.py's transition example: a double integrator for
# N_H intervals over t1, a DISCRETE transition x -> x[0] over 1 s, then a
# single integrator for N_H intervals over T_H - t1
MOCP_X0, MOCP_N_H, MOCP_T_H = (2.0, 0.0), 25, 1.0


def transition_mocp(t1=0.4, integrator_type=("ERK", "DISCRETE", "ERK"),
                    nlp_solver_type="SQP", dtype="float64"):
    """tests/test_multiphase.py:make_transition_mocp (the reference's
    mocp_transition_example): phases [double integrator x N_H, transition
    x 1, single integrator x N_H], NONLINEAR_LS costs, |u| <= 50 and then
    |u| <= 5, x0 = MOCP_X0, SQP with MERIT_BACKTRACKING."""
    import torch

    from acados_tpu_torch.interface.acados_ocp import AcadosModel, AcadosOcp
    from acados_tpu_torch.interface.multiphase import AcadosMultiphaseOcp
    ph0, m0 = AcadosOcp(), AcadosModel()
    m0.name, m0.x, m0.u = "dint", 2, 1
    m0.f_expl_expr = lambda x, u: torch.cat([x[1:2], u[:1]])
    m0.cost_y_expr = lambda x, u: torch.cat([x, u])
    ph0.model = m0
    ph0.cost.cost_type = "NONLINEAR_LS"
    ph0.cost.W, ph0.cost.yref = np.diag([1.0, 1e-1, 1e-3]), np.zeros(3)
    ph0.constraints.lbu, ph0.constraints.ubu = np.array([-50.0]), \
        np.array([50.0])
    ph0.constraints.idxbu = np.array([0])
    ph0.constraints.x0 = np.array(MOCP_X0)

    ph1, m1 = AcadosOcp(), AcadosModel()
    m1.name, m1.x, m1.u = "trans", 2, 0
    m1.disc_dyn_expr = lambda x, u: x[:1]
    m1.cost_y_expr = lambda x, u: x
    ph1.model = m1
    ph1.cost.cost_type = "NONLINEAR_LS"
    ph1.cost.W, ph1.cost.yref = np.diag([1.0, 1e-2]), np.zeros(2)

    ph2, m2 = AcadosOcp(), AcadosModel()
    m2.name, m2.x, m2.u = "sint", 1, 1
    m2.f_expl_expr = lambda x, u: u[:1]
    m2.cost_y_expr = lambda x, u: torch.cat([x, u])
    m2.cost_y_expr_e = lambda x: x
    ph2.model = m2
    ph2.cost.cost_type = ph2.cost.cost_type_e = "NONLINEAR_LS"
    ph2.cost.W, ph2.cost.yref = np.diag([1.0, 1.0]), np.zeros(2)
    ph2.cost.W_e, ph2.cost.yref_e = np.diag([1e1]), np.zeros(1)
    ph2.constraints.lbu, ph2.constraints.ubu = np.array([-5.0]), \
        np.array([5.0])
    ph2.constraints.idxbu = np.array([0])

    mocp = AcadosMultiphaseOcp([MOCP_N_H, 1, MOCP_N_H])
    for i, ph in enumerate((ph0, ph1, ph2)):
        mocp.set_phase(ph, i)
    so = mocp.solver_options
    so.nlp_solver_type, so.globalization = nlp_solver_type, \
        "MERIT_BACKTRACKING"
    mocp.mocp_opts.integrator_type = list(integrator_type)
    so.tf = MOCP_T_H + 1.0
    so.time_steps = np.array(MOCP_N_H * [t1 / MOCP_N_H] + [1.0]
                             + MOCP_N_H * [(MOCP_T_H - t1) / MOCP_N_H])
    so.dtype = dtype
    return mocp


def control_horizon_mocp(N=20, Nc=5, dtype="float64",
                         nlp_solver_type="SQP"):
    """tests/test_utils_interface.py::TestControlHorizon's problem:
    create_ocp_with_control_horizon of the pendulum of
    tests/test_interface.py:make_ocp (models/pendulum.py, which adds its
    float32 tolerances and Levenberg-Marquardt term in float32): nx 4 and
    nu 1 for Nc intervals, the transition x -> [x; u], then nx 5 with the
    control held (N + 1 intervals in all)."""
    from acados_tpu_torch.interface.mpc_utils import \
        create_ocp_with_control_horizon
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    return create_ocp_with_control_horizon(
        make_pendulum_ocp(N=N, dtype=dtype, nlp_solver_type=nlp_solver_type),
        Nc)


class MocpBatch:
    """A multiphase OCP solved batch-first for B instances, instance i
    from x0s[i]: the port's SQP (make_nlp_solver) on build_mocp's form
    with the data broadcast over the batch and each instance's x0 as
    its stage-0 state bounds, what a vmap of the JAX package's solve
    function over AcadosOcpSolver's data would do (the batch solvers of
    both packages take single-phase OCPs only). The iterate starts as
    AcadosOcpSolver's default: x0 at every stage's phase-0 state
    coordinates, zeros elsewhere; each solve() warm-starts from the
    last. The fields the card's checks read (N_batch, N, form, opts,
    acados_ocp, _it_dev, _stats, get_stats) are those of
    AcadosOcpBatchSolver."""

    def __init__(self, mocp, x0s, device):
        import torch

        from acados_tpu_torch.interface.builder import data_to_torch
        from acados_tpu_torch.interface.multiphase import build_mocp
        from acados_tpu_torch.interface.solver import (_sqp_opts_from,
                                                       _torch_dtype,
                                                       make_nlp_solver)
        from acados_tpu_torch.ocp_nlp.sqp import init_iterate
        x0s = np.asarray(x0s, np.float64)
        self.acados_ocp, self.device = mocp, torch.device(device)
        self.form, data, self.layouts = build_mocp(mocp)
        self.opts = _sqp_opts_from(mocp)
        self.dtype = _torch_dtype(mocp)
        self.N, self.N_batch = self.form.N, x0s.shape[0]
        self._solve_fn = make_nlp_solver(
            self.form, self.opts, mocp.solver_options.nlp_solver_type)
        data = {k: np.tile(v, (self.N_batch,) + (1,) * np.ndim(v))
                for k, v in data.items()}
        lay, idx = self.layouts["0"], list(self.form.con_0.idxbx)
        for key in ("lb_0", "ub_0"):
            data[key][:, lay.off_bx:lay.off_bx + lay.nbx] = x0s
        self._data_dev = data_to_torch(data, self.dtype, self.device)
        it = init_iterate(self.form, self.N_batch, self.dtype, self.device)
        it.x[:, :, idx] = torch.as_tensor(x0s, dtype=self.dtype,
                                          device=self.device)[:, None]
        self._it_dev, self._stats = it, None

    def solve(self):
        """One batch-first solve from the current iterate; returns the
        (B,) statuses."""
        self._it_dev, self._stats = self._solve_fn(self._data_dev,
                                                   self._it_dev)
        return self._stats.status.cpu().numpy()

    def get_stats(self, field):
        s = self._stats
        if field == "sqp_iter":
            return s.sqp_iter.cpu().numpy()
        if field == "qp_iter":
            return s.qp_iter_total.cpu().numpy()
        if field == "cost":
            return s.cost.cpu().numpy()
        if field == "residuals":
            return np.stack([r.cpu().numpy() for r in (
                s.res_stat, s.res_eq, s.res_ineq, s.res_comp)], axis=1)
        raise ValueError(field)


def slice_solve_worker(rank: int, init_method: str, world: int,
                       ocp_kw: dict, x0s: np.ndarray, calls: int,
                       device: str, out_dir: str) -> None:
    """One of `world` processes (torch.multiprocessing.spawn's fn): the
    process group started through `initialize_distributed` at
    init_method, this process's `process_local_batch_slice` of the x0s
    solved as `rti_batch` of make_pendulum_ocp(**ocp_kw) on device,
    `calls` solve() calls, then the global status histogram and largest
    res_stat; writes rank{rank}.npz under out_dir (the slice, x, u, the
    statuses, the reductions and the slice of a batch of 100)."""
    import os

    import torch
    import torch.distributed as dist

    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.parallel.distributed import (
        all_reduce_status_counts, global_max_residual,
        initialize_distributed, process_local_batch_slice)
    torch.set_num_threads(1)
    n = initialize_distributed(init_method, world, rank)
    try:
        start, stop = process_local_batch_slice(len(x0s))
        solver = rti_batch(make_pendulum_ocp(**ocp_kw), x0s[start:stop],
                           device)
        for _ in range(calls):
            status = solver.solve()
        it = solver._host_iterate()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), n=n,
                 slice=(start, stop), x=it["x"], u=it["u"], status=status,
                 counts=all_reduce_status_counts(status),
                 res_max=global_max_residual(
                     solver.get_stats("residuals")[:, 0]),
                 slice100=process_local_batch_slice(100))
    finally:
        dist.destroy_process_group()
