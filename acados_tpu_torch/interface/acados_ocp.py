"""AcadosOcp-style problem description (user-facing API).

Copy of `acados_tpu/interface/acados_ocp.py` with the same classes,
fields and defaults (field-for-field mirrors of the reference Python
classes AcadosModel, AcadosOcpCost, AcadosOcpConstraints,
AcadosOcpOptions and AcadosOcp). The one change: model expressions are
per-instance torch callables, and `model.x` & co. carry only dimensions
(an int or an array template). Options whose code paths the port does
not have yet raise NotImplementedError when the solver is built.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


def _dim_of(v, default=0):
    """Dimension carrier: int, or array-like whose length is the dim."""
    if v is None:
        return default
    if isinstance(v, int):
        return v
    return int(np.asarray(v).reshape(-1).shape[0])


@dataclasses.dataclass
class AcadosModel:
    """Reference: acados_model.py:55-114. Dynamics/cost/constraint
    expressions are per-instance torch callables:
      f_expl_expr(x, u[, p[, t]]) -> xdot
      f_impl_expr(xdot, x, z, u[, p[, t]]) -> residual
      disc_dyn_expr(x, u[, p[, t]]) -> x_next
      cost_y_expr*(x, u[, p[, t]]) -> y
      cost_expr_ext_cost*(x, u[, p[, t]]) -> scalar
      con_h_expr*(x, u[, p[, t]]) -> h
    x/u/z/p are dimension carriers (int or array template)."""

    name: str = "model"
    x: object = None
    u: object = None
    z: object = None
    p: object = None
    t: object = None
    f_expl_expr: Optional[Callable] = None
    f_impl_expr: Optional[Callable] = None
    disc_dyn_expr: Optional[Callable] = None
    cost_y_expr_0: Optional[Callable] = None
    cost_y_expr: Optional[Callable] = None
    cost_y_expr_e: Optional[Callable] = None
    cost_expr_ext_cost_0: Optional[Callable] = None
    cost_expr_ext_cost: Optional[Callable] = None
    cost_expr_ext_cost_e: Optional[Callable] = None
    cost_psi_expr_0: Optional[Callable] = None   # CONL outer
    cost_psi_expr: Optional[Callable] = None
    cost_psi_expr_e: Optional[Callable] = None
    cost_r_in_psi_expr_0: object = None           # CONL residual dim carrier
    cost_r_in_psi_expr: object = None
    cost_r_in_psi_expr_e: object = None
    con_h_expr_0: Optional[Callable] = None
    con_h_expr: Optional[Callable] = None
    con_h_expr_e: Optional[Callable] = None
    # BGP convex-over-nonlinear constraints (reference acados_model.py
    # con_phi_expr/con_r_expr + con_r_in_phi): phi is a callable in
    # the inner residual r, r a callable in (x, u[, p[, t]])
    con_phi_expr_0: Optional[Callable] = None   # (r,) -> (nphi,)
    con_r_expr_0: Optional[Callable] = None     # (x, u[, p[, t]]) -> (nr,)
    con_phi_expr: Optional[Callable] = None
    con_r_expr: Optional[Callable] = None
    con_phi_expr_e: Optional[Callable] = None
    con_r_expr_e: Optional[Callable] = None
    # global parameters (reference model.p_global + np_global,
    # ocp_nlp_common.h:165-166): shared across all stages, set once via
    # AcadosOcpSolver.set_p_global_and_precompute_dependencies. Stage
    # callables see them as the TAIL of the stage parameter vector:
    # p_full = [p_stage | p_global | global_data], where global_data is
    # the output of p_global_precompute_fun(p_global) — the analog of
    # the reference's p_global_precompute_fun.in.h (expensive
    # p_global-only expressions evaluated once per p_global change, not
    # per stage per iteration).
    p_global: object = None
    p_global_precompute_fun: Optional[Callable] = None
    x_labels: list = None
    u_labels: list = None
    t_label: str = "t"


@dataclasses.dataclass
class AcadosOcpCost:
    """Reference: acados_ocp_cost.py. LINEAR_LS uses Vx/Vu/W/yref;
    NONLINEAR_LS uses model.cost_y_expr + W/yref; EXTERNAL uses
    model.cost_expr_ext_cost; CONL uses cost_psi_expr over cost_y_expr."""

    cost_type_0: Optional[str] = None
    cost_type: str = "LINEAR_LS"
    cost_type_e: Optional[str] = None
    Vx_0: Optional[np.ndarray] = None
    Vu_0: Optional[np.ndarray] = None
    W_0: Optional[np.ndarray] = None
    yref_0: Optional[np.ndarray] = None
    Vx: Optional[np.ndarray] = None
    Vu: Optional[np.ndarray] = None
    W: Optional[np.ndarray] = None
    yref: Optional[np.ndarray] = None
    # algebraic-variable residual blocks (reference ocp_nlp_cost_ls.c:243
    # Vz): y = Vx x + Vu u + Vz z; requires an IRK DAE model
    Vz: Optional[np.ndarray] = None
    Vz_0: Optional[np.ndarray] = None
    Vx_e: Optional[np.ndarray] = None
    W_e: Optional[np.ndarray] = None
    yref_e: Optional[np.ndarray] = None
    # soft-constraint slack penalties (reference: Zl/Zu quadratic, zl/zu
    # linear, with _0/_e stage variants)
    Zl_0: Optional[np.ndarray] = None
    Zu_0: Optional[np.ndarray] = None
    zl_0: Optional[np.ndarray] = None
    zu_0: Optional[np.ndarray] = None
    Zl: Optional[np.ndarray] = None
    Zu: Optional[np.ndarray] = None
    zl: Optional[np.ndarray] = None
    zu: Optional[np.ndarray] = None
    Zl_e: Optional[np.ndarray] = None
    Zu_e: Optional[np.ndarray] = None
    zl_e: Optional[np.ndarray] = None
    zu_e: Optional[np.ndarray] = None
    cost_scaling: Optional[np.ndarray] = None


@dataclasses.dataclass
class AcadosOcpConstraints:
    """Reference: acados_ocp_constraints.py:47-121. `x0` is sugar for
    idxbx_0 = arange(nx), lbx_0 = ubx_0 = x0 (the reference does the same)."""

    # initial stage
    x0: Optional[np.ndarray] = None
    idxbx_0: Optional[np.ndarray] = None
    lbx_0: Optional[np.ndarray] = None
    ubx_0: Optional[np.ndarray] = None
    # indices of stage-0 bounds that are equalities (lbx_0 == ubx_0);
    # setting x0 implies idxbxe_0 = arange(nx), like the reference
    # (acados_ocp_constraints.py idxbxe_0) — tags the rows HPIPM's
    # reduce_eq_dof eliminates from the QP
    idxbxe_0: Optional[np.ndarray] = None
    # path state/input bounds
    idxbx: Optional[np.ndarray] = None
    lbx: Optional[np.ndarray] = None
    ubx: Optional[np.ndarray] = None
    idxbu: Optional[np.ndarray] = None
    lbu: Optional[np.ndarray] = None
    ubu: Optional[np.ndarray] = None
    # general linear
    C: Optional[np.ndarray] = None
    D: Optional[np.ndarray] = None
    lg: Optional[np.ndarray] = None
    ug: Optional[np.ndarray] = None
    # nonlinear h
    lh_0: Optional[np.ndarray] = None
    uh_0: Optional[np.ndarray] = None
    lh: Optional[np.ndarray] = None
    uh: Optional[np.ndarray] = None
    lh_e: Optional[np.ndarray] = None
    uh_e: Optional[np.ndarray] = None
    # terminal state bounds / terminal general linear
    idxbx_e: Optional[np.ndarray] = None
    lbx_e: Optional[np.ndarray] = None
    ubx_e: Optional[np.ndarray] = None
    C_e: Optional[np.ndarray] = None
    lg_e: Optional[np.ndarray] = None
    ug_e: Optional[np.ndarray] = None
    # BGP convex-over-nonlinear bounds (reference lphi/uphi fields)
    lphi_0: Optional[np.ndarray] = None
    uphi_0: Optional[np.ndarray] = None
    lphi: Optional[np.ndarray] = None
    uphi: Optional[np.ndarray] = None
    lphi_e: Optional[np.ndarray] = None
    uphi_e: Optional[np.ndarray] = None
    # soft constraint index sets (reference idxs* map into slack vectors)
    idxsbx: Optional[np.ndarray] = None
    idxsbu: Optional[np.ndarray] = None
    idxsg: Optional[np.ndarray] = None
    idxsh: Optional[np.ndarray] = None
    idxsh_0: Optional[np.ndarray] = None
    idxsbx_e: Optional[np.ndarray] = None
    idxsh_e: Optional[np.ndarray] = None
    idxsphi: Optional[np.ndarray] = None
    idxsphi_0: Optional[np.ndarray] = None
    idxsphi_e: Optional[np.ndarray] = None


@dataclasses.dataclass
class AcadosOcpDims:
    """Reference: acados_ocp_dims.py (inferred by make_consistent)."""

    N: Optional[int] = None
    nx: Optional[int] = None
    nu: Optional[int] = None
    nz: int = 0
    np: int = 0


@dataclasses.dataclass
class AcadosOcpOptions:
    """Reference: acados_ocp_options.py:46-140 (same names/defaults where
    they transfer; qp_solver names map onto the internal Riccati IPM,
    FULL_CONDENSING_* onto full condensing and the dense IPM)."""

    N_horizon: Optional[int] = None
    tf: Optional[float] = None
    time_steps: Optional[np.ndarray] = None
    shooting_nodes: Optional[np.ndarray] = None
    qp_solver: str = "PARTIAL_CONDENSING_HPIPM"  # accepted + mapped
    # IPM preset (reference hpipm_mode, acados_ocp_options.py:133):
    # BALANCE | SPEED | SPEED_ABS | ROBUST -> IpmOpts iter_max/tau
    hpipm_mode: str = "BALANCE"
    hessian_approx: str = "GAUSS_NEWTON"
    # EXACT-mode term switches (reference acados_ocp_options.py:96-98):
    # with hessian_approx="EXACT", each Lagrangian term's second-order
    # contribution can be disabled individually
    exact_hess_cost: int = 1
    exact_hess_dyn: int = 1
    exact_hess_constr: int = 1
    integrator_type: str = "ERK"
    # EULER (default): stage cost * dt. INTEGRATOR: the Lagrange cost is
    # integrated along the RK stages of the dynamics integrator
    # (reference acados_ocp_options cost_discretization; CI pins the
    # integrated value to 1e-10, test_cost_integration_value.py:46)
    cost_discretization: str = "EULER"
    nlp_solver_type: str = "SQP_RTI"
    globalization: str = "FIXED_STEP"
    nlp_solver_max_iter: int = 100
    nlp_solver_tol_stat: float = 1e-6
    nlp_solver_tol_eq: float = 1e-6
    nlp_solver_tol_ineq: float = 1e-6
    nlp_solver_tol_comp: float = 1e-6
    tol_min_step_norm: float = 1e-12
    qp_solver_iter_max: int = 50
    # 0.0 = use the hpipm_mode preset's barrier start (reference
    # semantics: qp_solver_mu0 default 0.0, acados_ocp_options.py:83)
    qp_solver_mu0: float = 0.0
    qp_tol: Optional[float] = None
    # QP-tolerance strategy inside the NLP loop (reference
    # acados_ocp_options.py:118-124, ocp_nlp_common.c:4460).
    # ADAPTIVE_CURRENT_RES_JOINT ties QP tolerances to the current NLP
    # residuals (inexact-SQP forcing term — good for cold SQP solves);
    # the default matches the reference (FIXED_QP_TOL). Note adaptive is
    # self-referential at an RTI steady state (the QP tolerance tracks
    # the stalled residual), so RTI should keep FIXED_QP_TOL.
    nlp_qp_tol_strategy: str = "FIXED_QP_TOL"
    # measure time_lin/time_reg/time_qp/time_glob INSIDE the solve via
    # ordered host-clock callbacks (reference ocp_nlp_timings,
    # ocp_nlp_common.h:410-428). Diagnostic mode for single-instance
    # solves (each boundary is a host round trip; ordered callbacks do
    # not vmap). Off: get_stats falls back to the re-execution estimate.
    collect_phase_times: bool = False
    nlp_qp_tol_reduction_factor: float = 1e-1
    nlp_qp_tol_safety_factor: float = 0.1
    nlp_qp_tol_min_stat: float = 1e-9
    nlp_qp_tol_min_eq: float = 1e-10
    nlp_qp_tol_min_ineq: float = 1e-10
    nlp_qp_tol_min_comp: float = 1e-11
    levenberg_marquardt: float = 0.0
    regularize_method: str = "NO_REGULARIZE"
    reg_epsilon: float = 1e-4
    globalization_alpha_min: float = 0.05
    globalization_alpha_reduction: float = 0.7
    globalization_line_search_use_sufficient_descent: bool = False
    globalization_eps_sufficient_descent: float = 1e-4
    globalization_use_SOC: bool = False
    # funnel method (reference globalization_funnel.c defaults)
    globalization_funnel_init_increase_factor: float = 15.0
    globalization_funnel_init_upper_bound: float = 1.0
    globalization_funnel_sufficient_decrease_factor: float = 0.9
    globalization_funnel_kappa: float = 0.9
    globalization_funnel_fraction_switching_condition: float = 1e-3
    globalization_funnel_initial_penalty_parameter: float = 1.0
    sim_method_num_stages: int = 4
    sim_method_num_steps: int = 1
    sim_method_newton_iter: int = 3
    # freeze the IRK Newton Jacobian at the predictor point (reference
    # sim opt jac_reuse, sim_common.h:139) — 1 Jacobian build + LU per
    # integration step instead of newton_iter+1
    sim_method_jac_reuse: bool = False
    collocation_type: str = "GAUSS_LEGENDRE"
    # condensing horizon (reference qp_solver_cond_N,
    # acados_ocp_options.py; None or >= N = no partial condensing, the
    # only setting ported; FULL_CONDENSING_* qp_solvers ignore it).
    qp_solver_cond_N: Optional[int] = None
    # AS-RTI (reference as_rti_level/as_rti_iter, acados_ocp_options.py:
    # 134-135; level int 0..4 = A,B,C,D,STANDARD — strings also accepted)
    as_rti_level: object = 4
    as_rti_iter: int = 1
    as_rti_advancement_strategy: str = "SIMULATE"  # SHIFT | NONE
    # fixed-step length (reference nlp_solver_step_length)
    nlp_solver_step_length: float = 1.0
    globalization_full_step_dual: bool = False
    # Anderson acceleration (reference ocp_nlp_common.c:1277-1278)
    with_anderson_acceleration: bool = False
    anderson_activation_threshold: float = 1e1
    # keep all intermediate iterates (reference store_iterates)
    store_iterates: bool = False
    # QP scaling (reference ocp_nlp_qpscaling.c; NO_SCALING |
    # OBJECTIVE_GERSHGORIN)
    qpscaling_scale_objective: str = "NO_SCALING"
    # wall-clock budget. For single-instance solves the budget is
    # enforced INSIDE the loop with per-iteration time prediction
    # (reference ocp_nlp_sqp.c:436,611-635; heuristic below); the
    # batched path falls back to a post-hoc check. 0 = no timeout.
    timeout_max_time: float = 0.0
    # prediction heuristic for the next iteration's duration:
    # ZERO | LAST | MAX | AVERAGE (reference timeout_heuristic)
    timeout_heuristic: str = "ZERO"
    # adaptive Levenberg-Marquardt (reference acados_ocp_options.py:
    # 136-140): the LM diagonal shrinks by /lam on residual decrease and
    # grows by *lam otherwise, floored at mu_min
    with_adaptive_levenberg_marquardt: bool = False
    adaptive_levenberg_marquardt_lam: float = 5.0
    adaptive_levenberg_marquardt_mu_min: float = 1e-16
    adaptive_levenberg_marquardt_mu0: float = 1e-3
    # > 0 enables warm-starting each iteration's QP at the NLP duals
    # (reference warm_start_first_qp_from_nlp); default off — measured
    # on chip it raises the RTI steady-state residual floor (see
    # SqpOpts.warm_start_first_qp_from_nlp)
    qp_solver_warm_start: int = 0
    # ---- reference options tail (acados_ocp_options.py, 2770 LoC) ----
    # Fields are grouped by status: WIRED = changes solver behavior here;
    # PARITY = accepted + validated, semantics covered by an existing
    # mechanism or by-inversion N/A (rationale inline). Codegen-only
    # fields of the reference (ext_fun_compile_flags, custom_templates,
    # model_external_shared_lib_*, ext_fun_expand_*) are intentionally
    # absent: there is no code generation to configure.
    # WIRED: print the per-iteration stat table after each solve
    # (reference print_level; jit compiles the whole solve, so the table
    # prints post-hoc rather than live)
    print_level: int = 0
    # WIRED: per-field QP tolerances (reference qp_solver_tol_*);
    # None = derive from qp_tol / the nlp tolerances
    qp_solver_tol_stat: Optional[float] = None
    qp_solver_tol_eq: Optional[float] = None
    qp_solver_tol_ineq: Optional[float] = None
    qp_solver_tol_comp: Optional[float] = None
    # WIRED: barrier floor of the QP IPM (reference tau_min: minimum
    # barrier parameter for solution-sensitivity-grade solves) -> the
    # IPM's mu_min
    tau_min: float = 0.0
    # WIRED: explicit ragged condensing block sizes (reference
    # qp_solver_cond_block_size -> HPIPM per-block sizes); None = derive
    # from qp_solver_cond_N via the HPIPM remainder rule
    qp_solver_cond_block_size: Optional[list] = None
    # WIRED: reference spelling of warm_start_first_qp_from_nlp
    # (ocp_nlp_common.h:350); qp_solver_warm_start above is the legacy
    # alias this implementation exposed first
    nlp_solver_warm_start_first_qp: bool = False
    nlp_solver_warm_start_first_qp_from_nlp: bool = False
    # WIRED: slack/multiplier floor of the solution-sensitivity KKT
    # smoothing (reference solution_sens_qp_t_lam_min,
    # ocp_nlp_common.h:337)
    solution_sens_qp_t_lam_min: float = 1e-9
    # WIRED: reference alias of nlp_solver_step_length
    globalization_fixed_step_length: Optional[float] = None
    # WIRED: reference alias of tol_min_step_norm
    nlp_solver_tol_min_step_norm: Optional[float] = None
    # PARITY: IRK Newton tolerance (reference sim_method_newton_tol,
    # default 0.0 = pure fixed-iteration Newton — exactly this
    # implementation's XLA-friendly design; a nonzero value is refused
    # rather than silently ignored)
    sim_method_newton_tol: float = 0.0
    # PARITY: residuals are always evaluated at the returned iterate for
    # SQP (reference eval_residual_at_max_iter default True); RTI
    # reports the preparation-point residuals (reference semantics)
    eval_residual_at_max_iter: bool = True
    # PARITY: RTI residual logging switches (reference rti_log_residuals
    # / rti_log_only_available_residuals): the stat matrix always
    # carries the preparation-point residuals here
    rti_log_residuals: int = 0
    rti_log_only_available_residuals: int = 0
    # PARITY: primal step norms are always logged (stat column
    # 'step_norm'); dual step norms are not tracked
    log_primal_step_norm: bool = False
    log_dual_step_norm: bool = False
    # PARITY: Riccati algorithm selectors (reference qp_solver_ric_alg /
    # qp_solver_cond_ric_alg, 0 = classical, 1 = square-root): the
    # Riccati here factorizes Huu by Cholesky per stage (the square-root
    # flavor); selector accepted for config compatibility
    qp_solver_ric_alg: int = 1
    qp_solver_cond_ric_alg: int = 1
    # PARITY: HPIPM initial-slack strategy (qp_solver_t0_init; the IPM
    # here uses the t0_min floor strategy ~ mode 1)
    qp_solver_t0_init: int = 1
    # PARITY: numeric-Hessian EXTERNAL cost (reference ext_cost_num_hess
    # = finite-difference Hessian of CasADi costs): an AD Hessian is exact
    # for every EXTERNAL cost, so there is nothing to approximate
    ext_cost_num_hess: int = 0
    # PARITY: constant-Hessian declaration (reference fixed_hess skips
    # Hessian re-evaluation; XLA's fused linearization recomputes it for
    # free within the same pass)
    fixed_hess: int = 0
    # PARITY: batch solving needs no opt-in (reference
    # with_batch_functionality gates OpenMP codegen; vmap is always on)
    with_batch_functionality: bool = True
    num_threads_in_batch_solve: int = 1
    # PARITY: solution-sensitivity opt-ins (reference
    # with_solution_sens_wrt_params / with_value_sens_wrt_params
    # preallocate seed memory at codegen; the AD sensitivity paths
    # allocate nothing ahead of time)
    with_solution_sens_wrt_params: bool = False
    with_value_sens_wrt_params: bool = False
    # PARITY: WFQP options (reference ocp_nlp_sqp_with_feasible_qp.c:
    # 122-123); wired through interface defaults into wfqp.py
    use_constraint_hessian_in_feas_qp: bool = False
    search_direction_mode: str = "NOMINAL_QP"
    allow_direction_mode_switch_to_nominal: bool = True
    # WIRED: developer debug checks (reference
    # ACADOS_DEVELOPER_DEBUG_CHECKS, CMakeLists.txt:81): host-side data /
    # iterate validation before each solve (finite values, bound
    # ordering, W symmetry, multiplier signs) — also enabled globally by
    # the env var ACADOS_TPU_DEBUG_CHECKS=1. See utils/debug_checks.py.
    with_debug_checks: bool = False
    # TPU-specific
    dtype: str = "float32"

    @property
    def tol(self):
        return self.nlp_solver_tol_stat

    @tol.setter
    def tol(self, v):
        self.nlp_solver_tol_stat = v
        self.nlp_solver_tol_eq = v
        self.nlp_solver_tol_ineq = v
        self.nlp_solver_tol_comp = v


@dataclasses.dataclass
class AcadosOcp:
    """Reference: acados_ocp.py. Assemble model/cost/constraints/options,
    then pass to AcadosOcpSolver."""

    model: AcadosModel = dataclasses.field(default_factory=AcadosModel)
    cost: AcadosOcpCost = dataclasses.field(default_factory=AcadosOcpCost)
    constraints: AcadosOcpConstraints = dataclasses.field(
        default_factory=AcadosOcpConstraints)
    dims: AcadosOcpDims = dataclasses.field(default_factory=AcadosOcpDims)
    solver_options: AcadosOcpOptions = dataclasses.field(
        default_factory=AcadosOcpOptions)
    parameter_values: Optional[np.ndarray] = None
    # initial global-parameter values (reference ocp.p_global_values)
    p_global_values: Optional[np.ndarray] = None
    # zoRO custom update description (reference ocp.zoro_description,
    # zoro_description.py:42-103); see interface/zoro.py
    zoro_description: object = None
