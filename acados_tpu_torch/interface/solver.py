"""AcadosOcpSolver: the user-facing solve/get/set surface.

Counterpart of `acados_tpu/interface/solver.py` (API mirror of the
reference AcadosOcpSolver): construction builds the solve function of
the plan's NLP solver (SQP, SQP_RTI, DDP or SQP_WITH_FEASIBLE_QP);
`set` mutates host-side numpy data that is moved to the device at
`solve()`. One instance runs as a batch of one through the batch-first
solver.

The solver runs on the card unless `device="cpu"` is passed; with no
CUDA and no explicit device it raises. Ported: solve, get, set,
cost_set, constraints_set, options_set (rti_phase, print_level, the
timeouts, store_iterates and the other runtime options), the RTI
phases (solve() after options_set("rti_phase", 1 or 2), AS-RTI levels
A-D), get_status, get_stats (sqp_iter, qp_iter, residuals, statistics,
time_tot, time_preparation, time_feedback and the phase times time_lin,
time_sim, time_reg, time_qp, time_glob), get_residuals, get_cost,
get_iterates, print_statistics, reset, get(stage, "z") of a DAE,
set_p_global_and_precompute_dependencies, the solution sensitivities
(eval_param_sens, eval_solution_sensitivity,
eval_adjoint_solution_sensitivity, eval_and_get_optimal_value_gradient),
the iterate's store and load (objects, flat vectors, JSON and '.atni'
files), custom_update (the zoRO tightening, interface/zoro.py) and
dump_qp_to_file.

A multiphase OCP (AcadosMultiphaseOcp) builds through build_mocp, as in
the JAX package (acados_tpu/interface/solver.py:181-187): get and set of
x and u take the stage's phase dims; where the JAX package fails on a
multiphase OCP (lam, sl and su at a path stage, z, the sensitivities)
the port raises NotImplementedError. With solver_options.
with_debug_checks or ACADOS_TPU_DEBUG_CHECKS=1, solve() validates the
data and the iterate on the host first (utils/debug_checks.py).
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import AcadosOcp, _dim_of
from acados_tpu_torch.interface.builder import (StageLayout, _global_data,
                                                build_ocp, data_to_torch)
from acados_tpu_torch.interface.iterate import AcadosOcpFlattenedIterate
from acados_tpu_torch.interface.multiphase import (AcadosMultiphaseOcp,
                                                   _phase_dims, build_mocp,
                                                   phase_of_stage)
from acados_tpu_torch.ocp_nlp.ddp import make_ddp_solver
from acados_tpu_torch.ocp_nlp.formulation import NlpData
from acados_tpu_torch.native import load_iterate_bin, save_iterate_bin
from acados_tpu_torch.ocp_nlp.linearize import (NlpIterate,
                                                build_static_rows, linearize)
from acados_tpu_torch.ocp_nlp.regularize import regularize_qp
from acados_tpu_torch.ocp_nlp.rti import make_rti_solver
from acados_tpu_torch.ocp_nlp.sensitivity import (KktFactor, SensOpts,
                                                  adjoint_sensitivity,
                                                  eval_lagrange_grad_p,
                                                  forward_sensitivity,
                                                  optimal_value_grad_x0)
from acados_tpu_torch.ocp_nlp.sqp import (SqpOpts, make_sqp_solver,
                                          use_x0_elimination)
from acados_tpu_torch.ocp_nlp.wfqp import make_wfqp_solver
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
from acados_tpu_torch.ocp_qp.xcond import resolve_cond_N
from acados_tpu_torch.utils.debug_checks import (check_iterate,
                                                 check_nlp_data,
                                                 debug_checks_enabled)
from acados_tpu_torch.utils.device import (full_precision_matmul,
                                           resolve_device)


def _sqp_opts_from(ocp: AcadosOcp) -> SqpOpts:
    """Solver options -> SqpOpts, as acados_tpu/interface/solver.py:44."""
    so = ocp.solver_options
    if so.sim_method_newton_tol != 0.0:
        raise NotImplementedError(
            "sim_method_newton_tol > 0 (tolerance-terminated IRK Newton) "
            "is not supported: the integrator runs a fixed newton_iter "
            "count (the reference's default, newton_tol = 0)")
    qp_tol = so.qp_tol
    if qp_tol is None:
        # QP solved tighter than the NLP tolerance, floored at what the
        # dtype can reach
        qp_tol = min(so.nlp_solver_tol_stat * 1e-1, 1e-6) \
            if so.dtype == "float64" else max(
                so.nlp_solver_tol_stat * 1e-1, 1e-6)
    # hpipm_mode presets (reference acados_ocp_options.py:133)
    mode = {"BALANCE": dict(mu0=1e1), "SPEED": dict(iter_max=15, mu0=1e1),
            "SPEED_ABS": dict(iter_max=15, mu0=1e4),
            "ROBUST": dict(iter_max=100, tau=0.99, mu0=1e2)}[so.hpipm_mode]
    iter_max = mode.get("iter_max", so.qp_solver_iter_max)
    if so.qp_solver_iter_max != 50:   # user override beats the preset
        iter_max = so.qp_solver_iter_max
    mu0 = so.qp_solver_mu0 if so.qp_solver_mu0 > 0 else mode["mu0"]
    pick = lambda v: qp_tol if v is None else v
    qp_opts = IpmOpts(iter_max=iter_max, mu0=mu0,
                      tau=mode.get("tau", 0.995), mu_min=so.tau_min,
                      tol_stat=pick(so.qp_solver_tol_stat),
                      tol_eq=pick(so.qp_solver_tol_eq),
                      tol_ineq=pick(so.qp_solver_tol_ineq),
                      tol_comp=pick(so.qp_solver_tol_comp))
    rti = so.nlp_solver_type == "SQP_RTI"
    if so.nlp_solver_type not in NLP_SOLVER_TYPES:
        raise ValueError(f"nlp_solver_type {so.nlp_solver_type!r}")
    return SqpOpts(
        max_iter=1 if rti else so.nlp_solver_max_iter,
        rti=rti,
        warm_start_first_qp_from_nlp=bool(
            so.qp_solver_warm_start
            or so.nlp_solver_warm_start_first_qp_from_nlp
            or so.nlp_solver_warm_start_first_qp),
        tol_stat=so.nlp_solver_tol_stat, tol_eq=so.nlp_solver_tol_eq,
        tol_ineq=so.nlp_solver_tol_ineq, tol_comp=so.nlp_solver_tol_comp,
        tol_min_step_norm=(so.nlp_solver_tol_min_step_norm
                           if so.nlp_solver_tol_min_step_norm is not None
                           else so.tol_min_step_norm),
        timeout_max_time=so.timeout_max_time,
        timeout_heuristic=so.timeout_heuristic,
        levenberg_marquardt=so.levenberg_marquardt,
        with_adaptive_levenberg_marquardt=(
            so.with_adaptive_levenberg_marquardt),
        adaptive_levenberg_marquardt_lam=(
            so.adaptive_levenberg_marquardt_lam),
        adaptive_levenberg_marquardt_mu_min=(
            so.adaptive_levenberg_marquardt_mu_min),
        adaptive_levenberg_marquardt_mu0=(
            so.adaptive_levenberg_marquardt_mu0),
        regularize_method=so.regularize_method,
        reg_epsilon=so.reg_epsilon,
        globalization=so.globalization if not rti else "FIXED_STEP",
        alpha_min=so.globalization_alpha_min,
        alpha_reduction=so.globalization_alpha_reduction,
        line_search_use_sufficient_descent=(
            so.globalization_line_search_use_sufficient_descent),
        eps_sufficient_descent=so.globalization_eps_sufficient_descent,
        globalization_use_SOC=so.globalization_use_SOC,
        funnel_initialization_increase_factor=(
            so.globalization_funnel_init_increase_factor),
        funnel_initialization_upper_bound=(
            so.globalization_funnel_init_upper_bound),
        funnel_sufficient_decrease_factor=(
            so.globalization_funnel_sufficient_decrease_factor),
        funnel_kappa=so.globalization_funnel_kappa,
        funnel_fraction_switching_condition=(
            so.globalization_funnel_fraction_switching_condition),
        funnel_initial_penalty_parameter=(
            so.globalization_funnel_initial_penalty_parameter),
        cond_N=_resolve_cond(ocp), full_cond=_is_full_cond(so),
        cond_block_size=(tuple(int(b) for b in so.qp_solver_cond_block_size)
                         if so.qp_solver_cond_block_size else None),
        as_rti_level=_as_rti_level_str(so.as_rti_level),
        as_rti_iter=so.as_rti_iter,
        as_rti_advancement=so.as_rti_advancement_strategy,
        step_length=(so.globalization_fixed_step_length
                     if so.globalization_fixed_step_length is not None
                     else so.nlp_solver_step_length),
        full_step_dual=so.globalization_full_step_dual,
        with_anderson_acceleration=so.with_anderson_acceleration,
        anderson_activation_threshold=so.anderson_activation_threshold,
        store_iterates=so.store_iterates,
        qpscaling=so.qpscaling_scale_objective,
        collect_phase_times=so.collect_phase_times,
        nlp_qp_tol_strategy=so.nlp_qp_tol_strategy,
        nlp_qp_tol_reduction_factor=so.nlp_qp_tol_reduction_factor,
        nlp_qp_tol_safety_factor=so.nlp_qp_tol_safety_factor,
        qp_opts=qp_opts)


# the reference's plan enum (ocp_nlp_interface.h:51-59)
NLP_SOLVER_TYPES = ("SQP", "SQP_RTI", "DDP", "SQP_WITH_FEASIBLE_QP")


def make_nlp_solver(form, opts: SqpOpts, nlp_solver_type: str):
    """The solve function of the plan's NLP solver (acados_tpu/interface/
    solver.py:311-322): DDP, SQP with feasible QPs, or the SQP of SQP and
    SQP_RTI."""
    if nlp_solver_type == "DDP":
        return make_ddp_solver(form, opts)
    if nlp_solver_type == "SQP_WITH_FEASIBLE_QP":
        return make_wfqp_solver(form, opts)
    return make_sqp_solver(form, opts)


def _is_full_cond(so) -> bool:
    """Every FULL_CONDENSING_* qp_solver takes the dense IPM path."""
    return str(so.qp_solver).startswith("FULL_CONDENSING")


def _resolve_cond(ocp: AcadosOcp) -> int | None:
    """qp_solver_cond_N -> the partial-condensing horizon, as
    acados_tpu/interface/solver.py:_resolve_cond maps it: None for full
    condensing and for cond_N >= N (HPIPM's "no condensing"); a
    multiphase OCP's N is sum(N_list)."""
    so = ocp.solver_options
    if so.qp_solver_cond_N is None or _is_full_cond(so):
        return None
    N = sum(ocp.N_list) if isinstance(ocp, AcadosMultiphaseOcp) \
        else so.N_horizon or ocp.dims.N
    return resolve_cond_N(N, so.qp_solver_cond_N)


def _as_rti_level_str(level) -> str:
    """The reference's int encoding (0..4 = A, B, C, D, STANDARD,
    ocp_nlp_sqp_rti.h:70-77) or a string."""
    if isinstance(level, str):
        return level
    return {0: "A", 1: "B", 2: "C", 3: "D", 4: "STANDARD"}[int(level)]


# the QP fields dump_qp_to_file writes (acados_tpu/interface/solver.py:
# 1008-1012)
QP_DUMP_FIELDS = ("Q", "R", "S", "q", "r", "A", "B", "b", "C", "D", "lg",
                  "ug", "mask_l", "mask_u", "Zl", "Zu", "zl", "zu",
                  "soft_mask")
ITERATE_FIELDS = ("x", "u", "pi", "lam_l", "lam_u", "sl", "su")
FLAT_FIELDS = ("x", "u", "pi", "lam", "sl", "su")
PHASE_KEYS = ("time_lin", "time_qp", "time_sim", "time_reg", "time_glob")


def _sync(device: torch.device):
    """Wait until the card has run what was queued (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fence(t: torch.Tensor):
    """Wait until the card has computed t (a no-op on the CPU)."""
    _sync(t.device)


def timed_run(fn, device: torch.device, reps: int = 1):
    """fn() once to warm up, then the least host time (s) of `reps`
    synchronised runs: (seconds, the last output)."""
    out = fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def measured_phase_times(stats) -> dict | None:
    """The phase times a solve measured in its loop (collect_phase_times),
    with the JAX package's keys: time_sim is time_lin, the linearization
    holding the integrator sweep (acados_tpu/interface/solver.py:815-819);
    None without them."""
    pt = getattr(stats, "phase_times", None)
    if pt is None:
        return None
    pt = pt.tolist()
    return {"time_lin": pt[0], "time_sim": pt[0], "time_reg": pt[1],
            "time_qp": pt[2], "time_glob": pt[3]}


def _z_at(solver, stage: int, it: dict, data: dict) -> np.ndarray:
    """z of a DAE at a shooting node, (M, nz) for M instances
    (acados_tpu/interface/solver.py:490-500): the exact z(t0) of the
    interval the node starts, (M, 0) without z or at stage N. it: host
    "x" and "u", data: host "p", "ts" and "dts", each with a leading
    axis of the M instances."""
    form = solver.form
    if form.z_fun is None or stage >= form.N:
        return np.zeros((it["x"].shape[0], 0))
    as_t = lambda a: torch.as_tensor(np.asarray(a)[:, stage],
                                     dtype=solver.dtype, device=solver.device)
    z = form.z_fun(*(as_t(v) for v in (it["x"], it["u"], data["p"],
                                       data["ts"], data["dts"])))
    return z.detach().cpu().numpy().astype(np.float64)


def _torch_dtype(ocp: AcadosOcp):
    return (torch.float64 if ocp.solver_options.dtype == "float64"
            else torch.float32)


def iterate_to_torch(it: dict, dtype, device) -> NlpIterate:
    """Numpy iterate dict (leading batch axis) -> NlpIterate."""
    return NlpIterate(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                         for k, v in it.items()})


def iterate_to_numpy(it: NlpIterate) -> dict:
    """NlpIterate -> numpy float64 dict, one host copy a field."""
    return {k: getattr(it, k).detach().cpu().numpy().astype(np.float64)
            for k in ITERATE_FIELDS}


def flat_of(it: dict, field: str, lead: tuple = ()) -> np.ndarray:
    """One field of a numpy iterate dict flattened over its stages
    (reference ocp_nlp_get_all, ocp_nlp_interface.c:1914): `lam` is
    [lam_l_k, lam_u_k] stage by stage. lead: the leading axes kept (the
    batch's)."""
    if field in ("x", "u", "pi", "sl", "su"):
        return it[field].reshape(lead + (-1,)).copy()
    if field == "lam":
        return np.concatenate([it["lam_l"], it["lam_u"]],
                              axis=-1).reshape(lead + (-1,))
    raise ValueError(f"get_flat: unknown field {field!r}")


def set_flat_in(it: dict, field: str, value) -> None:
    """Inverse of flat_of on a numpy iterate dict, in place (reference
    ocp_nlp_set_all, ocp_nlp_interface.c:2018)."""
    value = np.asarray(value, np.float64)
    if field in ("x", "u", "pi", "sl", "su"):
        it[field] = value.reshape(it[field].shape).copy()
    elif field == "lam":
        shape = it["lam_l"].shape
        lam = value.reshape(shape[:-1] + (2 * shape[-1],))
        it["lam_l"] = lam[..., :shape[-1]].copy()
        it["lam_u"] = lam[..., shape[-1]:].copy()
    else:
        raise ValueError(f"set_flat: unknown field {field!r}")


class AcadosOcpSolver:
    """Drop-in style replacement for the reference class of the same
    name, for an AcadosOcp or an AcadosMultiphaseOcp; `device` None means
    "cuda"."""

    def __init__(self, ocp: AcadosOcp, json_file=None, build=None,
                 generate=None, verbose=False, device=None):
        del json_file, build, generate, verbose  # codegen-era args accepted
        self.device = resolve_device(device)
        full_precision_matmul()
        self.acados_ocp = ocp
        self._is_mocp = isinstance(ocp, AcadosMultiphaseOcp)
        self.form, self._data, self.layouts = (
            build_mocp if self._is_mocp else build_ocp)(ocp)
        self.opts = _sqp_opts_from(ocp)
        self.dtype = _torch_dtype(ocp)
        self._solve_fn = self._make_solve_fn(self.opts)
        self._solve_fn_noelim = None  # lazy barrier-x0 fallback (solve())
        self._rti_fns = None  # built on first rti_phase use
        self._rti_phase = 0
        self._rti_cache = None
        self._rti_prev_cache = None
        self.N = self.form.N
        self._iterate = self._zero_iterate()
        self._default_init = True
        self._last_stats = None
        self._phase_cache = None
        self._print_level = int(ocp.solver_options.print_level)
        self._time_tot = float("nan")
        self._time_prep = float("nan")
        self._time_fb = float("nan")

    # -- iterate management -------------------------------------------------
    def _zero_iterate(self):
        N, nx, nu, nc = (self.form.N, self.form.nx, self.form.nu,
                         self.form.nc)
        z = lambda *s: np.zeros(s)
        return dict(x=z(N + 1, nx), u=z(N, nu), pi=z(N, nx),
                    lam_l=z(N + 1, nc), lam_u=z(N + 1, nc),
                    sl=z(N + 1, nc), su=z(N + 1, nc))

    def reset(self, reset_qp_solver_mem=1):
        """Reference: acados_ocp_solver.py reset()."""
        del reset_qp_solver_mem
        self._iterate = self._zero_iterate()
        self._default_init = True
        self._rti_cache = None
        self._rti_prev_cache = None

    # -- options ------------------------------------------------------------
    def options_set(self, field: str, value):
        """Reference: acados_ocp_solver.py options_set, as
        acados_tpu/interface/solver.py:233-309 takes it: rti_phase,
        print_level and the runtime options; the timeouts also go to the
        solver options, whose timeout_max_time the post-hoc rule of
        solve() reads."""
        if field == "rti_phase":
            value = int(value)
            if value not in (0, 1, 2):
                raise ValueError("rti_phase must be 0, 1 or 2")
            if value and self.acados_ocp.solver_options.nlp_solver_type \
                    != "SQP_RTI":
                raise ValueError("rti_phase requires SQP_RTI")
            self._rti_phase = value
            return
        if field == "print_level":
            self._print_level = int(value)
            return
        if field == "warm_start_first_qp":
            return  # as acados_tpu: warm starting is explicit here
        opts, qp_opts = self.opts, self.opts.qp_opts
        so = self.acados_ocp.solver_options
        from_so = False
        so_after = {}
        if field == "levenberg_marquardt":
            opts = opts.replace(levenberg_marquardt=float(value))
        elif field in ("tol_stat", "tol_eq", "tol_ineq", "tol_comp"):
            opts = opts.replace(**{field: float(value)})
        elif field in ("qp_tol_stat", "qp_tol_eq", "qp_tol_ineq",
                       "qp_tol_comp"):
            opts = opts.replace(qp_opts=qp_opts.replace(
                **{field[3:]: float(value)}))
        elif field in ("step_length", "nlp_solver_step_length"):
            opts = opts.replace(step_length=float(value))
        elif field in ("alpha_min", "globalization_alpha_min"):
            opts = opts.replace(alpha_min=float(value))
        elif field in ("alpha_reduction", "globalization_alpha_reduction"):
            opts = opts.replace(alpha_reduction=float(value))
        elif field == "anderson_activation_threshold":
            opts = opts.replace(anderson_activation_threshold=float(value))
        elif field == "with_anderson_acceleration":
            opts = opts.replace(with_anderson_acceleration=bool(value))
        elif field == "store_iterates":
            opts = opts.replace(store_iterates=bool(value))
        elif field in ("timeout_max_time", "timeout_heuristic"):
            value = (float if field == "timeout_max_time" else str)(value)
            opts = opts.replace(**{field: value})
            so_after[field] = value
        elif field == "qp_mu0":
            opts = opts.replace(qp_opts=qp_opts.replace(mu0=float(value)))
        elif field == "qp_iter_max":
            opts = opts.replace(qp_opts=qp_opts.replace(iter_max=int(value)))
        elif hasattr(opts, field):
            # string-keyed fallback over SqpOpts (make_sqp_solver refuses
            # the values of paths not ported yet)
            cur = getattr(opts, field)
            cast = type(cur) if cur is not None else (lambda v: v)
            opts = opts.replace(**{field: cast(value)})
        elif hasattr(so, field):
            from_so, old = True, getattr(so, field)
            setattr(so, field, value)
        else:
            raise ValueError(f"options_set: unsupported field {field!r}")
        try:
            if from_so:
                opts = _sqp_opts_from(self.acados_ocp)
            solve_fn = self._make_solve_fn(opts)
        except Exception:
            # an option that is refused leaves the solver as it was
            if from_so:
                setattr(so, field, old)
            raise
        for f, v in so_after.items():
            setattr(so, f, v)
        self._solve_fn, self.opts = solve_fn, opts
        self._solve_fn_noelim = None
        self._rti_fns = None

    def _make_solve_fn(self, opts: SqpOpts):
        return make_nlp_solver(
            self.form, opts, self.acados_ocp.solver_options.nlp_solver_type)

    # -- solve ----------------------------------------------------------------
    def _maybe_default_init(self):
        if not self._default_init:
            return
        # reference-style default initialization: x ~ x0 everywhere
        lay = self.layouts["0"]
        if lay.nbx:
            x0 = 0.5 * (self._data["lb_0"][:lay.nbx]
                        + self._data["ub_0"][:lay.nbx])
            xs = np.array(self._iterate["x"])
            xs[:, list(self.form.con_0.idxbx)] = np.clip(x0, -1e6, 1e6)
            self._iterate["x"] = xs
        self._default_init = False

    def _x0_bounds_asymmetric(self) -> bool:
        """True when x0 elimination is active but lb_0 != ub_0 on the
        state rows (solve() then uses the barrier treatment). DDP and
        SQP_WITH_FEASIBLE_QP never eliminate x0."""
        if self.acados_ocp.solver_options.nlp_solver_type in (
                "DDP", "SQP_WITH_FEASIBLE_QP") or not use_x0_elimination(
                    self.form, self.opts):
            return False
        off, nx = self._layout(0).off_bx, self.form.nx
        return not np.array_equal(self._data["lb_0"][off:off + nx],
                                  self._data["ub_0"][off:off + nx])

    def _data_and_iterate(self):
        data = data_to_torch(self._data, self.dtype, self.device, batch=1)
        init = iterate_to_torch({k: v[None] for k, v in
                                 self._iterate.items()},
                                self.dtype, self.device)
        return data, init

    def _solve_rti_phase(self) -> int:
        """One RTI phase (acados_tpu/interface/solver.py:329-373): 1 is
        the preparation, 2 the feedback (after an implicit preparation
        if none is pending)."""
        if self._rti_fns is None:
            self._rti_fns = make_rti_solver(self.form, self.opts)
        prepare, feedback = self._rti_fns
        self._maybe_default_init()

        def _prepare():
            # AS-RTI levels start from the previous cycle's cache
            prev = (self._rti_prev_cache
                    if self.opts.as_rti_level != "STANDARD" else None)
            cache = prepare(*self._data_and_iterate(), prev)
            _fence(cache.g0)
            return cache

        if self._rti_phase == 1:
            t0 = time.perf_counter()
            self._rti_cache = _prepare()
            self._time_prep = self._time_tot = time.perf_counter() - t0
            # AS-RTI levels advance the iterate during the preparation
            if self.opts.as_rti_level != "STANDARD":
                self._iterate = {k: v[0] for k, v in iterate_to_numpy(
                    self._rti_cache.it).items()}
            return 0
        if self._rti_cache is None:
            # feedback without a pending preparation: prepare first
            t0 = time.perf_counter()
            self._rti_cache = _prepare()
            self._time_prep = time.perf_counter() - t0
        t0 = time.perf_counter()
        data, init = self._data_and_iterate()
        it, stats = feedback(self._rti_cache, data, init)
        status = int(stats.status[0])  # host transfer: waits for the card
        self._time_fb = self._time_tot = time.perf_counter() - t0
        self._iterate = {k: v[0] for k, v in iterate_to_numpy(it).items()}
        self._last_stats = stats
        self._rti_prev_cache, self._rti_cache = self._rti_cache, None
        self._default_init = False
        return status

    def solve(self) -> int:
        """Solve; returns the acados status (0 success). With rti_phase
        1 or 2 set by options_set, runs only that RTI phase."""
        if self._rti_phase in (1, 2):
            return self._solve_rti_phase()
        self._maybe_default_init()
        if debug_checks_enabled(self.acados_ocp.solver_options):
            check_nlp_data(self._data)
            check_iterate(self._iterate)
        solve_fn = self._solve_fn
        if self._x0_bounds_asymmetric():
            if self._solve_fn_noelim is None:
                self._solve_fn_noelim = make_sqp_solver(
                    self.form, self.opts.replace(eliminate_x0=False))
            solve_fn = self._solve_fn_noelim
        t0 = time.perf_counter()
        it, stats = solve_fn(*self._data_and_iterate())
        status = int(stats.status[0])  # host transfer: waits for the card
        self._time_tot = time.perf_counter() - t0
        self._iterate = {k: v[0] for k, v in iterate_to_numpy(it).items()}
        self._last_stats = stats
        self._phase_cache = None
        if self._print_level > 0:
            # the iteration table prints after the solve, as the JAX
            # package prints it (the reference prints it live,
            # ocp_nlp_sqp.c:449-465)
            self.print_statistics()
        budget = self.acados_ocp.solver_options.timeout_max_time
        if budget and self._time_tot > budget and status != 0:
            return 7  # ACADOS_TIMEOUT (acados_tpu/interface/solver.py:441)
        return status

    def solve_for_x0(self, x0_bar, fail_on_nonzero_status=True,
                     print_stats_on_failure=True):
        """Reference: acados_ocp_solver.py solve_for_x0."""
        self.set(0, "lbx", x0_bar)
        self.set(0, "ubx", x0_bar)
        status = self.solve()
        if status != 0:
            if print_stats_on_failure:
                self.print_statistics()
            if fail_on_nonzero_status:
                raise RuntimeError(f"solve failed with status {status}")
        return self.get(0, "u")

    # -- get / set ----------------------------------------------------------
    def _stage_dims(self, stage: int):
        """(nx, nu) at a stage: a multiphase OCP's are its phase's, as
        the reference's multi-solver returns them."""
        if not self._is_mocp:
            return self.form.nx, self.form.nu
        mocp = self.acados_ocp
        return _phase_dims(mocp)[phase_of_stage(mocp, stage)]

    def _refuse_path_stage_of_mocp(self, stage: int, what: str):
        """A multiphase OCP has a row layout per phase, which the JAX
        package's stage lookup does not take (acados_tpu/interface/
        solver.py:505-512 fails there)."""
        if self._is_mocp and 0 < stage < self.N:
            raise NotImplementedError(
                f"{what} at a path stage of a multiphase OCP is not "
                "supported: the JAX package fails there too (ROADMAP.md, "
                "Queue 3: gaps in the JAX package)")

    def get(self, stage: int, field: str):
        """Reference: ocp_nlp_get_at_stage (ocp_nlp_interface.c:1704)."""
        it = self._iterate
        if field in ("x", "u"):
            n = self._stage_dims(stage)[field == "u"]
            return it[field][stage][:n].copy()
        if field == "pi":
            return it[field][stage].copy()
        if field in ("sl", "su"):
            return it[field][stage][self._soft_slice(stage)].copy()
        if field == "lam":
            # reference lam layout: [lam_lb; lam_ub] over the stage's rows
            n = self._layout(stage).nrows
            return np.concatenate([it["lam_l"][stage][:n],
                                   it["lam_u"][stage][:n]])
        if field == "z":
            if self._is_mocp:
                raise NotImplementedError(
                    "get(stage, 'z') of a multiphase OCP is not supported: "
                    "the JAX package's multiphase formulation has no z")
            return _z_at(self, stage, {k: it[k][None] for k in ("x", "u")},
                         {k: self._data[k][None] for k in ("p", "ts",
                                                           "dts")})[0]
        raise ValueError(f"get: unknown field {field!r}")

    def _layout(self, stage) -> StageLayout:
        self._refuse_path_stage_of_mocp(stage, "the constraint rows")
        return self.layouts["0" if stage == 0
                            else ("e" if stage == self.N else "p")]

    def _soft_slice(self, stage):
        self._refuse_path_stage_of_mocp(stage, "the soft rows")
        spec = (self.form.con_0 if stage == 0 else
                self.form.con_e if stage == self.N else self.form.con)
        return list(spec.soft_rows)

    def set(self, stage: int, field: str, value):
        """Reference: acados_ocp_solver.py set(): iterate fields and the
        common data fields (p, yref, W, bounds)."""
        value = np.atleast_1d(np.asarray(value, np.float64))
        it = self._iterate
        if field in ("x", "u", "pi"):
            if self._is_mocp and field != "pi" and \
                    value.shape[0] == self._stage_dims(stage)[field == "u"]:
                it[field][stage][:value.shape[0]] = value  # phase dims
            else:
                it[field][stage] = value
            self._default_init = False
            return
        if field in ("sl", "su"):
            it[field][stage][self._soft_slice(stage)] = value
            self._default_init = False
            return
        if field == "p":
            if value.shape[0] == self._data["p"].shape[1]:
                self._data["p"][stage] = value
            else:
                # the stage part only: the [p_global | global_data] tail
                # is set_p_global_and_precompute_dependencies'
                self._data["p"][stage, :value.shape[0]] = value
            return
        if field in ("yref", "W"):
            self.cost_set(stage, field, value)
            return
        if field in ("lbx", "ubx", "lbu", "ubu", "lg", "ug", "lh", "uh"):
            self.constraints_set(stage, field, value)
            return
        raise ValueError(f"set: unknown field {field!r}")

    def cost_set(self, stage: int, field: str, value):
        """Reference: acados_ocp_solver.py cost_set."""
        value = np.asarray(value, np.float64)
        if field in ("yref", "W"):
            if stage == 0:
                self._data[field + "_0"] = value
            elif stage == self.N:
                self._data[field + "_e"] = value
            else:
                self._data[field][stage - 1] = value
            return
        if field in ("Zl", "Zu", "zl", "zu"):
            rows = self._soft_slice(stage)
            key = field + ("_0" if stage == 0 else
                           "_e" if stage == self.N else "")
            tgt = self._data[key] if stage in (0, self.N) \
                else self._data[key][stage - 1]
            sc = np.atleast_1d(value)
            for j, rowi in enumerate(rows):
                tgt[rowi] = sc[j] if j < len(sc) else sc[-1]
            return
        raise ValueError(f"cost_set: unknown field {field!r}")

    def constraints_set(self, stage: int, field: str, value):
        """Reference: acados_ocp_solver.py constraints_set; maps the
        per-kind bound vectors onto the unified rows."""
        value = np.atleast_1d(np.asarray(value, np.float64))
        key, off, n = _bound_slot(self._layout(stage), stage, self.N, field)
        if stage in (0, self.N):
            self._data[key][off:off + n] = value
        else:
            self._data[key][stage - 1][off:off + n] = value

    # -- solution sensitivities ----------------------------------------------
    # acados_tpu/interface/solver.py:613-760, on a batch of one

    def _kkt_factor(self) -> KktFactor:
        so = self.acados_ocp.solver_options
        return KktFactor(self.form,
                         SensOpts(t_lam_min=so.solution_sens_qp_t_lam_min),
                         *self._data_and_iterate())

    def eval_param_sens(self, index: int, stage=None):
        """Forward solution sensitivity with respect to one parameter
        entry (reference eval_param_sens -> ocp_nlp_common_eval_param_sens,
        ocp_nlp_common.c:4039). stage=None seeds the parameter at every
        stage (the global-parameter convention), an int only that stage.

        Returns a dict with 'sens_x' (N+1, nx) and 'sens_u' (N, nu)."""
        kf = self._kkt_factor()
        dp = torch.zeros_like(kf.data.p)
        dp[:, slice(None) if stage is None else stage, index] = 1.0
        dx, du, _, _, _ = forward_sensitivity(kf, _seed_data(p=dp))
        return {"sens_x": dx[0].cpu().numpy(),
                "sens_u": du[0].cpu().numpy()}

    def set_p_global_and_precompute_dependencies(self, p_global_values):
        """Set the global parameters of every stage and recompute their
        precomputed data (reference p_global_precompute_fun.in.h;
        acados_tpu/interface/solver.py:632-656): the stage callables see
        [p_stage | p_global | global_data] as their p."""
        m = self.acados_ocp.model
        npg = _dim_of(getattr(m, "p_global", None))
        if npg == 0:
            raise ValueError("model.p_global is not declared")
        vals = np.atleast_1d(np.asarray(p_global_values, np.float64))
        if vals.shape[0] != npg:
            raise ValueError(f"expected {npg} p_global values")
        gd = _global_data(m, vals)
        np_stage = self._data["p"].shape[1] - npg - gd.shape[0]
        self._data["p"][:, np_stage:np_stage + npg] = vals
        if gd.shape[0]:
            self._data["p"][:, np_stage + npg:] = gd

    def eval_and_get_optimal_value_gradient(self,
                                            with_respect_to="p_global"):
        """Gradient of the optimal objective with respect to 'p_global'
        (the parameter shared by every stage) or 'initial_state', by the
        envelope theorem at the converged KKT point (reference
        eval_lagr_grad_p, ocp_nlp_common.c:4181)."""
        data, it = self._data_and_iterate()
        if with_respect_to in ("p_global", "params_global"):
            g = eval_lagrange_grad_p(self.form, data, it)
            return g[0].sum(dim=0).cpu().numpy()
        if with_respect_to == "initial_state":
            return optimal_value_grad_x0(self.form, data,
                                         it)[0].cpu().numpy()
        raise ValueError(f"with_respect_to {with_respect_to!r}")

    def eval_solution_sensitivity(self, stages, with_respect_to,
                                  return_sens_x=True, return_sens_u=True,
                                  sanity_checks=True):
        """Forward sensitivities of (x_stage, u_stage) with respect to every
        entry of 'initial_state' or 'params_global'/'p_global' (reference
        acados_ocp_solver.py eval_solution_sensitivity): the seed
        directions go through one vmapped forward_sensitivity.

        Returns (sens_x, sens_u): lists over the stages of arrays whose
        last axis runs over the seed directions (one array each when one
        stage is asked for)."""
        del sanity_checks
        if isinstance(stages, int):
            stages = [stages]
        kf = self._kkt_factor()
        dxs, dus = _forward_over_seeds(kf, self.layouts["0"],
                                       with_respect_to)
        dxs = dxs[0].cpu().numpy()
        dus = dus[0].cpu().numpy()
        n_wrt = dxs.shape[-1]
        sens_x = [dxs[s] for s in stages]
        sens_u = [dus[s] if s < self.N
                  else np.zeros((self.form.nu, n_wrt)) for s in stages]
        out = []
        if return_sens_x:
            out.append(sens_x if len(stages) > 1 else sens_x[0])
        if return_sens_u:
            out.append(sens_u if len(stages) > 1 else sens_u[0])
        return tuple(out) if len(out) > 1 else out[0]

    def eval_adjoint_solution_sensitivity(self, seed_x, seed_u,
                                          with_respect_to="params_global",
                                          sanity_checks=True):
        """Adjoint solution sensitivity: the gradient of the seeded
        solution entries with respect to the parameters (reference
        eval_adjoint_solution_sensitivity -> eval_solution_sens_adj_p,
        ocp_nlp_common.c:4108). seed_x/seed_u: lists of (stage, vector)
        pairs, full (N+1, nx)/(N, nu) arrays, or None.

        Returns (np,) for 'params_global', (N+1, np) for 'p_stagewise',
        (nbx0,) for 'initial_state', or the NlpData of gradients (batch of
        one) for 'all'."""
        del sanity_checks
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        grad = adjoint_sensitivity(
            self._kkt_factor(),
            as_t(_seeds((1, self.N + 1, self.form.nx), seed_x)),
            as_t(_seeds((1, self.N, self.form.nu), seed_u)))
        if with_respect_to == "all":
            return grad
        return _adjoint_wrt(grad, self.layouts["0"], with_respect_to)[0]

    # -- stats ----------------------------------------------------------------
    def get_status(self) -> int:
        return int(self._last_stats.status[0])

    def get_cost(self) -> float:
        return float(self._last_stats.cost[0])

    def get_residuals(self, recompute=False):
        del recompute
        s = self._last_stats
        return np.array([float(s.res_stat[0]), float(s.res_eq[0]),
                         float(s.res_ineq[0]), float(s.res_comp[0])])

    def get_stats(self, field: str):
        """Reference: acados_ocp_solver.py get_stats (subset)."""
        s = self._last_stats
        if field in ("sqp_iter", "nlp_iter"):
            return int(s.sqp_iter[0])
        if field == "qp_iter":
            return int(s.qp_iter_total[0])
        if field == "statistics":
            n = int(s.sqp_iter[0]) + 1
            tab = s.stat[0, :n].cpu().numpy()
            return np.concatenate([np.arange(n)[:, None], tab], axis=1).T
        if field == "time_tot":
            return self._time_tot
        if field == "time_preparation":
            return self._time_prep
        if field == "time_feedback":
            return self._time_fb
        if field in PHASE_KEYS:
            return self._phase_times()[field]
        if field == "residuals":
            return self.get_residuals()
        if field == "cost_value":
            return self.get_cost()
        raise ValueError(f"get_stats: unknown field {field!r}")

    def _phase_times(self) -> dict:
        """The phase times (reference ocp_nlp_timings, ocp_nlp_common.h:
        410-428), as acados_tpu/interface/solver.py:795-878 takes them:
        measured in the loop with collect_phase_times, else by isolated
        re-execution at the last solve's iterate of the linearization,
        the dynamics sweep with its forward sensitivities, the
        regularization and the QP, each timed on its second run and
        scaled by the iteration count. Cached per solve."""
        measured = measured_phase_times(self._last_stats)
        if measured is not None:
            return measured
        if self._phase_cache is not None:
            return self._phase_cache
        form, opts, dev = self.form, self.opts, self.device
        data, it = self._data_and_iterate()
        static_rows = build_static_rows(form, self.dtype, dev)
        lm = torch.tensor(opts.levenberg_marquardt, dtype=self.dtype,
                          device=dev)
        t_lin, qp = timed_run(
            lambda: linearize(form, static_rows, data, it, lm), dev)
        t_sim, _ = timed_run(lambda: form.step_jac_fn(*(
            v.flatten(0, 1) for v in (it.x[:, :-1], it.u, data.p[:, :-1],
                                      data.ts[:, :-1], data.dts))), dev)
        t_reg, qp_r = timed_run(lambda: regularize_qp(
            qp, opts.regularize_method, opts.reg_epsilon), dev)
        t_qp, _ = timed_run(lambda: solve_ocp_qp(qp_r, opts.qp_opts), dev)
        n_iter = (max(int(self._last_stats.sqp_iter[0]), 1)
                  if self._last_stats is not None else 1)
        self._phase_cache = {
            "time_lin": t_lin * n_iter, "time_sim": t_sim * n_iter,
            "time_reg": t_reg * n_iter, "time_qp": t_qp * n_iter,
            "time_glob": max(0.0, self._time_tot
                             - (t_lin + t_qp + t_reg) * n_iter)}
        return self._phase_cache

    def custom_update(self, data=None):
        """Custom-update hook between solver calls (reference
        AcadosOcpSolver.custom_update + custom_update_templates/): with a
        ZoroDescription attached, the zoRO covariance propagation and
        bound tightening (interface/zoro.py); otherwise `data` may be a
        callable(solver) implementing an arbitrary update."""
        if self.acados_ocp.zoro_description is not None:
            from acados_tpu_torch.interface.zoro import zoro_custom_update
            zoro_custom_update(self)
            return 0
        if callable(data):
            data(self)
            return 0
        raise ValueError("custom_update: attach ocp.zoro_description or "
                         "pass a callable(solver)")

    def get_iterates(self):
        """The per-iteration primal trajectories when store_iterates is on
        (reference AcadosOcpSolver.get_iterates / mem->iterates): a dict
        with 'x' (n_iter+1, N+1, nx) and 'u' (n_iter+1, N, nu)."""
        s = self._last_stats
        if s is None or getattr(s, "iterates_x", None) is None:
            raise RuntimeError("set solver_options.store_iterates = True "
                               "before solve()")
        n = int(s.sqp_iter[0]) + 1
        return {"x": s.iterates_x[0, :n].cpu().numpy(),
                "u": s.iterates_u[0, :n].cpu().numpy()}

    def print_statistics(self):
        """Reference-style iteration table (ocp_nlp_sqp.c
        print_iteration), in the JAX package's columns and formats
        (acados_tpu/interface/solver.py:908-916)."""
        cols = ["iter", "res_stat", "res_eq", "res_ineq", "res_comp",
                "qp_status", "qp_iter", "alpha", "step_norm"]
        print("  ".join(f"{c:>9s}" for c in cols))
        for row in self.get_stats("statistics").T:
            print("  ".join(f"{int(row[0]):>9d}" if i == 0 else
                            f"{row[i]:>9.3e}" for i in range(len(cols))))

    # -- iterate save/load ----------------------------------------------------
    # acados_tpu/interface/solver.py:918-993, on the host copy

    def store_iterate_to_obj(self) -> dict:
        """Reference: AcadosOcpIterate (acados_ocp_iterate.py:40)."""
        return {k: v.copy() for k, v in self._iterate.items()}

    def load_iterate_from_obj(self, obj):
        for k in self._iterate:
            self._iterate[k] = np.asarray(obj[k], np.float64).copy()
        self._default_init = False

    def get_flat(self, field: str) -> np.ndarray:
        """Flat all-stage value of one iterate field: x, u, pi, lam (per
        stage [lam_l, lam_u] over the unified rows), sl, su."""
        return flat_of(self._iterate, field)

    def set_flat(self, field: str, value):
        """Inverse of get_flat."""
        set_flat_in(self._iterate, field, value)
        self._default_init = False

    def store_iterate_to_flat_obj(self) -> AcadosOcpFlattenedIterate:
        """Reference: store_iterate_to_flat_obj."""
        return AcadosOcpFlattenedIterate(
            **{f: self.get_flat(f) for f in FLAT_FIELDS})

    def load_iterate_from_flat_obj(self, flat):
        """Reference: load_iterate_from_flat_obj (warm-start transfer
        between solvers of the same formulation)."""
        for f in FLAT_FIELDS:
            self.set_flat(f, getattr(flat, f))

    def store_iterate(self, filename: str, overwrite=True, verbose=False):
        """Reference: store_iterate -> a JSON file; a '.atni' extension
        selects the binary checkpoint format (native/), which the JAX
        package reads and writes byte for byte alike."""
        del overwrite, verbose
        if filename.endswith(".atni"):
            save_iterate_bin(filename, self._iterate)
            return
        with open(filename, "w") as f:
            json.dump({k: v.tolist() for k, v in self._iterate.items()}, f)

    def load_iterate(self, filename: str, verbose=False):
        del verbose
        if filename.endswith(".atni"):
            self.load_iterate_from_obj(load_iterate_bin(filename))
            return
        with open(filename) as f:
            obj = json.load(f)
        self.load_iterate_from_obj({k: np.asarray(v) for k, v in
                                    obj.items()})

    def dump_qp_to_file(self, filename: str):
        """Debug dump of the QP linearized at the current iterate
        (reference ACADOS_DEBUG_SQP_PRINT_QPS_TO_FILE, ocp_nlp_common.h:
        674-675): every stage-blocked QP matrix and vector, without the
        batch axis, to an .npz of the JAX package's keys and shapes."""
        data, it = self._data_and_iterate()
        qp = linearize(self.form, build_static_rows(
            self.form, self.dtype, self.device), data, it,
            torch.zeros((), dtype=self.dtype, device=self.device))
        np.savez(filename, **{k: getattr(qp, k)[0].cpu().numpy()
                              for k in QP_DUMP_FIELDS})


def _bound_slot(lay: StageLayout, stage: int, N: int, field: str):
    """(data key, row offset, row count) of a bound field at a stage."""
    lower = field.startswith("l")
    kind = field[1:]
    off, n = {"bx": (lay.off_bx, lay.nbx), "bu": (lay.off_bu, lay.nbu),
              "g": (lay.off_g, lay.ng), "h": (lay.off_h, lay.nh)}[kind]
    if n == 0:
        raise ValueError(f"stage {stage} has no '{kind}' rows")
    side = "lb" if lower else "ub"
    key = side + ("_0" if stage == 0 else "_e" if stage == N else "")
    return key, off, n


def _seeds(shape, seeds) -> np.ndarray:
    """Adjoint seeds as one (B, stages, dim) array: `seeds` is None, a
    full array, or a list of (stage, vector) pairs whose vectors are
    (dim,), (B, dim) or (B, dim, n_seeds) (the seed columns summed)."""
    tgt = np.zeros(shape)
    if seeds is None:
        return tgt
    if isinstance(seeds, (list, tuple)):
        for stage, vec in seeds:
            v = np.asarray(vec)
            if v.ndim == 3:
                v = v.sum(axis=-1)
            tgt[:, stage] += v.reshape(tgt[:, stage].shape)
    else:
        tgt[:] = np.asarray(seeds).reshape(shape)
    return tgt


def _seed_data(**fields) -> NlpData:
    """An NlpData tangent that is zero (None) but in `fields`."""
    return NlpData(**{f: fields.get(f) for f in NlpData.__dataclass_fields__})


def _forward_over_seeds(kf: KktFactor, lay0: StageLayout, with_respect_to):
    """forward_sensitivity along every unit direction of 'initial_state'
    (the stage-0 state rows' bounds, both sides) or of the parameters
    (every stage at once), the directions as one torch.func.vmap axis:
    returns (dx (B, N+1, nx, n_wrt), du (B, N, nu, n_wrt))."""
    data = kf.data
    if with_respect_to in ("params_global", "p_global", "p"):
        n_wrt = data.p.shape[-1]
        eye = torch.eye(n_wrt, dtype=data.p.dtype, device=data.p.device)
        seeds = eye[:, None, None, :].expand((n_wrt,) + data.p.shape)

        def one(dp):
            return forward_sensitivity(kf, _seed_data(p=dp))[:2]
    elif with_respect_to == "initial_state":
        n_wrt = lay0.nbx
        nc = data.lb_0.shape[-1]
        eye = torch.zeros((n_wrt, nc), dtype=data.p.dtype,
                          device=data.p.device)
        eye[:, lay0.off_bx:lay0.off_bx + n_wrt] = torch.eye(
            n_wrt, dtype=data.p.dtype, device=data.p.device)
        seeds = eye[:, None, :].expand((n_wrt,) + data.lb_0.shape)

        def one(e):
            return forward_sensitivity(kf, _seed_data(lb_0=e, ub_0=e))[:2]
    else:
        raise ValueError(with_respect_to)
    dxs, dus = torch.func.vmap(one)(seeds)
    return dxs.movedim(0, -1), dus.movedim(0, -1)


def _adjoint_wrt(grad: NlpData, lay0: StageLayout, with_respect_to):
    """The slice of an adjoint gradient the caller asked for, per
    instance: (B, np) for the global parameters, (B, N+1, np) stagewise,
    (B, nbx0) for the initial state."""
    if with_respect_to in ("params_global", "p_global", "p"):
        return grad.p.sum(dim=1).cpu().numpy()
    if with_respect_to == "p_stagewise":
        return grad.p.cpu().numpy()
    if with_respect_to == "initial_state":
        g = grad.lb_0 + grad.ub_0
        return g[:, lay0.off_bx:lay0.off_bx + lay0.nbx].cpu().numpy()
    raise ValueError(with_respect_to)
