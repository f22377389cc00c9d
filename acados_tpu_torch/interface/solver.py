"""AcadosOcpSolver: the user-facing solve/get/set surface.

Counterpart of `acados_tpu/interface/solver.py` (API mirror of the
reference AcadosOcpSolver): construction builds the SQP solve function;
`set` mutates host-side numpy data that is moved to the device at
`solve()`. One instance runs as a batch of one through the batch-first
solver.

The solver runs on the card unless `device="cpu"` is passed; with no
CUDA and no explicit device it raises. Ported: solve, get, set,
cost_set, constraints_set, get_status, get_stats (sqp_iter, qp_iter,
residuals, time_tot, statistics), get_residuals, get_cost, reset. The
RTI phases (rti_phase), sensitivities and phase times wait (ROADMAP.md
Queue 1).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import AcadosOcp
from acados_tpu_torch.interface.builder import (StageLayout, build_ocp,
                                                data_to_torch)
from acados_tpu_torch.ocp_nlp.linearize import NlpIterate
from acados_tpu_torch.ocp_nlp.sqp import (SqpOpts, make_sqp_solver,
                                          use_x0_elimination)
from acados_tpu_torch.ocp_qp.ipm import IpmOpts
from acados_tpu_torch.ocp_qp.xcond import resolve_cond_N
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
    if so.nlp_solver_type not in ("SQP", "SQP_RTI"):
        raise NotImplementedError(
            f"nlp_solver_type {so.nlp_solver_type!r} is not ported yet "
            "(ROADMAP.md Queue 1, NLP breadth)")
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
        levenberg_marquardt=so.levenberg_marquardt,
        with_adaptive_levenberg_marquardt=(
            so.with_adaptive_levenberg_marquardt),
        regularize_method=so.regularize_method,
        reg_epsilon=so.reg_epsilon,
        globalization=so.globalization if not rti else "FIXED_STEP",
        cond_N=_resolve_cond(ocp), full_cond=_is_full_cond(so),
        step_length=(so.globalization_fixed_step_length
                     if so.globalization_fixed_step_length is not None
                     else so.nlp_solver_step_length),
        full_step_dual=so.globalization_full_step_dual,
        with_anderson_acceleration=so.with_anderson_acceleration,
        store_iterates=so.store_iterates,
        qpscaling=so.qpscaling_scale_objective,
        collect_phase_times=so.collect_phase_times,
        nlp_qp_tol_strategy=so.nlp_qp_tol_strategy,
        qp_opts=qp_opts)


def _is_full_cond(so) -> bool:
    """Every FULL_CONDENSING_* qp_solver takes the dense IPM path."""
    return str(so.qp_solver).startswith("FULL_CONDENSING")


def _resolve_cond(ocp: AcadosOcp) -> int | None:
    """qp_solver_cond_N -> the partial-condensing horizon, as
    acados_tpu/interface/solver.py:_resolve_cond maps it: None for full
    condensing and for cond_N >= N (HPIPM's "no condensing")."""
    so = ocp.solver_options
    if so.qp_solver_cond_N is None or _is_full_cond(so):
        return None
    return resolve_cond_N(so.N_horizon or ocp.dims.N, so.qp_solver_cond_N)


def _torch_dtype(ocp: AcadosOcp):
    return (torch.float64 if ocp.solver_options.dtype == "float64"
            else torch.float32)


def iterate_to_torch(it: dict, dtype, device) -> NlpIterate:
    """Numpy iterate dict (leading batch axis) -> NlpIterate."""
    return NlpIterate(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                         for k, v in it.items()})


def iterate_to_numpy(it: NlpIterate) -> dict:
    return {k: getattr(it, k).detach().cpu().numpy().astype(np.float64)
            for k in ("x", "u", "pi", "lam_l", "lam_u", "sl", "su")}


class AcadosOcpSolver:
    """Drop-in style replacement for the reference class of the same
    name; `device` None means "cuda"."""

    def __init__(self, ocp: AcadosOcp, json_file=None, build=None,
                 generate=None, verbose=False, device=None):
        del json_file, build, generate, verbose  # codegen-era args accepted
        self.device = resolve_device(device)
        full_precision_matmul()
        self.acados_ocp = ocp
        self.form, self._data, self.layouts = build_ocp(ocp)
        self.opts = _sqp_opts_from(ocp)
        self.dtype = _torch_dtype(ocp)
        self._solve_fn = make_sqp_solver(self.form, self.opts)
        self._solve_fn_noelim = None  # lazy barrier-x0 fallback (solve())
        self.N = self.form.N
        self._iterate = self._zero_iterate()
        self._default_init = True
        self._last_stats = None
        self._time_tot = float("nan")

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
        state rows (solve() then uses the barrier treatment)."""
        if not use_x0_elimination(self.form, self.opts):
            return False
        off, nx = self._layout(0).off_bx, self.form.nx
        return not np.array_equal(self._data["lb_0"][off:off + nx],
                                  self._data["ub_0"][off:off + nx])

    def solve(self) -> int:
        """Solve; returns the acados status (0 success)."""
        self._maybe_default_init()
        solve_fn = self._solve_fn
        if self._x0_bounds_asymmetric():
            if self._solve_fn_noelim is None:
                self._solve_fn_noelim = make_sqp_solver(
                    self.form, self.opts.replace(eliminate_x0=False))
            solve_fn = self._solve_fn_noelim
        t0 = time.perf_counter()
        data = data_to_torch(self._data, self.dtype, self.device, batch=1)
        init = iterate_to_torch({k: v[None] for k, v in
                                 self._iterate.items()},
                                self.dtype, self.device)
        it, stats = solve_fn(data, init)
        status = int(stats.status[0])  # host transfer: waits for the card
        self._time_tot = time.perf_counter() - t0
        self._iterate = {k: v[0] for k, v in iterate_to_numpy(it).items()}
        self._last_stats = stats
        return status

    def solve_for_x0(self, x0_bar, fail_on_nonzero_status=True):
        """Reference: acados_ocp_solver.py solve_for_x0."""
        self.set(0, "lbx", x0_bar)
        self.set(0, "ubx", x0_bar)
        status = self.solve()
        if status != 0 and fail_on_nonzero_status:
            raise RuntimeError(f"solve failed with status {status}")
        return self.get(0, "u")

    # -- get / set ----------------------------------------------------------
    def get(self, stage: int, field: str):
        """Reference: ocp_nlp_get_at_stage (ocp_nlp_interface.c:1704)."""
        it = self._iterate
        if field in ("x", "u", "pi"):
            return it[field][stage].copy()
        if field in ("sl", "su"):
            return it[field][stage][self._soft_slice(stage)].copy()
        if field == "lam":
            # reference lam layout: [lam_lb; lam_ub] over the stage's rows
            n = self._layout(stage).nrows
            return np.concatenate([it["lam_l"][stage][:n],
                                   it["lam_u"][stage][:n]])
        raise ValueError(f"get: unknown field {field!r}")

    def _layout(self, stage) -> StageLayout:
        return self.layouts["0" if stage == 0
                            else ("e" if stage == self.N else "p")]

    def _soft_slice(self, stage):
        spec = (self.form.con_0 if stage == 0 else
                self.form.con_e if stage == self.N else self.form.con)
        return list(spec.soft_rows)

    def set(self, stage: int, field: str, value):
        """Reference: acados_ocp_solver.py set(): iterate fields and the
        common data fields (p, yref, W, bounds)."""
        value = np.atleast_1d(np.asarray(value, np.float64))
        it = self._iterate
        if field in ("x", "u", "pi"):
            it[field][stage] = value
            self._default_init = False
            return
        if field in ("sl", "su"):
            it[field][stage][self._soft_slice(stage)] = value
            self._default_init = False
            return
        if field == "p":
            self._data["p"][stage] = value
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
        if field == "residuals":
            return self.get_residuals()
        if field == "cost_value":
            return self.get_cost()
        raise ValueError(f"get_stats: unknown field {field!r}")


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
