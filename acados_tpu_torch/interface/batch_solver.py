"""AcadosOcpBatchSolver: N_batch solves as one batch-first solve.

Counterpart of `acados_tpu/interface/batch_solver.py` (API mirror of the
reference batch solver): the batch is the leading axis of every tensor
of one lockstep solve, where the JAX package vmaps it. solve() runs the
plan's NLP solver (SQP, SQP_RTI, DDP or SQP_WITH_FEASIBLE_QP; the JAX
package's batch solver runs its SQP for every plan); prepare/feedback
are SQP_RTI's.

Over a mesh of several devices (`devices=`, parallel/mesh.py) solve()
splits the batch into one shard a device, each solved in a thread of its
own (`map_shards`), where N_batch divides by their number, as the JAX
package shards its solve; the iterate and the stats are gathered on the
mesh's first device, where everything else runs, as in the JAX package,
whose other entry points are not sharded either.

The data and the iterate stay on the device between solves and between
the RTI phases (`prepare`, `feedback`), so a warm RTI loop moves nothing
to the host but the statuses (and the measured x0s it is given); the
per-instance views `ocp_solvers[i].get/set` work on a host copy that is
moved across only when it changed. The solution sensitivities work on
the same device-resident data and iterate: one KKT factor of the whole
batch, the seed directions a vmapped axis. The flat iterate API
(get_flat, set_flat, store_iterate_to_flat_obj,
load_iterate_from_flat_obj) moves the iterate with one host copy a
field, and get_stats gives the phase times (time_lin, time_sim,
time_reg, time_qp, time_glob).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from acados_tpu_torch.interface.acados_ocp import AcadosOcp
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.interface.iterate import AcadosOcpFlattenedBatchIterate
from acados_tpu_torch.interface.multiphase import AcadosMultiphaseOcp
from acados_tpu_torch.interface.solver import (FLAT_FIELDS, PHASE_KEYS,
                                               _adjoint_wrt, _bound_slot,
                                               _fence, _forward_over_seeds,
                                               _seeds, _sqp_opts_from,
                                               _torch_dtype, _z_at, flat_of,
                                               iterate_to_numpy,
                                               iterate_to_torch,
                                               make_nlp_solver,
                                               measured_phase_times,
                                               set_flat_in, timed_run)
from acados_tpu_torch.ocp_nlp.linearize import build_static_rows, linearize
from acados_tpu_torch.ocp_nlp.regularize import regularize_qp
from acados_tpu_torch.ocp_nlp.rti import make_rti_solver
from acados_tpu_torch.ocp_nlp.sensitivity import (KktFactor, SensOpts,
                                                  adjoint_sensitivity)
from acados_tpu_torch.ocp_nlp.sqp import make_qp_solve, nlp_warm_start
from acados_tpu_torch.parallel.mesh import make_batch_mesh, map_shards
from acados_tpu_torch.utils.device import full_precision_matmul


class _BatchView:
    """Per-instance get/set view (reference: batch_solver.ocp_solvers[i])."""

    def __init__(self, parent, i):
        self._p = parent
        self._i = i

    def set(self, stage, field, value):
        value = np.atleast_1d(np.asarray(value, np.float64))
        p, i = self._p, self._i
        if field in ("x", "u", "pi", "sl", "su"):
            p._host_iterate()[field][i, stage] = value
            p._it_dev = None
            return
        if field == "p":
            p._data["p"][i, stage] = value
        elif field in ("yref", "W"):
            if stage in (0, p.N):
                p._data[field + ("_0" if stage == 0 else "_e")][i] = value
            else:
                p._data[field][i, stage - 1] = value
        elif field in ("lbx", "ubx", "lbu", "ubu", "lg", "ug", "lh", "uh"):
            key, off, n = _bound_slot(p._layout(stage), stage, p.N, field)
            if stage in (0, p.N):
                p._data[key][i, off:off + n] = value
            else:
                p._data[key][i, stage - 1, off:off + n] = value
        else:
            raise ValueError(field)
        p._data_dev = None

    def get(self, stage, field):
        if field in ("x", "u", "pi", "sl", "su"):
            return self._p._host_iterate()[field][self._i, stage].copy()
        if field == "z":
            p, i = self._p, self._i
            return _z_at(p, stage, {k: p._host_iterate()[k][i:i + 1]
                                    for k in ("x", "u")},
                         {k: p._data[k][i:i + 1]
                          for k in ("p", "ts", "dts")})[0]
        raise ValueError(field)

    def get_status(self):
        st = self._p._status
        return None if st is None else int(st[self._i])


class AcadosOcpBatchSolver:
    """Batch of N_batch identical-structure OCPs solved as one batch.

    devices: the mesh solve() shards over (`make_batch_mesh`; None means
    every visible card); device: a one-device mesh, the shortcut for
    devices=[device]; not both."""

    def __init__(self, ocp: AcadosOcp, N_batch: int,
                 num_threads_in_batch_solve=None, json_file=None,
                 build=None, generate=None, verbose=False, device=None,
                 devices=None):
        del num_threads_in_batch_solve, json_file, build, generate, verbose
        if device is not None and devices is not None:
            raise ValueError("pass device or devices, not both")
        if isinstance(ocp, AcadosMultiphaseOcp):
            raise NotImplementedError(
                "AcadosOcpBatchSolver takes single-phase OCPs only, as the "
                "JAX package's (acados_tpu/interface/batch_solver.py:89 "
                "builds through build_ocp): solve a multiphase OCP with "
                "AcadosOcpSolver")
        self.mesh = make_batch_mesh(devices if device is None
                                    else [device])
        self.device = self.mesh[0]
        full_precision_matmul()
        self.acados_ocp = ocp
        self.N_batch = N_batch
        self.form, data1, self.layouts = build_ocp(ocp)
        self.opts = _sqp_opts_from(ocp)
        self.dtype = _torch_dtype(ocp)
        self.N = self.form.N
        self._solve_fn = make_nlp_solver(self.form, self.opts,
                                         ocp.solver_options.nlp_solver_type)
        # batch-tiled host data and iterate; device copies made on demand
        self._data = {k: np.tile(v, (N_batch,) + (1,) * np.ndim(v))
                      for k, v in data1.items()}
        self._data_dev = None
        N, nx, nu, nc = self.form.N, self.form.nx, self.form.nu, self.form.nc
        z = lambda *s: np.zeros((N_batch,) + s)
        self._iterate = dict(x=z(N + 1, nx), u=z(N, nu), pi=z(N, nx),
                             lam_l=z(N + 1, nc), lam_u=z(N + 1, nc),
                             sl=z(N + 1, nc), su=z(N + 1, nc))
        self._it_dev = None
        self._host_stale = False
        self.ocp_solvers = [_BatchView(self, i) for i in range(N_batch)]
        self._status = None
        self._stats = None
        self._phase_cache = None
        self._time_tot = float("nan")
        self._rti_fns = None
        self._rti_cache = None
        self._time_prep = float("nan")
        self._time_fb = float("nan")
        self._kf = None  # (data, iterate, KktFactor) of the last factor

    def _layout(self, stage):
        return self.layouts["0" if stage == 0
                            else ("e" if stage == self.N else "p")]

    def _host_iterate(self) -> dict:
        if self._host_stale:
            self._iterate = iterate_to_numpy(self._it_dev)
            self._host_stale = False
        return self._iterate

    def _on_device(self):
        """(data, iterate) on the device, moved across if they changed."""
        if self._data_dev is None:
            self._data_dev = data_to_torch(self._data, self.dtype,
                                           self.device)
        if self._it_dev is None:
            self._it_dev = iterate_to_torch(self._host_iterate(),
                                            self.dtype, self.device)
        return self._data_dev, self._it_dev

    def _take(self, it, stats):
        self._status = stats.status.cpu().numpy()  # waits for the card
        self._it_dev = it
        self._host_stale = True
        self._stats = stats
        self._phase_cache = None
        return self._status

    def solve(self, n_batch=None):
        """Solve all instances; returns the (N_batch,) statuses. Sharded
        over the mesh when it has several devices and N_batch divides by
        their number; time_tot spans every shard."""
        del n_batch
        t0 = time.perf_counter()
        if len(self.mesh) > 1 and self.N_batch % len(self.mesh) == 0:
            it, stats, times = map_shards(self._shard_solve, self.mesh,
                                          *self._on_device())
            if times is not None:
                # the shards run at once: each phase's longest
                stats = stats.replace(phase_times=times.amax(0).cpu())
        else:
            it, stats = self._solve_fn(*self._on_device())
        status = self._take(it, stats)
        self._time_tot = time.perf_counter() - t0
        return status

    def _shard_solve(self, data, init):
        """One shard's solve, its (4,) phase times (not batch-first) set
        apart as a (1, 4) row."""
        it, stats = self._solve_fn(data, init)
        times = stats.phase_times
        return (it, stats.replace(phase_times=None),
                None if times is None else times[None])

    # -- batched RTI phases ---------------------------------------------------
    # acados_tpu/interface/batch_solver.py:165-213 (the reference capsule's
    # batch_setup_qp_matrices_and_factorize): prepare between samples,
    # give the measured x0s to feedback.

    def prepare(self):
        """Batched RTI preparation: linearize and solve the QP at the
        predicted x0 for every instance. AS-RTI levels (as_rti_level in
        the options) start from the previous preparation's cache."""
        if self.acados_ocp.solver_options.nlp_solver_type != "SQP_RTI":
            raise RuntimeError("batched prepare/feedback requires "
                               "nlp_solver_type == 'SQP_RTI'")
        if self._rti_fns is None:
            self._rti_fns = make_rti_solver(self.form, self.opts)
        t0 = time.perf_counter()
        prev = (self._rti_cache if self.opts.as_rti_level != "STANDARD"
                else None)
        cache = self._rti_fns[0](*self._on_device(), prev)
        _fence(cache.g0)
        self._time_prep = time.perf_counter() - t0
        self._rti_cache = cache

    # the reference capsule's spelling
    setup_qp_matrices_and_factorize = prepare

    def feedback(self, x0=None):
        """Batched RTI feedback: inject the initial states and solve the
        prepared QPs, warm-started from the predicted solutions.

        x0: optional (N_batch, nbx0) measured initial states; None keeps
        the bounds already set. Returns the (N_batch,) statuses."""
        if self._rti_cache is None:
            raise RuntimeError("call prepare() before feedback()")
        t0 = time.perf_counter()
        if x0 is not None:
            lay = self._layout(0)
            x0 = np.asarray(x0, np.float64).reshape(self.N_batch, lay.nbx)
            sl = slice(lay.off_bx, lay.off_bx + lay.nbx)
            self._data["lb_0"][:, sl] = x0
            self._data["ub_0"][:, sl] = x0
            if self._data_dev is not None:
                # only the stage-0 bounds cross to the device
                lb_0 = self._data_dev.lb_0.clone()
                ub_0 = self._data_dev.ub_0.clone()
                lb_0[:, sl] = ub_0[:, sl] = torch.tensor(
                    x0, dtype=self.dtype, device=self.device)
                self._data_dev = self._data_dev.replace(lb_0=lb_0,
                                                        ub_0=ub_0)
        it, stats = self._rti_fns[1](self._rti_cache, *self._on_device())
        status = self._take(it, stats)
        self._time_fb = self._time_tot = time.perf_counter() - t0
        return status

    # -- the flat iterate -----------------------------------------------------
    # acados_tpu/interface/batch_solver.py:213-248: (N_batch, n_field)
    # arrays; the device iterate crosses once a field each way

    def get_flat(self, field: str) -> np.ndarray:
        return flat_of(self._host_iterate(), field, (self.N_batch,))

    def set_flat(self, field: str, value):
        set_flat_in(self._host_iterate(), field, value)
        self._it_dev = None

    def store_iterate_to_flat_obj(self) -> AcadosOcpFlattenedBatchIterate:
        """Reference: AcadosOcpFlattenedBatchIterate."""
        return AcadosOcpFlattenedBatchIterate(
            **{f: self.get_flat(f) for f in FLAT_FIELDS},
            N_batch=self.N_batch)

    def load_iterate_from_flat_obj(self, flat):
        for f in FLAT_FIELDS:
            self.set_flat(f, getattr(flat, f))

    # -- batched solution sensitivities ---------------------------------------
    # acados_tpu/interface/batch_solver.py:250-357: one KktFactor of the
    # whole batch at the device-resident data and iterate; the seed
    # directions are a torch.func.vmap axis, folded into the kernels'
    # batch by their vmap rules

    def _kkt_factor(self) -> KktFactor:
        """The KKT factor at the current data and iterate, kept until
        either changes (a solve, a feedback or a set)."""
        data, it = self._on_device()
        if self._kf is None or self._kf[0] is not data \
                or self._kf[1] is not it:
            self._kf = (data, it, KktFactor(self.form, SensOpts(), data,
                                            it))
        return self._kf[2]

    def eval_solution_sensitivity(self, stages, with_respect_to,
                                  return_sens_x=True, return_sens_u=True,
                                  sanity_checks=True):
        """Batched forward solution sensitivities (reference
        acados_ocp_batch_solver.py:342) with respect to every entry of
        'initial_state' or 'params_global'.

        Returns arrays of shape (N_batch, len(stages), dim, n_seeds)."""
        del sanity_checks
        if isinstance(stages, int):
            stages = [stages]
        dxs, dus = _forward_over_seeds(self._kkt_factor(),
                                       self._layout(0), with_respect_to)
        dxs, dus = dxs.cpu().numpy(), dus.cpu().numpy()
        sens_x = np.stack([dxs[:, s] for s in stages], axis=1)
        sens_u = np.stack([dus[:, s] if s < self.N
                           else np.zeros_like(dus[:, 0]) for s in stages],
                          axis=1)
        out = []
        if return_sens_x:
            out.append(sens_x)
        if return_sens_u:
            out.append(sens_u)
        return tuple(out) if len(out) > 1 else out[0]

    def eval_adjoint_solution_sensitivity(self, seed_x, seed_u,
                                          with_respect_to="params_global",
                                          sanity_checks=True):
        """Batched adjoint solution sensitivities, the RL policy-gradient
        path (reference acados_ocp_batch_solver.py:227 ->
        ocp_nlp_eval_solution_sens_adj_p): one Riccati-factored IFT solve
        of the whole batch.

        seed_x/seed_u: arrays (N_batch, N+1, nx) / (N_batch, N, nu), or
        lists of (stage, (N_batch, dim) array) pairs ((N_batch, dim,
        n_seeds) arrays are summed over the seeds), or None. Returns
        (N_batch, np) for 'params_global', (N_batch, N+1, np) for
        'p_stagewise', (N_batch, nbx0) for 'initial_state', or the
        batch's NlpData of gradients for 'all'."""
        del sanity_checks
        B, N, nx, nu = self.N_batch, self.N, self.form.nx, self.form.nu
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        grad = adjoint_sensitivity(self._kkt_factor(),
                                   as_t(_seeds((B, N + 1, nx), seed_x)),
                                   as_t(_seeds((B, N, nu), seed_u)))
        if with_respect_to == "all":
            return grad
        return _adjoint_wrt(grad, self._layout(0), with_respect_to)

    def get_stats(self, field):
        if field == "time_tot":
            return self._time_tot
        if field == "time_preparation":
            return self._time_prep
        if field == "time_feedback":
            return self._time_fb
        if field in ("sqp_iter", "nlp_iter"):
            return self._stats.sqp_iter.cpu().numpy()
        if field == "qp_iter":
            return self._stats.qp_iter_total.cpu().numpy()
        if field == "residuals":
            s = self._stats
            return np.stack([s.res_stat.cpu().numpy(),
                             s.res_eq.cpu().numpy(),
                             s.res_ineq.cpu().numpy(),
                             s.res_comp.cpu().numpy()], axis=1)
        if field in PHASE_KEYS:
            return self._phase_times()[field]
        raise ValueError(field)

    def _phase_times(self) -> dict:
        """The batch's phase times (reference ocp_nlp_timings,
        ocp_nlp_common.h:410-428): measured in the lockstep loop with
        collect_phase_times; otherwise by differencing, as
        acados_tpu/interface/batch_solver.py:371-465 takes them: the
        linearization alone and the linearization with the production
        QP path after it (the NLP warm start, regularize, then scale
        inside the QP dispatch, as the loop runs them), each the least
        of 3 synchronised runs at the last solve's iterate, scaled by
        the batch's largest iteration count (the lockstep rounds run).
        The regularization is inside the QP's time there. Cached per
        solve."""
        measured = measured_phase_times(self._stats)
        if measured is not None:
            return measured
        if self._phase_cache is not None:
            return self._phase_cache
        form, opts, dev = self.form, self.opts, self.device
        data, it = self._on_device()
        static_rows = build_static_rows(form, self.dtype, dev)
        lm = torch.tensor(opts.levenberg_marquardt, dtype=self.dtype,
                          device=dev)
        solve_qp = make_qp_solve(form, opts)

        def both():
            qp = linearize(form, static_rows, data, it, lm)
            warm = (nlp_warm_start(qp, it)
                    if opts.warm_start_first_qp_from_nlp else None)
            return solve_qp(regularize_qp(qp, opts.regularize_method,
                                          opts.reg_epsilon), warm=warm)

        t_lin, _ = timed_run(
            lambda: linearize(form, static_rows, data, it, lm), dev, reps=3)
        t_both, _ = timed_run(both, dev, reps=3)
        n_iter = (int(self._stats.sqp_iter.max())
                  if self._stats is not None else 1) or 1
        self._phase_cache = {
            "time_lin": t_lin * n_iter, "time_sim": t_lin * n_iter,
            "time_reg": 0.0, "time_qp": max(t_both - t_lin, 0.0) * n_iter,
            "time_glob": max(0.0, self._time_tot - t_both * n_iter)}
        return self._phase_cache
