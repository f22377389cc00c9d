"""AcadosOcpBatchSolver: N_batch solves as one batch-first solve.

Counterpart of `acados_tpu/interface/batch_solver.py` (API mirror of the
reference batch solver) on a single device: the batch is the leading
axis of every tensor of one lockstep SQP solve, where the JAX package
vmaps and shards it.

The data and the iterate stay on the device between solves, so a warm
RTI loop moves nothing to the host but the statuses; the per-instance
views `ocp_solvers[i].get/set` work on a host copy that is moved across
only when it changed. `prepare`/`feedback` and the sensitivities wait
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

import time

import numpy as np

from acados_tpu_torch.interface.acados_ocp import AcadosOcp
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.interface.solver import (_bound_slot, _sqp_opts_from,
                                               _torch_dtype, iterate_to_numpy,
                                               iterate_to_torch)
from acados_tpu_torch.ocp_nlp.sqp import make_sqp_solver
from acados_tpu_torch.utils.device import (full_precision_matmul,
                                           resolve_device)


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
        raise ValueError(field)

    def get_status(self):
        st = self._p._status
        return None if st is None else int(st[self._i])


class AcadosOcpBatchSolver:
    """Batch of N_batch identical-structure OCPs solved as one batch;
    `device` None means "cuda"."""

    def __init__(self, ocp: AcadosOcp, N_batch: int,
                 num_threads_in_batch_solve=None, json_file=None,
                 build=None, generate=None, verbose=False, device=None):
        del num_threads_in_batch_solve, json_file, build, generate, verbose
        self.device = resolve_device(device)
        full_precision_matmul()
        self.acados_ocp = ocp
        self.N_batch = N_batch
        self.form, data1, self.layouts = build_ocp(ocp)
        self.opts = _sqp_opts_from(ocp)
        self.dtype = _torch_dtype(ocp)
        self.N = self.form.N
        self._solve_fn = make_sqp_solver(self.form, self.opts)
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
        self._time_tot = float("nan")

    def _layout(self, stage):
        return self.layouts["0" if stage == 0
                            else ("e" if stage == self.N else "p")]

    def _host_iterate(self) -> dict:
        if self._host_stale:
            self._iterate = iterate_to_numpy(self._it_dev)
            self._host_stale = False
        return self._iterate

    def solve(self, n_batch=None):
        """Solve all instances; returns the (N_batch,) statuses."""
        del n_batch
        t0 = time.perf_counter()
        if self._data_dev is None:
            self._data_dev = data_to_torch(self._data, self.dtype,
                                           self.device)
        if self._it_dev is None:
            self._it_dev = iterate_to_torch(self._host_iterate(),
                                            self.dtype, self.device)
        it, stats = self._solve_fn(self._data_dev, self._it_dev)
        self._status = stats.status.cpu().numpy()  # waits for the card
        self._time_tot = time.perf_counter() - t0
        self._it_dev = it
        self._host_stale = True
        self._stats = stats
        return self._status

    def get_stats(self, field):
        if field == "time_tot":
            return self._time_tot
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
        raise ValueError(field)
