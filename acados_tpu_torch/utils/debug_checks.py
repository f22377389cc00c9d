"""Developer debug checks (reference ACADOS_DEVELOPER_DEBUG_CHECKS).

Copy of `acados_tpu/utils/debug_checks.py`: the reference gates extra
sanity assertions behind a CMake flag (CMakeLists.txt:81); here the
PROBLEM DATA is validated on the host before a solve, with numpy on the
solver's data dict and iterate: finite values, bound ordering, weight
symmetry, slack penalty and multiplier signs. Enabled per solver by
`solver_options.with_debug_checks = True` or for every solver by the
environment variable ACADOS_TPU_DEBUG_CHECKS=1.

A failed check raises `AcadosDebugCheckError` naming the field and the
rows: the failure the unchecked solve would show as a NaN status or a
wrong trajectory.
"""
from __future__ import annotations

import os

import numpy as np


class AcadosDebugCheckError(AssertionError):
    pass


def debug_checks_enabled(solver_options=None) -> bool:
    if os.environ.get("ACADOS_TPU_DEBUG_CHECKS", "0") not in ("0", ""):
        return True
    return bool(getattr(solver_options, "with_debug_checks", False))


def _fail(msg):
    raise AcadosDebugCheckError(msg)


def _finite(name, a):
    a = np.asarray(a)
    if not np.all(np.isfinite(a)):
        bad = np.argwhere(~np.isfinite(a))[:3]
        _fail(f"debug check: non-finite values in {name} at indices "
              f"{bad.tolist()}")


def check_nlp_data(data: dict, x0_elim_nx: int = 0) -> None:
    """Validate the runtime data dict before a solve.

    x0_elim_nx > 0: initial-state elimination is active, so the first
    x0_elim_nx stage-0 rows must be equalities (lb_0 == ub_0): the
    eliminated path pins x0 to lb_0 and would solve another problem
    otherwise."""
    if x0_elim_nx > 0 and "lb_0" in data and "ub_0" in data:
        l0 = np.asarray(data["lb_0"])[..., :x0_elim_nx]
        u0 = np.asarray(data["ub_0"])[..., :x0_elim_nx]
        if not np.array_equal(l0, u0):
            _fail("debug check: x0 elimination active but lb_0 != ub_0 "
                  "on the state rows — set eliminate_x0=False or keep "
                  "the initial-state rows an equality")
    for name in ("W", "yref", "p", "ts", "dts", "cost_scale",
                 "Zl", "Zu", "zl", "zu"):
        if name in data and data[name] is not None:
            _finite(name, data[name])
    inf_thr = 0.5e10
    for lo, hi in (("lb_0", "ub_0"), ("lb", "ub"), ("lb_e", "ub_e")):
        if lo not in data or hi not in data:
            continue
        l = np.asarray(data[lo])
        u = np.asarray(data[hi])
        # only rows with both sides present take part in the ordering
        both = (l > -inf_thr) & (u < inf_thr)
        if np.any(both & (l > u)):
            bad = np.argwhere(both & (l > u))[:3]
            _fail(f"debug check: {lo} > {hi} at rows {bad.tolist()} "
                  f"(an empty box makes the QP infeasible by "
                  f"construction)")
    if "dts" in data and np.any(np.asarray(data["dts"]) <= 0):
        _fail("debug check: non-positive interval length in dts")
    for name in ("Zl", "Zu"):
        if name in data and data[name] is not None \
                and np.any(np.asarray(data[name]) < 0):
            _fail(f"debug check: negative quadratic slack penalty {name}")
    if "W" in data and data["W"] is not None:
        W = np.asarray(data["W"])
        if W.ndim >= 2 and W.shape[-1] == W.shape[-2]:
            if not np.allclose(W, np.swapaxes(W, -1, -2),
                               rtol=1e-6, atol=1e-9):
                _fail("debug check: cost weight W is not symmetric")


def check_iterate(it_dict: dict) -> None:
    """Validate an iterate (warm start or a solution handed over)."""
    for name, a in it_dict.items():
        _finite(f"iterate.{name}", a)
    for name in ("lam_l", "lam_u", "sl", "su"):
        if name in it_dict and np.any(np.asarray(it_dict[name]) < 0):
            _fail(f"debug check: negative multiplier/slack in "
                  f"iterate.{name}")
