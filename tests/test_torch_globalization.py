"""PyTorch port, the SQP loop's line searches (ocp_nlp/sqp.py):
MERIT_BACKTRACKING with the Armijo sufficient-descent test and with the
second-order correction, and FUNNEL_L1PEN_LINESEARCH, against jax.vmap
of the JAX package's make_sqp_solver on the pendulum ERK SQP (float64,
CPU), each through make_sqp_solver, AcadosOcpBatchSolver and
AcadosOcpSolver. The helpers here serve tests/test_torch_adaptive.py
too (Anderson, adaptive LM and QP tolerances).

Held per instance: equal status, sqp_iter, qp_iter_total (with the SOC
QPs' iterations), the stat table's QP status and iteration columns, and
its alpha column on every row where a step was taken; the iterates
within a relative gap of 1e-9. Not compared: alpha in the round where an
instance converges, whose step the reference computes and drops.

The line searches run on the pendulum with its cost weights W, W_e
scaled by 1e-3. At the pendulum's own weights the swing-up's merit is
about 3.4e3 (one rounding step 4.5e-13) while a step near the solution
is about res_stat / 2e3: below res_stat ~1e-4 the full step changes the
merit by a few rounding steps, so which alpha passes follows the order
of the merit's sums, and XLA's and PyTorch's differ (at 1e-5 the two
packages part in the last 1-2 iterations of 3 of 4 instances, at the
same KKT point; `test_merit_tail_at_rounding_level` shows that tail and
holds it to the KKT point). Scaled, the merit's changes stay hundreds
of rounding steps wide down to the 1e-6 tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acados_tpu.interface.builder import build_ocp as jax_build_ocp
from acados_tpu.interface.solver import _sqp_opts_from as jax_opts_from
from acados_tpu.models.pendulum import make_pendulum_ocp as jax_pendulum_ocp
from acados_tpu.ocp_nlp.formulation import NlpData as JNlpData
from acados_tpu.ocp_nlp.linearize import NlpIterate as JNlpIterate
from acados_tpu.ocp_nlp.sqp import make_sqp_solver as jax_make_sqp_solver
from acados_tpu_torch import AcadosOcpSolver
from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
from acados_tpu_torch.interface.solver import _sqp_opts_from
from acados_tpu_torch.models.pendulum import make_pendulum_ocp
from acados_tpu_torch.ocp_nlp.sqp import make_sqp_solver
from acados_tpu_torch.testing import rti_batch
from acados_tpu_torch.utils.convert import iterate_from_numpy

torch.set_num_threads(1)

N = 8
# the swing-up from pi, spread wide enough that the instances take
# different numbers of backtracking steps
X0S = (np.array([0.0, np.pi, 0.0, 0.0])
       + np.random.default_rng(3).normal(0.0, 0.2, (4, 4)))[:3]
FIELDS = ("x", "u", "pi", "lam_l", "lam_u", "sl", "su")


def rel_gap(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref) / (1 + np.abs(ref)), initial=0.0))


def batch_data(data: dict, x0s, nx):
    """The builder's data dict tiled over the x0s, x0 as lbx = ubx at
    stage 0 (whose box-x rows come first)."""
    out = {k: np.tile(v, (len(x0s),) + (1,) * np.ndim(v))
           for k, v in data.items()}
    out["lb_0"][:, :nx] = x0s
    out["ub_0"][:, :nx] = x0s
    return out


def zero_iterate(form, x0s) -> dict:
    """Numpy iterate of the batch: x at x0 on every stage, the rest 0."""
    B, N_, nx, nu, nc = len(x0s), form.N, form.nx, form.nu, form.nc
    z = lambda *s: np.zeros((B,) + s)
    return dict(x=np.repeat(np.asarray(x0s)[:, None], N_ + 1, axis=1),
                u=z(N_, nu), pi=z(N_, nx), lam_l=z(N_ + 1, nc),
                lam_u=z(N_ + 1, nc), sl=z(N_ + 1, nc), su=z(N_ + 1, nc))


def jax_solve(ocp, x0s, opts_update=None, data=None, init=None,
              make=jax_make_sqp_solver):
    """jax.vmap of the JAX package's make_sqp_solver (or `make`, another
    of its solver factories) on the batch of x0s (float64). Returns (data
    dict, init dict, iterate, stats), numpy."""
    form, dnp, _ = jax_build_ocp(ocp)
    opts = jax_opts_from(ocp)
    if opts_update:
        opts = opts.replace(**opts_update)
    data = batch_data(dnp, x0s, form.nx) if data is None else data
    init = zero_iterate(form, x0s) if init is None else init
    solve = jax.jit(jax.vmap(make(form, opts)))
    it, st = solve(JNlpData(**{k: jnp.asarray(v) for k, v in data.items()}),
                   JNlpIterate(**{k: jnp.asarray(v)
                                  for k, v in init.items()}))
    it = {f: np.asarray(getattr(it, f)) for f in FIELDS}
    st = {f: np.asarray(getattr(st, f)) for f in (
        "status", "sqp_iter", "qp_iter_total", "stat", "res_stat")}
    return data, init, it, st


def port_solve(ocp, data, init, opts_update=None, make=make_sqp_solver):
    """The port's make_sqp_solver (or `make`) on the same numpy data and
    iterate."""
    form, _, _ = build_ocp(ocp)
    opts = _sqp_opts_from(ocp)
    if opts_update:
        opts = opts.replace(**opts_update)
    it, st = make(form, opts)(
        data_to_torch(data, torch.float64, "cpu"),
        iterate_from_numpy(init, torch.float64, "cpu"))
    return ({f: getattr(it, f).numpy() for f in FIELDS},
            {f: getattr(st, f).numpy() for f in (
                "status", "sqp_iter", "qp_iter_total", "stat",
                "res_stat")})


def assert_same_solve(it, st, it_ref, st_ref, label, rel=1e-9,
                      fields=FIELDS):
    """Per instance: equal statuses and counts, the stat table's QP
    columns up to the last row and its alpha column on the rows where a
    step was taken, iterates within `rel`."""
    for f in ("status", "sqp_iter", "qp_iter_total"):
        np.testing.assert_array_equal(st[f], st_ref[f],
                                      err_msg=f"{label}: {f}")
    for b, n in enumerate(st_ref["sqp_iter"]):
        np.testing.assert_array_equal(
            st["stat"][b, :n + 1, 4:6], st_ref["stat"][b, :n + 1, 4:6],
            err_msg=f"{label}: QP columns of instance {b}")
        np.testing.assert_array_equal(
            st["stat"][b, :n, 6], st_ref["stat"][b, :n, 6],
            err_msg=f"{label}: alpha of instance {b}")
    for f in fields:
        gap = rel_gap(it[f], it_ref[f])
        assert gap <= rel, f"{label}: {f} {gap:.3e}"


def pendulum(make, tol=1e-6, weight=1.0, **so):
    ocp = make(N=N, dtype="float64", nlp_solver_type="SQP")
    ocp.cost.W = weight * np.asarray(ocp.cost.W)
    ocp.cost.W_e = weight * np.asarray(ocp.cost.W_e)
    for k in ("stat", "eq", "ineq", "comp"):
        setattr(ocp.solver_options, f"nlp_solver_tol_{k}", tol)
    for k, v in so.items():
        setattr(ocp.solver_options, k, v)
    return ocp


# the solver options of each variant; the line searches' with the cost
# weights scaled (see above)
LS = dict(weight=1e-3)
VARIANTS = {
    "merit_sufficient_descent": dict(
        globalization="MERIT_BACKTRACKING",
        globalization_line_search_use_sufficient_descent=True, **LS),
    "merit_soc": dict(globalization="MERIT_BACKTRACKING",
                      globalization_use_SOC=True, **LS),
    "funnel": dict(globalization="FUNNEL_L1PEN_LINESEARCH", **LS),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_globalization_matches_jax(name):
    """Each line search through make_sqp_solver, AcadosOcpBatchSolver
    and AcadosOcpSolver (the first instance) against the vmapped JAX
    solve of the same batch."""
    check_three_routes(name, VARIANTS[name])


def check_three_routes(name, so):
    """The solver options `so` through make_sqp_solver,
    AcadosOcpBatchSolver and AcadosOcpSolver (the first instance)
    against the vmapped JAX solve of the same batch."""
    data, init, it_ref, st_ref = jax_solve(
        pendulum(jax_pendulum_ocp, **so), X0S)
    assert np.all(st_ref["status"] == 0), st_ref["status"]
    it, st = port_solve(pendulum(make_pendulum_ocp, **so), data, init)
    assert_same_solve(it, st, it_ref, st_ref, f"{name} make_sqp_solver")

    batch = rti_batch(pendulum(make_pendulum_ocp, **so), X0S, "cpu")
    status = batch.solve()
    s = batch._stats
    assert_same_solve(
        {f: getattr(batch._it_dev, f).numpy() for f in FIELDS},
        {"status": status, "sqp_iter": batch.get_stats("sqp_iter"),
         "qp_iter_total": batch.get_stats("qp_iter"),
         "stat": s.stat.numpy()}, it_ref, st_ref, f"{name} batch solver")

    single = AcadosOcpSolver(pendulum(make_pendulum_ocp, **so),
                             device="cpu")
    single.constraints_set(0, "lbx", X0S[0])
    single.constraints_set(0, "ubx", X0S[0])
    for k in range(N + 1):
        single.set(k, "x", X0S[0])
    assert single.solve() == st_ref["status"][0]
    assert single.get_stats("sqp_iter") == st_ref["sqp_iter"][0]
    assert single.get_stats("qp_iter") == st_ref["qp_iter_total"][0]
    n = int(st_ref["sqp_iter"][0])
    np.testing.assert_array_equal(single.get_stats("statistics")[7, :n],
                                  st_ref["stat"][0, :n, 6])
    for k in range(N):
        assert rel_gap(single.get(k, "u"), it_ref["u"][0, k]) <= 1e-9


def test_line_searches_take_different_steps():
    """MERIT_BACKTRACKING at alpha_min = 0.6: the instances backtrack in
    different rounds, and where an instance accepts neither 1 nor 0.7
    its loop exits under alpha_min with 0.49 (the reference's alpha_bt,
    never tried) as the vmapped while_loop does."""
    ocp = lambda make: pendulum(make, globalization="MERIT_BACKTRACKING",
                                **LS)
    data, init, it_ref, st_ref = jax_solve(ocp(jax_pendulum_ocp), X0S,
                                           opts_update=dict(alpha_min=0.6))
    it, st = port_solve(ocp(make_pendulum_ocp), data, init,
                        opts_update=dict(alpha_min=0.6))
    assert_same_solve(it, st, it_ref, st_ref, "alpha_min 0.6")
    steps = [tuple(np.round(st_ref["stat"][b, :n, 6], 6))
             for b, n in enumerate(st_ref["sqp_iter"])]
    assert len(set(steps)) == len(steps), steps
    assert any(np.isclose(a, 0.49) for s_ in steps for a in s_), steps


def test_merit_tail_at_rounding_level():
    """At the pendulum's own cost weights and a 1e-5 tolerance the merit
    line search's last comparisons are between values within a few
    rounding steps of each other: both packages still stop at status 0
    on the same KKT point, within the tolerance's reach (x and u within
    1e-6, the multipliers pi, up to 1.2e3, within 1e-5 relative)."""
    so = dict(globalization="MERIT_BACKTRACKING",
              globalization_line_search_use_sufficient_descent=True,
              tol=1e-5)
    data, init, it_ref, st_ref = jax_solve(pendulum(jax_pendulum_ocp, **so),
                                           X0S)
    it, st = port_solve(pendulum(make_pendulum_ocp, **so), data, init)
    assert np.all(st_ref["status"] == 0) and np.all(st["status"] == 0)
    assert np.all(st["res_stat"] < 1e-5)
    for f, rel in (("x", 1e-6), ("u", 1e-6), ("pi", 1e-5)):
        assert rel_gap(it[f], it_ref[f]) <= rel, f
