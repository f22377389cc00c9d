"""The float32 SQP solves whose lockstep tails and unconverged instances
the PyTorch port showed on the card, through both packages on the CPU,
and MIRROR's full-width solve on the card: which per-instance iteration
counts, statuses and step lengths are the port's own.

Set-up of chip_smoke.py's phases 27 and 30 (`chip_smoke.newton_batch`,
`chip_smoke.wfqp_phase`), in float32: the pendulum (IRK GL4, N = 20),
x0 per instance = (0, pi, 0, 0) + N(0, 0.05) drawn with seed 0 (the main
path's draw; instance i of a batch of B is row i of every larger draw),
x0 as lbx = ubx at stage 0 and as the initial x at every stage, run to
the end (nlp_solver_max_iter 100). The solvers:
  - newton: EXACT Hessian, CONVEXIFY, MERIT_BACKTRACKING
    (`chip_smoke.NEWTON_SO`);
  - mirror: the same with MIRROR;
  - wfqp: SQP_WITH_FEASIBLE_QP with MERIT_BACKTRACKING.
Each package runs its own solve function on the same numpy data:
jax.jit(jax.vmap(make_sqp_solver / make_wfqp_solver)) in the JAX
package, the port's batch-first make_sqp_solver / make_wfqp_solver.

    JAX_PLATFORMS=cpu python sqp_f32_settle.py [--B 64] [--out FILE]

runs newton and wfqp at B through the port, the JAX package, and the JAX
package again on x0s moved by one float32 rounding step each (up or down
at random; two draws, seeds 1 and 2): the spread that rounding alone
gives the reference. It prints, per solver and run, the statuses,
sqp_iter's mean and max and the instances above twice the mean, then per
instance where a run parts from the JAX package's: status, sqp_iter, and
the first round whose exit alpha differs (stat column 6 on the rows
where a step was taken), and the verdict of the rule PERF.md states
before the run: the port's tail is its own where its max sqp_iter, or
its count of instances above twice its mean, exceeds the JAX package's
by more than the moved runs part from the JAX package's, or where it
leaves an instance unconverged that the JAX package converges.

    JAX_PLATFORMS=cpu python sqp_f32_settle.py --mirror I[,J...] [--B 64]

runs mirror from each instance's x0 alone (B = 1) and inside its block
of B instances of the draw (rows B * (I // B) ..), through both
packages, and prints each one's status, sqp_iter and first parting
round.

    python sqp_f32_settle.py --card [--out FILE]

needs one GPU and imports no JAX: mirror at B = 4096 through the port
on the card (chip_smoke.newton_batch), the unconverged instances with
their x0s and the sqp_iter distribution, then each unconverged instance
alone and in its block of 64 on the card.

Each mode ends with one JSON line (also written to --out). Imports both
packages on the CPU, as the tests do; the port itself imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

import chip_smoke as cs

SOLVERS = dict(
    newton=dict(nlp_solver_type="SQP", **cs.NEWTON_SO),
    mirror=dict(nlp_solver_type="SQP",
                **dict(cs.NEWTON_SO, regularize_method="MIRROR")),
    wfqp=dict(nlp_solver_type="SQP_WITH_FEASIBLE_QP",
              globalization="MERIT_BACKTRACKING"))
MAX_ITER = 100
MOVE_SEEDS = (1, 2)


def x0_draw(B, move_seed=None):
    """The main path's x0 draw; move_seed: every entry moved by one
    float32 rounding step, up or down at random."""
    rng = np.random.default_rng(cs.SEED)
    x0s = np.asarray(cs.X0_CENTER) + rng.normal(0.0, cs.X0_SIGMA, (B, 4))
    if move_seed is not None:
        step = np.random.default_rng(move_seed).choice((-1.0, 1.0),
                                                        x0s.shape)
        x0s = x0s * (1 + np.finfo(np.float32).eps * step)
    return x0s


def ocp_of(pkg, solver):
    if pkg == "jax":
        from acados_tpu.models.pendulum import make_pendulum_ocp
    else:
        from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    so = dict(SOLVERS[solver])
    ocp = make_pendulum_ocp(N=cs.N_HORIZON, dtype="float32",
                            integrator_type="IRK",
                            nlp_solver_type=so.pop("nlp_solver_type"))
    for k, v in dict(so, nlp_solver_max_iter=MAX_ITER).items():
        setattr(ocp.solver_options, k, v)
    return ocp


def batch_inputs(form, data1, x0s):
    """build_ocp's data tiled over the x0s (x0 as lbx = ubx at stage 0,
    whose box-x rows come first) and the iterate with x at x0 on every
    stage, the rest 0 (numpy, float64)."""
    B, N, nx, nu, nc = len(x0s), form.N, form.nx, form.nu, form.nc
    data = {k: np.tile(v, (B,) + (1,) * np.ndim(v)) for k, v in data1.items()}
    data["lb_0"][:, :nx] = x0s
    data["ub_0"][:, :nx] = x0s
    z = lambda *s: np.zeros((B,) + s)
    init = dict(x=np.repeat(np.asarray(x0s)[:, None], N + 1, axis=1),
                u=z(N, nu), pi=z(N, nx), lam_l=z(N + 1, nc),
                lam_u=z(N + 1, nc), sl=z(N + 1, nc), su=z(N + 1, nc))
    return data, init


def jax_run(solver, x0s):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from acados_tpu.interface.builder import build_ocp
    from acados_tpu.interface.solver import _sqp_opts_from
    from acados_tpu.ocp_nlp.formulation import NlpData
    from acados_tpu.ocp_nlp.linearize import NlpIterate
    from acados_tpu.ocp_nlp.sqp import make_sqp_solver
    from acados_tpu.ocp_nlp.wfqp import make_wfqp_solver
    ocp = ocp_of("jax", solver)
    form, data1, _ = build_ocp(ocp)
    make = make_wfqp_solver if solver == "wfqp" else make_sqp_solver
    data, init = batch_inputs(form, data1, x0s)
    solve = jax.jit(jax.vmap(make(form, _sqp_opts_from(ocp))))
    _, st = solve(NlpData(**{k: jnp.asarray(v, jnp.float32)
                             for k, v in data.items()}),
                  NlpIterate(**{k: jnp.asarray(v, jnp.float32)
                                for k, v in init.items()}))
    return stats_of(st, np.asarray)


def port_run(solver, x0s, device="cpu"):
    import torch
    from acados_tpu_torch.interface.builder import build_ocp, data_to_torch
    from acados_tpu_torch.interface.solver import _sqp_opts_from
    from acados_tpu_torch.ocp_nlp.sqp import make_sqp_solver
    from acados_tpu_torch.ocp_nlp.wfqp import make_wfqp_solver
    from acados_tpu_torch.utils.convert import iterate_from_numpy
    from acados_tpu_torch.utils.device import full_precision_matmul
    full_precision_matmul()
    ocp = ocp_of("torch", solver)
    form, data1, _ = build_ocp(ocp)
    make = make_wfqp_solver if solver == "wfqp" else make_sqp_solver
    data, init = batch_inputs(form, data1, x0s)
    _, st = make(form, _sqp_opts_from(ocp))(
        data_to_torch(data, torch.float32, device),
        iterate_from_numpy(init, torch.float32, device))
    return stats_of(st, lambda t: t.cpu().numpy())


def stats_of(st, host):
    """Per instance: status, sqp_iter, and the exit alphas of the rounds
    where it took a step (stat column 6, rows < sqp_iter)."""
    status, it = host(st.status).astype(int), host(st.sqp_iter).astype(int)
    stat = host(st.stat)
    return dict(status=status, sqp_iter=it,
                alpha=[stat[b, :n, 6] for b, n in enumerate(it)])


def summary(r):
    it = r["sqp_iter"]
    mean = float(it.mean())
    return dict(statuses={int(v): int((r["status"] == v).sum())
                          for v in np.unique(r["status"])},
                mean=mean, max=int(it.max()),
                above_2x_mean=int((it > 2 * mean).sum()),
                quantiles={q: float(np.quantile(it, float(q)))
                           for q in ("0.5", "0.9", "0.99", "1.0")})


def parting(a, b):
    """Per instance where runs a and b part: (instance, status a, b,
    sqp_iter a, b, the first round whose exit alpha differs or None)."""
    out = []
    for i in range(len(a["status"])):
        aa, ab = a["alpha"][i], b["alpha"][i]
        n = min(len(aa), len(ab))
        diff = np.flatnonzero(aa[:n] != ab[:n])
        first = int(diff[0]) if len(diff) else (
            None if len(aa) == len(ab) else n)
        if first is not None or a["status"][i] != b["status"][i]:
            out.append(dict(instance=i, status=[int(a["status"][i]),
                                                int(b["status"][i])],
                            sqp_iter=[int(a["sqp_iter"][i]),
                                      int(b["sqp_iter"][i])],
                            first_alpha_round=first))
    return out


def timed(fn, *args):
    t0 = time.perf_counter()
    r = fn(*args)
    return r, time.perf_counter() - t0


def tails(B) -> dict:
    result = {}
    for solver in ("newton", "wfqp"):
        runs = {}
        plan = [("port", port_run, x0_draw(B)), ("jax", jax_run, x0_draw(B))]
        plan += [(f"jax_moved{m}", jax_run, x0_draw(B, m))
                 for m in MOVE_SEEDS]
        for name, fn, x0s in plan:
            r, secs = timed(fn, solver, x0s)
            runs[name] = r
            s = summary(r)
            print(f"{solver} {name}: {s}; {secs:.1f} s", flush=True)
            result.setdefault(solver, {})[name] = dict(
                **s, sqp_iter=r["sqp_iter"].tolist(),
                status=r["status"].tolist(), seconds=round(secs, 1))
        for a in [name for name, _, _ in plan if name != "jax"]:
            p = parting(runs[a], runs["jax"])
            result[solver][f"{a}_vs_jax"] = p
            print(f"  {a} against jax: {len(p)} of {B} instances part: "
                  + "; ".join(f"{d['instance']} status {d['status']} "
                              f"sqp_iter {d['sqp_iter']} alpha from round "
                              f"{d['first_alpha_round']}" for d in p),
                  flush=True)
        result[solver]["verdict"] = verdict(result[solver])
        print(f"  {solver}: {result[solver]['verdict']}", flush=True)
    return result


def verdict(res) -> dict:
    """The rule stated before the run: the port's tail is its own where
    its max, or its count above twice its mean, exceeds the JAX package's
    by more than the moved runs part from the JAX package's in it, or
    where it leaves unconverged an instance the JAX package converges."""
    jax, port = res["jax"], res["port"]
    moved = [res[f"jax_moved{m}"] for m in MOVE_SEEDS]
    out = {}
    for key in ("max", "above_2x_mean"):
        spread = max(abs(m[key] - jax[key]) for m in moved)
        out[key] = dict(port=port[key], jax=jax[key], spread=spread,
                        excess=port[key] - jax[key] - spread)
    lost = [i for i, (a, b) in enumerate(zip(port["status"], jax["status"]))
            if a != 0 and b == 0]
    out["unconverged_port_only"] = lost
    out["fault"] = bool(lost) or any(out[k]["excess"] > 0
                                     for k in ("max", "above_2x_mean"))
    return out


def mirror(instances, B) -> dict:
    result = {}
    for i in instances:
        block = B * (i // B)
        x0s = x0_draw(block + B)
        for label, rows in (("alone", [i]),
                            (f"block {block}..{block + B - 1}",
                             list(range(block, block + B)))):
            runs = {}
            for name, fn in (("port", port_run), ("jax", jax_run)):
                r, secs = timed(fn, "mirror", x0s[rows])
                runs[name] = r
                k = rows.index(i)
                print(f"mirror instance {i} {label} {name}: status "
                      f"{r['status'][k]} sqp_iter {r['sqp_iter'][k]}; "
                      f"batch {summary(r)}; {secs:.1f} s", flush=True)
                result.setdefault(str(i), {}).setdefault(label, {})[name] = \
                    dict(status=int(r["status"][k]),
                         sqp_iter=int(r["sqp_iter"][k]),
                         alpha=r["alpha"][k].tolist(), batch=summary(r),
                         seconds=round(secs, 1))
            p = parting(runs["port"], runs["jax"])
            result[str(i)][label]["port_vs_jax"] = p
            print(f"  port against jax: {len(p)} of {len(rows)} part: "
                  + "; ".join(f"{d['instance']} status {d['status']} "
                              f"sqp_iter {d['sqp_iter']} alpha from round "
                              f"{d['first_alpha_round']}" for d in p),
                  flush=True)
    return result


def card() -> dict:
    import torch
    from acados_tpu_torch.utils.device import full_precision_matmul
    full_precision_matmul()
    dev = torch.device("cuda")
    out = dict(card=cs.card_line(), device=torch.cuda.get_device_name(0))
    print(f"card: {out['card']}", flush=True)
    solver = cs.newton_batch(cs.B_MAIN, "float32", dev, solver_options=dict(
        cs.NEWTON_SO, regularize_method="MIRROR",
        nlp_solver_max_iter=MAX_ITER))
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r = stats_of(solver._stats, lambda t: t.cpu().numpy())
    bad = np.flatnonzero(r["status"] != 0).tolist()
    x0s = x0_draw(cs.B_MAIN)
    out["B4096"] = dict(summary(r), seconds=secs, unconverged=bad,
                        x0={str(i): x0s[i].tolist() for i in bad},
                        sqp_iter={str(i): int(r["sqp_iter"][i])
                                  for i in bad})
    print(f"mirror B={cs.B_MAIN} on the card: {summary(r)}; unconverged "
          f"{bad}, x0 {out['B4096']['x0']}; {secs:.1f} s", flush=True)
    for i in bad:
        block = 64 * (i // 64)
        for label, rows in (("alone", [i]), (f"block {block}..{block + 63}",
                                             list(range(block, block + 64)))):
            t0 = time.perf_counter()
            rr = port_run("mirror", x0s[rows], dev)
            k = rows.index(i)
            out.setdefault(str(i), {})[label] = dict(
                status=int(rr["status"][k]), sqp_iter=int(rr["sqp_iter"][k]),
                alpha=rr["alpha"][k].tolist(), batch=summary(rr),
                seconds=time.perf_counter() - t0)
            print(f"mirror instance {i} {label} on the card: status "
                  f"{rr['status'][k]} sqp_iter {rr['sqp_iter'][k]}; batch "
                  f"{summary(rr)}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--mirror", default=None)
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.card:
        result = card()
    elif args.mirror:
        result = mirror([int(i) for i in args.mirror.split(",")], args.B)
    else:
        result = tails(args.B)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
