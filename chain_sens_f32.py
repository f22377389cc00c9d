"""The chain's float32 solution sensitivities through both packages on the
CPU: which instances come back non-finite in the JAX package and which in
the PyTorch port.

Set-up of chip_smoke.py's phase 21 (`chip_smoke.chain_batch`), in float32:
the chain at n_mass = 8 (nx = 39), N = 40, x0 per instance = rest state +
N(0, 0.02) drawn with seed 0, each package's AcadosOcpBatchSolver set up
as bench.py's _build_rti does (x0 as lbx = ubx at stage 0 and as the
initial x at every stage), 1 + 5 RTI solve() calls, then the forward
sensitivities of every stage to the initial state and the adjoint seeded
with ones on u_0 (chip_smoke.consistency). On the CPU the JAX package
factors P_0 with jnp.linalg.cholesky, the port with K2's plain version.

    JAX_PLATFORMS=cpu python chain_sens_f32.py [--B 256] [--out FILE]

prints, per package, the statuses after the solves, the instances whose
forward or adjoint sensitivities hold a non-finite entry and those whose
Riccati factors (Luu, P_0's) came back NaN, then one JSON line with both
sets and, for every instance non-finite in either package, how near
singular its Riccati matrices are in each: lambda_min / lambda_max of
P_0 (+ the factor's reg_eps I) and the least over the stages of that of
Huu_k = Luu_k Luu_k' (eigenvalues in float64 of the float32 matrices),
beside the same ratios of the port's float64 solve from the same x0s
(`ref64`), the instances' place among all B by them, and the quantiles
of the ratios over the batch. Imports both packages, as the tests do; the port
itself imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_MASS, N_CHAIN, CHAIN_SIGMA, SEED, RTI_CALLS = 8, 40, 0.02, 0, 1 + 5
REG_EPS = 1e-11   # SensOpts.reg_eps of both packages


def x0_draw(xrest, B):
    rng = np.random.default_rng(SEED)
    return xrest + rng.normal(0.0, CHAIN_SIGMA, (B, len(xrest)))


def set_up(solver, x0s):
    for i, view in enumerate(solver.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(N_CHAIN + 1):
            view.set(k, "x", x0s[i])


def nonfinite(*arrays):
    """Instances with a non-finite entry in any of the (B, ...) arrays."""
    bad = np.zeros(len(arrays[0]), bool)
    for a in arrays:
        bad |= ~np.isfinite(np.asarray(a).reshape(len(a), -1)).all(1)
    return sorted(np.flatnonzero(bad).tolist())


def jax_run(B):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from acados_tpu import AcadosOcpBatchSolver
    from acados_tpu.models.chain_mass import make_chain_mass_ocp
    ocp, xrest = make_chain_mass_ocp(n_mass=N_MASS, N=N_CHAIN,
                                     dtype="float32")
    solver = AcadosOcpBatchSolver(ocp, N_batch=B)
    set_up(solver, x0_draw(xrest, B))
    for _ in range(RTI_CALLS):
        st = np.asarray(solver.solve())
    sx, su = solver.eval_solution_sensitivity(list(range(N_CHAIN + 1)),
                                              "initial_state")
    nu = solver.form.nu
    sx_seed = np.zeros((B, N_CHAIN + 1, solver.form.nx))
    su_seed = np.zeros((B, N_CHAIN, nu))
    su_seed[:, 0] = 1.0
    grad = solver.eval_adjoint_solution_sensitivity(
        sx_seed, su_seed, with_respect_to="all")
    lay = solver._layout(0)
    adj = np.asarray(grad.lb_0 + grad.ub_0)[:, lay.off_bx:lay.off_bx
                                             + lay.nbx]
    import jax.numpy as jnp
    from acados_tpu.interface.builder import data_to_jax
    from acados_tpu.ocp_nlp.linearize import NlpIterate
    from acados_tpu.ocp_nlp.sensitivity import KktFactor, SensOpts

    def factor(data1, it1):
        f = KktFactor(solver.form, SensOpts(), data1, it1).fact
        return f.P[0], f.Luu, f.LP0

    it = NlpIterate(**{k: jnp.asarray(v, jnp.float32)
                       for k, v in solver._iterate.items()})
    P0, Luu, LP0 = jax.jit(jax.vmap(factor))(
        data_to_jax(solver._data, jnp.float32), it)
    return dict(st=st, sx=sx, su=su, adj=adj, P0=np.asarray(P0),
                Luu=np.asarray(Luu), luu_nan=nonfinite(np.asarray(Luu)),
                p0_nan=nonfinite(np.asarray(LP0)))


def port_run(B, dtype="float32"):
    from acados_tpu_torch.models.chain_mass import make_chain_mass_ocp
    from acados_tpu_torch.testing import rti_batch
    ocp, xrest = make_chain_mass_ocp(n_mass=N_MASS, N=N_CHAIN, dtype=dtype)
    solver = rti_batch(ocp, x0_draw(xrest, B), "cpu")
    for _ in range(RTI_CALLS):
        st = np.asarray(solver.solve())
    sx, su = solver.eval_solution_sensitivity(list(range(N_CHAIN + 1)),
                                              "initial_state")
    adj = solver.eval_adjoint_solution_sensitivity(
        None, [(0, np.ones((B, solver.form.nu)))],
        with_respect_to="initial_state")
    fact = solver._kkt_factor().fact
    return dict(st=st, sx=sx, su=su, adj=adj,
                P0=fact.P[:, 0].cpu().numpy(), Luu=fact.Luu.cpu().numpy(),
                luu_nan=nonfinite(fact.Luu.cpu().numpy()),
                p0_nan=nonfinite(fact.LP0.cpu().numpy()))


def near_singular(P0):
    """lambda_min / lambda_max of each P_0 + REG_EPS I, in float64 (NaN
    where P_0 itself is not finite)."""
    P = P0.astype(np.float64) + REG_EPS * np.eye(P0.shape[-1])
    out = np.full(len(P), np.nan)
    fin = np.isfinite(P).reshape(len(P), -1).all(1)
    ev = np.linalg.eigvalsh(P[fin])
    out[fin] = ev[:, 0] / ev[:, -1]
    return out


def huu_near_singular(Luu):
    """min over the stages of lambda_min / lambda_max of Huu_k = Luu_k
    Luu_k' (the factored matrix, eigenvalues in float64; NaN where a
    factor is not finite)."""
    Lf = Luu.astype(np.float64)
    out = np.full(len(Lf), np.nan)
    fin = np.isfinite(Lf).reshape(len(Lf), -1).all(1)
    Hf = Lf[fin] @ np.swapaxes(Lf[fin], -1, -2)
    ev = np.linalg.eigvalsh(Hf)
    out[fin] = (ev[..., 0] / ev[..., -1]).min(axis=1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = dict(B=args.B, n_mass=N_MASS, N=N_CHAIN, dtype="float32",
                  rti_calls=RTI_CALLS)
    ratios, huu = {}, {}
    for name, run in (("port", port_run), ("jax", jax_run),
                      ("ref64", lambda B: port_run(B, "float64"))):
        t0 = time.perf_counter()
        r = run(args.B)
        secs = time.perf_counter() - t0
        ratios[name] = near_singular(r["P0"])
        huu[name] = huu_near_singular(r["Luu"])
        fwd = nonfinite(r["sx"], r["su"])
        back = nonfinite(r["adj"])
        both = sorted(set(fwd) | set(back))
        st = np.asarray(r["st"])
        result[name] = dict(
            statuses={int(v): int((st == v).sum()) for v in np.unique(st)},
            nonfinite=both, nonfinite_forward=fwd, nonfinite_adjoint=back,
            luu_nan=r["luu_nan"], p0_nan=r["p0_nan"],
            p0_nonfinite=nonfinite(r["P0"]), seconds=round(secs, 1))
        print(f"{name}: statuses {result[name]['statuses']}; non-finite "
              f"sensitivities in {len(both)} of {args.B} instances "
              f"(forward {len(fwd)}, adjoint {len(back)}): {both}; NaN "
              f"factors: Luu {r['luu_nan']}, P_0 {r['p0_nan']}; P_0 "
              f"itself non-finite: {result[name]['p0_nonfinite']}; "
              f"{secs:.1f} s", flush=True)
    result["port_only"] = sorted(set(result["port"]["nonfinite"])
                                 - set(result["jax"]["nonfinite"]))
    result["jax_only"] = sorted(set(result["jax"]["nonfinite"])
                                - set(result["port"]["nonfinite"]))
    union = sorted(set(result["port"]["nonfinite"])
                   | set(result["jax"]["nonfinite"]))
    result["p0_lambda_ratio"] = {
        int(i): {name: float(r[i]) for name, r in ratios.items()}
        | {"rank_ref64": int((ratios["ref64"] < ratios["ref64"][i]).sum())}
        for i in union}
    result["huu_lambda_ratio"] = {
        int(i): {name: float(r[i]) for name, r in huu.items()}
        | {"rank_ref64": int((huu["ref64"] < huu["ref64"][i]).sum())}
        for i in union}
    result["huu_lambda_ratio_quantiles"] = {
        name: {q: float(np.quantile(r[np.isfinite(r)], float(q)))
               for q in ("0.0", "0.01", "0.05", "0.5", "1.0")}
        for name, r in huu.items()}
    result["p0_lambda_ratio_quantiles"] = {
        name: {q: float(np.quantile(r[np.isfinite(r)], float(q)))
               for q in ("0.0", "0.01", "0.05", "0.5", "1.0")}
        for name, r in ratios.items()}
    for key in ("huu_lambda_ratio", "p0_lambda_ratio"):
        for i, row in result[key].items():
            print(f"  instance {i}: {key} "
                  + ", ".join(f"{k} {v:.3e}" if isinstance(v, float)
                              else f"{k} {v}" for k, v in row.items()))
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
