#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, in order; any
failure exits non-zero:
 1. device: the card's name and power limit (nvidia-smi), torch/CUDA
    versions, TF32 off;
 2. build: every CUDA kernel of acados_tpu_torch/csrc/ with nvcc for
    sm_90a (one nvcc per source, all started together);
 3. kernels against their plain PyTorch versions on the card: first
    the route K1's dispatcher takes at every n = 1..48 (k1_routes: the
    group branch at every n = 2..16, padded to the next power of two
    below 16 but at 2, 4, 8; the warp branch at n = 1 and 17..48),
    held to the design; then the Gauss-Jordan inverse K1 on the IRK
    stage Jacobians of the main path
    (81,920 x 16 x 16 float32), on seeded diagonally dominant batches
    (n = 2, 4, 8, 16 for its group branch, n = 9, 21, 29, 39, 48, a
    ragged batch size, n = 56 through the Schur path), on
    the same with rows permuted (row swaps at most steps), in float32 and
    float64, on matrices with equal magnitudes in their pivot columns,
    where exact arithmetic makes kernel, plain version and exact inverse
    agree bit for bit only under the lowest-index tie rule, at every
    n = 3..15 (the padded orders among them) on all three kinds of batch
    in both layouts (k1_padded_batches), and on the
    edge cases of both branches (every n = 1..48 at B = 7; B = 1, 2, 3,
    33 at n = 9, 29, 39, 48; B = 1, 2, 3, 33, 65, 1023 at n = 2, 3, 4, 7,
    8, 9, 15, 16; n = 2, 3, 16 at B = 200,003; a misaligned input at
    n = 2, 9 and 16),
    and the same edge cases (n = 16 alone at B = 200,003) as transposed
    views, the layout in which the IRK hands K1 its stage Jacobians, each
    bit for bit the kernel on the view's contiguous copy; linsolve on the
    card launching K1 for small n too; then K1's time at
    the main-path shape beside its bound, the plain version and
    torch.linalg.inv, and over the group branch's grid (every n = 2..16
    at B = 81920 float32, (81920, 16, 16) float64; k1_compare.py times
    the warp branch's cells) beside the branches they replaced;
 4. main path: AcadosOcpBatchSolver on the canonical pendulum IRK SQP-RTI
    config (N = 20, float32) at B = 4096, 1 cold + 10 warm + 3 timed
    solve() calls (cut from 6); every status 0, the float32 tolerances
    met, and exactly
    8 kernel launches per RTI call; then where the time of a call goes
    (layers on the host clock, device busy share from torch.profiler);
 5. reference check: the same config in float64 at B = 8 on the card and
    on the CPU (the port's plain path, which the CPU tests hold against
    the JAX package) must agree;
 6. full-condensing path: the same config with qp_solver =
    "FULL_CONDENSING_HPIPM" (full condensing, then the dense IPM, whose
    barrier Hessian is factored by the Cholesky kernel K2 once per
    lockstep round) at B = 4096 float32, 1 cold + 10 warm + 3 timed calls
    (cut from 6);
    every status 0, in tolerance, K1 at 8 launches per call and K2 at the
    sum over calls of the batch's largest qp_iter; then where the time
    goes (linearize, condense, dense IPM, expand);
 7. the Cholesky kernels K2 (factor), K3 (solve) and K4 (fused) against
    their plain versions: the barrier Hessians captured from phase 6's
    first dense-IPM round (4096 x 24 x 24), seeded SPD batches at n = 1,
    4, 13, 24, 39, 64 with a ragged B = 1001, in float32 and float64, and
    a batch mixing SPD with indefinite and non-finite matrices, which
    must come back NaN throughout; K2, K3 and K4 bit for bit (NaN in the
    same matrices), float32 and float64, on the barrier Hessians, every
    n = 1..32 at B = 7, B = 1, 2, 3, 5, 33, 1023 at n = 4, 8, 16, 24, 32,
    B = 200,003 at n = 4 and 24, misaligned inputs at n = 24 and 13, and
    the indefinite and non-finite batches at n = 4, 13, 24 with a bad
    matrix in every group position (K3 also on factors with NaN and inf
    above the diagonal and with a zero or NaN diagonal); then their times
    at (4096, 24, 24) float32 beside their bounds, the plain versions and
    the library's Cholesky calls (CUDA events around one call, and the
    device time of the call's kernels), beside the replaced kernels'
    figures (the grids over n and B went: k2_compare.py times them);
 8. the public ops entry points (chol_factor_batched, chol_solve_batched,
    chol_factor_solve_batched: K3 and K4 have no solver caller) on the
    barrier Hessians of phase 6 in float64, one launch each, against the
    plain fused version;
 9. reference check of the full-condensing path: float64, B = 8, card
    against CPU;
10. the Riccati IPM with a free initial state at nx = 16 (P_0 factored by
    K2, one launch a round), float64, card against CPU; with K2 on that
    run's P_0 against its plain version, the same solve on the card with
    the plain version in K2's place, and the CPU's own spread on inputs
    moved by one rounding step, beside it;
11. chain path: AcadosOcpBatchSolver on make_chain_mass_ocp(n_mass=8,
    N=40) (nx = 39, nu = 3, the Kronecker IRK path) in float32 at B = 256,
    x0 = steady state + N(0, 0.02), 1 cold + 10 warm + 3 timed calls (cut
    from 6); every
    status 0, bench.py's chain tolerances met, K1 exactly 2 launches a call
    of (10240, 39, 39), K2 and K5 none; K1 on the captured block
    determinants against its plain version, and its time there; then
    where the time of a call goes;
12. chain sweep: n_mass = 3, 4, 5, 11 (nx = 9, 15, 21, 57) at B = 256,
    N = 40, 1 cold + 3 warm calls (cut from 10); every status 0 and in
    tolerance, K1 at 2 launches a call (4 at nx = 57: two n = 29
    inverses of the Schur recursion per determinant), its route at each
    shape logged (the padded group branch at nx = 9 and 15);
13. the small-matrix product K5 against its plain version, bit for bit:
    on phase 11's dynamics Jacobians (A @ A at (10240, 39, 39)), on seeded
    batches at n = 1, 20, 39, 48, 64 with B = 1001 in float32 and float64,
    on a batch with NaN and infinite entries, and on the edge cases of its
    pair groups and padded tiles (n = 1, 7, 39, 40, 64 at B = 1, 2, 3, 5,
    1023, and n = 1, 7 at B = 200,003); then its device time beside
    torch.bmm's and the bound over the microbenchmark's grid (n = 20, 39,
    48, 64 x B = 256 ... 10240), and at the chain's shape in float64;
14. chain reference check: float64, n_mass = 8, N = 40, B = 4, 3 RTI
    calls, card against CPU, beside the CPU's own spread under one
    rounding step of the x0s;
15. the quadrotor (N = 20) and race car (N = 30, Tf = 0.6) ERK RTI batches
    at B = 1024, x0 spreads 0.05 and 0.01, 1 cold + 6 warm + 1 timed
    calls (cut from 9 warm); every
    status 0, within stat 5e-3 and eq 1e-4, no kernel launches;
16. RTI phases on the main path's config (pendulum IRK, N = 20, float32,
    B = 4096) from phase 4's converged iterate: 1 + 2 warm + 2 timed
    (cut from 11 warm cycles from the swing-up and 8 timed, for time)
    prepare() / feedback(x0) cycles at STANDARD; every status 0 and in tolerance, K1 exactly 8
    launches in each prepare() and none in each feedback(); the medians
    of time_preparation and time_feedback beside the solve() call's;
17. long-horizon pendulum (bench.py's bench_long_horizon_rti, plain,
    cond_N16 and parallel_riccati): make_pendulum_ocp(N=128, Tf=1.0),
    ERK, SQP_RTI, float32, B = 1024, x0 = [0, pi, 0, 0] + N(0, 0.02),
    the three variants in one process: 1 cold + 10 warm calls of the
    plain one (bench.py warms 25 a variant: cut for the plain variant's
    seconds a call), the other two from its iterate with 1 warm call
    each, then 1 round of 1 timed call (cut from 2); every status 0,
    within stat 1e-1 and eq 1e-4 (bench.py's _LONGH_TOLS); no kernel
    launches in plain and cond_N16 (nu = 1, condensed nu = 8 <= 12), and
    in parallel_riccati K1 exactly 13 launches a lockstep IPM round (one a
    non-empty combine of the associative scan over 129 stages); for
    each: solves/s, median call with p10/p90, Riccati stages a sweep (or
    combine levels a factor; the time split and the parallel variant's
    profile were dropped for time); then K1 on the
    largest combine, (65536, 4, 4) captured in the parallel variant's
    first timed call, against its plain version (the bits that differ
    counted), and its times there;
18. chain at qp_solver_cond_N = 8 (n_mass = 8, N = 40, B = 256,
    float32; blocks of M = 5, condensed nu = 15 > 12, so each condensed
    stage's Huu goes through K2): 1 cold + 10 warm calls, then 2
    interleaved rounds of 2 timed calls (cut from 3 of 4) beside phase
    11's plain chain;
    every status 0 and in tolerance, K1 2 launches a call, K2 exactly 8
    a lockstep IPM round (8 stages x 1 factorization x the rounds), K2 on
    the captured (256, 15, 15) Huu batches of the cold call's first round
    bit for bit against chol_factor_plain, and its time there;
19. float64 card against CPU of the new paths: the long-horizon
    pendulum at cond_N = 16 (B = 4), the chain at cond_N = 8 (B = 4) and
    the main path's config (B = 8) in prepare() / feedback() cycles, 1
    call or cycle each (cut from 3), each within 1e-9;
20. the batch simulator (AcadosSimBatchSolver) with the main path's
    integrator (pendulum, IRK Gauss-Legendre 4 stages, 2 substeps,
    dt = Tf / N = 0.05) at B = 4096 float32 with sens_forw, and RK4
    beside it: 3 warm + 5 timed calls (cut from 10), median (p10, p90),
    sims/s, K1
    exactly 8 launches a call (3 Newton inverses and 1 tangent solve a
    substep), none for RK4; K1 on one captured stage-Jacobian batch
    against its plain version (the bits that differ counted, the error
    bounded), and its times there;
21. the batched sensitivities: bench.py's bench_pendulum_irk_sqp config
    (SQP, IRK, N = 20, float32, B = 4096), its Gauss-Newton solve: every
    status 0 and in tolerance in one call from the initial iterate,
    then eval_solution_sensitivity (every stage, initial_state) and
    eval_adjoint_solution_sensitivity seeded on u_0: K1 exactly 44 + 8
    launches, the forward-adjoint gap of every instance within 10 x the
    JAX package's float32 gap, dx_0/dx0 = I (the layer's time split was
    dropped for time); then the chain (n_mass = 8, N = 40, B = 256,
    float64, after 6 RTI calls): K1 60 + 2 launches, K2 exactly 1 (P_0,
    (256, 39, 39)), K2 bit for bit against its plain version on the captured P_0 (float64
    and float32), and its times beside torch.linalg.cholesky_ex;
22. the differentiable solver: make_diff_solver on the parametric
    pendulum (ERK, float64, B = 1024), the gradient of 0.5 |u_0|^2 with
    respect to every stage's p through its backward against
    eval_adjoint_solution_sensitivity within 1e-9, no kernel launch;
23. float64 card against CPU of phases 20-22 at B = 4: the simulator's
    xn, S_forw, S_adj, S_hess (IRK and RK4), the forward and adjoint
    sensitivities and the differentiable solver's gradient within 1e-9;
    the chain's sensitivities (B = 4) within the CPU's own spread on x0s
    moved by one rounding step, where that exceeds 1e-9;
24. latency (bench.py's bench_latency): phase 17's three variants at
    B = 8 (cond_N = 32), the plain one from phase 17's warm iterate (its
    first 8 instances share these x0s) with 1 call (1 cold + 10 warm
    from the swing-up before that; bench.py warms 25 a variant), the
    others from its iterate with 1 warm call each, then 1 round of 1
    timed call (cut from 2); the call with
    p10/p90, every status 0, _LONGH_TOLS met, K1 only in
    parallel_riccati, 13 a lockstep IPM round;
25. the ADMM QP backend (bench.py's bench_admm_backend): the pendulum
    ERK SQP-RTI, N = 20, float32, B = 4096, x0 spread 0.05, the Riccati
    IPM beside qp_solver_name="ADMM": the IPM 1 cold + 10 warm calls (cut
    from 15),
    ADMM 1 + 3 calls from the IPM's iterate after its 6th call (not yet
    in tolerance: ADMM's own steps bring the batch there), then 2
    interleaved rounds of 1 timed call (at 1 the last ADMM call was out
    of tolerance; bench.py: 15 warm calls each, 3
    rounds of 10; an ADMM call runs up to 500 lockstep iterations);
    every status 0, the OCP's nlp tolerances (stat, eq) met, no launch
    of the repo's kernels; solves/s, the largest ADMM iteration count a
    call, ADMM's residual maxima call by call;
26. float64 card against CPU of the QP-breadth paths, each within 1e-9:
    the long horizon with parallel_riccati, the main path's config with
    abs_form and the ADMM RTI batch (B = 8, 1 RTI call each, cut from 3
    for the first two and from 2 for ADMM), and
    AcadosOcpQpSolver on a random QP (N = 20, x0 free) with the Riccati
    IPM, ADMM and ADMM through partial condensing (cond_N = 4), with its
    forward and adjoint sensitivities;
27. the Newton SQP at full width: bench_pendulum_irk_sqp's problem (SQP,
    IRK, N = 20, float32, B = 4096, the main path's x0s) with
    hessian_approx EXACT, CONVEXIFY and MERIT_BACKTRACKING (MIRROR's
    solve takes over 100 lockstep rounds there, see NEWTON_SO; its
    Gauss-Newton solve is phase 21's): one EXACT linearization first (K1
    exactly K1_PER_EXACT_LINEARIZE = 22 launches; a round's time split
    was dropped for time), then the EXACT call from the initial
    iterate, cut at
    NEWTON_ROUNDS lockstep rounds (nothing compiles in the port: a first
    call is timed like any other), its statuses converged or at the cut
    and finite; its K1 launches equal to those worked out from its stat
    table (newton_k1_expected: 22 a round, 6 a dynamics gap of the
    merit); sqp_iter mean and max; K1 on
    the largest launch of the EXACT linearization against its plain
    version, and its times there;
28. float64 card against CPU of the new options, B = 4, each solve cut
    at 2 iterations (cut from 4): the Newton SQP of phase 27 (2
    iterations),
    EXACT with each of the five
    regularizations on the nonconvex EXTERNAL-cost double integrator,
    MERIT with sufficient descent and with SOC, FUNNEL, FIXED_STEP with
    Anderson, adaptive LM, ADAPTIVE_CURRENT_RES_JOINT and a CONL-cost
    pendulum, each within 1e-9.
29. DDP at full width (B = 4096, N = 20, float32, the main path's x0s):
    tests/test_ddp.py's unconstrained pendulum with ERK, DDP_ERK_ROUNDS
    lockstep rounds (statuses converged, at max_iter or at a vanishing
    step: DDP cycles from about half these x0s in both packages;
    every res_eq within 1e-4, the converged in tolerance), and with the
    main path's IRK cut at DDP_CUT_ITER iterations: K1 launches equal to
    ddp_k1_expected from its stat table, K1 on the rollout's (4096, 16,
    16) launch against its plain version;
30. SQP_WITH_FEASIBLE_QP at full width: the main path's pendulum with
    MERIT_BACKTRACKING cut at WFQP_ROUNDS rounds (K1 equal to
    wfqp_k1_expected, the converged instances in tolerance, both QPs'
    iterations), and the obstacle as BGP rows from the zero iterate,
    where plain SQP fails on every instance and WFQP converges with
    every node outside the disc;
31. the main path with cost_discretization INTEGRATOR beside EULER from
    the main path's converged iterate, interleaved (1 + 1 warm, 2
    rounds of 1): every status 0 and in tolerance, K1
    K1_PER_INTEGRATOR_RTI = 48 a call, K1 on the path stage points'
    (77,824, 16, 16) launch against its plain version;
32. float64 card against CPU, B = 4, within 1e-9: DDP on ERK and IRK,
    WFQP on the pendulum and on the obstacle as BGH, BGP and soft BGP
    rows, and the INTEGRATOR cost with IRK NONLINEAR_LS, IRK CONL, ERK
    NONLINEAR_LS and ERK EXTERNAL.
33. the DAE cart (tests/test_dae_nlp.py: nx 2, nz 1, IRK GL3, 2
    substeps, z in the NONLINEAR_LS cost and in an h row) by SQP at
    B = 4096, N = 20, float32 at the main path's tolerances, x0 = (1, 0)
    + N(0, 0.05): every status 0 and in tolerance (float64 at the same B
    where float32 misses the gate, said so), z(t0) finite with |z| within
    its bound, get(k, "z") equal to it, K1 launches equal to
    dae_k1_expected from the stat table, every one at (81,920, 9, 9), and
    K1 there against its plain version;
34. integrator breadth at B = 4096, float32: the main path with GNSF by
    SQP-RTI from the main path's converged iterate (structure detected,
    every status 0 and in tolerance, no kernel launch) and the batch
    simulator with GNSF beside IRK (their gap in x_next; 1 call each,
    cut from 2); DISCRETE, the pendulum's RK4 step as disc_dyn_expr,
    beside ERK at 4 stages and 1 step, 2 RTI calls each (cut from 3),
    every status 0 (in float32 the step and its
    Jacobians within rounding and at most 1 % of the instances parted,
    beside ERK against itself on x0s moved by one rounding step; in
    float64 the trajectories within 1e-6); the pglob model with
    per-instance global parameters bit for bit equal to the same batch
    with the tail baked into p; LIFTED_IRK's 3 single-instance simulate()
    calls (cut from 5) converging to IRK's x_next, and the OCP with
    LIFTED_IRK bit for bit
    equal to IRK;
35. float64 card against CPU at B = 4, within 1e-9: the DAE cart (N =
    10, 2 iterations), the GNSF, LIFTED_IRK and DISCRETE RTI batches,
    the p_global SQP, the DAE and GNSF batch simulators, the DAE
    simulator's zn and the lifted simulator's calls.
36. multiphase OCPs at B = 4096, float32: the control horizon
    (create_ocp_with_control_horizon of the main path's pendulum with
    ERK, N = 20, Nc = 5) by SQP from the main path's x0s, every status 0
    and in tolerance, the held state equal to the transition's control
    to float32 rounding, no kernel launch, beside the single-phase
    pendulum ERK SQP; the transition example of tests/test_multiphase.py
    with IRK phases by SQP with MERIT_BACKTRACKING, every status 0 and
    in tolerance, the position carried over the transition, K1 launches
    equal to mp_k1_expected from the stat table at (102,400, 8, 8) and
    (102,400, 4, 4) only, and K1 at both shapes against its plain
    version, torch.linalg.inv and its bound;
37. float64 card against CPU at B = 4, within 1e-9: the transition
    example with ERK and IRK phases by SQP and under SQP_RTI, and the
    control horizon by SQP.
38. the interface utilities at the main path's width (pendulum IRK GL4,
    N = 20, float32, B = 4096, from the main path's converged iterate):
    the batch with and without collect_phase_times, interleaved (1 warm
    call each, 1 round of 1 timed call, cut from 3): every status 0 and in
    tolerance, K1 8 launches a call either way, the four phase times
    positive and their sum within 0.5-1.05 of time_tot after each call,
    both medians; store_iterates on one RTI call (K1 8) and on the
    Gauss-Newton SQP (K1 8 a lockstep round and 8 for the final
    residuals): row 0 the initial iterate and row sqp_iter the returned
    one, bit for bit; the B = 4096 flat iterate through set_flat and a
    '.atni' file under build/chip_smoke bit for bit, loaded into a second
    batch solver, whose next call equals the first solver's bit for bit;
    on single-instance SQPs of the same pendulum, store_iterates
    (get_iterates' first and last rows) and the timeouts from its
    iterate 2 iterations before the solution (cut from 3; 1e-7 s with
    LAST: status 7
    before 5 iterations; 120 s with ZERO, LAST, MAX, AVERAGE: status 0
    and bit for bit the solve without), print_
    statistics() and dump_qp_to_file (19 keys at the JAX package's
    shapes), zoRO's custom_update from the solution (K1 exactly 8 at
    (20, 16, 16), against
    its plain version and timed beside its bound and torch.linalg.inv; a
    finite backoff growing along the horizon on the force and position
    rows; the tightened solve at status 0), and AcadosScipyOcpSolver on
    the float64 pendulum from the SQP solution, within 1e-4 of it;
39. float64 card against CPU at B = 4, within 1e-9: the stored iterates
    of a main-path SQP cut at 4 iterations, the flat iterate after 3 RTI
    calls, zoRO's tightened bounds, and the scipy oracle (within the
    CPU's own spread from a start one rounding step away, where that
    exceeds 1e-9);
40. every examples_torch script with --device cuda (its main() with its
    own asserts), all started together, one process each, after phase
    38, running beside the float64 checks (see below): each exits 0; its
    seconds and last line;
41. batch sharding: the main path's batch (B = 4096, float32, from its
    converged iterate) with devices=["cuda:0"] bit for bit the default,
    and over two shards on the one card (devices=["cuda:0"] * 2, a
    thread each): K1 8 launches a call unsharded and 16 sharded, all at
    (40,960, 16, 16), each shard bit for bit its half solved alone, equal
    statuses with the whole batch, every instance in tolerance, the
    largest x/u gap and the instances whose qp_iter differs (a float32
    QP's last round follows the batch size's reduction order); one warm
    call each, then
    2 interleaved rounds of one timed call (cut from 3), both medians
    beside the
    card's name and power limit, and K1 at the shard's shape against its
    plain version, torch.linalg.inv and its bound (41a, after phase
    40); two processes on the card with torchrun's environment
    (chip_smoke.py --dist-worker DIR), started with the examples, each
    through initialize_distributed (gloo) solving its
    process_local_batch_slice from the converged iterate: after its
    first call K1 8, the summed status histogram equal to the
    one-process call's and the global largest res_stat within the
    float32 gate of it, then, after 41a, 2 timed calls (cut from 3), K1
    8 each, and
    the pair's wall time (41b); float64 card
    against CPU within 1e-9: tests/test_torch_sharding.py's B = 8
    pendulum MERIT SQP over 4 shards cut at 4 iterations (statuses and
    sqp_iter equal) and 3 prepare()/feedback() cycles with
    ADAPTIVE_CURRENT_RES_JOINT (41c, beside the examples).
Phases 28, 32, 35, 37, 39 and 41c, float64 checks that time nothing,
run after phase 38, beside the examples of phase 40 and the first calls
of 41b's processes (the float64 checks and the examples took 120 and
116 s on a slow host, one after the other).
Phases 38-41 run alone through utilities_phase(dev), utilities_vs_cpu(),
examples_phase(), procs = start_dist(it0, x0s), sharding_vs_cpu(),
entry, ref = sharding_phase(dev, it0) and dist_phase(procs, *ref), after
cuda_build.build_all().
The CPU halves of the float64 card-against-CPU checks (phases 5, 9, 14,
19, 23, 26, 28, 32, 35, 37, 39, 41) run ahead in a second process started
after the build (chip_smoke.py --cpu-refs DIR, with no card), which
the script waits for and stops before it ends; a check called alone
computes both halves itself.
Depth cuts that keep the run well inside its 1200 s limit (timed calls,
rounds, warm calls and check iterations, each check kept) are noted at
each phase as "cut from"; the "-- phase N from T s" lines time each
phase.
The last lines are the kernels JSON line, the card line and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

B_MAIN = 4096
N_HORIZON = 20
WARM_CALLS = 10
TIMED_CALLS = 3               # cut from 6 (phases 4, 6, 11)
LAUNCHES_PER_RTI = 8          # 4 inverses per substep x 2 substeps
# timed calls of each part of a time split (host_ms; cut from 3)
SPLIT_REPS = 1
# the main path's OCP (make_pendulum_ocp's keywords)
MAIN_KW = dict(N=N_HORIZON, dtype="float32", nlp_solver_type="SQP_RTI",
               integrator_type="IRK")
# the Newton SQP (phase 27): K1 launches of an EXACT linearization (the
# 8 above + 14 of the dynamics Hessian's torch.func.hessian through the
# IRK step: per substep 3 Newton solves forward, 1 reverse, 1 + 2 in the
# forward-mode passes of the root and its reverse) and of one dynamics-
# gap evaluation of the merit (3 Newton solves a substep)
K1_PER_EXACT_LINEARIZE = 22
K1_PER_DYN_GAP = 6
# the main path with cost_discretization INTEGRATOR (phase 31): a call's
# K1 launches are the dynamics' 8 and, for each of the two integrated
# stage classes (stage 0, the path) and each of the 2 substeps, the
# stage points' Newton solves (3) once in the linearization (the
# residuals and their Jacobian from one forward pass), the implicit
# solve of their forward-mode Jacobian (1), and the Newton solves again
# in each of the call's two cost evaluations (the unbounded check and
# the final cost): 8 + 2 * 2 * (3 + 1 + 2 * 3)
K1_PER_INTEGRATOR_RTI = 48
X0_CENTER = (0.0, np.pi, 0.0, 0.0)
X0_SIGMA = 0.05
SEED = 0
FULL_COND = "FULL_CONDENSING_HPIPM"
# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12            # outside the tensor cores
F32_BOUND = 1e-4
F64_BOUND = 1e-12
# the chain entry of bench.py: n_mass = 8 (nx = 39), B = 256, N = 40, x0
# spread 0.02 around the steady state, and its float32 tolerances
# (stat, eq, ineq, comp)
N_MASS, B_CHAIN, N_CHAIN, CHAIN_SIGMA = 8, 256, 40, 0.02
CHAIN_TOLS = (1e-2, 1e-4, 1e-3, 1e-2)
K1_PER_CHAIN_CALL = 2         # one block-determinant inverse per substep
# bench.py's quadrotor and race car entries: (builder, x0 spread, OCP
# keywords), gated at stat 5e-3 and eq 1e-4
ERK_MODELS = (("quadrotor", 0.05, dict(N=20)),
              ("race_car", 0.01, dict(N=30, Tf=0.6)))
ERK_TOLS = (5e-3, 1e-4, np.inf, np.inf)
B_ERK = 1024
ERK_WARM = 6                  # cut from 9 (at 4 the quadrotor ends out of
                              # tolerance: res_stat 0.0608 against 5e-3)
# the RTI phases on the main path: warm and timed prepare/feedback cycles
# (from the main path's converged iterate; from the swing-up it took 11
# warm cycles)
RTI_WARM, RTI_TIMED = 2, 2    # timed cut from 4
# bench.py's bench_long_horizon_rti: N, B, x0 spread, its float32
# tolerances (_LONGH_TOLS: stat, eq) and the condensed horizon of its
# cond_N16 variant; the warm calls (bench.py: 25) and interleaved rounds
N_LONG, B_LONG, LONG_SIGMA, COND_LONG = 128, 1024, 0.02, 16
LONG_TOLS = (1e-1, 1e-4, np.inf, np.inf)
LONG_WARM, LONG_ROUNDS, LONG_PER_ROUND = 10, 1, 1
# the plain variant's warm-up serves all three (phases 17, 24): from the
# swing-up start each variant takes 10-13 calls to reach LONG_TOLS (on an
# H100 the plain one's first calls 8-15 s at B_LONG, their QPs far from
# the solution), along the same RTI iterates. The other two start from
# the plain variant's warmed iterate and take SHARED_WARM warm calls of
# their own before the timed rounds
SHARED_WARM = 1
# the parallel-in-time Riccati: K1 launches a factor, one a non-empty
# combine of the associative scan over N + 1 elements (7 reduce + 7 even
# combines at N = 128, the even one at 2 elements empty; 4 + 4 at N = 20)
K1_PER_PAR_FACTOR = {128: 13, 20: 7}
# the largest combine: 64 pairs of each of the B_LONG instances
PAR_COMBINE_B = 64 * 1024
# bench.py's bench_latency: B, the condensed horizon of its cond_N32
# variant, and the warm calls (bench.py: 25; from the swing-up 3 left
# cond_N32 out of _LONGH_TOLS at B = 8; the plain variant starts from
# phase 17's warm iterate, so 1 + 0 before the timed round),
# rounds and calls a round
B_LAT, COND_LAT = 8, 32
LAT_WARM, LAT_ROUNDS, LAT_PER_ROUND = 0, 1, 1
# bench.py's bench_admm_backend: B, N, x0 spread, the IPM's warm calls
# (bench.py: 15 for each variant), the IPM call whose iterate the ADMM
# variant starts from (the RTI iteration still far from tolerance there:
# a converged instance keeps its iterate, so ADMM's steps must be what
# brings the batch into tolerance), the ADMM variant's warm calls and
# the interleaved rounds (bench.py: 3 rounds of 10 calls). Cut to keep
# the phase near a minute: an ADMM call runs up to 500 lockstep
# iterations, ~6 s at B = 4096
B_ADMM, N_ADMM, ADMM_SIGMA = 4096, 20, 0.05
ADMM_IPM_WARM, ADMM_FROM_IPM_CALL = 10, 6   # warm cut from 15
ADMM_WARM, ADMM_ROUNDS, ADMM_PER_ROUND = 3, 2, 1
# the chain sweep's warm calls (phase 12; cut from 10: the largest
# qp_iter settles at 2 from the second or third call)
SWEEP_WARM = 3
# the chain at qp_solver_cond_N = 8: condensed nu = 5 * 3 = 15
COND_CHAIN = 8
CHAIN_ROUNDS, CHAIN_PER_ROUND = 2, 2   # cut from 3 rounds of 4
# K5's edge cases: n at the start, inside and at the end of a band of the
# kernel's padded sizes (one n in each band: 4, 8, 16, ..., 64), batches
# that end inside a pair group (4 k + 3 among them), a long batch with
# more groups than resident blocks, and every n at a short ragged batch
K5_EDGE_N = (1, 7, 13, 20, 29, 39, 40, 48, 53, 64)
K5_EDGE_B = (1, 2, 3, 5, 1023)
K5_LONG_B = 200_003
K5_SWEEP_B = 7
# K1's warp branch (n = 1 and 17..48; n = 9, now in the padded group
# branch, keeps its checks here): the n of its checks and grid (one in
# each band from 16 to 48), the n and batches of its edge cases
# (batches that end inside a block of warps), the long batch and the
# short batch every n runs at
K1_BRANCH_N = (9, 21, 29, 39, 48)
K1_EDGE_N = (9, 29, 39, 48)
K1_EDGE_B = (1, 2, 3, 33)
K1_LONG_B = 200_003
K1_SWEEP_B = 7
K1_GRID_B = (10240,)
# K1's group branch (n = 2, 4, 8, 16, and padded to the next of those
# bands, n = 3, 5-7, 9-15): batches that end inside a group of lanes, a
# warp and a block of warps, the n of the long batches, and the batches
# of its grid (every n = 2..16 in phase 3; k1_compare.py times the warp
# branch's cells). The padded orders' checks draw from a generator of
# their own (K1_PAD_SEED), so the other checks keep their draws
K1_GROUP_N = (2, 4, 8, 16)
K1_PAD_N = (3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15)
K1_GROUP_EDGE_B = (1, 2, 3, 33, 65, 1023)
K1_PAD_EDGE_N = (3, 7, 9, 15)
K1_PAD_SEED = 1
K1_LONG_N = (2, 3, 16)
K1_GROUP_GRID_B = (81920,)
# k1_grid's cells (n, B, type): the warp branch's (k1_compare.py), the
# group branch's at every n = 2..16 (phase 3), and the padded orders in
# both types (k1_compare.py --pad)
K1_WARP_CELLS = tuple((n, B, "float32") for n in K1_BRANCH_N
                      for B in K1_GRID_B) + ((39, 10240, "float64"),)
K1_GROUP_CELLS = tuple((n, B, "float32") for n in range(2, 17)
                       for B in K1_GROUP_GRID_B) + ((16, 81920, "float64"),)
K1_PAD_CELLS = tuple((n, B, dt) for dt in ("float32", "float64")
                     for n in range(3, 16) for B in K1_GROUP_GRID_B)
# the same branch at the chain's shape, on the chain's block determinants
# (chip_smoke.py phase 11; NVIDIA H100 80GB HBM3, 700.00 W)
K1_PARENT_CHAIN_DEVICE_MS = 0.9014
# the branch K1's group branch replaced ([A | I] in registers, a column a
# lane): device ms back to back over k1_grid's group cells, from
# k1_compare.py, and on the main path's stage Jacobians, from this
# script (NVIDIA H100 80GB HBM3, 700.00 W), for the log lines only
K1_PARENT_GROUP_DEVICE_MS = {
    (2, 10240, "float32"): 0.0056, (2, 81920, "float32"): 0.0071,
    (4, 10240, "float32"): 0.0065, (4, 81920, "float32"): 0.0133,
    (8, 10240, "float32"): 0.0108, (8, 81920, "float32"): 0.0439,
    (16, 10240, "float32"): 0.0341, (16, 81920, "float32"): 0.2175,
    (16, 81920, "float64"): 0.4028}
K1_PARENT_MAIN_DEVICE_MS = 0.2793
# the warp branch that ran n = 3, 5-7, 9-15 before the padded group
# branch: device ms back to back at k1_grid's cells, by (n, B, type), from
# k1_compare.py --pad (NVIDIA H100 80GB HBM3, 700.00 W), for the log lines
# only
K1_PARENT_PAD_DEVICE_MS = {
    (3, 81920, "float32"): 0.0691, (5, 81920, "float32"): 0.0693,
    (6, 81920, "float32"): 0.0720, (7, 81920, "float32"): 0.0720,
    (9, 81920, "float32"): 0.1291, (10, 81920, "float32"): 0.1346,
    (11, 81920, "float32"): 0.1349, (12, 81920, "float32"): 0.1332,
    (13, 81920, "float32"): 0.1649, (14, 81920, "float32"): 0.1672,
    (15, 81920, "float32"): 0.1743}
# K2's row branch (n <= 32, bands 4, 8, 16, 24, 32): an n in each band
# with the batches that end inside a group, a warp and a block of warps,
# the long batches, the short batch every n runs at, and K2's grid
# (K2_WIDE_N: above the row branch)
K2_ROW_N = (4, 8, 16, 24, 32)
K2_EDGE_B = (1, 2, 3, 5, 33, 1023)
K2_LONG_N = (4, 24)
K2_LONG_B = 200_003
K2_SWEEP_B = 7
K2_GRID_N = (4, 8, 13, 16, 24, 32)
K2_GRID_B = (4096,)
K2_WIDE_N = (39, 64)
# K2's block branch (n = 33..64 up to 512 matrices, a block a matrix; the
# one-warp kernel above): small batches, one past a wave of 256 blocks,
# both sides of the 512 threshold, a long batch at the chain's P_0 width,
# and the small-batch cells of K2's grid (the chain's P_0 and condensed
# Huu at B = 256, and n = 64) in both types
K2_BLOCK_N = (33, 39, 48, 64)
K2_BLOCK_EDGE_B = (1, 2, 3, 5, 33, 257, 512, 513)
K2_BLOCK_LONG = (39, 20_001)
K2_SMALL_CELLS = ((15, 256), (39, 256), (64, 256))
# the K2 the row and block branches replaced (one warp a matrix,
# left-looking, in shared memory): device ms back to back over
# chol_grid's cells, by (n, B, type), from k2_compare.py (NVIDIA H100 80GB
# HBM3, 700.00 W), for the log lines only
K2_PARENT_DEVICE_MS = {
    (4, 4096, "float32"): 0.0073, (4, 65536, "float32"): 0.0383,
    (8, 4096, "float32"): 0.0101, (8, 65536, "float32"): 0.0738,
    (13, 4096, "float32"): 0.0152, (13, 65536, "float32"): 0.1376,
    (16, 4096, "float32"): 0.0178, (16, 65536, "float32"): 0.1727,
    (24, 4096, "float32"): 0.0289, (24, 65536, "float32"): 0.3156,
    (32, 4096, "float32"): 0.0423, (32, 65536, "float32"): 0.4870,
    (24, 4096, "float64"): 0.0329, (39, 4096, "float32"): 0.0645,
    (64, 4096, "float32"): 0.2332,
    # the small-batch cells before the block branch (n = 15: the row
    # branch, which stays)
    (15, 256, "float32"): 0.0095, (39, 256, "float32"): 0.0296,
    (64, 256, "float32"): 0.0645, (15, 256, "float64"): 0.0093,
    (39, 256, "float64"): 0.0376, (64, 256, "float64"): 0.0873}
# the K3 and K4 the row branch replaced (one warp a matrix in shared
# memory, the back substitution on one lane): device ms back to back over
# chol_grid's cells, by (n, B, type), from k2_compare.py (NVIDIA H100 80GB
# HBM3, 700.00 W), for the log lines only
K3_PARENT_DEVICE_MS = {
    (4, 4096, "float32"): 0.0087, (4, 65536, "float32"): 0.0491,
    (8, 4096, "float32"): 0.0119, (8, 65536, "float32"): 0.0907,
    (13, 4096, "float32"): 0.0169, (13, 65536, "float32"): 0.1590,
    (16, 4096, "float32"): 0.0198, (16, 65536, "float32"): 0.1993,
    (24, 4096, "float32"): 0.0304, (24, 65536, "float32"): 0.3438,
    (32, 4096, "float32"): 0.0373, (32, 65536, "float32"): 0.4440,
    (24, 4096, "float64"): 0.0389, (39, 4096, "float32"): 0.0514,
    (64, 4096, "float32"): 0.1576}
K4_PARENT_DEVICE_MS = {
    (4, 4096, "float32"): 0.0110, (4, 65536, "float32"): 0.0794,
    (8, 4096, "float32"): 0.0168, (8, 65536, "float32"): 0.1586,
    (13, 4096, "float32"): 0.0261, (13, 65536, "float32"): 0.2840,
    (16, 4096, "float32"): 0.0318, (16, 65536, "float32"): 0.3576,
    (24, 4096, "float32"): 0.0520, (24, 65536, "float32"): 0.6260,
    (32, 4096, "float32"): 0.0703, (32, 65536, "float32"): 0.8669,
    (24, 4096, "float64"): 0.0650, (39, 4096, "float32"): 0.1041,
    (64, 4096, "float32"): 0.3214}
# K5 at (10240, 39, 39) float32, device ms back to back, before the
# register-tiled design (one output a thread; NVIDIA H100 80GB HBM3,
# 700.00 W), for the log line only
K5_PREVIOUS_DEVICE_MS = 0.2336


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float:
    """Median device time (ms) of one fn() call, the calls queued back to
    back behind a spin kernel that holds the stream until all of them are
    queued: the events between the calls then time the card alone, not
    the host's launch time, which CUDA events around a short kernel on an
    idle card also count. The spin doubles until the host has queued
    every call before the first event is reached."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(cycles)
        ev[0].record()
        for r in range(reps):
            fn()
            ev[r + 1].record()
        queued_in_time = not ev[0].query()
        torch.cuda.synchronize()
        if queued_in_time:
            return float(np.median([ev[r].elapsed_time(ev[r + 1])
                                    for r in range(reps)]))
        if cycles >= 1 << 32:
            raise SystemExit("device_ms: the host could not queue "
                             f"{reps} calls ahead of the card")
        cycles *= 2


def kernel_busy_ms(fn, calls: int = 10) -> float:
    """Device time (ms) of one fn() call as the sum of the CUDA kernels it
    launches (torch.profiler, mean over `calls` calls): for a library
    call that waits for the host inside, which device_ms cannot queue."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / calls


def bound_of(bytes_moved: float, flops: float, peak: float = FP32_FLOPS):
    """The least time the card could take (ms) and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def reset_counts():
    """Every kernel's launch count to 0."""
    from acados_tpu_torch.ops import batched_chol, batched_inv, small_mm
    batched_inv.LAUNCHES = 0
    small_mm.LAUNCHES = 0
    for k in batched_chol.LAUNCHES:
        batched_chol.LAUNCHES[k] = 0


def read_counts() -> dict:
    from acados_tpu_torch.ops import batched_chol, batched_inv, small_mm
    return dict(gj_inverse=batched_inv.LAUNCHES, **batched_chol.LAUNCHES,
                small_mm=small_mm.LAUNCHES)


class K1Shapes:
    """While active, records the shape of every K1 launch and keeps a copy
    of the first launch's input and of the largest one's, and of the
    first for which match(input) holds, where match is given."""

    def __init__(self, match=None):
        self.match, self.matched = match, None

    def __enter__(self):
        from acados_tpu_torch.ops import batched_inv
        self._mod, self._orig = batched_inv, batched_inv._gj_inverse_cuda
        self.shapes, self.first, self.largest = [], None, None

        def record(A):
            if self.matched is None and self.match is not None \
                    and self.match(A):
                self.matched = A.detach().clone()
            if self.first is None:
                self.first = A.detach().clone()
            if self.largest is None or A.numel() > self.largest.numel():
                self.largest = A.detach().clone()
            self.shapes.append(tuple(A.shape))
            return self._orig(A)

        batched_inv._gj_inverse_cuda = record
        return self

    def __exit__(self, *exc):
        self._mod._gj_inverse_cuda = self._orig


def check_inverse(name, A, inv_kernel, bound, quiet=False):
    """Kernel against the plain version on the same input; returns
    (rel_err, abs_err, resid). quiet: log only a failure."""
    import torch
    from acados_tpu_torch.ops.batched_inv import gj_inverse_plain
    Ak = inv_kernel(A)
    torch.cuda.synchronize()
    Ap = gj_inverse_plain(A)
    abs_err = float((Ak - Ap).abs().max())
    rel = abs_err / float(Ap.abs().max())
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    resid = float((A @ Ak - eye).abs().max())
    ok = rel <= bound and resid <= bound and bool(torch.isfinite(Ak).all())
    if not quiet or not ok:
        log(f"  {name:<34} {str(A.dtype):<14} max|k-p|/max|p| {rel:.3e}  "
            f"max|A Ainv - I| {resid:.3e}  bound {bound:g}  "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version: {name}")
    return rel, abs_err, resid


def transposed_view(A):
    """The same matrices as A, each stored as its transpose: strides
    (n^2, 1, n), the layout of the IRK's stage Jacobians."""
    return A.transpose(-1, -2).contiguous().transpose(-1, -2)


def check_transposed(name, A, kern, bound, quiet=True):
    """K1 on A, a view the kernel reads in place (input_layout
    "transposed"; "rows" at n = 1, where the view is contiguous), bit for
    bit against the kernel on A's contiguous copy and within bound of the
    plain version; returns check_inverse's (rel_err, abs_err, resid)."""
    from acados_tpu_torch.ops.batched_inv import input_layout
    layout = input_layout(A)
    same = same_bits(kern(A), kern(A.contiguous()))
    if layout != ("rows" if A.is_contiguous() else "transposed") \
            or not same:
        raise SystemExit(f"K1 on a transposed view: {name} {A.dtype} read "
                         f"as {layout!r}, bit for bit its contiguous "
                         f"copy's: {same}")
    return check_inverse(name + " transposed", A, kern, bound, quiet=quiet)


def rti_batch(ocp_kw, B, device, seed=SEED, qp_solver=None,
              sigma=X0_SIGMA, moved=False, solver_options=None, **updates):
    """The main path's batch solver with bench.py's _build_rti set-up:
    x0 per instance = X0_CENTER + N(0, sigma), set as lbx/ubx at stage
    0, and the x trajectory initialised at x0. qp_solver, if given, is
    set in the solver options, as are the entries of solver_options;
    moved: every x0 entry moved by one rounding step, up or down at
    random; updates (opts_update, qp_opts_update) go to
    acados_tpu_torch.testing.rti_batch."""
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    ocp = make_pendulum_ocp(**ocp_kw)
    if qp_solver is not None:
        ocp.solver_options.qp_solver = qp_solver
    for k, v in (solver_options or {}).items():
        setattr(ocp.solver_options, k, v)
    rng = np.random.default_rng(seed)
    x0s = np.asarray(X0_CENTER) + rng.normal(0.0, sigma, (B, 4))
    if moved:
        x0s = x0s * (1 + np.finfo(np.float64).eps * rng.choice(
            (-1.0, 1.0), x0s.shape))
    return batch_at(ocp, x0s, device, **updates), ocp


def chain_batch(n_mass, B, dtype, device, seed=SEED, moved=False,
                cond_N=None):
    """bench_chain_rti's set-up: the chain OCP at N = N_CHAIN, x0 per
    instance = steady state + N(0, CHAIN_SIGMA). moved: every x0 entry
    moved by one rounding step, up or down at random. cond_N: the
    solver's qp_solver_cond_N."""
    from acados_tpu_torch.models.chain_mass import make_chain_mass_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    ocp, xrest = make_chain_mass_ocp(n_mass=n_mass, N=N_CHAIN, dtype=dtype)
    ocp.solver_options.qp_solver_cond_N = cond_N
    rng = np.random.default_rng(seed)
    x0s = xrest + rng.normal(0.0, CHAIN_SIGMA, (B, len(xrest)))
    if moved:
        x0s = x0s * (1 + np.finfo(np.float64).eps * rng.choice(
            (-1.0, 1.0), x0s.shape))
    return batch_at(ocp, x0s, device)


def in_tolerance(solver, tols=None):
    """bench.py's _residual_fields gate on the last solve's residuals, at
    the configuration's tolerances unless tols (stat, eq, ineq, comp) are
    given."""
    so = solver.acados_ocp.solver_options
    res = solver.get_stats("residuals").max(axis=0)
    if tols is None:
        tols = (so.nlp_solver_tol_stat, so.nlp_solver_tol_eq,
                so.nlp_solver_tol_ineq, so.nlp_solver_tol_comp)
    return bool(np.all(res <= np.asarray(tols))), res, tols


def host_ms(fn, reps: int = SPLIT_REPS) -> float:
    """Median host-clock time of fn() ending in a synchronize (ms), after
    one untimed call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_calls(solver, label, on_call=None, tols=None, warm=WARM_CALLS,
              timed=TIMED_CALLS):
    """1 cold + `warm` warm + `timed` timed solve() calls: every status
    must be 0 and the last call in tolerance (at `tols`, or the
    configuration's). Returns the timed calls' host times (ms) and each
    call's largest qp_iter."""
    import torch
    call_ms, statuses, qp_max = [], [], []
    for c in range(1 + warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = solver.solve()
        torch.cuda.synchronize()
        if c > warm:
            call_ms.append((time.perf_counter() - t0) * 1e3)
        statuses.append(st)
        qp_max.append(int(solver.get_stats("qp_iter").max()))
        if on_call is not None:
            on_call(c)
    bad = [c for c, st in enumerate(statuses) if np.any(st != 0)]
    if bad:
        raise SystemExit(f"{label}: non-zero statuses in calls {bad}: "
                         f"{np.unique(statuses[bad[0]], return_counts=True)}")
    ok_tol, res, tols = in_tolerance(solver, tols)
    log(f"  residual maxima {res.tolist()} vs tolerances {list(tols)}: "
        f"{'in tolerance' if ok_tol else 'OUT OF TOLERANCE'}")
    if not ok_tol:
        raise SystemExit(f"{label} not in tolerance")
    x = solver._it_dev.x
    if x.shape != (solver.N_batch, solver.N + 1, solver.form.nx) or not \
            bool(torch.isfinite(x).all()):
        raise SystemExit(f"bad trajectory tensor {tuple(x.shape)}")
    return call_ms, qp_max


def call_stats(call_ms, B=B_MAIN) -> str:
    med = float(np.median(call_ms))
    p10, p90 = (float(np.percentile(call_ms, q)) for q in (10, 90))
    return (f"median {med:.2f} ms (p10 {p10:.2f}, p90 {p90:.2f}) over "
            f"{len(call_ms)} calls -> {B / med * 1e3:.1f} solves/s")


def profile_calls(solver, call_ms: float, calls: int = 1) -> dict:
    """A torch.profiler trace of a few solve() calls: the device's busy
    share of the unprofiled call time, launches per call, top kernels.
    It traces the device alone: the host's operator events (several for
    each launch) are read by nothing here."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            solver.solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {}
    for e in kern:
        t = busy.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.elapsed_us() / 1e3 / calls
        t[1] += 1 / calls
    busy_ms = sum(t[0] for t in busy.values())
    return dict(device_busy_ms_per_call=busy_ms,
                device_busy_share=busy_ms / call_ms,
                profiled_wall_ms_per_call=wall_ms / calls,
                kernel_launches_per_call=len(kern) / calls,
                top_kernels=[dict(name=k[:80], ms=v[0], launches=v[1])
                             for k, v in sorted(busy.items(),
                                                key=lambda kv: -kv[1][0])[:6]])


def linearized(solver):
    """(linearize thunk, its QP) at the solver's current iterate."""
    import torch
    from acados_tpu_torch.ocp_nlp.linearize import (build_static_rows,
                                                    linearize)
    form, opts = solver.form, solver.opts
    data, it = solver._data_dev, solver._it_dev
    rows = build_static_rows(form, it.x.dtype, it.x.device)
    lm = torch.tensor(opts.levenberg_marquardt, dtype=it.x.dtype,
                      device=it.x.device)
    lin = lambda: linearize(form, rows, data, it, lm)
    return lin, lin()


def qp_solve(solver, qp, warm=None):
    """The SQP's QP dispatch for the solver's options (no scaling, no
    full condensing): the Riccati IPM, through partial condensing where
    cond_N is set."""
    from acados_tpu_torch.ocp_nlp.sqp import keep_rows_of, use_x0_elimination
    from acados_tpu_torch.ocp_qp.xcond import solve_ocp_qp_xcond
    form, opts = solver.form, solver.opts
    return solve_ocp_qp_xcond(
        qp, opts.qp_opts, cond_N=opts.cond_N, warm=warm,
        keep_rows=keep_rows_of(form), cond_block_size=opts.cond_block_size,
        x0_fixed=use_x0_elimination(form, opts))


def time_split(solver, reps: int = SPLIT_REPS, profiled: int = 0) -> dict:
    """Where the time of one warm RTI call goes: its layers on the host
    clock (each synchronised, medians of `reps`), then a torch.profiler
    trace of a few calls for the device's busy share and kernel launches
    per call (`profiled` calls: the profiler's bookkeeping grows with the
    launches). The QP goes through the solver's dispatch (partial
    condensing where cond_N is set) and is warm-started from the NLP
    multipliers where the configuration asks for it, as the SQP loop
    does."""
    import torch
    from acados_tpu_torch.ocp_nlp.sqp import _nlp_residuals
    from acados_tpu_torch.ocp_qp.data import OcpQpSol
    form, opts = solver.form, solver.opts
    data, it = solver._data_dev, solver._it_dev
    M = it.u.shape[0] * it.u.shape[1]
    flat = lambda t: t.reshape((M,) + tuple(t.shape[2:]))
    step_args = (flat(it.x[:, :-1]), flat(it.u), flat(data.p[:, :-1]),
                 flat(data.ts[:, :-1]), flat(data.dts))
    lin, qp = linearized(solver)
    warm = None
    if opts.warm_start_first_qp_from_nlp:
        warm = OcpQpSol(x=torch.zeros_like(qp.q), u=torch.zeros_like(qp.r),
                        pi=it.pi, lam_lg=it.lam_l, lam_ug=it.lam_u,
                        t_lg=torch.ones_like(it.lam_l),
                        t_ug=torch.ones_like(it.lam_u), sl=it.sl, su=it.su)
    _, info = qp_solve(solver, qp, warm)
    out = dict(call_ms=host_ms(solver.solve, reps),
               linearize_ms=host_ms(lin, reps),
               step_jac_ms=host_ms(lambda: form.step_jac_fn(*step_args),
                                   reps),
               qp_ms=host_ms(lambda: qp_solve(solver, qp, warm), reps),
               qp_rounds=int(info.num_iter.max()),
               riccati_stages=opts.cond_N or form.N,
               residuals_ms=host_ms(lambda: _nlp_residuals(qp, it), reps))
    out["rest_ms"] = out["call_ms"] - out["linearize_ms"] - out["qp_ms"]
    out["qp_share"] = out["qp_ms"] / out["call_ms"]
    if profiled:
        out.update(profile_calls(solver, out["call_ms"], profiled))
    return out


def fc_time_split(solver) -> dict:
    """time_split for the full-condensing path: linearize, condense,
    dense IPM, expand."""
    from acados_tpu_torch.dense_qp.ipm import solve_dense_qp
    from acados_tpu_torch.ocp_qp.full_condensing import (full_condense,
                                                         full_expand)
    qp_opts = solver.opts.qp_opts
    lin, qp = linearized(solver)
    dense, cache = full_condense(qp)
    sol_d, info = solve_dense_qp(dense, qp_opts)
    out = dict(call_ms=host_ms(solver.solve),
               linearize_ms=host_ms(lin),
               condense_ms=host_ms(lambda: full_condense(qp)),
               dense_ipm_ms=host_ms(lambda: solve_dense_qp(dense, qp_opts)),
               dense_ipm_rounds=int(info.num_iter.max()),
               expand_ms=host_ms(lambda: full_expand(qp, cache, sol_d)))
    out["rest_ms"] = out["call_ms"] - sum(
        out[k] for k in ("linearize_ms", "condense_ms", "dense_ipm_ms",
                         "expand_ms"))
    return out


# The CPU halves of the float64 card-against-CPU checks (phases 5, 9,
# 14, 19, 23, 26, 28, 32, 35, 37, 39 and 41) run ahead in a second process,
# started after the build (`chip_smoke.py --cpu-refs DIR`, which sees no
# card; REF_THREADS threads): each half is saved under its check's label
# and read where the card's half needs it, so the CPU's solves no longer
# add to the run's time. A check run alone (no such process) computes
# both halves in turn. REF_CHECKS: the checks, in the order main() runs
# them.
REF_THREADS = 4
REF_CHECKS = ("main_path_vs_cpu", "full_cond_vs_cpu", "chain_vs_cpu",
              "new_paths_vs_cpu", "sens_vs_cpu", "qp_paths_vs_cpu",
              "newton_vs_cpu", "nlp_breadth_vs_cpu", "integrators_vs_cpu",
              "multiphase_vs_cpu", "utilities_vs_cpu", "sharding_vs_cpu")
REFS = dict(mode=None, dir=None, proc=None, seen=set())


def _ref_path(key: str) -> str:
    import hashlib
    import os
    return os.path.join(REFS["dir"], hashlib.sha1(
        key.encode()).hexdigest()[:20] + ".pkl")


def cpu_half(key: str, compute):
    """The CPU half of the check `key`: compute() here when no reference
    process runs; in the reference process, compute() saved under key;
    in the main one, the saved result, waited for."""
    import os
    import pickle
    if key in REFS["seen"]:
        raise SystemExit(f"two checks share the label {key!r}")
    REFS["seen"].add(key)
    if REFS["mode"] is None:
        return compute()
    path = _ref_path(key)
    if REFS["mode"] == "worker":
        out = compute()
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
        return out
    while not os.path.exists(path):
        if REFS["proc"].poll() is not None and not os.path.exists(path):
            with open(os.path.join(REFS["dir"], "worker.log")) as f:
                tail = f.read()[-3000:]
            raise SystemExit(f"the CPU reference process stopped (exit "
                             f"{REFS['proc'].returncode}) before {key!r}:\n"
                             f"{tail}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def card_half() -> bool:
    """False in the reference process, which computes CPU halves only."""
    return REFS["mode"] != "worker"


def start_cpu_refs() -> None:
    """Start the reference process (see REF_CHECKS)."""
    import os
    import shutil
    d = os.path.join(UTIL_DIR, "cpu_refs")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "worker.log"), "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-refs", d],
            stdout=logf, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                 "OMP_NUM_THREADS": str(REF_THREADS)})
    REFS.update(mode="main", dir=d, proc=proc)


def stop_cpu_refs() -> None:
    """Wait for the reference process, then make sure it is gone."""
    proc = REFS["proc"]
    if proc is None:
        return
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def cpu_refs_worker(d: str) -> int:
    """The reference process: every check's CPU half, saved under d."""
    import torch
    torch.set_num_threads(REF_THREADS)
    REFS.update(mode="worker", dir=d)
    for name in REF_CHECKS:
        t0 = time.perf_counter()
        globals()[name]()
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    return 0


def card_vs_cpu(label, make, moved=None, calls=3, step=None,
                spread_bound=False):
    """The same float64 batch (make(device) -> solver) on the card and on
    the CPU, `calls` RTI calls (step(solver) -> statuses, default
    solver.solve()): equal statuses and qp_iter call by call, and max
    |d|/(1 + |ref|) over x, u, pi within 1e-9, naming the worst instance.
    moved, if given, makes the CPU batch again from inputs moved by one
    rounding step (moved() -> solver), to log the CPU's own spread beside
    the card's gap; with spread_bound the bound is 4 x that spread where
    it exceeds 1e-9 (as tests/test_torch_sens_models.py holds stiff
    cases to the JAX package's spread). The CPU half: cpu_half(label)."""
    import torch
    step = step or (lambda s: s.solve())
    fields = ("x", "u", "pi")

    def run(solver):
        per_call = [(np.asarray(step(solver)), solver.get_stats("qp_iter"))
                    for _ in range(calls)]
        return per_call, {f: getattr(solver._it_dev, f).cpu().numpy()
                          for f in fields}

    def cpu():
        per_call, it = run(make("cpu"))
        return per_call, it, run(moved())[1] if moved is not None else None

    ref_calls, ref, ref_moved = cpu_half(label, cpu)
    if not card_half():
        return
    gpu = make(torch.device("cuda"))
    for st_c, qp_c in ref_calls:
        st_g = step(gpu)
        if not (np.array_equal(st_g, st_c) and np.array_equal(
                gpu.get_stats("qp_iter"), qp_c)):
            raise SystemExit(f"{label}: card and CPU disagree on "
                             "statuses/qp_iter")

    def gaps(it):
        """Per instance, max |it - cpu| / (1 + |cpu|) over x, u, pi."""
        out = 0.0
        for f in fields:
            a, b = it[f], ref[f]
            out = np.maximum(out, np.max(
                (np.abs(a - b) / (1 + np.abs(b))).reshape(len(b), -1), 1))
        return out

    g = gaps({f: getattr(gpu._it_dev, f).cpu().numpy() for f in fields})
    worst = int(np.argmax(g))
    log(f"{label} float64 B={len(g)}, {calls} RTI calls: card vs CPU "
        f"max |d|/(1+|ref|) {g[worst]:.3e} (bound 1e-9, worst instance "
        f"{worst}), statuses {st_g.tolist()}, qp_iter "
        f"{gpu.get_stats('qp_iter').tolist()}")
    bound = 1e-9
    if ref_moved is not None:
        gm = gaps(ref_moved)
        if spread_bound:
            bound = max(bound, 4 * float(gm.max()))
        log(f"  CPU against the CPU on x0s moved by one rounding step: "
            f"worst instance {int(np.argmax(gm))} ({gm.max():.3e}; "
            f"instance {worst} {gm[worst]:.3e}); the card held to "
            f"{bound:.3e}")
    if not g[worst] <= bound:
        raise SystemExit(f"{label}: card and CPU disagree")


def spd_batch(rng, B, n):
    """Seeded SPD matrices A A' / n + I."""
    A = rng.normal(size=(B, n, n))
    return A @ np.swapaxes(A, 1, 2) / n + np.eye(n)


def chol_flops(n):
    """Operations of the factor as the kernel runs it: the sums, the
    column scalings, a sqrt and a reciprocal per column."""
    return (n ** 3 - n) / 3 + n * (n - 1) / 2 + 2 * n


def check_chol(name, H, b, bound, bad=None):
    """K2, K3 and K4 against their plain versions on the same inputs;
    returns {kernel: (rel_err, abs_err)}. `bad` marks the matrices that
    must come back NaN throughout (all others finite)."""
    import torch
    from acados_tpu_torch.ops import batched_chol as bc
    Lk = bc.chol_factor_batched(H)
    Lp = bc.chol_factor_plain(H)
    # K3's input: the plain factors, an identity in place of a NaN one
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    Lref = torch.where(torch.isnan(Lp).flatten(1).any(1)[:, None, None],
                       eye, Lp)
    pairs = dict(chol_factor=(Lk, Lp),
                 chol_solve=(bc.chol_solve_batched(Lref, b),
                             bc.chol_solve_plain(Lref, b)))
    xk, Lk4 = bc.chol_factor_solve_batched(H, b)
    xp, Lp4 = bc.chol_factor_solve_plain(H, b)
    pairs["chol_factor_solve"] = (torch.cat([xk, Lk4.flatten(1)], 1),
                                  torch.cat([xp, Lp4.flatten(1)], 1))
    torch.cuda.synchronize()
    out, fail = {}, []
    for kname, (k, p) in pairs.items():
        good = torch.isfinite(p).flatten(1).all(1)
        nan_k = torch.isnan(k).flatten(1)
        nan_ok = bool((nan_k.all(1) == ~good).all()) and bool(
            torch.isfinite(k[good]).all())
        if bad is not None and kname != "chol_solve":
            nan_ok = nan_ok and bool((~good == bad).all())
        abs_err = float((k[good] - p[good]).abs().max()) if good.any() \
            else 0.0
        rel = abs_err / max(float(p[good].abs().max()), 1e-300) \
            if good.any() else 0.0
        ok = rel <= bound and nan_ok
        out[kname] = (rel, abs_err)
        log(f"  {kname:<18} {name:<30} {str(H.dtype):<14} "
            f"max|k-p|/max|p| {rel:.3e}  NaN rows "
            f"{int((~good).sum())}/{len(good)} {'as planned' if nan_ok else 'WRONG'}"
            f"  bound {bound:g}  {'ok' if ok else 'FAIL'}")
        if not ok:
            fail.append(kname)
    if fail:
        raise SystemExit(f"{fail} disagree with their plain versions: {name}")
    return out


def indefinite_batch(rng, B, n):
    """SPD matrices with every 5th made indefinite, every 7th given a NaN
    and every 11th an infinite diagonal entry in the lower triangle;
    returns (H, bad)."""
    H = spd_batch(rng, B, n)
    bad = np.zeros(B, bool)
    H[::5, n // 2, n // 2] = -1.0
    H[3::7, n - 1, 0] = np.nan
    H[6::11, n // 3, n // 3] = np.inf
    bad[::5] = bad[3::7] = bad[6::11] = True
    return H, bad


def pivot_fail_batch(rng, n):
    """SPD matrices with a pivot that fails at every column j: H[j][j] =
    -1, inf or NaN, or a NaN below the diagonal in column j (-inf in the
    last row's diagonal), each beside a good matrix; returns (H, bad)."""
    H = spd_batch(rng, 8 * n, n)
    bad = np.zeros(8 * n, bool)
    for j in range(n):
        H[8 * j, j, j] = -1.0
        H[8 * j + 2, j, j] = np.inf
        H[8 * j + 4, j, j] = np.nan
        if j < n - 1:
            H[8 * j + 6, n - 1, j] = np.nan
        else:
            H[8 * j + 6, j, j] = -np.inf
        H[8 * j + 7, j, (j + 1) % n] = np.nan   # above the diagonal, or
        bad[8 * j:8 * j + 7:2] = True           # the last row's first entry
        if j == n - 1:
            bad[8 * j + 7] = True
    return H, bad


def k2_bit_checks(dev, rng, kern, Hb=None) -> None:
    """K2 (kern: chol_factor_batched, or the same on a copy's build)
    against chol_factor_plain bit for bit, NaN in the same matrices, in
    float32 and float64: on the barrier Hessians Hb (where given), every
    n = 1..64 at B = K2_SWEEP_B, the batches of K2_EDGE_B at each row
    band's n (they end inside a group, a warp and a block of warps) and
    of K2_BLOCK_EDGE_B at K2_BLOCK_N (the block branch, a block a matrix,
    and the one-warp kernel past 512), B = K2_LONG_B at K2_LONG_N and
    K2_BLOCK_LONG, an input one element off its allocation (not aligned
    to the row branch's vectors) at n = 24, 13 and 39, batches mixing SPD
    with indefinite and non-finite matrices at n = 4, 13, 24 (B = 1001)
    and 39, 64 (B = 505 and 1001, either side of the block branch's
    threshold), whose bad matrices fall in every position of a warp's
    groups (up to 8), and at n = 39 and 64 a failed pivot at every column
    of a block (pivot_fail_batch). Raises at the first batch that
    differs."""
    import torch
    from acados_tpu_torch.ops.batched_chol import chol_factor_plain
    for dtype in (torch.float32, torch.float64):
        def spd(B, n):
            return torch.as_tensor(spd_batch(rng, B, n), dtype=dtype,
                                   device=dev)
        batches = [] if Hb is None else [
            (f"barrier Hessians {tuple(Hb.shape)}", Hb.to(dtype), None)]
        batches += [(f"n={n} B={K2_SWEEP_B}", spd(K2_SWEEP_B, n), None)
                    for n in range(1, 65)]
        batches += [(f"n={n} B={B}", spd(B, n), None) for n in K2_ROW_N
                    for B in K2_EDGE_B]
        batches += [(f"n={n} B={B}", spd(B, n), None) for n in K2_BLOCK_N
                    for B in K2_BLOCK_EDGE_B]
        batches += [(f"long n={n} B={B}", spd(B, n), None)
                    for n, B in [(n, K2_LONG_B) for n in K2_LONG_N]
                    + [K2_BLOCK_LONG]]
        for n, B in ((24, 1023), (13, 1023), (39, 511)):
            H = torch.empty(B * n * n + 1, dtype=dtype,
                            device=dev)[1:].view(B, n, n)
            H.copy_(spd(B, n))
            batches.append((f"misaligned n={n} B={B}", H, None))
        for n, B in ((4, 1001), (13, 1001), (24, 1001), (39, 505),
                     (39, 1001), (64, 505), (64, 1001)):
            H, bad = indefinite_batch(rng, B, n)
            if set(np.flatnonzero(bad) % 8) != set(range(8)):
                raise SystemExit("the bad matrices miss a group position")
            batches.append((f"indefinite/non-finite n={n} B={B}",
                            torch.as_tensor(H, dtype=dtype, device=dev),
                            torch.as_tensor(bad, device=dev)))
        for n in (39, 64):
            H, bad = pivot_fail_batch(rng, n)
            batches.append((f"a failed pivot at every column n={n} "
                            f"B={len(H)}",
                            torch.as_tensor(H, dtype=dtype, device=dev),
                            torch.as_tensor(bad, device=dev)))
        branches = dict(collections.Counter(
            k2_branch("chol_factor", len(H), H.shape[-1], kern)
            for _, H, _ in batches))
        for name, H, bad in batches:
            Lk, Lp = kern(H), chol_factor_plain(H)
            nan_p = torch.isnan(Lp).flatten(1).all(1)
            if not (same_bits(Lk, Lp) and (bad is None
                                           or torch.equal(nan_p, bad))):
                raise SystemExit(f"K2 is not bit for bit its plain version: "
                                 f"{name} {dtype}")
        log(f"  K2 bit for bit, {str(dtype):<14} {len(batches)} batches "
            f"(n = 1..64 at B = {K2_SWEEP_B}; n in {K2_ROW_N} at B in "
            f"{K2_EDGE_B}; n in {K2_BLOCK_N} at B in {K2_BLOCK_EDGE_B}; n "
            f"in {K2_LONG_N} at B = {K2_LONG_B}; (n, B) = {K2_BLOCK_LONG}; "
            f"misaligned n = 24, 13, 39; indefinite/non-finite n = 4, 13, "
            f"24, 39, 64; a failed pivot at every column n = 39, 64): "
            f"equal, NaN in the same matrices; branches {branches}")


def k3_k4_bit_checks(dev, rng, kern, Hb=None) -> None:
    """K3 and K4 (kern: {"chol_solve": fn, "chol_factor_solve": fn}, the
    wrappers or the same on a copy's build) against chol_solve_plain and
    chol_factor_solve_plain bit for bit, NaN in the same entries, in
    float32 and float64, with b ~ N(0, 1), on k2_bit_checks' batches: the
    barrier Hessians Hb (where given), every n = 1..32 at B = K2_SWEEP_B,
    the batches of K2_EDGE_B at each band's n, B = K2_LONG_B at K2_LONG_N,
    H, L and b each one element off its allocation at n = 24 and 13, and
    for K4 the indefinite and non-finite batches at n = 4, 13, 24 (x and L
    NaN throughout in exactly the bad matrices). K3 solves with each
    batch's plain factor (the identity in place of a failed one), and at
    n = 4, 13, 24 also with factors holding NaN and inf above the diagonal
    (never read) and with a zero or a NaN on the diagonal (x as the plain
    version's, NaN where it is NaN). Raises at the first batch that
    differs."""
    import torch
    from acados_tpu_torch.ops import batched_chol as bc
    solve, factor_solve = kern["chol_solve"], kern["chol_factor_solve"]

    def off_by_one(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return out[1:].view(t.shape).copy_(t)

    for dtype in (torch.float32, torch.float64):
        def spd(B, n):
            return torch.as_tensor(spd_batch(rng, B, n), dtype=dtype,
                                   device=dev)
        # (name, H, bad matrices or None, one element off)
        batches = [] if Hb is None else [
            (f"barrier Hessians {tuple(Hb.shape)}", Hb.to(dtype), None,
             False)]
        batches += [(f"n={n} B={K2_SWEEP_B}", spd(K2_SWEEP_B, n), None,
                     False) for n in range(1, 33)]
        batches += [(f"n={n} B={B}", spd(B, n), None, False)
                    for n in K2_ROW_N for B in K2_EDGE_B]
        batches += [(f"long n={n} B={K2_LONG_B}", spd(K2_LONG_B, n), None,
                     False) for n in K2_LONG_N]
        batches += [(f"misaligned n={n} B=1023", spd(1023, n), None, True)
                    for n in (24, 13)]
        for n in (4, 13, 24):
            H, bad = indefinite_batch(rng, 1001, n)
            batches.append((f"indefinite/non-finite n={n} B=1001",
                            torch.as_tensor(H, dtype=dtype, device=dev),
                            torch.as_tensor(bad, device=dev), False))
        n3 = 0
        for name, H, bad, shift in batches:
            B, n = H.shape[0], H.shape[-1]
            b = torch.as_tensor(rng.normal(size=(B, n)), dtype=dtype,
                                device=dev)
            L = bc.chol_factor_plain(H)
            L = torch.where(torch.isnan(L).flatten(1).any(1)[:, None, None],
                            torch.eye(n, dtype=dtype, device=dev), L)
            if shift:
                H, L, b = off_by_one(H), off_by_one(L), off_by_one(b)
            x4, L4 = factor_solve(H, b)
            xp, Lp = bc.chol_factor_solve_plain(H, b)
            if not (same_bits(x4, xp) and same_bits(L4, Lp)) or (
                    bad is not None and not (
                        torch.equal(torch.isnan(Lp).flatten(1).all(1), bad)
                        and torch.equal(torch.isnan(x4).all(1), bad))):
                raise SystemExit(f"K4 is not bit for bit its plain version: "
                                 f"{name} {dtype}")
            solves = [(name, L)]
            if n in (4, 13, 24) and bad is None and not shift \
                    and B == K2_SWEEP_B:
                above = torch.ones(n, n, dtype=torch.bool,
                                   device=dev).triu(1)
                garbage = L.clone()
                garbage[0::2, above] = float("nan")
                garbage[1::2, above] = float("inf")
                diag = L.clone()
                diag[0::3, n - 1, n - 1] = 0.0
                diag[1::3, n // 2, n // 2] = float("nan")
                solves += [(f"{name}, NaN/inf above the diagonal", garbage),
                           (f"{name}, zero/NaN on the diagonal", diag)]
            for sname, Ls in solves:
                if not same_bits(solve(Ls, b), bc.chol_solve_plain(Ls, b)):
                    raise SystemExit(f"K3 is not bit for bit its plain "
                                     f"version: {sname} {dtype}")
            n3 += len(solves)
        log(f"  K3/K4 bit for bit, {str(dtype):<14} K4 {len(batches)} "
            f"batches, K3 {n3} (n = 1..32 at B = {K2_SWEEP_B}; n in "
            f"{K2_ROW_N} at B in {K2_EDGE_B}; n in {K2_LONG_N} at B = "
            f"{K2_LONG_B}; H, L, b misaligned at n = 24, 13; indefinite/"
            f"non-finite n = 4, 13, 24; K3's L with NaN/inf above and zero/"
            f"NaN on the diagonal at n = 4, 13, 24): equal, NaN in the same "
            f"entries")


def k2_branch(kname, B, n, fn=None):
    """The branch of csrc/batched_chol.cu that kernel kname takes at
    (B, n, n) (batched_chol.chol_branch) in the build a wrapper fn runs
    (a partial naming a copy's source, or the package's own), or None for
    a build whose source predates the query."""
    from acados_tpu_torch.ops import batched_chol
    source = getattr(fn, "keywords", {}).get("source", "batched_chol")
    try:
        return batched_chol.chol_branch(kname, B, n, source)
    except AttributeError:
        return None


def chol_library(kname):
    """(name, fn(H, L, b)): the library call that computes the function of
    kernel kname (chol_factor: K2, chol_solve: K3, chol_factor_solve: K4)."""
    import torch
    return {
        "chol_factor": ("torch.linalg.cholesky_ex",
                        lambda H, L, b: torch.linalg.cholesky_ex(H)),
        "chol_solve": ("torch.cholesky_solve",
                       lambda H, L, b: torch.cholesky_solve(b[..., None], L)),
        "chol_factor_solve": (
            "cholesky_ex + cholesky_solve",
            lambda H, L, b: torch.cholesky_solve(
                b[..., None], torch.linalg.cholesky_ex(H)[0])),
    }[kname]


def chol_args(kname, H, L, b):
    """The arguments of kernel kname's wrapper."""
    return {"chol_factor": (H,), "chol_solve": (L, b),
            "chol_factor_solve": (H, b)}[kname]


def chol_bound(kname, B, n, dtype):
    """Kernel kname's bound (ms, what bounds it) at (B, n, n) of dtype:
    the lower triangle read, b read and x written, L written (K2, K4);
    chol_flops(n) a matrix for the factor, 2 n^2 for the solve."""
    import torch
    size = torch.empty((), dtype=dtype).element_size()
    peak = FP32_FLOPS if dtype == torch.float32 else FP64_FLOPS
    tri = n * (n + 1) // 2
    factor = kname != "chol_solve"
    solve = kname != "chol_factor"
    return bound_of(B * (tri + factor * n * n + solve * 2 * n) * size,
                    B * (factor * chol_flops(n) + solve * 2 * n * n), peak)


def chol_grid(kname, kerns: dict, parent=None, order=None) -> list:
    """Device ms back to back of each wrapper of kernel kname (chol_factor,
    chol_solve or chol_factor_solve) in kerns ({label: fn}), called in
    turns (order: labels, default each once), over K2's grid (n in
    K2_GRID_N x B in K2_GRID_B and n in K2_WIDE_N at B = 4096 float32,
    (4096, 24, 24) float64, and K2_SMALL_CELLS in both types) on SPD X X'
    / n + I (K3: its library factor) and b ~ N(0, 1), beside the library
    call and the bound. The library's torch.linalg.cholesky_ex is timed
    as the kernels are (device_ms); torch.cholesky_solve waits for the
    host, so K3's and K4's library calls are timed by CUDA events around
    one call. parent: device ms of an earlier build by (n, B, dtype name),
    logged beside."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    order = list(kerns) if order is None else order
    cells = [(n, B, torch.float32) for n in K2_GRID_N for B in K2_GRID_B]
    cells.append((24, 4096, torch.float64))
    cells += [(n, 4096, torch.float32) for n in K2_WIDE_N]
    cells += [(n, B, dtype) for dtype in (torch.float32, torch.float64)
              for n, B in K2_SMALL_CELLS]
    lname, lib_fn = chol_library(kname)
    like = kname == "chol_factor"
    log(f"{kname} grid (device ms back to back; {lname} "
        f"{'the same way' if like else 'CUDA events around one call'}; "
        f"X X' / n + I):")
    rows = []
    for n, B, dtype in cells:
        X = torch.randn((B, n, n), generator=gen, device=dev, dtype=dtype)
        H = X @ X.transpose(1, 2) / n + torch.eye(n, device=dev, dtype=dtype)
        b = torch.randn((B, n), generator=gen, device=dev, dtype=dtype)
        L = torch.linalg.cholesky_ex(H)[0].contiguous()  # row-major
        args = chol_args(kname, H, L, b)
        times = {label: [] for label in kerns}
        for label in order:
            times[label].append(device_ms(lambda: kerns[label](*args)))
        lib = (device_ms(lambda: lib_fn(H, L, b)) if like
               else cuda_ms(lambda: lib_fn(H, L, b), reps=10))
        b_ms, b_by = chol_bound(kname, B, n, dtype)
        dt = str(dtype).split(".")[-1]
        branch = {label: k2_branch(kname, B, n, fn)
                  for label, fn in kerns.items()}
        rows.append(dict(kernel=kname, n=n, B=B, dtype=dt, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib, branch=branch,
                         **{k: float(np.median(v)) for k, v in times.items()}))
        old = (parent or {}).get((n, B, dt))
        log(f"  n={n:2d} B={B:6d} {dt:<7} " + "  ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in v)} ({branch[k]})"
            for k, v in times.items())
            + (f"  (before: {old:.4f})" if old is not None else "")
            + f"  library {lib:.4f}  bound {b_ms:.4f} ({b_by})")
    return rows


def riccati_free_x0(dev) -> None:
    """Phase 10: the Riccati IPM with a free initial state at nx = 16,
    whose P_0 goes through chol_any (K2 on the card, one launch a round),
    float64, card against CPU. The same solve on the card with P_0
    factored by the plain version, K2 on the captured P_0 against the
    plain version, and the CPU solve of inputs moved by one rounding
    step show where the gap between card and CPU comes from."""
    import torch
    from acados_tpu_torch.ocp_qp import data as qp_data
    from acados_tpu_torch.ocp_qp import riccati
    from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp
    from acados_tpu_torch.ops import batched_chol
    from acados_tpu_torch.testing import random_qp_batch
    d = random_qp_batch(SEED, B=256, N=8, nx=16, nu=2, nc=3, x0_rows=False)
    rng = np.random.default_rng(SEED + 1)
    # every number of the problem (not the masks) moved by about one
    # rounding step, up or down
    d_moved = {k: v if "mask" in k else v * (
        1 + np.finfo(np.float64).eps * rng.choice((-1.0, 1.0), v.shape))
        for k, v in d.items()}
    opts = IpmOpts(iter_max=50)
    orig_chol = riccati.chol_any
    p0 = []

    def capture_p0(H):
        p0.append(H.detach().clone())
        return orig_chol(H)

    def solve(data, where, chol=orig_chol):
        qp = qp_data.OcpQp(**{k: torch.as_tensor(v, device=where)
                              for k, v in data.items()})
        riccati.chol_any = chol
        try:
            reset_counts()
            sol, info = solve_ocp_qp(qp, opts, x0_fixed=False)
            return sol, info, read_counts()
        finally:
            riccati.chol_any = orig_chol

    sc, ic, _ = solve(d, "cpu")
    sm, _, _ = solve(d_moved, "cpu")
    sg, ig, counts = solve(d, dev, capture_p0)
    sp, _, counts_p = solve(d, dev, batched_chol.chol_factor_plain)

    def gaps(s, fields=("x", "u", "pi")):
        """Per instance, max |s - cpu| / (1 + |cpu|) over `fields`."""
        out = 0.0
        for f in fields:
            a, b = getattr(s, f).cpu().numpy(), getattr(sc, f).numpy()
            out = np.maximum(out, np.max(
                (np.abs(a - b) / (1 + np.abs(b))).reshape(len(b), -1), 1))
        return out

    g_card, g_moved = gaps(sg), gaps(sm)
    gap, lam_gap = float(g_card.max()), float(
        gaps(sg, ("lam_lg", "lam_ug")).max())
    worst, worst_moved = int(np.argmax(g_card)), int(np.argmax(g_moved))
    fields = ("x", "u", "pi", "lam_lg", "lam_ug")
    plain_same = all(torch.equal(getattr(sg, f), getattr(sp, f))
                     for f in fields)
    k2_same = all(torch.equal(batched_chol.chol_factor_plain(P),
                              batched_chol.chol_factor_batched(P))
                  for P in p0)
    rounds = int(ig.num_iter.max())
    same = (np.array_equal(ig.num_iter.cpu(), ic.num_iter)
            and np.array_equal(ig.status.cpu(), ic.status))
    log(f"Riccati IPM, x0 free, nx=16, B=256, float64: card vs CPU "
        f"max |d|/(1+|ref|) over x, u, pi {gap:.3e} (bound 1e-8; over "
        f"lam_lg, lam_ug {lam_gap:.3e}), equal iterations and statuses "
        f"{same}, K2 launches {counts['chol_factor']} for {rounds} rounds, "
        f"statuses {np.unique(ig.status.cpu()).tolist()}")
    log(f"  worst instance {worst} ({g_card[worst]:.3e}; median instance "
        f"{float(np.median(g_card)):.3e}, {int(np.sum(g_card > 1e-9))} "
        f"above 1e-9); K2 on this run's {len(p0)} P_0 batches equals the "
        f"plain version bit for bit: {k2_same}; the card's solve with P_0 "
        f"factored by the plain version ({counts_p['chol_factor']} K2 "
        f"launches) equals the one through K2 bit for bit: {plain_same}")
    log(f"  CPU against the CPU on inputs moved by one rounding step: "
        f"worst instance {worst_moved} ({g_moved[worst_moved]:.3e}; "
        f"instance {worst} {g_moved[worst]:.3e}; median "
        f"{float(np.median(g_moved)):.3e})")
    # 1e-8: K2 is bit for bit the plain version on these P_0, and the gap
    # is the same without it; one instance amplifies rounding-level
    # differences (cuBLAS against the CPU's BLAS, or a rounding step of
    # its inputs) to a few 1e-9
    if not (same and gap <= 1e-8 and counts["chol_factor"] == rounds
            and len(p0) == rounds and counts_p["chol_factor"] == 0
            and k2_same and plain_same
            and bool((ig.status == 0).all())):
        raise SystemExit("Riccati IPM with P_0 through K2 failed")


def k1_routes(source: str = "gj_inverse") -> dict:
    """The branch K1's dispatcher takes at every n = 1..48 in the build
    of `source` (batched_inv.gj_route), held to the design: the group
    branch in the band n at n = 2, 4, 8, 16 and in the next power of two
    at every other n <= 16 but 1, the warp branch in the next multiple
    of 8 at n = 1 and 17..48. Logged; returns {n: route}."""
    from acados_tpu_torch.ops.batched_inv import _GJ_MAX_N, gj_route
    routes = {n: gj_route(n, source) for n in range(1, _GJ_MAX_N + 1)}
    bad = []
    for n, (branch, band, _) in routes.items():
        want = (("group", 1 << (n - 1).bit_length()) if 2 <= n <= 16
                else ("warp", -(-n // 8) * 8))
        if (branch, band) != want:
            bad.append((n, routes[n], want))
    log(f"  K1 routes: " + "; ".join(
        f"n={n} {route_name(routes[n], n)}" for n in
        tuple(range(1, 18)) + (24, 25, 48))
        + (f"; MISROUTED {bad}" if bad else ""))
    if bad:
        raise SystemExit(f"K1 routes n off the design: {bad}")
    return routes


def route_name(route, n) -> str:
    """A gj_route result in words."""
    branch, band, rows = route
    if branch == "warp":
        return f"warp {band}"
    return f"group {band} RL={rows}" + (" padded" if n < band else "")


def k1_padded_batches(dev, rng, kern):
    """K1 at every n = 3..15 (the group branch, padded to its band at every
    n but 4 and 8) against its plain version, float32 and float64, each
    batch row-major and as a transposed view (check_transposed: bit for
    bit the row-major result, within bound of the plain version): N(0, 1)
    + n I and the same with rows permuted at B = 1001 (no multiple of the
    matrices a warp holds), and the pivot-tie batch, whose kernel result
    must equal the exact inverse in either layout."""
    import torch
    from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
    for n in range(3, 16):
        draws = dict(random=rng.normal(size=(1001, n, n)) + n * np.eye(n),
                     permuted=row_permuted_batch(rng, 1001, n))
        A_tie, X_tie = pivot_tie_batch(rng, 4096, n)
        for dtype, bound in ((torch.float32, F32_BOUND),
                             (torch.float64, F64_BOUND)):
            errs = {}
            for kind, A0 in draws.items():
                A = torch.as_tensor(A0, dtype=dtype, device=dev)
                errs[kind] = max(
                    check_inverse(f"{kind} n={n} B=1001", A, kern, bound,
                                  quiet=True)[0],
                    check_transposed(f"{kind} n={n} B=1001",
                                     transposed_view(A), kern, bound)[0])
            At = torch.as_tensor(A_tie, dtype=dtype, device=dev)
            Xt = torch.as_tensor(X_tie, dtype=dtype, device=dev)
            d_kx = max(float((kern(X) - Xt).abs().max())
                       for X in (At, transposed_view(At)))
            log(f"  padded batches n={n:2d} {str(dtype):<14} both layouts: "
                f"random {errs['random']:.3e}, rows permuted "
                f"{errs['permuted']:.3e} (bound {bound:g}); ties B="
                f"{len(A_tie)} max|k-exact| {d_kx:g}  "
                f"{'ok' if len(A_tie) and d_kx == 0 else 'FAIL'}")
            if not len(A_tie) or d_kx != 0:
                raise SystemExit(f"K1 breaks pivot ties differently: n={n}")


def k1_batches(dev, rng, kern):
    """K1 against its plain version on seeded batches at every n of the
    warp branch's grid and at the group branch's n = 2, 4, 8, 16: random
    N(0, 1) + n I, the same with rows permuted (row swaps at most steps),
    in float32 and float64, and matrices with equal magnitudes in their
    pivot columns, where exact arithmetic makes kernel, plain version and
    exact inverse agree bit for bit only under the lowest-index tie
    rule; then k1_padded_batches at n = 3..15 (its own generator)."""
    import torch
    from acados_tpu_torch.ops.batched_inv import gj_inverse_plain
    from acados_tpu_torch.testing import pivot_tie_batch, row_permuted_batch
    ns = K1_BRANCH_N + K1_GROUP_N
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        for n in ns:
            A = torch.as_tensor(rng.normal(size=(1001, n, n)) + n * np.eye(n),
                                dtype=dtype, device=dev)
            check_inverse(f"random n={n} B=1001", A, kern, bound)
        for n in ns:
            A = row_permuted_batch(rng, 1001, n)
            swaps = np.mean(np.argmax(np.abs(A[:, :, 0]), axis=1) != 0)
            check_inverse(f"rows permuted n={n} (swap at k=0: "
                          f"{swaps:.0%})",
                          torch.as_tensor(A, dtype=dtype, device=dev), kern,
                          bound)
    for n in ns:
        A, X = pivot_tie_batch(rng, 4096, n)
        col0 = np.abs(A[:, :, 0])
        ties = np.sum(np.sum(col0 == col0.max(1, keepdims=True), 1) > 1)
        swaps = np.sum(np.argmax(col0, axis=1) != 0)
        for dtype in (torch.float32, torch.float64):
            At = torch.as_tensor(A, dtype=dtype, device=dev)
            Xt = torch.as_tensor(X, dtype=dtype, device=dev)
            Ak, Ap = kern(At), gj_inverse_plain(At)
            d_kp = float((Ak - Ap).abs().max())
            d_kx = float((Ak - Xt).abs().max())
            ok = len(A) > 0 and d_kp == d_kx == 0
            log(f"  ties n={n} B={len(A)} {str(dtype):<14} (ties at k=0 "
                f"{ties}, swaps {swaps}): max|k-p| {d_kp:g}, "
                f"max|k-exact| {d_kx:g}  bound 0  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K1 breaks pivot ties differently: n={n}")
    k1_padded_batches(dev, np.random.default_rng(K1_PAD_SEED), kern)


def k1_edge_cases(dev, rng, kern):
    """K1 against its plain version where the branches' groups, warps,
    bands and blocks end: every n = 1..48 at a short batch, batches that
    end inside a block of warps (warp branch) or inside a group, a warp or
    a block (group branch, at n = 2, 4, 8, 16 and padded at n = 3, 7, 9,
    15), long batches at n = 2, 3, 16 (more warps than the card holds at
    once), and an input one element off its allocation (not aligned to
    the group branch's vector loads; padded at n = 9). The long batches
    are strictly diagonally dominant with their rows permuted, so they
    pivot and stay well conditioned: 200,003 draws of N(0, 1) + 3 I hold
    matrices so ill-conditioned that the kernel's fused multiply-adds
    alone move their inverses by more than F32_BOUND or F64_BOUND of the
    batch's largest entry (k1_compare.py logs such batches). Each row-major
    batch's transposed view (every batch above but the long ones at n = 2,
    3, one long batch at n = 16, and transposed views misaligned by an
    element at n = 2, 8, 9, 16, 39) goes through check_transposed: bit
    for bit the kernel on its contiguous copy, and within bound."""
    import torch
    from acados_tpu_torch.ops.batched_inv import _GJ_MAX_N
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        cases = [(n, K1_SWEEP_B) for n in range(1, _GJ_MAX_N + 1)]
        cases += [(n, B) for n in K1_EDGE_N for B in K1_EDGE_B]
        cases += [(n, B) for n in K1_GROUP_N for B in K1_GROUP_EDGE_B]
        worst = worst_t = 0.0
        for n, B in cases:
            A = torch.as_tensor(rng.normal(size=(B, n, n)) + n * np.eye(n),
                                dtype=dtype, device=dev)
            worst = max(worst, check_inverse(f"edge n={n} B={B}", A, kern,
                                             bound, quiet=True)[0])
            worst_t = max(worst_t, check_transposed(
                f"edge n={n} B={B}", transposed_view(A), kern, bound)[0])
        for n in K1_LONG_N:
            A = rng.uniform(-1.0, 1.0, (K1_LONG_B, n, n)) + 2 * n * np.eye(n)
            A = torch.as_tensor(np.take_along_axis(
                A, np.argsort(rng.random((K1_LONG_B, n)))[..., None], 1),
                dtype=dtype, device=dev)
            worst = max(worst, check_inverse(
                f"long n={n} B={K1_LONG_B}", A, kern, bound, quiet=True)[0])
            if n == 16:
                worst_t = max(worst_t, check_transposed(
                    f"long n={n} B={K1_LONG_B}", transposed_view(A), kern,
                    bound)[0])
        for n in (2, 8, 16, 39):
            B = 1023
            flat = torch.empty(B * n * n + 1, dtype=dtype, device=dev)
            A = flat[1:].view(B, n, n)
            A.copy_(torch.as_tensor(rng.normal(size=(B, n, n))
                                    + n * np.eye(n), dtype=dtype))
            if n in (2, 16):
                worst = max(worst, check_inverse(
                    f"misaligned n={n} B={B}", A, kern, bound,
                    quiet=True)[0])
            worst_t = max(worst_t, check_transposed(
                f"misaligned n={n} B={B}", A.transpose(-1, -2), kern,
                bound)[0])
        # the padded orders, from a generator of their own: batches that
        # end inside a group, a warp and a block, and a misaligned input
        prng = np.random.default_rng(K1_PAD_SEED)
        pcases = [(n, B) for n in K1_PAD_EDGE_N for B in K1_GROUP_EDGE_B]
        for n, B in pcases + [(9, -1023)]:
            A0 = prng.normal(size=(abs(B), n, n)) + n * np.eye(n)
            if B < 0:       # one element off its allocation
                flat = torch.empty(A0.size + 1, dtype=dtype, device=dev)
                A = flat[1:].view(A0.shape)
                A.copy_(torch.as_tensor(A0, dtype=dtype))
            else:
                A = torch.as_tensor(A0, dtype=dtype, device=dev)
            name = f"{'misaligned' if B < 0 else 'edge'} n={n} B={abs(B)}"
            worst = max(worst, check_inverse(name, A, kern, bound,
                                             quiet=True)[0])
            worst_t = max(worst_t, check_transposed(
                name, transposed_view(A) if B > 0 else A.transpose(-1, -2),
                kern, bound)[0])
        log(f"  edge cases {str(dtype):<14} "
            f"{len(cases) + len(pcases) + len(K1_LONG_N) + 3} batches (n = "
            f"1..{_GJ_MAX_N} at B = {K1_SWEEP_B}; n in {K1_EDGE_N} at B in "
            f"{K1_EDGE_B}; n in {K1_GROUP_N + K1_PAD_EDGE_N} at B in "
            f"{K1_GROUP_EDGE_B}; n in {K1_LONG_N} dominant, rows permuted, "
            f"at B = {K1_LONG_B}; misaligned n = 2, 9, 16): worst "
            f"max|k-p|/max|p| {worst:.3e}, bound {bound:g}, ok; their "
            f"transposed views ({len(cases) + len(pcases) + 6} batches: the "
            f"same, the long one at n = 16 only, misaligned n = 2, 8, 9, 16, "
            f"39) each bit for bit its contiguous copy, worst "
            f"max|k-p|/max|p| {worst_t:.3e}, ok")


def k1_bound(A):
    """K1's bound (ms, what bounds it) at the shape and type of A: each
    input byte read and each output byte written once, and 2 n^3 flops a
    matrix (the in-place Gauss-Jordan's multiply-adds)."""
    import torch
    M, n = A.shape[0], A.shape[-1]
    peak = FP32_FLOPS if A.dtype == torch.float32 else FP64_FLOPS
    return bound_of(2 * M * n * n * A.element_size(), 2 * M * n ** 3, peak)


def k1_grid(kerns: dict, parent=None, order=None, transposed=False,
            cells=K1_WARP_CELLS + K1_GROUP_CELLS) -> list:
    """Device ms back to back of each K1 wrapper in kerns ({label: fn}),
    called in turns (order: labels, default each once), over the cells
    (n, B, type name) (default both branches' grid: K1_WARP_CELLS and
    K1_GROUP_CELLS), beside torch.linalg.inv (CUDA events around one
    call: it waits for the host) and the bound. parent: device ms of an
    earlier build by (n, B, dtype name), logged beside. transposed: each
    wrapper also on the same matrices as a transposed view (label +
    "/tr"), in the same turn."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    order = list(kerns) if order is None else order
    log("K1 grid (device ms back to back; torch.linalg.inv CUDA events "
        "around one call; N(0, 1) + n I):")
    rows = []
    for n, B, dt in cells:
        dtype = getattr(torch, dt)
        A = torch.randn((B, n, n), generator=gen, device=dev, dtype=dtype) \
            + n * torch.eye(n, device=dev, dtype=dtype)
        views = {"": A}
        if transposed:
            views["/tr"] = transposed_view(A)
        times = {label + v: [] for label in kerns for v in views}
        for label in order:
            for v, X in views.items():
                times[label + v].append(device_ms(lambda: kerns[label](X)))
        lib = cuda_ms(lambda: torch.linalg.inv(A), reps=10)
        b_ms, b_by = k1_bound(A)
        row = dict(n=n, B=B, dtype=dt, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib, **{k: float(np.median(v))
                                      for k, v in times.items()})
        rows.append(row)
        old = (parent or {}).get((n, B, dt))
        log(f"  n={n:2d} B={B:6d} {dt:<7} " + "  ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in v)}"
            for k, v in times.items())
            + (f"  (before: {old:.4f})" if old is not None else "")
            + f"  torch.linalg.inv {lib:.4f}  bound {b_ms:.4f} ({b_by})")
    return rows


def k1_entry(name, A, launches, rel, abs_err, before=None) -> dict:
    """K1's kernels-line entry at the shape of A (float32): its time per
    wrapper call and back to back, the plain version's and
    torch.linalg.inv's, and the bound. before: the replaced branch's
    device ms at this shape, logged beside. A as the solver hands it over:
    where it is not contiguous (the IRK stage Jacobians come transposed),
    the wrapper reads it in place or copies it first (input_layout, logged
    and kept as "layout"), and the device time on a contiguous copy is
    given beside."""
    import torch
    from acados_tpu_torch.ops import batched_inv
    kern = batched_inv._gj_inverse_cuda
    M, n = A.shape[0], A.shape[-1]
    layout = batched_inv.input_layout(A)
    k_ms = cuda_ms(lambda: kern(A), reps=30)
    k_dev_ms = device_ms(lambda: kern(A))
    contiguous = {}
    if not A.is_contiguous():
        Ac = A.contiguous()
        contiguous = {"contiguous_device_ms": device_ms(lambda: kern(Ac))}
    p_ms = cuda_ms(lambda: batched_inv.gj_inverse_plain(A), reps=10)
    l_ms = cuda_ms(lambda: torch.linalg.inv(A), reps=20)
    nbytes = 2 * M * n * n * A.element_size()
    flops = 2 * M * n ** 3
    b_ms, b_by = k1_bound(A)
    was = f"; the replaced branch: {before}" if before else ""
    if contiguous:
        how = ("read in place" if layout == "transposed"
               else "the wrapper's copy is in it")
        was += (f"; strides {A.stride()}, layout {layout!r}: {how}; "
                f"{contiguous['contiguous_device_ms']:.4f} ms on a "
                f"contiguous copy")
    branch = route_name(batched_inv.gj_route(n), n)
    log(f"K1 at {tuple(A.shape)} float32 ({branch}): kernel {k_ms:.4f} ms "
        f"(device {k_dev_ms:.4f} ms back to back{was}), plain {p_ms:.4f} "
        f"ms, torch.linalg.inv {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": name, "route": "cuda", "kernel_route": branch,
            "source": "acados_tpu_torch/csrc/gj_inverse.cu",
            "replaces": "acados_tpu/ops/batched_inv.py:39",
            "shape": list(A.shape), "layout": layout, "launches": launches,
            "max_abs_err": abs_err, "max_rel_err_f32": rel, "ms": k_ms,
            "device_ms": k_dev_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms, **contiguous}


def chain_path(dev):
    """Phase 11: the chain RTI batch at full width. Returns K1's kernels
    entry at the chain's shape, the dynamics Jacobians A of one
    linearisation, (B * N, nx, nx), and the warm solver."""
    from acados_tpu_torch.ops import batched_inv
    solver = chain_batch(N_MASS, B_CHAIN, "float32", dev)
    nx = solver.form.nx
    n_calls = 1 + WARM_CALLS + TIMED_CALLS
    reset_counts()
    with K1Shapes() as k1:
        call_ms, qp_max = run_calls(solver, "chain path", tols=CHAIN_TOLS)
    counts = read_counts()
    M = B_CHAIN * N_CHAIN
    log(f"chain path: make_chain_mass_ocp(n_mass={N_MASS}, N={N_CHAIN}), "
        f"nx={nx}, IRK 2 stages kron, B={B_CHAIN}, float32, {n_calls} "
        f"solve() calls, launches {counts}, K1 shapes "
        f"{sorted(set(k1.shapes))}; largest qp_iter per call {qp_max}")
    want = K1_PER_CHAIN_CALL * n_calls
    if counts["gj_inverse"] != want or k1.shapes != [(M, nx, nx)] * want:
        raise SystemExit(f"chain path: expected {want} K1 launches of "
                         f"{(M, nx, nx)}, counted {counts['gj_inverse']}")
    if any(v for k, v in counts.items() if k != "gj_inverse"):
        raise SystemExit(f"chain path: unexpected launches {counts}")
    log(f"  per call: {call_stats(call_ms, B_CHAIN)}; qp_iter max "
        f"{int(solver.get_stats('qp_iter').max())} mean "
        f"{float(solver.get_stats('qp_iter').mean()):.2f}")
    log(f"  time split: {json.dumps(time_split(solver))}")
    # K1 on the block determinants of the cold call's first substep
    D = k1.first
    rel, abs_err, _ = check_inverse(
        f"chain block determinants {tuple(D.shape)}", D,
        batched_inv._gj_inverse_cuda, F32_BOUND)
    entry = k1_entry("gj_inverse_chain", D, counts["gj_inverse"], rel,
                     abs_err, before=K1_PARENT_CHAIN_DEVICE_MS)
    _, qp = linearized(solver)
    return entry, qp.A.reshape(M, nx, nx).contiguous(), solver


def chain_sweep(dev):
    """Phase 12: n_mass = 3, 4, 5, 11 (nx = 9, 15, 21, 57) at B_CHAIN,
    N_CHAIN, float32, 1 cold + SWEEP_WARM warm calls each; K1's route at
    each launch shape logged (the padded group branch at nx = 9, 15)."""
    from acados_tpu_torch.ops.batched_inv import gj_route
    for n_mass, per_call in ((3, 2), (4, 2), (5, 2), (11, 4)):
        solver = chain_batch(n_mass, B_CHAIN, "float32", dev)
        reset_counts()
        with K1Shapes() as k1:
            call_ms, qp_max = run_calls(solver, f"chain n_mass={n_mass}",
                                        tols=CHAIN_TOLS,
                                        warm=SWEEP_WARM - 1, timed=1)
        counts = read_counts()
        calls = 1 + SWEEP_WARM
        shapes = sorted(set(k1.shapes))
        log(f"chain sweep n_mass={n_mass} nx={solver.form.nx}: {calls} "
            f"calls, K1 launches {counts['gj_inverse']} of {shapes} ("
            + ", ".join(route_name(gj_route(m[-1]), m[-1]) for m in shapes)
            + f"), largest qp_iter per call {qp_max}, last call "
            f"{call_ms[0]:.2f} ms")
        if counts["gj_inverse"] != per_call * calls:
            raise SystemExit(f"chain n_mass={n_mass}: expected "
                             f"{per_call * calls} K1 launches")


def same_bits(k, p) -> bool:
    """Equal entry for entry, NaN where the other is NaN."""
    import torch
    nan = torch.isnan(p)
    return bool(torch.equal(torch.isnan(k), nan)) and bool(
        torch.equal(k[~nan], p[~nan]))


def small_mm_phase(dev, A) -> dict:
    """Phase 13: K5 against its plain version bit for bit (the edge cases
    of its pair groups and padded tiles included), then its times over the
    microbenchmark's grid beside torch.bmm and the bound."""
    import torch
    from acados_tpu_torch.ops.small_mm import (SMALL_MM_MAX_N,
                                               small_mm_batched,
                                               small_mm_plain)

    def check(label, X, Y, quiet=False):
        k = small_mm_batched(X, Y)
        torch.cuda.synchronize()
        p = small_mm_plain(X, Y)
        ok = same_bits(k, p)
        fin = torch.isfinite(p)
        err = float((k[fin] - p[fin]).abs().max()) if bool(fin.any()) \
            else 0.0
        if not quiet or not ok:
            log(f"  {label:<40} {str(X.dtype):<14} max|k-p| {err:g}, NaN "
                f"{int(torch.isnan(p).sum())}, bit for bit {ok}")
        if not ok:
            raise SystemExit(f"K5 disagrees with its plain version: {label}")
        return err

    log("K5 small_mm: kernel vs plain version on the card")
    reset_counts()
    small_mm_batched(A, A)
    launches = read_counts()["small_mm"]
    err32 = check(f"chain Jacobians A @ A {tuple(A.shape)}", A, A)
    check(f"chain Jacobians A @ A {tuple(A.shape)}", A.double(), A.double())
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float32, torch.float64):
        for n in (1, 20, 39, 48, 64):
            X, Y = (torch.as_tensor(rng.normal(size=(1001, n, n)),
                                    dtype=dtype, device=dev)
                    for _ in range(2))
            check(f"random n={n} B=1001", X, Y)
        X, Y = (torch.as_tensor(rng.normal(size=(1001, 39, 39)), dtype=dtype,
                                device=dev) for _ in range(2))
        X[::7, 3, 5] = float("nan")
        Y[::5, 11, 2] = float("inf")
        X[::11, 20, 30] = -float("inf")
        check("NaN/inf entries n=39 B=1001", X, Y)
        # the ends of a pair group and the padded tile edge: short and
        # ragged batches, n inside and at the end of a band, and batches
        # with more groups than the card holds blocks
        cases = [(n, B) for n in K5_EDGE_N for B in K5_EDGE_B]
        cases += [(n, K5_LONG_B) for n in (1, 7)]
        cases += [(n, K5_SWEEP_B) for n in range(1, SMALL_MM_MAX_N + 1)]
        for n, B in cases:
            X, Y = (torch.as_tensor(rng.normal(size=(B, n, n)), dtype=dtype,
                                    device=dev) for _ in range(2))
            check(f"edge n={n} B={B}", X, Y, quiet=True)
        log(f"  edge cases {str(dtype):<14} {len(cases)} batches (n in "
            f"{K5_EDGE_N}, B in {K5_EDGE_B}; n = 1, 7 at B = {K5_LONG_B}; "
            f"n = 1..{SMALL_MM_MAX_N} at B = {K5_SWEEP_B}), bit for bit True")

    log("K5 grid, float32 (device ms back to back; torch.bmm with TF32 off):")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in (20, 39, 48, 64):
        for B in (256, 1024, 4096, 10240):
            X, Y = (torch.randn((B, n, n), generator=gen, device=dev)
                    for _ in range(2))
            k_dev = device_ms(lambda: small_mm_batched(X, Y))
            l_dev = device_ms(lambda: torch.bmm(X, Y))
            b_ms, b_by = bound_of(3 * B * n * n * 4, 2 * B * n ** 3)
            log(f"  n={n:2d} B={B:5d}: K5 {k_dev:.4f} ms, torch.bmm "
                f"{l_dev:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    X = A
    M, n = X.shape[0], X.shape[-1]
    k_ms = cuda_ms(lambda: small_mm_batched(X, X), reps=30)
    k_dev = device_ms(lambda: small_mm_batched(X, X))
    p_ms = cuda_ms(lambda: small_mm_plain(X, X), reps=5)
    l_ms = cuda_ms(lambda: torch.bmm(X, X), reps=30)
    l_dev = device_ms(lambda: torch.bmm(X, X))
    nbytes, flops = 3 * M * n * n * X.element_size(), 2 * M * n ** 3
    b_ms, b_by = bound_of(nbytes, flops)
    log(f"K5 at {tuple(X.shape)} float32: kernel {k_ms:.4f} ms (device "
        f"{k_dev:.4f} ms back to back; {K5_PREVIOUS_DEVICE_MS} before the "
        f"register-tiled design), plain {p_ms:.4f} ms, torch.bmm "
        f"{l_ms:.4f} ms (device {l_dev:.4f} ms), bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    X64 = A.double()
    k64 = device_ms(lambda: small_mm_batched(X64, X64))
    l64 = device_ms(lambda: torch.bmm(X64, X64))
    b64, b64_by = bound_of(2 * nbytes, flops, FP64_FLOPS)
    log(f"K5 at {tuple(X.shape)} float64: device {k64:.4f} ms back to "
        f"back, torch.bmm {l64:.4f} ms, bound {b64:.4f} ms ({b64_by}: "
        f"{2 * nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP at "
        f"{FP64_FLOPS / 1e12:g} TFLOP/s)")
    return {"name": "small_mm", "route": "cuda",
            "source": "acados_tpu_torch/csrc/small_mm.cu",
            "replaces": "scratch/bench_smallmm39.py:39",
            "shape": list(X.shape), "launches": launches,
            "solver_path_launches": 0, "max_abs_err": err32, "ms": k_ms,
            "device_ms": k_dev, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "library_device_ms": l_dev,
            "f64_device_ms": k64, "f64_library_device_ms": l64,
            "f64_bound_ms": b64}


def erk_models(dev):
    """Phase 15: the quadrotor and race car RTI batches at bench.py's
    widths, float32."""
    from acados_tpu_torch import models
    from acados_tpu_torch.testing import rti_batch as batch_at
    for name, sigma, kw in ERK_MODELS:
        ocp = getattr(models, f"make_{name}_ocp")(dtype="float32", **kw)
        nx = len(ocp.constraints.x0)
        x0s = np.random.default_rng(SEED).normal(0.0, sigma, (B_ERK, nx))
        solver = batch_at(ocp, x0s, dev)
        reset_counts()
        call_ms, qp_max = run_calls(solver, name, tols=ERK_TOLS,
                                    warm=ERK_WARM, timed=1)
        counts = read_counts()
        log(f"{name}: nx={nx}, N={solver.N}, B={B_ERK}, float32, "
            f"{2 + ERK_WARM} calls, "
            f"launches {counts}, largest qp_iter per call {qp_max}, last "
            f"call {call_ms[0]:.2f} ms")
        if any(counts.values()):
            raise SystemExit(f"{name}: unexpected kernel launches {counts}")


def rti_phases(dev, call_med_ms: float, it0) -> None:
    """Phase 16: prepare() / feedback(x0) cycles on the main path's
    config at STANDARD, from the main path's converged iterate it0.
    call_med_ms: the main path's median solve() call in this run, logged
    beside."""
    from acados_tpu_torch.utils.struct import map_fields
    solver, _ = rti_batch(MAIN_KW, B_MAIN, dev)
    solver._it_dev = map_fields(lambda t: t.clone(), it0)
    solver._host_stale = True
    x0s = solver._data["lb_0"][:, :4].copy()
    prep, fb, bad = [], [], []
    t_prep, t_fb = [], []
    for c in range(1 + RTI_WARM + RTI_TIMED):
        reset_counts()
        solver.prepare()
        prep.append(read_counts())
        reset_counts()
        st = solver.feedback(x0=x0s)
        fb.append(read_counts())
        if np.any(st != 0):
            bad.append(c)
        if c > RTI_WARM:
            t_prep.append(solver.get_stats("time_preparation") * 1e3)
            t_fb.append(solver.get_stats("time_feedback") * 1e3)
    ok_tol, res, tols = in_tolerance(solver)
    want_prep = dict(gj_inverse=LAUNCHES_PER_RTI)
    prep_ok = all(c == {**{k: 0 for k in c}, **want_prep} for c in prep)
    fb_ok = not any(v for c in fb for v in c.values())
    spread = lambda t: (f"median {np.median(t):.2f} ms (p10 "
                        f"{np.percentile(t, 10):.2f}, p90 "
                        f"{np.percentile(t, 90):.2f})")
    log(f"RTI phases: pendulum IRK, B={B_MAIN}, N={N_HORIZON}, float32, "
        f"STANDARD, {len(prep)} prepare()/feedback(x0) cycles from the "
        f"main path's converged iterate; launches in "
        f"each prepare() {prep[-1]} (8 K1 in every one: {prep_ok}), in "
        f"each feedback() {fb[-1]} (none in every one: {fb_ok}); last "
        f"qp_iter max {int(solver.get_stats('qp_iter').max())}")
    log(f"  residual maxima {res.tolist()} vs tolerances {list(tols)}: "
        f"{'in tolerance' if ok_tol else 'OUT OF TOLERANCE'}")
    log(f"  time_preparation {spread(t_prep)}, time_feedback "
        f"{spread(t_fb)} over {len(t_fb)} cycles; the solve() call "
        f"{call_med_ms:.2f} ms (phase 4)")
    if bad or not (ok_tol and prep_ok and fb_ok):
        raise SystemExit(f"RTI phases failed: non-zero statuses in cycles "
                         f"{bad}, in tolerance {ok_tol}, launches "
                         f"{prep_ok} {fb_ok}")


def long_batch(B, dtype, device, cond_N=None, seed=SEED, parallel=False):
    """bench_long_horizon_rti's set-up: the pendulum ERK SQP-RTI OCP at
    N = N_LONG, Tf = 1, x0 per instance = [0, pi, 0, 0] +
    N(0, LONG_SIGMA), with qp_solver_cond_N = cond_N; parallel: the IPM's
    parallel_riccati (bench.py's qp_opts_update)."""
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    ocp = make_pendulum_ocp(N=N_LONG, Tf=1.0, nlp_solver_type="SQP_RTI",
                            dtype=dtype)
    ocp.solver_options.qp_solver_cond_N = cond_N
    rng = np.random.default_rng(seed)
    x0s = np.asarray(X0_CENTER) + rng.normal(0.0, LONG_SIGMA, (B, 4))
    return batch_at(ocp, x0s, device, qp_opts_update=dict(
        parallel_riccati=True) if parallel else None)


def long_variants(B, dtype, dev, cond_N) -> dict:
    """bench.py's three long-horizon variants: plain, cond_N and
    parallel_riccati."""
    return {"plain": long_batch(B, dtype, dev),
            f"cond_N{cond_N}": long_batch(B, dtype, dev, cond_N=cond_N),
            "parallel_riccati": long_batch(B, dtype, dev, parallel=True)}


def check_launches(label, runs: dict) -> None:
    """Of the repo's kernels only K1, and only in the parallel_riccati
    variant: exactly K1_PER_PAR_FACTOR[N_LONG] a lockstep IPM round, i.e.
    times the sum over calls of the batch's largest qp_iter."""
    for name, (_, qp_max, counts) in runs.items():
        want = dict.fromkeys(counts, 0)
        if name == "parallel_riccati":
            want["gj_inverse"] = K1_PER_PAR_FACTOR[N_LONG] * sum(qp_max)
        if counts != want:
            raise SystemExit(f"{label} {name}: expected launches {want}, "
                             f"counted {counts}")


def interleaved(solvers: dict, label, tols, warm, rounds, per_round,
                warmed=(), before_call=None, shared=False) -> dict:
    """Each solver of {name: solver} but those named in `warmed`: 1 cold
    + `warm` calls; then `rounds` rounds in which every solver takes
    `per_round` timed calls in turn. Every status must be 0 and each
    solver's last call in tolerance. Counts are set to 0 before and read
    after each call and summed per solver. before_call(name, timed), if
    given, runs before each call. shared: only the first solver warms
    up; each other one starts from a copy of its warmed iterate and takes
    SHARED_WARM warm calls of its own (the solvers hold the same OCP and
    data). Returns {name: (timed call ms, largest qp_iter per call,
    launch counts)}."""
    import torch
    from acados_tpu_torch.utils.struct import map_fields
    out = {name: ([], [], {}) for name in solvers}

    def call(name, timed):
        s = solvers[name]
        if before_call is not None:
            before_call(name, timed)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = s.solve()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        for k, v in read_counts().items():
            out[name][2][k] = out[name][2].get(k, 0) + v
        out[name][1].append(int(s.get_stats("qp_iter").max()))
        if timed:
            out[name][0].append(dt)
        if np.any(st != 0):
            raise SystemExit(f"{label} {name}: non-zero statuses "
                             f"{np.unique(st, return_counts=True)}")

    first = next(iter(solvers))
    for name, s in solvers.items():
        if name in warmed:
            continue
        if shared and name != first:
            s._it_dev = map_fields(lambda t: t.clone(),
                                   solvers[first]._it_dev)
            s._host_stale = True
            n = SHARED_WARM
        else:
            n = 1 + warm
        for _ in range(n):
            call(name, False)
    for _ in range(rounds):
        for name in solvers:
            for _ in range(per_round):
                call(name, True)
    for name, s in solvers.items():
        ok_tol, res, tl = in_tolerance(s, tols)
        log(f"  {label} {name}: residual maxima {res.tolist()} vs "
            f"tolerances {list(tl)}: "
            f"{'in tolerance' if ok_tol else 'OUT OF TOLERANCE'}")
        if not ok_tol:
            raise SystemExit(f"{label} {name} not in tolerance")
    return out


def long_horizon(dev):
    """Phase 17: bench_long_horizon_rti's three variants at full width,
    in one process; K1 on the largest combine of the parallel Riccati
    (captured in the variant's first timed call). Returns (K1's kernels
    entry there, the plain variant's warm iterate)."""
    import torch
    from acados_tpu_torch.ops import batched_inv
    solvers = long_variants(B_LONG, "float32", dev, COND_LONG)
    orig = batched_inv._gj_inverse_cuda
    grab = {"armed": False, "M": None}

    def record(A, *args, **kw):
        if grab["armed"] and grab["M"] is None \
                and A.shape[0] == PAR_COMBINE_B:
            grab["M"] = A.detach().clone()
        return orig(A, *args, **kw)

    def arm(name, timed):
        grab["armed"] = name == "parallel_riccati" and timed

    batched_inv._gj_inverse_cuda = record
    try:
        runs = interleaved(solvers, "long horizon", LONG_TOLS, LONG_WARM,
                           LONG_ROUNDS, LONG_PER_ROUND, before_call=arm,
                           shared=True)
    finally:
        batched_inv._gj_inverse_cuda = orig
    log(f"long horizon: pendulum ERK SQP-RTI, N={N_LONG}, B={B_LONG}, "
        f"float32, 1 cold + {LONG_WARM} warm calls of the plain variant "
        f"(bench.py warms 25 a variant; cut for the plain variant's call "
        f"time), the others from its iterate with {SHARED_WARM} warm call "
        f"each, then {LONG_ROUNDS} interleaved rounds of {LONG_PER_ROUND} "
        f"timed calls")
    for name, s in solvers.items():
        call_ms, qp_max, counts = runs[name]
        depth = (f"combine levels a factor {K1_PER_PAR_FACTOR[N_LONG]} "
                 f"(the {N_LONG} stages in log depth)"
                 if name == "parallel_riccati" else
                 f"Riccati stages a sweep {s.opts.cond_N or s.form.N}")
        log(f"  {name}: {call_stats(call_ms, B_LONG)}; {depth}; largest "
            f"qp_iter per call {qp_max}; launches of the repo's kernels "
            f"{counts}")
    check_launches("long horizon", runs)
    qp_max = runs["parallel_riccati"][1]
    launches = runs["parallel_riccati"][2]["gj_inverse"]
    log(f"  parallel_riccati: K1 {launches} launches = "
        f"{K1_PER_PAR_FACTOR[N_LONG]} a factor x {sum(qp_max)} lockstep IPM "
        f"rounds over {len(qp_max)} calls")

    # K1 on the largest combine level against its plain version
    M = grab["M"]
    if M is None or M.shape != (PAR_COMBINE_B, 4, 4):
        raise SystemExit("no (65536, 4, 4) combine captured")
    Mk = batched_inv._gj_inverse_cuda(M)
    torch.cuda.synchronize()
    Mp = batched_inv.gj_inverse_plain(M)
    abs_err = float((Mk - Mp).abs().max())
    rel = abs_err / float(Mp.abs().max())
    eye = torch.eye(4, dtype=M.dtype, device=dev)
    resid = float((M @ Mk - eye).abs().max())
    bits = int((Mk != Mp).sum())
    cond = float(torch.linalg.cond(M.double()).max())
    ok = rel <= F32_BOUND and bool(torch.isfinite(Mk).all())
    log(f"  K1 on the captured combine {tuple(M.shape)} float32 "
        f"(I + C_i J_j, largest condition number {cond:.3e}): "
        f"max|k-p|/max|p| {rel:.3e} (bound {F32_BOUND:g}), "
        f"max|M Minv - I| {resid:.3e}, {bits} of {Mk.numel()} entries "
        f"differ in their bits from the plain version: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("K1 disagrees with its plain version on the "
                         "parallel Riccati's combine")
    entry = k1_entry("gj_inverse_par_riccati", M, launches, rel, abs_err)
    entry["bits_differing"] = bits
    return entry, solvers["plain"]._it_dev


def chain_cond(dev, plain) -> dict:
    """Phase 18: the chain at qp_solver_cond_N = COND_CHAIN beside phase
    11's warm plain chain, interleaved. Returns K2's kernels entry at the
    condensed stages' (B, 15, 15) Huu."""
    import torch
    from acados_tpu_torch.ocp_qp import riccati
    from acados_tpu_torch.ops import batched_chol
    solver = chain_batch(N_MASS, B_CHAIN, "float32", dev, cond_N=COND_CHAIN)
    nu_c = (N_CHAIN // COND_CHAIN) * solver.form.nu
    huu = []
    orig = riccati.chol_any

    def capture(H):
        if len(huu) < COND_CHAIN:   # the cold call's first round
            huu.append(H.detach().clone())
        return orig(H)

    riccati.chol_any = capture
    try:
        runs = interleaved({"plain": plain, "cond": solver}, "chain",
                           CHAIN_TOLS, WARM_CALLS, CHAIN_ROUNDS,
                           CHAIN_PER_ROUND, warmed=("plain",))
    finally:
        riccati.chol_any = orig
    cond_ms, qp_max, counts = runs["cond"]
    plain_ms = runs["plain"][0]
    calls = len(qp_max)
    want_k2 = COND_CHAIN * 1 * sum(qp_max)
    log(f"chain at cond_N={COND_CHAIN}: n_mass={N_MASS}, N={N_CHAIN}, "
        f"B={B_CHAIN}, float32, {calls} solve() calls, blocks of "
        f"{N_CHAIN // COND_CHAIN} stages, condensed nu={nu_c}; launches "
        f"{counts}; largest qp_iter per call {qp_max} (sum "
        f"{sum(qp_max)}: K2 expected {COND_CHAIN} stages x 1 factorization "
        f"a round x {sum(qp_max)} rounds = {want_k2})")
    log(f"  interleaved, {CHAIN_ROUNDS} rounds of {CHAIN_PER_ROUND}: "
        f"cond_N={COND_CHAIN} {call_stats(cond_ms, B_CHAIN)}; plain "
        f"{call_stats(plain_ms, B_CHAIN)}")
    if counts["chol_factor"] != want_k2 or \
            counts["gj_inverse"] != K1_PER_CHAIN_CALL * calls or any(
                counts[k] for k in ("chol_solve", "chol_factor_solve",
                                    "small_mm")):
        raise SystemExit(f"chain cond: expected {want_k2} K2 and "
                         f"{K1_PER_CHAIN_CALL * calls} K1 launches, "
                         f"counted {counts}")
    split = time_split(solver)
    log(f"  cond_N={COND_CHAIN}: Riccati stages a sweep "
        f"{split['riccati_stages']}; QP {split['qp_ms']:.2f} "
        f"of {split['call_ms']:.2f} ms ({split['qp_share'] * 100:.1f} %)")
    log(f"    time split: {json.dumps(split)}")
    # K2 on the path's own Huu batches against its plain version
    if len(huu) != COND_CHAIN or any(H.shape != (B_CHAIN, nu_c, nu_c)
                                     for H in huu):
        raise SystemExit(f"captured {len(huu)} Huu batches "
                         f"{[tuple(H.shape) for H in huu]}")
    kern = batched_chol.chol_factor_batched
    abs_err = 0.0
    for H in huu:
        Lk, Lp = kern(H), batched_chol.chol_factor_plain(H)
        torch.cuda.synchronize()
        if not same_bits(Lk, Lp) or not bool(torch.isfinite(Lk).all()):
            raise SystemExit("K2 disagrees with its plain version on the "
                             "chain's condensed Huu")
        abs_err = max(abs_err, float((Lk - Lp).abs().max()))
    H = huu[0]
    k_ms = cuda_ms(lambda: kern(H), reps=30)
    k_dev = device_ms(lambda: kern(H))
    p_ms = cuda_ms(lambda: batched_chol.chol_factor_plain(H), reps=10)
    l_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(H), reps=20)
    l_dev = device_ms(lambda: torch.linalg.cholesky_ex(H))
    b_ms, b_by = chol_bound("chol_factor", B_CHAIN, nu_c, H.dtype)
    branch = k2_branch("chol_factor", B_CHAIN, nu_c)
    log(f"K2 on the chain's {len(huu)} condensed Huu batches "
        f"{tuple(H.shape)} float32 ({branch} branch): bit for bit with "
        f"chol_factor_plain; kernel {k_ms:.4f} ms (device {k_dev:.4f} ms "
        f"back to back), plain {p_ms:.4f} ms, torch.linalg.cholesky_ex "
        f"{l_ms:.4f} ms (device {l_dev:.4f} ms back to back), bound "
        f"{b_ms:.4f} ms ({b_by})")
    return {"name": "chol_factor_chain_cond8", "route": "cuda",
            "source": "acados_tpu_torch/csrc/batched_chol.cu",
            "replaces": "acados_tpu/ops/batched_chol.py:38",
            "branch": branch,
            "shape": list(H.shape), "launches": counts["chol_factor"],
            "max_abs_err": abs_err, "ms": k_ms, "device_ms": k_dev,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "library_device_ms": l_dev}


def new_paths_vs_cpu() -> None:
    """Phase 19: float64 card against CPU of the long-horizon pendulum
    at cond_N = 16, the chain at cond_N = 8 and the RTI phases, one RTI
    call or cycle each (cut from 2)."""
    card_vs_cpu(f"long-horizon reference check (N={N_LONG}, "
                f"cond_N={COND_LONG})",
                lambda where: long_batch(4, "float64", where,
                                         cond_N=COND_LONG, seed=1), calls=1)
    card_vs_cpu(f"chain reference check (n_mass={N_MASS}, N={N_CHAIN}, "
                f"cond_N={COND_CHAIN})",
                lambda where: chain_batch(N_MASS, 4, "float64", where,
                                          cond_N=COND_CHAIN), calls=1)
    kw64 = dict(N=N_HORIZON, dtype="float64", nlp_solver_type="SQP_RTI",
                integrator_type="IRK")
    card_vs_cpu("RTI phases reference check (prepare/feedback)",
                lambda where: rti_batch(kw64, 8, where, seed=1)[0],
                step=lambda s: (s.prepare(), s.feedback())[1], calls=1)


# the simulator (phase 20): the main path's integrator, dt = Tf / N, and
# K1's launches a call with sens_forw: per substep 3 Newton inverses and
# one for the implicit gradient's tangent solve, 2 substeps
B_SIM, SIM_DT, SIM_WARM, SIM_TIMED = 4096, 1.0 / 20, 3, 5  # timed cut from 10
K1_PER_SIM = 8
# the sensitivities (phase 21): bench.py's bench_pendulum_irk_sqp config,
# solved in at most this many solve() calls; the forward-adjoint gap is
# held to 10 x the largest gap the JAX package shows between its own
# forward and adjoint float32 sensitivities on the same config and seeds
# (acados_tpu_torch.testing.JAX_SENS_F32_GAP)
SQP_SOLVES_MAX = 8
# K1 and K2 launches an eval_solution_sensitivity call on the main path
# (KktFactor: linearize 8, the stage-0 and path Hessians 2 x 14; the
# forward sensitivities' linearize 8) and on the chain (linearize 2, the
# Hessians 2 x 28 through the Schur split of nw = 78, the forward
# linearize 2; K2 once, P_0); the adjoint reuses the factor: one
# linearize under vjp (8 main, 2 chain)
K1_PER_FWD_SENS, K1_PER_ADJ_SENS = 44, 8
K1_PER_FWD_SENS_CHAIN, K1_PER_ADJ_SENS_CHAIN = 60, 2
# the chain's x0 rows are barrier rows (not eliminated) whose weights
# lam / t are finite, so its dx_0 / dx0 is the identity only to ~1e-4
CHAIN_EYE_BOUND = 1e-3
# the differentiable solver (phase 22): the parametric pendulum's swing-up
# from pi / 2 with x0 and p spread per instance (at spreads of 0.05 and
# 0.01 a full-step SQP instance can stop at its 200 iterations)
B_DIFF, DIFF_X0_SIGMA, DIFF_P_SIGMA = 1024, 0.01, 0.005
# float64 card against CPU of the new paths (phase 23)
B_CHECK = 4
# the chain's float64 sensitivities of phase 23 after this many RTI calls
# (cut from 3)
CHAIN_SENS_CALLS = 2


def sim_solver(integrator_type, B, dtype, dev, sens_hess=False):
    """AcadosSimBatchSolver on the pendulum with the main path's
    integrator settings (IRK: Gauss-Legendre 4 stages; ERK: RK4; both 2
    substeps over SIM_DT), float32 unless dtype says otherwise."""
    from acados_tpu_torch import AcadosSim, AcadosSimBatchSolver
    from acados_tpu_torch.models.pendulum import export_pendulum_model
    sim = AcadosSim()
    sim.model = export_pendulum_model()
    so = sim.solver_options
    so.T, so.integrator_type, so.num_stages, so.num_steps = \
        SIM_DT, integrator_type, 4, 2
    so.dtype, so.sens_forw = dtype, True
    so.sens_adj = so.sens_hess = sens_hess
    return AcadosSimBatchSolver(sim, B, device=dev)


def sim_inputs(B, seed=SEED):
    rng = np.random.default_rng(seed)
    x = np.asarray(X0_CENTER) + rng.normal(0.0, X0_SIGMA, (B, 4))
    u = rng.normal(0.0, 10.0, (B, 1))
    return x, u


def simulator(dev) -> dict:
    """Phase 20: the batch simulator at B_SIM, IRK and ERK. Returns K1's
    kernels entry at the simulator's stage Jacobians."""
    import torch
    x, u = sim_inputs(B_SIM)
    entry = None
    for itype in ("IRK", "ERK"):
        sim = sim_solver(itype, B_SIM, "float32", dev)
        for _ in range(SIM_WARM):
            sim.simulate(x, u)
        reset_counts()
        times = []
        for _ in range(SIM_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xn = sim.simulate(x, u)   # ends in a host copy of xn
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        S = sim.get("S_forw")
        ok = (np.isfinite(xn).all() and np.isfinite(S).all()
              and xn.shape == (B_SIM, 4) and S.shape == (B_SIM, 4, 5))
        want = K1_PER_SIM if itype == "IRK" else 0
        med = float(np.median(times))
        log(f"simulator {itype}: B={B_SIM}, float32, sens_forw, "
            f"{SIM_TIMED} calls: median {med:.2f} ms (p10 "
            f"{np.percentile(times, 10):.2f}, p90 "
            f"{np.percentile(times, 90):.2f}) -> "
            f"{B_SIM / med * 1e3:.1f} sims/s; K1 launches a call "
            f"{counts['gj_inverse'] / SIM_TIMED:g} (expected {want}); "
            f"launches {counts}")
        if not ok or counts["gj_inverse"] != want * SIM_TIMED or any(
                v for k, v in counts.items() if k != "gj_inverse"):
            raise SystemExit(f"simulator {itype}: bad output or launches "
                             f"{counts}")
        if itype == "IRK":
            with K1Shapes() as k1:
                sim.simulate(x, u)
            J = k1.first
            if J.shape != (B_SIM, 16, 16) or len(k1.shapes) != want:
                raise SystemExit(f"simulator K1 shapes {k1.shapes}")
            from acados_tpu_torch.ops import batched_inv
            Jk = batched_inv._gj_inverse_cuda(J)
            Jp = batched_inv.gj_inverse_plain(J)
            torch.cuda.synchronize()
            differ = int((Jk != Jp).sum())
            log(f"  K1 on the captured stage Jacobians {tuple(J.shape)}: "
                f"{differ} of {Jk.numel()} entries differ in their bits "
                f"from the plain version (the kernel fuses multiply-adds)")
            rel, abs_err, _ = check_inverse(
                f"simulator stage Jacobians {tuple(J.shape)}", J,
                batched_inv._gj_inverse_cuda, F32_BOUND)
            entry = k1_entry("gj_inverse_sim", J,
                             counts["gj_inverse"], rel, abs_err)
            entry["bits_differing"] = differ
    return entry


def sens_batch(B, dtype, dev, seed=SEED):
    """bench_pendulum_irk_sqp's batch (SQP, IRK, N = 20), solved until
    every status is 0 (at most SQP_SOLVES_MAX solve() calls, each from
    the last one's iterate). Returns the solver and the calls taken."""
    kw = dict(N=N_HORIZON, dtype=dtype, nlp_solver_type="SQP",
              integrator_type="IRK")
    solver, _ = rti_batch(kw, B, dev, seed=seed)
    for calls in range(1, SQP_SOLVES_MAX + 1):
        if np.all(solver.solve() == 0):
            return solver, calls
    raise SystemExit(f"SQP batch B={B} {dtype}: statuses not all 0 after "
                     f"{SQP_SOLVES_MAX} solve() calls")


def consistency(solver, dev=None):
    """Forward sensitivities of every stage to the initial state, the
    adjoint seeded on u_0, and their per-instance gap max|adj - fwd| /
    max|fwd| (fwd = d u_0 / d x0 summed over u's entries)."""
    B, nu = solver.N_batch, solver.form.nu
    sx, su = solver.eval_solution_sensitivity(list(range(solver.N + 1)),
                                              "initial_state")
    adj = solver.eval_adjoint_solution_sensitivity(
        None, [(0, np.ones((B, nu)))], with_respect_to="initial_state")
    fwd = su[:, 0].sum(axis=1)
    gap = np.abs(adj - fwd).max(axis=1) / np.abs(fwd).max(axis=1)
    return sx, su, adj, gap


def sensitivities(dev) -> dict:
    """Phase 21: the batched sensitivities on the main path's width, then
    the chain's. Returns K2's kernels entry at the chain's P_0."""
    import torch
    from acados_tpu_torch.ocp_qp import riccati
    from acados_tpu_torch.ops import batched_chol
    from acados_tpu_torch.testing import JAX_SENS_F32_GAP
    bound = 10 * JAX_SENS_F32_GAP
    solver, calls = sens_batch(B_MAIN, "float32", dev)
    ok_tol, res, tols = in_tolerance(solver)
    log(f"sensitivities: pendulum IRK SQP, B={B_MAIN}, N={N_HORIZON}, "
        f"float32: every status 0 after {calls} solve() calls, residual "
        f"maxima {res.tolist()} ({'in' if ok_tol else 'OUT OF'} "
        f"tolerance), sqp_iter max {int(solver.get_stats('sqp_iter').max())}")
    # this is bench_pendulum_irk_sqp's Gauss-Newton solve, which phase 27
    # once ran beside the Newton SQP: every status 0 and in tolerance in
    # one call from the initial iterate
    if calls != 1 or not ok_tol:
        raise SystemExit("the Gauss-Newton SQP did not solve in one call")
    reset_counts()
    t0 = time.perf_counter()
    sx, su, adj, gap = consistency(solver)
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    worst = int(np.argmax(gap))
    finite = all(np.isfinite(a).all() for a in (sx, su, adj))
    eye_gap = float(np.abs(sx[:, 0] - np.eye(4)).max())
    want = K1_PER_FWD_SENS + K1_PER_ADJ_SENS
    log(f"  eval_solution_sensitivity (21 stages, initial_state) + "
        f"eval_adjoint_solution_sensitivity (seed on u_0): {ms:.1f} ms; "
        f"launches {counts} (K1 expected {K1_PER_FWD_SENS} + "
        f"{K1_PER_ADJ_SENS}); forward-adjoint gap max {gap[worst]:.3e} "
        f"(instance {worst}, median {np.median(gap):.3e}; bound "
        f"{bound:.2e}); max|dx_0/dx0 - I| {eye_gap:.2e}")
    if not finite or not ok_tol or gap[worst] > bound \
            or eye_gap > 1e-4 or counts["gj_inverse"] != want \
            or counts["chol_factor"]:
        raise SystemExit("sensitivities on the main path failed")

    # the chain: P_0 (nx = 39 > 12) goes through chol_any, K2. In float64:
    # its active wall rows give barrier weights lam / t up to ~1e10 (t at
    # the t_lam_min floor, 1e-9), and in float32 Huu or P_0 then loses
    # positive definiteness in some instances (NaN sensitivities)
    chain = chain_batch(N_MASS, B_CHAIN, "float64", dev)
    for _ in range(1 + 5):
        st = chain.solve()
    if np.any(st != 0):
        raise SystemExit("chain: non-zero statuses before the "
                         "sensitivities")
    p0s = []
    orig = riccati.chol_any

    def capture(H):
        p0s.append(H.detach().clone())
        return orig(H)

    riccati.chol_any = capture
    reset_counts()
    try:
        t0 = time.perf_counter()
        csx, csu, cadj, cgap = consistency(chain)
        cms = (time.perf_counter() - t0) * 1e3
    finally:
        riccati.chol_any = orig
    counts = read_counts()
    want = K1_PER_FWD_SENS_CHAIN + K1_PER_ADJ_SENS_CHAIN
    ceye = float(np.abs(csx[:, 0] - np.eye(csx.shape[-1])).max())
    log(f"chain sensitivities: n_mass={N_MASS}, N={N_CHAIN}, "
        f"B={B_CHAIN}, float64, after 6 RTI calls: {cms:.1f} ms; launches "
        f"{counts} (K1 expected {want}, K2 1); forward-adjoint gap max "
        f"{cgap.max():.3e} (median {np.median(cgap):.3e}); max|dx_0/dx0 "
        f"- I| {ceye:.2e}; captured P_0 {[tuple(H.shape) for H in p0s]}")
    if len(p0s) != 1 or p0s[0].shape != (B_CHAIN, 39, 39) or \
            counts["chol_factor"] != 1 or counts["gj_inverse"] != want or \
            not all(np.isfinite(a).all() for a in (csx, csu, cadj)) or \
            ceye > CHAIN_EYE_BOUND or cgap.max() > 1e-9:
        raise SystemExit("chain sensitivities failed")
    H = p0s[0]
    kern = batched_chol.chol_factor_batched
    Lk, Lp = kern(H), batched_chol.chol_factor_plain(H)
    torch.cuda.synchronize()
    if not same_bits(Lk, Lp) or not bool(torch.isfinite(Lk).all()):
        raise SystemExit("K2 disagrees with its plain version on the "
                         "chain's P_0")
    k_ms = cuda_ms(lambda: kern(H), reps=30)
    k_dev = device_ms(lambda: kern(H))
    p_ms = cuda_ms(lambda: batched_chol.chol_factor_plain(H), reps=10)
    l_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(H), reps=20)
    l_dev = device_ms(lambda: torch.linalg.cholesky_ex(H))
    b_ms, b_by = chol_bound("chol_factor", B_CHAIN, 39, H.dtype)
    branch = k2_branch("chol_factor", B_CHAIN, 39)
    log(f"K2 on the chain's P_0 {tuple(H.shape)} float64 ({branch} "
        f"branch): bit for bit with chol_factor_plain; kernel {k_ms:.4f} "
        f"ms (device {k_dev:.4f} ms back to back), plain {p_ms:.4f} ms, "
        f"torch.linalg.cholesky_ex {l_ms:.4f} ms (device {l_dev:.4f} ms "
        f"back to back), bound {b_ms:.4f} ms ({b_by})")
    if branch != "block":
        raise SystemExit(f"K2 took the {branch} branch at the chain's P_0")
    # the same matrices in float32, for the kernel table's float32 rows
    H32 = H.float()
    if not same_bits(kern(H32), batched_chol.chol_factor_plain(H32)):
        raise SystemExit("K2 disagrees with its plain version on the "
                         "chain's P_0 in float32")
    f32 = dict(ms_f32=cuda_ms(lambda: kern(H32), reps=30),
               device_ms_f32=device_ms(lambda: kern(H32)),
               plain_ms_f32=cuda_ms(
                   lambda: batched_chol.chol_factor_plain(H32), reps=10),
               library_ms_f32=cuda_ms(lambda: torch.linalg.cholesky_ex(H32),
                                      reps=20),
               library_device_ms_f32=device_ms(
                   lambda: torch.linalg.cholesky_ex(H32)),
               bound_ms_f32=chol_bound("chol_factor", B_CHAIN, 39,
                                       H32.dtype)[0])
    log(f"  the same P_0 as float32 (bit for bit too): {json.dumps(f32)}")
    return {"name": "chol_factor_chain_p0", "route": "cuda",
            "source": "acados_tpu_torch/csrc/batched_chol.cu",
            "replaces": "acados_tpu/ops/batched_chol.py:38",
            "branch": branch,
            "shape": list(H.shape), "launches": counts["chol_factor"],
            "max_abs_err": float((Lk - Lp).abs().max()), "ms": k_ms,
            "device_ms": k_dev, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
            "library_device_ms": l_dev, "dtype": "float64", **f32}


def diff_batch(B, dev, seed=SEED):
    """The parametric pendulum of the sensitivity tests (float64, SQP to
    1e-11) at B instances, x0 and p spread per instance, solved."""
    from acados_tpu_torch.interface.batch_solver import AcadosOcpBatchSolver
    from acados_tpu_torch.testing import param_pendulum_ocp
    ocp = param_pendulum_ocp(N=N_HORIZON)
    solver = AcadosOcpBatchSolver(ocp, B, device=dev)
    rng = np.random.default_rng(seed)
    x0s = np.array([0.0, np.pi / 2, 0.0, 0.0]) + rng.normal(
        0, DIFF_X0_SIGMA, (B, 4))
    ps = np.array([0.1, 0.8]) + rng.normal(0, DIFF_P_SIGMA, (B, 2))
    for i, view in enumerate(solver.ocp_solvers):
        view.set(0, "lbx", x0s[i])
        view.set(0, "ubx", x0s[i])
        for k in range(N_HORIZON + 1):
            view.set(k, "x", x0s[i])
            view.set(k, "p", ps[i])
    st = solver.solve()
    if np.any(st != 0):
        raise SystemExit(f"parametric pendulum B={B}: statuses "
                         f"{np.unique(st, return_counts=True)}")
    return solver


def diff_grad(solver):
    """The gradient of 0.5 |u_0|^2 with respect to every stage's p,
    through make_diff_solver (forward: the SQP solve from the solver's
    iterate; backward: KktFactor + adjoint_sensitivity), beside
    eval_adjoint_solution_sensitivity's. Returns (grad, reference,
    forward ms, backward ms)."""
    import torch
    from acados_tpu_torch.interface.solver import _sqp_opts_from
    from acados_tpu_torch.ocp_nlp.sensitivity import make_diff_solver
    data, it = solver._on_device()
    solve_diff = make_diff_solver(solver.form,
                                  _sqp_opts_from(solver.acados_ocp))
    p = data.p.clone().requires_grad_()
    sync = (torch.cuda.synchronize if p.is_cuda else lambda: None)
    t0 = time.perf_counter()
    _, us = solve_diff(data.replace(p=p), it)
    sync()
    t1 = time.perf_counter()
    (g,) = torch.autograd.grad(0.5 * (us[:, 0] ** 2).sum(), p)
    sync()
    t2 = time.perf_counter()
    u0 = us[:, 0].detach().cpu().numpy()
    ref = solver.eval_adjoint_solution_sensitivity(
        None, [(0, u0)], with_respect_to="p_stagewise")
    return g.cpu().numpy(), ref, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def diff_solver(dev) -> None:
    """Phase 22: make_diff_solver's backward on the card."""
    solver = diff_batch(B_DIFF, dev)
    reset_counts()
    g, ref, f_ms, b_ms = diff_grad(solver)
    counts = read_counts()
    gap = float(np.abs(g - ref).max() / np.abs(ref).max())
    log(f"differentiable solver: parametric pendulum ERK, B={B_DIFF}, "
        f"N={N_HORIZON}, float64: forward (SQP from the solution) "
        f"{f_ms:.1f} ms, backward (KktFactor + adjoint) {b_ms:.1f} ms; "
        f"d(0.5 |u_0|^2)/dp against eval_adjoint_solution_sensitivity "
        f"max|d|/max|ref| {gap:.3e} (bound 1e-9); launches {counts}")
    if not np.isfinite(g).all() or gap > 1e-9 or any(counts.values()):
        raise SystemExit("differentiable solver failed")


def rel_gap(a, b) -> float:
    """max |a - b| / (1 + |b|)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / (1 + np.abs(b))))


def sens_vs_cpu() -> None:
    """Phase 23: float64 card against CPU of phases 20-22 at B_CHECK."""
    import torch
    x, u = sim_inputs(B_CHECK, seed=1)
    seed = np.random.default_rng(2).normal(size=(B_CHECK, 4))

    def outputs(where) -> dict:
        """The simulators' outputs, the sensitivities and the
        differentiable solver's gradient on `where`, as numpy."""
        out = {}
        for itype in ("IRK", "ERK"):
            sim = sim_solver(itype, B_CHECK, "float64", where,
                             sens_hess=True)
            r = sim._one._run(x, u, np.zeros((B_CHECK, 0)), seed)
            for f in ("xn", "S_forw", "S_adj", "S_hess"):
                out[f"sim {itype} {f}"] = getattr(r, f).cpu().numpy()
        s, _ = sens_batch(B_CHECK, "float64", where, seed=1)
        sx, su, adj, _ = consistency(s)
        g, _, _, _ = diff_grad(diff_batch(B_CHECK, where, seed=1))
        out.update({"sens x": sx, "sens u": su, "adjoint": adj,
                    "diff solver grad": g})
        return out

    def chain_sens(where, moved=False):
        c = chain_batch(N_MASS, 4, "float64", where, moved=moved)
        for _ in range(CHAIN_SENS_CALLS):
            c.solve()
        return consistency(c)[:3]

    ref = cpu_half("phase 23: simulators, sensitivities, differentiable "
                   "solver", lambda: outputs("cpu"))
    chain_ref, chain_moved = cpu_half(
        "phase 23: chain sensitivities",
        lambda: (chain_sens("cpu"), chain_sens("cpu", True)))
    if not card_half():
        return
    card = outputs(torch.device("cuda"))
    gaps = {k: rel_gap(card[k], ref[k]) for k in ref}
    worst = max(gaps, key=gaps.get)
    log(f"new paths, float64 card against CPU (B={B_CHECK}): max "
        f"|d|/(1+|ref|) by output {json.dumps(gaps)}; worst {worst} "
        f"{gaps[worst]:.3e} (bound 1e-9)")
    if not gaps[worst] <= 1e-9:
        raise SystemExit("new paths: card and CPU disagree")
    # the chain's sensitivities are ill-conditioned (barrier weights up to
    # ~1e10 on its active wall rows): the CPU's own results move by more
    # than 1e-9 when x0 moves by one rounding step, so the card's gap is
    # held to that spread where it exceeds 1e-9
    card = [rel_gap(a, b) for a, b in zip(chain_sens(torch.device("cuda")),
                                          chain_ref)]
    spread = [rel_gap(a, b) for a, b in zip(chain_moved, chain_ref)]
    log(f"chain sensitivities (n_mass={N_MASS}, B=4, {CHAIN_SENS_CALLS} "
        f"RTI calls), float64 card against CPU: sens x, sens u, adjoint "
        f"{['%.3e' % g for g in card]}; the CPU against itself on x0s "
        f"moved by one rounding step {['%.3e' % g for g in spread]}")
    if not all(g <= max(1e-9, sp) for g, sp in zip(card, spread)):
        raise SystemExit("chain sensitivities: card and CPU disagree "
                         "beyond the CPU's own spread")


def latency(dev, it_long) -> None:
    """Phase 24: bench_latency, the three long-horizon variants at
    B = B_LAT (one controller's batch), interleaved: the median call with
    p10/p90 beside each other, every status 0, _LONGH_TOLS met, K1 only
    in the parallel variant at 13 a lockstep IPM round. The plain
    variant starts from it_long, phase 17's warm plain iterate, whose
    first B_LAT instances have these x0s (the same seeded draw), and
    takes LAT_WARM calls from there."""
    from acados_tpu_torch.utils.struct import map_fields
    solvers = long_variants(B_LAT, "float32", dev, COND_LAT)
    solvers["plain"]._it_dev = map_fields(lambda t: t[:B_LAT].clone(),
                                          it_long)
    solvers["plain"]._host_stale = True
    runs = interleaved(solvers, "latency", LONG_TOLS, LAT_WARM, LAT_ROUNDS,
                       LAT_PER_ROUND, shared=True)
    log(f"latency: pendulum ERK SQP-RTI, N={N_LONG}, B={B_LAT}, float32, "
        f"the plain variant from phase 17's warm iterate, 1 + {LAT_WARM} "
        f"warm calls (bench.py warms 25 a variant from the swing-up), the "
        f"others from its iterate with {SHARED_WARM} warm call each, then "
        f"{LAT_ROUNDS} interleaved rounds of {LAT_PER_ROUND} timed calls")
    for name, (call_ms, qp_max, counts) in runs.items():
        med = float(np.median(call_ms))
        p10, p90 = (float(np.percentile(call_ms, q)) for q in (10, 90))
        log(f"  latency {name}: median {med:.2f} ms (p10 {p10:.2f}, p90 "
            f"{p90:.2f}) over {len(call_ms)} calls; largest qp_iter per "
            f"call {qp_max}; launches {counts}")
    check_launches("latency", runs)


def admm_phase(dev) -> None:
    """Phase 25: bench_admm_backend, the pendulum ERK SQP-RTI (N = 20) at
    B = B_ADMM with the Riccati IPM beside qp_solver_name="ADMM": the IPM
    warms up from the swing-up start, the ADMM variant starts from the
    IPM's iterate after ADMM_FROM_IPM_CALL calls, then interleaved
    rounds; every status 0, the OCP's own nlp tolerances (stat, eq) met,
    no launch of the repo's kernels."""
    from acados_tpu_torch.utils.struct import map_fields
    kw = dict(N=N_ADMM, dtype="float32", nlp_solver_type="SQP_RTI")
    ipm = rti_batch(kw, B_ADMM, dev, sigma=ADMM_SIGMA)[0]
    admm = rti_batch(kw, B_ADMM, dev, sigma=ADMM_SIGMA,
                     opts_update=dict(qp_solver_name="ADMM"))[0]
    so = ipm.acados_ocp.solver_options
    tols = (so.nlp_solver_tol_stat, so.nlp_solver_tol_eq, np.inf, np.inf)
    calls, start, res = [0], {}, []

    def snapshot(name, timed):
        if calls[0] == ADMM_FROM_IPM_CALL:
            start["it"] = map_fields(lambda t: t.clone(), ipm._it_dev)
        calls[0] += 1

    warm = interleaved({"ipm": ipm}, "ADMM", tols, ADMM_IPM_WARM, 0, 0,
                       before_call=snapshot)
    if any(warm["ipm"][2].values()):
        raise SystemExit(f"ADMM phase ipm: unexpected kernel launches "
                         f"{warm['ipm'][2]}")
    admm._it_dev = start["it"]
    admm._host_stale = True

    def residuals(name, timed):
        if name == "admm" and admm._stats is not None:
            res.append(float(admm.get_stats("residuals")[:, 0].max()))

    solvers = {"ipm": ipm, "admm": admm}
    runs = interleaved(solvers, "ADMM", tols, ADMM_WARM, ADMM_ROUNDS,
                       ADMM_PER_ROUND, warmed=("ipm",),
                       before_call=residuals)
    log(f"ADMM backend: pendulum ERK SQP-RTI, N={N_ADMM}, B={B_ADMM}, "
        f"float32, x0 spread {ADMM_SIGMA}; the IPM 1 cold + "
        f"{ADMM_IPM_WARM} warm calls (largest qp_iter {warm['ipm'][1]}); "
        f"ADMM from the IPM's iterate after {ADMM_FROM_IPM_CALL} calls, 1 "
        f"+ {ADMM_WARM} warm calls, then {ADMM_ROUNDS} interleaved rounds of "
        f"{ADMM_PER_ROUND} timed call (bench.py: 15 warm calls each, 3 "
        f"rounds of 10); ADMM's res_stat maxima call by call "
        f"{res + [float(admm.get_stats('residuals')[:, 0].max())]}")
    for name, s in solvers.items():
        call_ms, qp_max, counts = runs[name]
        log(f"  ADMM phase {name}: {call_stats(call_ms, B_ADMM)}; largest "
            f"{'ADMM num_iter' if name == 'admm' else 'qp_iter'} per call "
            f"{qp_max}; launches of the repo's kernels {counts}")
        if any(counts.values()):
            raise SystemExit(f"ADMM phase {name}: unexpected kernel "
                             f"launches {counts}")


def qp_solver_pair(where, solver, cond_N, seed=SEED, moved=0):
    """AcadosOcpQpSolver on one seeded random QP (x0 free, 3 general
    rows a stage, N = 20), float64, on `where`; moved > 0: every entry
    of the data but the masks moved by one rounding step, up or down at
    random (the draw seeded by `moved`)."""
    from acados_tpu_torch import AcadosOcpQp, AcadosOcpQpSolver
    from acados_tpu_torch.testing import random_qp_batch
    d = random_qp_batch(seed, B=1, N=20, x0_rows=False)
    if moved:
        rng = np.random.default_rng(seed + moved)
        d = {f: v if f.startswith(("mask", "soft")) else v * (
            1 + np.finfo(np.float64).eps * rng.choice((-1.0, 1.0), v.shape))
            for f, v in d.items()}
    N, nx, nu = 20, d["q"].shape[-1], d["r"].shape[-1]
    desc = AcadosOcpQp(N, nx, nu, d["lg"].shape[-1], device=where)
    for f, v in d.items():
        for k in range(v.shape[1]):
            desc.set(k, f, v[0, k])
    return AcadosOcpQpSolver(desc, solver=solver, cond_N=cond_N)


def qp_paths_vs_cpu() -> None:
    """Phase 26: float64 card against CPU of this slice's paths: the
    long horizon with parallel_riccati (B = 8), the main path's config
    with abs_form (B = 8), the ADMM RTI batch (B = 8), and
    AcadosOcpQpSolver with the Riccati IPM, ADMM and ADMM through
    partial condensing, with its forward and adjoint sensitivities."""
    import torch
    card_vs_cpu(f"long-horizon reference check (N={N_LONG}, "
                f"parallel_riccati)",
                lambda where: long_batch(8, "float64", where, seed=1,
                                         parallel=True), calls=1)
    kw64 = dict(N=N_HORIZON, dtype="float64", nlp_solver_type="SQP_RTI",
                integrator_type="IRK")
    # SPEED_ABS stops at iter_max (50) on most instances here: their
    # unconverged iterates are held to 4 x the CPU's own spread (one
    # draw read 1.881e-8 beside the card's 3.059e-8)
    abs_form = dict(qp_opts_update=dict(abs_form=True))
    card_vs_cpu("main path reference check (abs_form)",
                lambda where: rti_batch(kw64, 8, where, seed=1,
                                        **abs_form)[0],
                moved=lambda: rti_batch(kw64, 8, "cpu", seed=1, moved=True,
                                        **abs_form)[0], spread_bound=True,
                calls=1)
    kwa = dict(N=N_ADMM, dtype="float64", nlp_solver_type="SQP_RTI")
    card_vs_cpu("ADMM RTI reference check",
                lambda where: rti_batch(kwa, 8, where, seed=1,
                                        sigma=ADMM_SIGMA,
                                        opts_update=dict(
                                            qp_solver_name="ADMM"))[0],
                calls=1)
    ok = [qp_solver_gaps(solver + (f" cond_N={cond_N}" if cond_N else ""),
                         solver, cond_N, torch.device("cuda"), "cpu")
          for solver, cond_N in (("RICCATI_IPM", None), ("ADMM", None),
                                 ("ADMM", 4))]
    if not all(ok):
        raise SystemExit("AcadosOcpQpSolver: card and CPU disagree")


def qp_solver_gaps(label, solver, cond_N, where, ref_where) -> bool:
    """AcadosOcpQpSolver on `where` against `ref_where` (qp_solver_pair):
    equal statuses (0) and iterations, the solution within 1e-9; its
    eval_sens_forw in a direction of q and eval_sens_adj seeded on x and
    u within 1e-9, or within 4 x their spread on `ref_where` under one
    rounding step of the data (the larger of two draws) where that is
    larger (at the active rows the seeds' barrier weights lam / t reach
    ~1e12). The half on `ref_where`: cpu_half(label). Returns whether
    all hold (True in the reference process)."""
    import torch
    rel = lambda a, b: float(np.max(np.abs(a - b) / (1 + np.abs(b)),
                                    initial=0.0))
    cpu = lambda t: t.detach().cpu().numpy()
    rng = np.random.default_rng(1)

    def run(w, m):
        """(status, iterations, solution and seeds as numpy)."""
        s = qp_solver_pair(w, solver, cond_N, moved=m)
        st = s.solve()
        dims = s.qp_desc.dims
        qp = s.qp_desc.qp
        d = qp.replace(**{f: None for f in qp.__dataclass_fields__})
        d = d.replace(q=torch.as_tensor(dq(dims), device=qp.q.device))
        grad = s.eval_sens_adj(*seeds(dims))
        return st, int(s.get_stats("num_iter")), dims.N, dict(
            **{f: cpu(getattr(s.sol, f)) for f in ("x", "u", "pi", "lam_lg",
                                                   "lam_ug", "sl", "su")},
            sens_forw=np.concatenate([cpu(t).ravel()
                                      for t in s.eval_sens_forw(d)]),
            sens_adj=np.concatenate([cpu(getattr(grad, f)).ravel() for f in
                                     ("Q", "q", "A", "b", "C", "lg", "ug")]))

    draws = {}

    def dq(dims):
        if "dq" not in draws:
            draws["dq"] = rng.normal(size=(1, dims.N + 1, dims.nx))
            draws["sx"] = rng.normal(size=(dims.N + 1, dims.nx))
            draws["su"] = rng.normal(size=(dims.N, dims.nu))
        return draws["dq"]

    def seeds(dims):
        dq(dims)
        return draws["sx"], draws["su"]

    refs = cpu_half(f"phase 26: AcadosOcpQpSolver {label}",
                    lambda: [run(ref_where, m) for m in (0, 1, 2)])
    if not card_half():
        return True
    runs = [run(where, 0)] + refs
    st = [r[0] for r in runs]
    it = [r[1] for r in runs]
    if any(st) or it[0] != it[1]:
        raise SystemExit(f"QP solver {label}: statuses {st}, iterations "
                         f"{it}")
    out = [r[3] for r in runs]
    gaps = {f: rel(out[0][f], out[1][f]) for f in out[1]}
    spread = {f: max(rel(o[f], out[1][f]) for o in out[2:])
              for f in ("sens_forw", "sens_adj")}
    bound = {f: 1e-9 if f not in spread else max(1e-9, 4 * spread[f])
             for f in gaps}
    ok = all(gaps[f] <= bound[f] for f in gaps)
    log(f"AcadosOcpQpSolver {label} float64 (N={runs[0][2]}, x0 free, "
        f"{it[0]} iterations): {where} vs {ref_where} max |d|/(1+|ref|) "
        f"{json.dumps(gaps)}; the seeds' spread on {ref_where} under one "
        f"rounding step of the data {json.dumps(spread)} (iterations "
        f"{it[2:]}): {'ok' if ok else 'FAIL'}")
    return ok


# the Newton SQP (phase 27): bench_pendulum_irk_sqp's problem (SQP, IRK,
# N = 20, float32, the main path's batch and x0s) with the exact Hessian,
# CONVEXIFY and the merit line search; its Gauss-Newton solve of the
# same x0s is phase 21's. MIRROR (newton_batch with
# regularize_method="MIRROR"), whose solve the port's CPU tests hold,
# takes 72.0 SQP iterations an instance on average at B = 4096 on the
# H100, and one instance, 2135, runs to max_iter 100 (367.5 s a call: it
# would not fit the script's time limit). That instance converges in
# 98-99 iterations alone, on the card and on the CPU, in both packages
# (sqp_f32_settle.py): float32 rounding that follows the batch size, not
# a fault. CONVEXIFY leaves the Hessian as it is where the
# reduced Hessian is convex and keeps Newton's local convergence (16-29
# iterations on the CPU at B = 8).
NEWTON_SO = dict(hessian_approx="EXACT", regularize_method="CONVEXIFY",
                 globalization="MERIT_BACKTRACKING")
# the EXACT call runs NEWTON_ROUNDS lockstep rounds (nlp_solver_max_iter):
# run to convergence it took 52 rounds and 198 s of the script's 1200 s
# (PERF.md), which phases 29-32 need; its launches are still held to
# newton_k1_expected and its trajectory to finiteness, its convergence by
# the CPU tests (tests/test_torch_exact_irk.py and the Newton tests) and
# phase 28. It runs 1 round (8 before phases 33-35 came, then 6, then
# 3 before phases 36-37, then 2), and the Gauss-Newton call beside it is
# phase 21's solve of the same problem, held there to one call
NEWTON_ROUNDS = 1
# float64 card against CPU of the new options (phase 28), B = 4, each
# solve cut at CHECK_ITER iterations (the parity of the same code on the
# card and on the CPU needs no convergence; the CPU tests hold the
# converged solves against the JAX package): the exact Newton SQP on the
# main path's config (NEWTON_CHECK_ITER iterations), the five
# regularizations on the nonconvex EXTERNAL-cost double integrator of
# tests/test_regularize.py (N = 10), and the line searches and adaptive
# options on the ERK pendulum at N = 8 (the line searches with the cost
# weights scaled by 1e-3, as tests/test_torch_globalization.py runs
# them: at the pendulum's own weights the merit's last comparisons are
# between values within a few rounding steps, whose outcome follows the
# order of the sums)
B_NEWTON_CHECK, NEWTON_CHECK_ITER, CHECK_ITER = 4, 2, 2   # cut from 3


def newton_batch(B, dtype, dev, solver_options=NEWTON_SO, seed=SEED):
    """bench_pendulum_irk_sqp's batch (SQP, IRK, N = 20) with the given
    solver options (default: EXACT, MIRROR, MERIT_BACKTRACKING)."""
    kw = dict(N=N_HORIZON, dtype=dtype, nlp_solver_type="SQP",
              integrator_type="IRK")
    return rti_batch(kw, B, dev, seed=seed,
                     solver_options=solver_options)[0]


def backtrack_trials(alpha, opts, dtype, start=1.0):
    """(trials, accepted) of one instance's backtracking that ended at
    alpha (sqp.py, ddp.py, wfqp.py: from `start`, each alpha tried while
    above alpha_min, shrunk by alpha_reduction until one passes), in the
    solver's floating type; not accepted: it left under alpha_min, at
    the alpha after its last trial."""
    red, a_min = dtype(opts.alpha_reduction), dtype(opts.alpha_min)
    a, tried = dtype(start), 0
    while a > a_min:
        tried += 1
        if a == alpha:
            return tried, True
        a = dtype(a * red)
    if a != alpha:
        raise SystemExit(f"alpha {alpha!r} is no exit of the backtracking")
    return tried, False


def merit_evaluations(alpha, opts, dtype) -> int:
    """The merit evaluations of one instance's SQP backtracking loop that
    ended at alpha < 1 (sqp.py: from alpha_reduction)."""
    return backtrack_trials(alpha, opts, dtype,
                            start=opts.alpha_reduction)[0]


def merit_sqp_k1(stats, opts, per_linearize, per_gap) -> int:
    """K1 launches of one MERIT_BACKTRACKING SQP solve() call, worked out
    from its stat table, with per_linearize launches a linearization and
    per_gap a dynamics gap. Instance b takes sqp_iter[b] rounds, one
    more where it converged inside the loop (the round that finds it
    converged still runs its QP and line search), at most max_iter; the
    batch runs R lockstep rounds, the most of those. Each round is a
    linearization, the merit at the iterate and at the full step (2
    dynamics gaps) and one more gap for each round of the lockstep
    backtracking, whose rounds are the most any instance active in that
    round took; then the final linearization."""
    rounds = np.minimum((stats.sqp_iter + (stats.status == 0)).cpu().numpy(),
                        opts.max_iter)
    alpha = stats.stat[:, :, 6].cpu().numpy()
    dtype = alpha.dtype.type
    R = int(rounds.max())
    gaps = 0
    for k in range(R):
        tried = [merit_evaluations(a, opts, dtype)
                 for a in alpha[rounds > k, k] if a < 1]
        gaps += 2 + max(tried, default=0)
    return per_linearize * (R + 1) + per_gap * gaps


def newton_k1_expected(stats, opts) -> int:
    """K1 launches of one EXACT + MERIT_BACKTRACKING solve() call of the
    IRK pendulum: an EXACT linearization K1_PER_EXACT_LINEARIZE, a
    merit's dynamics gap K1_PER_DYN_GAP."""
    return merit_sqp_k1(stats, opts, K1_PER_EXACT_LINEARIZE, K1_PER_DYN_GAP)


def timed_cold_call(solver, it0):
    """One solve() from the initial iterate it0 (host ms, synchronised)."""
    import torch
    solver._it_dev = it0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = solver.solve()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, status


def newton_sqp(dev) -> dict:
    """Phase 27: the Newton SQP at full width. Returns K1's kernels entry
    at the largest launch of an EXACT linearization."""
    import torch
    from acados_tpu_torch.ocp_nlp.linearize import build_static_rows
    from acados_tpu_torch.ops import batched_inv
    exact = newton_batch(B_MAIN, "float32", dev, solver_options=dict(
        NEWTON_SO, nlp_solver_max_iter=NEWTON_ROUNDS))
    it0_exact = exact._on_device()[1]
    so = exact.acados_ocp.solver_options
    log(f"Newton SQP: pendulum IRK SQP, B={B_MAIN}, N={N_HORIZON}, float32, "
        f"x0 = {list(X0_CENTER)} + N(0, {X0_SIGMA}); hessian_approx "
        f"{so.hessian_approx}, regularize_method {so.regularize_method}, "
        f"globalization {so.globalization} (alpha_min "
        f"{exact.opts.alpha_min}, alpha_reduction "
        f"{exact.opts.alpha_reduction}); its Gauss-Newton solve (FIXED_STEP) "
        f"is phase 21's")

    # one EXACT linearization at the initial iterate: its K1 launches and
    # shapes, then where a round's time goes
    from acados_tpu_torch.ocp_nlp.linearize import linearize
    data, it = exact._on_device()
    rows = build_static_rows(exact.form, torch.float32, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    reset_counts()
    with K1Shapes() as k1:
        linearize(exact.form, rows, data, it, zero)
    torch.cuda.synchronize()
    lin_counts = read_counts()
    log(f"  one EXACT linearization: K1 launches {lin_counts['gj_inverse']} "
        f"(expected {K1_PER_EXACT_LINEARIZE}), shapes "
        f"{sorted(set(k1.shapes))}")
    if lin_counts["gj_inverse"] != K1_PER_EXACT_LINEARIZE or any(
            v for k, v in lin_counts.items() if k != "gj_inverse"):
        raise SystemExit(f"EXACT linearization launches {lin_counts}")

    # EXACT, cut at NEWTON_ROUNDS, from the initial iterate
    reset_counts()
    ex_ms, st = timed_cold_call(exact, it0_exact)
    counts = read_counts()
    ex_stats = exact._stats
    # converged (0) or at the cut (2)
    if np.any((st != 0) & (st != 2)):
        raise SystemExit(f"Newton SQP: statuses "
                         f"{np.unique(st, return_counts=True)}")
    res = exact.get_stats("residuals").max(axis=0)
    want = newton_k1_expected(ex_stats, exact.opts)
    ex_iter = ex_stats.sqp_iter.cpu().numpy()
    x = exact._it_dev.x
    if not bool(torch.isfinite(x).all()) or \
            x.shape != (B_MAIN, N_HORIZON + 1, 4):
        raise SystemExit("Newton SQP: bad trajectory tensor")
    alpha = ex_stats.stat[:, :, 6].cpu().numpy()
    ex_status = ex_stats.status.cpu().numpy()
    rounds = lockstep_rounds(ex_stats, exact.opts)
    bt = int((alpha[:, :rounds] < 1).sum())
    log(f"  EXACT cut at {NEWTON_ROUNDS} lockstep rounds: 1 call "
        f"{ex_ms:.2f} ms; statuses "
        f"{np.unique(ex_status, return_counts=True)}, residual maxima "
        f"{res.tolist()}; sqp_iter mean {ex_iter.mean():.2f} max "
        f"{ex_iter.max()}, {rounds} lockstep rounds, {bt} backtracking "
        f"line searches over the batch; launches {counts} (K1 expected "
        f"{want} from the stat table)")
    if counts["gj_inverse"] != want or any(
            v for k, v in counts.items() if k != "gj_inverse"):
        raise SystemExit(f"Newton SQP launches {counts}, K1 expected {want}")

    # K1 on the largest launch of the EXACT linearization
    A = k1.largest
    rel, abs_err, _ = check_inverse(
        f"Newton SQP EXACT linearization {tuple(A.shape)}", A,
        batched_inv._gj_inverse_cuda, F32_BOUND)
    entry = k1_entry("gj_inverse_newton", A, counts["gj_inverse"], rel,
                     abs_err)
    entry["launch_shapes"] = sorted(set(k1.shapes))
    return entry


def nonconvex_ocp(method, u_nonconvex=False, max_iter=100):
    """The port's copy of tests/test_regularize.py's nonconvex EXTERNAL-
    cost double integrator (x-nonconvex: 2 cos(3 x_0); u-nonconvex for
    PROJECT_REDUC_HESS: 4 (1 - cos(2 u))) at N = 10, EXACT, MERIT,
    float64."""
    import torch
    from acados_tpu_torch import AcadosModel, AcadosOcp
    ocp, m = AcadosOcp(), AcadosModel()
    m.name, m.x, m.u = "nonconvex", 2, 1
    m.f_expl_expr = lambda x, u: torch.cat([x[1:2], u])
    if u_nonconvex:
        m.cost_expr_ext_cost = lambda x, u: (
            x @ x + 4.0 * (1.0 - torch.cos(2.0 * u[0])) + 0.05 * u[0] ** 2)
        m.cost_expr_ext_cost_e = lambda x: 5.0 * (x @ x)
    else:
        m.cost_expr_ext_cost = lambda x, u: (
            x[0] ** 2 + 0.1 * x[1] ** 2 + 1e-2 * u[0] ** 2
            + 2.0 * torch.cos(3.0 * x[0]))
        m.cost_expr_ext_cost_e = lambda x: x[0] ** 2 + 0.1 * x[1] ** 2
        ocp.constraints.idxbu = np.array([0])
        ocp.constraints.lbu = np.array([-10.0])
        ocp.constraints.ubu = np.array([10.0])
    ocp.model = m
    ocp.cost.cost_type = ocp.cost.cost_type_e = "EXTERNAL"
    ocp.constraints.x0 = np.array([1.5, 0.0])
    so = ocp.solver_options
    so.N_horizon, so.tf, so.dtype = 10, 1.0, "float64"
    so.hessian_approx, so.nlp_solver_type = "EXACT", "SQP"
    so.nlp_solver_max_iter, so.globalization = max_iter, "MERIT_BACKTRACKING"
    so.regularize_method = method
    return ocp


def pendulum_variant(N=8, weight=1.0, conl=False, **so):
    """The ERK pendulum SQP in float64 with the given solver options, its
    cost weights scaled by `weight`; conl: the cost as CONL with psi =
    0.5 r' W r + 0.01 sum(r^4)."""
    import torch
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    ocp = make_pendulum_ocp(N=N, dtype="float64", nlp_solver_type="SQP")
    ocp.cost.W = weight * np.asarray(ocp.cost.W)
    ocp.cost.W_e = weight * np.asarray(ocp.cost.W_e)
    if conl:
        W, Q = (torch.as_tensor(ocp.cost.W), torch.as_tensor(ocp.cost.W_e))
        ocp.model.cost_psi_expr = lambda r, p: (0.5 * r @ W.to(r) @ r
                                                + 0.01 * (r ** 4).sum())
        ocp.model.cost_psi_expr_e = lambda r, p: (0.5 * r @ Q.to(r) @ r
                                                  + 0.01 * (r ** 4).sum())
        ocp.cost.cost_type = ocp.cost.cost_type_e = "CONL"
    for k, v in so.items():
        setattr(ocp.solver_options, k, v)
    return ocp


def newton_vs_cpu() -> None:
    """Phase 28: float64 card against CPU of the new options, B = 4, one
    solve() call each: statuses and qp_iter equal, x, u, pi within
    1e-9."""
    from acados_tpu_torch.testing import rti_batch as batch_at
    rng = np.random.default_rng(1)
    x0_swing = np.asarray(X0_CENTER) + rng.normal(0.0, 0.2,
                                                  (B_NEWTON_CHECK, 4))
    x0_dbl = np.array([1.5, 0.0]) + rng.normal(0.0, 0.1,
                                               (B_NEWTON_CHECK, 2))
    card_vs_cpu(f"Newton SQP ({NEWTON_CHECK_ITER} iterations, IRK, "
                f"N={N_HORIZON})",
                lambda where: newton_batch(
                    B_NEWTON_CHECK, "float64", where, seed=1,
                    solver_options=dict(
                        NEWTON_SO, nlp_solver_max_iter=NEWTON_CHECK_ITER)),
                calls=1)
    for method in ("MIRROR", "PROJECT", "GLM", "CONVEXIFY",
                   "PROJECT_REDUC_HESS"):
        ocp = lambda: nonconvex_ocp(method, method == "PROJECT_REDUC_HESS",
                                    max_iter=CHECK_ITER)
        card_vs_cpu(f"EXACT + {method} (nonconvex EXTERNAL cost)",
                    lambda where: batch_at(ocp(), x0_dbl, where), calls=1)
    ls = dict(weight=1e-3)
    variants = {
        "MERIT + sufficient descent": dict(
            globalization="MERIT_BACKTRACKING",
            globalization_line_search_use_sufficient_descent=True, **ls),
        "MERIT + SOC": dict(globalization="MERIT_BACKTRACKING",
                            globalization_use_SOC=True, **ls),
        "FUNNEL": dict(globalization="FUNNEL_L1PEN_LINESEARCH", **ls),
        "FIXED_STEP + Anderson": dict(with_anderson_acceleration=True),
        "adaptive LM": dict(with_adaptive_levenberg_marquardt=True,
                            adaptive_levenberg_marquardt_mu0=1e-2),
        "ADAPTIVE_CURRENT_RES_JOINT": dict(
            nlp_qp_tol_strategy="ADAPTIVE_CURRENT_RES_JOINT"),
        "CONL cost": dict(conl=True)}
    for label, so in variants.items():
        card_vs_cpu(label, lambda where: batch_at(
            pendulum_variant(nlp_solver_max_iter=CHECK_ITER, **so),
            x0_swing, where), calls=1)


# ---------------------------------------------------------------------------
# NLP breadth (phases 29-32): DDP, SQP_WITH_FEASIBLE_QP, BGP rows and the
# INTEGRATOR cost
# ---------------------------------------------------------------------------


def lockstep_rounds(stats, opts) -> int:
    """The lockstep rounds of a solve: instance b ran sqp_iter[b] rounds
    and one more where it converged inside the loop (the round that finds
    it converged); an instance at max_iter may converge at the final
    linearization, which is no round."""
    rounds = stats.sqp_iter.cpu().numpy() + (stats.status.cpu().numpy() == 0)
    return int(np.minimum(rounds, opts.max_iter).max())


def _stepping_alphas(stats, opts):
    """Per lockstep round r, the stat table's alphas of the instances
    that took a step in it (sqp_iter > r; the round that finds an
    instance converged takes none)."""
    sqp_iter = stats.sqp_iter.cpu().numpy()
    alpha = stats.stat[:, :, 6].cpu().numpy()
    return [alpha[sqp_iter > r, r]
            for r in range(lockstep_rounds(stats, opts))]


def ddp_k1_expected(stats, opts, N) -> int:
    """K1 launches of one DDP solve on the IRK pendulum, worked out from
    its stat table (ddp.py): the initial forward simulation (N steps of
    K1_PER_DYN_GAP); each lockstep round a linearization
    (LAUNCHES_PER_RTI) and, where any instance takes a step, one rollout
    of N steps for each trial alpha of the lockstep backtracking (the
    most any stepping instance took, from alpha = 1) and one more where
    an instance left it under alpha_min; the final linearization."""
    total = K1_PER_DYN_GAP * N + LAUNCHES_PER_RTI
    for alphas in _stepping_alphas(stats, opts):
        total += LAUNCHES_PER_RTI
        if len(alphas):
            tr = [backtrack_trials(a, opts, alphas.dtype.type)
                  for a in alphas]
            total += K1_PER_DYN_GAP * N * (max(t for t, _ in tr)
                                           + (not all(ok for _, ok in tr)))
    return total


def wfqp_k1_expected(stats, opts) -> int:
    """K1 launches of one SQP_WITH_FEASIBLE_QP solve on the IRK pendulum
    (wfqp.py): each lockstep round a linearization and, with
    MERIT_BACKTRACKING where any instance takes a step, the merit at the
    iterate and at each trial alpha of the lockstep backtracking (from
    alpha = 1), one dynamics gap each; the final linearization. Both QPs
    run without K1 (nx = 4)."""
    total = LAUNCHES_PER_RTI
    for alphas in _stepping_alphas(stats, opts):
        total += LAUNCHES_PER_RTI
        if len(alphas) and opts.globalization != "FIXED_STEP":
            trials = max(backtrack_trials(a, opts, alphas.dtype.type)[0]
                         for a in alphas)
            total += K1_PER_DYN_GAP * (1 + trials)
    return total


# phases 29-32: the main path's float32 tolerances (models/pendulum.py;
# the DDP pendulum also takes its Levenberg-Marquardt term), the IRK
# DDP's cut (phase 29 b), the obstacle's start and its spread, and the
# float64 checks' batch and horizons (an IRK rollout is N sequential
# steps, slow on the CPU side of the check; at N = 8 the obstacle's
# first node clears the disc and its row is inactive, at N = 10 the
# node sits on the disc)
F32_TOLS = dict(nlp_solver_tol_stat=2e-3, nlp_solver_tol_eq=1e-4,
                nlp_solver_tol_ineq=1e-4, nlp_solver_tol_comp=1e-3)
F32_LM = 1e-4
DDP_CUT_ITER = 1
X0_OBSTACLE, OBSTACLE_SIGMA = (-2.0, 0.01), 0.01
B_NLP_CHECK, N_NLP_CHECK, NLP_CHECK_ITER = 4, 10, 2
N_IRK_CHECK, IRK_CHECK_ITER = 2, 1
# depth cuts that keep phases 29-32 near their 180 s: run to its end,
# the ERK DDP took 100 lockstep rounds and 95.0 s (about half the
# instances cycle, tests/test_torch_ddp.py::test_cycling_instances_
# match_jax), the pendulum WFQP 96 rounds and 271.0 s, every status 0
# (float32 merit ties near the 2e-3 gate stretch its tail; PERF.md).
# Cut, each keeps its launch count against the stat table, its
# statuses (converged or at the cut) and a finite trajectory; the
# converged runs stay held by the CPU tests and phase 32. Before phases
# 36-37 came the ERK DDP ran 36 rounds (186 instances converged there;
# 37 at 30) and the IRK DDP 2 iterations; the WFQP keeps 10 rounds
# (1149 converged there; none at 8, and the phase needs some)
DDP_ERK_ROUNDS, WFQP_ROUNDS = 30, 10


def nlp_batch(ocp, B, dev, x0_center, sigma, seed=SEED, zero_init=False,
              **solver_options):
    """AcadosOcpBatchSolver of `ocp` with the given solver options, x0
    per instance = x0_center + N(0, sigma), set as bench.py's _build_rti
    sets it (acados_tpu_torch.testing.rti_batch); zero_init: the
    iterate 0 instead (tests/test_wfqp.py's init_iterate, where the
    obstacle rows' gradient vanishes)."""
    from acados_tpu_torch.testing import rti_batch as batch_at
    for k, v in solver_options.items():
        setattr(ocp.solver_options, k, v)
    rng = np.random.default_rng(seed)
    x0s = np.asarray(x0_center) + rng.normal(0.0, sigma,
                                             (B, len(x0_center)))
    solver = batch_at(ocp, x0s, dev)
    if zero_init:
        solver._host_iterate()["x"][:] = 0.0
        solver._it_dev = None
    return solver


def timed_call(solver):
    """One solve() call: (host ms, statuses), synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = solver.solve()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, st


def check_solved(label, solver, st, tols=None):
    """Every status 0, the residuals in tolerance, a finite trajectory of
    the batch's shape; returns the residual maxima."""
    import torch
    if np.any(st != 0):
        raise SystemExit(f"{label}: statuses "
                         f"{np.unique(st, return_counts=True)}")
    ok_tol, res, tols = in_tolerance(solver, tols)
    if not ok_tol:
        raise SystemExit(f"{label} out of tolerance: {res} vs {tols}")
    x = solver._it_dev.x
    if x.shape != (solver.N_batch, solver.N + 1, solver.form.nx) or not \
            bool(torch.isfinite(x).all()):
        raise SystemExit(f"{label}: bad trajectory tensor")
    return res


def once_ms(fn) -> float:
    """Host-clock time of one fn() ending in a synchronize (ms): nothing
    compiles in the port, so a first run is timed like any other."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def ddp_first_cost(solver):
    """Every instance's cost at the DDP solver's first forward simulation:
    its solve function cut at 0 iterations, on the same data and initial
    iterate as the solver's next call."""
    from acados_tpu_torch.interface.solver import make_nlp_solver
    solve = make_nlp_solver(solver.form, solver.opts.replace(max_iter=0),
                            "DDP")
    return solve(*solver._on_device())[1].cost.cpu().numpy()


def ddp_descent(solver, first_cost):
    """What DDP's backtracking guarantees (ddp.py: a trial is accepted
    only where the cost falls below the iterate's): an instance that
    stepped and whose every step was accepted (alpha > alpha_min) ends
    below its first rollout's cost. A step left under alpha_min is
    taken unchecked. Returns (held, fell, short): the instances the
    guarantee covers, those whose cost fell, those with an unchecked
    step."""
    stats, opts = solver._stats, solver.opts
    k = stats.sqp_iter.cpu().numpy()
    alpha = stats.stat[:, :, 6].cpu().numpy()
    rows = np.arange(alpha.shape[1])[None] < k[:, None]
    short = np.any(rows & (alpha <= opts.alpha_min), axis=1)
    fell = stats.cost.cpu().numpy() < first_cost
    return (k > 0) & ~short, fell, short


def ddp_phase(dev) -> dict:
    """Phase 29: DDP at full width. (a) tests/test_ddp.py's unconstrained
    pendulum (ERK, 2 substeps, MERIT_BACKTRACKING), DDP_ERK_ROUNDS
    lockstep rounds;
    (b) the same OCP with the main path's IRK cut at DDP_CUT_ITER
    iterations, its K1 launches against ddp_k1_expected, K1 on the
    rollout's (B, 16, 16) launch against its plain version. Returns K1's
    kernels entry there."""
    from acados_tpu_torch.ops import batched_inv
    from acados_tpu_torch.testing import ddp_pendulum_ocp
    import torch
    so = dict(F32_TOLS, levenberg_marquardt=F32_LM)
    erk = nlp_batch(ddp_pendulum_ocp(N_HORIZON, "float32", "ERK"), B_MAIN,
                    dev, X0_CENTER, X0_SIGMA,
                    nlp_solver_max_iter=DDP_ERK_ROUNDS, **so)
    first_cost = ddp_first_cost(erk)
    reset_counts()
    ms, st = timed_call(erk)
    counts = read_counts()
    res = erk.get_stats("residuals")
    it_ = erk.get_stats("sqp_iter")
    ok = st == 0
    tols = np.array([so[f"nlp_solver_tol_{k}"]
                     for k in ("stat", "eq", "ineq", "comp")])
    log(f"DDP: tests/test_ddp.py's unconstrained pendulum, ERK, B={B_MAIN}, "
        f"N={N_HORIZON}, float32, x0 = {list(X0_CENTER)} + N(0, "
        f"{X0_SIGMA}), MERIT_BACKTRACKING, max_iter "
        f"{erk.opts.max_iter}: 1 call {ms:.2f} ms; statuses "
        f"{np.unique(st, return_counts=True)}; converged instances' "
        f"residual maxima {res[ok].max(axis=0).tolist()}, sqp_iter mean "
        f"{it_[ok].mean():.2f} max {it_[ok].max()}; res_eq of every "
        f"instance <= {res[:, 1].max():.3e}; launches {counts}")
    # DDP cycles from part of these x0s in both packages
    # (tests/test_torch_ddp.py::test_cycling_instances_match_jax), and
    # most of the rest are still on their way at the cut: those stop at
    # max_iter (2; DDP_ERK_ROUNDS) or on a vanishing step (3),
    # dynamically feasible all the same, and each is held to the descent
    # its line search guarantees
    held, fell, short = ddp_descent(erk, first_cost)
    log(f"  descent: {int(held.sum())} instances stepped with every step "
        f"accepted, {int((held & fell).sum())} of them below their first "
        f"rollout's cost; {int(short.sum())} took a step under alpha_min "
        f"(unchecked); {int(fell.sum())} of {B_MAIN} below it in all")
    x = erk._it_dev.x
    if np.any((st != 0) & (st != 2) & (st != 3)) or not ok.any() \
            or np.any(res[ok] > tols) or res[:, 1].max() > tols[1] \
            or np.any(held & ~fell) \
            or not bool(torch.isfinite(x).all()) or any(counts.values()):
        raise SystemExit("DDP ERK failed its checks")

    irk = nlp_batch(ddp_pendulum_ocp(N_HORIZON, "float32", "IRK"), B_MAIN,
                    dev, X0_CENTER, X0_SIGMA,
                    nlp_solver_max_iter=DDP_CUT_ITER, **so)
    reset_counts()
    with K1Shapes() as k1:
        ms, st = timed_call(irk)
    counts = read_counts()
    want = ddp_k1_expected(irk._stats, irk.opts, N_HORIZON)
    x = irk._it_dev.x
    if not bool(torch.isfinite(x).all()) or np.any((st != 0) & (st != 2)):
        raise SystemExit(f"DDP IRK: statuses {np.unique(st)}, finite "
                         f"{bool(torch.isfinite(x).all())}")
    alpha = irk._stats.stat[:, :DDP_CUT_ITER, 6].cpu().numpy()
    log(f"  DDP, the main path's IRK, cut at {DDP_CUT_ITER} iterations: 1 "
        f"call {ms:.2f} ms; statuses {np.unique(st, return_counts=True)}; "
        f"alphas {np.unique(alpha, return_counts=True)}; launches {counts} "
        f"(K1 expected {want} from the stat table), shapes "
        f"{sorted(set(k1.shapes))}")
    if counts["gj_inverse"] != want or any(
            v for k, v in counts.items() if k != "gj_inverse"):
        raise SystemExit(f"DDP IRK launches {counts}, K1 expected {want}")
    A = k1.first
    if tuple(A.shape) != (B_MAIN, 16, 16):
        raise SystemExit(f"DDP IRK: first K1 launch {tuple(A.shape)}")
    rel, abs_err, _ = check_inverse(
        f"DDP rollout step {tuple(A.shape)}", A,
        batched_inv._gj_inverse_cuda, F32_BOUND)
    entry = k1_entry("gj_inverse_ddp_rollout", A, counts["gj_inverse"], rel,
                     abs_err)
    entry["launch_shapes"] = sorted(set(k1.shapes))
    return entry


def wfqp_phase(dev) -> None:
    """Phase 30: SQP_WITH_FEASIBLE_QP at full width. The main path's
    pendulum (IRK, float32 tolerances) with MERIT_BACKTRACKING, WFQP_ROUNDS
    lockstep rounds: converged instances in tolerance, K1 against
    wfqp_k1_expected, both QPs' iterations. The obstacle OCP as BGP rows (ERK) from the zero iterate,
    x0 spread by N(0, OBSTACLE_SIGMA): plain SQP fails on the batch,
    WFQP converges with every node outside the disc."""
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import obstacle_ocp
    pend = nlp_batch(make_pendulum_ocp(
        N=N_HORIZON, dtype="float32", integrator_type="IRK",
        nlp_solver_type="SQP_WITH_FEASIBLE_QP"), B_MAIN, dev, X0_CENTER,
        X0_SIGMA, globalization="MERIT_BACKTRACKING",
        nlp_solver_max_iter=WFQP_ROUNDS)
    reset_counts()
    ms, st = timed_call(pend)
    counts = read_counts()
    res = pend.get_stats("residuals")
    conv = st == 0
    tols = np.array([pend.acados_ocp.solver_options.nlp_solver_tol_stat,
                     pend.acados_ocp.solver_options.nlp_solver_tol_eq,
                     pend.acados_ocp.solver_options.nlp_solver_tol_ineq,
                     pend.acados_ocp.solver_options.nlp_solver_tol_comp])
    import torch
    if np.any(~conv & (st != 2)) or not conv.any() \
            or np.any(res[conv] > tols) \
            or not bool(torch.isfinite(pend._it_dev.x).all()):
        raise SystemExit(f"WFQP pendulum: statuses "
                         f"{np.unique(st, return_counts=True)}")
    want = wfqp_k1_expected(pend._stats, pend.opts)
    it_ = pend.get_stats("sqp_iter")
    total = pend.get_stats("qp_iter")
    feas = pend._stats.feas_qp_iter.cpu().numpy()
    log(f"WFQP: the main path's pendulum (IRK, SQP_WITH_FEASIBLE_QP, "
        f"MERIT_BACKTRACKING), B={B_MAIN}, N={N_HORIZON}, float32, cut at "
        f"{WFQP_ROUNDS} rounds: 1 call {ms:.2f} ms; statuses "
        f"{np.unique(st, return_counts=True)}, the converged instances' "
        f"residual maxima {res[conv].max(axis=0).tolist()} (in tolerance); "
        f"sqp_iter mean "
        f"{it_.mean():.2f} max {it_.max()}; QP iterations a solve: "
        f"feasibility QP mean {feas.mean():.2f} max {feas.max()}, nominal "
        f"QP mean {(total - feas).mean():.2f} max {(total - feas).max()}; "
        f"launches {counts} (K1 expected {want} from the stat table)")
    if counts["gj_inverse"] != want or any(
            v for k, v in counts.items() if k != "gj_inverse"):
        raise SystemExit(f"WFQP launches {counts}, K1 expected {want}")

    def obstacle(kind):
        return nlp_batch(obstacle_ocp("bgp", N_HORIZON, "float32"), B_MAIN,
                         dev, X0_OBSTACLE, OBSTACLE_SIGMA, zero_init=True,
                         nlp_solver_type=kind, **F32_TOLS)

    sqp = obstacle("SQP")
    ms_s, st_s = timed_call(sqp)
    wfqp = obstacle("SQP_WITH_FEASIBLE_QP")
    ms_w, st_w = timed_call(wfqp)
    res = check_solved("WFQP obstacle (BGP)", wfqp, st_w)
    d2 = float((wfqp._it_dev.x ** 2).sum(-1).min())
    it_ = wfqp.get_stats("sqp_iter")
    log(f"  obstacle as BGP rows (ERK, N={N_HORIZON}, B={B_MAIN}, float32, "
        f"from the zero iterate, x0 = {list(X0_OBSTACLE)} + N(0, "
        f"{OBSTACLE_SIGMA})): plain SQP {ms_s:.2f} ms, statuses "
        f"{np.unique(st_s, return_counts=True)}; WFQP {ms_w:.2f} ms, every "
        f"status 0, residual maxima {res.tolist()}, sqp_iter mean "
        f"{it_.mean():.2f} max {it_.max()}, min ||x||^2 {d2:.6f}")
    if np.any(st_s == 0):
        raise SystemExit("plain SQP solved the obstacle from the zero "
                         "iterate")
    if not d2 >= 1.0 - 1e-4:
        raise SystemExit(f"WFQP obstacle: min ||x||^2 {d2}")


def integrator_phase(dev, it0) -> dict:
    """Phase 31: the main path with cost_discretization INTEGRATOR beside
    the EULER main path, both from the main path's converged iterate it0
    (phase 4: the RTI takes ~10 calls from x0 to its tolerance),
    interleaved (1 cold + 1 warm call each, then 2 rounds of 1 timed
    call; 3 warm and 3 rounds before phases 33-35 came; without the warm
    call the INTEGRATOR batch, whose optimum is not EULER's, was out of
    tolerance after its calls, res_stat 3.3e-3): every status 0
    and in tolerance, K1 K1_PER_INTEGRATOR_RTI a call; K1 on the path
    stage points' launch against its plain version.
    Returns K1's kernels entry there."""
    from acados_tpu_torch.ops import batched_inv
    kw = dict(N=N_HORIZON, dtype="float32", nlp_solver_type="SQP_RTI",
              integrator_type="IRK")
    solvers = {disc: rti_batch(kw, B_MAIN, dev, solver_options=dict(
        cost_discretization=disc))[0] for disc in ("EULER", "INTEGRATOR")}
    for solver in solvers.values():
        solver._it_dev = it0
    warm, rounds = 1, 2
    out = interleaved(solvers, "INTEGRATOR cost", None, warm, rounds, 1)
    calls = 1 + warm + rounds
    for disc, per_call in (("EULER", LAUNCHES_PER_RTI),
                           ("INTEGRATOR", K1_PER_INTEGRATOR_RTI)):
        ms, qp_max, counts = out[disc]
        log(f"main path, cost_discretization {disc}: {call_stats(ms)}; "
            f"largest qp_iter a call {qp_max}; launches over {calls} "
            f"calls {counts} (K1 expected {per_call} a call)")
        if counts["gj_inverse"] != per_call * calls or any(
                v for k, v in counts.items() if k != "gj_inverse"):
            raise SystemExit(f"{disc}: launches {counts}")
    ratio = float(np.median(out["INTEGRATOR"][0])) / float(
        np.median(out["EULER"][0]))
    # the path stage points' Newton solves: (B (N - 1), 16, 16)
    with K1Shapes(match=lambda a: a.shape[0] == B_MAIN * (N_HORIZON - 1)) \
            as k1:
        solvers["INTEGRATOR"].solve()
    log(f"  INTEGRATOR call {ratio:.2f}x the EULER median; K1 shapes of "
        f"a call {sorted(set(k1.shapes))}")
    A = k1.matched
    rel, abs_err, _ = check_inverse(
        f"INTEGRATOR stage points {tuple(A.shape)}", A,
        batched_inv._gj_inverse_cuda, F32_BOUND)
    return k1_entry("gj_inverse_integrator_points", A,
                    out["INTEGRATOR"][2]["gj_inverse"], rel, abs_err)


def integrator_variant(kind, integrator):
    """The main path's pendulum as an SQP in float64 with the INTEGRATOR
    cost: NONLINEAR_LS (its own), CONL psi = 0.5 r' W r + 0.01 sum(r^4)
    on the same residuals, or EXTERNAL 0.5 y' W y with y = (x, u)."""
    import torch
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    ocp = make_pendulum_ocp(
        N=N_IRK_CHECK if integrator == "IRK" else N_NLP_CHECK,
        dtype="float64", nlp_solver_type="SQP", integrator_type=integrator)
    m, c = ocp.model, ocp.cost
    W, Q = torch.as_tensor(c.W), torch.as_tensor(c.W_e)
    if kind == "CONL":
        m.cost_psi_expr = lambda r, p: (0.5 * r @ W.to(r) @ r
                                        + 0.01 * (r ** 4).sum())
        m.cost_psi_expr_e = lambda r, p: 0.5 * r @ Q.to(r) @ r
        c.cost_type = c.cost_type_e = "CONL"
    elif kind == "EXTERNAL":
        m.cost_expr_ext_cost = lambda x, u: 0.5 * (
            torch.cat([x, u]) @ W.to(x) @ torch.cat([x, u]))
        m.cost_expr_ext_cost_e = lambda x: 0.5 * x @ Q.to(x) @ x
        c.cost_type = c.cost_type_e = "EXTERNAL"
    ocp.solver_options.cost_discretization = "INTEGRATOR"
    return ocp


def nlp_breadth_vs_cpu() -> None:
    """Phase 32: float64 card against CPU at B = B_NLP_CHECK, each solve
    cut at NLP_CHECK_ITER iterations (the IRK's at IRK_CHECK_ITER, N =
    N_IRK_CHECK): DDP on ERK and on IRK, WFQP on the
    pendulum and on the obstacle as BGH, BGP and soft BGP rows, the
    INTEGRATOR cost with IRK NONLINEAR_LS, IRK CONL, ERK NONLINEAR_LS and
    ERK EXTERNAL; statuses and iterations equal, x, u, pi within 1e-9."""
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import ddp_pendulum_ocp, obstacle_ocp

    def soft(ocp):
        ocp.constraints.idxsphi = np.array([0])
        ocp.cost.Zl = ocp.cost.Zu = np.array([1.0])
        ocp.cost.zl = ocp.cost.zu = np.array([50.0])
        return ocp

    B, cut = B_NLP_CHECK, dict(nlp_solver_max_iter=NLP_CHECK_ITER)
    cases = {
        "DDP ERK": (lambda: ddp_pendulum_ocp(N_NLP_CHECK, "float64", "ERK"),
                    X0_CENTER, 0.05, False),
        "DDP IRK": (lambda: ddp_pendulum_ocp(N_IRK_CHECK, "float64",
                                             "IRK"), X0_CENTER, 0.05, False),
        "WFQP pendulum (IRK)": (lambda: make_pendulum_ocp(
            N=N_IRK_CHECK, dtype="float64", integrator_type="IRK",
            nlp_solver_type="SQP_WITH_FEASIBLE_QP"), X0_CENTER, 0.05,
            False),
        **{f"WFQP obstacle ({label})": (
            lambda rows=rows, sft=sft: (soft if sft else (lambda o: o))(
                obstacle_ocp(rows, N_NLP_CHECK, "float64")),
            X0_OBSTACLE, OBSTACLE_SIGMA, True)
           for label, rows, sft in (("BGH", "h", False), ("BGP", "bgp", False),
                                    ("soft BGP", "bgp", True))},
        **{f"INTEGRATOR {integ} {kind}": (
            lambda kind=kind, integ=integ: integrator_variant(kind, integ),
            X0_CENTER, 0.05, False)
           for integ, kind in (("IRK", "NONLINEAR_LS"), ("IRK", "CONL"),
                               ("ERK", "NONLINEAR_LS"), ("ERK", "EXTERNAL"))}}
    for label, (ocp, center, sigma, zero) in cases.items():
        so = (dict(nlp_solver_max_iter=IRK_CHECK_ITER) if "IRK" in label
              else cut)
        t0 = time.perf_counter()
        card_vs_cpu(label, lambda where, ocp=ocp, center=center, sigma=sigma,
                    zero=zero, so=so: nlp_batch(
                        ocp(), B, where, center, sigma, seed=2,
                        zero_init=zero, **so), calls=1)
        log(f"  ({time.perf_counter() - t0:.1f} s)")


# phases 33-35: integrator breadth. The DAE cart (tests/test_dae_nlp.py)
# at the main path's width: x0 = (1, 0) + N(0, 0.05), float32 at the main
# path's tolerances, SQP cut at DAE_MAX_ITER (CPU float32, B = 64: every
# status 0 in at most 5 iterations); its K1 launches, each at (B N, 9, 9):
# a linearization 2 substeps x (3 Newton + 1 refresh) stage inverses, an
# exact z(t0) evaluation (the cost's, once a round and once at the end)
# 3 Newton solves (dae_k1_expected)
DAE_X0, DAE_SIGMA, DAE_MAX_ITER = (1.0, 0.0), 0.05, 20
K1_PER_DAE_LINEARIZE, K1_PER_DAE_Z = 8, 3
DAE_STAGE_N = 9
# GNSF on the main path from its converged iterate: 1 RTI call and no
# warm one; the simulators' calls; DISCRETE / ERK and LIFTED_IRK calls
# (the simulators' calls cut from 2, DISCRETE's from 3, LIFTED_IRK's
# from 5)
GNSF_WARM, GNSF_SIM_CALLS, DISC_CALLS, LIFTED_CALLS = 0, 1, 2, 3
# DISCRETE against ERK: the same RK4 in another order of operations, so
# in float32 the step and its Jacobians agree to rounding (~100 ulp,
# DISC_STEP_BOUND). After 3 RTI calls from the same x0s the
# float32 batches part by 0.50 in x and 1.94 in u (relative; u flips
# between its bounds) on 0.29 % of 4096 instances, and ERK against
# itself on the x0s moved by one float32 rounding step parts as much
# (0.43, 1.97, 0.27 %): the swing-up's QPs carry rounding that far. In
# float64 on the same x0s DISCRETE equals ERK within 1.8e-9 on every
# instance (H100 runs). Held: the float32 share of instances whose u
# parts by more than DISC_PART (relative) at most DISC_PART_SHARE, the
# float64 trajectories within DISC_F64_BOUND
DISC_STEP_BOUND, DISC_F64_BOUND = 1e-5, 1e-6
DISC_PART, DISC_PART_SHARE = 1e-2, 0.01
B_INT_CHECK = 4


def dae_k1_expected(stats, opts) -> int:
    """K1 launches of one SQP (FIXED_STEP) solve of the DAE cart, from its
    stat table: each lockstep round and the final pass a linearization
    (K1_PER_DAE_LINEARIZE) and the cost at the iterate, whose exact
    z(t0) takes K1_PER_DAE_Z (sqp.py: eval_cost once a round and once at
    the end; z_fun, sim/irk.py:make_irk_z0_fun)."""
    return (K1_PER_DAE_LINEARIZE + K1_PER_DAE_Z) * (
        lockstep_rounds(stats, opts) + 1)


def dae_batch(B, dtype, dev, seed=SEED, max_iter=DAE_MAX_ITER, N=None):
    """The DAE cart (acados_tpu_torch.testing.dae_ocp) as a batch, x0 per
    instance DAE_X0 + N(0, DAE_SIGMA), at the main path's float32
    tolerances in float32."""
    from acados_tpu_torch.testing import dae_ocp
    ocp = dae_ocp(N=N or N_HORIZON, dtype=dtype,
                  tf=2.0 * (N or N_HORIZON) / 20)
    so = dict(nlp_solver_max_iter=max_iter)
    if dtype == "float32":
        so.update(F32_TOLS)
    return nlp_batch(ocp, B, dev, DAE_X0, DAE_SIGMA, seed=seed, **so)


def dae_phase(dev) -> dict:
    """Phase 33: the DAE cart at full width by SQP (nx 2, nz 1, IRK GL3,
    2 substeps, z in the cost and in h): every status 0 and in tolerance,
    z finite with |z| <= DAE_ZBOUND up to the inequality tolerance (the
    batch's z(t0) at every node, and get("z") of two instances equal to
    it), K1 launches equal to dae_k1_expected, K1 on the stage system's
    (B N, 9, 9) launch against its plain version. Should float32 miss the
    gate, the same batch runs in float64 and the phase says so. Returns
    K1's kernels entry there."""
    import torch
    from acados_tpu_torch.ops import batched_inv
    from acados_tpu_torch.testing import DAE_ZBOUND
    from acados_tpu_torch.ocp_nlp.linearize import _z_exact
    for dtype in ("float32", "float64"):
        solver = dae_batch(B_MAIN, dtype, dev)
        reset_counts()
        with K1Shapes() as k1:
            ms, st = timed_call(solver)
        counts = read_counts()
        ok_tol, res, tols = in_tolerance(solver)
        it_ = solver.get_stats("sqp_iter")
        log(f"DAE cart (tests/test_dae_nlp.py), B={B_MAIN}, N={N_HORIZON}, "
            f"{dtype}, SQP, x0 = {list(DAE_X0)} + N(0, {DAE_SIGMA}): 1 call "
            f"{ms:.2f} ms; statuses {np.unique(st, return_counts=True)}; "
            f"sqp_iter mean {it_.mean():.2f} max {it_.max()}; residual "
            f"maxima {res.tolist()} vs {list(tols)}")
        if np.all(st == 0) and ok_tol:
            break
        if dtype == "float64":
            raise SystemExit("DAE cart: float64 missed the gate too")
        log("  float32 missed the gate: the phase solves in float64")
    want = dae_k1_expected(solver._stats, solver.opts)
    shapes = sorted(set(k1.shapes))
    log(f"  launches {counts} (K1 expected {want} from the stat table), "
        f"shapes {shapes}")
    if counts["gj_inverse"] != want or any(
            v for k, v in counts.items() if k != "gj_inverse") \
            or shapes != [(B_MAIN * N_HORIZON, DAE_STAGE_N, DAE_STAGE_N)]:
        raise SystemExit(f"DAE launches {counts}, K1 expected {want}")
    check_solved("DAE cart", solver, st)
    data, it = solver._on_device()
    z = _z_exact(solver.form, data, it.x, it.u)
    zmax = float(z.abs().max())
    z_get = np.array([[solver.ocp_solvers[i].get(k, "z")
                       for k in range(N_HORIZON)] for i in (0, B_MAIN - 1)])
    z_gap = float(np.abs(z_get - z[[0, -1]].cpu().numpy()).max())
    log(f"  z(t0) of every node: finite {bool(torch.isfinite(z).all())}, "
        f"max |z| {zmax:.6f} (bound {DAE_ZBOUND} + tol_ineq); get(k, 'z') "
        f"of instances 0 and {B_MAIN - 1} against it: {z_gap:.3e}")
    if not bool(torch.isfinite(z).all()) or \
            zmax > DAE_ZBOUND + tols[2] or z_gap > 1e-5:
        raise SystemExit("DAE cart: z out of its bound or not finite")
    A = k1.first
    rel, abs_err, _ = check_inverse(
        f"DAE stage systems {tuple(A.shape)}", A.float(),
        batched_inv._gj_inverse_cuda, F32_BOUND)
    entry = k1_entry("gj_inverse_dae_stage", A.float(), counts["gj_inverse"],
                     rel, abs_err)
    entry["solve_dtype"] = dtype
    return entry


def integrator_breadth(dev, it0) -> None:
    """Phase 34: GNSF, DISCRETE, p_global and LIFTED_IRK at full width.
    (a) The main path with integrator_type GNSF (structure detected) by
    SQP-RTI from the main path's converged iterate, 1 cold + GNSF_WARM
    calls, every status 0 and in tolerance, no kernel launch; the batch
    simulator with GNSF beside IRK (B_SIM, float32), its gap in x_next.
    (b) DISCRETE: a hand-rolled RK4 disc_dyn_expr on the pendulum beside
    ERK at 4 stages and 1 step, DISC_CALLS RTI calls each from the same
    x0s, every status 0: in float32 the steps and Jacobians within
    DISC_STEP_BOUND and at most DISC_PART_SHARE of the instances parted
    (beside ERK against itself on x0s moved by one rounding step); in
    float64 the trajectories within DISC_F64_BOUND. (c)
    p_global: the pglob model at B_MAIN with per-instance global
    parameters set through set("p") against the same model with the tail
    baked into a plain p: bit for bit. (d) LIFTED_IRK: repeated
    single-instance simulate() calls converge to IRK's x_next; the OCP
    with LIFTED_IRK equals IRK bit for bit (one RTI call each)."""
    import torch
    from acados_tpu_torch import AcadosSim, AcadosSimSolver
    from acados_tpu_torch.models.pendulum import export_pendulum_model
    from acados_tpu_torch.sim.gnsf import detect_gnsf_structure
    from acados_tpu_torch.models.pendulum import pendulum_ode
    from acados_tpu_torch.testing import pendulum_rk4, pglobal_ocp

    # (a) GNSF
    model = detect_gnsf_structure(pendulum_ode, nx=4, nu=1)
    if model is None:
        raise SystemExit("GNSF: no structure detected on the pendulum")
    kw = dict(N=N_HORIZON, dtype="float32", nlp_solver_type="SQP_RTI",
              integrator_type="IRK")
    gnsf, _ = rti_batch(dict(kw, integrator_type="GNSF"), B_MAIN, dev)
    gnsf._it_dev = it0
    ms = []
    reset_counts()
    for c in range(1 + GNSF_WARM):
        t_ms, st = timed_call(gnsf)
        ms.append(t_ms)
        if np.any(st != 0):
            raise SystemExit(f"GNSF RTI: statuses {np.unique(st)}")
    counts = read_counts()
    res = check_solved("GNSF RTI", gnsf, st)
    log(f"GNSF: the pendulum's structure nx1 {model.nx1}, nx2 {model.nx2}, "
        f"n_out {model.n_out} (perm {model.perm.tolist()}); the main path "
        f"with GNSF (4 stages, 2 substeps) by SQP-RTI from the IRK main "
        f"path's converged iterate, B={B_MAIN}, float32: "
        f"calls {[round(t, 2) for t in ms]} ms, every status 0, residual "
        f"maxima {res.tolist()}; launches {counts} (none expected)")
    if any(counts.values()):
        raise SystemExit(f"GNSF RTI launched {counts}")
    x, u = sim_inputs(B_SIM)
    xn, times = {}, {}
    for itype in ("IRK", "GNSF"):
        sim = sim_solver(itype, B_SIM, "float32", dev)
        sim.simulate(x, u)
        reset_counts()
        times[itype] = [once_ms(lambda: sim.simulate(x, u))
                        for _ in range(GNSF_SIM_CALLS)]
        counts = read_counts()
        want = K1_PER_SIM * GNSF_SIM_CALLS if itype == "IRK" else 0
        xn[itype] = sim.get("xn")
        S = sim.get("S_forw")
        if counts["gj_inverse"] != want or not np.isfinite(S).all():
            raise SystemExit(f"simulator {itype}: launches {counts}")
    gap = float(np.abs(xn["GNSF"] - xn["IRK"]).max()
                / np.abs(xn["IRK"]).max())
    log(f"  simulator B={B_SIM}, float32, sens_forw: IRK median "
        f"{np.median(times['IRK']):.2f} ms, GNSF "
        f"{np.median(times['GNSF']):.2f} ms ({GNSF_SIM_CALLS} calls each); "
        f"max|xn GNSF - xn IRK| / max|xn IRK| {gap:.3e} (bound "
        f"{F32_BOUND:g}: the same collocation)")
    if not gap <= F32_BOUND:
        raise SystemExit("GNSF simulator parts from IRK")

    # (b) DISCRETE
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    rng = np.random.default_rng(SEED)
    x0s = np.asarray(X0_CENTER) + rng.normal(0.0, X0_SIGMA, (B_MAIN, 4))
    toward = (np.inf * rng.choice((-1.0, 1.0), x0s.shape)).astype(np.float32)
    x0s_moved = np.nextafter(x0s.astype(np.float32),
                             toward).astype(np.float64)

    def disc_batch(kind, dtype, x0s_):
        ocp = make_pendulum_ocp(N=N_HORIZON, dtype=dtype,
                                nlp_solver_type="SQP_RTI",
                                integrator_type=kind)
        ocp.solver_options.sim_method_num_stages = 4
        ocp.solver_options.sim_method_num_steps = 1
        if kind == "DISCRETE":
            ocp.model.disc_dyn_expr = pendulum_rk4(1.0 / N_HORIZON)
        return batch_at(ocp, x0s_, dev)

    def parted(a, b):
        """(gaps in x and u relative to 1 + max|b|, the share of
        instances whose u parts by more than DISC_PART)."""
        gaps = {f: float((getattr(a._it_dev, f) - getattr(b._it_dev, f))
                         .abs().max() / (1 + getattr(b._it_dev, f)
                                         .abs().max()))
                for f in ("x", "u")}
        du = (a._it_dev.u - b._it_dev.u).abs().flatten(1).max(1).values
        scale = 1 + b._it_dev.u.abs().max()
        return gaps, float((du / scale > DISC_PART).float().mean())

    runs = {}
    for dtype in ("float32", "float64"):
        solvers = {k: disc_batch(k, dtype, x0s) for k in ("ERK", "DISCRETE")}
        if dtype == "float32":
            solvers["ERK_moved"] = disc_batch("ERK", dtype, x0s_moved)
        reset_counts()
        for _ in range(DISC_CALLS):
            st = {k: s_.solve() for k, s_ in solvers.items()}
            bad = [k for k, v in st.items() if np.any(v != 0)]
            if bad:
                raise SystemExit(f"DISCRETE / ERK {dtype}: non-zero "
                                 f"statuses in {bad}")
        counts = read_counts()
        if any(counts.values()):
            raise SystemExit(f"DISCRETE / ERK {dtype}: launches {counts}")
        runs[dtype] = solvers
    solvers = runs["float32"]
    # the discretizations themselves on every interval of that iterate
    data, it = solvers["ERK"]._on_device()
    flat = lambda a: a.reshape((a.shape[0] * a.shape[1],)
                               + tuple(a.shape[2:]))
    args = (flat(it.x[:, :-1]), flat(it.u), flat(data.p[:, :-1]),
            flat(data.ts[:, :-1]), flat(data.dts))
    outs = {k: solvers[k].form.step_jac_fn(*args)
            for k in ("ERK", "DISCRETE")}
    step_gap = max(float((a - b).abs().max() / (1 + b.abs().max()))
                   for a, b in zip(outs["DISCRETE"], outs["ERK"]))
    g32, share32 = parted(solvers["DISCRETE"], solvers["ERK"])
    g_ulp, share_ulp = parted(solvers["ERK_moved"], solvers["ERK"])
    g64, share64 = parted(runs["float64"]["DISCRETE"], runs["float64"]["ERK"])
    log(f"DISCRETE: the pendulum's RK4 step as disc_dyn_expr beside ERK (4 "
        f"stages, 1 step), B={B_MAIN}, {DISC_CALLS} RTI calls each from the "
        f"same x0s, every status 0, no launch. float32: the step and its "
        f"Jacobians on all {args[0].shape[0]} intervals max|d|/(1+max|ref|) "
        f"{step_gap:.3e} (bound {DISC_STEP_BOUND:g}); DISCRETE - ERK x "
        f"{g32['x']:.3e}, u {g32['u']:.3e}, instances parted (u by more "
        f"than {DISC_PART:g}) {share32:.4%} (bound {DISC_PART_SHARE:.0%}); "
        f"ERK on x0s moved by one float32 rounding step - ERK x "
        f"{g_ulp['x']:.3e}, u {g_ulp['u']:.3e}, parted {share_ulp:.4%}. "
        f"float64: DISCRETE - ERK x {g64['x']:.3e}, u {g64['u']:.3e} "
        f"(bound {DISC_F64_BOUND:g}), parted {share64:.4%}")
    if step_gap > DISC_STEP_BOUND or share32 > DISC_PART_SHARE \
            or max(g64.values()) > DISC_F64_BOUND:
        raise SystemExit("DISCRETE parts from ERK")
    del runs, solvers, outs

    # (c) p_global
    rng = np.random.default_rng(SEED)
    pg = 1.0 + 0.5 * rng.random((B_MAIN, 2))
    tails = np.concatenate([pg, (pg[:, 0] * pg[:, 1] ** 2)[:, None]], 1)
    batches = {}
    for kind in ("p_global", "baked"):
        ocp = pglobal_ocp(N=N_HORIZON, dtype="float32")
        if kind == "baked":
            ocp.model.p, ocp.model.p_global = 4, None
            ocp.model.p_global_precompute_fun = None
            ocp.p_global_values = None
            ocp.parameter_values = np.array([0.1, 1.0, 1.0, 1.0])
        for k, v in F32_TOLS.items():
            setattr(ocp.solver_options, k, v)
        s = nlp_batch(ocp, B_MAIN, dev, (1.0, 0.0), X0_SIGMA)
        full = np.concatenate([np.full((B_MAIN, 1), 0.1), tails], 1)
        if kind == "p_global":
            # through the per-instance views, as a user sets them
            for i, view in enumerate(s.ocp_solvers):
                for k in range(N_HORIZON + 1):
                    view.set(k, "p", full[i])
        else:
            s._data["p"][:] = full[:, None]
            s._data_dev = None
        batches[kind] = s
    if batches["p_global"].form.np_ != 4:
        raise SystemExit("p_global: the parameter is not [p | pg | gd]")
    st = {k: timed_call(s) for k, s in batches.items()}
    same = all(torch.equal(getattr(batches["p_global"]._it_dev, f),
                           getattr(batches["baked"]._it_dev, f))
               for f in ("x", "u", "pi", "lam_l", "lam_u"))
    res = check_solved("p_global", batches["p_global"], st["p_global"][1])
    log(f"p_global: the pglob model (p = [p_stage | mass, length | m l^2]), "
        f"B={B_MAIN}, N={N_HORIZON}, float32, per-instance global "
        f"parameters in [1, 1.5]: {st['p_global'][0]:.2f} ms, every status "
        f"0, residual maxima {res.tolist()}; beside the tail baked into a "
        f"plain p ({st['baked'][0]:.2f} ms): bit for bit {same}")
    if not same or not np.array_equal(st["p_global"][1], st["baked"][1]):
        raise SystemExit("p_global parts from the baked parameter")

    # (d) LIFTED_IRK
    xs, us = sim_inputs(1)
    sims = {}
    for itype in ("IRK", "LIFTED_IRK"):
        sim = AcadosSim()
        sim.model = export_pendulum_model()
        so = sim.solver_options
        so.T, so.integrator_type, so.num_stages, so.num_steps = \
            SIM_DT, itype, 4, 2
        so.newton_iter, so.dtype = 8, "float32"
        sims[itype] = AcadosSimSolver(sim, device=dev)
    x_irk = sims["IRK"].simulate(x=xs[0], u=us[0])
    errs = [float(np.abs(sims["LIFTED_IRK"].simulate(x=xs[0], u=us[0])
                         - x_irk).max()) for _ in range(LIFTED_CALLS)]
    log(f"LIFTED_IRK: {LIFTED_CALLS} single-instance simulate() calls "
        f"(float32, 4 stages, 2 substeps) against IRK's x_next (8 Newton "
        f"iterations): max|x - x_IRK| by call "
        f"{[f'{e:.2e}' for e in errs]}")
    if not (errs[-1] <= F32_BOUND * max(1.0, np.abs(x_irk).max())
            and errs[0] > errs[-1]):
        raise SystemExit("LIFTED_IRK does not converge to IRK")
    ocp_runs = {}
    for itype in ("IRK", "LIFTED_IRK"):
        s, _ = rti_batch(dict(kw, integrator_type=itype), B_MAIN, dev)
        st = s.solve()
        ocp_runs[itype] = (st, s._it_dev)
    same = all(torch.equal(getattr(ocp_runs["IRK"][1], f),
                           getattr(ocp_runs["LIFTED_IRK"][1], f))
               for f in ("x", "u", "pi"))
    log(f"  the main path's OCP with LIFTED_IRK against IRK, one RTI call "
        f"each: bit for bit {same}")
    if not same or not np.array_equal(ocp_runs["IRK"][0],
                                      ocp_runs["LIFTED_IRK"][0]):
        raise SystemExit("the OCP's LIFTED_IRK parts from IRK")


def sim_vs_cpu(label, make, calls=1, fields=("xn", "S_forw", "zn")):
    """A float64 simulator (make(device) -> AcadosSim(Batch)Solver, called
    by run(solver)) on the card and on the CPU: every field within 1e-9
    relative. The CPU half: cpu_half(label)."""
    import torch

    def outputs(where):
        s, run = make(where)
        for _ in range(calls):
            run(s)
        return {f: np.asarray(s.get(f)) for f in fields}

    ref = cpu_half(label, lambda: outputs("cpu"))
    if not card_half():
        return
    card = outputs(torch.device("cuda"))
    g = max(float(np.max(np.abs(card[f] - ref[f]) / (1 + np.abs(ref[f])),
                         initial=0.0)) for f in fields)
    log(f"{label} float64: card vs CPU max |d|/(1+|ref|) over "
        f"{list(fields)} {g:.3e} (bound 1e-9)")
    if not g <= 1e-9:
        raise SystemExit(f"{label}: card and CPU disagree")


def integrators_vs_cpu() -> None:
    """Phase 35: float64 card against CPU of phases 33-34's paths at
    B = B_INT_CHECK: the DAE cart (N = 10, 2 iterations), the GNSF,
    DISCRETE and LIFTED_IRK (as IRK) RTI batches (1 call) and the
    p_global SQP, the DAE, GNSF and LIFTED_IRK simulators."""
    from acados_tpu_torch import AcadosSim, AcadosSimSolver
    from acados_tpu_torch.models.pendulum import (export_pendulum_model,
                                                  make_pendulum_ocp)
    from acados_tpu_torch.testing import (dae_ocp, pendulum_rk4,
                                          pglobal_ocp)
    from acados_tpu_torch.testing import rti_batch as batch_at
    B = B_INT_CHECK
    card_vs_cpu("DAE cart (N = 10, 2 iterations)",
                lambda where: dae_batch(B, "float64", where, seed=2,
                                        max_iter=2, N=10), calls=1)
    kw64 = dict(N=N_NLP_CHECK, dtype="float64", nlp_solver_type="SQP_RTI")
    for itype in ("GNSF", "LIFTED_IRK"):
        card_vs_cpu(f"{itype} RTI (N = {N_NLP_CHECK})",
                    lambda where: rti_batch(dict(kw64, integrator_type=itype),
                                            B, where, seed=2)[0], calls=1)

    def disc(where):
        ocp = make_pendulum_ocp(integrator_type="DISCRETE", **kw64)
        ocp.model.disc_dyn_expr = pendulum_rk4(1.0 / N_NLP_CHECK)
        rng = np.random.default_rng(2)
        return batch_at(ocp, np.asarray(X0_CENTER)
                        + rng.normal(0.0, X0_SIGMA, (B, 4)), where)

    card_vs_cpu(f"DISCRETE RTI (N = {N_NLP_CHECK})", disc, calls=1)

    def pglob(where):
        s = nlp_batch(pglobal_ocp(N=N_NLP_CHECK), B, where, (1.0, 0.0),
                      X0_SIGMA, seed=2)
        rng = np.random.default_rng(2)
        for view, pg in zip(s.ocp_solvers, 1.0 + 0.5 * rng.random((B, 2))):
            for k in range(N_NLP_CHECK + 1):
                view.set(k, "p", [0.1, *pg, pg[0] * pg[1] ** 2])
        return s

    card_vs_cpu(f"p_global SQP (N = {N_NLP_CHECK})", pglob, calls=1)
    x, u = sim_inputs(B, seed=2)

    def sim_of(itype, where, dae=False):
        sim = AcadosSim()
        sim.model = export_pendulum_model()
        if dae:
            import torch
            from acados_tpu_torch.models.pendulum import pendulum_ode
            sim.model.z = 1
            sim.model.f_impl_expr = lambda xd, x_, z, u_, p, t: torch.cat([
                xd - pendulum_ode(x_, u_), z - x_[2:3] ** 2 - x_[3:4] ** 2])
        so = sim.solver_options
        so.T, so.integrator_type, so.num_stages, so.num_steps = \
            SIM_DT, itype, 4, 2
        return sim

    from acados_tpu_torch import AcadosSimBatchSolver
    for itype, dae in (("IRK", True), ("GNSF", False)):
        sim_vs_cpu(f"simulator {itype}{' DAE' if dae else ''} (B = {B})",
                   lambda where, itype=itype, dae=dae: (
                       AcadosSimBatchSolver(sim_of(itype, where, dae), B,
                                            device=where),
                       lambda s: s.simulate(x, u)),
                   fields=("xn", "S_forw"))
    sim_vs_cpu("simulator IRK DAE (one instance)",
               lambda where: (AcadosSimSolver(sim_of("IRK", where, True),
                                              device=where),
                              lambda s: s.simulate(x=x[0], u=u[0])),
               fields=("xn", "S_forw", "zn"))
    sim_vs_cpu("simulator LIFTED_IRK (one instance, 3 calls)",
               lambda where: (AcadosSimSolver(sim_of("LIFTED_IRK", where),
                                              device=where),
                              lambda s: s.simulate(x=x[0], u=u[0])),
               calls=3, fields=("xn", "S_forw"))


# phases 36-37 (multiphase OCPs). The control horizon: the main path's
# pendulum (ERK, N = 20, SQP Gauss-Newton, float32 at its tolerances)
# free for MP_NC intervals, then the transition x -> [x; u] and the
# control held (nx 5): its held state equals the transition's control
# to MP_HELD_ULPS float32 rounding steps of (1 + |u|) (bit for bit on
# the CPU). The transition example with IRK phases (GL4 = the
# options' default sim_method_num_stages 4, 1 substep): K1 solves the
# double integrator's stage systems at (B 25, 8, 8) and the single
# integrator's at (B 25, 4, 4), on its group branch; a linearization
# runs each IRK phase's fused step Jacobian once (newton_iter 3 + 1
# launches), a merit's dynamics gap each IRK phase's step (3)
MP_NC = 5
MP_HELD_ULPS = 8
K1_PER_MP_LINEARIZE, K1_PER_MP_GAP = 2 * 4, 2 * 3
MP_STAGE_N = (4, 8)
B_MP_CHECK = 4


def mocp_batch(mocp, B, dev, x0_center, sigma, seed=SEED, **so):
    """acados_tpu_torch.testing.MocpBatch of `mocp` with the given solver
    options, x0 per instance = x0_center + N(0, sigma)."""
    from acados_tpu_torch.testing import MocpBatch
    for k, v in so.items():
        setattr(mocp.solver_options, k, v)
    rng = np.random.default_rng(seed)
    x0s = np.asarray(x0_center) + rng.normal(0.0, sigma,
                                             (B, len(x0_center)))
    return MocpBatch(mocp, x0s, dev)


def mp_k1_expected(stats, opts) -> int:
    """K1 launches of one SQP (MERIT_BACKTRACKING) solve of the transition
    example with IRK phases, from its stat table (merit_sqp_k1)."""
    return merit_sqp_k1(stats, opts, K1_PER_MP_LINEARIZE, K1_PER_MP_GAP)


def multiphase_phase(dev) -> list:
    """Phase 36: multiphase OCPs at full width, float32, B = B_MAIN.
    (a) The control horizon (create_ocp_with_control_horizon of the main
    path's pendulum with ERK, N = 20, Nc = MP_NC: N = 21, nx 5) by SQP
    from the main path's x0s: every status 0 and in tolerance, no kernel
    launch, the held control within MP_HELD_ULPS rounding steps, beside
    the single-phase pendulum ERK SQP on the same x0s. (b) The transition
    example with IRK phases by SQP with MERIT_BACKTRACKING from X0 =
    MOCP_X0 + N(0, X0_SIGMA): every status 0 and in tolerance, the
    position carried over the transition, K1 launches equal to
    mp_k1_expected at the shapes (B 25, 8, 8) and (B 25, 4, 4) alone,
    and K1 at both against its plain version, torch.linalg.inv and its
    bound. Returns K1's two kernels entries."""
    import torch
    from acados_tpu_torch.ops import batched_inv
    from acados_tpu_torch.testing import (MOCP_N_H, MOCP_X0,
                                          control_horizon_mocp,
                                          transition_mocp)
    ch = mocp_batch(control_horizon_mocp(N=N_HORIZON, Nc=MP_NC,
                                         dtype="float32"),
                    B_MAIN, dev, X0_CENTER, X0_SIGMA)
    reset_counts()
    ms, st = timed_call(ch)
    counts = read_counts()
    res = check_solved("control horizon", ch, st)
    it_ = ch.get_stats("sqp_iter")
    x, u = ch._it_dev.x, ch._it_dev.u
    u_held = u[:, MP_NC, 0]
    held = (x[:, MP_NC + 1:, 4] - u_held[:, None]).abs() \
        / (1 + u_held.abs()[:, None])
    held_err = float(held.max())
    held_bound = MP_HELD_ULPS * float(torch.finfo(torch.float32).eps)
    log(f"control horizon (pendulum ERK, N={N_HORIZON}, Nc={MP_NC}: N = "
        f"{ch.N}, nx {ch.form.nx}, nu {ch.form.nu}, nc {ch.form.nc}), "
        f"B={B_MAIN}, float32, SQP: 1 call {ms:.2f} ms; statuses "
        f"{np.unique(st, return_counts=True)}; sqp_iter mean "
        f"{it_.mean():.2f} max {it_.max()}; residual maxima {res.tolist()}; "
        f"held state against the transition's control max |d|/(1+|u|) "
        f"{held_err:.3e} (bound {held_bound:.3e}); launches {counts}")
    if any(counts.values()) or not held_err <= held_bound:
        raise SystemExit("control horizon: kernel launches or the held "
                         "control broken")
    single, _ = rti_batch(dict(N=N_HORIZON, dtype="float32",
                               nlp_solver_type="SQP", integrator_type="ERK"),
                          B_MAIN, dev)
    ms1, st1 = timed_call(single)
    check_solved("single-phase pendulum ERK SQP", single, st1)
    it1 = single.get_stats("sqp_iter")
    log(f"  beside it the single-phase pendulum ERK SQP (N={N_HORIZON}), "
        f"same x0s: 1 call {ms1:.2f} ms, sqp_iter mean {it1.mean():.2f} "
        f"max {it1.max()}, every status 0 and in tolerance")
    del ch, single

    tr = mocp_batch(transition_mocp(integrator_type=("IRK", "DISCRETE",
                                                     "IRK"),
                                    dtype="float32"),
                    B_MAIN, dev, MOCP_X0, X0_SIGMA, **F32_TOLS)
    reset_counts()
    with K1Shapes(match=lambda A: A.shape[-1] == MP_STAGE_N[0]) as k1:
        ms, st = timed_call(tr)
    counts = read_counts()
    res = check_solved("transition IRK", tr, st)
    want = mp_k1_expected(tr._stats, tr.opts)
    M = B_MAIN * MOCP_N_H
    shapes = sorted(set(k1.shapes))
    x = tr._it_dev.x
    carry = float((x[:, MOCP_N_H + 1, 0] - x[:, MOCP_N_H, 0]).abs().max())
    it_ = tr.get_stats("sqp_iter")
    log(f"transition example, IRK phases (GL4, nx 2 -> 1), B={B_MAIN}, "
        f"float32, SQP + MERIT_BACKTRACKING, x0 = {list(MOCP_X0)} + N(0, "
        f"{X0_SIGMA}): 1 call {ms:.2f} ms; statuses "
        f"{np.unique(st, return_counts=True)}; sqp_iter mean "
        f"{it_.mean():.2f} max {it_.max()}; residual maxima {res.tolist()}; "
        f"position over the transition max |d| {carry:.3e}; launches "
        f"{counts} (K1 expected {want} from the stat table), shapes "
        f"{shapes}")
    if counts["gj_inverse"] != want or any(
            v for k, v in counts.items() if k != "gj_inverse") \
            or shapes != [(M, n, n) for n in MP_STAGE_N]:
        raise SystemExit(f"transition IRK launches {counts}, K1 expected "
                         f"{want}, shapes {shapes}")
    if not carry <= F32_TOLS["nlp_solver_tol_eq"]:
        raise SystemExit("transition IRK: the position is not carried")
    entries = []
    for n, A in ((8, k1.first), (4, k1.matched)):
        rel, abs_err, _ = check_inverse(
            f"transition stage systems {tuple(A.shape)}", A,
            batched_inv._gj_inverse_cuda, F32_BOUND)
        entries.append(k1_entry(
            f"gj_inverse_mp_stage_{n}", A,
            sum(s[-1] == n for s in k1.shapes), rel, abs_err))
    return entries


def multiphase_vs_cpu() -> None:
    """Phase 37: float64 card against CPU at B = B_MP_CHECK, within 1e-9:
    the transition example with ERK and with IRK phases by SQP, under
    SQP_RTI (2 calls), and the control horizon by SQP."""
    from acados_tpu_torch.testing import (MOCP_X0, control_horizon_mocp,
                                          transition_mocp)
    B = B_MP_CHECK
    for label, phases, nlp in (("ERK", ("ERK", "DISCRETE", "ERK"), "SQP"),
                               ("IRK", ("IRK", "DISCRETE", "IRK"), "SQP"),
                               ("ERK", ("ERK", "DISCRETE", "ERK"),
                                "SQP_RTI")):
        card_vs_cpu(
            f"transition example, {label} phases, {nlp}",
            lambda where, phases=phases, nlp=nlp: mocp_batch(
                transition_mocp(integrator_type=phases, nlp_solver_type=nlp),
                B, where, MOCP_X0, X0_SIGMA, seed=2),
            calls=2 if nlp == "SQP_RTI" else 1)
    card_vs_cpu(f"control horizon (Nc = {MP_NC}), SQP",
                lambda where: mocp_batch(control_horizon_mocp(
                    N=N_HORIZON, Nc=MP_NC), B, where, X0_CENTER, X0_SIGMA,
                    seed=2), calls=1)


# the interface utilities (phase 38): interleaved rounds of the main
# path's batch with and without collect_phase_times (after 1 warm call
# each, from the main path's converged iterate), the rows the phase
# times must cover of time_tot, the heuristics of the timeouts, the zoRO
# description of the IRK pendulum (a path bound on the cart position
# beside the force bound; P0 = 0 and a W and gain at which both rows'
# backoff grows along the horizon and the tightened problem stays
# feasible: at 100 x this W the position's backoff passes its bound and
# the tightened QP fails) and where the files go
PT_ROUNDS = 1                 # cut from 3
PT_COVER = (0.5, 1.05)
TIMEOUT_HEURISTICS = ("ZERO", "LAST", "MAX", "AVERAGE")
# the timeout solves start this many SQP iterations before the solution
# (a row of the stored iterates): each runs a few rounds, not 8 (cut
# from 3)
TIMEOUT_START_BACK = 2
ZORO_POS_BOUND = 3.0
ZORO_W = (1e-6, 1e-5, 1e-6, 1e-5)
ZORO_K = ((1.0, -10.0, 1.0, -1.0),)
ZORO_GAMMA = 2.0
SCIPY_ATOL = 1e-4             # tests/test_admm.py::TestScipyCrossCheck
UTIL_DIR = "build/chip_smoke"
B_UTIL_CHECK = 4
QP_DUMP_SHAPES = dict(
    Q=("N1", "nx", "nx"), R=("N", "nu", "nu"), S=("N", "nu", "nx"),
    q=("N1", "nx"), r=("N", "nu"), A=("N", "nx", "nx"),
    B=("N", "nx", "nu"), b=("N", "nx"), C=("N1", "nc", "nx"),
    D=("N", "nc", "nu"), **dict.fromkeys(
        ("lg", "ug", "mask_l", "mask_u", "Zl", "Zu", "zl", "zu",
         "soft_mask"), ("N1", "nc")))
# the examples (phase 40): examples_torch/, each run with --device cuda,
# and how long the phase waits for them all
EXAMPLES_TIMEOUT = 400
EXAMPLES = ("minimal_example_ocp", "minimal_example_closed_loop",
            "minimal_example_mhe", "mocp_transition_example",
            "differentiable_mpc", "batched_scenario_mpc",
            "batched_rti_phases", "dae_constrained_ocp",
            "on_device_mpc_loop")


def main_path_iterate(dev):
    """The main path's batch after 1 cold + WARM_CALLS calls, in
    tolerance: its converged iterate, for running phases 38-39 alone."""
    solver, _ = rti_batch(dict(N=N_HORIZON, dtype="float32",
                               nlp_solver_type="SQP_RTI",
                               integrator_type="IRK"), B_MAIN, dev)
    run_calls(solver, "main path", timed=0)
    return solver._it_dev


def zoro_pendulum(dtype="float32"):
    """The main path's pendulum (IRK GL4, 2 substeps, N = 20) by SQP with
    a path bound |p| <= ZORO_POS_BOUND and a zoRO description."""
    from acados_tpu_torch import ZoroDescription
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    ocp = make_pendulum_ocp(N=N_HORIZON, dtype=dtype, nlp_solver_type="SQP",
                            integrator_type="IRK")
    ocp.constraints.idxbx = np.array([0])
    ocp.constraints.lbx = np.array([-ZORO_POS_BOUND])
    ocp.constraints.ubx = np.array([ZORO_POS_BOUND])
    ocp.zoro_description = ZoroDescription(
        backoff_scaling_gamma=ZORO_GAMMA, P0_mat=np.zeros((4, 4)),
        W_mat=np.diag(ZORO_W), fdbk_K_mat=np.array(ZORO_K))
    return ocp


def phase_time_calls(dev, it0) -> dict:
    """Phase 38 (a): the main path's batch without and with
    collect_phase_times, from the converged iterate it0, 1 warm call
    each, then PT_ROUNDS interleaved rounds of one timed call: every
    status 0 and in tolerance, K1 LAUNCHES_PER_RTI a call either way;
    after each call with the option, the four phase times positive and
    their sum within PT_COVER of time_tot; both medians logged, and the
    phase times of the plain solver by differencing beside them.
    Returns the two solvers {"plain", "collect"}."""
    kw = dict(N=N_HORIZON, dtype="float32", nlp_solver_type="SQP_RTI",
              integrator_type="IRK")
    solvers = {name: rti_batch(kw, B_MAIN, dev, solver_options=dict(
        collect_phase_times=flag))[0]
        for name, flag in (("plain", False), ("collect", True))}
    covers = []

    def check_previous(name, timed):
        s = solvers["collect"]
        if name == "plain" and s._stats is not None:
            covers.append(phase_cover(s))

    for s in solvers.values():
        s._it_dev = it0
    out = interleaved(solvers, "phase times", None, 1, PT_ROUNDS, 1,
                      before_call=check_previous)
    covers.append(phase_cover(solvers["collect"]))
    calls = 2 + PT_ROUNDS
    for name, (ms, _, counts) in out.items():
        log(f"main path with{'' if name == 'collect' else 'out'} "
            f"collect_phase_times: {call_stats(ms)}; launches over {calls} "
            f"calls {counts}")
        if counts["gj_inverse"] != LAUNCHES_PER_RTI * calls or any(
                v for k, v in counts.items() if k != "gj_inverse"):
            raise SystemExit(f"phase times {name}: launches {counts}")
    ratio = float(np.median(out["collect"][0])) / float(
        np.median(out["plain"][0]))
    last = {k: solvers["collect"].get_stats(k) for k in
            ("time_lin", "time_reg", "time_qp", "time_glob", "time_tot")}
    diffd = {k: solvers["plain"].get_stats(k) for k in
             ("time_lin", "time_qp", "time_glob", "time_tot")}
    log(f"  collect call {ratio:.3f}x the plain median; the sum of the "
        f"phase times over time_tot, call by call: "
        f"{[round(c, 4) for c in covers]}; the last call's (s): "
        f"{json.dumps(last)}; the plain solver's by differencing (s): "
        f"{json.dumps(diffd)}")
    return solvers


def phase_cover(s) -> float:
    """The sum of the batch solver's measured phase times over its
    time_tot; every phase time must be positive and the sum within
    PT_COVER."""
    parts = [s.get_stats(k) for k in ("time_lin", "time_reg", "time_qp",
                                      "time_glob")]
    cover = sum(parts) / s.get_stats("time_tot")
    if not (all(p > 0 for p in parts)
            and PT_COVER[0] <= cover <= PT_COVER[1]):
        raise SystemExit(f"phase times {parts} cover {cover:.3f} of "
                         f"time_tot")
    return cover


def stored_iterates(dev, it0, rti) -> None:
    """Phase 38 (b): store_iterates on the main path: one RTI call
    (K1 LAUNCHES_PER_RTI) of the main-path batch `rti`, its solve
    function rebuilt with the option, from the RTI's converged iterate
    it0; and its Gauss-Newton SQP from it0 with the x0s of another seed
    (from it0 at its own x0s the SQP stops in the first round, which
    leaves one row), K1 LAUNCHES_PER_RTI a lockstep round and one for
    the final residuals; row 0 the initial iterate and the row at each
    instance's sqp_iter its returned x and u, bit for bit; every status
    0 and in tolerance."""
    import torch
    from acados_tpu_torch.interface.solver import make_nlp_solver
    rti.opts = rti.opts.replace(store_iterates=True,
                                collect_phase_times=False)
    rti._solve_fn = make_nlp_solver(rti.form, rti.opts, "SQP_RTI")
    for nlp in ("SQP_RTI", "SQP"):
        if nlp == "SQP_RTI":
            s = rti
        else:
            s, _ = rti_batch(dict(N=N_HORIZON, dtype="float32",
                                  nlp_solver_type=nlp,
                                  integrator_type="IRK"),
                             B_MAIN, dev, seed=SEED + 1,
                             opts_update=dict(store_iterates=True))
        s._it_dev = it0
        reset_counts()
        ms, st = timed_call(s)
        counts = read_counts()
        res = check_solved(f"stored iterates {nlp}", s, st)
        stats, it = s._stats, s._it_dev
        k = stats.sqp_iter.long()
        idx = torch.arange(B_MAIN, device=dev)
        rounds = lockstep_rounds(stats, s.opts)
        want = LAUNCHES_PER_RTI * (rounds + (nlp == "SQP"))
        first = all(torch.equal(h[:, 0], v) for h, v in (
            (stats.iterates_x, it0.x), (stats.iterates_u, it0.u)))
        last = all(torch.equal(h[idx, k], v) for h, v in (
            (stats.iterates_x, it.x), (stats.iterates_u, it.u)))
        mb = (stats.iterates_x.numel() + stats.iterates_u.numel()) \
            * stats.iterates_x.element_size() / 2 ** 20
        log(f"store_iterates, main path {nlp}, B={B_MAIN}: 1 call "
            f"{ms:.2f} ms, history {tuple(stats.iterates_x.shape)} + "
            f"{tuple(stats.iterates_u.shape)} ({mb:.1f} MiB); sqp_iter max "
            f"{int(k.max())}, {rounds} lockstep rounds; residual maxima "
            f"{res.tolist()}; row 0 the initial iterate: {first}; row "
            f"sqp_iter the returned one: {last}; launches {counts} (K1 "
            f"expected {want})")
        if not (first and last) or counts["gj_inverse"] != want:
            raise SystemExit(f"stored iterates {nlp} failed")


def flat_roundtrip(solver, other) -> None:
    """Phase 38 (c): the B_MAIN iterate of `solver` (a main-path batch)
    through get_flat/set_flat and a '.atni' file under UTIL_DIR, bit for
    bit, then into `other`, a second main-path batch with the same x0s
    (its solve function may store iterates: the arithmetic is the
    same): one warm call of each gives the same statuses and iterate bit
    for bit."""
    import os

    import torch
    from acados_tpu_torch import AcadosOcpFlattenedBatchIterate
    from acados_tpu_torch.native import load_iterate_bin, save_iterate_bin
    fields = ("x", "u", "pi", "lam", "sl", "su")
    t0 = time.perf_counter()
    flat = solver.store_iterate_to_flat_obj()
    t_get = time.perf_counter() - t0
    for f in fields:
        solver.set_flat(f, getattr(flat, f))
    same = all(np.array_equal(solver.get_flat(f), getattr(flat, f))
               for f in fields)
    os.makedirs(UTIL_DIR, exist_ok=True)
    path = os.path.join(UTIL_DIR, f"iterate_b{B_MAIN}.atni")
    t0 = time.perf_counter()
    save_iterate_bin(path, {f: getattr(flat, f) for f in fields})
    back = load_iterate_bin(path)
    t_io = time.perf_counter() - t0
    same_file = all(np.array_equal(back[f], getattr(flat, f))
                    for f in fields)
    other.load_iterate_from_flat_obj(AcadosOcpFlattenedBatchIterate(
        **back, N_batch=B_MAIN))
    st1, st2 = solver.solve(), other.solve()
    warm_same = np.array_equal(st1, st2) and all(
        torch.equal(getattr(solver._it_dev, f), getattr(other._it_dev, f))
        for f in ("x", "u", "pi", "lam_l", "lam_u", "sl", "su"))
    log(f"flat iterate, B={B_MAIN}: get {t_get * 1e3:.1f} ms (one host "
        f"copy a field), set_flat round trip bit for bit: {same}; "
        f"'.atni' {os.path.getsize(path) / 2 ** 20:.1f} MiB written and "
        f"read in {t_io * 1e3:.1f} ms, bit for bit: {same_file}; the next "
        f"call of the solver and of a second one loaded from the file "
        f"equal bit for bit: {warm_same} (statuses "
        f"{np.unique(st2, return_counts=True)})")
    if not (same and same_file and warm_same) or np.any(st2 != 0):
        raise SystemExit("flat iterate round trip failed")
    os.remove(path)


def single_solver_utilities(dev) -> dict:
    """Phase 38 (d-g) on single-instance solvers of the main path's
    pendulum (IRK, N = 20, float32, SQP). One solve with store_iterates
    (get_iterates: row 0 the initial iterate, the last the solution, bit
    for bit); its iterate TIMEOUT_START_BACK rows before the solution is
    the start of the timeout solves (1e-7 s with LAST gives status 7 with
    sqp_iter < 5; 120 s with each heuristic status 0 and bit for bit the
    solve without a timeout from the same start). Then print_statistics()
    and dump_qp_to_file (the 19 keys at their shapes), zoRO's
    custom_update from the solution (K1 exactly LAUNCHES_PER_RTI, a finite
    backoff growing along the horizon on the tightened rows, the
    tightened solve at status 0), and AcadosScipyOcpSolver on the
    pendulum in float64 against the SQP within SCIPY_ATOL. Returns K1's
    kernels entry at zoRO's shape."""
    import os

    from acados_tpu_torch import AcadosOcpSolver, AcadosScipyOcpSolver
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.ops import batched_inv

    def sqp(dtype="float32", integrator="IRK", **so):
        ocp = make_pendulum_ocp(N=N_HORIZON, dtype=dtype,
                                nlp_solver_type="SQP",
                                integrator_type=integrator)
        for k, v in so.items():
            setattr(ocp.solver_options, k, v)
        return AcadosOcpSolver(ocp, device=dev)

    fields = ("x", "u", "pi", "lam", "sl", "su")
    plain = sqp(store_iterates=True)
    ms, st = once_ms(plain.solve), plain.get_status()
    its = plain.get_iterates()
    x_sol, u_sol = trajectory(plain)
    rows_ok = (np.array_equal(its["x"][-1], x_sol)
               and np.array_equal(its["u"][-1], u_sol)
               and np.all(its["x"][0] == np.asarray(X0_CENTER,
                                                     its["x"].dtype)))
    log(f"single-instance pendulum IRK SQP float32 with store_iterates: "
        f"{ms:.1f} ms, status {st}, {plain.get_stats('sqp_iter')} "
        f"iterations; get_iterates {its['x'].shape}, row 0 the initial "
        f"iterate and the last the solution: {rows_ok}")
    if st != 0 or not rows_ok:
        raise SystemExit("single-instance stored iterates failed")
    row = max(len(its["x"]) - 1 - TIMEOUT_START_BACK, 0)
    start = {k: np.zeros_like(v) for k, v in plain._iterate.items()}
    start.update(x=its["x"][row].astype(np.float64),
                 u=its["u"][row].astype(np.float64))

    def from_start(solver):
        solver.load_iterate_from_obj(start)
        return solver.solve()

    ref_s = sqp()
    st = from_start(ref_s)
    ref = {f: ref_s.get_flat(f) for f in fields}
    tight = sqp(timeout_max_time=1e-7, timeout_heuristic="LAST")
    st7 = from_start(tight)
    log(f"timeouts, from the iterate of row {row}: without, status {st} "
        f"after {ref_s.get_stats('sqp_iter')} iterations; budget 1e-7 s "
        f"(LAST): status {st7}, sqp_iter {tight.get_stats('sqp_iter')}")
    if st != 0 or st7 != 7 or not tight.get_stats("sqp_iter") < 5:
        raise SystemExit("the impossible budget did not time out")
    for heur in TIMEOUT_HEURISTICS:
        s = sqp(timeout_max_time=120.0, timeout_heuristic=heur)
        st = from_start(s)
        same = all(np.array_equal(s.get_flat(f), ref[f]) for f in fields)
        log(f"  budget 120 s ({heur}): status {st}, bit for bit the solve "
            f"without a timeout: {same}")
        if st != 0 or not same:
            raise SystemExit(f"timeout {heur} changed the solve")

    plain.print_statistics()
    os.makedirs(UTIL_DIR, exist_ok=True)
    path = os.path.join(UTIL_DIR, "qp.npz")
    plain.dump_qp_to_file(path)
    dims = dict(N=N_HORIZON, N1=N_HORIZON + 1, nx=plain.form.nx,
                nu=plain.form.nu, nc=plain.form.nc)
    with np.load(path) as z:
        got = {k: z[k].shape for k in z.files}
        finite = all(np.isfinite(z[k]).all() for k in z.files)
    want = {k: tuple(dims[d] for d in v) for k, v in QP_DUMP_SHAPES.items()}
    log(f"dump_qp_to_file: {len(got)} keys, shapes as the JAX package's: "
        f"{got == want}, finite: {finite}")
    if got != want or not finite:
        raise SystemExit(f"dump_qp_to_file: {got}")
    os.remove(path)

    zs = AcadosOcpSolver(zoro_pendulum(), device=dev)
    for k in range(N_HORIZON + 1):   # its position bound is inactive there
        zs.set(k, "x", x_sol[k])
        if k < N_HORIZON:
            zs.set(k, "u", u_sol[k])
    if zs.solve() != 0:
        raise SystemExit("zoRO nominal solve failed")
    base = zs._data["ub"].copy()
    reset_counts()
    with K1Shapes() as k1:
        zms = once_ms(zs.custom_update)
    counts = read_counts()
    lay = zs.layouts["p"]
    rows = [lay.off_bu, lay.off_bx]
    back = base[:, rows] - zs._data["ub"][:, rows]
    grows = bool(np.all(np.diff(back, axis=0) > 0))
    st_t = zs.solve()
    log(f"zoRO custom_update, pendulum IRK N={N_HORIZON} float32: "
        f"{zms:.2f} ms, launches {counts}, K1 shapes "
        f"{sorted(set(k1.shapes))}; backoff of the force and position "
        f"rows at stages 1 and {N_HORIZON - 1}: {back[0].tolist()} -> "
        f"{back[-1].tolist()}, finite and growing: "
        f"{bool(np.isfinite(back).all()) and grows}; tightened solve "
        f"status {st_t}")
    if counts["gj_inverse"] != LAUNCHES_PER_RTI or any(
            v for k, v in counts.items() if k != "gj_inverse") \
            or not (np.isfinite(back).all() and grows and np.all(back > 0)) \
            or st_t != 0:
        raise SystemExit("zoRO custom_update failed")
    A = k1.first
    rel, abs_err, _ = check_inverse(f"zoRO stage systems {tuple(A.shape)}",
                                    A, batched_inv._gj_inverse_cuda,
                                    F32_BOUND)
    entry = k1_entry("gj_inverse_zoro", A, counts["gj_inverse"], rel,
                     abs_err)

    s64 = sqp(dtype="float64", integrator="ERK")
    if s64.solve() != 0:
        raise SystemExit("float64 pendulum SQP failed")
    x_sqp, u_sqp = trajectory(s64)
    oracle = AcadosScipyOcpSolver(s64.acados_ocp, device=dev)
    t0 = time.perf_counter()
    st_o = oracle.solve(x_init=x_sqp, u_init=u_sqp)
    o_ms = (time.perf_counter() - t0) * 1e3
    x_o, u_o = trajectory(oracle)
    gap = max(float(np.abs(x_o - x_sqp).max()),
              float(np.abs(u_o - u_sqp).max()))
    log(f"AcadosScipyOcpSolver, pendulum float64 on the card: status "
        f"{st_o} in {o_ms:.0f} ms ({oracle._result.nit} SLSQP iterations, "
        f"{oracle._result.nfev} evaluations), max |oracle - SQP| over x "
        f"and u {gap:.3e} (atol {SCIPY_ATOL:g})")
    if st_o != 0 or not gap <= SCIPY_ATOL:
        raise SystemExit("the scipy oracle disagrees with the SQP")
    return entry


def trajectory(solver):
    """(x (N+1, nx), u (N, nu)) of a single-instance solver."""
    return (np.array([solver.get(k, "x") for k in range(solver.N + 1)]),
            np.array([solver.get(k, "u") for k in range(solver.N)]))


def utilities_phase(dev, it0=None) -> list:
    """Phase 38: the interface utilities on the card at the main path's
    width (B = B_MAIN, float32, pendulum IRK GL4, N = 20, its x0s), from
    the main path's converged iterate it0 (made here when None, to run
    the phase alone): the phase times, stored iterates, the flat
    iterate and '.atni', then the single-instance utilities. Returns
    K1's kernels entry at zoRO's shape."""
    if it0 is None:
        it0 = main_path_iterate(dev)
    solvers = phase_time_calls(dev, it0)
    stored_iterates(dev, it0, solvers["collect"])
    flat_roundtrip(solvers["plain"], solvers["collect"])
    del solvers
    return [single_solver_utilities(dev)]


def utilities_vs_cpu() -> None:
    """Phase 39: float64 card against CPU of phase 38's new paths at
    B = B_UTIL_CHECK: the stored iterates of a main-path SQP cut at 4
    iterations, the flat iterate after 3 RTI calls, zoRO's tightened
    bounds (single instance, linearized at x = x0 on every stage) and
    the scipy oracle from the CPU SQP's solution, each within 1e-9 as
    max |d| / (1 + |cpu|), the oracle within the CPU's own spread where
    that exceeds 1e-9 (the CPU oracle started one rounding step away)."""
    import torch
    from acados_tpu_torch import AcadosOcpSolver, AcadosScipyOcpSolver
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    kw64 = dict(N=N_HORIZON, dtype="float64", integrator_type="IRK")
    flat_fields = ("x", "u", "pi", "lam", "sl", "su")
    ocp = make_pendulum_ocp(N=N_HORIZON, dtype="float64",
                            nlp_solver_type="SQP")

    def oracle(where, x_init, u_init):
        o = AcadosScipyOcpSolver(ocp, device=where)
        if o.solve(x_init=x_init, u_init=u_init) != 0:
            raise SystemExit(f"scipy oracle ({where}) failed")
        return np.concatenate([a.reshape(-1) for a in trajectory(o)])

    def outputs(where) -> dict:
        """The paths' results on `where`, as numpy."""
        s, _ = rti_batch(dict(kw64, nlp_solver_type="SQP"), B_UTIL_CHECK,
                         where, seed=2,
                         opts_update=dict(store_iterates=True, max_iter=4))
        out = dict(st=s.solve(),
                   iterates=[getattr(s._stats, f).cpu().numpy()
                             for f in ("iterates_x", "iterates_u")])
        r, _ = rti_batch(dict(kw64, nlp_solver_type="SQP_RTI"),
                         B_UTIL_CHECK, where, seed=2)
        for _ in range(3):
            out["st_rti"] = r.solve()
        out["flat"] = [r.get_flat(f) for f in flat_fields]
        z = AcadosOcpSolver(zoro_pendulum("float64"), device=where)
        for k in range(N_HORIZON + 1):
            z.set(k, "x", X0_CENTER)
        out["st_zoro"] = z.custom_update()
        out["zoro"] = [z._data[k] for k in ("lb", "ub", "lb_e", "ub_e")]
        return out

    def cpu() -> dict:
        out = outputs("cpu")
        s = AcadosOcpSolver(ocp, device="cpu")
        s.solve()
        x0, u0 = trajectory(s)
        out.update(start=(x0, u0), oracle=oracle("cpu", x0, u0),
                   oracle_moved=oracle("cpu", x0 * (1 + np.finfo(float).eps),
                                       u0))
        return out

    ref = cpu_half("phase 39: the interface utilities", cpu)
    if not card_half():
        return
    card = outputs(torch.device("cuda"))
    card["oracle"] = oracle("cuda", *ref["start"])
    if not (np.array_equal(card["st"], ref["st"])
            and np.array_equal(card["st_rti"], ref["st_rti"])
            and card["st_zoro"] == ref["st_zoro"] == 0):
        raise SystemExit("utilities: card and CPU statuses differ")
    gaps = {name: max(rel_gap(a, b) for a, b in zip(card[k], ref[k]))
            for name, k in (("stored iterates", "iterates"),
                            ("flat iterate", "flat"),
                            ("zoRO bounds", "zoro"))}
    gaps["scipy oracle"] = rel_gap(card["oracle"], ref["oracle"])
    spread = rel_gap(ref["oracle_moved"], ref["oracle"])
    bounds = dict.fromkeys(gaps, 1e-9)
    bounds["scipy oracle"] = max(1e-9, 4 * spread)
    log(f"float64 card against CPU, B={B_UTIL_CHECK}: max |d|/(1+|ref|) "
        f"{json.dumps(gaps)}; bounds {json.dumps(bounds)} (the oracle's "
        f"CPU spread from a start one rounding step away {spread:.3e})")
    if any(not gaps[k] <= bounds[k] for k in gaps):
        raise SystemExit("utilities: card and CPU disagree")


def start_examples():
    """Start phase 40: every examples_torch script with --device cuda,
    one process and one thread each. Returns ({name: (process, its log
    file)}, the start time)."""
    import os
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "examples_torch")
    os.makedirs(UTIL_DIR, exist_ok=True)
    procs = {}
    try:
        for name in EXAMPLES:
            logf = open(os.path.join(UTIL_DIR, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, f"{name}.py", "--device", "cuda"], cwd=d,
                stdout=logf, stderr=subprocess.STDOUT,
                env={**os.environ, "OMP_NUM_THREADS": "1"}), logf)
    except BaseException:
        stop_procs(procs.values())
        raise
    return procs, time.perf_counter()


def stop_procs(procs) -> None:
    """Kill what still runs of (process, log file) pairs; close the
    logs."""
    for p, logf in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        logf.close()


def examples_phase(started=None) -> None:
    """Phase 40: every examples_torch script with --device cuda, all
    started together (by start_examples, here when `started` is None),
    one process and one thread each (their main() with its own asserts):
    each must exit 0; its seconds and last lines are logged. Run in this
    process one after the other they took 145.6-194.7 s (host-bound RTI
    loops at B = 1-4), more than the script's time limit leaves beside
    phases 1-39; at once 88.6-116.0 s, so they run beside
    the float64 checks, which time nothing. The processes are stopped on
    the way out."""
    import os
    procs, t0 = started or start_examples()
    done = {}
    try:
        while len(done) < len(procs):
            for name, (p, _) in procs.items():
                if name not in done and p.poll() is not None:
                    done[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > EXAMPLES_TIMEOUT:
                raise SystemExit(f"examples still running after "
                                 f"{EXAMPLES_TIMEOUT} s: "
                                 f"{sorted(set(procs) - set(done))}")
            time.sleep(0.1)
    finally:
        stop_procs(procs.values())
    failed = []
    wall0 = time.time() - (time.perf_counter() - t0)   # t0 on the wall clock
    for name, (p, _) in procs.items():
        path = os.path.join(UTIL_DIR, f"{name}.log")
        with open(path) as f:
            out = f.read().strip().splitlines()
        log(f"example {name}: exit {p.returncode} seen after {done[name]:.1f}"
            f" s (its log last written at {os.path.getmtime(path) - wall0:.1f}"
            f" s); last line: {out[-1] if out else ''}")
        if p.returncode != 0:
            failed.append(name)
            log("\n".join(out[-20:]))
    if failed:
        raise SystemExit(f"examples failed: {failed}")


# batch sharding (phase 41): the main path's batch over two shards on the
# one card (41a: one warm call each, then interleaved rounds of one timed
# call), its two halves in two processes on the card (41b: one call
# checked against the one-process call, then timed calls), and the
# float64 checks (41c: tests/test_torch_sharding.py's B = 8 pendulum
# MERIT SQP, its cost weights scaled by 1e-3, over 4 shards, and the RTI
# phases with adaptive QP tolerances near the upright pendulum)
SHARD_ROUNDS = 2              # cut from 3
DIST_TIMED = 2                # cut from 3
DIST_TIMEOUT = 300
# how long 41b's processes wait, after their first call, for the go
# (phases 39, 40 and 41a run meanwhile)
DIST_GO_TIMEOUT = 900
DIST_DIR = UTIL_DIR + "/dist"
SHARD_CHECK_SHARDS = 4
# the MERIT SQP's float64 check cut at this many iterations (it takes 10
# to 21; the CPU test runs it to the end): the 4 shards' host code takes
# turns, so each iteration costs about 4 unsharded ones
SHARD_CHECK_ITER = 4
SHARD_X0S = np.tile(np.array([0.0, np.pi, 0.0, 0.0]), (8, 1))
SHARD_X0S[:, 1] += np.linspace(-0.05, 0.05, 8)
ADAPTIVE_X0S = (np.array([0.0, 0.15, 0.0, 0.0])
                + np.random.default_rng(7).normal(0.0, 0.03, (8, 4)))
ADAPTIVE_CYCLES = 3


def sharding_phase(dev, it0):
    """Phase 41a: the main path's batch (B = B_MAIN, float32) from the
    converged iterate it0, as the default solver, with devices=["cuda:0"]
    and with devices=["cuda:0"] * 2 (two shards, each in a thread of its
    own, on the one card): one warm call each, K1 LAUNCHES_PER_RTI a
    call unsharded and twice that sharded, every K1 launch of the sharded
    call at half the batch; devices=["cuda:0"] bit for bit the default;
    each shard bit for bit its half of the batch solved alone (statuses,
    qp_iter, iterate); against the whole batch the statuses equal and
    every instance in tolerance, the x/u gap and the instances whose
    qp_iter differs logged (in float32 on the card a QP's last IPM round
    follows reductions whose order depends on the batch size: the halves
    alone stop 880 of the 4096 instances' QPs a round earlier or later
    than the whole batch, with the same iterate bit for bit); then
    SHARD_ROUNDS interleaved rounds of one timed call each
    (K1 counted again) and both medians beside the card's name and power
    limit. Returns (K1's kernels entry at a shard's shape, (the unsharded
    first call's status histogram, its largest res_stat, the res_stat
    gate))."""
    import torch
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.ops import batched_inv
    from acados_tpu_torch.testing import rti_batch as batch_at
    from acados_tpu_torch.utils.struct import map_fields
    one = ["cuda:0"]
    solvers = {"default": rti_batch(MAIN_KW, B_MAIN, dev)[0],
               "cuda:0": rti_batch(MAIN_KW, B_MAIN, None, devices=one)[0],
               "2 shards": rti_batch(MAIN_KW, B_MAIN, None,
                                     devices=one * 2)[0]}
    if [len(s.mesh) for s in solvers.values()] != [1, 1, 2]:
        raise SystemExit(f"meshes {[s.mesh for s in solvers.values()]}")
    for s in solvers.values():
        s._it_dev = map_fields(lambda t: t.clone(), it0)
        s._host_stale = True
    half = B_MAIN * N_HORIZON // 2
    counts, warm_ms, shapes = {}, {}, {}
    with K1Shapes(match=lambda A: A.shape[0] == half) as k1:
        for name, s in solvers.items():
            n_shapes = len(k1.shapes)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve()
            torch.cuda.synchronize()
            warm_ms[name] = (time.perf_counter() - t0) * 1e3
            counts[name] = read_counts()
            shapes[name] = sorted(set(k1.shapes[n_shapes:]))
    want = {name: {**dict.fromkeys(counts[name], 0),
                   "gj_inverse": LAUNCHES_PER_RTI * len(s.mesh)}
            for name, s in solvers.items()}
    log(f"sharding: main path B={B_MAIN} from its converged iterate, one "
        f"warm call each: K1 launches "
        f"{json.dumps({k: c['gj_inverse'] for k, c in counts.items()})} at "
        f"{json.dumps({k: [list(v) for v in vs] for k, vs in shapes.items()})}"
        f", ms {json.dumps(warm_ms)}")
    if counts != want or shapes["2 shards"] != [(half, 16, 16)]:
        raise SystemExit(f"sharding: expected launches {want} and K1 at "
                         f"({half}, 16, 16) sharded")
    d, o, two = (solvers[k] for k in ("default", "cuda:0", "2 shards"))
    fields = [f.name for f in dataclasses.fields(d._it_dev)]
    # each half alone, unsharded: what a shard computes
    halves = []
    for h in (slice(0, B_MAIN // 2), slice(B_MAIN // 2, B_MAIN)):
        s = batch_at(make_pendulum_ocp(**MAIN_KW), d._data["lb_0"][h, :4],
                     dev)
        s._it_dev = map_fields(lambda t: t[h].clone(), it0)
        s._host_stale = True
        s.solve()
        halves.append(s)
    half_st = np.concatenate([s._status for s in halves])
    half_qp = np.concatenate([s.get_stats("qp_iter") for s in halves])
    half_bits = sum(int((getattr(two._it_dev, f) != torch.cat(
        [getattr(s._it_dev, f) for s in halves])).sum()) for f in fields)
    log(f"  2 shards against the halves solved alone: statuses equal "
        f"{np.array_equal(two._status, half_st)}, qp_iter equal "
        f"{np.array_equal(two.get_stats('qp_iter'), half_qp)}, iterate "
        f"entries that differ {half_bits}; the halves against the whole "
        f"batch: qp_iter differs on "
        f"{int((half_qp != d.get_stats('qp_iter')).sum())} instances")
    if not (np.array_equal(two._status, half_st) and np.array_equal(
            two.get_stats("qp_iter"), half_qp) and half_bits == 0):
        raise SystemExit("sharding: a shard is not bit for bit its half "
                         "solved alone")
    if not (np.array_equal(d._status, o._status) and np.array_equal(
            d.get_stats("qp_iter"), o.get_stats("qp_iter")) and all(
            torch.equal(getattr(d._it_dev, f), getattr(o._it_dev, f))
            for f in fields)):
        raise SystemExit("sharding: devices=['cuda:0'] is not bit for bit "
                         "the default")
    same_st = np.array_equal(two._status, d._status)
    qp_diff = two.get_stats("qp_iter") - d.get_stats("qp_iter")
    ok_tol, res, tols = in_tolerance(two)
    gaps = {f: float((getattr(two._it_dev, f)
                      - getattr(d._it_dev, f)).abs().max())
            for f in ("x", "u")}
    n_bits = sum(int((getattr(two._it_dev, f)
                      != getattr(d._it_dev, f)).sum()) for f in fields)
    log(f"  2 shards against the whole batch unsharded: statuses equal "
        f"{same_st}, qp_iter differs on {int((qp_diff != 0).sum())} "
        f"instances (by {sorted(set(qp_diff[qp_diff != 0].tolist()))}), "
        f"largest |x| gap {gaps['x']:.3e}, |u| gap {gaps['u']:.3e}, "
        f"iterate entries that differ {n_bits}; residual maxima "
        f"{res.tolist()} vs tolerances {list(tols)}: "
        f"{'in tolerance' if ok_tol else 'OUT OF TOLERANCE'}")
    if not (same_st and ok_tol):
        raise SystemExit("sharding: the sharded call disagrees")
    ref_hist = np.bincount(d._status, minlength=8)
    ref_max = float(d.get_stats("residuals")[:, 0].max())
    gate = d.acados_ocp.solver_options.nlp_solver_tol_stat
    timed = interleaved({"unsharded": d, "2 shards": two}, "sharding",
                        None, 0, SHARD_ROUNDS, 1,
                        warmed=("unsharded", "2 shards"))
    for name, per_call in (("unsharded", 1), ("2 shards", 2)):
        got = timed[name][2]
        want_t = {**dict.fromkeys(got, 0), "gj_inverse":
                  LAUNCHES_PER_RTI * per_call * SHARD_ROUNDS}
        if got != want_t:
            raise SystemExit(f"sharding {name}: launches {got}, expected "
                             f"{want_t}")
    med = {k: float(np.median(v[0])) for k, v in timed.items()}
    log(f"  {SHARD_ROUNDS} interleaved rounds of one call: unsharded "
        f"{timed['unsharded'][0]} ms (median {med['unsharded']:.2f}), 2 "
        f"shards on one card {timed['2 shards'][0]} ms (median "
        f"{med['2 shards']:.2f}; {med['2 shards'] / med['unsharded']:.3f}x)"
        f" on {card_line()}")
    A = k1.matched
    rel, abs_err, _ = check_inverse(f"a shard's stage Jacobians "
                                    f"{tuple(A.shape)}", A,
                                    batched_inv._gj_inverse_cuda, F32_BOUND)
    entry = k1_entry("gj_inverse", A, LAUNCHES_PER_RTI * 2
                     * (1 + SHARD_ROUNDS), rel, abs_err)
    return entry, (ref_hist, ref_max, gate)


def start_dist(it0, x0s) -> list:
    """Start phase 41b: two processes on the one card with torchrun's
    environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    `chip_smoke.py --dist-worker DIST_DIR`, from the main path's
    converged iterate it0 (x0s: the batch's x0s). Each makes its first
    call and waits for DIST_DIR/go (dist_phase). Returns [(process, its
    log file)]."""
    import os
    import shutil
    import socket
    import torch
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    torch.save({f.name: getattr(it0, f.name).cpu()
                for f in dataclasses.fields(it0)},
               os.path.join(DIST_DIR, "it0.pt"))
    np.save(os.path.join(DIST_DIR, "x0s.npy"), np.asarray(x0s))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
    procs = []
    try:
        for r in range(2):
            logf = open(os.path.join(DIST_DIR, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 DIST_DIR], stdout=logf, stderr=subprocess.STDOUT,
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}), logf))
    except BaseException:
        stop_procs(procs)
        raise
    return procs


def dist_phase(procs, ref_hist, ref_max, gate) -> None:
    """Phase 41b: the processes of start_dist, each through
    initialize_distributed (gloo) on its process_local_batch_slice of the
    main path's batch, K1 LAUNCHES_PER_RTI a call. Their first call ran
    beside the float64 checks; after it the summed status histogram must
    equal the one-process call's (ref_hist, phase 41a's) and the global
    largest res_stat ref_max within the float32 gate (res_stat's
    tolerance). Here they are let go (DIST_DIR/go) for DIST_TIMED timed
    calls, every status 0; the pair's wall time from the go is logged.
    The processes are stopped on the way out."""
    import os
    t0 = time.perf_counter()
    open(os.path.join(DIST_DIR, "go"), "w").close()
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, DIST_TIMEOUT
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        raise SystemExit(f"dist: the processes ran over {DIST_TIMEOUT} s")
    finally:
        stop_procs(procs)
    wall = time.perf_counter() - t0
    outs = []
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(DIST_DIR, f"rank{r}.log")) as f:
                log(f.read()[-3000:])
            raise SystemExit(f"dist: rank {r} exited {p.returncode}")
        with open(os.path.join(DIST_DIR, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    for o in outs:
        others = sum(v for c in o["launches"] for k, v in c.items()
                     if k != "gj_inverse")
        log(f"  dist rank {o['rank']} of {o['world']}: slice {o['slice']}, "
            f"ready after {o['setup_s']:.1f} s, calls "
            f"{[round(t, 2) for t in o['call_ms']]} ms, K1 launches a call "
            f"{[c['gj_inverse'] for c in o['launches']]} (others {others}),"
            f" summed statuses {o['hist']}, global largest res_stat "
            f"{o['global_max']:.4e} (its own {o['local_max']:.4e})")
    ok = (all(o["world"] == 2 and o["hist"] == ref_hist.tolist()
              and abs(o["global_max"] - ref_max) <= gate
              and o["global_max"] <= gate and o["all_zero"]
              and all(c == {**dict.fromkeys(c, 0),
                            "gj_inverse": LAUNCHES_PER_RTI}
                      for c in o["launches"]) for o in outs)
          and [o["slice"] for o in outs] == [[0, B_MAIN // 2],
                                             [B_MAIN // 2, B_MAIN]])
    log(f"dist: two processes on one card, B={B_MAIN} split in halves, "
        f"the pair's {DIST_TIMED} timed calls each {wall:.1f} s of wall "
        f"time; the one-process call's statuses "
        f"{ref_hist.tolist()}, largest res_stat {ref_max:.4e} (gate "
        f"{gate:g}): {'agree' if ok else 'DISAGREE'}")
    if not ok:
        raise SystemExit("dist: the two processes disagree")


def wait_for(path: str, timeout: float) -> None:
    """Wait until the file `path` exists."""
    import os
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"no {path} after {timeout} s")
        time.sleep(0.05)


def dist_worker(d: str) -> int:
    """One process of phase 41b (see dist_phase); writes rank{r}.json
    under d."""
    import os
    import torch
    import torch.distributed as dist
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.ocp_nlp.linearize import NlpIterate
    from acados_tpu_torch.ops import cuda_build
    from acados_tpu_torch.parallel.distributed import (
        all_reduce_status_counts, global_max_residual,
        initialize_distributed, process_local_batch_slice)
    from acados_tpu_torch.testing import rti_batch as batch_at
    t_start = time.perf_counter()
    world = initialize_distributed()
    rank = dist.get_rank()
    try:
        start, stop = process_local_batch_slice(B_MAIN)
        dev = torch.device("cuda:0")
        x0s = np.load(os.path.join(d, "x0s.npy"))
        it0 = torch.load(os.path.join(d, "it0.pt"))
        solver = batch_at(make_pendulum_ocp(**MAIN_KW), x0s[start:stop],
                          dev)
        solver._it_dev = NlpIterate(**{k: v[start:stop].to(dev)
                                       for k, v in it0.items()})
        solver._host_stale = True
        cuda_build.load("gj_inverse")
        setup_s = time.perf_counter() - t_start
        call_ms, launches, all_zero = [], [], True
        for c in range(1 + DIST_TIMED):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = solver.solve()
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(read_counts())
            all_zero = all_zero and bool(np.all(st == 0))
            if c == 0:
                res = solver.get_stats("residuals")[:, 0]
                hist = all_reduce_status_counts(st)
                gmax = global_max_residual(res)
                wait_for(os.path.join(d, "go"), DIST_GO_TIMEOUT)
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, world=world, slice=[start, stop],
                           hist=hist.tolist(), global_max=gmax,
                           local_max=float(res.max()), call_ms=call_ms,
                           launches=launches, all_zero=all_zero,
                           setup_s=setup_s), f)
    finally:
        dist.destroy_process_group()
    return 0


def merit_shard_batch(where):
    """Phase 41c's SQP: tests/test_torch_sharding.py's pendulum MERIT SQP
    (float64, N = N_HORIZON, cost weights scaled by 1e-3) at SHARD_X0S,
    cut at SHARD_CHECK_ITER iterations, unsharded on the CPU, over
    SHARD_CHECK_SHARDS shards on the card."""
    import torch
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    ocp = make_pendulum_ocp(N=N_HORIZON, nlp_solver_type="SQP")
    ocp.solver_options.globalization = "MERIT_BACKTRACKING"
    ocp.cost.W = 1e-3 * np.asarray(ocp.cost.W)
    ocp.cost.W_e = 1e-3 * np.asarray(ocp.cost.W_e)
    ocp.solver_options.nlp_solver_max_iter = SHARD_CHECK_ITER
    if torch.device(where).type == "cpu":
        return batch_at(ocp, SHARD_X0S, "cpu")
    return batch_at(ocp, SHARD_X0S, None,
                    devices=["cuda:0"] * SHARD_CHECK_SHARDS)


def adaptive_rti_batch(where):
    """Phase 41c's RTI phases: the pendulum ERK SQP_RTI (float64, N = 8)
    with nlp_qp_tol_strategy ADAPTIVE_CURRENT_RES_JOINT near the upright
    reference (tests/test_torch_rti.py's set-up at B = 8)."""
    from acados_tpu_torch.models.pendulum import make_pendulum_ocp
    from acados_tpu_torch.testing import rti_batch as batch_at
    ocp = make_pendulum_ocp(N=8, dtype="float64", nlp_solver_type="SQP_RTI")
    ocp.solver_options.nlp_qp_tol_strategy = "ADAPTIVE_CURRENT_RES_JOINT"
    return batch_at(ocp, ADAPTIVE_X0S, where)


def closed_loop_cycle(solver):
    """prepare(), then feedback() at the x_1 of the solver's iterate (the
    loop closed on the model); returns the statuses."""
    x1 = solver._host_iterate()["x"][:, 1].copy()
    solver.prepare()
    return solver.feedback(x0=x1)


def sharding_vs_cpu() -> None:
    """Phase 41c: float64 card against CPU within 1e-9: the MERIT SQP
    over SHARD_CHECK_SHARDS shards on the card against the unsharded CPU
    solve (statuses and sqp_iter equal), and ADAPTIVE_CYCLES
    prepare()/feedback() cycles with adaptive QP tolerances."""
    card_vs_cpu(f"sharded MERIT SQP ({SHARD_CHECK_SHARDS} shards of "
                f"B = {len(SHARD_X0S)} on the card, statuses and sqp_iter)",
                merit_shard_batch, calls=1,
                step=lambda s: np.stack([s.solve(),
                                         s.get_stats("sqp_iter")]))
    card_vs_cpu("RTI phases with adaptive QP tolerances",
                adaptive_rti_batch, calls=ADAPTIVE_CYCLES,
                step=closed_loop_cycle)


# the main path's config in float64 for phases 5 and 9
KW64 = dict(N=N_HORIZON, dtype="float64", nlp_solver_type="SQP_RTI",
            integrator_type="IRK")


def main_path_vs_cpu() -> None:
    """Phase 5: the main path's config in float64 at B = 8, card against
    CPU."""
    card_vs_cpu("reference check",
                lambda where: rti_batch(KW64, 8, where, seed=1)[0])


def full_cond_vs_cpu() -> None:
    """Phase 9: the same with full condensing."""
    card_vs_cpu("full-condensing reference check",
                lambda where: rti_batch(KW64, 8, where, seed=1,
                                        qp_solver=FULL_COND)[0])


def chain_vs_cpu() -> None:
    """Phase 14: the chain in float64 at B = 4, card against CPU, beside
    the CPU's own spread under one rounding step of the x0s."""
    card_vs_cpu(f"chain reference check (n_mass={N_MASS}, N={N_CHAIN})",
                lambda where: chain_batch(N_MASS, 4, "float64", where),
                moved=lambda: chain_batch(N_MASS, 4, "float64", "cpu",
                                          moved=True))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-refs":
        return cpu_refs_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":
        return dist_worker(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    from acados_tpu_torch.ops import cuda_build
    from acados_tpu_torch.utils.device import full_precision_matmul
    t_run = time.perf_counter()

    def at(phase):
        log(f"-- phase {phase} from {time.perf_counter() - t_run:.1f} s")

    # ---- 1. device ---------------------------------------------------------
    at(1)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    full_precision_matmul()
    dev = torch.device("cuda")

    # ---- 2. build ------------------------------------------------------------
    at(2)
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    log(f"build: {sorted(cuda_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    start_cpu_refs()
    try:
        return card_phases(dev, t_run, at)
    finally:
        stop_cpu_refs()


def stage_jacobians(dev):
    """The main path's batch solver and the stage Jacobians of one
    linearisation, (B_MAIN * N_HORIZON, 16, 16) float32 as the IRK step
    hands them to K1: the first inverse it asks for at the initial
    iterate."""
    import torch
    solver, _ = rti_batch(dict(N=N_HORIZON, dtype="float32",
                               nlp_solver_type="SQP_RTI",
                               integrator_type="IRK"), B_MAIN, dev)
    data = solver._data
    M = B_MAIN * N_HORIZON
    flat = lambda a: torch.as_tensor(
        np.asarray(a).reshape((M,) + np.shape(a)[2:]), dtype=torch.float32,
        device=dev)
    x_init = np.repeat(np.asarray(data["lb_0"])[:, None, :4], N_HORIZON,
                       axis=1)
    with K1Shapes() as k1:
        solver.form.step_jac_fn(
            flat(x_init), torch.zeros((M, 1), device=dev),
            torch.zeros((M, 0), device=dev),
            flat(data["ts"][:, :-1]), flat(data["dts"]))
    J = k1.first
    if J.shape != (M, 16, 16):
        raise SystemExit(f"unexpected stage Jacobian shape {tuple(J.shape)}")
    return solver, J


def card_phases(dev, t_run, at) -> int:
    """Phases 3-41 (see the module docstring)."""
    import torch
    from acados_tpu_torch.dense_qp import ipm as dense_ipm
    from acados_tpu_torch.ops import batched_chol, batched_inv
    from acados_tpu_torch.ops.linsolve import linsolve

    # ---- 3. K1 against its plain version --------------------------------------
    at(3)
    log("K1 gj_inverse: kernel vs plain version on the card")
    k1_routes()
    solver, J = stage_jacobians(dev)
    kern = batched_inv._gj_inverse_cuda
    # handed over transposed (strides (256, 1, 16)), read in place
    rel32, abs32, res32 = check_transposed(
        f"stage Jacobians {tuple(J.shape)}", J, kern, F32_BOUND, quiet=False)
    check_transposed(f"stage Jacobians {tuple(J.shape)}", J.double(), kern,
                     F64_BOUND, quiet=False)
    rng = np.random.default_rng(SEED)
    k1_batches(dev, rng, kern)
    k1_edge_cases(dev, rng, kern)
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        n = 56
        A = torch.as_tensor(rng.normal(size=(1001, n, n)) + n * np.eye(n),
                            dtype=dtype, device=dev)
        check_inverse(f"random n={n} B=1001 (Schur)", A,
                      batched_inv._inv_impl, bound)
    # linsolve on the card inverts through the kernel at every n
    for n in (4, 16):
        A = torch.as_tensor(rng.normal(size=(1001, n, n)) + n * np.eye(n),
                            device=dev)
        b = torch.as_tensor(rng.normal(size=(1001, n)), device=dev)
        before = batched_inv.LAUNCHES
        x = linsolve(A, b)
        launched = batched_inv.LAUNCHES - before
        ref = (batched_inv.gj_inverse_plain(A) @ b[..., None])[..., 0]
        err = float((x - ref).abs().max() / ref.abs().max())
        log(f"  linsolve n={n} float64: {launched} K1 launch, "
            f"max|x-ref|/max|ref| {err:.3e}")
        if launched != 1 or not err <= F64_BOUND:
            raise SystemExit(f"linsolve on the card, n={n}: {launched} "
                             f"launches, error {err:.3e}")

    # time at the main-path shape, then over the group branch's grid
    kernels = [k1_entry("gj_inverse", J, None, rel32, abs32,
                        before=K1_PARENT_MAIN_DEVICE_MS)]
    k1_grid({"K1": kern}, cells=K1_GROUP_CELLS,
            parent={**K1_PARENT_GROUP_DEVICE_MS, **K1_PARENT_PAD_DEVICE_MS})
    k1_ms = kernels[0]["ms"]

    # ---- 4. main path ----------------------------------------------------------
    at(4)
    n_calls = 1 + WARM_CALLS + TIMED_CALLS
    reset_counts()
    call_ms, qp_max = run_calls(solver, "main path")
    counts = read_counts()
    launches = counts["gj_inverse"]
    kernels[0]["launches"] = launches
    log(f"main path: pendulum IRK SQP-RTI, B={B_MAIN}, N={N_HORIZON}, "
        f"float32, {n_calls} solve() calls, launches {counts}")
    if launches != LAUNCHES_PER_RTI * n_calls:
        raise SystemExit(f"expected {LAUNCHES_PER_RTI * n_calls} K1 "
                         f"launches, counted {launches}")
    med = float(np.median(call_ms))
    qp_iter = solver.get_stats("qp_iter")
    log(f"  per call: {call_stats(call_ms)}; "
        f"K1 {LAUNCHES_PER_RTI * k1_ms:.3f} ms per call "
        f"({LAUNCHES_PER_RTI * k1_ms / med * 100:.2f} %); qp_iter max "
        f"{int(qp_iter.max())} mean {float(qp_iter.mean()):.2f}")
    log(f"  time split: {json.dumps(time_split(solver, profiled=1))}")

    # ---- 5. reference check at a small input --------------------------------------
    at(5)
    main_path_vs_cpu()

    # ---- 6. full-condensing path ----------------------------------------------------
    at(6)
    fc, _ = rti_batch(dict(N=N_HORIZON, dtype="float32",
                           nlp_solver_type="SQP_RTI", integrator_type="IRK"),
                      B_MAIN, dev, qp_solver=FULL_COND)
    if not (fc.opts.full_cond and fc.opts.cond_N is None):
        raise SystemExit("the full-condensing options did not take")
    hb = []
    orig_chol = dense_ipm.chol_any

    def capture_hb(H):
        hb.append(H.detach().clone())
        return orig_chol(H)

    def release(c):
        dense_ipm.chol_any = orig_chol

    dense_ipm.chol_any = capture_hb   # the cold call's first round only
    reset_counts()
    try:
        fc_ms, fc_qp_max = run_calls(
            fc, "full-condensing path",
            on_call=lambda c: release(c) if c == 0 else None)
    finally:
        dense_ipm.chol_any = orig_chol
    counts = read_counts()
    nv = 4 + N_HORIZON
    log(f"full-condensing path: pendulum IRK SQP-RTI, {FULL_COND}, "
        f"B={B_MAIN}, float32, {n_calls} solve() calls, launches {counts}; "
        f"largest qp_iter per call {fc_qp_max} (sum {sum(fc_qp_max)})")
    if counts["gj_inverse"] != LAUNCHES_PER_RTI * n_calls:
        raise SystemExit(f"expected {LAUNCHES_PER_RTI * n_calls} K1 "
                         f"launches, counted {counts['gj_inverse']}")
    if counts["chol_factor"] != sum(fc_qp_max):
        raise SystemExit(f"expected {sum(fc_qp_max)} K2 launches (one per "
                         f"dense-IPM round), counted {counts['chol_factor']}")
    k2_launches = counts["chol_factor"]
    Hb = hb[0]
    if Hb.shape != (B_MAIN, nv, nv) or len(hb) != fc_qp_max[0]:
        raise SystemExit(f"captured {len(hb)} barrier Hessians of shape "
                         f"{tuple(Hb.shape)}")
    fc_qp = fc.get_stats("qp_iter")
    log(f"  per call: {call_stats(fc_ms)}; qp_iter max {int(fc_qp.max())} "
        f"mean {float(fc_qp.mean()):.2f}")
    log(f"  time split: {json.dumps(fc_time_split(fc))}")

    # ---- 7. K2, K3, K4 against their plain versions ---------------------------------
    at(7)
    log("K2/K3/K4 batched Cholesky: kernels vs plain versions on the card")
    b_hb = torch.as_tensor(rng.normal(size=(B_MAIN, nv)), device=dev)
    errs32 = check_chol(f"barrier Hessians {tuple(Hb.shape)}", Hb,
                        b_hb.float(), F32_BOUND)
    check_chol(f"barrier Hessians {tuple(Hb.shape)}", Hb.double(), b_hb,
               F64_BOUND)
    for dtype, bound in ((torch.float32, F32_BOUND),
                         (torch.float64, F64_BOUND)):
        for n in (1, 4, 13, 24, 39, 64):
            H = torch.as_tensor(spd_batch(rng, 1001, n), dtype=dtype,
                                device=dev)
            b = torch.as_tensor(rng.normal(size=(1001, n)), dtype=dtype,
                                device=dev)
            check_chol(f"SPD n={n} B=1001", H, b, bound)
        for n in (4, 24, 64):
            H, bad = indefinite_batch(rng, 1001, n)
            check_chol(f"indefinite/non-finite n={n} B=1001",
                       torch.as_tensor(H, dtype=dtype, device=dev),
                       torch.as_tensor(rng.normal(size=(1001, n)),
                                       dtype=dtype, device=dev),
                       bound, bad=torch.as_tensor(bad, device=dev))

    k2_bit_checks(dev, rng, batched_chol.chol_factor_batched, Hb)
    k3_k4_bit_checks(dev, rng, dict(
        chol_solve=batched_chol.chol_solve_batched,
        chol_factor_solve=batched_chol.chol_factor_solve_batched), Hb)

    # times at the dense IPM's shape (k2_compare.py times the grids)
    n, Bm = nv, B_MAIN
    bf = b_hb.float()
    L32 = batched_chol.chol_factor_plain(Hb)
    parents = dict(chol_factor=("K2", ":38", K2_PARENT_DEVICE_MS),
                   chol_solve=("K3", ":60", K3_PARENT_DEVICE_MS),
                   chol_factor_solve=("K4", ":79", K4_PARENT_DEVICE_MS))
    for kname, (_, line, parent) in parents.items():
        kfn = getattr(batched_chol, kname + "_batched")
        pfn = getattr(batched_chol, kname + "_plain")
        args = chol_args(kname, Hb, L32, bf)
        lname, lfn = chol_library(kname)
        k_ms = cuda_ms(lambda: kfn(*args), reps=30)
        k_dev_ms = device_ms(lambda: kfn(*args))
        p_ms = cuda_ms(lambda: pfn(*args), reps=10)
        l_ms = cuda_ms(lambda: lfn(Hb, L32, bf), reps=20)
        # cholesky_ex queues as the kernels do; cholesky_solve waits for
        # the host: the sum of its kernels' times instead
        like = kname == "chol_factor"
        l_dev_ms = (device_ms if like else kernel_busy_ms)(
            lambda: lfn(Hb, L32, bf))
        b_ms, b_by = chol_bound(kname, Bm, n, Hb.dtype)
        log(f"{kname} at ({Bm}, {n}, {n}) float32 "
            f"({k2_branch(kname, Bm, n)} branch): kernel {k_ms:.4f} ms "
            f"(device {k_dev_ms:.4f} ms back to back; the kernel the row "
            f"branch replaced {parent[(n, Bm, 'float32')]}), plain "
            f"{p_ms:.4f} ms, {lname} {l_ms:.4f} ms (device "
            f"{l_dev_ms:.4f} ms {'back to back' if like else 'its kernels'}"
            f"), bound {b_ms:.4f} ms ({b_by})")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "acados_tpu_torch/csrc/batched_chol.cu",
            "replaces": "acados_tpu/ops/batched_chol.py" + line,
            "shape": [Bm, n, n],
            "launches": k2_launches if kname == "chol_factor" else None,
            "max_abs_err": errs32[kname][1],
            "max_rel_err_f32": errs32[kname][0], "ms": k_ms,
            "device_ms": k_dev_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
            "library_device_ms": l_dev_ms})

    # ---- 8. the public ops entry points ----------------------------------------------
    at(8)
    from acados_tpu_torch.ops import (chol_factor_batched,
                                      chol_factor_solve_batched,
                                      chol_solve_batched)
    H64, b64 = Hb.double(), b_hb
    reset_counts()
    L = chol_factor_batched(H64)
    x3 = chol_solve_batched(L, b64)
    x4, L4 = chol_factor_solve_batched(H64, b64)
    counts = read_counts()
    ref, _ = batched_chol.chol_factor_solve_plain(H64, b64)
    gap = max(float((x - ref).abs().max() / ref.abs().max())
              for x in (x3, x4))
    lib = torch.cholesky_solve(b64[..., None],
                               torch.linalg.cholesky(H64))[..., 0]
    lib_gap = float((x4 - lib).abs().max() / lib.abs().max())
    log(f"ops entry points on the barrier Hessians, float64: launches "
        f"{counts}, max|x-plain|/max|plain| {gap:.3e} (bound "
        f"{F64_BOUND:g}), L of K2 and K4 equal: {bool(torch.equal(L, L4))}; "
        f"beside torch.cholesky_solve {lib_gap:.3e}")
    if counts != dict(gj_inverse=0, chol_factor=1, chol_solve=1,
                      chol_factor_solve=1, small_mm=0) \
            or not gap <= F64_BOUND \
            or not torch.equal(L, L4):
        raise SystemExit("ops entry points failed")
    for kd in kernels[2:]:
        kd["launches"] = counts[kd["name"]]

    # ---- 9. full-condensing reference check ------------------------------------------
    at(9)
    full_cond_vs_cpu()

    # ---- 10. Riccati IPM with a free initial state at nx = 16 -----------------------------
    at(10)
    riccati_free_x0(dev)

    # ---- 11. chain path at full width (the Kronecker IRK path) -----------------------------
    at(11)
    k1_chain, A_chain, chain_plain = chain_path(dev)
    kernels.append(k1_chain)

    # ---- 12. chain sweep -------------------------------------------------------------------
    at(12)
    chain_sweep(dev)

    # ---- 13. K5 against its plain version, its times -----------------------------------------
    at(13)
    kernels.append(small_mm_phase(dev, A_chain))

    # ---- 14. chain reference check -----------------------------------------------------------
    at(14)
    chain_vs_cpu()

    # ---- 15. quadrotor and race car ------------------------------------------------------------
    at(15)
    erk_models(dev)

    # ---- 16. RTI phases on the main path's config ---------------------------
    at(16)
    rti_phases(dev, med, solver._it_dev)

    # ---- 17. long-horizon pendulum: plain, cond_N16, parallel_riccati ------
    at(17)
    entry, it_long = long_horizon(dev)
    kernels.append(entry)

    # ---- 18. chain at cond_N = 8 (K2 on the condensed Huu) ------------------
    at(18)
    kernels.append(chain_cond(dev, chain_plain))

    # ---- 19. float64 card against CPU of the new paths ----------------------
    at(19)
    new_paths_vs_cpu()

    # ---- 20. the batch simulator at full width ------------------------------
    at(20)
    kernels.append(simulator(dev))

    # ---- 21. the batched sensitivities, main path and chain -----------------
    at(21)
    kernels.append(sensitivities(dev))

    # ---- 22. the differentiable solver --------------------------------------
    at(22)
    diff_solver(dev)

    # ---- 23. float64 card against CPU of phases 20-22 -----------------------
    at(23)
    sens_vs_cpu()

    # ---- 24. latency: the long-horizon variants at B = 8 --------------------
    at(24)
    latency(dev, it_long)

    # ---- 25. the ADMM QP backend beside the IPM -----------------------------
    at(25)
    admm_phase(dev)

    # ---- 26. float64 card against CPU of the QP-breadth paths ---------------
    at(26)
    qp_paths_vs_cpu()

    # ---- 27. the Newton SQP at full width -----------------------------------
    at(27)
    kernels.append(newton_sqp(dev))

    # ---- 29. DDP at full width ----------------------------------------------
    at(29)
    kernels.append(ddp_phase(dev))

    # ---- 30. SQP with feasible QPs, BGP rows -----------------------------------
    at(30)
    wfqp_phase(dev)

    # ---- 31. the INTEGRATOR cost on the main path ---------------------------
    at(31)
    kernels.append(integrator_phase(dev, solver._it_dev))

    # ---- 33. the DAE cart at full width (K1 on its 9 x 9 stage systems) -----
    at(33)
    kernels.append(dae_phase(dev))

    # ---- 34. GNSF, DISCRETE, p_global and LIFTED_IRK ------------------------
    at(34)
    integrator_breadth(dev, solver._it_dev)

    # ---- 36. multiphase OCPs: the control horizon, the IRK transition -------
    at(36)
    kernels.extend(multiphase_phase(dev))

    # ---- 38. the interface utilities at the main path's width ---------------
    at(38)
    kernels.extend(utilities_phase(dev, solver._it_dev))

    # ---- 40 starts: the examples, and 41b's processes up to their first
    # call, run beside the float64 checks of phases 28, 32, 35, 37, 39
    # and 41c, which time nothing ---------------------------------------
    at("40 (the examples and 41b's processes start)")
    torch.cuda.empty_cache()
    examples = start_examples()
    dist = []
    try:
        dist = start_dist(solver._it_dev, solver._data["lb_0"][:, :4])

        # ---- 28. float64 card against CPU of the new options ------------
        at(28)
        newton_vs_cpu()

        # ---- 32. float64 card against CPU of the NLP breadth ------------
        at(32)
        nlp_breadth_vs_cpu()

        # ---- 35. float64 card against CPU of the integrator breadth -----
        at(35)
        integrators_vs_cpu()

        # ---- 37. float64 card against CPU of the multiphase OCPs --------
        at(37)
        multiphase_vs_cpu()

        # ---- 39. float64 card against CPU of the utilities --------------
        at(39)
        utilities_vs_cpu()

        # ---- 41c. float64 card against CPU of the sharded paths ---------
        at("41c")
        sharding_vs_cpu()

        # ---- 40. the examples on the card --------------------------------
        at(40)
        examples_phase(examples)

        # ---- 41a-b. batch sharding over devices and processes ------------
        at("41a")
        entry, ref = sharding_phase(dev, solver._it_dev)
        kernels.append(entry)
        at("41b")
        dist_phase(dist, *ref)
    finally:
        stop_procs(list(examples[0].values()) + dist)

    log(f"-- all phases in {time.perf_counter() - t_run:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
