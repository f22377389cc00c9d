"""Condensing QP front-end: {none, partial, full} condensing, batch-first.

Counterpart of `acados_tpu/ocp_qp/xcond.py`: the one QP entry the NLP
layer calls, wrapping condense -> solve -> expand. No condensing and
partial condensing solve with an OCP-QP backend (the Riccati IPM unless
`backend=` names another, e.g. one of the registry's), full condensing
with the dense IPM.
"""
from __future__ import annotations

from acados_tpu_torch.dense_qp.ipm import solve_dense_qp
from acados_tpu_torch.ocp_qp.condensing import (_resolve_keep,
                                                condense_warm,
                                                hpipm_block_sizes,
                                                pad_qp_to_blocks,
                                                pad_warm_to_blocks,
                                                partial_condense,
                                                partial_expand, unpad_sol)
from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.full_condensing import (full_condense,
                                                     full_expand)
from acados_tpu_torch.ocp_qp.ipm import IpmOpts, solve_ocp_qp


def resolve_cond_N(N: int, cond_N) -> int | None:
    """The partial-condensing horizon for a requested cond_N: None (no
    condensing, HPIPM's N2 == N) when it is None or at least N, else
    clamped to at least 1. A cond_N that does not divide N takes HPIPM's
    remainder rule through inert padding (solve_ocp_qp_xcond)."""
    if cond_N is None or cond_N >= N:
        return None
    return max(int(cond_N), 1)


def cond_x0_rows(nc: int, nx: int, M: int, keep_rows=None):
    """Positions of the stage-0 x0 identity rows (original rows
    0..nx-1) in the condensed node-0 rows: partial_condense maps stage-0
    row r to r when r < npath and to M*npath + (r - npath) otherwise
    (the stage-0 extras). Usable as solve_ocp_qp's x0_rows."""
    n0, npth, _ = _resolve_keep(nc, keep_rows)
    assert n0 >= nx, (n0, nx)
    return tuple(r if r < npth else M * npth + (r - npth)
                 for r in range(nx))


def solve_ocp_qp_xcond(qp: OcpQp, opts: IpmOpts = None, cond_N: int = None,
                       full_cond: bool = False,
                       warm: OcpQpSol | None = None, backend=None,
                       keep_rows=None, cond_block_size=None,
                       x0_fixed: bool = False):
    """Solve a batch of OcpQps through the condensing front-end.

    full_cond: condense to dense QPs and solve them with the dense IPM
      (cold: the reference passes no warm start on this path).
    cond_N: the partial-condensing horizon; None or >= N solves the
      OCP-QP as it is. A cond_N that does not divide N, or explicit
      cond_block_size (per-block stage counts summing to N), pads ragged
      blocks to the widest with inert stages.
    keep_rows: static real-row counts (n0, npath[, nterm]) of the stage
      classes; rows beyond them are pruned before condensing.
    backend: the OCP-QP solver callable (qp, opts, warm=) for the
      (partially condensed) QPs, e.g. registry.get_qp_backend("ADMM");
      None is the Riccati IPM (the reference's xcond composes
      {condensing} x {any backend}).
    x0_fixed: eliminate the initial state through the condensing: the
      condensed block-0 entry state is x0, so its identity rows survive
      at known positions (cond_x0_rows) and the condensed QP is solved
      on the eliminated-x0 Riccati path. Requires the Riccati IPM.
    Returns (OcpQpSol in the original coordinates, IpmInfo).
    """
    if opts is None:
        opts = IpmOpts()
    if backend is None:
        backend = solve_ocp_qp
    if x0_fixed and backend is not solve_ocp_qp:
        raise ValueError("x0_fixed requires the Riccati IPM backend")

    def run(qp_c, warm_c, x0_rows=None):
        if x0_fixed:
            return backend(qp_c, opts, warm=warm_c, x0_fixed=True,
                           x0_rows=x0_rows)
        return backend(qp_c, opts, warm=warm_c)

    if full_cond:
        if x0_fixed:
            raise ValueError("x0_fixed is not supported with full "
                             "condensing (the dense path has its own "
                             "state elimination)")
        dense, cache = full_condense(qp)
        sol_d, info = solve_dense_qp(dense, opts)
        return full_expand(qp, cache, sol_d), info
    N, nx, nc = qp.dims.N, qp.dims.nx, qp.dims.nc
    if cond_block_size is not None:
        cond_N = len(cond_block_size)
        if len(set(cond_block_size)) == 1 \
                and cond_N * cond_block_size[0] == N:
            cond_block_size = None  # uniform: the plain path below
    if cond_N is None or cond_N >= N:
        return run(qp, warm)
    if cond_block_size is not None or N % cond_N != 0:
        # ragged blocks: pad to the widest with inert stages, condense
        # uniformly, restrict the solution back. keep_rows carries over:
        # padding nodes are path nodes whose rows are all masked off
        qp_p, maps = pad_qp_to_blocks(qp, cond_N, block_sizes=cond_block_size)
        warm_p = None if warm is None else pad_warm_to_blocks(warm, maps)
        qp_c, cache = partial_condense(qp_p, cond_N, keep_rows=keep_rows)
        warm_c = None if warm_p is None else condense_warm(
            warm_p, cond_N, keep_rows=keep_rows)
        rows_c = None
        if x0_fixed:
            bs = (list(cond_block_size) if cond_block_size is not None
                  else hpipm_block_sizes(N, cond_N))
            rows_c = cond_x0_rows(nc, nx, max(bs), keep_rows)
        sol_c, info = run(qp_c, warm_c, rows_c)
        sol_p = partial_expand(qp_p, cache, sol_c, keep_rows=keep_rows)
        return unpad_sol(sol_p, maps), info
    qp_c, cache = partial_condense(qp, cond_N, keep_rows=keep_rows)
    warm_c = None if warm is None else condense_warm(warm, cond_N,
                                                    keep_rows=keep_rows)
    rows_c = (cond_x0_rows(nc, nx, N // cond_N, keep_rows)
              if x0_fixed else None)
    sol_c, info = run(qp_c, warm_c, rows_c)
    return partial_expand(qp, cache, sol_c, keep_rows=keep_rows), info
