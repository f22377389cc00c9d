"""Block and partial condensing, batch-first.

Counterpart of `acados_tpu/ocp_qp/condensing.py`. Inside a block of M
stages with entry state x_bar and stacked controls u_bar, the states are
eliminated by forward substitution,

    x_{k0+i} = Gam_i x_bar + Phi_i u_bar + gam_i .

`_block_prop` and `_condense_block` condense one block (full condensing
uses them on the whole horizon). `partial_condense` re-blocks an N-stage
QP into N2 stages of M = N / N2 stages each: the N2 blocks of every
instance fold into the batch axis, (B, N2, M, ...) -> (B*N2, M, ...), so
one `_condense_block` call condenses them all and only the block's M
stages are a Python loop (the JAX package's `lax.scan`).
`partial_expand` recovers the full-horizon solution, the interior
dynamics multipliers by a reversed loop over the block's stages. Ragged
blocks (N2 not dividing N, or explicit block sizes) are padded to the
widest block with inert stages (`pad_qp_to_blocks`) and the padded
solution restricted back (`unpad_sol`).
"""
from __future__ import annotations

import numpy as np
import torch

from acados_tpu_torch.ocp_qp.data import OcpQp, OcpQpSol
from acados_tpu_torch.ocp_qp.riccati import _mTv, _mv
from acados_tpu_torch.utils.struct import tensor_dataclass


@tensor_dataclass
class PartialCondCache:
    """Per-block elimination operators needed to expand the solution:
    x_{jM+i} = Gams[:, j, i] x_bar_j + Phis[:, j, i] u_bar_j + gams[:, j, i].

    Gams (B, N2, M, nx, nx), Phis (B, N2, M, nx, M*nu), gams (B, N2, M, nx)
    """

    Gams: torch.Tensor
    Phis: torch.Tensor
    gams: torch.Tensor


def _block_prop(A, B, b):
    """Within-block state propagation operators.

    A (Bsz, M, nx, nx), B (Bsz, M, nx, nu), b (Bsz, M, nx) ->
      Gams (Bsz, M, nx, nx), Phis (Bsz, M, nx, M*nu), gams (Bsz, M, nx)
      for i = 0..M-1, plus the block-exit triple (Gam_M, Phi_M, gam_M),
      the condensed (A_bar, B_bar, b_bar).
    """
    Bsz, M, nx, nu = B.shape
    Gam = torch.eye(nx, dtype=A.dtype, device=A.device).expand(Bsz, nx, nx)
    Phi = torch.zeros((Bsz, nx, M * nu), dtype=A.dtype, device=A.device)
    gam = torch.zeros((Bsz, nx), dtype=A.dtype, device=A.device)
    Gams, Phis, gams = [], [], []
    for i in range(M):
        Gams.append(Gam)
        Phis.append(Phi)
        gams.append(gam)
        A_i = A[:, i]
        Gam = A_i @ Gam
        Phi = A_i @ Phi                  # a fresh tensor: set in place
        Phi[:, :, i * nu:(i + 1) * nu] = B[:, i]
        gam = _mv(A_i, gam) + b[:, i]
    return (torch.stack(Gams, 1), torch.stack(Phis, 1), torch.stack(gams, 1),
            Gam, Phi, gam)


def _blockdiag(X, M: int, rows: int, cols: int):
    """(Bsz, M, r, c) -> (Bsz, M, r, M, c) with X[:, i] at block (i, i)."""
    out = torch.zeros((X.shape[0], M, rows, M, cols), dtype=X.dtype,
                      device=X.device)
    for i in range(M):
        out[:, i, :, i, :] = X[:, i]
    return out


def _condense_block(A, B, b, Q, R, S, q, r, C, D, lg, ug):
    """Condense one block of M stages (every input holds the block's M
    stages, batch-first). Returns the condensed stage's (Q_bar, R_bar,
    S_bar, q_bar, r_bar, A_bar, B_bar, b_bar, C_bar, D_bar, lg_bar,
    ug_bar, (Gams, Phis, gams))."""
    Bsz, M, nx, nu = B.shape
    nc = C.shape[2]
    Gams, Phis, gams, A_bar, B_bar, b_bar = _block_prop(A, B, b)

    # cost: x_i = Gam_i xb + Phi_i ub + gam_i;  u_i = E_i ub
    Qg = torch.einsum("ziab,zib->zia", Q, gams) + q   # Q_i gam_i + q_i
    Q_bar = torch.einsum("ziax,ziab,ziby->zxy", Gams, Q, Gams)
    q_bar = torch.einsum("ziax,zia->zx", Gams, Qg)

    # R_bar = Phi'QPhi + blkdiag(R) + E'S Phi + (E'S Phi)'
    PQP = torch.einsum("ziau,ziab,zibv->zuv", Phis, Q, Phis)
    Rblk = _blockdiag(R, M, nu, nu).reshape(Bsz, M * nu, M * nu)
    SPhi = torch.einsum("ziux,zixv->ziuv", S, Phis).reshape(Bsz, M * nu,
                                                             M * nu)
    R_bar = PQP + Rblk + SPhi + SPhi.transpose(-1, -2)
    S_bar = (torch.einsum("ziau,ziab,zibx->zux", Phis, Q, Gams)
             + torch.einsum("ziux,zixy->ziuy", S, Gams).reshape(
                 Bsz, M * nu, nx))
    r_bar = (torch.einsum("ziau,zia->zu", Phis, Qg)
             + (torch.einsum("ziux,zix->ziu", S, gams) + r).reshape(
                 Bsz, M * nu))

    # rows: g_i = (C_i Gam_i) xb + (C_i Phi_i + D_i E_i) ub + C_i gam_i
    C_bar = torch.einsum("zica,ziax->zicx", C, Gams).reshape(Bsz, M * nc,
                                                             nx)
    CPhi = torch.einsum("zica,ziau->zicu", C, Phis)     # (Bsz, M, nc, M*nu)
    DE = _blockdiag(D, M, nc, nu).reshape(Bsz, M, nc, M * nu)
    D_bar = (CPhi + DE).reshape(Bsz, M * nc, M * nu)
    Cg = torch.einsum("zica,zia->zic", C, gams)
    lg_bar = (lg - Cg).reshape(Bsz, M * nc)
    ug_bar = (ug - Cg).reshape(Bsz, M * nc)

    return (Q_bar, R_bar, S_bar, q_bar, r_bar, A_bar, B_bar, b_bar,
            C_bar, D_bar, lg_bar, ug_bar, (Gams, Phis, gams))


def _resolve_keep(nc, keep_rows):
    """Static per-stage-class row-keep counts (n0, npath, nterm)."""
    if keep_rows is None:
        return nc, nc, nc
    if len(keep_rows) == 2:
        n0, npth = keep_rows
        ne = nc
    else:
        n0, npth, ne = keep_rows
    return min(int(n0), nc), min(int(npth), nc), min(int(ne), nc)


def _row_layout(nc, M, keep_rows):
    """(n0, npath, nterm, n_extra, nrb, ncb): the kept row counts, the
    stage-0 rows beyond the path's, the condensed path rows M*npath and
    the condensed row count."""
    n0, npth, ne = _resolve_keep(nc, keep_rows)
    n_extra = max(0, n0 - npth)
    nrb = M * npth
    return n0, npth, ne, n_extra, nrb, max(nrb + n_extra, ne)


def _blocks(a, N2: int):
    """(B, N, ...) -> (B, N2, M, ...): the stages of each block."""
    return a.reshape((a.shape[0], N2, a.shape[1] // N2) + tuple(a.shape[2:]))


def _cond_rows(v, N2: int, nrb: int, ncb: int, npth: int, ne: int,
               n0: int, fill: float):
    """Original row vector (B, N+1, nc) -> condensed layout
    (B, N2+1, ncb): each block's path rows, the stage-0 extras after
    them, the terminal rows, `fill` in the rows nothing maps to."""
    Bsz, N = v.shape[0], v.shape[1] - 1
    out = torch.full((Bsz, N2 + 1, ncb), fill, dtype=v.dtype,
                     device=v.device)
    out[:, :N2, :nrb] = v[:, :N, :npth].reshape(Bsz, N2, nrb)
    if n0 > npth:
        out[:, 0, nrb:nrb + n0 - npth] = v[:, 0, npth:n0]
    out[:, N2, :ne] = v[:, N, :ne]
    return out


def partial_condense(qp: OcpQp, N2: int, keep_rows=None):
    """Condense a batch of N-stage OcpQps to N2 stages (N2 must divide N).

    keep_rows: optional static (n0, npath[, nterm]), the number of real
    rows of the initial / path (/ terminal) stage classes
    (form.con_0.nrows, ...). Rows beyond them are padding (masked off)
    and are pruned before condensing, so a condensed stage carries
    M*npath rows (+ stage 0's extras) instead of M*nc. Stage 0's rows
    beyond npath (e.g. the x0 equality rows) attach to condensed stage 0
    uneliminated: its block-entry state is x0.

    Returns (qp_cond, PartialCondCache).
    """
    d = qp.dims
    N, nx, nu, nc = d.N, d.nx, d.nu, d.nc
    if N % N2 != 0:
        raise ValueError(f"partial condensing needs N2 | N, got N={N}, "
                         f"N2={N2}")
    M = N // N2
    Bsz = qp.q.shape[0]
    n0, npth, ne, n_extra, nrb, ncb = _row_layout(nc, M, keep_rows)

    # the N2 blocks of every instance fold into the batch axis
    fold = lambda a: a.reshape((Bsz * N2, M) + tuple(a.shape[2:]))
    (Q_b, R_b, S_b, q_b, r_b, A_b, B_b, b_b, C_b, D_b, lg_b, ug_b,
     (Gams, Phis, gams)) = _condense_block(
        fold(qp.A), fold(qp.B), fold(qp.b), fold(qp.Q[:, :N]), fold(qp.R),
        fold(qp.S), fold(qp.q[:, :N]), fold(qp.r), fold(qp.C[:, :N, :npth]),
        fold(qp.D[:, :, :npth]), fold(qp.lg[:, :N, :npth]),
        fold(qp.ug[:, :N, :npth]))
    unfold = lambda a: a.reshape((Bsz, N2) + tuple(a.shape[1:]))

    C = torch.zeros((Bsz, N2 + 1, ncb, nx), dtype=qp.q.dtype,
                    device=qp.q.device)
    C[:, :N2, :nrb] = unfold(C_b)
    C[:, N2, :ne] = qp.C[:, N, :ne]
    D = torch.zeros((Bsz, N2, ncb, M * nu), dtype=qp.q.dtype,
                    device=qp.q.device)
    D[:, :, :nrb] = unfold(D_b)
    if n_extra:
        # stage-0 rows npth:n0, attached directly (Gam_0 = I, Phi_0 = 0)
        ex = slice(nrb, nrb + n_extra)
        C[:, 0, ex] = qp.C[:, 0, npth:n0]
        D[:, 0, ex, :nu] = qp.D[:, 0, npth:n0]
    rows = lambda v, fill=0.0: _cond_rows(v, N2, nrb, ncb, npth, ne, n0,
                                          fill)
    # the bounds' layout, then the block rows' condensed bounds
    lg, ug = rows(qp.lg, -1.0), rows(qp.ug, 1.0)
    lg[:, :N2, :nrb] = unfold(lg_b)
    ug[:, :N2, :nrb] = unfold(ug_b)

    qp_cond = OcpQp(
        Q=torch.cat([unfold(Q_b), qp.Q[:, N:]], dim=1),
        R=unfold(R_b), S=unfold(S_b),
        q=torch.cat([unfold(q_b), qp.q[:, N:]], dim=1),
        r=unfold(r_b), A=unfold(A_b), B=unfold(B_b), b=unfold(b_b),
        C=C, D=D, lg=lg, ug=ug, mask_l=rows(qp.mask_l),
        mask_u=rows(qp.mask_u), Zl=rows(qp.Zl), Zu=rows(qp.Zu),
        zl=rows(qp.zl), zu=rows(qp.zu), soft_mask=rows(qp.soft_mask))
    return qp_cond, PartialCondCache(Gams=unfold(Gams), Phis=unfold(Phis),
                                     gams=unfold(gams))


def partial_expand(qp: OcpQp, cache: PartialCondCache, sol_c: OcpQpSol,
                   keep_rows=None) -> OcpQpSol:
    """Expand a batch of condensed solutions back to the full horizon.

    keep_rows must match the partial_condense call. The interior dynamics
    multipliers follow from stationarity at the eliminated states,
      pi_{k-1} = Q_k x_k + q_k + S_k'u_k - C_k'lam_k + A_k'pi_k ,
    run backwards through each block from its boundary multiplier.
    """
    d = qp.dims
    N, nx, nu, nc = d.N, d.nx, d.nu, d.nc
    Bsz = qp.q.shape[0]
    N2, M = cache.Gams.shape[1], cache.Gams.shape[2]
    n0, npth, ne, n_extra, nrb, _ = _row_layout(nc, M, keep_rows)

    xb, ub = sol_c.x, sol_c.u          # (B, N2+1, nx), (B, N2, M*nu)
    u = ub.reshape(Bsz, N, nu)
    # interior states: x_{jM+i} = Gam_i xb_j + Phi_i ub_j + gam_i
    x_blocks = (torch.einsum("zjiab,zjb->zjia", cache.Gams, xb[:, :N2])
                + torch.einsum("zjiau,zju->zjia", cache.Phis, ub)
                + cache.gams)
    x = torch.cat([x_blocks.reshape(Bsz, N, nx), xb[:, N2:]], dim=1)

    def unblk(v_c, fill=0.0):
        """Condensed rows (B, N2+1, ncb) -> original rows (B, N+1, nc);
        pruned padding rows take their disabled-row default `fill`."""
        out = torch.full((Bsz, N + 1, nc), fill, dtype=v_c.dtype,
                         device=v_c.device)
        out[:, :N, :npth] = v_c[:, :N2, :nrb].reshape(Bsz, N, npth)
        if n_extra:
            out[:, 0, npth:n0] = v_c[:, 0, nrb:nrb + n_extra]
        out[:, N, :ne] = v_c[:, N2, :ne]
        return out

    lam_l, lam_u = unblk(sol_c.lam_lg), unblk(sol_c.lam_ug)
    t_l, t_u = unblk(sol_c.t_lg, fill=1.0), unblk(sol_c.t_ug, fill=1.0)
    sl, su = unblk(sol_c.sl), unblk(sol_c.su)

    # pi: the block-boundary multipliers are the condensed ones, the
    # interior ones run backwards over each block's stages i = M-1..1
    lam_d = _blocks((qp.mask_l * lam_l - qp.mask_u * lam_u)[:, :N], N2)
    Qb, qb = _blocks(qp.Q[:, :N], N2), _blocks(qp.q[:, :N], N2)
    Sb, Ab, Cb = _blocks(qp.S, N2), _blocks(qp.A, N2), _blocks(
        qp.C[:, :N], N2)
    ub_s, xb_s = _blocks(u, N2), _blocks(x[:, :N], N2)
    pis = [None] * M
    pi_next = pis[M - 1] = sol_c.pi    # (B, N2, nx)
    for i in range(M - 1, 0, -1):
        pi_next = (_mv(Qb[:, :, i], xb_s[:, :, i]) + qb[:, :, i]
                   + _mTv(Sb[:, :, i], ub_s[:, :, i])
                   - _mTv(Cb[:, :, i], lam_d[:, :, i])
                   + _mTv(Ab[:, :, i], pi_next))
        pis[i - 1] = pi_next
    pi = torch.stack(pis, dim=2).reshape(Bsz, N, nx)

    return OcpQpSol(x=x, u=u, pi=pi, lam_lg=lam_l, lam_ug=lam_u,
                    t_lg=t_l, t_ug=t_u, sl=sl, su=su)


def condense_warm(warm: OcpQpSol, N2: int, keep_rows=None) -> OcpQpSol:
    """Map a batch of full-horizon warm starts onto the condensed
    variables (row layout as partial_condense's keep_rows)."""
    Bsz, N = warm.u.shape[0], warm.u.shape[1]
    M = N // N2
    n0, npth, ne, _, nrb, ncb = _row_layout(warm.lam_lg.shape[-1], M,
                                            keep_rows)
    rows = lambda v, fill: _cond_rows(v, N2, nrb, ncb, npth, ne, n0, fill)
    return OcpQpSol(
        x=torch.cat([warm.x[:, :N:M], warm.x[:, N:]], dim=1),
        u=warm.u.reshape(Bsz, N2, M * warm.u.shape[-1]),
        pi=warm.pi[:, M - 1::M],
        lam_lg=rows(warm.lam_lg, 0.0), lam_ug=rows(warm.lam_ug, 0.0),
        t_lg=rows(warm.t_lg, 1.0), t_ug=rows(warm.t_ug, 1.0),
        sl=rows(warm.sl, 0.0), su=rows(warm.su, 0.0))


# ---------------------------------------------------------------------------
# Ragged block sizes (HPIPM's remainder rule) through inert padding
# ---------------------------------------------------------------------------

def hpipm_block_sizes(N: int, N2: int):
    """HPIPM's block-size rule (d_part_cond_qp_compute_block_size): the
    remainder goes to the first blocks, [M+1]*R + [M]*(N2-R) with
    M, R = divmod(N, N2)."""
    M, R = divmod(N, N2)
    return [M + 1] * R + [M] * (N2 - R)


def _pad_maps(N: int, N2: int, sizes=None):
    """Static index maps for padding ragged blocks to the uniform width
    Mmax: (Mmax, link_src (N2*Mmax,), link_real mask, node_src
    (N2*Mmax+1,), node_real mask, o2p_node (N+1,), o2p_link (N,)).
    sizes: explicit per-block sizes (qp_solver_cond_block_size); default
    HPIPM's remainder rule."""
    bs = list(sizes) if sizes is not None else hpipm_block_sizes(N, N2)
    assert len(bs) == N2 and sum(bs) == N, (bs, N, N2)
    Mmax = max(bs)
    offs = np.concatenate([[0], np.cumsum(bs)])
    link_src, link_real, node_src, node_real = [], [], [], []
    o2p_node = np.zeros(N + 1, np.int64)
    o2p_link = np.zeros(N, np.int64)
    for j in range(N2):
        for i in range(Mmax):
            t = j * Mmax + i
            if i < bs[j]:
                link_src.append(offs[j] + i)
                link_real.append(True)
                node_src.append(offs[j] + i)
                node_real.append(True)
                o2p_node[offs[j] + i] = t
                o2p_link[offs[j] + i] = t
            else:
                link_src.append(0)
                link_real.append(False)
                # padding nodes sit behind the block's real links on
                # identity dynamics: the carried state is the block's
                # last real node, so lifted warm starts stay dynamically
                # consistent at padding links
                node_src.append(offs[j] + bs[j])
                node_real.append(False)
    node_src.append(N)
    node_real.append(True)
    o2p_node[N] = N2 * Mmax
    return (Mmax, np.asarray(link_src), np.asarray(link_real),
            np.asarray(node_src), np.asarray(node_real), o2p_node,
            o2p_link)


def _stage_mask(real, dims: int, device):
    """(K,) bool -> (1, K, 1...) with `dims` trailing singleton axes."""
    return torch.as_tensor(real, device=device).reshape(
        (1, -1) + (1,) * dims)


def pad_qp_to_blocks(qp: OcpQp, N2: int, block_sizes=None):
    """Pad a batch of N-stage QPs with inert stages so every condensing
    block has the width Mmax of HPIPM's (or the given) block sizes:
    padding links have identity dynamics (A = I, B = 0, b = 0) and a unit
    control Hessian (the padded controls decouple and solve to zero),
    padding nodes zero cost and masked-off rows. The padded QP's solution
    restricted to the real indices is the original QP's.

    Returns (qp_padded, maps) with maps for unpad_sol."""
    nx, nu = qp.dims.nx, qp.dims.nu
    dt, dev = qp.q.dtype, qp.q.device
    maps = _pad_maps(qp.dims.N, N2, sizes=block_sizes)
    _, l_src, l_real, n_src, n_real, _, _ = maps
    lr, lrv = _stage_mask(l_real, 2, dev), _stage_mask(l_real, 1, dev)
    nr, nrv = _stage_mask(n_real, 2, dev), _stage_mask(n_real, 1, dev)
    ls = torch.as_tensor(l_src, device=dev)
    ns = torch.as_tensor(n_src, device=dev)
    eye = torch.eye(nx, dtype=dt, device=dev)
    eyeu = torch.eye(nu, dtype=dt, device=dev)
    gl = lambda a: a[:, ls]
    gn = lambda a: a[:, ns]
    qp_p = OcpQp(
        Q=torch.where(nr, gn(qp.Q), 0.0),
        R=torch.where(lr, gl(qp.R), eyeu),
        S=torch.where(lr, gl(qp.S), 0.0),
        q=torch.where(nrv, gn(qp.q), 0.0),
        r=torch.where(lrv, gl(qp.r), 0.0),
        A=torch.where(lr, gl(qp.A), eye),
        B=torch.where(lr, gl(qp.B), 0.0),
        b=torch.where(lrv, gl(qp.b), 0.0),
        C=torch.where(nr, gn(qp.C), 0.0),
        D=torch.where(lr, gl(qp.D), 0.0),
        lg=torch.where(nrv, gn(qp.lg), -1.0),
        ug=torch.where(nrv, gn(qp.ug), 1.0),
        mask_l=torch.where(nrv, gn(qp.mask_l), 0.0),
        mask_u=torch.where(nrv, gn(qp.mask_u), 0.0),
        Zl=torch.where(nrv, gn(qp.Zl), 0.0),
        Zu=torch.where(nrv, gn(qp.Zu), 0.0),
        zl=torch.where(nrv, gn(qp.zl), 0.0),
        zu=torch.where(nrv, gn(qp.zu), 0.0),
        soft_mask=torch.where(nrv, gn(qp.soft_mask), 0.0))
    return qp_p, maps


def unpad_sol(sol_p: OcpQpSol, maps) -> OcpQpSol:
    """Restrict a batch of padded-horizon solutions to the original
    stages."""
    _, _, _, _, _, o2p_node, o2p_link = maps
    dev = sol_p.x.device
    pn = torch.as_tensor(o2p_node, device=dev)
    pl = torch.as_tensor(o2p_link, device=dev)
    g_n = lambda a: a[:, pn]
    g_l = lambda a: a[:, pl]
    return OcpQpSol(x=g_n(sol_p.x), u=g_l(sol_p.u), pi=g_l(sol_p.pi),
                    lam_lg=g_n(sol_p.lam_lg), lam_ug=g_n(sol_p.lam_ug),
                    t_lg=g_n(sol_p.t_lg), t_ug=g_n(sol_p.t_ug),
                    sl=g_n(sol_p.sl), su=g_n(sol_p.su))


def pad_warm_to_blocks(warm: OcpQpSol, maps) -> OcpQpSol:
    """Lift a batch of warm starts onto the padded horizon (padding
    controls, multipliers and slacks zero, slack distances one)."""
    _, l_src, l_real, n_src, n_real, _, _ = maps
    dev = warm.x.device
    ls = torch.as_tensor(l_src, device=dev)
    ns = torch.as_tensor(n_src, device=dev)
    lrv, nrv = _stage_mask(l_real, 1, dev), _stage_mask(n_real, 1, dev)
    return OcpQpSol(
        x=warm.x[:, ns], u=torch.where(lrv, warm.u[:, ls], 0.0),
        pi=torch.where(lrv, warm.pi[:, ls], 0.0),
        lam_lg=torch.where(nrv, warm.lam_lg[:, ns], 0.0),
        lam_ug=torch.where(nrv, warm.lam_ug[:, ns], 0.0),
        t_lg=torch.where(nrv, warm.t_lg[:, ns], 1.0),
        t_ug=torch.where(nrv, warm.t_ug[:, ns], 1.0),
        sl=torch.where(nrv, warm.sl[:, ns], 0.0),
        su=torch.where(nrv, warm.su[:, ns], 0.0))
