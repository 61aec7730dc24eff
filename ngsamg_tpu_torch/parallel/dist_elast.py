"""Distributed (shard-local) AMG setup for block (elasticity) energies.

Copied from ngsamg_tpu/parallel/dist_elast.py (numpy/scipy only; the
pencil eigenvalues run ``apps/elasticity._pencil_extreme_eig``'s numpy
branch). Extends the scalar/vector-H1 distributed setup
(parallel/dist_setup.py) to energies with non-identity rigid-body
transports — the counterpart of the reference's distributed elasticity
stack: EQC-consistent
robust coarsening (src/elasticity/elasticity.hpp:58-98 with
spw_agg_impl.hpp:1512-1541 solid/ghost matching), transported nodal-data
cumulation (`AttachedEVD/AttachedEED` + ReduceTable, elasticity_mesh.hpp),
and the distributed Galerkin product (utils_sparseMM.cpp).

Ownership model: contiguous global VERTEX ranges per shard (matrix rows =
vertex range x block size). Every step computes only on a shard's owned
rows plus halos through the two dist_setup exchange primitives
(`_gather` / `_reduce_by_owner` — indexed all-gather / reduce-scatter).

State carried per level, all row-sharded (the AttachedNodeData analog):

* adjacency rows ``G`` (scalar edge weights, owned rows x global cols),
* per-entry edge matrices ``E`` (dpv x dpv, expressed at the edge-midpoint
  frame — orientation-free, so the two owners of an edge hold the SAME
  matrix),
* per-vertex position and L2 weight.

Serial equality: every per-edge quantity is computed in a CANONICAL
(lo, hi) orientation with commutative-only reorderings, so the owner of
row (i, j) and the owner of row (j, i) produce bitwise-identical values,
and those equal the serial path's per-edge values (apps/elasticity.py
symmetrizes its tangential extraction for exactly this reason). Matching
is the same synchronous-rounds handshake as dist_setup, so aggregates are
identical to the serial `spw_aggregate_energy`; coarse operators agree to
fp roundoff (summation orders differ in the RAP). Asserted by
tests/test_torch_dist_setup.py.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..apps.elasticity import _frob2T, _pencil_extreme_eig
from ..config import AMGOptions, ProlType
from ..factory.levels import FactoryLog, SetupLevel
from ..mesh.topo import AlgebraicMesh
from ..transfer.prolongation import truncate_prol
from .dist_setup import (
    _dist_symmetrize,
    _dist_adopt_orphans,
    _dist_aggregates,
    _dist_handshake,
    _dist_rap,
    _gather,
    _gather_csr_rows,
    _owner,
    _reduce_by_owner,
)


class _Rows:
    """One shard's mesh rows: adjacency + attached edge/vertex data."""

    __slots__ = ("G", "E", "pos", "l2")

    def __init__(self, G, E, pos, l2):
        self.G = G  # csr (n_own, nv_glob), data = scalar edge weight
        self.E = E  # (G.nnz, dpv, dpv) edge matrices (midpoint frame)
        self.pos = pos  # (n_own, dim)
        self.l2 = l2  # (n_own,)


def _row_locals(G: sp.csr_matrix):
    return np.repeat(np.arange(G.shape[0], dtype=np.int64), np.diff(G.indptr))


def _serial_order(G: sp.csr_matrix, own0: int):
    """Entry permutation matching the serial two-pass accumulation order.

    The serial path accumulates per-vertex sums in two `np.add.at` passes:
    first all edges where the vertex is the LO endpoint (neighbors > v,
    ascending), then edges where it is HI (neighbors < v, ascending). CSR
    rows are ascending-by-column, so per row: take the (col > own) tail
    first, then the (col < own) head.
    """
    rows_l = _row_locals(G)
    cols = G.indices.astype(np.int64)
    hi_first = cols > (rows_l + own0)
    idx = np.arange(G.nnz)
    return np.concatenate([idx[hi_first], idx[~hi_first]]), rows_l


# ---------------------------------------------------------------------------
# finest-level rows (apps/elasticity.build_finest_mesh, shard-local)
# ---------------------------------------------------------------------------


def _rows_finest(A_parts, pos_parts, energy, vst):
    """Per-shard finest rows from per-shard matrix-row slices (``None`` in
    slots owned by another controller); also sets energy._s (rot_scale
    auto, identical on every rank via allgathered edge lengths)."""
    from .transport import get_transport

    tr = get_transport()
    dim, dpv = energy.dim, energy.dpv
    n_shards = len(vst) - 1
    mine = list(tr.my_shards(n_shards))
    ncols_scal = int(vst[-1]) * dim
    rows_list = [None] * n_shards
    all_lens = []
    for s in mine:
        own0 = int(vst[s])
        nloc = int(vst[s + 1] - vst[s])
        B = sp.bsr_matrix(A_parts[s], blocksize=(dim, dim))
        norms = np.sqrt(_frob2T(B.data.astype(np.float64)))
        rows_l = _row_locals_b(B)
        cols = B.indices.astype(np.int64)
        offd = (cols != (rows_l + own0)) & (norms > 0)
        # diagonal-block norms (for the vertex weight)
        diag_m = cols == (rows_l + own0)
        diag = np.zeros(nloc)
        diag[rows_l[diag_m]] = norms[diag_m]
        # canonical tangential stiffness per off-diagonal entry
        r_l = rows_l[offd]
        c_g = cols[offd]
        blocks = B.data[offd].astype(np.float64)
        pos_own = pos_parts[s][r_l]
        pos_oth = _gather(pos_parts, vst, c_g)
        own_is_lo = (r_l + own0) < c_g
        # canonical direction lo -> hi
        t = np.where(own_is_lo[:, None], pos_oth - pos_own, pos_own - pos_oth)
        lens = np.linalg.norm(t, axis=1)
        all_lens.append(lens)
        t = t / np.maximum(lens[:, None], 1e-300)
        # the serial path holds the UPPER (lo, hi) block; the hi-owner's
        # row block is its transpose — symmetrizing makes both bitwise equal
        blocks_sym = 0.5 * (blocks + np.transpose(blocks, (0, 2, 1)))
        fac = np.abs(np.einsum("ei,eij,ej->e", t, -blocks_sym, t))
        E = np.zeros((len(r_l), dpv, dpv))
        E[:, :dim, :dim] = fac[:, None, None] * np.einsum("ei,ej->eij", t, t)
        wt = norms[offd]
        G = sp.csr_matrix(
            (wt, c_g, _recount_keep(B.indptr, offd)),
            shape=(nloc, ncols_scal // dim),
        )
        # vertex L2 weight: diag norm minus incident couplings, serial order
        vwt = diag.copy()
        order, _rl = _serial_order(G, own0)
        np.subtract.at(vwt, _row_locals(G)[order], G.data[order])
        rows_list[s] = _Rows(G, E, pos_parts[s], np.maximum(vwt, 0.0))
    if energy.rot_scale == "auto":
        own_lens = (
            np.concatenate(all_lens) if all_lens else np.zeros(0)
        )
        # every edge appears exactly twice (once per endpoint owner): the
        # median of the duplicated multiset equals the serial median; the
        # allgather replicates it so every rank scales identically
        lens_all = tr.allgather(own_lens)
        if len(lens_all):
            energy._s = 1.0 / max(float(np.median(lens_all)), 1e-300)
    return rows_list


def _row_locals_b(B: sp.bsr_matrix):
    nb = B.shape[0] // B.blocksize[0]
    return np.repeat(np.arange(nb, dtype=np.int64), np.diff(B.indptr))


def _recount_keep(indptr, keep):
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(len(deg)), deg)
    newdeg = np.bincount(rows, weights=keep.astype(np.int64), minlength=len(deg))
    out = np.zeros(len(indptr), dtype=np.int64)
    out[1:] = np.cumsum(newdeg.astype(np.int64))
    return out


# ---------------------------------------------------------------------------
# energy kernels on rows (aux diagonal, replacement blocks, robust SOC)
# ---------------------------------------------------------------------------


def _rows_aux_diag(rows_list, vst, energy):
    """Per-shard (n_own, dpv, dpv) aux diagonals, serial accumulation order.

    Serial `aux_diagonal`: D_v = sum of Q(v->mid)^T E Q(v->mid) over
    incident edges (lo-pass then hi-pass) + l2 * I_disp.
    """
    from .transport import get_transport

    dpv, dim = energy.dpv, energy.dim
    pos_parts = _all_pos(rows_list)
    out = [None] * len(rows_list)
    for s in get_transport().my_shards(len(rows_list)):
        rows = rows_list[s]
        own0 = int(vst[s])
        nloc = rows.G.shape[0]
        order, rows_l = _serial_order(rows.G, own0)
        cols = rows.G.indices.astype(np.int64)
        pos_own = rows.pos[rows_l]
        pos_oth = _gather(pos_parts, vst, cols)
        mid = 0.5 * (pos_own + pos_oth)
        Qvm = energy.transport(pos_own, mid)
        E = rows.E
        EQ = E @ Qvm
        Bvv = np.swapaxes(Qvm, -1, -2) @ EQ
        D = np.zeros((nloc, dpv, dpv))
        np.add.at(D, rows_l[order], Bvv[order])
        idx = np.arange(dim)
        D[:, idx, idx] += rows.l2[:, None]
        out[s] = D
    return out


def _rows_soc(rows_list, vst, energy, robust, D_parts=None,
              scal_rel=0.0):
    """Per-shard strength rows (same sparsity as G).

    robust: the serial `soc_robust` pencil per entry, computed in the
    canonical (lo, hi) orientation so both owners agree bitwise.
    scalar: wt * (1/d_i + 1/d_j)/2, d = l2 + incident wt (serial `soc`).
    ``scal_rel`` > 0 mirrors the serial `_robust_soc_prefiltered`
    shortlist (reference phase-(a) scalar filter, spw_agg_impl.hpp:691):
    entries below ``scal_rel`` x max(row-max of either endpoint) in the
    SCALAR weight score 0 and skip the pencil EVP. The scalar weights,
    row maxima, and the compare are bitwise shard-order independent, so
    the shortlist (and hence the aggregates) equal the serial path's.
    """
    from .transport import get_transport

    pos_parts = _all_pos(rows_list)
    n_shards = len(rows_list)
    mine = list(get_transport().my_shards(n_shards))
    if not robust:
        d_parts = [None] * n_shards
        for s in mine:
            rows = rows_list[s]
            own0 = int(vst[s])
            d = rows.l2.copy()
            order, rows_l = _serial_order(rows.G, own0)
            np.add.at(d, rows_l[order], rows.G.data[order])
            d_parts[s] = np.maximum(d, 1e-300)
        out = [None] * n_shards
        for s in mine:
            rows = rows_list[s]
            rows_l = _row_locals(rows.G)
            dj = _gather(d_parts, vst, rows.G.indices.astype(np.int64))
            soc = rows.G.data * 0.5 * (1.0 / d_parts[s][rows_l] + 1.0 / dj)
            out[s] = sp.csr_matrix(
                (soc, rows.G.indices, rows.G.indptr), shape=rows.G.shape
            )
        return out
    if D_parts is None:
        D_parts = _rows_aux_diag(rows_list, vst, energy)
    keep_parts = [None] * n_shards
    if scal_rel > 0:
        scal_parts = _rows_soc(rows_list, vst, energy, False)
        rowmax_parts = [None] * n_shards
        for s in mine:
            Ssc = scal_parts[s]
            from ..sparse.host import csr_rowwise_max

            rowmax_parts[s] = csr_rowwise_max(Ssc.indptr, Ssc.data)
        for s in mine:
            Ssc = scal_parts[s]
            rows_l = _row_locals(Ssc)
            w = Ssc.data
            rm_own = rowmax_parts[s][rows_l]
            rm_col = _gather(
                rowmax_parts, vst, Ssc.indices.astype(np.int64)
            )
            k = (w >= scal_rel * rm_own) | (w >= scal_rel * rm_col)
            keep_parts[s] = None if k.all() else k
    out = [None] * n_shards
    for s in mine:
        rows = rows_list[s]
        own0 = int(vst[s])
        rows_l = _row_locals(rows.G)
        cols = rows.G.indices.astype(np.int64)
        own_g = rows_l + own0
        lo = np.minimum(own_g, cols)
        hi = np.maximum(own_g, cols)
        keep = keep_parts[s]
        E_use = rows.E
        if keep is not None:
            lo, hi = lo[keep], hi[keep]
            E_use = E_use[keep]
        pos_lo = _gather(pos_parts, vst, lo)
        pos_hi = _gather(pos_parts, vst, hi)
        D_lo = _gather(D_parts, vst, lo)
        D_hi = _gather(D_parts, vst, hi)
        mid = 0.5 * (pos_lo + pos_hi)
        # serial soc_robust with i = lo, j = hi
        Qmi = energy.transport(mid, pos_lo)
        Qmj = energy.transport(mid, pos_hi)
        di = np.swapaxes(Qmi, -1, -2) @ (D_lo @ Qmi)
        dj = np.swapaxes(Qmj, -1, -2) @ (D_hi @ Qmj)
        dsum_inv = np.linalg.pinv(di + dj, rcond=1e-12, hermitian=True)
        C = di @ dsum_inv @ dj
        C = 0.5 * (C + np.transpose(C, (0, 2, 1)))
        soc_sub = _pencil_extreme_eig(E_use, C, reduction="max")
        if keep is None:
            soc = soc_sub
        else:
            soc = np.zeros(len(keep))
            soc[keep] = soc_sub
        out[s] = sp.csr_matrix(
            (soc, rows.G.indices, rows.G.indptr), shape=rows.G.shape
        )
    return out


# ---------------------------------------------------------------------------
# coarse-rows mapping (energy.map_data, shard-local + owner routing)
# ---------------------------------------------------------------------------


def _rows_map_data(rows_list, vst, v2agg_parts, c_vst, energy):
    """Coarse rows from fine rows under an aggregation (serial map_data).

    Coarse positions are member averages; coarse edge matrices are
    Q(mid_c -> mid_f)-transported sums over the mapped fine edges, routed
    to the coarse-row owners and accumulated in the serial fine-edge order.
    """
    from .transport import get_transport

    tr = get_transport()
    n_shards = len(rows_list)
    mine = list(tr.my_shards(n_shards))
    dpv = energy.dpv
    nv_c = int(c_vst[-1])
    nv_f = int(vst[-1])
    nloc_c = [int(c_vst[t + 1] - c_vst[t]) for t in range(n_shards)]
    dim = next(rows_list[s].pos.shape[1] for s in mine)

    # coarse pos (count average) + l2 sums: ascending-vertex reductions
    # (owned contributions only — the transport routes them to owners)
    own_v2 = np.concatenate([v2agg_parts[s] for s in mine])
    own_act = own_v2[own_v2 >= 0]
    cnt_parts = _reduce_by_owner(
        c_vst, own_act, np.ones(len(own_act)), nloc_c
    )
    cpos_parts = [None] * n_shards
    cols_k = [
        _reduce_by_owner(
            c_vst,
            own_act,
            np.concatenate(
                [
                    rows_list[s].pos[v2agg_parts[s] >= 0, k]
                    for s in mine
                ]
            ),
            nloc_c,
        )
        for k in range(dim)
    ]
    for t in mine:
        cpos_parts[t] = np.stack(
            [cols_k[k][t] for k in range(dim)], axis=1
        ) / np.maximum(cnt_parts[t], 1.0)[:, None]
    cl2_parts = _reduce_by_owner(
        c_vst,
        own_act,
        np.concatenate(
            [rows_list[s].l2[v2agg_parts[s] >= 0] for s in mine]
        ),
        nloc_c,
    )

    # transported cross-edge contributions, routed to coarse-row owners
    ri_l, cj_l, key_l, E_l, w_l = [], [], [], [], []
    pos_parts = _all_pos(rows_list)
    for s in mine:
        rows = rows_list[s]
        own0 = int(vst[s])
        rows_l = _row_locals(rows.G)
        cols = rows.G.indices.astype(np.int64)
        own_g = rows_l + own0
        ci = v2agg_parts[s][rows_l]
        cj = _gather(v2agg_parts, vst, cols)
        keep = (ci >= 0) & (cj >= 0) & (ci != cj)
        # no data-dependent skip: an empty shard still participates in
        # every collective below (SPMD call-count symmetry)
        own_g, cols = own_g[keep], cols[keep]
        ci, cj = ci[keep], cj[keep]
        lo_f = np.minimum(own_g, cols)
        hi_f = np.maximum(own_g, cols)
        pos_lo = _gather(pos_parts, vst, lo_f)
        pos_hi = _gather(pos_parts, vst, hi_f)
        mid_f = 0.5 * (pos_lo + pos_hi)
        lo_c = np.minimum(ci, cj)
        hi_c = np.maximum(ci, cj)
        cpos_lo = _gather(cpos_parts, c_vst, lo_c)
        cpos_hi = _gather(cpos_parts, c_vst, hi_c)
        mid_c = 0.5 * (cpos_lo + cpos_hi)
        Q = energy.transport(mid_c, mid_f)
        Ef = rows.E[keep]
        Et = np.swapaxes(Q, -1, -2) @ (Ef @ Q)
        ri_l.append(ci)
        cj_l.append(cj)
        key_l.append(lo_f * nv_f + hi_f)  # serial fine-edge order key
        E_l.append(Et)
        w_l.append(rows.G.data[keep])
    if ri_l:
        ri = np.concatenate(ri_l)
        cj = np.concatenate(cj_l)
        fkey = np.concatenate(key_l)
        Em = np.concatenate(E_l)
        wm = np.concatenate(w_l)
    else:
        ri = cj = fkey = np.zeros(0, dtype=np.int64)
        Em = np.zeros((0, dpv, dpv))
        wm = np.zeros(0)

    routed = tr.route_rows(c_vst, ri, (ri, cj, fkey, Em, wm))
    out = [None] * n_shards
    for t in mine:
        r, c, k, Eb, wb = routed[t]
        nl = nloc_c[t]
        if not len(r):
            G = sp.csr_matrix((nl, nv_c))
            out[t] = _Rows(
                G, np.zeros((0, dpv, dpv)), cpos_parts[t], cl2_parts[t]
            )
            continue
        r = r - c_vst[t]
        # accumulate per (row, col) in the serial fine-edge order
        order = np.lexsort((k, c, r))
        r, c, Eb, wb = r[order], c[order], Eb[order], wb[order]
        key = r * nv_c + c
        uniq, inv = np.unique(key, return_inverse=True)
        Es = np.zeros((len(uniq), dpv, dpv))
        np.add.at(Es, inv, Eb)
        ws = np.zeros(len(uniq))
        np.add.at(ws, inv, wb)
        ur = (uniq // nv_c).astype(np.int64)
        uc = (uniq % nv_c).astype(np.int32)
        indptr = np.zeros(nl + 1, dtype=np.int64)
        np.add.at(indptr, ur + 1, 1)
        indptr = np.cumsum(indptr)
        G = sp.csr_matrix((ws, uc, indptr), shape=(nl, nv_c))
        out[t] = _Rows(G, Es, cpos_parts[t], cl2_parts[t])
    return out


# ---------------------------------------------------------------------------
# matching loop (serial spw_aggregate_energy, shard-local)
# ---------------------------------------------------------------------------


def _dist_spw_energy(rows_list, vst, opts: AMGOptions, level: int, energy):
    """Multi-round SPW with per-round energy re-evaluation (robust)."""
    c = opts.coarsen
    theta = float(c.theta.get(level))
    aaf = c.aaf.get(level)
    rounds = 10 if aaf is not None else int(c.spw_rounds.get(level))
    r = c.robust.get(level)
    use_robust = (
        getattr(energy, "default_robust", False) if r is None else bool(r)
    )
    scal_rel = float(c.scal_rel_thresh.get(level)) if use_robust else 0.0
    from .transport import get_transport

    n_shards = len(rows_list)
    mine = list(get_transport().my_shards(n_shards))
    n0 = int(vst[-1])
    v2c_parts = [None] * n_shards
    for s in mine:
        v2c_parts[s] = np.arange(vst[s], vst[s + 1], dtype=np.int64)
    cur_rows, cur_vst = rows_list, vst
    n_cur = n0
    for _round in range(rounds):
        if aaf is not None and n_cur <= float(aaf) * n0:
            break
        S_parts = _rows_soc(
            cur_rows, cur_vst, energy, use_robust, scal_rel=scal_rel
        )
        partner_parts = _dist_handshake(S_parts, cur_vst, theta)
        c2agg_parts, c_starts = _dist_aggregates(partner_parts, cur_vst)
        n_agg = int(c_starts[-1])
        if n_agg >= n_cur or n_agg == 0:
            break
        for s in mine:
            v2 = v2c_parts[s]
            m = v2 >= 0
            v2[m] = _gather(c2agg_parts, cur_vst, v2[m])
        cur_rows = _rows_map_data(
            cur_rows, cur_vst, c2agg_parts, c_starts, energy
        )
        cur_vst = c_starts
        n_cur = n_agg
    if bool(c.adopt_orphans.get(level)) and n_cur:
        S_parts = _rows_soc(
            cur_rows, cur_vst, energy, use_robust, scal_rel=scal_rel
        )
        v2c_parts, cur_vst = _dist_adopt_orphans(
            S_parts, cur_vst, v2c_parts
        )
    return v2c_parts, cur_vst


# ---------------------------------------------------------------------------
# block prolongation (serial smoothed_prol, shard-local rows)
# ---------------------------------------------------------------------------


def _all_pos(rows_list):
    return [None if r is None else r.pos for r in rows_list]


def _dist_rho(yfun, n_scal: int, seed: int, iters=10):
    """Serial `_rho_estimate` with per-shard owned-row matvecs.

    The start vector uses the serial seed; every shard holds the full
    iterate (models a replicated small state + allgather of shard rows).
    """
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n_scal)
    lam = 1.0
    for _ in range(iters):
        x = yfun(x)
        nrm = np.linalg.norm(x)
        if nrm == 0:
            return 2.0
        lam = nrm
        x = x / nrm
    return float(lam)


def _halo_rows_csr(P_parts, scal_starts, need_rows, n_rows, n_cols):
    """Global-shaped CSR holding only the gathered halo rows."""
    sub = _gather_csr_rows(P_parts, scal_starts, need_rows, n_cols)
    sub = sub.tocoo()
    return sp.csr_matrix(
        (sub.data, (need_rows[sub.row], sub.col)), shape=(n_rows, n_cols)
    )


def _dist_prol_elast(
    rows_list,
    vst,
    v2agg_parts,
    c_vst,
    cpos_parts,
    opts: AMGOptions,
    level: int,
    energy,
    A_parts=None,
    row_bs=None,
):
    """Per-shard smoothed block prolongation (semi-aux classic choice).

    Mirrors transfer/prolongation.smoothed_prol row-for-row: piecewise
    Q-transport rows, one damped-Jacobi step with the aux (replacement)
    matrix rows, real-matrix rows where the coarse fan-out is bounded
    (level matrices with row_bs == dpv only), kernel-preserving truncation.
    """
    from .transport import get_transport

    tr = get_transport()
    dpv, dim = energy.dpv, energy.dim
    n_shards = len(rows_list)
    mine = list(tr.my_shards(n_shards))
    nv = int(vst[-1])
    nc = int(c_vst[-1])
    omega = float(opts.prol.omega.get(level))
    max_per_row = int(opts.prol.max_per_row.get(level))
    min_frac = float(opts.prol.min_frac.get(level))
    max_classic = int(opts.prol.max_classic.get(level))
    ptype = ProlType(opts.prol.type.get(level))
    pos_parts = _all_pos(rows_list)

    # --- piecewise rows ----------------------------------------------------
    Ppw_parts = [None] * n_shards
    for s in mine:
        rows = rows_list[s]
        nloc = rows.G.shape[0]
        v2 = v2agg_parts[s]
        act = np.flatnonzero(v2 >= 0)
        cpos_act = _gather(cpos_parts, c_vst, v2[act])
        Q = energy.transport(cpos_act, rows.pos[act])
        indptr = np.zeros(nloc + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(v2 >= 0)
        Ppw_parts[s] = sp.bsr_matrix(
            (Q.astype(np.float64), v2[act].astype(np.int32), indptr),
            shape=(nloc * dpv, nc * dpv),
        )
    if ptype == ProlType.PIECEWISE:
        return Ppw_parts

    D_parts = _rows_aux_diag(rows_list, vst, energy)

    # --- aux (replacement-matrix) rows as BSR with global columns ----------
    Ahat_parts = [None] * n_shards
    Dinv_parts = [None] * n_shards
    for s in mine:
        rows = rows_list[s]
        own0 = int(vst[s])
        nloc = rows.G.shape[0]
        rows_l = _row_locals(rows.G)
        cols = rows.G.indices.astype(np.int64)
        pos_own = rows.pos[rows_l]
        pos_oth = _gather(pos_parts, vst, cols)
        mid = 0.5 * (pos_own + pos_oth)
        Qim = energy.transport(pos_own, mid)
        Qjm = energy.transport(pos_oth, mid)
        EQj = rows.E @ Qjm
        Bij = -(np.swapaxes(Qim, -1, -2) @ EQj)
        # assemble the owned rows (diag block = aux diagonal)
        r_all = np.concatenate([rows_l, np.arange(nloc, dtype=np.int64)])
        c_all = np.concatenate([cols, np.arange(nloc, dtype=np.int64) + own0])
        blocks = np.concatenate([Bij, D_parts[s]], axis=0)
        order = np.lexsort((c_all, r_all))
        r_all, c_all, blocks = r_all[order], c_all[order], blocks[order]
        indptr = np.zeros(nloc + 1, dtype=np.int64)
        np.add.at(indptr, r_all + 1, 1)
        indptr = np.cumsum(indptr)
        Ahat_parts[s] = sp.bsr_matrix(
            (blocks, c_all.astype(np.int32), indptr),
            shape=(nloc * dpv, nv * dpv),
        ).tocsr()
        Dinv_b = np.linalg.pinv(D_parts[s])
        Dinv_parts[s] = sp.bsr_matrix(
            (
                Dinv_b,
                np.arange(nloc, dtype=np.int32),
                np.arange(nloc + 1),
            ),
            shape=(nloc * dpv, nloc * dpv),
        )

    def rho_mv(x):
        # owned-row slices + allgather: the replicated iterate every rank
        # rebuilds identically (rank-order concatenation = serial order)
        ys = [None] * n_shards
        for s in mine:
            ys[s] = Dinv_parts[s] @ (Ahat_parts[s] @ x)
        return tr.allgather_parts(ys)

    rho = _dist_rho(rho_mv, nv * dpv, seed=0)
    scale = omega / max(rho, 1e-12)

    scal_starts = vst * dpv
    Ppw_scal = [None if P is None else P.tocsr() for P in Ppw_parts]
    P_parts = [None] * n_shards
    for s in mine:
        # halo piecewise rows referenced by this shard's aux rows
        need_v = np.unique(Ahat_parts[s].indices // dpv).astype(np.int64)
        need_rows = (need_v[:, None] * dpv + np.arange(dpv)).ravel()
        Phalo = _halo_rows_csr(
            Ppw_scal, scal_starts, need_rows, nv * dpv, nc * dpv
        )
        P_parts[s] = (
            Ppw_scal[s] - scale * (Dinv_parts[s] @ (Ahat_parts[s] @ Phalo))
        ).tocsr()

    # --- classic (real-matrix) rows where the coarse fan-out is bounded ----
    if (
        A_parts is not None
        and row_bs == dpv
        and max_classic
        and max_classic > 1
    ):
        A_csr = [None if Ap is None else Ap.tocsr() for Ap in A_parts]
        classic_parts = [None] * n_shards
        any_classic = False
        for s in mine:
            rows = rows_list[s]
            nloc = rows.G.shape[0]
            B = sp.bsr_matrix(A_csr[s], blocksize=(dpv, dpv))
            norms = np.sqrt(
                (B.data.astype(np.float64) ** 2).sum(axis=(1, 2))
            )
            rows_b = _row_locals_b(B)
            colsb = B.indices.astype(np.int64)
            offd = (colsb != (rows_b + int(vst[s]))) & (norms > 0)
            agg_j = _gather(v2agg_parts, vst, colsb)
            own_agg = v2agg_parts[s]
            keys = np.concatenate(
                [
                    (rows_b * np.int64(nc) + agg_j)[offd & (agg_j >= 0)],
                    (np.arange(nloc, dtype=np.int64) * nc + own_agg)[
                        own_agg >= 0
                    ],
                ]
            )
            uniqk = np.unique(keys)
            counts = np.bincount(
                (uniqk // nc).astype(np.int64), minlength=nloc
            )
            classic_parts[s] = (counts <= max_classic) & (own_agg >= 0)
            any_classic = any_classic or bool(classic_parts[s].any())
        # the smoothing scale is a COLLECTIVE decision: every rank must
        # join the rho power iteration and the halo gathers below even if
        # none of ITS rows take the classic branch (SPMD call symmetry)
        if tr.allreduce_any(any_classic):
            DinvA_parts = [None] * n_shards
            for t in mine:
                nl_t = rows_list[t].G.shape[0]
                Db = block_diagonal_fast_rows(A_csr[t], dpv, int(vst[t]))
                DinvA_parts[t] = sp.bsr_matrix(
                    (
                        np.linalg.pinv(Db),
                        np.arange(nl_t, dtype=np.int32),
                        np.arange(nl_t + 1),
                    ),
                    shape=(nl_t * dpv, nl_t * dpv),
                )

            def rho_mv_r(x):
                ys = [None] * n_shards
                for t in mine:
                    ys[t] = DinvA_parts[t] @ (A_csr[t] @ x)
                return tr.allgather_parts(ys)

            rho_r = _dist_rho(rho_mv_r, nv * dpv, seed=1)
            scale_r = omega / max(rho_r, 1e-12)
            for s in mine:
                need_v = np.unique(A_csr[s].indices // dpv).astype(
                    np.int64
                )
                need_rows = (
                    need_v[:, None] * dpv + np.arange(dpv)
                ).ravel()
                Phalo = _halo_rows_csr(
                    Ppw_scal, scal_starts, need_rows, nv * dpv, nc * dpv
                )
                classic = classic_parts[s]
                if not classic.any():
                    continue  # after the collective gather — local-only
                P_real = (
                    Ppw_scal[s]
                    - scale_r * (DinvA_parts[s] @ (A_csr[s] @ Phalo))
                ).tocsr()
                sel = sp.diags(np.repeat(classic.astype(np.float64), dpv))
                inv = sp.diags(
                    np.repeat((~classic).astype(np.float64), dpv)
                )
                P_s = (sel @ P_real + inv @ P_parts[s]).tocsr()
                P_s.eliminate_zeros()
                P_parts[s] = P_s

    # --- kernel-preserving truncation (row-local) ---------------------------
    out = [None] * n_shards
    for s in mine:
        Pb = P_parts[s].tobsr(blocksize=(dpv, dpv))
        Pb.sort_indices()
        need_c = np.unique(Pb.indices).astype(np.int64)
        pos_c = np.zeros((nc, dim))
        # unconditional: the gather is a collective every rank must join
        pos_c[need_c] = _gather(cpos_parts, c_vst, need_c)
        mesh_c = AlgebraicMesh(nv=nc, edges=np.zeros((0, 2), dtype=np.int64))
        mesh_c.vertex_data["pos"] = pos_c
        out[s] = truncate_prol(
            energy,
            mesh_c,
            Pb,
            max_per_row=max_per_row,
            min_frac=min_frac,
        )
    return out


def block_diagonal_fast_rows(A_rows: sp.csr_matrix, bs: int, own0: int):
    """(n_own, bs, bs) diagonal blocks of a shard's global-column rows."""
    B = sp.bsr_matrix(A_rows, blocksize=(bs, bs))
    nloc = B.shape[0] // bs
    rows = _row_locals_b(B)
    isdiag = B.indices == (rows + own0)
    out = np.zeros((nloc, bs, bs), dtype=np.float64)
    out[rows[isdiag]] = B.data[isdiag]
    return out


# ---------------------------------------------------------------------------
# the distributed elasticity level loop
# ---------------------------------------------------------------------------


def _elast_levels_parts(A_parts, pos_parts, vst, opts: AMGOptions, energy):
    """The elasticity distributed level loop, rank-local.

    Consumes per-shard finest BLOCK rows + vertex positions (``None`` in
    slots owned by another controller) and returns one record per
    coarsening step holding the owned slots of P / A_c / v2agg / coarse
    mesh data plus the replicated coarse starts — rows stay per-shard end
    to end, like `dist_setup._scalar_levels_parts`. Under a
    single-controller transport every slot is owned (exact previous
    behavior); under ``mp_runtime.MPTransport`` each rank owns one slot
    and all cross-shard movement is real message passing. The reference's
    distributed layer drives elasticity with the same EQC/ReduceTable
    machinery as scalar H1 (reducetable.hpp:22-949, elasticity.hpp:58-98)
    — this is that uniformity for this setup.
    """
    from .transport import get_transport, shard_nbytes

    tr = get_transport()
    n_shards = len(vst) - 1
    mine = list(tr.my_shards(n_shards))
    dim, dpv = energy.dim, energy.dpv
    lc = opts.levels
    log = FactoryLog()
    nv = int(vst[-1])

    rows_list = _rows_finest(A_parts, pos_parts, energy, vst)

    log.nvs.append(nv)
    log.nnzs.append(
        int(
            tr.allgather(
                np.array([A_parts[s].nnz for s in mine], dtype=np.int64)
            ).sum()
        )
    )
    log.finest_global_bytes = int(
        tr.allgather(
            np.array(
                [shard_nbytes(A_parts[s]) for s in mine], dtype=np.int64
            )
        ).sum()
    )

    def _track_peak(*state_parts):
        per_shard = [
            shard_nbytes(
                *(sp_[s] for sp_ in state_parts if sp_ is not None)
            )
            for s in mine
        ]
        log.peak_shard_bytes = max(
            log.peak_shard_bytes, max(per_shard)
        )

    def _rows_state(rl):
        return [
            None if r is None else (r.G, r.E, r.pos, r.l2) for r in rl
        ]

    _track_peak(A_parts, _rows_state(rows_list))

    row_bs = dim
    starts = vst * row_bs
    recs = []
    finest = {
        "pos_parts": [
            None if rows_list[s] is None else rows_list[s].pos
            for s in range(n_shards)
        ],
        "l2_parts": [
            None if rows_list[s] is None else rows_list[s].l2
            for s in range(n_shards)
        ],
    }
    active = n_shards
    log.shards_per_level.append(active)
    n = nv
    lvl = 0
    while lvl + 1 < lc.max_levels and n > lc.max_coarse_size:
        v2agg_parts, c_vst = _dist_spw_energy(
            rows_list, vst, opts, lvl, energy
        )
        n_agg = int(c_vst[-1])
        if n_agg >= lc.min_coarsen_ratio * n or n_agg == 0:
            break
        from .dist_setup import try_contract_starts

        c_vst, active = try_contract_starts(
            c_vst, n, active, lc, lvl, log
        )
        log.shards_per_level.append(active)
        # coarse mesh data from the LEVEL's fine rows + composed aggregates
        # (the serial loop rebuilds mesh_c from the composed v2agg too)
        rows_c = _rows_map_data(rows_list, vst, v2agg_parts, c_vst, energy)
        cpos_parts = _all_pos(rows_c)
        P_parts = _dist_prol_elast(
            rows_list,
            vst,
            v2agg_parts,
            c_vst,
            cpos_parts,
            opts,
            lvl,
            energy,
            A_parts=A_parts if row_bs == dpv else None,
            row_bs=row_bs,
        )
        P_scal = [None if P is None else P.tocsr() for P in P_parts]
        P_amg_parts = None
        if lvl == 0:
            # pre-embedding prol (MultiDofMapStep secondary map)
            P_amg_parts = P_scal
            # fold the disp-only embedding E_v = [I_dim | 0] per shard
            folded = [None] * n_shards
            for s in mine:
                P_s = P_scal[s]
                nloc = rows_list[s].G.shape[0]
                Eb = energy.embed_blocks(nloc)
                E_s = sp.bsr_matrix(
                    (
                        Eb,
                        np.arange(nloc, dtype=np.int32),
                        np.arange(nloc + 1),
                    ),
                    shape=(nloc * dim, nloc * dpv),
                )
                folded[s] = (E_s @ P_s).tocsr()
            P_scal = folded
        c_starts = c_vst * dpv
        Ac_parts = _dist_rap(A_parts, starts, P_scal, c_starts)
        Ac_parts = _dist_symmetrize(Ac_parts, c_starts)
        _track_peak(
            A_parts, _rows_state(rows_c), P_scal, Ac_parts
        )
        log.nvs.append(n_agg)
        log.nnzs.append(
            int(
                tr.allgather(
                    np.array(
                        [Ac_parts[s].nnz for s in mine], dtype=np.int64
                    )
                ).sum()
            )
        )
        recs.append(
            {
                "P_parts": P_scal,
                "P_amg_parts": P_amg_parts,
                "v2agg_parts": v2agg_parts,
                "Ac_parts": Ac_parts,
                "coarse_starts": c_starts,
                "c_vst": c_vst,
                "row_bs_f": row_bs,
                "row_bs_c": dpv,
                "cpos_parts": cpos_parts,
                "cl2_parts": [
                    None if rows_c[s] is None else rows_c[s].l2
                    for s in range(n_shards)
                ],
            }
        )
        rows_list = rows_c
        vst = c_vst
        row_bs = dpv
        starts = c_starts
        A_parts = Ac_parts
        n = n_agg
        lvl += 1
    return recs, log, finest


def dist_setup_levels_elast(
    A: sp.spmatrix,
    energy,
    opts: AMGOptions,
    n_shards: int,
    coords: np.ndarray,
) -> tuple[list[SetupLevel], FactoryLog]:
    """Build the elasticity hierarchy from row-sharded inputs.

    Mirrors the serial factory loop (factory/levels.setup_levels) with
    every step shard-local: robust SPW matching with per-round transported
    coarse energies, block smoothed prolongation, the finest-level
    embedding fold, and the owner-routed distributed RAP. Aggregates equal
    the serial path; operators agree to fp roundoff. The level loop itself
    (`_elast_levels_parts`) is rank-local and also runs one-process-per-
    shard under ``mp_runtime`` (single-controller packaging happens here).
    """
    if coords is None:
        raise ValueError("elasticity needs vertex coordinates")
    dim, dpv = energy.dim, energy.dpv
    A = A.tocsr().astype(np.float64)
    nv = A.shape[0] // dim
    vst = np.linspace(0, nv, n_shards + 1).astype(np.int64)
    starts = vst * dim
    A_parts = [A[starts[s] : starts[s + 1]] for s in range(n_shards)]
    coords = np.asarray(coords, float)
    pos_parts = [
        np.asarray(coords[vst[s] : vst[s + 1]], dtype=np.float64)
        for s in range(n_shards)
    ]

    recs, log, finest = _elast_levels_parts(
        A_parts, pos_parts, vst, opts, energy
    )
    return (
        package_elast_levels(A, recs, finest, dim, dpv, nv),
        log,
    )


def package_elast_levels(A, recs, finest, dim, dpv, nv):
    """Assemble global SetupLevels from per-shard level-loop records
    (single-controller staging; the MP parent feeds per-rank slots)."""

    def ph_mesh(n, pos=None, l2=None):
        m = AlgebraicMesh(nv=n, edges=np.zeros((0, 2), dtype=np.int64))
        if pos is not None:
            m.vertex_data["pos"] = pos
            m.vertex_data["l2wt"] = l2
        return m

    levels = [
        SetupLevel(
            index=0,
            A=A,
            row_bs=dim,
            mesh=ph_mesh(
                nv,
                np.concatenate([p for p in finest["pos_parts"]]),
                np.concatenate([w for w in finest["l2_parts"]]),
            ),
        )
    ]
    for rec in recs:
        if rec["P_amg_parts"] is not None:
            levels[0].P_amg = sp.vstack(
                rec["P_amg_parts"], format="csr"
            ).tobsr(blocksize=(dpv, dpv))
        levels[-1].P = sp.vstack(rec["P_parts"], format="csr").tobsr(
            blocksize=(rec["row_bs_f"], dpv)
        )
        levels[-1].v2agg = np.concatenate(rec["v2agg_parts"])
        n_agg = int(rec["c_vst"][-1])
        levels.append(
            SetupLevel(
                index=len(levels),
                A=sp.vstack(rec["Ac_parts"], format="csr"),
                row_bs=dpv,
                mesh=ph_mesh(
                    n_agg,
                    np.concatenate(rec["cpos_parts"]),
                    np.concatenate(rec["cl2_parts"]),
                ),
            )
        )
    return levels
