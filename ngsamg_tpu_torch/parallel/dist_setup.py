"""Distributed (shard-local) AMG setup for row-sharded inputs.

Copied from ngsamg_tpu/parallel/dist_setup.py (numpy/scipy only; imports
point at this package's host copies). The counterpart of the reference's
distributed setup stack: EQC row
ownership (src/base/distributed/eqchierarchy.hpp:15-233),
solid/ghost-vertex matching (spw_agg_impl.hpp:1512-1541), the ReduceTable
gather-reduce-scatter collective (reducetable.hpp:22), and the distributed
Galerkin product (utils_sparseMM.cpp).

Ownership model: contiguous global row ranges per shard — the same 1-D row
partition the sharded solve uses (parallel/shard.py). Every step computes
ONLY on a shard's owned rows plus halo values fetched through the two
exchange primitives below:

* :func:`_gather` — fetch remote values at arbitrary global indices from
  their owners (maps to an all-to-all / indexed all-gather),
* :func:`_reduce_by_owner` — route (index, value) contributions to the
  index's owner and sum (maps to a reduce-scatter / ReduceTable).

On one host both are index-gathers into the owners' arrays, but no step
reads another shard's data except through them, so the control flow IS the
multi-host program.

Determinism / serial equality: handshake matching is a synchronous-rounds
algorithm, so the shard-local formulation with per-round halo exchange of
(rowmax, avail, best, partner) produces the SAME aggregates as the serial
path (coarse numbering = representative order = shard-major, matching the
serial np.unique compaction); coarse operators agree to fp roundoff
(summation order differs). Asserted by tests/test_torch_dist_setup.py.

State carried level to level, all row-sharded: the level matrix rows, the
edge-weight graph W (SIGNED -a_ij at the finest level, signed Galerkin
SUMS of fine cross-edge weights on coarse levels — the
AttachedNodeData/map_data analog; strength/energy consumers clamp to the
attractive part), and the per-vertex L2 weights. Replication of small coarse levels is a PLACEMENT
decision (parallel/shard.py replicate_below), not a setup-algorithm switch.

Scope: scalar H1 energies (dpv == 1), SPW coarsening, smoothed prolongation
with kernel-preserving truncation and the semi-aux classic-row choice.
Block energies route to their own distributed setups: elasticity to
parallel/dist_elast.py, Stokes to parallel/dist_stokes.py.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..config import AMGOptions
from ..factory.levels import FactoryLog, SetupLevel
from ..mesh.topo import AlgebraicMesh
from ..sparse.host import csr_rowwise_argmax, csr_rowwise_max
from ..transfer.prolongation import truncate_prol
from .transport import get_transport, shard_nbytes

# ---------------------------------------------------------------------------
# exchange primitives (the MPI boundary)
# ---------------------------------------------------------------------------


def split_rows(A: sp.spmatrix, n_shards: int):
    """Contiguous row partition: (parts, starts)."""
    A = A.tocsr()
    n = A.shape[0]
    starts = np.linspace(0, n, n_shards + 1).astype(np.int64)
    parts = [A[starts[s] : starts[s + 1]] for s in range(n_shards)]
    return parts, starts


def _owner(starts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.searchsorted(starts, idx, side="right") - 1


def _gather(parts: list, starts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """values[idx] fetched from the owning shards (halo exchange)."""
    return get_transport().gather(parts, starts, idx)


def _reduce_by_owner(
    starts: np.ndarray, idx: np.ndarray, vals: np.ndarray, n_local: list
):
    """Sum contributions onto their owners: per-shard dense arrays."""
    return get_transport().reduce_by_owner(starts, idx, vals, n_local)


def _route_coo(starts_row, ri, cj, vv, ncols):
    """Route COO triples to the row owners; per-shard CSR rows out."""
    return get_transport().route_coo(starts_row, ri, cj, vv, ncols)


# ---------------------------------------------------------------------------
# shard-local H1 energy data (the AttachedNodeData analog)
# ---------------------------------------------------------------------------


def _finest_wl2(parts, starts):
    """Per-shard (W rows, l2wt) from owned matrix rows.

    W = SIGNED -a_ij for every off-diagonal (attractive positive), l2 =
    clipped signed row sum (H1VData) — the row-derivable form of
    apps/h1.build_finest_mesh. Strength/energy consumers clamp to the
    attractive part; coarse-level Galerkin collapses stay signed so
    repulsive couplings cancel (serial-equality invariant).
    """
    n_shards = len(parts)
    W_parts = [None] * n_shards
    l2_parts = [None] * n_shards
    for s in get_transport().my_shards(n_shards):
        C = parts[s].tocsr()
        rows_l = np.repeat(
            np.arange(C.shape[0], dtype=np.int64), np.diff(C.indptr)
        )
        offd = C.indices != (rows_l + starts[s])
        keep = offd & (C.data != 0)
        W = sp.csr_matrix(
            (-C.data[keep], C.indices[keep], _recount(C.indptr, keep)),
            shape=C.shape,
        )
        W_parts[s] = W
        l2_parts[s] = np.maximum(np.asarray(C.sum(axis=1)).ravel(), 0.0)
    return W_parts, l2_parts


def _recount(indptr, keep):
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(len(deg)), deg)
    newdeg = np.bincount(
        rows, weights=keep.astype(np.int64), minlength=len(deg)
    ).astype(np.int64)
    out = np.zeros(len(indptr), dtype=np.int64)
    out[1:] = np.cumsum(newdeg)
    return out


def _aux_diag(W_parts, l2_parts):
    """d = l2 + sum incident max(w,0) per owned vertex (aux diagonal).

    Attractive clamp: W rows carry SIGNED weights (apps/h1.soc parity).
    """
    out = [None] * len(W_parts)
    for s in get_transport().my_shards(len(W_parts)):
        W = W_parts[s]
        rows_l = np.repeat(
            np.arange(W.shape[0], dtype=np.int64), np.diff(W.indptr)
        )
        d = l2_parts[s] + np.bincount(
            rows_l, weights=np.maximum(W.data, 0.0), minlength=W.shape[0]
        )
        out[s] = np.maximum(d, 1e-300)
    return out


def _strength_parts(W_parts, d_parts, starts):
    """soc rows: s_e = max(w_e,0) (1/d_i + 1/d_j)/2 (apps/h1.soc)."""
    out = [None] * len(W_parts)
    for s in get_transport().my_shards(len(W_parts)):
        W = W_parts[s]
        rows_l = np.repeat(
            np.arange(W.shape[0], dtype=np.int64), np.diff(W.indptr)
        )
        dj = _gather(d_parts, starts, W.indices.astype(np.int64))
        soc = np.maximum(W.data, 0.0) * 0.5 * (
            1.0 / d_parts[s][rows_l] + 1.0 / dj
        )
        out[s] = sp.csr_matrix((soc, W.indices, W.indptr), shape=W.shape)
    return out


# ---------------------------------------------------------------------------
# distributed handshake matching (synchronous rounds == serial result)
# ---------------------------------------------------------------------------


def _jitter(rows_g: np.ndarray, cols_g: np.ndarray, vals: np.ndarray):
    """The serial tie-break hash (coarsen/pairwise.handshake_match)."""
    lo = np.minimum(rows_g, cols_g)
    hi = np.maximum(rows_g, cols_g)
    h = (lo * np.int64(2654435761) + hi * np.int64(40503)) & np.int64(
        0xFFFFFFFF
    )
    return vals * (1.0 + 1e-9 * (h.astype(np.float64) / 2**32))


def _dist_handshake(S_parts, starts, theta: float):
    """Mutual-proposal matching, shard-local rows + per-round halos."""
    tr = get_transport()
    n_shards = len(S_parts)
    mine = list(tr.my_shards(n_shards))
    rowmax_parts = [None] * n_shards
    jit_parts = [None] * n_shards
    strong_parts = [None] * n_shards
    rowsl_parts = [None] * n_shards
    for s in mine:
        rowmax_parts[s] = csr_rowwise_max(S_parts[s].indptr, S_parts[s].data)
    for s in mine:
        S = S_parts[s]
        rows_l = np.repeat(
            np.arange(S.shape[0], dtype=np.int64), np.diff(S.indptr)
        )
        cols_g = S.indices.astype(np.int64)
        vals = _jitter(rows_l + starts[s], cols_g, S.data)
        rmax_j = _gather(rowmax_parts, starts, cols_g)
        thresh = theta * np.minimum(rowmax_parts[s][rows_l], rmax_j)
        strong_parts[s] = vals >= np.maximum(thresh, 1e-300)
        jit_parts[s] = vals
        rowsl_parts[s] = rows_l

    partner_parts = [None] * n_shards
    avail_parts = [None] * n_shards
    for s in mine:
        partner_parts[s] = np.full(S_parts[s].shape[0], -1, dtype=np.int64)
        avail_parts[s] = np.ones(S_parts[s].shape[0], dtype=bool)
    for _round in range(8):
        best_parts = [None] * n_shards
        for s in mine:
            S = S_parts[s]
            cols_g = S.indices.astype(np.int64)
            av_j = _gather(avail_parts, starts, cols_g)
            valid = (
                strong_parts[s] & avail_parts[s][rowsl_parts[s]] & av_j
            )
            best, _bv = csr_rowwise_argmax(
                S.indptr, S.indices, jit_parts[s], valid=valid
            )
            best[~avail_parts[s]] = -1
            best_parts[s] = best
        any_new = False
        accepts = [None] * n_shards
        for s in mine:
            best = best_parts[s]
            v_l = np.flatnonzero(best >= 0)
            b = best[v_l]
            bb = _gather(best_parts, starts, b)
            mutual = bb == (v_l + starts[s])
            accepts[s] = (v_l[mutual], b[mutual])
            any_new = any_new or bool(mutual.any())
        for s in mine:
            v_l, b = accepts[s]
            partner_parts[s][v_l] = b
            avail_parts[s][v_l] = False
        if not tr.allreduce_any(any_new):
            break
    return partner_parts


def _dist_aggregates(partner_parts, starts):
    """Compact aggregate ids; numbering == serial np.unique(rep) order."""
    tr = get_transport()
    n_shards = len(partner_parts)
    mine = list(tr.my_shards(n_shards))
    rep_parts = [None] * n_shards
    isrep_parts = [None] * n_shards
    for s in mine:
        partner = partner_parts[s]
        v_g = np.arange(len(partner), dtype=np.int64) + starts[s]
        rep = np.where(partner >= 0, np.minimum(v_g, partner), v_g)
        rep_parts[s] = rep
        isrep_parts[s] = rep == v_g
    counts = tr.allgather(
        np.array([isrep_parts[s].sum() for s in mine], dtype=np.int64)
    )
    coarse_starts = np.zeros(n_shards + 1, dtype=np.int64)
    coarse_starts[1:] = np.cumsum(counts)
    aggid_parts = [None] * n_shards
    for s in mine:
        aid = np.full(len(rep_parts[s]), -1, dtype=np.int64)
        aid[isrep_parts[s]] = coarse_starts[s] + np.arange(counts[s])
        aggid_parts[s] = aid
    v2agg_parts = [None] * n_shards
    for s in mine:
        v2 = aggid_parts[s].copy()
        need = v2 < 0
        v2[need] = _gather(aggid_parts, starts, rep_parts[s][need])
        v2agg_parts[s] = v2
    return v2agg_parts, coarse_starts


def _dist_collapse(G_parts, starts, v2agg_parts, coarse_starts):
    """Coarse graph C^T G C (off-diagonal part), rows routed to owners."""
    ri_l, cj_l, vv_l = [], [], []
    for s in get_transport().my_shards(len(G_parts)):
        G = G_parts[s]
        rows_l = np.repeat(
            np.arange(G.shape[0], dtype=np.int64), np.diff(G.indptr)
        )
        ci = v2agg_parts[s][rows_l]
        cj = _gather(v2agg_parts, starts, G.indices.astype(np.int64))
        keep = (ci >= 0) & (cj >= 0) & (ci != cj)
        ri_l.append(ci[keep])
        cj_l.append(cj[keep])
        vv_l.append(G.data[keep])
    nc = int(coarse_starts[-1])
    return _route_coo(
        coarse_starts,
        np.concatenate(ri_l) if ri_l else np.zeros(0, np.int64),
        np.concatenate(cj_l) if cj_l else np.zeros(0, np.int64),
        np.concatenate(vv_l) if vv_l else np.zeros(0),
        nc,
    )


def _dist_symmetrize(Ac_parts, starts):
    """Owner-local (C + C^T)/2: route every entry's TRANSPOSE to the row
    owner and add shard-locally — no global matrix is materialized
    (the per-level global `Ac + Ac.T` staging this replaces held the
    whole coarse matrix on one host; a multi-controller run only ever
    sees its own rows plus incoming transpose messages, exactly the
    reference's ReduceTable-routed assembly, reducetable.hpp:22)."""
    n = int(starts[-1])
    mine = list(get_transport().my_shards(len(Ac_parts)))
    ri, cj, vv = [], [], []
    for s in mine:
        coo = Ac_parts[s].tocoo()
        ri.append(coo.col.astype(np.int64))  # transposed entries
        cj.append(coo.row.astype(np.int64) + starts[s])
        vv.append(coo.data)
    T_parts = _route_coo(
        starts,
        np.concatenate(ri) if ri else np.zeros(0, np.int64),
        np.concatenate(cj) if cj else np.zeros(0, np.int64),
        np.concatenate(vv) if vv else np.zeros(0),
        n,
    )
    out = [None] * len(Ac_parts)
    for s in mine:
        M = ((Ac_parts[s].tocsr() + T_parts[s]) * 0.5).tocsr()
        M.sum_duplicates()
        M.sort_indices()
        out[s] = M
    return out


def _dist_spw(S_parts, starts, opts: AMGOptions, level: int):
    """Multi-round SPW on sharded strength rows (serial-equivalent)."""
    theta = float(opts.coarsen.theta.get(level))
    aaf = opts.coarsen.aaf.get(level)
    rounds = (
        10 if aaf is not None else int(opts.coarsen.spw_rounds.get(level))
    )
    return _dist_spw_core(
        S_parts,
        starts,
        theta=theta,
        rounds=rounds,
        aaf=aaf,
        adopt_orphans=bool(opts.coarsen.adopt_orphans.get(level)),
    )


def _collapse_l2(l2_parts, starts, v2agg_parts, coarse_starts):
    """Coarse l2 weights: owner-reduced sums of member weights."""
    n_shards = len(l2_parts)
    mine = list(get_transport().my_shards(n_shards))
    all_v2 = np.concatenate([v2agg_parts[s] for s in mine])
    all_l2 = np.concatenate([l2_parts[s] for s in mine])
    m = all_v2 >= 0
    return _reduce_by_owner(
        coarse_starts,
        all_v2[m],
        all_l2[m],
        [
            int(coarse_starts[t + 1] - coarse_starts[t])
            for t in range(n_shards)
        ],
    )


def _dist_spw_wl2(W_parts, l2_parts, starts, opts: AMGOptions, level: int):
    """SPW with per-round strength re-evaluation from SIGNED weight sums.

    The distributed mirror of serial `pairwise.spw_aggregate_energy` for
    H1 energies (the levels.py default): every matching round Galerkin-
    collapses the SIGNED W graph and the l2 weights onto the current
    aggregates (net-zero couplings between sub-clusters stop looking
    strong) and recomputes the harmonic soc before the next handshake.
    """
    theta = float(opts.coarsen.theta.get(level))
    aaf = opts.coarsen.aaf.get(level)
    rounds = (
        10 if aaf is not None else int(opts.coarsen.spw_rounds.get(level))
    )
    adopt = bool(opts.coarsen.adopt_orphans.get(level))
    n_shards = len(W_parts)
    mine = list(get_transport().my_shards(n_shards))
    n0 = int(starts[-1])
    v2c_parts = [None] * n_shards
    for s in mine:
        v2c_parts[s] = np.arange(starts[s], starts[s + 1], dtype=np.int64)
    cur_W, cur_l2, cur_starts = W_parts, l2_parts, starts
    n_cur = n0
    for _round in range(rounds):
        if aaf is not None and n_cur <= float(aaf) * n0:
            break
        d_parts = _aux_diag(cur_W, cur_l2)
        S_parts = _strength_parts(cur_W, d_parts, cur_starts)
        partner_parts = _dist_handshake(S_parts, cur_starts, theta)
        c2agg_parts, coarse_starts = _dist_aggregates(
            partner_parts, cur_starts
        )
        n_agg = int(coarse_starts[-1])
        if n_agg >= n_cur or n_agg == 0:
            break
        for s in mine:
            v2 = v2c_parts[s]
            m = v2 >= 0
            v2[m] = _gather(c2agg_parts, cur_starts, v2[m])
        cur_W = _dist_collapse(
            cur_W, cur_starts, c2agg_parts, coarse_starts
        )
        cur_l2 = _collapse_l2(
            cur_l2, cur_starts, c2agg_parts, coarse_starts
        )
        cur_starts = coarse_starts
        n_cur = n_agg
    if adopt and n_cur < n0:
        d_parts = _aux_diag(cur_W, cur_l2)
        S_parts = _strength_parts(cur_W, d_parts, cur_starts)
        v2c_parts, cur_starts = _dist_adopt_orphans(
            S_parts, cur_starts, v2c_parts
        )
    return v2c_parts, cur_starts


def _dist_spw_core(
    S_parts, starts, *, theta, rounds, aaf=None, adopt_orphans=True
):
    """Explicit-knob SPW core (serial coarsen/pairwise.spw_aggregate)."""
    n_shards = len(S_parts)
    mine = list(get_transport().my_shards(n_shards))
    n0 = int(starts[-1])
    v2c_parts = [None] * n_shards
    for s in mine:
        v2c_parts[s] = np.arange(starts[s], starts[s + 1], dtype=np.int64)
    cur_S, cur_starts = S_parts, starts
    n_cur = n0
    for _round in range(rounds):
        if aaf is not None and n_cur <= float(aaf) * n0:
            break
        partner_parts = _dist_handshake(cur_S, cur_starts, theta)
        c2agg_parts, coarse_starts = _dist_aggregates(
            partner_parts, cur_starts
        )
        n_agg = int(coarse_starts[-1])
        if n_agg >= n_cur:
            break
        for s in mine:
            v2 = v2c_parts[s]
            m = v2 >= 0  # dropped vertices stay -1 (serial mask rule)
            v2[m] = _gather(c2agg_parts, cur_starts, v2[m])
        cur_S = _dist_collapse(
            cur_S, cur_starts, c2agg_parts, coarse_starts
        )
        cur_starts = coarse_starts
        n_cur = n_agg
    if adopt_orphans and n_cur < n0:
        v2c_parts, cur_starts = _dist_adopt_orphans(
            cur_S, cur_starts, v2c_parts
        )
    return v2c_parts, cur_starts


def _dist_adopt_orphans(Sc_parts, coarse_starts, v2c_parts):
    """Serial _adopt_orphans, shard-local (sizes/argmax/renumber)."""
    tr = get_transport()
    n_shards = len(Sc_parts)
    mine = list(tr.my_shards(n_shards))
    all_v2c = np.concatenate([v2c_parts[s] for s in mine])
    sizes_parts = _reduce_by_owner(
        coarse_starts,
        all_v2c[all_v2c >= 0],
        np.ones(int((all_v2c >= 0).sum())),
        [
            int(coarse_starts[s + 1] - coarse_starts[s])
            for s in range(n_shards)
        ],
    )
    orphan_parts = [
        (sz == 1 if sz is not None else None) for sz in sizes_parts
    ]
    if not tr.allreduce_any(any(orphan_parts[s].any() for s in mine)):
        return v2c_parts, coarse_starts
    tgt_parts = [None] * n_shards
    surv_parts = [None] * n_shards
    for s in mine:
        Sc = Sc_parts[s]
        nloc = Sc.shape[0]
        best, _bv = csr_rowwise_argmax(Sc.indptr, Sc.indices, Sc.data)
        c_g = np.arange(nloc, dtype=np.int64) + coarse_starts[s]
        tgt = c_g.copy()
        has = best >= 0
        orphan_best = np.zeros(nloc, dtype=bool)
        orphan_best[has] = _gather(orphan_parts, coarse_starts, best[has])
        ok = orphan_parts[s] & has & ~orphan_best
        tgt[ok] = best[ok]
        tgt_parts[s] = tgt
        surv_parts[s] = ~ok  # adopted-away ids vanish
    counts = tr.allgather(
        np.array([surv_parts[s].sum() for s in mine], dtype=np.int64)
    )
    new_starts = np.zeros(n_shards + 1, dtype=np.int64)
    new_starts[1:] = np.cumsum(counts)
    newid_parts = [None] * n_shards
    for s in mine:
        nid = np.full(len(surv_parts[s]), -1, dtype=np.int64)
        nid[surv_parts[s]] = new_starts[s] + np.arange(counts[s])
        newid_parts[s] = nid
    remap_parts = [None] * n_shards
    for s in mine:
        rm = newid_parts[s].copy()
        adopted = rm < 0
        rm[adopted] = _gather(
            newid_parts, coarse_starts, tgt_parts[s][adopted]
        )
        remap_parts[s] = rm
    out_parts = [None] * n_shards
    for s in mine:
        v2 = v2c_parts[s].copy()
        m = v2 >= 0
        v2[m] = _gather(remap_parts, coarse_starts, v2[m])
        out_parts[s] = v2
    return out_parts, new_starts


# ---------------------------------------------------------------------------
# distributed prolongation + Galerkin product
# ---------------------------------------------------------------------------


def _dist_power_rho(matvec_rows, starts, seed: int, iters=10):
    """Distributed power iteration for rho(D^-1 M).

    ``matvec_rows(s, x)`` returns (D^-1 M x) on shard s's owned rows; the
    random start vector uses the serial seeds (0 = aux, 1 = real matrix).

    The iterate stays REPLICATED (an O(n) vector, not matrix state):
    every controller regenerates the same start vector and re-assembles y
    via ``allgather_parts`` each iteration, so the norm — and hence rho,
    the prolongation scale, and the whole hierarchy — is bitwise-equal
    across 1..n controllers (partial-sum allreduce would differ in the
    last ulp and could flip downstream truncation ties)."""
    tr = get_transport()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(int(starts[-1]))
    lam = 1.0
    n_shards = len(starts) - 1
    mine = list(tr.my_shards(n_shards))
    for _ in range(iters):
        y_parts = [None] * n_shards
        for s in mine:
            y_parts[s] = matvec_rows(s, x)
        y = tr.allgather_parts(y_parts)
        nrm = np.linalg.norm(y)
        if nrm == 0:
            return 2.0
        lam = nrm
        x = y / nrm
    return float(lam)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    """The serial zero-diagonal rule: dinv = 0 where d is (clamped) zero."""
    return np.where(d > 1e-299, 1.0 / np.maximum(d, 1e-300), 0.0)


def _dist_rho_aux(W_parts, d_parts, starts, iters=10):
    """rho(Dhat^-1 A-hat) (seed 0 like serial smoothed_prol)."""

    def mv(s, x):
        W = W_parts[s]
        nloc = W.shape[0]
        rows_l = np.repeat(
            np.arange(nloc, dtype=np.int64), np.diff(W.indptr)
        )
        xj = x[W.indices]  # x is replicated (see _dist_power_rho)
        off = np.bincount(
            rows_l, weights=-np.maximum(W.data, 0.0) * xj, minlength=nloc
        )
        xo = x[starts[s] : starts[s + 1]]
        dinv = _safe_inv(d_parts[s])
        return dinv * (d_parts[s] * xo + off)

    return _dist_power_rho(mv, starts, seed=0, iters=iters)


def _dist_rho_real(A_parts, starts, iters=10):
    """rho(D_A^-1 A) (seed 1 like the serial classic path)."""

    def mv(s, x):
        C = A_parts[s].tocsr()
        nloc = C.shape[0]
        rows_l = np.repeat(
            np.arange(nloc, dtype=np.int64), np.diff(C.indptr)
        )
        xj = x[C.indices]  # x is replicated (see _dist_power_rho)
        Ax = np.bincount(rows_l, weights=C.data * xj, minlength=nloc)
        diagA = C.diagonal(k=int(starts[s]))[:nloc]
        return _safe_inv(diagA) * Ax

    return _dist_power_rho(mv, starts, seed=1, iters=iters)


def _dist_prol(
    A_parts, W_parts, d_parts, starts, v2agg_parts, coarse_starts,
    opts, level, energy, filter_classic=True,
):
    """Smoothed H1 prolongation rows per shard (semi-aux classic choice).

    ``filter_classic`` selects the scalar-path parity behavior (classic
    rows smooth with the SA-FILTERED matrix — positive off-diagonals
    lumped — sharing the aux spectral scale, matching the native kernel);
    the vector (trace-condensed) path keeps the raw-real smoothing of
    serial transfer/prolongation.smoothed_prol for dpv > 1.
    """
    tr = get_transport()
    n_shards = len(A_parts)
    mine = list(tr.my_shards(n_shards))
    nc = int(coarse_starts[-1])
    omega = float(opts.prol.omega.get(level))
    rho = _dist_rho_aux(W_parts, d_parts, starts)
    scale = omega / max(rho, 1e-12)
    max_classic = int(opts.prol.max_classic.get(level))
    rho_r = scale_r = None

    # pass A: aux rows + classic precursors per owned shard. The gathers
    # here run once per owned shard — a symmetric collective count under
    # a multi-controller transport.
    P_parts = [None] * n_shards
    cls_cache = {}
    for s in mine:
        W = W_parts[s]
        nloc = W.shape[0]
        rows_l = np.repeat(
            np.arange(nloc, dtype=np.int64), np.diff(W.indptr)
        )
        agg_own = v2agg_parts[s]
        agg_j = _gather(v2agg_parts, starts, W.indices.astype(np.int64))
        dinv = _safe_inv(d_parts[s])  # serial rule: zero rows -> dinv 0
        rows = np.concatenate([np.arange(nloc), rows_l])
        cols = np.concatenate([agg_own, agg_j])
        # P row i = e_agg(i) - scale * dinv_i * (Ahat row i) P_pw with
        # Ahat_ii = d_i, Ahat_ij = -w_ij (the H1 replacement matrix)
        vals = np.concatenate(
            [np.full(nloc, 1.0) - scale * dinv * d_parts[s],
             scale * dinv[rows_l] * np.maximum(W.data, 0.0)]
        )
        keep = cols >= 0
        P_s = sp.coo_matrix(
            (vals[keep], (rows[keep], cols[keep])), shape=(nloc, nc)
        ).tocsr()
        P_s.sum_duplicates()
        P_parts[s] = P_s
        if max_classic and max_classic > 1:
            C = A_parts[s].tocsr()
            rows_a = np.repeat(
                np.arange(nloc, dtype=np.int64), np.diff(C.indptr)
            )
            offd = C.indices != (rows_a + starts[s])
            nzo = offd & (C.data != 0)
            agg_aj = _gather(
                v2agg_parts, starts, C.indices.astype(np.int64)
            )
            keys = np.concatenate(
                [
                    (rows_a * np.int64(nc) + agg_aj)[nzo & (agg_aj >= 0)],
                    (np.arange(nloc, dtype=np.int64) * nc + agg_own)[
                        agg_own >= 0
                    ],
                ]
            )
            uniqk = np.unique(keys)
            counts = np.bincount(
                (uniqk // nc).astype(np.int64), minlength=nloc
            )
            classic = (counts <= max_classic) & (agg_own >= 0)
            cls_cache[s] = (C, rows_a, offd, agg_aj, classic)

    # the raw-real spectral scale is a COLLECTIVE (per-iteration
    # allgather): every rank must join it even when none of ITS rows
    # take the classic branch (SPMD call symmetry)
    if (
        max_classic
        and max_classic > 1
        and not filter_classic
        and tr.allreduce_any(
            any(cls_cache[s][4].any() for s in mine if s in cls_cache)
        )
    ):
        rho_r = _dist_rho_real(A_parts, starts)
        scale_r = omega / max(rho_r, 1e-12)

    # pass B: apply the classic rows (local work) + truncation
    for s in mine:
        P_s = P_parts[s]
        nloc = P_s.shape[0]
        agg_own = v2agg_parts[s]
        if s in cls_cache:
            C, rows_a, offd, agg_aj, classic = cls_cache[s]
            if classic.any():
                if filter_classic:
                    # serial parity (native smoothed_prol_scalar kernel):
                    # classic rows smooth with the FILTERED matrix —
                    # positive off-diagonals lumped onto the diagonal —
                    # using the aux spectral-radius scale
                    scale_r = scale
                    diagA = C.diagonal(k=int(starts[s]))[:nloc]
                    pos = offd & (C.data > 0)
                    diagF = diagA + np.bincount(
                        rows_a[pos], weights=C.data[pos], minlength=nloc
                    )
                    dinvA = np.where(diagF > 0, 1.0 / diagF, 0.0)
                    neg = offd & (C.data < 0)
                    rows2 = np.concatenate([np.arange(nloc), rows_a[neg]])
                    cols2 = np.concatenate([agg_own, agg_aj[neg]])
                    vals2 = np.concatenate(
                        [
                            1.0 - scale_r * dinvA * diagF,
                            -scale_r * dinvA[rows_a[neg]] * C.data[neg],
                        ]
                    )
                else:
                    # raw-real smoothing (serial smoothed_prol, dpv > 1;
                    # scale_r precomputed collectively above)
                    diagA = C.diagonal(k=int(starts[s]))[:nloc]
                    dinvA = np.where(
                        diagA > 0, 1.0 / np.maximum(diagA, 1e-300), 0.0
                    )
                    rows2 = np.concatenate([np.arange(nloc), rows_a[offd]])
                    cols2 = np.concatenate([agg_own, agg_aj[offd]])
                    vals2 = np.concatenate(
                        [
                            1.0 - scale_r * dinvA * diagA,
                            -scale_r * dinvA[rows_a[offd]] * C.data[offd],
                        ]
                    )
                k2 = cols2 >= 0
                P_real = sp.coo_matrix(
                    (vals2[k2], (rows2[k2], cols2[k2])), shape=(nloc, nc)
                ).tocsr()
                P_real.sum_duplicates()
                selc = sp.diags(classic.astype(np.float64))
                sela = sp.diags((~classic).astype(np.float64))
                P_s = (selc @ P_real + sela @ P_s).tocsr()
                P_s.eliminate_zeros()
        mesh_c = AlgebraicMesh(
            nv=nc, edges=np.zeros((0, 2), dtype=np.int64)
        )
        Pb = truncate_prol(
            energy,
            mesh_c,
            P_s.tobsr(blocksize=(1, 1)),
            max_per_row=int(opts.prol.max_per_row.get(level)),
            min_frac=float(opts.prol.min_frac.get(level)),
        )
        P_parts[s] = Pb.tocsr()
    return P_parts


def _gather_csr_rows(P_parts, starts, rows_g, ncols):
    """Fetch CSR rows at global indices from their owners, stacked."""
    return get_transport().gather_csr_rows(P_parts, starts, rows_g, ncols)


def _dist_rap(A_parts, starts, P_parts, coarse_starts):
    """A_c = P^T A P with per-shard products + owner-routed reduction."""
    n_shards = len(A_parts)
    nc = int(coarse_starts[-1])
    ri_l, cj_l, vv_l = [], [], []
    for s in get_transport().my_shards(n_shards):
        A_s = A_parts[s].tocsr()
        cols = np.unique(A_s.indices.astype(np.int64))
        P_halo = _gather_csr_rows(P_parts, starts, cols, nc)
        colmap = np.searchsorted(cols, A_s.indices)
        A_c = sp.csr_matrix(
            (A_s.data, colmap, A_s.indptr),
            shape=(A_s.shape[0], len(cols)),
        )
        AP = A_c @ P_halo
        M = (P_parts[s].T.tocsr() @ AP).tocoo()
        ri_l.append(M.row.astype(np.int64))
        cj_l.append(M.col.astype(np.int64))
        vv_l.append(M.data)
    return _route_coo(
        coarse_starts,
        np.concatenate(ri_l),
        np.concatenate(cj_l),
        np.concatenate(vv_l),
        nc,
    )


def try_contract_starts(coarse_starts, n_prev, active, lc, lvl, log):
    """The TryContractStep/FindRDFac analog inside the level loop
    (base_factory.cpp:573-682): decide DURING setup whether the coarse
    level concentrates onto fewer shards.

    Halves the active group once when the step coarsened slowly
    (nc/n_prev >= rd_slow_ratio — the reference contracts when the
    coarsening rate drops), then keeps halving while a shard would own
    fewer than rd_min_rows coarse rows (rd_min_nv_th). Contraction merges
    ADJACENT ownership ranges (locality-preserving; shards beyond the new
    active count own empty ranges, like the reference's idle dropped
    ranks — `amg_matrix.cpp drops_out`), so coarse IDs and all computed
    values are unchanged; only ownership, per-rank residency, and the
    device placement cap change. Logs the decision like FactoryLog logs
    OC. Returns (new_coarse_starts, new_active).
    """
    nc = int(coarse_starts[-1])
    k = int(active)
    reasons = []
    if k > 1 and n_prev and nc >= lc.rd_slow_ratio * n_prev:
        k //= 2
        reasons.append("slow_coarsening")
    while k > 1 and nc // k < int(lc.rd_min_rows):
        k //= 2
        if "min_rows" not in reasons:
            reasons.append("min_rows")
    if k == active:
        return coarse_starts, int(active)
    fac = int(active) // k
    new = np.empty_like(coarse_starts)
    for j in range(k + 1):
        new[j] = coarse_starts[min(j * fac, int(active))]
    new[k + 1:] = nc
    log.contract_decisions.append(
        (lvl + 1, int(active), k, "+".join(reasons))
    )
    return new, k


# ---------------------------------------------------------------------------
# the distributed level loop
# ---------------------------------------------------------------------------


def _vector_levels_parts(parts, starts, opts: AMGOptions, bs: int):
    """The vector-H1 distributed level loop, rank-local.

    Matching/prolongation run shard-locally on the TRACE-condensed vertex
    graph (the serial vector-H1 semantics: all energy data is the block
    trace, transport is the identity); per-shard prolongations expand by
    kron with I_bs and the Galerkin product runs on the full block rows.
    Aggregates are identical to the serial path; values agree up to the
    rho-estimate (power iteration runs in the vertex space here). Like
    `_scalar_levels_parts`, every slot not in ``transport.my_shards`` is
    ``None`` and all cross-shard movement goes through the transport, so
    the same loop runs one-process-per-rank under ``mp_runtime``.
    """
    from ..apps.h1 import H1Energy

    tr = get_transport()
    n_shards = len(starts) - 1
    mine = list(tr.my_shards(n_shards))
    lc = opts.levels
    log = FactoryLog()
    nv = int(starts[-1]) // bs
    log.nvs.append(nv)
    log.nnzs.append(
        int(
            tr.allgather(
                np.array([parts[s].nnz for s in mine], dtype=np.int64)
            ).sum()
        )
    )
    log.finest_global_bytes = int(
        tr.allgather(
            np.array(
                [shard_nbytes(parts[s]) for s in mine], dtype=np.int64
            )
        ).sum()
    )

    def _track_peak(*state_parts):
        per_shard = [
            shard_nbytes(*(sp_[s] for sp_ in state_parts if sp_ is not None))
            for s in mine
        ]
        log.peak_shard_bytes = max(log.peak_shard_bytes, max(per_shard))

    T_parts, vst = _condense_block_rows(parts, starts, bs)
    W_parts, l2_parts = _finest_wl2(T_parts, vst)
    _track_peak(parts, T_parts, W_parts, l2_parts)
    en1 = H1Energy(bs=1)
    recs = []
    active = n_shards
    log.shards_per_level.append(active)
    n = nv
    lvl = 0
    while lvl + 1 < lc.max_levels and n > lc.max_coarse_size:
        d_parts = _aux_diag(W_parts, l2_parts)
        v2agg_parts, c_vst = _dist_spw_wl2(
            W_parts, l2_parts, vst, opts, lvl
        )
        ncv = int(c_vst[-1])
        if ncv >= lc.min_coarsen_ratio * n or ncv == 0:
            break
        c_vst, active = try_contract_starts(
            c_vst, n, active, lc, lvl, log
        )
        log.shards_per_level.append(active)
        Pv_parts = _dist_prol(
            T_parts, W_parts, d_parts, vst, v2agg_parts, c_vst, opts,
            lvl, en1, filter_classic=False,
        )
        P_parts = [None] * n_shards
        for s in mine:
            P_parts[s] = sp.kron(Pv_parts[s], sp.eye(bs), format="csr")
        c_starts = c_vst * bs
        Ac_parts = _dist_rap(parts, starts, P_parts, c_starts)
        Ac_parts = _dist_symmetrize(Ac_parts, c_starts)
        _track_peak(parts, T_parts, W_parts, l2_parts, P_parts, Ac_parts)
        log.nvs.append(ncv)
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
                "P_parts": P_parts,
                "v2agg_parts": v2agg_parts,
                "Ac_parts": Ac_parts,
                "coarse_starts": c_starts,
                "c_vst": c_vst,
            }
        )
        W_parts = _dist_collapse(W_parts, vst, v2agg_parts, c_vst)
        all_v2 = np.concatenate([v2agg_parts[s] for s in mine])
        all_l2 = np.concatenate([l2_parts[s] for s in mine])
        m = all_v2 >= 0
        l2_parts = _reduce_by_owner(
            c_vst,
            all_v2[m],
            all_l2[m],
            [int(c_vst[t + 1] - c_vst[t]) for t in range(n_shards)],
        )
        parts = Ac_parts
        starts, vst = c_starts, c_vst
        T_parts, _ = _condense_block_rows(parts, starts, bs)
        n = ncv
        lvl += 1
    return recs, log


def _dist_setup_vector(
    A: sp.spmatrix, energy, opts: AMGOptions, n_shards: int, bs: int
) -> tuple[list[SetupLevel], FactoryLog]:
    """Vector (multidim) H1 distributed setup (single-controller
    packaging around the rank-local `_vector_levels_parts`)."""
    A = A.tocsr().astype(np.float64)
    nv = A.shape[0] // bs
    v_starts = np.linspace(0, nv, n_shards + 1).astype(np.int64)
    starts = v_starts * bs
    parts = [A[starts[s] : starts[s + 1]] for s in range(n_shards)]
    recs, log = _vector_levels_parts(parts, starts, opts, bs)

    def ph_mesh(n):
        return AlgebraicMesh(nv=n, edges=np.zeros((0, 2), dtype=np.int64))

    levels = [
        SetupLevel(
            index=0,
            A=sp.vstack(parts, format="csr"),
            row_bs=bs,
            mesh=ph_mesh(nv),
        )
    ]
    for rec in recs:
        levels[-1].P = sp.vstack(rec["P_parts"], format="csr").tobsr(
            blocksize=(bs, bs)
        )
        levels[-1].v2agg = np.concatenate(rec["v2agg_parts"])
        levels.append(
            SetupLevel(
                index=len(levels),
                A=sp.vstack(rec["Ac_parts"], format="csr"),
                row_bs=bs,
                mesh=ph_mesh(int(rec["c_vst"][-1])),
            )
        )
    return levels, log


def _condense_block_rows(parts, starts, bs: int):
    """Per-shard TRACE condensation of block rows to the vertex graph.

    The vector-H1 analog of apps/h1.build_finest_mesh: vertex-graph entry
    (v, w) = sum_k a[v*bs+k, w*bs+k]. Owned block rows condense locally
    (vertex ownership = block-row ownership). Returns per-shard vertex
    CSR rows (global vertex columns) + vertex starts.
    """
    n_shards = len(parts)
    v_starts = starts // bs
    out = [None] * n_shards
    for s in get_transport().my_shards(n_shards):
        C = parts[s].tocsr()
        nloc = C.shape[0]
        rows_l = np.repeat(
            np.arange(nloc, dtype=np.int64), np.diff(C.indptr)
        )
        comp_r = (rows_l + starts[s]) % bs
        comp_c = C.indices % bs
        m = comp_r == comp_c  # block-diagonal components carry the trace
        vr = rows_l[m] // bs
        vc = C.indices[m] // bs
        nv = int(v_starts[-1])
        T = sp.coo_matrix(
            (C.data[m], (vr, vc)), shape=(nloc // bs, nv)
        ).tocsr()
        T.sum_duplicates()
        out[s] = T
    return out, v_starts


def dist_setup_levels(
    A: sp.spmatrix,
    energy,
    opts: AMGOptions,
    n_shards: int,
    coords: np.ndarray | None = None,
) -> tuple[list[SetupLevel], FactoryLog]:
    """Build the hierarchy from row-sharded inputs.

    Scalar H1 runs the shard-local machinery directly; vector H1
    (dpv == bs > 1, identity transport) condenses block rows to the
    vertex trace graph per shard, coarsens/smooths there, and expands the
    prolongations by kron with I_bs — exactly the serial vector-H1
    semantics (apps/h1.py). Elasticity (non-identity rigid-body
    transports) runs the block machinery in parallel/dist_elast.py.
    The returned SetupLevel matrices are assembled global views of the
    per-shard rows — the staging step before device placement, which
    re-shards them via parallel/shard.py (small levels replicated there).
    """
    bs = getattr(energy, "dpv", None)
    from ..apps.elasticity import ElasticityEnergy
    from ..apps.h1 import H1Energy

    if isinstance(energy, ElasticityEnergy):
        from ..config import CoarsenType
        from ..factory.levels import setup_levels

        algo = CoarsenType(opts.coarsen.algo.get(0))
        if algo == CoarsenType.AUTO and coords is not None:
            from ..coarsen.lattice import lattice_aggregate

            if lattice_aggregate(np.asarray(coords, float)) is not None:
                # serial AUTO would take the lattice coarsener here
                # (structured beams); keep serial parity
                return setup_levels(A, energy, opts, coords=coords)
        if algo not in (CoarsenType.AUTO, CoarsenType.SPW):
            return setup_levels(A, energy, opts, coords=coords)
        from .dist_elast import dist_setup_levels_elast

        return dist_setup_levels_elast(A, energy, opts, n_shards, coords)
    if not isinstance(energy, H1Energy):
        raise ValueError(
            "distributed setup supports H1 and elasticity energies "
            "(other block energies build serially)"
        )
    if bs != 1:
        return _dist_setup_vector(A, energy, opts, n_shards, bs)
    parts, starts = split_rows(A.tocsr().astype(np.float64), n_shards)
    recs, log = _scalar_levels_parts(parts, starts, opts, energy)

    def ph_mesh(n):
        return AlgebraicMesh(nv=n, edges=np.zeros((0, 2), dtype=np.int64))

    # single-controller packaging (the MP parent packages rank parts in
    # parallel/mp_runtime.py instead)
    levels = [
        SetupLevel(
            index=0,
            A=sp.vstack(parts, format="csr"),
            row_bs=1,
            mesh=ph_mesh(int(starts[-1])),
        )
    ]
    for rec in recs:
        levels[-1].P = sp.vstack(rec["P_parts"], format="csr").tobsr(
            blocksize=(1, 1)
        )
        levels[-1].v2agg = np.concatenate(rec["v2agg_parts"])
        levels.append(
            SetupLevel(
                index=len(levels),
                A=sp.vstack(rec["Ac_parts"], format="csr"),
                row_bs=1,
                mesh=ph_mesh(int(rec["coarse_starts"][-1])),
            )
        )
    return levels, log


def _scalar_levels_parts(parts, starts, opts, energy):
    """The scalar-H1 distributed level loop, rank-local.

    Consumes per-shard finest rows (``None`` in slots owned by another
    controller) and returns one record per coarsening step holding the
    owned slots of P / A_c / v2agg plus the replicated coarse_starts —
    rows stay per-shard end to end. Under a single-controller transport
    every slot is owned (exact previous behavior); under
    ``mp_runtime.MPTransport`` each rank owns one slot and all
    cross-shard movement is real message passing.
    """
    tr = get_transport()
    n_shards = len(starts) - 1
    mine = list(tr.my_shards(n_shards))
    lc = opts.levels
    log = FactoryLog()
    n = int(starts[-1])
    log.nvs.append(n)
    log.nnzs.append(
        int(
            tr.allgather(
                np.array([parts[s].nnz for s in mine], dtype=np.int64)
            ).sum()
        )
    )
    W_parts, l2_parts = _finest_wl2(parts, starts)
    log.finest_global_bytes = int(
        tr.allgather(
            np.array(
                [shard_nbytes(parts[s]) for s in mine], dtype=np.int64
            )
        ).sum()
    )

    def _track_peak(*state_parts):
        # resident bytes of the LARGEST owned shard's level-loop state —
        # what one rank of a multi-controller run holds at this point
        per_shard = [
            shard_nbytes(*(sp_[s] for sp_ in state_parts if sp_ is not None))
            for s in mine
        ]
        log.peak_shard_bytes = max(log.peak_shard_bytes, max(per_shard))

    _track_peak(parts, W_parts, l2_parts)
    recs = []
    active = n_shards
    log.shards_per_level.append(active)
    lvl = 0
    while lvl + 1 < lc.max_levels and n > lc.max_coarse_size:
        d_parts = _aux_diag(W_parts, l2_parts)
        v2agg_parts, coarse_starts = _dist_spw_wl2(
            W_parts, l2_parts, starts, opts, lvl
        )
        nc = int(coarse_starts[-1])
        if nc >= lc.min_coarsen_ratio * n or nc == 0:
            break
        # TryContractStep: decide IN the loop whether the coarse level
        # concentrates onto fewer shards (all later routing targets the
        # contracted owners)
        coarse_starts, active = try_contract_starts(
            coarse_starts, n, active, lc, lvl, log
        )
        log.shards_per_level.append(active)
        P_parts = _dist_prol(
            parts, W_parts, d_parts, starts, v2agg_parts, coarse_starts,
            opts, lvl, energy,
        )
        Ac_parts = _dist_rap(parts, starts, P_parts, coarse_starts)
        # owner-local symmetrization (serial rap() parity) — no global
        # matrix is ever materialized in the level loop
        Ac_parts = _dist_symmetrize(Ac_parts, coarse_starts)
        _track_peak(parts, W_parts, l2_parts, P_parts, Ac_parts)
        log.nvs.append(nc)
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
                "P_parts": P_parts,
                "v2agg_parts": v2agg_parts,
                "Ac_parts": Ac_parts,
                "coarse_starts": coarse_starts,
            }
        )
        # next-level sharded state (mesh map_data analog)
        W_parts = _dist_collapse(W_parts, starts, v2agg_parts, coarse_starts)
        all_v2 = np.concatenate([v2agg_parts[s] for s in mine])
        all_l2 = np.concatenate([l2_parts[s] for s in mine])
        m = all_v2 >= 0
        l2_parts = _reduce_by_owner(
            coarse_starts,
            all_v2[m],
            all_l2[m],
            [
                int(coarse_starts[t + 1] - coarse_starts[t])
                for t in range(n_shards)
            ],
        )
        parts = Ac_parts
        starts = coarse_starts
        n = nc
        lvl += 1
    return recs, log
