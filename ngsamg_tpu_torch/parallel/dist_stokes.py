"""Distributed (shard-local) setup for the facet-based Stokes AMG.

Copied from ngsamg_tpu/parallel/dist_stokes.py (numpy and scipy only; it
imports no torch, so the multi-process ranks of parallel/mp_runtime.py
start without it).

Completes the distributed-setup coverage (parallel/dist_setup.py for H1,
parallel/dist_elast.py for elasticity) with the Stokes family: the dual
mesh (vertices = cells, edges = facets) is built from CELL-sharded and
FACET-row-sharded inputs, and every level step computes only on a shard's
owned rows plus halo values fetched through the dist_setup exchange
primitives (`_gather` = indexed all-gather, `_route_coo`/`_reduce*` =
owner-routed reductions). Reference counterparts:

* cell aggregation — the solid/ghost distributed matching of
  src/base/coarsening/spw_agg_impl.hpp:1512-1541, run on
  the flow-magnitude strength graph (`coarsen_cells`);
* coarse mesh map — `BaseAgglomerateCoarseMap::MapVerts/MapEdges`
  (agglomerate_map.cpp) with ReduceTable-style owner-routed reductions of
  volumes/positions/oriented flow sums;
* flow-preserving prolongation — the reference's div-free Stokes
  prolongation (stokes_factory.hpp:20-44): cross-facet rows are computed
  by the facet owners; the per-aggregate spanning-forest interior routing
  is OWNER-COMPUTED (the aggregate's owner gathers its few member cells'
  excess rows + interior facets, routes the resulting P rows back to the
  facet owners) — the reference's master-decides + scatter pattern;
* facet loops — `CalcFacetLoops` with its cross-proc oriented loop
  reduction (stokes_pc.cpp): a DISTRIBUTED spanning forest (shard-local
  BFS forests + a leader-solved quotient tree over the shard components,
  like the reference's rank-0 METIS gather) and batched fundamental-cycle
  climbs with per-round halo gathers of (parent, depth, pedge);
* Galerkin RAP — dist_setup._dist_rap on the facet rows.

Determinism / serial equality: matching, coarse-edge numbering (globally
sorted (lo, hi) keys == shard-major owner blocks), and the prolongation
(the aggregate owner replays the serial spanning-forest routing from
sorted member data) reproduce the serial results bitwise on aggregates
and to fp roundoff on operators. The loop BASIS differs from the serial
one (different global forest) but spans exactly ker(D) — asserted by
tests — which is the property Hiptmair needs.

Scope: scalar normal-flux facet dofs (MAC/RT0-like) and VECTOR (NC/CR)
facet dofs; SPW cell aggregation (the serial lattice fast path is a
structured-grid shortcut — callers on lattices keep the serial setup).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..apps import stokes as st
from ..config import AMGOptions, ProlType
from ..mesh.topo import AlgebraicMesh
from .dist_setup import (
    _dist_symmetrize,
    _dist_spw_core,
    _gather,
    _gather_csr_rows,
    _owner,
    _route_coo,
)

# ---------------------------------------------------------------------------
# sharded dual-mesh state
# ---------------------------------------------------------------------------


def _split(n: int, k: int) -> np.ndarray:
    return np.linspace(0, n, k + 1).astype(np.int64)


def _reduce_nd(starts, idx, vals, shape_tail=()):
    """Owner-routed sum of (idx, vals) rows; per-shard dense arrays
    (``None`` in slots owned by another controller). The caller passes
    only ITS owned shards' contributions; the transport routes them in
    (source rank, source position) order, so the accumulation is
    bitwise-stable across transports."""
    from .transport import get_transport

    tr = get_transport()
    n_shards = len(starts) - 1
    idx = np.asarray(idx, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    routed = tr.route_rows(starts, idx, (idx, vals))
    out = [None] * n_shards
    for t in tr.my_shards(n_shards):
        acc = np.zeros(
            (int(starts[t + 1] - starts[t]),) + shape_tail
        )
        gi, v = routed[t]
        if len(gi):
            np.add.at(acc, gi - starts[t], v)
        out[t] = acc
    return out


def _route_by(starts, key_idx, *arrays):
    """Route parallel row arrays to the owner shard of ``key_idx[i]``
    (per-shard tuples, ``None`` in unowned slots)."""
    from .transport import get_transport

    return get_transport().route_rows(
        starts, np.asarray(key_idx, dtype=np.int64), tuple(arrays)
    )


def _route(dest, n_shards, *arrays):
    """Group parallel row arrays by destination shard — SINGLE-CONTROLLER
    only (used by the HDiv variant, which still runs its per-shard loops
    on one controller over the transport primitives; the scalar/vector
    Stokes loop uses the transport's ``route_rows`` via ``_route_by``)."""
    out = []
    for t in range(n_shards):
        m = dest == t
        out.append(tuple(a[m] for a in arrays))
    return out


class _ShardedDual:
    """Per-shard view of one dual-mesh level.

    Cells partitioned by ``v_starts`` (positions, volumes); facets by
    ``e_starts`` (edge endpoints as global cell ids, oriented flows, and
    the facet-DOF matrix rows).
    """

    def __init__(self, v_starts, e_starts, pos_parts, vol_parts,
                 edges_parts, flow_parts, A_parts):
        self.v_starts = v_starts
        self.e_starts = e_starts
        self.pos_parts = pos_parts
        self.vol_parts = vol_parts
        self.edges_parts = edges_parts
        self.flow_parts = flow_parts
        self.A_parts = A_parts

    @property
    def n_shards(self):
        return len(self.v_starts) - 1

    @property
    def nv(self):
        return int(self.v_starts[-1])

    @property
    def ne(self):
        return int(self.e_starts[-1])

    def assemble_mesh(self) -> AlgebraicMesh:
        mesh = AlgebraicMesh(
            nv=self.nv,
            edges=np.concatenate(self.edges_parts)
            if self.ne
            else np.zeros((0, 2), dtype=np.int64),
        )
        mesh.vertex_data["pos"] = np.concatenate(self.pos_parts)
        mesh.vertex_data["vol"] = np.concatenate(self.vol_parts)
        mesh.edge_data["flow"] = np.concatenate(self.flow_parts)
        return mesh


def _shard_level0(mesh: AlgebraicMesh, A: sp.csr_matrix, bs: int,
                  n_shards: int) -> _ShardedDual:
    v_starts = _split(mesh.nv, n_shards)
    e_starts = _split(mesh.ne, n_shards)
    pos = mesh.vertex_data["pos"]
    vol = mesh.vertex_data["vol"]
    flow = mesh.edge_data["flow"]
    A = A.tocsr().astype(np.float64)
    return _ShardedDual(
        v_starts,
        e_starts,
        [pos[v_starts[s]: v_starts[s + 1]] for s in range(n_shards)],
        [vol[v_starts[s]: v_starts[s + 1]] for s in range(n_shards)],
        [mesh.edges[e_starts[s]: e_starts[s + 1]] for s in range(n_shards)],
        [flow[e_starts[s]: e_starts[s + 1]] for s in range(n_shards)],
        [
            A[e_starts[s] * bs: e_starts[s + 1] * bs]
            for s in range(n_shards)
        ],
    )


# ---------------------------------------------------------------------------
# distributed cell aggregation (serial apps/stokes.coarsen_cells, SPW path)
# ---------------------------------------------------------------------------


def _my(sd_or_n):
    from .transport import get_transport

    n = sd_or_n.n_shards if hasattr(sd_or_n, "n_shards") else int(sd_or_n)
    return list(get_transport().my_shards(n))


def _dist_coarsen_cells(sd: _ShardedDual, theta: float = 0.08):
    """SPW matching on the flow-magnitude cell graph, shard-local rows."""
    n_shards = sd.n_shards
    ri, cj, vv = [], [], []
    for s in _my(sd):
        e = sd.edges_parts[s]
        w = st._flow_mag(sd.flow_parts[s])
        ri.extend([e[:, 0], e[:, 1]])
        cj.extend([e[:, 1], e[:, 0]])
        vv.extend([w, w])
    S_parts = _route_coo(
        sd.v_starts,
        np.concatenate(ri) if ri else np.zeros(0, np.int64),
        np.concatenate(cj) if cj else np.zeros(0, np.int64),
        np.concatenate(vv) if vv else np.zeros(0),
        sd.nv,
    )
    v2agg_parts, c_starts = _dist_spw_core(
        S_parts, sd.v_starts, theta=theta, rounds=2
    )
    # OWNERSHIP rebalance (numbering unchanged): the matcher's shard-major
    # compaction concentrates aggregates on low shards and the skew
    # COMPOUNDS level over level (measured 17x on level-1 state). Coarse
    # ids are global, so an even re-split changes only who holds which
    # rows — all downstream routing targets the balanced owners.
    c_starts = _split(int(c_starts[-1]), sd.n_shards)
    return v2agg_parts, c_starts


# ---------------------------------------------------------------------------
# distributed coarse-mesh map (serial mesh/topo.map_edges +
# apps/stokes.map_stokes_mesh)
# ---------------------------------------------------------------------------


def _dist_map_edges(sd: _ShardedDual, v2agg_parts, c_starts):
    """Coarse edges (shard-major (lo,hi)-sorted == serial numbering) and
    the per-fine-facet (ci, cj, ce) maps.

    Returns (ce_starts, cedges_parts, ci_parts, cj_parts, e2ce_parts).
    """
    from .transport import get_transport

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)
    n_agg = int(c_starts[-1])
    ci_parts = [None] * n_shards
    cj_parts = [None] * n_shards
    key_parts = [None] * n_shards
    for s in mine:
        e = sd.edges_parts[s]
        ci = _gather(v2agg_parts, sd.v_starts, e[:, 0])
        cj = _gather(v2agg_parts, sd.v_starts, e[:, 1])
        ci_parts[s] = ci
        cj_parts[s] = cj
        lo = np.minimum(ci, cj)
        hi = np.maximum(ci, cj)
        cross = (lo != hi) & (lo >= 0)
        key_parts[s] = np.where(
            cross, lo * np.int64(n_agg) + hi, np.int64(-1)
        )
    # route cross keys to the owner of lo (coarse-cell owner): unique
    # per owner == unique of the owner's mask in the single-controller
    # code (sorted either way)
    own_keys = np.concatenate([key_parts[s] for s in mine])
    ak = own_keys[own_keys >= 0]
    routed = tr.route_rows(c_starts, ak // n_agg, (ak,))
    uniq_parts = [None] * n_shards
    for t in mine:
        uniq_parts[t] = np.unique(routed[t][0])
    counts = tr.allgather(
        np.array([len(uniq_parts[t]) for t in mine], dtype=np.int64)
    )
    # the lo-owner blocks give the globally-SORTED numbering (lo ranges
    # ascending across owners => keys ascending across blocks — serial
    # map_edges parity); OWNERSHIP is then re-split evenly, because
    # owner-of-lo is min-biased toward low shards and the skew compounds
    # per level. The lo-owner keeps its sorted key list as the id
    # DICTIONARY; the coarse-edge DATA moves to the balanced owners.
    old_starts = np.zeros(n_shards + 1, dtype=np.int64)
    old_starts[1:] = np.cumsum(counts)
    nce = int(old_starts[-1])
    ce_starts = _split(nce, n_shards)
    ce_l, lo_l, hi_l = [], [], []
    for t in mine:
        u = uniq_parts[t]
        ce_l.append(old_starts[t] + np.arange(len(u), dtype=np.int64))
        lo_l.append(u // n_agg)
        hi_l.append(u % n_agg)
    moved = tr.route_rows(
        ce_starts,
        np.concatenate(ce_l),
        (np.concatenate(ce_l), np.concatenate(lo_l),
         np.concatenate(hi_l)),
    )
    cedges_parts = [None] * n_shards
    for t in mine:
        ids_t, lo_t, hi_t = moved[t]
        # sources are ordered (old owners ascending, ids ascending within
        # each) => ids arrive globally ascending == this range's order
        cedges_parts[t] = (
            np.stack([lo_t, hi_t], axis=1)
            if len(ids_t)
            else np.zeros((0, 2), dtype=np.int64)
        )
    # query-back: fine-facet owner asks owner(lo) for the coarse edge id
    # (two routed phases — request to the key owner, reply to the facet
    # owner — the DCC request/reply shape)
    req_key, req_eg = [], []
    for s in mine:
        key = key_parts[s]
        m = key >= 0
        req_key.append(key[m])
        req_eg.append(
            np.flatnonzero(m).astype(np.int64) + sd.e_starts[s]
        )
    rk = np.concatenate(req_key)
    re = np.concatenate(req_eg)
    got = tr.route_rows(c_starts, rk // n_agg, (rk, re))
    rep_ids, rep_eg = [], []
    for t in mine:
        keys_t, eg_t = got[t]
        rep_ids.append(
            old_starts[t] + np.searchsorted(uniq_parts[t], keys_t)
        )
        rep_eg.append(eg_t)
    back = tr.route_rows(
        sd.e_starts,
        np.concatenate(rep_eg),
        (np.concatenate(rep_eg), np.concatenate(rep_ids)),
    )
    e2ce_parts = [None] * n_shards
    for s in mine:
        key = key_parts[s]
        e2 = np.full(len(key), -1, dtype=np.int64)
        eg_b, ids_b = back[s]
        e2[eg_b - sd.e_starts[s]] = ids_b
        e2ce_parts[s] = e2
    return ce_starts, cedges_parts, ci_parts, cj_parts, e2ce_parts


def _dist_map_mesh(sd: _ShardedDual, v2agg_parts, c_starts, ce_starts,
                   cedges_parts, ci_parts, e2ce_parts):
    """Coarse sharded dual mesh: summed vols/flows, vol-weighted positions."""
    n_shards = sd.n_shards
    mine = _my(sd)
    dim_pos = next(sd.pos_parts[s].shape[1] for s in mine)
    # vertex data: volume sums + vol-weighted positions to coarse owners
    # (owned contributions only — the transport routes them)
    all_v2 = np.concatenate([v2agg_parts[s] for s in mine])
    all_vol = np.concatenate([sd.vol_parts[s] for s in mine])
    all_pos = np.concatenate([sd.pos_parts[s] for s in mine])
    act = all_v2 >= 0
    cvol_parts = _reduce_nd(c_starts, all_v2[act], all_vol[act])
    cpos_parts = _reduce_nd(
        c_starts, all_v2[act], all_pos[act] * all_vol[act, None],
        shape_tail=(dim_pos,),
    )
    for t in mine:
        cpos_parts[t] = cpos_parts[t] / np.maximum(
            cvol_parts[t], 1e-300
        )[:, None]
    # oriented flow sums to coarse-edge owners: sign = +1 where the fine
    # edge's first cell maps to the coarse edge's lo end (== serial
    # map_stokes_mesh since cedges[ce,0] = lo by construction)
    tail = next(sd.flow_parts[s].shape[1:] for s in mine)
    lo_parts = [
        None if c is None else c[:, 0] for c in cedges_parts
    ]
    idx_l, val_l = [], []
    for s in mine:
        e2 = e2ce_parts[s]
        m = e2 >= 0
        # no data-dependent skip: the gather below is a collective every
        # rank joins each iteration (empty requests are fine)
        ci = ci_parts[s][m]
        lo_of = _gather(lo_parts, ce_starts, e2[m])
        sign = np.where(ci == lo_of, 1.0, -1.0)
        fl = sd.flow_parts[s][m]
        idx_l.append(e2[m])
        val_l.append(fl * (sign[:, None] if fl.ndim == 2 else sign))
    cflow_parts = _reduce_nd(
        ce_starts,
        np.concatenate(idx_l) if idx_l else np.zeros(0, np.int64),
        np.concatenate(val_l)
        if val_l
        else np.zeros((0,) + tail),
        shape_tail=tail,
    )
    return _ShardedDual(
        c_starts, ce_starts, cpos_parts, cvol_parts, cedges_parts,
        cflow_parts, A_parts=None,
    )


# ---------------------------------------------------------------------------
# distributed flow-preserving prolongation (serial apps/stokes.
# flow_prolongation / flow_prolongation_vec)
# ---------------------------------------------------------------------------


def _agg_payload(sd, v2agg_parts, c_starts, ci_parts, cj_parts,
                 e2ce_parts):
    """Owner-computed aggregate data: per coarse-cell-owner shard, the
    member cells (with volumes) and interior facets of each owned
    aggregate, sorted for the serial replay."""
    mine = _my(sd)
    # member cells -> aggregate owners (owned cells only; the transport
    # routes them in the single-controller order)
    all_v2 = np.concatenate([v2agg_parts[s] for s in mine])
    cells_g = np.concatenate(
        [
            np.arange(sd.v_starts[s], sd.v_starts[s + 1], dtype=np.int64)
            for s in mine
        ]
    )
    all_vol = np.concatenate([sd.vol_parts[s] for s in mine])
    act = all_v2 >= 0
    mem_parts = _route_by(
        c_starts, all_v2[act], all_v2[act], cells_g[act], all_vol[act]
    )
    # interior facets (ci == cj >= 0) -> aggregate owners
    ie_agg, ie_e, ie_i, ie_j = [], [], [], []
    for s in mine:
        ci, cj = ci_parts[s], cj_parts[s]
        m = (ci == cj) & (ci >= 0)
        e = sd.edges_parts[s][m]
        ie_agg.append(ci[m])
        ie_e.append(np.flatnonzero(m).astype(np.int64) + sd.e_starts[s])
        ie_i.append(e[:, 0])
        ie_j.append(e[:, 1])
    ia = np.concatenate(ie_agg)
    fac_parts = _route_by(
        c_starts, ia, ia, np.concatenate(ie_e),
        np.concatenate(ie_i), np.concatenate(ie_j),
    )
    return mem_parts, fac_parts


def _serial_forest_routing(agg_ids, mem_a, mem_c, ie_e, ie_i, ie_j,
                           exc_rows, route_cb):
    """Replay the serial per-aggregate spanning-forest excess routing.

    ``exc_rows``: dict cell_g -> (cols, vals) sparse excess row. Calls
    ``route_cb(edge_g, sign, cols, vals)`` exactly like the serial loop
    (apps/stokes.flow_prolongation): P-row contributions for interior
    facets in leaves-first order.
    """
    order_f = np.argsort(ie_e, kind="stable")  # increasing global edge id
    adj: dict[int, list] = {}
    for t in order_f:
        i, j, e = int(ie_i[t]), int(ie_j[t]), int(ie_e[t])
        adj.setdefault(i, []).append((j, e))
        adj.setdefault(j, []).append((i, e))
    by_agg: dict[int, list[int]] = {}
    for a, c in zip(mem_a, mem_c):
        by_agg.setdefault(int(a), []).append(int(c))
    for a in agg_ids:
        cells = sorted(by_agg.get(int(a), []))
        if len(cells) <= 1:
            continue
        # serial _spanning_forest restricted to this aggregate: roots in
        # increasing cell order, stack-based traversal, adjacency in
        # increasing edge order
        parent_edge: dict[int, int] = {}
        visited = set()
        order: list[int] = []
        for root in cells:
            if root in visited:
                continue
            visited.add(root)
            stack = [root]
            bfs = [root]
            while stack:
                c = stack.pop()
                for nb, e in adj.get(c, ()):  # same-agg by construction
                    if nb not in visited:
                        visited.add(nb)
                        parent_edge[nb] = e
                        stack.append(nb)
                        bfs.append(nb)
            order.extend(reversed(bfs))
        pos_in_order = {c: t for t, c in enumerate(order)}
        cells_o = sorted(cells, key=lambda c: pos_in_order[c])
        # dense local block over the union of excess columns
        lcols_set = set()
        for c in cells_o:
            cols, _ = exc_rows.get(c, ((), ()))
            lcols_set.update(int(x) for x in cols)
        if not lcols_set:
            continue
        lcols = np.array(sorted(lcols_set), dtype=np.int64)
        colpos = {int(x): t for t, x in enumerate(lcols)}
        loc = np.zeros((len(cells_o), len(lcols)))
        cpos = {c: t for t, c in enumerate(cells_o)}
        for c in cells_o:
            cols, vals = exc_rows.get(c, ((), ()))
            for x, v in zip(cols, vals):
                loc[cpos[c], colpos[int(x)]] += v
        edge_ends = {int(e): (int(i), int(j))
                     for i, j, e in zip(ie_i, ie_j, ie_e)}
        for t, ci_ in enumerate(cells_o):
            e = parent_edge.get(ci_, -1)
            if e < 0:
                continue
            i, j = edge_ends[e]
            other = j if i == ci_ else i
            s_ = 1.0 if i == ci_ else -1.0
            row = loc[t]
            nz = np.flatnonzero(row)
            if len(nz):
                route_cb(e, s_, lcols[nz], row[nz])
            loc[cpos[other]] += row
            loc[t] = 0.0


def _dist_flow_prol(sd, csd, v2agg_parts, ci_parts, cj_parts,
                    e2ce_parts):
    """Scalar facet prolongation, distributed (serial flow_prolongation)."""
    n_shards = sd.n_shards
    mine = _my(sd)
    ne_c = csd.ne
    c_starts, ce_starts = csd.v_starts, csd.e_starts

    # cross-facet coefficients: wsum per coarse edge, gathered back
    idx_l, val_l = [], []
    for s in mine:
        e2 = e2ce_parts[s]
        m = e2 >= 0
        idx_l.append(e2[m])
        val_l.append(np.abs(sd.flow_parts[s][m]))
    wsum_parts = _reduce_nd(
        ce_starts, np.concatenate(idx_l), np.concatenate(val_l)
    )
    lo_parts = [None if c is None else c[:, 0] for c in csd.edges_parts]
    cross_rows = [None] * n_shards  # (local rows, ce, coef signed)
    for s in mine:
        e2 = e2ce_parts[s]
        m = np.flatnonzero(e2 >= 0)
        ce = e2[m]
        ws = _gather(wsum_parts, ce_starts, ce)
        lo_of = _gather(lo_parts, ce_starts, ce)
        sgn = np.where(ci_parts[s][m] == lo_of, 1.0, -1.0)
        wcoef = np.abs(sd.flow_parts[s][m]) / np.maximum(ws, 1e-300)
        cross_rows[s] = (m, ce, sgn * wcoef)

    # per-cell boundary influx Bin rows (routed to CELL owners): fine
    # cross facet e=(i,j): +v at (i, ce), -v at (j, ce)
    ri, cj, vv = [], [], []
    for s in mine:
        m, ce, v = cross_rows[s]
        e = sd.edges_parts[s][m]
        ri.extend([e[:, 0], e[:, 1]])
        cj.extend([ce, ce])
        vv.extend([v, -v])
    Bin_parts = _route_coo(
        sd.v_starts,
        np.concatenate(ri),
        np.concatenate(cj),
        np.concatenate(vv),
        ne_c,
    )
    # coarse incidence rows Cout (coarse-cell-owner shards): +-1 columns
    ri2, cj2, vv2 = [], [], []
    for t in mine:
        ce_g = np.arange(
            ce_starts[t], ce_starts[t + 1], dtype=np.int64
        )
        E = csd.edges_parts[t]
        ri2.extend([E[:, 0], E[:, 1]])
        cj2.extend([ce_g, ce_g])
        vv2.extend([np.ones(len(E)), -np.ones(len(E))])
    Cout_parts = _route_coo(
        c_starts,
        np.concatenate(ri2),
        np.concatenate(cj2),
        np.concatenate(vv2),
        ne_c,
    )
    # per-cell target rows: frac_i * Cout[v2agg[i]]; Excess = Tgt - Bin
    exc_parts = [None] * n_shards
    for s in mine:
        v2 = v2agg_parts[s]
        aggvol = _gather(csd.vol_parts, c_starts, np.maximum(v2, 0))
        frac = sd.vol_parts[s] / np.maximum(aggvol, 1e-300)
        Crows = _gather_csr_rows(
            Cout_parts, c_starts, np.maximum(v2, 0), ne_c
        )
        Tgt = sp.diags(np.where(v2 >= 0, frac, 0.0)) @ Crows
        exc_parts[s] = (Tgt - Bin_parts[s]).tocsr()

    # owner-computed interior routing
    mem_parts, fac_parts = _agg_payload(
        sd, v2agg_parts, c_starts, ci_parts, cj_parts, e2ce_parts
    )
    # excess rows shipped to aggregate owners alongside members
    tri_e, tri_c, tri_v = [], [], []
    for t in mine:
        mem_a, mem_c, _mem_vol = mem_parts[t]
        ie_a, ie_e, ie_i, ie_j = fac_parts[t]
        # gather member excess rows from cell owners
        Exc = _gather_csr_rows(exc_parts, sd.v_starts, mem_c, ne_c)
        exc_rows = {}
        for k, c in enumerate(mem_c):
            r = Exc[k]
            exc_rows[int(c)] = (r.indices.astype(np.int64), r.data)
        agg_ids = np.arange(c_starts[t], c_starts[t + 1], dtype=np.int64)

        def cb(edge_g, s_, cols, vals, _te=tri_e, _tc=tri_c, _tv=tri_v):
            _te.append(np.full(len(cols), edge_g, dtype=np.int64))
            _tc.append(cols)
            _tv.append(s_ * vals)

        _serial_forest_routing(
            agg_ids, mem_a, mem_c, ie_e, ie_i, ie_j, exc_rows, cb
        )
    # P assembly per facet owner: cross rows + routed interior triples
    ri3, cj3, vv3 = [], [], []
    for s in mine:
        m, ce, v = cross_rows[s]
        ri3.append(m + sd.e_starts[s])
        cj3.append(ce)
        vv3.append(v)
    if tri_e:
        ri3.append(np.concatenate(tri_e))
        cj3.append(np.concatenate(tri_c))
        vv3.append(np.concatenate(tri_v))
    P_parts = _route_coo(
        sd.e_starts,
        np.concatenate(ri3),
        np.concatenate(cj3),
        np.concatenate(vv3),
        ne_c,
    )
    # incidence -> velocity units (serial conjugation): row scale 1/flow_f
    # (local), column scale flow_c (gathered from coarse-facet owners —
    # a collective every rank joins, so no empty-cols skip)
    out = [None] * n_shards
    for s in mine:
        fl = sd.flow_parts[s]
        gf = np.where(
            np.abs(fl) > 1e-300, 1.0 / np.where(fl == 0, 1.0, fl), 1.0
        )
        P = sp.diags(gf) @ P_parts[s]
        cols = (
            np.unique(P.indices.astype(np.int64))
            if P.nnz
            else np.zeros(0, np.int64)
        )
        cf = _gather(csd.flow_parts, ce_starts, cols)
        gc_all = np.ones(ne_c)
        if len(cols):
            gc_all[cols] = np.where(np.abs(cf) > 1e-300, cf, 1.0)
            P = (P @ sp.diags(gc_all)).tocsr()
        out[s] = P.tocsr()
    return out


def _dist_flow_prol_vec(sd, csd, v2agg_parts, ci_parts, cj_parts,
                        e2ce_parts):
    """VECTOR facet prolongation, distributed (flow_prolongation_vec)."""
    n_shards = sd.n_shards
    mine = _my(sd)
    ne_c = csd.ne
    dim = next(sd.flow_parts[s].shape[1] for s in mine)
    c_starts, ce_starts = csd.v_starts, csd.e_starts
    k = np.arange(dim)

    # cross facets copy the coarse vector (identity blocks)
    ri, cj, vv = [], [], []
    for s in mine:
        e2 = e2ce_parts[s]
        m = np.flatnonzero(e2 >= 0)
        ce = e2[m]
        fe_g = m + sd.e_starts[s]
        ri.append((fe_g[:, None] * dim + k).ravel())
        cj.append((ce[:, None] * dim + k).ravel())
        vv.append(np.ones(len(m) * dim))

    # interior base: |cflow|-weighted average of the aggregate's incident
    # coarse vectors. Wavg rows live on coarse-CELL owners.
    ri2, cj2, vv2 = [], [], []
    for t in mine:
        E = csd.edges_parts[t]
        wE = np.linalg.norm(csd.flow_parts[t], axis=1)
        ce_g = np.arange(ce_starts[t], ce_starts[t + 1], dtype=np.int64)
        ri2.extend([E[:, 0], E[:, 1]])
        cj2.extend([ce_g, ce_g])
        vv2.extend([wE, wE])
    AggInc_parts = _route_coo(
        c_starts,
        np.concatenate(ri2),
        np.concatenate(cj2),
        np.concatenate(vv2),
        ne_c,
    )
    Wavg_parts = [None] * n_shards
    for t in mine:
        M = AggInc_parts[t]
        wsum = np.asarray(M.sum(axis=1)).ravel()
        Wavg_parts[t] = (
            sp.diags(1.0 / np.maximum(wsum, 1e-300)) @ M
        ).tocsr()
    for s in mine:
        e2 = e2ce_parts[s]
        ci = ci_parts[s]
        m = np.flatnonzero((e2 < 0) & (ci >= 0) & (ci == cj_parts[s]))
        # unconditional: the row gather is a collective every rank joins
        rows_g = m + sd.e_starts[s]
        B = _gather_csr_rows(Wavg_parts, c_starts, ci[m], ne_c).tocoo()
        ri.append((rows_g[B.row][:, None] * dim + k).ravel())
        cj.append((B.col[:, None] * dim + k).ravel())
        vv.append(np.repeat(B.data, dim))
    P0_parts = _route_coo(
        sd.e_starts * dim,
        np.concatenate(ri),
        np.concatenate(cj),
        np.concatenate(vv),
        ne_c * dim,
    )

    # per-cell flux imbalance Excess = diag(frac) Cout[v2agg] - Df P0
    # Df rows (cells x fine vector dofs): +-flow components
    ri3, cj3, vv3 = [], [], []
    for s in mine:
        e = sd.edges_parts[s]
        fl = sd.flow_parts[s]
        dof_g = (
            (np.arange(len(e), dtype=np.int64) + sd.e_starts[s])[:, None]
            * dim + k
        ).ravel()
        ri3.extend([np.repeat(e[:, 0], dim), np.repeat(e[:, 1], dim)])
        cj3.extend([dof_g, dof_g])
        vv3.extend([fl.ravel(), -fl.ravel()])
    Df_parts = _route_coo(
        sd.v_starts,
        np.concatenate(ri3),
        np.concatenate(cj3),
        np.concatenate(vv3),
        sd.ne * dim,
    )
    # Cout rows (coarse cells x coarse vector dofs): +-cflow components
    ri4, cj4, vv4 = [], [], []
    for t in mine:
        E = csd.edges_parts[t]
        cf = csd.flow_parts[t]
        ce_g = (
            (np.arange(len(E), dtype=np.int64) + ce_starts[t])[:, None]
            * dim + k
        ).ravel()
        ri4.extend([np.repeat(E[:, 0], dim), np.repeat(E[:, 1], dim)])
        cj4.extend([ce_g, ce_g])
        vv4.extend([cf.ravel(), -cf.ravel()])
    Cout_parts = _route_coo(
        c_starts,
        np.concatenate(ri4),
        np.concatenate(cj4),
        np.concatenate(vv4),
        ne_c * dim,
    )
    exc_parts = [None] * n_shards
    for s in mine:
        v2 = v2agg_parts[s]
        aggvol = _gather(csd.vol_parts, c_starts, np.maximum(v2, 0))
        frac = sd.vol_parts[s] / np.maximum(aggvol, 1e-300)
        Crows = _gather_csr_rows(
            Cout_parts, c_starts, np.maximum(v2, 0), ne_c * dim
        )
        Tgt = sp.diags(np.where(v2 >= 0, frac, 0.0)) @ Crows
        # Df P0 on owned cells: gather halo P0 rows at Df's columns
        Df = Df_parts[s]
        cols = (
            np.unique(Df.indices.astype(np.int64))
            if Df.nnz
            else np.zeros(0, np.int64)
        )
        P0_halo = _gather_csr_rows(
            P0_parts, sd.e_starts * dim, cols, ne_c * dim
        )
        colmap = np.searchsorted(cols, Df.indices)
        Dfc = sp.csr_matrix(
            (Df.data, colmap, Df.indptr), shape=(Df.shape[0], len(cols))
        )
        exc_parts[s] = (Tgt - Dfc @ P0_halo).tocsr()

    # owner-computed interior routing with normal-direction corrections
    mem_parts, fac_parts = _agg_payload(
        sd, v2agg_parts, c_starts, ci_parts, cj_parts, e2ce_parts
    )
    tri_e, tri_c, tri_v = [], [], []
    for t in mine:
        mem_a, mem_c, _mv = mem_parts[t]
        ie_a, ie_e, ie_i, ie_j = fac_parts[t]
        Exc = _gather_csr_rows(
            exc_parts, sd.v_starts, mem_c, ne_c * dim
        )
        exc_rows = {}
        for q, c in enumerate(mem_c):
            r = Exc[q]
            exc_rows[int(c)] = (r.indices.astype(np.int64), r.data)
        # per-facet flow vectors of the aggregate's interior facets
        fl_int = _gather(sd.flow_parts, sd.e_starts, ie_e)
        f2 = {int(e): float((f * f).sum())
              for e, f in zip(ie_e, fl_int)}
        fvec = {int(e): f for e, f in zip(ie_e, fl_int)}
        agg_ids = np.arange(c_starts[t], c_starts[t + 1], dtype=np.int64)

        def cb(edge_g, s_, cols, vals, _te=tri_e, _tc=tri_c, _tv=tri_v,
               _f2=f2, _fv=fvec):
            if _f2[edge_g] <= 1e-300:
                return
            coef = s_ / _f2[edge_g]
            fv = _fv[edge_g]
            for kk in range(len(fv)):
                _te.append(
                    np.full(len(cols), edge_g * len(fv) + kk,
                            dtype=np.int64)
                )
                _tc.append(cols)
                _tv.append(coef * fv[kk] * vals)

        _serial_forest_routing(
            agg_ids, mem_a, mem_c, ie_e, ie_i, ie_j, exc_rows, cb
        )
    # the route is a collective: every rank calls it, with or without
    # interior triples of its own
    z = np.zeros(0, dtype=np.int64)
    dP_parts = _route_coo(
        sd.e_starts * dim,
        np.concatenate(tri_e) if tri_e else z,
        np.concatenate(tri_c) if tri_c else z,
        np.concatenate(tri_v) if tri_v else np.zeros(0),
        ne_c * dim,
    )
    out = [None] * n_shards
    for s in mine:
        out[s] = (P0_parts[s] + dP_parts[s]).tocsr()
    return out


# ---------------------------------------------------------------------------
# distributed facet loops (serial apps/stokes.build_loops[_vec] analog)
# ---------------------------------------------------------------------------


def _local_bfs_forest(nv_local, v0, intra):
    """Deterministic BFS forest over a shard's intra edges.

    ``intra`` = (i_l, j_l, e_g) sorted by e_g. Returns (parent_g, pedge,
    depth, comp, roots): parent as GLOBAL cell id (-1 at roots), pedge the
    global facet id used, comp the local component index.
    """
    from collections import deque

    i_l, j_l, e_g = intra
    adj: list[list] = [[] for _ in range(nv_local)]
    for i, j, e in zip(i_l, j_l, e_g):
        adj[int(i)].append((int(j), int(e)))
        adj[int(j)].append((int(i), int(e)))
    parent = np.full(nv_local, -1, dtype=np.int64)
    pedge = np.full(nv_local, -1, dtype=np.int64)
    depth = np.zeros(nv_local, dtype=np.int64)
    comp = np.full(nv_local, -1, dtype=np.int64)
    roots = []
    nc = 0
    for root in range(nv_local):
        if comp[root] >= 0:
            continue
        comp[root] = nc
        roots.append(root)
        q = deque([root])
        while q:
            c = q.popleft()
            for nb, e in adj[c]:
                if comp[nb] < 0:
                    comp[nb] = nc
                    parent[nb] = c + v0
                    pedge[nb] = e
                    depth[nb] = depth[c] + 1
                    q.append(nb)
        nc += 1
    return parent, pedge, depth, comp, np.asarray(roots, dtype=np.int64), nc


def _dist_forest(sd: _ShardedDual, act_parts=None):
    """Global spanning forest over the ACTIVE dual graph, sharded state.

    Shard-local BFS forests + a leader-solved quotient spanning tree over
    the components (the reference gathers the processor graph to rank 0
    the same way, grid_contract.cpp:84-98). Returns per-cell-shard
    (parent_g, pedge, depth_global) and per-edge-shard intree masks.
    ``act_parts`` masks the facets allowed in the forest (flux-free
    facets stay out of the cycle graph entirely).
    """
    from .transport import get_transport

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)
    # route intra edges to cell shards; keep cross edges
    intra_i, intra_j, intra_e = [], [], []
    cross_i, cross_j, cross_e = [], [], []
    for s in mine:
        e = sd.edges_parts[s]
        e_g = np.arange(len(e), dtype=np.int64) + sd.e_starts[s]
        if act_parts is not None:
            e = e[act_parts[s]]
            e_g = e_g[act_parts[s]]
        oi = _owner(sd.v_starts, e[:, 0])
        oj = _owner(sd.v_starts, e[:, 1])
        m = oi == oj
        intra_i.append(e[m, 0])
        intra_j.append(e[m, 1])
        intra_e.append(e_g[m])
        cross_i.append(e[~m, 0])
        cross_j.append(e[~m, 1])
        cross_e.append(e_g[~m])
    z = np.zeros(0, dtype=np.int64)
    intra_parts = _route_by(
        sd.v_starts,
        np.concatenate(intra_i) if intra_i else z,
        np.concatenate(intra_i) if intra_i else z,
        np.concatenate(intra_j) if intra_j else z,
        np.concatenate(intra_e) if intra_e else z,
    )
    parent_parts = [None] * n_shards
    pedge_parts = [None] * n_shards
    depth_parts = [None] * n_shards
    comp_parts = [None] * n_shards
    ncomp_mine, tree_edges = [], []
    for s in mine:
        i_l, j_l, e_g = intra_parts[s]
        o = np.argsort(e_g, kind="stable")
        v0 = int(sd.v_starts[s])
        nvl = int(sd.v_starts[s + 1] - v0)
        p, pe, d, c, r, nc = _local_bfs_forest(
            nvl, v0, (i_l[o] - v0, j_l[o] - v0, e_g[o])
        )
        parent_parts[s] = p
        pedge_parts[s] = pe
        depth_parts[s] = d
        comp_parts[s] = c
        ncomp_mine.append(nc)
        tree_edges.append(pe[pe >= 0])
    ncomp = tr.allgather(np.asarray(ncomp_mine, dtype=np.int64))
    comp_starts = np.zeros(n_shards + 1, dtype=np.int64)
    comp_starts[1:] = np.cumsum(ncomp)
    compg_parts = [
        None if c is None else np.where(c >= 0, c + comp_starts[s], -1)
        for s, c in enumerate(comp_parts)
    ]

    # quotient spanning tree over the cross edges: the cross lists are
    # interface-sized, so they replicate to every rank (the reference
    # gathers the processor graph to rank 0 the same way) and every rank
    # solves the same deterministic quotient BFS
    ci = tr.allgather(np.concatenate(cross_i) if cross_i else z)
    cj = tr.allgather(np.concatenate(cross_j) if cross_j else z)
    ce = tr.allgather(np.concatenate(cross_e) if cross_e else z)
    qi = _gather(compg_parts, sd.v_starts, ci) if len(ci) else z
    qj = _gather(compg_parts, sd.v_starts, cj) if len(cj) else z
    o = np.argsort(ce, kind="stable")
    qi, qj, ci, cj, ce = qi[o], qj[o], ci[o], cj[o], ce[o]
    ncq = int(comp_starts[-1])
    from collections import deque

    qadj: list[list] = [[] for _ in range(ncq)]
    for t in range(len(ce)):
        qadj[int(qi[t])].append((int(qj[t]), t))
        qadj[int(qj[t])].append((int(qi[t]), t))
    q_parent = np.full(ncq, -1, dtype=np.int64)
    q_link = np.full(ncq, -1, dtype=np.int64)  # cross-edge slot used
    q_order = []
    seen = np.zeros(ncq, dtype=bool)
    for root in range(ncq):
        if seen[root]:
            continue
        seen[root] = True
        q_order.append(root)
        q = deque([root])
        while q:
            c = q.popleft()
            for nb, t in qadj[c]:
                if not seen[nb]:
                    seen[nb] = True
                    q_parent[nb] = c
                    q_link[nb] = t
                    q_order.append(nb)
                    q.append(nb)
    link_slots = q_link[q_link >= 0]
    link_set = set(int(ce[t]) for t in link_slots)

    # re-root linked components at their attach cells (shard-local flips)
    # attach cell w_c: the link edge endpoint inside comp c
    attach_cell = np.full(ncq, -1, dtype=np.int64)  # global cell id
    attach_parent = np.full(ncq, -1, dtype=np.int64)  # cell in parent comp
    attach_edge = np.full(ncq, -1, dtype=np.int64)
    for c in range(ncq):
        t = q_link[c]
        if t < 0:
            continue
        # endpoints: which one lies in comp c?
        if int(qi[t]) == c:
            attach_cell[c], attach_parent[c] = int(ci[t]), int(cj[t])
        else:
            attach_cell[c], attach_parent[c] = int(cj[t]), int(ci[t])
        attach_edge[c] = int(ce[t])
    for s in mine:
        p, pe = parent_parts[s], pedge_parts[s]
        v0 = int(sd.v_starts[s])
        for c in range(int(comp_starts[s]), int(comp_starts[s + 1])):
            w = attach_cell[c]
            if w < 0:
                continue
            # flip parents along w -> old root
            chain = []
            x = int(w)
            while True:
                par = int(p[x - v0])
                chain.append((x, par, int(pe[x - v0])))
                if par < 0:
                    break
                x = par
            for (a, b, e) in chain:
                if b < 0:
                    break
                p[b - v0] = a
                pe[b - v0] = e
            p[w - v0] = attach_parent[c]
            pe[w - v0] = attach_edge[c]
        # recompute local depths from comp roots (post re-root)
        d = depth_parts[s]
        d[:] = 0
        kids: dict[int, list[int]] = {}
        root_cells = []
        for x in range(len(p)):
            par = int(p[x])
            if par >= v0 and par < int(sd.v_starts[s + 1]):
                kids.setdefault(par - v0, []).append(x)
            else:
                root_cells.append(x)  # global root or attach cell
        q = deque(root_cells)
        while q:
            x = q.popleft()
            for y in kids.get(x, ()):
                d[y] = d[x] + 1
                q.append(y)
    # comp depth offsets down the quotient tree (leader), then scatter
    offs = np.zeros(ncq, dtype=np.int64)
    # local depth of each attach-parent cell
    ap = attach_parent[attach_parent >= 0]
    ap_d = (
        _gather(depth_parts, sd.v_starts, ap)
        if len(ap)
        else z
    )
    ap_depth = np.zeros(ncq, dtype=np.int64)
    ap_depth[attach_parent >= 0] = ap_d
    ap_comp = np.zeros(ncq, dtype=np.int64)
    if (attach_parent >= 0).any():
        ap_comp[attach_parent >= 0] = _gather(
            compg_parts, sd.v_starts, ap
        )
    for c in q_order:  # parents precede children
        if q_parent[c] >= 0:
            offs[c] = offs[int(ap_comp[c])] + int(ap_depth[c]) + 1
    for s in mine:
        cg = compg_parts[s]
        depth_parts[s] = depth_parts[s] + np.where(cg >= 0, offs[cg], 0)

    # intree marks routed to the edge owners (the link edges are
    # replicated, so every rank submits them — marking is idempotent)
    used = np.concatenate(
        [np.concatenate(tree_edges) if tree_edges else z,
         np.asarray(sorted(link_set), dtype=np.int64)]
    )
    routed_used = _route_by(sd.e_starts, used, used)
    intree_parts = [None] * n_shards
    for s in mine:
        m = np.zeros(int(sd.e_starts[s + 1] - sd.e_starts[s]), dtype=bool)
        m[routed_used[s][0] - sd.e_starts[s]] = True
        intree_parts[s] = m
    return parent_parts, pedge_parts, depth_parts, intree_parts


def _dist_cycles(sd: _ShardedDual, parent_parts, pedge_parts,
                 depth_parts, intree_parts, act_parts=None):
    """Fundamental-cycle rows via batched climbs with per-round gathers.

    Returns (C_parts incidence CSR per facet shard, n_loops). Loop
    columns are shard-major over the owning (active, non-tree) facets.
    """
    from .transport import get_transport

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)

    def nontree(s):
        m = ~intree_parts[s]
        if act_parts is not None:
            m = m & act_parts[s]
        return m

    # loop numbering: shard-major over active non-tree owned edges
    nt_counts = tr.allgather(
        np.array([int(nontree(s).sum()) for s in mine], dtype=np.int64)
    )
    loop_starts = np.zeros(n_shards + 1, dtype=np.int64)
    loop_starts[1:] = np.cumsum(nt_counts)
    n_loops = int(loop_starts[-1])
    if n_loops == 0:
        return None, 0
    # each rank climbs ITS loops; rounds are transport-synchronized (the
    # per-round gathers are collectives every rank joins, empty or not)
    loops_e, loops_a, loops_b, loops_id = [], [], [], []
    for s in mine:
        nt = np.flatnonzero(nontree(s))
        e = sd.edges_parts[s][nt]
        loops_e.append(nt + sd.e_starts[s])
        loops_a.append(e[:, 0])
        loops_b.append(e[:, 1])
        loops_id.append(loop_starts[s] + np.arange(len(nt)))
    E = np.concatenate(loops_e)
    A_ = np.concatenate(loops_a)
    B_ = np.concatenate(loops_b)
    LID = np.concatenate(loops_id)
    tri_r, tri_c, tri_v = [E], [LID], [np.ones(len(E))]

    U = B_.copy()
    V = A_.copy()
    active = np.ones(len(E), dtype=bool)
    guard = 0
    while tr.allreduce_any(bool(active.any())):
        guard += 1
        if guard > 4 * sd.nv + 8:
            raise RuntimeError("forest climb did not terminate")
        idx = np.flatnonzero(active)
        dU = _gather(depth_parts, sd.v_starts, U[idx])
        dV = _gather(depth_parts, sd.v_starts, V[idx])
        done = U[idx] == V[idx]
        active[idx[done]] = False
        idx = idx[~done]
        dU, dV = dU[~done], dV[~done]
        climb_u = dU >= dV
        # climb U where climb_u, else V (one side per round, serial rule)
        for side, mask in (("u", climb_u), ("v", ~climb_u)):
            ii = idx[mask]
            X = U if side == "u" else V
            ed = _gather(pedge_parts, sd.v_starts, X[ii])
            assert (ed >= 0).all(), "climbed past a root"
            ends = _gather(sd.edges_parts, sd.e_starts, ed)
            sgn = np.where(ends[:, 0] == X[ii], 1.0, -1.0)
            tri_r.append(ed)
            tri_c.append(LID[ii])
            tri_v.append(sgn if side == "u" else -sgn)
            par = _gather(parent_parts, sd.v_starts, X[ii])
            X[ii] = par
    C_parts = _route_coo(
        sd.e_starts,
        np.concatenate(tri_r),
        np.concatenate(tri_c),
        np.concatenate(tri_v),
        n_loops,
    )
    # drop cancelled entries like the serial coefficient dict
    out = [None] * n_shards
    for s in mine:
        M = C_parts[s].copy()
        M.eliminate_zeros()
        out[s] = M
    return out, n_loops


def _dist_loops(sd: _ShardedDual, bs: int):
    """Per-facet-shard curl-matrix rows (scalar or vector dofs).

    Returns (C_parts, l_starts): CSR rows over the shard's owned facet
    dofs with GLOBAL loop columns, and the contiguous loop-ownership
    partition (cycle loops shard-major by owning non-tree facet, plus —
    for vector dofs — each shard's (dim-1) tangential columns per owned
    facet). The incidence cycles come from the distributed forest; the
    scalar flow lift / vector normal-lift + tangential columns are purely
    local per owned facet (serial build_loops_tree / build_loops_vec).
    """
    from .transport import get_transport

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)
    # facets whose (coarse oriented-sum) flow cancelled to zero carry no
    # flux for any dof value: excluded from the cycle graph, each spans
    # its own flux-free kernel direction(s) — serial build_loops_tree /
    # build_loops_vec semantics
    if bs == 1:
        act_parts = [
            None if fl is None else np.abs(fl) > 1e-300
            for fl in sd.flow_parts
        ]
    else:
        act_parts = [
            None if fl is None else (fl * fl).sum(axis=1) > 1e-300
            for fl in sd.flow_parts
        ]
    parent_p, pedge_p, depth_p, intree_p = _dist_forest(sd, act_parts)
    Ci_parts, n_cyc = _dist_cycles(
        sd, parent_p, pedge_p, depth_p, intree_p, act_parts
    )
    nt_counts = tr.allgather(
        np.array(
            [int(((~intree_p[s]) & act_parts[s]).sum()) for s in mine],
            dtype=np.int64,
        )
    )
    old_starts = np.zeros(n_shards + 1, dtype=np.int64)
    old_starts[1:] = np.cumsum(nt_counts)
    dead_counts = tr.allgather(
        np.array([int((~act_parts[s]).sum()) for s in mine],
                 dtype=np.int64)
    )
    act_counts = np.diff(sd.e_starts) - dead_counts
    if bs == 1:
        own_counts = nt_counts + dead_counts
    else:
        own_counts = (
            nt_counts + (bs - 1) * act_counts + bs * dead_counts
        )
    l_starts = np.zeros(n_shards + 1, dtype=np.int64)
    l_starts[1:] = np.cumsum(own_counts)
    if int(l_starts[-1]) == 0:
        return None, None
    # cycle-loop id (shard-major by nt_counts) -> interleaved numbering
    remap = np.zeros(max(int(old_starts[-1]), 1), dtype=np.int64)
    for s in range(n_shards):
        remap[old_starts[s]: old_starts[s + 1]] = l_starts[s] + np.arange(
            nt_counts[s]
        )
    nl_total = int(l_starts[-1])
    out = [None] * n_shards
    if bs == 1:
        for s in mine:
            fl = sd.flow_parts[s]
            ne_l = len(fl)
            rows_l, cols_l, vals_l = [], [], []
            if Ci_parts is not None and Ci_parts[s].nnz:
                Cc = Ci_parts[s].tocoo()
                g = np.where(
                    np.abs(fl) > 1e-300,
                    1.0 / np.where(fl == 0, 1.0, fl),
                    1.0,
                )
                rows_l.append(Cc.row.astype(np.int64))
                cols_l.append(remap[Cc.col])
                vals_l.append(Cc.data * g[Cc.row])
            dead = np.flatnonzero(~act_parts[s])
            if len(dead):
                rows_l.append(dead)
                cols_l.append(
                    l_starts[s] + nt_counts[s] + np.arange(len(dead))
                )
                vals_l.append(np.ones(len(dead)))
            if not rows_l:
                out[s] = sp.csr_matrix((ne_l, nl_total))
                continue
            out[s] = sp.coo_matrix(
                (
                    np.concatenate(vals_l),
                    (np.concatenate(rows_l), np.concatenate(cols_l)),
                ),
                shape=(ne_l, nl_total),
            ).tocsr()
        return out, l_starts
    # vector dofs: normal lifts of the incidence cycles + per-ACTIVE-facet
    # tangential columns + per-dead-facet standard basis columns, numbered
    # CONTIGUOUSLY per owner shard
    dim = bs
    k = np.arange(dim)
    for s in mine:
        rows_l, cols_l, vals_l = [], [], []
        fl = sd.flow_parts[s]
        ne_l = len(fl)
        act = act_parts[s]
        if Ci_parts is not None and Ci_parts[s].nnz:
            Cc = Ci_parts[s].tocoo()
            f2 = (fl * fl).sum(axis=1)
            g = fl / np.maximum(f2, 1e-300)[:, None]
            rows_l.append(((Cc.row[:, None]) * dim + k).ravel())
            cols_l.append(np.repeat(remap[Cc.col], dim))
            vals_l.append((Cc.data[:, None] * g[Cc.row]).ravel())
        act_e = np.flatnonzero(act)
        if len(act_e):
            f2 = (fl * fl).sum(axis=1)
            nrm = np.sqrt(np.maximum(f2, 1e-300))
            n_unit = fl / nrm[:, None]
            if dim == 2:
                tangents = [
                    np.stack([-n_unit[:, 1], n_unit[:, 0]], axis=1)
                ]
            else:
                a = np.zeros_like(n_unit)
                small = np.argmin(np.abs(n_unit), axis=1)
                a[np.arange(ne_l), small] = 1.0
                t1 = a - (a * n_unit).sum(axis=1)[:, None] * n_unit
                t1 /= np.maximum(
                    np.linalg.norm(t1, axis=1), 1e-300
                )[:, None]
                t2 = np.cross(n_unit, t1)
                tangents = [t1, t2]
            base = l_starts[s] + nt_counts[s]
            for ti, t_vec in enumerate(tangents):
                rows_l.append((act_e[:, None] * dim + k).ravel())
                cols_l.append(
                    np.repeat(
                        base + ti * len(act_e) + np.arange(len(act_e)),
                        dim,
                    )
                )
                vals_l.append(t_vec[act_e].ravel())
        dead = np.flatnonzero(~act)
        if len(dead):
            base = l_starts[s] + nt_counts[s] + (dim - 1) * len(act_e)
            rows_l.append((dead[:, None] * dim + k).ravel())
            cols_l.append(base + np.arange(len(dead) * dim))
            vals_l.append(np.ones(len(dead) * dim))
        if not rows_l:
            out[s] = sp.csr_matrix((ne_l * dim, nl_total))
            continue
        out[s] = sp.coo_matrix(
            (
                np.concatenate(vals_l),
                (np.concatenate(rows_l), np.concatenate(cols_l)),
            ),
            shape=(ne_l * dim, nl_total),
        ).tocsr()
    return out, l_starts


# ---------------------------------------------------------------------------
# distributed curl-space prolongation smoothing (precond/stokes.
# _curl_smooth_prol) and the level loop
# ---------------------------------------------------------------------------


def _csr_cols_compress(M: sp.csr_matrix):
    """(columns present, column-compressed copy) of a CSR block."""
    cols = (
        np.unique(M.indices.astype(np.int64))
        if M.nnz
        else np.zeros(0, np.int64)
    )
    colmap = np.searchsorted(cols, M.indices)
    return cols, sp.csr_matrix(
        (M.data, colmap, M.indptr), shape=(M.shape[0], len(cols))
    )


def _dist_spmm_rows(A_parts, row_starts, B_parts, b_starts, ncols_b):
    """Per-shard (A @ B) rows: gather halo B rows at A's columns."""
    n_shards = len(A_parts)
    out = [None] * n_shards
    for s in _my(n_shards):
        A_s = A_parts[s].tocsr()
        cols, Ac = _csr_cols_compress(A_s)
        B_halo = _gather_csr_rows(B_parts, b_starts, cols, ncols_b)
        out[s] = (Ac @ B_halo).tocsr()
    return out


def _dist_ATB_rows(A_parts, row_starts, B_parts, a_cols_starts, ncols_b):
    """Owner-routed A^T @ B: per-shard partials reduced to A-column owners.

    ``A_parts``/``B_parts`` share the row partition ``row_starts``; the
    result rows follow ``a_cols_starts`` (the ownership of A's columns).
    """
    ri, cj, vv = [], [], []
    for s in _my(len(A_parts)):
        M = (A_parts[s].T.tocsr() @ B_parts[s]).tocoo()
        if M.nnz:
            ri.append(M.row.astype(np.int64))
            cj.append(M.col.astype(np.int64))
            vv.append(M.data)
    z = np.zeros(0, dtype=np.int64)
    return _route_coo(
        a_cols_starts,
        np.concatenate(ri) if ri else z,
        np.concatenate(cj) if cj else z,
        np.concatenate(vv) if vv else np.zeros(0),
        ncols_b,
    )


def _dist_curl_smooth(sd, C_parts, l_starts, P_parts, nc_dofs, omega):
    """P += C Y, one damped-Jacobi step in the curl space (distributed).

    Mirrors precond/stokes._curl_smooth_prol: d = diag(C^T A C), rho by
    power iteration on D^-1 C^T A C, Y = -(omega/rho) D^-1 (C^T A P).
    The correction stays exactly divergence-free per construction.
    """
    from .transport import get_transport

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)
    # facet-DOF row partition: infer block size from A rows
    bs = next(
        sd.A_parts[s].shape[0]
        // max(int(sd.e_starts[s + 1] - sd.e_starts[s]), 1)
        for s in mine
    )
    dof_starts = sd.e_starts * bs
    n_loops = int(l_starts[-1])
    # AC rows + d = colsum(C .* AC) routed to loop owners
    AC_parts = _dist_spmm_rows(
        sd.A_parts, dof_starts, C_parts, dof_starts, n_loops
    )
    ri, vv = [], []
    for s in mine:
        M = C_parts[s].multiply(AC_parts[s]).tocoo()
        if M.nnz:
            ri.append(M.col.astype(np.int64))
            vv.append(M.data)
    z = np.zeros(0, dtype=np.int64)
    d_parts = _reduce_nd(
        l_starts,
        np.concatenate(ri) if ri else z,
        np.concatenate(vv) if vv else np.zeros(0),
    )
    dinv_parts = [None] * n_shards
    for s in mine:
        d = d_parts[s]
        dinv_parts[s] = np.where(
            d > 0, 1.0 / np.maximum(d, 1e-300), 0.0
        )
    # rho(D^-1 C^T A C) via power iteration (serial seeds/iters); the
    # iterate is REPLICATED (allgathered per round) so every rank sees
    # the same norm
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n_loops)
    lam = 2.0
    for _ in range(8):
        # y = dinv * C^T A C x: Cx rows live on facet owners; the A
        # product gathers halo Cx values
        Cx_parts = [None] * n_shards
        for s in mine:
            Cx_parts[s] = C_parts[s] @ x
        ACx_parts = [None] * n_shards
        for s in mine:
            A_s = sd.A_parts[s].tocsr()
            xj = _gather(Cx_parts, dof_starts, A_s.indices.astype(np.int64))
            rows_l = np.repeat(
                np.arange(A_s.shape[0], dtype=np.int64),
                np.diff(A_s.indptr),
            )
            ACx_parts[s] = np.bincount(
                rows_l, weights=A_s.data * xj, minlength=A_s.shape[0]
            )
        ri2, vv2 = [], []
        for s in mine:
            M = C_parts[s].tocsr()
            rows_l = np.repeat(
                np.arange(M.shape[0], dtype=np.int64), np.diff(M.indptr)
            )
            contrib = M.data * ACx_parts[s][rows_l]
            ri2.append(M.indices.astype(np.int64))
            vv2.append(contrib)
        cty = _reduce_nd(
            l_starts,
            np.concatenate(ri2) if ri2 else z,
            np.concatenate(vv2) if vv2 else np.zeros(0),
        )
        y_parts = [None] * n_shards
        for s in mine:
            y_parts[s] = dinv_parts[s] * cty[s]
        y = tr.allgather_parts(y_parts)
        nrm = np.linalg.norm(y)
        if nrm == 0:
            break
        lam = nrm
        x = y / nrm
    scale = omega / max(lam, 1e-12)
    # Y = -scale * D^-1 (C^T A P), rows owned by loop owners
    AP_parts = _dist_spmm_rows(
        sd.A_parts, dof_starts, P_parts, dof_starts, nc_dofs
    )
    Y_parts = _dist_ATB_rows(
        C_parts, dof_starts, AP_parts, l_starts, nc_dofs
    )
    for s in mine:
        Y_parts[s] = (
            sp.diags(-scale * dinv_parts[s]) @ Y_parts[s]
        ).tocsr()
    # P += C Y (gather halo Y rows at C's loop columns)
    CY_parts = _dist_spmm_rows(
        C_parts, dof_starts, Y_parts, l_starts, nc_dofs
    )
    out = [None] * n_shards
    for s in mine:
        out[s] = (P_parts[s] + CY_parts[s]).tocsr()
    return out


def _stokes_levels_parts(sd: _ShardedDual, bs: int, opts: AMGOptions):
    """The Stokes distributed level loop, rank-local.

    Consumes a per-shard dual-mesh level 0 (``None`` slots for rows owned
    by another controller) and returns one record per LEVEL holding the
    owned slots of the dual-mesh data, the loop basis C, the flow
    prolongation P and the aggregation — plus a rank-local FactoryLog
    with shard-residency accounting. Under a single-controller transport
    every slot is owned (exact previous behavior); under
    ``mp_runtime.MPTransport`` each rank owns one slot.
    """
    from ..factory.levels import FactoryLog
    from .dist_setup import _dist_rap
    from .transport import get_transport, shard_nbytes

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)
    lc = opts.levels
    log = FactoryLog()
    log.finest_global_bytes = int(
        tr.allgather(
            np.array(
                [shard_nbytes(sd.A_parts[s]) for s in mine],
                dtype=np.int64,
            )
        ).sum()
    )

    tot0 = [0]

    def _track_peak(*objs_per_shard):
        per = [
            shard_nbytes(*(o[s] for o in objs_per_shard if o is not None))
            for s in mine
        ]
        loc_max = max(per)
        log.peak_shard_bytes = max(log.peak_shard_bytes, loc_max)
        # balance: the largest shard's state vs an even split of the
        # total — the residency proof when the dominant state (the loop
        # basis) is much larger than the finest matrix. Levels far
        # smaller than the finest are excluded: tiny coarse levels
        # concentrate by construction (few coarse cells; the owner of
        # `lo` takes the edges — the reference's idle-rank regime) and
        # carry negligible absolute state.
        allp = tr.allgather(np.asarray(per, dtype=np.int64))
        tot = int(allp.sum())
        if tot0[0] == 0:
            tot0[0] = tot
        if tot >= 0.25 * tot0[0] and tot > 0:
            log.state_balance = max(
                log.state_balance,
                float(int(allp.max()) * n_shards / tot),
            )

    recs = []
    lvl = 0
    while True:
        C_parts, l_starts = _dist_loops(sd, bs)
        rec = {
            "v_starts": sd.v_starts,
            "e_starts": sd.e_starts,
            "A_parts": sd.A_parts,
            "pos_parts": sd.pos_parts,
            "vol_parts": sd.vol_parts,
            "edges_parts": sd.edges_parts,
            "flow_parts": sd.flow_parts,
            "C_parts": C_parts,
            "P_parts": None,
            "v2agg_parts": None,
        }
        recs.append(rec)
        log.nvs.append(sd.nv)
        log.nnzs.append(
            int(
                tr.allgather(
                    np.array(
                        [sd.A_parts[s].nnz for s in mine], dtype=np.int64
                    )
                ).sum()
            )
        )
        _track_peak(
            sd.A_parts, sd.pos_parts, sd.vol_parts, sd.edges_parts,
            sd.flow_parts,
        )
        if (
            lvl + 1 >= lc.max_levels
            or sd.ne * bs <= lc.max_coarse_size
            or sd.nv <= 8
        ):
            break
        v2agg_parts, c_starts = _dist_coarsen_cells(sd)
        n_agg = int(c_starts[-1])
        if n_agg >= lc.min_coarsen_ratio * sd.nv:
            break
        (ce_starts, cedges_parts, ci_parts, cj_parts,
         e2ce_parts) = _dist_map_edges(sd, v2agg_parts, c_starts)
        csd = _dist_map_mesh(
            sd, v2agg_parts, c_starts, ce_starts, cedges_parts,
            ci_parts, e2ce_parts,
        )
        if bs == 1:
            P_parts = _dist_flow_prol(
                sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts
            )
        else:
            P_parts = _dist_flow_prol_vec(
                sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts
            )
        if (
            ProlType(opts.prol.type.get(lvl)) == ProlType.SMOOTHED
            and C_parts is not None
        ):
            P_parts = _dist_curl_smooth(
                sd, C_parts, l_starts, P_parts, csd.ne * bs,
                float(opts.prol.omega.get(lvl)),
            )
        rec["P_parts"] = P_parts
        rec["v2agg_parts"] = v2agg_parts
        Ac_parts = _dist_rap(
            sd.A_parts, sd.e_starts * bs, P_parts, ce_starts * bs
        )
        Ac_parts = _dist_symmetrize(Ac_parts, ce_starts * bs)
        csd.A_parts = [None] * n_shards
        for s in mine:
            # serial f32 parity
            csd.A_parts[s] = (
                Ac_parts[s].astype(np.float32).astype(np.float64)
            )
        state = [sd.A_parts, csd.A_parts, P_parts]
        if C_parts is not None:
            state.append(C_parts)
        _track_peak(*state)
        sd = csd
        lvl += 1
    return recs, log


def package_stokes_levels(recs):
    """Assemble global `StokesLevel`s from per-shard level records
    (single-controller staging; the MP parent feeds per-rank slots)."""
    levels: list[st.StokesLevel] = []
    for rec in recs:
        mesh = AlgebraicMesh(
            nv=int(rec["v_starts"][-1]),
            edges=np.concatenate(rec["edges_parts"])
            if int(rec["e_starts"][-1])
            else np.zeros((0, 2), dtype=np.int64),
        )
        mesh.vertex_data["pos"] = np.concatenate(rec["pos_parts"])
        mesh.vertex_data["vol"] = np.concatenate(rec["vol_parts"])
        mesh.edge_data["flow"] = np.concatenate(rec["flow_parts"])
        cap = st.StokesLevel(
            A=sp.vstack(rec["A_parts"], format="csr"), mesh=mesh
        )
        cap.C = (
            None
            if rec["C_parts"] is None
            else sp.vstack(rec["C_parts"], format="csr")
        )
        if rec["P_parts"] is not None:
            cap.P = sp.vstack(rec["P_parts"], format="csr")
            cap.v2agg = np.concatenate(rec["v2agg_parts"])
        levels.append(cap)
    return levels


def dist_stokes_levels(
    A: sp.csr_matrix,
    mesh0: AlgebraicMesh,
    bs: int,
    opts: AMGOptions,
    n_shards: int,
    return_log: bool = False,
):
    """Build the Stokes level list from sharded inputs (serial-equal).

    Mirrors precond/stokes.StokesAMG.setup's level loop; returns the same
    assembled `StokesLevel` list (the staging step before device
    placement, like dist_setup.dist_setup_levels). The loop itself
    (`_stokes_levels_parts`) is rank-local and also runs one-process-
    per-shard under ``mp_runtime`` (packaging happens here).
    """
    sd = _shard_level0(mesh0, A, bs, n_shards)
    recs, log = _stokes_levels_parts(sd, bs, opts)
    levels = package_stokes_levels(recs)
    return (levels, log) if return_log else levels


# ---------------------------------------------------------------------------
# distributed HDiv variant: variable facet DOFs + preserved vectors
# (serial apps/stokes_hdiv.preserved_prolongation; reference
# src/stokes/hdiv/preserved_vectors.hpp computeCoarseBasis)
# ---------------------------------------------------------------------------


def _dist_preserved_prol(
    sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts,
    cnt_parts, V_parts, Pflux_parts, rank_tol=1e-10,
):
    """Distributed preserved-vector prolongation.

    Sharded inputs: per-facet dof counts ``cnt_parts`` and preserved-
    vector rows ``V_parts`` (dof rows live with their facet's owner),
    plus the scalar flux prolongation rows ``Pflux_parts``. Coarse-facet
    bases are OWNER-COMPUTED (the coarse facet's owner gathers its fine
    members' higher-dof preserved restrictions, takes the rank-revealing
    SVD, and routes the basis block back to the fine-dof owners); the
    per-aggregate interior fits/cycle corrections run at the aggregate
    owners — the reference's master-decides + scatter pattern.

    Returns (P_parts over fine-dof rows, cnt_c_parts, Vc_parts).
    """
    from .transport import get_transport

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)
    ne_c = csd.ne
    ce_starts = csd.e_starts
    m = next(V_parts[s].shape[1] for s in mine)
    z = np.zeros(0, dtype=np.int64)

    # global dof offsets per shard (fine) — per-rank counts allgathered
    loc_nd = tr.allgather(
        np.array([int(cnt_parts[s].sum()) for s in mine], dtype=np.int64)
    )
    dof_starts = np.zeros(n_shards + 1, dtype=np.int64)
    dof_starts[1:] = np.cumsum(loc_nd)
    off_parts = [None] * n_shards  # local facet -> GLOBAL first dof
    for s in mine:
        o = np.zeros(len(cnt_parts[s]) + 1, dtype=np.int64)
        o[1:] = np.cumsum(cnt_parts[s])
        off_parts[s] = o[:-1] + dof_starts[s]

    # --- route member higher-dof restrictions to coarse-facet owners ----
    hi_ce, hi_dof, hi_V = [], [], []
    for s in mine:
        e2 = e2ce_parts[s]
        sel = np.flatnonzero(e2 >= 0)
        for t in sel:  # higher dofs of each member facet
            c = int(cnt_parts[s][t])
            if c <= 1:
                continue
            g0 = off_parts[s][t]
            l0 = g0 - dof_starts[s]
            hi_ce.append(np.full(c - 1, e2[t], dtype=np.int64))
            hi_dof.append(np.arange(g0 + 1, g0 + c))
            hi_V.append(V_parts[s][l0 + 1: l0 + c])
    hi_ce = np.concatenate(hi_ce) if hi_ce else z
    hi_dof = np.concatenate(hi_dof) if hi_dof else z
    hi_V = (
        np.concatenate(hi_V) if len(hi_ce) else np.zeros((0, m))
    )
    hi_parts = _route_by(ce_starts, hi_ce, hi_ce, hi_dof, hi_V)

    # --- per-coarse-facet SVD bases at the owners -----------------------
    cnt_c_parts = [None] * n_shards
    basis_info = [None] * n_shards
    coords_parts = [None] * n_shards  # per local ce: (k, m) coords
    for t in mine:
        ces, dofs_g, Vh = hi_parts[t]
        nloc = int(ce_starts[t + 1] - ce_starts[t])
        cnt_c = np.ones(nloc, dtype=np.int64)
        coords = [None] * nloc
        blocks = [None] * nloc
        order = np.argsort(dofs_g, kind="stable")  # serial member order
        ces, dofs_g, Vh = ces[order], dofs_g[order], Vh[order]
        for ce_l in range(nloc):
            mset = ces == (ce_l + ce_starts[t])
            if not mset.any():
                continue
            W = Vh[mset]
            U, sv, _vt = np.linalg.svd(W, full_matrices=False)
            k = int(
                (sv > rank_tol * max(
                    sv[0] if len(sv) else 0.0, 1e-300
                )).sum()
            )
            if k == 0:
                continue
            B = U[:, :k]
            cnt_c[ce_l] += k
            blocks[ce_l] = (dofs_g[mset], B)
            coords[ce_l] = B.T @ W
        cnt_c_parts[t] = cnt_c
        coords_parts[t] = coords
        basis_info[t] = blocks

    # coarse dof offsets (global)
    loc_ndc = tr.allgather(
        np.array(
            [int(cnt_c_parts[t].sum()) for t in mine], dtype=np.int64
        )
    )
    cdof_starts = np.zeros(n_shards + 1, dtype=np.int64)
    cdof_starts[1:] = np.cumsum(loc_ndc)
    c0_parts = [None] * n_shards
    for t in mine:
        o = np.zeros(len(cnt_c_parts[t]) + 1, dtype=np.int64)
        o[1:] = np.cumsum(cnt_c_parts[t])
        c0_parts[t] = o[:-1] + cdof_starts[t]
    ndc = int(cdof_starts[-1])

    # --- P entries -------------------------------------------------------
    ri, cj, vv = [], [], []
    # flux rows: Pflux (facet x coarse facet) -> (dof0 x coarse dof0);
    # the c0 gather is a collective every rank joins (empty rows included)
    for s in mine:
        Pf = Pflux_parts[s].tocoo()
        c0_of = _gather(c0_parts, ce_starts, Pf.col.astype(np.int64))
        ri.append(off_parts[s][Pf.row])
        cj.append(c0_of)
        vv.append(Pf.data)
    # coarse higher-dof basis blocks (emitted by ce owners)
    for t in mine:
        for ce_l, blk in enumerate(basis_info[t]):
            if blk is None:
                continue
            dofs_g, B = blk
            k = B.shape[1]
            cd = np.arange(
                c0_parts[t][ce_l] + 1, c0_parts[t][ce_l] + 1 + k
            )
            r, c = np.meshgrid(dofs_g, cd, indexing="ij")
            ri.append(r.ravel())
            cj.append(c.ravel())
            vv.append(B.ravel())

    # --- coarse preserved coordinates Vc (rows at coarse-facet owners) --
    lo_view = [
        None if c is None else c[:, 0] for c in csd.edges_parts
    ]
    idx_l, val_l = [], []
    for s in mine:
        e2 = e2ce_parts[s]
        sel = np.flatnonzero(e2 >= 0)
        # unconditional: both gathers are collectives every rank joins
        ce = e2[sel]
        lo_of = _gather(lo_view, ce_starts, ce)
        sgn = np.where(ci_parts[s][sel] == lo_of, 1.0, -1.0)
        fl = sd.flow_parts[s][sel]
        l0 = off_parts[s][sel] - dof_starts[s]
        Vf = V_parts[s][l0]  # fine flux components
        c0_of = _gather(c0_parts, ce_starts, ce)
        idx_l.append(c0_of)
        val_l.append((sgn * fl)[:, None] * Vf)
    # reduce onto coarse-dof owners (partition = cdof_starts)
    Vc_parts = _reduce_nd(
        cdof_starts,
        np.concatenate(idx_l) if idx_l else z,
        np.concatenate(val_l) if val_l else np.zeros((0, m)),
        shape_tail=(m,),
    )
    for t in mine:
        cfl = csd.flow_parts[t]
        gc = np.where(np.abs(cfl) > 1e-300, cfl, 1.0)
        l0 = c0_parts[t] - cdof_starts[t]
        Vc_parts[t][l0] /= gc[:, None]
        for ce_l, co in enumerate(coords_parts[t]):
            if co is None:
                continue
            k = co.shape[0]
            Vc_parts[t][l0[ce_l] + 1: l0[ce_l] + 1 + k] = co
    return (
        (ri, cj, vv), cnt_c_parts, Vc_parts, off_parts, c0_parts,
        dof_starts, cdof_starts, ndc,
    )


def _dist_hdiv_interior(
    sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts, cnt_parts,
    V_parts, off_parts, c0_parts, dof_starts, cdof_starts, ndc,
    Vc_parts, tri, P_shape_rows,
):
    """Aggregate-owner interior fits + cycle-space flux corrections.

    Rank-local: the per-aggregate gathers are BATCHED per owner (one
    gather of the incident-ce metadata and one of the referenced Vc
    rows), so every rank makes the same number of collective calls
    regardless of how many aggregates it owns.
    """
    n_shards = sd.n_shards
    mine = _my(sd)
    ce_starts = csd.e_starts
    c_starts = csd.v_starts
    z = np.zeros(0, dtype=np.int64)
    ri, cj, vv = tri

    # incident coarse-edge sets per coarse cell (at coarse-cell owners)
    inc_a, inc_ce = [], []
    for t in mine:
        E = csd.edges_parts[t]
        ce_g = np.arange(
            ce_starts[t], ce_starts[t + 1], dtype=np.int64
        )
        inc_a.extend([E[:, 0], E[:, 1]])
        inc_ce.extend([ce_g, ce_g])
    ia = np.concatenate(inc_a) if inc_a else z
    ic = np.concatenate(inc_ce) if inc_ce else z
    inc_parts = _route_by(c_starts, ia, ia, ic)

    # interior facets routed to aggregate owners with their data
    ie_agg, ie_e, ie_i, ie_j, ie_cnt, ie_off, ie_flow = (
        [], [], [], [], [], [], []
    )
    iv_agg, iv_dof, iv_V = [], [], []
    m = next(V_parts[s].shape[1] for s in mine)
    for s in mine:
        e2 = e2ce_parts[s]
        ci = ci_parts[s]
        sel = np.flatnonzero((e2 < 0) & (ci >= 0) & (ci == cj_parts[s]))
        e = sd.edges_parts[s][sel]
        ie_agg.append(ci[sel])
        ie_e.append(sel + sd.e_starts[s])
        ie_i.append(e[:, 0])
        ie_j.append(e[:, 1])
        ie_cnt.append(cnt_parts[s][sel])
        ie_off.append(off_parts[s][sel])
        ie_flow.append(sd.flow_parts[s][sel])
        for t in sel:
            c = int(cnt_parts[s][t])
            g0 = off_parts[s][t]
            l0 = g0 - dof_starts[s]
            iv_agg.append(np.full(c, ci[t], dtype=np.int64))
            iv_dof.append(np.arange(g0, g0 + c))
            iv_V.append(V_parts[s][l0: l0 + c])
    ia2 = np.concatenate(ie_agg) if ie_agg else z
    fac_parts = _route_by(
        c_starts, ia2, ia2,
        np.concatenate(ie_e) if ie_e else z,
        np.concatenate(ie_i) if ie_i else z,
        np.concatenate(ie_j) if ie_j else z,
        np.concatenate(ie_cnt) if ie_cnt else z,
        np.concatenate(ie_off) if ie_off else z,
        np.concatenate(ie_flow) if ie_flow else np.zeros(0),
    )
    iva = np.concatenate(iv_agg) if iv_agg else z
    ivd_parts = _route_by(
        c_starts, iva, iva,
        np.concatenate(iv_dof) if iv_dof else z,
        np.concatenate(iv_V) if iv_V else np.zeros((0, m)),
    )

    cnt_view = _cnt_c_view(c0_parts, cdof_starts)
    for t in mine:
        a_arr, e_arr, i_arr, j_arr, cnt_arr, off_arr, fl_arr = (
            fac_parts[t]
        )
        va_arr, vd_arr, vV_arr = ivd_parts[t]
        inc_a_arr, inc_c_arr = inc_parts[t]
        o = np.argsort(e_arr, kind="stable")
        a_arr, e_arr, i_arr, j_arr = (
            a_arr[o], e_arr[o], i_arr[o], j_arr[o]
        )
        cnt_arr, off_arr, fl_arr = cnt_arr[o], off_arr[o], fl_arr[o]
        vmap = {int(d): v for d, v in zip(vd_arr, vV_arr)}
        # batched (agg, ce) incidence pairs for ALL owned aggregates:
        # sorted (a, ce) unique pairs == per-agg np.unique(ces)
        po = np.lexsort((inc_c_arr, inc_a_arr))
        pa, pc = inc_a_arr[po], inc_c_arr[po]
        if len(pa):
            newp = np.ones(len(pa), dtype=bool)
            newp[1:] = (pa[1:] != pa[:-1]) | (pc[1:] != pc[:-1])
            pa, pc = pa[newp], pc[newp]
        # ONE metadata gather + ONE Vc-row gather per owner (symmetric
        # collective count across ranks, empty or not)
        c0_of_all = _gather(c0_parts, ce_starts, pc)
        kcnt_all = _gather(cnt_view, ce_starts, pc)
        stencil_all = (
            np.concatenate(
                [
                    np.arange(c0_of_all[q], c0_of_all[q] + kcnt_all[q])
                    for q in range(len(pc))
                ]
            )
            if len(pc)
            else z
        )
        pair_starts = np.zeros(len(pc) + 1, dtype=np.int64)
        if len(pc):
            pair_starts[1:] = np.cumsum(kcnt_all)
        Vs_all = _gather(Vc_parts, cdof_starts, stencil_all)
        # per-aggregate slices out of the batched arrays
        if not len(a_arr):
            continue
        for a in np.unique(a_arr):
            sel = np.flatnonzero(a_arr == a)
            pr = np.flatnonzero(pa == a)
            if not len(pr):
                continue
            st_idx = np.concatenate(
                [
                    np.arange(pair_starts[q], pair_starts[q + 1])
                    for q in pr
                ]
            )
            stencil = stencil_all[st_idx]
            Vs = Vs_all[st_idx]
            pinvVs = np.linalg.pinv(Vs, rcond=1e-10)
            # higher-dof fits per interior facet
            for q in sel:
                c = int(cnt_arr[q])
                if c <= 1:
                    continue
                hi = np.arange(off_arr[q] + 1, off_arr[q] + c)
                Vhi = np.stack([vmap[int(d)] for d in hi])
                R = Vhi @ pinvVs
                r, cc = np.meshgrid(hi, stencil, indexing="ij")
                ri.append(r.ravel())
                cj.append(cc.ravel())
                vv.append(R.ravel())
        # NOTE: the cycle-space flux correction needs P rows times Vc;
        # handled by the caller after P assembly (gather-based), see
        # dist_stokes_hdiv_levels.
    return ri, cj, vv


def _cnt_c_view(c0_parts, cdof_starts):
    """Per-shard coarse-facet dof counts from offsets (None-slot safe)."""
    out = [None] * len(c0_parts)
    for t in range(len(c0_parts)):
        if c0_parts[t] is None:
            continue
        ends = np.append(
            c0_parts[t][1:], cdof_starts[t + 1]
        )
        out[t] = ends - c0_parts[t]
    return out


def _dist_hdiv_cycle_fix(
    sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts, off_parts,
    c0_parts, dof_starts, cdof_starts, Vc_parts, V_parts, P_parts, ndc,
):
    """Aggregate-owner cycle-space flux correction (serial final pass).

    The tree routing completes divergence uniquely on a spanning tree;
    the preserved vectors' circulation on non-tree interior facets lies
    in the aggregate's interior cycle space. Each aggregate owner gathers
    its interior flux P rows + the referenced Vc rows, computes the local
    residual, and fits the cycle-space part against the incident coarse
    dofs (serial preserved_prolongation's `_local_cycles` pass).
    """
    from ..apps.stokes_hdiv import _local_cycles
    from ..mesh.topo import AlgebraicMesh as _AM

    n_shards = sd.n_shards
    mine = _my(sd)
    ce_starts = csd.e_starts
    c_starts = csd.v_starts
    z = np.zeros(0, dtype=np.int64)

    inc_a, inc_ce = [], []
    for t in mine:
        E = csd.edges_parts[t]
        ce_g = np.arange(ce_starts[t], ce_starts[t + 1], dtype=np.int64)
        inc_a.extend([E[:, 0], E[:, 1]])
        inc_ce.extend([ce_g, ce_g])
    ia0 = np.concatenate(inc_a) if inc_a else z
    inc_parts = _route_by(
        c_starts, ia0, ia0,
        np.concatenate(inc_ce) if inc_ce else z,
    )

    ie_agg, ie_e, ie_i, ie_j, ie_off, ie_flow, ie_V0 = (
        [], [], [], [], [], [], []
    )
    mV = next(V_parts[s].shape[1] for s in mine)
    for s in mine:
        e2 = e2ce_parts[s]
        ci = ci_parts[s]
        sel = np.flatnonzero((e2 < 0) & (ci >= 0) & (ci == cj_parts[s]))
        e = sd.edges_parts[s][sel]
        l0 = off_parts[s][sel] - dof_starts[s]
        ie_agg.append(ci[sel])
        ie_e.append(sel + sd.e_starts[s])
        ie_i.append(e[:, 0])
        ie_j.append(e[:, 1])
        ie_off.append(off_parts[s][sel])
        ie_flow.append(sd.flow_parts[s][sel])
        ie_V0.append(V_parts[s][l0])
    ia = np.concatenate(ie_agg) if ie_agg else z
    fac_parts = _route_by(
        c_starts, ia, ia,
        np.concatenate(ie_e) if ie_e else z,
        np.concatenate(ie_i) if ie_i else z,
        np.concatenate(ie_j) if ie_j else z,
        np.concatenate(ie_off) if ie_off else z,
        np.concatenate(ie_flow) if ie_flow else np.zeros(0),
        np.concatenate(ie_V0) if ie_V0 else np.zeros((0, mV)),
    )
    cnt_view = _cnt_c_view(c0_parts, cdof_starts)
    tri_r, tri_c, tri_v = [], [], []
    for t in mine:
        a_arr, e_arr, i_arr, j_arr, off_arr, fl_arr, V0_arr = (
            fac_parts[t]
        )
        inc_a_arr, inc_c_arr = inc_parts[t]
        o = np.argsort(e_arr, kind="stable")
        a_arr, e_arr, i_arr, j_arr = (
            a_arr[o], e_arr[o], i_arr[o], j_arr[o]
        )
        off_arr, fl_arr, V0_arr = off_arr[o], fl_arr[o], V0_arr[o]
        # aggregates with >= 2 interior facets (the only ones corrected)
        ua, ua_cnt = (
            np.unique(a_arr, return_counts=True)
            if len(a_arr)
            else (z, z)
        )
        live = ua[ua_cnt >= 2]
        live_set = set(int(a) for a in live)
        sel_all = (
            np.flatnonzero(
                np.isin(a_arr, live)
            )
            if len(a_arr)
            else z
        )
        flux_all = off_arr[sel_all] if len(sel_all) else z
        # BATCHED collectives (one each per owner, symmetric across
        # ranks): P rows at every corrected flux row, the union of
        # their Vc columns, the incident-ce metadata, the stencil rows
        Prow_all = _gather_csr_rows(P_parts, dof_starts, flux_all, ndc)
        cols_u = (
            np.unique(Prow_all.indices.astype(np.int64))
            if Prow_all.nnz
            else z
        )
        Vc_u = _gather(Vc_parts, cdof_starts, cols_u)
        po = np.lexsort((inc_c_arr, inc_a_arr))
        pa, pc = inc_a_arr[po], inc_c_arr[po]
        if len(pa):
            newp = np.ones(len(pa), dtype=bool)
            newp[1:] = (pa[1:] != pa[:-1]) | (pc[1:] != pc[:-1])
            pa, pc = pa[newp], pc[newp]
        c0_of_all = _gather(c0_parts, ce_starts, pc)
        kcnt_all = _gather(cnt_view, ce_starts, pc)
        stencil_all = (
            np.concatenate(
                [
                    np.arange(c0_of_all[q], c0_of_all[q] + kcnt_all[q])
                    for q in range(len(pc))
                ]
            )
            if len(pc)
            else z
        )
        pair_starts = np.zeros(len(pc) + 1, dtype=np.int64)
        if len(pc):
            pair_starts[1:] = np.cumsum(kcnt_all)
        Vs_all = _gather(Vc_parts, cdof_starts, stencil_all)
        if not len(sel_all):
            continue
        # position of each corrected facet inside the batched P rows
        rowpos = {int(q): k for k, q in enumerate(sel_all)}
        colmap_all = np.searchsorted(cols_u, Prow_all.indices)
        Pc_all = sp.csr_matrix(
            (Prow_all.data, colmap_all, Prow_all.indptr),
            shape=(Prow_all.shape[0], len(cols_u)),
        )
        resid_all = Pc_all @ Vc_u if len(cols_u) else np.zeros(
            (Prow_all.shape[0], V0_arr.shape[1])
        )
        for a in live:
            sel = np.flatnonzero(a_arr == a)
            flux_rows = off_arr[sel]
            rk = np.array([rowpos[int(q)] for q in sel], dtype=np.int64)
            resid = V0_arr[sel] - resid_all[rk]
            if np.abs(resid).max() < 1e-13:
                continue
            # local cycles over the aggregate's interior facet subgraph
            lmesh = _AM(
                nv=sd.nv,
                edges=np.stack(
                    [i_arr[sel], j_arr[sel]], axis=1
                ),
            )
            lmesh.edge_data["flow"] = fl_arr[sel]
            Ca = _local_cycles(
                _FacView(lmesh), list(range(len(sel)))
            )
            if Ca is None:
                continue
            y, *_ = np.linalg.lstsq(Ca, resid, rcond=None)
            corr = Ca @ y
            pr = np.flatnonzero(pa == a)
            if not len(pr):
                continue
            st_idx = np.concatenate(
                [
                    np.arange(pair_starts[q], pair_starts[q + 1])
                    for q in pr
                ]
            )
            stencil = stencil_all[st_idx]
            Vs = Vs_all[st_idx]
            X = corr @ np.linalg.pinv(Vs, rcond=1e-10)
            r, c = np.meshgrid(flux_rows, stencil, indexing="ij")
            tri_r.append(r.ravel())
            tri_c.append(c.ravel())
            tri_v.append(X.ravel())
    # the route is a collective every rank joins, triples or not
    dP_parts = _route_coo(
        dof_starts,
        np.concatenate(tri_r) if tri_r else z,
        np.concatenate(tri_c) if tri_c else z,
        np.concatenate(tri_v) if tri_v else np.zeros(0),
        ndc,
    )
    out = [None] * n_shards
    for s in mine:
        out[s] = (P_parts[s] + dP_parts[s]).tocsr()
    return out


class _FacView:
    """Minimal mesh view for _local_cycles over routed facet arrays."""

    def __init__(self, mesh):
        self.edges = mesh.edges
        self.edge_data = mesh.edge_data


def dist_stokes_hdiv_levels(
    A: sp.csr_matrix,
    mesh0: AlgebraicMesh,
    dofs0,
    pres0,
    opts: AMGOptions,
    n_shards: int,
):
    """Distributed HDiv Stokes level loop (serial StokesHDivAMG.setup).

    Variable per-facet DOFs (`MeshDOFs`) shard with their facets; the
    preserved-vector machinery runs owner-computed per coarse facet /
    aggregate. Returns the assembled `StokesLevel` list with dofs/pres
    per level, matching the serial hierarchy.
    """
    sd, cnt_parts, V_parts = _shard_hdiv_level0(
        A, mesh0, dofs0, pres0, int(n_shards)
    )
    recs, _log = _stokes_hdiv_levels_parts(
        sd, cnt_parts, V_parts, pres0.n_special, opts
    )
    return package_hdiv_levels(recs, pres0.n_special)


def _shard_hdiv_level0(A, mesh0, dofs0, pres0, n_shards):
    """Per-shard HDiv level-0 state (parent-side split)."""
    v_starts = _split(mesh0.nv, n_shards)
    e_starts = _split(mesh0.ne, n_shards)
    A = A.tocsr().astype(np.float64)
    counts0 = dofs0.counts()
    off_all = dofs0.offsets
    sd = _ShardedDual(
        v_starts,
        e_starts,
        [mesh0.vertex_data["pos"][v_starts[s]: v_starts[s + 1]]
         for s in range(n_shards)],
        [mesh0.vertex_data["vol"][v_starts[s]: v_starts[s + 1]]
         for s in range(n_shards)],
        [mesh0.edges[e_starts[s]: e_starts[s + 1]]
         for s in range(n_shards)],
        [mesh0.edge_data["flow"][e_starts[s]: e_starts[s + 1]]
         for s in range(n_shards)],
        [A[off_all[e_starts[s]]: off_all[e_starts[s + 1]]]
         for s in range(n_shards)],
    )
    cnt_parts = [
        counts0[e_starts[s]: e_starts[s + 1]] for s in range(n_shards)
    ]
    V_parts = [
        pres0.vectors[off_all[e_starts[s]]: off_all[e_starts[s + 1]]]
        for s in range(n_shards)
    ]
    return sd, cnt_parts, V_parts


def _stokes_hdiv_levels_parts(sd, cnt_parts, V_parts, n_special, opts):
    """The HDiv Stokes distributed level loop, rank-local.

    Like `_stokes_levels_parts`, every slot not in
    ``transport.my_shards`` is ``None``; the preserved-vector machinery
    runs owner-computed with BATCHED per-owner collectives (symmetric
    call counts across ranks).
    """
    from ..factory.levels import FactoryLog
    from .dist_setup import _dist_rap
    from .transport import get_transport, shard_nbytes

    tr = get_transport()
    n_shards = sd.n_shards
    mine = _my(sd)
    lc = opts.levels
    log = FactoryLog()
    log.finest_global_bytes = int(
        tr.allgather(
            np.array(
                [shard_nbytes(sd.A_parts[s]) for s in mine],
                dtype=np.int64,
            )
        ).sum()
    )
    recs = []
    lvl = 0
    while True:
        ndof = int(
            tr.allgather(
                np.array(
                    [int(cnt_parts[s].sum()) for s in mine],
                    dtype=np.int64,
                )
            ).sum()
        )
        rec = {
            "v_starts": sd.v_starts,
            "e_starts": sd.e_starts,
            "A_parts": sd.A_parts,
            "pos_parts": sd.pos_parts,
            "vol_parts": sd.vol_parts,
            "edges_parts": sd.edges_parts,
            "flow_parts": sd.flow_parts,
            "cnt_parts": cnt_parts,
            "V_parts": V_parts,
            "P_parts": None,
            "v2agg_parts": None,
        }
        recs.append(rec)
        log.nvs.append(sd.nv)
        log.nnzs.append(
            int(
                tr.allgather(
                    np.array(
                        [sd.A_parts[s].nnz for s in mine],
                        dtype=np.int64,
                    )
                ).sum()
            )
        )
        per = [
            shard_nbytes(
                sd.A_parts[s], sd.pos_parts[s], sd.vol_parts[s],
                sd.edges_parts[s], sd.flow_parts[s], V_parts[s],
            )
            for s in mine
        ]
        log.peak_shard_bytes = max(log.peak_shard_bytes, max(per))
        if (
            lvl + 1 >= lc.max_levels
            or ndof <= lc.max_coarse_size
            or sd.nv <= 8
        ):
            break
        v2agg_parts, c_starts = _dist_coarsen_cells(sd)
        n_agg = int(c_starts[-1])
        if n_agg >= lc.min_coarsen_ratio * sd.nv:
            break
        (ce_starts, cedges_parts, ci_parts, cj_parts,
         e2ce_parts) = _dist_map_edges(sd, v2agg_parts, c_starts)
        csd = _dist_map_mesh(
            sd, v2agg_parts, c_starts, ce_starts, cedges_parts,
            ci_parts, e2ce_parts,
        )
        Pflux_parts = _dist_flow_prol(
            sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts
        )
        (tri, cnt_c_parts, Vc_parts, off_parts, c0_parts, dof_starts,
         cdof_starts, ndc) = _dist_preserved_prol(
            sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts,
            cnt_parts, V_parts, Pflux_parts,
        )
        ri, cj_l, vv = _dist_hdiv_interior(
            sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts,
            cnt_parts, V_parts, off_parts, c0_parts, dof_starts,
            cdof_starts, ndc, Vc_parts, tri, None,
        )
        z = np.zeros(0, dtype=np.int64)
        P_parts = _route_coo(
            dof_starts,
            np.concatenate(ri) if ri else z,
            np.concatenate(cj_l) if cj_l else z,
            np.concatenate(vv) if vv else np.zeros(0),
            ndc,
        )
        P_parts = _dist_hdiv_cycle_fix(
            sd, csd, v2agg_parts, ci_parts, cj_parts, e2ce_parts,
            off_parts, c0_parts, dof_starts, cdof_starts, Vc_parts,
            V_parts, P_parts, ndc,
        )
        rec["P_parts"] = P_parts
        rec["v2agg_parts"] = v2agg_parts
        Ac_parts = _dist_rap(sd.A_parts, dof_starts, P_parts, cdof_starts)
        Ac_parts = _dist_symmetrize(Ac_parts, cdof_starts)
        csd.A_parts = Ac_parts
        cnt_parts = cnt_c_parts
        V_parts = Vc_parts
        sd = csd
        lvl += 1
    return recs, log


def package_hdiv_levels(recs, n_special):
    """Assemble global HDiv `StokesLevel`s from per-shard records."""
    from ..apps.stokes_hdiv import MeshDOFs, PreservedVectors

    levels = []
    for rec in recs:
        mesh = AlgebraicMesh(
            nv=int(rec["v_starts"][-1]),
            edges=np.concatenate(rec["edges_parts"])
            if int(rec["e_starts"][-1])
            else np.zeros((0, 2), dtype=np.int64),
        )
        mesh.vertex_data["pos"] = np.concatenate(rec["pos_parts"])
        mesh.vertex_data["vol"] = np.concatenate(rec["vol_parts"])
        mesh.edge_data["flow"] = np.concatenate(rec["flow_parts"])
        cap = st.StokesLevel(
            A=sp.vstack(rec["A_parts"], format="csr"), mesh=mesh
        )
        cap.dofs = MeshDOFs.from_counts(
            np.concatenate(rec["cnt_parts"])
        )
        cap.pres = PreservedVectors(
            n_special, np.concatenate(rec["V_parts"], axis=0)
        )
        if rec["P_parts"] is not None:
            cap.P = sp.vstack(rec["P_parts"], format="csr")
            cap.v2agg = np.concatenate(rec["v2agg_parts"])
        levels.append(cap)
    return levels
