"""Facet-based Stokes AMG on the dual mesh (host setup).

Copied from ngsamg_tpu/apps/stokes.py (numpy/scipy only), the re-creation
of the reference's Stokes component (src/stokes/):

* The algebraic mesh is the DUAL mesh — vertices = elements (cells), edges =
  facets; the velocity DOF sits on the edge as a (signed) normal flux
  (`StokesAMGFactory : NodalAMGFactory<NT_EDGE,...>`, stokes_factory.hpp:75).
* Edge data carries the facet *flow* (oriented area) and vertex data the
  element volume (nc_stokes_mesh.hpp:19-39).
* Coarsening aggregates CELLS (``coarsen/lattice.py`` on lattices, else
  ``coarsen/pairwise.py``); coarse facets are the aggregated cross facets
  with oriented summed flows.
* The prolongation preserves flux and divergence: a coarse facet's flux is
  distributed over its fine facets proportionally to flow, and interior
  fine facets are reconstructed by routing each fine cell's volume share of
  the coarse divergence along a spanning forest of the aggregate — so
  divergence-free coarse fields prolongate to divergence-free fine fields
  (the reference's flow-preserving prolongation, stokes_factory.hpp:20-44).
* The potential space is spanned by facet LOOPS (discrete curls): short
  geometric loops around interior primal entities contracted level to
  level, elementary lattice 4-cycles, or fundamental cycles of a spanning
  forest (`CalcFacetLoops`, stokes_pc.cpp), yielding the curl matrix C per
  level that feeds the Hiptmair smoother.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..mesh.topo import AlgebraicMesh


@dataclass
class StokesLevel:
    """One Stokes level (the reference's `BaseStokesLevelCapsule`)."""

    A: sp.csr_matrix  # facet-DOF operator
    mesh: AlgebraicMesh  # dual mesh: vertices=cells, edges=facets
    P: sp.csr_matrix | None = None  # facet prolongation to this level
    C: sp.csr_matrix | None = None  # curl: loops -> facet space
    v2agg: np.ndarray | None = None
    # HDiv variant: variable per-facet DOFs + preserved vectors
    dofs: object | None = None  # apps.stokes_hdiv.MeshDOFs
    pres: object | None = None  # apps.stokes_hdiv.PreservedVectors


def build_dual_mesh(cell_pos, cell_vol, facet_cells, facet_flow, A=None):
    """Dual mesh from cell/facet geometry (interior facets only).

    ``facet_flow`` may be scalar (nf,) — normal-flux dofs — or a VECTOR
    (nf, dim) — the NC/CR case where each facet carries a velocity vector
    and the flow is the facet area-normal (the reference's facet flow
    vector, nc_stokes_mesh.hpp:19-39).
    """
    interior = (facet_cells >= 0).all(axis=1)
    edges = facet_cells[interior].astype(np.int64)
    # orient edges i < j, flipping the flow sign accordingly
    flip = edges[:, 0] > edges[:, 1]
    edges = np.where(flip[:, None], edges[:, ::-1], edges)
    fl = np.asarray(facet_flow)[interior]
    sgn = np.where(flip, -1.0, 1.0)
    flow = fl * (sgn[:, None] if fl.ndim == 2 else sgn)
    mesh = AlgebraicMesh(nv=len(cell_pos), edges=edges)
    mesh.vertex_data["pos"] = np.asarray(cell_pos, float)
    mesh.vertex_data["vol"] = np.asarray(cell_vol, float)
    mesh.edge_data["flow"] = flow
    return mesh, np.flatnonzero(interior)


def coarsen_cells(mesh: AlgebraicMesh, theta: float = 0.08):
    """Aggregate dual-mesh cells: lattice when possible, else SPW."""
    from ..coarsen.lattice import lattice_aggregate
    from ..coarsen.pairwise import spw_aggregate

    res = lattice_aggregate(mesh.vertex_data["pos"])
    if res is not None:
        return res
    w = _flow_mag(mesh.edge_data["flow"])
    S = mesh.edge_graph(weights=w)
    return spw_aggregate(S, rounds=2, theta=theta)


def _flow_mag(flow: np.ndarray) -> np.ndarray:
    return np.linalg.norm(flow, axis=1) if flow.ndim == 2 else np.abs(flow)


def map_stokes_mesh(mesh, v2agg, n_agg, coarse_edges, e2ce):
    """Coarse dual mesh with oriented flow sums + summed volumes."""
    cmesh = AlgebraicMesh(nv=n_agg, edges=coarse_edges)
    m = e2ce >= 0
    fi = mesh.edges[m]
    ce = e2ce[m]
    # orientation of the fine edge relative to its coarse edge
    sign = np.where(
        v2agg[fi[:, 0]] == coarse_edges[ce, 0], 1.0, -1.0
    )
    fl = mesh.edge_data["flow"]
    flow_c = np.zeros((len(coarse_edges),) + fl.shape[1:])
    np.add.at(
        flow_c, ce, fl[m] * (sign[:, None] if fl.ndim == 2 else sign)
    )
    cmesh.edge_data["flow"] = flow_c
    vol = np.zeros(n_agg)
    act = v2agg >= 0
    np.add.at(vol, v2agg[act], mesh.vertex_data["vol"][act])
    cmesh.vertex_data["vol"] = vol
    pos = mesh.vertex_data["pos"]
    cpos = np.zeros((n_agg, pos.shape[1]))
    wsum = np.zeros(n_agg)
    np.add.at(cpos, v2agg[act], pos[act] * mesh.vertex_data["vol"][act, None])
    np.add.at(wsum, v2agg[act], mesh.vertex_data["vol"][act])
    cmesh.vertex_data["pos"] = cpos / np.maximum(wsum, 1e-300)[:, None]
    return cmesh


def flow_prolongation(mesh, cmesh, v2agg, e2ce):
    """Divergence-preserving facet prolongation P: (ne_f, ne_c).

    Cross facets: U_E distributed over its fine facets proportionally to
    |flow| (oriented) so the total flux is preserved. Interior facets:
    each fine cell must end with div = (vol_i / vol_agg) * coarse div, so
    the per-cell excess is routed along a spanning forest of each
    aggregate's interior connectivity (exact, local, linear in U).
    """
    ne_f, ne_c = mesh.ne, cmesh.ne
    edges = mesh.edges
    flow = mesh.edge_data["flow"]
    vol = mesh.vertex_data["vol"]
    aggvol = cmesh.vertex_data["vol"]

    rows, cols, vals = [], [], []

    # --- cross facets -----------------------------------------------------
    cross = e2ce >= 0
    ce = e2ce[cross]
    sgn = np.where(v2agg[edges[cross, 0]] == cmesh.edges[ce, 0], 1.0, -1.0)
    wsum = np.zeros(ne_c)
    np.add.at(wsum, ce, np.abs(flow[cross]))
    # coarse DOF U_E is the TOTAL flux through E (in coarse orientation);
    # distribute proportionally to |flow| so the signed fine sum equals U_E
    wcoef = np.abs(flow[cross]) / np.maximum(wsum[ce], 1e-300)
    rows.append(np.flatnonzero(cross))
    cols.append(ce)
    vals.append(sgn * wcoef)

    # --- per-cell boundary influx b_i(U) as a sparse (ncell, ne_c) --------
    # fine cross facet e=(i,j) with value v_e(U_E): flux leaves i, enters j
    fe = np.flatnonzero(cross)
    i_c, j_c = edges[fe, 0], edges[fe, 1]
    # div convention: + for flow out of cell i (edge oriented i->j)
    Bin = sp.coo_matrix(
        (
            np.concatenate([sgn * wcoef, -sgn * wcoef]),
            (
                np.concatenate([i_c, j_c]),
                np.concatenate([ce, ce]),
            ),
        ),
        shape=(mesh.nv, ne_c),
    ).tocsr()
    # target outflux per cell: (vol_i / vol_I) * (net coarse outflux of I)
    # coarse cell I's outflux in terms of U: +U_E if I == E[0] else -U_E
    CI, CJ = cmesh.edges[:, 0], cmesh.edges[:, 1]
    Cout = sp.coo_matrix(
        (
            np.concatenate([np.ones(ne_c), -np.ones(ne_c)]),
            (np.concatenate([CI, CJ]), np.concatenate([np.arange(ne_c)] * 2)),
        ),
        shape=(cmesh.nv, ne_c),
    ).tocsr()
    frac = vol / np.maximum(aggvol[v2agg], 1e-300)
    Tgt = sp.diags(frac) @ Cout[v2agg]  # (ncell, ne_c)
    Excess = (Tgt - Bin).tocsr()  # flux each cell still must emit

    # --- route excess along a spanning forest of interior facets ----------
    # vectorized subtree-sum form: the flux a cell's PARENT facet must
    # carry is the signed sum of Excess over the cell's subtree (pushing
    # leaves-first is exactly that), so the routed correction is one
    # sparse product Sel @ S with S = (I - Par)^-1 Excess — Par nilpotent
    # (forest), computed by ~depth sparse mat-adds
    interior = np.flatnonzero(~cross)
    route = _route_subtree_sums(mesh, v2agg, interior, Excess)
    P = sp.coo_matrix(
        (
            np.concatenate(vals),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(ne_f, ne_c),
    ).tocsr()
    if route is not None:
        ch, pe, sgn_r, S = route
        Sel = sp.coo_matrix(
            (sgn_r, (pe, ch)), shape=(ne_f, mesh.nv)
        ).tocsr()
        P = (P + Sel @ S).tocsr()
    P.sum_duplicates()
    # flux -> velocity units: the construction above preserves INCIDENCE
    # divergence (dof-value sums); the systems' divergence is FLOW-weighted
    # (flux_e = flow_e * u_e), identical only for constant per-level flows
    # (MAC lattices). Conjugating by the flows makes D_f P = Frac @ D_c
    # hold exactly for ARBITRARY facet areas (simplicial meshes, coarse
    # levels with summed flows): coarse DOFs are velocity-like, their flux
    # is flow_c * U. Zero (cancelled) flows keep scale 1 so no coarse
    # column goes identically zero.
    gf = np.where(np.abs(flow) > 1e-300, 1.0 / np.where(flow == 0, 1.0, flow), 1.0)
    cflow = cmesh.edge_data["flow"]
    gc = np.where(np.abs(cflow) > 1e-300, cflow, 1.0)
    return (sp.diags(gf) @ P @ sp.diags(gc)).tocsr()


def flow_prolongation_vec(mesh, cmesh, v2agg, e2ce) -> sp.csr_matrix:
    """Divergence-preserving VECTOR facet prolongation: (ne_f*d, ne_c*d).

    The NC/CR case: each facet dof is a velocity VECTOR, flux_e =
    flow_vec_e . u_e (the reference's NC Stokes prolongation,
    stokes_factory.hpp:20-44 with vector flows). Construction:

    * cross facets copy the coarse velocity vector — the oriented flow
      vectors of a coarse facet SUM to its coarse flow, so total flux is
      preserved identically, and constant fields prolongate exactly;
    * interior facets start from the |flow|-weighted average of the
      aggregate's incident coarse vectors (still exact on constants);
    * each fine cell's flux imbalance against its volume share of the
      coarse divergence is routed along a spanning forest with
      NORMAL-direction corrections u_e += s * (excess/|flow_e|^2) flow_e —
      divergence-free coarse fields prolongate divergence-free.
    """
    flow = mesh.edge_data["flow"]  # (ne_f, d) oriented i -> j
    cflow = cmesh.edge_data["flow"]
    dim = flow.shape[1]
    ne_f, ne_c = mesh.ne, cmesh.ne
    edges = mesh.edges
    vol = mesh.vertex_data["vol"]
    aggvol = cmesh.vertex_data["vol"]
    k = np.arange(dim)

    rows, cols, vals = [], [], []
    cross = e2ce >= 0
    fe = np.flatnonzero(cross)
    ce = e2ce[fe]
    rows.append((fe[:, None] * dim + k).ravel())
    cols.append((ce[:, None] * dim + k).ravel())
    vals.append(np.ones(len(fe) * dim))

    # interior base: |cflow|-weighted average of incident coarse vectors
    wE = np.linalg.norm(cflow, axis=1)
    CI, CJ = cmesh.edges[:, 0], cmesh.edges[:, 1]
    AggInc = sp.coo_matrix(
        (
            np.concatenate([wE, wE]),
            (np.concatenate([CI, CJ]), np.concatenate([np.arange(ne_c)] * 2)),
        ),
        shape=(cmesh.nv, ne_c),
    ).tocsr()
    wsum = np.asarray(AggInc.sum(axis=1)).ravel()
    Wavg = sp.diags(1.0 / np.maximum(wsum, 1e-300)) @ AggInc
    interior_e = np.flatnonzero(~cross)
    if len(interior_e):
        Bco = Wavg[v2agg[edges[interior_e, 0]]].tocoo()
        rows.append((interior_e[Bco.row][:, None] * dim + k).ravel())
        cols.append((Bco.col[:, None] * dim + k).ravel())
        vals.append(np.repeat(Bco.data, dim))

    P0 = sp.coo_matrix(
        (
            np.concatenate(vals),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(ne_f * dim, ne_c * dim),
    ).tocsr()
    P0.sum_duplicates()

    # per-cell flux imbalance Excess(U) = Tgt - D_f P0, all linear in U
    rD = np.concatenate(
        [np.repeat(edges[:, 0], dim), np.repeat(edges[:, 1], dim)]
    )
    cD = np.concatenate([np.arange(ne_f * dim)] * 2)
    vD = np.concatenate([flow.ravel(), -flow.ravel()])
    Df = sp.coo_matrix((vD, (rD, cD)), shape=(mesh.nv, ne_f * dim)).tocsr()
    rC = np.concatenate([np.repeat(CI, dim), np.repeat(CJ, dim)])
    cC = np.concatenate([np.arange(ne_c * dim)] * 2)
    vC = np.concatenate([cflow.ravel(), -cflow.ravel()])
    Cout = sp.coo_matrix(
        (vC, (rC, cC)), shape=(cmesh.nv, ne_c * dim)
    ).tocsr()
    frac = vol / np.maximum(aggvol[v2agg], 1e-300)
    Excess = (sp.diags(frac) @ Cout[v2agg] - Df @ P0).tocsr()

    # route excess along a spanning forest, corrections along the normal
    # (vectorized subtree-sum form — see flow_prolongation): the routed
    # flux lifts to the facet velocity u_e = flux * flow_e / |flow_e|^2
    route = _route_subtree_sums(mesh, v2agg, interior_e, Excess)
    if route is not None:
        ch, pe, sgn_r, S = route
        f2 = (flow * flow).sum(axis=1)
        live = f2[pe] > 1e-300
        ch, pe, sgn_r = ch[live], pe[live], sgn_r[live]
        if len(ch):
            k = np.arange(dim)
            coef = (sgn_r / f2[pe])[:, None] * flow[pe]  # (nch, dim)
            Sel = sp.coo_matrix(
                (
                    coef.ravel(),
                    (
                        (pe[:, None] * dim + k).ravel(),
                        np.repeat(ch, dim),
                    ),
                ),
                shape=(ne_f * dim, mesh.nv),
            ).tocsr()
            P0 = (P0 + Sel @ S).tocsr()
    return P0


def build_loops_vec(
    mesh: AlgebraicMesh, incidence: sp.spmatrix | None = None
) -> sp.csr_matrix | None:
    """ker(D)-spanning curl basis for VECTOR facet dofs.

    flux_e = flow_vec_e . u_e, so ker(D) = {normal loop lifts} ⊕
    {per-facet tangential fields}:

    * each incidence cycle y lifts to u_e = y_e flow_e / |flow_e|^2
      (flux exactly y_e along the cycle);
    * every single-facet tangential field carries zero flux — and MUST be
      in the potential space: its energy is pure grad-grad, which a range
      smoother tuned to the alpha-scaled spectrum never damps (measured
      324 -> ~30 iterations at alpha=1e3 with/without the tangential
      columns).

    Together the columns span ker(D) exactly. Facets whose flow vector
    cancelled to zero (coarse oriented sums) carry no flux in ANY
    direction: they stay out of the cycle graph and contribute ``dim``
    standard-basis columns instead (their normal is undefined).
    """
    flow = mesh.edge_data["flow"]
    ne, dim = flow.shape
    f2 = (flow * flow).sum(axis=1)
    act = f2 > 1e-300
    if incidence is None:
        C = _loops_incidence(mesh, active=act)
    else:
        C = _drop_dead_columns(incidence, act)
    nrm = np.sqrt(np.maximum(f2, 1e-300))
    g = flow / np.maximum(f2, 1e-300)[:, None]
    rows_l, cols_l, vals_l = [], [], []
    nl = 0
    if C is not None:
        Cc = C.tocoo()
        k = np.arange(dim)
        rows_l.append((Cc.row[:, None] * dim + k).ravel())
        cols_l.append(np.repeat(Cc.col, dim))
        vals_l.append((Cc.data[:, None] * g[Cc.row]).ravel())
        nl = C.shape[1]
    # orthonormal tangent frame per ACTIVE facet (complement of n)
    n_unit = flow / nrm[:, None]
    if dim == 2:
        tangents = [np.stack([-n_unit[:, 1], n_unit[:, 0]], axis=1)]
    else:
        # any vector not parallel to n, Gram-Schmidt twice
        a = np.zeros_like(n_unit)
        small = np.argmin(np.abs(n_unit), axis=1)
        a[np.arange(ne), small] = 1.0
        t1 = a - (a * n_unit).sum(axis=1)[:, None] * n_unit
        t1 /= np.maximum(np.linalg.norm(t1, axis=1), 1e-300)[:, None]
        t2 = np.cross(n_unit, t1)
        tangents = [t1, t2]
    k = np.arange(dim)
    act_e = np.flatnonzero(act)
    for t_vec in tangents:
        rows_l.append((act_e[:, None] * dim + k).ravel())
        cols_l.append(np.repeat(nl + np.arange(len(act_e)), dim))
        vals_l.append(t_vec[act_e].ravel())
        nl += len(act_e)
    dead = np.flatnonzero(~act)
    if len(dead):
        # all dim directions of a flux-free facet lie in ker(D)
        rows_l.append((dead[:, None] * dim + k).ravel())
        cols_l.append(nl + np.arange(len(dead) * dim))
        vals_l.append(np.ones(len(dead) * dim))
        nl += len(dead) * dim
    if nl == 0:
        return None
    return sp.coo_matrix(
        (
            np.concatenate(vals_l),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(ne * dim, nl),
    ).tocsr()


def _route_subtree_sums(mesh, v2agg, interior_edges, Excess):
    """Signed subtree excess sums for the forest routing, vectorized.

    For each cell c with a parent facet in the aggregate-local spanning
    forest, the flux its parent facet must carry equals the sum of
    ``Excess`` over c's subtree (the leaves-first elimination in closed
    form). S = (I - Par)^-1 Excess via the nilpotent series — at most
    tree-depth sparse mat-adds, with aggregate-bounded depth.

    Returns (cells, parent_facets, signs (+1 = facet oriented
    cell -> parent), S (nv x ncols subtree sums)) or None.
    """
    parent_edge, _ = _spanning_forest(mesh, v2agg, interior_edges)
    ch = np.flatnonzero(parent_edge >= 0)
    if len(ch) == 0:
        return None
    pe = parent_edge[ch]
    ei, ej = mesh.edges[pe, 0], mesh.edges[pe, 1]
    par_of = np.where(ei == ch, ej, ei)
    sgn = np.where(ei == ch, 1.0, -1.0)
    Par = sp.coo_matrix(
        (np.ones(len(ch)), (par_of, ch)), shape=(mesh.nv, mesh.nv)
    ).tocsr()
    S = Excess.tocsr()
    T = (Par @ S).tocsr()
    guard = 0
    while T.nnz:
        S = (S + T).tocsr()
        T = (Par @ T).tocsr()
        guard += 1
        if guard > mesh.nv:  # cannot happen: Par is a forest (nilpotent)
            raise RuntimeError("routing forest contains a cycle")
    return ch, pe, sgn, S


def _spanning_forest(mesh, v2agg, interior_edges):
    """BFS spanning forest of each aggregate over interior facets.

    Returns (parent_edge (ncell,), order): parent facet of each cell (-1
    for aggregate roots) and a leaves-first processing order.
    """
    nv = mesh.nv
    adj = {}
    for e in interior_edges:
        i, j = mesh.edges[e]
        adj.setdefault(i, []).append((j, e))
        adj.setdefault(j, []).append((i, e))
    parent_edge = np.full(nv, -1, dtype=np.int64)
    visited = np.zeros(nv, dtype=bool)
    order = []
    for root in range(nv):
        if visited[root]:
            continue
        visited[root] = True
        stack = [root]
        bfs = [root]
        while stack:
            c = stack.pop()
            for nb, e in adj.get(c, ()):
                if not visited[nb] and v2agg[nb] == v2agg[c]:
                    visited[nb] = True
                    parent_edge[nb] = e
                    stack.append(nb)
                    bfs.append(nb)
        order.extend(reversed(bfs))
    return parent_edge, order


def build_loops_tree(
    mesh: AlgebraicMesh, incidence: sp.spmatrix | None = None
) -> sp.csr_matrix | None:
    """Flow-scaled incidence-cycle curl basis (any mesh, scalar dofs).

    Facets whose (coarse, oriented-sum) flow cancelled to zero carry no
    flux for ANY dof value: they are flux-free kernel directions of their
    own and must be EXCLUDED from the cycle graph — a cycle routed
    through one loses that edge's flux and stops being divergence-free.
    Each gets a singleton column instead; together with the cycles of the
    nonzero-flow subgraph the columns span ker(D) exactly.

    ``incidence``: precomputed incidence cycles (entries w.r.t. the dual
    edge orientation) — geometric loops or level-contracted loops
    (:func:`geometric_loops` / :func:`contract_loops`). Columns touching a
    dead (zero-flow) facet are dropped (their live part is an open chain,
    not a cycle of the live subgraph). Default: BFS fundamental cycles of
    the live subgraph (:func:`_loops_incidence`).
    """
    flow = mesh.edge_data["flow"]
    act = np.abs(flow) > 1e-300
    if incidence is None:
        C = _loops_incidence(mesh, active=act)
    else:
        C = _drop_dead_columns(incidence, act)
    cols = []
    if C is not None:
        cols.append(_flow_scale(mesh) @ C)
    dead = np.flatnonzero(~act)
    if len(dead):
        cols.append(
            sp.coo_matrix(
                (np.ones(len(dead)), (dead, np.arange(len(dead)))),
                shape=(mesh.ne, len(dead)),
            ).tocsr()
        )
    if not cols:
        return None
    return sp.hstack(cols, format="csr")


def _drop_dead_columns(Y: sp.spmatrix, act: np.ndarray):
    """Drop loop columns that touch a dead (zero-flow) facet row."""
    Yc = Y.tocsc()
    if Yc.nnz == 0:
        return None
    touch_dead = np.zeros(Yc.shape[1], dtype=bool)
    dead_rows = ~act
    if dead_rows.any():
        mask = dead_rows[Yc.indices]
        if mask.any():
            col_of = np.repeat(
                np.arange(Yc.shape[1]), np.diff(Yc.indptr)
            )
            touch_dead = (
                np.bincount(col_of[mask], minlength=Yc.shape[1]) > 0
            )
    keep = ~touch_dead
    if not keep.any():
        return None
    return Yc[:, keep].tocsr()


def geometric_loops(
    mesh: AlgebraicMesh,
    facet_verts: np.ndarray,
    vert_pos: np.ndarray,
    bnd_facet_verts: np.ndarray,
) -> sp.csr_matrix | None:
    """SHORT incidence cycles from the primal mesh geometry.

    The reference's `CalcFacetLoops` (src/stokes/common/stokes_pc.cpp):
    in 2D one loop per interior primal VERTEX (the facets incident to it,
    i.e. the dual-graph face around it), in 3D one loop per interior
    primal EDGE (the facets sharing it — the fan of cells around the
    edge). Loop length = local degree (~6), so the potential operator
    C^T A C stays O(1)-sparse per row — unlike fundamental-cycle bases,
    whose O(diameter) tree paths densify it quadratically (measured
    126 s setup at 10.7k DoF before this).

    Parameters: ``facet_verts`` (ne, dim) primal vertex ids of each
    INTERIOR facet, aligned with ``mesh.edges``; ``vert_pos`` primal
    vertex coordinates; ``bnd_facet_verts`` vertex ids of the boundary
    (eliminated) facets — loops are built only around primal entities
    with a CLOSED interior fan, i.e. not touching the boundary surface.

    Entries are +-1 w.r.t. the dual edge orientation (``mesh.edges``),
    so columns are exact incidence cycles; a final boundary-operator
    check drops any non-cycle column (degenerate geometry).
    """
    pos = mesh.vertex_data["pos"]  # dual (cell centroid) positions
    e = mesh.edges
    ne = len(e)
    fv = np.asarray(facet_verts, dtype=np.int64)
    if ne == 0 or fv.shape[0] != ne:
        return None
    d = pos[e[:, 1]] - pos[e[:, 0]]  # dual edge vectors
    vp = np.asarray(vert_pos, float)
    dim = vp.shape[1]
    rows_l, cols_l, vals_l = [], [], []
    if dim == 2:
        # one loop per interior primal vertex: each interior facet (a
        # segment v--w) contributes to the loops of both endpoints
        is_bnd = np.zeros(len(vp), dtype=bool)
        if len(bnd_facet_verts):
            is_bnd[np.unique(np.asarray(bnd_facet_verts, np.int64))] = True
        anchors = []
        for s_ in (0, 1):
            v, w = fv[:, s_], fv[:, 1 - s_]
            keep = ~is_bnd[v]
            if not keep.any():
                continue
            u = vp[w[keep]] - vp[v[keep]]
            cr = u[:, 0] * d[keep, 1] - u[:, 1] * d[keep, 0]
            rows_l.append(np.flatnonzero(keep))
            anchors.append(v[keep])
            vals_l.append(np.where(cr > 0, 1.0, -1.0))
        if not rows_l:
            return None
        anchors = np.concatenate(anchors)
        _, loop_of = np.unique(anchors, return_inverse=True)
        cols_l = [loop_of]
    else:
        # one loop per interior primal edge: each interior facet (a
        # triangle) contributes to the loops of its 3 edges
        nvert = len(vp)
        bnd_keys = np.empty(0, dtype=np.int64)
        if len(bnd_facet_verts):
            bf = np.asarray(bnd_facet_verts, np.int64)
            pk = []
            for a_i, b_i in ((0, 1), (0, 2), (1, 2)):
                lo = np.minimum(bf[:, a_i], bf[:, b_i])
                hi = np.maximum(bf[:, a_i], bf[:, b_i])
                pk.append(lo * nvert + hi)
            bnd_keys = np.unique(np.concatenate(pk))
        keys_l, rws, vls = [], [], []
        for a_i, b_i, w_i in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
            a, b, w = fv[:, a_i], fv[:, b_i], fv[:, w_i]
            lo = np.minimum(a, b)
            hi = np.maximum(a, b)
            key = lo * nvert + hi
            keep = ~np.isin(key, bnd_keys, assume_unique=False)
            if not keep.any():
                continue
            t = vp[hi[keep]] - vp[lo[keep]]
            u = vp[w[keep]] - 0.5 * (vp[lo[keep]] + vp[hi[keep]])
            s_ = np.sign((np.cross(t, u) * d[keep]).sum(axis=1))
            nz = s_ != 0
            rws.append(np.flatnonzero(keep)[nz])
            keys_l.append(key[keep][nz])
            vls.append(s_[nz])
        if not keys_l:
            return None
        keys = np.concatenate(keys_l)
        _, loop_of = np.unique(keys, return_inverse=True)
        rows_l = rws
        cols_l = [loop_of]
        vals_l = vls
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l) if len(cols_l) > 1 else cols_l[0]
    vals = np.concatenate(vals_l)
    nl = int(cols.max()) + 1
    Y = sp.coo_matrix((vals, (rows, cols)), shape=(ne, nl)).tocsc()
    # boundary-operator check: keep exact cycles only
    B = sp.coo_matrix(
        (
            np.concatenate([np.ones(ne), -np.ones(ne)]),
            (
                np.concatenate([e[:, 0], e[:, 1]]),
                np.concatenate([np.arange(ne)] * 2),
            ),
        ),
        shape=(mesh.nv, ne),
    ).tocsr()
    resid = B @ Y
    bad = np.flatnonzero(
        np.abs(resid).max(axis=0).toarray().ravel() > 1e-12
    )
    if len(bad):
        keep = np.ones(Y.shape[1], dtype=bool)
        keep[bad] = False
        if not keep.any():
            return None
        Y = Y[:, keep]
    return Y.tocsr()


def contract_loops(
    Y: sp.spmatrix,
    mesh: AlgebraicMesh,
    v2agg: np.ndarray,
    cedges: np.ndarray,
    e2ce: np.ndarray,
) -> sp.csr_matrix | None:
    """Contract incidence loops through one dual-mesh coarsening step.

    Cell aggregation is a graph CONTRACTION of the dual graph (connected
    aggregates collapse, parallel facets merge), and the quotient chain
    map sends cycles to cycles: the image of a spanning set of the fine
    cycle space SPANS the coarse cycle space. So the loop set transfers
    level-to-level exactly — the coarse analog of the reference
    re-deriving loops on its coarse (still topological) meshes — while
    staying SHORT: a contracted loop has at most its fine length.

    Rows map fine facet -> coarse facet with the `map_stokes_mesh`
    orientation sign; zero columns (loops swallowed by one aggregate) are
    dropped; duplicate columns (up to sign) are deduplicated.
    """
    if Y is None:
        return None
    m = e2ce >= 0
    if not m.any():
        return None
    fe = np.flatnonzero(m)
    ce = e2ce[fe]
    sign = np.where(
        v2agg[mesh.edges[fe, 0]] == cedges[ce, 0], 1.0, -1.0
    )
    T = sp.coo_matrix(
        (sign, (ce, fe)), shape=(len(cedges), Y.shape[0])
    ).tocsr()
    Yc = (T @ Y).tocsc()
    Yc.eliminate_zeros()
    nz = np.diff(Yc.indptr) > 0
    if not nz.any():
        return None
    Yc = Yc[:, nz]
    # dedupe columns up to sign: normalize leading entry positive, hash
    indptr, indices, data = Yc.indptr, Yc.indices, Yc.data
    seen: dict[bytes, int] = {}
    keep = []
    for j in range(Yc.shape[1]):
        s0, s1 = indptr[j], indptr[j + 1]
        dj = data[s0:s1]
        if dj[0] < 0:
            dj = -dj
        key = indices[s0:s1].tobytes() + dj.tobytes()
        if key not in seen:
            seen[key] = j
            keep.append(j)
    if len(keep) < Yc.shape[1]:
        Yc = Yc[:, np.asarray(keep, dtype=np.int64)]
    return Yc.tocsr()


def _loops_incidence(
    mesh: AlgebraicMesh, active: np.ndarray | None = None
) -> sp.csr_matrix | None:
    """Fundamental-cycle basis of the dual graph's UNWEIGHTED incidence.

    The discrete divergence D is the signed cell-facet incidence operator
    of the dual graph, so ker(D) is EXACTLY the graph's cycle space; the
    fundamental cycles of a spanning forest form a basis of it: one loop
    per non-tree facet e=(a,b) — e followed by the tree path b -> a. BFS
    keeps the paths (hence the potential-operator stencil) short. This is
    the general-mesh replacement for the reference's geometric
    `CalcFacetLoops` (src/stokes/common/stokes_pc.cpp): same span, built
    from the algebraic dual graph alone — Hiptmair survives coarsening
    and irregular meshes.
    """
    from collections import deque

    nv, ne = mesh.nv, mesh.ne
    edges = mesh.edges
    adj: list[list] = [[] for _ in range(nv)]
    for e in range(ne):
        if active is not None and not active[e]:
            continue  # flux-free facets stay out of the cycle graph
        i, j = int(edges[e, 0]), int(edges[e, 1])
        adj[i].append((j, e))
        adj[j].append((i, e))
    parent = np.full(nv, -1, dtype=np.int64)
    pedge = np.full(nv, -1, dtype=np.int64)
    depth = np.zeros(nv, dtype=np.int64)
    intree = np.zeros(ne, dtype=bool)
    visited = np.zeros(nv, dtype=bool)
    for root in range(nv):
        if visited[root]:
            continue
        visited[root] = True
        q = deque([root])
        while q:
            c = q.popleft()
            for nb, e in adj[c]:
                if not visited[nb]:
                    visited[nb] = True
                    parent[nb] = c
                    pedge[nb] = e
                    depth[nb] = depth[c] + 1
                    intree[e] = True
                    q.append(nb)
    rows, cols, vals = [], [], []
    nl = 0
    for e in range(ne):
        if intree[e] or (active is not None and not active[e]):
            continue
        a, b = int(edges[e, 0]), int(edges[e, 1])
        coef: dict[int, float] = {e: 1.0}  # traversal a -> b
        u, v = b, a  # climb b -> lca (forward) and a -> lca (reversed)
        while u != v:
            if depth[u] >= depth[v]:
                ed = int(pedge[u])
                s = 1.0 if int(edges[ed, 0]) == u else -1.0
                coef[ed] = coef.get(ed, 0.0) + s
                u = int(parent[u])
            else:
                ed = int(pedge[v])
                s = 1.0 if int(edges[ed, 0]) == v else -1.0
                coef[ed] = coef.get(ed, 0.0) - s
                v = int(parent[v])
        for ed, s in coef.items():
            if s != 0.0:
                rows.append(ed)
                cols.append(nl)
                vals.append(s)
        nl += 1
    if nl == 0:
        return None
    return sp.coo_matrix((vals, (rows, cols)), shape=(ne, nl)).tocsr()


def build_loops(
    mesh: AlgebraicMesh, incidence: sp.spmatrix | None = None
) -> sp.csr_matrix | None:
    """Curl matrix C: loops -> facet space (`CalcFacetLoops` analog).

    With ``incidence`` (geometric finest loops or level-contracted loops):
    flow-scale those — the simplicial fast path. Otherwise, on lattice
    dual meshes: the elementary 4-cycles (in 2D one loop per interior
    primal node, in 3D one per interior primal edge) — short, geometric,
    like the reference. Off-lattice with no incidence given: the
    spanning-forest fundamental cycle basis (:func:`build_loops_tree`),
    which spans ker(D) on any dual graph but carries O(diameter) loops.
    """
    from ..coarsen.lattice import detect_lattice

    if incidence is not None:
        return build_loops_tree(mesh, incidence=incidence)
    det = detect_lattice(mesh.vertex_data["pos"])
    if det is None:
        return build_loops_tree(mesh)
    idx, dims = det
    d = idx.shape[1]
    if d < 2:
        return build_loops_tree(mesh)
    cell_of = -np.ones(tuple(int(x) for x in dims), dtype=np.int64)
    cell_of[tuple(idx.T)] = np.arange(mesh.nv)
    ekey = {}
    for e, (i, j) in enumerate(mesh.edges):
        ekey[(int(i), int(j))] = e

    def get_edge(a, b):
        if a < 0 or b < 0:
            return None
        if a < b:
            e = ekey.get((a, b))
            return (e, 1.0) if e is not None else None
        e = ekey.get((b, a))
        return (e, -1.0) if e is not None else None

    rows, cols, vals = [], [], []
    nl = 0
    for a1 in range(d):
        for a2 in range(a1 + 1, d):
            e1 = np.zeros(d, dtype=np.int64)
            e2 = np.zeros(d, dtype=np.int64)
            e1[a1] = 1
            e2[a2] = 1
            it_dims = [
                int(dims[k]) - (1 if k in (a1, a2) else 0) for k in range(d)
            ]
            for flat in range(int(np.prod(it_dims))):
                base = []
                r = flat
                for k in reversed(it_dims):
                    base.append(r % k)
                    r //= k
                base = np.asarray(base[::-1], dtype=np.int64)
                c00 = cell_of[tuple(base)]
                c10 = cell_of[tuple(base + e1)]
                c11 = cell_of[tuple(base + e1 + e2)]
                c01 = cell_of[tuple(base + e2)]
                legs = [
                    get_edge(c00, c10),
                    get_edge(c10, c11),
                    get_edge(c11, c01),
                    get_edge(c01, c00),
                ]
                if any(l is None for l in legs):
                    continue
                for e, s in legs:
                    rows.append(e)
                    cols.append(nl)
                    vals.append(s)
                nl += 1
    if nl == 0:
        return build_loops_tree(mesh)
    C = sp.coo_matrix((vals, (rows, cols)), shape=(mesh.ne, nl)).tocsr()
    return _flow_scale(mesh) @ C


def _flow_scale(mesh: AlgebraicMesh) -> sp.dia_matrix:
    """diag(1/flow): converts incidence-cycle fields into ker(D) fields.

    The divergence is FLOW-weighted (flux through facet e = flow_e * u_e),
    so a cycle y of the unweighted incidence becomes the divergence-free
    dof field u_e = y_e / flow_e. On constant-flow (MAC) lattices this is
    a harmless global scale; on simplicial meshes (varying facet areas)
    and coarse levels (summed flows) it is required for D @ C == 0.
    Zero-flow facets (cancelling oriented sums on coarse levels) carry no
    flux for any dof value and keep scale 1.
    """
    flow = mesh.edge_data["flow"]
    s = np.where(np.abs(flow) > 1e-300, 1.0 / np.where(flow == 0, 1.0, flow), 1.0)
    return sp.diags(s)
