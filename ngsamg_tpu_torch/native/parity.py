"""Each native setup wrapper against its numpy branch, on one problem.

:func:`block_setup_parity`: the elasticity setup (ROADMAP item 10b)
reaches fifteen wrappers of ``ngsamg_tpu_torch.native``. It sets up the
host hierarchy of an elasticity problem with the native branches, takes its
finest level (matrix, mesh, aggregation, prolongation) and the next
level's mesh, and runs every one of those wrappers' callers twice on the
same inputs: with ``native.HAVE_NATIVE`` on, and off (the numpy branch
beside the call). Integer outputs (indptr, indices, integer arrays) must be
equal; float outputs agree within ``TOLERANCES[wrapper]`` (max |native -
numpy| over max |numpy|). The native robust SOC and pencil eigenvalues come
from a Jacobi eigensolver, numpy's from LAPACK, and the power iteration and
the products sum in another order, hence the tolerances.

:func:`scalar_setup_parity` does the same for the sixteen scalar-setup and
staging wrappers (item 10c) on the finest level and the first coarse level
of a scalar H1 hierarchy: the finest mesh, the matching rounds, the edge
maps, the smoothed prolongation, the Galerkin product, the coloring, the
cluster detection, the row permutation, the scaling and the tile-ELL
packers. Edges, partners, aggregates, colours, cluster sets, permutations
and tile columns are integers and must be equal; values agree within
``SCALAR_TOLERANCES``.

tests/test_torch_native.py runs both on small problems; chip_smoke.py's
``[native]`` phase on ``unstructured_elasticity(12, dim=3, refine=1)`` and
``unstructured_poisson(16, dim=3, refine=1)``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.sparse as sp

# per wrapper: the bound on max |native - numpy| / max |numpy|
TOLERANCES = {
    "frob2_sym": 0.0,
    "elast_ahat_bsr": 1e-12,
    "rigid_edge_blocks": 1e-12,
    "bsr_from_edge_blocks": 1e-12,
    "elast_rm_diag": 1e-12,
    "harmonic_mean_sym": 1e-10,
    "elast_soc_robust": 1e-9,
    "pencil_extreme_eig": 1e-9,
    "elast_map_edge_mats": 1e-12,
    "rho_power": 1e-10,
    "bsr_mm": 1e-12,
    "rap_bsr": 1e-12,
    "bsr_smooth_update": 1e-10,
    "truncate_prol_blocks": 1e-10,
    "bsr_sym_scale": 1e-15,
}


@contextlib.contextmanager
def _switch(on: bool):
    from .. import native

    old = native.HAVE_NATIVE
    native.HAVE_NATIVE = on
    try:
        yield
    finally:
        native.HAVE_NATIVE = old


def _parts(x):
    """(integer arrays, float arrays) of a result: the index arrays of a
    sparse matrix (sorted), or the arrays of a tuple."""
    if sp.issparse(x):
        if x.format == "bsr":
            x = x.copy()
            x.sort_indices()
            return [x.indptr, x.indices], [x.data]
        x = x.tocsr()
        x.sort_indices()
        return [x.indptr, x.indices], [x.data]
    if isinstance(x, (tuple, list)):
        ints, floats = [], []
        for y in x:
            i, f = _parts(y)
            ints += i
            floats += f
        return ints, floats
    x = np.asarray(x)
    if x.dtype.kind in "iub":
        return [x.astype(np.int64)], []
    return [], [x.astype(np.float64)]


def _compare(name, native_out, numpy_out, tolerances=TOLERANCES) -> dict:
    ia, fa = _parts(native_out)
    ib, fb = _parts(numpy_out)
    ints_equal = len(ia) == len(ib) and all(
        a.shape == b.shape and np.array_equal(a, b) for a, b in zip(ia, ib)
    )
    rel = 0.0
    for a, b in zip(fa, fb):
        if a.shape != b.shape:
            rel = float("inf")
            break
        scale = np.abs(b).max(initial=0.0)
        d = np.abs(a - b).max(initial=0.0)
        rel = max(rel, d / scale if scale > 0 else d)
    tol = tolerances[name]
    return {
        "wrapper": name,
        "ints_equal": bool(ints_equal),
        "max_rel_diff": rel,
        "tol": tol,
        "ok": bool(ints_equal and len(fa) == len(fb) and rel <= tol),
    }


def block_setup_parity(A, coords, dim: int) -> list[dict]:
    """One row per block-setup wrapper: its callers with the switch on and
    off on the finest level of ``A``'s elasticity hierarchy, the integer
    outputs compared exactly, the float ones against ``TOLERANCES``, and
    the native calls the switch-on run made (``native_calls``, > 0)."""
    from .. import native
    from ..apps.elasticity import (
        ElasticityEnergy,
        _frob2T,
        _pencil_extreme_eig,
    )
    from ..config import AMGOptions, SmootherOptions, SmootherType
    from ..factory.levels import setup_levels
    from ..mesh.topo import map_edges
    from ..precond.amg import _sym_scale
    from ..smoothers.build import _lam_max_estimate
    from ..sparse.host import block_diagonal_fast, to_bsr
    from ..transfer.galerkin import rap
    from ..transfer.prolongation import (
        _smoothed_block,
        piecewise_prol,
        truncate_prol,
    )

    en = ElasticityEnergy(dim)
    opts = AMGOptions(
        smoother=SmootherOptions(type=SmootherType.CHEBYSHEV)
    )
    with _switch(True):
        levels, _log = setup_levels(A.tocsr(), en, opts, coords)
    if len(levels) < 2:
        raise ValueError("the problem must coarsen at least once")
    lev0, lev1 = levels[0], levels[1]
    mesh0, mesh1 = lev0.mesh, lev1.mesh
    A0, P0, v2agg = lev0.A, lev0.P, lev0.v2agg
    bs, dpv = lev0.row_bs, en.dpv
    edges, E = mesh0.edges, mesh0.edge_data["mat"]
    cedges, e2ce = map_edges(mesh0, v2agg, mesh1.nv)
    Ppw = piecewise_prol(en, mesh0, mesh1, v2agg)
    with _switch(True):
        Ahat = en.replacement_matrix(mesh0)
        D = en.aux_diagonal(mesh0)
        P_smooth = _smoothed_block(
            en, mesh0, v2agg, Ppw, omega=4.0 / 3.0, A=A0, row_bs=bs,
            max_classic=5,
        )
    with _switch(False):
        blocks = en._edge_rm_blocks(mesh0)
    Dv = np.zeros((mesh0.nv, dpv, dpv))
    idx = np.arange(dim)
    Dv[:, idx, idx] = mesh0.vertex_data["l2wt"][:, None]
    # the pencil pairs of the robust SOC: the aux diagonals transported to
    # each edge's midpoint, and their series energy
    pos = mesh0.vertex_data["pos"]
    mid = 0.5 * (pos[edges[:, 0]] + pos[edges[:, 1]])
    Qmi = en.transport(mid, pos[edges[:, 0]])
    Qmj = en.transport(mid, pos[edges[:, 1]])
    di = np.swapaxes(Qmi, -1, -2) @ (D[edges[:, 0]] @ Qmi)
    dj = np.swapaxes(Qmj, -1, -2) @ (D[edges[:, 1]] @ Qmj)
    with _switch(True):
        C = native.harmonic_mean_sym(di, dj, rcond=1e-12)
    Dinv0 = np.linalg.pinv(block_diagonal_fast(to_bsr(A0, bs), bs))
    A0_bsr = to_bsr(A0, bs).copy()
    A0_bsr.sort_indices()
    Ppw_b = Ppw.tobsr(blocksize=(dpv, dpv))

    def sorted_product():
        C = (Ahat @ Ppw_b).tobsr(blocksize=(dpv, dpv))
        C.sort_indices()
        return C

    def series_energy():
        # the numpy branch of ElasticityEnergy.soc_robust
        T = di @ np.linalg.pinv(di + dj, rcond=1e-12, hermitian=True) @ dj
        return 0.5 * (T + np.transpose(T, (0, 2, 1)))

    def block_rap():
        Ac_b = native.rap_bsr(to_bsr(A0, bs), P0)
        Ac = Ac_b.tocsr()
        Ac.eliminate_zeros()
        return Ac

    # wrapper: (the native side, the numpy side); each runs with the
    # switch on and off respectively
    cases = {
        "frob2_sym": (lambda: _frob2T(E),) * 2,
        "elast_ahat_bsr": (lambda: en.replacement_matrix(mesh0),) * 2,
        "rigid_edge_blocks": (lambda: en._edge_rm_blocks(mesh0),) * 2,
        "bsr_from_edge_blocks": (
            lambda: native.bsr_from_edge_blocks(edges, *blocks, Dv),
            lambda: en.replacement_matrix(mesh0),
        ),
        "elast_rm_diag": (lambda: en.aux_diagonal(mesh0),) * 2,
        "harmonic_mean_sym": (
            lambda: native.harmonic_mean_sym(di, dj, rcond=1e-12),
            series_energy,
        ),
        "elast_soc_robust": (lambda: en.soc_robust(mesh0),) * 2,
        "pencil_extreme_eig": (lambda: _pencil_extreme_eig(E, C),) * 2,
        "elast_map_edge_mats": (
            lambda: en.map_data(mesh0, v2agg, mesh1.nv, cedges,
                                e2ce).edge_data["mat"],) * 2,
        "rho_power": (lambda: _lam_max_estimate(A0, bs, Dinv0),) * 2,
        "bsr_mm": (lambda: native.bsr_mm(Ahat, Ppw_b), sorted_product),
        "rap_bsr": (
            block_rap,
            lambda: rap(A0, P0, dtype=np.float64, bs_r=bs, bs_c=dpv),
        ),
        "bsr_smooth_update": (
            lambda: _smoothed_block(
                en, mesh0, v2agg, Ppw, omega=4.0 / 3.0, A=A0, row_bs=bs,
                max_classic=5,
            ),) * 2,
        "truncate_prol_blocks": (
            lambda: truncate_prol(en, mesh1, P_smooth.copy(),
                                  max_per_row=4, min_frac=0.1),) * 2,
        "bsr_sym_scale": (lambda: _sym_scale(A0_bsr)[0],) * 2,
    }
    rows = []
    for name, (fn_native, fn_numpy) in cases.items():
        before = native.CALLS[name]["native"]
        with _switch(True):
            a = fn_native()
        calls = native.CALLS[name]["native"] - before
        with _switch(False):
            b = fn_numpy()
        row = _compare(name, a, b)
        row["native_calls"] = calls
        row["ok"] = row["ok"] and calls > 0
        rows.append(row)
    return rows


# per scalar wrapper: the bound on max |native - numpy| / max |numpy|
SCALAR_TOLERANCES = {
    "finest_mesh_scal": 1e-12,
    "edges_to_adj": 0.0,
    "map_edges_agg": 0.0,
    "spw_round_h1": 0.0,
    "handshake_match": 0.0,
    "collapse_graph": 1e-12,
    "rho_power_h1": 1e-10,
    "smoothed_prol_scalar": 1e-10,
    "rap_csr": 1e-12,
    "greedy_color": 0.0,
    "cluster_detect": 1e-10,
    "csr_permute": 0.0,
    "csr_sym_scale": 1e-15,
    "tile_chunk_counts": 0.0,
    "tile_ell_fill_range": 0.0,
    "tile_ell_pack": 0.0,
}


def _cluster_sets(cc):
    """The clusters of a correction as integers: each cluster's sorted
    rows followed by -1, clusters in ascending order, and the inverses'
    entries in the same cluster order (or empty arrays without one)."""
    if cc is None:
        return np.zeros(0, dtype=np.int64), np.zeros(0)
    idx, inv = cc.idx.cpu().numpy(), cc.inv.cpu().numpy()
    used = np.abs(inv).sum(axis=2) > 0
    clusters = sorted(
        (tuple(sorted(int(v) for v in r[u])), k)
        for k, (r, u) in enumerate(zip(idx, used))
    )
    flat = [v for c, _ in clusters for v in (*c, -1)]
    # each inverse in the ascending order of its cluster's rows
    invs = []
    for c, k in clusters:
        rows = idx[k][used[k]]
        order = np.argsort(rows)
        sel = np.flatnonzero(used[k])[order]
        invs.append(inv[k][np.ix_(sel, sel)].ravel())
    return np.asarray(flat, dtype=np.int64), np.concatenate(invs)


def _tile_arrays(te):
    """(cols, data) of a plain or stacked tile-ELL as host arrays."""
    blocks = te.blocks if hasattr(te, "blocks") else (te,)
    return [
        (b.cols.cpu().numpy(), b.data.cpu().numpy()) for b in blocks
    ]


def scalar_setup_parity(A, coords, theta: float = 0.08) -> list[dict]:
    """One row per scalar-setup and staging wrapper: its callers with the
    switch on and off on the finest level and the first coarse level of
    ``A``'s scalar H1 hierarchy (Chebyshev options, host setup with the
    native branches), the integer outputs compared exactly, the float ones
    against ``SCALAR_TOLERANCES``, and the native calls the switch-on runs
    made (``native_calls``, > 0)."""
    from .. import native
    from ..apps.h1 import H1Energy
    from ..coarsen.pairwise import coarse_strength_graph, handshake_match
    from ..config import AMGOptions, SmootherOptions, SmootherType
    from ..factory.levels import setup_levels
    from ..mesh.topo import map_edges
    from ..precond.amg import _sym_scale
    from ..smoothers.cluster_corr import detect_clusters
    from ..smoothers.coloring import jones_plassmann_coloring
    from ..sparse import formats
    from ..transfer.galerkin import rap
    from ..transfer.prolongation import (
        _rho_estimate_h1_edges,
        piecewise_prol,
        smoothed_prol,
    )

    en = H1Energy()
    opts = AMGOptions(
        smoother=SmootherOptions(type=SmootherType.CHEBYSHEV)
    )
    with _switch(True):
        levels, _log = setup_levels(A.tocsr(), en, opts, coords)
    if len(levels) < 3:
        raise ValueError("the problem must coarsen at least twice")

    def level_cases(i):
        lev, nxt = levels[i], levels[i + 1]
        mesh, cmesh, v2agg, n_agg = lev.mesh, nxt.mesh, lev.v2agg, nxt.mesh.nv
        Ai = lev.A.tocsr()
        n = Ai.shape[0]
        with _switch(True):
            soc = en.soc(mesh)
            S = mesh.edge_graph(weights=soc)
            perm = formats.plan_reorder(Ai, 1)
            Ap = formats.permute(Ai, perm, perm)
            As = _sym_scale(Ap)[0]
        Ppw = piecewise_prol(en, mesh, cmesh, v2agg)
        cm = np.ones(n, dtype=bool)
        cm[:: 7] = False
        W = abs(Ai).tocsr()
        W.setdiag(0.0)
        W.eliminate_zeros()
        T = -(-n // formats.TILE_M)

        def numpy_round():
            return handshake_match(
                mesh.edge_graph(weights=en.soc(mesh)), theta,
                np.ones(n, dtype=bool),
            )

        def finest_mesh():
            m = en.build_finest_mesh(Ai, None)
            return (m.edges, m.edge_data["wt"], m.vertex_data["l2wt"],
                    m.vertex_data["diag"])

        return {
            "finest_mesh_scal": (finest_mesh,) * 2,
            "edges_to_adj": (lambda: mesh.edge_graph(weights=soc),) * 2,
            "map_edges_agg": (lambda: map_edges(mesh, v2agg, n_agg),) * 2,
            "spw_round_h1": (lambda: en.spw_round(mesh, theta, None),
                             numpy_round),
            "handshake_match": (lambda: handshake_match(S, theta, cm),) * 2,
            "collapse_graph": (
                lambda: coarse_strength_graph(S, v2agg, n_agg),) * 2,
            "rho_power_h1": (
                lambda: _rho_estimate_h1_edges(
                    mesh.edges, mesh.edge_data["wt"],
                    mesh.vertex_data["l2wt"],
                ),) * 2,
            "smoothed_prol_scalar": (
                lambda: smoothed_prol(
                    en, mesh, cmesh, v2agg, Ppw, A=Ai, row_bs=1,
                ),) * 2,
            "rap_csr": (lambda: rap(Ai, lev.P, dtype=np.float64),) * 2,
            "greedy_color": (lambda: jones_plassmann_coloring(W),) * 2,
            "cluster_detect": (
                lambda: _cluster_sets(detect_clusters(As)),) * 2,
            "csr_permute": (lambda: formats.permute(Ai, perm, perm),) * 2,
            "csr_sym_scale": (lambda: _sym_scale(Ap)[0],) * 2,
            "tile_chunk_counts": (
                lambda: formats._tile_chunk_counts(
                    Ap, formats.TILE_CHUNK, T),) * 2,
            "tile_ell_fill_range": (
                lambda: _tile_arrays(
                    formats.tile_ell_stack_from_scipy(Ap, np.float32)),) * 2,
            "tile_ell_pack": (
                lambda: _tile_arrays(
                    formats.tile_ell_from_scipy(lev.P, np.float32)),) * 2,
        }

    rows = {}
    for i in (0, 1):
        for name, (fn_native, fn_numpy) in level_cases(i).items():
            before = native.CALLS[name]["native"]
            with _switch(True):
                a = fn_native()
            calls = native.CALLS[name]["native"] - before
            with _switch(False):
                b = fn_numpy()
            row = _compare(name, a, b, SCALAR_TOLERANCES)
            row["native_calls"] = calls
            row["ok"] = row["ok"] and calls > 0
            prev = rows.get(name)
            if prev is not None:
                row["ints_equal"] &= prev["ints_equal"]
                row["max_rel_diff"] = max(row["max_rel_diff"],
                                          prev["max_rel_diff"])
                row["native_calls"] += prev["native_calls"]
                row["ok"] &= prev["ok"]
            rows[name] = row
    return list(rows.values())
