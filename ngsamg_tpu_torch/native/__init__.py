"""The port's native (C++) setup kernels: 31 wrappers and their switch.

Copied from ngsamg_tpu/native/__init__.py. Each wrapper converts its
arguments as the original does and calls the port's own build of
``native/kernels.cpp`` (``native/build.py``: compiled with ``g++`` on first
use into ``build/ngsamg_tpu_torch_native/<hash>/``). The callers keep the
original's numpy branches beside each call; those are the plain versions.

``HAVE_NATIVE`` is the switch, named as in the JAX package so that a test
sets both packages the same way. It is True by default: a wrapper then
builds and loads the extension, or raises (a failed compile is a
``RuntimeError`` with the compiler's output; nothing catches it). Where a
caller sets it to False, every wrapper returns None (``tile_ell_fill_range``
False) without building anything, and the caller runs its numpy branch.
Apart from that a wrapper returns None only where the original does for the
input's shape (``bsr_mm``, ``rap_bsr``, ``bsr_smooth_update``,
``truncate_prol_blocks``): the caller then takes its numpy branch, as the
JAX package does, and the hierarchy stays the JAX package's. A caller that
does not send an input to its wrapper, where the original's caller does not
either (``H1Energy.spw_round`` on a mesh without ``wt`` or ``l2wt``,
``_smoothed_prol_scalar_native`` without a scalar level matrix), says so
with :func:`declined`.

``CALLS[name]`` counts each wrapper's calls: ``native`` where the C++ ran,
``declined`` where the wrapper or its caller returned None for the input's
shape, so the counts say where the JAX package's native run takes numpy.
Two methods of the extension have no wrapper (``ell_slots``,
``collapse_signed``); ``extension()`` reaches them.

This module imports neither torch nor the JAX package: the host-setup ranks
of ``parallel/mp_runtime.py`` import it.
"""

from __future__ import annotations

import threading

import numpy as np

from . import build

HAVE_NATIVE = True

WRAPPERS = (
    "greedy_color", "rap_csr", "handshake_match", "edges_to_adj",
    "map_edges_agg", "rho_power_h1", "tile_chunk_counts",
    "tile_ell_fill_range", "tile_ell_pack", "collapse_graph",
    "smoothed_prol_scalar", "finest_mesh_scal", "csr_permute",
    "cluster_detect", "spw_round_h1", "bsr_from_edge_blocks",
    "pencil_extreme_eig", "harmonic_mean_sym", "csr_sym_scale", "frob2_sym",
    "bsr_sym_scale", "elast_rm_diag", "bsr_mm", "elast_map_edge_mats",
    "elast_soc_robust", "rap_bsr", "bsr_smooth_update",
    "truncate_prol_blocks", "elast_ahat_bsr", "rho_power",
    "rigid_edge_blocks",
)
CALLS = {name: {"native": 0, "declined": 0} for name in WRAPPERS}

_lock = threading.Lock()
_ext = None
build_seconds = 0.0  # compile time spent by this process (0 on a cache hit)


def extension():
    """The loaded extension module (built on the first call)."""
    global _ext, build_seconds
    with _lock:
        if _ext is None:
            path, build_seconds = build.build()
            _ext = build.load(path)
    return _ext


def reset_calls() -> None:
    for c in CALLS.values():
        c["native"] = c["declined"] = 0


def _run(name, *args):
    """Call the extension's method ``name``, counted as a native call."""
    CALLS[name]["native"] += 1
    return getattr(extension(), name)(*args)


def _declined(name):
    """None for an input shape the method does not take, counted."""
    CALLS[name]["declined"] += 1
    return None


def declined(name):
    """None for an input its caller does not send to wrapper ``name``,
    counted as a decline where ``HAVE_NATIVE`` is on (with it off the
    caller takes its numpy branch anyway, and nothing is counted)."""
    if HAVE_NATIVE:
        CALLS[name]["declined"] += 1
    return None


def _csr_idx(indptr, indices):
    """Matching-dtype (int32/int64) contiguous index arrays, no-copy when
    possible.

    Native kernels dispatch on the index dtype; scipy stores int32 below
    2^31 nnz, the native emitters int64 indptr + int32 indices. A dtype
    mismatch downcasts the (short) indptr — never the O(nnz) indices."""
    indptr = np.ascontiguousarray(indptr)
    indices = np.ascontiguousarray(indices)
    if indptr.dtype != indices.dtype:
        indptr = indptr.astype(indices.dtype)
    if indptr.dtype not in (np.dtype(np.int32), np.dtype(np.int64)):
        indptr = indptr.astype(np.int64)
        indices = indices.astype(np.int64)
    return indptr, indices


def greedy_color(indptr, indices) -> np.ndarray | None:
    """Sequential greedy coloring; None when HAVE_NATIVE is off."""
    if not HAVE_NATIVE:
        return None
    return _run("greedy_color", *_csr_idx(indptr, indices))


def rap_csr(A, P, dtype=None, symmetrize=False):
    """Fused P^T A P; returns a scipy CSR or None (HAVE_NATIVE off).

    Accumulates in f64; emits float32 values directly when ``dtype`` says
    so, and applies the exact (C + C^T)/2 symmetrization in-kernel when
    ``symmetrize`` (saves scipy's allocating 3-pass add)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    A = A.tocsr()
    P = P.tocsr()
    nc = P.shape[1]
    ai, aj = _csr_idx(A.indptr, A.indices)
    pi, pj = _csr_idx(P.indptr, P.indices)
    if ai.dtype != pi.dtype:
        t = np.promote_types(ai.dtype, pi.dtype)
        ai, aj, pi, pj = (x.astype(t) for x in (ai, aj, pi, pj))
    emit_f32 = dtype is not None and np.dtype(dtype) == np.dtype(
        np.float32
    )
    indptr, indices, data = _run(
        "rap_csr",
        ai, aj, np.ascontiguousarray(A.data, dtype=np.float64),
        pi, pj, np.ascontiguousarray(P.data, dtype=np.float64),
        int(nc), 1 if emit_f32 else 0, 1 if symmetrize else 0,
    )
    if dtype is not None and data.dtype != np.dtype(dtype):
        data = data.astype(dtype)
    M = sp.csr_matrix((data, indices, indptr), shape=(nc, nc))
    M.has_canonical_format = True
    return M


def handshake_match(indptr, indices, weights, can_match, theta, iters=8,
                    jitter=False):
    if not HAVE_NATIVE:
        return None
    return _run(
        "handshake_match",
        *_csr_idx(indptr, indices),
        np.ascontiguousarray(weights, dtype=np.float64),
        np.ascontiguousarray(can_match, dtype=np.uint8),
        float(theta),
        int(iters),
        1 if jitter else 0,
    )


def edges_to_adj(edges, weights, n):
    """Symmetric CSR adjacency from an (i < j) edge list; CSR or None."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    indptr, indices, data = _run(
        "edges_to_adj",
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(weights, dtype=np.float64),
        int(n),
    )
    M = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    M.has_canonical_format = True
    return M


def map_edges_agg(edges, v2agg, n_agg):
    """(coarse_edges, e2ce) under aggregation; None when HAVE_NATIVE is off."""
    if not HAVE_NATIVE:
        return None
    ce, e2ce = _run(
        "map_edges_agg",
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(v2agg, dtype=np.int64),
        int(n_agg),
    )
    return ce, e2ce


def rho_power_h1(edges, w, d, x0, iters=10):
    """Power-iteration rho(Dhat^-1 A-hat) from edges; None when
    HAVE_NATIVE is off."""
    if not HAVE_NATIVE:
        return None
    return float(
        _run(
            "rho_power_h1",
            np.ascontiguousarray(edges, dtype=np.int64),
            None,
            np.ascontiguousarray(w, dtype=np.float64),
            np.ascontiguousarray(d, dtype=np.float64),
            np.ascontiguousarray(x0, dtype=np.float64),
            int(iters),
        )
    )


def tile_chunk_counts(indptr, indices, M, chunk, T):
    """int64[T] distinct column-chunk count per M-row tile, or None."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "tile_chunk_counts",
        *_csr_idx(indptr, indices), int(M), int(chunk), int(T)
    )


def tile_ell_fill_range(A, M, chunk, t0, t1, K, out_data, out_cols):
    """Fill one bucket of the bucketed/chunked tile-ELL in place.

    ``out_data`` (t1-t0, K, chunk, M) matching A.data's float dtype,
    ``out_cols`` (t1-t0, K) int32, both zeroed by the caller. Returns
    True, or False when HAVE_NATIVE is off."""
    if not HAVE_NATIVE:
        return False
    data = A.data
    if data.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        data = data.astype(np.float64)
    _run(
        "tile_ell_fill_range",
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(data),
        int(M),
        int(chunk),
        int(t0),
        int(t1),
        int(K),
        out_data,
        out_cols,
    )
    return True


def tile_ell_pack(A, M, T):
    """(data (T,K,M) f32, cols (T,K) i32, K) or None (HAVE_NATIVE off)."""
    if not HAVE_NATIVE:
        return None
    A = A.tocsr()
    data = A.data
    if data.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        data = data.astype(np.float64)
    return _run(
        "tile_ell_pack",
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(data),
        int(M),
        int(T),
    )


def collapse_graph(S, v2agg, n_agg):
    """C^T S C with the diagonal dropped; scipy CSR or None."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    S = S.tocsr()
    indptr, indices, data = _run(
        "collapse_graph",
        *_csr_idx(S.indptr, S.indices),
        np.ascontiguousarray(S.data, dtype=np.float64),
        np.ascontiguousarray(v2agg, dtype=np.int64),
        int(n_agg),
    )
    M = sp.csr_matrix((data, indices, indptr), shape=(n_agg, n_agg))
    M.has_canonical_format = True
    return M


def smoothed_prol_scalar(
    A, edges, edge_w, l2wt, v2agg, n_agg,
    scale_aux, scale_real, max_per_row, max_classic, min_frac,
    filter_pos=False,
):
    """Fused scalar semi-aux smoothed prolongation; CSR or None.

    ``scale_aux``/``scale_real`` are omega already divided by the
    respective spectral-radius estimates (the caller computes those so the
    numpy fallback and this kernel share them bit-for-bit)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    A = A.tocsr()
    Adata = A.data
    if Adata.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        Adata = Adata.astype(np.float64)
    indptr, indices, data = _run(
        "smoothed_prol_scalar",
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(Adata),
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(edge_w, dtype=np.float64),
        np.ascontiguousarray(l2wt, dtype=np.float64),
        np.ascontiguousarray(v2agg, dtype=np.int64),
        int(n_agg),
        float(scale_aux),
        float(scale_real),
        int(max_per_row),
        int(max_classic),
        float(min_frac),
        1 if filter_pos else 0,
    )
    return sp.csr_matrix(
        (data, indices, indptr), shape=(A.shape[0], int(n_agg))
    )


def finest_mesh_scal(A, neg_only=False, signed_wt=False):
    """(diag, signed rowsum, edges (m,2) int64, wt) from a symmetric
    scalar CSR in one fused pass; None when HAVE_NATIVE is off.

    With ``neg_only`` the edge list keeps only attractive (negative)
    couplings — the standard SA strength filter. With ``signed_wt`` all
    off-diagonal couplings are kept with SIGNED weight -a_ij (attractive
    positive), so coarse-level weight sums cancel repulsive couplings."""
    if not HAVE_NATIVE:
        return None
    A = A.tocsr()
    mode = 2 if signed_wt else (1 if neg_only else 0)
    diag, rsum, edges, ew = _run(
        "finest_mesh_scal",
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(A.data, dtype=np.float64),
        mode,
    )
    return diag, rsum, edges, ew


def csr_permute(A, rowperm=None, colperm=None):
    """``A[rowperm][:, colperm]`` as a canonical CSR; None when
    HAVE_NATIVE is off.

    ``rowperm``/``colperm`` are new-index -> old-index permutations (the
    numpy fancy-index convention). Column renaming uses the inverse map
    internally; rows come out column-sorted."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    A = A.tocsr()
    data = A.data
    if data.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        data = data.astype(np.float64)
    rp = (
        None
        if rowperm is None
        else np.ascontiguousarray(rowperm, dtype=np.int64)
    )
    cmap = None
    if colperm is None:
        icp = None
    else:
        cp = np.asarray(colperm, dtype=np.int64)
        icp = np.empty(len(cp), dtype=np.int64)
        icp[cp] = np.arange(len(cp), dtype=np.int64)
        cmap = icp
    indptr, indices, vals = _run(
        "csr_permute",
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(data),
        rp,
        cmap,
    )
    M = sp.csr_matrix(
        (vals, indices, indptr),
        shape=(
            A.shape[0] if rowperm is None else len(rp),
            A.shape[1],
        ),
    )
    M.has_canonical_format = True
    return M


def cluster_detect(A, beta, eig_ratio, max_size):
    """(blocks (ncand,K,K) f64, members (ncand,K) int32, csz int32) of
    candidate defective strong clusters; None when HAVE_NATIVE is off.

    One fused pass: strength union-find + in-kernel screening (exact 2x2
    eig for pairs, Gershgorin bound for larger) + dense block extraction
    for candidates only (smoothers/cluster_corr.detect_clusters)."""
    if not HAVE_NATIVE:
        return None
    A = A.tocsr()
    return _run(
        "cluster_detect",
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(A.data, dtype=np.float64),
        float(beta),
        float(eig_ratio),
        int(max_size),
    )


def spw_round_h1(edges, w, l2, can_match, theta, iters=8):
    """Fused H1 matching round: aux diag + soc + adjacency + jittered
    handshake in one pass; partner int64[n] or None (HAVE_NATIVE off)."""
    if not HAVE_NATIVE:
        return None
    cm = (
        None
        if can_match is None
        else np.ascontiguousarray(can_match, dtype=np.uint8)
    )
    return _run(
        "spw_round_h1",
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(w, dtype=np.float64),
        np.ascontiguousarray(l2, dtype=np.float64),
        cm,
        float(theta),
        int(iters),
    )


def bsr_from_edge_blocks(edges, Bii, Bij, Bji, Bjj, Dv):
    """Assemble the block replacement matrix A-hat as a scipy BSR from
    per-edge (d,d) blocks + per-vertex diagonal blocks; None when HAVE_NATIVE
    is off (apps/elasticity.replacement_matrix)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    d = Dv.shape[1]
    indptr, indices, blocks = _run(
        "bsr_from_edge_blocks",
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(Bii, dtype=np.float64),
        np.ascontiguousarray(Bij, dtype=np.float64),
        np.ascontiguousarray(Bji, dtype=np.float64),
        np.ascontiguousarray(Bjj, dtype=np.float64),
        np.ascontiguousarray(Dv, dtype=np.float64),
    )
    nv = Dv.shape[0]
    return sp.bsr_matrix(
        (blocks, indices, indptr), shape=(nv * d, nv * d)
    )


def pencil_extreme_eig(E, C, tol=1e-10, reduction="min"):
    """Batched extreme eigenvalue of small symmetric pencils (E, C)
    restricted to range(C); None when HAVE_NATIVE is off
    (apps/elasticity._pencil_extreme_eig hot path)."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "pencil_extreme_eig",
        np.ascontiguousarray(E, dtype=np.float64),
        np.ascontiguousarray(C, dtype=np.float64),
        float(tol),
        0 if reduction == "min" else 1,
    )


def harmonic_mean_sym(A, B, rcond=1e-12):
    """Batched symmetrized series energy A (A+B)^+ B; None when HAVE_NATIVE
    is off (soc_robust / _neib_boost)."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "harmonic_mean_sym",
        np.ascontiguousarray(A, dtype=np.float64),
        np.ascontiguousarray(B, dtype=np.float64),
        float(rcond),
    )


def csr_sym_scale(A, s):
    """data * s[row] * s[col] in one pass over a CSR; None when HAVE_NATIVE
    is off (precond/amg device-staging scaling)."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "csr_sym_scale",
        A.indptr, A.indices,
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(s, dtype=np.float64),
    )


def frob2_sym(B):
    """Transpose-invariant batched squared Frobenius norms (canonical
    summation order of apps/elasticity._frob2T, fp-contraction off);
    None when HAVE_NATIVE is off."""
    if not HAVE_NATIVE:
        return None
    return _run("frob2_sym", np.ascontiguousarray(B, dtype=np.float64))


def bsr_sym_scale(A, s):
    """One-pass symmetric diagonal scaling of a scipy BSR (block form of
    csr_sym_scale): data'[e,r,c] = data[e,r,c] * s[row_r] * s[col_c];
    None when HAVE_NATIVE is off (precond/amg._sym_scale)."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "bsr_sym_scale",
        np.ascontiguousarray(A.indptr, dtype=np.int64),
        np.ascontiguousarray(A.indices, dtype=np.int32),
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(s, dtype=np.float64),
    )


def elast_rm_diag(pos, edges, E, s):
    """Fused replacement-matrix diagonal (aux_diagonal's RM part): D[i] +=
    Qim^T E Qim, D[j] += Qjm^T E Qjm; None when HAVE_NATIVE is off."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "elast_rm_diag",
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
    )


def bsr_mm(A, B):
    """Block-sparse Gustavson product C = A @ B for scipy BSR inputs
    with compatible (possibly rectangular) block sizes; returns scipy
    BSR, or None when HAVE_NATIVE is off or B's row blocks do not match
    A's column blocks (the callers then take scipy's products)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    ra, ca = A.blocksize
    if B.blocksize[0] != ca:
        return _declined("bsr_mm")
    cbk = B.blocksize[1]
    ncB = B.shape[1] // cbk
    ip, ix, dat = _run(
        "bsr_mm",
        np.ascontiguousarray(A.indptr, dtype=np.int64),
        np.ascontiguousarray(A.indices, dtype=np.int32),
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(B.indptr, dtype=np.int64),
        np.ascontiguousarray(B.indices, dtype=np.int32),
        np.ascontiguousarray(B.data, dtype=np.float64),
        int(ncB),
    )
    return sp.bsr_matrix(
        (dat, ix, ip), shape=(A.shape[0], B.shape[1])
    )


def elast_map_edge_mats(pos, cpos, edges, ce, cedges, E, s):
    """Fused coarse-edge-matrix accumulation (map_data hot loop):
    Ec[ce] += Q(m_c -> m_f)^T E Q(m_c -> m_f) over mapped fine edges, in
    edge order (bitwise equal to the numpy scatter_add path); None when
    HAVE_NATIVE is off."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "elast_map_edge_mats",
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(cpos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(ce, dtype=np.int64),
        np.ascontiguousarray(cedges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
    )


def elast_soc_robust(pos, edges, E, D, s, tol=1e-10, reduction="min"):
    """Fully fused robust SOC per edge (midpoint transports + series
    energy + extreme pencil eigenvalue); None when HAVE_NATIVE is
    off (apps/elasticity.soc_robust)."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "elast_soc_robust",
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        np.ascontiguousarray(D, dtype=np.float64),
        float(s),
        float(tol),
        0 if reduction == "min" else 1,
    )


def rap_bsr(A, P, nc_blocks=None, symmetrize=True):
    """Fused block-entry Galerkin triple product C = P^T A P for scipy
    BSR inputs (A: (br,br) blocks, P: (br,bc) blocks) with in-kernel
    block symmetrization; returns scipy BSR with (bc,bc) blocks, or
    None when HAVE_NATIVE is off or A's blocks are not square or not P's
    row blocks (factory/levels.py's block Galerkin step)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    br, br2 = A.blocksize
    brp, bc = P.blocksize
    if br != br2 or brp != br:
        return _declined("rap_bsr")
    ncb = nc_blocks if nc_blocks is not None else P.shape[1] // bc
    ip, ix, dat = _run(
        "rap_bsr",
        np.ascontiguousarray(A.indptr, dtype=np.int64),
        np.ascontiguousarray(A.indices, dtype=np.int32),
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(P.indptr, dtype=np.int64),
        np.ascontiguousarray(P.indices, dtype=np.int32),
        np.ascontiguousarray(P.data, dtype=np.float64),
        int(ncb),
        1 if symmetrize else 0,
    )
    return sp.bsr_matrix(
        (dat, ix, ip), shape=(ncb * bc, ncb * bc)
    )


def bsr_smooth_update(Ahat, Ppw, Dinv, scale):
    """Fused damped-Jacobi prolongation smoothing
    C = P_pw - scale * Dinv (A-hat @ P_pw) for square-block scipy BSR
    inputs; returns sorted scipy BSR, or None when HAVE_NATIVE is off,
    the blocks are not square or a row of P_pw holds more than one block
    (transfer/prolongation.smoothed_prol block path)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    d = Ahat.blocksize[0]
    if Ahat.blocksize[1] != d or Ppw.blocksize != (d, d):
        return _declined("bsr_smooth_update")
    deg = np.diff(Ppw.indptr)
    if len(deg) and deg.max() > 1:
        # the kernel reads at most one (piecewise) block per row
        return _declined("bsr_smooth_update")
    ncb = Ppw.shape[1] // d
    ip, ix, dat = _run(
        "bsr_smooth_update",
        np.ascontiguousarray(Ahat.indptr, dtype=np.int64),
        np.ascontiguousarray(Ahat.indices, dtype=np.int32),
        np.ascontiguousarray(Ahat.data, dtype=np.float64),
        np.ascontiguousarray(Ppw.indptr, dtype=np.int64),
        np.ascontiguousarray(Ppw.indices, dtype=np.int32),
        np.ascontiguousarray(Ppw.data, dtype=np.float64),
        np.ascontiguousarray(Dinv, dtype=np.float64),
        float(scale),
        int(ncb),
    )
    out = sp.bsr_matrix((dat, ix, ip), shape=Ppw.shape)
    out.has_sorted_indices = True
    return out


def truncate_prol_blocks(P, pos_c, s, max_per_row, min_frac):
    """Fan-out-bounded kernel-preserving truncation of a block
    prolongation (scipy BSR, sorted indices); ``pos_c`` None = identity
    transport; returns truncated scipy BSR, or None when HAVE_NATIVE
    is off or P's blocks are not square
    (transfer/prolongation.truncate_prol)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    d = P.blocksize[0]
    if P.blocksize[1] != d:
        return _declined("truncate_prol_blocks")
    ip, ix, dat = _run(
        "truncate_prol_blocks",
        np.ascontiguousarray(P.indptr, dtype=np.int64),
        np.ascontiguousarray(P.indices, dtype=np.int32),
        np.ascontiguousarray(P.data, dtype=np.float64),
        None
        if pos_c is None
        else np.ascontiguousarray(pos_c, dtype=np.float64),
        float(s),
        int(max_per_row),
        float(min_frac),
    )
    return sp.bsr_matrix((dat, ix, ip), shape=P.shape)


def elast_ahat_bsr(pos, edges, E, s, l2):
    """Fully fused elasticity replacement-matrix assembly (rigid edge
    blocks scattered straight into sorted BSR + l2 displacement
    diagonal); None when HAVE_NATIVE is off
    (apps/elasticity.replacement_matrix)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    d = E.shape[1]
    nv = len(l2)
    indptr, indices, blocks = _run(
        "elast_ahat_bsr",
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
        np.ascontiguousarray(l2, dtype=np.float64),
    )
    return sp.bsr_matrix(
        (blocks, indices, indptr), shape=(nv * d, nv * d)
    )


def rho_power(A, Dinv, x0, iters):
    """Power-iteration rho(D^-1 A) on a scalar CSR or block BSR with
    block-diagonal Dinv; None when HAVE_NATIVE is off
    (prolongation._rho_estimate / smoothers/build._lam_max_estimate)."""
    if not HAVE_NATIVE:
        return None
    data = A.data
    if data.ndim == 3:
        data = np.ascontiguousarray(data, dtype=np.float64)
    else:
        data = np.ascontiguousarray(data.ravel(), dtype=np.float64)
    indptr, indices = _csr_idx(A.indptr, A.indices)
    return _run(
        "rho_power",
        indptr, indices, data,
        np.ascontiguousarray(Dinv, dtype=np.float64),
        np.ascontiguousarray(x0, dtype=np.float64),
        int(iters),
    )


def rigid_edge_blocks(pos, edges, E, s):
    """Fused per-edge replacement-matrix blocks (Bii, Bij, Bji, Bjj);
    None when HAVE_NATIVE is off (_edge_rm_blocks hot path)."""
    if not HAVE_NATIVE:
        return None
    return _run(
        "rigid_edge_blocks",
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
    )
