"""Host-side (numpy/scipy) sparse utilities used during AMG setup.

Copied from ngsamg_tpu/sparse/host.py: the BSR view of a level matrix (with
its cache on the matrix object), the diagonal blocks and strength graph of a
level, the block permutation, the padded block-ELL packing and the row-wise
CSR max/argmax of the matching rounds. Setup runs on the host with dynamic
shapes; only the resulting static-shape hierarchy is staged on the device
(sparse/bell.py, sparse/formats.py).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def to_bsr(A: sp.spmatrix, bs: int) -> sp.bsr_matrix:
    """View a scalar CSR as BSR with square block size ``bs``.

    The conversion is cached on the matrix object: setup stages (row
    ordering, block diagonals, classic-row choice, strength graphs) all
    need the same BSR view of a level matrix, and csr->bsr costs ~7 s at
    56M nnz. Level matrices are never mutated in place after construction
   , so the cache cannot go stale.
    """
    if isinstance(A, sp.bsr_matrix) and A.blocksize == (bs, bs):
        return A
    cached = getattr(A, "_amg_bsr_cache", None)
    if cached is not None and cached[0] == bs:
        return cached[1]
    B = sp.bsr_matrix(A, blocksize=(bs, bs))
    try:
        A._amg_bsr_cache = (bs, B)
    except AttributeError:
        pass
    return B


def block_norm_graph(A: sp.spmatrix, bs: int):
    """Condense a block matrix into its scalar connectivity graph.

    Returns (W, diag): ``W`` is a scalar CSR over *vertices* (block rows) whose
    entries are the Frobenius norms of off-diagonal blocks; ``diag`` holds the
    Frobenius norms of the diagonal blocks. For ``bs == 1`` this is just
    |off-diag| / |diag|. This is the graph the coarsening operates on
    (the reference's matrix-graph -> BlockTM conversion).
    """
    cached = getattr(A, "_amg_bng_cache", None)
    if cached is not None and cached[0] == bs:
        return cached[1], cached[2]
    if bs == 1:
        C = A.tocsr().copy()
        d = np.abs(C.diagonal())
        C.setdiag(0.0)
        C.eliminate_zeros()
        C.data = np.abs(C.data)
        _bng_store(A, bs, C, d)
        return C, d
    B = to_bsr(A, bs)
    nv = B.shape[0] // bs
    # einsum: one pass over the block data, no astype/square temporaries
    # (an astype(f64) copy alone was ~0.35 s per 450 MB at this host's
    # first-touch page-fault rate)
    dat = B.data if B.data.dtype == np.float64 else B.data.astype(
        np.float64, copy=False
    )
    norms = np.sqrt(np.einsum("nij,nij->n", dat, dat))
    # copy structure arrays: setdiag/eliminate_zeros mutate them in place
    W = sp.csr_matrix(
        (norms, B.indices.copy(), B.indptr.copy()), shape=(nv, nv)
    )
    d = W.diagonal().copy()
    W.setdiag(0.0)
    W.eliminate_zeros()
    _bng_store(A, bs, W, d)
    return W, d


def _bng_store(A, bs, W, d):
    try:
        A._amg_bng_cache = (bs, W, d)
    except AttributeError:
        pass


def block_diagonal_fast(A: sp.spmatrix, bs: int) -> np.ndarray:
    """Extract the (nv, bs, bs) diagonal blocks of a block matrix."""
    if bs == 1:
        return A.diagonal().reshape(-1, 1, 1)
    B = to_bsr(A, bs)
    nv = B.shape[0] // bs
    rows = np.repeat(np.arange(nv), np.diff(B.indptr))
    isdiag = B.indices == rows
    out = np.zeros((nv, bs, bs), dtype=B.dtype)
    out[rows[isdiag]] = B.data[isdiag]
    return out


def bsr_permute(
    B: sp.bsr_matrix, perm: np.ndarray, col_perm=None
) -> sp.bsr_matrix:
    """Block-row/column permutation of a BSR: rows reordered by the
    BLOCK permutation ``perm`` (new index r holds old index perm[r]),
    columns by ``col_perm`` (defaults to ``perm`` — the symmetric case;
    pass a different permutation for rectangular transfers).

    One fused index pass + ONE gather of the block data (the CSR
    permute + csr_tobsr route moves the same bytes twice with ~bs^2
    more index work); output rows are column-sorted.
    """
    perm = np.asarray(perm, dtype=np.int64)
    n = len(perm)
    cp = perm if col_perm is None else np.asarray(col_perm, np.int64)
    iperm = np.empty(len(cp), dtype=np.int64)
    iperm[cp] = np.arange(len(cp))
    deg = np.diff(B.indptr)[perm]
    indptr = np.concatenate([[0], np.cumsum(deg)])
    tot = int(indptr[-1])
    pos = (
        np.repeat(B.indptr[perm].astype(np.int64), deg)
        + np.arange(tot, dtype=np.int64)
        - np.repeat(indptr[:-1], deg)
    )
    cols = iperm[B.indices[pos]]
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    order = np.lexsort((cols, rows))
    out = sp.bsr_matrix(
        (B.data[pos[order]], cols[order].astype(np.int32), indptr),
        shape=B.shape,
    )
    out.has_sorted_indices = True
    return out


def csr_rowwise_max(indptr: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Per-row maximum of CSR values (0 for empty rows)."""
    n = len(indptr) - 1
    out = np.zeros(n, dtype=vals.dtype)
    nonempty = np.flatnonzero(np.diff(indptr) > 0)
    if len(nonempty):
        out[nonempty] = np.maximum.reduceat(vals, indptr[nonempty])
    return out


def csr_rowwise_argmax(indptr, indices, vals, valid=None):
    """Per-row argmax over CSR entries, restricted to ``valid`` entries.

    Returns (best_col, best_val) per row; rows with no valid entry get
    best_col = -1, best_val = -inf. O(nnz) via two reduceat passes (a
    lexsort here dominated the whole AMG setup at scale).
    """
    n = len(indptr) - 1
    if valid is not None:
        v = vals.astype(np.float64, copy=True)
        v[~valid] = -np.inf
    else:
        v = vals.astype(np.float64, copy=False)
    best_col = np.full(n, -1, dtype=np.int64)
    best_val = np.full(n, -np.inf)
    deg = np.diff(indptr)
    nonempty = np.flatnonzero(deg > 0)
    if len(nonempty) == 0:
        return best_col, best_val
    starts = indptr[nonempty]
    rowmax = np.maximum.reduceat(v, starts)
    rowmax_full = np.full(n, -np.inf)
    rowmax_full[nonempty] = rowmax
    rows = np.repeat(np.arange(n), deg)
    # first position achieving the row max
    nnz = len(v)
    pos = np.arange(nnz)
    cand = np.where(v == rowmax_full[rows], pos, nnz)
    first = np.minimum.reduceat(cand, starts)
    ok = np.isfinite(rowmax) & (first < nnz)
    sel = first[ok]
    best_col[nonempty[ok]] = indices[sel]
    best_val[nonempty[ok]] = v[sel]
    return best_col, best_val


def pad_to_ell(
    A: sp.spmatrix,
    bs_r: int,
    bs_c: int,
    width: int | None = None,
    dtype=np.float64,
):
    """Convert a (possibly rectangular-block) sparse matrix to padded ELL.

    Returns ``(data, cols, deg)`` with ``data: (n, K, bs_r, bs_c)`` float64,
    ``cols: (n, K) int32`` and ``deg: (n,)`` the stored blocks of each row,
    which fill its first slots; padded slots have column 0 and an all-zero
    block. ``n`` is the number of block rows. ``width`` forces the ELL
    width K.
    """
    if bs_r == bs_c == 1:
        C = A.tocsr()
        data3 = C.data.reshape(-1, 1, 1)
        indptr, indices = C.indptr, C.indices
        n = C.shape[0]
    else:
        B = (
            to_bsr(A, bs_r)  # cached square-block view
            if bs_r == bs_c
            else sp.bsr_matrix(A, blocksize=(bs_r, bs_c))
        )
        data3 = B.data
        indptr, indices = B.indptr, B.indices
        n = B.shape[0] // bs_r
    deg = np.diff(indptr)
    K = int(deg.max()) if width is None else int(width)
    if deg.max() > K:
        raise ValueError(f"ELL width {K} < max row degree {deg.max()}")
    data = np.zeros((n, K, bs_r, bs_c), dtype=np.dtype(dtype))
    cols = np.zeros((n, K), dtype=np.int32)
    rows = np.repeat(np.arange(n), deg)
    slot = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
    data[rows, slot] = data3
    cols[rows, slot] = indices
    return data, cols, deg
