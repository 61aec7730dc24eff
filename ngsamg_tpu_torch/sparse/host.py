"""Host-side (numpy/scipy) sparse utilities used during AMG setup.

Copied from ngsamg_tpu/sparse/host.py, scalar (block size 1) branches: the
diagonal and strength-graph extraction of a level matrix and the row-wise
CSR max/argmax of the matching rounds. The block (bs > 1) branches arrive
with the block energies (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _scalar_only(bs: int):
    if bs != 1:
        raise NotImplementedError(
            "block levels are not ported to ngsamg_tpu_torch (ROADMAP "
            "queue 1 item 3)"
        )


def block_norm_graph(A: sp.spmatrix, bs: int):
    """Condense a matrix into its scalar connectivity graph.

    Returns (W, diag): ``W`` is a scalar CSR of |off-diagonal| entries and
    ``diag`` holds |diagonal| — the graph the coarsening operates on.
    """
    _scalar_only(bs)
    C = A.tocsr().copy()
    d = np.abs(C.diagonal())
    C.setdiag(0.0)
    C.eliminate_zeros()
    C.data = np.abs(C.data)
    return C, d


def block_diagonal_fast(A: sp.spmatrix, bs: int) -> np.ndarray:
    """Extract the (nv, bs, bs) diagonal blocks of a block matrix."""
    _scalar_only(bs)
    return A.diagonal().reshape(-1, 1, 1)


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
    best_col = -1, best_val = -inf. O(nnz) via two reduceat passes.
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
