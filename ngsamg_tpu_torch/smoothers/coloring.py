"""Host-side graph coloring for the multicolor Gauss-Seidel sweeps.

Copied from ngsamg_tpu/smoothers/coloring.py. As in the original, the
coloring runs in the native extension (``native.greedy_color``: a
sequential greedy coloring in vertex order). Its plain version, taken with
``native.HAVE_NATIVE`` off, is the same kernel written in Python (the
kernel is ``greedy_color_impl`` of native/kernels.cpp), so both settings of
the switch give the same colors.

The JAX package's numpy branch is a different coloring (the speculative
Jones-Plassmann rounds of ngsamg_tpu/smoothers/coloring.py:41-73), and the
port does not follow it: it keeps the colors a vertex's neighbours use in a
uint64 bitmask, so once those neighbours hold all 64 colors its candidate
is log2(0) and the rounds never finish. The coarse levels of 3D Poisson at
1,000,000 DoF need 56 and 199 colors. The color count is the sequential
depth of one GS sweep.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import native

# the native kernel keeps its "color used by a neighbour" marks in an array
# of this many entries
_MARK_SIZE = 256


def jones_plassmann_coloring(
    W: sp.csr_matrix, max_colors: int = 63, seed: int = 0
) -> np.ndarray:
    """Distance-1 coloring of a symmetric graph; returns (n,) int32 colors.

    Each vertex in turn takes the smallest color none of its already
    colored neighbours holds (``native.greedy_color``, or the same loop in
    Python with ``native.HAVE_NATIVE`` off). Like the JAX package's native
    path it applies no ``max_colors`` check and ignores ``seed`` (both are
    kept for its signature). A vertex that would need color 256 or more
    raises a ``RuntimeError`` in both, where the JAX package's kernel would
    write past its 256-entry mark array.
    """
    n = W.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    nat = native.greedy_color(W.indptr, W.indices)
    if nat is not None:
        return np.asarray(nat)
    indptr = W.indptr.tolist()
    indices = W.indices.tolist()
    colors = [-1] * n
    mark = [-1] * _MARK_SIZE
    for v in range(n):
        for k in range(indptr[v], indptr[v + 1]):
            c = colors[indices[k]]
            if c >= 0:
                mark[c] = v
        c = 0
        while c < _MARK_SIZE and mark[c] == v:
            c += 1
        if c == _MARK_SIZE:
            raise RuntimeError(
                f"vertex {v} needs more than {_MARK_SIZE} colors"
            )
        colors[v] = c
    return np.asarray(colors, dtype=np.int32)


def color_row_lists(colors: np.ndarray, pad_row: int, align: int = 8):
    """Per-color row index arrays, padded (with ``pad_row``) to ``align``.

    ``pad_row`` must point to an all-zero padded matrix row so that padded
    entries are no-ops in the sweep.
    """
    ncol = int(colors.max()) + 1 if len(colors) else 0
    out = []
    for c in range(ncol):
        rows = np.flatnonzero(colors == c).astype(np.int32)
        npad = -(-len(rows) // align) * align - len(rows)
        if npad:
            rows = np.concatenate(
                [rows, np.full(npad, pad_row, dtype=np.int32)]
            )
        out.append(rows)
    return out
