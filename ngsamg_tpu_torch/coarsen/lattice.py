"""Lattice detection and lattice-structured aggregation.

Copied from ngsamg_tpu/coarsen/lattice.py: ``detect_lattice`` and
``detect_lattice_rowmajor`` with their helper (the structured setup), and
``lattice_aggregate``, which the generic level loop's AUTO coarsening tries
before pairwise matching. numpy only.
"""

from __future__ import annotations

import numpy as np


def _uniform_axis(c: np.ndarray):
    """O(n) index mapping for a uniformly-spaced axis, or None.

    Avoids the np.unique sort (measured 20s at 10M vertices): infer the
    step from a sample, snap every coordinate, validate exactly.
    """
    cmin, cmax = float(c.min()), float(c.max())
    if cmax <= cmin:
        return np.zeros(len(c), dtype=np.int64), 1
    u = np.unique(np.round(c[: min(len(c), 1 << 16)], 9))
    if len(u) < 2:
        return None
    step = float(np.diff(u).min())
    if step <= 0:
        return None
    m = int(round((cmax - cmin) / step)) + 1
    if m > 4 * len(c):
        return None
    idx = np.round((c - cmin) / step).astype(np.int64)
    # direct max-abs check (np.isclose allocates ~6 temporaries at 10M)
    err = cmin + idx * step
    err -= c
    np.abs(err, out=err)
    if float(err.max()) > 1e-9 * max(abs(cmax), 1.0):
        return None
    return idx, m


def detect_lattice_rowmajor(coords: np.ndarray | None):
    """dims when coords IS a row-major full tensor lattice, else None.

    O(n) with no sort and no per-vertex index array: axis values are read
    off strided slices (last axis varies fastest; a block ends at the
    first non-increase), then ONE broadcast comparison verifies every
    vertex. This is the case every structured benchmark hits; the general
    detector below costs ~8 s at 10M vertices mostly re-discovering it.
    """
    if coords is None or coords.ndim != 2 or len(coords) == 0:
        return None
    nv, d = coords.shape
    dims = [0] * d
    axes = [None] * d
    stride = 1
    for k in range(d - 1, -1, -1):
        if stride > nv:
            return None
        c = coords[::stride, k]
        if len(c) <= 1:
            m = 1
        else:
            # blockwise early-exit scan: the first non-increase is at
            # ~dims[k], so diffing the WHOLE 10M-long slice allocates
            # 80 MB of fresh pages (slow first-touch faults) for nothing
            m = len(c)
            B = 1 << 16
            for i0 in range(0, len(c) - 1, B):
                dv = np.diff(c[i0: min(i0 + B + 1, len(c))])
                neg = np.flatnonzero(dv <= 0)
                if len(neg):
                    m = i0 + int(neg[0]) + 1
                    break
        dims[k] = m
        axes[k] = np.ascontiguousarray(c[:m])
        stride *= m
    if int(np.prod([float(m) for m in dims])) != nv or stride != nv:
        return None
    try:
        C = coords.reshape(tuple(dims) + (d,))
    except ValueError:
        return None
    # chunked verification over the leading axis with a reusable scratch
    # buffer: full-size temporaries (5 x 80 MB per axis at 10M) are all
    # fresh-page writes, up to ~15x slower than warm pages
    tail = int(np.prod([float(m) for m in dims[1:]])) if d > 1 else 1
    B0 = max(1, int(2_000_000 // max(tail, 1)))
    buf = np.empty(min(dims[0], B0) * tail, dtype=np.float64)
    for k in range(d):
        shape = [1] * d
        shape[k] = dims[k]
        ref = axes[k].reshape(shape)
        scale = max(float(np.abs(axes[k]).max()), 1.0)
        tol = 1e-9 * scale
        for i0 in range(0, dims[0], B0):
            i1 = min(i0 + B0, dims[0])
            block = C[i0:i1, ..., k]
            ref_b = ref[i0:i1] if k == 0 else ref[0]
            out = buf[: block.size].reshape(block.shape)
            np.subtract(block, ref_b, out=out)
            np.abs(out, out=out)
            if float(out.max()) > tol:
                return None
    return np.asarray(dims, dtype=np.int64)


def detect_lattice(coords: np.ndarray | None):
    """Map vertices to integer lattice indices, or None.

    Returns (idx (nv, d) int64, dims (d,)) when every vertex has a unique
    integer coordinate tuple.
    """
    if coords is None or coords.ndim != 2 or len(coords) == 0:
        return None
    nv, d = coords.shape
    idx = np.empty((nv, d), dtype=np.int64)
    dims = []
    for k in range(d):
        fast = _uniform_axis(coords[:, k])
        if fast is not None:
            idx[:, k], mk = fast
            dims.append(mk)
            continue
        u, inv = np.unique(np.round(coords[:, k], 9), return_inverse=True)
        idx[:, k] = inv
        dims.append(len(u))
    dims = np.asarray(dims, dtype=np.int64)
    if np.prod(dims.astype(np.float64)) > 8 * nv:
        # far from a filled lattice: keys would be meaningless (random
        # point sets decode to nv x nv "lattices" under a laxer bound)
        return None
    key = np.zeros(nv, dtype=np.int64)
    for k in range(d):
        key = key * dims[k] + idx[:, k]
    prod = int(np.prod(dims))
    if prod <= 4 * nv:  # O(n) uniqueness check (no sort)
        if np.bincount(key, minlength=prod).max() != 1:
            return None
    elif len(np.unique(key)) != nv:
        return None
    return idx, dims


def lattice_aggregate(
    coords: np.ndarray, factor: int = 2
) -> tuple[np.ndarray, int] | None:
    """Aggregate `factor`^d lattice blocks. Returns (v2agg, n_agg) or None."""
    det = detect_lattice(coords)
    if det is None:
        return None
    idx, dims = det
    cdims = (dims + factor - 1) // factor
    cidx = idx // factor
    key = np.zeros(len(idx), dtype=np.int64)
    for k in range(idx.shape[1]):
        key = key * cdims[k] + cidx[:, k]
    # sort-free compaction (prod(cdims) <= prod(dims) <= 8 nv by detection)
    prod = int(np.prod(cdims))
    present = np.zeros(prod, dtype=bool)
    present[key] = True
    remap = np.cumsum(present, dtype=np.int64) - 1
    return remap[key], int(present.sum())
