"""3D P1 Poisson on Kuhn tets of the unit cube, Dirichlet boundary.

Frozen copy of ``ngsamg_tpu_torch/utils/fem.py``: ``poisson_3d(n)``'s
stencil path (``_poisson_3d_stencil``, ``_kuhn_stencil``) with the element
assembly it probes the stencil from (``_poisson_3d_assembled`` without the
coefficient jump, ``_grid_3d``, ``_p1_stiffness``, ``_assemble``,
``_eliminate_dirichlet``). The benchmark owns this copy, so a later change to
the program's generator cannot change the problem the benchmark solves;
``benchmark/tests/test_bench_problems.py`` holds it to the original.
Differences: no load vector (the benchmark draws its right-hand sides from
the seed) and no module-level stencil cache.

``generate(n)`` returns ``(A, coords)``: the ``(n-1)^3`` free vertices'
stiffness as a ``scipy.sparse.dia_matrix`` and their coordinates.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# Kuhn split of the unit cube into 6 tets (all share main diagonal 0-7)
_KUHN_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 5, 7],
        [0, 2, 3, 7],
        [0, 2, 6, 7],
        [0, 4, 5, 7],
        [0, 4, 6, 7],
    ]
)


def _grid_3d(nx: int, ny: int, nz: int):
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    zs = np.linspace(0.0, 1.0, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    corners = np.stack(
        [
            vid(i, j, k),
            vid(i + 1, j, k),
            vid(i, j + 1, k),
            vid(i + 1, j + 1, k),
            vid(i, j, k + 1),
            vid(i + 1, j, k + 1),
            vid(i, j + 1, k + 1),
            vid(i + 1, j + 1, k + 1),
        ],
        axis=1,
    )  # (ncell, 8)
    tets = corners[:, _KUHN_TETS].reshape(-1, 4)
    return verts, tets


def _p1_stiffness(verts, elems, coeff):
    """Element-wise P1 stiffness: K_e = coeff_e * vol_e * G G^T."""
    dim = verts.shape[1]
    ne, nl = elems.shape
    X = verts[elems]
    D = X[:, 1:, :] - X[:, :1, :]
    detD = np.linalg.det(D)
    vol = np.abs(detD) / (2.0 if dim == 2 else 6.0)
    Dinv = np.linalg.inv(D)
    G = np.empty((ne, nl, dim))
    G[:, 1:, :] = np.transpose(Dinv, (0, 2, 1))
    G[:, 0, :] = -G[:, 1:, :].sum(axis=1)
    Ke = np.einsum("eid,ejd->eij", G, G) * (coeff * vol)[:, None, None]
    return Ke, vol


def _assemble(nv, elems, Ke):
    nl = elems.shape[1]
    rows = np.repeat(elems, nl, axis=1).ravel()
    cols = np.tile(elems, (1, nl)).ravel()
    A = sp.coo_matrix((Ke.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    A.sum_duplicates()
    return A


def _assembled(n: int):
    """Element assembly on the n^3 lattice; (A, b) of the free vertices."""
    verts, tets = _grid_3d(n, n, n)
    Ke, vol = _p1_stiffness(verts, tets, np.ones(len(tets)))
    A = _assemble(len(verts), tets, Ke)
    b = np.zeros(len(verts))
    np.add.at(b, tets.ravel(), np.repeat(vol / 4.0, 4))
    x, y, z = verts.T
    fixed = (x == 0) | (x == 1) | (y == 0) | (y == 1) | (z == 0) | (z == 1)
    free = ~fixed
    return A[free][:, free].tocsr(), b[free]


def _kuhn_stencil():
    """Interior stencil: ((di, dj, dk), value per unit h) pairs."""
    n0 = 8
    A, _b = _assembled(n0)
    m = n0 - 1  # interior lattice per dim
    c = (m // 2) * m * m + (m // 2) * m + (m // 2)  # center vertex
    lo, hi = A.indptr[c], A.indptr[c + 1]
    cols, vals = A.indices[lo:hi], A.data[lo:hi]
    offs = []
    for col, v in zip(cols, vals):
        d = int(col) - c
        di, r = divmod(d + 2 * m * m + 2 * m + 2, m * m)
        dj, dk = divmod(r, m)
        # normalize out the probe's h0 = 1/n0 (3D P1 stiffness ~ h)
        offs.append(((di - 2, dj - 2, dk - 2), float(v) * n0))
    return offs


def generate(n: int):
    """(A, coords) of P1 Poisson on the n^3 Kuhn lattice: (n-1)^3 DoF."""
    offs = _kuhn_stencil()
    m = n - 1  # interior vertices per dim
    nv = m**3
    h = 1.0 / n
    I, J, K = np.meshgrid(np.arange(m), np.arange(m), np.arange(m),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    diags, offsets = [], []
    for (di, dj, dk), v in offs:
        off = (di * m + dj) * m + dk
        valid = (
            (I + di >= 0) & (I + di < m)
            & (J + dj >= 0) & (J + dj < m)
            & (K + dk >= 0) & (K + dk < m)
        )
        col = np.where(valid, v * h, 0.0)  # stiffness scales with h in 3D
        # sp.dia_matrix convention: data[d, i] used for column i (= row i-off)
        d = np.zeros(nv)
        rows = np.arange(nv)
        cols = rows + off
        ok = valid & (cols >= 0) & (cols < nv)
        d[cols[ok]] = col[ok]
        diags.append(d)
        offsets.append(off)
    A = sp.dia_matrix((np.asarray(diags), np.asarray(offsets)),
                      shape=(nv, nv))
    xs = (np.arange(m) + 1) * h
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    return A, coords
