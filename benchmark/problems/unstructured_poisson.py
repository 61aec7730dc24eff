"""P1 Poisson on a perturbed Delaunay mesh of the unit square or cube,
Dirichlet boundary.

Frozen copy of ``ngsamg_tpu_torch/utils/fem.py``: ``unstructured_poisson``
without the coefficient jump, with its mesh (``_unstructured_mesh``),
uniform red refinement (``refine_simplices``), element matrices
(``_p1_stiffness``), chunked assembly (``_assemble_chunked``) and
``_eliminate_dirichlet``. The benchmark owns this copy, so a later change to
the program's generator cannot change the problem the benchmark solves;
``benchmark/tests/test_bench_unstructured_poisson.py`` holds it to the
original. Difference: no load vector (the benchmark draws its right-hand
sides from the seed).

``generate(n, dim, seed, refine)`` returns ``(A, coords)``: the free
vertices' stiffness as a ``scipy.sparse.csr_matrix`` and their coordinates.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _unstructured_mesh(n: int, dim: int, seed: int = 0, amp: float = 0.35):
    """Perturbed-grid Delaunay mesh: interior grid points jittered by
    ``amp * h`` i.i.d., boundary points kept, degenerate simplices
    dropped."""
    from scipy.spatial import Delaunay

    h = 1.0 / n
    axes = [np.linspace(0.0, 1.0, n + 1)] * dim
    grids = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([g.ravel() for g in grids], axis=1)
    interior = np.all((verts > 0) & (verts < 1), axis=1)
    rng = np.random.default_rng(seed)
    verts = verts + np.where(
        interior[:, None],
        rng.uniform(-amp * h, amp * h, size=verts.shape),
        0.0,
    )
    tri = Delaunay(verts)
    elems = tri.simplices
    X = verts[elems]
    D = X[:, 1:, :] - X[:, :1, :]
    detD = np.abs(np.linalg.det(D))
    elems = elems[detD > 1e-12 * h**dim]
    return verts, elems


def refine_simplices(verts: np.ndarray, elems: np.ndarray):
    """One uniform red refinement (2D: 4 children; 3D: Bey's rule, the
    octahedron split along the x02-x13 diagonal)."""
    nl = elems.shape[1]
    nv = len(verts)
    pairs = np.array(
        [(a, b) for a in range(nl) for b in range(a + 1, nl)]
    )
    ea = elems[:, pairs[:, 0]]
    eb = elems[:, pairs[:, 1]]
    lo = np.minimum(ea, eb).astype(np.int64)
    hi = np.maximum(ea, eb).astype(np.int64)
    key = lo * nv + hi
    uniq, inv = np.unique(key, return_inverse=True)
    mid = nv + inv.reshape(elems.shape[0], -1)
    mverts = 0.5 * (verts[uniq // nv] + verts[uniq % nv])
    verts2 = np.concatenate([verts, mverts])
    e = elems
    if nl == 3:  # triangle: pairs = (01, 02, 12)
        m01, m02, m12 = mid[:, 0], mid[:, 1], mid[:, 2]
        children = [
            (e[:, 0], m01, m02),
            (e[:, 1], m01, m12),
            (e[:, 2], m02, m12),
            (m01, m02, m12),
        ]
    else:  # tet: pairs = (01, 02, 03, 12, 13, 23)
        m01, m02, m03 = mid[:, 0], mid[:, 1], mid[:, 2]
        m12, m13, m23 = mid[:, 3], mid[:, 4], mid[:, 5]
        children = [
            (e[:, 0], m01, m02, m03),
            (m01, e[:, 1], m12, m13),
            (m02, m12, e[:, 2], m23),
            (m03, m13, m23, e[:, 3]),
            (m01, m02, m03, m13),
            (m01, m02, m12, m13),
            (m02, m03, m13, m23),
            (m02, m12, m13, m23),
        ]
    elems2 = np.concatenate(
        [np.stack(c, axis=1) for c in children]
    ).astype(elems.dtype)
    return verts2, elems2


def _p1_stiffness(verts, elems, coeff):
    """Element P1 stiffness K_e = coeff_e vol_e G G^T, G the constant
    gradients of the barycentric basis functions."""
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


def _assemble_chunked(nv, elems, verts, coeff, chunk=500_000):
    """The stiffness summed chunk by chunk of elements, each chunk's CSR
    added to the running sum (the original's order of additions)."""
    nl = elems.shape[1]
    A = None
    for lo in range(0, len(elems), chunk):
        el = elems[lo: lo + chunk]
        Ke, _vol = _p1_stiffness(verts, el, coeff[lo: lo + chunk])
        rows = np.repeat(el, nl, axis=1).ravel()
        cols = np.tile(el, (1, nl)).ravel()
        Ac = sp.coo_matrix(
            (Ke.ravel(), (rows, cols)), shape=(nv, nv)
        ).tocsr()
        Ac.sum_duplicates()
        A = Ac if A is None else A + Ac
    return A


def generate(n: int, dim: int = 3, seed: int = 0, refine: int = 0):
    """(A, coords) of P1 Poisson on the perturbed n^dim Delaunay mesh after
    ``refine`` red refinements, the boundary vertices eliminated."""
    verts, elems = _unstructured_mesh(n, dim, seed=seed)
    for _ in range(max(refine, 0)):
        verts, elems = refine_simplices(verts, elems)
    coeff = np.ones(len(elems))
    A = _assemble_chunked(len(verts), elems, verts, coeff)
    fixed = np.any((verts == 0) | (verts == 1), axis=1)
    free = ~fixed
    return A[free][:, free].tocsr(), verts[free]
