"""P1 linear elasticity on a perturbed Delaunay mesh of the unit square or
cube, clamped at x=0.

Frozen copy of ``ngsamg_tpu_torch/utils/fem.py``: ``unstructured_elasticity``
with its mesh (``_unstructured_mesh``), uniform red refinement
(``refine_simplices``), element matrices (``_elasticity_elem``) and
``_eliminate_dirichlet``. The benchmark owns this copy, so a later change to
the program's generator cannot change the problem the benchmark solves;
``benchmark/tests/test_bench_problems.py`` holds it to the original.
Difference: no load vector (the benchmark draws its right-hand sides from
the seed).

``generate(n, dim, E, nu, seed, refine)`` returns ``(A, coords)``: the free
displacement DoFs' stiffness as a ``scipy.sparse.csr_matrix`` (interleaved,
``dim`` DoFs a vertex) and the free vertices' coordinates.
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


def _elasticity_elem(verts, elems, E, nu, plane_stress=True):
    """Small-strain isotropic P1 element stiffness:
    a(u,v) = int 2 mu eps(u):eps(v) + lam div u div v."""
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

    E = np.broadcast_to(np.asarray(E, dtype=np.float64), (ne,))
    mu = E / (2 * (1 + nu))
    if dim == 2 and plane_stress:
        lam = E * nu / (1 - nu * nu)
    else:
        lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu5 = mu[:, None, None, None, None]
    lam5 = lam[:, None, None, None, None]
    GiGj = np.einsum("eid,ejd->eij", G, G)
    Ke = (
        mu5 * np.einsum("eij,ab->eiajb", GiGj, np.eye(dim))
        + mu5 * np.einsum("eib,eja->eiajb", G, G)
        + lam5 * np.einsum("eia,ejb->eiajb", G, G)
    )
    Ke *= vol[:, None, None, None, None]
    return Ke.reshape(ne, nl * dim, nl * dim), vol


def generate(n: int, dim: int = 3, E: float = 1e3, nu: float = 0.3,
             seed: int = 0, refine: int = 0):
    """(A, coords) of P1 elasticity on the perturbed n^dim Delaunay mesh
    after ``refine`` red refinements, clamped at x=0."""
    verts, elems = _unstructured_mesh(n, dim, seed=seed)
    for _ in range(max(refine, 0)):
        verts, elems = refine_simplices(verts, elems)
    nl = elems.shape[1]
    nv = len(verts)
    A = None
    chunk = 200_000
    for lo in range(0, len(elems), chunk):
        el = elems[lo: lo + chunk]
        Ke, _vol = _elasticity_elem(verts, el, E, nu)
        dof = (
            el[:, :, None] * dim + np.arange(dim)[None, None, :]
        ).reshape(len(el), nl * dim)
        rows = np.repeat(dof, nl * dim, axis=1).ravel()
        cols = np.tile(dof, (1, nl * dim)).ravel()
        Ac = sp.coo_matrix(
            (Ke.ravel(), (rows, cols)), shape=(nv * dim, nv * dim)
        ).tocsr()
        Ac.sum_duplicates()
        A = Ac if A is None else A + Ac
    fixed = verts[:, 0] == 0.0
    free_v = ~fixed
    free = np.repeat(free_v, dim)
    return A[free][:, free].tocsr(), verts[free_v]
