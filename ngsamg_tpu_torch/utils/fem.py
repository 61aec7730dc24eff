"""FEM problem generators for the port's tests and its chip smoke run.

Copied from ngsamg_tpu/utils/fem.py: ``Problem``, the structured 2D and
the 3D Kuhn-tet P1 Poisson assembly with their helpers (``poisson_3d`` is
the headline problem of the benchmark), 2D P1 Poisson with its element
matrices (``poisson_2d_elmats``, the ELMAT mode's input) and 2D anisotropic
diffusion (``anisotropic_poisson_2d``), the unstructured P1 Poisson
generator (perturbed Delaunay meshes with optional uniform red refinement,
``unstructured_poisson``), and P1 linear elasticity: cantilever beams
(``elasticity_2d/3d``), a thin plate, the unstructured generator
(``unstructured_elasticity``) and vector-valued H1 (``vector_poisson``),
all with interleaved per-vertex displacement DOFs (block size = dim).
numpy/scipy only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class Problem:
    """An assembled test problem (strict-algebraic-mode inputs)."""

    A: sp.csr_matrix  # system matrix, Dirichlet-eliminated (SPD)
    b: np.ndarray  # right-hand side
    coords: np.ndarray  # (nv, dim) vertex coordinates of the FREE vertices
    dim: int  # spatial dimension
    block_size: int  # DOFs per vertex (1 scalar, dim elasticity)

    @property
    def n(self) -> int:
        return self.A.shape[0]


def _grid_2d(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0):
    """Structured triangulation of [0,lx]x[0,ly]: (nx+1)(ny+1) verts."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i, j = i.ravel(), j.ravel()
    v00, v10 = vid(i, j), vid(i + 1, j)
    v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
    # two triangles per square
    tris = np.concatenate(
        [
            np.stack([v00, v10, v11], axis=1),
            np.stack([v00, v11, v01], axis=1),
        ],
        axis=0,
    )
    return verts, tris


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


def _grid_3d(nx: int, ny: int, nz: int, lx=1.0, ly=1.0, lz=1.0):
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
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
    """Element-wise P1 stiffness: K_e = coeff_e * vol_e * G G^T.

    G rows are the constant gradients of the barycentric basis functions.
    """
    dim = verts.shape[1]
    ne, nl = elems.shape  # nl = dim+1
    X = verts[elems]  # (ne, nl, dim)
    D = X[:, 1:, :] - X[:, :1, :]  # (ne, dim, dim) edge matrix
    detD = np.linalg.det(D)
    vol = np.abs(detD) / (2.0 if dim == 2 else 6.0)
    Dinv = np.linalg.inv(D)  # (ne, dim, dim)
    # gradients: g_i (i=1..dim) = rows of Dinv^T; g_0 = -sum g_i
    G = np.empty((ne, nl, dim))
    G[:, 1:, :] = np.transpose(Dinv, (0, 2, 1))
    G[:, 0, :] = -G[:, 1:, :].sum(axis=1)
    Ke = np.einsum("eid,ejd->eij", G, G) * (coeff * vol)[:, None, None]
    return Ke, vol


def _assemble(nv, elems, Ke, block: int = 1):
    """Scatter element matrices into a global scipy CSR (scalar DOFs)."""
    nl = elems.shape[1]
    rows = np.repeat(elems, nl, axis=1).ravel()
    cols = np.tile(elems, (1, nl)).ravel()
    A = sp.coo_matrix((Ke.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    A.sum_duplicates()
    return A


def _eliminate_dirichlet(A, b, coords, fixed_mask, block_size=1):
    """Remove fixed-vertex DOFs symmetrically (keep only free rows/cols)."""
    free_v = ~fixed_mask
    if block_size == 1:
        free = free_v
    else:
        free = np.repeat(free_v, block_size)
    A = A[free][:, free].tocsr()
    return A, b[free], coords[free_v]


def poisson_2d_elmats(n: int = 32, jump: bool = False):
    """P1 Poisson + its element matrices in FREE-DOF numbering.

    Returns (Problem, dnums (ne, 3) with -1 for Dirichlet vertices,
    elmats (ne, 3, 3)) — the input of the ELMAT energy mode.
    """
    verts, tris = _grid_2d(n, n)
    centers = verts[tris].mean(axis=1)
    coeff = (
        np.where(_in_inclusions_2d(centers), 1e4, 1.0)
        if jump
        else np.ones(len(tris))
    )
    Ke, vol = _p1_stiffness(verts, tris, coeff)
    A = _assemble(len(verts), tris, Ke)
    b = np.zeros(len(verts))
    np.add.at(b, tris.ravel(), np.repeat(vol / 3.0, 3))
    x, y = verts[:, 0], verts[:, 1]
    fixed = (x == 0) | (x == 1) | (y == 0) | (y == 1)
    A2, b2, coords = _eliminate_dirichlet(A, b, verts, fixed)
    prob = Problem(A=A2, b=b2, coords=coords, dim=2, block_size=1)
    renum = np.full(len(verts), -1, dtype=np.int64)
    renum[~fixed] = np.arange((~fixed).sum())
    return prob, renum[tris], Ke


def poisson_2d(n: int = 32, jump: bool = False, f=1.0) -> Problem:
    """P1 Poisson on the unit square, Dirichlet on the whole boundary.

    ``jump=True`` uses a checkerboard-with-inclusions coefficient field (1 vs
    1e4).
    """
    verts, tris = _grid_2d(n, n)
    centers = verts[tris].mean(axis=1)
    if jump:
        coeff = np.where(_in_inclusions_2d(centers), 1e4, 1.0)
    else:
        coeff = np.ones(len(tris))
    Ke, vol = _p1_stiffness(verts, tris, coeff)
    A = _assemble(len(verts), tris, Ke)
    # rhs: f * vol/3 per vertex of each element
    b = np.zeros(len(verts))
    np.add.at(b, tris.ravel(), np.repeat(f * vol / 3.0, 3))
    x, y = verts[:, 0], verts[:, 1]
    fixed = (x == 0) | (x == 1) | (y == 0) | (y == 1)
    A, b, coords = _eliminate_dirichlet(A, b, verts, fixed)
    return Problem(A=A, b=b, coords=coords, dim=2, block_size=1)


def anisotropic_poisson_2d(
    n: int = 64, eps: float = 1e-2, angle: float = 0.0, f=1.0
) -> Problem:
    """P1 anisotropic diffusion K = R(angle) diag(1, eps) R(angle)^T.

    The regime the reference's prolongation-refinement machinery
    (`ImproveSProlRow`, vertex_factory_impl.hpp:1834-2433) exists for:
    grid-aligned (angle 0) and rotated (e.g. pi/4 — non-M-matrix with
    strong positive off-diagonals) anisotropy.
    """
    verts, tris = _grid_2d(n, n)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    K = R @ np.diag([1.0, eps]) @ R.T
    X = verts[tris]
    D = X[:, 1:, :] - X[:, :1, :]
    det = D[:, 0, 0] * D[:, 1, 1] - D[:, 0, 1] * D[:, 1, 0]
    vol = np.abs(det) / 2.0
    Dinv = np.linalg.inv(D)
    G = np.empty((len(tris), 3, 2))
    G[:, 1:, :] = np.transpose(Dinv, (0, 2, 1))
    G[:, 0, :] = -G[:, 1:, :].sum(axis=1)
    Ke = vol[:, None, None] * np.einsum("eid,dk,ejk->eij", G, K, G)
    A = _assemble(len(verts), tris, Ke)
    b = np.zeros(len(verts))
    np.add.at(b, tris.ravel(), np.repeat(f * vol / 3.0, 3))
    fixed = np.any((verts == 0) | (verts == 1), axis=1)
    A, b, coords = _eliminate_dirichlet(A.tocsr(), b, verts, fixed)
    return Problem(A=A, b=b, coords=coords, dim=2, block_size=1)


def poisson_3d(n: int = 16, jump: bool = False, f=1.0) -> Problem:
    """P1 Poisson on the unit cube (Kuhn tets), Dirichlet boundary.

    Constant-coefficient problems take the O(n) stencil-replication fast
    path (`_poisson_3d_stencil`) — the matrix is identical to element
    assembly because the uniform Kuhn-tet P1 stiffness is translation
    invariant; only the assembly cost changes.
    """
    if not jump and n >= 8:
        return _poisson_3d_stencil(n, f)
    return _poisson_3d_assembled(n, jump, f)


_STENCIL_CACHE: dict = {}


def _kuhn_stencil():
    """Interior stencil (offsets in (i,j,k), values per unit h) + load."""
    if "v" in _STENCIL_CACHE:
        return _STENCIL_CACHE["v"]
    n0 = 8
    p = _poisson_3d_assembled(n0, False, 1.0)
    m = n0 - 1  # interior lattice per dim
    c = (m // 2) * m * m + (m // 2) * m + (m // 2)  # center vertex
    A = p.A.tocsr()
    lo, hi = A.indptr[c], A.indptr[c + 1]
    cols, vals = A.indices[lo:hi], A.data[lo:hi]
    offs = []
    for col, v in zip(cols, vals):
        d = int(col) - c
        di, r = divmod(d + 2 * m * m + 2 * m + 2, m * m)
        dj, dk = divmod(r, m)
        # normalize out the probe's h0 = 1/n0 (3D P1 stiffness ~ h)
        offs.append(((di - 2, dj - 2, dk - 2), float(v) * n0))
    # load per interior vertex scales with h^3 (here h = 1/n0)
    bc = float(p.b[c]) * (n0**3)
    _STENCIL_CACHE["v"] = (offs, bc)
    return _STENCIL_CACHE["v"]


def _poisson_3d_stencil(n: int, f: float) -> Problem:
    offs, bunit = _kuhn_stencil()
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
    # kept in DIA: the AMG stencil fast path decodes it without a COO/CSR
    # detour (transfer/stencil.from_dia), and scipy DIA matvec serves the
    # host-side residual checks fine
    A = sp.dia_matrix((np.asarray(diags), np.asarray(offsets)),
                      shape=(nv, nv))
    b = np.full(nv, f * bunit * h**3)
    xs = (np.arange(m) + 1) * h
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    return Problem(A=A, b=b, coords=coords, dim=3, block_size=1)


def _poisson_3d_assembled(n: int, jump: bool, f) -> Problem:
    verts, tets = _grid_3d(n, n, n)
    centers = verts[tets].mean(axis=1)
    if jump:
        m = (
            (centers[:, 0] > 0.3)
            & (centers[:, 0] < 0.7)
            & (centers[:, 1] > 0.3)
            & (centers[:, 1] < 0.7)
        )
        coeff = np.where(m, 1e4, 1.0)
    else:
        coeff = np.ones(len(tets))
    Ke, vol = _p1_stiffness(verts, tets, coeff)
    A = _assemble(len(verts), tets, Ke)
    b = np.zeros(len(verts))
    np.add.at(b, tets.ravel(), np.repeat(f * vol / 4.0, 4))
    x, y, z = verts.T
    fixed = (x == 0) | (x == 1) | (y == 0) | (y == 1) | (z == 0) | (z == 1)
    A, b, coords = _eliminate_dirichlet(A, b, verts, fixed)
    return Problem(A=A, b=b, coords=coords, dim=3, block_size=1)


def _in_inclusions_2d(p):
    """High-coefficient inclusion pattern (scaled to the unit square)."""
    x, y = p[:, 0], p[:, 1]
    boxes = [
        (0.20, 0.70, 0.30, 0.80),
        (0.70, 0.70, 0.80, 0.80),
        (0.42, 0.42, 0.58, 0.58),
        (0.10, 0.20, 0.90, 0.30),
        (0.60, 0.45, 0.70, 0.55),
    ]
    m = np.zeros(len(p), dtype=bool)
    for x0, y0, x1, y1 in boxes:
        m |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    return m


# ---------------------------------------------------------------------------
# unstructured (perturbed Delaunay) meshes
# ---------------------------------------------------------------------------


def _unstructured_mesh(n: int, dim: int, seed: int = 0, amp: float = 0.35):
    """Perturbed-grid Delaunay mesh of the unit square/cube.

    The reference validates on genuinely irregular Netgen meshes
    (the reference's tests/h1/simple/test_2d_lo.py, maxh=0.05); this is the
    standalone equivalent: interior grid points jittered by ``amp * h``
    i.i.d., then Delaunay-triangulated. Boundary points stay put so the
    domain (and the Dirichlet boundary) is exact.
    """
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
    # drop degenerate (near-zero-volume) simplices produced by co-planar
    # boundary points; P1 assembly would blow up on them
    X = verts[elems]
    D = X[:, 1:, :] - X[:, :1, :]
    detD = np.abs(np.linalg.det(D))
    elems = elems[detD > 1e-12 * h**dim]
    return verts, elems


def refine_simplices(verts: np.ndarray, elems: np.ndarray):
    """One uniform red refinement of a simplicial mesh (vectorized).

    2D: each triangle -> 4 (corner + medial); 3D: Bey's rule — each tet
    -> 4 corner tets + 4 octahedron tets split along the x02-x13 diagonal
    (J. Bey, 'Tetrahedral grid refinement', Computing 55, 1995). This is
    how production FEM stacks reach large unstructured meshes (coarse
    mesh from a mesher, then uniform refinements — e.g. Netgen's
    `Refine()` used with the reference); the refined mesh keeps the
    parent's irregular connectivity and geometry.
    """
    nl = elems.shape[1]
    nv = len(verts)
    pairs = np.array(
        [(a, b) for a in range(nl) for b in range(a + 1, nl)]
    )
    ea = elems[:, pairs[:, 0]]  # (ne, npairs)
    eb = elems[:, pairs[:, 1]]
    lo = np.minimum(ea, eb).astype(np.int64)
    hi = np.maximum(ea, eb).astype(np.int64)
    key = lo * nv + hi
    uniq, inv = np.unique(key, return_inverse=True)
    mid = nv + inv.reshape(elems.shape[0], -1)  # per-elem midpoint ids
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


def _assemble_chunked(nv, elems, verts, coeff, f, chunk=500_000):
    """Chunked P1 assembly: bounded temporaries, warm scratch reuse.

    At 8M+ elements the monolithic `_p1_stiffness` + `_assemble` route
    materializes multi-GB COO temporaries whose first-touch page faults
    can run ~15x slower than warm writes; chunking keeps every
    temporary in a few hundred MB and accumulates per-chunk CSRs (scipy's
    compiled merge).
    """
    nl = elems.shape[1]
    A = None
    b = np.zeros(nv)
    for lo in range(0, len(elems), chunk):
        el = elems[lo: lo + chunk]
        Ke, vol = _p1_stiffness(verts, el, coeff[lo: lo + chunk])
        rows = np.repeat(el, nl, axis=1).ravel()
        cols = np.tile(el, (1, nl)).ravel()
        Ac = sp.coo_matrix(
            (Ke.ravel(), (rows, cols)), shape=(nv, nv)
        ).tocsr()
        Ac.sum_duplicates()
        A = Ac if A is None else A + Ac
        np.add.at(b, el.ravel(), np.repeat(f * vol / nl, nl))
    return A, b


def unstructured_poisson(n: int, dim: int = 2, jump: bool = False,
                         f: float = 1.0, seed: int = 0,
                         refine: int = 0) -> Problem:
    """P1 Poisson on a perturbed Delaunay mesh, Dirichlet boundary.

    ``refine`` uniform red refinements follow the Delaunay step: the
    production route to large unstructured problems (3D Delaunay at the
    1M-point scale costs ~10 min of Qhull; one refinement of a 180k-point
    mesh reaches 1.3M DoF in seconds with the same irregular topology).
    """
    verts, elems = _unstructured_mesh(n, dim, seed=seed)
    for _ in range(max(refine, 0)):
        verts, elems = refine_simplices(verts, elems)
    if jump and dim == 2:
        centers = verts[elems].mean(axis=1)
        coeff = np.where(_in_inclusions_2d(centers), 1e4, 1.0)
    elif jump:
        centers = verts[elems].mean(axis=1)
        m = np.all((centers > 0.3) & (centers < 0.7), axis=1)
        coeff = np.where(m, 1e4, 1.0)
    else:
        coeff = np.ones(len(elems))
    A, b = _assemble_chunked(len(verts), elems, verts, coeff, f)
    fixed = np.any((verts == 0) | (verts == 1), axis=1)
    A, b, coords = _eliminate_dirichlet(A, b, verts, fixed)
    return Problem(A=A, b=b, coords=coords, dim=dim, block_size=1)


# ---------------------------------------------------------------------------
# linear elasticity (P1, vector-valued)
# ---------------------------------------------------------------------------


def _elasticity_elem(verts, elems, E, nu, plane_stress=True):
    """Element stiffness for linear elasticity with P1 displacements.

    Small-strain isotropic: a(u,v) = int 2 mu eps(u):eps(v) + lam div u div v.
    """
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

    # standard small-strain isotropic element stiffness:
    # mu*(delta_ab G_i.G_j + G_ib G_ja) + lam G_ia G_jb
    GiGj = np.einsum("eid,ejd->eij", G, G)  # (ne, nl, nl)
    Ke = (
        mu5 * np.einsum("eij,ab->eiajb", GiGj, np.eye(dim))
        + mu5 * np.einsum("eib,eja->eiajb", G, G)
        + lam5 * np.einsum("eia,ejb->eiajb", G, G)
    )
    Ke *= vol[:, None, None, None, None]
    return Ke.reshape(ne, nl * dim, nl * dim), vol


def _beam(dim, n, length):
    """Beam domain [0,length] x [0,1]^(dim-1), clamped at x=0."""
    if dim == 2:
        verts, elems = _grid_2d(length * n, n, lx=float(length))
    else:
        verts, elems = _grid_3d(length * n, n, n, lx=float(length))
    fixed = verts[:, 0] == 0.0
    return verts, elems, fixed


def thin_plate_elasticity(
    n: int = 12, thickness: float = 0.1, E=1e3, nu=0.3, load=1.0
) -> Problem:
    """3D elasticity on a thin plate [0,1]^2 x [0,t], one element through
    the thickness, clamped at x=0.

    The high-aspect-ratio tets produce NEAR-SINGULAR edge/vertex energy
    matrices — the regime the reference's robust min-eigenvalue SOC with
    neighbor-boost accumulation exists for.
    """
    dim = 3
    verts, elems = _grid_3d(n, n, 1, lz=float(thickness))
    fixed = verts[:, 0] == 0.0
    Ke, vol = _elasticity_elem(verts, elems, E, nu)
    nl = elems.shape[1]
    dof = (elems[:, :, None] * dim + np.arange(dim)[None, None, :]).reshape(
        len(elems), nl * dim
    )
    nv = len(verts)
    rows = np.repeat(dof, nl * dim, axis=1).ravel()
    cols = np.tile(dof, (1, nl * dim)).ravel()
    A = sp.coo_matrix(
        (Ke.ravel(), (rows, cols)), shape=(nv * dim, nv * dim)
    ).tocsr()
    A.sum_duplicates()
    b = np.zeros(nv * dim)
    w = np.repeat(load * vol / nl, nl)
    np.add.at(b, (elems.ravel() * dim + (dim - 1)), -w)
    A, b, coords = _eliminate_dirichlet(A, b, verts, fixed, block_size=dim)
    return Problem(A=A, b=b, coords=coords, dim=dim, block_size=dim)


def _elasticity(dim, n, length, E, nu, load, jump=False) -> Problem:
    verts, elems, fixed = _beam(dim, n, length)
    if jump:
        # two-material beam: stiff inclusions along the length
        centers = verts[elems].mean(axis=1)
        stiff = (centers[:, 0] % 4.0) < 2.0
        Evec = np.where(stiff, E * 1e3, E)
    else:
        Evec = E
    Ke, vol = _elasticity_elem(verts, elems, Evec, nu)
    nl = elems.shape[1]
    # vector DOF indices: vertex v -> [v*dim, ..., v*dim+dim-1]
    dof = (elems[:, :, None] * dim + np.arange(dim)[None, None, :]).reshape(
        len(elems), nl * dim
    )
    nv = len(verts)
    rows = np.repeat(dof, nl * dim, axis=1).ravel()
    cols = np.tile(dof, (1, nl * dim)).ravel()
    A = sp.coo_matrix(
        (Ke.ravel(), (rows, cols)), shape=(nv * dim, nv * dim)
    ).tocsr()
    A.sum_duplicates()
    # downward volume load
    b = np.zeros(nv * dim)
    w = np.repeat(load * vol / nl, nl)
    np.add.at(b, (elems.ravel() * dim + (dim - 1)), -w)
    A, b, coords = _eliminate_dirichlet(A, b, verts, fixed, block_size=dim)
    return Problem(A=A, b=b, coords=coords, dim=dim, block_size=dim)


def vector_poisson(base: Problem, bs: int) -> Problem:
    """Multidim / vector-valued H1: block a_ij = a_scalar_ij * I_bs.

    Identical graph per component.
    """
    # kron in block layout: each scalar entry becomes a bs x bs identity block
    A = sp.kron(base.A, sp.eye(bs), format="csr")
    b = np.repeat(base.b, bs)
    return Problem(
        A=A, b=b, coords=base.coords, dim=base.dim, block_size=bs
    )


def unstructured_elasticity(n: int = 12, dim: int = 2, E=1e3, nu=0.3,
                            load=1.0, seed: int = 0,
                            refine: int = 0) -> Problem:
    """P1 elasticity on a perturbed Delaunay mesh, clamped at x=0.

    ``refine`` uniform red refinements reach the 1M-DoF scale without
    the ~10-minute Qhull cost of a 300k-point 3D Delaunay.
    """
    verts, elems = _unstructured_mesh(n, dim, seed=seed)
    for _ in range(max(refine, 0)):
        verts, elems = refine_simplices(verts, elems)
    nl = elems.shape[1]
    nv = len(verts)
    b = np.zeros(nv * dim)
    # chunked assembly: at 2M tets the monolithic COO route needs ~7 GB
    # of (nl*dim)^2-fanout temporaries (cf. _assemble_chunked)
    A = None
    chunk = 200_000
    for lo in range(0, len(elems), chunk):
        el = elems[lo: lo + chunk]
        Ke, vol = _elasticity_elem(verts, el, E, nu)
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
        w = np.repeat(load * vol / nl, nl)
        np.add.at(b, (el.ravel() * dim + (dim - 1)), -w)
    fixed = verts[:, 0] == 0.0
    A, b, coords = _eliminate_dirichlet(A, b, verts, fixed, block_size=dim)
    return Problem(A=A, b=b, coords=coords, dim=dim, block_size=dim)


def elasticity_2d(n: int = 8, length: int = 10, E=1e3, nu=0.3, load=1.0,
                  jump: bool = False):
    """2D plane-stress cantilever beam."""
    return _elasticity(2, n, length, E, nu, load, jump=jump)


def elasticity_3d(n: int = 4, length: int = 10, E=1e3, nu=0.3, load=1.0,
                  jump: bool = False):
    """3D cantilever beam 10x1x1."""
    return _elasticity(3, n, length, E, nu, load, jump=jump)
