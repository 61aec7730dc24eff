"""Staggered-grid (MAC) and simplicial Stokes test problems.

Copied from ngsamg_tpu/utils/stokes_fem.py (numpy/scipy only): facet-flux
velocity systems with a grad-grad + div-penalty ("GG") bilinear form, one
normal-velocity DOF per interior facet (MAC lattices in 2D and 3D,
perturbed Delaunay triangle and tet meshes), the vector Crouzeix-Raviart
variant, the HDG-flavoured variable-DOF facet spaces of the HDiv AMG and
the statically condensed P1-HDG system with its aux embedding:

    K = L + alpha * D^T W D,   D = cell-wise discrete divergence.

K is SPD on the free facet DOFs. Each generator also returns the geometric
data the Stokes AMG needs: the dual mesh (cells x faces), face flows
(areas, or area-normals for vector DOFs) and cell volumes, and for the
simplicial meshes the primal facet -> vertex incidence of the short
geometric loops. The meshes come from this package's
``utils/fem._unstructured_mesh``, which builds the JAX package's meshes bit
for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class StokesProblem:
    A: sp.csr_matrix  # velocity system on free facet DOFs (SPD)
    b: np.ndarray
    D: sp.csr_matrix  # divergence: (ncells, nfacets) on free DOFs
    cell_pos: np.ndarray  # (ncells, dim) cell centers
    cell_vol: np.ndarray  # (ncells,)
    facet_cells: np.ndarray  # (nfacets, 2) adjacent cells, -1 = boundary
    facet_flow: np.ndarray  # (nfacets,) face area (flow weight)
    facet_pos: np.ndarray  # (nfacets, dim) face centers
    alpha: float
    # primal facet->vertex incidence (optional): enables the short
    # geometric loop basis (StokesAMG facet_verts/vert_pos kwargs)
    facet_verts: np.ndarray | None = None  # (nfacets, dim) vertex ids
    vert_pos: np.ndarray | None = None  # (nverts, dim)
    bnd_facet_verts: np.ndarray | None = None  # eliminated boundary facets

    @property
    def n(self):
        return self.A.shape[0]


def stokes_mac_2d(n: int = 16, alpha: float = 10.0, nu: float = 1.0):
    """MAC Stokes velocity block on an n x n unit-square grid.

    Free DOFs are the interior faces (no-slip boundary eliminated):
    vertical faces carry u_x, horizontal faces carry u_y.
    """
    h = 1.0 / n
    ncell = n * n

    def cid(i, j):
        return i * n + j

    # interior vertical faces: between cells (i,j) and (i+1,j) -> u_x
    # interior horizontal faces: between (i,j) and (i,j+1)     -> u_y
    vi, vj = np.meshgrid(np.arange(n - 1), np.arange(n), indexing="ij")
    hi, hj = np.meshgrid(np.arange(n), np.arange(n - 1), indexing="ij")
    nv = (n - 1) * n  # vertical faces
    nh = n * (n - 1)
    nf = nv + nh

    fc = np.full((nf, 2), -1, dtype=np.int64)
    fc[:nv, 0] = cid(vi, vj).ravel()
    fc[:nv, 1] = cid(vi + 1, vj).ravel()
    fc[nv:, 0] = cid(hi, hj).ravel()
    fc[nv:, 1] = cid(hi, hj + 1).ravel()

    fpos = np.zeros((nf, 2))
    fpos[:nv, 0] = (vi.ravel() + 1.0) * h
    fpos[:nv, 1] = (vj.ravel() + 0.5) * h
    fpos[nv:, 0] = (hi.ravel() + 0.5) * h
    fpos[nv:, 1] = (hj.ravel() + 1.0) * h

    flow = np.full(nf, h)  # face length in 2D

    # divergence: for cell c, sum of outgoing fluxes / vol
    rows = np.concatenate([fc[:, 0], fc[:, 1]])
    cols = np.concatenate([np.arange(nf), np.arange(nf)])
    data = np.concatenate([flow, -flow])  # out of cell0, into cell1
    D = sp.coo_matrix((data, (rows, cols)), shape=(ncell, nf)).tocsr()

    # component Laplacians on the staggered grids (5-point, no-slip):
    # u_x on the (n-1) x n vertical-face lattice, u_y on n x (n-1)
    def lap(nx, ny):
        ex = np.ones(nx)
        ey = np.ones(ny)
        Tx = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
        Ty = sp.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
        # no-slip tangential walls add +1 to the boundary-normal weight;
        # keep the standard 2/h^2 scaling (constant h): factor nu
        return sp.kron(Tx, sp.eye(ny)) + sp.kron(sp.eye(nx), Ty)

    L = sp.block_diag([lap(n - 1, n), lap(n, n - 1)]).tocsr() * nu
    W = sp.diags(1.0 / (h * h) * np.ones(ncell))  # 1/vol weights
    K = (L + alpha * (D.T @ W @ D)).tocsr()
    K = (K + K.T) * 0.5

    rng = np.random.default_rng(0)
    b = rng.standard_normal(nf)
    # make the rhs consistent-ish: remove the mean flux component
    b -= b.mean()

    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    cpos = np.stack(
        [(ii.ravel() + 0.5) * h, (jj.ravel() + 0.5) * h], axis=1
    )
    return StokesProblem(
        A=K.tocsr(),
        b=b,
        D=D,
        cell_pos=cpos,
        cell_vol=np.full(ncell, h * h),
        facet_cells=fc,
        facet_flow=flow,
        facet_pos=fpos,
        alpha=alpha,
    )


def stokes_mac_2d_hdiv(n: int = 16, alpha: float = 10.0, nu: float = 1.0):
    """HDG-flavored facet space: normal flux + tangential trace per facet.

    The test vehicle for the HDiv-variant AMG (reference src/stokes/hdiv):
    every interior facet carries its MAC normal-flux dof; facets away from
    the domain boundary additionally carry a tangential-trace dof
    (boundary-adjacent tangential traces are eliminated by no-slip), so
    the per-facet DOF counts are VARIABLE. The operator is the MAC
    velocity block on the flux dofs plus a facet-lattice Laplacian on the
    tangential dofs (the two families decouple, as in an HDG aux space).

    Returns (StokesProblem over the joint dof space, dof_counts (nf_int,),
    preserved (ndof, 2): the facet coordinates of the constant velocity
    fields e_x, e_y).
    """
    base = stokes_mac_2d(n, alpha=alpha, nu=nu)
    nf = base.A.shape[0]
    h = 1.0 / n
    interior = (base.facet_cells >= 0).all(axis=1)
    assert interior.all()  # stokes_mac_2d already eliminates boundary
    # tangential dofs only away from the boundary (variable counts)
    p = base.facet_pos
    has_t = (p.min(axis=1) > 1.1 * h) & (p.max(axis=1) < 1.0 - 1.1 * h)
    counts = 1 + has_t.astype(np.int64)
    off = np.zeros(nf + 1, dtype=np.int64)
    off[1:] = np.cumsum(counts)
    ndof = int(off[-1])
    # scatter maps: flux dof = off[e], tangential dof = off[e]+1
    flux_dofs = off[:-1]
    tang_dofs = off[:-1][has_t] + 1
    Sf = sp.coo_matrix(
        (np.ones(nf), (flux_dofs, np.arange(nf))), shape=(ndof, nf)
    ).tocsr()
    nt = int(has_t.sum())
    St = sp.coo_matrix(
        (np.ones(nt), (tang_dofs, np.arange(nt))), shape=(ndof, nt)
    ).tocsr()
    # tangential operator: graph Laplacian over same-family facet adjacency
    # (facets sharing a cell), restricted to tangential-carrying facets
    i, j = base.facet_cells[:, 0], base.facet_cells[:, 1]
    inc = sp.coo_matrix(
        (
            np.ones(2 * nf),
            (np.concatenate([i, j]), np.concatenate([np.arange(nf)] * 2)),
        ),
        shape=(len(base.cell_vol), nf),
    ).tocsr()
    Adj = (inc.T @ inc).tolil()
    Adj.setdiag(0)
    Adj = Adj.tocsr()
    Adj.eliminate_zeros()
    Adj = Adj[has_t][:, has_t]
    deg = np.asarray(Adj.sum(axis=1)).ravel()
    Lt = (sp.diags(deg + 1.0) - Adj) * nu  # +1: no-slip boundary weight
    A = (Sf @ base.A @ Sf.T + St @ Lt @ St.T).tocsr()
    A = (A + A.T) * 0.5
    # preserved vectors: constant fields e_x, e_y in facet coordinates
    vertical = base.facet_cells[:, 1] == base.facet_cells[:, 0] + n
    V = np.zeros((ndof, 2))
    V[flux_dofs[vertical], 0] = base.facet_flow[vertical]  # ex normal flux
    V[flux_dofs[~vertical], 1] = base.facet_flow[~vertical]
    vt = vertical[has_t]
    V[tang_dofs[vt], 1] = 1.0  # vertical facet tangent = e_y
    V[tang_dofs[~vt], 0] = 1.0
    rng = np.random.default_rng(1)
    b = rng.standard_normal(ndof)
    b -= b.mean()
    prob = StokesProblem(
        A=A,
        b=b,
        D=base.D @ Sf.T,  # divergence acts on the flux components
        cell_pos=base.cell_pos,
        cell_vol=base.cell_vol,
        facet_cells=base.facet_cells,
        facet_flow=base.facet_flow,
        facet_pos=base.facet_pos,
        alpha=alpha,
    )
    return prob, counts, V


def _simplex_facets(verts: np.ndarray, elems: np.ndarray):
    """Facet geometry of a simplicial mesh.

    Returns (fc_all (nf_all, 2) adjacent cells (-1 = boundary),
    area (nf_all,), unit normal (nf_all, dim) oriented cell0 -> cell1,
    facet centroids, cell volumes, cell centroids, inv (ncell*nl,) facet
    index of each local face, nl = dim+1, ncell, fverts (nf_all, dim)
    primal vertex ids of each facet).
    """
    ncell, nl = elems.shape
    dim = nl - 1
    # facet k of a simplex = all vertices but the k-th
    faces = np.stack(
        [np.delete(elems, k, axis=1) for k in range(nl)], axis=1
    )  # (ncell, nl, dim)
    faces_flat = np.sort(faces.reshape(-1, dim), axis=1)
    uniq, inv = np.unique(faces_flat, axis=0, return_inverse=True)
    nf_all = len(uniq)
    cells_of = np.repeat(np.arange(ncell, dtype=np.int64), nl)
    fc_all = np.full((nf_all, 2), -1, dtype=np.int64)
    # first-come cell0, second cell1 (each facet appears <= 2 times)
    order = np.argsort(inv, kind="stable")
    f_sorted = inv[order]
    c_sorted = cells_of[order]
    first = np.r_[True, f_sorted[1:] != f_sorted[:-1]]
    fc_all[f_sorted[first], 0] = c_sorted[first]
    fc_all[f_sorted[~first], 1] = c_sorted[~first]

    X = verts[elems]  # (ncell, nl, dim)
    Dm = X[:, 1:, :] - X[:, :1, :]
    vol = np.abs(np.linalg.det(Dm)) / np.prod(np.arange(1, dim + 1))
    cpos = X.mean(axis=1)

    fx = verts[uniq]  # (nf_all, dim, dim) facet vertex coords
    fpos = fx.mean(axis=1)
    if dim == 2:
        tvec = fx[:, 1] - fx[:, 0]
        area = np.linalg.norm(tvec, axis=1)
        normal = np.stack([tvec[:, 1], -tvec[:, 0]], axis=1)
    else:
        e1 = fx[:, 1] - fx[:, 0]
        e2 = fx[:, 2] - fx[:, 0]
        normal = 0.5 * np.cross(e1, e2)
        area = np.linalg.norm(normal, axis=1)
    normal = normal / np.maximum(area[:, None], 1e-300)
    # orient cell0 -> cell1: flip where the normal points INTO cell0
    d0 = fpos - cpos[fc_all[:, 0]]
    flip = (normal * d0).sum(axis=1) < 0
    normal[flip] *= -1.0
    return fc_all, area, normal, fpos, vol, cpos, inv, nl, ncell, uniq


def stokes_tri(
    n: int = 12,
    dim: int = 2,
    alpha: float = 10.0,
    nu: float = 1.0,
    seed: int = 0,
):
    """Unstructured SIMPLICIAL facet-flux Stokes velocity block.

    The unstructured counterpart of the MAC problems above and the test
    vehicle for the reference's facet-based Stokes AMG on real simplicial
    meshes (the reference's NC/HDiv spaces put velocity DOFs on mesh
    facets; reference src/stokes/): one normal-velocity DOF per
    interior facet of a perturbed Delaunay triangulation (triangles in 2D,
    tets in 3D), no-slip boundary facets eliminated.

        K = nu * L + alpha * D^T W D

    D is the exact geometric divergence (signed facet areas over cells),
    W = diag(1/vol), and L the cell-wise facet-coupling Laplacian: for
    every cell and every pair of its facets (e, e'), the SPD pair stencil
    w [[1,-1],[-1,1]] with w = area_e * area_e' / vol — the P0-HDG
    grad-grad analog; pairs with an eliminated boundary facet contribute
    +w to the interior facet's diagonal (the no-slip wall term).

    Returns (StokesProblem, normals (nf_int, dim) unit facet normals in
    the cell0 -> cell1 orientation).
    """
    from .fem import _unstructured_mesh

    verts, elems = _unstructured_mesh(n, dim, seed=seed)
    geo = _simplex_facets(verts, elems)
    (fc_all, area, normal, fpos, vol, cpos, inv, nl, ncell, fverts) = geo
    interior = fc_all[:, 1] >= 0
    fi = np.flatnonzero(interior)
    nf = len(fi)
    fidx = np.full(len(fc_all), -1, dtype=np.int64)
    fidx[fi] = np.arange(nf)
    fc = fc_all[fi]
    flow = area[fi]

    # --- exact divergence ----------------------------------------------------
    rows = np.concatenate([fc[:, 0], fc[:, 1]])
    cols = np.concatenate([np.arange(nf), np.arange(nf)])
    data = np.concatenate([flow, -flow])
    D = sp.coo_matrix((data, (rows, cols)), shape=(ncell, nf)).tocsr()

    # --- cell-wise facet-pair Laplacian --------------------------------------
    f_of_cell = fidx[inv.reshape(ncell, nl)]  # (ncell, nl), -1 = boundary
    a_of_cell = area[inv.reshape(ncell, nl)]
    li, lj, lv = [], [], []
    for a in range(nl):
        for b2 in range(a + 1, nl):
            ea, eb = f_of_cell[:, a], f_of_cell[:, b2]
            w = nu * a_of_cell[:, a] * a_of_cell[:, b2] / vol
            both = (ea >= 0) & (eb >= 0)
            li.extend([ea[both], eb[both], ea[both], eb[both]])
            lj.extend([ea[both], eb[both], eb[both], ea[both]])
            lv.extend([w[both], w[both], -w[both], -w[both]])
            onlya = (ea >= 0) & (eb < 0)  # wall pair: diagonal only
            li.append(ea[onlya])
            lj.append(ea[onlya])
            lv.append(w[onlya])
            onlyb = (eb >= 0) & (ea < 0)
            li.append(eb[onlyb])
            lj.append(eb[onlyb])
            lv.append(w[onlyb])
    L = sp.coo_matrix(
        (np.concatenate(lv), (np.concatenate(li), np.concatenate(lj))),
        shape=(nf, nf),
    ).tocsr()

    W = sp.diags(1.0 / vol)
    K = (L + alpha * (D.T @ W @ D)).tocsr()
    K = (K + K.T) * 0.5

    rng = np.random.default_rng(seed)
    b = rng.standard_normal(nf)
    b -= b.mean()
    prob = StokesProblem(
        A=K.tocsr(),
        b=b,
        D=D,
        cell_pos=cpos,
        cell_vol=vol,
        facet_cells=fc,
        facet_flow=flow,
        facet_pos=fpos[fi],
        alpha=alpha,
        facet_verts=fverts[fi],
        vert_pos=verts,
        bnd_facet_verts=fverts[~interior],
    )
    return prob, normal[fi]


def stokes_cr(
    n: int = 10,
    dim: int = 2,
    alpha: float = 10.0,
    nu: float = 1.0,
    seed: int = 0,
):
    """Crouzeix-Raviart (non-conforming P1) vector Stokes GG system.

    The real NC discretization of the reference's `stokes_gg_*` exports
    (reference src/stokes/ncfes/ with the `NoCoH1FESpace`): velocity
    = vector-valued CR P1 on a perturbed-Delaunay simplicial mesh, one
    dim-vector DOF per interior facet (midpoint value), no-slip boundary
    facet DOFs eliminated. Bilinear form = broken grad-grad + grad-div
    penalty:

        a(u, v) = nu sum_T int_T grad u : grad v
                  + alpha sum_T (1/vol_T) (int_T div u)(int_T div v)

    CR identity: the element divergence integral is EXACTLY the facet-flux
    form, int_T div u = sum_f |f| n_f^out . u_f, so the dual-mesh edge
    carries the facet area-normal VECTOR as its flow (the reference's
    facet flow vector, nc_stokes_mesh.hpp:19-39).

    Returns (StokesProblem with facet_flow of shape (nf, dim), unit
    normals (nf, dim)). DOF layout is facet-major: dof(f, k) = f*dim + k.
    """
    from .fem import _unstructured_mesh

    verts, elems = _unstructured_mesh(n, dim, seed=seed)
    (fc_all, area, normal, fpos, vol, cpos, inv, nl, ncell,
     fverts) = _simplex_facets(
        verts, elems
    )
    interior = fc_all[:, 1] >= 0
    fi = np.flatnonzero(interior)
    nf = len(fi)
    fidx = np.full(len(fc_all), -1, dtype=np.int64)
    fidx[fi] = np.arange(nf)
    fc = fc_all[fi]
    flow_vec = area[fi, None] * normal[fi]  # oriented cell0 -> cell1

    # per-cell outward area-normals of the local facets
    f_glob = inv.reshape(ncell, nl)
    f_loc = fidx[f_glob]  # -1 = boundary facet (dof eliminated)
    own0 = fc_all[f_glob, 0] == np.arange(ncell)[:, None]
    sgn = np.where(own0, 1.0, -1.0)
    aw = (
        area[f_glob, None] * normal[f_glob] * sgn[:, :, None]
    )  # (ncell, nl, dim) outward |f| n

    # broken grad-grad: K_ab = nu (aw_a . aw_b) / vol * I_dim
    li, lj, lv = [], [], []
    for a in range(nl):
        for b2 in range(nl):
            ea, eb = f_loc[:, a], f_loc[:, b2]
            keep = (ea >= 0) & (eb >= 0)
            if not keep.any():
                continue
            w = nu * (aw[:, a, :] * aw[:, b2, :]).sum(axis=1) / vol
            li.append(ea[keep])
            lj.append(eb[keep])
            lv.append(w[keep])
    li = np.concatenate(li)
    lj = np.concatenate(lj)
    lv = np.concatenate(lv)
    # expand scalar facet couplings to dim-blocks (w * I_dim)
    k = np.arange(dim)
    rows = (li[:, None] * dim + k).ravel()
    cols = (lj[:, None] * dim + k).ravel()
    vals = np.repeat(lv, dim)
    GG = sp.coo_matrix(
        (vals, (rows, cols)), shape=(nf * dim, nf * dim)
    ).tocsr()

    # exact divergence on the vector dofs: D[c, f*dim:k] = +-flow_vec
    rD = np.concatenate([np.repeat(fc[:, 0], dim), np.repeat(fc[:, 1], dim)])
    cD = np.concatenate([np.arange(nf * dim)] * 2)
    vD = np.concatenate([flow_vec.ravel(), -flow_vec.ravel()])
    D = sp.coo_matrix((vD, (rD, cD)), shape=(ncell, nf * dim)).tocsr()

    W = sp.diags(1.0 / vol)
    K = (GG + alpha * (D.T @ W @ D)).tocsr()
    K = (K + K.T) * 0.5

    rng = np.random.default_rng(seed)
    b = rng.standard_normal(nf * dim)
    b -= b.mean()
    prob = StokesProblem(
        A=K.tocsr(),
        b=b,
        D=D,
        cell_pos=cpos,
        cell_vol=vol,
        facet_cells=fc,
        facet_flow=flow_vec,  # VECTOR flow (nf, dim)
        facet_pos=fpos[fi],
        alpha=alpha,
        facet_verts=fverts[fi],
        vert_pos=verts,
        bnd_facet_verts=fverts[~interior],
    )
    return prob, normal[fi]


def stokes_tri_hdiv(
    n: int = 12, alpha: float = 10.0, nu: float = 1.0, seed: int = 0,
    dim: int = 2,
):
    """HDG-flavored facet space on an unstructured SIMPLICIAL mesh.

    The simplicial counterpart of :func:`stokes_mac_2d_hdiv` (the test
    vehicle for the HDiv-variant AMG, reference src/stokes/hdiv): every
    interior facet carries its normal-flux dof; facets whose both cells
    are interior additionally carry dim-1 tangential-trace dofs, so
    per-facet DOF counts are VARIABLE (1 or dim). Preserved vectors are
    the constant velocity fields e_k expressed in the facet frames
    (normal velocity n.e_k on flux dofs, tangential t_j.e_k on traces).

    Returns (StokesProblem over the joint space, dof counts (nf,),
    preserved (ndof, dim)).
    """
    base, normal = stokes_tri(n, dim=dim, alpha=alpha, nu=nu, seed=seed)
    nf = base.n
    ncell = len(base.cell_vol)
    # a cell is interior iff all its facets are interior (dim+1 of them)
    cnt = np.bincount(base.facet_cells.ravel(), minlength=ncell)
    cell_interior = cnt == dim + 1
    has_t = cell_interior[base.facet_cells].all(axis=1)
    nt_per = dim - 1
    counts = 1 + nt_per * has_t.astype(np.int64)
    off = np.zeros(nf + 1, dtype=np.int64)
    off[1:] = np.cumsum(counts)
    ndof = int(off[-1])
    flux_dofs = off[:-1]
    Sf = sp.coo_matrix(
        (np.ones(nf), (flux_dofs, np.arange(nf))), shape=(ndof, nf)
    ).tocsr()
    # tangential operator: cell-shared facet adjacency graph Laplacian
    i, j = base.facet_cells[:, 0], base.facet_cells[:, 1]
    inc = sp.coo_matrix(
        (
            np.ones(2 * nf),
            (np.concatenate([i, j]), np.concatenate([np.arange(nf)] * 2)),
        ),
        shape=(ncell, nf),
    ).tocsr()
    Adj = (inc.T @ inc).tolil()
    Adj.setdiag(0)
    Adj = Adj.tocsr()
    Adj.eliminate_zeros()
    Adj = Adj[has_t][:, has_t]
    deg = np.asarray(Adj.sum(axis=1)).ravel()
    Lt = (sp.diags(deg + 1.0) - Adj) * nu  # +1: no-slip boundary weight
    A = (Sf @ base.A @ Sf.T).tocsr()
    # orthonormal tangent frame per facet
    if dim == 2:
        tangents = [np.stack([-normal[:, 1], normal[:, 0]], axis=1)]
    else:
        a = np.zeros_like(normal)
        small = np.argmin(np.abs(normal), axis=1)
        a[np.arange(nf), small] = 1.0
        t1 = a - (a * normal).sum(axis=1)[:, None] * normal
        t1 /= np.maximum(np.linalg.norm(t1, axis=1), 1e-300)[:, None]
        tangents = [t1, np.cross(normal, t1)]
    nt = int(has_t.sum())
    V = np.zeros((ndof, dim))
    V[flux_dofs] = normal
    for q in range(nt_per):
        tq_dofs = off[:-1][has_t] + 1 + q
        St = sp.coo_matrix(
            (np.ones(nt), (tq_dofs, np.arange(nt))), shape=(ndof, nt)
        ).tocsr()
        A = A + St @ Lt @ St.T
        V[tq_dofs] = tangents[q][has_t]
    A = A.tocsr()
    A = (A + A.T) * 0.5
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal(ndof)
    b -= b.mean()
    prob = StokesProblem(
        A=A,
        b=b,
        D=base.D @ Sf.T,
        cell_pos=base.cell_pos,
        cell_vol=base.cell_vol,
        facet_cells=base.facet_cells,
        facet_flow=base.facet_flow,
        facet_pos=base.facet_pos,
        alpha=alpha,
    )
    return prob, counts, V


def stokes_hdg_p1(
    n: int = 8, alpha: float = 10.0, nu: float = 1.0, seed: int = 0,
    dim: int = 2,
):
    """Statically-condensed P1-HDG Stokes velocity system + embedding.

    The REAL higher-order facet FE source for the HDiv-HDG embedding
    machinery (reference src/stokes/hdiv/hdiv_hdg_embedding.hpp:20-70):
    element space = P1(T)^dim (vector, dim+1 nodes), facet space =
    P1(F)^dim (vector traces, dim nodes per facet), bilinear form

        a(u, uh; v, vh) = nu sum_T int_T grad u : grad v
            + sum_F (nu/h_F) int_F (u - uh).(v - vh)
            + alpha sum_T (1/vol)(int_T div u)(int_T div v)

    with h_F = |F|^(1/(dim-1)) (interior-penalty coupling of element
    traces to the facet unknowns; no-slip: boundary facet traces are
    zero). Element DOFs are eliminated per element by static condensation
    — the Schur complement S lives on the facet-P1 unknowns, dim^2 DOFs
    per interior facet (dim nodes x dim comps).

    The AUX space is the per-facet constant (mean) velocity — dim DOFs per
    facet, exactly the vector NC facet space the Stokes AMG coarsens. The
    embedding E maps an aux vector to equal nodal trace values.

    Returns (S (ndof x ndof) csr, b, E (ndof x nf*dim) csr, aux geometry
    dict(cell_pos, cell_vol, facet_cells, facet_flow)).
    """
    from .fem import _unstructured_mesh

    verts, elems = _unstructured_mesh(n, dim, seed=seed)
    (fc_all, area, normal, fpos, vol, cpos, inv, nl, ncell,
     fverts) = _simplex_facets(
        verts, elems
    )
    interior = fc_all[:, 1] >= 0
    fi = np.flatnonzero(interior)
    nf = len(fi)
    fidx = np.full(len(fc_all), -1, dtype=np.int64)
    fidx[fi] = np.arange(nf)
    nfd = dim * dim  # facet dofs: dim nodes x dim comps
    ndof = nf * nfd
    ned = nl * dim  # element dofs

    # P1 nodal gradients per element: G (ncell, nl, dim)
    X = verts[elems]
    Dm = X[:, 1:, :] - X[:, :1, :]  # (ncell, dim, dim) edge matrix rows
    Ginner = np.linalg.inv(Dm)  # columns = gradients of lambda_1..lambda_d
    G = np.zeros((ncell, nl, dim))
    G[:, 1:, :] = np.transpose(Ginner, (0, 2, 1))
    G[:, 0] = -G[:, 1:].sum(axis=1)

    # element block: grad-grad + div penalty
    Kgg = nu * vol[:, None, None] * np.einsum("tik,tjk->tij", G, G)
    Aee = np.einsum("tij,kl->tikjl", Kgg, np.eye(dim)).reshape(
        ncell, ned, ned
    )
    dflat = (vol[:, None, None] * G).reshape(ncell, ned)
    Aee += alpha / vol[:, None, None] * np.einsum(
        "ti,tj->tij", dflat, dflat
    )

    # facet-penalty P1 mass: int_F phi_a phi_b = |F| (1+d_ab)/(dim(dim+1))
    # scaled by tau = nu / h_F, h_F = |F|^(1/(dim-1))
    pen = nu * area ** (1.0 - 1.0 / (dim - 1) if dim > 2 else 0.0)
    pen = pen / (dim * (dim + 1))
    Mfac = 1.0 + np.eye(dim)  # (facet-node a, facet-node b) factor

    f_glob = inv.reshape(ncell, nl)
    Bef = np.zeros((ncell, ned, nl * nfd))
    fcols = np.full((ncell, nl), -1, dtype=np.int64)
    cell_ids = np.arange(ncell)
    for k in range(nl):
        fg = f_glob[:, k]
        fl = fidx[fg]
        fcols[:, k] = fl
        w = pen[fg]  # (ncell,) per-facet penalty coefficient
        loc = np.delete(np.arange(nl), k)  # local nodes of face k
        gl = elems[:, loc]  # (ncell, dim) their global ids
        # facet node p (sorted global order) -> element-local node
        order = np.argsort(gl, axis=1)
        eloc = loc[order]  # (ncell, dim)
        has = fl >= 0
        for fa in range(dim):
            ea = eloc[:, fa]
            for fb in range(dim):
                eb = eloc[:, fb]
                m = w * Mfac[fa, fb]
                for c in range(dim):
                    # element-element trace coupling (all facets)
                    Aee[cell_ids, ea * dim + c, eb * dim + c] += m
                    # element-facet coupling (interior facets only)
                    Bef[
                        has,
                        ea[has] * dim + c,
                        k * nfd + fb * dim + c,
                    ] -= m[has]

    # facet-facet penalty: sum over adjacent elements of the facet mass
    n_adj = (fc_all[fi] >= 0).sum(axis=1)
    Aff_blk = np.zeros((nf, nfd, nfd))
    for fa in range(dim):
        for fb in range(dim):
            for c in range(dim):
                Aff_blk[:, fa * dim + c, fb * dim + c] = (
                    n_adj * pen[fi] * Mfac[fa, fb]
                )

    # static condensation: S = A_ff - sum_T B^T Aee^-1 B
    Xs = np.linalg.solve(Aee, Bef)
    Sc = -np.einsum("tiu,tiv->tuv", Bef, Xs)
    nw = nl * nfd
    cols_w = (
        fcols[:, :, None] * nfd + np.arange(nfd)[None, None, :]
    ).reshape(ncell, nw)
    valid = (fcols[:, :, None] >= 0).repeat(nfd, axis=2).reshape(ncell, nw)
    rows_l, cols_l, vals_l = [], [], []
    for u in range(nw):
        for v in range(nw):
            m = valid[:, u] & valid[:, v]
            if not m.any():
                continue
            rows_l.append(cols_w[m, u])
            cols_l.append(cols_w[m, v])
            vals_l.append(Sc[m, u, v])
    bi = np.arange(nf)[:, None, None] * nfd + np.arange(nfd)[None, :, None]
    bj = np.arange(nf)[:, None, None] * nfd + np.arange(nfd)[None, None, :]
    rows_l.append(np.broadcast_to(bi, (nf, nfd, nfd)).ravel())
    cols_l.append(np.broadcast_to(bj, (nf, nfd, nfd)).ravel())
    vals_l.append(Aff_blk.ravel())
    S = sp.coo_matrix(
        (
            np.concatenate(vals_l),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(ndof, ndof),
    ).tocsr()
    S.sum_duplicates()
    S = (S + S.T) * 0.5

    # embedding: aux (facet-constant vector) -> equal nodal traces
    rE = np.concatenate(
        [
            np.arange(nf) * nfd + p * dim + c
            for p in range(dim)
            for c in range(dim)
        ]
    )
    cE = np.concatenate(
        [np.arange(nf) * dim + c for _p in range(dim) for c in range(dim)]
    )
    E = sp.coo_matrix(
        (np.ones(len(rE)), (rE, cE)), shape=(ndof, nf * dim)
    ).tocsr()

    rng = np.random.default_rng(seed)
    b = rng.standard_normal(ndof)
    b -= b.mean()
    geo = dict(
        cell_pos=cpos,
        cell_vol=vol,
        facet_cells=fc_all[fi],
        facet_flow=area[fi, None] * normal[fi],
    )
    return S, b, E, geo


def stokes_mac_3d(n: int = 8, alpha: float = 10.0, nu: float = 1.0):
    """3D MAC Stokes velocity block on an n^3 unit-cube grid."""
    h = 1.0 / n
    ncell = n**3

    def cid(i, j, k):
        return (i * n + j) * n + k

    axes = []
    for ax in range(3):
        dims = [n, n, n]
        dims[ax] -= 1
        I, J, K = np.meshgrid(
            np.arange(dims[0]), np.arange(dims[1]), np.arange(dims[2]),
            indexing="ij",
        )
        step = [0, 0, 0]
        step[ax] = 1
        c0 = cid(I, J, K).ravel()
        c1 = cid(I + step[0], J + step[1], K + step[2]).ravel()
        pos = np.stack(
            [
                (I.ravel() + (1.0 if ax == 0 else 0.5)) * h,
                (J.ravel() + (1.0 if ax == 1 else 0.5)) * h,
                (K.ravel() + (1.0 if ax == 2 else 0.5)) * h,
            ],
            axis=1,
        )
        axes.append((c0, c1, pos, dims))

    fc = np.concatenate(
        [np.stack([a[0], a[1]], axis=1) for a in axes]
    ).astype(np.int64)
    fpos = np.concatenate([a[2] for a in axes])
    nf = len(fc)
    flow = np.full(nf, h * h)  # face area

    rows = np.concatenate([fc[:, 0], fc[:, 1]])
    cols = np.concatenate([np.arange(nf), np.arange(nf)])
    data = np.concatenate([flow, -flow])
    D = sp.coo_matrix((data, (rows, cols)), shape=(ncell, nf)).tocsr()

    def lap3(dims):
        mats = []
        for d in dims:
            e = np.ones(d)
            mats.append(sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1]))
        L = (
            sp.kron(sp.kron(mats[0], sp.eye(dims[1])), sp.eye(dims[2]))
            + sp.kron(sp.kron(sp.eye(dims[0]), mats[1]), sp.eye(dims[2]))
            + sp.kron(sp.kron(sp.eye(dims[0]), sp.eye(dims[1])), mats[2])
        )
        return L

    L = sp.block_diag([lap3(a[3]) for a in axes]).tocsr() * nu * h
    W = sp.diags(np.full(ncell, 1.0 / h**3))
    Kmat = (L + alpha * (D.T @ W @ D)).tocsr()
    Kmat = (Kmat + Kmat.T) * 0.5

    rng = np.random.default_rng(0)
    b = rng.standard_normal(nf)
    b -= b.mean()

    I, J, K2 = np.meshgrid(
        np.arange(n), np.arange(n), np.arange(n), indexing="ij"
    )
    cpos = np.stack(
        [(I.ravel() + 0.5) * h, (J.ravel() + 0.5) * h, (K2.ravel() + 0.5) * h],
        axis=1,
    )
    return StokesProblem(
        A=Kmat.tocsr(),
        b=b,
        D=D,
        cell_pos=cpos,
        cell_vol=np.full(ncell, h**3),
        facet_cells=fc,
        facet_flow=flow,
        facet_pos=fpos,
        alpha=alpha,
    )
