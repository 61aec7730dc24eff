"""Elasticity AMG energy (2D: 3 DOFs/vertex, 3D: 6 DOFs/vertex).

Copied from ngsamg_tpu/apps/elasticity.py with its native branches: as
there, each step first asks the native extension (``frob2_sym``,
``elast_ahat_bsr``, ``rigid_edge_blocks``, ``bsr_from_edge_blocks``,
``elast_rm_diag``, ``harmonic_mean_sym``, ``elast_soc_robust``,
``elast_map_edge_mats``, ``pencil_extreme_eig``; ``ngsamg_tpu_torch.native``)
and runs the numpy code beside it where ``native.HAVE_NATIVE`` is off. The
native robust SOC is a Jacobi eigensolver, so it can order near-ties
differently from numpy's ``eigh``: the two switch settings build slightly
different hierarchies, each the JAX package's under the same setting. The
device pencil solver of ``_pencil_extreme_eig`` (ops/batched_la.py, behind
``DEVICE_SOC_MIN_EDGES``, off by default as in the JAX package) runs on the
energy's ``device``, which the preconditioner sets to its own; a failure
there raises.

The reference's `EpsEpsEnergy` (elasticity_energy.hpp:11-150) with DPV = 3
(2D: 2 displacements + 1 rotation) / 6 (3D: 3 + 3), vertex data = position +
weight (`ElastVData`), edge data = scalar energy weight extracted from the
assembled matrix (the reference projects matrix entries onto the edge
tangent; here the Frobenius norm of the displacement coupling block serves
the same role).

The *rigid-body transport* Q(a -> b) moves a (translation, rotation)
coefficient vector between points (`GetQiToj`): a rigid motion
u(x) = t + omega x (x - a) parameterized at a equals the motion
(t - skew(d) omega, omega) parameterized at b, d = b - a. Piecewise
prolongation blocks are exactly these transports; the finest-level embedding
E keeps only the displacement rows (disp-only FEM space -> disp+rot AMG
space, the reference's `BuildEmbedding` E_D).

The replacement matrix penalizes the difference of coefficients transported
to the edge midpoint — its kernel is exactly the global rigid-body modes, so
smoothed prolongation + kernel-preserving truncation keep RBMs representable
on every level (the reference's `CheckKVecs` invariant).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import native
from ..mesh.topo import AlgebraicMesh, scatter_add
from ..sparse.host import to_bsr
from .base import Energy


def _frob2T(B: np.ndarray) -> np.ndarray:
    """Transpose-invariant batched Frobenius norm^2 (bitwise).

    Sums the squared entries in an orientation-canonical order (diagonal
    first, then unordered off-diagonal pairs), so the owner of row (i,j)
    and the owner of row (j,i) — who holds the TRANSPOSED block — compute
    bitwise-identical weights. Required for the distributed setup's
    serial-equality guarantee.
    """
    nat = native.frob2_sym(B) if B.ndim == 3 else None
    if nat is not None:
        return nat
    sq = B * B
    d = np.einsum("...ii->...i", sq).sum(axis=-1)
    s = sq + np.swapaxes(sq, -1, -2)  # commutative add: transpose-invariant
    iu, ju = np.triu_indices(B.shape[-1], k=1)
    return d + s[..., iu, ju].sum(axis=-1)


def _skew(d: np.ndarray) -> np.ndarray:
    """Batched 3D skew matrices: skew(d) @ v = d x v. d: (m, 3)."""
    m = len(d)
    S = np.zeros((m, 3, 3))
    S[:, 0, 1] = -d[:, 2]
    S[:, 0, 2] = d[:, 1]
    S[:, 1, 0] = d[:, 2]
    S[:, 1, 2] = -d[:, 0]
    S[:, 2, 0] = -d[:, 1]
    S[:, 2, 1] = d[:, 0]
    return S


class ElasticityEnergy(Energy):
    """dim=2 -> dpv=3, dim=3 -> dpv=6.

    ``rot_scale`` rescales the rotational coefficients r' = r / s so the
    transport couplings d/s stay O(1) (the reference's `rot_scale` ~ 1/h):
    "auto" picks s = median edge length of the finest mesh.
    """

    default_robust = True  # ENABLE_ROBUST_ELASTICITY_COARSENING analog
    transport_kind = "rigid"  # native truncate_prol kernel dispatch

    def __init__(self, dim: int, rot_scale: float | str = "auto",
                 device=None):
        # goal-driven coarsening default for 3D (reference per-app
        # factory flags): fixed 2-round pairs give oc ~5 at 1M DoF with
        # 3x3-block smoothed prolongations; aaf 0.08 -> aggregates ~12,
        # oc ~2.1 at 32 iterations. 2D keeps fixed rounds (the jump-beam
        # suite regresses under forced-goal aggregation there).
        self.default_aaf = 0.08 if dim == 3 else None
        if dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        self.dim = dim
        self.dpv = 3 if dim == 2 else 6
        self.rot_scale = rot_scale
        self._s = 1.0 if rot_scale == "auto" else float(rot_scale)
        # where the batched pencil solver runs (``_pencil_extreme_eig``);
        # AMGPreconditioner sets its own device here
        self.device = device

    # -- transport --------------------------------------------------------
    def transport(self, pos_from, pos_to) -> np.ndarray:
        """Q(a -> b): (m, dpv, dpv) rigid-body coefficient transport.

        In scaled coordinates (t, r/s): Q' = S Q S^-1 with S = diag(I, I/s),
        i.e. the displacement-rotation coupling becomes -skew(d)*s... note
        the coupling block is multiplied by the rotation scale s.
        """
        d = np.asarray(pos_to, float) - np.asarray(pos_from, float)
        m = len(d)
        s = self._s
        Q = np.tile(np.eye(self.dpv), (m, 1, 1))
        if self.dim == 2:
            # u(b) = t + omega * perp(d), perp(d) = (-dy, dx)
            Q[:, 0, 2] = -d[:, 1] * s
            Q[:, 1, 2] = d[:, 0] * s
        else:
            # u(b) = t + omega x d = t - skew(d) omega
            Q[:, :3, 3:] = -_skew(d) * s
        return Q

    def embed_blocks(self, m: int) -> np.ndarray:
        """E_v = [I_dim | 0]: take displacement rows of the rigid coeff."""
        E = np.zeros((m, self.dim, self.dpv))
        E[:, : self.dim, : self.dim] = np.eye(self.dim)
        return E

    def embedding_matrix(self, mesh: AlgebraicMesh) -> sp.spmatrix:
        nv = mesh.nv
        E = self.embed_blocks(nv)
        return sp.bsr_matrix(
            (E, np.arange(nv, dtype=np.int32), np.arange(nv + 1)),
            shape=(nv * self.dim, nv * self.dpv),
        )

    # -- finest-level mesh -------------------------------------------------
    def build_finest_mesh(self, A, coords=None) -> AlgebraicMesh:
        """Topology + edge matrices from the assembled matrix.

        Edge matrix = |t^T (-A_ij) t| * (t (x) t) embedded in the DPV space
        (rank-1 tangential stiffness; the reference's `CalcEdgeWeights`),
        plus the scalar weight used by the
        approximate SOC. Coarse levels accumulate transported full matrices.
        """
        if coords is None:
            raise ValueError("elasticity needs vertex coordinates")
        dim, dpv = self.dim, self.dpv
        B = to_bsr(A, dim)
        nv = B.shape[0] // dim
        if len(coords) != nv:
            raise ValueError(
                f"coords rows {len(coords)} != vertices {nv}"
            )
        pos = np.asarray(coords, dtype=np.float64)
        # scalar connectivity: Frobenius norms of displacement blocks
        # (orientation-canonical summation: see _frob2T)
        norms = np.sqrt(_frob2T(B.data.astype(np.float64)))
        # data must be COPIED too: scipy csr aliases it, and
        # setdiag/eliminate_zeros compact W.data IN PLACE — which would
        # scramble the `norms` used for the edge/block alignment below
        W = sp.csr_matrix(
            (norms.copy(), B.indices.copy(), B.indptr.copy()),
            shape=(nv, nv),
        )
        diag = W.diagonal().copy()
        W.setdiag(0.0)
        W.eliminate_zeros()
        U = sp.triu(W, k=1).tocoo()
        mesh = AlgebraicMesh(
            nv=nv,
            edges=np.stack([U.row, U.col], axis=1).astype(np.int64),
        )
        # off-diagonal displacement blocks for the edges (vectorized lookup).
        # Explicitly-stored ZERO blocks were dropped from W by
        # eliminate_zeros above — drop them here too or the edge/block
        # alignment silently shifts (norms>0 matches eliminate_zeros exactly)
        rows_all = np.repeat(np.arange(nv), np.diff(B.indptr))
        upper = (rows_all < B.indices) & (norms > 0)
        blk_i, blk_j = rows_all[upper], B.indices[upper]
        blocks = B.data[upper].astype(np.float64)
        assert len(blocks) == mesh.ne, (len(blocks), mesh.ne)
        # the triu COO above and this BSR walk enumerate the same edges;
        # align by (i, j) sort order
        order_u = np.lexsort((mesh.edges[:, 1], mesh.edges[:, 0]))
        order_b = np.lexsort((blk_j, blk_i))
        inv = np.empty_like(order_u)
        inv[order_u] = np.arange(len(order_u))
        blocks = blocks[order_b][inv]  # aligned with mesh.edges
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        t = pos[j] - pos[i]
        lens = np.linalg.norm(t, axis=1)
        if self.rot_scale == "auto" and len(lens):
            # rotations measured in units of h: couplings d * s stay O(1)
            self._s = 1.0 / max(float(np.median(lens)), 1e-300)
        t /= np.maximum(lens[:, None], 1e-300)
        # symmetrize before the quadratic form (t^T B t == t^T B_sym t in
        # exact arithmetic) so both edge orientations compute bitwise-equal
        # tangential stiffnesses (distributed-setup serial equality)
        blocks_sym = 0.5 * (blocks + np.transpose(blocks, (0, 2, 1)))
        fac = np.abs(np.einsum("ei,eij,ej->e", t, -blocks_sym, t))
        emat = np.zeros((mesh.ne, dpv, dpv))
        emat[:, :dim, :dim] = fac[:, None, None] * np.einsum(
            "ei,ej->eij", t, t
        )
        mesh.edge_data["mat"] = emat
        mesh.edge_data["wt"] = U.data.copy()
        # vertex weight: excess of diagonal over incident couplings — the
        # Dirichlet/L2 part (same construction as H1; near the clamped
        # boundary this correctly breaks rigid-mode preservation)
        wts = mesh.edge_data["wt"]
        vwt = (
            diag
            - np.bincount(mesh.edges[:, 0], weights=wts, minlength=mesh.nv)
            - np.bincount(mesh.edges[:, 1], weights=wts, minlength=mesh.nv)
        )
        mesh.vertex_data["l2wt"] = np.maximum(vwt, 0.0)
        mesh.vertex_data["pos"] = np.asarray(coords, dtype=np.float64)
        return mesh

    # -- strength of connection -------------------------------------------
    def soc(self, mesh: AlgebraicMesh) -> np.ndarray:
        w = mesh.edge_data["wt"]
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        nv = mesh.nv
        d = (
            mesh.vertex_data["l2wt"]
            + np.bincount(i, weights=w, minlength=nv)
            + np.bincount(j, weights=w, minlength=nv)
        )
        d = np.maximum(d, 1e-300)
        return w * 0.5 * (1.0 / d[i] + 1.0 / d[j])

    # -- replacement (aux) matrix -----------------------------------------
    def replacement_matrix(self, mesh: AlgebraicMesh) -> sp.spmatrix:
        """A-hat from rigid-body edge energies.

        Edge (i,j), midpoint m: K_e = w_e * [Qim, -Qjm]^T [Qim, -Qjm]
        (the reference's `CalcRMBlock`) + vertex-weight * identity on displacement DOFs.
        """
        fused = native.elast_ahat_bsr(
            mesh.vertex_data["pos"], mesh.edges, mesh.edge_data["mat"],
            self._s, mesh.vertex_data["l2wt"],
        )
        if fused is not None:
            # rigid edge blocks scattered straight into sorted BSR, no
            # (ne, dpv, dpv) temporaries (bitwise equal to the
            # rigid_edge_blocks + bsr_from_edge_blocks pipeline below)
            return fused
        nv, dpv = mesh.nv, self.dpv
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        Bii, Bij, Bji, Bjj = self._edge_rm_blocks(mesh)

        vwt = mesh.vertex_data["l2wt"]
        Dv = np.zeros((nv, dpv, dpv))
        idx = np.arange(self.dim)
        Dv[:, idx, idx] = vwt[:, None]
        nat = native.bsr_from_edge_blocks(mesh.edges, Bii, Bij, Bji, Bjj, Dv)
        if nat is not None:
            return nat
        rows = np.concatenate([i, j, i, j, np.arange(nv)])
        cols = np.concatenate([i, j, j, i, np.arange(nv)])
        blocks = np.concatenate([Bii, Bjj, Bij, Bji, Dv], axis=0)
        # assemble BSR via COO-of-blocks
        order = np.lexsort((cols, rows))
        rows, cols, blocks = rows[order], cols[order], blocks[order]
        # sum duplicate (row, col) blocks
        key = rows * nv + cols
        uniq, first = np.unique(key, return_index=True)
        summed = np.add.reduceat(blocks, first, axis=0)
        urows, ucols = uniq // nv, uniq % nv
        indptr = np.zeros(nv + 1, dtype=np.int64)
        np.add.at(indptr, urows + 1, 1)
        indptr = np.cumsum(indptr)
        return sp.bsr_matrix(
            (summed, ucols.astype(np.int32), indptr),
            shape=(nv * dpv, nv * dpv),
        )

    def _edge_rm_blocks(self, mesh: AlgebraicMesh):
        """Replacement-matrix blocks of every edge (CalcRMBlockImpl):

        [ Qim^T E Qim   -Qim^T E Qjm ]
        [ -Qjm^T E Qim   Qjm^T E Qjm ]   with E the edge matrix at the
        midpoint frame and Qim/Qjm the half transports.
        """
        nat = native.rigid_edge_blocks(
            mesh.vertex_data["pos"], mesh.edges,
            mesh.edge_data["mat"], self._s,
        )
        if nat is not None:
            return nat
        pos = mesh.vertex_data["pos"]
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        E = mesh.edge_data["mat"]
        mid = 0.5 * (pos[i] + pos[j])
        Qim = self.transport(pos[i], mid)
        Qjm = self.transport(pos[j], mid)
        # batched matmul (BLAS) instead of einsum: ~10x on 6x6 stacks
        EQi = E @ Qim
        EQj = E @ Qjm
        QimT = np.swapaxes(Qim, -1, -2)
        Bii = QimT @ EQi
        Bjj = np.swapaxes(Qjm, -1, -2) @ EQj
        Bij = -(QimT @ EQj)
        Bji = np.transpose(Bij, (0, 2, 1))
        return Bii, Bij, Bji, Bjj

    def aux_diagonal(self, mesh: AlgebraicMesh) -> np.ndarray:
        """(nv, dpv, dpv) diagonal of the replacement matrix."""
        nv, dpv = mesh.nv, self.dpv
        D = native.elast_rm_diag(
            mesh.vertex_data["pos"], mesh.edges,
            mesh.edge_data["mat"], self._s,
        )
        if D is None:
            Bii, _Bij, _Bji, Bjj = self._edge_rm_blocks(mesh)
            D = np.zeros((nv, dpv, dpv))
            np.add.at(D, mesh.edges[:, 0], Bii)
            np.add.at(D, mesh.edges[:, 1], Bjj)
        idx = np.arange(self.dim)
        D[:, idx, idx] += mesh.vertex_data["l2wt"][:, None]
        stab = mesh.vertex_data.get("stab")
        if stab is not None:
            # diagStabBoost retention carried through map_data
            # (spw_agg_impl.hpp:516 inAggEdgeFactor)
            D += stab
        return D

    def _neib_boost(self, mesh: AlgebraicMesh) -> np.ndarray:
        """Common-neighbor path energies per edge (`AddNeibBoost`,
        agglomerator_utils.hpp:600-667), vectorized over all triangles.

        For edge (i,j) and every common neighbor k: transport the two leg
        edge matrices into k's frame, form the series (half harmonic mean)
        energy E_ik (E_ik + E_jk)^+ E_jk, transport it to the (i,j)
        midpoint frame, and accumulate.

        The parallel sum's range is range(E_ik) ∩ range(E_jk), so at the
        FINEST level (rank-1 translational tangent energies with distinct
        tangents) the boost is exactly zero — harmless there, because C
        collapses to ~rank 1 too (collinear midpoints) and the min
        eigenvalue stays finite. It matters on COARSE levels: aux
        diagonals gain rotational rank from varied fine midpoints while
        coarse edge energies remain low-rank sums of near-parallel
        tangents, making the bare min eigenvalue on range(C) identically
        ~0 for every edge (measured: 100% of level-1 thin-plate edges);
        the accumulated shared-neighbor path energies are then full-rank
        enough to make the strict reduction usable.
        """
        nv = mesh.nv
        e = mesh.edges
        ne = len(e)
        E = mesh.edge_data["mat"]
        pos = mesh.vertex_data["pos"]
        if ne == 0:
            return np.zeros_like(E)
        # adjacency with edge ids (both directions), rows sorted
        heads = np.concatenate([e[:, 0], e[:, 1]])
        tails = np.concatenate([e[:, 1], e[:, 0]])
        eids = np.tile(np.arange(ne, dtype=np.int64), 2)
        order = np.lexsort((tails, heads))
        heads, tails, eids = heads[order], tails[order], eids[order]
        indptr = np.zeros(nv + 1, dtype=np.int64)
        np.add.at(indptr, heads + 1, 1)
        indptr = np.cumsum(indptr)
        # expand k over N(i) for every edge, keep pairs where (j,k) is an
        # edge: the triangle list (one entry per common neighbor)
        i, j = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
        deg_i = indptr[i + 1] - indptr[i]
        tot = int(deg_i.sum())
        eid_rep = np.repeat(np.arange(ne, dtype=np.int64), deg_i)
        base = np.repeat(indptr[i], deg_i)
        offs = np.arange(tot, dtype=np.int64) - np.repeat(
            np.cumsum(deg_i) - deg_i, deg_i
        )
        padj = base + offs
        k = tails[padj]
        e_ik = eids[padj]
        jj = j[eid_rep]
        keys = heads * nv + tails  # sorted (lexsort order == key order)
        want = jj * nv + k
        p = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
        hit = (k != jj) & (keys[p] == want)
        eid_t = eid_rep[hit]
        e_ik = e_ik[hit]
        e_jk = eids[p[hit]]
        kk = k[hit]
        if len(eid_t) == 0:
            return np.zeros_like(E)

        def to_frame(leg, frame_pos):
            li, lj = e[leg, 0], e[leg, 1]
            mid = 0.5 * (pos[li] + pos[lj])
            Q = self.transport(frame_pos, mid)
            return np.swapaxes(Q, -1, -2) @ (E[leg] @ Q)

        A = to_frame(e_ik, pos[kk])
        B = to_frame(e_jk, pos[kk])
        T = native.harmonic_mean_sym(A, B, rcond=1e-10)
        if T is None:
            Sinv = np.linalg.pinv(A + B, rcond=1e-10, hermitian=True)
            T = A @ Sinv @ B
            T = 0.5 * (T + np.transpose(T, (0, 2, 1)))
        mid_t = 0.5 * (pos[e[eid_t, 0]] + pos[e[eid_t, 1]])
        Qm = self.transport(mid_t, pos[kk])
        boost = np.swapaxes(Qm, -1, -2) @ (T @ Qm)
        return scatter_add(eid_t, boost, len(E))

    def soc_robust(
        self, mesh: AlgebraicMesh, reduction="max", neib_boost=False,
        edge_subset=None,
    ) -> np.ndarray:
        """Robust strength via batched generalized EVPs.

        Re-creates `CalcRobustPairSOC` + `PrepRobSOC`
        (agglomerator_utils.hpp:764-885): per edge, E = edge matrix (at the
        midpoint frame), C = harmonic mean d_i (d_i + d_j)^+ d_j of the
        transported aux diagonals; strength = the extreme eigenvalue of the
        pencil (E, C) restricted to range(C). All edges solve as one batched
        eigendecomposition (numpy LAPACK), or one fused native pass per
        edge (``elast_soc_robust``: transports, series energy and a Jacobi
        pencil eigensolver) where the batch is below
        ``DEVICE_SOC_MIN_EDGES``.

        Deviation: the default reduction is "max" — the finest-level edge
        matrices are rank-1 tangential projections, for which the
        reference's min-eigenvalue is identically zero unless its
        neighbor-boost accumulation is active; the max eigenvalue measures
        the tangential-stiffness-to-diagonal ratio and reduces to the
        scalar SOC for H1. Pass reduction="min" for the strict behavior
        (meaningful together with ``neib_boost``, which accumulates
        common-neighbor path energies so pair pencils are not degenerate
        — `mis_neib_boost` / `AddNeibBoost` semantics).
        """
        pos = mesh.vertex_data["pos"]
        E = mesh.edge_data["mat"]
        if neib_boost:
            E = E + self._neib_boost(mesh)
        D = self.aux_diagonal(mesh)
        edges = mesh.edges
        ne_full = len(edges)
        if edge_subset is not None:
            # score only the shortlisted edges (the reference's scalar
            # prefilter, spw_agg_impl.hpp:691); the full aux diagonal D
            # still sees every edge. Result: full-length, zeros outside.
            sub = np.asarray(edge_subset)
            if sub.dtype == bool:
                sub = np.flatnonzero(sub)
            edges = edges[sub]
            E = E[sub]
        out_sub = None
        if len(E) < DEVICE_SOC_MIN_EDGES:
            out_sub = native.elast_soc_robust(
                pos, edges, E, D, self._s,
                tol=1e-10, reduction=reduction,
            )
        if out_sub is not None:
            if edge_subset is None:
                return out_sub
            out = np.zeros(ne_full)
            out[sub] = out_sub
            return out
        i, j = edges[:, 0], edges[:, 1]
        mid = 0.5 * (pos[i] + pos[j])
        Qmi = self.transport(mid, pos[i])  # coeff at m -> coeff at i
        Qmj = self.transport(mid, pos[j])
        di = np.swapaxes(Qmi, -1, -2) @ (D[i] @ Qmi)
        dj = np.swapaxes(Qmj, -1, -2) @ (D[j] @ Qmj)
        C = native.harmonic_mean_sym(di, dj, rcond=1e-12)
        if C is None:
            dsum_inv = np.linalg.pinv(
                di + dj, rcond=1e-12, hermitian=True
            )
            C = di @ dsum_inv @ dj
            C = 0.5 * (C + np.transpose(C, (0, 2, 1)))
        res = _pencil_extreme_eig(E, C, reduction=reduction,
                                  device=self.device)
        if edge_subset is None:
            return res
        out = np.zeros(ne_full)
        out[sub] = res
        return out

    # -- coarse data mapping ----------------------------------------------
    def map_data(
        self, mesh, v2agg, n_agg, coarse_edges, e2ce, diag_stab_boost=0.0
    ):
        """Coarse mesh with Q-transported summed edge matrices.

        Coarse edge matrix = sum over mapped fine edges of
        Q(m_f -> m_c)^T E_f Q(m_f -> m_c) — the transported energy
        accumulation of the reference's elasticity map_data.

        ``diag_stab_boost`` (spw_agg.hpp:42, spw_agg_impl.hpp:516): keep
        the fraction 2*boost of in-agglomerate edge energies in the coarse
        aux diagonals (carried as a per-vertex "stab" matrix; 0 = rebuild
        from coarse edges only — the default here; the reference default
        0.5 keeps half, making later rounds more conservative).
        """
        cmesh = AlgebraicMesh(nv=n_agg, edges=coarse_edges)
        act = v2agg >= 0
        # coarse positions first (needed for transports)
        pos = mesh.vertex_data["pos"]
        cpos = scatter_add(v2agg[act], pos[act], n_agg)
        cnt = np.bincount(v2agg[act], minlength=n_agg).astype(np.float64)
        cpos /= np.maximum(cnt, 1.0)[:, None]
        cmesh.vertex_data["pos"] = cpos

        m = e2ce >= 0
        wt = scatter_add(e2ce[m], mesh.edge_data["wt"][m], len(coarse_edges))
        cmesh.edge_data["wt"] = wt

        dpv = self.dpv
        if m.any():
            Ec = native.elast_map_edge_mats(
                pos, cpos, mesh.edges[m], e2ce[m], coarse_edges,
                mesh.edge_data["mat"][m], self._s,
            )
            if Ec is None:
                fi, fj = mesh.edges[m, 0], mesh.edges[m, 1]
                mid_f = 0.5 * (pos[fi] + pos[fj])
                ce = e2ce[m]
                mid_c = 0.5 * (
                    cpos[coarse_edges[ce, 0]] + cpos[coarse_edges[ce, 1]]
                )
                # coeff at m_c -> coeff at m_f
                Q = self.transport(mid_c, mid_f)
                Ef = mesh.edge_data["mat"][m]
                Et = np.swapaxes(Q, -1, -2) @ (Ef @ Q)
                Ec = scatter_add(ce, Et, len(coarse_edges))
        else:
            Ec = np.zeros((len(coarse_edges), dpv, dpv))
        cmesh.edge_data["mat"] = Ec

        l2 = scatter_add(v2agg[act], mesh.vertex_data["l2wt"][act], n_agg)
        cmesh.vertex_data["l2wt"] = l2

        stab_f = mesh.vertex_data.get("stab")
        boost = float(diag_stab_boost)
        if boost != 0.0 or stab_f is not None:
            cstab = np.zeros((n_agg, dpv, dpv))
            if stab_f is not None:
                Qv = self.transport(cpos[v2agg[act]], pos[act])
                St = np.swapaxes(Qv, -1, -2) @ (stab_f[act] @ Qv)
                cstab += scatter_add(v2agg[act], St, n_agg)
            if boost != 0.0 and (~m).any():
                fi, fj = mesh.edges[~m, 0], mesh.edges[~m, 1]
                ci = v2agg[fi]
                same = (ci >= 0) & (ci == v2agg[fj])
                if same.any():
                    mid_f = 0.5 * (pos[fi[same]] + pos[fj[same]])
                    Q = self.transport(cpos[ci[same]], mid_f)
                    Eb = mesh.edge_data["mat"][~m][same]
                    contrib = (2.0 * boost) * (
                        np.swapaxes(Q, -1, -2) @ (Eb @ Q)
                    )
                    cstab += scatter_add(ci[same], contrib, n_agg)
            cmesh.vertex_data["stab"] = cstab
        return cmesh


# batches at least this large go to the batched pencil solver
# (ops/batched_la.pencil_extreme_eig) on the energy's device, in f32. Off
# by default, as in the JAX package, whose hierarchies the port matches;
# tests and chip_smoke.py set it to 1 to take the device branch.
DEVICE_SOC_MIN_EDGES = 10**9


def _pencil_extreme_eig(E, C, reduction="min", tol=1e-10, device=None):
    """Batched extreme eigenvalue of pencil (E, C) restricted to range(C).

    Vectorized version of `CalcRobustPairSOC`: eigendecompose C, scale the
    above-threshold eigvecs by 1/sqrt(lam), form W^T E W, and take the
    min (or max) eigenvalue; null directions of C get a +/-inf sentinel on
    the diagonal so they never win. Batches of ``DEVICE_SOC_MIN_EDGES`` or
    more run in f32 on ``device`` (SOC scores only order candidates) and
    raise there on failure; the rest in the native Jacobi kernel
    (``pencil_extreme_eig``), or in f64 numpy with ``native.HAVE_NATIVE``
    off.
    """
    if len(E) >= DEVICE_SOC_MIN_EDGES:
        import torch

        from ..ops import batched_la

        if device is None:
            raise ValueError(
                "the batched pencil solver needs the energy's device "
                "(ElasticityEnergy(device=...))"
            )
        out = batched_la.pencil_extreme_eig(
            torch.as_tensor(E, dtype=torch.float32, device=device),
            torch.as_tensor(C, dtype=torch.float32, device=device),
            rel_tol=max(tol, 1e-6),
            reduction=reduction,
        )
        return out.cpu().numpy().astype(np.float64)
    out = native.pencil_extreme_eig(E, C, tol=tol, reduction=reduction)
    if out is not None:
        return out
    lam, V = np.linalg.eigh(C)
    lam_max = np.maximum(lam[:, -1:], 1e-300)
    ok = lam > tol * lam_max
    isq = np.where(ok, 1.0 / np.sqrt(np.where(ok, lam, 1.0)), 0.0)
    W = V * isq[:, None, :]
    M = np.swapaxes(W, -1, -2) @ (E @ W)
    big = 1e30 if reduction == "min" else -1e30
    n = E.shape[-1]
    idx = np.arange(n)
    M = M.copy()
    M[:, idx, idx] += np.where(ok, 0.0, big)
    ev = np.linalg.eigvalsh(M)
    if reduction == "min":
        out = ev[:, 0]
    else:
        out = ev[:, -1]
    # edges whose C is entirely null carry no information
    allnull = ~ok.any(axis=1)
    out = np.where(allnull, 0.0, out)
    return np.maximum(out, 0.0)
