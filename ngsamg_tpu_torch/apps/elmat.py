"""Element-matrix (ELMAT) energy accumulation.

Copied from ngsamg_tpu/apps/elmat.py (numpy only). Instead of extracting
the algebraic-mesh energy from the assembled matrix (ALG mode), per-element
stiffness matrices are accumulated into per-vertex and per-edge weight
tables (the reference's `ElmatVAMG`, `AddElementMatrix`, with the SC / ALG
/ LSQ weight extraction variants). Element matrices carry strictly more
information than the assembled matrix (no cross-element cancellation),
which matters for jumping coefficients. The accumulator is batched and
vectorized: callers pass all element DOF tables and element matrices at
once (or in chunks). The front end (precond/amg.py ``elmat_data``) feeds
the finalized mesh to ``setup_levels(..., finest_mesh=...)``.
"""

from __future__ import annotations

import numpy as np

from ..mesh.topo import AlgebraicMesh


class ElmatAccumulator:
    """Accumulate H1 element energies into vertex/edge weights.

    variant "alg": edge weight += |elmat[a, b]| (CalcAuxWeightsALG);
    variant "sc": edge weight from the 2x2 Schur complement of the element
    matrix onto the DOF pair (CalcAuxWeightsSC) — more robust for
    high-order/jumpy elements;
    variant "lsq": least-squares fit of replacement-matrix edge weights
    to the element matrix (CalcAuxWeightsLSQ, amg_pc_vertex.hpp:170-181):
    minimize ||E - sum_ab w_ab R_ab||_F over the pair weights, where
    R_ab is the [[1,-1],[-1,1]] edge block. The Gram matrix of the R_ab
    basis depends only on the element DOF count, so the fit is one
    batched matmul with a precomputed inverse.
    """

    def __init__(self, nv: int, variant: str = "sc"):
        if variant not in ("alg", "sc", "lsq"):
            raise ValueError(variant)
        self.nv = nv
        self.variant = variant
        self._lo: list = []
        self._hi: list = []
        self._w: list = []
        self._vwt = np.zeros(nv)

    def add_batch(self, dnums: np.ndarray, elmats: np.ndarray):
        """dnums: (ne, nl) int; elmats: (ne, nl, nl). Fully vectorized."""
        dnums = np.asarray(dnums)
        elmats = np.asarray(elmats, dtype=np.float64)
        ne, nl = dnums.shape
        # dnums < 0 mark constrained (Dirichlet) element DOFs, as in the
        # reference's freedof handling — they contribute nothing
        dn = dnums.ravel()
        ok_v = dn >= 0
        # vertex weights: signed row sums (zero-order part)
        np.add.at(
            self._vwt, dn[ok_v], elmats.sum(axis=2).ravel()[ok_v]
        )
        a, b = np.triu_indices(nl, k=1)
        if self.variant == "alg":
            w = np.abs(elmats)[:, a, b].ravel()
        elif self.variant == "sc":
            w = _pairwise_schur(elmats)[:, a, b].ravel()
        else:  # lsq
            w = _lsq_pair_weights(elmats, a, b).ravel()
        da, db = dnums[:, a].ravel(), dnums[:, b].ravel()
        ok = (da >= 0) & (db >= 0)
        self._lo.append(np.minimum(da, db)[ok])
        self._hi.append(np.maximum(da, db)[ok])
        self._w.append(w[ok])

    def finalize(self, coords=None) -> AlgebraicMesh:
        lo = np.concatenate(self._lo) if self._lo else np.zeros(0, np.int64)
        hi = np.concatenate(self._hi) if self._hi else np.zeros(0, np.int64)
        w = np.concatenate(self._w) if self._w else np.zeros(0)
        key = lo.astype(np.int64) * self.nv + hi
        uniq, inv = np.unique(key, return_inverse=True)
        wt = np.zeros(len(uniq))
        np.add.at(wt, inv, w)
        edges = np.stack([uniq // self.nv, uniq % self.nv], axis=1)
        keep = wt > 1e-14 * max(wt.max(), 1e-300) if len(wt) else wt > 0
        mesh = AlgebraicMesh(nv=self.nv, edges=edges[keep])
        mesh.edge_data["wt"] = np.abs(wt[keep])
        mesh.vertex_data["l2wt"] = np.maximum(self._vwt, 0.0)
        if coords is not None:
            mesh.vertex_data["pos"] = np.asarray(coords, float)
        return mesh


def _pairwise_schur(elmats: np.ndarray) -> np.ndarray:
    """|off-diagonal| of the 2x2 Schur complements of each DOF pair.

    For element matrix E and pair (a,b): S = E[ab,ab] - E[ab,r] E[r,r]^+
    E[r,ab]; the returned weight is |S[0,1]|. Vectorized over elements via
    a full pseudo-inverse identity: S^{-1} = (E^+)[ab,ab], so
    S = inv((E^+)[ab,ab]) — one batched pinv per element instead of one
    solve per pair (the reference's SC hash-table fill, CalcAuxWeightsSC).
    """
    ne, nl, _ = elmats.shape
    Einv = np.linalg.pinv(elmats, rcond=1e-10, hermitian=True)
    W = np.zeros((ne, nl, nl))
    for a in range(nl):
        for b in range(a + 1, nl):
            s00 = Einv[:, a, a]
            s01 = Einv[:, a, b]
            s11 = Einv[:, b, b]
            det = s00 * s11 - s01 * s01
            good = np.abs(det) > 1e-300
            w = np.where(good, np.abs(-s01 / np.where(good, det, 1.0)), 0.0)
            W[:, a, b] = w
            W[:, b, a] = w
    return W


def _lsq_pair_weights(elmats: np.ndarray, a, b) -> np.ndarray:
    """LSQ fit w = argmin ||E - sum w_p R_p||_F per element (batched).

    <E, R_ab> = E_aa + E_bb - 2 E_ab; the Gram <R_p, R_q> is 4 on the
    diagonal, 1 for pairs sharing exactly one DOF, 0 otherwise — fixed
    per element arity, inverted once (CalcAuxWeightsLSQ analog).
    """
    npairs = len(a)
    G = np.zeros((npairs, npairs))
    for p in range(npairs):
        for q in range(npairs):
            shared = len({a[p], b[p]} & {a[q], b[q]})
            G[p, q] = 4.0 if p == q else (1.0 if shared == 1 else 0.0)
    Ginv = np.linalg.inv(G)
    rhs = (
        elmats[:, a, a] + elmats[:, b, b] - 2.0 * elmats[:, a, b]
    )  # (ne, npairs)
    return rhs @ Ginv.T
