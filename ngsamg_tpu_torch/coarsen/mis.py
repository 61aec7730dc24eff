"""MIS-seeded aggregation coarsening (alternative to pairwise matching).

Copied from ngsamg_tpu/coarsen/mis.py (numpy/scipy only), on the port's own
``sparse/host.py``: pick a maximal independent set of seed vertices
(distance-1 or distance-2), make each seed an aggregate, then assign every
remaining vertex to its strongest neighboring aggregate.

The MIS is computed with vectorized Luby rounds (random priorities, local
maxima join the set, neighbors get knocked out), the growth phase with
row-wise argmax over aggregate-assigned neighbors: all O(nnz) numpy. The
priorities come from ``np.random.default_rng(seed)``, so the aggregates
equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..sparse.host import csr_rowwise_argmax, csr_rowwise_max


def luby_mis(S: sp.csr_matrix, seed: int = 0, dist2: bool = False):
    """Maximal independent set via vectorized Luby rounds."""
    if dist2:
        G = (S @ S + S).tolil()
        G.setdiag(0.0)  # S@S introduces self-loops; a vertex is not its own
        G = G.tocsr()   # neighbor (would block every local-max win)
        G.eliminate_zeros()
    else:
        G = S.tocsr()
        if (G.diagonal() != 0).any():
            G = G.copy()
            G.setdiag(0.0)
            G.eliminate_zeros()
    n = G.shape[0]
    rng = np.random.default_rng(seed)
    prio = rng.random(n)
    indptr, indices = G.indptr, G.indices
    in_set = np.zeros(n, dtype=bool)
    undecided = np.ones(n, dtype=bool)
    while undecided.any():
        nbr_p = np.where(undecided[indices], prio[indices], -1.0)
        nbr_max = np.full(n, -1.0)
        ne = np.flatnonzero(np.diff(indptr) > 0)
        if len(ne):
            nbr_max[ne] = np.maximum.reduceat(nbr_p, indptr[ne])
        winners = undecided & (prio > nbr_max)
        if not winners.any():
            # isolated undecided vertices (no undecided neighbors)
            winners = undecided & (nbr_max < 0)
        in_set |= winners
        undecided &= ~winners
        # knock out neighbors of new members
        knocked = np.zeros(n, dtype=bool)
        rows = np.repeat(np.arange(n), np.diff(indptr))
        hit = winners[rows]
        knocked[indices[hit]] = True
        undecided &= ~knocked
    return in_set


def mis_aggregate(
    S: sp.csr_matrix,
    *,
    theta: float = 0.08,
    dist2: bool = True,
    active: np.ndarray | None = None,
    grow_rounds: int = 3,
) -> tuple[np.ndarray, int]:
    """MIS seeds + strength-guided growth. Returns (v2agg, n_agg)."""
    n = S.shape[0]
    if active is None:
        active = np.ones(n, dtype=bool)
    # filter weak edges before seeding (strength threshold, mis ecw options)
    rowmax = csr_rowwise_max(S.indptr, S.data)
    rows = np.repeat(np.arange(n), np.diff(S.indptr))
    strong = S.data >= theta * np.minimum(rowmax[rows], rowmax[S.indices])
    Sf = sp.csr_matrix(
        (np.where(strong, S.data, 0.0), S.indices, S.indptr), shape=S.shape
    )
    Sf.eliminate_zeros()

    act_idx = np.flatnonzero(active)
    Sa = Sf[act_idx][:, act_idx].tocsr()
    na = len(act_idx)
    seeds = luby_mis(Sa, dist2=dist2)
    a2agg = np.full(na, -1, dtype=np.int64)
    sidx = np.flatnonzero(seeds)
    a2agg[sidx] = np.arange(len(sidx))

    # grow: unassigned vertices join the strongest assigned neighbor's agg
    for _ in range(grow_rounds):
        unassigned = a2agg < 0
        if not unassigned.any():
            break
        rowsa = np.repeat(np.arange(na), np.diff(Sa.indptr))
        valid = (a2agg[Sa.indices] >= 0) & unassigned[rowsa]
        best, bv = csr_rowwise_argmax(Sa.indptr, Sa.indices, Sa.data, valid)
        join = unassigned & (best >= 0)
        a2agg[join] = a2agg[best[join]]
    # leftovers become singletons
    left = np.flatnonzero(a2agg < 0)
    a2agg[left] = len(sidx) + np.arange(len(left))
    n_agg = len(sidx) + len(left)

    v2agg = np.full(n, -1, dtype=np.int64)
    v2agg[act_idx] = a2agg
    return v2agg, n_agg
