"""Local cluster correction: exact solves on near-singular strong clusters.

Port of ngsamg_tpu/smoothers/cluster_corr.py. Low-quality unstructured
meshes (sliver tets) produce small vertex clusters whose local stiffness
block is nearly rank-deficient with an oscillatory near-kernel, which a
one-vector-per-aggregate coarse space cannot represent and point smoothers
barely damp. The correction adds a batched dense local solve on only the
defective clusters, applied multiplicatively and symmetrically around the
multigrid cycle (solve/cycle.py ``amg_apply``):

    z  = C b                      (batched (K,K) solves)
    z += V(b - A z)               (the usual AMG cycle)
    z += C (b - A z)

Detection (host, setup phase): connected components of the
magnitude-strength graph |a_ij| >= beta * sqrt(a_ii a_jj), keep components
of size 2..max_size whose local block has lambda_min < eig_ratio *
max(diag). As in the original, one fused native pass
(``native.cluster_detect``) finds and extracts the candidate clusters; the
numpy code beside it runs with ``native.HAVE_NATIVE`` off. Application
(device): one gather, one batched product, one ``index_add_``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .. import native

@dataclass(frozen=True)
class ClusterCorrection:
    """Device data: padded cluster row indices + dense local inverses.

    ``idx`` (ncl, K) int64, padded slots point at row 0 with the matching
    ``inv`` rows/cols zeroed so padded contributions vanish.
    """

    idx: torch.Tensor  # (ncl, K) int64
    inv: torch.Tensor  # (ncl, K, K) level dtype

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return cluster_apply(self, r)


def _finish(blocks, members, csz, eig_ratio):
    """Shared tail: pad diag, min-eig filter, batched inverse, idx table.

    ``blocks`` (ncl,K,K) f64 with zeros outside each cluster's real
    (csz x csz) corner, ``members`` (ncl,K) padded with 0. Returns the host
    arrays (idx (n,K) int64, inv (n,K,K) f64) or None.
    """
    ncl, K, _ = blocks.shape
    if ncl == 0:
        return None
    ii = np.arange(K)
    diag = blocks[:, ii, ii]
    maxdiag = np.maximum(diag.max(axis=1), 1e-300)
    padmask = ii[None, :] >= csz[:, None]
    blocks[:, ii, ii] = np.where(padmask, maxdiag[:, None], diag)
    wmin = np.linalg.eigvalsh(blocks)[:, 0]
    keep = wmin < eig_ratio * maxdiag
    if not keep.any():
        return None
    blocks = blocks[keep]
    padmask = padmask[keep]
    inv = np.linalg.inv(blocks)
    inv[np.broadcast_to(padmask[:, :, None], inv.shape)] = 0.0
    inv[np.broadcast_to(padmask[:, None, :], inv.shape)] = 0.0
    idx = members[keep].astype(np.int64)
    idx[padmask] = 0  # contribution is zero (inv rows/cols zeroed)
    return idx, inv


def detect_clusters(
    A: sp.spmatrix,
    *,
    beta: float = 0.35,
    eig_ratio: float = 0.3,
    max_size: int = 16,
    dtype=np.float32,
    device="cpu",
) -> ClusterCorrection | None:
    """Find near-singular strong clusters of a scalar SPD matrix (host).

    Returns None when no defective cluster exists (e.g. on any
    shape-regular mesh) — the correction then costs nothing.
    """
    A = A.tocsr()
    n = A.shape[0]
    if n == 0:
        return None
    nat = native.cluster_detect(A, beta, eig_ratio, max_size)
    if nat is not None:
        blocks, members, csz = nat
        res = _finish(blocks, members, csz.astype(np.int64), eig_ratio)
    else:
        res = _detect_numpy(A, beta, eig_ratio, max_size)
    if res is None:
        return None
    idx, inv = res
    return ClusterCorrection(
        idx=torch.from_numpy(idx).to(device),
        inv=torch.from_numpy(inv.astype(dtype)).to(device),
    )


def _detect_numpy(A: sp.csr_matrix, beta, eig_ratio, max_size):
    """The numpy branch of :func:`detect_clusters`: the host arrays of
    :func:`_finish`, or None."""
    n = A.shape[0]
    d = A.diagonal()
    coo = A.tocoo()
    off = coo.row != coo.col
    r, c, v = coo.row[off], coo.col[off], coo.data[off]
    dpos = np.maximum(d, 1e-300)
    strong = np.abs(v) >= beta * np.sqrt(dpos[r] * dpos[c])
    if not strong.any():
        return None
    import scipy.sparse.csgraph as csg

    G = sp.coo_matrix(
        (np.ones(int(strong.sum())), (r[strong], c[strong])), shape=(n, n)
    ).tocsr()
    ncomp, lab = csg.connected_components(G, directed=False)
    sizes = np.bincount(lab, minlength=ncomp)
    elig = (sizes >= 2) & (sizes <= max_size)
    if not elig.any():
        return None
    # cluster id (contiguous) + slot within cluster, -1 for non-members
    cid = np.full(ncomp, -1, dtype=np.int64)
    cid[elig] = np.arange(int(elig.sum()))
    ncl = int(elig.sum())
    vcid = cid[lab]  # per-vertex cluster id or -1
    member = vcid >= 0
    order = np.lexsort((np.arange(n), np.where(member, vcid, ncl)))
    memb_sorted = order[: int(member.sum())]
    # slot: position within its cluster (lexsort keeps vertex order)
    cl_of = vcid[memb_sorted]
    starts = np.searchsorted(cl_of, np.arange(ncl + 1))
    slot = np.arange(len(memb_sorted)) - starts[cl_of]
    vslot = np.full(n, -1, dtype=np.int64)
    vslot[memb_sorted] = slot
    K = int(sizes[elig].max())

    # dense local blocks: all A entries with both ends in the same cluster
    blocks = np.zeros((ncl, K, K))
    both = member[coo.row] & member[coo.col] & (vcid[coo.row] == vcid[coo.col])
    br, bc, bv = coo.row[both], coo.col[both], coo.data[both]
    blocks[vcid[br], vslot[br], vslot[bc]] = bv
    members = np.zeros((ncl, K), dtype=np.int64)
    members[cl_of, slot] = memb_sorted
    return _finish(blocks, members, sizes[elig], eig_ratio)


def cluster_apply(cc: ClusterCorrection, r: torch.Tensor) -> torch.Tensor:
    """z = C r: batched dense solves scattered back (scalar vectors).

    ``r`` is the padded (nrows_pad, 1) residual; returns same shape. The
    clusters are disjoint and padded slots add exact zeros onto row 0, so
    the scatter's result does not depend on the order of its additions.
    """
    g = r[cc.idx, 0]  # (ncl, K)
    y = torch.bmm(cc.inv, g[:, :, None])  # (ncl, K, 1)
    out = torch.zeros_like(r)
    out.index_add_(0, cc.idx.reshape(-1), y.reshape(-1, 1))
    return out
