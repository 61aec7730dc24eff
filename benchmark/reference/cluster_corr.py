"""The local cluster correction by its definition, in plain float64.

For a scalar SPD matrix ``A`` with diagonal ``a_ii``:

- ``detect(A, beta, eig_ratio, max_size)``: the strength graph joins
  ``i != j`` where ``|a_ij| >= beta sqrt(a_ii a_jj)``; of its connected
  components, those of 2 to ``max_size`` rows whose principal block
  ``A[c, c]`` has its least eigenvalue below ``eig_ratio`` times the largest
  diagonal entry of that block are the clusters;
- ``apply(clusters, A, r)``: ``z[c] = A[c, c]^{-1} r[c]`` on every cluster
  ``c`` and ``z = 0`` on every other row;
- ``wrapped(cycle, clusters, A, b)``: a cycle wrapped by the correction,
  ``z = C b``, ``z += cycle(b - A z)``, ``z += C (b - A z)``.

``operator(M, device)`` is the plain product of any matrix, square or not,
for holding a staged level or transfer to its host matrix: the benchmark's
``residual.Operator`` on ``M`` set in the corner of a square zero matrix.

Plain torch in float64 for the products and solves, numpy and scipy on the
host for the detection (as the program detects on the host too); imports
nothing of the program. Departures:

- float64 only: a float32 correction is held to it within its rounding;
- the detection runs on the host, on a ``scipy.sparse`` matrix;
- scalar rows only (one unknown a row): the program stages no correction
  on block levels either.

``Correction`` and ``operator`` turn TF32 products off for the process
(``torch.backends``), so that a float32 product that a caller compares with
these is not rounded to TF32.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch

from benchmark.reference import residual


def _no_tf32() -> None:
    """float32 products in full precision for the rest of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _principal_blocks(A: sp.csr_matrix, clusters) -> list[np.ndarray]:
    """``A[c, c]`` as a dense array for every cluster ``c`` (disjoint sets
    of rows): the entries of ``A`` whose row and column lie in one
    cluster, placed by their positions in it."""
    n = A.shape[0]
    cid = np.full(n, -1, dtype=np.int64)
    slot = np.zeros(n, dtype=np.int64)
    for k, c in enumerate(clusters):
        cid[c] = k
        slot[c] = np.arange(len(c))
    C = A.tocoo()
    inside = (cid[C.row] >= 0) & (cid[C.row] == cid[C.col])
    r, c, v = C.row[inside], C.col[inside], C.data[inside]
    blocks = [np.zeros((len(rows), len(rows))) for rows in clusters]
    for k, i, j, a in zip(cid[r], slot[r], slot[c], v):
        blocks[k][i, j] += a
    return blocks


def detect(A: sp.spmatrix, beta: float = 0.35, eig_ratio: float = 0.3,
           max_size: int = 16) -> list[np.ndarray]:
    """The clusters of ``A``, each the sorted array of its rows, in the
    order of their smallest row."""
    A = sp.csr_matrix(A, dtype=np.float64)
    n = A.shape[0]
    d = A.diagonal()
    C = A.tocoo()
    off = C.row != C.col
    r, c, v = C.row[off], C.col[off], C.data[off]
    strong = np.abs(v) >= beta * np.sqrt(d[r] * d[c])
    G = sp.csr_matrix((np.ones(int(strong.sum())), (r[strong], c[strong])),
                      shape=(n, n))
    _, label = csg.connected_components(G, directed=False)
    sizes = np.bincount(label)
    rows = np.flatnonzero((sizes[label] >= 2) & (sizes[label] <= max_size))
    rows = rows[np.argsort(label[rows], kind="stable")]
    cuts = np.flatnonzero(np.diff(label[rows])) + 1
    comps = np.split(rows, cuts) if len(rows) else []
    out = [c for c, block in zip(comps, _principal_blocks(A, comps))
           if np.linalg.eigvalsh(block)[0]
           < eig_ratio * block.diagonal().max()]
    out.sort(key=lambda rows: rows[0])
    return out


class Correction:
    """``z = C r`` of ``clusters`` on ``A`` in float64 on ``device``: the
    clusters grouped by size, each group's blocks solved in one batched
    ``torch.linalg.solve``."""

    def __init__(self, clusters, A: sp.spmatrix, device):
        _no_tf32()
        A = sp.csr_matrix(A, dtype=np.float64)
        self.device = torch.device(device)
        blocks = _principal_blocks(A, clusters)
        self.groups = []
        for k in sorted({len(c) for c in clusters}):
            sel = [i for i, c in enumerate(clusters) if len(c) == k]
            self.groups.append((
                torch.as_tensor(np.stack([clusters[i] for i in sel]),
                                dtype=torch.int64, device=self.device),
                torch.as_tensor(np.stack([blocks[i] for i in sel]),
                                device=self.device)))

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        r = r.to(device=self.device, dtype=torch.float64).reshape(-1)
        z = torch.zeros_like(r)
        for idx, blocks in self.groups:
            z[idx] = torch.linalg.solve(blocks, r[idx][:, :, None])[:, :, 0]
        return z


def apply(clusters, A: sp.spmatrix, r: torch.Tensor) -> torch.Tensor:
    """``z = C r`` (float64, on ``r``'s device)."""
    return Correction(clusters, A, r.device)(r)


def wrapped(cycle, clusters, A: sp.spmatrix, b: torch.Tensor) -> torch.Tensor:
    """``cycle`` wrapped by the correction: ``z = C b``, ``z += cycle(b -
    A z)``, ``z += C (b - A z)``; ``cycle`` maps a float64 vector to one."""
    b = b.to(torch.float64).reshape(-1)
    C = Correction(clusters, A, b.device)
    op = residual.Operator(A, b.device)
    z = C(b)
    z = z + cycle(b - op(z))
    return z + C(b - op(z))


def operator(M: sp.spmatrix, device):
    """``x -> M x`` in float64 on ``device`` for any ``M`` (m x k): the
    benchmark's ``residual.Operator`` on ``M`` in the corner of a square
    zero matrix, ``x`` padded with zeros and ``y`` cut to ``m``."""
    _no_tf32()
    m, k = M.shape
    s = max(m, k)
    M = sp.csr_matrix(M, dtype=np.float64)
    # s - m empty rows below M; its columns lie in [0, k), k <= s
    indptr = np.concatenate([M.indptr, np.full(s - m, M.indptr[-1])])
    op = residual.Operator(
        sp.csr_matrix((M.data, M.indices, indptr), shape=(s, s)), device)

    def matvec(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=op.device, dtype=torch.float64).reshape(-1)
        xs = torch.zeros(s, dtype=torch.float64, device=op.device)
        xs[:k] = x[:k]
        return op(xs)[:m]

    return matvec
