"""Block Gauss-Seidel over user-supplied or structural DOF blocks.

Port of ngsamg_tpu/smoothers/block.py (the reference's `BSmoother` family,
block_gssmoother.hpp:17-141, and `DynBlockSmoother`): overlapping DOF
blocks with pre-inverted block diagonals, swept in graph-colored groups so
all blocks of a color update together. The host construction is a numpy
copy of the original; the sweep is plain torch, as it is XLA there.

Blocks are padded to a common width; padded slots point at the padded
all-zero matrix row and carry zero inverse columns, so they are exact
no-ops. Blocks coupled through the matrix get different colors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..sparse.bell import BlockELL, spmv_rows
from .coloring import jones_plassmann_coloring


@dataclass(frozen=True)
class BlockGSSmoother:
    """Colored block Gauss-Seidel over padded DOF blocks."""

    blocks: torch.Tensor  # (nb, B) int64 row indices, padded with pad_row
    Binv: torch.Tensor  # (nb, B, B) block pseudo-inverses (zero on padding)
    color_bounds: tuple  # block ranges per color (sorted by color)
    steps: int = 1

    def sweep(self, A, x, b, *, reverse: bool):
        return block_gs_smooth(self, A, x, b, reverse=reverse)


def block_gs_smooth(sm: BlockGSSmoother, A: BlockELL, x, b, *, reverse):
    # one copy per call, updated in place; the caller's x is never written
    x = torch.zeros_like(b) if x is None else x.clone()
    bounds = sm.color_bounds
    ncol = len(bounds) - 1
    order = range(ncol - 1, -1, -1) if reverse else range(ncol)
    for _ in range(sm.steps):
        for c in order:
            lo, hi = bounds[c], bounds[c + 1]
            if hi == lo:
                continue
            blk = sm.blocks[lo:hi]  # (m, B)
            rows = blk.reshape(-1)
            r = b[rows] - spmv_rows(A, x, rows)  # (m*B, 1)
            r = r.reshape(blk.shape[0], blk.shape[1])
            upd = torch.einsum("mij,mj->mi", sm.Binv[lo:hi], r)
            # padded slots repeat pad_row with a zero update: accumulate
            x.index_add_(0, rows, upd.reshape(-1, 1))
    return x


def build_block_gs(
    A: sp.spmatrix,
    blocks: list[np.ndarray],
    nrows_pad: int,
    dtype,
    steps: int = 1,
) -> BlockGSSmoother:
    """Assemble the block smoother from scipy A + DOF blocks, as CPU
    tensors (``smoothers.build.stage_smoother`` moves it to a device)."""
    A = A.tocsr()
    n = A.shape[0]
    nb = len(blocks)
    B = max((len(b) for b in blocks), default=1)
    pad_row = nrows_pad - 1  # all-zero padded matrix row
    blk = np.full((nb, B), pad_row, dtype=np.int32)
    for i, b in enumerate(blocks):
        blk[i, : len(b)] = np.asarray(b, dtype=np.int32)

    # batched block submatrices A[blk, blk] (padding -> identity-free zero)
    Asub = np.zeros((nb, B, B))
    for i in range(B):
        rows_i = blk[:, i]
        valid_i = rows_i != pad_row
        for j in range(B):
            cols_j = blk[:, j]
            valid = valid_i & (cols_j != pad_row)
            if not valid.any():
                continue
            vals = np.asarray(
                A[rows_i[valid], cols_j[valid]]
            ).ravel()
            Asub[valid, i, j] = vals
    Binv = np.linalg.pinv(Asub, rcond=1e-12)
    # zero the padded columns/rows so padded slots are no-ops
    for i, b in enumerate(blocks):
        k = len(b)
        Binv[i, k:, :] = 0.0
        Binv[i, :, k:] = 0.0

    # block conflict graph: blocks whose DOF sets are coupled through A
    ind = sp.coo_matrix(
        (
            np.ones(sum(len(b) for b in blocks)),
            (
                np.concatenate(
                    [np.full(len(b), i) for i, b in enumerate(blocks)]
                )
                if nb
                else np.zeros(0),
                np.concatenate([np.asarray(b) for b in blocks])
                if nb
                else np.zeros(0),
            ),
        ),
        shape=(nb, n),
    ).tocsr()
    G = (ind @ A @ ind.T).tolil()
    G.setdiag(0)
    G = G.tocsr()
    G.eliminate_zeros()
    colors = jones_plassmann_coloring(G) if G.nnz else np.zeros(nb, np.int32)
    order = np.argsort(colors, kind="stable")
    counts = np.bincount(colors) if nb else np.zeros(0, int)
    bounds = tuple(int(x) for x in np.concatenate([[0], np.cumsum(counts)]))
    return BlockGSSmoother(
        blocks=torch.from_numpy(blk[order].astype(np.int64)),
        Binv=torch.from_numpy(
            np.ascontiguousarray(Binv[order], dtype=np.dtype(dtype))
        ),
        color_bounds=bounds,
        steps=steps,
    )


def dyn_blocks(A: sp.spmatrix, max_block: int = 8) -> list[np.ndarray]:
    """Variable-size blocks by structural row fusion (`DynVectorBlocking`,
    dyn_block.hpp:14-109): runs of consecutive rows with IDENTICAL column
    structure fuse into one block (high-order FEM spaces produce many such
    runs), capped at ``max_block`` rows. Hash-filtered, exactly
    verified."""
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    if n == 0:
        return []
    deg = np.diff(A.indptr)
    # order-aware row hash of the column pattern
    slot = np.arange(A.nnz, dtype=np.uint64) - np.repeat(
        A.indptr[:-1].astype(np.uint64), deg
    )
    mix = (A.indices.astype(np.uint64) + np.uint64(1)) * (
        np.uint64(2654435761) + slot * np.uint64(40503)
    )
    h = np.zeros(n, dtype=np.uint64)
    ne = np.flatnonzero(deg > 0)
    if len(ne):
        h[ne] = np.add.reduceat(mix, A.indptr[:-1][ne])
    cand = (deg[:-1] == deg[1:]) & (h[:-1] == h[1:]) if n > 1 else None
    blocks = []
    i = 0
    while i < n:
        j = i
        while (
            j + 1 < n
            and j - i + 1 < max_block
            and cand[j]
            and np.array_equal(
                A.indices[A.indptr[j] : A.indptr[j + 1]],
                A.indices[A.indptr[j + 1] : A.indptr[j + 2]],
            )
        ):
            j += 1
        blocks.append(np.arange(i, j + 1))
        i = j + 1
    return blocks


def build_dyn_block_gs(
    A: sp.spmatrix, nrows_pad: int, dtype, steps: int = 1,
    max_block: int = 8,
) -> BlockGSSmoother:
    """Dyn-block GS: automatic structural blocking + colored block sweeps
    (`DynBlockSmoother`, dyn_block_smoother.hpp:16)."""
    return build_block_gs(
        A, dyn_blocks(A, max_block), nrows_pad, dtype, steps=steps
    )


def aggregate_blocks(v2agg: np.ndarray, n_agg: int) -> list[np.ndarray]:
    """Blocks from aggregation (a natural default block partition)."""
    order = np.argsort(v2agg, kind="stable")
    sorted_a = v2agg[order]
    starts = np.searchsorted(sorted_a, np.arange(n_agg))
    ends = np.searchsorted(sorted_a, np.arange(n_agg) + 1)
    return [order[s:e] for s, e in zip(starts, ends) if e > s]
