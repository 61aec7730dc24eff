"""Device-resident block-ELL sparse format + SpMV.

Port of ngsamg_tpu/sparse/bell.py: a padded ELL layout of small dense
blocks, the format of block (bs > 1) levels and of their rectangular
transfers:

* ``data``: (n_pad, K, br, C*bc) — K slots per block row, zero-padded
* ``cols``: (n_pad, K) int32 — block-column (or column-chunk) index per
  slot, 0 for padding

* ``nslots``: (n_pad,) int32 — the real slots a row (its blocks come
  first, the padding after them), 0 for the padded rows; or None

The JAX package computes the matvec in XLA (no Pallas kernel): one gather
of x rows by ``cols`` and one contraction "nkij,nkj->ni" in the tensor's
dtype. The port launches one hand-written kernel for a CUDA tensor
(ops/bell_cuda.py, csrc/bell_matvec.cu), which reads only the real slots
of a row; a CPU tensor takes the plain version, the same gather and
contraction in plain torch. Block vectors are (n, bc) tensors
(``formats.block_vec`` / ``formats.flat_vec``). Row counts are padded to a
multiple of ``row_align``; padded rows are entirely zero and stay zero
through every operation. The host packing is numpy, bit for bit the JAX
package's. ``spmv_rows`` (the block rows the dyn-block GS sweep updates)
and the multicolor GS sweep use the plain contraction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import bell_cuda
from . import host as _host


@dataclass(frozen=True)
class BlockELL:
    """Padded block-ELL sparse matrix (block rows x block cols).

    ``col_chunk = C > 1`` stores each slot as C ADJACENT block columns
    side by side (``data``: (n, K, br, C*bc), ``cols``: chunk index =
    block_col // C): the matvec gathers one (C*bc)-wide row of x per slot
    instead of C separate bc-wide gathers; the price is zero-fill where
    only one column of a chunk is present.

    ``nslots`` (optional): the real slots of each row, which come first in
    it; the kernel reads no slot past them. Without it every slot is read
    (the padding is zero, so the product is the same).
    """

    data: torch.Tensor  # (n_pad, K, br, col_chunk*bc)
    cols: torch.Tensor  # (n_pad, K) int32 (block col, or chunk id if C>1)
    nrows: int  # logical number of block rows
    ncols: int  # logical number of block cols
    nrows_pad: int  # padded number of block rows (= data.shape[0])
    col_chunk: int = 1
    nslots: torch.Tensor | None = None  # (n_pad,) int32, 0 for padded rows
    # the kernel's launch plan, made once here (ops/bell_cuda.py ``stage``)
    launch: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "launch", bell_cuda.stage(self))

    def __reduce__(self):
        # pickled by its constructor's fields; the plan is made anew
        return type(self), tuple(
            getattr(self, f.name) for f in dataclasses.fields(self) if f.init
        )

    @property
    def ell_width(self) -> int:
        return self.data.shape[1]

    @property
    def block_shape(self) -> tuple[int, int]:
        return self.data.shape[2], self.data.shape[3]

    @property
    def shape(self) -> tuple[int, int]:
        br, bc = self.block_shape
        return self.nrows * br, self.ncols * bc

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return spmv(self, x)


def to_scipy(A: BlockELL) -> sp.csr_matrix:
    """Padded block-ELL -> scipy BSR->CSR (introspection/debugging)."""
    data = A.data.cpu().numpy().astype(np.float64)[: A.nrows]
    cols = A.cols.cpu().numpy()[: A.nrows]
    if A.col_chunk > 1:
        C = A.col_chunk
        n, K, br, cbc = data.shape
        bc = cbc // C
        # expand each chunk slot into C plain block slots
        data = data.reshape(n, K, br, C, bc).transpose(0, 1, 3, 2, 4)
        data = data.reshape(n, K * C, br, bc)
        cols = (
            cols[:, :, None] * C + np.arange(C)[None, None, :]
        ).reshape(n, K * C)
        # a chunk overhanging ncols holds only zero blocks: clamp the
        # index into range (eliminate_zeros drops them below)
        cols = np.minimum(cols, max(A.ncols - 1, 0))
    n, K, br, bc = data.shape
    B = sp.bsr_matrix(
        (
            data.reshape(n * K, br, bc),
            cols.reshape(-1),
            np.arange(n + 1) * K,
        ),
        shape=(n * br, A.ncols * bc),
    )
    C = B.tocsr()
    C.eliminate_zeros()  # padding slots are all-zero blocks at col 0
    return C


def _chunked_pack(A, bs_r: int, bs_c: int, C: int, dtype):
    """(data (n, K, br, C*bc), cols (n, K) chunk ids, the slots a row) — C
    adjacent block columns per slot (see BlockELL.col_chunk)."""
    if bs_r == bs_c == 1:
        B = A.tocsr()
        # the plain-assignment scatter below drops (not sums) duplicate
        # stored entries and assumes ascending column order — canonicalize
        if not B.has_canonical_format:
            B.sum_duplicates()
        bdata = B.data.reshape(-1, 1, 1)
        indptr, indices = B.indptr, B.indices
        n = B.shape[0]
    else:
        if bs_r == bs_c:
            B = _host.to_bsr(A, bs_r)  # cached square-block view
        else:
            B = sp.bsr_matrix(A, blocksize=(bs_r, bs_c))
        if not B.has_sorted_indices:
            B.sort_indices()
        bdata = B.data
        indptr, indices = B.indptr, B.indices
        n = B.shape[0] // bs_r
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols_b = indices.astype(np.int64)
    cc = cols_b // C
    # BSR column indices are ascending per row, so (row, cc) runs are
    # contiguous: slot = rank of the (row, chunk) pair within its row
    newp = np.ones(len(rows), dtype=bool)
    newp[1:] = (rows[1:] != rows[:-1]) | (cc[1:] != cc[:-1])
    gid = np.cumsum(newp) - 1
    pair_row = rows[newp]
    row_first = np.searchsorted(pair_row, np.arange(n, dtype=np.int64))
    slot_pair = np.arange(len(pair_row), dtype=np.int64) - row_first[
        pair_row
    ]
    slot = slot_pair[gid]
    K = int(slot.max(initial=-1)) + 1 if len(slot) else 1
    K = max(K, 1)
    data = np.zeros((n, K, bs_r, C, bs_c), dtype=np.dtype(dtype))
    cols = np.zeros((n, K), dtype=np.int32)
    data[rows, slot, :, cols_b % C, :] = bdata
    cols[rows, slot] = cc.astype(np.int32)
    return (data.reshape(n, K, bs_r, C * bs_c), cols,
            np.bincount(pair_row, minlength=n))


def pack(
    A,
    bs_r: int = 1,
    bs_c: int = 1,
    dtype=np.float32,
    row_align: int = 8,
    width: int | None = None,
    col_chunk: int = 1,
) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """The host arrays of a BlockELL: ``(data, cols, nrows, nslots)`` with
    the rows padded to a multiple of ``row_align`` (see
    :func:`from_scipy`); ``nslots`` (int32) counts a row's real slots (its
    stored blocks, explicit zero blocks included), 0 for a padded row."""
    if col_chunk > 1:
        data, cols, deg = _chunked_pack(A, bs_r, bs_c, col_chunk, dtype)
    else:
        data, cols, deg = _host.pad_to_ell(
            A, bs_r, bs_c, width=width, dtype=dtype
        )
    n = data.shape[0]
    n_pad = -(-n // row_align) * row_align
    nslots = np.zeros(n_pad, dtype=np.int32)
    nslots[:n] = deg
    if n_pad != n:
        pad = n_pad - n
        data = np.concatenate(
            [data, np.zeros((pad,) + data.shape[1:], data.dtype)]
        )
        cols = np.concatenate(
            [cols, np.zeros((pad, cols.shape[1]), cols.dtype)]
        )
    data = np.ascontiguousarray(data, dtype=np.dtype(dtype))
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    return data, cols, n, nslots


def from_packed(
    data: np.ndarray, cols: np.ndarray, nrows: int, ncols: int,
    col_chunk: int = 1, device="cpu", nslots: np.ndarray | None = None,
) -> BlockELL:
    """A BlockELL on ``device`` from the host arrays of :func:`pack`."""
    return BlockELL(
        data=torch.from_numpy(data).to(device),
        cols=torch.from_numpy(cols).to(device),
        nrows=nrows,
        ncols=ncols,
        nrows_pad=data.shape[0],
        col_chunk=col_chunk,
        nslots=None if nslots is None else torch.from_numpy(nslots).to(
            device),
    )


def from_scipy(
    A,
    bs_r: int = 1,
    bs_c: int = 1,
    dtype=np.float32,
    row_align: int = 8,
    width: int | None = None,
    col_chunk: int = 1,
    device="cpu",
) -> BlockELL:
    """Build a BlockELL on ``device`` from a host scipy matrix.

    ``dtype`` is a numpy dtype (the packing is host code). ``width``
    forces the ELL width K; ``col_chunk`` packs that many adjacent block
    columns per slot (SQUARE operators only: the matvec reshapes x by the
    chunk, so the vector pad must divide it — row_align does).
    """
    data, cols, n, nslots = pack(
        A, bs_r, bs_c, dtype, row_align, width, col_chunk
    )
    return from_packed(
        data, cols, n, A.shape[1] // bs_c, col_chunk, device=device,
        nslots=nslots,
    )


def rows_product(data: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """The contraction "mkij,mkj->mi" of block rows ``data`` (m, K, br, bc)
    with gathered x rows ``xg`` (m, K, bc), as a broadcast product and one
    sum, so that ``data`` is read where it lies (an einsum would first copy
    it into (m, i, k*j) order)."""
    return (data * xg.unsqueeze(2)).sum(dim=(1, 3))


def spmv(A: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a block vector x of shape (ncols_pad?, bc).

    ``x`` may be longer than ``A.ncols`` (padded); gathered columns are
    always < ncols so padding never contaminates the product. A CUDA
    tensor launches the kernel (ops/bell_cuda.py) or raises; a CPU tensor
    takes the plain version below, which reads every slot.
    """
    if x.device.type != "cpu":
        return bell_cuda.bell_matvec(A, x.contiguous())
    return _spmv_plain(A, x)


def _spmv_plain(A: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel (and the JAX package's matvec): one
    gather of x rows by ``cols`` and the contraction, every slot read."""
    if A.col_chunk > 1:
        x = x.reshape(-1, A.col_chunk * x.shape[1])
    return rows_product(A.data, x[A.cols])  # x[A.cols]: (n, K, C*bc)


def spmv_rows(A: BlockELL, x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(A @ x) restricted to the given block rows: (m, br)."""
    c = A.cols[rows]  # (m, K)
    if A.col_chunk > 1:
        x = x.reshape(-1, A.col_chunk * x.shape[1])
    return rows_product(A.data[rows], x[c])
