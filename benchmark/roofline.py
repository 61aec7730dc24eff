"""Work counts of one float32 matvec, from the problem and never from the
program's storage, and the least time an NVIDIA H100 could take for it.

- A lattice operator (a ``scipy.sparse.dia_matrix`` of a uniform stencil):
  its distinct stencil taps (one float32 value each), x read once and y
  written once. Operations: a multiply and an add per stored nonzero.
- Any other operator, in ``bs x bs`` blocks: each block of the input matrix
  that holds a nonzero read once (``bs*bs`` float32 values and one int32
  block-column index), one int32 row pointer per block row and one more, x
  read once and y written once. Operations: a multiply and an add per entry
  of those blocks.

A format that stores padding or reads x again does the same work by this
count, so a layout that drops the padding shows as a gain, not as a lower
bound.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

F32 = 4
I32 = 4
# NVIDIA's H100 SXM data sheet (dense rates, 700 W): HBM3 bandwidth and the
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def lattice_matvec_work(A: sp.dia_matrix) -> tuple[int, int]:
    """(operations, bytes) of y = A x for a uniform-stencil DIA matrix."""
    n = A.shape[0]
    taps = nnz = 0
    for off, col in zip(A.offsets, A.data):
        # scipy DIA: data[d, j] is A[j - off, j]; only 0 <= j - off < n
        k = int(np.count_nonzero(col[max(0, off): min(n, n + off)]))
        taps += k > 0
        nnz += k
    return 2 * nnz, F32 * taps + 2 * F32 * n


def block_matvec_work(A: sp.spmatrix, bs: int) -> tuple[int, int]:
    """(operations, bytes) of y = A x with A read in ``bs x bs`` blocks."""
    A = sp.csr_matrix(A, copy=True)
    A.eliminate_zeros()
    n, m = A.shape
    if n % bs or m % bs:
        raise ValueError(f"{A.shape} is not in {bs} x {bs} blocks")
    blocks = len(A.tobsr(blocksize=(bs, bs)).indices)
    nbr = n // bs
    return (2 * bs * bs * blocks,
            blocks * (bs * bs * F32 + I32) + I32 * (nbr + 1) + 2 * F32 * n)


def matvec_work(A: sp.spmatrix, bs: int) -> tuple[int, int]:
    if isinstance(A, sp.dia_matrix):
        return lattice_matvec_work(A)
    return block_matvec_work(A, bs)


def bound_s(ops: int, nbytes: int) -> tuple[float, str]:
    """The least time, and which of ``"bytes"`` and ``"ops"`` sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
