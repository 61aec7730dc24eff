"""Work counts of one float32 Gauss-Seidel sweep of a scalar level, from the
problem and never from the program's storage, by ``benchmark/roofline.py``'s
rule for the matrix:

- A lattice operator (a ``scipy.sparse.dia_matrix`` of a uniform stencil):
  its distinct stencil taps (one float32 value each), one float32 inverse
  diagonal where the diagonal is uniform (else one a row), ``b`` read and
  ``x`` read and written once each.
- Any other operator: every nonzero (after ``eliminate_zeros``) read once,
  a float32 value and an int32 column index; one int32 row pointer a row
  and one more; the inverse diagonal, ``b`` read and ``x`` read and written,
  4 bytes each a row.

Operations: a multiply and an add a nonzero, and a subtraction and a
multiply a row (the residual and the diagonal scale).

A sweep that stores padding, reads ``x`` more than once or splits its rows
into more launches does the same work by this count, so what it spends
beyond it shows as a share of the roofline below 100%.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from benchmark import roofline

F32 = 4
I32 = 4


def _lattice_sweep_work(A: sp.dia_matrix) -> tuple[int, int]:
    n = A.shape[0]
    # the matvec's count: 2 a nonzero; the taps, x read and y written
    ops, nbytes = roofline.lattice_matvec_work(A)
    diag = A.diagonal()
    dinv = F32 if np.all(diag == diag[0]) else F32 * n
    # y is x written back; b is the one vector more
    return ops + 2 * n, nbytes + F32 * n + dinv


def _sparse_sweep_work(A: sp.spmatrix) -> tuple[int, int]:
    A = sp.csr_matrix(A, copy=True)
    A.eliminate_zeros()
    n, nnz = A.shape[0], A.nnz
    nbytes = nnz * (F32 + I32) + I32 * (n + 1) + (F32 + 2 * F32 + F32) * n
    return 2 * nnz + 2 * n, nbytes


def sweep_work(A: sp.spmatrix) -> tuple[int, int]:
    """(operations, bytes) of one float32 sweep of the scalar matrix A."""
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"square matrix expected, got {A.shape}")
    if isinstance(A, sp.dia_matrix):
        return _lattice_sweep_work(A)
    return _sparse_sweep_work(A)
