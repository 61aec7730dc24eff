"""Plain Gauss-Seidel sweeps in float64, by their definition.

For a matrix ``A = D + L + U`` (diagonal, strictly lower, strictly upper, in
the order its rows are given), a forward Gauss-Seidel sweep is

    x <- x + (D + L)^{-1} (b - A x)

and a backward sweep is ``x <- x + (D + U)^{-1} (b - A x)``; ``steps``
sweeps apply that ``steps`` times. Two forms:

- ``dense_sweep``: the definition itself, a triangular solve on the dense
  ``D + L`` (or ``D + U``) with ``torch.linalg.solve_triangular``. For
  test sizes only.
- ``blocked_sweep``: the same on a colour-sorted sparse matrix, colour by
  colour (backwards in reverse colour order), each colour's rows updated
  from the latest ``x`` by a sparse product of those rows. It equals the
  definition only where no two rows of one colour are coupled, so it first
  checks that each colour's diagonal block is diagonal, and raises
  ``ValueError`` where it is not. It runs at full size on a card.

Plain ``torch`` in float64; imports nothing of the program. Departures:

- scalar rows only (one unknown a row): the program's block sweeps (3x3
  and 6x6 blocks) are not covered;
- the diagonal must be nonzero; the program's inverse diagonal sets a zero
  entry's inverse to 0 instead;
- in float32 the blocked form sums each row in another order than the
  definition's triangular solve, so the two agree to rounding only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


class Csr:
    """A square ``scipy.sparse`` matrix as float64 CSR tensors on
    ``device``: row of each entry, column, value, and the diagonal."""

    def __init__(self, A: sp.spmatrix, device):
        A = sp.csr_matrix(A, dtype=np.float64)
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"square matrix expected, got {A.shape}")
        self.device = torch.device(device)
        self.n = A.shape[0]
        self.indptr = [int(v) for v in A.indptr]
        dev = self.device
        self.rows = torch.as_tensor(
            np.repeat(np.arange(self.n), np.diff(A.indptr)), device=dev)
        self.cols = torch.as_tensor(A.indices.astype(np.int64), device=dev)
        self.vals = torch.as_tensor(A.data, device=dev)
        self.diag = torch.as_tensor(A.diagonal(), device=dev)


def _colour_products(A: Csr, bounds):
    """Each colour's rows as ``(lo, hi, rows - lo, cols, vals)``, after
    checking that no entry couples two rows of one colour."""
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        a, e = A.indptr[lo], A.indptr[hi]
        rows, cols, vals = A.rows[a:e], A.cols[a:e], A.vals[a:e]
        inside = (cols >= lo) & (cols < hi) & (cols != rows) & (vals != 0)
        if bool(inside.any()):
            raise ValueError(
                f"colour rows [{lo}, {hi}) are coupled: its diagonal block "
                "is not diagonal, so the colouring is not valid")
        out.append((lo, hi, rows - lo, cols, vals))
    return out


def blocked_sweep(A: Csr, bounds, x, b, reverse: bool = False,
                  steps: int = 1) -> torch.Tensor:
    """``steps`` forward (or backward) sweeps on ``A``, whose rows are
    sorted by colour: colour ``c`` holds rows ``bounds[c]:bounds[c + 1]``.
    ``x`` (None: zero) and ``b`` are float64 vectors of length ``A.n``;
    ``x`` is not written."""
    bounds = [int(v) for v in bounds]
    if bounds[0] != 0 or bounds[-1] != A.n or any(
            a > c for a, c in zip(bounds[:-1], bounds[1:])):
        raise ValueError(f"colour bounds {bounds[:3]}... do not cover "
                         f"{A.n} rows in order")
    parts = _colour_products(A, bounds)
    if reverse:
        parts = parts[::-1]
    b = torch.as_tensor(b, dtype=torch.float64, device=A.device)
    x = (torch.zeros_like(b) if x is None else
         torch.as_tensor(x, dtype=torch.float64, device=A.device).clone())
    for _ in range(steps):
        for lo, hi, rows, cols, vals in parts:
            if hi == lo:
                continue
            ax = torch.zeros(hi - lo, dtype=torch.float64, device=A.device)
            ax.index_add_(0, rows, vals * x[cols])
            x[lo:hi] += (b[lo:hi] - ax) / A.diag[lo:hi]
    return x


def dense_sweep(A, x, b, reverse: bool = False,
                steps: int = 1) -> torch.Tensor:
    """``steps`` sweeps by the definition on the dense float64 ``A`` (a
    tensor or an array); ``x`` None is zero."""
    A = torch.as_tensor(A, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    x = (torch.zeros_like(b) if x is None else
         torch.as_tensor(x, dtype=torch.float64).clone())
    T = torch.triu(A) if reverse else torch.tril(A)
    for _ in range(steps):
        r = (b - A @ x).unsqueeze(1)
        x = x + torch.linalg.solve_triangular(
            T, r, upper=reverse).squeeze(1)
    return x
