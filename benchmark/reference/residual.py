"""Plain float64 residual of a solve: ``||b - A x|| / ||b||``.

``A`` is the benchmark's own ``scipy.sparse`` matrix (DIA or CSR), never the
program's staged operator; ``b`` is the benchmark's right-hand side and ``x``
the program's answer, read only to be judged. The product runs in plain
torch in float64 on the given device, diagonal by diagonal (DIA) or as a
gather and an ``index_add_`` over the stored entries (CSR).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


class Operator:
    """``y = A @ x`` in float64 on ``device``."""

    def __init__(self, A: sp.spmatrix, device):
        self.device = torch.device(device)
        self.n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"square matrix expected, got {A.shape}")
        if isinstance(A, sp.dia_matrix):
            self.offsets = [int(o) for o in A.offsets]
            self.diags = torch.as_tensor(
                np.asarray(A.data[:, : self.n], dtype=np.float64),
                device=self.device,
            )
            self.rows = None
        else:
            A = A.tocsr()
            counts = torch.as_tensor(np.diff(A.indptr), device=self.device)
            self.rows = torch.repeat_interleave(
                torch.arange(self.n, device=self.device), counts
            )
            self.cols = torch.as_tensor(
                A.indices.astype(np.int64), device=self.device
            )
            self.vals = torch.as_tensor(
                A.data.astype(np.float64), device=self.device
            )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        if self.rows is None:
            # scipy DIA: A[i, i + off] = data[d, i + off]
            y = torch.zeros(n, dtype=torch.float64, device=self.device)
            for off, col in zip(self.offsets, self.diags):
                if off >= 0:
                    y[: n - off] += col[off:] * x[off:]
                else:
                    y[-off:] += col[: n + off] * x[: n + off]
            return y
        y = torch.zeros(n, dtype=torch.float64, device=self.device)
        return y.index_add_(0, self.rows, self.vals * x[self.cols])


def relres(A: Operator, b, x) -> float:
    """``||b - A x|| / ||b||`` in float64; ``inf`` for an answer that is not
    a finite vector of the right length."""
    xt = torch.as_tensor(x).reshape(-1)
    if xt.numel() != A.n:
        return float("inf")
    xt = xt.to(device=A.device, dtype=torch.float64)
    bt = torch.as_tensor(b, device=A.device, dtype=torch.float64)
    r = bt - A(xt)
    out = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bt))
    return out if np.isfinite(out) else float("inf")
