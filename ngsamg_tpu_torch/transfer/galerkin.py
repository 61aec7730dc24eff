"""Galerkin triple product (RAP) — setup-phase coarse operator assembly.

Copied from ngsamg_tpu/transfer/galerkin.py, scalar scipy branch only (the
native Gustavson and block products there are optional accelerations of
the same product). Symmetry is restored exactly afterwards (the product is
symmetric in exact arithmetic since A is).
"""

from __future__ import annotations

import scipy.sparse as sp


def rap(A: sp.spmatrix, P: sp.spmatrix, dtype=None) -> sp.csr_matrix:
    """Coarse operator A_c = P^T A P (symmetrized), scipy matmats."""
    if dtype is not None:
        A = A.astype(dtype)
        P = P.astype(dtype)
    Ac = (P.T.tocsr() @ (A.tocsr() @ P.tocsr())).tocsr()
    Ac = (Ac + Ac.T) * 0.5
    Ac = Ac.tocsr()
    Ac.sum_duplicates()
    Ac.sort_indices()
    return Ac
