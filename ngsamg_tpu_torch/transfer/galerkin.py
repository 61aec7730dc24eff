"""Galerkin triple product (RAP) — setup-phase coarse operator assembly.

Copied from ngsamg_tpu/transfer/galerkin.py, scipy branches (the native
Gustavson kernels there are optional accelerations of the same product).
Symmetry is restored exactly afterwards (the product is symmetric in exact
arithmetic since A is).
"""

from __future__ import annotations

import scipy.sparse as sp


def rap(
    A: sp.spmatrix,
    P: sp.spmatrix,
    dtype=None,
    bs_r: int = 1,
    bs_c: int | None = None,
) -> sp.csr_matrix:
    """Coarse operator A_c = P^T A P (symmetrized), scipy matmats.

    ``bs_r``/``bs_c`` give the fine-row / coarse-column BLOCK sizes of a
    block-structured product: the two products then run on scipy's BSR
    kernels, (P^T (A P)) with ``A`` in (bs_r, bs_r) and ``P`` in
    (bs_r, bs_c) blocks — ~bs^2 less index work than the scalar CSR
    products, the same sums. Entries that are exactly zero inside stored
    blocks are dropped, as the scalar route never stores them.
    """
    if dtype is not None:
        # astype would copy (and drop the cached BSR view of) a matrix
        # that already has the dtype
        if A.dtype != dtype:
            A = A.astype(dtype)
        if P.dtype != dtype:
            P = P.astype(dtype)
    blocked = bs_r > 1 or (bs_c or 1) > 1
    if blocked:
        from ..sparse.host import to_bsr

        bc = bs_c or bs_r
        A_b = to_bsr(A, bs_r)
        P_b = P.tobsr(blocksize=(bs_r, bc))
        Ac = (P_b.T.tobsr(blocksize=(bc, bs_r)) @ (A_b @ P_b)).tocsr()
    else:
        Ac = (P.T.tocsr() @ (A.tocsr() @ P.tocsr())).tocsr()
    Ac = (Ac + Ac.T) * 0.5
    Ac = Ac.tocsr()
    if blocked:
        Ac.eliminate_zeros()
    Ac.sum_duplicates()
    Ac.sort_indices()
    return Ac
