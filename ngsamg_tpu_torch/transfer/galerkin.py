"""Galerkin triple product (RAP) — setup-phase coarse operator assembly.

Copied from ngsamg_tpu/transfer/galerkin.py. A block-structured product
(``bs_r``/``bs_c``) runs as two native block Gustavson passes (``bsr_mm``),
as in the original; with ``native.HAVE_NATIVE`` off, or for a blocking the
BSR conversions refuse, it runs on scipy's BSR products. The scalar product
runs on scipy (the original's native ``rap_csr`` is item 10c). Symmetry is
restored exactly afterwards (the product is symmetric in exact arithmetic
since A is).
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
    """Coarse operator A_c = P^T A P (symmetrized).

    ``bs_r``/``bs_c`` give the fine-row / coarse-column BLOCK sizes of a
    block-structured product: the triple product then runs as two native
    block-entry Gustavson passes (``bsr_mm``, f64, rectangular blocks),
    ~bs^2 less index work than the scalar kernel. With
    ``native.HAVE_NATIVE`` off the two products run on scipy's BSR kernels,
    (P^T (A P)) with ``A`` in (bs_r, bs_r) and ``P`` in (bs_r, bs_c)
    blocks, the same sums; entries that are exactly zero inside stored
    blocks are then dropped, as the scalar route never stores them.
    ``dtype`` is the emitted precision.
    """
    blocked = bs_r > 1 or (bs_c or 1) > 1
    if blocked:
        Ac = _rap_bsr_mm(A, P, bs_r, bs_c or bs_r)
        if Ac is not None:
            return Ac if dtype is None else Ac.astype(dtype)
    if dtype is not None:
        # astype would copy (and drop the cached BSR view of) a matrix
        # that already has the dtype
        if A.dtype != dtype:
            A = A.astype(dtype)
        if P.dtype != dtype:
            P = P.astype(dtype)
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


def _rap_bsr_mm(A, P, bs_r: int, bc: int):
    """The original's native block RAP: (P^T (A P)) by ``native.bsr_mm``
    in f64, symmetrized; None where the switch is off or the blocking does
    not fit."""
    from .. import native

    # only the BSR conversions may legitimately fail (irregular blocking);
    # kernel errors propagate
    try:
        A_b = sp.bsr_matrix(A, blocksize=(bs_r, bs_r))
        P_b = (
            P
            if sp.issparse(P) and P.format == "bsr"
            and P.blocksize == (bs_r, bc)
            else sp.bsr_matrix(P, blocksize=(bs_r, bc))
        )
    except (ValueError, TypeError):
        return None
    AP = native.bsr_mm(A_b, P_b)
    if AP is None:
        return None
    Pt_b = P_b.transpose().tobsr(blocksize=(bc, bs_r))
    Ac_b = native.bsr_mm(Pt_b, AP)
    if Ac_b is None:
        return None
    Ac = Ac_b.tocsr()
    Ac = ((Ac + Ac.T) * 0.5).tocsr()
    Ac.sum_duplicates()
    Ac.sort_indices()
    return Ac
