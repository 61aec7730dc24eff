"""Prolongation construction: piecewise transport + smoothed variant.

Copied from ngsamg_tpu/transfer/prolongation.py, numpy branches — the
reference's `PWProlMap` and `SemiAuxSProlMap`
(vertex_factory_impl.hpp:1599-1659 and :1834-2433):

* **Piecewise**: one block per fine vertex, Q(x_coarse -> x_fine) (identity
  for H1, rigid-body extension for elasticity).
* **Smoothed**: one damped-Jacobi step on P using the *replacement matrix*
  A-hat assembled from edge energies (rows with a small real-matrix coarse
  fan-out are smoothed with the filtered level matrix instead), followed by
  a fan-out bound (`sp_max_per_row`) and a drop tolerance (`sp_min_frac`).
  Truncated entries are transported into the strongest kept column, so the
  energy kernel (constants for H1, rigid-body modes for elasticity) stays
  exactly preserved.

The scalar (dpv 1) smoothing, spectral radius and truncation run in one
fused native pass from the H1 mesh data (``native.smoothed_prol_scalar``,
with ``rho_power_h1`` for the radius), as in the original. The block
(dpv > 1) smoothing keeps A-hat, the level matrix and P in BSR and runs on
the original's native kernels (``rho_power``, ``bsr_smooth_update``,
``bsr_mm``), and the truncation of an energy with an identity or rigid
transport on ``truncate_prol_blocks``. With ``native.HAVE_NATIVE`` off, or
for an input a kernel declines (counted in ``native.CALLS``), the numpy and
scipy branches beside them compute P: the same structure, the values to
rounding.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import native
from ..apps.base import Energy
from ..mesh.topo import AlgebraicMesh


def piecewise_prol(
    energy: Energy,
    mesh_f: AlgebraicMesh,
    mesh_c: AlgebraicMesh,
    v2agg: np.ndarray,
) -> sp.bsr_matrix:
    """P_pw: (nf*dpv) x (nc*dpv), row v = Q(x_agg(v) -> x_v).

    Vertices with v2agg == -1 (Dirichlet-dropped) get an all-zero row.
    """
    dpv = energy.dpv
    nf, nc = mesh_f.nv, mesh_c.nv
    act = np.flatnonzero(v2agg >= 0)
    pos_f = energy.vertex_positions(mesh_f)
    pos_c = energy.vertex_positions(mesh_c)
    if pos_f is None:
        Q = energy.transport(None, np.zeros((len(act), 0)))
    else:
        Q = energy.transport(pos_c[v2agg[act]], pos_f[act])
    indptr = np.zeros(nf + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(v2agg >= 0)
    indices = v2agg[act].astype(np.int32)
    return sp.bsr_matrix(
        (Q.astype(np.float64), indices, indptr), shape=(nf * dpv, nc * dpv)
    )


def _rho_estimate(Dinv_op, Ahat, iters: int = 10, seed: int = 0) -> float:
    """Power-iteration estimate of rho(Dinv A-hat) (host, cheap)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(Ahat.shape[0])
    lam = 1.0
    for _ in range(iters):
        x = Dinv_op(Ahat @ x)
        nrm = np.linalg.norm(x)
        if nrm == 0:
            return 2.0
        lam = nrm
        x /= nrm
    return float(lam)


def smoothed_prol(
    energy: Energy,
    mesh_f: AlgebraicMesh,
    mesh_c: AlgebraicMesh,
    v2agg: np.ndarray,
    P_pw: sp.bsr_matrix,
    *,
    omega: float = 4.0 / 3.0,
    max_per_row: int = 4,
    min_frac: float = 0.1,
    A: sp.spmatrix | None = None,
    row_bs: int | None = None,
    max_classic: int = 5,
) -> sp.bsr_matrix:
    """One damped-Jacobi smoothing step on P_pw (semi-aux variant).

    The reference's default `SemiAuxSProlMap`
    (vertex_factory_impl.hpp:1744-1831): rows whose REAL-matrix coarse
    fan-out stays within ``max_classic`` are smoothed with the actual
    (filtered) level matrix ``A`` and all other rows with the replacement
    (aux) matrix A-hat. Followed by fan-out-bounded, kernel-preserving
    truncation. ``omega`` is in units of 1/rho(D^-1 A); 4/3 is the
    classical SA optimum.
    """
    dpv = energy.dpv
    if dpv > 1:
        P = _smoothed_block(
            energy, mesh_f, v2agg, P_pw, omega=omega, A=A, row_bs=row_bs,
            max_classic=max_classic,
        )
        return truncate_prol(
            energy, mesh_c, P, max_per_row=max_per_row, min_frac=min_frac
        )
    P = _smoothed_prol_scalar_native(
        mesh_f, v2agg, P_pw.shape[1],
        omega=omega, max_per_row=max_per_row, min_frac=min_frac,
        A=A if row_bs == 1 else None, max_classic=max_classic,
    )
    if P is not None:
        return P
    Ahat = energy.replacement_matrix(mesh_f).tocsr()
    d = Ahat.diagonal()
    dinv = np.where(d > 0, 1.0 / np.maximum(d, 1e-300), 0.0)

    def Dinv_op(x):
        return dinv * x

    Dinv_mat = sp.diags(dinv)
    rho = _rho_estimate(Dinv_op, Ahat)
    scale = omega / max(rho, 1e-12)
    P = (P_pw - scale * (Dinv_mat @ (Ahat @ P_pw))).tocsr()

    classic = None
    if A is not None and row_bs == 1 and max_classic and max_classic > 1:
        classic = _classic_rows(A, 1, v2agg, P_pw.shape[1], max_classic)
    if classic is not None and classic.any():
        # SA filtering: lump positive off-diagonals onto the diagonal
        # (rowsum-preserving); the filtered classic matrix ~= the aux
        # replacement matrix for H1, so both share the aux scale
        Ar = _filter_pos_offdiag(A.tocsr())
        da = Ar.diagonal()
        DinvA = sp.diags(np.where(da > 0, 1.0 / da, 0.0))
        P_real = (P_pw - scale * (DinvA @ (Ar @ P_pw))).tocsr()
        sel = sp.diags(classic.astype(np.float64))
        inv = sp.diags((~classic).astype(np.float64))
        P = (sel @ P_real + inv @ P).tocsr()
        P.eliminate_zeros()

    P = P.tobsr(blocksize=(1, 1))
    P.sort_indices()
    return truncate_prol(
        energy, mesh_c, P, max_per_row=max_per_row, min_frac=min_frac
    )


def _block_diag_bsr(blocks: np.ndarray) -> sp.bsr_matrix:
    """Block-diagonal BSR of an (n, bs, bs) stack."""
    n, bs = blocks.shape[0], blocks.shape[1]
    return sp.bsr_matrix(
        (blocks, np.arange(n, dtype=np.int32), np.arange(n + 1)),
        shape=(n * bs, n * bs),
    )


def _smoothed_block(
    energy, mesh_f, v2agg, P_pw, *, omega, A, row_bs, max_classic
) -> sp.bsr_matrix:
    """The damped-Jacobi step of :func:`smoothed_prol` for dpv > 1, before
    truncation: block Dinv = pinv of A-hat's diagonal blocks, rho by power
    iteration, P = P_pw - (omega/rho) Dinv A-hat P_pw; classic rows (only
    where the level matrix already has dpv-blocks) take the level matrix
    with its own rho instead.

    A-hat stays sorted BSR end to end: rho comes from the native block
    power iteration (``rho_power``) and the update from the fused native
    kernel (``bsr_smooth_update``), or, where that declines the shape, from
    the native block product (``bsr_mm``) with the update assembled on the
    product's own sorted structure. With ``native.HAVE_NATIVE`` off, scipy's
    block products do the work."""
    from ..sparse.host import block_diagonal_fast, to_bsr

    dpv = energy.dpv
    nf = mesh_f.nv
    Ahat_raw = energy.replacement_matrix(mesh_f)
    Ahat = (
        Ahat_raw
        if sp.issparse(Ahat_raw)
        and Ahat_raw.format == "bsr"
        and Ahat_raw.blocksize == (dpv, dpv)
        else sp.bsr_matrix(Ahat_raw.tocsr(), blocksize=(dpv, dpv))
    )
    if not Ahat.has_sorted_indices:
        Ahat.sort_indices()
    Dinv_b = np.linalg.pinv(block_diagonal_fast(Ahat, dpv))
    Ppw_b = P_pw.tobsr(blocksize=(dpv, dpv))
    P = None
    rho = native.rho_power(
        Ahat, Dinv_b, np.random.default_rng(0).standard_normal(nf * dpv), 10
    )
    if rho is not None:
        scale = omega / max(float(rho), 1e-12)
        P = _native_smooth(Ahat, Ppw_b, Dinv_b, scale, nf)
    if P is None:
        Dinv_mat = _block_diag_bsr(Dinv_b)
        rho = _rho_estimate(lambda x: Dinv_mat @ x, Ahat)
        scale = omega / max(rho, 1e-12)
        P = (Ppw_b - scale * (Dinv_mat @ (Ahat @ Ppw_b))).tocsr()

    classic = None
    if A is not None and row_bs == dpv and max_classic and max_classic > 1:
        classic = _classic_rows(
            A, dpv, v2agg, P_pw.shape[1] // dpv, max_classic
        )
    if classic is not None and classic.any():
        Ar = to_bsr(A, dpv)  # cached on the level matrix object
        DinvA_b = np.linalg.pinv(block_diagonal_fast(Ar, dpv))
        DinvA = _block_diag_bsr(DinvA_b)
        rho_r = native.rho_power(
            Ar, DinvA_b, np.random.default_rng(1).standard_normal(nf * dpv),
            10,
        )
        if rho_r is None:
            rho_r = _rho_estimate(lambda x: DinvA @ x, Ar, seed=1)
        scale_r = omega / max(float(rho_r), 1e-12)
        P_real = _native_smooth(Ar, Ppw_b, DinvA_b, scale_r, nf)
        if P_real is None:
            P_real = (Ppw_b - scale_r * (DinvA @ (Ar @ Ppw_b))).tocsr()
        sel = sp.diags(np.repeat(classic.astype(np.float64), dpv))
        inv = sp.diags(np.repeat((~classic).astype(np.float64), dpv))
        P = (sel @ P_real + inv @ P).tocsr()
        P.eliminate_zeros()

    P = P.tobsr(blocksize=(dpv, dpv))
    P.sort_indices()
    return P


def _native_smooth(M, Ppw_b, Dinv_b, scale, nf):
    """P_pw - scale Dinv M P_pw (M: A-hat or the level matrix, sorted BSR)
    on the native kernels: the fused update, or where it declines the shape
    the native product with the update assembled on its sorted structure;
    None with the switch off."""
    P = native.bsr_smooth_update(M, Ppw_b, Dinv_b, scale)
    if P is not None:
        return P
    AP = native.bsr_mm(M, Ppw_b)
    if AP is None:
        return None
    dpv = Ppw_b.blocksize[0]
    nc_b = AP.shape[1] // dpv
    rows = np.repeat(np.arange(nf, dtype=np.int64), np.diff(AP.indptr))
    data_new = (-scale) * (Dinv_b[rows] @ AP.data)
    # += P_pw blocks at their positions (sorted rows => the global
    # (row, col) keys are ascending)
    pw_rows = np.repeat(np.arange(nf, dtype=np.int64), np.diff(Ppw_b.indptr))
    keys = rows * nc_b + AP.indices
    want = pw_rows * nc_b + Ppw_b.indices
    pos = np.searchsorted(keys, want)
    # M's structural diagonal puts every piecewise column in AP; a miss
    # means an unsorted product
    if len(want) and not (
        (pos < len(keys)) & (keys[pos % len(keys)] == want)
    ).all():
        raise RuntimeError("bsr_mm returned a product with unsorted rows")
    data_new[pos] += Ppw_b.data
    P = sp.bsr_matrix((data_new, AP.indices, AP.indptr), shape=AP.shape)
    P.has_sorted_indices = True
    return P


def _filter_pos_offdiag(A: sp.csr_matrix) -> sp.csr_matrix:
    """Scalar SA filtered matrix A_F: positive off-diagonals lumped onto
    the diagonal (rowsum preserved, so P_F still reproduces constants)."""
    coo = A.tocoo()
    pos = (coo.row != coo.col) & (coo.data > 0)
    if not pos.any():
        return A.tocsr()
    lump = np.bincount(
        coo.row[pos], weights=coo.data[pos], minlength=A.shape[0]
    )
    keep = ~pos
    out = sp.coo_matrix(
        (
            np.concatenate([coo.data[keep], lump]),
            (
                np.concatenate([coo.row[keep], np.arange(A.shape[0])]),
                np.concatenate([coo.col[keep], np.arange(A.shape[0])]),
            ),
        ),
        shape=A.shape,
    ).tocsr()
    out.sum_duplicates()
    return out


def _rho_estimate_h1_edges(
    edges: np.ndarray,
    w_signed: np.ndarray,
    l2: np.ndarray,
    iters: int = 10,
    seed: int = 0,
) -> float:
    """rho(Dhat^-1 A-hat) without assembling A-hat (edge-scatter matvecs).

    ``w_signed`` are the mesh's SIGNED edge weights; the aux matrix takes
    the attractive part and d = l2 + incident sums (in the kernel on the
    native path, ``native.rho_power_h1``). The numpy loop is
    :func:`_rho_estimate`'s on the H1 replacement matrix
    A-hat x = d*x - sum_edges w (x_j e_i + x_i e_j); its sums associate
    differently from the assembled-CSR path (about 1e-15 apart).
    """
    n = len(l2)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    nat = native.rho_power_h1(edges, w_signed, l2, x, iters)
    if nat is not None:
        return nat
    ei, ej = edges[:, 0], edges[:, 1]
    w = np.maximum(w_signed, 0.0)
    d = l2.astype(np.float64, copy=True)
    if len(ei):
        np.add.at(d, ei, w)
        np.add.at(d, ej, w)
    dinv = np.where(d > 0, 1.0 / np.maximum(d, 1e-300), 0.0)
    lam = 1.0
    for _ in range(iters):
        y = d * x
        if len(ei):
            y -= np.bincount(ei, weights=w * x[ej], minlength=n)
            y -= np.bincount(ej, weights=w * x[ei], minlength=n)
        x = dinv * y
        nrm = np.linalg.norm(x)
        if nrm == 0:
            return 2.0
        lam = nrm
        x /= nrm
    return float(lam)


def _smoothed_prol_scalar_native(
    mesh_f: AlgebraicMesh,
    v2agg: np.ndarray,
    nc: int,
    *,
    omega: float,
    max_per_row: int,
    min_frac: float,
    A: sp.spmatrix | None,
    max_classic: int,
) -> sp.bsr_matrix | None:
    """The scalar H1 semi-aux smoothed and truncated P in one native pass
    (``native.smoothed_prol_scalar``).

    None with ``native.HAVE_NATIVE`` off; None, counted as declined, where
    the mesh lacks the H1 data (edge ``wt``, vertex ``l2wt``: the inputs
    of ``H1Energy.replacement_matrix``) or there is no scalar level matrix
    ``A`` (row blocks > 1), and where the wrapper returns None. The numpy
    path of :func:`smoothed_prol` then runs.
    """
    if not native.HAVE_NATIVE:
        return None
    w = mesh_f.edge_data.get("wt")
    l2 = mesh_f.vertex_data.get("l2wt")
    if w is None or l2 is None or A is None:
        return native.declined("smoothed_prol_scalar")
    # edge weights are SIGNED (attractive positive); the aux matrix takes
    # the attractive part in the kernel (SA filtered-matrix convention)
    rho = _rho_estimate_h1_edges(mesh_f.edges, w, l2)
    scale_aux = omega / max(rho, 1e-12)
    # classic rows smooth with the FILTERED real matrix (filter_pos below);
    # for H1 the filtered matrix equals the aux replacement matrix up to
    # the rowsum clamping, so the aux spectral-radius estimate serves both
    scale_real = scale_aux
    use_classic = bool(max_classic and max_classic > 1)
    P = native.smoothed_prol_scalar(
        A.tocsr(), mesh_f.edges, w, l2, v2agg, nc,
        scale_aux, scale_real, max_per_row,
        max_classic if use_classic else 0, min_frac,
        filter_pos=True,
    )
    if P is None:
        return native.declined("smoothed_prol_scalar")
    return P.tobsr(blocksize=(1, 1))


def _classic_rows(
    A: sp.spmatrix, dpv: int, v2agg: np.ndarray, nc: int, max_classic: int
) -> np.ndarray:
    """Rows whose real-matrix coarse image has <= max_classic columns.

    The 'classic' eligibility of `SemiAuxSProlMap`
    (vertex_factory_impl.hpp:1855 MAX_PER_ROW_CLASSIC)."""
    from ..sparse.host import block_norm_graph

    W, _d = block_norm_graph(A, dpv)
    nf = W.shape[0]
    rows = np.repeat(np.arange(nf, dtype=np.int64), np.diff(W.indptr))
    aggs = v2agg[W.indices]
    own = v2agg
    # distinct coarse columns touched by each row, including its own agg
    key = np.concatenate(
        [
            (rows * np.int64(nc) + aggs)[aggs >= 0],
            (np.arange(nf, dtype=np.int64) * nc + own)[own >= 0],
        ]
    )
    uniq = np.unique(key)
    counts = np.bincount((uniq // nc).astype(np.int64), minlength=nf)
    return (counts <= max_classic) & (v2agg >= 0)


def truncate_prol(
    energy: Energy,
    mesh_c: AlgebraicMesh,
    P: sp.bsr_matrix,
    *,
    max_per_row: int,
    min_frac: float,
) -> sp.bsr_matrix:
    """Bound P's fan-out; transport dropped blocks into the strongest column.

    For every block row, keep the (up to) ``max_per_row`` strongest blocks
    (Frobenius norm) that are also >= min_frac * strongest; every dropped
    block B targeting coarse vertex cd is replaced by B @ Q(x_c0 -> x_cd)
    added onto the strongest kept column c0 — exact kernel preservation.
    """
    dpv = energy.dpv
    nf = P.shape[0] // dpv
    kind = getattr(energy, "transport_kind", None)
    if kind in ("identity", "rigid") and P.blocksize == (dpv, dpv):
        # native kernel (no padded temporaries): the rigid-body or identity
        # transport is resolved in the kernel; ties and quantization match
        # the numpy branch below bit for bit
        if not P.has_sorted_indices:
            P.sort_indices()
        pos_c = (
            energy.vertex_positions(mesh_c) if kind == "rigid" else None
        )
        s = float(getattr(energy, "_s", 0.0)) if kind == "rigid" else 0.0
        out = native.truncate_prol_blocks(
            P, pos_c, s, max_per_row, min_frac
        )
        if out is not None:
            return out
    data, cols = _bsr_to_padded(P, dpv)  # (nf, K, dpv, dpv), (nf, K) col=-1 pad
    K = data.shape[1]
    if K <= max_per_row and min_frac <= 0:
        # row-local decision only: an early return for K <= max_per_row
        # alone would make the result depend on OTHER rows' degrees
        return P
    norms = np.sqrt((data**2).sum(axis=(2, 3)))
    norms[cols < 0] = -1.0
    rowmax = norms.max(axis=1, keepdims=True)
    # QUANTIZED relative magnitudes (40 fractional bits): summation-order
    # ulp noise must not flip near-ties; ties then keep slot
    # (ascending-column) order
    qs = np.where(rowmax > 0, 2.0**40 / np.maximum(rowmax, 1e-300), 0.0)
    q = np.floor(np.maximum(norms, 0.0) * qs + 0.5)
    q[cols < 0] = -1.0
    order = np.argsort(-q, axis=1, kind="stable")  # descending
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(K)[None, :].repeat(nf, 0), axis=1)
    qthr = np.floor(min_frac * 2.0**40 + 0.5)
    keep = (rank < max_per_row) & (q >= qthr) & (cols >= 0)
    # ensure at least the strongest entry is kept for nonzero rows
    keep |= (rank == 0) & (cols >= 0)
    drop = (cols >= 0) & ~keep

    if drop.any():
        c0 = np.take_along_axis(cols, order[:, :1], axis=1).ravel()  # strongest
        pos_c = energy.vertex_positions(mesh_c)
        r, k = np.nonzero(drop)
        cd = cols[r, k]
        if pos_c is None:
            Q = energy.transport(None, np.zeros((len(r), 0)))
        else:
            Q = energy.transport(pos_c[c0[r]], pos_c[cd])
        # B @ Q(c0 -> cd) accumulated onto the strongest column's slot
        add = np.einsum("mij,mjk->mik", data[r, k], Q)
        slot0 = order[:, 0]
        np.add.at(data, (r, slot0[r]), add)
    data[~keep] = 0.0
    cols_out = np.where(keep, cols, -1)
    return _padded_to_bsr(data, cols_out, P.shape, dpv)


def _bsr_to_padded(P: sp.bsr_matrix, dpv: int):
    """BSR -> padded (data, cols) with col = -1 padding."""
    n = P.shape[0] // dpv
    deg = np.diff(P.indptr)
    K = max(int(deg.max()), 1) if len(deg) else 1
    data = np.zeros((n, K, dpv, dpv))
    cols = np.full((n, K), -1, dtype=np.int64)
    rows = np.repeat(np.arange(n), deg)
    slot = np.arange(len(P.indices)) - np.repeat(P.indptr[:-1], deg)
    data[rows, slot] = P.data
    cols[rows, slot] = P.indices
    return data, cols


def _padded_to_bsr(data, cols, shape, dpv):
    m = cols >= 0
    r, k = np.nonzero(m)
    nf = shape[0] // dpv
    indptr = np.zeros(nf + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    # entries are produced row-major already (r sorted)
    B = sp.bsr_matrix(
        (data[r, k], cols[r, k].astype(np.int32), indptr), shape=shape
    )
    B.sort_indices()
    return B
