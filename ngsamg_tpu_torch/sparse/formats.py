"""Device sparse formats of the structured main path + the `matvec` dispatch.

Port of ngsamg_tpu/sparse/formats.py, cut to the formats a lattice
hierarchy stages (see ``format_from_stencil`` and ``choose_format``):

* :class:`StencilDia` — a uniform clipped stencil: m scalar values and m
  vector offsets, no per-row data. The finest level of a constant-
  coefficient lattice problem. Matvec: K1 (ops/stencil_cuda.py).
* :class:`DiaMatrix` — diagonal storage, full or symmetric half
  (``sym_half``: only offsets >= 0 stored, the minus direction read by
  symmetry). Middle levels. Matvec: K2/K3 (ops/dia_cuda.py).
* :class:`DenseMatrix` — small coarse levels, applied with ``torch.matmul``.

Vectors are (nrows_pad, bs) tensors, as in the JAX package. The matvec of
a CUDA tensor always runs the hand-written kernel (at every size); a CPU
tensor takes the kernel's plain PyTorch version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.dia_cuda import dia_matvec
from ..ops.stencil_cuda import stencil_matvec


@dataclass(frozen=True)
class DiaMatrix:
    """Diagonal-storage sparse matrix (square, scalar entries).

    data[d, i] = A[i, i + offsets[d]] (zero where out of range); the row
    dimension is padded to ``nrows_pad``. ``sym_half``: only the
    offsets >= 0 diagonals are stored; the minus direction is read from the
    positive arrays by exact symmetry (data[-o][i] = data[o][i - o],
    verified at construction).
    """

    data: torch.Tensor  # (ndiag, nrows_pad)
    offsets: tuple  # ints, ascending
    nrows: int
    nrows_pad: int
    sym_half: bool = False


@dataclass(frozen=True)
class DenseMatrix:
    """Dense square matrix acting on (nrows_pad, bs) block vectors."""

    data: torch.Tensor  # (nrows_pad*bs, nrows_pad*bs)
    nrows: int  # logical block rows
    nrows_pad: int
    bs: int


@dataclass(frozen=True)
class StencilDia:
    """Uniform clipped stencil: scalar values + vector offsets, ZERO data.

    y = sum_t vals[t] * shift_nd(x, off_t), where the n-d zero-filled
    shifts implement the Dirichlet clipping exactly.
    """

    vals: torch.Tensor  # (m,) stencil values
    offs: tuple  # m d-tuples
    dims: tuple  # lattice extents
    nrows: int
    nrows_pad: int


def matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for the port's device formats; x: (nrows_pad, bs)."""
    if isinstance(A, DiaMatrix):
        return dia_matvec(A, x)
    if isinstance(A, StencilDia):
        return stencil_matvec(A, x)
    if isinstance(A, DenseMatrix):
        n, bs = x.shape
        return torch.matmul(A.data, x.reshape(-1)).reshape(n, bs)
    from ..transfer.lattice_transfer import (
        LatticeProlongation,
        LatticeRestriction,
        lattice_prol_apply,
        lattice_restrict_apply,
    )

    if isinstance(A, LatticeProlongation):
        return lattice_prol_apply(A, x)
    if isinstance(A, LatticeRestriction):
        return lattice_restrict_apply(A, x)
    raise TypeError(type(A))


# ---------------------------------------------------------------------------
# host-side construction / format selection
# ---------------------------------------------------------------------------

# symmetric halving pays off once shipping/residency dominate
_DIA_SYM_MIN_ROWS = 100_000

DENSE_MAX_ROWS = 4096
DIA_MAX_DIAGS = 256


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def dia_from_scipy(
    A: sp.spmatrix, dtype, row_align: int = 8, device="cpu"
) -> DiaMatrix:
    C = A.tocsr()
    n = C.shape[0]
    n_pad = -(-n // row_align) * row_align
    coo = C.tocoo()
    off_all = coo.col.astype(np.int64) - coo.row
    offs = _unique_offsets(off_all, n)
    # O(nnz) slot lookup instead of a searchsorted per entry
    b = int(max(-offs[0], offs[-1], 0))
    lut = np.zeros(2 * b + 1, dtype=np.int32)
    lut[offs + b] = np.arange(len(offs), dtype=np.int32)
    data = np.zeros((len(offs), n_pad), dtype=np.dtype(dtype))
    data[lut[off_all + b], coo.row] = coo.data
    return DiaMatrix(
        data=_tensor(data, device),
        offsets=tuple(int(o) for o in offs),
        nrows=n,
        nrows_pad=n_pad,
    )


def dia_from_stencil(
    op, dtype, row_align: int = 8, device="cpu"
) -> DiaMatrix:
    """DiaMatrix straight from a stencil-form level (transfer/stencil.py)."""
    from ..transfer.stencil import to_dia_arrays

    n = op.n
    n_pad = -(-n // row_align) * row_align
    offs, raw = to_dia_arrays(op)
    data = np.zeros((len(offs), n_pad), dtype=np.dtype(dtype))
    data[:, :n] = raw
    return DiaMatrix(
        data=_tensor(data, device),
        offsets=tuple(int(o) for o in offs),
        nrows=n,
        nrows_pad=n_pad,
    )


def format_from_stencil(stc, dtype, row_align: int = 8, device="cpu"):
    """Device format for a stencil-form level (LatticeOp or ClampedOp).

    Uniform clipped stencils become :class:`StencilDia` (no per-row data);
    clamp-compressed levels expand straight into padded DIA rows; plain
    stencil levels use :func:`dia_from_stencil`.
    """
    from ..transfer.stencil import ClampedOp, detect_uniform

    if isinstance(stc, ClampedOp):
        vals = detect_uniform(stc.patch)
        if vals is not None:
            n = stc.n
            n_pad = -(-n // row_align) * row_align
            v = np.asarray(vals, dtype=np.dtype(dtype))
            return StencilDia(
                vals=_tensor(v, device),
                offs=tuple(tuple(int(x) for x in o) for o in stc.offs),
                dims=tuple(int(x) for x in stc.dims),
                nrows=n,
                nrows_pad=n_pad,
            )
        return dia_from_clamped(stc, dtype, row_align, device=device)
    return dia_from_stencil(stc, dtype, row_align, device=device)


def dia_from_clamped(
    cop, dtype, row_align: int = 8, device="cpu"
) -> DiaMatrix:
    """DiaMatrix from a clamp-compressed level: expand each offset's field
    directly into the padded array (no full f64 intermediate)."""
    from ..transfer.stencil import _strides

    n = cop.n
    n_pad = -(-n // row_align) * row_align
    strides = _strides(cop.dims)
    lin = (cop.offs * strides).sum(axis=1)
    order = np.argsort(lin, kind="stable")
    uniq, first = np.unique(lin[order], return_index=True)
    dt = np.dtype(dtype)
    patch_cast = cop.patch.data.astype(dt, copy=False)
    data = np.empty((len(uniq), n_pad), dtype=dt)
    for u in range(len(uniq)):
        hi = first[u + 1] if u + 1 < len(uniq) else len(order)
        ts = order[first[u]: hi]
        field = patch_cast[ts[0]][np.ix_(*cop.maps)].reshape(-1)
        for t in ts[1:]:
            field = field + patch_cast[t][np.ix_(*cop.maps)].reshape(-1)
        data[u, :n] = field
        data[u, n:] = 0
    # symmetric halving: drop the negative diagonals when every +-pair
    # verifies data[-o][o:] == data[o][:-o] exactly (the coarse operators
    # are explicitly symmetrized)
    offs_t = tuple(int(o) for o in uniq)
    if n >= _DIA_SYM_MIN_ROWS and 0 < max(offs_t):
        neg = {-o: u for u, o in enumerate(offs_t) if o < 0}
        ok = set(neg) == {o for o in offs_t if o > 0}
        if ok:
            for o in neg:
                up, un = offs_t.index(o), neg[o]
                if not (
                    np.array_equal(data[un, o:n], data[up, : n - o])
                    and not data[un, :o].any()
                ):
                    ok = False
                    break
        if ok:
            keep = [u for u, o in enumerate(offs_t) if o >= 0]
            return DiaMatrix(
                data=_tensor(data[keep], device),
                offsets=tuple(o for o in offs_t if o >= 0),
                nrows=n,
                nrows_pad=n_pad,
                sym_half=True,
            )
    return DiaMatrix(
        data=_tensor(data, device),
        offsets=offs_t,
        nrows=n,
        nrows_pad=n_pad,
    )


def _unique_offsets(off: np.ndarray, n: int) -> np.ndarray:
    """Sorted unique diagonal offsets, O(nnz) via a presence mask."""
    if len(off) == 0:
        return np.zeros(0, dtype=np.int64)
    present = np.zeros(2 * n - 1, dtype=bool)
    present[off + (n - 1)] = True
    return np.flatnonzero(present).astype(np.int64) - (n - 1)


def count_diagonals(A: sp.spmatrix, limit: int | None = None) -> int:
    """Number of distinct diagonals; with ``limit``, an early-out count
    (a cheap row sample that already exceeds it skips the full pass)."""
    n = A.shape[0]
    C = A.tocsr() if not sp.issparse(A) or A.format != "csr" else A
    if limit is not None and n > 8192:
        step = max(n // 4096, 1)
        rows = np.arange(0, n, step)
        lo, hi = C.indptr[rows], C.indptr[rows + 1]
        cnt = np.minimum(hi - lo, 64)
        idx = np.concatenate(
            [C.indices[a: a + c] for a, c in zip(lo, cnt)]
        ) if len(rows) else np.zeros(0, np.int64)
        offs = idx.astype(np.int64) - np.repeat(rows, cnt)
        if len(np.unique(offs)) > limit:
            return limit + 1  # definitely not DIA-eligible
    coo = C.tocoo()
    return len(
        _unique_offsets(coo.col.astype(np.int64) - coo.row, n)
    )


def dense_from_scipy(
    A: sp.spmatrix, bs: int, dtype, row_align: int = 8, device="cpu"
) -> DenseMatrix:
    n = A.shape[0] // bs
    n_pad = -(-n // row_align) * row_align
    out = np.zeros((n_pad * bs, n_pad * bs), dtype=np.dtype(dtype))
    out[: A.shape[0], : A.shape[1]] = A.toarray()
    return DenseMatrix(
        data=_tensor(out, device), nrows=n, nrows_pad=n_pad, bs=bs
    )


def choose_format(
    A: sp.spmatrix,
    bs: int,
    dtype,
    row_align: int = 8,
    *,
    device="cpu",
):
    """Format for a level without a stencil: DIA (few diagonals) or dense
    (small). The tile-ELL and block-ELL formats of the JAX package are not
    ported: levels that need them raise. In the mid-density regime (more
    than ``DENSE_MAX_ROWS`` rows, 33..``DIA_MAX_DIAGS`` diagonals) the JAX
    package weighs DIA against tile-ELL bytes and takes DIA when its
    tile-ELL packer is unavailable; without tile-ELL the port takes DIA."""
    n = A.shape[0] // bs
    # DIA wins over dense whenever the level is a stencil and not tiny
    if bs == 1 and n > 512:
        nd = count_diagonals(A, limit=DIA_MAX_DIAGS)
        if nd <= DIA_MAX_DIAGS:
            return dia_from_scipy(A, dtype, row_align, device=device)
    if n <= DENSE_MAX_ROWS and (n * bs) ** 2 * 4 <= 512e6:
        return dense_from_scipy(A, bs, dtype, row_align, device=device)
    raise NotImplementedError(
        f"level of {n} rows (bs={bs}) needs tile-ELL or block-ELL, which "
        "ngsamg_tpu_torch does not have yet (ROADMAP queue 1 item 2)"
    )


def block_vec(v, bs: int, nrows_pad: int, dtype, device="cpu"):
    """Reshape a flat DOF vector into a padded (nrows_pad, bs) block vector."""
    v = torch.as_tensor(v, dtype=dtype, device=device).reshape(-1, bs)
    n = v.shape[0]
    if n < nrows_pad:
        v = torch.cat([v, v.new_zeros((nrows_pad - n, bs))], dim=0)
    return v


def flat_vec(v: torch.Tensor, nrows: int) -> torch.Tensor:
    """Inverse of :func:`block_vec`: drop row padding and flatten."""
    return v[:nrows].reshape(-1)
