"""Device sparse formats and `matvec`.

Port of ngsamg_tpu/sparse/formats.py, cut to the formats the ported
hierarchies stage (see ``format_from_stencil`` and ``choose_format``):

* :class:`StencilDia` — a uniform clipped stencil: m scalar values and m
  vector offsets, no per-row data. The finest level of a constant-
  coefficient lattice problem. Matvec: K1 (ops/stencil_cuda.py).
* :class:`DiaMatrix` — diagonal storage, full or symmetric half
  (``sym_half``: only offsets >= 0 stored, the minus direction read by
  symmetry). Stencil-like levels. Matvec: K2/K3 (ops/dia_cuda.py).
* :class:`TileELL` / :class:`TileELLStack` — tile-ELL: 8-row tiles sharing
  one distinct-column slot list, optionally bucketed by slot count and
  gathering 8-wide column chunks per slot. Unstructured levels and the
  explicit transfers. The JAX package computes this matvec in XLA (no
  Pallas kernel). On the card the port runs one hand-written kernel
  (ops/tile_ell_cuda.py) on a compact copy of the nonzeros, staged once
  when the operator is built (a stack one copy, one launch); the plain
  version, ``TileELL.product``, is one gather and one batched product a
  bucket. Each application adds one to the solve's
  ``SolveInfo.tile_ell_matvecs`` (``timers.count_tile_ell_matvecs``, a
  host integer), a stack once whatever its buckets, and each kernel launch
  one to ``SolveInfo.tile_ell_kernel_matvecs``.
* :class:`DiaWindow` — a row block of a full-storage DIA matrix over a
  longer x (a rank's rows of a row-sharded level). Matvec: K2 on the
  window.
* :class:`DenseMatrix` — small coarse levels, applied with ``torch.matmul``.
* :class:`~ngsamg_tpu_torch.sparse.bell.BlockELL` (sparse/bell.py) — block
  (bs > 1) unstructured levels and their transfers.

The host packers of tile-ELL run in the native extension, as in the JAX
package (``native.tile_chunk_counts``, ``tile_ell_fill_range``,
``tile_ell_pack``, and ``csr_permute`` for ``plan_reorder``'s tile sort);
the numpy code beside each call runs with ``native.HAVE_NATIVE`` off and
packs the same arrays. Column slots are stored as int64 on the device
(the kernels emit int32; one cast after the fill).

Every device operator, here and in the layers above (the implicit lattice
transfers, the sharded formats of parallel/), applies itself through its
``matvec(x)`` method; :func:`matvec` calls it.

Vectors are (nrows_pad, bs) tensors, as in the JAX package. The matvec of
a CUDA tensor always runs the hand-written kernel where there is one (at
every size); a CPU tensor takes the kernel's plain PyTorch version. The
batched products (the plain tile-ELL, dense) follow torch's float32 matmul
precision, which is full f32 by default; ``AMGPreconditioner.solve``/
``apply`` force it for their scope (precond/amg.py ``_full_f32``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from .. import native
from ..ops import dia_cuda, stencil_cuda, tile_ell_cuda
from ..utils import timers
from . import bell as _bell


def _rebuild(A):
    """Pickle a format with a launch plan by its constructor's fields: the
    plan (device tensors, ctypes arguments) is made anew where the level
    is unpickled (a rank of the sharded solve loading the hierarchy)."""
    return type(A), tuple(
        getattr(A, f.name) for f in dataclasses.fields(A) if f.init
    )


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
    # K2/K3's launch arguments, made once here (ops/dia_cuda.py ``stage``)
    launch: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "launch", dia_cuda.stage(self))

    def __reduce__(self):
        return _rebuild(self)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return dia_cuda.dia_matvec(self, x)


@dataclass(frozen=True)
class DiaWindow:
    """Rows of a full-storage DIA matrix over a longer x (the rank's row
    block of a row-sharded level, parallel/shard.py):

        y[i] = sum_d data[d, i] * x[x_base + i + offsets[d]],

    x zero outside [0, x_len). Matvec: K2 on the window."""

    data: torch.Tensor  # (ndiag, nrows)
    offsets: tuple  # ints, ascending
    nrows: int
    x_len: int
    x_base: int
    launch: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "launch", dia_cuda.stage(self))

    def __reduce__(self):
        return _rebuild(self)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return dia_cuda.dia_matvec(self, x)


@dataclass(frozen=True)
class DenseMatrix:
    """Dense square matrix acting on (nrows_pad, bs) block vectors."""

    data: torch.Tensor  # (nrows_pad*bs, nrows_pad*bs)
    nrows: int  # logical block rows
    nrows_pad: int
    bs: int

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        n, bs = x.shape
        return torch.matmul(self.data, x.reshape(-1)).reshape(n, bs)


@dataclass(frozen=True)
class TileELL:
    """Tile-ELL: M-row tiles sharing one DISTINCT-column slot list.

    data[t, k, c, m] = A[t*M + m, cols[t, k]*C + c] (zero where absent;
    no ``c`` axis when C == 1). The plain product gathers C consecutive x
    scalars per (tile, slot) — T*K*C values instead of one per nonzero —
    and runs a dense (K*C, M) product per tile. ``cols`` is int64, the
    index dtype of torch's gathers on both CPU and CUDA. On a CUDA device
    the operator also holds ``launch``, the kernel's compact copy of its
    nonzeros and plan (ops/tile_ell_cuda.py ``stage``), made here once;
    ``bucket``: a bucket of a :class:`TileELLStack`, whose one copy spans
    all its buckets, so a bucket stages none and is not applied alone.
    """

    data: torch.Tensor  # (T, K, M), or (T, K, C, M) chunked
    cols: torch.Tensor  # (T, K) int64: scalar index (C == 1) or chunk index
    nrows: int  # logical output rows
    nrows_pad: int  # == T * M
    ncols_pad: int  # padded input vector length (multiple of chunk_c)
    tile_m: int
    chunk_c: int = 1  # column-chunk width gathered per slot
    bucket: bool = False
    launch: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        on_card = self.data.device.type == "cuda" and not self.bucket
        object.__setattr__(self, "launch",
                           tile_ell_cuda.stage(self) if on_card else None)

    def __reduce__(self):
        return _rebuild(self)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        timers.count_tile_ell_matvecs(1)
        return _tile_ell_apply(self, x)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """Gather one column chunk of x per slot, then one (1 x K*C) @
        (K*C x M) product per tile (ngsamg_tpu/sparse/formats.py
        ``_tile_ell_matvec``); the matvec, uncounted."""
        T, K = self.cols.shape
        kc = K * self.chunk_c
        xg = x[:, 0].reshape(-1, self.chunk_c)[self.cols]  # (T, K, C)
        y = torch.bmm(xg.reshape(T, 1, kc),
                      self.data.reshape(T, kc, self.tile_m))
        return y.reshape(-1, 1)


@dataclass(frozen=True)
class TileELLStack:
    """Bucketed TileELL: contiguous tile ranges with per-bucket slot
    counts (rows are pre-permuted so tiles sort by descending column
    union, ``plan_reorder``). On a CUDA device ``launch`` is one compact
    copy over all the buckets, in row order, and the matvec one launch;
    the plain ``product`` concatenates the buckets' products."""

    blocks: tuple  # tuple[TileELL, ...] over contiguous row ranges
    nrows: int
    nrows_pad: int  # == sum(b.nrows_pad)
    ncols_pad: int
    tile_m: int
    launch: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        on_card = self.blocks[0].data.device.type == "cuda"
        object.__setattr__(self, "launch",
                           tile_ell_cuda.stage(self) if on_card else None)

    def __reduce__(self):
        return _rebuild(self)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        timers.count_tile_ell_matvecs(1)
        return _tile_ell_apply(self, x)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The buckets' plain products, concatenated; the matvec,
        uncounted."""
        return torch.cat([b.product(x) for b in self.blocks])


def _tile_ell_apply(A, x: torch.Tensor) -> torch.Tensor:
    """The hand-written kernel for a CUDA tensor (it raises where it
    cannot run: no fallback), the plain product for a CPU one."""
    if x.device.type != "cuda":
        return A.product(x)
    y = tile_ell_cuda.tile_ell_matvec(A, x)
    timers.count_tile_ell_kernel_matvecs(1)
    return y


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
    # K1's launch plan and arguments, made once here (ops/stencil_cuda.py
    # ``stage``)
    launch: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "launch", stencil_cuda.stage(self))

    def __reduce__(self):
        return _rebuild(self)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return stencil_cuda.stencil_matvec(self, x)


def matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for the port's device formats; x: (nrows_pad, bs)."""
    return A.matvec(x)


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


# tile-ELL tile height, column-chunk width and bucket merge bound
# (ngsamg_tpu/sparse/formats.py TILE_CHUNK, _STACK_MIN_TILES): 8-row tiles,
# 8 scalars per gathered slot of a stacked level
TILE_M = 8
TILE_CHUNK = 8
_STACK_MIN_TILES = 512  # merge smaller bucket runs (bounds op count)


def _tile_chunk_counts(C: sp.csr_matrix, chunk: int, T: int):
    """Distinct column-chunk count per tile (tiles = TILE_M-row groups)."""
    cnt = native.tile_chunk_counts(C.indptr, C.indices, TILE_M, chunk, T)
    if cnt is not None:
        return cnt
    n = C.shape[0]
    t_rows = min(T * TILE_M, n)
    nnz_head = int(C.indptr[t_rows])
    rows = np.repeat(
        np.arange(t_rows, dtype=np.int64), np.diff(C.indptr[: t_rows + 1])
    )
    cc = C.indices[:nnz_head].astype(np.int64) // chunk
    stride = C.shape[1] // chunk + 2
    keys = (rows // TILE_M) * stride + cc
    uk = np.unique(keys)
    return np.bincount((uk // stride).astype(np.int64), minlength=T)


def _tile_slots(C: sp.csr_matrix, chunk: int, T: int):
    """Slot assignment of every stored entry of the first T tiles.

    Each tile's distinct column chunks take slots 0, 1, ... in ascending
    chunk order. Returns the entries sorted by (tile, chunk) as
    (tile, chunk, slot, column offset in the chunk, row in the tile,
    value), and the slot count of each tile."""
    nr = C.shape[0]
    t_rows = min(T * TILE_M, nr)
    nnz_head = int(C.indptr[t_rows])
    rows = np.repeat(
        np.arange(t_rows, dtype=np.int64),
        np.diff(C.indptr[: t_rows + 1]),
    )
    cols = C.indices[:nnz_head].astype(np.int64)
    tid = rows // TILE_M
    cc = cols // chunk
    order = np.lexsort((cc, tid))
    tid_s, cc_s = tid[order], cc[order]
    newpair = np.ones(len(order), dtype=bool)
    if len(order) > 1:
        newpair[1:] = (tid_s[1:] != tid_s[:-1]) | (cc_s[1:] != cc_s[:-1])
    gid = np.cumsum(newpair) - 1
    pair_tid = tid_s[newpair]
    tile_first = np.searchsorted(pair_tid, np.arange(T, dtype=np.int64))
    slot_pair = np.arange(len(pair_tid), dtype=np.int64) - tile_first[
        pair_tid
    ]
    return (
        tid_s, cc_s, slot_pair[gid], (cols % chunk)[order],
        (rows % TILE_M)[order], C.data[:nnz_head][order],
        np.bincount(pair_tid, minlength=T),
    )


def _fill_tiles(slots, t0: int, t1: int, K: int, chunk: int, dtype):
    """Dense (data, cols) arrays of tiles [t0, t1) with K slots each;
    padded slots hold column 0 and zero values."""
    tid_s, cc_s, slot, coff, moff, val_s, _cnt = slots
    m = (tid_s >= t0) & (tid_s < t1)
    lt = tid_s[m] - t0
    if chunk > 1:
        data = np.zeros((t1 - t0, K, chunk, TILE_M), dtype=dtype)
        data[lt, slot[m], coff[m], moff[m]] = val_s[m]
    else:
        data = np.zeros((t1 - t0, K, TILE_M), dtype=dtype)
        data[lt, slot[m], moff[m]] = val_s[m]
    cols = np.zeros((t1 - t0, K), dtype=np.int64)
    cols[lt, slot[m]] = cc_s[m]
    return data, cols


def _tile_ell(data, cols, nrows, ncols_pad, chunk, device, bucket=False):
    return TileELL(
        data=_tensor(data, device),
        cols=_tensor(cols, device),
        nrows=nrows,
        nrows_pad=data.shape[0] * TILE_M,
        ncols_pad=ncols_pad,
        tile_m=TILE_M,
        chunk_c=chunk,
        bucket=bucket,
    )


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tile_ell_from_scipy(
    A: sp.spmatrix,
    dtype,
    nr_pad: int | None = None,
    nc_pad: int | None = None,
    device="cpu",
) -> TileELL:
    """Pack a scalar matrix into a plain :class:`TileELL` (chunk 1, one
    slot count K = the largest distinct-column count of any tile).

    Tile t stores its rows' values at the tile's distinct columns in
    ascending order: the native packer (``native.tile_ell_pack``), or its
    numpy copy with ``native.HAVE_NATIVE`` off. ``nr_pad``/``nc_pad`` pin
    the interface sizes for rectangular transfers.
    """
    C = A.tocsr()
    nr, nc = C.shape
    nr_pad = _round_up(nr if nr_pad is None else nr_pad, TILE_M)
    if nc_pad is None:
        nc_pad = _round_up(nc, TILE_M)
    T = nr_pad // TILE_M
    dt = np.dtype(dtype)
    res = native.tile_ell_pack(C, TILE_M, T)
    if res is not None:
        data, cols, _K = res
        data = data.astype(dt, copy=False)
        cols = cols.astype(np.int64)
    else:
        slots = _tile_slots(C, 1, T)
        K = max(int(slots[-1].max(initial=1)), 1)
        data, cols = _fill_tiles(slots, 0, T, K, 1, dt)
    return _tile_ell(data, cols, nr, nc_pad, 1, device)


def _fill_buckets_native(C: sp.csr_matrix, bounds, Ks, dtype):
    """(data, cols) of each bucket of tiles [bounds[b], bounds[b + 1]) with
    Ks[b] slots, filled by ``native.tile_ell_fill_range`` into zeroed
    arrays; None with ``native.HAVE_NATIVE`` off, and (counted as
    declined) for a value type the kernel does not take."""
    if dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return native.declined("tile_ell_fill_range")
    if C.data.dtype != dtype:
        C = sp.csr_matrix(
            (C.data.astype(dtype), C.indices, C.indptr), shape=C.shape
        )
    out = []
    for t0, t1, K in zip(bounds[:-1], bounds[1:], Ks):
        data = np.zeros((t1 - t0, K, TILE_CHUNK, TILE_M), dtype=dtype)
        cols = np.zeros((t1 - t0, K), dtype=np.int32)
        if not native.tile_ell_fill_range(
            C, TILE_M, TILE_CHUNK, t0, t1, K, data, cols
        ):
            return None
        out.append((data, cols.astype(np.int64)))
    return out


def tile_ell_stack_from_scipy(
    A: sp.spmatrix, dtype, device="cpu"
) -> TileELLStack:
    """Pack into bucketed tile-ELL gathering TILE_CHUNK-wide column chunks.

    Callers should pre-sort tiles by descending column-chunk union
    (``plan_reorder``) so bucket runs are contiguous; the packer is correct
    for any order but then buckets at K_max."""
    C = A.tocsr()
    nr, nc = C.shape
    nr_pad = _round_up(nr, TILE_M)
    nc_pad = _round_up(nc, TILE_CHUNK)
    T = nr_pad // TILE_M
    cnt = _tile_chunk_counts(C, TILE_CHUNK, T)
    kmax = int(cnt.max(initial=1))
    # grid of allowed per-bucket widths (geometric, ratio 1.5)
    grid = [max(kmax, 1)]
    while grid[-1] > 4:
        grid.append(max(int(grid[-1] / 1.5), 4))
    grid = np.array(sorted(set(grid)), dtype=np.int64)
    gK = grid[np.searchsorted(grid, np.maximum(cnt, 1), side="left")]
    # contiguous runs of equal gridded K; merge short runs into the
    # previous (wider-K) run so the block count stays O(len(grid))
    bounds = [0]
    Ks = [int(gK[0])]
    for t in range(1, T):
        if gK[t] != Ks[-1]:
            if t - bounds[-1] < _STACK_MIN_TILES and len(bounds) >= 1:
                Ks[-1] = max(Ks[-1], int(gK[t]))  # absorb into current
                continue
            bounds.append(t)
            Ks.append(int(gK[t]))
    bounds.append(T)
    # if a later tile absorbed a LARGER K into a run, per-tile counts may
    # exceed the run's K — recompute each bucket's K as its tiles' max
    Ks = [
        int(max(cnt[bounds[b]: bounds[b + 1]].max(initial=1), 1))
        for b in range(len(bounds) - 1)
    ]
    dt = np.dtype(dtype)
    fills = _fill_buckets_native(C, bounds, Ks, dt)
    if fills is None:
        # global slot assignment (rank of each (tile, chunk) pair within
        # its tile), then one scatter per bucket
        slots = _tile_slots(C, TILE_CHUNK, T)
        fills = [
            _fill_tiles(slots, t0, t1, K, TILE_CHUNK, dt)
            for t0, t1, K in zip(bounds[:-1], bounds[1:], Ks)
        ]
    blocks = []
    for t0, (data, cols) in zip(bounds, fills):
        rows = min(max(nr - t0 * TILE_M, 0), data.shape[0] * TILE_M)
        blocks.append(
            _tile_ell(data, cols, rows, nc_pad, TILE_CHUNK, device,
                      bucket=True)
        )
    return TileELLStack(
        blocks=tuple(blocks),
        nrows=nr,
        nrows_pad=nr_pad,
        ncols_pad=nc_pad,
        tile_m=TILE_M,
    )


def permute(A: sp.spmatrix, rowperm, colperm) -> sp.csr_matrix:
    """``A[rowperm][:, colperm]`` as a CSR (either permutation may be
    None; both map new indices to old): the native ``csr_permute``, or
    scipy's fancy indexing with ``native.HAVE_NATIVE`` off."""
    out = native.csr_permute(A, rowperm, colperm)
    if out is not None:
        return out
    out = A.tocsr()
    if rowperm is not None:
        out = out[rowperm]
    if colperm is not None:
        out = out[:, colperm]
    return out.tocsr()


def plan_reorder(A: sp.spmatrix, bs: int, tile_sort: bool = True):
    """Row order for levels headed to tile-ELL: bandwidth-reducing reverse
    Cuthill-McKee, then FULL TILE_M-row tiles sorted by descending
    TILE_CHUNK column-chunk union, so the bucketed tile-ELL packer gets
    contiguous equal-width runs.

    Tiles only stay narrow if consecutive rows share neighbors; aggregate-
    ordered coarse levels do not. Returns a row permutation, or None for
    levels that will use DIA or dense storage in natural order. The partial
    tail tile stays pinned last (real rows must remain a prefix of every
    bucket's row range). ``tile_sort=False`` (levels the sharded solve
    cuts into row blocks, packed as plain tile-ELL) keeps the RCM order.
    """
    n = A.shape[0] // bs
    if bs != 1 or n <= DENSE_MAX_ROWS:
        return None
    if count_diagonals(A, limit=DIA_MAX_DIAGS) <= DIA_MAX_DIAGS:
        return None  # stencil level: DIA in natural order
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rcm = np.asarray(
        reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True),
        dtype=np.int64,
    )
    Tfull = n // TILE_M
    if Tfull < 2 or not tile_sort:
        return rcm
    cnt = _tile_chunk_counts(permute(A, rcm, rcm), TILE_CHUNK, Tfull)
    order = np.argsort(-cnt, kind="stable")
    head = rcm[: Tfull * TILE_M].reshape(Tfull, TILE_M)[order].ravel()
    return np.concatenate([head, rcm[Tfull * TILE_M:]])


def _te_bytes(te) -> int:
    """Stored bytes of a tile-ELL stack (or plain tile-ELL), counting
    column indices as int32 (the JAX package's layout) so the DIA/tile-ELL
    choice matches it."""
    blocks = te.blocks if isinstance(te, TileELLStack) else (te,)
    return sum(
        b.data.numel() * b.data.element_size() + 4 * b.cols.numel()
        for b in blocks
    )


def choose_format(
    A: sp.spmatrix,
    bs: int,
    dtype,
    row_align: int = 8,
    *,
    device="cpu",
    stack: bool = True,
):
    """Pick the format for one level's matrix.

    Priority, as in the JAX package: DIA for true stencil levels (<= 32
    diagonals); above ``DENSE_MAX_ROWS`` rows, DIA against the bucketed
    tile-ELL by stored bytes (DIA, which gathers nothing, wins up to twice
    the tile-ELL bytes) when the level has at most ``DIA_MAX_DIAGS``
    diagonals, else tile-ELL; small levels DIA (few diagonals) or dense.
    Block (bs > 1) unstructured levels keep their natural block tiles in
    block-ELL. ``stack=False`` packs a plain :class:`TileELL` with its rows
    padded to ``row_align`` in place of the bucketed stack (the JAX
    package's ``stack_chunk=None``: levels the sharded solve cuts).
    """

    def te_pack():
        if stack:
            return tile_ell_stack_from_scipy(A, dtype, device=device)
        m = max(TILE_M, row_align)
        return tile_ell_from_scipy(
            A, dtype, nr_pad=_round_up(A.shape[0], m),
            nc_pad=_round_up(A.shape[1], row_align), device=device,
        )

    n = A.shape[0] // bs
    # DIA wins over dense whenever the level is a stencil and not tiny
    if bs == 1 and n > 512:
        nd = count_diagonals(A, limit=DIA_MAX_DIAGS)
        if nd <= 32:
            # true stencil level: DIA is gather-free at ~1x fill
            return dia_from_scipy(A, dtype, row_align, device=device)
        if n > DENSE_MAX_ROWS:
            te = te_pack()
            if nd <= DIA_MAX_DIAGS:
                n_pad = -(-n // row_align) * row_align
                dia_bytes = nd * n_pad * np.dtype(dtype).itemsize
                if dia_bytes <= 2 * _te_bytes(te):
                    return dia_from_scipy(A, dtype, row_align, device=device)
            return te
        if nd <= DIA_MAX_DIAGS:
            return dia_from_scipy(A, dtype, row_align, device=device)
    if n <= DENSE_MAX_ROWS and (n * bs) ** 2 * 4 <= 512e6:
        return dense_from_scipy(A, bs, dtype, row_align, device=device)
    if bs == 1:
        return te_pack()
    return _bell.from_scipy(
        A, bs, bs, dtype=dtype, row_align=row_align, device=device
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
