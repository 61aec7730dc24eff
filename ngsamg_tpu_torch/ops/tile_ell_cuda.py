"""The tile-ELL matvec: compact copy, launch plan and CUDA kernel wrapper.

It replaces no TPU kernel: the JAX package computes the tile-ELL matvec in
XLA (``ngsamg_tpu/sparse/formats.py::_tile_ell_matvec``, a gather of x
chunks and an einsum over dense 8-row tiles). The kernel is
``csrc/tile_ell_matvec.cu``; ``op`` is a ``TileELL`` or a ``TileELLStack``
(sparse/formats.py; duck-typed here: ``nrows_pad``, ``ncols_pad`` and
either ``blocks`` or the fields of one bucket, ``data`` (T, K, M) or
(T, K, C, M), ``cols`` (T, K), ``tile_m``, ``chunk_c``), and ``op.launch``
the :class:`TileEllLaunch` that :func:`stage` made when it was built.

The matvec is bound by the bytes of the values and their 32-bit columns:
two operations for each (8 bytes in f32), x a few MB in the L2. The dense
tiles of the format are ~5.6% full on an unstructured level, so the kernel
never reads them. :func:`stage` makes a compact copy of the nonzeros once,
in plain torch on the operator's own device, from its ``data`` and
``cols`` (not from a host matrix, so every constructor gets the same
copy): for each tile of 8 rows, each row's nonzeros (structural zeros
dropped) in column order as a 32-bit column and a value of the
operator's dtype, slot-major (the j-th nonzeros of the tile's 8 rows side
by side), padded to the tile's longest row; the start of each tile and
the count of each row. The kernel reads a row's nonzeros up to its count,
so each stored value is read once and no padding at all. A stack gets one
copy over all its buckets, in row order: one launch a matvec.

:func:`tile_ell_plan` picks the launch from the operator's shape alone
(its stored nonzeros a row, mean and longest, and its row count):
``lanes`` threads a row and ``threads`` a block. The launch refuses a plan
that does not match the kernel's layout.

:func:`tile_ell_matvec` launches the kernel for a CUDA tensor (f32, f64
or bf16) and raises if it cannot; its checks come before the library is
loaded. The plain version, for CPU tensors, is ``TileELL.product``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import cuda_lib

# kernel launches per dtype suffix (a plain count; see chip_smoke.py)
LAUNCHES = {f"tile_ell_matvec_{sfx}": 0 for sfx in cuda_lib.DTYPE_SUFFIXES}

TILE = 8  # rows of a tile (kTile in the kernel; the format's TILE_M)
MAX_LANES = 32
BLOCK_THREADS = (64, 128, 256)  # threads of a block the kernel takes
# a row takes the power of two nearest the square root of its mean count
# of nonzeros in lanes, and a block the fewest threads that hold a tile
# (at least 64): the sweep of every plan on unstructured_poisson_55's
# operators on an H100 (PERF.md section 6) found 4 lanes best for level
# 0 (15 a row: 128.8 us after an L2 sweep against 132.3 on 2 lanes and
# 165 on 1), 2 for the transfers' rows of 4 (42.5 against 49.3-52.3 on
# 1), 8 for 60 and 125 a row, 16 for 180, and 64-thread blocks 1-4% ahead
# of 256 where they hold a tile
# a level with fewer threads than this in its grid (a quarter of the
# 1,024 a 132-SM card keeps resident on each SM) gets more lanes a row,
# up to its longest row: 4,009 rows of 15 ran in 7.9 us on 16 lanes
# against 9.1-9.3 on 4
TARGET_THREADS = 132 * 256
# stored slots (values of the dense tiles) one step of staging reads
STAGE_SLOTS = 1 << 24


@dataclass(frozen=True)
class TileEllPlan:
    """The launch of one operator: ``lanes`` threads a row (a power of two
    up to 32), ``threads`` a block (64, 128 or 256, at least a tile's
    ``8 * lanes``) and ``blocks`` blocks over ``n_tiles`` tiles."""

    lanes: int
    threads: int
    blocks: int

    @property
    def variant(self) -> str:
        return f"l{self.lanes}-t{self.threads}"


@dataclass(frozen=True)
class TileEllLaunch:
    """The compact copy of an operator's nonzeros and its plan.

    ``vals`` (E,) and ``cols`` (E,) int32: tile t's entries are
    ``[tile_ptr[t], tile_ptr[t + 1])``, row ``8 t + m``'s j-th nonzero at
    ``tile_ptr[t] + 8 j + m``; ``counts`` (nrows_pad,) int32, the row's
    nonzeros; ``tile_ptr`` (n_tiles + 1,) int64. ``nnz``, ``longest`` and
    ``mean``: the nonzeros, those of the longest row and the mean a row."""

    vals: torch.Tensor
    cols: torch.Tensor
    tile_ptr: torch.Tensor
    counts: torch.Tensor
    nnz: int
    longest: int
    mean: float
    plan: TileEllPlan

    @property
    def n_tiles(self) -> int:
        return self.tile_ptr.numel() - 1


def _pow2_nearest(v: float) -> int:
    """The power of two nearest v on a log scale (1 for v <= 1)."""
    return 1 << max(0, round(math.log2(v))) if v > 1 else 1


def tile_ell_plan(n_tiles: int, mean: float, longest: int,
                  lanes: int | None = None,
                  threads: int | None = None) -> TileEllPlan:
    """The plan from the shape alone: the power of two nearest the square
    root of the mean nonzeros a row in lanes, at most 32; while the grid
    holds fewer than TARGET_THREADS threads and a row's lanes fewer than
    its longest row, twice the lanes. Then the fewest threads a block that
    hold a tile's 8 * lanes, at least 64. ``lanes`` and ``threads`` force
    a plan (to time others); raises for one the kernel does not take."""
    if lanes is None:
        lanes = min(MAX_LANES, _pow2_nearest(math.sqrt(max(mean, 0.0))))
        while (lanes < MAX_LANES and lanes < longest
               and n_tiles * TILE * lanes < TARGET_THREADS):
            lanes *= 2
    if lanes < 1 or lanes > MAX_LANES or lanes & (lanes - 1):
        raise ValueError(f"tile_ell_matvec: lanes {lanes} is not a power of "
                         f"two up to {MAX_LANES}")
    if threads is None:
        threads = max(BLOCK_THREADS[0], TILE * lanes)
    if threads not in BLOCK_THREADS or threads < TILE * lanes:
        raise ValueError(f"tile_ell_matvec: {threads} threads a block: the "
                         f"kernel takes {BLOCK_THREADS}, at least "
                         f"{TILE * lanes} for {lanes} lanes")
    per_block = threads // (TILE * lanes)
    return TileEllPlan(lanes=lanes, threads=threads,
                       blocks=-(-n_tiles // per_block))


def _buckets(op) -> tuple:
    return tuple(op.blocks) if hasattr(op, "blocks") else (op,)


def _slots(b):
    """A bucket's values as (T, K * C, M) and the scalar column of each of
    its K * C slots as a function of (tiles, slots)."""
    T, K = b.cols.shape
    C, M = int(b.chunk_c), int(b.tile_m)
    if b.data.shape[0] != T or b.data.numel() != T * K * C * M \
            or T * M != b.nrows_pad:
        raise ValueError(
            f"tile_ell stage: data {tuple(b.data.shape)}, cols "
            f"{tuple(b.cols.shape)}, {b.nrows_pad} rows do not make "
            f"{M}-row tiles of {K} slots of {C} columns")
    vals = b.data.reshape(T, K * C, M)

    def column(t, s):
        return b.cols[t, s // C] * C + s % C

    return vals, column


def _steps(T: int, width: int):
    step = max(1, STAGE_SLOTS // max(width, 1))
    return [(t0, min(t0 + step, T)) for t0 in range(0, T, step)]


def stage(op) -> TileEllLaunch:
    """The compact copy of ``op``'s nonzeros on its own device, and its
    plan. Two passes over the dense tiles, a step of at most STAGE_SLOTS
    slots at a time: the count of each row, then each nonzero's place
    (its row's tile start + 8 x its rank in the row + its row in the
    tile). Raises for an operator the kernel does not take."""
    bks = _buckets(op)
    dtype, dev = bks[0].data.dtype, bks[0].data.device
    if any(b.data.dtype != dtype or b.data.device != dev for b in bks):
        raise ValueError("tile_ell stage: the buckets differ in dtype or "
                         "device")
    n_pad = int(op.nrows_pad)
    if n_pad % TILE or int(op.ncols_pad) >= 2**31:
        raise ValueError(f"tile_ell stage: {n_pad} rows are not whole "
                         f"{TILE}-row tiles, or {op.ncols_pad} columns "
                         f"overflow a 32-bit index")
    counts = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    r0 = 0
    for b in bks:
        vals, _ = _slots(b)
        T, S, M = vals.shape
        if r0 + T * M > n_pad:
            raise ValueError(f"tile_ell stage: buckets hold more than "
                             f"{n_pad} rows")
        for t0, t1 in _steps(T, S * M):
            counts[r0 + t0 * M: r0 + t1 * M] = (
                vals[t0:t1] != 0).sum(1, dtype=torch.int32).reshape(-1)
        r0 += T * M
    if r0 != n_pad:
        raise ValueError(f"tile_ell stage: buckets hold {r0} rows, not "
                         f"{n_pad}")
    lengths = counts.view(-1, TILE).amax(1).to(torch.int64)
    tile_ptr = torch.zeros(lengths.numel() + 1, dtype=torch.int64,
                           device=dev)
    torch.cumsum(lengths * TILE, 0, out=tile_ptr[1:])
    size = int(tile_ptr[-1])
    out_vals = torch.zeros(size, dtype=dtype, device=dev)
    out_cols = torch.zeros(size, dtype=torch.int32, device=dev)
    r0 = 0
    for b in bks:
        vals, column = _slots(b)
        T, S, M = vals.shape
        for t0, t1 in _steps(T, S * M):
            v = vals[t0:t1]
            nz = v != 0
            rank = nz.cumsum(1, dtype=torch.int32)  # 1 for a row's first
            tl, s, m = nz.nonzero(as_tuple=True)
            row = r0 + (t0 + tl) * M + m
            dest = (tile_ptr[row // TILE] + row % TILE
                    + (rank[tl, s, m].to(torch.int64) - 1) * TILE)
            out_vals[dest] = v[tl, s, m]
            out_cols[dest] = column(t0 + tl, s).to(torch.int32)
        r0 += T * M
    if size and int(out_cols.max()) >= int(op.ncols_pad):
        raise ValueError(f"tile_ell stage: a column past {op.ncols_pad}")
    nnz = int(counts.sum())
    longest = int(lengths.max()) if lengths.numel() else 0
    mean = nnz / max(int(op.nrows), 1)
    return TileEllLaunch(
        vals=out_vals, cols=out_cols, tile_ptr=tile_ptr, counts=counts,
        nnz=nnz, longest=longest, mean=mean,
        plan=tile_ell_plan(lengths.numel(), mean, longest))


def tile_ell_matvec(op, x: torch.Tensor,
                    plan: TileEllPlan | None = None) -> torch.Tensor:
    """y = A x, x: (rows, 1) with rows at least ``op.ncols_pad``; y:
    (nrows_pad, 1). ``plan`` replaces the operator's own (to time
    another)."""
    L = getattr(op, "launch", None)
    if L is None:
        raise ValueError("tile_ell_matvec: the operator has no compact copy "
                         "(built off the card, or a bucket of a stack)")
    sfx = cuda_lib.suffix(L.vals.dtype)  # raises for a dtype without a kernel
    if x.dtype != L.vals.dtype:
        raise ValueError(f"tile_ell_matvec: operator {L.vals.dtype} vs x "
                         f"{x.dtype}")
    if (x.dim() != 2 or x.shape[1] != 1 or x.shape[0] < op.ncols_pad
            or not x.is_contiguous()):
        raise ValueError(f"tile_ell_matvec: x must be contiguous (rows, 1) "
                         f"with rows at least {op.ncols_pad}, got "
                         f"{tuple(x.shape)}")
    if L.counts.numel() != op.nrows_pad:
        raise ValueError(f"tile_ell_matvec: the copy has {L.counts.numel()} "
                         f"rows, the operator {op.nrows_pad}")
    # stage makes the copy's tensors on one device
    if x.device.type != "cuda" or x.device != L.vals.device:
        raise ValueError(f"tile_ell_matvec: x on {x.device}, the copy on "
                         f"{L.vals.device}: the kernel takes one CUDA "
                         f"device")
    plan = L.plan if plan is None else plan
    y = torch.empty((op.nrows_pad, 1), dtype=x.dtype, device=x.device)
    name = f"ngsamg_tile_ell_matvec_{sfx}"
    fn = getattr(cuda_lib.library(), name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(L.vals.data_ptr(), L.cols.data_ptr(), L.tile_ptr.data_ptr(),
            L.counts.data_ptr(), L.n_tiles, plan.lanes, plan.threads,
            plan.blocks, x.data_ptr(), y.data_ptr(), stream)
    cuda_lib.check(rc, name)
    LAUNCHES[f"tile_ell_matvec_{sfx}"] += 1
    return y
