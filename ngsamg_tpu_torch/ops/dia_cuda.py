"""K2/K3: the DIA matvecs — CUDA kernel wrappers + plain version.

Replace the Pallas TPU kernels ngsamg_tpu/ops/dia_pallas.py `_dia_kernel`
(full storage, K2) and `_dia_sym_kernel` (symmetric half storage, K3); the
kernels are ``csrc/dia_matvec.cu``. ``A`` is a
:class:`ngsamg_tpu_torch.sparse.formats.DiaMatrix` (duck-typed here:
``data``, ``offsets``, ``nrows_pad``, ``sym_half``, and ``launch``, the
:class:`DiaLaunch` that :func:`stage` made when the level was built: the
offsets on the device and the level's launch plan, a :class:`DiaPlan` for
full storage or a :class:`DiaSymPlan` for symmetric half storage).

K3 gives a block a tile of rows; a thread owns two consecutive rows (so
the aligned plus-direction data is one vector load per diagonal; a level
with an odd padding is refused at staging), starts the loads of ``batch``
diagonals together before it sums them, and reads the shifted terms
through the read-only cache. A level too small to fill the card with one
thread per two rows has its diagonals split over ``groups`` thread groups
of the block, whose partial sums are reduced in shared memory in group
order (no atomics: the same input gives the same bits).
:func:`dia_sym_plan` decides all of this from the level's shape alone, and
the launch refuses a plan that does not match the kernel's layout.

:func:`dia_matvec` launches the kernel for a CUDA tensor (f32, f64 or
bf16) and raises if it cannot; for a CPU tensor it runs
:func:`_dia_matvec_plain`, which sums bf16 in f32 and rounds once, as the
bf16 kernels do. K2 and its plain version run on a window: a block of
rows over a longer x read from an offset. A whole level is the window
(n_pad, n_pad, 0); a rank's rows of a row-sharded level are a
:class:`~ngsamg_tpu_torch.sparse.formats.DiaWindow` (parallel/shard.py),
whose launches are counted apart, as ``dia_window_matvec_*``. The plans
size the partial sums in shared memory by the accumulation type (f32 for
bf16) and x's window by the element size.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import cuda_lib

# kernel launches per entry point (a plain count; see chip_smoke.py)
LAUNCHES = {
    f"{kind}_{sfx}": 0
    for kind in ("dia_matvec", "dia_sym_matvec", "dia_window_matvec")
    for sfx in cuda_lib.DTYPE_SUFFIXES
}

TILE_ROWS = 32  # rows of a K2 block: one per lane (kTileRows in the kernel)
DIAGS_PER_GROUP = 8  # K2: at least this many diagonals per warp ...
MAX_GROUPS = 16  # ... and at most this many warps per block
SMEM_BUDGET = 48 * 1024  # bytes a block gets without an opt-in
OFFSET_BYTES = 8  # the offsets are staged as int64
SYM_ROWS = 2  # K3: consecutive rows of a thread (kSymRows in the kernel)
SYM_THREADS = 256  # K3: threads of a block, over all its groups
SYM_MIN_GROUP_THREADS = 32  # K3: a group is at least one warp
SYM_DIAGS_PER_GROUP = 4  # K3: at least this many diagonals per group
# K3 splits the diagonals until the grid holds this many threads: half of
# what the 132 SMs of an H100 keep resident (2,048 each)
SYM_TARGET_THREADS = 132 * 1024
# K3: diagonals whose loads a thread starts together. A level that streams
# from device memory (one group) runs best with 2, a small level whose
# data stays in the L2 (several groups) with 4; the kernel is built for
# these two
SYM_BATCH_STREAM, SYM_BATCH_SPLIT = 2, 4


def _acc_bytes(itemsize: int) -> int:
    """Bytes of a partial sum: the accumulation type's (f32 for bf16)."""
    return max(itemsize, 4)


@dataclass(frozen=True)
class DiaPlan:
    """K2's launch plan for one level (full storage).

    A block covers ``tile`` rows with ``groups`` warps; warp g sums the
    diagonals [g * per_group, (g + 1) * per_group). On the "smem" path the
    block stages x's window [r0 + lo, r0 + lo + window) in shared memory;
    on the "ldg" path (window 0) it reads x through the read-only cache.
    ``smem_bytes`` is what the kernel's layout takes (offsets, partial
    sums, window); the launch derives the same size from the other fields.
    """

    tile: int
    groups: int
    per_group: int
    window: int
    lo: int
    smem_bytes: int
    path: str
    blocks: int


def dia_plan(offsets, n_pad: int, itemsize: int) -> DiaPlan:
    """K2's plan from the level's shape alone (offsets ascending). Raises
    if even the offsets and partial sums overflow the shared-memory budget
    (about 5,600 diagonals)."""
    ndiag = len(offsets)
    groups = min(MAX_GROUPS, max(1, -(-ndiag // DIAGS_PER_GROUP)))
    per_group = -(-ndiag // groups)
    groups = max(1, -(-ndiag // per_group)) if per_group else 1
    lo = min(int(offsets[0]), 0) if ndiag else 0
    hi = max(int(offsets[-1]), 0) if ndiag else 0
    base = ndiag * OFFSET_BYTES + groups * TILE_ROWS * _acc_bytes(itemsize)
    if base > SMEM_BUDGET:
        raise ValueError(
            f"dia_matvec: {ndiag} diagonals need {base} B of shared memory "
            f"for K2's offsets and partial sums (budget {SMEM_BUDGET} B)"
        )
    window = TILE_ROWS + hi - lo
    if base + window * itemsize <= SMEM_BUDGET:
        path, smem = "smem", base + window * itemsize
    else:
        path, smem, window = "ldg", base, 0
    return DiaPlan(
        tile=TILE_ROWS, groups=groups, per_group=per_group, window=window,
        lo=lo, smem_bytes=smem, path=path,
        blocks=-(-n_pad // TILE_ROWS),
    )


@dataclass(frozen=True)
class DiaSymPlan:
    """K3's launch plan for one level (symmetric half storage).

    A block covers ``tile = tpg * SYM_ROWS`` rows with ``groups`` groups
    of ``tpg`` threads; a thread owns ``SYM_ROWS`` consecutive rows and
    loads ``batch`` diagonals at a time, and group g sums the diagonals
    [g * per_group, (g + 1) * per_group). ``reach`` is the largest offset:
    a tile at least that far inside [0, n_pad) skips the bounds tests.
    ``smem_bytes`` is what the kernel's layout takes (partial sums when
    groups > 1, then the offsets). The launch takes the whole plan, checks
    it against the kernel's layout and launches ``blocks`` blocks with
    ``smem_bytes`` of shared memory.
    """

    batch: int
    tpg: int
    groups: int
    per_group: int
    tile: int
    reach: int
    smem_bytes: int
    blocks: int

    @property
    def variant(self) -> str:
        return f"tile-r{SYM_ROWS}-u{self.batch}-g{self.groups}"


def dia_sym_plan(offsets, n_pad: int, itemsize: int) -> DiaSymPlan:
    """K3's plan from the level's shape alone (offsets >= 0, ascending).
    Raises if the padded row count is odd (a thread owns two rows; the
    levels' padding is a multiple of 8), or if the offsets and partial
    sums overflow the shared-memory budget (about 6,000 diagonals)."""
    ndiag = len(offsets)
    if n_pad % SYM_ROWS:
        raise ValueError(
            f"dia_matvec: sym_half needs nrows_pad a multiple of {SYM_ROWS} "
            f"for K3, got {n_pad}"
        )
    row_threads = n_pad // SYM_ROWS
    groups = 1
    while (groups * 2 * SYM_DIAGS_PER_GROUP <= ndiag
           and groups * 2 * SYM_MIN_GROUP_THREADS <= SYM_THREADS
           and row_threads * groups < SYM_TARGET_THREADS):
        groups *= 2
    per_group = -(-ndiag // groups) if ndiag else 0
    tpg = SYM_THREADS // groups
    tile = tpg * SYM_ROWS
    smem = ndiag * OFFSET_BYTES + (groups * tile * _acc_bytes(itemsize)
                                   if groups > 1 else 0)
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"dia_matvec: {ndiag} diagonals need {smem} B of shared memory "
            f"for K3's offsets and partial sums (budget {SMEM_BUDGET} B)"
        )
    return DiaSymPlan(
        batch=SYM_BATCH_SPLIT if groups > 1 else SYM_BATCH_STREAM,
        tpg=tpg, groups=groups, per_group=per_group,
        tile=tile, reach=max(int(offsets[-1]), 0) if ndiag else 0,
        smem_bytes=smem, blocks=-(-n_pad // tile),
    )


@dataclass(frozen=True)
class DiaLaunch:
    """What a launch needs, made once per staged level: the offsets on the
    level's device and the plan (K2's for full storage, K3's for symmetric
    half storage)."""

    offs: torch.Tensor  # (ndiag,) int64
    plan: DiaPlan | DiaSymPlan


def _window(A) -> tuple[int, int, int]:
    """(rows, x_len, x_base) of a full-storage matrix: a DiaWindow's own
    (a rank's row block over a longer x), a DiaMatrix's (n_pad, n_pad, 0)."""
    if hasattr(A, "x_base"):
        return A.nrows, A.x_len, A.x_base
    return A.nrows_pad, A.nrows_pad, 0


def stage(A) -> DiaLaunch:
    offsets = tuple(int(o) for o in A.offsets)
    sym = getattr(A, "sym_half", False)
    if sym and min(offsets, default=0) < 0:
        raise ValueError("dia_matvec: sym_half stores offsets >= 0 only")
    offs = torch.tensor(offsets, dtype=torch.int64, device=A.data.device)
    if sym:
        plan = dia_sym_plan(offsets, A.nrows_pad, A.data.element_size())
    else:
        plan = dia_plan(offsets, _window(A)[0], A.data.element_size())
    return DiaLaunch(offs=offs, plan=plan)


def _dia_matvec_plain(A, x: torch.Tensor) -> torch.Tensor:
    """Shift-and-FMA form (ngsamg_tpu/sparse/formats.py `_dia_matvec_xla`),
    summed in the kernels' accumulation type and rounded once. Full
    storage reads the window: y[i] = sum_d data[d, i] * x[x_base + i +
    off_d], x zero outside [0, x_len)."""
    acc = cuda_lib.acc_dtype(x.dtype)
    data = A.data.to(acc)
    xf = x[:, 0].to(acc)
    if getattr(A, "sym_half", False):
        n = A.nrows_pad
        hi = max(A.offsets[-1], 0)
        xp = F.pad(xf, (hi, hi))
        y = torch.zeros_like(xf)
        for d, off in enumerate(A.offsets):
            y = y + data[d] * xp[hi + off: hi + off + n]
            if off > 0:
                # A[i, i-o] = data[o][i-o]; the zero pad of the shifted
                # data supplies the i < o mask
                dp = F.pad(data[d], (hi, hi))
                y = y + dp[hi - off: hi - off + n] * xp[hi - off: hi - off + n]
        return y.to(x.dtype)[:, None]
    n, x_len, x_base = _window(A)
    first = x_base + min(A.offsets, default=0)
    last = x_base + max(A.offsets, default=0) + n
    left, right = max(0, -first), max(0, last - x_len)
    xp = F.pad(xf[:x_len], (left, right))
    y = torch.zeros(n, dtype=acc, device=x.device)
    for d, off in enumerate(A.offsets):
        s = left + x_base + off
        y = y + data[d] * xp[s: s + n]
    return y.to(x.dtype)[:, None]


def dia_matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DiaMatrix (full or sym_half; x: (nrows_pad, 1)) or
    a DiaWindow (x: (x_len, 1); y: (nrows, 1))."""
    if x.device.type == "cpu":
        return _dia_matvec_plain(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_matvec: unsupported device {x.device}")
    sfx = cuda_lib.suffix(x.dtype)  # raises for a dtype without a kernel
    if A.data.dtype != x.dtype or A.data.device != x.device:
        raise ValueError(
            f"dia_matvec: data {A.data.dtype}@{A.data.device} vs "
            f"x {x.dtype}@{x.device}"
        )
    sym = getattr(A, "sym_half", False)
    n, x_len, x_base = (A.nrows_pad, A.nrows_pad, 0) if sym else _window(A)
    ndiag = len(A.offsets)
    if A.data.shape != (ndiag, n) or not A.data.is_contiguous():
        raise ValueError(
            f"dia_matvec: data must be contiguous ({ndiag}, {n}), "
            f"got {tuple(A.data.shape)}"
        )
    if x.shape != (x_len, 1) or not x.is_contiguous():
        raise ValueError(
            f"dia_matvec: x must be contiguous ({x_len}, 1), "
            f"got {tuple(x.shape)}"
        )
    launch = A.launch
    y = x.new_empty((n, 1))
    if sym:
        kind = entry = "dia_sym_matvec"
    else:
        entry = "dia_matvec"
        kind = "dia_window_matvec" if hasattr(A, "x_base") else entry
    sym_name = f"ngsamg_{entry}_{sfx}"
    fn = getattr(cuda_lib.library(), sym_name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p = launch.plan
    if sym:
        rc = fn(A.data.data_ptr(), launch.offs.data_ptr(), ndiag, n,
                p.batch, p.tpg, p.groups, p.per_group, p.tile, p.reach,
                p.smem_bytes, p.blocks, x.data_ptr(), y.data_ptr(), stream)
    else:
        rc = fn(A.data.data_ptr(), launch.offs.data_ptr(), ndiag, n, x_len,
                x_base, p.groups, p.per_group, p.window, p.lo, x.data_ptr(),
                y.data_ptr(), stream)
    cuda_lib.check(rc, sym_name)
    LAUNCHES[f"{kind}_{sfx}"] += 1
    return y
