"""The block-ELL matvec: CUDA kernel wrapper and launch plan.

It replaces no TPU kernel: the JAX package computes ``bell.spmv`` in XLA (a
gather and an einsum). The kernel is ``csrc/bell_matvec.cu``; ``A`` is a
:class:`ngsamg_tpu_torch.sparse.bell.BlockELL` (duck-typed here: ``data``
(n, K, br, bcw), ``cols`` (n, K) int32, ``nslots`` (n,) int32 or None,
``ncols``, ``col_chunk`` and ``launch``, the :class:`BellPlan` that
:func:`stage` made when the operator was built).

A block row is owned by ``lanes`` threads of a warp, or by ``warps`` whole
warps for a level with too few rows to fill the card; its threads take its
slots in turn up to the row's count of real slots, so the padding is never
read. :func:`bell_plan` decides this from the operator's shape alone: the
stored slots a row (K) and the row count. The launch refuses a plan that
does not match the kernel's layout.

:func:`bell_matvec` launches the kernel for a CUDA tensor (f32, f64 or
bf16) and raises if it cannot. Its checks come before the library is
loaded. The plain version, for CPU tensors, is ``bell.spmv``'s
``rows_product`` path, and the kernel sums as it does: in the tensor's
type, bf16 in f32 from products rounded to bf16, rounded once at the end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import cuda_lib

# kernel launches per dtype suffix (a plain count; see chip_smoke.py)
LAUNCHES = {f"bell_matvec_{sfx}": 0 for sfx in cuda_lib.DTYPE_SUFFIXES}

THREADS = 256  # threads of a block (kThreads in the kernel)
WARP = 32
MAX_WARPS = THREADS // WARP  # warps of one row at most
# a row takes the power of two nearest K / 4 lanes, at least 4 (or K):
# the sweep of every plan on elasticity3d_36's levels (PERF.md section 6)
# found 8 lanes best at K = 37, 4 at K = 4 (1 lane read the 3x6 transfer
# at 2.3 times the time: neighbouring lanes 288 bytes apart), 16-32 at
# K = 88-100 and 32 at K = 144
SLOTS_PER_LANE = 4
MIN_LANES = 4
# a level with fewer threads than this in its grid (a quarter of the
# 1,024 a 132-SM card keeps resident on each SM) gets more lanes, then
# more warps, a row, up to about one thread a stored slot: 198 rows of
# K = 80 ran in 4.0 us on 4 warps a row against 5.5 on one, 2,560 rows
# of K = 144 in 12.9 on one against 13.7 on two
TARGET_THREADS = 132 * 256
STAGED_WIDTHS = (1, 2, 3, 6)  # br and bcw the kernel is built for


@dataclass(frozen=True)
class BellPlan:
    """The launch of one operator: ``lanes`` threads of a warp a row (a
    power of two up to 32), ``warps`` warps a row (more than one only
    with 32 lanes and a staged shape), ``THREADS // (lanes * warps)`` rows
    a block and ``blocks`` blocks. ``staged``: (br, bcw) has a kernel of its
    own; any other shape runs the generic kernel."""

    lanes: int
    warps: int
    blocks: int
    staged: bool

    @property
    def variant(self) -> str:
        kind = "" if self.staged else "-generic"
        return f"l{self.lanes}-w{self.warps}{kind}"


def _pow2_nearest(v: float) -> int:
    """The power of two nearest v on a log scale (1 for v <= 1)."""
    return 1 << max(0, round(math.log2(v))) if v > 1 else 1


def bell_plan(K: int, br: int, bcw: int, n_rows: int, lanes: int | None = None,
              warps: int | None = None) -> BellPlan:
    """The plan from the shape alone: the power of two nearest
    K / SLOTS_PER_LANE lanes a row, at least MIN_LANES (or K's power of
    two) and at most a warp; then, while the grid holds fewer than
    TARGET_THREADS threads and the row's threads fewer than its K slots,
    twice the lanes (up to a warp) and then twice the warps (up to the
    block). ``lanes`` and ``warps`` force a plan (to time others); raises
    for one the kernel does not take."""
    staged = br in STAGED_WIDTHS and bcw in STAGED_WIDTHS
    if lanes is None:
        floor = min(MIN_LANES, 1 << (max(K, 1) - 1).bit_length())
        lanes = min(WARP, max(floor, _pow2_nearest(K / SLOTS_PER_LANE)))
        while lanes < WARP and lanes < K and n_rows * lanes < TARGET_THREADS:
            lanes *= 2
    if warps is None:
        warps = 1
        while (staged and lanes == WARP and warps < MAX_WARPS
               and WARP * warps < K
               and n_rows * WARP * warps < TARGET_THREADS):
            warps *= 2
    if lanes < 1 or lanes > WARP or lanes & (lanes - 1):
        raise ValueError(f"bell_matvec: lanes {lanes} is not a power of two "
                         f"up to {WARP}")
    if warps != 1 and not (staged and lanes == WARP and warps <= MAX_WARPS
                           and not warps & (warps - 1)):
        raise ValueError(f"bell_matvec: {warps} warps a row need 32 lanes, "
                         f"a staged shape and a power of two up to "
                         f"{MAX_WARPS}")
    rows = THREADS // (lanes * warps)
    return BellPlan(lanes=lanes, warps=warps, blocks=-(-n_rows // rows),
                    staged=staged)


def stage(A) -> BellPlan:
    n, K, br, bcw = A.data.shape
    return bell_plan(K, br, bcw, n)


def _load_bytes(n: int, itemsize: int) -> int:
    """The widest aligned load of n values (LoadBytes in the kernel)."""
    total = n * itemsize
    for b in (16, 8, 4):
        if total % b == 0:
            return b
    return itemsize


def bell_matvec(A, x: torch.Tensor, plan: BellPlan | None = None):
    """y = A @ x, x: (rows, bc) with rows a multiple of col_chunk, at
    least ncols rounded up to it; y: (nrows_pad, br). ``plan`` replaces
    the operator's own (to time another)."""
    data, cols, ns = A.data, A.cols, A.nslots
    if data.dim() != 4:
        raise ValueError(f"bell_matvec: data must be (n, K, br, bcw), got "
                         f"{tuple(data.shape)}")
    n, K, br, bcw = data.shape
    sfx = cuda_lib.suffix(data.dtype)  # raises for a dtype without a kernel
    if x.dtype != data.dtype:
        raise ValueError(f"bell_matvec: data {data.dtype} vs x {x.dtype}")
    if not data.is_contiguous():
        raise ValueError("bell_matvec: data must be contiguous")
    if (cols.dtype != torch.int32 or tuple(cols.shape) != (n, K)
            or not cols.is_contiguous()):
        raise ValueError(f"bell_matvec: cols must be contiguous int32 "
                         f"({n}, {K}), got {cols.dtype} {tuple(cols.shape)}")
    if ns is not None and (ns.dtype != torch.int32
                           or tuple(ns.shape) != (n,)
                           or not ns.is_contiguous()):
        raise ValueError(f"bell_matvec: nslots must be contiguous int32 "
                         f"({n},), got {ns.dtype} {tuple(ns.shape)}")
    C = A.col_chunk
    bc = bcw // C
    need = -(-A.ncols // C) * C
    if (x.dim() != 2 or x.shape[1] != bc or x.shape[0] % C
            or x.shape[0] < need or not x.is_contiguous()):
        raise ValueError(
            f"bell_matvec: x must be contiguous (rows, {bc}) with rows a "
            f"multiple of {C} and at least {need}, got {tuple(x.shape)}"
        )
    devices = {t.device for t in (data, cols, x) + ((ns,) if ns is not None
                                                     else ())}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"bell_matvec: tensors on {sorted(map(str, devices))}"
                         f", the kernel takes one CUDA device")
    plan = A.launch if plan is None else plan
    if plan.staged:
        item = data.element_size()
        if (data.data_ptr() % _load_bytes(br * bcw, item)
                or x.data_ptr() % _load_bytes(bcw, item)):
            raise ValueError("bell_matvec: data or x misaligned for the "
                             "kernel's vector loads")
    y = torch.empty((n, br), dtype=x.dtype, device=x.device)
    name = f"ngsamg_bell_matvec_{sfx}"
    fn = getattr(cuda_lib.library(), name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(data.data_ptr(), cols.data_ptr(),
            None if ns is None else ns.data_ptr(), K, br, bcw, n,
            plan.lanes, plan.warps, plan.blocks, x.data_ptr(), y.data_ptr(),
            stream)
    cuda_lib.check(rc, name)
    LAUNCHES[f"bell_matvec_{sfx}"] += 1
    return y
