"""K2/K3: the DIA matvecs — CUDA kernel wrappers + plain version.

Replace the Pallas TPU kernels ngsamg_tpu/ops/dia_pallas.py `_dia_kernel`
(full storage, K2) and `_dia_sym_kernel` (symmetric half storage, K3); the
kernels are ``csrc/dia_matvec.cu``. ``A`` is a
:class:`ngsamg_tpu_torch.sparse.formats.DiaMatrix` (duck-typed here:
``data``, ``offsets``, ``nrows_pad``, ``sym_half``, and ``launch``, the
:class:`DiaLaunch` that :func:`stage` made when the level was built).

:func:`dia_matvec` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs :func:`_dia_matvec_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import cuda_lib

# kernel launches per entry point (a plain count; see chip_smoke.py)
LAUNCHES = {
    "dia_matvec_f32": 0,
    "dia_matvec_f64": 0,
    "dia_sym_matvec_f32": 0,
    "dia_sym_matvec_f64": 0,
}

TILE_ROWS = 32  # rows of a K2 block: one per lane (kTileRows in the kernel)
DIAGS_PER_GROUP = 8  # K2: at least this many diagonals per warp ...
MAX_GROUPS = 16  # ... and at most this many warps per block
SMEM_BUDGET = 48 * 1024  # bytes a block gets without an opt-in
OFFSET_BYTES = 8  # the offsets are staged as int64


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
    base = ndiag * OFFSET_BYTES + groups * TILE_ROWS * itemsize
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
class DiaLaunch:
    """What a launch needs, made once per staged level: the offsets on the
    level's device and, for full storage, K2's plan."""

    offs: torch.Tensor  # (ndiag,) int64
    plan: DiaPlan | None  # None for sym_half (K3: one thread per row)


def stage(A) -> DiaLaunch:
    offsets = tuple(int(o) for o in A.offsets)
    if A.sym_half and min(offsets, default=0) < 0:
        raise ValueError("dia_matvec: sym_half stores offsets >= 0 only")
    offs = torch.tensor(offsets, dtype=torch.int64, device=A.data.device)
    plan = None if A.sym_half else dia_plan(
        offsets, A.nrows_pad, A.data.element_size()
    )
    return DiaLaunch(offs=offs, plan=plan)


def _dia_matvec_plain(A, x: torch.Tensor) -> torch.Tensor:
    """Shift-and-FMA form (ngsamg_tpu/sparse/formats.py `_dia_matvec_xla`)."""
    n = A.nrows_pad
    xf = x[:, 0]
    if A.sym_half:
        hi = max(A.offsets[-1], 0)
        xp = F.pad(xf, (hi, hi))
        y = torch.zeros_like(xf)
        for d, off in enumerate(A.offsets):
            y = y + A.data[d] * xp[hi + off: hi + off + n]
            if off > 0:
                # A[i, i-o] = data[o][i-o]; the zero pad of the shifted
                # data supplies the i < o mask
                dp = F.pad(A.data[d], (hi, hi))
                y = y + dp[hi - off: hi - off + n] * xp[hi - off: hi - off + n]
        return y[:, None]
    lo = -min(A.offsets[0], 0)
    hi = max(A.offsets[-1], 0)
    xp = F.pad(xf, (lo, hi))
    y = torch.zeros_like(xf)
    for d, off in enumerate(A.offsets):
        y = y + A.data[d] * xp[lo + off: lo + off + n]
    return y[:, None]


def dia_matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DiaMatrix (full or sym_half); x: (nrows_pad, 1)."""
    if x.device.type == "cpu":
        return _dia_matvec_plain(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_matvec: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_matvec: dtype {x.dtype} (f32/f64 only)")
    if A.data.dtype != x.dtype or A.data.device != x.device:
        raise ValueError(
            f"dia_matvec: data {A.data.dtype}@{A.data.device} vs "
            f"x {x.dtype}@{x.device}"
        )
    ndiag = len(A.offsets)
    if A.data.shape != (ndiag, A.nrows_pad) or not A.data.is_contiguous():
        raise ValueError(
            f"dia_matvec: data must be contiguous ({ndiag}, {A.nrows_pad}), "
            f"got {tuple(A.data.shape)}"
        )
    if x.shape != (A.nrows_pad, 1) or not x.is_contiguous():
        raise ValueError(
            f"dia_matvec: x must be contiguous ({A.nrows_pad}, 1), "
            f"got {tuple(x.shape)}"
        )
    launch = A.launch
    y = torch.empty_like(x)
    key = ("dia_sym_matvec" if A.sym_half else "dia_matvec") + (
        "_f32" if x.dtype == torch.float32 else "_f64"
    )
    sym = f"ngsamg_{key}"
    fn = getattr(cuda_lib.library(), sym)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if A.sym_half:
        rc = fn(A.data.data_ptr(), launch.offs.data_ptr(), ndiag, A.nrows_pad,
                x.data_ptr(), y.data_ptr(), stream)
    else:
        p = launch.plan
        rc = fn(A.data.data_ptr(), launch.offs.data_ptr(), ndiag, A.nrows_pad,
                p.groups, p.per_group, p.window, p.lo, x.data_ptr(),
                y.data_ptr(), stream)
    cuda_lib.check(rc, sym)
    LAUNCHES[key] += 1
    return y
