"""K1: the uniform-stencil matvec — CUDA kernel wrappers + plain version.

Replaces the Pallas TPU kernel ngsamg_tpu/ops/stencil_pallas.py
`_stencil_kernel`; the kernels are ``csrc/stencil_matvec.cu``. ``A`` is a
:class:`ngsamg_tpu_torch.sparse.formats.StencilDia` (duck-typed here:
``vals``, ``offs``, ``dims``, ``nrows``, ``nrows_pad``, and ``launch``, the
:class:`StencilLaunch` that :func:`stage` made when the level was built).

:func:`stencil_matvec` launches a kernel for a CUDA tensor (f32 or bf16
for the cycle, f64 for the defect-correction residual) and raises if it
cannot; for a CPU tensor it runs :func:`_stencil_matvec_plain`, which sums
bf16 in f32 and rounds once, as the bf16 kernels do. The variant comes
from the shape alone (:func:`stencil_plan`): the tiled kernel for a 3-d
lattice whose stencil reaches at most one cell along each axis (the
headline's), the general kernel for every other shape.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import cuda_lib

MAX_DIM = 4

# kernel launches per entry point (a plain count; see chip_smoke.py)
LAUNCHES = {
    f"{kind}_{sfx}": 0
    for kind in ("stencil_tiled3d", "stencil_matvec")
    for sfx in cuda_lib.DTYPE_SUFFIXES
}

# the tiled kernel's geometry (kTX, kTY, kHalo, kSlots, kMirror, kMaxTaps
# in the kernel, whose launch refuses a plan that does not match them)
TILE_X = 32  # fast-axis cells of a tile: one warp
TILE_Y = 16  # middle-axis cells of a tile: two per thread
HALO = 1
RING_SLOTS = 8  # x planes in a block's shared-memory ring ...
RING_MIRROR = 2  # ... and its slots 0, 1 repeated after it
MAX_TAPS = 27
TAP_COUNTS = (7, 15, 27)  # the compiled tap-loop lengths
TARGET_BLOCKS = 132 * 8 * 2  # SMs x resident 256-thread blocks x 2 waves
INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class StencilPlan:
    """K1's launch plan for one level.

    ``tiled3d``: a block owns a ``tile`` = (TILE_Y, TILE_X) patch of the
    two fast axes and marches over ``chunk`` planes of the slow axis,
    keeping a ring of RING_SLOTS halo-padded x planes (three in use, the
    rest in flight; RING_MIRROR slots mirrored) in ``smem_bytes`` of
    shared memory (the ring holds the storage type: bf16 planes take half
    the f32 bytes); the grid is tiles_y * tiles_x * ceil(dims[0] / chunk)
    blocks.
    ``general``: one thread per row, grid-stride (``tile`` and ``chunk``
    unused). ``ntaps``: the compiled tap-loop length (zero-weight taps pad
    the stencil up to it) or, for ``general``, the stencil's own count.
    The tiled launch passes every field to the kernel, which checks them
    against its own geometry and launches ``blocks`` blocks with
    ``smem_bytes`` of shared memory.
    """

    variant: str
    tile: tuple
    halo: int
    chunk: int
    tiles: tuple  # (tiles_y, tiles_x)
    blocks: int
    smem_bytes: int
    ntaps: int


def stencil_plan(offs, dims, itemsize: int) -> StencilPlan:
    """K1's plan from the level's shape alone."""
    d = len(dims)
    m = len(offs)
    reach = max((abs(int(v)) for o in offs for v in o), default=0)
    if d == 3 and reach <= HALO and 0 < m <= MAX_TAPS \
            and dims[1] * dims[2] <= INT32_MAX:
        n0, n1, n2 = (int(v) for v in dims)
        ty, tx = -(-n1 // TILE_Y), -(-n2 // TILE_X)
        nchunks = min(n0, max(1, TARGET_BLOCKS // (ty * tx)))
        chunk = -(-n0 // nchunks)
        blocks = ty * tx * -(-n0 // chunk)
        if blocks <= INT32_MAX:
            return StencilPlan(
                variant="tiled3d", tile=(TILE_Y, TILE_X), halo=HALO,
                chunk=chunk, tiles=(ty, tx), blocks=blocks,
                smem_bytes=(RING_SLOTS + RING_MIRROR) * (TILE_Y + 2 * HALO)
                * (TILE_X + 2 * HALO) * itemsize,
                ntaps=min(c for c in TAP_COUNTS if c >= m),
            )
    return StencilPlan(
        variant="general", tile=(), halo=reach, chunk=0, tiles=(),
        blocks=0, smem_bytes=0, ntaps=m,
    )


def _device_meta(offs: tuple, dims: tuple, device: torch.device):
    """[linear offsets (m,), vector offsets (m, d), reach per axis (d,)]
    as one int64 array (the general kernel's ``meta``)."""
    d = len(dims)
    strides = [1] * d
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * dims[k + 1]
    lin = [sum(int(o[k]) * strides[k] for k in range(d)) for o in offs]
    reach = [max((abs(int(o[k])) for o in offs), default=0) for k in range(d)]
    flat = lin + [int(o[k]) for o in offs for k in range(d)] + reach
    return torch.tensor(flat, dtype=torch.int64, device=device)


@dataclass(frozen=True)
class StencilLaunch:
    """What a launch needs, made once per staged level: the plan and, for
    the tiled kernel, its parameters on the host (weights, and each tap's
    (dz, dy, dx), in ``offs`` order, padded to MAX_TAPS with zero-weight
    taps on the output cell), or, for the general kernel, its ``meta`` on
    the level's device."""

    plan: StencilPlan
    weights: object = None  # ctypes array of MAX_TAPS values
    taps: object = None  # ctypes array of 3 * MAX_TAPS int32
    meta: torch.Tensor | None = None


def stage(A) -> StencilLaunch:
    offs = tuple(tuple(int(v) for v in o) for o in A.offs)
    dims = tuple(int(v) for v in A.dims)
    plan = stencil_plan(offs, dims, A.vals.element_size())
    if plan.variant == "general":
        return StencilLaunch(plan=plan,
                             meta=_device_meta(offs, dims, A.vals.device))
    # the weights in the accumulation type (bf16 values exactly, as f32)
    acc = cuda_lib.acc_dtype(A.vals.dtype)
    ctype = ctypes.c_double if acc == torch.float64 else ctypes.c_float
    pad = MAX_TAPS - len(offs)
    w = A.vals.to(acc).tolist() + [0.0] * pad
    taps = [v for o in offs for v in o] + [0, 0, 0] * pad
    return StencilLaunch(
        plan=plan,
        weights=(ctype * MAX_TAPS)(*w),
        taps=(ctypes.c_int * (3 * MAX_TAPS))(*taps),
    )


def _stencil_matvec_plain(A, x: torch.Tensor) -> torch.Tensor:
    """Pad-and-shift form (ngsamg_tpu/sparse/formats.py XLA path), summed
    in the kernels' accumulation type and rounded once."""
    d = len(A.dims)
    acc = cuda_lib.acc_dtype(x.dtype)
    vals = A.vals.to(acc)
    xf = x[: A.nrows, 0].to(acc).reshape(A.dims)
    r = [max(abs(int(o[k])) for o in A.offs) for k in range(d)]
    pads = []
    for k in reversed(range(d)):  # F.pad lists the last axis first
        pads += [r[k], r[k]]
    xp = F.pad(xf, pads)
    y = torch.zeros_like(xf)
    for t, off in enumerate(A.offs):
        sl = tuple(
            slice(r[k] + int(off[k]), r[k] + int(off[k]) + A.dims[k])
            for k in range(d)
        )
        y = y + vals[t] * xp[sl]
    y = y.reshape(-1).to(x.dtype)
    return F.pad(y, (0, A.nrows_pad - A.nrows))[:, None]


def _check(A, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"stencil_matvec: unsupported device {x.device}")
    if A.vals.dtype != x.dtype or A.vals.device != x.device:
        raise ValueError(
            f"stencil_matvec: vals {A.vals.dtype}@{A.vals.device} vs "
            f"x {x.dtype}@{x.device}"
        )
    if x.shape != (A.nrows_pad, 1) or not x.is_contiguous():
        raise ValueError(
            f"stencil_matvec: x must be contiguous ({A.nrows_pad}, 1), "
            f"got {tuple(x.shape)}"
        )


def _launch_tiled(A, x: torch.Tensor) -> torch.Tensor:
    launch = A.launch
    p = launch.plan
    n0, n1, n2 = A.dims
    y = torch.empty_like(x)
    sfx = cuda_lib.suffix(x.dtype)
    key = f"stencil_tiled3d_{sfx}"
    sym = f"ngsamg_stencil3d_{sfx}"
    rc = getattr(cuda_lib.library(), sym)(
        ctypes.addressof(launch.weights), ctypes.addressof(launch.taps),
        p.ntaps, n0, n1, n2, *p.tile, p.halo, *p.tiles, p.chunk, p.blocks,
        p.smem_bytes, A.nrows, A.nrows_pad, x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, sym)
    LAUNCHES[key] += 1
    return y


def _launch_general(A, x: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    d = len(A.dims)
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"stencil_matvec: {d}-d lattice (1..{MAX_DIM})")
    if not A.vals.is_contiguous():
        raise ValueError("stencil_matvec: vals must be contiguous")
    dims4 = list(A.dims) + [1] * (MAX_DIM - d)
    y = torch.empty_like(x)
    key = f"stencil_matvec_{cuda_lib.suffix(x.dtype)}"
    sym = f"ngsamg_{key}"
    rc = getattr(cuda_lib.library(), sym)(
        A.vals.data_ptr(), meta.data_ptr(), len(A.offs), d, *dims4,
        A.nrows, A.nrows_pad, x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, sym)
    LAUNCHES[key] += 1
    return y


def stencil_matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a uniform clipped stencil; x: (nrows_pad, 1)."""
    if x.device.type == "cpu":
        return _stencil_matvec_plain(A, x)
    _check(A, x)
    if A.launch.plan.variant == "tiled3d":
        return _launch_tiled(A, x)
    return _launch_general(A, x, A.launch.meta)
