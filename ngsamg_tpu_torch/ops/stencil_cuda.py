"""K1: the uniform-stencil matvec — CUDA kernel wrapper + plain version.

Replaces the Pallas TPU kernel ngsamg_tpu/ops/stencil_pallas.py
`_stencil_kernel`; the kernel is ``csrc/stencil_matvec.cu``. ``A`` is a
:class:`ngsamg_tpu_torch.sparse.formats.StencilDia` (duck-typed here:
``vals``, ``offs``, ``dims``, ``nrows``, ``nrows_pad``).

:func:`stencil_matvec` launches the kernel for a CUDA tensor (f32 for the
cycle, f64 for the defect-correction residual) and raises if it cannot;
for a CPU tensor it runs :func:`_stencil_matvec_plain`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import cuda_lib

MAX_DIM = 4

# kernel launches per entry point (a plain count; see chip_smoke.py)
LAUNCHES = {"stencil_matvec_f32": 0, "stencil_matvec_f64": 0}

_ENTRY = {
    torch.float32: ("stencil_matvec_f32", "ngsamg_stencil_matvec_f32"),
    torch.float64: ("stencil_matvec_f64", "ngsamg_stencil_matvec_f64"),
}


def _stencil_matvec_plain(A, x: torch.Tensor) -> torch.Tensor:
    """Pad-and-shift form (ngsamg_tpu/sparse/formats.py XLA path)."""
    d = len(A.dims)
    xf = x[: A.nrows, 0].reshape(A.dims)
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
        y = y + A.vals[t] * xp[sl]
    return F.pad(y.reshape(-1), (0, A.nrows_pad - A.nrows))[:, None]


@functools.lru_cache(maxsize=64)
def _device_meta(offs: tuple, dims: tuple, device: torch.device):
    """[linear offsets (m,), vector offsets (m, d), reach per axis (d,)]
    as one int64 array (the kernel's ``meta``)."""
    d = len(dims)
    strides = [1] * d
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * dims[k + 1]
    lin = [sum(int(o[k]) * strides[k] for k in range(d)) for o in offs]
    reach = [max((abs(int(o[k])) for o in offs), default=0) for k in range(d)]
    flat = lin + [int(o[k]) for o in offs for k in range(d)] + reach
    return torch.tensor(flat, dtype=torch.int64, device=device)


def stencil_matvec(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a uniform clipped stencil; x: (nrows_pad, 1)."""
    if x.device.type == "cpu":
        return _stencil_matvec_plain(A, x)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_matvec: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"stencil_matvec: dtype {x.dtype} (f32/f64 only)")
    if A.vals.dtype != x.dtype or A.vals.device != x.device:
        raise ValueError(
            f"stencil_matvec: vals {A.vals.dtype}@{A.vals.device} vs "
            f"x {x.dtype}@{x.device}"
        )
    if tuple(x.shape) != (A.nrows_pad, 1) or not x.is_contiguous():
        raise ValueError(
            f"stencil_matvec: x must be contiguous ({A.nrows_pad}, 1), "
            f"got {tuple(x.shape)}"
        )
    d = len(A.dims)
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"stencil_matvec: {d}-d lattice (1..{MAX_DIM})")
    vals = A.vals.contiguous()
    meta = _device_meta(
        tuple(tuple(int(v) for v in o) for o in A.offs),
        tuple(int(v) for v in A.dims),
        x.device,
    )
    dims4 = list(A.dims) + [1] * (MAX_DIM - d)
    y = torch.empty_like(x)
    key, sym = _ENTRY[x.dtype]
    fn = getattr(cuda_lib.library(), sym)
    rc = fn(
        vals.data_ptr(), meta.data_ptr(), len(A.offs), d, *dims4,
        A.nrows, A.nrows_pad, x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, sym)
    LAUNCHES[key] += 1
    return y
