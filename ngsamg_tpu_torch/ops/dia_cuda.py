"""K2/K3: the DIA matvecs — CUDA kernel wrappers + plain version.

Replace the Pallas TPU kernels ngsamg_tpu/ops/dia_pallas.py `_dia_kernel`
(full storage, K2) and `_dia_sym_kernel` (symmetric half storage, K3); the
kernels are ``csrc/dia_matvec.cu``. ``A`` is a
:class:`ngsamg_tpu_torch.sparse.formats.DiaMatrix` (duck-typed here:
``data``, ``offsets``, ``nrows_pad``, ``sym_half``).

:func:`dia_matvec` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs :func:`_dia_matvec_plain`.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=64)
def _device_offsets(offsets: tuple, device: torch.device):
    return torch.tensor(offsets, dtype=torch.int64, device=device)


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
    if tuple(A.data.shape) != (ndiag, A.nrows_pad) or not A.data.is_contiguous():
        raise ValueError(
            f"dia_matvec: data must be contiguous ({ndiag}, {A.nrows_pad}), "
            f"got {tuple(A.data.shape)}"
        )
    if tuple(x.shape) != (A.nrows_pad, 1) or not x.is_contiguous():
        raise ValueError(
            f"dia_matvec: x must be contiguous ({A.nrows_pad}, 1), "
            f"got {tuple(x.shape)}"
        )
    if A.sym_half and min(A.offsets, default=0) < 0:
        raise ValueError("dia_matvec: sym_half stores offsets >= 0 only")
    offs = _device_offsets(tuple(int(o) for o in A.offsets), x.device)
    y = torch.empty_like(x)
    kind = "dia_sym_matvec" if A.sym_half else "dia_matvec"
    key = f"{kind}_{'f32' if x.dtype == torch.float32 else 'f64'}"
    sym = f"ngsamg_{key}"
    fn = getattr(cuda_lib.library(), sym)
    rc = fn(
        A.data.data_ptr(), offs.data_ptr(), ndiag, A.nrows_pad,
        x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, sym)
    LAUNCHES[key] += 1
    return y
