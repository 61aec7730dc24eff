"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources are ``ngsamg_tpu_torch/csrc/*.cu`` (and the headers they
include, ``csrc/*.cuh``); they expose a plain C interface, so one ``nvcc``
call builds them in seconds (no PyTorch headers). Each kernel has an f32,
an f64 and a bf16 entry point. The library is built on first use into
``build/ngsamg_tpu_torch/<hash>/`` beside the package, keyed by a hash of
the sources, the headers and the flags, and
loaded once per process. Nothing here runs at import time: a machine
without ``nvcc`` or a GPU imports the package and uses the plain PyTorch
versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ngsamg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LIB_NAME = "libngsamg_tpu_torch_kernels.so"

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process made (ptxas -v)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
DTYPE_SUFFIXES = ("f32", "f64", "bf16")
_ARGS = {
    "ngsamg_stencil_matvec": [_P, _P, _I, _I, _L, _L, _L, _L, _L, _L,
                              _P, _P, _P],
    "ngsamg_stencil3d": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _L, _L, _L, _L, _P, _P, _P],
    "ngsamg_dia_matvec": [_P, _P, _I, _L, _L, _L, _I, _I, _I, _L,
                          _P, _P, _P],
    "ngsamg_dia_sym_matvec": [_P, _P, _I, _L, _I, _I, _I, _I, _I,
                              _L, _I, _L, _P, _P, _P],
    "ngsamg_bell_matvec": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _L,
                           _P, _P, _P],
    "ngsamg_gs_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "ngsamg_tile_ell_matvec": [_P, _P, _P, _P, _L, _I, _I, _L, _P, _P, _P],
}
_SIGNATURES = {
    f"{name}_{sfx}": args
    for name, args in _ARGS.items() for sfx in DTYPE_SUFFIXES
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
        "ngsamg_tpu_torch are built from source on first use"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this source hash is already built."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, out)  # atomic: concurrent builds see whole files
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def suffix(dtype) -> str:
    """The entry-point suffix of a tensor dtype; raises for one that no
    kernel is built for."""
    sfx = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}.get(dtype)
    if sfx is None:
        raise TypeError(f"dtype {dtype}: the kernels take f32, f64 and bf16")
    return sfx


def acc_dtype(dtype):
    """The dtype a kernel sums in: its own, f32 for bf16 (precision.cuh);
    the plain versions sum in it too and round once."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
