"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources are ``ngsamg_tpu_torch/csrc/*.cu``; they expose a plain C
interface, so one ``nvcc`` call builds them in seconds (no PyTorch headers).
The library is built on first use into ``build/ngsamg_tpu_torch/<hash>/``
beside the package, keyed by a hash of the sources and the flags, and
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
_SIGNATURES = {
    "ngsamg_stencil_matvec_f32": [_P, _P, _I, _I, _L, _L, _L, _L, _L, _L,
                                  _P, _P, _P],
    "ngsamg_stencil_matvec_f64": [_P, _P, _I, _I, _L, _L, _L, _L, _L, _L,
                                  _P, _P, _P],
    "ngsamg_stencil3d_f32": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _L, _L, _L, _L, _P, _P, _P],
    "ngsamg_stencil3d_f64": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _L, _L, _L, _L, _P, _P, _P],
    "ngsamg_dia_matvec_f32": [_P, _P, _I, _L, _I, _I, _I, _L, _P, _P, _P],
    "ngsamg_dia_matvec_f64": [_P, _P, _I, _L, _I, _I, _I, _L, _P, _P, _P],
    "ngsamg_dia_sym_matvec_f32": [_P, _P, _I, _L, _I, _I, _I, _I, _I,
                                  _L, _I, _L, _P, _P, _P],
    "ngsamg_dia_sym_matvec_f64": [_P, _P, _I, _L, _I, _I, _I, _I, _I,
                                  _L, _I, _L, _P, _P, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    for src in _sources():
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


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
