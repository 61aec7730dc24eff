"""Build and load the port's native setup extension (g++ -> CPython module).

The source is ``ngsamg_tpu_torch/native/kernels.cpp``, a CPython extension
on the numpy C API (``Python.h`` and numpy's headers). It is compiled on
first use, never at import time, with the command line setuptools gives
the JAX package's extension (``setup.py``): the interpreter's ``CFLAGS``
and ``CCSHARED``, then ``-O3 -std=c++17 -march=native``. The same source,
flags and compiler then give the same bits as that extension.

The library goes to ``build/ngsamg_tpu_torch_native/<hash>/`` beside the
package, keyed by a hash of the source, the flags, ``g++ --version``, the
interpreter's ABI tag and numpy's version. One build serves every process:
the compile runs under an ``fcntl`` lock on the hash directory and writes
a temporary file that ``os.replace`` moves into place. A failed compile
raises ``RuntimeError`` with the command and the compiler's whole output.

This module imports neither torch nor the JAX package: the host-setup
ranks of ``parallel/mp_runtime.py`` load it.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("kernels.cpp")
BUILD_ROOT = (
    Path(__file__).resolve().parents[2] / "build" / "ngsamg_tpu_torch_native"
)
CXX = "g++"
# the JAX extension's extra_compile_args (setup.py)
EXTRA_FLAGS = ("-O3", "-std=c++17", "-march=native")
# the init symbol is PyInit__ngsamg_native (kernels.cpp), so the module's
# last name part must be _ngsamg_native
MODULE_NAME = "ngsamg_tpu_torch.native._ngsamg_native"


def compile_flags() -> list[str]:
    """setuptools' flags for the JAX extension's compile, then the link."""
    cfg = sysconfig.get_config_var
    return [
        *(cfg("CFLAGS") or "").split(),
        *(cfg("CCSHARED") or "").split(),
        f"-I{sysconfig.get_paths()['include']}",
        f"-I{np.get_include()}",
        *EXTRA_FLAGS,
        "-shared",
        "-fPIC",
    ]


def _compiler_version(cxx: str) -> str:
    try:
        res = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True)
    except OSError as e:
        raise RuntimeError(
            f"the native setup extension needs a C++ compiler: {cxx!r} "
            f"could not be run ({e})"
        ) from e
    if res.returncode != 0:
        raise RuntimeError(
            f"{cxx} --version failed ({res.returncode}):\n"
            f"{res.stdout}{res.stderr}"
        )
    return res.stdout


def library_path(cxx: str = CXX, root: Path = BUILD_ROOT) -> Path:
    """Where the extension for this source, compiler and interpreter goes."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(compile_flags()).encode())
    h.update(_compiler_version(cxx).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    h.update(sys.implementation.cache_tag.encode())
    h.update(suffix.encode())
    h.update(np.__version__.encode())
    return Path(root) / h.hexdigest()[:16] / f"_ngsamg_native{suffix}"


def build(cxx: str = CXX, root: Path = BUILD_ROOT) -> tuple[Path, float]:
    """Compile the extension unless this hash is built; returns its path
    and the seconds this call spent compiling (0.0 on a cache hit)."""
    out = library_path(cxx, root)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, 0.0
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=out.parent)
        os.close(fd)
        cmd = [cxx, *compile_flags(), str(SOURCE), "-o", tmp]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise RuntimeError(
                f"the native setup extension did not build: {' '.join(cmd)}"
                f"\n{e}"
            ) from e
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"the native setup extension did not build "
                f"({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)
        return out, time.perf_counter() - t0


def load(path: Path):
    """Import the built extension at ``path`` as a module."""
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, str(path))
    spec = importlib.util.spec_from_file_location(
        MODULE_NAME, str(path), loader=loader
    )
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module
