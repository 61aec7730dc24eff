"""The benchmark's problems: frozen generators and their on-disk cache.

A configuration names a generator (a module of this package, found by name)
and its parameters. ``load`` returns the generator's ``(A, coords)``, built
once per checkout and then read back from ``build/bench_problems/``, keyed by
the generator's source and parameters, so that the assembly (53 s of numpy
for the elasticity configuration) is paid by the first run alone.
"""

from __future__ import annotations

import hashlib
import importlib
import inspect
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import scipy.sparse as sp

_CSR_KEYS = ("data", "indices", "indptr")


def generator(name: str):
    """The generator module ``benchmark/problems/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")


def cache_key(name: str, params: dict) -> str:
    src = inspect.getsource(generator(name))
    h = hashlib.sha256(src.encode())
    h.update(json.dumps(params, sort_keys=True).encode())
    return h.hexdigest()[:16]


def _save(d: Path, A, coords) -> None:
    if isinstance(A, sp.dia_matrix):
        arrays = {"data": A.data, "offsets": A.offsets}
    else:
        A = A.tocsr()
        arrays = {k: getattr(A, k) for k in _CSR_KEYS}
    arrays["coords"] = coords
    for k, v in arrays.items():
        with open(d / f"{k}.npy", "wb") as f:
            np.save(f, np.ascontiguousarray(v))
            # on disk before the run goes on, so that no write-back of the
            # cache runs beside the window of a checkout's first run
            f.flush()
            os.fsync(f.fileno())
    meta = {"format": A.format, "shape": list(A.shape)}
    (d / "meta.json").write_text(json.dumps(meta))


def _read(d: Path):
    meta = json.loads((d / "meta.json").read_text())
    arr = {p.stem: np.load(p) for p in d.glob("*.npy")}
    shape = tuple(meta["shape"])
    if meta["format"] == "dia":
        A = sp.dia_matrix((arr["data"], arr["offsets"]), shape=shape)
    else:
        A = sp.csr_matrix(tuple(arr[k] for k in _CSR_KEYS), shape=shape)
    return A, arr["coords"]


def load(problem: dict, cache_root: Path):
    """``(A, coords)`` of ``problem = {"generator": name, "params": {...}}``,
    from the cache when this generator source and these parameters were
    built before in ``cache_root``."""
    name, params = problem["generator"], problem["params"]
    d = Path(cache_root) / f"{name}-{cache_key(name, params)}"
    if not (d / "meta.json").exists():
        A, coords = generator(name).generate(**params)
        d.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix=f".{d.name}.", dir=d.parent))
        try:
            _save(tmp, A, coords)
            os.replace(tmp, d)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if not (d / "meta.json").exists():
                raise
        return A, coords
    return _read(d)
