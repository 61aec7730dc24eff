"""Host setup and device staging seconds of the port's scalar paths.

    python3 scripts/setup_times.py [OTHER_ROOT] [--problems unstructured,gs,dist]

Needs one CUDA device. Each problem is set up with
``ngsamg_tpu_torch.AMGPreconditioner(..., device="cuda")`` and solved once
to 1e-8; the problems are ``chip_smoke.py``'s:

- ``unstructured``: ``unstructured_poisson(55, dim=3, refine=1)``
  (1,411,632 DoF), Chebyshev;
- ``gs``: ``poisson_3d(101)`` with ``AMGOptions()`` (multicolor GS);
- ``dist``: ``poisson_3d(101)``, ``dist_setup=8``, SPW, Chebyshev.

Every run is a fresh process that imports ``ngsamg_tpu_torch`` from one
checkout. With ``OTHER_ROOT`` (another checkout, for example a parent
commit unpacked with ``git archive``) the runs go other, this, this, other,
so both checkouts meet the host in both orders. The problems are assembled
once, by the first run, and kept in ``build/setup_times/`` of this
checkout for the others (assembly is numpy and would dominate).

Prints one JSON line per run and problem: the checkout, the host setup and
staging seconds (and staging by stage), the levels, operator complexity
and iterations, the native setup calls where the checkout counts them, and
the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
CACHE = HERE / "build" / "setup_times"
PROBLEMS = ("unstructured", "gs", "dist")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _problem(name: str):
    """(A, b, coords) of a problem, assembled once and cached."""
    import scipy.sparse as sp

    from ngsamg_tpu_torch.utils import fem

    key = "unstructured" if name == "unstructured" else "lattice"
    path = CACHE / f"{key}.npz"
    if path.exists():
        z = np.load(path)
        A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                          shape=tuple(z["shape"]))
        coords = z["coords"] if z["coords"].size else None
        return A, z["b"], coords
    if key == "unstructured":
        p = fem.unstructured_poisson(55, dim=3, refine=1)
    else:
        p = fem.poisson_3d(101)
    A = p.A.tocsr()
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = CACHE / f"{key}.tmp.npz"
    np.savez(tmp, data=A.data, indices=A.indices, indptr=A.indptr,
             shape=np.array(A.shape), b=p.b,
             coords=np.zeros(0) if p.coords is None else p.coords)
    tmp.replace(path)
    return A, p.b, p.coords


def _options(name: str):
    from ngsamg_tpu_torch import AMGOptions, CoarsenType, SpecOpt
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType

    if name == "gs":
        return AMGOptions()
    opts = AMGOptions(
        smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
    if name == "dist":
        opts.dist_setup = 8
        opts.coarsen.algo = SpecOpt(CoarsenType.SPW)
    return opts


def worker(root: str, problems) -> None:
    sys.path.insert(0, root)
    import torch

    import ngsamg_tpu_torch
    from ngsamg_tpu_torch import AMGPreconditioner

    if not ngsamg_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {ngsamg_tpu_torch.__file__}, "
                           f"not from {root}")
    try:
        from ngsamg_tpu_torch import native
    except ImportError:  # a checkout without the native extension
        native = None
    for name in problems:
        A, b, coords = _problem(name)
        if native is not None:
            native.reset_calls()
        pc = AMGPreconditioner(A, coords=coords, options=_options(name),
                               device="cuda").setup()
        calls = None if native is None else {
            k: v["native"] for k, v in native.CALLS.items() if v["native"]}
        _x, info = pc.solve(b, tol=1e-8)
        torch.cuda.synchronize()
        print(json.dumps({
            "checkout": root, "problem": name, "dofs": int(A.shape[0]),
            "setup_host_s": pc.setup_time_host,
            "setup_staging_s": pc.setup_time_device,
            "staging_stages_s": pc._device_stage_times,
            "level_sizes": [int(v) for v in pc.log_.nvs],
            "operator_complexity": pc.operator_complexity,
            "iterations": int(info.iterations),
            "native_calls": calls, "card": _card(),
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?", default=None)
    ap.add_argument("--problems", default=",".join(PROBLEMS))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    problems = [p for p in args.problems.split(",") if p]
    bad = set(problems) - set(PROBLEMS)
    if bad:
        ap.error(f"unknown problems {sorted(bad)}")
    if args.worker is not None:
        worker(args.worker, problems)
        return 0
    this = str(HERE)
    order = [this] if args.other is None else [
        str(Path(args.other).resolve()), this, this,
        str(Path(args.other).resolve())]
    for root in order:
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, __file__, "--worker", root, "--problems",
             ",".join(problems)],
            check=True, cwd=root,
        )
        print(json.dumps({"checkout": root,
                          "process_s": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
