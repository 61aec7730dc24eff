"""Fill-in of the distributed Stokes setup's prolongations.

The distributed Stokes setup (``parallel/dist_stokes.py``, in the JAX
package and in its copy in ``ngsamg_tpu_torch``) curl-smooths P with the
smoothed prolongation, the default, and keeps every entry the smoothing
makes; on 3D meshes P then fills in. This script sets ``stokes_tri(n,
dim)`` up on ``shards`` shards, on the host, with the smoothed and (unless
``--smoothed-only``) the piecewise prolongation, through one package's
``dist_stokes_levels``, and prints one JSON line per setup: the seconds,
the peak resident memory, the level sizes and each P's shape, nonzeros
and density. ``--package ngsamg_tpu`` runs the JAX package's code on its
numpy branches (``native.HAVE_NATIVE = False``, as the port's tests hold
it); the other package is not imported::

    env JAX_PLATFORMS=cpu python3 scripts/dist_stokes_fill.py \\
        --package ngsamg_tpu --n 8 --dim 3
    python3 scripts/dist_stokes_fill.py --package ngsamg_tpu_torch --n 8
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("ngsamg_tpu", "ngsamg_tpu_torch"),
                    default="ngsamg_tpu_torch")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--max-coarse-size", type=int, default=80)
    ap.add_argument("--smoothed-only", action="store_true")
    a = ap.parse_args(argv)
    pkg = importlib.import_module(a.package)
    dist_stokes = importlib.import_module(a.package + ".parallel.dist_stokes")
    stokes = importlib.import_module(a.package + ".precond.stokes")
    stokes_fem = importlib.import_module(a.package + ".utils.stokes_fem")
    kw = {"device": "cpu"} if a.package == "ngsamg_tpu_torch" else {}
    if a.package == "ngsamg_tpu":
        importlib.import_module("ngsamg_tpu.native").HAVE_NATIVE = False

    p, _normals = stokes_fem.stokes_tri(a.n, dim=a.dim, alpha=10.0)
    ProlType = pkg.config.ProlType
    prols = [ProlType.SMOOTHED]
    if not a.smoothed_only:
        prols.append(ProlType.PIECEWISE)
    for prol in prols:
        o = pkg.AMGOptions()
        o.levels.max_coarse_size = a.max_coarse_size
        o.prol.type = pkg.SpecOpt(prol)
        pc = stokes.StokesAMG(
            p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
            facet_cells=p.facet_cells, facet_flow=p.facet_flow,
            options=o, **kw,
        )
        t0 = time.perf_counter()
        levels = dist_stokes.dist_stokes_levels(
            pc.A_host, pc.mesh0, pc.facet_bs, o, a.shards
        )
        secs = time.perf_counter() - t0
        print(json.dumps({
            "package": a.package,
            "problem": f"stokes_tri({a.n}, dim={a.dim})",
            "ndof": int(p.A.shape[0]),
            "prolongation": prol.value, "shards": a.shards,
            "host_s": secs,
            "level_sizes": [int(lev.A.shape[0]) for lev in levels],
            "P": [
                {"shape": list(lev.P.shape), "nnz": int(lev.P.nnz),
                 "density": lev.P.nnz / (lev.P.shape[0] * lev.P.shape[1])}
                for lev in levels if lev.P is not None
            ],
            "max_rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6,
        }), flush=True)


if __name__ == "__main__":
    main()
