"""Device-time breakdown and busy share of one warm solve.

    python3 -m ngsamg_tpu_torch.utils.trace_solve \
        [headline|unstructured|elasticity|gs|stokes]

Needs one CUDA device. Sets up on ``cuda``, with the Chebyshev smoother,
``fem.poisson_3d(216)`` (``headline``, the default: 9,938,375 DoF),
``fem.unstructured_poisson(55, dim=3, refine=1)`` (``unstructured``:
1,411,632 DoF on tile-ELL levels) or ``fem.unstructured_elasticity(36,
dim=3, refine=1)`` (``elasticity``: 1,250,196 DoF on block-ELL levels,
solved by the mixed-precision PCG); or, with ``AMGOptions()`` unchanged
(multicolor GS, V-cycle), ``fem.poisson_3d(101)`` (``gs``: 1,000,000 DoF
on block-ELL levels, one sweep a sequence of color steps); or the JAX
package's Stokes bench leg (``stokes``: ``stokes_fem.stokes_tri(20, dim=3,
alpha=10)``, 104,738 DoF, ``StokesAMG`` with short geometric loops and
``max_coarse_size`` 80, Hiptmair smoothing on tile-ELL and dense levels,
solved with ``maxiter=150``). It runs two warm-up solves and five
unprofiled warm solves (host wall clock, ending in
``torch.cuda.synchronize()``), then one solve under ``torch.profiler``. It
prints the device time by kernel name and one JSON line with:

- ``busy_ms``: the union of the device events' intervals in the profiled
  solve (overlapping events count once);
- ``busy_share``: ``busy_ms`` over the median unprofiled warm solve. The
  profiler slows the host's dispatch but not the kernels, so this is the
  share of a real warm solve in which the device is busy;
- ``busy_share_profiled``: ``busy_ms`` over the profiled solve's own wall
  clock, which the profiler inflates (a lower bound);
- ``kernel_launches``: the device kernels of the profiled solve (copies and
  memsets apart).

``--setup-profile`` also runs ``setup()`` under ``cProfile`` and prints the
package's own functions by cumulative host time (the profiler adds a few
per cent to the setup it times).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _union_us(intervals) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _profiled_setup(pc, top: int = 25) -> None:
    """``pc.setup()`` under cProfile; prints the port's own functions (and
    numpy.linalg's) by cumulative time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    pc.setup()
    prof.disable()
    print(f"[setup] host {pc.setup_time_host:.3f} s, staging "
          f"{pc.setup_time_device:.3f} s", flush=True)
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, _)
    rows = sorted(
        ((ct, tt, nc, f"{fn.split('ngsamg_tpu_torch/')[-1]}:{name}")
         for (fn, _ln, name), (_cc, nc, tt, ct, _c) in stats.items()
         if "ngsamg_tpu_torch/" in fn or "numpy/linalg" in fn),
        reverse=True,
    )
    for ct, tt, nc, label in rows[:top]:
        print(f"[setup] {ct:9.3f} s cumulative {tt:9.3f} s own "
              f"{nc:6d} calls  {label[-70:]}", flush=True)


PROBLEMS = {
    "headline": lambda fem: fem.poisson_3d(216),
    "unstructured": lambda fem: fem.unstructured_poisson(55, dim=3, refine=1),
    "elasticity": lambda fem: fem.unstructured_elasticity(
        36, dim=3, refine=1),
    "gs": lambda fem: fem.poisson_3d(101),
}
# problems solved with the JAX package's default options (multicolor GS);
# the others take the Chebyshev smoother
DEFAULT_OPTIONS = {"gs"}
# the front-end arguments and the solve of each problem beyond the defaults
SETUP_KW = {"elasticity": {"energy": "elasticity", "block_size": 3}}
SOLVE_KW = {"elasticity": {"maxiter": 120, "mixed": True}}


def _stokes_case():
    """(problem, preconditioner not set up, solve) of the Stokes bench
    leg."""
    from .. import AMGOptions
    from ..precond.stokes import StokesAMG
    from .stokes_fem import stokes_tri

    p, _normals = stokes_tri(20, dim=3, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 80
    pc = StokesAMG(
        p.A, cell_pos=p.cell_pos, cell_vol=p.cell_vol,
        facet_cells=p.facet_cells, facet_flow=p.facet_flow,
        facet_verts=p.facet_verts, vert_pos=p.vert_pos,
        bnd_facet_verts=p.bnd_facet_verts, options=opts, device="cuda",
    )
    return p, pc, lambda: pc.solve(p.b, tol=1e-8, maxiter=150)


def main(argv=None) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .. import AMGOptions, AMGPreconditioner
    from ..config import SmootherOptions, SmootherType
    from . import fem

    ap = argparse.ArgumentParser(prog="trace_solve")
    ap.add_argument("problem", nargs="?", default="headline",
                    choices=sorted([*PROBLEMS, "stokes"]))
    ap.add_argument("--setup-profile", action="store_true",
                    help="profile setup() on the host with cProfile")
    args = ap.parse_args(argv)
    problem = args.problem
    if not torch.cuda.is_available():
        raise RuntimeError("trace_solve needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[trace] {smi}", flush=True)
    if problem == "stokes":
        p, pc, solve = _stokes_case()
    else:
        p = PROBLEMS[problem](fem)
        opts = (
            AMGOptions() if problem in DEFAULT_OPTIONS else AMGOptions(
                smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
        )
        pc = AMGPreconditioner(
            p.A, coords=p.coords, options=opts, device="cuda",
            **SETUP_KW.get(problem, {}),
        )

        def solve():
            return pc.solve(p.b, tol=1e-8, return_device=True,
                            **SOLVE_KW.get(problem, {}))
    if args.setup_profile:
        _profiled_setup(pc)
    else:
        pc.setup()

    for _ in range(2):
        _wall(solve)
    walls = [_wall(solve) for _ in range(5)]
    warm = float(np.median(walls))
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _x, info = solve()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = _union_us(
        (e.time_range.start, e.time_range.end) for e in evs
    )
    by_name: dict[str, list] = {}
    for e in evs:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.elapsed_us()
        t[1] += 1
    total_us = sum(t for t, _ in by_name.values())
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[trace] {t / 1e3:9.3f} ms {c:6d} calls "
              f"{100 * t / total_us:5.1f}%  {name[:90]}")
    print(json.dumps({
        "device": smi,
        "problem": problem,
        "dofs": int(p.n),
        "iterations": int(info.iterations),
        "warm_solve_ms": [w * 1e3 for w in walls],
        "warm_solve_median_ms": warm * 1e3,
        "profiled_solve_ms": prof_wall * 1e3,
        "device_events": len(evs),
        "kernel_launches": sum(
            1 for e in evs if not e.name.lower().startswith(
                ("memcpy", "memset"))),
        "device_time_sum_ms": total_us / 1e3,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e6 / warm,
        "busy_share_profiled": busy_us / 1e6 / prof_wall,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
