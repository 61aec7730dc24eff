"""Device-time breakdown, busy share and idle time by program span of one
warm solve.

    python3 -m ngsamg_tpu_torch.utils.trace_solve \
        [headline|unstructured|elasticity|gs|stokes] [--blocks SECONDS] \
        [--setup-profile]

Needs one CUDA device. Sets up on ``cuda``, with the Chebyshev smoother,
``fem.poisson_3d(216)`` (``headline``, the default: 9,938,375 DoF),
``fem.unstructured_poisson(55, dim=3, refine=1)`` (``unstructured``:
1,411,632 DoF on tile-ELL levels) or ``fem.unstructured_elasticity(36,
dim=3, refine=1)`` (``elasticity``: 1,250,196 DoF on block-ELL levels,
solved by the mixed-precision PCG); or, with ``AMGOptions()`` unchanged
(multicolor GS, V-cycle), ``fem.poisson_3d(101)`` (``gs``: 1,000,000 DoF
on block-ELL levels, one sweep a sequence of color steps); or the JAX
package's Stokes bench leg (``stokes``: ``stokes_fem.stokes_tri(20,
dim=3, alpha=10)``, 104,738 DoF, ``StokesAMG`` with short geometric loops and
``max_coarse_size`` 80, Hiptmair smoothing on tile-ELL and dense levels,
solved with ``maxiter=150``; it records no program spans). It prints the
set-up's phases and staging stages (the ``setup.*`` and ``staging.*`` spans
of ``pc.trace_``, utils/timers.py), runs two warm-up solves and five
unprofiled warm solves (host wall clock, ending in
``torch.cuda.synchronize()``), then one solve under ``torch.profiler`` with
tracing on. It prints the device time by kernel name, the device's idle
time by program span, and one JSON line with:

- ``busy_ms``: the union of the device events' intervals in the profiled
  solve (overlapping events count once);
- ``busy_share``: ``busy_ms`` over the median unprofiled warm solve. The
  profiler slows the host's dispatch but not the kernels, so this is the
  share of a real warm solve in which the device is busy;
- ``busy_share_profiled``: ``busy_ms`` over the profiled solve's own wall
  clock, which the profiler inflates (a lower bound);
- ``kernel_launches``: the device kernels of the profiled solve (copies and
  memsets apart);
- ``idle_by_span``: each gap between the device's busy intervals inside
  the profiled solve (from the root ``solve`` span's start to the end of
  the device's last event in it) goes, in seconds, to the innermost program
  span at the gap's midpoint, keyed by its name (with the level or the
  read's op; a multicolour GS sweep takes its parent's level:
  ``gs.sweep[<level>]`` inside ``cycle.level``, ``gs.sweep`` inside
  ``cycle.coarse``); ``root_self_idle_share``: the share of the idle time
  that falls in the root ``solve`` span's self time;
- ``colour_steps``: the profiled solve's ``SolveInfo.colour_steps`` (the
  GS sweeps' colour steps, 0 under Chebyshev), ``gs_kernel_steps``,
  those of them the hand-written sweep kernel ran,
  ``tile_ell_matvecs``, its applications of tile-ELL operators, and
  ``tile_ell_kernel_matvecs``, those of them the tile-ELL kernel ran.

``--blocks S`` then times warm solves in alternating blocks of ``S``
seconds, tracing off, on, on, off, and prints each block's mean solve time,
the cost of tracing (on against off) and the cost of the span sites with
tracing off (the time of one site's check, measured here, times the sites
of one solve). ``--setup-profile`` also runs ``setup()`` under
``cProfile`` and prints the package's own functions by cumulative host time
(the profiler adds a few per cent to the setup it times).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import timers

SETUP_PHASES = ("setup.mesh", "setup.coarsen", "setup.prol", "setup.rap")
ROOT = "solve"
NO_SPAN = "(no program span)"


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _span_key(sp, by_id) -> str:
    a = sp.attrs or {}
    if sp.name == "gs.sweep" and sp.parent in by_id:
        # a sweep smooths the level of the visit it is a child of
        a = by_id[sp.parent].attrs or {}
    if "level" in a:
        return f"{sp.name}[{a['level']}]"
    if "op" in a:
        return f"{sp.name}[{a['op']}]"
    return sp.name


def idle_by_span(busy, spans, epoch, hi=None):
    """Device idle time by innermost program span.

    ``busy``: the device's busy intervals (epoch ns, merged, sorted);
    ``spans``: the closed spans of one solve, the root ``solve`` span among
    them; ``epoch``: maps a span's ``perf_counter_ns`` reading to epoch ns
    (``Recorder.epoch_ns``). The window runs from the root span's start to
    ``hi`` (default: the later of its end and the last busy interval's).
    Each gap goes to the innermost span covering its midpoint (of the
    spans that cover it, the one that started last), ``NO_SPAN`` where none
    does. Returns ({key: seconds}, idle seconds in the root's self time,
    idle seconds in all)."""
    root = next(s for s in spans if s.name == ROOT)
    lo = epoch(root.start)
    if hi is None:
        hi = max([epoch(root.end)] + [b for _, b in busy])
    ivs = sorted((epoch(s.start), epoch(s.end), s) for s in spans)
    by_id = {s.id: s for s in spans}
    edges = [lo]
    for a, b in busy:
        if b > lo and a < hi:
            edges += [max(a, lo), min(b, hi)]
    edges.append(hi)
    out: dict[str, float] = {}
    root_self = total = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = None
        for s0, s1, sp in ivs:
            if s0 > mid:
                break
            if s1 >= mid:
                inner = sp
        key = NO_SPAN if inner is None else _span_key(inner, by_id)
        sec = (b - a) / 1e9
        out[key] = out.get(key, 0.0) + sec
        total += sec
        if inner is root:
            root_self += sec
    return out, root_self, total


def _setup_report(pc) -> dict:
    """The set-up's phases (self time of each ``setup.*`` phase span) and
    staging stages, from ``pc.trace_``."""
    rec = pc.trace_
    host = rec.seconds("setup.host")
    phases = {k: rec.self_seconds(k) for k in SETUP_PHASES}
    stages = rec.by_name("staging.")
    out = {"setup_host_s": host, "phases_s": phases,
           "uncovered_s": host - sum(phases.values()),
           "staging_s": rec.seconds("setup.staging"), "stages_s": stages,
           "levels": len(rec.named("setup.level"))}
    print(f"[setup] host {host:.3f} s: " + ", ".join(
        f"{k.split('.')[1]} {v:.3f}" for k, v in phases.items())
        + f", no phase {out['uncovered_s']:.3f}", flush=True)
    print(f"[setup] staging {out['staging_s']:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    return out


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


def site_off_ns(n: int = 1_000_000) -> dict[str, float]:
    """Nanoseconds one span site costs with tracing off, by the sites'
    two forms: a per-iteration site (``sp = span(...) if ON else None``
    and its close) and a pass site (``with span(...) if ON else NULL``),
    each less an empty loop."""
    if timers.ON:
        raise RuntimeError("site_off_ns measures with tracing off")
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    t1 = time.perf_counter_ns()
    for i in range(n):
        sp = timers.span("cycle.level", level=i) if timers.ON else None
        if sp is not None:
            sp.close()
    t2 = time.perf_counter_ns()
    for i in range(n):
        with (timers.span("solve.pass", index=i) if timers.ON
              else timers.NULL):
            pass
    t3 = time.perf_counter_ns()
    empty = t1 - t0
    return {"iter": (t2 - t1 - empty) / n, "pass": (t3 - t2 - empty) / n}


def _blocks(solve, pc, seconds: float) -> dict:
    """Warm solves in blocks of ``seconds``, tracing off, on, on, off; the
    mean solve time of each block, and the sites of one solve's spans."""
    order = (False, True, True, False)
    means = []
    for on in order:
        lat = []
        with timers.tracing(on):
            t_end = time.perf_counter() + seconds
            while time.perf_counter() < t_end:
                lat.append(_wall(solve))
        means.append(1e3 * sum(lat) / len(lat))
        print(f"[blocks] tracing {'on ' if on else 'off'} {len(lat):5d} "
              f"solves {means[-1]:.3f} ms a solve", flush=True)
    off = [m for m, on in zip(means, order) if not on]
    on_ = [m for m, on in zip(means, order) if on]
    # one traced solve's spans: the sites it passed
    rec = pc.trace_
    n0 = len(rec.spans)
    with timers.tracing(True):
        _wall(solve)
    kinds: dict[str, int] = {}
    for sp in rec.spans[n0:]:
        kinds[sp.name] = kinds.get(sp.name, 0) + 1
    cost = site_off_ns()
    # pass sites are ``with`` sites; every other span (the root's check
    # is one more) an ``if`` site; a ``sync`` span's check sits in
    # ``timers.blocking``
    n_pass = kinds.get("solve.pass", 0)
    n_iter = sum(kinds.values()) - n_pass
    off_us = (n_pass * cost["pass"] + n_iter * cost["iter"]) / 1e3
    out = {"block_s": seconds, "order": ["on" if o else "off" for o in order],
           "solve_ms": means, "off_ms": float(np.mean(off)),
           "on_ms": float(np.mean(on_)),
           "tracing_cost": float(np.mean(on_) / np.mean(off) - 1.0),
           "sites_per_solve": kinds, "site_off_ns": cost,
           "sites_off_us_per_solve": off_us,
           "sites_off_share": off_us / 1e3 / float(np.mean(off))}
    print("[blocks] " + json.dumps(out), flush=True)
    return out


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
    ap.add_argument("--blocks", type=float, default=0.0,
                    help="seconds a block of the tracing on/off timing")
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
    rec = getattr(pc, "trace_", None)
    setup = None if rec is None else _setup_report(pc)

    for _ in range(2):
        _wall(solve)
    walls = [_wall(solve) for _ in range(5)]
    warm = float(np.median(walls))
    n0 = 0 if rec is None else len(rec.spans)
    with timers.tracing(True), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _x, info = solve()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0

    # device events from the profiler's raw results, in epoch ns
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    busy = _union((a, b) for _, a, b in evs)
    busy_us = sum(b - a for a, b in busy) / 1e3
    by_name: dict[str, list] = {}
    for name, a, b in evs:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += (b - a) / 1e3
        t[1] += 1
    total_us = sum(t for t, _ in by_name.values())
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[trace] {t / 1e3:9.3f} ms {c:6d} calls "
              f"{100 * t / total_us:5.1f}%  {name[:90]}")
    idle = root_self = idle_s = None
    spans = [] if rec is None else [s for s in rec.spans[n0:] if s.end]
    if any(s.name == ROOT for s in spans):
        idle, root_self, idle_s = idle_by_span(busy, spans, rec.epoch_ns)
        for key, sec in sorted(idle.items(), key=lambda kv: -kv[1])[:20]:
            print(f"[idle] {sec * 1e3:9.3f} ms {100 * sec / idle_s:5.1f}%  "
                  f"{key}")
    print(json.dumps({
        "device": smi,
        "problem": problem,
        "dofs": int(p.n),
        "iterations": int(info.iterations),
        "host_syncs": getattr(info, "host_syncs", None),
        "colour_steps": getattr(info, "colour_steps", None),
        "gs_kernel_steps": getattr(info, "gs_kernel_steps", None),
        "tile_ell_matvecs": getattr(info, "tile_ell_matvecs", None),
        "tile_ell_kernel_matvecs": getattr(info, "tile_ell_kernel_matvecs",
                                           None),
        "setup": setup,
        "warm_solve_ms": [w * 1e3 for w in walls],
        "warm_solve_median_ms": warm * 1e3,
        "profiled_solve_ms": prof_wall * 1e3,
        "device_events": len(evs),
        "kernel_launches": sum(
            1 for name, _, _ in evs if not name.lower().startswith(
                ("memcpy", "memset"))),
        "device_time_sum_ms": total_us / 1e3,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e6 / warm,
        "busy_share_profiled": busy_us / 1e6 / prof_wall,
        "idle_s": idle_s,
        "idle_by_span": idle,
        "root_self_idle_share": (None if idle is None
                                 else root_self / max(idle_s, 1e-30)),
    }), flush=True)
    if args.blocks > 0 and rec is not None:
        _blocks(solve, pc, args.blocks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
