"""Warm headline solves of two checkouts of the port, alternated on one card.

    python3 -m ngsamg_tpu_torch.utils.ab_solve OTHER_ROOT [--rounds 4]
                                              [--pairs 4]

Needs one CUDA device. ``OTHER_ROOT`` is another checkout of the repository
(for example a parent commit unpacked with ``git archive``, or a copy of
this one for an A/A control). Each round starts one worker process per
checkout; a worker imports ``ngsamg_tpu_torch`` from its own checkout
(which builds its own kernels), sets up ``fem.poisson_3d(216)`` with the
Chebyshev smoother on ``cuda`` and runs two warm-up solves. Then the two
take turns, one solve at a time while the other waits on its pipe:
``--pairs`` pairs, in the order other, this / this, other alternately. A
solve is ``solve(b, tol=1e-8, return_device=True)`` on the host clock, up
to ``torch.cuda.synchronize()``. Fresh processes each round spread over
both checkouts what a process's placement on the shared host costs it.

At the end of a round each worker runs one more warm solve under
``torch.profiler`` (CPU and CUDA) and reports where the host's time goes:
the wall clock, the device busy time (the union of the device events'
intervals), the host time inside each CUDA runtime call (the
synchronising ones are where the host waits for the device), and the ops
with the most self CPU time. The profiler slows the host, so these read
as shares of a profiled solve.

Prints one JSON line per solve, then one JSON summary: per checkout the
times with their median and quartiles, the differences this - other
within each pair with their median and quartiles, and the profiles of
every round.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TAG = "@@ab "  # prefix of the workers' protocol lines on stdout


def _send(obj) -> None:
    print(TAG + json.dumps(obj), flush=True)


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


def _host_profile(solve) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.events()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    runtime: dict[str, list] = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name.startswith("cu"):
            r = runtime.setdefault(e.name, [0, 0.0])
            r[0] += 1
            r[1] += e.time_range.elapsed_us() / 1e3
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": _union_us(
            (e.time_range.start, e.time_range.end) for e in dev) / 1e3,
        "runtime_calls": {k: {"count": c, "ms": ms} for k, (c, ms) in
                          sorted(runtime.items(), key=lambda kv: -kv[1][1])},
        "top_self_cpu": [
            {"op": a.key, "count": a.count,
             "self_cpu_ms": a.self_cpu_time_total / 1e3}
            for a in ops[:15]
        ],
    }


def _worker(root: str) -> None:
    sys.path[0] = root  # this checkout's package, not the script's own
    import torch

    import ngsamg_tpu_torch
    from ngsamg_tpu_torch import AMGOptions, AMGPreconditioner
    from ngsamg_tpu_torch.config import SmootherOptions, SmootherType
    from ngsamg_tpu_torch.utils import fem

    p = fem.poisson_3d(216)
    opts = AMGOptions(smoother=SmootherOptions(type=SmootherType.CHEBYSHEV))
    pc = AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cuda"
    ).setup()

    def solve():
        return pc.solve(p.b, tol=1e-8, return_device=True)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _x, info = solve()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, int(info.iterations)

    for _ in range(2):
        timed()
    _send({"ready": True, "package": ngsamg_tpu_torch.__file__})
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "solve":
            ms, its = timed()
            _send({"ms": ms, "iterations": its})
        elif cmd == "profile":
            _send(_host_profile(solve))
        else:
            break


def _start(root: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(root)],
        cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        bufsize=1,
    )


def _recv(w: subprocess.Popen) -> dict:
    for line in w.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
    raise RuntimeError(f"worker {w.args[-1]} ended (exit {w.wait()})")


def _ask(w: subprocess.Popen, cmd: str) -> dict:
    w.stdin.write(cmd + "\n")
    w.stdin.flush()
    return _recv(w)


def _spread(v) -> dict:
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "min": float(np.min(v)), "max": float(np.max(v))}


def _round(roots, rnd, pairs, times) -> dict:
    """One round: fresh workers, ``pairs`` alternated pairs, a profile."""
    workers = {k: _start(r) for k, r in roots.items()}
    try:
        for k, w in workers.items():
            print(json.dumps({"round": rnd, "tree": k, "root": str(roots[k]),
                              **_recv(w)}), flush=True)
        for i in range(pairs):
            for k in ("other", "this") if i % 2 == 0 else ("this", "other"):
                r = _ask(workers[k], "solve")
                times[k].append(r["ms"])
                print(json.dumps({"round": rnd, "pair": i, "tree": k, **r}),
                      flush=True)
        profiles = {k: _ask(w, "profile") for k, w in workers.items()}
        for w in workers.values():
            w.stdin.write("quit\n")
            w.stdin.flush()
            w.wait(timeout=120)
    finally:
        for w in workers.values():
            if w.poll() is None:
                w.kill()
                w.wait()
    return profiles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ab_solve")
    ap.add_argument("other", help="root of another checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=4, help="pairs per round")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.other)
        return 0
    roots = {"this": Path(__file__).resolve().parents[2],
             "other": Path(args.other).resolve()}
    times = {"this": [], "other": []}
    profiles = [_round(roots, rnd, args.pairs, times)
                for rnd in range(args.rounds)]
    diffs = [t - o for t, o in zip(times["this"], times["other"])]
    print(json.dumps({
        "rounds": args.rounds, "pairs_per_round": args.pairs,
        "this_ms": times["this"], "other_ms": times["other"],
        "this": _spread(times["this"]), "other": _spread(times["other"]),
        "this_minus_other_ms": diffs, "diff": _spread(diffs),
        "profiles": profiles,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
