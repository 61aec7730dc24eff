"""Run one cell again and again in fresh processes and print the spread of
each metric: the numbers that the bounds in ``BENCHMARK.json`` are set from.

    python3 benchmark/spread.py --workload <cell> --seconds <s> \
        --seeds <n> <n> ... [--sets 2] [--trace 0|1] [--out FILE]

Every set runs the same seeds, one process a run, one after another. A
spread is the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median; a bound is
about five times the widest spread of a metric over the cells. Each run's
result line (or its exit code and the end of its standard error) goes to
``--out`` as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    rec = {"seed": seed, "trace": trace, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0, "result": None,
           "stderr": p.stderr[-3000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/spread.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sets: list[list[dict]] = []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            rec = one_run(args.workload, seed, args.seconds, args.trace)
            rec["set"] = s
            runs.append(rec)
            res = rec["result"] or {}
            short = {k: v["value"] for k, v in res.get("metrics", {}).items()}
            print(json.dumps({"set": s, "seed": seed, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 1),
                              "correct": res.get("correct"),
                              "checks": res.get("checks"), **short}),
                  flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        sets.append(runs)
    summary = {"workload": args.workload, "seconds": args.seconds,
               "runs": sum(len(r) for r in sets),
               "correct": sum(1 for r in sets for x in r
                              if (x["result"] or {}).get("correct")),
               "metrics": {}}
    names = {k for r in sets for x in r
             for k in ((x["result"] or {}).get("metrics") or {})}
    for name in sorted(names):
        per_set = [[x["result"]["metrics"][name]["value"] for x in r
                    if x["result"] and name in x["result"]["metrics"]]
                   for r in sets]
        row = {"medians": [statistics.median(v) for v in per_set if v],
               "spreads": [spread(v) for v in per_set if len(v) >= 2]}
        every = [v for vs in per_set for v in vs]
        if len(every) >= 2:
            row["spread_all"] = spread(every)
        summary["metrics"][name] = row
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
