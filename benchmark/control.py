"""Readings that the check's limit is set from, in one process: the largest
relative residual of the program's answers on each of ``--seeds``, and of
the control's on each of ``--control-seeds``. The control is the program
with the configuration's ``control`` solve arguments: its float32 path
without the float64 correction, which has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... [--out FILE]

The benchmark's own runs never run this. Each seed is a run's window and
check (``run.run_window`` and ``run.judge``) at the cell's own load; the
problem and the program's setup are made once for all seeds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from benchmark import run  # noqa: E402
from benchmark.reference import residual  # noqa: E402


def readings(cell: "run.Cell", seeds, control: bool, seconds: float,
             op=None):
    """One JSON-able record a seed: the run's ``correct``, its solves, the
    answers checked and the largest and smallest relative residual among
    them."""
    limit = float(cell.cfg["limits"]["relres_max"])
    if op is None:
        op = residual.Operator(cell.A, cell.device)
    out = []
    for seed in seeds:
        m = run.run_window(cell, seed, seconds, False, control)
        res = run.judge(cell.A, m, limit, op)
        out.append({"workload": cell.name, "control": control, "seed": seed,
                    "correct": res["correct"], "solves": res["attempted"],
                    "checked": len(m.relres),
                    "relres_max": max(m.relres), "relres_min": min(m.relres),
                    "iterations": m.iterations,
                    "solve_ms": res["metrics"]["solve_ms"]["value"]})
        print(json.dumps(out[-1]), flush=True)
        del m
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    run.cache_env(ROOT)
    cell = run.set_up(ROOT, args.workload, args.device)
    op = residual.Operator(cell.A, cell.device)
    recs = readings(cell, args.seeds, False, args.seconds, op)
    recs += readings(cell, args.control_seeds, True, args.seconds, op)
    lower = max(r["relres_max"] for r in recs if not r["control"])
    upper = min(r["relres_max"] for r in recs if r["control"])
    summary = {"workload": args.workload, "lower": lower, "upper": upper,
               "limit": float(cell.cfg["limits"]["relres_max"]),
               "program_correct": sum(r["correct"] for r in recs
                                      if not r["control"]),
               "control_correct": sum(r["correct"] for r in recs
                                      if r["control"])}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in recs + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
