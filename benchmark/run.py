"""The benchmark of ngsamg_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. The cell
(an entry of ``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<name>.json``: the problem's generator and parameters,
the AMG options, the solve's arguments, the check's limit) and a traffic mix
(``benchmark/traffic/<name>.json``). A run:

1. makes the problem (``benchmark/problems``, cached in ``build/``), runs
   the one ``AMGPreconditioner(A, ...).setup()`` and the mix's warm-up
   solves: that is the set-up (``setup_s``);
2. solves back to back for ``--seconds``, each solve on a right-hand side
   of its own drawn from ``--seed`` (``solve_ms``: the solves' latencies
   over their number; ``solve_p95_ms``: the 95th percentile of them);
3. with ``--trace 1``, profiles a few more solves and reads each per-layer
   metric (``benchmark/metrics/<name>.py``) in place of the end-to-end ones;
4. reads the program's device memory peak, frees the program's state, and
   checks a sample of the window's answers, drawn from the seed, and every
   traced one with the plain float64 residual of ``benchmark/reference``:
   ``correct`` when the largest relative residual is within the
   configuration's limit.

``set_up``, ``run_window`` and ``judge`` are the three steps;
``benchmark/control.py`` runs the last two for many seeds on one set-up.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), then ``checks``: each number compared with its limit, which
also end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # run as a script: import the benchmark as a package from the checkout
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import devtrace, drive, problems, spec  # noqa: E402
from benchmark.reference import residual  # noqa: E402

PROGRAM = "ngsamg_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "ngsamg_tpu"}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's own builds already go to ``build/`` beside it."""
    b = Path(root) / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(b / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(b / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(b / "cuda_cache")


@dataclass
class Run:
    """What a per-layer metric's reader may read."""

    pc: object  # the program's AMGPreconditioner, set up
    A: object  # the benchmark's matrix (scipy)
    block_size: int
    device: torch.device
    window: drive.Window
    infos: list  # SolveInfo of every solve, window and traced
    trace: object  # devtrace.Trace, or None without --trace 1


END_TO_END = {
    "solve_ms": lambda r, s: 1e3 * r.window.solve_s,
    "solve_p95_ms": lambda r, s: 1e3 * float(
        np.percentile(r.window.latencies, 95)),
    "setup_s": lambda r, s: s["setup_s"],
}


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _traced(solve, rhs, first: int, count: int, device):
    """``count`` solves under torch.profiler, each in a ``devtrace.SPAN``
    record; the right-hand sides are drawn, and the answers kept, between
    the records, as in the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    answers, infos = [], []
    with profile(activities=acts) as prof:
        for k in range(first, first + count):
            b = rhs.draw(k)
            drive.sync(device)
            with record_function(devtrace.SPAN):
                x, info = solve(b)
                drive.sync(device)
            answers.append((k, drive.to_host(x)))
            infos.append(info)
            del x
    return answers, infos, devtrace.reduce(devtrace.events_of(prof))


@dataclass
class Cell:
    """A cell's files and its program, set up."""

    root: Path
    name: str
    t_start: float  # the process's start: set-up runs from here
    bench: dict  # BENCHMARK.json
    entry: dict  # the cell's entry of ``workloads``
    cfg: dict
    mix: dict
    device: torch.device
    A: object  # the benchmark's matrix; the program set up on a copy
    pc: object  # the program's AMGPreconditioner

    def solver(self, control: bool = False):
        """The window's call: ``pc.solve`` with the configuration's
        arguments, or with its ``control`` arguments (the lower-precision
        path that has to come out not correct)."""
        kw = dict(self.cfg["solve"])
        if control:
            kw.update(self.cfg["control"])
        kw["return_device"] = bool(self.mix["return_device"])
        pc = self.pc

        def solve(b):
            return pc.solve(b, **kw)

        return solve


def set_up(root: Path, name: str, device: str = "cuda",
           t_start: float = T_START) -> Cell:
    """Find the cell's files by name, make its problem and set the program
    up on it with the one ``AMGPreconditioner(A, ...).setup()``."""
    root = Path(root)
    bench = spec.load(root)
    entry = spec.workload(bench, name)
    cfg = spec.config(root, entry["config"])
    mix = spec.traffic(root, entry["traffic"])
    drive.check_mix(mix)
    dev = torch.device(device)

    from ngsamg_tpu_torch import AMGPreconditioner
    from ngsamg_tpu_torch.config import options_from_flags

    if dev.type == "cuda":
        # the builds and the CUDA context before anything is timed: only a
        # checkout's first run compiles, and it does so here
        from ngsamg_tpu_torch import native
        from ngsamg_tpu_torch.ops import cuda_lib

        native.extension()
        cuda_lib.library()
        torch.empty(1, device=dev)
    A, coords = problems.load(cfg["problem"], root / "build" /
                              "bench_problems")
    log(f"{name}: {A.shape[0]} DoF, {A.format}, "
        f"{time.perf_counter() - t_start:.3f} s into set-up")
    st = cfg["setup"]
    kw = dict(energy=st["energy"], block_size=st["block_size"],
              options=options_from_flags(st["flags"]), device=dev)
    if st["coords"]:
        kw["coords"] = coords
    A_prog = A.copy()  # the program's own copy: the check reads A
    t0 = time.perf_counter()
    pc = AMGPreconditioner(A_prog, **kw).setup()
    amg_setup_s = time.perf_counter() - t0
    log(f"amg setup {amg_setup_s:.3f} s: host {pc.setup_time_host:.3f}, "
        f"staging {pc.setup_time_device:.3f}, {pc.num_levels} levels, "
        f"OC {pc.operator_complexity:.4f}")
    return Cell(root=root, name=name, t_start=t_start, bench=bench,
                entry=entry, cfg=cfg, mix=mix, device=dev, A=A, pc=pc)


@dataclass
class Measured:
    """What a run's window gives, the program's state left behind: the
    result line's numbers, and the answers to be checked."""

    seed: int
    rhs: drive.Rhs  # draws each checked answer's right-hand side again
    attempted: int
    metrics: dict
    device: dict
    breakdown: dict | None
    kept: list  # (solve index, host answer)
    iterations: float  # mean PCG iterations over the run's solves
    relres: list | None = None  # the check's readings, once judged


def run_window(c: Cell, seed: int, seconds: float, trace: bool,
               control: bool = False) -> Measured:
    """Warm-up solves, the window, the traced solves and the metrics on the
    set-up cell ``c``; the device's memory peak is the program's."""
    seed = int(seed) % 2**64
    dev, mix = c.device, c.mix
    solve = c.solver(control)
    cuda = dev.type == "cuda"
    if cuda:
        # the program's peak so far (its setup); from here the harness's
        # one device buffer is counted apart
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rhs = drive.Rhs(c.A.shape[0], seed, dev, mix["rhs_memory"])
    warm = int(mix["warmup_solves"])
    for k in range(warm):
        solve(rhs.draw(k))
        drive.sync(dev)
    times = {"setup_s": time.perf_counter() - c.t_start}
    log(f"set-up {times['setup_s']:.3f} s")

    window = drive.closed_loop(
        solve, rhs, warm, seconds, dev, int(mix["checked_solves"]),
        np.random.default_rng([seed, 1]))
    attempted = len(window.latencies)
    log(f"window {window.wall_s:.3f} s, {attempted} solves, "
        f"{1e3 * window.solve_s:.3f} ms a solve")
    kept, infos = list(window.kept), list(window.infos)
    tr = None
    if trace:
        answers, tinfos, tr = _traced(solve, rhs, warm + attempted,
                                      int(mix["traced_solves"]), dev)
        kept += answers
        infos += tinfos
        attempted += len(answers)
    run = Run(pc=c.pc, A=c.A, block_size=int(c.cfg["setup"]["block_size"]),
              device=dev, window=window, infos=infos, trace=tr)

    info = {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}
    if cuda:
        peak = max(setup_peak, torch.cuda.max_memory_allocated(dev)
                   - rhs.device_bytes)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": int(c.entry["chips"]),
                "memory_peak_bytes": int(peak),
                "power_limit": _power_limit()}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.span_s

    metrics = {}
    if trace:
        for m in c.bench["per_layer"]:
            if spec.applies(m, c.name):
                v = spec.reader(Path(c.root), m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
    else:
        for m in c.bench["end_to_end"]:
            if spec.applies(m, c.name):
                metrics[m["name"]] = {
                    "value": float(END_TO_END[m["name"]](run, times)),
                    "unit": m["unit"]}
    return Measured(
        seed=seed, rhs=rhs, attempted=attempted, metrics=metrics,
        device=info,
        breakdown=None if tr is None else {"device_ops": tr.device_ops,
                                           "idle_gaps": tr.idle_gaps},
        kept=kept,
        iterations=float(np.mean([i.iterations for i in infos])))


def judge(A, m: Measured, limit: float, op=None) -> dict:
    """The result line's object: every kept answer's plain float64
    residual, on its right-hand side drawn again, against ``limit``."""
    if op is None:
        op = residual.Operator(A, m.rhs.device)
    rel = [residual.relres(op, m.rhs.draw(k), x) for k, x in m.kept]
    m.relres = rel
    failed = sum(1 for r in rel if not r <= limit)
    result = {
        "correct": bool(rel) and failed == 0,
        "attempted": m.attempted,
        "failed": failed,
        "metrics": m.metrics,
        "device": m.device,
    }
    if m.breakdown is not None:
        result["breakdown"] = m.breakdown
    result["checks"] = {
        "relres_max": {"value": max(rel) if rel else float("inf"),
                       "limit": limit},
        "answers_checked": {"value": len(rel), "limit": 1},
    }
    log(f"checked {len(rel)} of {m.attempted} answers, mean "
        f"{m.iterations:.2f} iterations")
    return result


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             t_start: float = T_START) -> dict:
    """One run of the cell ``name``; returns the result line's object."""
    c = set_up(root, name, device, t_start)
    m = run_window(c, seed, seconds, trace, control)
    A, limit = c.A, float(c.cfg["limits"]["relres_max"])
    # the program's state goes before the reference runs on the device
    del c
    gc.collect()
    if m.rhs.device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(A, m, limit)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    chips = int(spec.workload(spec.load(ROOT), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import ngsamg_tpu_torch

    where = Path(ngsamg_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        log(f"{PROGRAM} is not in this checkout ({where})")
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"modules that must not load did: {', '.join(bad)}")
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
