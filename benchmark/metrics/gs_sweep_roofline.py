"""Share of the roofline of a V-cycle's multicolour Gauss-Seidel sweeps:
the least time of one forward and one backward float32 sweep of every
smoothed level, by ``benchmark/gs_work.py``'s count of the work, over the
device time of the same sweeps on the staged levels (``smooth`` and
``smooth_back`` of each level's smoother, from a nonzero ``x``, each after
an L2-sweeping write).

The device time is the union of the intervals of the sweep's kernels and
copies in a ``torch.profiler`` trace, so the host's pace between launches
does not enter it; each level and direction takes the median of ``REPS``
sweeps.
Level 0 is counted from the problem's matrix; the coarser levels, which the
problem does not define, from the program's Galerkin operators read back as
scipy matrices. None off the card and where the levels are not scalar
multicolour GS levels."""

import statistics
import sys
import time

import numpy as np
import torch

from benchmark import devtrace, gs_work, roofline, timing

REPS = 5
RECORD = "bench.gs_sweep"
SETTLE_S = 0.004  # the device's idle time on each side of a record


def sweep_device_s(events, record: str = RECORD,
                   margin_us: float = 0.5e6 * SETTLE_S) -> list[float]:
    """Device seconds of each host ``record`` of ``events``
    (``devtrace.events_of``), in the records' order: the union of the
    device intervals that fall in the record widened by ``margin_us`` on
    each side. The profiler places the device's events on the host's clock
    up to a few hundred microseconds off, and the offset moves within a
    profile; the reader leaves the device idle for ``SETTLE_S`` on each
    side of a record, so that the margin takes in the whole sweep and
    nothing before or after it."""
    recs = sorted((a, b) for name, on_device, a, b in events
                  if name == record and not on_device)
    dev = [(a, b) for name, on_device, a, b in events
           if on_device and name != record]
    out = []
    for lo, hi in recs:
        lo, hi = lo - margin_us, hi + margin_us
        busy = devtrace._union((max(a, lo), min(b, hi)) for a, b in dev
                               if b > lo and a < hi)
        out.append(sum(b - a for a, b in busy) / 1e6)
    return out


def read(run):
    if run.device.type != "cuda" or run.block_size != 1:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    from ngsamg_tpu_torch.smoothers.core import (GSSmoother, smooth,
                                                 smooth_back)
    from ngsamg_tpu_torch.sparse import bell

    levels = run.pc.op.levels[:-1]
    if not levels or not all(isinstance(lev.smoother, GSSmoother)
                             and isinstance(lev.A, bell.BlockELL)
                             for lev in levels):
        return None
    g = np.random.default_rng(0)
    cases = []  # (level, direction, sweep, smoother, A, x, b, bound s)
    for i, lev in enumerate(levels):
        sm, A = lev.smoother, lev.A
        n, dt = A.nrows, sm.Dinv.dtype
        x = torch.zeros((sm.Dinv.shape[0], 1), dtype=dt, device=run.device)
        b = torch.zeros_like(x)
        x[:n, 0] = torch.as_tensor(g.standard_normal(n), dtype=dt)
        b[:n, 0] = torch.as_tensor(g.standard_normal(n), dtype=dt)
        t, _ = roofline.bound_s(*gs_work.sweep_work(
            run.A if i == 0 else bell.to_scipy(A)))
        cases += [(i, "forward", smooth, sm, A, x, b, t),
                  (i, "backward", smooth_back, sm, A, x, b, t)]

    flush = torch.empty(timing.L2_SWEEP_BYTES, dtype=torch.uint8,
                        device=run.device)
    for _, _, fn, sm, A, x, b, _ in cases:
        fn(sm, A, x, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            for _, _, fn, sm, A, x, b, _ in cases:
                flush.zero_()
                torch.cuda.synchronize()
                time.sleep(SETTLE_S)
                with record_function(RECORD):
                    fn(sm, A, x, b)
                    torch.cuda.synchronize()
                time.sleep(SETTLE_S)
    del flush
    got = sweep_device_s(devtrace.events_of(prof))
    if len(got) != REPS * len(cases):
        return None
    bound = spent = 0.0
    for k, (i, way, _, sm, _, _, _, t) in enumerate(cases):
        s = statistics.median(got[k::len(cases)])
        bound += t
        spent += s
        print(f"[bench] gs sweep level {i} {way}, "
              f"{len(sm.color_bounds) - 1} colours: device {s * 1e6:.2f} "
              f"us, bound {t * 1e6:.2f} us", file=sys.stderr, flush=True)
    torch.cuda.synchronize()
    return 100.0 * bound / spent if spent > 0 else None
