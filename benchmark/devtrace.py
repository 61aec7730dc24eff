"""Reduction of a ``torch.profiler`` trace of the traced solves.

The busy-time arithmetic is a copy of ``ngsamg_tpu_torch/utils/
trace_solve.py`` (the union of the device events' intervals, overlapping
events counted once; kernel launches are the device events that are not
copies or memsets). Only what lies inside a ``SPAN`` record counts: the
traced window is the sum of the records' lengths, in the profiler's own
clock, so that the harness's work between solves is left out.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SPAN = "bench.solve"
TOP = 10
NAME_CHARS = 160  # of a kernel name in the breakdown
SCAN = 64
PYTHON = "python (no op recorded)"


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    solves: int  # SPAN records in the trace
    device_events: int
    launches: int  # device kernels, copies and memsets apart
    busy_s: float  # union of device intervals inside the SPAN records
    span_s: float  # the SPAN records' summed length, profiler's clock
    device_ops: list = field(default_factory=list)  # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds]]


def events_of(prof) -> list[tuple[str, bool, float, float]]:
    """``(name, on_device, start_us, end_us)`` of every event of a finished
    ``torch.profiler.profile``, from the profiler's raw results, about
    twenty times faster than building ``prof.events()``' tree."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def reduce(events) -> Trace:
    """``events``: ``events_of`` a profile holding ``SPAN`` records."""
    dev, host, spans = [], [], []
    for name, on_device, a, b in events:
        if name == SPAN:
            # the record on the host; its mirror on the device's timeline
            # (a user annotation, no work) is left out
            if not on_device:
                spans.append((a, b))
        elif on_device:
            dev.append((a, b, name))
        else:
            host.append((a, b, name))
    if not spans:
        raise ValueError(f"the trace holds no {SPAN!r} record")
    host.sort()
    starts = [a for a, _, _ in host]

    by_name: dict[str, float] = {}
    idle: dict[str, float] = {}
    launches = n_dev = 0
    busy_us = span_us = 0.0
    for lo, hi in sorted(spans):
        span_us += hi - lo
        inside = [(max(a, lo), min(b, hi), name) for a, b, name in dev
                  if b > lo and a < hi]
        busy = _union((a, b) for a, b, _ in inside)
        busy_us += sum(b - a for a, b in busy)
        n_dev += len(inside)
        for a, b, name in inside:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            if not name.lower().startswith(("memcpy", "memset")):
                launches += 1
        # idle gaps, named by the innermost host event (the latest-starting
        # one) that covers each gap's midpoint, looked for among the SCAN
        # events that started last; PYTHON where none covers it (the host
        # between ops)
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = PYTHON
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(last - SCAN, -1), -1):
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
            idle[name] = idle.get(name, 0.0) + (b - a)
    device_ops = [[name[:NAME_CHARS], us / 1e6] for name, us in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    idle_gaps = [[name[:NAME_CHARS], us / 1e6] for name, us in
                 sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(
        solves=len(spans), device_events=n_dev, launches=launches,
        busy_s=busy_us / 1e6, span_s=span_us / 1e6,
        device_ops=device_ops, idle_gaps=idle_gaps,
    )
