"""Tracing / profiling utilities.

Ported from ngsamg_tpu/utils/timers.py. The reference instruments every
significant function with NGSolve Timers + RegionTimers (e.g.
base_factory.cpp:223, amg_matrix.cpp:168-178 per-level cycle timers).
Here: named wall-clock accumulators for the host setup phase (``timer``,
``report``: copies), plus named ranges in the torch profiler's trace for
the device solve phase (``device_region``, the counterpart of
``jax.profiler.TraceAnnotation``) and a profiler context that writes a
Chrome/TensorBoard trace (``trace``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch

_ACC: dict[str, list] = defaultdict(lambda: [0.0, 0])


@contextlib.contextmanager
def timer(name: str):
    """Accumulating host timer (the reference's static Timer/RegionTimer)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc = _ACC[name]
        acc[0] += time.perf_counter() - t0
        acc[1] += 1


@contextlib.contextmanager
def device_region(name: str):
    """Named range in the torch profiler's trace
    (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def report(reset: bool = False) -> str:
    lines = ["timer                              total_s   calls"]
    for name in sorted(_ACC, key=lambda n: -_ACC[n][0]):
        tot, calls = _ACC[name]
        lines.append(f"{name:32s} {tot:9.3f} {calls:7d}")
    if reset:
        _ACC.clear()
    return "\n".join(lines)


def trace(logdir: str | None = None, activities=None):
    """Capture a profiler trace around a block:

    with trace(logdir) as prof:
        pc.solve(b)

    records ``activities`` (``torch.profiler.ProfilerActivity``; CPU and
    CUDA unless given) and writes a Chrome trace that TensorBoard's
    profiler plugin reads (``*.pt.trace.json``) under ``logdir`` (default:
    ``ngsamg_trace`` in the temporary directory) when the block ends.
    """
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "ngsamg_trace")
    if activities is None:
        activities = [
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    )
