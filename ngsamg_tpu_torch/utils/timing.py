"""Device timers for the kernels (CUDA only; used by chip_smoke.py and by
throw-away timing scripts, never by the solve path).

- :func:`event_ms`: one call between two CUDA events. For a small kernel
  this is mostly the wrapper's host time.
- :func:`graph_ms`: device time per launch, from the replay of a CUDA graph
  of many launches. The launches follow each other at once, so whatever
  fits the 50 MB L2 stays there between them (a warm time).
- :func:`cold_ms`: one call between two events right after a write that
  sweeps the L2, so that the kernel finds its inputs in device memory
  only. The sweep also keeps the card busy while the host enqueues the
  call, which keeps the wrapper's host time out of the reading.
"""

from __future__ import annotations

import numpy as np
import torch

GRAPH_LAUNCHES = 50
L2_SWEEP_BYTES = 512 * 1024 * 1024  # ten times an H100's 50 MB L2


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def event_ms(fn, reps: int = 25) -> float:
    """Median time of one call between two CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = _events()
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def graph_ms(fn, n: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """Device time per launch: CUDA events around the replay of a CUDA
    graph that holds ``n`` calls of ``fn``, over ``n`` (median of ``reps``
    replays). ``fn`` is warmed up first, so every staged cache is filled
    before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = _events()
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    del graph
    torch.cuda.synchronize()
    return float(np.median(times))


def cold_ms(fn, reps: int = 11) -> float:
    """Median time of one call that follows a sweep of the L2."""
    sweep = torch.empty(L2_SWEEP_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        sweep.zero_()
        s, e = _events()
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    del sweep
    return float(np.median(times))
