"""Frozen copy of ``ngsamg_tpu_torch/utils/timing.py``'s ``cold_ms``: the
median time of one call between two CUDA events, each right after a write
that sweeps the L2, so that the call finds its inputs in device memory only
and the sweep keeps the card busy while the host enqueues the call. The
benchmark owns this copy so that a later change to the program's timers
cannot change the yardstick. Needs a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

L2_SWEEP_BYTES = 512 * 1024 * 1024  # ten times an H100's 50 MB L2


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


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
