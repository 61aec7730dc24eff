"""Share of the roofline of one float32 matvec of every staged tile-ELL
operator (``TileELL`` or ``TileELLStack``: each level's ``A``, ``P`` and
``R``), summed over the operators, one matvec each: the least time of each
by ``benchmark/roofline.py``'s count of the work (``block_matvec_work(M,
1)``), over the device time of the same matvecs on the staged operators.

The count is taken from the problem's matrix for level 0's ``A`` and from
the program's host matrices for the rest (``pc.setup_levels_``: ``A``,
``P``, and ``R`` = P^T), never from the tile-ELL storage, so its padding
counts as waste. The device time is measured as ``gs_sweep_roofline``
measures a sweep: the union of the device intervals within a
``torch.profiler`` record, after an L2-sweeping write and with the device
left idle on both sides, so that the host's pace between launches does not
enter it; each operator takes the median of ``REPS`` matvecs. None off the
card and where no operator is tile-ELL."""

import statistics
import sys
import time

import numpy as np
import torch

from benchmark import devtrace, roofline, timing
from benchmark.metrics.gs_sweep_roofline import SETTLE_S, sweep_device_s

REPS = 5
RECORD = "bench.tile_ell_matvec"


def _operators(run):
    """(label, staged operator, host matrix) of every tile-ELL operator."""
    from ngsamg_tpu_torch.sparse import formats

    tile = (formats.TileELL, formats.TileELLStack)
    out = []
    for i, (lev, host) in enumerate(zip(run.pc.op.levels,
                                        run.pc.setup_levels_)):
        mats = {"A": run.A if i == 0 else host.A, "P": host.P,
                "R": None if host.P is None else host.P.T}
        for what in ("A", "P", "R"):
            T = getattr(lev, what)
            if isinstance(T, tile) and mats[what] is not None:
                out.append((f"{what}{i}", T, mats[what]))
    return out


def read(run):
    if run.device.type != "cuda" or run.block_size != 1:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    cases = []  # (label, operator, x, bound s)
    g = np.random.default_rng(0)
    for label, T, M in _operators(run):
        x = torch.zeros((T.ncols_pad, 1), dtype=torch.float32,
                        device=run.device)
        x[: M.shape[1], 0] = torch.as_tensor(
            g.standard_normal(M.shape[1]), dtype=torch.float32)
        t, _ = roofline.bound_s(*roofline.block_matvec_work(M, 1))
        cases.append((label, T, x, t))
    if not cases:
        return None

    flush = torch.empty(timing.L2_SWEEP_BYTES, dtype=torch.uint8,
                        device=run.device)
    for _, T, x, _ in cases:
        T.matvec(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            for _, T, x, _ in cases:
                flush.zero_()
                torch.cuda.synchronize()
                time.sleep(SETTLE_S)
                with record_function(RECORD):
                    T.matvec(x)
                    torch.cuda.synchronize()
                time.sleep(SETTLE_S)
    del flush
    got = sweep_device_s(devtrace.events_of(prof), RECORD)
    if len(got) != REPS * len(cases):
        return None
    bound = spent = 0.0
    for k, (label, T, _, t) in enumerate(cases):
        s = statistics.median(got[k::len(cases)])
        bound += t
        spent += s
        print(f"[bench] tile-ELL {label} {type(T).__name__}, {T.nrows} rows: "
              f"device {s * 1e6:.2f} us, bound {t * 1e6:.2f} us",
              file=sys.stderr, flush=True)
    torch.cuda.synchronize()
    return 100.0 * bound / spent if spent > 0 else None
