"""Port parity for the tracing utilities (`utils/timers.py`).

``timer`` and ``report`` are copies: the same regions give the JAX
package's report format. ``device_region`` is a named range of the torch
profiler (the JAX package's is a ``jax.profiler.TraceAnnotation``), and
``trace`` a torch profiler that writes a Chrome trace when its block ends.
On this CPU-only machine the tests pass the CPU activity alone; the
card's trace (K1's kernel under the region) is checked by
``chip_smoke.py`` ``[timers]``.
"""

import glob
import json
import os
import re

import numpy as np
import torch

import ngsamg_tpu.utils.timers as jtimers
import ngsamg_tpu_torch
import ngsamg_tpu_torch.utils.timers as ttimers
from ngsamg_tpu_torch.utils import fem as tfem

torch.set_num_threads(2)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _normalized(report):
    """The report with its seconds column masked (wall clocks differ)."""
    return re.sub(r"\d+\.\d{3}", "#.###", report)


def test_timer_report_matches_jax_format():
    ttimers.report(reset=True)
    jtimers.report(reset=True)
    for mod in (jtimers, ttimers):
        for name, k in (("setup", 2), ("solve", 3), ("a_much_longer_name", 1)):
            for _ in range(k):
                with mod.timer(name):
                    pass
    rt, rj = ttimers.report(), jtimers.report()
    lines_t, lines_j = rt.splitlines(), rj.splitlines()
    assert lines_t[0] == lines_j[0]
    # same rows (order follows the measured totals, so compare as sets)
    assert sorted(_normalized(rt).splitlines()[1:]) == sorted(
        _normalized(rj).splitlines()[1:]
    )
    assert any(ln.split()[0] == "solve" and ln.split()[-1] == "3"
               for ln in lines_t[1:])
    assert _normalized(ttimers.report(reset=True)) == _normalized(rt)
    assert ttimers.report().splitlines() == [lines_t[0]]
    jtimers.report(reset=True)


def test_device_region_and_trace_write_a_chrome_trace(tmp_path):
    p = tfem.poisson_3d(12)
    opts = ngsamg_tpu_torch.AMGOptions(
        smoother=ngsamg_tpu_torch.SmootherOptions(
            type=ngsamg_tpu_torch.SmootherType.CHEBYSHEV
        )
    )
    pc = ngsamg_tpu_torch.AMGPreconditioner(
        p.A, coords=p.coords, options=opts, device="cpu"
    ).setup()
    logdir = str(tmp_path / "trace")
    with ttimers.trace(logdir, activities=CPU_ONLY) as prof:
        with ttimers.device_region("solve"):
            x, info = pc.solve(p.b, tol=1e-8)
    assert info.converged
    assert np.linalg.norm(p.A @ x - p.b) <= 1e-8 * np.linalg.norm(p.b)
    assert "solve" in {e.key for e in prof.key_averages()}
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "solve" in names
    assert "aten::add" in names or "aten::add_" in names


def test_trace_defaults_to_cpu_and_cuda():
    """Without ``activities`` the profiler records the card too: nothing
    is dropped because this machine has none."""
    prof = ttimers.trace("unused")
    assert set(prof.activities) == {
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    }
