"""Share of a solve in which the device is idle:
100 x (1 - the union of the device intervals of the traced solves over the
wall time of as many unprofiled solves, at the window's median latency).
The profiler slows the host's dispatch and not the kernels, so the
unprofiled solve is the right denominator; it can read below 0 where the
device is busy all along and the profiler lengthens the kernels."""

import statistics


def read(run):
    tr = run.trace
    if tr is None or tr.device_events == 0 or not run.window.latencies:
        return None
    wall = tr.solves * statistics.median(run.window.latencies)
    return 100.0 * (1.0 - tr.busy_s / wall)
