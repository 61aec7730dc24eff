"""Host milliseconds a solve spends outside blocking reads: the mean of the
program's ``SolveInfo.dispatch_s`` (the solve's host time less the time
the host waited in reads and copies that drain the device) over the
window's unprofiled solves, x 1e3."""

from benchmark import spans


def read(run):
    v = spans.mean_info(run.window.infos, "dispatch_s")
    return None if v is None else 1e3 * v
