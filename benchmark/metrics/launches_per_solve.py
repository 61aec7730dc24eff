"""Device kernels per traced solve, copies and memsets apart, from the
profiler's trace."""


def read(run):
    tr = run.trace
    if tr is None or tr.device_events == 0:
        return None
    return tr.launches / tr.solves
