"""Blocking reads and copies a solve: the mean of the program's
``SolveInfo.host_syncs`` (each ``float``/``int`` of a device tensor,
``.cpu()`` and blocking host-to-device copy of the solve) over the
window's unprofiled solves."""

from benchmark import spans


def read(run):
    return spans.mean_info(run.window.infos, "host_syncs")
