"""f64 residuals computed on the host a solve: the mean of the program's
``SolveInfo.host_residuals`` (each scipy ``b - A x`` of its host
defect-correction loop, a host count with no device read) over the
window's unprofiled solves. None where the program does not count them."""

from benchmark import spans


def read(run):
    return spans.mean_info(run.window.infos, "host_residuals")
