"""Share of the multicolour Gauss-Seidel colour steps that the program's
hand-written sweep kernel ran, in %: the program's
``SolveInfo.gs_kernel_steps`` over its ``SolveInfo.colour_steps``, both
summed over the window's unprofiled solves (host counts, no device read).
None where the program does not count the kernel's steps or ran no colour
step."""

from benchmark import spans


def read(run):
    kernel = spans.mean_info(run.window.infos, "gs_kernel_steps")
    steps = spans.mean_info(run.window.infos, "colour_steps")
    if kernel is None or not steps:
        return None
    return 100.0 * kernel / steps
