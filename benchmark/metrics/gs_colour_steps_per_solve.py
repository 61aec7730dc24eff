"""Colour steps of the multicolour Gauss-Seidel sweeps a solve: the mean of
the program's ``SolveInfo.colour_steps`` (over every level, sweep, step and
pass; counted on the host as the sweeps run) over the window's unprofiled
solves."""

from benchmark import spans


def read(run):
    return spans.mean_info(run.window.infos, "colour_steps")
