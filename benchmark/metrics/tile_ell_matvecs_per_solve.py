"""Applications of tile-ELL operators a solve: the mean of the program's
``SolveInfo.tile_ell_matvecs`` (every ``TileELL`` and ``TileELLStack``
matvec of the solve, levels, transfers and the float64 twin, a stack once
whatever its buckets; counted on the host, no device read) over the
window's unprofiled solves. None where the program does not count them."""

from benchmark import spans


def read(run):
    return spans.mean_info(run.window.infos, "tile_ell_matvecs")
