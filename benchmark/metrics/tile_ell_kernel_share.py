"""Share of the tile-ELL matvecs that the program's hand-written tile-ELL
kernel ran, in %: the program's ``SolveInfo.tile_ell_kernel_matvecs`` over
its ``SolveInfo.tile_ell_matvecs`` (every ``TileELL`` and ``TileELLStack``
application, a stack once), both summed over the window's unprofiled
solves (host counts, no device read). None where the program does not
count the kernel's matvecs or ran no tile-ELL matvec."""


def read(run):
    infos = run.window.infos
    kernel = [getattr(i, "tile_ell_kernel_matvecs", None) for i in infos]
    total = [getattr(i, "tile_ell_matvecs", None) for i in infos]
    if None in kernel or None in total or not sum(total):
        return None
    return 100.0 * sum(kernel) / sum(total)
