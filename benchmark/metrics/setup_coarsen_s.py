"""Host seconds of the set-up's ``setup.coarsen`` phase: the summed self time
of its spans in the run's one set-up (the coarse maps, ``map_edges`` and
``map_data`` of each level). Read from the program's recorder,
``pc.trace_``."""

from benchmark import spans


def read(run):
    return spans.setup_self_s(run.pc, "setup.coarsen")
