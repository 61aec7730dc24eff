"""Host seconds of the set-up's ``setup.mesh`` phase: the summed self time of
its spans in the run's one set-up (the finest level's mesh: lattice
detection and compression on the stencil path, the energy's mesh on the
generic one). Read from the program's recorder, ``pc.trace_``."""

from benchmark import spans


def read(run):
    return spans.setup_self_s(run.pc, "setup.mesh")
