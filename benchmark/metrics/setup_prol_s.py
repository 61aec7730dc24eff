"""Host seconds of the set-up's ``setup.prol`` phase: the summed self time of
its spans in the run's one set-up (each level's prolongation: the implicit
lattice plan or the piecewise or smoothed prolongation with the finest
embedding, and on stencil levels the Gershgorin bound and omega). Read from
the program's recorder, ``pc.trace_``."""

from benchmark import spans


def read(run):
    return spans.setup_self_s(run.pc, "setup.prol")
