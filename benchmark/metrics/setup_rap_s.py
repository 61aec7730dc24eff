"""Host seconds of the set-up's ``setup.rap`` phase: the summed self time of
its spans in the run's one set-up (each level's Galerkin product and pruning
(on stencil levels the fused smoothed RAP, which also builds the implicit
prolongation)). Read from the program's recorder, ``pc.trace_``."""

from benchmark import spans


def read(run):
    return spans.setup_self_s(run.pc, "setup.rap")
