"""PCG iterations per solve: the mean of the program's
``SolveInfo.iterations`` over every solve of the run (window and traced)."""


def read(run):
    if not run.infos:
        return None
    return sum(int(i.iterations) for i in run.infos) / len(run.infos)
