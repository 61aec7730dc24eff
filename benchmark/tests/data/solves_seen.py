"""Test-only per-layer metric: the number of solves the run made."""


def read(run):
    return float(len(run.infos))
