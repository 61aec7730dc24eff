"""Host setup seconds of the run's one setup (``pc.setup_time_host``: the
level loop in ``factory/``, ``coarsen/``, ``transfer/``, ``apps/``,
``mesh/`` and ``native/``)."""


def read(run):
    return float(run.pc.setup_time_host)
