"""Staging seconds of the run's one setup (``pc.setup_time_device``:
``precond/amg.py::_compile_device``, which ends in a synchronise)."""


def read(run):
    return float(run.pc.setup_time_device)
