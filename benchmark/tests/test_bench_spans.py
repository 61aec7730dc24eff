"""The readers of the program's spans and counters (``benchmark/
spans.py``): on the tiny CPU cells each of the six gives a number, and on
a program that keeps no such record each gives None."""

import types

import pytest

from benchmark import run, spec

SEED = 2**31 + 23
READERS = ["setup_mesh_s", "setup_coarsen_s", "setup_prol_s",
           "setup_rap_s", "dispatch_ms", "host_syncs_per_solve"]


@pytest.mark.parametrize("cell", ["lattice_tiny.solve",
                                  "elasticity_tiny.solve"])
def test_span_readers_give_numbers(tiny_tree, cell):
    res = run.run_cell(tiny_tree, cell, SEED, 0.3, True, device="cpu")
    assert res["correct"]
    m = res["metrics"]
    for name in READERS:
        assert name in m, name
        assert m[name]["value"] >= 0
    assert m["host_syncs_per_solve"]["value"] > m["pcg_iterations"]["value"]
    assert m["dispatch_ms"]["value"] > 0
    phases = sum(m[n]["value"] for n in READERS[:4])
    assert 0 < phases <= m["setup_host_s"]["value"]


def test_span_readers_give_none_without_a_record(tiny_tree):
    """A program without spans or counters (no ``trace_``, a
    ``SolveInfo`` without the fields): every reader gives None."""
    info = types.SimpleNamespace(iterations=3, relres=1e-9)
    fake = types.SimpleNamespace(
        pc=types.SimpleNamespace(setup_time_host=1.0),
        window=types.SimpleNamespace(infos=[info, info]), infos=[info])
    for name in READERS:
        assert spec.reader(tiny_tree, name)(fake) is None, name
