"""The reader of ``host_residuals_per_solve``: the window's mean of the
program's ``SolveInfo.host_residuals``, None from a program that does not
count them, and 0 on the tiny GS and lattice cells, whose f64 defect
correction runs on the device."""

import json
import shutil
import types

import pytest

from benchmark import run, spec
from benchmark.tests.conftest import DATA, make_tree

SEED = 2**31 + 23
NAME = "host_residuals_per_solve"


def _run(infos):
    return types.SimpleNamespace(window=types.SimpleNamespace(infos=infos))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree of ``conftest.make_tree`` with the tiny GS cell."""
    tree = make_tree(tmp_path_factory.mktemp("residuals_tree"))
    shutil.copy(DATA / "gs_tiny.json", tree / "benchmark" / "configs")
    bench = spec.load(tree)
    bench["configs"].append(
        {"name": "gs_tiny", "source": "test-only",
         "file": "benchmark/configs/gs_tiny.json", "reduced": [],
         "why": "a CPU test's size"})
    bench["workloads"].append(
        {"name": "gs_tiny.solve", "config": "gs_tiny",
         "traffic": "solve_tiny", "chips": 1, "why": "a CPU test's size"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tree


def test_reader_is_the_windows_mean(tree):
    read = spec.reader(tree, NAME)
    infos = [types.SimpleNamespace(host_residuals=v) for v in (0, 2, 4)]
    assert read(_run(infos)) == 2.0


def test_reader_gives_none_without_the_field(tree):
    read = spec.reader(tree, NAME)
    old = [types.SimpleNamespace(iterations=3, relres=1e-9)] * 2
    assert read(_run(old)) is None


@pytest.mark.parametrize("cell", ["gs_tiny.solve", "lattice_tiny.solve"])
def test_device_refinement_reads_zero(tree, cell):
    res = run.run_cell(tree, cell, SEED, 0.2, True, device="cpu")
    assert res["correct"]
    m = res["metrics"][NAME]
    assert m["unit"] == "residuals/solve" and m["value"] == 0.0
