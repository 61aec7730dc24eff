"""The reader of ``tile_ell_kernel_share``: 100 x the window's summed
``SolveInfo.tile_ell_kernel_matvecs`` over its summed ``tile_ell_matvecs``,
None from a program that does not count the kernel's matvecs or ran no
tile-ELL matvec, and 0 on a tiny unstructured cell on the CPU, where every
tile-ELL matvec is the plain product."""

import json
import shutil
import types

import pytest

from benchmark import run, spec
from benchmark.tests.conftest import DATA, ROOT, make_tree

SEED = 2**31 + 25
NAME = "tile_ell_kernel_share"


def _run(infos):
    return types.SimpleNamespace(window=types.SimpleNamespace(infos=infos))


def _info(total, kernel):
    return types.SimpleNamespace(tile_ell_matvecs=total,
                                 tile_ell_kernel_matvecs=kernel)


def test_entry_lists_the_tile_ell_cells():
    bench = spec.load(ROOT)
    assert spec.validate(bench, ROOT) == []
    m = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_counter",
                 "layer": "formats and kernels", "moves": "solve_ms",
                 "workloads": ["poisson3d_101_gs.solve",
                               "unstructured_poisson_55.solve"]}
    assert bench["per_layer"][-1] is m


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree of ``conftest.make_tree`` with a tiny unstructured
    cell."""
    tree = make_tree(tmp_path_factory.mktemp("tile_ell_kernel_tree"))
    shutil.copy(DATA / "unstructured_tiny.json",
                tree / "benchmark" / "configs")
    bench = spec.load(tree)
    bench["configs"].append(
        {"name": "unstructured_tiny", "source": "test-only",
         "file": "benchmark/configs/unstructured_tiny.json", "reduced": [],
         "why": "a CPU test's size"})
    bench["workloads"].append(
        {"name": "unstructured_tiny.solve", "config": "unstructured_tiny",
         "traffic": "solve_tiny", "chips": 1, "why": "a CPU test's size"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tree


def test_reader_is_the_share_of_the_windows_sums(tree):
    read = spec.reader(tree, NAME)
    assert read(_run([_info(600, 600), _info(700, 700)])) == 100.0
    assert read(_run([_info(600, 0), _info(200, 200)])) == 25.0


def test_reader_gives_none_without_the_count_or_a_matvec(tree):
    read = spec.reader(tree, NAME)
    old = [types.SimpleNamespace(tile_ell_matvecs=88)] * 2
    assert read(_run(old)) is None
    assert read(_run([_info(0, 0)] * 3)) is None
    assert read(_run([])) is None


def test_plain_products_read_zero_on_the_cpu(tree):
    res = run.run_cell(tree, "unstructured_tiny.solve", SEED, 0.2, True,
                       device="cpu")
    assert res["correct"]
    m = res["metrics"][NAME]
    assert m == {"value": 0.0, "unit": "%"}
