"""The unstructured deployment ``unstructured_poisson_55``: its frozen
generator against the program's original, its file and entries, and its
two readers on a tiny unstructured cell on the CPU (the roofline reads on
a card only) and on a program that does not count tile-ELL matvecs."""

import json
import shutil
import types

import numpy as np
import pytest

from benchmark import run, spans, spec
from benchmark.problems import unstructured_poisson
from benchmark.tests.conftest import DATA, ROOT, make_tree
from ngsamg_tpu_torch.utils import fem

SEED = 2**31 + 55
NEW_METRICS = ("tile_ell_matvecs_per_solve", "tile_ell_roofline")


@pytest.mark.parametrize("n,dim,refine", [(4, 3, 0), (6, 3, 1), (9, 2, 1)])
def test_generator_is_the_original(n, dim, refine):
    A, coords = unstructured_poisson.generate(n, dim, 0, refine)
    p = fem.unstructured_poisson(n, dim=dim, seed=0, refine=refine)
    assert A.format == "csr" and A.shape == p.A.shape
    D = (A - p.A.tocsr()).tocsr()
    assert D.nnz == 0 or np.abs(D.data).max() == 0.0
    assert np.array_equal(A.indptr, p.A.tocsr().indptr)
    assert np.array_equal(coords, p.coords)


def test_config_parses_and_the_benchmark_validates():
    cfg = spec.config(ROOT, "unstructured_poisson_55")
    assert cfg["problem"] == {"generator": "unstructured_poisson",
                              "params": {"n": 55, "dim": 3, "seed": 0,
                                         "refine": 1}}
    assert cfg["dofs"] == 1411632
    assert cfg["setup"] == {"energy": "h1", "block_size": 1, "coords": True,
                            "flags": {"sm_type": "chebyshev"}}
    assert cfg["solve"] == {"tol": 1e-8}
    assert cfg["control"] == {"use_refinement": False}
    assert cfg["limits"] == {"relres_max": 1e-8}
    assert cfg["reduced"] == []
    bench = spec.load(ROOT)
    assert spec.validate(bench, ROOT) == []
    cell = spec.workload(bench, "unstructured_poisson_55.solve")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "unstructured_poisson_55", "solve", 1)
    listed = {m["name"] for m in bench["per_layer"]
              if spec.applies(m, cell["name"])}
    assert listed == {
        "setup_host_s", "staging_s", "pcg_iterations", "launches_per_solve",
        "l0_matvec_roofline", "device_idle_pct", "setup_mesh_s",
        "setup_coarsen_s", "setup_prol_s", "setup_rap_s", "dispatch_ms",
        "host_syncs_per_solve", "host_residuals_per_solve", *NEW_METRICS}
    # the GS cell's tile-ELL transfers give both readers something to read
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == ["poisson3d_101_gs.solve", cell["name"]]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree of ``conftest.make_tree`` with a tiny unstructured
    cell."""
    tree = make_tree(tmp_path_factory.mktemp("unstructured_tree"))
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


def test_readers_on_a_tiny_unstructured_cell(tree, monkeypatch):
    assert spec.validate(spec.load(tree), tree) == []
    seen = []  # the SolveInfos the counter's reader averages

    def mean_info(infos, field, _orig=spans.mean_info):
        if field == "tile_ell_matvecs":
            seen.extend(infos)
        return _orig(infos, field)

    monkeypatch.setattr(spans, "mean_info", mean_info)
    c = run.set_up(tree, "unstructured_tiny.solve", "cpu")
    assert type(c.pc.op.levels[0].A).__name__ == "TileELLStack"
    assert c.pc.op.cluster_corr is not None
    m = run.run_window(c, SEED, 0.3, True)
    res = run.judge(c.A, m, float(c.cfg["limits"]["relres_max"]))
    assert res["correct"]
    got = res["metrics"]["tile_ell_matvecs_per_solve"]
    assert got["unit"] == "matvecs/solve"
    # the mean over the window's unprofiled solves, none of them traced
    counts = [i.tile_ell_matvecs for i in seen]
    assert len(counts) == m.attempted - int(c.mix["traced_solves"])
    assert counts and min(counts) > 0
    assert got["value"] == pytest.approx(sum(counts) / len(counts))
    # the roofline is read on a card only
    assert "tile_ell_roofline" not in res["metrics"]


def test_counter_reader_is_the_windows_mean(tree):
    read = spec.reader(tree, "tile_ell_matvecs_per_solve")
    infos = [types.SimpleNamespace(tile_ell_matvecs=v) for v in (700, 900)]
    assert read(types.SimpleNamespace(
        window=types.SimpleNamespace(infos=infos))) == 800.0
    # a program whose SolveInfo has no such counter
    old = [types.SimpleNamespace(iterations=3)]
    assert read(types.SimpleNamespace(
        window=types.SimpleNamespace(infos=old))) is None


def test_roofline_reader_reads_nothing_off_the_card(tree):
    read = spec.reader(tree, "tile_ell_roofline")
    run_ = types.SimpleNamespace(device=types.SimpleNamespace(type="cpu"),
                                 block_size=1)
    assert read(run_) is None
