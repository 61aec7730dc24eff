"""The harness finds configurations, mixes and metrics by name, and
``BENCHMARK.json`` keeps to the naming rules."""

import json
import re

import pytest

from benchmark import drive, run, spec
from benchmark.tests.conftest import ROOT

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
ENTRY = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_added_files_are_found_by_name(tiny_tree):
    bench = spec.load(tiny_tree)
    assert spec.validate(bench, tiny_tree) == []
    assert spec.config(tiny_tree, "lattice_tiny")["problem"]["params"] == {
        "n": 20}
    drive.check_mix(spec.traffic(tiny_tree, "solve_tiny"))
    read = spec.reader(tiny_tree, "solves_seen")
    assert read(type("R", (), {"infos": [1, 2, 3]})()) == 3.0
    res = run.run_cell(tiny_tree, "lattice_tiny.solve", 5, 0.2, True,
                       device="cpu")
    assert res["correct"]
    assert res["metrics"]["solves_seen"] == {
        "value": float(res["attempted"]), "unit": "solves"}


def test_a_missing_file_is_named(tiny_tree, tmp_path):
    bench = spec.load(tiny_tree)
    bench["per_layer"].append({**bench["per_layer"][0], "name": "absent"})
    bench["workloads"][0] = {**bench["workloads"][0], "traffic": "absent"}
    bad = spec.validate(bench, tiny_tree)
    assert any("metric absent" in b for b in bad)
    assert any("traffic absent" in b for b in bad)
    with pytest.raises(KeyError):
        spec.workload(bench, "absent.solve")


def test_benchmark_json_keeps_the_rules():
    bench = spec.load(ROOT)
    assert set(bench) == TOP
    assert spec.validate(bench, ROOT) == []
    for kind, keys in ENTRY.items():
        for e in bench[kind]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
    for e in bench["configs"] + bench["workloads"]:
        assert LINE.fullmatch(e["why"])
    for e in bench["configs"]:
        assert LINE.fullmatch(e["source"])
        assert e["file"].startswith("benchmark/")
        assert spec.config(ROOT, e["name"])["reduced"] == e["reduced"]
    for m in bench["per_layer"]:
        assert LINE.fullmatch(m["layer"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1:] == ["benchmark/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # every name a file of ours is named from keeps to the name's letters
    for name in [m["name"] for m in bench["per_layer"]]:
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").exists()
    assert len(json.dumps(bench)) < 64 * 1024
