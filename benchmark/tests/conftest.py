"""Fixtures of the benchmark's CPU tests.

``tiny_tree`` is a checkout-like tree in a temporary directory: the
benchmark's configurations, mixes and metric readers, the test-only files of
``tests/data`` beside them, and a ``BENCHMARK.json`` whose cells are the
test-only ones. The harness finds all of it by name, as it finds a later
change's files; run on the CPU with ``device="cpu"``, the program takes its
plain PyTorch paths.

Tests that need an NVIDIA GPU carry the ``cuda`` marker and skip without
one.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# the harness runs in the test process; xdist workers share the cores
torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELLS = {"lattice_tiny.solve": "lattice_tiny",
              "elasticity_tiny.solve": "elasticity_tiny"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def make_tree(dest: Path) -> Path:
    """A tree holding the benchmark's data files, the test-only ones and a
    ``BENCHMARK.json`` of the test-only cells."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, dest / "benchmark" / sub)
    for cfg in TINY_CELLS.values():
        shutil.copy(DATA / f"{cfg}.json", dest / "benchmark" / "configs")
    shutil.copy(DATA / "solve_tiny.json", dest / "benchmark" / "traffic")
    shutil.copy(DATA / "solves_seen.py", dest / "benchmark" / "metrics")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] += [
        {"name": cfg, "source": "test-only",
         "file": f"benchmark/configs/{cfg}.json", "reduced": [],
         "why": "a CPU test's size"} for cfg in TINY_CELLS.values()]
    bench["workloads"] = [
        {"name": cell, "config": cfg, "traffic": "solve_tiny", "chips": 1,
         "why": "a CPU test's size"} for cell, cfg in TINY_CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"].append(
        {"name": "solves_seen", "unit": "solves", "better": "higher",
         "source": "program_counter", "layer": "test", "moves": "solve_ms"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory) -> Path:
    return make_tree(tmp_path_factory.mktemp("tree"))
