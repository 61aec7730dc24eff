"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``<name>``: ``benchmark/configs/<name>.json``;
- a traffic mix ``<name>``: ``benchmark/traffic/<name>.json``, parameters
  that ``benchmark/drive.py`` reads;
- a per-layer metric ``<name>``: ``benchmark/metrics/<name>.py``, a module
  with ``read(run) -> float | None``.

A later change adds a configuration, a mix or a metric by adding its file
and its entry; nothing here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = "benchmark"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, name: str) -> dict:
    cfg = json.loads((Path(root) / HERE / "configs" / f"{name}.json")
                     .read_text())
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names {cfg.get('name')!r}")
    return cfg


def traffic(root: Path, name: str) -> dict:
    return json.loads((Path(root) / HERE / "traffic" / f"{name}.json")
                      .read_text())


def reader(root: Path, name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    if mod_spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def validate(spec: dict, root: Path = ROOT) -> list[str]:
    """What in ``spec`` breaks the naming rules or names a missing file;
    empty when nothing does."""
    bad = []

    def name_ok(what, v):
        if not isinstance(v, str) or not NAME.fullmatch(v):
            bad.append(f"{what}: bad name {v!r}")

    for c in spec["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok(f"{c['name']}.reduced", k)
        try:
            config(root, c["name"])
        except (OSError, ValueError) as e:
            bad.append(f"config {c['name']}: {e}")
    cfgs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        name_ok("workload", w["name"])
        name_ok(f"{w['name']}.config", w["config"])
        name_ok(f"{w['name']}.traffic", w["traffic"])
        if w["config"] not in cfgs:
            bad.append(f"{w['name']}: unknown config {w['config']!r}")
        try:
            traffic(root, w["traffic"])
        except OSError as e:
            bad.append(f"traffic {w['traffic']}: {e}")
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            name_ok(kind, m["name"])
            if not UNIT.fullmatch(m["unit"]):
                bad.append(f"{m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"{m['name']}: better {m['better']!r}")
            if m["source"] not in SOURCES:
                bad.append(f"{m['name']}: source {m['source']!r}")
            for c in m.get("workloads", ()):
                if c not in cells:
                    bad.append(f"{m['name']}: unknown cell {c!r}")
    for m in spec["per_layer"]:
        if m["moves"] not in e2e:
            bad.append(f"{m['name']}: moves unknown {m['moves']!r}")
        try:
            reader(root, m["name"])
        except (OSError, AttributeError) as e:
            bad.append(f"metric {m['name']}: {e}")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    if len(names) != len(set(names)):
        bad.append("a name is used twice")
    return bad
