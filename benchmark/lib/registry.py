"""Everything the harness runs, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics.
Each cell ``<cell>`` has ``benchmark/workloads/<cell>.json`` (its
configuration, traffic, chips, why, and the limits of its correctness
check), which must agree with its entry in ``BENCHMARK.json``; each
configuration ``benchmark/configs/<config>.json``; each traffic mix
``benchmark/traffic/<mix>.json`` (its ``kind`` names the driver
``benchmark/kinds/<kind>.py``, the rest are its parameters); each
per-layer metric ``benchmark/metrics/<metric>.py`` (a ``read(ctx)`` that
returns a number or None); each spectrogram model a configuration names
``benchmark/reference/branches/<model>.py`` and
``benchmark/builders/<model>.py``.  A new cell, configuration, model, mix
or metric is new files and new entries: nothing here changes.  A traffic
mix's raw sizes (``n_points``, ``plane``) are its configuration's.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def benchmark_json(root: Optional[Path] = None) -> dict:
    return _load((root or BENCH.parent) / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = benchmark_json(root)
    base = (root / "benchmark") if root else BENCH
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    own = _load(base / "workloads" / f"{_named('cell', name)}.json")
    for key in ("config", "traffic", "chips"):
        if own[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key}={own[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = _load(base / "configs" / f"{_named('config', entry['config'])}.json")
    traffic = _load(base / "traffic" / f"{_named('traffic', entry['traffic'])}.json")
    for got, want, what in ((traffic["n_points"], config["eeg"]["n_points"],
                             "n_points"),
                            (list(traffic["plane"]),
                             list(config["spectrogram"]["image_size"]),
                             "plane")):
        if got != want:
            raise ValueError(f"traffic {entry['traffic']} has {what} {got}, "
                             f"configuration {entry['config']} {want}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"],
                config=config, traffic_name=entry["traffic"], traffic=traffic,
                limits=own.get("limits", {}), end_to_end=e2e,
                per_layer=per_layer)


def kind(name: str) -> ModuleType:
    """The driver of a traffic kind: ``benchmark/kinds/<name>.py``."""
    return importlib.import_module(f"benchmark.kinds.{_named('kind', name)}")


def metric_reader(name: str, root: Optional[Path] = None) -> ModuleType:
    """``benchmark/metrics/<name>.py``, loaded from its file (metric names
    hold dots)."""
    base = (root / "benchmark") if root else BENCH
    path = base / "metrics" / f"{_named('metric', name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
