"""The benchmark's manifest: `BENCHMARK.json` and the files it names.

A cell names a configuration (its file is listed in `configs`) and a
traffic mix (`mvsbench/traffic/<mix>.json` beside the manifest); a
per-layer metric's reader is `mvsbench/metrics/<metric>.py`. Nothing here
lists cells, mixes or metrics: a later cell or metric is files and
entries, found by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

REPO = Path(__file__).resolve().parents[1]
MANIFEST = REPO / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]      # the manifest's entries this cell reports
    per_layer: List[dict]
    root: Path                  # the manifest's directory


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(path: Path, name: str) -> Cell:
    """The cell ``name`` of the manifest at ``path``, its configuration and
    traffic read from their files."""
    path = Path(path)
    bench = load(path)
    root = path.parent
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {path}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "mvsbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root)


def reader(root: Path, metric: str) -> ModuleType:
    """The reader module of per-layer metric ``metric``."""
    path = Path(root) / "mvsbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "mvsbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
