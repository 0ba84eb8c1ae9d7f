"""The manifest keeps to the benchmark's contract, and every cell, mix and
metric is found by name from its own files."""

from __future__ import annotations

import re
from pathlib import Path

from mvsbench import manifest, trace

from .conftest import TINY_CELL, TINY_METRIC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keeps_to_the_contract():
    bench = manifest.load()
    assert set(bench) == TOP_KEYS
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.REPO / p).is_dir()
    assert all(_line(w) for w in bench["command"])
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (manifest.REPO / c["file"]).is_file()
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        names.add(c["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == names
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert _line(m["layer"])
        layers.add(m["layer"])
    pairs = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.cell(manifest.MANIFEST, w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(pairs) == len(bench["workloads"])


def test_every_metric_has_its_reader():
    bench = manifest.load()
    for m in bench["per_layer"]:
        mod = manifest.reader(manifest.REPO, m["name"])
        assert mod.UNIT == m["unit"]
        assert callable(mod.read)


def test_a_cell_and_a_metric_added_from_files(tiny_manifest: Path):
    cell = manifest.cell(tiny_manifest, TINY_CELL)
    assert cell.config["name"] == "tiny"
    assert cell.traffic["weak_share"] == 0.31
    assert [m["name"] for m in cell.per_layer] == [TINY_METRIC]
    rec = trace.Records(steps=7, window_s=1.0, busy_s=0.5, syncs=3,
                        kernels=[], k3_bound_s=0.0, device_ops=[],
                        idle_gaps=[])
    assert manifest.reader(cell.root, TINY_METRIC).read(rec) == 7.0
    # the cells already there are found as before
    for name in ("dtu.r1_geom_weak",):
        assert manifest.cell(tiny_manifest, name).config == \
            manifest.cell(manifest.MANIFEST, name).config
