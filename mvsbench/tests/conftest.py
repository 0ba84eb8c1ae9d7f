"""Fixtures of the benchmark's tests: a manifest in a directory of its own
with one more cell (the `tiny` configuration at 48x64 under the weak mix)
and one more per-layer metric, added as files and entries only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from mvsbench import manifest

HERE = Path(__file__).resolve().parent
TINY_CELL = "tiny.weak"
TINY_METRIC = "pass.steps"


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """Each test's scan folders under its own temporary directory, so that
    tests in parallel processes never share one."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("TMPDIR", str(tmp_path))


@pytest.fixture
def tiny_manifest(tmp_path) -> Path:
    """A copy of the repository's manifest and of the files it names,
    with a cell and a metric added from files: nothing of the copy's
    existing files is edited."""
    bench = manifest.load()
    src = manifest.REPO / "mvsbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(src / sub, tmp_path / "mvsbench" / sub)
    shutil.copy(HERE / "tiny.json", tmp_path / "mvsbench" / "configs")
    (tmp_path / "mvsbench" / "metrics" / f"{TINY_METRIC}.py").write_text(
        'UNIT = "steps"\n\n\ndef read(rec):\n    return float(rec.steps)\n')
    bench["configs"].append({
        "name": "tiny", "source": "https://example.org/tiny",
        "file": "mvsbench/configs/tiny.json",
        "reduced": ["height", "width", "views"], "why": "a test's size"})
    bench["workloads"].append({
        "name": TINY_CELL, "config": "tiny", "traffic": "final_geom_weak31",
        "chips": 1, "why": "the weak mix at a test's size"})
    bench["per_layer"].append({
        "name": TINY_METRIC, "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "view pass",
        "moves": "view_ms", "workloads": [TINY_CELL]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench, indent=1))
    return path


@pytest.fixture
def cuda_device():
    """The card, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
