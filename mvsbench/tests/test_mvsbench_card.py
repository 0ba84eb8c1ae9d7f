"""The harness on the card at a test's size: a whole run of the added cell
with and without the trace, the kernels' launches held to the port's
counters, and the control failing there too."""

from __future__ import annotations

import pytest

from mvsbench import judge, manifest, run
from mvsbench.reference import pass_ref

from .conftest import TINY_CELL, TINY_METRIC

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("traced", [False, True], ids=["timed", "traced"])
def test_added_cell_on_the_card(tiny_manifest, cuda_device, traced):
    cell = manifest.cell(tiny_manifest, TINY_CELL)
    result, info = run.run_cell(cell, 2**31 + 21, 1.0, traced, cuda_device)
    assert result["correct"] is True, (result, info)
    assert result["device"]["platform"] == "gpu"
    if traced:
        assert set(result["metrics"]) == {TINY_METRIC}
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
    else:
        assert set(result["metrics"]) == {"view_ms", "setup_s"}


def test_control_fails_on_the_card(tiny_manifest, cuda_device):
    from mvsbench import scan, scene
    cell = manifest.cell(tiny_manifest, TINY_CELL)
    cfg, traffic = cell.config, cell.traffic
    sc = scene.make_scene(cfg, traffic["weak_share"], 5, cuda_device)
    raw = scan.write_scan(run.scan_dir("card_test"), sc, traffic, 5,
                          cfg["sources"])
    spec = pass_ref.schedule_pass(cfg, traffic)
    want = pass_ref.run_pass(raw, 0, spec, 77, cuda_device)
    low = pass_ref.run_pass(raw, 0, spec, 77, cuda_device, lower=True)
    assert not judge.verdict([judge.compare(low, want)])[0]
