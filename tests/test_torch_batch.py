"""The port's batch path on the CPU, as a user runs it on an ETH3D scan:
`tools.eth3d_train.run_pipeline` normalizes a raw ETH3D-layout scan,
converts its COLMAP model, and runs `cli.run`, whose worker starts the
port's engine CLI as a subprocess (`--device cpu` here); then
`tools.collect` gathers the cloud. The scheduler does not report the
engine's exit status, so the outputs are checked (the JAX drill's bar,
tests/test_eth3d_drill.py:73-75)."""

import os
import sys
from pathlib import Path

import numpy as np

from apde_mvs_tpu_torch.io import binmat
from apde_mvs_tpu_torch.io.ply import read_ply
from apde_mvs_tpu_torch.testing import eth3d_fixture, synthetic
from apde_mvs_tpu_torch.tools import collect, eth3d_train

ROOT = Path(__file__).resolve().parents[1]


def test_eth3d_batch_pipeline_on_cpu(tmp_path, monkeypatch):
    scene = synthetic.make_scene(num_views=4, height=48, width=64)
    raw = tmp_path / "ETH3D_raw"
    eth3d_fixture.write_eth3d_scan(scene, str(raw), "drill")
    work = tmp_path / "ETH3D_work"
    # the engine subprocess imports the package from this checkout, on one
    # intra-op thread (the suite's workers share the cores)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = eth3d_train.run_pipeline(
        str(raw), str(work), skip_eval=True, run_args=[
            "--engine_cmd",
            f"{sys.executable} -m apde_mvs_tpu_torch.cli.apd --device cpu",
            "--no_sam"])
    assert rc == 0
    scan = work / "drill"
    log = (scan / "APD" / "log.txt").read_text()
    assert "dataset       : ETH3D" in log and "device        : cpu" in log
    assert log.count("Pass ") == 4, log[-2000:]
    assert "Sampler kernel launches: 0" in log
    for v in range(scene.num_views):
        depth = binmat.read_bin_mat(scan / "APD" / f"{v:08d}" / "depths.bin")
        gt = scene.depths[v]
        ok = (depth > 0) & (gt > 0)
        rel = np.median(np.abs(depth - gt)[ok] / gt[ok])
        assert rel < 0.02, f"view {v}: median relative depth error {rel}"
    pts, cols = read_ply(scan / "APD" / "APD.ply")
    assert len(pts) > 500 and cols is not None
    out = tmp_path / "collected"
    assert collect.main(["eth", "--data_dir", str(work),
                         "--out_dir", str(out)]) == 0
    assert (out / "drill.ply").read_bytes() \
        == (scan / "APD" / "APD.ply").read_bytes()
