"""Parity of the port's fusion (general variant, pipeline/fusion.py) with
the JAX package's `run_fusion` on the same per-view bins: the same point
count, coordinates to atol 1e-5, colours exactly."""

import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import FusionParams as JFusionParams
from apde_mvs_tpu.io import binmat as jbin
from apde_mvs_tpu.io.ply import read_ply
from apde_mvs_tpu.pipeline import driver as jdriver
from apde_mvs_tpu.pipeline import fusion as jfusion
from apde_mvs_tpu_torch import config as tcfg
from apde_mvs_tpu_torch.pipeline import driver as tdriver
from apde_mvs_tpu_torch.pipeline import fusion as tfusion
from apde_mvs_tpu_torch.testing import synthetic

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

WEAK, STRONG, UNKNOWN = 0, 1, 2


def _scan(root, seed):
    """A 5-view scan with noisy ground-truth bins: ~8% of depths off by 3%,
    a few holes, a quarter of the pixels WEAK with random confidence."""
    scene = synthetic.make_scene(num_views=5, height=40, width=56,
                                 with_foreground=True)
    synthetic.write_scene_to_disk(scene, root)
    rng = np.random.default_rng(seed)
    for v in range(scene.num_views):
        d = scene.depths[v] * (1 + rng.normal(0, 0.001, scene.depths[v].shape))
        d = np.where(rng.random(d.shape) < 0.08, d * 1.03, d)
        d[rng.random(d.shape) < 0.03] = 0.0
        n = scene.normals[v] + rng.normal(0, 0.02, scene.normals[v].shape)
        weak = np.where(rng.random(d.shape) < 0.25, WEAK, STRONG)
        weak[d == 0] = UNKNOWN
        conf = rng.integers(1, 40, d.shape)
        out = root / "APD" / f"{v:08d}"
        out.mkdir(parents=True, exist_ok=True)
        jbin.write_bin_mat(out / "depths.bin", d.astype(np.float32))
        jbin.write_bin_mat(out / "normals.bin", n.astype(np.float32))
        jbin.write_bin_mat(out / "weak.bin", weak.astype(np.uint8))
        jbin.write_bin_mat(out / "confidence.bin", conf.astype(np.uint8))


@pytest.mark.parametrize("weak_filter", [True, False])
def test_fusion_matches_jax(tmp_path, weak_filter):
    root = tmp_path / "scan"
    _scan(root, seed=int(weak_filter))
    jpath = jfusion.run_fusion(
        root, jdriver.generate_sample_list(root), "jax.ply",
        JFusionParams(weak_filter=weak_filter))
    jskip = [(root / "APD" / f"{v:08d}" / "skip.png").read_bytes()
             for v in range(5)] if weak_filter else None
    tpath = tfusion.run_fusion(
        root, tdriver.generate_sample_list(root), "port.ply",
        tcfg.FusionParams(weak_filter=weak_filter), device="cpu")
    jp, jc = read_ply(jpath)
    tp, tc = read_ply(tpath)
    assert len(jp) > 1000
    assert len(tp) == len(jp)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc, jc)
    if weak_filter:
        from apde_mvs_tpu_torch.io.images import read_png
        from PIL import Image
        import io
        for v in range(5):
            tskip = read_png(root / "APD" / f"{v:08d}" / "skip.png")
            want = np.asarray(Image.open(io.BytesIO(jskip[v])))
            np.testing.assert_array_equal(tskip[..., 0], want)
        assert any((read_png(root / "APD" / f"{v:08d}" / "skip.png") > 0).any()
                   for v in range(5))
