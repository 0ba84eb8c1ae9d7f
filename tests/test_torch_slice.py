"""The port's round-0 slice end to end on the CPU: its CLI reconstructs a
48x64x3 synthetic scan (FIRST_INIT + 3 REFINE_ITER passes, then fusion),
and on one view its `run_patchmatch` lands as close to ground truth as the
JAX package's. The two draw different random numbers, so their parity is
statistical: both under 1% median relative depth error, and within 1% of
each other in median."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu import config as jcfg
from apde_mvs_tpu.core import geometry as jgeo
from apde_mvs_tpu.ops.cost import CostData as JCostData
from apde_mvs_tpu.pipeline.patchmatch import run_patchmatch as j_run
from apde_mvs_tpu_torch import config as tcfg
from apde_mvs_tpu_torch.cli import apd
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.io import binmat
from apde_mvs_tpu_torch.io.ply import read_ply
from apde_mvs_tpu_torch.ops.cost import CostData as TCostData
from apde_mvs_tpu_torch.ops.cuda import sampler
from apde_mvs_tpu_torch.pipeline.patchmatch import run_patchmatch as t_run
from apde_mvs_tpu_torch.testing import synthetic

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

H, W, V = 48, 64, 3


def _median_rel(depth, gt):
    ok = (depth > 0) & (gt > 0)
    return float(np.median(np.abs(depth - gt)[ok] / gt[ok])), ok.mean()


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(num_views=V, height=H, width=W)


def test_cli_reconstructs_scan_on_cpu(tmp_path, scene):
    root = tmp_path / "scan"
    synthetic.write_scene_to_disk(scene, root)
    before = sampler.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = apd.main(["--dense_folder", str(root), "--dataset", "General",
                       "--device", "cpu"])
    assert rc == 0
    assert sampler.launches == before      # CPU run: plain sampler only
    log = out.getvalue()
    assert log.count("Pass ") == 4 and "first_init" in log
    for v in range(V):
        depth = binmat.read_bin_mat(root / "APD" / f"{v:08d}" / "depths.bin")
        assert depth.shape == (H, W)
        err, cover = _median_rel(depth, scene.depths[v])
        assert err < 0.01, f"view {v}: median relative error {err}"
        assert cover > 0.8
    pts, cols = read_ply(root / "APD" / "APD.ply")
    assert len(pts) > 1000 and cols is not None and len(cols) == len(pts)


def test_cli_refuses_what_is_not_ported(tmp_path, scene):
    root = tmp_path / "scan"
    synthetic.write_scene_to_disk(scene, root)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(NotImplementedError, match="APD"):
            apd.main(["--dense_folder", str(root), "--device", "cpu",
                      "--pyramid_base", "32"])
        with pytest.raises(NotImplementedError, match="views_parallel"):
            apd.main(["--dense_folder", str(root), "--device", "cpu",
                      "--views_parallel", "true"])


def test_run_patchmatch_matches_jax_statistically(scene):
    src = np.arange(1, V)
    params = jcfg.build_schedule(W, "General")[0].params
    dmin = scene.cameras[0].depth_min * jcfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * jcfg.DEPTH_MAX_FACTOR
    jc = jgeo.CameraArrays.from_cameras(scene.cameras)
    jd = JCostData.build(jc.view(0), jgeo.CameraArrays(*[a[src] for a in jc]),
                         jnp.asarray(scene.images[0]),
                         jnp.asarray(scene.images[src]), real_width=W,
                         real_height=H, sampler_u8=True)
    jout = j_run(jd, params, depth_min=dmin, depth_max=dmax, seed=0)

    tc = tgeo.CameraArrays.from_cameras(scene.cameras)
    td = TCostData.build(tc.view(0), tc.map(lambda a: a[1:]),
                         torch.as_tensor(scene.images[0]),
                         torch.as_tensor(scene.images[1:]), real_width=W,
                         real_height=H, sampler_u8=True)
    tparams = tcfg.build_schedule(W, "General")[0].params
    assert tparams == tcfg.PatchMatchParams(**vars(params))
    tout = t_run(td, tparams, depth_min=dmin, depth_max=dmax, seed=0)

    gt = scene.depths[0]
    jerr, _ = _median_rel(jout.depth, gt)
    terr, _ = _median_rel(tout.depth, gt)
    assert jerr < 0.01 and terr < 0.01, (jerr, terr)
    both = (jout.depth > 0) & (tout.depth > 0)
    rel = np.abs(tout.depth - jout.depth)[both] / jout.depth[both]
    assert np.median(rel) < 0.01
    # the classification agrees on most pixels
    assert (tout.weak == jout.weak).mean() > 0.8
