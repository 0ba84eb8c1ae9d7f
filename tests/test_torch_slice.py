"""The port's scans end to end on the CPU: its CLI reconstructs a 48x64x3
synthetic scan in one round (FIRST_INIT + 3 REFINE_ITER passes, then
fusion) and in two (`--pyramid_base 32`: round 1 adds REFINE_INIT and 3
REFINE_ITER passes with the APD weak path), and on one view its round-0
`run_patchmatch` lands as close to ground truth as the JAX package's. The
two draw different random numbers, so their parity is statistical: both
under 1% median relative depth error, and within 1% of each other in
median."""

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


def run_two_round_scan(root, scene):
    """The 2-round verify recipe through the port's CLI on the CPU; checks
    eight passes, weak pixels on round 1, depth error, the fused PLY, and
    that no kernel launched. Returns the log."""
    before = sampler.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = apd.main(["--dense_folder", str(root), "--dataset", "General",
                       "--device", "cpu", "--pyramid_base", "32"])
    assert rc == 0
    assert sampler.launches == before
    log = out.getvalue()
    assert log.count("Pass ") == 8 and "refine_init" in log
    weak = [int(ln.split()[2]) for ln in log.splitlines()
            if ln.startswith("Weak count:")]
    assert len(weak) == 4 * scene.num_views and max(weak) > 0, weak
    for v in range(scene.num_views):
        depth = binmat.read_bin_mat(root / "APD" / f"{v:08d}" / "depths.bin")
        assert depth.shape == scene.depths[v].shape
        err, cover = _median_rel(depth, scene.depths[v])
        assert err < 0.01, f"view {v}: median relative error {err}"
        assert cover > 0.8
    pts, cols = read_ply(root / "APD" / "APD.ply")
    assert len(pts) > 1000 and cols is not None and len(cols) == len(pts)
    return log


def test_cli_two_round_scan_on_cpu(tmp_path):
    scene = synthetic.make_scene(num_views=V, height=H, width=W,
                                 weak_region=(-0.3, 0.3, -0.2, 0.2))
    root = tmp_path / "scan"
    synthetic.write_scene_to_disk(scene, root)
    run_two_round_scan(root, scene)


def test_cli_refuses_what_is_not_ported(tmp_path, scene):
    """Nothing is refused any more: `--views_parallel true` (once refused
    as not ported) takes the view-parallel route at one rank, with
    `--view_batch` honoured; every pass is skipped here, the engines
    themselves are tested in tests/test_torch_parallel.py."""
    root = tmp_path / "scan"
    synthetic.write_scene_to_disk(scene, root)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert apd.main(["--dense_folder", str(root), "--device", "cpu",
                         "--views_parallel", "true", "--view_batch", "2",
                         "--start_iteration", "4", "--no_fuse", "true"]) == 0
    log = out.getvalue()
    assert "Scale-out: view-parallel over 1 rank(s)" in log
    assert "view_batch    : 2" in log and "ignored" not in log


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

    tc = tgeo.CameraArrays.from_cameras(scene.cameras, device="cpu")
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


def _pair_txt(path, num_src):
    """pair.txt of one reference view (0) with ``num_src`` sources."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"1\n0\n{num_src} " + " ".join(
        f"{i} 1.0" for i in range(1, num_src + 1)) + "\n")


def test_driver_refuses_more_than_32_sources(tmp_path):
    """A problem with 33 sources fails in ``generate_sample_list``, before
    any image is looked for or folder made, naming the limit, the view and
    its count; 32 sources are taken."""
    from apde_mvs_tpu_torch.pipeline import driver
    root = tmp_path / "scan"
    _pair_txt(root / "pair.txt", 33)
    with pytest.raises(ValueError, match=r"reference view 0 has 33 source "
                       r"views.*at most 32"):
        driver.generate_sample_list(root)
    assert not (root / "APD").exists()
    _pair_txt(root / "pair.txt", 32)
    (root / "images").mkdir()
    (root / "images" / "00000000.png").write_bytes(b"")
    probs = driver.generate_sample_list(root)
    assert len(probs) == 1 and len(probs[0].src_image_ids) == 32
