"""The port's APD pass against the JAX package's, and the 2-round scan with
SA masks, on the CPU.

One REFINE_INIT pass with the APD weak path (anchors, fit-plane RANSAC,
deformable NCC, weak sweeps) runs through both packages' `run_patchmatch`
on the same priors: ground-truth depth with 0.2% noise, pushed 4% off
inside the scene's weak (nearly textureless) plane, which is marked WEAK.
The two draw different random numbers, so their parity is statistical:
both under 1% median relative depth error over the view, within 1% of each
other in median over the view and over the weak region, and the same
classification on at least 90% of pixels."""

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
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.io import binmat
from apde_mvs_tpu_torch.ops.cost import CostData as TCostData
from apde_mvs_tpu_torch.pipeline.patchmatch import run_patchmatch as t_run
from apde_mvs_tpu_torch.testing import synthetic
from test_torch_slice import run_two_round_scan

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

H, W, V = 48, 64, 3
WEAK_REGION = (-0.3, 0.3, -0.2, 0.2)


def _median_rel(depth, gt, mask):
    ok = (depth > 0) & (gt > 0) & mask
    return float(np.median(np.abs(depth - gt)[ok] / gt[ok]))


@pytest.fixture(scope="module")
def apd_pass():
    """Both packages' APD REFINE_INIT pass on view 0, same priors."""
    scene = synthetic.make_scene(num_views=V, height=H, width=W,
                                 weak_region=WEAK_REGION)
    gt = scene.depths[0]
    weak_region = gt < gt.mean() * 0.95
    rng = np.random.default_rng(0)
    prior_depth = (gt * (1 + 0.002 * rng.standard_normal(gt.shape))
                   ).astype(np.float32)
    prior_depth[weak_region] *= 1.04
    priors = dict(
        prior_depth=prior_depth,
        prior_normal=scene.normals[0].astype(np.float32),
        prior_weak=np.where(weak_region, jcfg.WEAK,
                            jcfg.STRONG).astype(np.int32),
        prior_confidence=np.where(weak_region, 40, 200).astype(np.float32))
    schedule = jcfg.build_schedule(W, "General", use_sa=False, base=32)
    params = next(s.params for s in schedule
                  if s.params.state == "refine_init")
    assert params.use_apd
    dmin = scene.cameras[0].depth_min * jcfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * jcfg.DEPTH_MAX_FACTOR
    src = np.arange(1, V)
    jc = jgeo.CameraArrays.from_cameras(scene.cameras)
    jd = JCostData.build(
        jc.view(0), jgeo.CameraArrays(*[a[src] for a in jc]),
        jnp.asarray(scene.images[0]), jnp.asarray(scene.images[src]),
        src_depths=jnp.asarray(scene.depths[1:]), real_width=W,
        real_height=H, sampler_u8=True)
    jout = j_run(jd, params, depth_min=dmin, depth_max=dmax, seed=0,
                 **priors)
    tc = tgeo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    td = TCostData.build(
        tc.view(0), tc.map(lambda a: a[1:]), torch.as_tensor(scene.images[0]),
        torch.as_tensor(scene.images[1:]),
        src_depths=torch.as_tensor(scene.depths[1:]), real_width=W,
        real_height=H, sampler_u8=True)
    tparams = tcfg.PatchMatchParams(**vars(params))
    tout = t_run(td, tparams, depth_min=dmin, depth_max=dmax, seed=0,
                 **priors)
    return dict(gt=gt, weak_region=weak_region, prior_depth=prior_depth,
                jout=jout, tout=tout)


def test_apd_pass_matches_jax_statistically(apd_pass):
    p = apd_pass
    gt, region = p["gt"], p["weak_region"]
    everywhere = np.ones_like(region)
    jd, td = p["jout"].depth, p["tout"].depth
    jerr = _median_rel(jd, gt, everywhere)
    terr = _median_rel(td, gt, everywhere)
    assert jerr < 0.01 and terr < 0.01, (jerr, terr)
    both = (jd > 0) & (td > 0)
    assert np.median(np.abs(td - jd)[both] / jd[both]) < 0.01
    assert np.median(np.abs(td - jd)[both & region]
                     / jd[both & region]) < 0.01
    assert (p["tout"].weak == p["jout"].weak).mean() > 0.9


def test_apd_pass_moves_the_weak_region(apd_pass):
    """The weak sweep really ran: the WEAK pixels' depths left their prior
    in both packages, to the same error against ground truth."""
    p = apd_pass
    region = p["weak_region"]
    prior = _median_rel(p["prior_depth"], p["gt"], region)
    jerr = _median_rel(p["jout"].depth, p["gt"], region)
    terr = _median_rel(p["tout"].depth, p["gt"], region)
    assert abs(jerr - prior) > 0.01 and abs(terr - prior) > 0.01
    assert abs(terr - jerr) < 0.01, (terr, jerr)


def test_cli_two_round_scan_with_sa_masks(tmp_path):
    """The 2-round recipe with `sa_masks/` present (the weak plane is
    segment 1), so round 1 runs the SA star windows and anchor gating."""
    scene = synthetic.make_scene(num_views=V, height=H, width=W,
                                 weak_region=WEAK_REGION)
    root = tmp_path / "scan"
    synthetic.write_scene_to_disk(scene, root)
    (root / "sa_masks").mkdir()
    for v in range(V):
        mask = np.where(scene.depths[v] < scene.depths[v].mean() * 0.95, 1, 0)
        binmat.write_bin_mat(root / "sa_masks" / f"{v:08d}.bin",
                             mask.astype(np.uint8))
    with contextlib.redirect_stdout(io.StringIO()):
        run_two_round_scan(root, scene)
