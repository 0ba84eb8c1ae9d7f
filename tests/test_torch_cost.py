"""Parity of the port's cost module (ops/cost.py, ops/init.py) with the JAX
package on a 24x32 synthetic scene with S=4 source views (the fixture
pattern of tests/test_prop_oracle.py). Costs to atol 1e-4 (float32 window
sums taken in another order), selections exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import PatchMatchParams
from apde_mvs_tpu.core import geometry as jgeo
from apde_mvs_tpu.ops import cost as jcost
from apde_mvs_tpu.ops import init as jinit
from apde_mvs_tpu.ops.state import PMState as JState
from apde_mvs_tpu.testing import synthetic
from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import init as tinit

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

H, W, V = 24, 32, 5


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _port(jd):
    return convert.cost_data(
        ref_cam=tuple(jd.ref_cam), src_cams=tuple(jd.src_cams),
        ref_image=jd.ref_image, src_quads=jd.src_quads,
        src_depths=jd.src_depths, width=jd.width, height=jd.height,
        real_width=jd.real_width, real_height=jd.real_height, device="cpu")


def _scene_data(u8, geom=True, real=(0, 0)):
    scene = synthetic.make_scene(num_views=V, height=H, width=W)
    cams = jgeo.CameraArrays.from_cameras(scene.cameras)
    src = np.arange(1, V)
    depths = np.stack([scene.depths[s] for s in src]).astype(np.float32)
    depths[:, ::7, ::5] = 0.0                   # missing source depth
    jd = jcost.CostData.build(
        cams.view(0), jgeo.CameraArrays(*[a[src] for a in cams]),
        jnp.asarray(scene.images[0]), jnp.asarray(scene.images[src]),
        src_depths=jnp.asarray(depths) if geom else None,
        real_width=real[0], real_height=real[1], sampler_u8=u8)
    return scene, jd, _port(jd)


def _planes(scene, jd, seed):
    """Near-truth planes, random planes and a few degenerate (w = 0)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    x = xs.reshape(-1).astype(np.float32)
    y = ys.reshape(-1).astype(np.float32)
    gt = np.asarray(jgeo.make_plane(
        jd.ref_cam, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(scene.depths[0].reshape(-1) * (1 + rng.normal(
            0, 0.01, H * W).astype(np.float32))),
        jnp.asarray(scene.normals[0].reshape(-1, 3))))
    rnd = np.asarray(jgeo.random_plane_hypothesis(
        jax.random.PRNGKey(seed), jd.ref_cam, jnp.asarray(x), jnp.asarray(y),
        jnp.float32(2.0), jnp.float32(7.0)))
    planes = np.where(rng.random(H * W)[:, None] < 0.5, gt, rnd)
    planes[::37, 3] = 0.0
    return x, y, planes.astype(np.float32)


@pytest.mark.parametrize("u8", [True, False])
def test_cost_data_build(u8):
    scene, jd, _ = _scene_data(u8)
    cams = tgeo.CameraArrays.from_cameras(scene.cameras)
    src = torch.arange(1, V)
    td = tcost.CostData.build(
        cams.view(0), cams.map(lambda a: a[src]),
        torch.as_tensor(scene.images[0]), torch.as_tensor(scene.images[1:]),
        src_depths=torch.as_tensor(np.asarray(jd.src_depths)),
        sampler_u8=u8)
    np.testing.assert_array_equal(_np(td.src_quads), np.asarray(jd.src_quads))
    np.testing.assert_array_equal(_np(td.ref_image), np.asarray(jd.ref_image))
    for got, want in zip((td.ref_cam.K, td.ref_cam.R, td.src_cams.t,
                          td.src_cams.c), (jd.ref_cam.K, jd.ref_cam.R,
                                           jd.src_cams.t, jd.src_cams.c)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (td.width, td.height, td.num_src) == (W, H, V - 1)


def test_precompute_ref_window():
    scene, jd, td = _scene_data(True)
    x, y, _ = _planes(scene, jd, 0)
    jw = jcost.precompute_ref_window(jd, jnp.asarray(x), jnp.asarray(y), 5, 2,
                                     False)
    tw = tcost.precompute_ref_window(td, torch.as_tensor(x),
                                     torch.as_tensor(y), 5, 2)
    for name in ("tap_dx", "tap_dy", "tap_val", "sum_ref", "sum_rr"):
        np.testing.assert_array_equal(_np(getattr(tw, name)),
                                      np.asarray(getattr(jw, name)))
    assert tw.wsum == float(jw.wsum)
    # the SA branch with an all-zero mask (what round 0 runs) is the same
    # window
    jsa = jcost.precompute_ref_window(jd, jnp.asarray(x), jnp.asarray(y), 5,
                                      2, True)
    np.testing.assert_array_equal(np.asarray(jsa.sum_rr), _np(tw.sum_rr))
    np.testing.assert_array_equal(np.asarray(jsa.wsum),
                                  np.full(H * W, tw.wsum, np.float32))


@pytest.mark.parametrize("u8,real", [(True, (0, 0)), (False, (0, 0)),
                                     (True, (29, 21))])
def test_ncc_strong(u8, real):
    scene, jd, td = _scene_data(u8, real=real)
    x, y, planes = _planes(scene, jd, 1)
    jw = jcost.precompute_ref_window(jd, jnp.asarray(x), jnp.asarray(y), 5, 2,
                                     False)
    want = np.asarray(jcost.ncc_strong(jd, jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(planes), jw))
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    tw = tcost.precompute_ref_window(td, tx, ty, 5, 2)
    got = _np(tcost.ncc_strong(td, tx, ty, torch.as_tensor(planes), tw))
    assert got.shape == (H * W, V - 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (want == tcost.COST_MAX).sum() > 20          # oob / degenerate
    assert (want < 0.3).sum() > 100                     # real matches


def test_geom_cost():
    scene, jd, td = _scene_data(True, geom=True)
    x, y, planes = _planes(scene, jd, 2)
    want = np.asarray(jcost.geom_cost(jd, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(planes)))
    got = _np(tcost.geom_cost(td, torch.as_tensor(x), torch.as_tensor(y),
                              torch.as_tensor(planes)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (want == tcost.GEOM_COST_MAX).sum() > 20
    assert (want < 1.0).sum() > 100


def test_initial_cost_and_selection():
    rng = np.random.default_rng(3)
    costs = rng.uniform(0, 2.0, (500, 6)).astype(np.float32)
    costs[rng.random((500, 6)) < 0.3] = 2.0
    costs[:20] = 2.0                                     # all invalid
    costs[20:40, 1] = costs[20:40, 0]                    # exact ties
    jm, js = jcost.initial_cost_and_selection(jnp.asarray(costs), 4)
    tm, ts = tcost.initial_cost_and_selection(torch.as_tensor(costs), 4)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=1e-6, rtol=0)


@pytest.mark.parametrize("u8", [True, False])
def test_initial_cost(u8):
    scene, jd, td = _scene_data(u8)
    _, _, planes = _planes(scene, jd, 4)
    params = PatchMatchParams(use_sa=False)
    js = JState.create(H, W, V - 1).replace(
        planes=jnp.asarray(planes.reshape(H, W, 4)))
    jout = jinit.initial_cost(jd, js, params, use_apd=False)
    ts = convert.pm_state(**{k: getattr(js, k) for k in (
        "planes", "costs", "selected", "view_weights", "weak", "confidence",
        "valid")}, device="cpu")
    tout = tinit.initial_cost(td, ts, params)
    np.testing.assert_allclose(_np(tout.costs), np.asarray(jout.costs),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(_np(tout.selected),
                                  np.asarray(jout.selected))


def test_random_planes_from_jax_draws():
    scene, jd, td = _scene_data(True)
    key = jax.random.PRNGKey(7)
    want = jinit.random_planes(key, jd, jnp.float32(2.0), jnp.float32(7.0))
    kd, kn = jax.random.split(key)
    draws = tinit.PlaneDraws(
        torch.tensor(np.asarray(jax.random.uniform(kd, (H, W), jnp.float32))),
        torch.tensor(np.asarray(jax.random.normal(kn, (H, W, 3),
                                                  jnp.float32))))
    got = tinit.random_planes(td, 2.0, 7.0, draws=draws)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and from a generator: a valid plane field in the depth range
    gen = torch.Generator().manual_seed(0)
    planes = tinit.random_planes(td, 2.0, 7.0, generator=gen)
    xs, ys = tgeo.pixel_grid(H, W, "cpu")
    d = tgeo.depth_from_plane(td.ref_cam, planes, xs, ys)
    assert bool(((d >= 2.0 - 1e-4) & (d <= 7.0 + 1e-4)).all())
