"""Parity of the port's deformable NCC (ops/deformable.py) with the JAX
package's `WeakRefData.build` and `ncc_weak`, on the 24x32, S=4 fixture of
tests/test_prop_oracle.py, with and without SA (a seeded segment mask), for
u8 and f32 quad tables.

The reference-side window data (tap values, SA weights, sums, anchor
validity, the anchors' selected views) match exactly; costs to atol 1e-4
(float32 window sums taken in another order, as in test_torch_cost.py),
with one stated allowance: an SA-truncated anchor window may keep only 1-4
taps, whose tiny variance amplifies that float-order noise, so up to 0.5%
of the costs may differ by more than 1e-4, and none by more than 1e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import PatchMatchParams
from apde_mvs_tpu.core import geometry as jgeo
from apde_mvs_tpu.ops import cost as jcost
from apde_mvs_tpu.ops import deformable as jdef
from apde_mvs_tpu.testing import synthetic
from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.ops import deformable as tdef
from apde_mvs_tpu_torch.ops.cuda import sampler

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

H, W, V = 24, 32, 5
ATOL = 1e-4
LOOSE_SHARE, LOOSE_ATOL = 0.005, 1e-2


def assert_costs_close(got, want):
    diff = np.abs(got - want)
    assert (diff > ATOL).mean() <= LOOSE_SHARE, (diff > ATOL).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOSE_ATOL)


def sa_mask(depth, seed=0):
    """Segment ids for SA tests: segment 1 where the scene is nearer than
    its mean (a slanted plane, so a diagonal edge), a seeded block of
    segment 2 crossing it, and 0 (no segment) elsewhere."""
    rng = np.random.default_rng(seed)
    m = np.where(depth < depth.mean(), 1, 0).astype(np.int32)
    y0, x0 = rng.integers(4, depth.shape[0] // 2), rng.integers(
        4, depth.shape[1] // 2)
    m[y0:y0 + 9, x0:x0 + 12] = 2
    return m


def weak_anchors(rng, wx, wy):
    """(Nw, 9, 2) anchors: slot 0 the pixel, slots 1-8 random pixels
    (some far outside the image's reach after a warp near the border),
    about 10% missing."""
    n = len(wx)
    a = np.stack([rng.integers(0, W, (n, 9)), rng.integers(0, H, (n, 9))],
                 -1).astype(np.int32)
    a[rng.random((n, 9)) < 0.1] = -1
    a[:, 0, 0] = wx
    a[:, 0, 1] = wy
    return a


def setup(u8, use_sa, seed=0):
    """Both packages' CostData, a weak list (every other pixel), anchors,
    a random selected-views map and per-pixel planes: half near ground
    truth, half random, a few degenerate (w = 0)."""
    scene = synthetic.make_scene(num_views=V, height=H, width=W)
    cams = jgeo.CameraArrays.from_cameras(scene.cameras)
    src = np.arange(1, V)
    mask = sa_mask(scene.depths[0], seed) if use_sa else None
    jd = jcost.CostData.build(
        cams.view(0), jgeo.CameraArrays(*[a[src] for a in cams]),
        jnp.asarray(scene.images[0]), jnp.asarray(scene.images[src]),
        sa_mask=None if mask is None else jnp.asarray(mask), sampler_u8=u8)
    td = convert.cost_data(
        ref_cam=tuple(jd.ref_cam), src_cams=tuple(jd.src_cams),
        ref_image=jd.ref_image, src_quads=jd.src_quads,
        src_depths=jd.src_depths, width=W, height=H, sa_mask=mask,
        device="cpu")
    rng = np.random.default_rng(seed + 1)
    ys, xs = np.mgrid[0:H, 0:W]
    pick = (xs + ys) % 2 == 0
    wx = xs[pick].astype(np.int32)
    wy = ys[pick].astype(np.int32)
    anchors = weak_anchors(rng, wx, wy)
    selected = rng.random((H, W, V - 1)) < 0.5
    gt = np.asarray(jgeo.make_plane(
        jd.ref_cam, jnp.asarray(wx, jnp.float32), jnp.asarray(wy, jnp.float32),
        jnp.asarray(scene.depths[0][wy, wx]),
        jnp.asarray(scene.normals[0][wy, wx])))
    rnd = np.asarray(jgeo.make_plane(
        jd.ref_cam, jnp.asarray(wx, jnp.float32), jnp.asarray(wy, jnp.float32),
        jnp.asarray(rng.uniform(2.0, 7.0, len(wx)).astype(np.float32)),
        jnp.asarray(np.tile([0.1, -0.1, -1.0], (len(wx), 1)).astype(
            np.float32))))
    planes = np.where(rng.random(len(wx))[:, None] < 0.5, gt, rnd)
    planes[::29, 3] = 0.0
    params = PatchMatchParams(use_sa=use_sa)
    return jd, td, wx, wy, anchors, selected, planes.astype(np.float32), \
        params


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _builds(jd, td, wx, wy, anchors, selected, params):
    jref = jdef.WeakRefData.build(
        jd, jnp.asarray(wx, jnp.float32), jnp.asarray(wy, jnp.float32),
        jnp.asarray(anchors), jnp.asarray(selected), params)
    tref = tdef.WeakRefData.build(
        td, torch.as_tensor(wx, dtype=torch.float32),
        torch.as_tensor(wy, dtype=torch.float32), convert.ints(anchors, "cpu"),
        torch.as_tensor(selected), params)
    return jref, tref


@pytest.mark.parametrize("use_sa", [False, True])
def test_weak_ref_data_build_matches_jax(use_sa):
    jd, td, wx, wy, anchors, selected, _, params = setup(True, use_sa)
    jref, tref = _builds(jd, td, wx, wy, anchors, selected, params)
    for name in ("anchor_x", "anchor_y", "anchor_valid", "anchor_sel",
                 "tap_val", "sum_ref", "sum_rr", "wsum"):
        np.testing.assert_array_equal(_np(getattr(tref, name)),
                                      np.asarray(getattr(jref, name)),
                                      err_msg=name)
    jw = np.broadcast_to(np.asarray(jref.tap_w), np.asarray(
        jref.tap_val).shape)
    tw = np.ones_like(jw) if tref.tap_w is None else _np(tref.tap_w)
    np.testing.assert_array_equal(tw, jw)
    jc, tc = jref.center_win, tref.center_win
    for name in ("tap_val", "sum_ref", "sum_rr"):
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(tc.tap_dx),
                                  np.asarray(jc.tap_dx).reshape(-1))
    np.testing.assert_array_equal(
        np.broadcast_to(_np(tc.wsum), (len(wx),)),
        np.broadcast_to(np.asarray(jc.wsum), (len(wx),)))
    valid = _np(tref.anchor_valid)
    exists = anchors[:, 1:, 0] >= 0
    if use_sa:
        # the mask really gates: some existing anchors sit in another
        # segment, and some taps weigh 0
        assert (exists & ~valid).sum() > 20
        assert (_np(tref.tap_w) == 0).sum() > 100
        assert (_np(tc.wsum) < 36).sum() > 5
    else:
        np.testing.assert_array_equal(valid, exists)


@pytest.mark.parametrize("u8,use_sa", [(True, False), (False, False),
                                       (True, True), (False, True)])
def test_ncc_weak_matches_jax(u8, use_sa):
    jd, td, wx, wy, anchors, selected, planes, params = setup(u8, use_sa)
    jref, tref = _builds(jd, td, wx, wy, anchors, selected, params)
    want = np.asarray(jdef.ncc_weak(jd, jref, jnp.asarray(planes), params))
    before = sampler.launches
    got = _np(tdef.ncc_weak(td, tref, torch.as_tensor(planes), params))
    assert sampler.launches == before          # CPU tensors: plain sampler
    assert got.shape == (len(wx), V - 1)
    assert_costs_close(got, want)
    # the fixture reaches every branch: out-of-image centres (COST_MAX),
    # real matches, and the blend of centre and anchors
    assert (want == tdef.COST_MAX).sum() > 20
    assert (want < 0.3).sum() > 20
    # the JAX package's WeakRefData, carried across, gives the same costs
    conv = convert.weak_ref_data(**{f: getattr(jref, f)
                                    for f in jref._fields}, device="cpu")
    assert_costs_close(
        _np(tdef.ncc_weak(td, conv, torch.as_tensor(planes), params)), want)


def test_softmax_weighted_matches_jax():
    rng = np.random.default_rng(5)
    costs = rng.uniform(0, 2, (50, 8)).astype(np.float32)
    mask = rng.random((50, 8)) < 0.6
    mask[:5] = False                                   # nothing contributes
    want = np.asarray(jdef._softmax_weighted(jnp.asarray(costs),
                                             jnp.asarray(mask)))
    got = tdef._softmax_weighted(torch.as_tensor(costs),
                                 torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[:5] == 0).all()
