"""Parity of the port's anchor machinery (ops/anchors.py) with the JAX
package's `ops/anchors.py` and with the NumPy anchor oracles
(`anchor_oracle.run_gen_anchors_oracle`, `run_fit_plane_oracle`,
`neighbor_update_oracle`), under the same injected draws.

Discrete outputs — the nearest-strong map, per-pixel hit counts,
reliability, the anchors, the demoted weak map, has-fit flags — match the
JAX package exactly, with one stated exception: anchor slots 1-3 hold the
winning RANSAC triangle, whose members lie on their own plane, so their
sort keys are -1 plus a distance of a few ulps and their order among
themselves is rounding noise (XLA may contract the 3-term plane distance
into FMAs; torch rounds every product). Those three slots are compared as
a set, as tests/test_anchor_oracle.py does between the JAX package and its
oracle; every other slot is compared in order. Fit planes match the JAX
package to 1e-6 and the fit-plane oracle to 2e-4 (the oracle's own
tolerance in tests/test_anchor_oracle.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import STRONG, UNKNOWN, WEAK
from apde_mvs_tpu.core import geometry as jgeo
from apde_mvs_tpu.ops import anchors as janc
from apde_mvs_tpu.ops.state import PMState as JState
from apde_mvs_tpu.testing import anchor_oracle as oracle
from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.ops import anchors as tanc
from apde_mvs_tpu_torch.ops.state import PMState as TState

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

H, W = 64, 80
ROTATE_TIME = 2
DEPTH_MIN, DEPTH_MAX = 2.0, 6.0
THRESH = 0.004
CAM = {"fx": 120.0, "fy": 120.0, "cx": W / 2, "cy": H / 2}


def _scene(seed=0, holes=0.25, noise=0.015):
    """A strong field with random UNKNOWN holes, a weak blob in the middle
    and one near the border, random confidence, and a noisy planar depth
    map (noise scaled to the depth range, so RANSAC inlier counts vary)."""
    rng = np.random.default_rng(seed)
    weak = np.full((H, W), STRONG, np.int32)
    weak[rng.random((H, W)) < holes] = UNKNOWN
    weak[26:36, 30:46] = WEAK
    weak[48:56, 7:13] = WEAK
    conf = rng.integers(0, 256, (H, W)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    depth = (4.0 + 0.004 * xs + 0.003 * ys
             + noise * (DEPTH_MAX - DEPTH_MIN)
             * rng.standard_normal((H, W))).astype(np.float32)
    valid = np.ones((H, W), bool)
    valid[:, -3:] = False                          # a padding strip
    return weak, conf, depth, valid


class _JData:
    ref_cam = jgeo.CameraArrays(
        K=jnp.asarray([[CAM["fx"], 0, CAM["cx"]], [0, CAM["fy"], CAM["cy"]],
                       [0, 0, 1.0]]),
        R=jnp.eye(3), t=jnp.zeros(3), c=jnp.zeros(3))
    img_h = H
    img_w = W


class _TData:
    ref_cam = convert.camera_arrays(*_JData.ref_cam, device="cpu")
    img_h = H
    img_w = W


def _planes(depth):
    planes = np.zeros((H, W, 4), np.float32)
    planes[..., 2] = -1.0        # (0, 0, -1, d): depth_from_plane gives d
    planes[..., 3] = depth
    return planes


def _raws(rng, n):
    sr = tanc._shift_range(ROTATE_TIME)
    drj = 8 * ROTATE_TIME * len(janc._radius_schedule(25)) * 4
    return dict(
        shift_x=rng.integers(-sr + 1, sr, (n, drj)).astype(np.int32),
        shift_y=rng.integers(-sr + 1, sr, (n, drj)).astype(np.int32),
        triplets=rng.integers(0, 1 << 30, (janc.RANSAC_ITERS, n, 3)
                              ).astype(np.int32))


@pytest.fixture(scope="module")
def pinned():
    """Both packages' nearest-strong maps and anchors for every weak pixel
    of the scene, under one set of injected draws."""
    weak, conf, depth, valid = _scene()
    wy, wx = np.nonzero(weak == WEAK)
    raws = _raws(np.random.default_rng(7), len(wx))
    js = JState.create(H, W, 2, valid=jnp.asarray(valid)).replace(
        planes=jnp.asarray(_planes(depth)), weak=jnp.asarray(weak),
        confidence=jnp.asarray(conf))
    jns = janc.nearest_strong_jfa(js.weak, js.confidence, js.valid)
    jres = janc.gen_anchors(
        jax.random.PRNGKey(0), _JData, js, jnp.asarray(wx), jnp.asarray(wy),
        jnp.ones((len(wx),), bool), rotate_time=ROTATE_TIME,
        ransac_threshold=jnp.float32(THRESH), depth_min=jnp.float32(DEPTH_MIN),
        depth_max=jnp.float32(DEPTH_MAX), nearest_strong=jns,
        raws=janc.AnchorRaws(**{k: jnp.asarray(v) for k, v in raws.items()}))
    ts = TState.create(H, W, 2, valid=torch.as_tensor(valid),
                       device="cpu").replace(
        planes=torch.as_tensor(_planes(depth)), weak=torch.as_tensor(weak),
        confidence=torch.as_tensor(conf))
    tns = tanc.nearest_strong_jfa(ts.weak, ts.confidence, ts.valid)
    twx, twy = convert.ints(wx, "cpu"), convert.ints(wy, "cpu")
    tres = tanc.gen_anchors(
        _TData, ts, twx, twy, ROTATE_TIME, THRESH, DEPTH_MIN, DEPTH_MAX, tns,
        raws=convert.anchor_raws(**raws, device="cpu"), chunk=37)
    return dict(weak=weak, conf=conf, depth=depth, valid=valid, wx=wx, wy=wy,
                raws=raws, js=js, ts=ts, jns=np.asarray(jns),
                tns=tns.numpy(), jres=jres, tres=tres, twx=twx, twy=twy)


def test_jfa_matches_jax(pinned):
    p = pinned
    np.testing.assert_array_equal(p["tns"], p["jns"])
    assert (p["tns"][..., 0] >= 0).mean() > 0.9


def test_jfa_against_brute_force():
    """With one confidence everywhere the acceptance predicate is always
    true and the nearest-strong problem is a plain nearest-neighbour
    search: every JFA answer is a strong pixel, and its squared distance
    equals the brute-force minimum on all but a few pixels (JFA is an
    approximation; JFA+1 leaves only rare misses). With random confidence
    every answer still satisfies the predicate."""
    weak, conf, _, valid = _scene(seed=4, holes=0.9)
    strong = (weak == STRONG) & valid
    for c in (np.ones_like(conf), conf):
        ns = tanc.nearest_strong_jfa(torch.as_tensor(weak),
                                     torch.as_tensor(c),
                                     torch.as_tensor(valid)).numpy()
        got = ns[..., 0] >= 0
        sx, sy = ns[..., 0][got], ns[..., 1][got]
        assert strong[sy, sx].all()
        ys, xs = np.nonzero(got)
        assert (c[sy, sx] >= c[ys, xs]).all()
        if c is conf:
            continue
        qy, qx = np.nonzero(strong)
        d2 = (xs[:, None] - qx[None]) ** 2 + (ys[:, None] - qy[None]) ** 2
        got_d2 = (sx - xs) ** 2 + (sy - ys) ** 2
        exact = got_d2 == d2.min(1)
        assert got.all() and exact.mean() > 0.99, exact.mean()


def test_gen_anchors_matches_jax(pinned):
    """Every pixel, across a chunked port run (chunk 37): hit counts and
    reliability exactly, anchors by the signature (slots 1-3 as a set)."""
    p = pinned
    for name in ("reliable", "hit_count"):
        np.testing.assert_array_equal(getattr(p["tres"], name).numpy(),
                                      np.asarray(getattr(p["jres"], name)),
                                      err_msg=name)
    ta = p["tres"].anchors.numpy()
    ja = np.asarray(p["jres"].anchors)
    np.testing.assert_array_equal(ta[:, 0], ja[:, 0])
    for i in range(len(ta)):
        assert {tuple(a) for a in ta[i, 1:4]} == {tuple(a)
                                                  for a in ja[i, 1:4]}, i
    np.testing.assert_array_equal(ta[:, 4:], ja[:, 4:])
    rel = p["tres"].reliable.numpy()
    assert 0 < rel.sum() < len(rel)
    fill = (p["tres"].anchors.numpy()[rel, 1:, 0] >= 0).sum(1)
    assert (fill == 8).any() and (fill < 8).any()


def _signature(anchors, reliable, hit_count):
    """tests/test_anchor_oracle.py's discrete signature: slots 1-3 as a set
    (the RANSAC triangle's members tie up to ulps), the tail in order."""
    a = np.asarray(anchors)
    return (int(hit_count), bool(reliable), frozenset(map(tuple, a[1:4])),
            tuple(map(tuple, a[4:])), tuple(sorted(map(tuple, a[1:]))))


def test_gen_anchors_matches_oracle(pinned):
    p = pinned
    radii = tanc._radius_schedule(25)
    anchors = p["tres"].anchors.numpy()
    rel = p["tres"].reliable.numpy()
    hits = p["tres"].hit_count.numpy()
    for i in range(0, len(p["wx"]), 3):
        o = oracle.run_gen_anchors_oracle(
            int(p["wx"][i]), int(p["wy"][i]), p["depth"], p["tns"], CAM,
            ROTATE_TIME, THRESH, DEPTH_MIN, DEPTH_MAX, radii,
            p["raws"]["shift_x"][i], p["raws"]["shift_y"][i],
            p["raws"]["triplets"][:, i])
        assert _signature(anchors[i], rel[i], hits[i]) \
            == _signature(o["anchors"], o["reliable"], o["hit_count"]), i


def test_gen_anchors_from_generator(pinned):
    """Drawn from a torch.Generator: the same reliable majority, and anchors
    that are strong pixels inside the image."""
    p = pinned
    gen = torch.Generator().manual_seed(3)
    res = tanc.gen_anchors(_TData, p["ts"], p["twx"], p["twy"], ROTATE_TIME,
                           THRESH, DEPTH_MIN, DEPTH_MAX,
                           torch.as_tensor(p["tns"]), generator=gen)
    a = res.anchors.numpy()
    rel = res.reliable.numpy()
    assert abs(rel.mean() - p["tres"].reliable.numpy().mean()) < 0.2
    ax, ay = a[rel, 1:, 0], a[rel, 1:, 1]
    have = ax >= 0
    assert have.any(1).all()
    assert (p["weak"][ay[have], ax[have]] == STRONG).all()


def test_neighbor_update_matches_jax_and_oracle(pinned):
    p = pinned
    rel = p["tres"].reliable
    jw = janc.neighbor_update(p["js"], jnp.asarray(p["wx"]),
                              jnp.asarray(p["wy"]),
                              jnp.ones((len(p["wx"]),), bool),
                              jnp.asarray(rel.numpy())).weak
    tw = tanc.neighbor_update(p["ts"], p["twx"], p["twy"], rel).weak.numpy()
    np.testing.assert_array_equal(tw, np.asarray(jw))
    want = oracle.neighbor_update_oracle(
        p["weak"], {(int(x), int(y)): bool(r) for x, y, r in
                    zip(p["wx"], p["wy"], rel.numpy())})
    np.testing.assert_array_equal(tw, want)
    assert (tw == UNKNOWN).sum() > (p["weak"] == UNKNOWN).sum()


@pytest.fixture(scope="module")
def fits(pinned):
    """Both packages' fit planes on the pinned anchors, with one set of
    injected RANSAC draws."""
    p = pinned
    tri = np.random.default_rng(21).integers(
        0, 1 << 30, (janc.RANSAC_ITERS, len(p["wx"]), 3)).astype(np.int32)
    anchors = p["tres"].anchors.numpy()
    jfit = janc.ransac_fit_planes(
        jax.random.PRNGKey(0), _JData, p["js"], jnp.asarray(p["wx"]),
        jnp.asarray(p["wy"]), jnp.ones((len(p["wx"]),), bool),
        jnp.asarray(anchors), triplets=jnp.asarray(tri))
    tfit = tanc.ransac_fit_planes(_TData, p["ts"], p["twx"], p["twy"],
                                  convert.ints(anchors, "cpu"),
                                  triplets=convert.ints(tri, "cpu"))
    return dict(tri=tri, anchors=anchors, jfit=np.asarray(jfit),
                tfit=tfit.numpy())


def test_ransac_fit_planes_matches_jax(fits):
    f = fits
    has_t = (f["tfit"][:, :3] != 0).any(1)
    has_j = (f["jfit"][:, :3] != 0).any(1)
    np.testing.assert_array_equal(has_t, has_j)
    np.testing.assert_allclose(f["tfit"], f["jfit"], rtol=0, atol=1e-6)
    assert 0 < has_t.sum() < len(has_t)


def test_ransac_fit_planes_matches_oracle(pinned, fits):
    p, f = pinned, fits
    for i in range(len(p["wx"])):
        plane, has = oracle.run_fit_plane_oracle(
            int(p["wx"][i]), int(p["wy"][i]), f["anchors"][i],
            _planes(p["depth"]), CAM, f["tri"][:, i])
        assert has == bool((f["tfit"][i, :3] != 0).any()), i
        if has:
            np.testing.assert_allclose(f["tfit"][i], plane, rtol=2e-4,
                                       atol=2e-4, err_msg=str(i))


def test_ransac_fit_planes_from_generator(pinned, fits):
    """Drawn from a generator, the fit exists for the same pixels (the fit
    rule is deterministic given enough draws) and lies close to the true
    slanted plane's normal."""
    p, f = pinned, fits
    gen = torch.Generator().manual_seed(5)
    fit = tanc.ransac_fit_planes(_TData, p["ts"], p["twx"], p["twy"],
                                 convert.ints(f["anchors"], "cpu"),
                                 generator=gen).numpy()
    has = (fit[:, :3] != 0).any(1)
    assert (has == (f["tfit"][:, :3] != 0).any(1)).mean() > 0.9
    np.testing.assert_allclose(np.linalg.norm(fit[has, :3], axis=1), 1.0,
                               atol=1e-5)
    # normals face the camera: n . view_direction <= 0
    assert (fit[has, 2] < 0).all()


def test_radius_and_direction_tables_match_jax():
    for budget in (5, 25, 400):
        np.testing.assert_array_equal(tanc._radius_schedule(budget),
                                      janc._radius_schedule(budget))
    for rt in (1, 2, 4):
        np.testing.assert_array_equal(tanc._direction_table(rt),
                                      janc._direction_table(rt))
        assert tanc._shift_range(rt) == max(
            int(math.tan(math.radians(45.0 / rt / 2.0)) * 20), 1)
