"""Parity of the port's post-sweep filters (ops/filters.py) with the JAX
package, and of DepthToWeak / LocalRefine with the NumPy oracles
`prop_oracle.run_depth_to_weak_oracle` / `run_local_refine_oracle`, on the
24x32, S=4 fixture of tests/test_prop_oracle.py.

Classes exactly (both sides use the same strict-minimum tie rules); depths
to 1e-5 relative; median and confidence exactly. With SA (the APD passes'
window) the same holds on a seeded segment mask. On CPU tensors the sweeps
run the plain version of the fused sweep kernel (ops/cuda/sweep.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import STRONG, UNKNOWN, WEAK
from apde_mvs_tpu.core import geometry as jgeo
from apde_mvs_tpu.ops import filters as jf
from apde_mvs_tpu.ops.cost import CostData as JCostData
from apde_mvs_tpu.ops.init import random_planes as j_random_planes
from apde_mvs_tpu.ops.state import PMState as JState
from apde_mvs_tpu.testing import prop_oracle, synthetic
from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import filters as tf

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

H, W, V = 24, 32, 5
FIELDS = ("planes", "costs", "selected", "view_weights", "weak",
          "confidence", "valid")


def _sa_mask(depth, seed):
    """Seeded segment ids: 1 where the slanted scene is nearer than its
    mean, a random block of 2 across that edge, 0 elsewhere."""
    rng = np.random.default_rng(seed)
    m = np.where(depth < depth.mean(), 1, 0).astype(np.int32)
    y0, x0 = rng.integers(3, H // 2), rng.integers(3, W // 2)
    m[y0:y0 + 8, x0:x0 + 11] = 2
    return m


def _setup(seed=11, geom=False, sa=False):
    """(world normal, depth) planes with mildly noisy GT depths, ~30% badly
    off, a few zero; random selections and weights (tests/test_prop_oracle
    `_classify_setup`)."""
    scene = synthetic.make_scene(num_views=V, height=H, width=W)
    cams = jgeo.CameraArrays.from_cameras(scene.cameras)
    src = np.arange(1, V)
    kwargs = {}
    if geom:
        kwargs["src_depths"] = jnp.asarray(
            np.stack([scene.depths[s] for s in src]).astype(np.float32))
    mask = _sa_mask(scene.depths[0], seed) if sa else None
    jd = JCostData.build(
        cams.view(0), jgeo.CameraArrays(*[a[src] for a in cams]),
        jnp.asarray(scene.images[0]), jnp.asarray(scene.images[src]),
        sa_mask=None if mask is None else jnp.asarray(mask), **kwargs)
    dmin = float(scene.cameras[0].depth_min * 0.6)
    dmax = float(scene.cameras[0].depth_max * 1.2)
    rng = np.random.RandomState(seed)
    depth = scene.depths[0] * (1 + rng.randn(H, W).astype(np.float32) * 0.01)
    off = rng.rand(H, W) < 0.3
    depth = np.where(off, depth * (1 + rng.choice([-0.08, 0.1], (H, W))
                                   .astype(np.float32)), depth)
    depth[rng.rand(H, W) < 0.02] = 0.0
    planes_dn = np.concatenate([scene.normals[0].astype(np.float32),
                                depth[..., None]], -1).astype(np.float32)
    sel = rng.rand(H, W, jd.num_src) < 0.6
    vw = rng.randint(0, 6, (H, W, jd.num_src)).astype(np.float32)
    weak = np.where(rng.rand(H, W) < 0.2, WEAK, STRONG).astype(np.int32)
    costs = rng.uniform(0, 1, (H, W)).astype(np.float32)
    costs[rng.rand(H, W) < 0.05] = 0.0005
    js = JState.create(H, W, jd.num_src).replace(
        planes=jnp.asarray(planes_dn), selected=jnp.asarray(sel),
        view_weights=jnp.asarray(vw), weak=jnp.asarray(weak),
        costs=jnp.asarray(costs))
    td = convert.cost_data(
        ref_cam=tuple(jd.ref_cam), src_cams=tuple(jd.src_cams),
        ref_image=jd.ref_image, src_quads=jd.src_quads,
        src_depths=jd.src_depths, width=W, height=H, sa_mask=mask,
        device="cpu")
    ts = convert.pm_state(**{k: getattr(js, k) for k in FIELDS},
                          device="cpu")
    return jd, js, td, ts, dmin, dmax


def _pixels():
    ys, xs = np.mgrid[0:H, 0:W]
    return xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)


def _oracle_args(td):
    rc = td.ref_cam
    cam = dict(fx=float(rc.fx), fy=float(rc.fy), cx=float(rc.cx),
               cy=float(rc.cy))
    return cam, rc.R.numpy(), rc.c.numpy(), td.src_cams.c.numpy()


def _injected(td, xs, ys, geom):
    xf = torch.as_tensor(xs, dtype=torch.float32)
    yf = torch.as_tensor(ys, dtype=torch.float32)
    win = tcost.precompute_ref_window(td, xf, yf, 5, 2)

    def ncc(_x, _y, p):
        return tcost.ncc_strong(td, xf, yf, torch.as_tensor(
            p, dtype=torch.float32), win).numpy()

    def gc(_x, _y, p):
        return tcost.geom_cost(td, xf, yf, torch.as_tensor(
            p, dtype=torch.float32)).numpy()
    return ncc, (gc if geom else None)


def test_plane_conversions():
    jd, js, td, ts, dmin, dmax = _setup()
    planes = np.asarray(j_random_planes(jax.random.PRNGKey(0), jd, dmin,
                                        dmax))
    dn = jf.planes_to_depth_normal(jd, jnp.asarray(planes))
    np.testing.assert_allclose(
        tf.planes_to_depth_normal(td, torch.as_tensor(planes)).numpy(),
        np.asarray(dn), rtol=1e-5, atol=1e-5)
    back = jf.depth_normal_to_planes(jd, dn[..., 3], dn[..., :3])
    got = tf.depth_normal_to_planes(td, torch.as_tensor(np.asarray(
        dn[..., 3])), torch.as_tensor(np.asarray(dn[..., :3])))
    np.testing.assert_allclose(got.numpy(), np.asarray(back), rtol=1e-5,
                               atol=1e-5)


def test_median_filter_matches_jax():
    jd, js, td, ts, *_ = _setup()
    for color in (0, 1):
        js = jf.median_filter_color(js, color)
        ts = tf.median_filter_color(ts, color)
        np.testing.assert_array_equal(ts.planes.numpy(),
                                      np.asarray(js.planes))
    moved = ts.planes.numpy()[..., 3] != _setup()[3].planes.numpy()[..., 3]
    assert moved.sum() > 50


def test_compute_confidence_matches_jax():
    jd, js, td, ts, *_ = _setup(geom=True)
    jo = jf.compute_confidence(jd, js)
    to = tf.compute_confidence(td, ts)
    np.testing.assert_array_equal(to.confidence.numpy(),
                                  np.asarray(jo.confidence))
    np.testing.assert_array_equal(to.weak.numpy(), np.asarray(jo.weak))
    assert len(np.unique(to.confidence.numpy())) > 3


@pytest.mark.parametrize("geom", [False, True])
def test_depth_to_weak_matches_jax_and_oracle(geom):
    jd, js, td, ts, dmin, dmax = _setup(geom=geom)
    xs, ys = _pixels()
    gf = 0.2
    jw, jcurve = jax.jit(lambda d, s: jf.depth_to_weak(
        d, s, jnp.asarray(xs), jnp.asarray(ys), 2, False, geom,
        jnp.float32(gf), jnp.float32(dmin), jnp.float32(dmax),
        return_curve=True))(jd, js)
    tw, tcurve = tf.depth_to_weak(td, ts, torch.as_tensor(xs),
                                  torch.as_tensor(ys), 2, geom, gf, dmin,
                                  dmax, return_curve=True)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    cam, R, c, src_c = _oracle_args(td)
    ncc, gc = _injected(td, xs, ys, geom)
    oracle = prop_oracle.run_depth_to_weak_oracle(
        ts.planes.numpy(), ts.selected.numpy(), ts.view_weights.numpy(),
        ts.valid.numpy(), xs, ys, cam, R, c, src_c, ncc, gc, 2, gf, dmin,
        dmax, W, H, td.num_src)
    ok = oracle["ok"]
    np.testing.assert_allclose(tcurve.numpy()[ok], oracle["curve"][ok],
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(tcurve.numpy()[ok], np.asarray(jcurve)[ok],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tw.numpy(), oracle["weak"])
    got = tw.numpy()
    assert (got == STRONG).sum() > 20 and (got == WEAK).sum() > 20 \
        and (got == UNKNOWN).sum() > 20


@pytest.mark.parametrize("geom", [False, True])
def test_local_refine_matches_jax_and_oracle(geom):
    jd, js, td, ts, dmin, dmax = _setup(seed=13, geom=geom)
    xs, ys = _pixels()
    gf = 0.2
    jdep = jax.jit(lambda d, s: jf.local_refine(
        d, s, jnp.asarray(xs), jnp.asarray(ys), False, geom,
        jnp.float32(gf), jnp.float32(dmin), jnp.float32(dmax)))(jd, js)
    tdep = tf.local_refine(td, ts, torch.as_tensor(xs), torch.as_tensor(ys),
                           geom, gf, dmin, dmax).numpy()
    np.testing.assert_allclose(tdep, np.asarray(jdep), rtol=1e-5, atol=0)
    cam, R, c, src_c = _oracle_args(td)
    ncc, gc = _injected(td, xs, ys, geom)
    oracle = prop_oracle.run_local_refine_oracle(
        ts.planes.numpy(), ts.selected.numpy(), ts.view_weights.numpy(),
        ts.valid.numpy(), xs, ys, cam, R, c, src_c, ncc, gc, gf, dmin, dmax,
        td.num_src)
    np.testing.assert_allclose(tdep, oracle["depth"], rtol=1e-5, atol=0)
    assert oracle["refined"].sum() > 20
    assert (~oracle["refined"] & oracle["ok"]).sum() > 20


@pytest.mark.parametrize("geom", [False, True])
def test_depth_to_weak_and_local_refine_with_sa_match_jax(geom):
    """The APD passes classify and refine with the SA star window."""
    jd, js, td, ts, dmin, dmax = _setup(seed=17, geom=geom, sa=True)
    xs, ys = _pixels()
    gf = 0.2
    jw, jcurve = jax.jit(lambda d, s: jf.depth_to_weak(
        d, s, jnp.asarray(xs), jnp.asarray(ys), 2, True, geom,
        jnp.float32(gf), jnp.float32(dmin), jnp.float32(dmax),
        return_curve=True))(jd, js)
    tx, ty = torch.as_tensor(xs), torch.as_tensor(ys)
    tw, tcurve = tf.depth_to_weak(td, ts, tx, ty, 2, geom, gf, dmin, dmax,
                                  return_curve=True, use_sa=True)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # a truncated star window can keep a handful of taps, whose small
    # variance amplifies float-order noise in the sums: curve atol 1e-3
    np.testing.assert_allclose(tcurve.numpy(), np.asarray(jcurve), rtol=0,
                               atol=1e-3)
    plain = tf.depth_to_weak(td, ts, tx, ty, 2, geom, gf, dmin, dmax,
                             return_curve=True)[1].numpy()
    in_seg = td.sa_mask.numpy()[ys, xs] > 0
    assert (plain[in_seg] != tcurve.numpy()[in_seg]).any(-1).mean() > 0.5
    jdep = jax.jit(lambda d, s: jf.local_refine(
        d, s, jnp.asarray(xs), jnp.asarray(ys), True, geom,
        jnp.float32(gf), jnp.float32(dmin), jnp.float32(dmax)))(jd, js)
    tdep = tf.local_refine(td, ts, tx, ty, geom, gf, dmin, dmax,
                           use_sa=True).numpy()
    np.testing.assert_allclose(tdep, np.asarray(jdep), rtol=1e-5, atol=0)
    assert (tdep != ts.planes.numpy()[ys, xs, 3]).sum() > 20


def _crafted_curves(rng):
    """(B, 61) cost curves for the peak rule: crafted rows, then random rows
    of dyadic values (every square and sum of squares exact, so the rule's
    sums agree in any order), NaN and +inf. The crafted rows: one deep
    peak; two peaks of equal cost (the first is the minimum); equal costs
    on a plateau (no strict minimum); NaN beside and at a peak; +inf
    around a peak; peaks all at or above 2 (min_peak 0); a peak only at
    i = 1 and only at i = 59 (both outside [2, 58]); peaks at 2 and 58;
    several peaks whose spread puts the variance under and over 0.2."""
    nan, inf = np.nan, np.inf
    rows = []

    def row(base=1.0, **at):
        r = np.full(61, base, np.float32)
        for i, v in at.items():
            r[int(i[1:])] = v
        rows.append(r)
    row(i30=0.125)                                   # single, strong
    row(i30=0.25)                                    # single, weak
    row(i28=0.25, i33=0.25)                          # equal peak costs
    row(i28=0.5, i29=0.5, i30=0.5)                   # plateau: no peak
    row(i29=nan, i30=0.125)                          # NaN beside a peak
    row(i30=nan, i31=0.125)                          # NaN at a peak's side
    row(i29=inf, i30=0.125, i31=inf)                 # +inf around a peak
    row(base=3.0, i30=2.0, i40=2.5)                  # no peak below 2
    row(i1=0.125)                                    # only at i = 1
    row(i59=0.125)                                   # only at i = 59
    row(i2=0.125, i58=0.25)                          # peaks at 2 and 58
    row(i30=0.125, i10=0.5, i50=0.75)                # spread peaks
    row(i30=0.125, i10=0.25, i50=0.25)               # close peaks
    row(i31=0.25, i27=0.375, i45=1.5, i12=0.625)     # four peaks
    row(base=inf, i30=0.125)                         # inf everywhere else
    row(base=nan, i30=0.125)                         # NaN everywhere else
    vals = np.asarray([0.125, 0.25, 0.375, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5,
                       nan, inf], np.float32)
    p = np.asarray([.12, .12, .1, .1, .1, .1, .08, .1, .04, .07, .07])
    # random rows: a few dips into a flat curve, some of them NaN or +inf,
    # and on half of them a deep peak near the centre
    rand = np.full((400, 61), 1.5, np.float32)
    for r in rand:
        k = rng.integers(0, 6)
        r[rng.integers(0, 61, k)] = rng.choice(vals, k, p=p / p.sum())
        if rng.random() < 0.5:
            at = 30 + rng.integers(-4, 5)
            r[at - 1:at + 2] = (1.0, 0.0625, 1.0)
    return np.concatenate([np.stack(rows), rand]).astype(np.float32)


@pytest.mark.parametrize("weak_peak_radius", [2, 6])
def test_classify_peaks_on_crafted_curves_matches_jax(weak_peak_radius):
    """The plain peak rule (the one K5's stage form applies in its
    epilogue) against the JAX package's ``_classify_peaks`` on crafted
    curves, over pixels on and inside the margins, invalid pixels and
    setups that are not ok: classes equal."""
    jd, js, td, ts, *_ = _setup()
    rng = np.random.default_rng(23)
    curve = _crafted_curves(rng)
    b = curve.shape[0]
    n = 16                                       # crafted rows: inside
    xs = rng.integers(4, W - 4, b).astype(np.int32)
    ys = rng.integers(4, H - 4, b).astype(np.int32)
    xs[:n], ys[:n] = 15, 12
    xs[n:n + 4] = [5, 6, W - 7, W - 6]           # on and off the margins
    ys[n + 4:n + 8] = [5, 6, H - 7, H - 6]
    ok = rng.random(b) < 0.9
    ok[:n] = True
    valid = rng.random((H, W)) < 0.9
    valid[12, 15] = True
    js = js.replace(valid=jnp.asarray(valid))
    ts = ts.replace(valid=torch.as_tensor(valid))
    want = np.asarray(jf._classify_peaks(
        jd, js, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(curve),
        weak_peak_radius, jnp.asarray(ok)))
    got = tf._classify_peaks(td, ts, torch.as_tensor(xs),
                             torch.as_tensor(ys), torch.as_tensor(curve),
                             weak_peak_radius, torch.as_tensor(ok)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    for cls in (STRONG, WEAK, UNKNOWN):
        assert (got == cls).sum() > 10
    # the crafted rows' classes, as the reference's rule gives them
    crafted = got[:n]
    assert crafted[0] == STRONG and crafted[1] == WEAK
    assert crafted[7] == crafted[8] == crafted[9] == WEAK
