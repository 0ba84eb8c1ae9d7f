"""K5, the fused disparity sweep (ops/cuda/sweep.py, csrc/sweep.cu): its
plain version against the per-probe composition it replaced
(``testing.sweep_composition``, the old ``_sweep_cost`` loop: one K2 call,
the geometric cost and the view weighting a probe) and against the JAX
package's ``depth_to_weak`` / ``local_refine``; the wrapper's CPU contract;
the filters' route through it; and, on a card, the kernel against its plain
version bit for bit.

Cases run on a 24x32 synthetic scene with 4 source views: u8 and f32 quad
tables, the geometric cost on and off, an SA star window on seeded segment
masks, a halo-extended row block (``src_height`` > ``height``), depth
bounds that cut probes, planes with zero, NaN and +-inf depths and normals,
pixels whose selected views all weigh 0, and a ragged pixel count (not a
multiple of 32). The kernel runs only the (pixel, view) pairs whose weight
is not 0; a CPU test pins that rule against the plain version on every
case and on weight patterns (no view weighted, one, every view, a NaN
weight, -0 weights). On the card K5 is also held at those patterns, at 1
and 32 source views, at a ragged count and one pixel, and on 25-tap
windows (the kernel's generic tap loop; its main path runs 36 taps).

The card part imports no JAX, so on a machine with a card and without the
JAX package's imports it runs with ``--noconftest`` (the JAX parity tests
then skip):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sweep.py
"""

import functools
import math

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch.config import STRONG, UNKNOWN, WEAK
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import filters as tf
from apde_mvs_tpu_torch.ops.cuda import build as kbuild
from apde_mvs_tpu_torch.ops.cuda import ncc as k2
from apde_mvs_tpu_torch.ops.cuda import sampler as k1
from apde_mvs_tpu_torch.ops.cuda import sweep as k5
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.parallel.tiles import halo_block
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.testing.kernel_cases import (WEIGHT_PATTERNS,
                                                     weight_pattern,
                                                     window_25)
from apde_mvs_tpu_torch.testing.sweep_composition import sweep_composition

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

H, W, V = 24, 32, 5
S = V - 1
COST_MAX = tcost.COST_MAX
GF = 0.2
CASES = ("u8", "f32-geom", "u8-geom-cut", "sa-u8-geom", "sa-f32",
         "halo-u8-geom", "halo-sa-f32-cut")
MODES = ("classify", "refine")
# the card's further cases: a weight pattern (``kernel_cases``), 1 or 32
# source views (the 4 cycled), a ragged or one-pixel count, a 25-tap square
# window with shared or per-pixel offsets and weights
CARD_CASES = CASES + tuple(f"u8-geom-vw-{p}" for p in WEIGHT_PATTERNS) + (
    "u8-geom-s1", "sa-u8-geom-s32", "u8-geom-ragged", "u8-geom-one-pixel",
    "u8-geom-taps25", "f32-taps25-pp")


@functools.lru_cache(maxsize=None)
def _scene():
    return synthetic.make_scene(num_views=V, height=H, width=W)


def _sa_mask(depth, seed):
    """Seeded segment ids: segment 1 where the slanted scene is nearer than
    its mean, a random block of segment 2 across it, specks of segment 3
    (tests/test_torch_ncc.py)."""
    rng = np.random.default_rng(seed)
    m = np.where(depth < depth.mean(), 1, 0).astype(np.int32)
    y0, x0 = rng.integers(3, H // 2), rng.integers(3, W // 2)
    m[y0:y0 + 8, x0:x0 + 11] = 2
    m[rng.random(m.shape) < 0.03] = 3
    return m


def _state(data, row0, rng, degenerate=True):
    """(world normal, depth) planes near the truth, ~30% badly off; with
    ``degenerate`` some zero, NaN and +-inf depths and normals; random
    selections and weights, some selected views all weighing 0."""
    scene = _scene()
    S = data.num_src
    h, w = data.height, data.width
    rows = np.clip(np.arange(h) + row0, 0, H - 1)
    depth = scene.depths[0][rows] * (1 + rng.normal(0, 0.01, (h, w)))
    off = rng.random((h, w)) < 0.3
    depth = np.where(off, depth * (1 + rng.choice([-0.08, 0.1], (h, w))),
                     depth)
    planes = np.concatenate([scene.normals[0][rows], depth[..., None]],
                            -1).astype(np.float32)
    flat = planes.reshape(-1, 4)
    if degenerate:
        flat[::37, 3] = 0.0
        flat[5::41, :3] = np.nan
        flat[7::43, 3] = np.inf
        flat[11::47, 3] = -np.inf
        flat[13::53, 0] = np.inf
        flat[17::59, 3] = np.nan
    sel = rng.random((h, w, S)) < 0.6
    vw = rng.integers(0, 6, (h, w, S)).astype(np.float32)
    vw.reshape(-1, S)[3::29] = 0.0           # selected, but all weigh 0
    dev = data.device
    return PMState.create(h, w, S, device=dev).replace(
        planes=torch.as_tensor(planes, device=dev),
        selected=torch.as_tensor(sel, device=dev),
        view_weights=torch.as_tensor(vw, device=dev))


def _case(name, device="cpu"):
    """(cost data, state, x, y (int32), depth bounds) of one case. The pixels
    are a seeded raster-order subset of 601 (not a multiple of 32); 737
    for ``ragged``, 1 for ``one-pixel``. ``s1`` keeps the first source
    view, ``s32`` cycles the four into 32."""
    scene = _scene()
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    sa = name.startswith("sa") or "-sa" in name
    mask = torch.as_tensor(_sa_mask(scene.depths[0], 2), device=device) \
        if sa else None
    src = [1] if name.endswith("-s1") else \
        [1 + i % S for i in range(32)] if name.endswith("-s32") else \
        list(range(1, V))
    depths = torch.as_tensor(np.stack(scene.depths)[src], device=device) \
        if "geom" in name else None
    data = tcost.CostData.build(
        cams.view(0), cams.map(lambda a: a[src]), imgs[0], imgs[src],
        src_depths=depths, sampler_u8="u8" in name, sa_mask=mask)
    row0 = 0
    if name.startswith("halo"):
        data, row0, _, _ = halo_block(data, 6, 18, 4)   # 20 rows of 24
    rng = np.random.default_rng(CARD_CASES.index(name))
    state = _state(data, row0, rng)
    n = data.height * data.width
    count = 737 if name.endswith("ragged") else \
        1 if name.endswith("one-pixel") else 601
    pick = np.sort(rng.choice(n, count, replace=False))
    x = torch.as_tensor((pick % data.width).astype(np.int32), device=device)
    y = torch.as_tensor((pick // data.width).astype(np.int32), device=device)
    lo = scene.cameras[0].depth_min * 0.6
    hi = scene.cameras[0].depth_max * 1.2
    if name.endswith("cut"):
        lo, hi = scene.depths[0].min() * 0.97, scene.depths[0].max() * 1.01
    return data, state, x, y, (float(lo), float(hi))


def _inputs(data, state, x, y, sa):
    """The sweep's per-pixel inputs and window, as the filters make them."""
    xf, yf = x.float(), y.float()
    sc = tf._sweep_scalars(data, state, x, y)
    px = k5.SweepPixels(xf, yf, sc.plane_cam.contiguous(), sc.disp,
                        sc.base_line, sc.vw.contiguous(), sc.wnorm)
    win = tcost.precompute_ref_window(data, xf, yf, 5, 2, use_sa=sa)
    return sc, px, tcost.contiguous_window(win)


def _args(name, mode, device="cpu"):
    data, state, x, y, (lo, hi) = _case(name, device)
    sa = name.startswith("sa") or "-sa" in name
    sc, px, win = _inputs(data, state, x, y, sa)
    if "taps25" in name:
        win = tcost.contiguous_window(
            window_25(data, px.x, px.y, per_pixel=name.endswith("-pp")))
    if "-vw-" in name:
        px = weight_pattern(px, name.split("-vw-")[1])
    kw = dict(refine=mode == "refine", geom="geom" in name, geom_factor=GF,
              depth_min=lo, depth_max=hi)
    return data, sc, px, win, kw


def _assert_close(got, want, atol):
    """Costs within ``atol``, NaN and COST_MAX in the same places except
    where a cost sits within ``atol`` of the clamp."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    at_clamp = np.minimum(got, want) >= COST_MAX - atol
    np.testing.assert_array_equal((got == COST_MAX)[ok & ~at_clamp],
                                  (want == COST_MAX)[ok & ~at_clamp])
    np.testing.assert_allclose(got[ok], want[ok], atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The plain version on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_the_composition_it_replaces(name, mode):
    """The plain version against the per-probe loop it replaced (with the
    plane's w summed in K5's order): the view sum differs only in its
    summation order."""
    data, sc, px, win, kw = _args(name, mode)
    got = k5.sweep_plain(data, px, win, **kw)
    want = sweep_composition(data, sc, px, win, **kw)
    assert got.shape == (601, 12 if mode == "refine" else 61)
    _assert_close(got, want, 1e-3 if "sa" in name else 1e-4)
    # the cases reach what they are for: real costs, masked probes, empty
    # weights and degenerate planes at COST_MAX
    assert (got < 0.5).sum() > 100
    assert (got[sc.wnorm == 0] == COST_MAX).all() and (sc.wnorm == 0).any()
    nan_plane = torch.isnan(sc.plane_cam).any(-1)
    assert nan_plane.any() and (got[nan_plane] >= COST_MAX).all()
    if name.endswith("cut"):
        assert (got[:, 1:] == COST_MAX).float().mean() > 0.3


def _weighted_pairs_only(data, px, win, *, refine: bool, geom: bool,
                         geom_factor, depth_min, depth_max):
    """K5's costs as the kernel gathers them: only the (pixel, view) pairs
    whose weight is not 0 (NaN is, -0 is not) and whose pixel's weight sum
    is > 0, listed pixel by pixel in view order; each pixel's terms summed
    in list order from +0; the per-pair cost, the division and the masks
    as the plain version has them."""
    cam = data.ref_cam
    offsets = k5.REFINE_OFFSETS if refine else k5.CLASSIFY_OFFSETS
    depths = k5.probe_depths(cam.fx, px.disp, px.base_line, offsets)
    lo, hi = k5._f32(depth_min), k5._f32(depth_max)
    probes = [(depths[:, i], lo, hi) for i in range(len(offsets))]
    if refine:
        probes.insert(0, (px.plane[:, 3], -math.inf, math.inf))
    gf = k5._f32(geom_factor)
    on = (px.vw != 0) & (px.wnorm > 0)[:, None]
    pix, view = torch.nonzero(on, as_tuple=True)      # pixel, then view
    rank = (torch.cumsum(on.to(torch.int64), 1) - 1)[pix, view]
    n0, n1, n2 = px.plane[:, 0], px.plane[:, 1], px.plane[:, 2]
    cols = []
    for pd, lo, hi in probes:
        X = pd * (px.x - cam.cx) / cam.fx
        Y = pd * (px.y - cam.cy) / cam.fy
        w = -((n0 * X + n1 * Y) + n2 * pd)
        plane = torch.stack([n0, n1, n2, w], -1)
        cv = k2.ncc_strong_plain(data, px.x, px.y, plane, win)
        if geom:
            cv = cv + gf * tcost.geom_cost(data, px.x, px.y, plane)
        terms = px.vw[pix, view] * cv[pix, view]
        acc = torch.zeros_like(pd)
        for r in range(int(rank.max()) + 1 if rank.numel() else 0):
            at = rank == r        # each pixel's r-th weighted view
            acc = acc.index_put((pix[at],), acc[pix[at]] + terms[at])
        cost = acc / torch.clamp(px.wnorm, min=1e-20)
        cost = torch.where(px.wnorm > 0, cost, COST_MAX)
        cost = torch.where((pd >= lo) & (pd <= hi), cost, COST_MAX)
        cols.append(cost if refine else torch.clamp(cost, max=COST_MAX))
    return torch.stack(cols, 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "name", CASES + tuple(f"u8-geom-vw-{p}" for p in WEIGHT_PATTERNS))
def test_weighted_pairs_in_view_order_equal_plain(name, mode):
    """The rule K5's compaction relies on: the costs from the weighted
    pairs alone, each pixel's summed in view order from +0, equal the
    plain version's sum over every view bit for bit (a pair whose weight is
    0 adds +0 there), NaN payloads included."""
    data, _, px, win, kw = _args(name, mode)
    want = k5.sweep_plain(data, px, win, **kw)
    got = _weighted_pairs_only(data, px, win, **kw)
    assert _bitwise(got, want), \
        f"{int((got != want).sum())} costs differ"
    if name.endswith("nan"):
        assert torch.isnan(want).any()
    if name.endswith("none"):
        assert ((want == 0) | (want == COST_MAX)).all() and (want == 0).any()


def _jax():
    """(jax, jax.numpy, the JAX package's geometry, cost, filters and
    state modules), imported here: a machine with the card may lack the
    JAX package's imports."""
    jf = pytest.importorskip("apde_mvs_tpu.ops.filters")
    import jax
    import jax.numpy as jnp

    from apde_mvs_tpu.core import geometry as jgeo
    from apde_mvs_tpu.ops import cost as jcost
    from apde_mvs_tpu.ops.state import PMState as JState
    return jax, jnp, jgeo, jcost, jf, JState


def _jax_problem(td, ts):
    """The JAX package's CostData and PMState holding ``td``'s and ``ts``'s
    arrays."""
    _, jnp, jgeo, jcost, _, JState = _jax()

    def cams(c):
        return jgeo.CameraArrays(*(jnp.asarray(a.numpy())
                                   for a in (c.K, c.R, c.t, c.c)))
    sa = np.zeros((td.height, td.width), np.int32) if td.sa_mask is None \
        else td.sa_mask.numpy()
    jd = jcost.CostData(
        ref_cam=cams(td.ref_cam), src_cams=cams(td.src_cams),
        ref_image=jnp.asarray(td.ref_image.numpy()),
        src_quads=jnp.asarray(td.src_quads.numpy()), sa_mask=jnp.asarray(sa),
        src_depths=jnp.asarray(td.src_depths.numpy()), width=td.width,
        height=td.height, num_src=td.num_src, real_width=td.real_width,
        real_height=td.real_height, src_height=td.src_height)
    js = JState.create(td.height, td.width, td.num_src).replace(
        planes=jnp.asarray(ts.planes.numpy()),
        selected=jnp.asarray(ts.selected.numpy()),
        view_weights=jnp.asarray(ts.view_weights.numpy()),
        valid=jnp.asarray(ts.valid.numpy()))
    return jd, js


@pytest.mark.parametrize("name", ["u8", "f32-geom", "u8-geom-cut",
                                  "sa-u8-geom", "sa-f32"])
def test_sweeps_match_jax(name):
    """DepthToWeak and LocalRefine on the plain version (CPU tensors)
    against the JAX package's on the same arrays, over the near-truth
    planes: weak maps equal, curves to 1e-4 (SA 1e-3: a truncated star
    window of a few taps amplifies float-order noise), refined depths to
    rtol 1e-5."""
    jax, jnp, _, _, jf, _ = _jax()
    data, _, x, y, (lo, hi) = _case(name)
    state = _state(data, 0, np.random.default_rng(7), degenerate=False)
    sa = name.startswith("sa")
    geom = "geom" in name
    jd, js = _jax_problem(data, state)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    jw, jcurve = jax.jit(lambda d, s: jf.depth_to_weak(
        d, s, jx, jy, 2, sa, geom, jnp.float32(GF), jnp.float32(lo),
        jnp.float32(hi), return_curve=True))(jd, js)
    tw, tcurve = tf.depth_to_weak(data, state, x, y, 2, geom, GF, lo, hi,
                                  return_curve=True, use_sa=sa)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tcurve.numpy(), np.asarray(jcurve), rtol=0,
                               atol=1e-3 if sa else 1e-4)
    got = tw.numpy()
    assert (got == STRONG).sum() + (got == WEAK).sum() > 50 \
        and (got == UNKNOWN).sum() > 20
    jdep = jax.jit(lambda d, s: jf.local_refine(
        d, s, jx, jy, sa, geom, jnp.float32(GF), jnp.float32(lo),
        jnp.float32(hi)))(jd, js)
    tdep = tf.local_refine(data, state, x, y, geom, GF, lo, hi,
                           use_sa=sa).numpy()
    np.testing.assert_allclose(tdep, np.asarray(jdep), rtol=1e-5, atol=0)
    moved = tdep != state.planes.numpy()[y.numpy(), x.numpy(), 3]
    assert moved.sum() > 20 and (~moved).sum() > 20


def test_refine_accept_rule_equals_the_reference_loop():
    """LocalRefine's accept rule on K5's costs equals the reference's loop
    (COST_MAX to start, a strictly cheaper probe taken, NaN never): ties,
    NaN, costs at and above COST_MAX and -inf in the curve."""
    rng = np.random.default_rng(5)
    b = 601
    costs = rng.choice([0.1, 0.3, 0.5, 2.0, 2.5, np.nan, -np.inf, 1.9],
                       (b, 12), p=[.2, .2, .2, .15, .1, .05, .02, .08])
    costs = torch.as_tensor(costs.astype(np.float32))
    depth = torch.as_tensor(rng.uniform(2, 6, b).astype(np.float32))
    disp = torch.as_tensor(rng.uniform(8, 30, b).astype(np.float32))
    base = torch.as_tensor(rng.uniform(0.1, 0.3, b).astype(np.float32))
    fx = torch.tensor(40.0)
    p_depth = k5.probe_depths(fx, disp, base, k5.REFINE_OFFSETS)
    cost_now = costs[:, 0]
    min_cost = torch.full_like(cost_now, COST_MAX)
    best_depth = depth
    for i in range(11):
        better = costs[:, 1 + i] < min_cost
        min_cost = torch.where(better, costs[:, 1 + i], min_cost)
        best_depth = torch.where(better, p_depth[:, i], best_depth)
    want = torch.where((cost_now - min_cost) > 0.1, best_depth, depth)

    class Data:
        ref_cam = tgeo.CameraArrays(torch.diag(torch.stack(
            [fx, fx, torch.tensor(1.0)])), torch.eye(3), torch.zeros(3),
            torch.zeros(3))
    sc = tf._SweepScalars(torch.ones(b, dtype=torch.bool), None, depth, disp,
                          base, torch.ones(b), None)
    got = tf._refine_depths(Data, sc, costs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got != depth).sum() > 50 and (got == depth).sum() > 50


# ---------------------------------------------------------------------------
# The wrapper's CPU contract and the filters' route
# ---------------------------------------------------------------------------

def _launches():
    return (k5.launches, k2.launches, k1.launches)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_tensors_take_the_plain_version(mode):
    data, sc, px, win, kw = _args("sa-u8-geom", mode)
    before = _launches()
    got = k5.sweep_fused(data, px, win, **kw)
    assert _launches() == before
    assert torch.equal(got, k5.sweep_plain(data, px, win, **kw))
    assert got.shape == (601, 12 if mode == "refine" else 61)


def _bad(data, px, win, kw, what):
    """One argument set the wrapper must refuse, and the error it raises."""
    b = px.x.numel()
    if what == "x float64":
        return (data, px._replace(x=px.x.double()), win, kw), TypeError
    if what == "plane (B, 3)":
        return (data, px._replace(plane=px.plane[:, :3]), win, kw), ValueError
    if what == "disp float64":
        return (data, px._replace(disp=px.disp.double()), win, kw), TypeError
    if what == "base_line (B - 1,)":
        return (data, px._replace(base_line=px.base_line[1:]), win,
                kw), ValueError
    if what == "vw (B, S - 1)":
        return (data, px._replace(vw=px.vw[:, 1:]), win, kw), ValueError
    if what == "wnorm (B + 1,)":
        return (data, px._replace(wnorm=torch.ones(b + 1)), win,
                kw), ValueError
    if what == "window float64":
        return (data, px, win._replace(tap_val=win.tap_val.double()),
                kw), TypeError
    if what == "src_depths (H, W)":
        return (data.replace(src_depths=data.src_depths[0]), px, win,
                kw), ValueError
    if what == "src_depths float64":
        return (data.replace(src_depths=data.src_depths.double()), px, win,
                kw), TypeError
    if what == "vw on another device":
        return (data, px._replace(vw=px.vw.to("meta")), win, kw), ValueError
    raise AssertionError(what)


@pytest.mark.parametrize("what", [
    "x float64", "plane (B, 3)", "disp float64", "base_line (B - 1,)",
    "vw (B, S - 1)", "wnorm (B + 1,)", "window float64", "src_depths (H, W)",
    "src_depths float64", "vw on another device"])
def test_wrapper_rejects_bad_arguments(what):
    data, _, px, win, kw = _args("u8-geom-cut", "classify")
    args, err = _bad(data, px, win, kw, what)
    before = _launches()
    with pytest.raises(err):
        k5.sweep_fused(*args[:3], **args[3])
    assert _launches() == before


def test_wrapper_rejects_more_views_than_the_kernel_takes():
    data, _, px, win, kw = _args("u8", "classify")
    many = [i % S for i in range(k5.MAX_VIEWS + 1)]
    more = data.replace(src_quads=data.src_quads[many],
                        src_cams=data.src_cams.map(lambda a: a[many]),
                        src_depths=data.src_depths[many],
                        num_src=len(many))
    with pytest.raises(ValueError, match="at most 32"):
        k5.sweep_fused(more, px._replace(vw=px.vw[:, many].contiguous()),
                       win, **kw)


def test_filters_make_one_sweep_call_a_batch(monkeypatch):
    """depth_to_weak and local_refine call K5's stage entry once a batch,
    with the classify and refine modes, and never K2 or the sweep entry."""
    data, state, x, y, (lo, hi) = _case("sa-u8-geom")
    calls = []
    fused = k5.stage_fused

    def counted(*a, **kw):
        calls.append(kw["refine"])
        return fused(*a, **kw)
    monkeypatch.setattr(k5, "stage_fused", counted)
    monkeypatch.setattr(k5, "sweep_fused",
                        lambda *a, **kw: pytest.fail("sweep entry called"))
    before = (k2.launches, dict(k2.site_launches))
    k2_calls = []
    monkeypatch.setattr(k2, "ncc_strong_fused",
                        lambda *a, **kw: k2_calls.append(1))
    weak, curve = tf.depth_to_weak(data, state, x, y, 2, True, GF, lo, hi,
                                   return_curve=True, use_sa=True)
    depth = tf.local_refine(data, state, x, y, True, GF, lo, hi, use_sa=True)
    assert calls == [False, True] and not k2_calls
    assert (k2.launches, dict(k2.site_launches)) == before
    assert curve.shape == (601, 61) and weak.shape == depth.shape == (601,)


def _stage_kw(name, mode):
    """``stage_fused``'s keyword arguments for case ``name``."""
    _, _, _, _, (lo, hi) = _case(name)
    sa = name.startswith("sa") or "-sa" in name
    kw = dict(refine=mode == "refine", radius=5, increment=2, use_sa=sa,
              geom="geom" in name, geom_factor=GF, depth_min=lo,
              depth_max=hi)
    if mode == "classify":
        kw.update(weak_peak_radius=2, return_curve=True)
    return kw


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["u8-geom-cut", "sa-f32"])
def test_stage_over_one_chunk_equals_eight_chunks(name, mode):
    """The stage entry over all of a case's pixels at once equals the same
    pixels in 8 chunks, concatenated: a pixel's result depends on no other
    pixel of its chunk."""
    data, state, x, y, _ = _case(name)
    kw = _stage_kw(name, mode)
    whole = k5.stage_fused(data, state, x, y, **kw)
    parts = [k5.stage_fused(data, state, cx, cy, **kw)
             for cx, cy in zip(torch.tensor_split(x, 8),
                               torch.tensor_split(y, 8))]
    if mode == "refine":
        assert _bitwise(whole, torch.cat(parts))
    else:
        assert torch.equal(whole[0], torch.cat([w for w, _ in parts]))
        assert _bitwise(whole[1], torch.cat([c for _, c in parts]))
        assert whole[0].dtype == torch.int32 and whole[1].shape == (601, 61)


@pytest.mark.parametrize("mode", MODES)
def test_stage_plain_is_the_sweep_between_setup_and_rule(mode):
    """The stage's plain version is the setup (``_sweep_scalars``), the
    window K3 builds (``strong.window_plain``), the sweep's plain version
    and the rule (``_classify_peaks`` / ``_refine_depths``); with u8 tables
    the window's values are integers, so it equals the route it replaced
    (``precompute_ref_window`` and the sweep entry) bit for bit."""
    name = "sa-u8-geom"
    data, state, x, y, _ = _case(name)
    kw = _stage_kw(name, mode)
    got = k5.stage_plain(data, state, x, y, **kw)
    sc, px, win = _inputs(data, state, x, y, True)
    costs = k5.sweep_fused(data, px, win, refine=kw["refine"],
                           geom=kw["geom"], geom_factor=GF,
                           depth_min=kw["depth_min"],
                           depth_max=kw["depth_max"])
    if mode == "refine":
        want = torch.where(sc.ok & (sc.wnorm > 0) & state.valid[y, x],
                           tf._refine_depths(data, sc, costs), sc.depth)
        assert _bitwise(got, want)
        assert (got != sc.depth).sum() > 20
    else:
        want = tf._classify_peaks(data, state, x, y, costs, 2, sc.ok)
        assert torch.equal(got[0], want) and _bitwise(got[1], costs)


def test_stage_wrapper_rejects_bad_arguments():
    """The stage entry checks the pixels, the maps and the window on every
    device before anything runs."""
    data, state, x, y, _ = _case("sa-u8-geom")
    kw = _stage_kw("sa-u8-geom", "refine")
    before = _launches()
    bad = [(dict(x=x.float()), TypeError), (dict(y=y[1:]), ValueError),
           (dict(state=state.replace(selected=state.selected.float())),
            TypeError),
           (dict(state=state.replace(view_weights=state.view_weights[
               ..., 1:])), ValueError),
           (dict(state=state.replace(valid=state.valid[1:])), ValueError),
           (dict(radius=4), ValueError)]
    for change, err in bad:
        args = dict(data=data, state=state, x=x, y=y)
        args.update({k: v for k, v in change.items() if k in args})
        with pytest.raises(err):
            k5.stage_fused(**args, **dict(kw, **{k: v for k, v in
                                                 change.items()
                                                 if k not in args}))
    assert _launches() == before


def test_camera_table_is_built_once_per_cost_data():
    data, *_ = _case("u8-geom-cut")
    first = k5.cached_camera_table(data)
    assert k5.cached_camera_table(data) is first
    assert first.shape == (S + 1, k5.CAM_STRIDE)
    assert torch.equal(first[:, :16], k2.camera_table(data))
    assert torch.equal(first[:S, 16:25].reshape(S, 3, 3), data.src_cams.R)
    assert torch.equal(first[S, 28:37].reshape(3, 3), data.ref_cam.K)
    assert torch.equal(first[S, 37:], data.ref_cam.c)


def test_build_hashes_headers_but_compiles_sources_only(monkeypatch,
                                                         tmp_path):
    """A header under csrc/ enters every library's hash, so an edited header
    rebuilds; nvcc is given the sources alone."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kbuild, "CSRC", tmp_path)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "out")
    first = kbuild.source_hash(("a.cu",))
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kbuild.source_hash(("a.cu",)) != first
    seen = []

    class Failed:
        returncode, stdout, stderr = 1, "", "stopped here"

    monkeypatch.setattr(kbuild, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kbuild.subprocess, "run",
                        lambda cmd, **kw: seen.append(cmd) or Failed())
    with pytest.raises(RuntimeError, match="stopped here"):
        kbuild.build("probe", ("a.cu",))
    assert seen[0][-1] == str(tmp_path / "a.cu")
    assert not any(a.endswith(".cuh") for a in seen[0])


def test_profile_pass_times_k5_and_restores_it():
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    fused = k5.sweep_fused
    with pp.timed_kernels({}):
        assert k5.sweep_fused is not fused
    assert k5.sweep_fused is fused


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K5 is a CUDA kernel; no CUDA device here")
    return torch.device("cuda")


def _bitwise(got, want):
    return got.shape == want.shape and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CARD_CASES)
def test_k5_matches_plain_on_card(cuda_device, name, mode):
    data, sc, px, win, kw = _args(name, mode, cuda_device)
    before = _launches()
    got = k5.sweep_fused(data, px, win, **kw)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1,) + before[1:]
    want = k5.sweep_plain(data, px, win, **kw)
    assert _bitwise(got, want), \
        f"{int((got != want).sum())} costs differ, max " \
        f"{float((got - want).abs().nan_to_num().max())}"
    if "one-pixel" not in name and "-vw-" not in name:
        assert (got < 0.5).sum() > 100
    if name.endswith("nan"):
        assert torch.isnan(got).any()


@pytest.mark.cuda
def test_filters_launch_k5_once_a_batch_on_card(cuda_device):
    """On CUDA tensors depth_to_weak and local_refine launch K5 once each
    (its stage form) and K2 never; their results equal the same calls on
    the CPU."""
    data, state, x, y, (lo, hi) = _case("sa-u8-geom", cuda_device)
    k2.reset_launches()
    before = k5.launches
    weak, curve = tf.depth_to_weak(data, state, x, y, 2, True, GF, lo, hi,
                                   return_curve=True, use_sa=True)
    depth = tf.local_refine(data, state, x, y, True, GF, lo, hi, use_sa=True)
    torch.cuda.synchronize()
    assert k5.launches == before + 2 and k2.launches == 0
    cd, cs, cx, cy, _ = _case("sa-u8-geom")
    cweak, ccurve = tf.depth_to_weak(cd, cs, cx, cy, 2, True, GF, lo, hi,
                                     return_curve=True, use_sa=True)
    np.testing.assert_array_equal(weak.cpu().numpy(), cweak.numpy())
    np.testing.assert_allclose(curve.cpu().numpy(), ccurve.numpy(), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(
        depth.cpu().numpy(),
        tf.local_refine(cd, cs, cx, cy, True, GF, lo, hi,
                        use_sa=True).numpy(), rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES + ("classify-no-curve",))
@pytest.mark.parametrize("name", CASES + ("u8-geom-ragged",
                                          "u8-geom-one-pixel", "sa-u8-geom-s32"))
def test_k5_stage_matches_plain_on_card(cuda_device, name, mode):
    """K5's stage form (the setup, the window, the sweep and the rule in
    one launch) bitwise equal to its plain version on the same CUDA
    tensors."""
    data, state, x, y, _ = _case(name, cuda_device)
    kw = _stage_kw(name, mode.split("-")[0])
    if mode == "classify-no-curve":
        kw["return_curve"] = False
    before = _launches()
    got = k5.stage_fused(data, state, x, y, **kw)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1,) + before[1:]
    want = k5.stage_plain(data, state, x, y, **kw)
    if mode == "refine":
        assert _bitwise(got, want), f"{int((got != want).sum())} depths differ"
    else:
        assert torch.equal(got[0], want[0]), \
            f"{int((got[0] != want[0]).sum())} classes differ"
        if kw["return_curve"]:
            assert _bitwise(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None


@pytest.mark.cuda
def test_k5_rejects_what_it_does_not_take_on_card(cuda_device):
    data, _, px, win, kw = _args("u8-geom-cut", "refine", cuda_device)
    with pytest.raises(ValueError):     # not contiguous
        k5.sweep_fused(data, px._replace(vw=px.vw.T.contiguous().T), win,
                       **kw)
    with pytest.raises(ValueError):     # a CPU tensor among CUDA ones
        k5.sweep_fused(data, px._replace(disp=px.disp.cpu()), win, **kw)
    with pytest.raises(TypeError):
        k5.sweep_fused(data, px._replace(plane=px.plane.double()), win,
                       **kw)
