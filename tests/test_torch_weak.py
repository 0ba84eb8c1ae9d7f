"""K6, the deformable NCC of weak pixels (ops/cuda/weak.py, csrc/weak.cu):
its plain version against the JAX package's ``deformable.ncc_weak`` and
against the torch-op composition it replaced
(``testing.weak_composition``: two K1 launches and ~575 torch ops a plane,
the torch-op ``cost.geom_cost``); P planes in one call against P calls of
one; the probes' rule that only weighted views are evaluated; the
wrapper's CPU contract; the initial cost's route through it and the weak
sweep's around it (its candidates and probes run inside K7 since K7,
tests/test_torch_weak_sweep.py); and, on a card, the kernel against its
plain version bit for bit.

Cases run on the 24x32 synthetic scene with 4 source views of
tests/test_torch_deformable.py, every other pixel weak, seeded anchors
(about 10% missing) and selections: u8 and f32 quad tables, SA tap weights
(a seeded segment mask) on and off, the geometric cost on and off, 10
planes a pixel (``kernel_cases.weak_planes``: near the truth, tilted,
random ones whose warps leave the image, NaN, w = 0 and the zero fit
plane). The plain version sums in a fixed order, the JAX package and the
composition with torch's reductions, so the tolerance is
tests/test_torch_deformable.py's: 1e-4, at most 0.5% of the costs beyond
it, none beyond 1e-2.

The card part imports no JAX, so on a machine with a card and without the
JAX package's imports it runs with ``--noconftest`` (the JAX parity tests
then skip):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_weak.py
"""

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch.config import STRONG, WEAK, PatchMatchParams
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import deformable as tdef
from apde_mvs_tpu_torch.ops import init as tinit
from apde_mvs_tpu_torch.ops import propagation as tprop
from apde_mvs_tpu_torch.ops.cuda import sampler as k1
from apde_mvs_tpu_torch.ops.cuda import weak as k6
from apde_mvs_tpu_torch.ops.cuda import weak_sweep as k7
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.testing.kernel_cases import (VIEW_PATTERNS,
                                                     cycled_views,
                                                     weak_planes,
                                                     weak_view_weights)
from apde_mvs_tpu_torch.testing.weak_composition import weak_composition

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

H, W, V = 24, 32, 5
S = V - 1
P = 10
COST_MAX = tcost.COST_MAX
GF = 0.2
ATOL = 1e-4
LOOSE_SHARE, LOOSE_ATOL = 0.005, 1e-2
# name: table type, SA tap weights, geometric cost
CASES = ("u8", "f32-geom", "sa-u8-geom", "sa-f32")
# the card's further cases: the probes' view weights (``kernel_cases``),
# 1 or 32 source views (the 4 cycled), a ragged or one-pixel chunk, one
# plane (the initial cost's re-score), and windows other than the main
# path's 36 + 8 x 9 taps (the kernel's generic tap loops): 25-tap centre
# and anchor windows of radius 4, step 2, with and without SA
CARD_CASES = CASES + tuple(f"u8-geom-vw-{p}" for p in VIEW_PATTERNS) + (
    "sa-f32-geom-vw-random", "u8-geom-s1", "sa-u8-geom-s32",
    "u8-geom-ragged", "u8-geom-one-pixel", "u8-p1", "u8-geom-taps25",
    "sa-f32-taps25")


def assert_costs_close(got, want):
    diff = np.abs(got - want)
    assert (diff > ATOL).mean() <= LOOSE_SHARE, (diff > ATOL).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOSE_ATOL)


@functools.lru_cache(maxsize=None)
def _scene():
    return synthetic.make_scene(num_views=V, height=H, width=W)


def _sa_mask(depth, seed):
    """Seeded segment ids (tests/test_torch_deformable.py's): segment 1
    where the scene is nearer than its mean, a block of segment 2."""
    rng = np.random.default_rng(seed)
    m = np.where(depth < depth.mean(), 1, 0).astype(np.int32)
    y0, x0 = rng.integers(4, H // 2), rng.integers(4, W // 2)
    m[y0:y0 + 9, x0:x0 + 12] = 2
    return m


def _anchors(rng, wx, wy):
    """(Nw, 9, 2) anchors: slot 0 the pixel, slots 1-8 random pixels, about
    10% missing (tests/test_torch_deformable.py's)."""
    n = len(wx)
    a = np.stack([rng.integers(0, W, (n, 9)), rng.integers(0, H, (n, 9))],
                 -1).astype(np.int32)
    a[rng.random((n, 9)) < 0.1] = -1
    a[:, 0, 0] = wx
    a[:, 0, 1] = wy
    return a


class Case(NamedTuple):
    data: tcost.CostData
    wref: tdef.WeakRefData
    planes: torch.Tensor           # (B, P, 4)
    cfg: tprop.PropCfg
    geom: bool
    vw: Optional[torch.Tensor]     # (B, S) probe weights, or None
    x: torch.Tensor                # (B,) int32 weak pixels
    y: torch.Tensor
    anchors: torch.Tensor          # (B, 9, 2) int32
    selected: torch.Tensor         # (H, W, S) bool


def _case(name: str, device="cpu", seed: int = 0) -> Case:
    parts = name.split("-")
    sa, geom = "sa" in parts, "geom" in parts
    u8 = "u8" in parts
    scene = _scene()
    dev = torch.device(device)
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    mask = torch.as_tensor(_sa_mask(scene.depths[0], seed), device=dev) \
        if sa else None
    data = tcost.CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]), imgs[0], imgs[1:],
        src_depths=torch.as_tensor(np.stack(scene.depths[1:]), device=dev),
        sampler_u8=u8, sa_mask=mask)
    rng = np.random.default_rng(seed + 1)
    ys, xs = np.mgrid[0:H, 0:W]
    pick = (xs + ys) % 2 == 0
    wx, wy = xs[pick].astype(np.int32), ys[pick].astype(np.int32)
    if "ragged" in parts:
        wx, wy = wx[:37], wy[:37]
    elif "pixel" in parts:
        wx, wy = wx[100:101], wy[100:101]
    anchors = _anchors(rng, wx, wy)
    selected = rng.random((H, W, S)) < 0.5
    s_views = S
    if "s1" in parts or "s32" in parts:
        s_views = 1 if "s1" in parts else 32
        data, idx = cycled_views(data, s_views)
        selected = selected[..., idx]
    window = dict(strong_radius=4, strong_increment=2, weak_radius=4,
                  weak_increment=2) if "taps25" in parts else {}
    cfg = tprop.PropCfg(use_sa=sa, geom_consistency=geom, **window)
    x = torch.as_tensor(wx, device=dev)
    y = torch.as_tensor(wy, device=dev)
    xf, yf = x.float(), y.float()
    anchors_t = torch.as_tensor(anchors, device=dev)
    selected_t = torch.as_tensor(selected, device=dev)
    wref = tdef.contiguous_ref(tdef.WeakRefData.build(
        data, xf, yf, anchors_t, selected_t, cfg))
    normal = tgeo.normal_world_to_cam(cams.view(0).R, torch.cat(
        [torch.as_tensor(scene.normals[0][wy, wx], device=dev),
         torch.zeros((len(wx), 1), device=dev)], -1))[:, :3]
    planes = weak_planes(cams.view(0), xf, yf, torch.as_tensor(
        scene.depths[0][wy, wx], device=dev), normal,
        1 if "p1" in parts else P, seed)
    vw = None
    if "vw" in parts:
        vw = weak_view_weights(len(wx), s_views, parts[-1], seed, dev)
    return Case(data, wref, planes, cfg, geom, vw, x, y, anchors_t,
                selected_t)


def _plain(c: Case, **changes):
    kw = dict(geom=c.geom, view_weights=c.vw)
    kw.update(changes)
    planes = kw.pop("planes", c.planes)
    return k6.weak_plain(c.data, c.wref, planes, c.cfg.weak_radius,
                         c.cfg.weak_increment, **kw)


def _fused(c: Case, **changes):
    args = dict(data=c.data, wref=c.wref, planes_=c.planes,
                radius=c.cfg.weak_radius, increment=c.cfg.weak_increment)
    kw = dict(geom=c.geom, view_weights=c.vw)
    for k, v in changes.items():
        (args if k in args else kw)[k] = v
    return k6.weak_fused(**args, **kw)


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32)


def _same(got, want) -> bool:
    """Bit for bit, NaN included; both outputs."""
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            return False
        if g is not None and (g.shape != w.shape
                              or not torch.equal(_bits(g), _bits(w))):
            return False
    return True


# ---------------------------------------------------------------------------
# The plain version against the JAX package and the composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("u8,use_sa", [(True, False), (False, False),
                                       (True, True), (False, True)])
def test_plain_matches_jax(u8, use_sa):
    """The plain version against the JAX package's ``ncc_weak`` on
    tests/test_torch_deformable.py's fixture and planes, at its tolerance,
    and against the composition it replaced on those planes, their next
    pixel's and their w scaled by 1.05."""
    pytest.importorskip("apde_mvs_tpu.ops.deformable")
    import jax.numpy as jnp
    import test_torch_deformable as fixture

    from apde_mvs_tpu.ops import deformable as jdef
    from apde_mvs_tpu_torch import convert
    jd, td, wx, wy, anchors, selected, planes, params = fixture.setup(
        u8, use_sa)
    jref = jdef.WeakRefData.build(
        jd, jnp.asarray(wx, jnp.float32), jnp.asarray(wy, jnp.float32),
        jnp.asarray(anchors), jnp.asarray(selected), params)
    tref = tdef.contiguous_ref(tdef.WeakRefData.build(
        td, torch.as_tensor(wx, dtype=torch.float32),
        torch.as_tensor(wy, dtype=torch.float32), convert.ints(anchors, "cpu"),
        torch.as_tensor(selected), params))
    scaled = planes.copy()
    scaled[:, 3] *= 1.05
    stack = torch.as_tensor(np.stack([planes, np.roll(planes, 1, 0), scaled],
                                     1))
    got = k6.weak_plain(td, tref, stack, params.weak_radius,
                        params.weak_increment, geom=False).ncc
    want = np.asarray(jdef.ncc_weak(jd, jref, jnp.asarray(planes), params))
    assert_costs_close(got[:, 0].numpy(), want)
    assert (want == COST_MAX).sum() > 20 and (want < 0.3).sum() > 20
    comp, _ = weak_composition(td, tref, stack, params)
    assert_costs_close(got.numpy(), comp.numpy())


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_the_composition_it_replaces(name):
    """Costs to the JAX parity tolerance, the geometric costs exactly (the
    same torch ops), and no K1 launch on CPU tensors."""
    c = _case(name)
    before = k1.launches
    want, gwant = weak_composition(c.data, c.wref, c.planes, c.cfg,
                                   geom=c.geom)
    got = _plain(c)
    assert k1.launches == before
    assert got.ncc.shape == (c.x.numel(), P, S)
    assert_costs_close(got.ncc.numpy(), want.numpy())
    if c.geom:
        assert torch.equal(got.geom, gwant)
    else:
        assert got.geom is None
    # the fixture reaches every branch: centres out of the image, real
    # matches, NaN and zero planes
    assert (want == COST_MAX).float().mean() > 0.05
    assert (want < 0.3).sum() > 50


@pytest.mark.parametrize("name", CASES)
def test_planes_in_one_call_equal_single_plane_calls(name):
    c = _case(name)
    got = _plain(c)
    for i in range(P):
        one = _plain(c, planes=c.planes[:, i:i + 1].contiguous())
        assert _same((got.ncc[:, i], None if got.geom is None
                      else got.geom[:, i]),
                     (one.ncc[:, 0], None if one.geom is None
                      else one.geom[:, 0])), f"plane {i}"


def test_geom_output_is_cost_geom_cost():
    c = _case("sa-u8-geom")
    got = _plain(c)
    for i in range(P):
        want = tcost.geom_cost(c.data, c.wref.x, c.wref.y, c.planes[:, i])
        assert torch.equal(_bits(got.geom[:, i]), _bits(want)), f"plane {i}"


@pytest.mark.parametrize("pattern", VIEW_PATTERNS)
def test_probe_weights_keep_the_weighted_sums(pattern):
    """The probes' launch evaluates only the views weighing > 0: the others
    cost COST_MAX with geometric cost 0, and the weighted sums the weak
    sweep takes, (vw * (ncc + gf * geom)).sum(-1), equal the all-views
    sums bit for bit."""
    c = _case("sa-u8-geom")
    vw = weak_view_weights(c.x.numel(), S, pattern, 5, "cpu")
    every = _plain(c, view_weights=None)
    some = _plain(c, view_weights=vw)
    keep = (vw > 0)[:, None].expand(-1, P, -1)
    assert torch.equal(_bits(some.ncc[keep]), _bits(every.ncc[keep]))
    assert torch.equal(_bits(some.geom[keep]), _bits(every.geom[keep]))
    assert bool((some.ncc[~keep] == COST_MAX).all())
    assert bool((some.geom[~keep] == 0).all())
    gf = tgeo.f32_scalar(GF, "cpu")
    sums = [(vw[:, None] * (o.ncc + gf * o.geom)).sum(-1)
            for o in (some, every)]
    assert torch.equal(_bits(sums[0]), _bits(sums[1]))
    if pattern == "none":
        assert bool((some.ncc == COST_MAX).all())


# ---------------------------------------------------------------------------
# The wrapper's CPU contract and the routes through it
# ---------------------------------------------------------------------------

def _launches():
    return (k6.launches, k6.planes, k1.launches)


def test_cpu_tensors_take_the_plain_version():
    c = _case("sa-u8-geom-vw-random")
    before = _launches()
    got = _fused(c)
    assert _launches() == before
    assert _same(got, _plain(c))


def _bad(c: Case, what):
    """One argument the wrapper must refuse, and the error it raises."""
    b = c.x.numel()
    wref, cw = c.wref, c.wref.center_win
    table = {
        "planes float64": (dict(planes_=c.planes.double()), TypeError),
        "planes (B, P, 3)": (dict(planes_=c.planes[..., :3].contiguous()),
                             ValueError),
        "planes (B - 1, P, 4)": (dict(planes_=c.planes[1:]), ValueError),
        "planes not contiguous": (dict(planes_=c.planes.transpose(
            0, 1).contiguous().transpose(0, 1)), ValueError),
        "x (B - 1,)": (dict(wref=wref._replace(x=wref.x[1:])), ValueError),
        "anchor_sel uint8": (dict(wref=wref._replace(
            anchor_sel=wref.anchor_sel.to(torch.uint8))), TypeError),
        "anchor_sel (B, 8, S - 1)": (dict(wref=wref._replace(
            anchor_sel=wref.anchor_sel[..., 1:].contiguous())), ValueError),
        "anchor tap_val (B, 8, 25)": (dict(radius=4, increment=2),
                                      ValueError),
        "anchor tap_w missing": (dict(wref=wref._replace(tap_w=None)),
                                 ValueError),
        "centre tap_val float64": (dict(wref=wref._replace(
            center_win=cw._replace(tap_val=cw.tap_val.double()))),
            TypeError),
        "view_weights (B, S + 1)": (dict(view_weights=torch.zeros(
            b, S + 1)), ValueError),
        "src_depths (H, W)": (dict(data=c.data.replace(
            src_depths=c.data.src_depths[0])), ValueError),
        "anchor_x on another device": (dict(wref=wref._replace(
            anchor_x=torch.empty((b, 8), device="meta"))), ValueError),
    }
    return table[what]


@pytest.mark.parametrize("what", [
    "planes float64", "planes (B, P, 3)", "planes (B - 1, P, 4)",
    "planes not contiguous", "x (B - 1,)", "anchor_sel uint8",
    "anchor_sel (B, 8, S - 1)", "anchor tap_val (B, 8, 25)",
    "anchor tap_w missing", "centre tap_val float64",
    "view_weights (B, S + 1)", "src_depths (H, W)",
    "anchor_x on another device"])
def test_wrapper_rejects_bad_arguments(what):
    c = _case("sa-u8-geom")
    changes, err = _bad(c, what)
    before = _launches()
    with pytest.raises(err):
        _fused(c, **changes)
    assert _launches() == before


def test_wrapper_takes_32_views_and_rejects_33():
    c = _case("u8-geom")
    for n, ok in ((32, True), (33, False)):
        data, idx = cycled_views(c.data, n)
        wref = c.wref._replace(
            anchor_sel=c.wref.anchor_sel[..., idx].contiguous())
        if ok:
            assert _fused(c, data=data, wref=wref).ncc.shape \
                == (c.x.numel(), P, 32)
        else:
            with pytest.raises(ValueError, match="at most 32"):
                _fused(c, data=data, wref=wref)


def _sweep_state(c: Case) -> PMState:
    """The scene's planes (camera frame, 1% depth noise) on every pixel,
    the weak list WEAK and the rest STRONG, the case's selections."""
    scene = _scene()
    rng = np.random.default_rng(7)
    xs, ys = tgeo.pixel_grid(H, W, "cpu")
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    depth = torch.as_tensor((scene.depths[0] * (1 + rng.normal(
        0, 0.01, (H, W)))).astype(np.float32))
    normal = tgeo.normal_world_to_cam(cams.view(0).R, torch.cat(
        [torch.as_tensor(scene.normals[0]), torch.zeros((H, W, 1))],
        -1))[..., :3]
    planes = tgeo.make_plane(cams.view(0), xs.float(), ys.float(), depth,
                             normal)
    weak = torch.full((H, W), STRONG, dtype=torch.int32)
    weak[c.y.long(), c.x.long()] = WEAK
    return PMState.create(H, W, S, device="cpu").replace(
        planes=planes.contiguous(), weak=weak, selected=c.selected,
        costs=torch.as_tensor(rng.uniform(0, 1.5, (H, W)).astype(
            np.float32)))


def _fail(*a, **kw):
    pytest.fail("the weak path reached K1, K6 or the torch-op geometric "
                "cost")


def test_weak_sweep_makes_two_k6_calls_a_chunk(monkeypatch):
    """The weak sweep's route through its kernels. Before K7 a chunk was
    two K6 calls (the 10 candidates, the 5 probes); since K7
    (ops/cuda/weak_sweep.py) took the chunk update, propagate_weak calls
    K7's wrapper once a chunk and K6's not at all, and never reaches K1 or
    the torch-op geometric cost. The test keeps its name from before K7."""
    c = _case("sa-u8-geom")
    calls = []
    fused = k7.weak_update_fused

    def counted(*a, **kw):
        calls.append((a[2].numel(), kw["geom"], kw["use_sa"]))
        return fused(*a, **kw)
    monkeypatch.setattr(k7, "weak_update_fused", counted)
    monkeypatch.setattr(k6, "weak_fused", _fail)
    monkeypatch.setattr(k1, "sample_packed", _fail)
    monkeypatch.setattr(tcost, "geom_cost", _fail)
    monkeypatch.setattr(tprop, "geom_cost", _fail, raising=False)
    state = _sweep_state(c)
    scene = _scene()
    dmin, dmax = scene.cameras[0].depth_min, scene.cameras[0].depth_max
    fit = state.planes[c.y.long(), c.x.long()].clone()
    fit[::5] = 0.0
    n = c.x.numel()
    out = tprop.propagate_weak(
        c.data, state, c.cfg, 1, c.x, c.y, c.anchors, fit, dmin, dmax, GF,
        generator=torch.Generator().manual_seed(0), chunk=37)
    assert calls == [(min(37, n - lo), True, True) for lo in range(0, n, 37)]
    moved = (out.planes != state.planes).any(-1)
    assert int(moved.sum()) > 10 and bool(moved[state.weak == STRONG].sum()
                                          == 0)


def test_initial_cost_rescore_makes_one_k6_call_a_chunk(monkeypatch):
    """The initial cost's re-score: one call of K6's re-score form a
    WEAK_CHUNK of the weak list, its items in order, writing at the
    pixels' raster positions (on the serial route the selection mode,
    whose epilogue writes the pixels' selections), and no call of the
    cost-out mode (the tile route's) or of the weak-sweep form."""
    c = _case("u8")
    calls = []
    fused = k6.rescore_select_fused

    def counted(*a, **kw):
        calls.append((a[6], a[7]))
        return fused(*a, **kw)
    monkeypatch.setattr(k6, "rescore_select_fused", counted)
    monkeypatch.setattr(k6, "rescore_fused", _fail)
    monkeypatch.setattr(k6, "weak_fused", _fail)
    monkeypatch.setattr(k1, "sample_packed", _fail)
    monkeypatch.setattr(tinit, "WEAK_CHUNK", 100)
    state = _sweep_state(c)
    params = PatchMatchParams(use_sa=False)
    out = tinit.initial_cost(c.data, state, params, c.x, c.y, c.anchors)
    n = c.x.numel()
    assert calls == [(lo, min(lo + 100, n)) for lo in range(0, n, 100)]
    # the re-score's selections land at the pixels' raster positions
    cost, sel = k6.rescore_select_plain(
        c.data, state.planes, state.selected, c.x, c.y, c.anchors,
        state.valid, params.top_k, strong_radius=params.strong_radius,
        strong_increment=params.strong_increment,
        weak_radius=params.weak_radius,
        weak_increment=params.weak_increment, use_sa=False)
    yl, xl = c.y.long(), c.x.long()
    assert torch.equal(out.costs[yl, xl].view(torch.int32),
                       cost.view(torch.int32))
    assert torch.equal(out.selected[yl, xl], sel)


def test_profile_pass_times_k6_and_restores_it():
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    fused = k6.weak_fused
    with pp.timed_kernels({}):
        assert k6.weak_fused is not fused
    assert k6.weak_fused is fused


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K6 is a CUDA kernel; no CUDA device here")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_k6_matches_plain_on_card(cuda_device, name):
    c = _case(name, cuda_device)
    before = _launches()
    got = _fused(c)
    torch.cuda.synchronize()
    p = c.planes.shape[1]
    assert _launches() == (before[0] + 1, before[1] + p, before[2])
    want = _plain(c)
    assert _same(got, want), "costs differ: " + ", ".join(
        f"{int((g != w).sum())}" for g, w in zip(got, want)
        if g is not None)


@pytest.mark.cuda
def test_weak_sweep_launches_k6_twice_a_chunk_on_card(cuda_device):
    """On CUDA tensors a chunk was two K6 launches before K7; since K7 it
    is one K7 launch, no K6 and no K1 launch (the test keeps its name from
    before K7). The sweep equals the same sweep on the CPU to the JAX
    parity tests' tolerance (planes and costs 2e-5, view weights and
    selections exact, at most 0.5% of the pixels flipped on a float
    tie)."""
    outs = []
    k6.reset_launches()
    k7.reset_launches()
    k1.reset_launches()
    for dev in (cuda_device, torch.device("cpu")):
        c = _case("sa-u8-geom", dev)
        state = _sweep_state(_case("sa-u8-geom"))
        state = PMState(**{f.name: getattr(state, f.name).to(dev)
                           for f in dataclasses.fields(PMState)})
        scene = _scene()
        fit = state.planes[c.y.long(), c.x.long()].clone()
        n = c.x.numel()
        draws = tprop.sweep_draws(torch.Generator().manual_seed(0), n, "cpu")
        draws = tprop.SweepDraws(draws.sel_u.to(dev), tprop.RefineRaws(
            *(r.to(dev) for r in draws.raws)))
        outs.append(tprop.propagate_weak(
            c.data, state, c.cfg, 1, c.x, c.y, c.anchors, fit,
            scene.cameras[0].depth_min, scene.cameras[0].depth_max, GF,
            draws=draws, chunk=37))
    torch.cuda.synchronize()
    assert k7.launches == k7.chunks == math.ceil(n / 37) \
        and k6.launches == 0 and k1.launches == 0
    got, want = outs[0], outs[1]
    bad = (got.view_weights.cpu() != want.view_weights).any(-1) \
        | (got.selected.cpu() != want.selected).any(-1) \
        | ~torch.isclose(got.costs.cpu(), want.costs, rtol=2e-5, atol=2e-5,
                         equal_nan=True) \
        | ~torch.isclose(got.planes.cpu(), want.planes, rtol=2e-5,
                         atol=2e-5, equal_nan=True).all(-1)
    assert bad.float().mean() <= 0.005


@pytest.mark.cuda
def test_k6_rejects_what_it_does_not_take_on_card(cuda_device):
    c = _case("u8-geom", cuda_device)
    with pytest.raises(ValueError):     # not contiguous
        _fused(c, planes_=c.planes.transpose(0, 1).contiguous().transpose(
            0, 1))
    with pytest.raises(ValueError):     # a CPU tensor among CUDA ones
        _fused(c, wref=c.wref._replace(x=c.wref.x.cpu()))
    with pytest.raises(TypeError):
        _fused(c, planes_=c.planes.double())
