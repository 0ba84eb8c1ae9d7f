"""K3, the strong sweep's colour update (ops/cuda/strong.py,
csrc/strong.cu): its plain version against the torch-op body it replaced
(``testing.strong_composition``, the old ``propagation._strong_body``: 14 K2
calls and the selection's torch ops a colour); the reference's quirks on
crafted pixels; the rule the kernel's weighted pairs rest on; the wrapper's
CPU contract and the sweep's route through it; the reference window K3
builds itself (``strong.window_plain``) against
``cost.precompute_ref_window``; and, on a card, the kernel against its
plain version bit for bit.

Cases run on a 24x32 synthetic scene with 4 source views, one colour's
pixels at a time: u8 and f32 quad tables, square and SA star windows, the
geometric cost on and off, REFINE_INIT's commit rule, iterations 0 and 2,
and a tile route's halo row block whose top rows lie outside the image
(``row_bounds``). Planes are near the truth on half the pixels and random
on the rest; costs and selections are random. The composition sums in
torch's order, the plain version in a fixed one, so the tolerance is the
JAX parity tests' (tests/test_torch_propagation.py): view weights and
selections exact, planes and costs to 2e-5, at most 0.5% of the pixels
flipped on a float tie.

The card part imports no JAX, so on a machine with a card and without the
JAX package's imports it runs with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_strong.py
"""

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch.core import checkerboard as cb
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import init as tinit
from apde_mvs_tpu_torch.ops import propagation as tprop
from apde_mvs_tpu_torch.ops import selection as tsel
from apde_mvs_tpu_torch.ops.cuda import ncc as k2
from apde_mvs_tpu_torch.ops.cuda import sampler as k1
from apde_mvs_tpu_torch.ops.cuda import strong as k3
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.parallel.tiles import halo_block
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.testing.kernel_cases import (SELECTION_PATTERNS,
                                                     WEIGHT_PATTERNS,
                                                     block_state,
                                                     cycled_views,
                                                     strong_draws,
                                                     weight_pattern)
from apde_mvs_tpu_torch.testing.strong_composition import (put_composition,
                                                            strong_composition)

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

H, W, V = 24, 32, 5
S = V - 1
COST_MAX = tcost.COST_MAX
GF = 0.3
MAX_FLIP = 0.005
# name: table type, window, geometric cost, REFINE_INIT, iteration, halo
CASES = ("u8-it2", "f32-geom-it2", "u8-geom-it0", "sa-u8-geom-it1",
         "sa-f32-it2", "u8-geom-init-it2", "halo-u8-geom-it2",
         "halo-sa-f32-init-it1")
# SA with the odd segment ids negative: no segment, so the square window
NEG_CASE = "sa-neg-u8-geom-it2"
# the card's further cases: selection draws weighting one view or many,
# every plane NaN (no view weighted), 1 or 32 source views (the 4 cycled),
# a ragged or one-pixel batch, other windows than the main path's (the
# generic tap loop): 25-tap squares of radius 4, step 2 and radius 6, step
# 3, and SA with a 36-tap square of radius 8, step 3; then the square at
# 32 views and negative segment ids
CARD_CASES = CASES + tuple(
    f"u8-geom-it2-sel-{p}" for p in SELECTION_PATTERNS[1:]) + (
    "u8-geom-it2-nan", "u8-geom-it2-s1", "sa-u8-geom-it2-s32",
    "u8-geom-it2-ragged", "u8-geom-it2-one-pixel", "u8-geom-it2-taps25",
    "f32-it2-taps25-pp", "sa-u8-geom-it2-r8i3", "u8-geom-it2-s32",
    NEG_CASE)
# (radius, increment) of a case's window
WINDOWS = {"taps25": (4, 2), "taps25-pp": (6, 3), "r8i3": (8, 3)}


@functools.lru_cache(maxsize=None)
def _scene():
    return synthetic.make_scene(num_views=V, height=H, width=W)


def _sa_mask(depth, seed):
    """Seeded segment ids (tests/test_torch_sweep.py)."""
    rng = np.random.default_rng(seed)
    m = np.where(depth < depth.mean(), 1, 0).astype(np.int32)
    y0, x0 = rng.integers(3, H // 2), rng.integers(3, W // 2)
    m[y0:y0 + 8, x0:x0 + 11] = 2
    m[rng.random(m.shape) < 0.03] = 3
    return m


def _bounds():
    cam = _scene().cameras[0]
    return float(cam.depth_min * 0.6), float(cam.depth_max * 1.2)


class Case(NamedTuple):
    data: tcost.CostData
    state: PMState
    x: torch.Tensor            # (B,) int32
    y: torch.Tensor
    win: tcost.RefWindow       # the window K3 builds (window_plain)
    draws: tprop.SweepDraws
    kw: dict                   # strong_fused's keyword arguments
    cfg: tprop.PropCfg


def _state(data, rng, nan=False):
    """Planes near the truth (1% depth noise) on half the pixels, random on
    the rest; random costs in [0, 1.5) and selections (40%); with ``nan``
    every plane NaN."""
    scene = _scene()
    dev = data.device
    dmin, dmax = _bounds()
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    rand = tinit.random_planes(data, dmin, dmax, generator=gen)
    xs, ys = tgeo.pixel_grid(H, W, dev)
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device=dev)
    depth = torch.as_tensor(
        scene.depths[0] * (1 + rng.normal(0, 0.01, (H, W))).astype(np.float32),
        device=dev)
    normal = tgeo.normal_world_to_cam(cams.view(0).R, torch.cat(
        [torch.as_tensor(scene.normals[0], device=dev),
         torch.zeros((H, W, 1), device=dev)], -1))[..., :3]
    near = tgeo.make_plane(cams.view(0), xs, ys, depth, normal)
    pick = torch.as_tensor(rng.random((H, W)) < 0.5, device=dev)
    planes = torch.where(pick[..., None], near, rand)
    if nan:
        planes = torch.full_like(planes, float("nan"))
    return PMState.create(H, W, data.num_src, device=dev).replace(
        planes=planes.contiguous(),
        costs=torch.as_tensor(rng.uniform(0, 1.5, (H, W)).astype(np.float32),
                              device=dev),
        selected=torch.as_tensor(rng.random((H, W, data.num_src)) < 0.4,
                                 device=dev))


def _to(v, device):
    """``v`` (a tensor, or a tuple, CostData, window, draws or state of
    them) on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, tgeo.CameraArrays):
        return v.map(lambda a: a.to(device))
    if isinstance(v, (tcost.CostData, PMState)):
        return v.replace(**{f.name: _to(getattr(v, f.name), device)
                            for f in dataclasses.fields(v)
                            if getattr(v, f.name) is not None})
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_to(a, device) for a in v))
    return v


def _case(name, device="cpu") -> Case:
    """One case, made on the CPU (its random draws too) and moved to
    ``device``."""
    c = _cpu_case(name)
    if torch.device(device).type == "cpu":
        return c
    return c._replace(**{k: _to(getattr(c, k), device)
                         for k in ("data", "state", "x", "y", "win",
                                   "draws")})


def _window(name):
    """(radius, increment) of case ``name``'s window."""
    for suffix, window in WINDOWS.items():
        if name.endswith(suffix):
            return window
    return 5, 2


@functools.lru_cache(maxsize=None)
def _cpu_case(name) -> Case:
    device = "cpu"
    scene = _scene()
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    sa = name.startswith("sa") or "-sa" in name
    src = [1] if name.endswith("-s1") else \
        [1 + i % S for i in range(32)] if name.endswith("-s32") else \
        list(range(1, V))
    geom = "geom" in name
    depths = torch.as_tensor(np.stack(scene.depths)[src], device=device)
    mask = torch.as_tensor(_sa_mask(scene.depths[0], 2), device=device) \
        if sa else None
    if "-neg" in name:
        mask = torch.where(mask % 2 == 1, -mask, mask)
    data = tcost.CostData.build(
        cams.view(0), cams.map(lambda a: a[src]), imgs[0], imgs[src],
        src_depths=depths, sampler_u8="u8" in name, sa_mask=mask)
    rng = np.random.default_rng(CARD_CASES.index(name))
    state = _state(data, rng, nan=name.endswith("-nan"))
    color = CARD_CASES.index(name) % 2
    row_bounds = None
    if name.startswith("halo"):
        # rows 0 .. 11 of the image with 4 halo rows: the block's rows 0 .. 3
        # lie above the image
        data, row0, lo, hi = halo_block(data, 0, 12, 4)
        state = block_state(state, row0, data.height)
        row_bounds = (lo, hi)
    xs, ys = cb.color_coords(data.height, data.width, color, device=device)
    x, y = xs.reshape(-1).contiguous(), ys.reshape(-1).contiguous()
    if name.endswith("ragged"):
        x, y = x[:377].contiguous(), y[:377].contiguous()
    elif name.endswith("one-pixel"):
        x, y = x[200:201].contiguous(), y[200:201].contiguous()
    xf, yf = x.float(), y.float()
    radius, increment = _window(name)
    win = k3.window_plain(data, xf, yf, radius, increment, sa)
    pattern = name.split("-sel-")[1] if "-sel-" in name else "random"
    draws = strong_draws(x.numel(), pattern, 7 + CARD_CASES.index(name),
                         device)
    it = int(name.split("-it")[1][0])
    dmin, dmax = _bounds()
    kw = dict(radius=radius, increment=increment, use_sa=sa, iteration=it,
              depth_min=dmin, depth_max=dmax, geom_factor=GF, geom=geom,
              refine_init="-init" in name, row_bounds=row_bounds)
    cfg = tprop.PropCfg(geom_consistency=geom, use_sa=sa,
                        refine_init="-init" in name, strong_radius=radius,
                        strong_increment=increment)
    return Case(data, state, x, y, tcost.contiguous_window(win), draws, kw,
                cfg)


def _plain(c: Case):
    return k3.strong_plain(c.data, c.state, c.x, c.y, c.draws, **c.kw)


def _composition(c: Case):
    f32 = functools.partial(tgeo.f32_scalar, device=c.x.device)
    return strong_composition(
        c.data, c.state, c.cfg, c.kw["iteration"], c.draws, c.x, c.y,
        f32(c.kw["depth_min"]), f32(c.kw["depth_max"]), f32(GF),
        c.kw["row_bounds"])


def _mismatch(got, want):
    """Per-pixel disagreement over the four outputs (the JAX parity tests'
    rule)."""
    planes, costs, sel, vw = (np.asarray(a.cpu()) for a in got)
    wplanes, wcosts, wsel, wvw = (np.asarray(a.cpu()) for a in want)
    bad = (vw != wvw).any(-1) | (sel != wsel).any(-1)
    bad |= ~np.isclose(costs, wcosts, rtol=2e-5, atol=2e-5, equal_nan=True)
    bad |= ~np.isclose(planes, wplanes, rtol=2e-5, atol=2e-5,
                       equal_nan=True).all(-1)
    return bad


# ---------------------------------------------------------------------------
# The plain version on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES + (NEG_CASE,))
def test_plain_matches_the_composition_it_replaces(name):
    c = _case(name)
    got = _plain(c)
    bad = _mismatch(got, _composition(c))
    assert bad.mean() <= MAX_FLIP, f"{bad.sum()} of {bad.size} pixels differ"
    b = c.x.numel()
    assert got.planes.shape == (b, 4) and got.costs.shape == (b,)
    assert got.selected.shape == got.view_weights.shape == (b, S)
    assert got.selected.dtype == torch.bool
    # the case reaches what it is for: views weighted, planes moved
    before = tprop.fetch(c.state.planes, c.x, c.y)
    moved = (got.planes != before).any(-1)
    assert (got.view_weights.sum(-1) == 15).float().mean() > 0.5
    assert 0.1 < moved.float().mean() < 1.0
    if c.kw["row_bounds"] is not None:
        assert c.kw["row_bounds"][0] > 0


def test_row_bounds_keep_candidates_inside_the_image():
    """In the halo block the rows above the image are no candidate's: the
    flags follow ``row_bounds``, not the block's own rows."""
    c = _case("halo-u8-geom-it2")
    lo, hi = c.kw["row_bounds"]
    _, flags, _ = k3.candidate_costs_plain(c.data, c.state, c.x, c.y, c.win,
                                           c.kw["row_bounds"])
    _, flags_all, _ = k3.candidate_costs_plain(c.data, c.state, c.x, c.y,
                                               c.win)
    top = c.y == lo
    assert top.any() and not flags[top, 0].any() and flags_all[top, 0].all()
    # the far region up starts 3 rows up
    assert torch.equal(flags[c.y >= lo + 3], flags_all[c.y >= lo + 3])


def test_invalid_region_rows_are_zero_but_region_0_leaves_2():
    """``float cost_array[8][32] = {2.0f}``: an invalid region's row is 0,
    except [0][0], 2 when region 0 (up, near) is invalid."""
    c = _case("u8-it2")
    _, flags, costs = k3.candidate_costs_plain(c.data, c.state, c.x, c.y,
                                               c.win)
    top, bottom, left = c.y == 0, c.y == H - 1, c.x == 0
    assert top.any() and bottom.any() and left.any()
    assert not flags[top][:, :2].any() and flags[top][:, 2].all()
    assert (costs[top][:, 0, 0] == 2.0).all()
    assert (costs[top][:, 0, 1:] == 0).all() and (costs[top][:, 1] == 0).all()
    assert (costs[bottom][:, 2:4] == 0).all()
    inside = left & (c.y > 0)
    assert (costs[inside][:, 4:6] == 0).all()
    assert (costs[inside][:, 0, 0] != 2.0).any()


def test_zero_cost_invalid_region_blocks_adoption():
    """The last minimum of the weighted candidate costs wins; an invalid
    region's 0 is a minimum, and its region flag then blocks the
    adoption."""
    c = _case("u8-it2")
    b = 3
    cam = c.data.ref_cam
    x = torch.tensor([10.0, 11.0, 12.0])
    y = torch.tensor([5.0, 5.0, 5.0])
    plane = tgeo.make_plane(cam, x, y, torch.full((b,), 3.0),
                            torch.tensor([[0.0, 0.0, -1.0]] * b))
    cand = plane[:, None].expand(b, 8, 4).contiguous()
    final = torch.tensor([[0.5, 0.3, 0.0, 0.0, 0.4, 0.4, 0.6, 0.6],
                          [0.5, 0.3, 0.0, 0.0, 0.4, 0.4, 0.6, 0.6],
                          [0.2, 0.1, 0.3, 0.1, 0.4, 0.4, 0.6, 0.6]])
    flags = torch.ones((b, 8), dtype=torch.bool)
    flags[0, 2:4] = False
    rec = torch.full((b,), 0.9)
    dmin, dmax = (torch.tensor(v) for v in _bounds())
    adopt, _, best_cost = k3.adopt_plain(cam, x, y, cand, flags, final, rec,
                                         torch.ones(b, dtype=torch.bool),
                                         dmin, dmax)
    # pixel 0: region 3's 0 wins and is invalid; pixel 1: the same 0 from a
    # valid region is adopted; pixel 2: of the tied 0.1 the last (3) wins
    assert adopt.tolist() == [False, True, True]
    assert best_cost.tolist() == pytest.approx([0.0, 0.0, 0.1])
    no_views = k3.adopt_plain(cam, x, y, cand, flags, final, rec,
                              torch.zeros(b, dtype=torch.bool), dmin, dmax)
    assert not no_views[0].any()


def test_refinement_takes_the_first_minimum_if_lower():
    b = 4
    planes = torch.arange(b * 5 * 4, dtype=torch.float32).reshape(b, 5, 4)
    cur = torch.full((b, 4), -1.0)
    r_costs = torch.tensor([[0.5, 0.2, 0.2, 0.9, 0.3],
                            [0.5, 0.6, 0.7, 0.8, 0.9],
                            [math.inf] * 5,
                            [0.4, 0.4, 0.4, 0.4, 0.4]])
    cost_cur = torch.tensor([0.3, 0.5, 2.0, 0.4])
    plane, cost = k3.refine_choice(r_costs, planes, cur, cost_cur)
    assert torch.equal(plane[0], planes[0, 1])      # the first of two 0.2
    assert torch.equal(plane[1], cur[1]) and cost[1] == 0.5   # not lower
    assert torch.equal(plane[2], cur[2]) and cost[2] == 2.0   # all inf
    assert torch.equal(plane[3], cur[3]) and cost[3] == 0.4   # a tie


def test_refine_init_commits_only_an_improvement_over_0_1():
    new = torch.tensor([[1.0, 0, 0, 1]] * 3)
    old = torch.tensor([[0.0, 1, 0, 1]] * 3)
    rec = torch.tensor([1.0, 1.0, 1.0])
    cost = torch.tensor([0.95, 0.85, 0.9])
    plane, c = k3.commit_plain(new, cost, old, rec, refine_init=True)
    assert plane.tolist() == [old[0].tolist(), new[1].tolist(),
                              old[2].tolist()]
    assert c.tolist() == pytest.approx([1.0, 0.85, 1.0])
    plane, c = k3.commit_plain(new, cost, old, rec, refine_init=False)
    assert torch.equal(plane, new) and torch.equal(c, cost)


def test_empty_selection_means_no_update():
    """Every plane NaN: each candidate costs COST_MAX against every view,
    so every view has three or more costs above 1.2, no probability mass
    and no vote; the pixel keeps its plane and selection, costs COST_MAX
    and weighs no view."""
    c = _case("u8-geom-it2-nan")
    out = _plain(c)
    assert (out.view_weights == 0).all()
    assert (out.costs == COST_MAX).all()
    assert torch.isnan(out.planes).all()
    assert torch.equal(out.selected, tprop.fetch(c.state.selected, c.x, c.y))


def test_selection_patterns_weight_one_view_or_many():
    """``one``: every sample the same uniform, one view weighted 15;
    ``spread``: stratified samples, more views than at random."""
    counts = {}
    case = _case("u8-geom-it2-sel-one")
    for pattern in SELECTION_PATTERNS:
        c = case._replace(draws=strong_draws(case.x.numel(), pattern, 5,
                                             "cpu"))
        vw = _plain(c).view_weights
        counts[pattern] = float((vw > 0).sum(-1).float().mean())
        if pattern == "one":
            assert ((vw == 15).sum(-1) == 1).float().mean() > 0.9
    assert counts["one"] < counts["random"] < counts["spread"]


def test_ordered_selection_equals_the_selection_it_orders():
    """The ordered selection helpers against ``sampling_probabilities`` and
    ``monte_carlo_view_weights`` on one colour's costs: equal to 1e-6, the
    view weights exactly (torch's CPU sums of 4 and 8 terms round alike
    here)."""
    c = _case("f32-geom-it2")
    _, flags, costs = k3.candidate_costs_plain(c.data, c.state, c.x, c.y,
                                               c.win)
    nb = tprop.fetch(c.state.selected, torch.stack(
        [c.x, c.x, c.x - 1, c.x + 1], -1), torch.stack(
        [c.y - 1, c.y + 1, c.y, c.y], -1))
    valid = flags[:, [0, 2, 4, 6]]
    priors = tsel.ordered_priors(nb, valid)
    torch.testing.assert_close(priors, tsel.view_selection_priors(nb, valid),
                               rtol=0, atol=1e-6)
    probs = tsel.ordered_probabilities(costs, priors,
                                       *tsel.selection_thresholds(2))
    torch.testing.assert_close(
        probs, tsel.sampling_probabilities(costs, priors, 2), rtol=0,
        atol=1e-6)
    got = tsel.ordered_view_weights(c.draws.sel_u, probs)
    want = tsel.monte_carlo_view_weights(c.draws.sel_u, probs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class Weights(NamedTuple):
    vw: torch.Tensor
    wnorm: torch.Tensor


def _weighted_pairs_only(vw, costs):
    """K3's view sum: only the (pixel, view) pairs whose weight is not 0
    (NaN is, -0 is not), each pixel's terms in view order from +0."""
    on = vw != 0
    pix, view = torch.nonzero(on, as_tuple=True)
    rank = (torch.cumsum(on.to(torch.int64), 1) - 1)[pix, view]
    terms = vw[pix, view] * costs[pix, view]
    acc = torch.zeros(vw.shape[0])
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        at = rank == r
        acc = acc.index_put((pix[at],), acc[pix[at]] + terms[at])
    return acc


@pytest.mark.parametrize("pattern", WEIGHT_PATTERNS)
def test_weighted_pairs_in_view_order_equal_plain(pattern):
    """The rule K3's second phase relies on: the current plane's and the
    hypotheses' view sums from the weighted pairs alone, in view order,
    equal the plain version's sums over every view bit for bit (a pair
    whose weight is +-0 adds +-0 to a sum that starts at +0)."""
    c = _case("sa-u8-geom-it1")
    xf, yf = c.x.float(), c.y.float()
    out = _plain(c)
    w = weight_pattern(Weights(out.view_weights, out.view_weights.sum(-1)),
                       pattern)
    cur = tprop.fetch(c.state.planes, c.x, c.y)
    depth = tgeo.depth_from_plane(c.data.ref_cam, cur, xf, yf)
    dmin, dmax = (torch.tensor(v) for v in _bounds())
    planes = torch.cat([cur[:, None], k3.refinement_planes_plain(
        c.draws.raws, c.data.ref_cam, xf, yf, cur, depth, dmin, dmax)], 1)
    for i in range(planes.shape[1]):
        cv = k3.plane_costs_plain(c.data, xf, yf, planes[:, i], c.win, True,
                                  torch.tensor(GF))
        want = k3.weighted_sum(w.vw, cv)
        got = _weighted_pairs_only(w.vw, cv)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"plane {i}: {int((got != want).sum())} sums differ"
    if pattern == "nan":
        assert torch.isnan(want).any()


# ---------------------------------------------------------------------------
# The reference window K3 builds
# ---------------------------------------------------------------------------

WH, WW = 48, 64


@functools.lru_cache(maxsize=None)
def _window_data(u8: bool):
    """A 48x64 view with segment ids whose star windows are cut: the
    near half of the scene is segment 1, a block segment 2, 3% of the
    pixels segment 3, 3% segment -1 and a block -2 (no segment: the
    square), and the segments' edges run through the image."""
    scene = synthetic.make_scene(num_views=2, height=WH, width=WW)
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    imgs = torch.as_tensor(scene.images)
    rng = np.random.default_rng(11)
    m = np.where(scene.depths[0] < scene.depths[0].mean(), 1, 0)
    m[10:30, 20:41] = 2
    m[rng.random(m.shape) < 0.03] = 3
    m[rng.random(m.shape) < 0.03] = -1
    m[32:44, 44:60] = -2
    return tcost.CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]), imgs[0], imgs[1:],
        sampler_u8=u8, sa_mask=torch.as_tensor(m.astype(np.int32)))


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("sa", [False, True], ids=["square", "sa-star"])
def test_window_plain_equals_precompute_ref_window(sa, u8):
    """``window_plain`` (the window K3 builds, its sums in tap order)
    against ``cost.precompute_ref_window`` at every pixel of a 48x64 view,
    each image border included: offsets, values and weights exact; the
    sums exact on u8-rounded images, within 1e-6 relative on f32."""
    data = _window_data(u8)
    xs, ys = tgeo.pixel_grid(WH, WW, "cpu")
    x, y = xs.reshape(-1), ys.reshape(-1)
    got = k3.window_plain(data, x, y, 5, 2, sa)
    want = tcost.precompute_ref_window(data, x, y, 5, 2, use_sa=sa)
    for name in ("tap_dx", "tap_dy", "tap_val"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if sa:
        assert torch.equal(got.tap_w, want.tap_w)
        assert torch.equal(got.wsum, want.wsum)
    else:
        assert got.tap_w is None and got.wsum == want.wsum == 36.0
    for name in ("sum_ref", "sum_rr"):
        g, w = getattr(got, name), getattr(want, name)
        if u8:
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    # the ordered sums are the tap-order sums of the window's own terms
    wv = got.tap_val if got.tap_w is None else got.tap_w * got.tap_val
    acc = torch.zeros(x.shape)
    for t in range(36):
        acc = acc + wv[:, t]
    assert torch.equal(got.sum_ref, acc)
    border = (x == 0) | (y == 0) | (x == WW - 1) | (y == WH - 1)
    assert int(border.sum()) == 2 * (WH + WW) - 4
    if sa:
        ids = data.sa_mask.reshape(-1)
        star = ids > 0
        in_image = ((x[:, None] + got.tap_dx >= 0)
                    & (x[:, None] + got.tap_dx < WW)
                    & (y[:, None] + got.tap_dy >= 0)
                    & (y[:, None] + got.tap_dy < WH))
        skipped = star & (~in_image).any(-1)
        cut = star & ((got.tap_w == 0) & in_image).any(-1)
        # star windows at a border skip taps, and some are cut inside
        assert (skipped & border).any() and cut.any() and (cut & ~border).any()
        assert (got.wsum[~star] == 36).all()
        # a negative id is no segment: the square, as at id 0
        sq = torch.as_tensor(tcost.square_taps(5, 2), dtype=torch.float32)
        neg = ids < 0
        assert neg.sum() > 100
        assert (got.tap_dx[neg] == sq[:, 0]).all()
        assert (got.tap_dy[neg] == sq[:, 1]).all()
        # and an in-image star tap on a negative id leaves the segment: it
        # weighs 0
        tx = (x[:, None] + got.tap_dx).long().clamp(0, WW - 1)
        ty = (y[:, None] + got.tap_dy).long().clamp(0, WH - 1)
        on_neg = star[:, None] & in_image & (data.sa_mask[ty, tx] < 0)
        assert on_neg.sum() > 100 and (got.tap_w[on_neg] == 0).all()


def _star_tables():
    """The star's tap offsets as csrc/window_common.cuh, the window K3 and
    K5 build, encodes them (two bits a tap of kStarIx / kStarIy index
    {1, 3, 5}, a quadrant's signs from its number)."""
    import re
    from pathlib import Path
    src = (Path(k3.__file__).resolve().parents[2] / "csrc"
           / "window_common.cuh").read_text()
    ix, iy = (int(re.search(rf"{n} = (0x[0-9A-Fa-f]+)u;", src)[1], 16)
              for n in ("kStarIx", "kStarIy"))
    taps = []
    for q in range(4):
        sx = -1 if q & 1 else 1
        sy = -1 if q in (1, 2) else 1
        for k in range(9):
            taps.append((sx * (2 * ((ix >> 2 * k) & 3) + 1),
                         sy * (2 * ((iy >> 2 * k) & 3) + 1)))
    return np.asarray(taps, np.int32)


def test_kernel_star_tables_are_cost_star_taps():
    """The star K3 builds on the card is ``cost.star_taps()``, tap for tap
    in truncation order."""
    np.testing.assert_array_equal(_star_tables(), tcost.star_taps())


def test_strong_body_builds_no_window(monkeypatch):
    """``_strong_body`` hands K3 the window's radius, increment and SA flag,
    never a window: ``precompute_ref_window`` is not called."""
    c = _case("sa-u8-geom-it1")

    def refuse(*a, **kw):
        raise AssertionError("precompute_ref_window called")
    monkeypatch.setattr(tcost, "precompute_ref_window", refuse)
    dmin, dmax = _bounds()
    got = tprop._strong_body(c.data, c.state, c.cfg, 1, c.draws, c.x, c.y,
                             dmin, dmax, GF)
    for g, w in zip(got, _plain(c._replace(kw=dict(c.kw, iteration=1,
                                                   row_bounds=None)))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("window, err", [
    (dict(radius=4), ValueError), (dict(radius=5.5), ValueError),
    (dict(increment=0), ValueError)], ids=["sa-25-taps", "radius-5.5",
                                           "increment-0"])
def test_wrapper_rejects_bad_windows(window, err):
    """SA mixes the star only with a 36-tap square; the window's radius and
    increment are integers >= 0 and >= 1."""
    c = _case("sa-u8-geom-it1")
    before = _launches()
    with pytest.raises(err):
        _fused(c, **window)
    assert _launches() == before


# ---------------------------------------------------------------------------
# The wrapper's CPU contract and the sweep's route
# ---------------------------------------------------------------------------

def _launches():
    return (k3.launches, k3.colours, k2.launches, k1.launches)


def _fused(c: Case, **changes):
    args = dict(data=c.data, state=c.state, x=c.x, y=c.y, draws=c.draws)
    kw = dict(c.kw)
    for k, v in changes.items():
        (args if k in args else kw)[k] = v
    return k3.strong_fused(**args, **kw)


def test_cpu_tensors_take_the_plain_version():
    c = _case("sa-u8-geom-it1")
    before = _launches()
    got = _fused(c)
    assert _launches() == before
    for g, w in zip(got, _plain(c)):
        assert torch.equal(g, w)


def _bad(c: Case, what):
    """One argument the wrapper must refuse, and the error it raises."""
    b = c.x.numel()
    st, dr = c.state, c.draws
    raws = dr.raws
    table = {
        "x float32": (dict(x=c.x.float()), TypeError),
        "y (B - 1,)": (dict(y=c.y[1:]), ValueError),
        "costs (H, W, 1)": (dict(state=st.replace(costs=st.costs[..., None])),
                            ValueError),
        "planes float64": (dict(state=st.replace(planes=st.planes.double())),
                           TypeError),
        "selected uint8": (dict(state=st.replace(
            selected=st.selected.to(torch.uint8))), TypeError),
        "selected (H, W, S - 1)": (dict(state=st.replace(
            selected=st.selected[..., 1:])), ValueError),
        "sel_u (B, 14)": (dict(draws=dr._replace(sel_u=dr.sel_u[:, 1:])),
                          ValueError),
        "g float64": (dict(draws=dr._replace(raws=raws._replace(
            g=raws.g.double()))), TypeError),
        "angles (B, 2)": (dict(draws=dr._replace(raws=raws._replace(
            angles=raws.angles[:, 1:]))), ValueError),
        "window float64": (dict(data=c.data.replace(
            ref_image=c.data.ref_image.double())), TypeError),
        "src_depths (H, W)": (dict(data=c.data.replace(
            src_depths=c.data.src_depths[0])), ValueError),
        "u_rand on another device": (dict(draws=dr._replace(
            raws=raws._replace(u_rand=torch.empty(b, device="meta")))),
            ValueError),
    }
    return table[what]


@pytest.mark.parametrize("what", [
    "x float32", "y (B - 1,)", "costs (H, W, 1)", "planes float64",
    "selected uint8", "selected (H, W, S - 1)", "sel_u (B, 14)",
    "g float64", "angles (B, 2)", "window float64", "src_depths (H, W)",
    "u_rand on another device"])
def test_wrapper_rejects_bad_arguments(what):
    c = _case("u8-geom-it0")
    changes, err = _bad(c, what)
    before = _launches()
    with pytest.raises(err):
        _fused(c, **changes)
    assert _launches() == before


def test_wrapper_takes_32_views_and_rejects_33():
    c = _case("u8-geom-it0")
    for n, ok in ((32, True), (33, False)):
        data, idx = cycled_views(c.data, n)
        state = c.state.replace(selected=c.state.selected[..., idx])
        if ok:
            out = _fused(c, data=data, state=state)
            assert out.view_weights.shape == (c.x.numel(), 32)
        else:
            with pytest.raises(ValueError, match="at most 32"):
                _fused(c, data=data, state=state)


def _commit_case(name, device="cpu"):
    """Case ``name`` with a fifth of its pixels WEAK and a tenth invalid
    (inactive: the commit leaves them), and its colour."""
    c = _case(name, device)
    rng = np.random.default_rng(CARD_CASES.index(name) + 50)
    h, w = c.state.costs.shape
    weak = torch.as_tensor(np.where(rng.random((h, w)) < 0.2, 0, 1)
                           .astype(np.int32), device=c.x.device)
    valid = torch.as_tensor(rng.random((h, w)) < 0.9, device=c.x.device)
    return c._replace(state=c.state.replace(weak=weak, valid=valid)), \
        CARD_CASES.index(name) % 2


def _same_maps(got, want):
    """Four maps bit for bit, NaN payloads included."""
    return all(g.shape == w.shape and torch.equal(
        g.view(torch.int32) if g.dtype == torch.float32 else g,
        w.view(torch.int32) if w.dtype == torch.float32 else w)
        for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["u8-geom-it0", "sa-u8-geom-it1",
                                  "u8-geom-init-it2", "halo-u8-geom-it2"])
def test_commit_equals_the_put_composition(name):
    """K3's commit form in its plain version (copies of the maps, the
    outputs written at the active pixels) bitwise equal to the commit it
    replaced (``strong_composition.put_composition``: a fetch, a where and a
    scatter_color a map); the inactive pixels (WEAK, invalid) and the other
    colour keep their values; the wrapper's CPU route gives the same."""
    c, color = _commit_case(name)
    out = _plain(c)
    got = k3.commit_maps_plain(c.state, c.x, c.y, out)
    want = put_composition(c.state, color, out)
    assert _same_maps(got, (want.planes, want.costs, want.selected,
                            want.view_weights))
    old = (c.state.planes, c.state.costs, c.state.selected,
           c.state.view_weights)
    xl, yl = c.x.long(), c.y.long()
    active = (c.state.weak[yl, xl] != 0) & c.state.valid[yl, xl]
    assert 0 < int(active.sum()) < active.numel()
    keep = torch.ones_like(c.state.valid)
    keep[yl[active], xl[active]] = False
    for g, o in zip(got, old):
        assert _same_maps([g[keep]], [o[keep]])
    assert (got.costs[yl[active], xl[active]] != out.costs[active]).sum() \
        == 0
    assert not torch.equal(got.costs, c.state.costs)
    assert _same_maps(_fused(c, commit=True), got)


def test_propagate_strong_makes_one_update_call_a_colour(monkeypatch):
    """propagate_strong calls K3's wrapper once a colour, and never K2."""
    c = _case("sa-u8-geom-it1")
    calls = []
    fused = k3.strong_fused

    def counted(*a, **kw):
        calls.append(a[2].numel())
        return fused(*a, **kw)
    monkeypatch.setattr(k3, "strong_fused", counted)
    monkeypatch.setattr(k2, "ncc_strong_fused",
                        lambda *a, **kw: pytest.fail("K2 called"))
    gen = torch.Generator().manual_seed(0)
    dmin, dmax = _bounds()
    state = c.state
    for color in (0, 1):
        state = tprop.propagate_strong(c.data, state, c.cfg, 1, color, dmin,
                                       dmax, GF, generator=gen)
    assert calls == [H * W // 2] * 2


def test_profile_pass_times_k3_and_restores_it():
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    fused = k3.strong_fused
    with pp.stage_ranges({}):
        assert k3.strong_fused is not fused
    assert k3.strong_fused is fused


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K3 is a CUDA kernel; no CUDA device here")
    return torch.device("cuda")


def _bitwise(got, want):
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return False
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_k3_matches_plain_on_card(cuda_device, name):
    c = _case(name, cuda_device)
    before = _launches()
    got = _fused(c)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1) + before[2:]
    want = _plain(c)
    assert _bitwise(got, want), "outputs differ: " + ", ".join(
        f"{int((g != w).any(-1).sum() if g.ndim > 1 else (g != w).sum())}"
        for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["u8-geom-it0", "sa-u8-geom-it1",
                                  "u8-geom-init-it2", "halo-u8-geom-it2",
                                  "f32-geom-it2"])
def test_k3_commit_matches_plain_on_card(cuda_device, name):
    """K3's commit form on the card (the active pixels' outputs written into
    copies of the maps) bitwise equal to its plain version, one launch, the
    state's maps left as they were."""
    c, _ = _commit_case(name, cuda_device)
    before = _launches()
    old = [m.clone() for m in (c.state.planes, c.state.costs,
                               c.state.selected, c.state.view_weights)]
    got = _fused(c, commit=True)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1) + before[2:]
    want = k3.commit_maps_plain(c.state, c.x, c.y, _plain(c))
    assert _same_maps(got, want)
    assert _same_maps(old, (c.state.planes, c.state.costs, c.state.selected,
                            c.state.view_weights))


@pytest.mark.cuda
def test_propagate_strong_launches_k3_once_a_colour_on_card(cuda_device):
    """On CUDA tensors a colour is one K3 launch and no K2 launch; the
    result equals the same sweep on the CPU to the composition's
    tolerance."""
    c = _case("sa-u8-geom-it1", cuda_device)
    cpu = _case("sa-u8-geom-it1")
    dmin, dmax = _bounds()
    k2.reset_launches()
    before = k3.launches
    outs = []
    for case in (c, cpu):
        state = case.state
        for color in (0, 1):
            draws = strong_draws(H * W // 2, "random", color, "cpu")
            state = tprop.propagate_strong(
                case.data, state, case.cfg, 1, color, dmin, dmax, GF,
                draws=_to(draws, case.x.device))
        outs.append(state)
    torch.cuda.synchronize()
    assert k3.launches == before + 2 and k2.launches == 0
    xs, ys = tgeo.pixel_grid(H, W, "cpu")
    x, y = xs.reshape(-1).int(), ys.reshape(-1).int()
    got, want = ((tprop.fetch(s.planes.cpu(), x, y),
                  tprop.fetch(s.costs.cpu(), x, y),
                  tprop.fetch(s.selected.cpu(), x, y),
                  tprop.fetch(s.view_weights.cpu(), x, y)) for s in outs)
    assert _mismatch(got, want).mean() <= MAX_FLIP


@pytest.mark.cuda
def test_k3_rejects_what_it_does_not_take_on_card(cuda_device):
    c = _case("u8-geom-it0", cuda_device)
    with pytest.raises(ValueError):     # not contiguous
        _fused(c, draws=c.draws._replace(
            sel_u=c.draws.sel_u.T.contiguous().T))
    with pytest.raises(ValueError):     # a CPU tensor among CUDA ones
        _fused(c, x=c.x.cpu())
    with pytest.raises(TypeError):
        _fused(c, state=c.state.replace(planes=c.state.planes.double()))
