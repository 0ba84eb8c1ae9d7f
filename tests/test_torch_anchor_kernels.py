"""K8, K9 and K10, the APD setup's kernels (ops/cuda/anchors.py,
csrc/anchors.cu), and their plain versions in ops/anchors.py.

On the CPU: the plain versions against the JAX package's
``nearest_strong_jfa``, ``gen_anchors`` and ``ransac_fit_planes`` under the
same injected draws, on tests/test_torch_anchors.py's scene at rotate_time
1, 2 and 4 (8, 16 and 32 directions) and on crafted cases
(``testing.anchor_cases``): confidence ties and maps with no strong pixel
for the flooding; collinear, coincident and degenerate anchors, fewer
than 3 anchors and tying RANSAC costs for the fit; a flat depth map
(every anchor weight ties), weak pixels at the probes' border and too few
strong pixels for anchor generation. Discrete outputs match exactly,
anchor slots 1-3 as a set where the RANSAC triangle's members tie up to
ulps (tests/test_torch_anchors.py says why), fits to 1e-6. Also pinned:
the first of equally costly fits wins, the float32 cone comparison, the
refusal of more than 32 directions, and that CPU tensors take the plain
versions and launch nothing.

Also on the CPU: K10's schedule of live sub-passes (flooding over it
equals flooding over every sub-pass, the plain version and the JAX package
at maps where a step equals or nearly equals a side) and its phases; the
fit's selection rule on crafted ties, +inf and NaN costs.

On a card: each kernel against its plain version bit for bit (K10 at
maps inside one tile, past a tile and 600x800, one launch a call; K9 at
7, 33 and 50 iterations and on column slices), and the public functions'
launches and the camera they read once a pass.
The card part imports no JAX, so on a machine with a card and without
the JAX package's imports it runs with ``--noconftest`` (the JAX parity
tests then skip):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_anchor_kernels.py
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.config import STRONG, WEAK
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.ops import anchors as tanc
from apde_mvs_tpu_torch.ops.cuda import anchors as kern
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.testing import anchor_cases as cases

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

H, W = cases.H, cases.W
CAM = cases.camera()
ROTATE_TIMES = (1, 2, 4)


def _tstate(weak, conf, planes, valid, device="cpu"):
    return PMState.create(H, W, 2, valid=torch.as_tensor(valid,
                                                         device=device),
                          device=device).replace(
        planes=torch.as_tensor(planes, device=device),
        weak=torch.as_tensor(weak, device=device),
        confidence=torch.as_tensor(conf, device=device))


def _bits_equal(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _jax():
    """The JAX package's anchor module and what its calls take; skips where
    the JAX package does not import."""
    pytest.importorskip("apde_mvs_tpu.ops.anchors")
    import jax
    import jax.numpy as jnp

    from apde_mvs_tpu.core import geometry as jgeo
    from apde_mvs_tpu.ops import anchors as janc
    from apde_mvs_tpu.ops.state import PMState as JState

    K, R, t, c = cases.camera_arrays(CAM)
    data = SimpleNamespace(ref_cam=jgeo.CameraArrays(
        K=jnp.asarray(K), R=jnp.asarray(R), t=jnp.asarray(t),
        c=jnp.asarray(c)), img_h=H, img_w=W)

    def state(weak, conf, planes, valid):
        return JState.create(H, W, 2, valid=jnp.asarray(valid)).replace(
            planes=jnp.asarray(planes), weak=jnp.asarray(weak),
            confidence=jnp.asarray(conf))
    return SimpleNamespace(jax=jax, jnp=jnp, anc=janc, data=data,
                           state=state)


# ---------------------------------------------------------------------------
# K10's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", cases.JFA_CASES)
def test_jfa_plain_matches_jax(name):
    J = _jax()
    weak, conf, valid = cases.jfa_case(name)
    want = np.asarray(J.anc.nearest_strong_jfa(
        J.jnp.asarray(weak), J.jnp.asarray(conf), J.jnp.asarray(valid)))
    got = tanc.nearest_strong_jfa_plain(torch.as_tensor(weak),
                                        torch.as_tensor(conf),
                                        torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    strong = (weak == STRONG) & valid
    if not strong.any():
        assert (got == -1).all()
    else:
        assert (got[..., 0] >= 0).mean() > 0.5
        sy, sx = np.nonzero(strong)
        np.testing.assert_array_equal(got[sy, sx], np.stack([sx, sy], -1))


def test_jfa_lattice_ties_accept_and_differ_from_one_confidence():
    """On the lattice many weak pixels have several strong pixels equally
    near: every answer is a strong pixel whose confidence the pixel
    accepts (>= its own), and the tie rule makes the answers differ from
    those under one confidence everywhere."""
    weak, conf, valid = cases.jfa_case("ties")
    got = tanc.nearest_strong_jfa_plain(torch.as_tensor(weak),
                                        torch.as_tensor(conf),
                                        torch.as_tensor(valid)).numpy()
    flat = tanc.nearest_strong_jfa_plain(
        torch.as_tensor(weak), torch.full((H, W), 7.0),
        torch.as_tensor(valid)).numpy()
    ys, xs = np.nonzero(got[..., 0] >= 0)
    sx, sy = got[ys, xs, 0], got[ys, xs, 1]
    assert (weak[sy, sx] == STRONG).all()
    assert (conf[sy, sx] >= conf[ys, xs]).all()
    assert (got != flat).any()


def test_jfa_steps_at_600x800():
    steps = tanc.jfa_steps(600, 800)
    assert steps == [1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1, 1]
    assert 8 * len(steps) == 96


def _flood_numpy(weak, conf, valid, schedule):
    """The flooding in numpy over ``schedule``'s sub-passes only: each
    relaxes the whole map against the one the previous sub-pass left
    (neighbours outside the map (-1, -1)), then the strong pixels map to
    themselves."""
    h, w = weak.shape
    ys, xs = np.mgrid[0:h, 0:w]
    strong = (weak == STRONG) & valid
    bx = np.where(strong, xs, -1)
    by = np.where(strong, ys, -1)
    for step, dx, dy in schedule:
        nx, ny = xs + dx * step, ys + dy * step
        inside = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        nxc, nyc = np.clip(nx, 0, w - 1), np.clip(ny, 0, h - 1)
        cx = np.where(inside, bx[nyc, nxc], -1)
        cy = np.where(inside, by[nyc, nxc], -1)
        c_conf = conf[np.maximum(cy, 0), np.maximum(cx, 0)]
        b_conf = conf[np.maximum(by, 0), np.maximum(bx, 0)]
        d_cand = (cx - xs) ** 2 + (cy - ys) ** 2
        d_best = np.where(bx >= 0, (bx - xs) ** 2 + (by - ys) ** 2,
                          np.iinfo(np.int32).max)
        better = (cx >= 0) & (c_conf >= conf) & (
            (d_cand < d_best) | ((d_cand == d_best) & (c_conf > b_conf)))
        bx = np.where(better, cx, bx)
        by = np.where(better, cy, by)
    return np.stack([np.where(strong, xs, bx), np.where(strong, ys, by)],
                    -1).astype(np.int32)


# map shapes where a step equals or nearly equals a side: the sub-passes
# of every step that reaches past a side are dead
SCHEDULE_SHAPES = ((64, 80), (1, 80), (64, 1), (64, 64), (65, 129))


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=[f"{h}x{w}" for h, w in SCHEDULE_SHAPES])
@pytest.mark.parametrize("name", cases.JFA_CASES)
def test_jfa_schedule_floods_as_every_sub_pass(name, shape):
    """K10 runs only ``jfa_schedule``'s live sub-passes: flooding over
    them equals the plain version (every sub-pass) and the JAX package bit
    for bit."""
    J = _jax()
    h, w = shape
    weak, conf, valid = cases.jfa_case(name, h=h, w=w)
    schedule = tanc.jfa_schedule(h, w)
    every = [(s, dx, dy) for s in tanc.jfa_steps(h, w)
             for dx, dy in tanc.JFA_NEIGHBOURS]
    assert len(schedule) < len(every)
    got = _flood_numpy(weak, conf, valid, schedule)
    np.testing.assert_array_equal(got, _flood_numpy(weak, conf, valid,
                                                    every))
    np.testing.assert_array_equal(got, tanc.nearest_strong_jfa_plain(
        torch.as_tensor(weak), torch.as_tensor(conf),
        torch.as_tensor(valid)).numpy())
    np.testing.assert_array_equal(got, np.asarray(J.anc.nearest_strong_jfa(
        J.jnp.asarray(weak), J.jnp.asarray(conf), J.jnp.asarray(valid))))


def test_jfa_schedule_and_phases_at_600x800():
    """At 600x800 the 8 sub-passes of step 1024 are dead (88 live of 96);
    at the tests' 64x80 those of step 128 and 6 of step 64's. K10 runs
    the steps 512..32 as one phase folded by 32 (the folded map, 25 x 19,
    fits a tile whole), each step from 16 to 2 alone, folded by itself,
    and the two steps of 1 together at fold 1, all in one cooperative
    launch a call."""
    schedule = tanc.jfa_schedule(600, 800)
    assert len(schedule) == 88 and schedule[0][0] == 512
    assert len(tanc.jfa_steps(H, W)) == 9
    assert len(tanc.jfa_schedule(H, W)) == 8 * 9 - 8 - 6
    assert tanc.jfa_schedule(1, 1) == ()
    phases = kern.jfa_phases(schedule, 600, 800)
    assert phases == [(32, 0, 40), (16, 40, 8), (8, 48, 8), (4, 56, 8),
                      (2, 64, 8), (1, 72, 16)]
    # a map that fits a tile folded by 2: one phase but the tail
    assert kern.jfa_phases(tanc.jfa_schedule(H, W), H, W) == [
        (2, 0, 42), (1, 42, 16)]
    assert kern.jfa_phases((), 1, 1) == [(1, 0, 0)]
    for shape in ((600, 800), (H, W), (1, 80), (65, 129)):
        sch = tanc.jfa_schedule(*shape)
        ph = kern.jfa_phases(sch, *shape)
        assert sum(c for _, _, c in ph) == len(sch)
        assert ph[0][1] == 0 and all(
            f0 + c0 == f1 for (_, f0, c0), (_, f1, _) in zip(ph, ph[1:]))
        assert all(sch[i][0] % fold == 0 for fold, first, count in ph
                   for i in range(first, first + count))
        # the short-range tail: the steps of 1 at fold 1, whose reach (3
        # each way) fits a tile with its halo
        assert ph[-1][0] == 1 and all(
            sch[i][0] == 1 for i in range(ph[-1][1], len(sch)))


def _gen_both(J, weak, conf, depth, valid, wx, wy, rt, raws, ns=None):
    """(plain AnchorResult, JAX AnchorResult, the nearest-strong map)."""
    planes = cases.depth_planes(depth)
    js = J.state(weak, conf, planes, valid)
    jns = J.anc.nearest_strong_jfa(js.weak, js.confidence, js.valid) \
        if ns is None else J.jnp.asarray(ns)
    jres = J.anc.gen_anchors(
        J.jax.random.PRNGKey(0), J.data, js, J.jnp.asarray(wx),
        J.jnp.asarray(wy), J.jnp.ones((len(wx),), bool), rotate_time=rt,
        ransac_threshold=J.jnp.float32(cases.THRESH),
        depth_min=J.jnp.float32(cases.DEPTH_MIN),
        depth_max=J.jnp.float32(cases.DEPTH_MAX), nearest_strong=jns,
        raws=J.anc.AnchorRaws(**{k: J.jnp.asarray(v)
                                 for k, v in raws.items()}))
    ts = _tstate(weak, conf, planes, valid)
    tns = torch.as_tensor(np.asarray(jns))
    tres = tanc.gen_anchors(
        cases.data(), ts, convert.ints(wx, "cpu"), convert.ints(wy, "cpu"), rt,
        cases.THRESH, cases.DEPTH_MIN, cases.DEPTH_MAX, tns,
        raws=convert.anchor_raws(**raws, device="cpu"), chunk=53)
    return tres, jres, tns


def _assert_anchors_match(tres, jres, triangle_as_set=True):
    for name in ("reliable", "hit_count"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    ta = tres.anchors.numpy()
    ja = np.asarray(jres.anchors)
    if not triangle_as_set:
        np.testing.assert_array_equal(ta, ja)
        return
    np.testing.assert_array_equal(ta[:, 0], ja[:, 0])
    for i in range(len(ta)):
        assert {tuple(a) for a in ta[i, 1:4]} == {tuple(a)
                                                  for a in ja[i, 1:4]}, i
    np.testing.assert_array_equal(ta[:, 4:], ja[:, 4:])


@pytest.mark.parametrize("rt", ROTATE_TIMES)
def test_gen_anchors_plain_matches_jax(rt):
    """The scene of tests/test_torch_anchors.py at 8, 16 and 32
    directions, chunked (53 pixels) on the port's side."""
    J = _jax()
    weak, conf, depth, valid = cases.scene()
    wy, wx = np.nonzero(weak == WEAK)
    raws = cases.draws(np.random.default_rng(7 + rt), len(wx), rt)
    tres, jres, _ = _gen_both(J, weak, conf, depth, valid, wx, wy, rt, raws)
    _assert_anchors_match(tres, jres)
    rel = tres.reliable.numpy()
    assert 0 < rel.sum() < len(rel)
    assert tres.hit_count.numpy().max() <= 8 * rt


def _long_walks(seed: int = 0) -> tuple:
    """The scene with a weak block most of the map wide, every fifth of its
    pixels listed: probes walk several radii before a strong pixel takes
    them."""
    weak, conf, depth, valid = cases.scene(seed)
    weak[8:56, 8:68] = WEAK
    wy, wx = np.nonzero(weak == WEAK)
    return weak, conf, depth, valid, wx[::5], wy[::5]


@pytest.mark.parametrize("rt", (2, 4))
def test_gen_anchors_plain_matches_jax_on_long_walks(rt):
    """Walks over many radii (K8 tests 32 / D radii a step, a direction's
    lanes each taking every (32 / D)-th radius) and pixels with 6 hits or
    more (K8's RANSAC runs a lane an iteration over the compacted hits),
    at 16 and 32 directions."""
    J = _jax()
    weak, conf, depth, valid, wx, wy = _long_walks()
    raws = cases.draws(np.random.default_rng(13 + rt), len(wx), rt)
    tres, jres, tns = _gen_both(J, weak, conf, depth, valid, wx, wy, rt,
                                raws)
    _assert_anchors_match(tres, jres)
    in_image, ok, _, _, _ = tanc.probe_table(
        H, W, tns, convert.ints(wx, "cpu"), convert.ints(wy, "cpu"), rt,
        convert.anchor_raws(**raws, device="cpu"))
    ok = ok.reshape(len(wx), 8 * rt, -1)
    first = ok.to(torch.uint8).argmax(-1).float()
    # a radius holds 4 probes: the first accepted lies 3 radii out or more
    # for a quarter of the found directions
    assert float((first[ok.any(-1)] >= 12).float().mean()) > 0.25
    hits = tres.hit_count.numpy()
    assert (hits >= 6).mean() > 0.5 and tres.reliable.numpy().any()


@pytest.mark.parametrize("name", cases.GEN_CASES)
def test_gen_anchors_crafted_match_jax(name):
    """Crafted cases at 16 directions. On the flat depth map every hit lies
    on the support plane (distance 0), so the anchor weights tie exactly
    (-1 for the triangle, 0 for the rest) and a stable sort's order, the
    lower direction first, decides every slot: compared in order."""
    J = _jax()
    c = cases.gen_case(name)
    rt = 2
    raws = cases.draws(np.random.default_rng(11), len(c.wx), rt)
    tres, jres, _ = _gen_both(J, c.weak, c.confidence, c.depth, c.valid,
                              c.wx, c.wy, rt, raws, ns=c.nearest_strong)
    _assert_anchors_match(tres, jres, triangle_as_set=name != "flat")
    rel = tres.reliable.numpy()
    hits = tres.hit_count.numpy()
    if name == "flat":
        assert rel.mean() > 0.5
    elif name == "no_strong":
        assert (hits == 0).all() and not rel.any()
        assert (tres.anchors.numpy()[:, 1:] == -1).all()
    elif name == "sparse":
        assert (hits <= 3).all() and hits.max() > 0 and not rel.any()
    elif name == "border":
        m = tanc.MIN_MARGIN
        on_edge = (c.wx < m) | (c.wy < m) | (c.wx >= W - m) | (c.wy >= H - m)
        assert on_edge.sum() >= 4
        a = tres.anchors.numpy()[rel, 1:]
        have = a[..., 0] >= 0
        assert have.any()
        assert (c.weak[a[have][:, 1], a[have][:, 0]] == STRONG).all()


def test_gen_anchors_refuses_more_than_32_directions():
    weak, conf, depth, valid = cases.scene()
    ts = _tstate(weak, conf, cases.depth_planes(depth), valid)
    wy, wx = np.nonzero(weak == WEAK)
    ns = tanc.nearest_strong_jfa(ts.weak, ts.confidence, ts.valid)
    with pytest.raises(ValueError, match="at most 32"):
        tanc.gen_anchors(cases.data(), ts, convert.ints(wx, "cpu"),
                         convert.ints(wy, "cpu"), 8, cases.THRESH,
                         cases.DEPTH_MIN, cases.DEPTH_MAX, ns,
                         generator=torch.Generator().manual_seed(0))


def test_cone_comparison_is_float32():
    """The cone test compares a float32 tensor with the Python float
    cos(angle): torch rounds the scalar to float32 first. K8 takes the
    float32 value; the two agree at the float32 neighbours of each cone's
    cosine."""
    for rt in ROTATE_TIMES:
        c = tanc._cone_cos(rt)
        c32 = np.float32(c)
        vals = torch.as_tensor(np.array([np.nextafter(c32, np.float32(0)),
                                         c32, np.nextafter(c32,
                                                           np.float32(2))],
                                        np.float32))
        np.testing.assert_array_equal((vals > c).numpy(),
                                      (vals > torch.tensor(c32)).numpy())


# ---------------------------------------------------------------------------
# K9's plain version
# ---------------------------------------------------------------------------

def _fit_both(J, planes, wx, wy, anchors, tri):
    js = J.state(np.full((H, W), WEAK, np.int32), np.ones((H, W),
                                                          np.float32),
                 planes, np.ones((H, W), bool))
    jfit = np.asarray(J.anc.ransac_fit_planes(
        J.jax.random.PRNGKey(0), J.data, js, J.jnp.asarray(wx),
        J.jnp.asarray(wy), J.jnp.ones((len(wx),), bool),
        J.jnp.asarray(anchors), triplets=J.jnp.asarray(tri)))
    tfit = tanc.ransac_fit_planes_plain(
        cases.data().ref_cam, torch.as_tensor(planes), convert.ints(wx, "cpu"),
        convert.ints(wy, "cpu"), convert.ints(anchors, "cpu"),
        convert.ints(tri, "cpu")).numpy()
    return tfit, jfit


def _assert_fits_match(tfit, jfit):
    has_t = (tfit[:, :3] != 0).any(1)
    np.testing.assert_array_equal(has_t, (jfit[:, :3] != 0).any(1))
    np.testing.assert_allclose(tfit, jfit, rtol=0, atol=1e-6)
    return has_t


@pytest.mark.parametrize("rt", ROTATE_TIMES)
def test_fit_planes_plain_matches_jax(rt):
    """Fits on the anchors of the scene at 8, 16 and 32 directions."""
    J = _jax()
    weak, conf, depth, valid = cases.scene()
    wy, wx = np.nonzero(weak == WEAK)
    raws = cases.draws(np.random.default_rng(7 + rt), len(wx), rt)
    tres, _, _ = _gen_both(J, weak, conf, depth, valid, wx, wy, rt, raws)
    tri = cases.triplets(np.random.default_rng(21 + rt), len(wx))
    tfit, jfit = _fit_both(J, cases.depth_planes(depth), wx, wy,
                           tres.anchors.numpy(), tri)
    has = _assert_fits_match(tfit, jfit)
    assert 0 < has.sum() < len(has)
    np.testing.assert_allclose(np.linalg.norm(tfit[has, :3], axis=1), 1.0,
                               atol=1e-5)


def test_fit_planes_crafted_match_jax():
    """Collinear, coincident, zero- and NaN-plane anchors (degenerate
    planes), 0-2 anchors, anchors past the map and pixels on the border:
    the same fits as the JAX package; only the rings and triangles fit."""
    J = _jax()
    c = cases.fit_crafted()
    tfit, jfit = _fit_both(J, c.planes, c.wx, c.wy, c.anchors, c.triplets)
    has = _assert_fits_match(tfit, jfit)
    kinds = np.array([cases.FIT_KINDS[i % len(cases.FIT_KINDS)]
                      for i in range(len(c.wx))])
    for kind in ("collinear", "coincident", "zero_planes", "nan_planes",
                 "none", "one", "two"):
        assert not has[kinds == kind].any(), kind
        assert (tfit[kinds == kind] == 0).all(), kind
    assert has[kinds == "ring"].all() and has[kinds == "three"].all()


def _tie_kinds(n: int) -> np.ndarray:
    return np.array([cases.TIE_KINDS[i % len(cases.TIE_KINDS)]
                     for i in range(n)])


def test_fit_planes_ties_and_non_finite_costs_match_jax():
    """The selection rule's crafted pixels (``anchor_cases.fit_ties``):
    exact ties, the first usable iteration at either side of a warp's 32
    lanes, costs of +inf and NaN, fewer than 3 anchors: the same fits as
    the JAX package; no fit where every cost is +inf or NaN."""
    J = _jax()
    c = cases.fit_ties()
    tfit, jfit = _fit_both(J, c.planes, c.wx, c.wy, c.anchors, c.triplets)
    has = _assert_fits_match(tfit, jfit)
    kinds = _tie_kinds(len(c.wx))
    for kind in ("inf_anchor", "nan_anchor", "two"):
        assert not has[kinds == kind].any(), kind
        assert (tfit[kinds == kind] == 0).all(), kind
    assert has[kinds == "flat"].all() and has[kinds == "three_late"].all()
    # a fronto-parallel fit: every tied orientation flips to the same
    # plane but for the signs of its zeros
    np.testing.assert_array_equal(np.abs(tfit[kinds == "flat"]),
                                  [[0, 0, 1, 4]] * int((kinds == "flat")
                                                       .sum()))


def test_fit_planes_first_of_equal_costs_wins():
    """Three anchors: every usable iteration redraws the same triangle in
    some vertex order, at cost 0 (no other anchor). The fit is the first
    usable iteration's plane, bit for bit, though later orders give other
    bits."""
    c = cases.fit_crafted()
    kinds = np.array([cases.FIT_KINDS[i % len(cases.FIT_KINDS)]
                      for i in range(len(c.wx))])
    sel = np.nonzero(kinds == "three")[0]
    cam = cases.data().ref_cam
    args = (cam, torch.as_tensor(c.planes), convert.ints(c.wx[sel], "cpu"),
            convert.ints(c.wy[sel], "cpu"),
            convert.ints(c.anchors[sel], "cpu"))
    full = tanc.ransac_fit_planes_plain(
        *args, convert.ints(c.triplets[:, sel], "cpu")).numpy()
    alone = []
    for k in range(tanc.RANSAC_ITERS):
        tri = np.zeros_like(c.triplets[:, sel])     # (0, 0, 0): unusable
        tri[k] = c.triplets[k, sel]
        alone.append(tanc.ransac_fit_planes_plain(
            *args, convert.ints(tri, "cpu")).numpy())
    alone = np.stack(alone)                          # (50, n, 4)
    usable = (alone[..., :3] != 0).any(-1)
    differs = 0
    for j in range(len(sel)):
        first = np.nonzero(usable[:, j])[0]
        assert len(first) >= 2, j
        np.testing.assert_array_equal(full[j].view(np.int32),
                                      alone[first[0], j].view(np.int32))
        differs += any((alone[k, j] != alone[first[0], j]).any()
                       for k in first[1:])
    assert differs > 0


# ---------------------------------------------------------------------------
# The public functions' CPU contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    """The public functions on CPU tensors return the plain versions'
    results and launch no kernel; the kernel wrappers refuse CPU tensors
    (there is no fallback)."""
    kern.reset_launches()
    weak, conf, depth, valid = cases.scene()
    planes = cases.depth_planes(depth)
    ts = _tstate(weak, conf, planes, valid)
    ns = tanc.nearest_strong_jfa(ts.weak, ts.confidence, ts.valid)
    assert torch.equal(ns, tanc.nearest_strong_jfa_plain(
        ts.weak, ts.confidence, ts.valid))
    wy, wx = np.nonzero(weak == WEAK)
    twx, twy = convert.ints(wx, "cpu"), convert.ints(wy, "cpu")
    raws = convert.anchor_raws(**cases.draws(np.random.default_rng(1),
                                             len(wx), 2), device="cpu")
    res = tanc.gen_anchors(cases.data(), ts, twx, twy, 2, cases.THRESH,
                           cases.DEPTH_MIN, cases.DEPTH_MAX, ns, raws=raws)
    plain = tanc.gen_anchors_chunk_plain(
        cases.data().ref_cam, H, W, ts.planes[..., 3], ns, twx, twy, 2,
        tgeo.f32_scalar(cases.THRESH, "cpu"),
        tgeo.f32_scalar(cases.DEPTH_MIN, "cpu"),
        tgeo.f32_scalar(cases.DEPTH_MAX, "cpu"), raws)
    for a, b in zip(res, plain):
        assert torch.equal(a, b)
    tri = convert.ints(cases.triplets(np.random.default_rng(2), len(wx)),
                       "cpu")
    fit = tanc.ransac_fit_planes(cases.data(), ts, twx, twy, res.anchors,
                                 triplets=tri)
    assert torch.equal(fit, tanc.ransac_fit_planes_plain(
        cases.data().ref_cam, ts.planes, twx, twy, res.anchors, tri))
    assert (kern.jfa_launches, kern.anchor_launches,
            kern.fit_launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern.nearest_strong(ts.weak, ts.confidence, ts.valid,
                            tanc.jfa_schedule(H, W))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern.fit_planes(ts.planes, twx, twy, res.anchors, tri,
                        kern.camera(cases.data().ref_cam))
    assert (kern.jfa_launches, kern.anchor_launches,
            kern.fit_launches) == (0, 0, 0)


def test_host_camera_is_none_on_cpu():
    """A pass reads the reference camera to the host once for K8 and K9;
    on the CPU there is nothing to read: the plain versions take the
    camera's tensors, and the pass hands them None."""
    assert tanc.host_camera(cases.data().ref_cam) is None


def test_profile_pass_times_the_anchor_kernels_and_restores_them():
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    fns = (kern.nearest_strong, kern.gen_anchors, kern.fit_planes)
    with pp.stage_ranges({}):
        assert all(getattr(kern, f.__name__) is not f for f in fns)
    assert all(getattr(kern, f.__name__) is f for f in fns)


def test_engine_line_reports_the_anchor_kernels(capsys):
    """The engine's last line carries K10's, K8's and K9's launches, as
    chip_smoke.py parses them from a subprocess's log."""
    from apde_mvs_tpu_torch.pipeline import driver
    kern.reset_launches()
    kern.jfa_launches, kern.anchor_launches, kern.fit_launches = 96, 2, 3
    try:
        driver.print_launches("")
    finally:
        kern.reset_launches()
    assert capsys.readouterr().out.endswith(
        "anchor kernel launches: K10 96, K8 2, K9 3\n")


def test_chip_smoke_parses_the_engine_line(capsys):
    """chip_smoke.py reads a subprocess engine's launches, the anchor
    kernels' and the weak sweep's K7 among them, from this line."""
    import chip_smoke
    from apde_mvs_tpu_torch.ops.cuda import weak_sweep
    from apde_mvs_tpu_torch.pipeline import driver
    kern.reset_launches()
    weak_sweep.reset_launches()
    kern.jfa_launches, kern.anchor_launches, kern.fit_launches = 192, 9, 6
    weak_sweep.launches, weak_sweep.chunks = 7, 7
    try:
        driver.print_launches(", rank 1 of 2")
    finally:
        kern.reset_launches()
        weak_sweep.reset_launches()
    (m,) = chip_smoke.LAUNCH_RE.findall(capsys.readouterr().out)
    c = chip_smoke.parsed_counts(m)
    assert (c["k10"], c["k8"], c["k9"]) == (192, 9, 6)
    assert (c["k7"], c["k7_chunks"]) == (7, 7)
    # a weak path: one K7 launch a chunk, K6 one plane a launch
    assert chip_smoke.k6_chunks(dict(c, k6=3, k6_planes=3)) == (7, 3)
    assert chip_smoke.k6_chunks(dict(c, k6=2, k6_planes=30)) is None


def _check_sharded_setup(device) -> tuple:
    """The APD setup through `full_pass._anchors` / `_fit_planes` (the
    tile route's), serial and as rank 0 of 2 (its gather keeps its own
    part): rank 0's part equals its slice of the serial results, bit for
    bit. Returns each route's (K8, K9) launches."""
    from apde_mvs_tpu_torch.parallel.tile_pass import RowShard
    from apde_mvs_tpu_torch.pipeline import full_pass

    class RankPart(RowShard):
        def gather(self, t, counts):
            return t

    weak, conf, depth, valid = cases.scene()
    ts = _tstate(weak, conf, cases.depth_planes(depth), valid, device)
    data = cases.data(device)
    data.device = torch.device(device)
    wy, wx = np.nonzero(weak == WEAK)
    twx, twy = convert.ints(wx, device), convert.ints(wy, device)
    params = SimpleNamespace(rotate_time=2, ransac_threshold=cases.THRESH)
    ns = tanc.nearest_strong_jfa(ts.weak, ts.confidence, ts.valid)
    shard = RankPart(0, 2)
    launches = []
    sweep = None
    for route in (None, shard):
        kern.reset_launches()
        gen = torch.Generator(device=device).manual_seed(5)
        res = full_pass._anchors(data, ts, twx, twy, params,
                                 cases.DEPTH_MIN, cases.DEPTH_MAX, ns, gen,
                                 route)
        if route is None:
            keep = torch.nonzero(res.reliable, as_tuple=True)[0]
            sweep = (twx[keep], twy[keep], res.anchors[keep])
            serial = res
        fit = full_pass._fit_planes(data, ts, sweep, gen, route)
        if route is None:
            serial_fit = fit
        launches.append((kern.anchor_launches, kern.fit_launches))
    kern.reset_launches()
    sl, _ = shard.list_part(twx.numel())
    for a, b in zip(res, serial):
        assert _bits_equal(a, b[sl])
    sl, _ = shard.list_part(sweep[0].numel())
    assert _bits_equal(fit, serial_fit[sl])
    assert (serial_fit[:, :3] != 0).any()
    return tuple(launches)


def test_sharded_setup_takes_the_plain_versions_on_cpu():
    """On CPU tensors the sharded anchors and fit give rank 0's part of
    the serial results and launch nothing."""
    assert _check_sharded_setup("cpu") == ((0, 0), (0, 0))


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K8, K9 and K10 are CUDA kernels; no CUDA device here")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", cases.JFA_CASES)
def test_k10_matches_plain_on_card(cuda_device, name):
    """One launch a call (a cooperative launch over every phase)."""
    weak, conf, valid = (torch.as_tensor(a, device=cuda_device)
                         for a in cases.jfa_case(name))
    before = kern.jfa_launches
    got = tanc.nearest_strong_jfa(weak, conf, valid)
    torch.cuda.synchronize()
    assert kern.jfa_launches == before + 1
    assert tanc.host_camera(cases.data(cuda_device).ref_cam) == kern.camera(
        cases.data().ref_cam)
    assert _bits_equal(got, tanc.nearest_strong_jfa_plain(weak, conf,
                                                          valid))


# a map inside one tile, one that is no multiple of the tiles (a side past
# a tile's 128 columns) and the APD scan's
CARD_SHAPES = ((20, 30), (97, 201), (600, 800))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES + SCHEDULE_SHAPES[1:],
                         ids=[f"{h}x{w}" for h, w in
                              CARD_SHAPES + SCHEDULE_SHAPES[1:]])
@pytest.mark.parametrize("name", cases.JFA_CASES)
def test_k10_shapes_match_plain_on_card(cuda_device, name, shape):
    h, w = shape
    weak, conf, valid = (torch.as_tensor(a, device=cuda_device)
                         for a in cases.jfa_case(name, h=h, w=w))
    got = tanc.nearest_strong_jfa(weak, conf, valid)
    assert _bits_equal(got, tanc.nearest_strong_jfa_plain(weak, conf,
                                                          valid))


def _card_gen(dev, weak, conf, depth, valid, wx, wy, rt, raws, ns=None):
    ts = _tstate(weak, conf, cases.depth_planes(depth), valid, dev)
    if ns is None:
        ns = tanc.nearest_strong_jfa_plain(ts.weak, ts.confidence, ts.valid)
    else:
        ns = torch.as_tensor(ns, device=dev)
    twx, twy = convert.ints(wx, dev), convert.ints(wy, dev)
    tr = convert.anchor_raws(**raws, device=dev)
    before = kern.anchor_launches
    got = tanc.gen_anchors(cases.data(dev), ts, twx, twy, rt, cases.THRESH,
                           cases.DEPTH_MIN, cases.DEPTH_MAX, ns, raws=tr,
                           chunk=53)
    torch.cuda.synchronize()
    assert kern.anchor_launches == before + math.ceil(len(wx) / 53)
    want = tanc.gen_anchors_chunk_plain(
        cases.data(dev).ref_cam, H, W, ts.planes[..., 3], ns, twx, twy, rt,
        tgeo.f32_scalar(cases.THRESH, dev),
        tgeo.f32_scalar(cases.DEPTH_MIN, dev),
        tgeo.f32_scalar(cases.DEPTH_MAX, dev), tr)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("rt", ROTATE_TIMES)
def test_k8_matches_plain_on_card(cuda_device, rt):
    weak, conf, depth, valid = cases.scene()
    wy, wx = np.nonzero(weak == WEAK)
    raws = cases.draws(np.random.default_rng(7 + rt), len(wx), rt)
    got, want = _card_gen(cuda_device, weak, conf, depth, valid, wx, wy, rt,
                          raws)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rt", (2, 4))
def test_k8_long_walks_match_plain_on_card(cuda_device, rt):
    weak, conf, depth, valid, wx, wy = _long_walks()
    raws = cases.draws(np.random.default_rng(13 + rt), len(wx), rt)
    got, want = _card_gen(cuda_device, weak, conf, depth, valid, wx, wy, rt,
                          raws)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["unaligned", "jitter 2"])
def test_k8_refuses_draws_it_cannot_read_as_vectors(cuda_device, how):
    """K8 reads a radius's 4 jitter draws as one 16-byte vector: draws 4
    bytes past a 16-byte boundary, or 2 draws a radius, fail the call and
    count no launch."""
    dev = cuda_device
    weak, conf, depth, valid = cases.scene()
    wy, wx = np.nonzero(weak == WEAK)
    rt = 2
    raws = cases.draws(np.random.default_rng(9), len(wx), rt)
    ts = _tstate(weak, conf, cases.depth_planes(depth), valid, dev)
    ns = tanc.nearest_strong_jfa_plain(ts.weak, ts.confidence, ts.valid)
    tr = convert.anchor_raws(**raws, device=dev)
    jitter = tanc.JITTER_SAMPLES
    if how == "unaligned":
        sx, sy = (r.new_empty(r.numel() + 1)[1:].view(r.shape).copy_(r)
                  for r in (tr.shift_x, tr.shift_y))
        assert sx.data_ptr() % 16 and sy.data_ptr() % 16
    else:
        jitter = 2
        sx, sy = (r.reshape(len(wx), -1, 4)[..., :2].reshape(len(wx), -1)
                  .contiguous() for r in (tr.shift_x, tr.shift_y))
    dirs, radii = tanc._kernel_tables(rt, str(dev))
    before = kern.anchor_launches
    with pytest.raises(RuntimeError, match="apde_gen_anchors"):
        kern.gen_anchors(ns, ts.planes.contiguous(), H, W,
                         convert.ints(wx, dev), convert.ints(wy, dev), sx, sy,
                         tr.triplets, dirs, radii, jitter,
                         kern.camera(cases.data(dev).ref_cam), 0.5, 1.0, 1.0,
                         tanc.MIN_MARGIN)
    torch.cuda.synchronize()
    assert kern.anchor_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", cases.GEN_CASES)
def test_k8_crafted_match_plain_on_card(cuda_device, name):
    c = cases.gen_case(name)
    raws = cases.draws(np.random.default_rng(11), len(c.wx), 2)
    got, want = _card_gen(cuda_device, c.weak, c.confidence, c.depth,
                          c.valid, c.wx, c.wy, 2, raws, ns=c.nearest_strong)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["crafted", "ties", "scene"])
def test_k9_matches_plain_on_card(cuda_device, what):
    dev = cuda_device
    if what in ("crafted", "ties"):
        c = cases.fit_crafted() if what == "crafted" else cases.fit_ties()
        planes, wx, wy, anchors, tri = c
    else:
        weak, conf, depth, valid = cases.scene()
        wy, wx = np.nonzero(weak == WEAK)
        raws = cases.draws(np.random.default_rng(9), len(wx), 2)
        anchors = _card_gen(dev, weak, conf, depth, valid, wx, wy, 2,
                            raws)[1].anchors.cpu().numpy()
        planes = cases.depth_planes(depth)
        tri = cases.triplets(np.random.default_rng(10), len(wx))
    ts = _tstate(np.full((H, W), WEAK, np.int32), np.ones((H, W),
                                                          np.float32),
                 planes, np.ones((H, W), bool), dev)
    args = (convert.ints(wx, dev), convert.ints(wy, dev),
            convert.ints(anchors, dev))
    tri = convert.ints(tri, dev)
    before = kern.fit_launches
    got = tanc.ransac_fit_planes(cases.data(dev), ts, *args, triplets=tri)
    torch.cuda.synchronize()
    assert kern.fit_launches == before + 1
    want = tanc.ransac_fit_planes_plain(cases.data(dev).ref_cam, ts.planes,
                                        *args, tri)
    assert _bits_equal(got, want)
    # a column slice of longer draws, as the sharded fit takes it
    wide = convert.ints(cases.triplets(np.random.default_rng(12),
                                       2 * len(wx) + 3), dev)
    part = wide[:, 3:3 + len(wx)]
    assert _bits_equal(
        tanc.ransac_fit_planes(cases.data(dev), ts, *args, triplets=part),
        tanc.ransac_fit_planes_plain(cases.data(dev).ref_cam, ts.planes, *args,
                                     part))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [7, 33, 50])
def test_k9_iterations_match_plain_on_card(cuda_device, iters):
    """K9 takes its iterations from the draws: ``iters`` rows equal the
    plain version's 50 with the rows past ``iters`` unusable (0, 0, 0);
    on the crafted and the selection's pixels, also on a column slice of
    longer draws."""
    dev = cuda_device
    for c in (cases.fit_crafted(), cases.fit_ties()):
        ts = _tstate(np.full((H, W), WEAK, np.int32),
                     np.ones((H, W), np.float32), c.planes,
                     np.ones((H, W), bool), dev)
        args = (convert.ints(c.wx, dev), convert.ints(c.wy, dev),
                convert.ints(c.anchors, dev))
        n = len(c.wx)
        wide = np.concatenate([c.triplets, c.triplets[::-1]], 1)[:, :n + 5]
        for tri in (c.triplets, wide[:, 5:]):
            padded = tri.copy()
            padded[iters:] = 0
            before = kern.fit_launches
            got = tanc.ransac_fit_planes(cases.data(dev), ts, *args,
                                         triplets=convert.ints(
                                             tri, dev)[:iters])
            torch.cuda.synchronize()
            assert kern.fit_launches == before + 1
            want = tanc.ransac_fit_planes_plain(
                cases.data(dev).ref_cam, ts.planes, *args,
                convert.ints(padded, dev))
            assert _bits_equal(got, want)
        part = convert.ints(wide, dev)[:iters, 5:]
        assert part.stride(0) == wide.shape[1] * 3
        assert _bits_equal(
            tanc.ransac_fit_planes(cases.data(dev), ts, *args, triplets=part),
            tanc.ransac_fit_planes_plain(cases.data(dev).ref_cam, ts.planes,
                                         *args, convert.ints(np.concatenate(
                                             [wide[:iters, 5:], np.zeros(
                                                 (50 - iters, n, 3),
                                                 np.int32)]), dev)))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take_on_card(cuda_device):
    dev = cuda_device
    weak, conf, depth, valid = cases.scene()
    ts = _tstate(weak, conf, cases.depth_planes(depth), valid, dev)
    with pytest.raises(TypeError):
        kern.nearest_strong(ts.weak.long(), ts.confidence, ts.valid,
                            tanc.jfa_schedule(H, W))
    # K10 packs coordinates as int16
    wide = torch.zeros((1, kern.MAX_SIDE + 1), dtype=torch.int32, device=dev)
    before = kern.jfa_launches
    with pytest.raises(ValueError, match="int16"):
        kern.nearest_strong(wide, wide.float(), wide.bool(),
                            tanc.jfa_schedule(*wide.shape))
    assert kern.jfa_launches == before
    ns = tanc.nearest_strong_jfa(ts.weak, ts.confidence, ts.valid)
    wx = convert.ints([10, 11], dev)
    raws = convert.anchor_raws(**cases.draws(np.random.default_rng(0), 2, 2),
                               device=dev)
    dirs = torch.zeros((40, 2), device=dev)
    with pytest.raises(ValueError, match="32"):
        kern.gen_anchors(ns, ts.planes, H, W, wx, wx, raws.shift_x,
                         raws.shift_y, raws.triplets, dirs,
                         torch.ones(19, device=dev), 4,
                         kern.camera(cases.data(dev).ref_cam), 0.9, 0.01, 4.0,
                         tanc.MIN_MARGIN)


@pytest.mark.cuda
def test_sharded_setup_launches_the_kernels_on_card(cuda_device):
    """The tile route's sharded anchors and fit launch K8 once a chunk
    this rank holds a part of (the scene's 208 weak pixels are one
    chunk), and K9 once."""
    assert _check_sharded_setup("cuda") == ((1, 1), (1, 1))
