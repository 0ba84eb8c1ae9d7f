"""K7, the weak sweep's chunk update (ops/cuda/weak_sweep.py,
csrc/weak_sweep.cu): its plain version against the JAX package's
``propagate_weak`` (the ``_weak_setup`` fixture of
tests/test_torch_propagation.py, the JAX sweep's draws injected) and
against the torch-op body it replaced
(``testing.weak_composition.weak_body_composition``: two K6 launches and
~250 torch ops a chunk) on crafted pixels for each branch of the update;
the wrapper's view limit, CPU route and refusals; the profiling tool's
hook; and, on a card, the kernel against its plain version bit for bit.

The tolerance is the JAX parity tests' (tests/test_torch_propagation.py):
view weights and selections exactly, planes and costs to 2e-5, at most
0.5% of the pixels flipped on a float tie (the plain version sums in a
fixed order, the JAX package and the composition with torch's
reductions); at these sizes that is no pixel.

The crafted chunks run on the 24x32 synthetic scene with 4 source views:
8 weak pixels whose planes are the ground truth's with their depths 30%
off, anchors on strong ground-truth pixels, seeded selections and draws,
u8 tables; pixel 0 is crafted for the branch the case names.

The card part imports no JAX, so on a machine with a card and without the
JAX package's imports it runs with ``--noconftest`` (the JAX parity tests
then skip):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_weak_sweep.py
"""

import functools
from typing import NamedTuple

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch.config import STRONG, WEAK
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import propagation as tprop
from apde_mvs_tpu_torch.ops.cuda import weak as k6
from apde_mvs_tpu_torch.ops.cuda import weak_sweep as k7
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.testing.kernel_cases import cycled_views, \
    strong_draws
from apde_mvs_tpu_torch.testing.weak_composition import \
    weak_body_composition, weak_taps

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

H, W, V = 24, 32, 5
S = V - 1
GF = 0.2
MAX_FLIP = 0.005
ATOL = 2e-5
# pixel 0 of each crafted chunk is crafted for its case's branch
PIXELS = ((12, 10), (14, 10), (16, 10), (12, 12), (14, 12), (16, 12),
          (18, 12), (20, 14))
CASES = ("anchor_0_missing", "no_views", "zero_fit", "fit_taken",
         "refine_init_no_commit", "oob_anchor_selected",
         "oob_anchor_unselected", "zero_weight_sum", "other_segment",
         "non_strong_prior")


@functools.lru_cache(maxsize=None)
def _scene():
    return synthetic.make_scene(num_views=V, height=H, width=W)


def _truth(device) -> torch.Tensor:
    """The scene's ground-truth camera-frame planes, (H, W, 4)."""
    scene = _scene()
    xs, ys = tgeo.pixel_grid(H, W, device)
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device=device)
    normal = tgeo.normal_world_to_cam(cams.view(0).R, torch.cat(
        [torch.as_tensor(scene.normals[0], device=device),
         torch.zeros((H, W, 1), device=device)], -1))[..., :3]
    return tgeo.make_plane(cams.view(0), xs, ys, torch.as_tensor(
        scene.depths[0], device=device), normal).contiguous()


class Chunk(NamedTuple):
    data: tcost.CostData
    state: PMState
    x: torch.Tensor           # (B,) int32
    y: torch.Tensor
    anchors: torch.Tensor     # (B, 9, 2) int32
    fit: torch.Tensor         # (B, 4)
    draws: tprop.SweepDraws
    kw: dict                  # weak_update_fused's keywords


def _chunk(case: str = "", device="cpu", seed: int = 0, u8: bool = True,
           sa: bool = False, geom: bool = True, refine_init: bool = False,
           views: int = S, weak_window=(5, 5)) -> Chunk:
    """A crafted chunk (see the module's doc): ``case`` sets pixel 0 up for
    its branch and may turn SA, the pass form or the window."""
    dev = torch.device(device)
    scene = _scene()
    rng = np.random.default_rng(seed)
    truth = _truth(dev)
    x = torch.as_tensor([p[0] for p in PIXELS], dtype=torch.int32,
                        device=dev)
    y = torch.as_tensor([p[1] for p in PIXELS], dtype=torch.int32,
                        device=dev)
    b = len(PIXELS)
    weak = torch.full((H, W), STRONG, dtype=torch.int32, device=dev)
    weak[y.long(), x.long()] = WEAK
    planes = truth.clone()
    # the weak pixels' planes: the truth's with the depth 30% off
    planes[y.long(), x.long(), 3] *= 1.3
    strong_cells = [(i, j) for j in range(H) for i in range(W)
                    if (i, j) not in PIXELS]
    pick = rng.integers(0, len(strong_cells), (b, 8))
    anchors = np.zeros((b, 9, 2), np.int32)
    anchors[:, 0] = PIXELS
    anchors[:, 1:] = np.asarray(strong_cells)[pick]
    anchors[:, 1:][rng.random((b, 8)) < 0.1] = -1
    fit = truth[y.long(), x.long()].clone()
    fit[1::2] = 0.0
    selected = torch.as_tensor(rng.random((H, W, S)) < 0.5, device=dev)
    mask = None
    if case == "anchor_0_missing":
        anchors[0, 1] = -1
    elif case == "no_views":
        anchors[0, 1:] = -1
    elif case == "zero_fit":
        fit[0] = 0.0
    elif case in ("fit_taken", "refine_init_no_commit"):
        # no adoption (every anchor another weak pixel), a fit plane
        anchors[0, 1:] = PIXELS[1:] + PIXELS[1:2]
        fit[0] = truth[y[0].long(), x[0].long()]
        if case == "fit_taken":
            planes[y[0].long(), x[0].long(), 3] *= 1.5 / 1.3
        else:
            planes[y[0].long(), x[0].long()] = truth[y[0].long(),
                                                     x[0].long()]
            geom, refine_init = False, True
    elif case.startswith("oob_anchor"):
        anchors[0, 1] = _border_anchor(device)
        cell = tuple(int(v) for v in anchors[0, 1])
        selected[cell[1], cell[0]] = case == "oob_anchor_selected"
    elif case == "zero_weight_sum":
        # the anchors' window (radius 4, step 3) misses its own cell: an
        # anchor in the pixel's one-cell segment weighs nothing
        sa, weak_window = True, (4, 3)
        mask = np.zeros((H, W), np.int32)
        anchors[0, 1] = (25, 4)
        mask[10, 12] = mask[4, 25] = 1
    elif case == "other_segment":
        sa = True
        mask = np.where(np.arange(W)[None, :] < W // 2, 1, 2).repeat(H, 0)
        anchors[0, 1] = (25, 4)
    elif case == "non_strong_prior":
        anchors[0, 1] = PIXELS[1]
    elif case:
        raise ValueError(case)
    if sa and mask is None:
        mask = np.where(scene.depths[0] < scene.depths[0].mean(), 1,
                        0).astype(np.int32)
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    data = tcost.CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]), imgs[0], imgs[1:],
        src_depths=torch.as_tensor(np.stack(scene.depths[1:]), device=dev),
        sampler_u8=u8,
        sa_mask=None if mask is None else torch.as_tensor(mask, device=dev))
    if views != S:
        data, idx = cycled_views(data, views)
        selected = selected[..., idx]
    state = PMState.create(H, W, views, device=dev).replace(
        planes=planes.contiguous(), weak=weak,
        selected=selected.contiguous())
    draws = tprop.sweep_draws(torch.Generator(device=dev).manual_seed(seed),
                              b, dev)
    kw = dict(strong_radius=5, strong_increment=2,
              weak_radius=weak_window[0], weak_increment=weak_window[1],
              use_sa=sa, iteration=1,
              depth_min=scene.cameras[0].depth_min * 0.6,
              depth_max=scene.cameras[0].depth_max * 1.2, geom_factor=GF,
              geom=geom, refine_init=refine_init)
    return Chunk(data, state, x, y,
                 torch.as_tensor(anchors, device=dev).contiguous(),
                 fit.contiguous(), draws, kw)


@functools.lru_cache(maxsize=None)
def _border_anchor(device) -> tuple:
    """A strong border cell whose warp under pixel 0's plane leaves the
    image in some source views and stays in it in others."""
    base = _chunk(device=device)
    data = base.data
    plane = base.state.planes[base.y.long(), base.x.long()][:1]
    hom = tgeo.homography(data.ref_cam, data.src_views, plane)
    border = [(i, j) for j in (0, H - 1) for i in range(W)] \
        + [(i, j) for j in range(H) for i in (0, W - 1)]
    for cx, cy in border:
        wx, wy = tgeo.warp(hom, torch.tensor([float(cx)], device=device),
                           torch.tensor([float(cy)], device=device))
        oob = (wx < 0) | (wx >= W) | (wy < 0) | (wy >= H)
        if bool(oob.any()) and not bool(oob.all()):
            return cx, cy
    raise AssertionError("no border cell leaves the image in some views")


def _args(c: Chunk) -> tuple:
    return (c.data, c.state, c.x, c.y, c.anchors, c.fit, c.draws)


def _stage(c: Chunk) -> k7.WeakStage:
    return k7.weak_stage_plain(*_args(c), **{
        k: v for k, v in c.kw.items() if k != "refine_init"})


def _composition(c: Chunk):
    cfg = tprop.PropCfg(geom_consistency=c.kw["geom"], use_sa=c.kw["use_sa"],
                        refine_init=c.kw["refine_init"],
                        weak_radius=c.kw["weak_radius"],
                        weak_increment=c.kw["weak_increment"])
    dev = c.x.device
    return weak_body_composition(
        c.data, c.state, cfg, c.kw["iteration"], c.draws, c.x, c.y,
        c.anchors, c.fit, *(tgeo.f32_scalar(c.kw[k], dev) for k in (
            "depth_min", "depth_max", "geom_factor")))


def _mismatch(got, want) -> torch.Tensor:
    """Per-pixel disagreement of two chunk updates' (planes, costs,
    selections, view weights)."""
    planes, costs, sel, vw = got
    bad = (vw != want[3]).any(-1) | (sel != want[2]).any(-1)
    bad |= ~torch.isclose(costs, want[1], rtol=ATOL, atol=ATOL,
                          equal_nan=True)
    bad |= ~torch.isclose(planes, want[0], rtol=ATOL, atol=ATOL,
                          equal_nan=True).all(-1)
    return bad


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32) if a.dtype == torch.float32 \
        else a


def _same(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w))
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["photometric", "geom_refine_init", "sa"])
def test_plain_matches_jax(name):
    """``weak_update_plain`` on the whole weak list of the weak-sweep
    parity fixture against the JAX ``propagate_weak`` under its draws, at
    the pixels still WEAK (the others the sweep leaves alone)."""
    _plain_against_jax(name)


@pytest.mark.parametrize("name", ["photometric", "sa"])
def test_plain_matches_jax_at_ten_views(name, monkeypatch):
    """The same at 10 source views (the fixture's scene with 11 views): a
    pixel's phase-0 pairs pass 64, so K7 runs them in three or more rounds
    of 32, and the anchors count in the NCC (square windows; SA windows
    with several segments, where a pixel in no segment weighs every
    anchor)."""
    pytest.importorskip("apde_mvs_tpu.ops.propagation")
    import test_torch_propagation as tp
    monkeypatch.setattr(tp, "V", 11)
    st = _plain_against_jax(name)
    pairs = (st.flags.sum(-1) + 1 + st.fit_ok.long()) * 10
    assert float((pairs > 64).float().mean()) > 0.5
    assert float(st.wref.anchor_valid.float().mean()) > 0.5
    assert bool((st.wref.wsum > 0).any())


def _plain_against_jax(name):
    """test_plain_matches_jax's comparison; returns the plain version's
    stage."""
    pytest.importorskip("apde_mvs_tpu.ops.propagation")
    import jax
    import jax.numpy as jnp
    import test_torch_propagation as tp

    from apde_mvs_tpu.ops import selection as jsel
    from apde_mvs_tpu.ops.propagation import PropCfg as JPropCfg
    from apde_mvs_tpu.ops.propagation import propagate_weak as j_propagate
    from apde_mvs_tpu.ops.propagation import refinement_raws as j_raws
    from apde_mvs_tpu_torch import convert
    kw_cfg, iteration = tp.WEAK_CONFIGS[name]
    seed = 3
    jd, js, td, ts, dmin, dmax, wx, wy, anchors, fit = tp._weak_setup(
        seed, kw_cfg.get("geom_consistency", False),
        kw_cfg.get("use_sa", False))
    cfg = {"use_sa": False, **kw_cfg}
    n = len(wx)
    key = jax.random.PRNGKey(seed + 50)
    jout = j_propagate(jd, js, JPropCfg(**cfg), iteration, key,
                       jnp.asarray(wx), jnp.asarray(wy), jnp.ones(n, bool),
                       jnp.asarray(anchors), jnp.asarray(fit),
                       jnp.float32(dmin), jnp.float32(dmax),
                       jnp.float32(0.2))
    key, k_sel = jax.random.split(key)
    key, k_ref = jax.random.split(key)
    draws = tprop.SweepDraws(
        torch.tensor(np.asarray(jax.random.uniform(
            k_sel, (n, jsel.NUM_SAMPLES)))),
        tprop.RefineRaws(**{k: torch.tensor(np.asarray(v)) for k, v in
                            j_raws(k_ref, (n,))._asdict().items()}))
    tcfg = tprop.PropCfg(**cfg)
    got = k7.weak_update_plain(
        td, ts, convert.ints(wx, "cpu"), convert.ints(wy, "cpu"),
        convert.ints(anchors, "cpu"), convert.floats(fit, "cpu"), draws,
        strong_radius=tcfg.strong_radius,
        strong_increment=tcfg.strong_increment,
        weak_radius=tcfg.weak_radius, weak_increment=tcfg.weak_increment,
        use_sa=tcfg.use_sa, iteration=iteration, depth_min=dmin,
        depth_max=dmax, geom_factor=0.2, geom=tcfg.geom_consistency,
        refine_init=tcfg.refine_init)
    live = ts.weak.numpy()[wy, wx] == WEAK
    want = tp._outputs(jout, wx, wy)
    have = dict(vw=got.view_weights.numpy(), sel=got.selected.numpy(),
                planes=got.planes.numpy(), costs=got.costs.numpy())
    bad = tp._mismatch({k: v[live] for k, v in have.items()},
                       {k: v[live] for k, v in want.items()})
    assert bad.mean() <= MAX_FLIP, f"{bad.sum()} of {bad.size} pixels differ"
    assert live.sum() > 50
    return k7.weak_stage_plain(
        td, ts, convert.ints(wx, "cpu"), convert.ints(wy, "cpu"),
        convert.ints(anchors, "cpu"), convert.floats(fit, "cpu"), draws,
        strong_radius=tcfg.strong_radius,
        strong_increment=tcfg.strong_increment,
        weak_radius=tcfg.weak_radius, weak_increment=tcfg.weak_increment,
        use_sa=tcfg.use_sa, iteration=iteration, depth_min=dmin,
        depth_max=dmax, geom_factor=0.2, geom=tcfg.geom_consistency)


# ---------------------------------------------------------------------------
# Crafted branches against the composition K7 replaced
# ---------------------------------------------------------------------------

def _branch_reached(case: str, c: Chunk, st: k7.WeakStage, got) -> bool:
    """Whether pixel 0 took the branch its case names."""
    cur = c.state.planes[c.y[0].long(), c.x[0].long()]
    if case == "anchor_0_missing":
        return not bool(st.exists[0, 0]) and bool(st.has_views[0])
    if case == "no_views":
        return not bool(st.has_views[0]) and float(got.costs[0]) \
            == tcost.COST_MAX and bool((got.view_weights[0] == 0).all())
    if case == "zero_fit":
        return not bool(st.fit_ok[0])
    if case == "fit_taken":
        return bool(torch.equal(st.plane_cur[0], c.fit[0]))
    if case == "refine_init_no_commit":
        return bool(st.fit_ok[0]) and torch.equal(got.planes[0], cur) \
            and torch.equal(got.costs[0], st.cost_recomputed[0])
    if case.startswith("oob_anchor"):
        taps = weak_taps(c.data, st.wref._replace(
            **{f: getattr(st.wref, f)[:1] for f in (
                "x", "y", "anchor_x", "anchor_y")}), cur[None],
            tprop.PropCfg())
        sel = bool(st.wref.anchor_sel[0, 0].all())
        return bool(st.wref.anchor_valid[0, 0]) \
            and bool(taps.anchor_oob[:, 0, 0].any()) \
            and sel == (case == "oob_anchor_selected") \
            and bool(st.wref.anchor_sel[0, 0].any()) == sel
    if case == "zero_weight_sum":
        return bool(st.wref.anchor_valid[0, 0]) \
            and float(st.wref.wsum[0, 0]) == 0.0
    if case == "other_segment":
        return bool(st.exists[0, 0]) and not bool(st.wref.anchor_valid[0, 0])
    if case == "non_strong_prior":
        return bool(st.exists[0, 0]) and not bool(st.flags[0, 0]) \
            and bool(st.wref.anchor_valid[0, 0])
    raise ValueError(case)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_composition_on_each_branch(case):
    """The chunk update through the wrapper on CPU tensors (the plain
    version) against ``weak_body_composition`` on a chunk whose pixel 0
    takes the branch ``case`` names (checked on the plain version's stage),
    at the JAX parity tests' tolerance."""
    c = _chunk(case)
    got = k7.weak_update_fused(*_args(c), **c.kw)
    st = _stage(c)
    assert _branch_reached(case, c, st, got), case
    want = _composition(c)
    bad = _mismatch(got, want)
    assert bad.float().mean() <= MAX_FLIP, f"pixels {bad.nonzero()} differ"


def test_a_chunk_reaches_the_adoption_and_the_refinement():
    """The plain version's stage on a crafted chunk: some pixel adopts an
    anchor's plane, some takes its fit plane or a hypothesis, and the
    outputs move some planes."""
    c = _chunk()
    st = _stage(c)
    cur = c.state.planes[c.y.long(), c.x.long()]
    got = k7.weak_update_plain(*_args(c), **c.kw)
    adopted = (st.plane_cur != cur).any(-1)
    assert bool(adopted.any())
    assert bool((got.planes != st.plane_cur).any(-1).any())
    assert bool((got.view_weights > 0).any())


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def _launches() -> tuple:
    return (k7.launches, k7.chunks, k6.launches)


def test_cpu_tensors_take_the_plain_version():
    c = _chunk(sa=True)
    before = _launches()
    got = k7.weak_update_fused(*_args(c), **c.kw)
    assert _launches() == before
    assert _same(got, k7.weak_update_plain(*_args(c), **c.kw))


def test_wrapper_takes_32_views_and_rejects_33():
    for n, ok in ((32, True), (33, False)):
        c = _chunk(views=n)
        if ok:
            got = k7.weak_update_fused(*_args(c), **c.kw)
            assert got.view_weights.shape == (len(PIXELS), 32)
            assert float(got.view_weights.sum(-1).max()) <= 15
        else:
            with pytest.raises(ValueError, match="at most 32"):
                k7.weak_update_fused(*_args(c), **c.kw)


def _bad(c: Chunk, what: str):
    """One argument the wrapper must refuse, and the error it raises."""
    b = len(PIXELS)
    args = dict(zip(("data", "state", "x", "y", "anchors", "fit_planes",
                     "draws"), _args(c)))
    table = {
        "x float32": (dict(x=c.x.float()), TypeError),
        "y (B - 1,)": (dict(y=c.y[1:]), ValueError),
        "anchors (B, 8, 2)": (dict(anchors=c.anchors[:, 1:].contiguous()),
                              ValueError),
        "anchors int64": (dict(anchors=c.anchors.long()), TypeError),
        "fit_planes (B, 3)": (dict(fit_planes=c.fit[:, :3].contiguous()),
                              ValueError),
        "weak int64": (dict(state=c.state.replace(
            weak=c.state.weak.long())), TypeError),
        "selected (H, W, S - 1)": (dict(state=c.state.replace(
            selected=c.state.selected[..., 1:].contiguous())), ValueError),
        "sel_u (B, 14)": (dict(draws=c.draws._replace(
            sel_u=c.draws.sel_u[:, 1:].contiguous())), ValueError),
        "fit_planes on another device": (dict(fit_planes=torch.empty(
            (b, 4), device="meta")), ValueError),
        "weak radius -1": (dict(weak_radius=-1), ValueError),
    }
    changes, err = table[what]
    kw = dict(c.kw)
    for k, v in changes.items():
        (args if k in args else kw)[k] = v
    return args, kw, err


@pytest.mark.parametrize("what", [
    "x float32", "y (B - 1,)", "anchors (B, 8, 2)", "anchors int64",
    "fit_planes (B, 3)", "weak int64", "selected (H, W, S - 1)",
    "sel_u (B, 14)", "fit_planes on another device", "weak radius -1"])
def test_wrapper_rejects_bad_arguments(what):
    args, kw, err = _bad(_chunk(), what)
    before = _launches()
    with pytest.raises(err):
        k7.weak_update_fused(**args, **kw)
    assert _launches() == before


def test_profile_pass_times_k7_and_restores_it():
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    fused = k7.weak_update_fused
    with pp.stage_ranges({}):
        assert k7.weak_update_fused is not fused
    assert k7.weak_update_fused is fused


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

# name: the chunk's keywords on the card (selection draws, where named,
# from ``kernel_cases.strong_draws``)
CARD_CASES = {
    "sa-geom": dict(sa=True),
    "sa-refine_init": dict(sa=True, geom=False, refine_init=True),
    "square-geom": dict(),
    "square-refine_init": dict(geom=False, refine_init=True),
    "f32-sa-geom": dict(u8=False, sa=True),
    "sa-geom-s1": dict(sa=True, views=1),
    "sa-geom-s32": dict(sa=True, views=32),
    "square-geom-taps25": dict(weak_window=(4, 2)),
    "sa-geom-select-one": dict(sa=True),
    "sa-geom-select-spread": dict(sa=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K7 is a CUDA kernel; no CUDA device here")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES) + [f"case-{c}"
                                                    for c in CASES])
def test_k7_matches_plain_on_card(cuda_device, name):
    c = _chunk(name[5:], cuda_device) if name.startswith("case-") \
        else _chunk(device=cuda_device, **CARD_CASES[name])
    if name.startswith("sa-geom-select"):
        c = c._replace(draws=strong_draws(len(PIXELS), name.split("-")[-1],
                                          0, cuda_device))
    before = _launches()
    got = k7.weak_update_fused(*_args(c), **c.kw)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1, before[2])
    want = k7.weak_update_plain(*_args(c), **c.kw)
    assert _same(got, want), "outputs differ: " + ", ".join(
        f"{int((g != w).sum())}" for g, w in zip(got, want))


@pytest.mark.cuda
def test_k7_rejects_what_it_does_not_take_on_card(cuda_device):
    c = _chunk(device=cuda_device)
    with pytest.raises(ValueError):     # not contiguous
        k7.weak_update_fused(c.data, c.state, c.x, c.y,
                             c.anchors.transpose(0, 1).contiguous()
                             .transpose(0, 1), c.fit, c.draws, **c.kw)
    with pytest.raises(ValueError):     # a CPU tensor among CUDA ones
        k7.weak_update_fused(c.data, c.state, c.x, c.y, c.anchors,
                             c.fit.cpu(), c.draws, **c.kw)
    with pytest.raises(TypeError):
        k7.weak_update_fused(c.data, c.state, c.x, c.y, c.anchors,
                             c.fit.double(), c.draws, **c.kw)
