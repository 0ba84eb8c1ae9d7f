"""Parity of the port's sweeps (ops/propagation.py) with the JAX package's
`propagate_strong` / `propagate_weak`, under the same random draws (taken
from the keys the JAX sweep splits, as tests/test_prop_oracle.py does),
and with the NumPy oracles `prop_oracle.run_strong_oracle` /
`run_weak_oracle`; and of the APD initial cost (the weak list re-scored
with the deformable NCC) with the JAX `initial_cost`.

View weights and selections are exact; planes and costs to atol 2e-5. A
pixel whose discrete choice flips on a float tie (the two sides' costs are
summed in another order) may differ; such pixels are counted and must stay
at or below 0.5% of the sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import STRONG, UNKNOWN, WEAK, PatchMatchParams
from apde_mvs_tpu.core import checkerboard as jcb
from apde_mvs_tpu.core import geometry as jgeo
from apde_mvs_tpu.ops import selection as jsel
from apde_mvs_tpu.ops.cost import CostData as JCostData
from apde_mvs_tpu.ops.init import initial_cost as j_initial_cost
from apde_mvs_tpu.ops.init import random_planes as j_random_planes
from apde_mvs_tpu.ops.propagation import PropCfg as JPropCfg
from apde_mvs_tpu.ops.propagation import \
    checkerboard_candidates as j_candidates
from apde_mvs_tpu.ops.propagation import propagate_strong as j_propagate
from apde_mvs_tpu.ops.propagation import propagate_weak as j_propagate_weak
from apde_mvs_tpu.ops.propagation import refinement_raws as j_raws
from apde_mvs_tpu.ops.state import PMState as JState
from apde_mvs_tpu.testing import prop_oracle, synthetic
from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import deformable as tdef
from apde_mvs_tpu_torch.ops import init as tinit
from apde_mvs_tpu_torch.ops import propagation as tprop

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

H, W, V = 24, 32, 5
MAX_FLIP = 0.005

CONFIGS = {
    "photometric": (dict(), 0),
    "geom_impetus": (dict(geom_consistency=True, use_impetus=True), 1),
    "refine_init": (dict(geom_consistency=True, use_impetus=True,
                         refine_init=True), 2),
    "sa": (dict(use_sa=True), 1),
}


def _sa_mask(depth, seed):
    """Seeded segment ids: 1 where the slanted scene is nearer than its
    mean, a random block of 2 across that edge, 0 elsewhere."""
    rng = np.random.default_rng(seed)
    m = np.where(depth < depth.mean(), 1, 0).astype(np.int32)
    y0, x0 = rng.integers(3, H // 2), rng.integers(3, W // 2)
    m[y0:y0 + 8, x0:x0 + 11] = 2
    return m


def _setup(seed, geom, sa=False):
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
    kp, kc, ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    js = JState.create(H, W, jd.num_src).replace(
        planes=j_random_planes(kp, jd, dmin, dmax),
        costs=jax.random.uniform(kc, (H, W), jnp.float32, 0.0, 1.5),
        selected=jax.random.bernoulli(ks, 0.4, (H, W, jd.num_src)))
    td = convert.cost_data(
        ref_cam=tuple(jd.ref_cam), src_cams=tuple(jd.src_cams),
        ref_image=jd.ref_image, src_quads=jd.src_quads,
        src_depths=jd.src_depths, width=W, height=H, sa_mask=mask,
        device="cpu")
    ts = _port_state(js)
    return jd, js, td, ts, dmin, dmax


def _port_state(js):
    return convert.pm_state(**{k: getattr(js, k) for k in (
        "planes", "costs", "selected", "view_weights", "weak", "confidence",
        "valid")}, device="cpu")


def _jax_draws(key, color):
    """The draws propagate_strong takes from `key`, in its split order."""
    xs2, _ = jcb.color_coords(H, W, color)
    n = xs2.size
    key, k_sel = jax.random.split(key)
    key, k_ref = jax.random.split(key)
    sel_u = np.asarray(jax.random.uniform(k_sel, (n, jsel.NUM_SAMPLES)))
    raws = {k: np.asarray(v) for k, v in j_raws(k_ref, (n,))._asdict().items()}
    return sel_u, raws


def _port_draws(sel_u, raws):
    return tprop.SweepDraws(torch.tensor(sel_u), tprop.RefineRaws(
        **{k: torch.tensor(v) for k, v in raws.items()}))


def _run(name, seed=0, color=0, gf=0.2):
    kw, iteration = CONFIGS[name]
    jd, js, td, ts, dmin, dmax = _setup(seed, kw.get("geom_consistency",
                                                     False),
                                        sa=kw.get("use_sa", False))
    key = jax.random.PRNGKey(seed + 100)
    jout = j_propagate(jd, js, JPropCfg(**{"use_sa": False, **kw}),
                       iteration, key,
                       color, jnp.float32(dmin), jnp.float32(dmax),
                       jnp.float32(gf))
    sel_u, raws = _jax_draws(key, color)
    tout = tprop.propagate_strong(td, ts, tprop.PropCfg(**kw), iteration,
                                  color, dmin, dmax, gf,
                                  draws=_port_draws(sel_u, raws))
    xs2, ys2 = jcb.color_coords(H, W, color)
    xs, ys = np.asarray(xs2).reshape(-1), np.asarray(ys2).reshape(-1)
    return jd, js, td, ts, tout, jout, xs, ys, sel_u, raws, dmin, dmax


def _mismatch(a, b):
    """Per-pixel disagreement mask over the four sweep outputs."""
    bad = np.zeros(a["vw"].shape[0], bool)
    bad |= (a["vw"] != b["vw"]).any(-1)
    bad |= (a["sel"] != b["sel"]).any(-1)
    bad |= ~np.isclose(a["costs"], b["costs"], rtol=2e-5, atol=2e-5)
    bad |= ~np.isclose(a["planes"], b["planes"], rtol=2e-5,
                       atol=2e-5).all(-1)
    return bad


def _outputs(state, xs, ys):
    get = (lambda a: a.numpy()) if isinstance(state.costs, torch.Tensor) \
        else np.asarray
    return dict(vw=get(state.view_weights)[ys, xs],
                sel=get(state.selected)[ys, xs],
                planes=get(state.planes)[ys, xs],
                costs=get(state.costs)[ys, xs])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_propagate_strong_matches_jax(name):
    (_, _, _, ts, tout, jout, xs, ys, *_rest) = _run(name)
    got, want = _outputs(tout, xs, ys), _outputs(jout, xs, ys)
    bad = _mismatch(got, want)
    assert bad.mean() <= MAX_FLIP, f"{bad.sum()} of {bad.size} pixels differ"
    # the other color is untouched
    other = np.ones((H, W), bool)
    other[ys, xs] = False
    np.testing.assert_array_equal(tout.planes.numpy()[other],
                                  np.asarray(jout.planes)[other])
    # the sweep really moved state
    assert (got["planes"] != ts.planes.numpy()[ys, xs]).any(-1).mean() > 0.3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_propagate_strong_matches_oracle(name):
    kw, iteration = CONFIGS[name]
    (_, js, td, ts, tout, _, xs, ys, sel_u, raws, dmin,
     dmax) = _run(name, seed=1, color=1, gf=0.3)
    xf = torch.as_tensor(xs, dtype=torch.float32)
    yf = torch.as_tensor(ys, dtype=torch.float32)
    win = tcost.precompute_ref_window(td, xf, yf, 5, 2,
                                      kw.get("use_sa", False))
    rc = td.ref_cam
    cam = dict(fx=float(rc.fx), fy=float(rc.fy), cx=float(rc.cx),
               cy=float(rc.cy))
    oracle = prop_oracle.run_strong_oracle(
        ts.costs.numpy(), ts.planes.numpy(), ts.selected.numpy(), xs, ys,
        iteration, sel_u, raws, cam,
        lambda _x, _y, p: tcost.ncc_strong(td, xf, yf, torch.as_tensor(
            p, dtype=torch.float32), win).numpy(),
        lambda _x, _y, p: tcost.geom_cost(td, xf, yf, torch.as_tensor(
            p, dtype=torch.float32)).numpy(),
        dict(geom_consistency=kw.get("geom_consistency", False),
             use_impetus=kw.get("use_impetus", True),
             refine_init=kw.get("refine_init", False)),
        dmin, dmax, 0.3, td.num_src)
    got = _outputs(tout, xs, ys)
    want = dict(vw=oracle["vw"], sel=oracle["sel_out"],
                planes=oracle["planes_out"], costs=oracle["costs_out"])
    bad = _mismatch(got, want)
    assert bad.mean() <= MAX_FLIP, f"{bad.sum()} of {bad.size} pixels differ"
    assert oracle["adopted"].sum() > 10
    assert (oracle["refine_slot"] >= 0).sum() > 10


def test_candidate_and_min_index_rules():
    costs = torch.tensor([[3.0, 1.0, 1.0, 2.0],
                          [1.0, 5.0, 1.0, 0.5],
                          [2.0, 2.0, 2.0, 2.0]])
    # last minimum wins (FindMinCostIndex's <=)
    np.testing.assert_array_equal(tprop.last_min_index(costs).numpy(),
                                  [2, 3, 3])
    grid = torch.arange(48, dtype=torch.float32).reshape(6, 8) % 5
    x = torch.tensor([3, 4, 0], dtype=torch.int32)
    y = torch.tensor([3, 0, 5], dtype=torch.int32)
    jx, jy, jf = j_candidates(jnp.asarray(grid.numpy()), jnp.asarray(x),
                              jnp.asarray(y))
    tx, ty, tf = tprop.checkerboard_candidates(grid, x, y)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


# ---------------------------------------------------------------------------
# Weak sweep and the APD initial cost
# ---------------------------------------------------------------------------

WEAK_CONFIGS = {
    "photometric": (dict(), 1),
    "geom_refine_init": (dict(geom_consistency=True, use_impetus=False,
                              refine_init=True), 2),
    "sa": (dict(use_sa=True), 1),
}


def _weak_setup(seed, geom, sa):
    """tests/test_prop_oracle.py's weak fixture: a weak block whose pixels
    keep random planes, strong pixels on ground truth, anchors mostly on
    strong pixels (some missing, some inside the block), fit planes ~30%
    ground truth, ~30% random, the rest all-zero (no fit). Two listed
    pixels are no longer WEAK and must come out untouched."""
    jd, js, td, ts, dmin, dmax = _setup(seed, geom, sa)
    rng = np.random.RandomState(seed)
    weak_np = np.asarray(js.weak).copy()
    weak_np[8:16, 10:26] = WEAK
    wy, wx = np.nonzero(weak_np == WEAK)
    n = len(wx)
    scene = synthetic.make_scene(num_views=V, height=H, width=W)
    ysg, xsg = np.mgrid[0:H, 0:W]
    gt = np.asarray(jgeo.make_plane(
        jd.ref_cam, jnp.asarray(xsg, jnp.float32),
        jnp.asarray(ysg, jnp.float32), jnp.asarray(scene.depths[0]),
        jnp.asarray(scene.normals[0])))
    planes = np.array(js.planes)
    planes[weak_np != WEAK] = gt[weak_np != WEAK]
    anchors = np.full((n, 9, 2), -1, np.int32)
    anchors[:, 0, 0] = wx
    anchors[:, 0, 1] = wy
    for b in range(n):
        for j in range(1, 9):
            mode = rng.rand()
            if mode < 0.04:
                continue
            if mode < 0.08:
                anchors[b, j] = (rng.randint(10, 26), rng.randint(8, 16))
            else:
                anchors[b, j] = (rng.randint(0, W), rng.randint(0, H))
    fit = np.asarray(jgeo.random_plane_hypothesis(
        jax.random.PRNGKey(seed + 7), jd.ref_cam, jnp.asarray(wx, jnp.float32),
        jnp.asarray(wy, jnp.float32), dmin, dmax)).copy()
    u = rng.rand(n)
    fit[u < 0.3] = gt[wy, wx][u < 0.3]
    fit[u >= 0.6] = 0.0
    weak_np[wy[:2], wx[:2]] = UNKNOWN
    js = js.replace(planes=jnp.asarray(planes), weak=jnp.asarray(weak_np))
    return (jd, js, td, _port_state(js), dmin, dmax, wx.astype(np.int32),
            wy.astype(np.int32), anchors, fit.astype(np.float32))


def _run_weak(name, seed=3, gf=0.2):
    kw, iteration = WEAK_CONFIGS[name]
    jd, js, td, ts, dmin, dmax, wx, wy, anchors, fit = _weak_setup(
        seed, kw.get("geom_consistency", False), kw.get("use_sa", False))
    cfg_kw = {"use_sa": False, **kw}
    key = jax.random.PRNGKey(seed + 50)
    n = len(wx)
    jout = j_propagate_weak(
        jd, js, JPropCfg(**cfg_kw), iteration, key, jnp.asarray(wx),
        jnp.asarray(wy), jnp.ones(n, bool), jnp.asarray(anchors),
        jnp.asarray(fit), jnp.float32(dmin), jnp.float32(dmax),
        jnp.float32(gf))
    # propagate_weak splits k_sel then k_ref, as the strong sweep does
    key, k_sel = jax.random.split(key)
    key, k_ref = jax.random.split(key)
    sel_u = np.asarray(jax.random.uniform(k_sel, (n, jsel.NUM_SAMPLES)))
    raws = {k: np.asarray(v) for k, v in j_raws(k_ref, (n,))._asdict().items()}
    tcfg = tprop.PropCfg(**cfg_kw)
    tout = tprop.propagate_weak(
        td, ts, tcfg, iteration, convert.ints(wx, "cpu"),
        convert.ints(wy, "cpu"), convert.ints(anchors, "cpu"),
        convert.floats(fit, "cpu"), dmin, dmax, gf,
        draws=_port_draws(sel_u, raws), chunk=37)
    return (td, ts, tcfg, tout, jout, wx, wy, anchors, fit, sel_u, raws,
            iteration, dmin, dmax)


@pytest.mark.parametrize("name", list(WEAK_CONFIGS))
def test_propagate_weak_matches_jax_and_oracle(name):
    """A chunked port sweep (chunks of 37) against the JAX sweep and the
    weak-sweep oracle: view weights and selections exactly, planes and
    costs to 2e-5, with the strong sweep's allowance of at most 0.5% of
    pixels flipping on a float tie (0 pixels at this size)."""
    (td, ts, tcfg, tout, jout, wx, wy, anchors, fit, sel_u, raws, iteration,
     dmin, dmax) = _run_weak(name)
    live = ts.weak.numpy()[wy, wx] == WEAK
    got, want = _outputs(tout, wx, wy), _outputs(jout, wx, wy)
    bad = _mismatch(got, want)
    assert bad.mean() <= MAX_FLIP, f"{bad.sum()} of {bad.size} pixels differ"
    # pixels no longer WEAK and everything off the list are untouched
    for f in ("planes", "costs", "selected", "view_weights"):
        before = getattr(ts, f).numpy()
        after = getattr(tout, f).numpy()
        np.testing.assert_array_equal(after[wy[~live], wx[~live]],
                                      before[wy[~live], wx[~live]])
        off = np.ones((H, W), bool)
        off[wy, wx] = False
        np.testing.assert_array_equal(after[off], before[off])

    xf = torch.as_tensor(wx, dtype=torch.float32)
    yf = torch.as_tensor(wy, dtype=torch.float32)
    wref = tdef.WeakRefData.build(td, xf, yf, convert.ints(anchors, "cpu"),
                                  ts.selected, tcfg)
    rc = td.ref_cam
    cam = dict(fx=float(rc.fx), fy=float(rc.fy), cx=float(rc.cx),
               cy=float(rc.cy))
    oracle = prop_oracle.run_weak_oracle(
        ts.planes.numpy(), ts.selected.numpy(), ts.weak.numpy(), int(STRONG),
        anchors[:, 1:], fit, wx, wy, iteration, sel_u, raws, cam,
        lambda p: tdef.ncc_weak(td, wref, torch.as_tensor(
            p, dtype=torch.float32), tcfg).numpy(),
        lambda _x, _y, p: tcost.geom_cost(td, xf, yf, torch.as_tensor(
            p, dtype=torch.float32)).numpy(),
        dict(geom_consistency=tcfg.geom_consistency,
             use_impetus=tcfg.use_impetus, refine_init=tcfg.refine_init),
        dmin, dmax, 0.2, td.num_src)
    owant = dict(vw=oracle["vw"], sel=oracle["sel_out"],
                 planes=oracle["planes_out"], costs=oracle["costs_out"])
    obad = _mismatch({k: v[live] for k, v in got.items()},
                     {k: v[live] for k, v in owant.items()})
    assert obad.mean() <= MAX_FLIP, f"{obad.sum()} pixels differ from oracle"
    # every branch of the weak body fires on this fixture
    assert oracle["adopted"].sum() > 3
    assert oracle["took_fit"].sum() > 3
    assert (oracle["refine_slot"] >= 0).sum() > 3
    assert (~(oracle["took_fit"] | (oracle["refine_slot"] >= 0))).sum() > 3


@pytest.mark.parametrize("use_sa", [False, True])
def test_initial_cost_with_weak_rescore_matches_jax(use_sa):
    """The APD passes' initial cost: every listed weak pixel is re-scored
    with the deformable NCC before the top-k selection. Costs to atol 1e-4,
    selections exactly."""
    jd, js, td, ts, dmin, dmax, wx, wy, anchors, _ = _weak_setup(
        4, False, use_sa)
    params = PatchMatchParams(use_sa=use_sa)
    jout = j_initial_cost(jd, js, params, True, jnp.asarray(wx),
                          jnp.asarray(wy), jnp.ones(len(wx), bool),
                          jnp.asarray(anchors))
    tout = tinit.initial_cost(td, ts, params, convert.ints(wx, "cpu"),
                              convert.ints(wy, "cpu"),
                              convert.ints(anchors, "cpu"))
    np.testing.assert_allclose(tout.costs.numpy(), np.asarray(jout.costs),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tout.selected.numpy(),
                                  np.asarray(jout.selected))
    # the rescore really changed the listed pixels' costs
    plain = tinit.initial_cost(td, ts, params).costs.numpy()
    assert (plain[wy, wx] != tout.costs.numpy()[wy, wx]).mean() > 0.5
    off = np.ones((H, W), bool)
    off[wy, wx] = False
    np.testing.assert_array_equal(plain[off], tout.costs.numpy()[off])
