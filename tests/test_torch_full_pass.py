"""The port's pass as three stages (`pipeline.full_pass`): composed, they
equal the single-function pass the port ran before the stages were lifted
out of `run_patchmatch` (kept below as `_monolithic_pass`), bitwise, on a
FIRST_INIT pass and on an APD REFINE_INIT pass; and a one-rank `RowShard`
(the tile route's slicing, without a process group) changes nothing.

Inputs: the 48x64x3 synthetic scene; the APD pass starts from ground
truth with 0.2% noise, pushed 4% off inside the scene's weak plane, which
is marked WEAK (as tests/test_torch_apd.py)."""

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch import config as tcfg
from apde_mvs_tpu_torch.config import UNKNOWN, WEAK
from apde_mvs_tpu_torch.core import geometry as geo
from apde_mvs_tpu_torch.ops import anchors as anchor_ops
from apde_mvs_tpu_torch.ops import filters, init as init_ops
from apde_mvs_tpu_torch.ops.cost import CostData
from apde_mvs_tpu_torch.ops.propagation import PropCfg, propagate_strong, \
    propagate_weak
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.parallel.tile_pass import RowShard
from apde_mvs_tpu_torch.pipeline import full_pass
from apde_mvs_tpu_torch.pipeline.patchmatch import run_patchmatch
from apde_mvs_tpu_torch.testing import synthetic

# several test workers share the machine: one intra-op thread each
torch.set_num_threads(1)

H, W, V = 48, 64, 3
WEAK_REGION = (-0.3, 0.3, -0.2, 0.2)


def view_problem(kind: str):
    """(CostData, params, run_patchmatch keywords) of view 0 of the
    synthetic scene for a ``first_init`` or an ``apd`` pass."""
    scene = synthetic.make_scene(num_views=V, height=H, width=W,
                                 weak_region=WEAK_REGION)
    schedule = tcfg.build_schedule(W, "General", use_sa=False, base=32)
    state = "first_init" if kind == "first_init" else "refine_init"
    params = next(s.params for s in schedule if s.params.state == state)
    cams = geo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]),
        torch.as_tensor(scene.images[0]), torch.as_tensor(scene.images[1:]),
        src_depths=torch.as_tensor(scene.depths[1:]) if kind == "apd"
        else None, real_width=W, real_height=H, sampler_u8=True)
    kw = dict(depth_min=scene.cameras[0].depth_min * tcfg.DEPTH_MIN_FACTOR,
              depth_max=scene.cameras[0].depth_max * tcfg.DEPTH_MAX_FACTOR,
              seed=7)
    if kind == "apd":
        gt = scene.depths[0]
        region = gt < gt.mean() * 0.95
        rng = np.random.default_rng(0)
        prior = (gt * (1 + 0.002 * rng.standard_normal(gt.shape))
                 ).astype(np.float32)
        prior[region] *= 1.04
        kw.update(prior_depth=prior,
                  prior_normal=scene.normals[0].astype(np.float32),
                  prior_weak=np.where(region, WEAK, tcfg.STRONG).astype(
                      np.int32),
                  prior_confidence=np.where(region, 40, 200).astype(
                      np.float32))
    return data, params, kw


def _monolithic_pass(data, params, *, prior_depth=None, prior_normal=None,
                     prior_weak=None, prior_confidence=None, depth_min,
                     depth_max, seed=0):
    """The port's `run_patchmatch` as one function, before the stages were
    lifted out of it (its debug exports left out): the contract the stages
    are held to."""
    first_init = params.state == "first_init"
    use_apd = bool(params.use_apd) and not first_init
    h, w = data.height, data.width
    dev = data.device
    cfg = PropCfg(
        geom_consistency=bool(params.geom_consistency),
        use_impetus=bool(params.use_impetus), use_sa=bool(params.use_sa),
        refine_init=(params.state == "refine_init"),
        strong_radius=params.strong_radius,
        strong_increment=params.strong_increment,
        weak_radius=params.weak_radius, weak_increment=params.weak_increment)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dmin = geo.f32_scalar(depth_min, dev)
    dmax = geo.f32_scalar(depth_max, dev)
    gf = geo.f32_scalar(params.geom_factor, dev)

    state = PMState.create(h, w, data.num_src, device=dev)
    if prior_weak is not None and use_apd:
        state = state.replace(weak=torch.where(
            state.valid, torch.as_tensor(prior_weak).to(torch.int32),
            UNKNOWN))
    if prior_confidence is not None:
        state = state.replace(confidence=torch.as_tensor(
            prior_confidence, dtype=torch.float32))
    if prior_depth is not None:
        state = state.replace(planes=torch.cat(
            [torch.as_tensor(prior_normal, dtype=torch.float32),
             torch.as_tensor(prior_depth, dtype=torch.float32)[..., None]],
            -1))
    weak = None
    if use_apd:
        wy, wx = torch.nonzero(state.weak == WEAK, as_tuple=True)
        if wx.numel() > 0:
            wx = wx.to(torch.int32)
            wy = wy.to(torch.int32)
            ns = anchor_ops.nearest_strong_jfa(state.weak, state.confidence,
                                               state.valid)
            res = anchor_ops.gen_anchors(
                data, state, wx, wy, params.rotate_time,
                params.ransac_threshold, dmin, dmax, ns, generator=gen)
            state = anchor_ops.neighbor_update(state, wx, wy, res.reliable)
            weak = (wx, wy, res.anchors)
            keep = torch.nonzero(res.reliable, as_tuple=True)[0]
            sweep_list = (wx[keep], wy[keep], res.anchors[keep])
    if first_init:
        planes = init_ops.random_planes(data, dmin, dmax, generator=gen)
    else:
        planes = filters.depth_normal_to_planes(
            data, state.planes[..., 3], state.planes[..., :3])
    state = init_ops.initial_cost(
        data, state.replace(planes=planes), params,
        *(weak if weak is not None else ()))
    for it in range(params.max_iterations):
        for color in (0, 1):
            state = propagate_strong(data, state, cfg, it, color, dmin, dmax,
                                     gf, generator=gen)
        if weak is not None and sweep_list[0].numel() > 0:
            fit = anchor_ops.ransac_fit_planes(data, state, *sweep_list,
                                               generator=gen)
            state = propagate_weak(data, state, cfg, it, *sweep_list, fit,
                                   dmin, dmax, gf, generator=gen)
    state = state.replace(planes=filters.planes_to_depth_normal(
        data, state.planes))
    for color in (0, 1):
        state = filters.median_filter_color(state, color)

    xs, ys = geo.pixel_grid(h, w, dev)
    margin = (xs < 6) | (ys < 6) | (xs >= data.img_w - 6) \
        | (ys >= data.img_h - 6)
    depth_map = state.planes[..., 3]
    sweepable = state.valid & (depth_map != 0.0) & state.selected.any(-1)
    chunk = 1 << 16
    weak_map = torch.full((h, w), UNKNOWN, dtype=torch.int32)
    ys_, xs_ = torch.nonzero(sweepable & ~margin, as_tuple=True)
    for i in range(0, xs_.numel(), chunk):
        cx = xs_[i:i + chunk].to(torch.int32)
        cy = ys_[i:i + chunk].to(torch.int32)
        weak_map[cy.long(), cx.long()] = filters.depth_to_weak(
            data, state, cx, cy, params.weak_peak_radius,
            cfg.geom_consistency, gf, dmin, dmax, cfg.strong_radius,
            cfg.strong_increment, use_sa=cfg.use_sa)[0]
    state = state.replace(weak=weak_map)
    if params.geom_consistency or use_apd:
        state = filters.compute_confidence(data, state)
    ry, rx = torch.nonzero(sweepable, as_tuple=True)
    depth_map = depth_map.clone()
    for i in range(0, rx.numel(), chunk):
        cx = rx[i:i + chunk].to(torch.int32)
        cy = ry[i:i + chunk].to(torch.int32)
        depth_map[cy.long(), cx.long()] = filters.local_refine(
            data, state, cx, cy, cfg.geom_consistency, gf, dmin, dmax,
            cfg.strong_radius, cfg.strong_increment, use_sa=cfg.use_sa)
    state = state.replace(planes=torch.cat(
        [state.planes[..., :3], depth_map[..., None]], -1))
    return state


def assert_same(got, want, what):
    for name in ("depth", "normal", "weak", "confidence", "cost"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{what}: {name}")


@pytest.fixture(scope="module", params=["first_init", "apd"])
def problem(request):
    data, params, kw = view_problem(request.param)
    return request.param, data, params, kw, run_patchmatch(data, params,
                                                           **kw)


def test_stages_equal_the_monolithic_pass(problem):
    kind, data, params, kw, out = problem
    state = _monolithic_pass(data, params, **kw)
    np.testing.assert_array_equal(out.depth, state.planes[..., 3].numpy())
    np.testing.assert_array_equal(out.normal, state.planes[..., :3].numpy())
    np.testing.assert_array_equal(out.weak, state.weak.numpy())
    np.testing.assert_array_equal(
        out.confidence,
        np.clip(state.confidence.numpy(), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(out.cost, state.costs.numpy())
    if kind == "apd":
        # the weak machinery ran: the list was non-empty and kept pixels
        assert out.anchors is not None and len(out.anchors) > 32
        assert (out.anchors[:, 1:, 0] >= 0).any()


def test_stages_one_by_one_equal_the_pass(problem):
    """`pass_sweeps`, `pass_classify` and `pass_finish` called in turn (as
    a caller with work between the stages would) give `run_patchmatch`'s
    maps."""
    kind, data, params, kw, out = problem
    cfg = full_pass.PassStatic.from_params(params)
    gen = torch.Generator().manual_seed(kw["seed"])
    dmin = geo.f32_scalar(kw["depth_min"], "cpu")
    dmax = geo.f32_scalar(kw["depth_max"], "cpu")
    priors = {k: v for k, v in kw.items() if k.startswith("prior_")}
    state = full_pass.prior_state(data, cfg, **priors)
    state, weak = full_pass.pass_sweeps(data, state, cfg, dmin, dmax, gen)
    weak_map, curve = full_pass.pass_classify(data, state, cfg, dmin, dmax)
    state = full_pass.pass_finish(data, state.replace(weak=weak_map), cfg,
                                  dmin, dmax)
    np.testing.assert_array_equal(out.depth, state.planes[..., 3].numpy())
    np.testing.assert_array_equal(out.normal, state.planes[..., :3].numpy())
    np.testing.assert_array_equal(out.weak, state.weak.numpy())
    assert curve is None and (weak is None) == (kind == "first_init")


def test_one_rank_shard_changes_nothing(problem):
    """The tile route's slicing and gathers over one rank (no process
    group) reproduce the serial pass bitwise."""
    kind, data, params, kw, out = problem
    assert_same(run_patchmatch(data, params, shard=RowShard(0, 1), **kw),
                out, kind)


def test_pass_static_from_params():
    sched = tcfg.build_schedule(W, "General", use_sa=False, base=32)
    first = full_pass.PassStatic.from_params(sched[0].params)
    assert first.first_init and not first.use_apd
    apd = full_pass.PassStatic.from_params(next(
        s.params for s in sched if s.params.state == "refine_init"))
    assert apd.use_apd and apd.prop.refine_init and not apd.first_init
    geom = full_pass.PassStatic.from_params(sched[-1].params)
    assert geom.prop.geom_consistency and not geom.prop.refine_init
