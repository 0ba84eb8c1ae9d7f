"""Device times of K2, K5, the strong sweep's colour update (K3), the weak
sweep's chunk (K7, K6), the initial cost and the APD setup's kernels (K8,
K9, K10) at the main path's shapes, for comparing two checkouts of the
port on one card.

The shapes are chip_smoke.py's, on view 0 of the 11-view 600x800 synthetic
scene (seed 0), u8 quad tables:

- K2 at the strong shape (10 sources x 240,000 black pixels, ground-truth
  planes, the 36-tap square window), at a tile-route rank's halo row block
  (10 x 120,000) and at the classify chunk (10 x 65,536, depths 2% off);
- K5 as the main path runs it: ``filters.depth_to_weak`` at the classify
  chunk (10 x 65,536 pixels, 61 probes, geometric cost) and
  ``filters.local_refine`` (12 probes), over near-truth planes with each
  pixel's top-k views of K2's costs selected and weighted 1-4; and with
  every view weighted: K5's stage form (one launch a call) in a checkout
  that has it, the window and rule torch ops around K5's sweep form in one
  from before;
- both at S = 32: the 10 sources cycled into 32 (K2 at the strong shape;
  K5 at the classify chunk with the selections and weights cycled the same
  way, so the same share of pairs is weighted);
- the strong sweep's colour update, ``propagation._strong_body``, at the
  black pixels of view 0 (10 x 240,000, geometric cost, iteration 2) over
  the same near-truth planes as camera-frame planes, their top-k mean
  costs and views: K3 in a checkout that has it, the torch-op body (14 K2
  launches and ~100 torch ops) in one from before; with the square window
  and with SA (segment 1 where the depth is below 0.95 of its mean, the
  star there), so the window's torch ops count where a checkout builds it
  outside K3;
- K3 alone at the same two windows (``strong.strong_fused``; in a
  checkout whose K3 still takes a prebuilt window, that window is built
  beforehand, untimed: this branch exists only to time such older
  checkouts against this one);
- the weak sweep's body, ``propagation._weak_body``, on one chunk of the
  APD scan chip_smoke.py runs (``weak_chunk``: round 1 at 600x800, 6 views,
  the SA mask, REFINE_ITER's geometric cost): one K7 launch in a checkout
  that has K7, two K6 launches and ~250 torch ops in one from before it, 30
  K1 launches and ~14,000 torch ops in one from before K6; beside it, where
  the checkout has them, K7 alone (``weak_sweep.weak_update_fused``), the
  body K7 replaced (``weak_composition.weak_body_composition``) and K6
  alone on the chunk's 10 candidate planes (every view) and 5 probes (the
  weighted views); K7 also in REFINE_INIT, with square windows (every
  valid anchor counts) and on the first chunk a real APD REFINE_INIT pass
  hands it (``real_pass_chunks``: the 11-view APD scene of
  ``tools/profile_pass.py --pass apd``, the priors of a FIRST_INIT pass of
  the same view), in both pass forms;
- the initial cost, ``init.initial_cost``, on the call a real APD
  REFINE_INIT pass makes (``real_pass_chunks``: its state, SA windows and
  weak list), its time a call by CUDA events and its host time a call,
  and on the same state without the weak list (a round-0 pass's call:
  the SA and the square window) and with its 10 views cut to 5 or cycled
  to 32 (SA): K2's stage form and K6's re-score form with the selection
  in their epilogues in a checkout that has them, those forms writing the
  costs and K11 in one from before, the window, reference-side and
  selection torch ops around K2's and K6's launches in one from before
  that (also with ``--weak_only``; ``--init_only`` times only these);
- K6's re-score form alone, one launch, in its selection mode (over
  maps of its own) and its cost-out mode (view-major, the pixels' raster
  columns): at the APD scan's first WEAK_CHUNK of its weak list (65,536
  pixels, 5 views) with SA and with square windows, and on the weak list
  of the call a real APD REFINE_INIT pass makes (``real_pass_chunks``);
  also with ``--weak_only``, and ``--rescore_only`` times only these;
- K8 at a 16,384-pixel chunk of the APD scan's weak list at the APD
  round's rotate_time (2: 16 directions) and at the chunk a real APD pass
  hands it, and the chunk's jitter and RANSAC draw table
  (``anchors.anchor_raws``); K10 a call on the APD scan's map and on a
  real pass's (its device time a call's launches summed, as its wrapper
  counts them); K9 a call on the weak chunk's reliable pixels and on a real pass's first
  fit, beside its draw table (``anchors.ransac_draws``).

Each time is the mean over back-to-back launches after a warm-up (CUDA
events); the weak path's kernels also give their device time
(torch.profiler's, ``... device``), free of the host's time a call. The
script imports the package by absolute name, so it times the checkout
found first on ``sys.path``: run it from another checkout's root with
that root on ``PYTHONPATH`` to time that checkout's kernels.

    python -m apde_mvs_tpu_torch.tools.kernel_times [--tag NAME] \
        [--weak_only | --init_only | --rescore_only]
    cd OTHER && PYTHONPATH=$PWD python /path/to/kernel_times.py --tag other

Needs a CUDA device. The last line is one JSON object: the tag, the card,
the libraries' file names and the times in ms.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import json
import sys
import types
from typing import NamedTuple

import numpy as np
import torch

from apde_mvs_tpu_torch import config as cfg
from apde_mvs_tpu_torch.core import checkerboard as cb
from apde_mvs_tpu_torch.core import geometry as geo
from apde_mvs_tpu_torch.core.platform import card_line
from apde_mvs_tpu_torch.ops import anchors as anc
from apde_mvs_tpu_torch.ops import filters, init
from apde_mvs_tpu_torch.ops.cost import (CostData, contiguous_window,
                                         initial_cost_and_selection,
                                         ncc_strong, precompute_ref_window)
from apde_mvs_tpu_torch.ops.cuda import anchors as kern
from apde_mvs_tpu_torch.ops.cuda import ncc
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.parallel.tiles import HALO_ROWS, halo_block
from apde_mvs_tpu_torch.pipeline.full_pass import CHUNK, MIN_MARGIN
from apde_mvs_tpu_torch.testing import synthetic

HEIGHT, WIDTH, VIEWS = 600, 800, 11
CYCLED = 32
# chip_smoke.py's APD scan: its views, its pyramid base (round 1 at full
# size) and the weak plane of benchmarks/fullres_stress.py's scene
APD_VIEWS = 6
# tools/profile_pass.py's views: its APD pass is the real pass timed here
PASS_VIEWS = 11
APD_BASE = 400
WEAK_REGION = (-0.3, 0.3, -0.2, 0.2)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cycled_views(data, n: int):
    """``testing.kernel_cases.cycled_views``, kept here so that the script
    also runs on checkouts that predate that module."""
    idx = [i % data.num_src for i in range(n)]
    return data.replace(src_quads=data.src_quads[idx].contiguous(),
                        src_cams=data.src_cams.map(lambda a: a[idx]),
                        src_depths=data.src_depths[idx].contiguous(),
                        num_src=n), idx


def k2_times(scene, dev, out: dict) -> None:
    H, W = scene.images.shape[1:]
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    data = CostData.build(cams.view(0), cams.map(lambda a: a[1:]), imgs[0],
                          imgs[1:], src_depths=torch.as_tensor(
                              np.stack(scene.depths[1:]), device=dev),
                          sampler_u8=True)
    depth = torch.as_tensor(scene.depths[0], device=dev)
    normal = torch.as_tensor(scene.normals[0], device=dev)
    ncam = geo.normal_world_to_cam(cams.view(0).R, torch.cat(
        [normal, torch.zeros_like(depth)[..., None]], -1))[..., :3]

    def black(rows=slice(None), cam=None, row0=0, scale=1.0):
        xs, ys = cb.color_coords(H, W, 0, device=dev)
        xs, ys = xs[rows].reshape(-1), ys[rows].reshape(-1)
        xf, yf = xs.float(), (ys - row0).float()
        plane = geo.make_plane(cam or cams.view(0), xf, yf,
                               depth[ys.long(), xs.long()] * scale,
                               ncam[ys.long(), xs.long()])
        return xf.contiguous(), yf.contiguous(), plane.contiguous()

    def timed(name, d, x, y, plane, iters=50):
        win = precompute_ref_window(d, x, y, 5, 2)
        out[name] = cuda_ms(
            lambda: ncc.ncc_strong_fused(d, x, y, plane, win), iters)
        print(f"{name}: {out[name]:.4f} ms ({d.num_src} views x "
              f"{x.numel()} pixels)", flush=True)

    x, y, plane = black()
    timed("K2 strong", data, x, y, plane)
    block, row0, _, _ = halo_block(data, 0, H // 2, HALO_ROWS)
    timed("K2 row shard", block, *black(slice(0, H // 2), block.ref_cam,
                                        row0))
    cx, cy, cplane = black(scale=1.02)
    timed("K2 classify chunk", data, cx[:CHUNK], cy[:CHUNK],
          cplane[:CHUNK].contiguous())
    timed("K2 strong S=32", cycled_views(data, CYCLED)[0], x, y, plane, 20)


def k5_times(scene, dev, out: dict, seed: int = 0) -> None:
    H, W = scene.images.shape[1:]
    S = scene.num_views - 1
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    data = CostData.build(cams.view(0), cams.map(lambda a: a[1:]), imgs[0],
                          imgs[1:], src_depths=torch.as_tensor(
                              np.stack(scene.depths[1:]), device=dev),
                          sampler_u8=True)
    params = cfg.build_schedule(max(H, W))[1].params      # REFINE_ITER
    dmin = scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR
    rng = np.random.default_rng(seed)
    depth = scene.depths[0] * (1 + rng.normal(0, 0.002, (H, W)))
    depth = np.where(rng.random((H, W)) < 0.2,
                     depth * (1 + rng.choice([-0.03, 0.03], (H, W))), depth)
    planes = torch.as_tensor(np.concatenate(
        [scene.normals[0], depth[..., None]], -1).astype(np.float32),
        device=dev)
    xs, ys = geo.pixel_grid(H, W, dev)
    cam_planes = filters.depth_normal_to_planes(data, planes[..., 3],
                                                planes[..., :3])
    win_all = precompute_ref_window(data, xs.reshape(-1), ys.reshape(-1), 5,
                                    2)
    costs = ncc_strong(data, xs.reshape(-1), ys.reshape(-1),
                       cam_planes.reshape(-1, 4), win_all)
    del win_all, cam_planes
    _, sel = initial_cost_and_selection(costs, params.top_k)
    vw = sel.float() * torch.randint(1, 5, sel.shape, device=dev,
                                     generator=torch.Generator(
                                         device=dev).manual_seed(seed))
    state = PMState.create(H, W, S, device=dev).replace(
        planes=planes, selected=sel.reshape(H, W, S).contiguous(),
        view_weights=vw.reshape(H, W, S).contiguous())
    del costs
    margin = (xs < MIN_MARGIN) | (ys < MIN_MARGIN) \
        | (xs >= W - MIN_MARGIN) | (ys >= H - MIN_MARGIN)
    cy, cx = torch.nonzero(~margin, as_tuple=True)
    cx, cy = cx[:CHUNK].to(torch.int32), cy[:CHUNK].to(torch.int32)
    every = state.replace(selected=torch.ones_like(state.selected),
                          view_weights=torch.ones_like(state.view_weights))
    d32, idx = cycled_views(data, CYCLED)
    state32 = state.replace(selected=state.selected[..., idx].contiguous(),
                            view_weights=state.view_weights[..., idx]
                            .contiguous())
    gf, radius = params.geom_factor, params.weak_peak_radius

    def classify(d, s):
        return lambda: filters.depth_to_weak(d, s, cx, cy, radius, True, gf,
                                             dmin, dmax)

    def refine(d, s):
        return lambda: filters.local_refine(d, s, cx, cy, True, gf, dmin,
                                            dmax)

    for name, fn, s, iters in (
            ("K5 classify", classify(data, state), state, 20),
            ("K5 refine", refine(data, state), state, 50),
            ("K5 classify every view", classify(data, every), every, 10),
            ("K5 refine every view", refine(data, every), every, 20),
            ("K5 classify S=32", classify(d32, state32), state32, 10)):
        out[name] = cuda_ms(fn, iters)
        share = float((s.view_weights[cy.long(), cx.long()] != 0)
                      .float().mean())
        print(f"{name}: {out[name]:.4f} ms ({s.selected.shape[-1]} views x "
              f"{cx.numel()} pixels, {share:.3f} of the pairs weighted)",
              flush=True)


def colour_update_times(scene, dev, out: dict, seed: int = 0) -> None:
    from apde_mvs_tpu_torch.ops import propagation
    H, W = scene.images.shape[1:]
    S = scene.num_views - 1
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    data = CostData.build(cams.view(0), cams.map(lambda a: a[1:]), imgs[0],
                          imgs[1:], src_depths=torch.as_tensor(
                              np.stack(scene.depths[1:]), device=dev),
                          sampler_u8=True)
    params = cfg.build_schedule(max(H, W))[1].params      # REFINE_ITER
    rng = np.random.default_rng(seed)
    depth = scene.depths[0] * (1 + rng.normal(0, 0.002, (H, W)))
    depth = np.where(rng.random((H, W)) < 0.2,
                     depth * (1 + rng.choice([-0.03, 0.03], (H, W))), depth)
    xs, ys = geo.pixel_grid(H, W, dev)
    planes = filters.depth_normal_to_planes(
        data, torch.as_tensor(depth.astype(np.float32), device=dev),
        torch.as_tensor(scene.normals[0], device=dev)).contiguous()
    costs = ncc_strong(data, xs.reshape(-1), ys.reshape(-1),
                       planes.reshape(-1, 4), precompute_ref_window(
                           data, xs.reshape(-1), ys.reshape(-1), 5, 2))
    mean_cost, sel = initial_cost_and_selection(costs, params.top_k)
    state = PMState.create(H, W, S, device=dev).replace(
        planes=planes, costs=mean_cost.reshape(H, W).contiguous(),
        selected=sel.reshape(H, W, S).contiguous())
    xs2, ys2 = cb.color_coords(H, W, 0, device=dev)
    x, y = xs2.reshape(-1).contiguous(), ys2.reshape(-1).contiguous()
    draws = propagation.sweep_draws(
        torch.Generator(device=dev).manual_seed(seed), x.numel(), dev)
    dmin, dmax, gf = (float(np.float32(v)) for v in (
        scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR,
        scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR,
        params.geom_factor))
    sa_data = data.replace(sa_mask=torch.as_tensor(
        scene.depths[0] < 0.95 * scene.depths[0].mean(), device=dev).to(
            torch.int32))
    from apde_mvs_tpu_torch.ops.cuda import strong
    # only an older checkout's K3 takes a prebuilt window
    takes_window = "win" in inspect.signature(strong.strong_fused).parameters
    for tag, d, sa in (("", data, False), (" SA", sa_data, True)):
        prop = propagation.PropCfg(geom_consistency=True, use_sa=sa)
        name = "colour update" + tag
        out[name] = cuda_ms(lambda: propagation._strong_body(
            d, state, prop, 2, draws, x, y, dmin, dmax, gf), 10)
        print(f"{name}: {out[name]:.4f} ms ({S} views x {x.numel()} pixels, "
              "geometric)", flush=True)
        kw = dict(iteration=2, depth_min=dmin, depth_max=dmax,
                  geom_factor=gf, geom=True, refine_init=False)
        if takes_window:
            win = contiguous_window(precompute_ref_window(
                d, x.float(), y.float(), 5, 2, sa))
            args = (d, state, x, y, win, draws)
        else:
            args = (d, state, x, y, draws)
            kw.update(radius=5, increment=2, use_sa=sa)
        name = "K3" + tag
        out[name] = cuda_ms(lambda: strong.strong_fused(*args, **kw), 10)
        print(f"{name}: {out[name]:.4f} ms ({S} views x {x.numel()} pixels, "
              "geometric)", flush=True)


def device_ms(fn, iters: int, kernel: str, tries: int = 3,
              launches_a_call: int = 0) -> float:
    """The mean device time of the kernels whose name holds ``kernel``
    over ``iters`` calls of ``fn`` (torch.profiler), a launch's, or with
    ``launches_a_call`` a call's (every launch of the call summed): free
    of the host's time a call, which CUDA events around a short kernel
    also hold. A profile that caught none of them, or with
    ``launches_a_call`` not ``iters`` times that many (the profiler has
    lost a window's kernel records on the card), is taken again,
    ``tries`` times at most, then the time is NaN: not measured."""
    fn()
    torch.cuda.synchronize()
    want = iters * launches_a_call
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total += getattr(evt, "self_device_time_total",
                                 getattr(evt, "self_cuda_time_total", 0.0))
                count += evt.count
        if count and (not want or count == want):
            return total / (iters if want else count) / 1e3
    print(f"device_ms: the profiler saw {count} {kernel} kernel(s) in the "
          f"last of {tries} profiles, {want or 'some'} wanted: not measured",
          file=sys.stderr, flush=True)
    return float("nan")


def k10_launches(fn) -> int:
    """K10's launches in one call of ``fn``, by its wrapper's count."""
    before = kern.jfa_launches
    fn()
    return kern.jfa_launches - before


def apd_scene(views: int = APD_VIEWS):
    """chip_smoke.py's APD scene at 600x800."""
    return synthetic.make_scene(num_views=views, height=HEIGHT, width=WIDTH,
                                baseline=0.12, focal=1.25 * WIDTH,
                                weak_region=WEAK_REGION)


def _cloned(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{
            f.name: _cloned(getattr(v, f.name)) for f in dataclasses.fields(v)
            if isinstance(getattr(v, f.name), torch.Tensor)})
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_cloned(a) for a in v))
    return v


class RealPass(NamedTuple):
    """A real APD REFINE_INIT pass of view 0 (``real_pass_inputs``)."""

    data: CostData
    params: object        # the pass's PatchMatchParams
    depth_min: float
    depth_max: float
    prior: dict           # run_patchmatch's prior_* arguments
    prior_weak: int       # WEAK pixels of the prior


def real_pass_inputs(dev, views: int = PASS_VIEWS) -> RealPass:
    """``tools/profile_pass.py --pass apd``'s pass: the APD scene with
    ``views`` views (its default 11), priors from a FIRST_INIT pass of the
    same view at full size, source depths the ground truth, the SA mask the
    weak plane; run it with ``patchmatch.run_patchmatch(data, params,
    depth_min=, depth_max=, seed=1, **prior)``."""
    from apde_mvs_tpu_torch.pipeline import patchmatch
    scene = apd_scene(views)
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    region = scene.depths[0] < scene.depths[0].mean() * 0.95
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]), imgs[0], imgs[1:],
        src_depths=torch.as_tensor(scene.depths[1:], device=dev),
        sampler_u8=True, sa_mask=torch.as_tensor(region, device=dev))
    schedule = cfg.build_schedule(max(HEIGHT, WIDTH), "General",
                                  base=APD_BASE)
    dmin = scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR
    first = patchmatch.run_patchmatch(data, schedule[0].params,
                                      depth_min=dmin, depth_max=dmax, seed=1)
    prior = dict(prior_depth=first.depth, prior_normal=first.normal,
                 prior_weak=first.weak.astype(np.int32),
                 prior_confidence=first.confidence.astype(np.float32))
    spec = next(s for s in schedule if s.params.state == "refine_init")
    return RealPass(data, spec.params, dmin, dmax, prior,
                    int((first.weak == cfg.WEAK).sum()))


def real_pass_chunks(dev, views: int = PASS_VIEWS
                     ) -> types.SimpleNamespace:
    """The first K7 chunk, the first K8 chunk, the first K9 call, the
    K10 call and the initial cost of a real APD REFINE_INIT pass of view 0
    (``real_pass_inputs``), each as the positional and keyword arguments of
    its wrapper (``init.initial_cost`` for the initial cost: the pass's
    state, SA windows and weak list), captured at the call (``k7``, ``k8``,
    ``k9``, ``k10``, ``init``; None where the checkout has no such
    wrapper), the pass (``inputs``); and ``k8_plain``, the
    pass's reference camera, RANSAC threshold and depth bounds, which K8's
    plain version takes in place of the wrapper's host scalars (K9's
    takes the camera)."""
    from apde_mvs_tpu_torch.ops.cuda import weak_sweep
    from apde_mvs_tpu_torch.pipeline import patchmatch
    rp = real_pass_inputs(dev, views)
    got = {}

    def capture(mod, name, key):
        fn = getattr(mod, name)

        def run(*a, **kw):
            if key not in got:
                got[key] = (tuple(_cloned(v) for v in a),
                            {k: _cloned(v) for k, v in kw.items()})
            return fn(*a, **kw)
        return fn, run
    saved = []
    for mod, name, key in ((weak_sweep, "weak_update_fused", "k7"),
                           (kern, "gen_anchors", "k8"),
                           (kern, "fit_planes", "k9"),
                           (kern, "nearest_strong", "k10"),
                           (init, "initial_cost", "init")):
        fn, run = capture(mod, name, key)
        saved.append((mod, name, fn))
        setattr(mod, name, run)
    try:
        patchmatch.run_patchmatch(rp.data, rp.params, depth_min=rp.depth_min,
                                  depth_max=rp.depth_max, seed=1, **rp.prior)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return types.SimpleNamespace(
        k7=got.get("k7"), k8=got.get("k8"), k9=got.get("k9"),
        k10=got.get("k10"), init=got.get("init"), inputs=rp,
        prior_weak=rp.prior_weak,
        k8_plain=(rp.data.ref_cam, rp.params.ransac_threshold, rp.depth_min,
                  rp.depth_max))


def k7_kwargs(wc, sa: bool, geom: bool, refine_init: bool) -> dict:
    """``weak_update_fused``'s keywords for ``kernel_times.weak_chunk``'s
    chunk in one pass form."""
    c = wc.cfg
    return dict(strong_radius=c.strong_radius,
                strong_increment=c.strong_increment,
                weak_radius=c.weak_radius, weak_increment=c.weak_increment,
                use_sa=sa, iteration=wc.iteration, depth_min=wc.depth_min,
                depth_max=wc.depth_max, geom_factor=wc.geom_factor,
                geom=geom, refine_init=refine_init)


def k8_chunk(scene, dev, seed: int = 0) -> tuple:
    """(args, kwargs) of ``kern.gen_anchors`` at chip_smoke.py's K8 chunk:
    the first ANCHOR_CHUNK pixels of the APD scan's weak list (the weak
    plane WEAK at confidence 40 in a STRONG field at 200, the ground-truth
    depths), the APD round's rotate_time and threshold, seeded draws."""
    depth = torch.as_tensor(scene.depths[0], device=dev)
    normal = torch.as_tensor(scene.normals[0], device=dev)
    region = depth < depth.mean() * 0.95
    params = next(sp.params for sp in cfg.build_schedule(
        max(HEIGHT, WIDTH), base=APD_BASE) if sp.params.use_apd)
    weak = torch.where(region, cfg.WEAK, cfg.STRONG).to(torch.int32)
    conf = torch.where(region, 40.0, 200.0)
    valid = torch.ones_like(region)
    ns = anc.nearest_strong_jfa(weak, conf, valid)
    wy, wx = torch.nonzero(region, as_tuple=True)
    n = min(anc.ANCHOR_CHUNK, wx.numel())
    wx = wx[:n].to(torch.int32).contiguous()
    wy = wy[:n].to(torch.int32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rt = params.rotate_time
    raws = anc.anchor_raws(gen, n, rt, device=dev)
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    dirs, radii = anc._kernel_tables(rt, str(dev))
    dmin = np.float32(scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR)
    dmax = np.float32(scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR)
    planes = torch.cat([normal, depth[..., None]], -1).contiguous()
    return ((ns, planes, HEIGHT, WIDTH, wx, wy, raws.shift_x, raws.shift_y,
             raws.triplets, dirs, radii, anc.JITTER_SAMPLES,
             kern.camera(cams.view(0)),
             float(np.float32(anc._cone_cos(rt))),
             float(np.float32(params.ransac_threshold)),
             float(dmax - dmin), anc.MIN_MARGIN), {})


def draw_table_ms(dev, n: int, rotate_time: int, iters: int = 20) -> float:
    """The jitter and RANSAC draws of one K8 chunk (``anc.anchor_raws``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return cuda_ms(lambda: anc.anchor_raws(gen, n, rotate_time, device=dev),
                   iters)


class WeakChunk(NamedTuple):
    """One weak-sweep chunk: ``_weak_body``'s arguments, and K6's inputs."""

    data: CostData
    state: PMState
    cfg: object           # propagation.PropCfg
    iteration: int
    draws: object         # propagation.SweepDraws
    x: torch.Tensor       # (B,) int32
    y: torch.Tensor
    anchors: torch.Tensor  # (B, 9, 2) int32
    fit: torch.Tensor     # (B, 4) fit planes, zeros where none
    depth_min: float
    depth_max: float
    geom_factor: float
    candidates: torch.Tensor   # (B, 10, 4) the body's candidate planes
    probes: torch.Tensor       # (B, 5, 4) refinement probes of the current
    vw: torch.Tensor           # (B, S) view weights of the body's selection
    all_x: torch.Tensor        # (Nw,) every weak pixel, the initial cost's
    all_y: torch.Tensor        # weak list, and its (Nw, 9, 2) anchors
    all_anchors: torch.Tensor


def weak_chunk(scene, dev, seed: int = 0) -> WeakChunk:
    """The first weak-sweep chunk of an APD scan's round 1 (``scene`` at
    600x800 with its weak plane): the reference view's SA mask is the weak
    plane (depth below 0.95 of its mean), the state the ground-truth depths
    and normals with the plane WEAK, the initial cost's top-k views
    selected; anchors from ``anchors.gen_anchors`` and fit planes from
    ``anchors.ransac_fit_planes``, seeded; the chunk is the first
    WEAK_SWEEP_CHUNK reliable weak pixels. REFINE_ITER's parameters of the
    APD round (SA windows, the geometric cost against the ground-truth
    source depths). The probes are the refinement hypotheses of the
    current planes, the view weights those of ``_weak_body``'s selection;
    beside the chunk, every weak pixel with its anchors (the list the
    initial cost re-scores). Uses only what checkouts from before K6 have
    too."""
    from apde_mvs_tpu_torch.ops import propagation
    H, W = scene.images.shape[1:]
    S = scene.num_views - 1
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    depth = torch.as_tensor(scene.depths[0], device=dev)
    normal = torch.as_tensor(scene.normals[0], device=dev)
    region = depth < depth.mean() * 0.95
    data = CostData.build(cams.view(0), cams.map(lambda a: a[1:]), imgs[0],
                          imgs[1:], src_depths=torch.as_tensor(
                              np.stack(scene.depths[1:]), device=dev),
                          sampler_u8=True, sa_mask=region.to(torch.int32))
    params = next(sp.params for sp in cfg.build_schedule(
        max(H, W), base=APD_BASE) if sp.params.use_apd
        and sp.params.geom_consistency)
    dmin = float(np.float32(scene.cameras[0].depth_min
                            * cfg.DEPTH_MIN_FACTOR))
    dmax = float(np.float32(scene.cameras[0].depth_max
                            * cfg.DEPTH_MAX_FACTOR))
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = PMState.create(H, W, S, device=dev).replace(
        planes=torch.cat([normal, depth[..., None]], -1),
        weak=torch.where(region, cfg.WEAK, cfg.STRONG).to(torch.int32),
        confidence=torch.where(region, 40.0, 200.0))
    wy, wx = torch.nonzero(region, as_tuple=True)
    wx, wy = wx.to(torch.int32), wy.to(torch.int32)
    ns = anc.nearest_strong_jfa(state.weak, state.confidence, state.valid)
    res = anc.gen_anchors(data, state, wx, wy, params.rotate_time,
                          params.ransac_threshold, dmin, dmax, ns,
                          generator=gen)
    keep = torch.nonzero(res.reliable, as_tuple=True)[0][
        :propagation.WEAK_SWEEP_CHUNK]
    x, y, anchors = wx[keep], wy[keep], res.anchors[keep]
    planes = filters.depth_normal_to_planes(data, depth,
                                            normal).contiguous()
    xs, ys = geo.pixel_grid(H, W, dev)
    costs = ncc_strong(data, xs.reshape(-1), ys.reshape(-1),
                       planes.reshape(-1, 4), precompute_ref_window(
                           data, xs.reshape(-1), ys.reshape(-1), 5, 2))
    mean_cost, sel = initial_cost_and_selection(costs, params.top_k)
    state = state.replace(planes=planes,
                          costs=mean_cost.reshape(H, W).contiguous(),
                          selected=sel.reshape(H, W, S).contiguous())
    fit = anc.ransac_fit_planes(data, state, x, y, anchors, generator=gen)
    prop = propagation.PropCfg(
        geom_consistency=True, use_impetus=bool(params.use_impetus),
        use_sa=bool(params.use_sa), strong_radius=params.strong_radius,
        strong_increment=params.strong_increment,
        weak_radius=params.weak_radius, weak_increment=params.weak_increment)
    draws = propagation.sweep_draws(gen, x.numel(), dev)
    gf = float(np.float32(params.geom_factor))
    a_xc = torch.clamp(anchors[:, 1:, 0], min=0)
    a_yc = torch.clamp(anchors[:, 1:, 1], min=0)
    cur = planes[y.long(), x.long()]
    candidates = torch.cat([planes[a_yc.long(), a_xc.long()], cur[:, None],
                            fit[:, None]], 1).contiguous()
    xf, yf = x.float(), y.float()
    r_depths, r_normals = propagation.refinement_from_raws(
        draws.raws, data.ref_cam, xf, yf, cur,
        geo.depth_from_plane(data.ref_cam, cur, xf, yf), dmin, dmax)
    probes = torch.stack([geo.make_plane(data.ref_cam, xf, yf,
                                         r_depths[:, i], r_normals[:, i])
                          for i in range(5)], 1).contiguous()
    it = 1
    vw = propagation._weak_body(data, state, prop, it, draws, x, y, anchors,
                                fit, dmin, dmax, gf)[3].contiguous()
    return WeakChunk(data, state, prop, it, draws, x, y, anchors, fit, dmin,
                     dmax, gf, candidates, probes, vw, wx, wy,
                     res.anchors.contiguous())


def timed(out: dict, name: str, fn, iters: int, kernel: str,
          what: str, launches_a_call: int = 0) -> None:
    """``fn``'s mean time a call by CUDA events into out[name] and its
    kernel's device time (profiler; a call's of ``launches_a_call``
    launches where given) into out[name + " device"]."""
    out[name] = cuda_ms(fn, iters)
    out[name + " device"] = device_ms(fn, iters, kernel,
                                      launches_a_call=launches_a_call)
    print(f"{name}: {out[name]:.4f} ms, device {out[name + ' device']:.4f} "
          f"ms {what}", flush=True)


def weak_times(scene, wc, real, dev, out: dict) -> None:
    from apde_mvs_tpu_torch.ops import propagation
    from apde_mvs_tpu_torch.ops.deformable import WeakRefData
    S = wc.data.num_src
    what = f"({S} views x {wc.x.numel()} weak pixels, geometric, SA)"
    out["weak body"] = cuda_ms(lambda: propagation._weak_body(
        wc.data, wc.state, wc.cfg, wc.iteration, wc.draws, wc.x, wc.y,
        wc.anchors, wc.fit, wc.depth_min, wc.depth_max, wc.geom_factor), 5)
    print(f"weak body: {out['weak body']:.4f} ms {what}", flush=True)
    try:
        from apde_mvs_tpu_torch.ops.cuda import weak_sweep
        from apde_mvs_tpu_torch.testing.weak_composition import \
            weak_body_composition
    except ImportError:
        print("no K7 in this checkout", flush=True)
    else:
        cfg_ = wc.cfg
        kw = dict(strong_radius=cfg_.strong_radius,
                  strong_increment=cfg_.strong_increment,
                  weak_radius=cfg_.weak_radius,
                  weak_increment=cfg_.weak_increment, use_sa=cfg_.use_sa,
                  iteration=wc.iteration, depth_min=wc.depth_min,
                  depth_max=wc.depth_max, geom_factor=wc.geom_factor,
                  geom=True, refine_init=False)
        args = (wc.data, wc.state, wc.x, wc.y, wc.anchors, wc.fit, wc.draws)
        for name, kw_, what_ in (
                ("K7", kw, what),
                ("K7 REFINE_INIT", dict(kw, geom=False, refine_init=True),
                 what.replace("geometric", "REFINE_INIT")),
                ("K7 square", dict(kw, use_sa=False),
                 what.replace("SA", "square windows"))):
            timed(out, name, lambda: weak_sweep.weak_update_fused(
                *args, **kw_), 20, "weak_update_kernel", what_)
        if real.k7 is not None:
            a, kw_ = real.k7
            for name, form in (("K7 real pass", dict(geom=False,
                                                     refine_init=True)),
                               ("K7 real pass REFINE_ITER",
                                dict(geom=True, refine_init=False))):
                timed(out, name, lambda: weak_sweep.weak_update_fused(
                    *a, **dict(kw_, **form)), 20, "weak_update_kernel",
                    f"({a[0].num_src} views x {a[2].numel()} weak pixels of "
                    "a real APD pass's first chunk)")
        scalars = [geo.f32_scalar(v, dev) for v in (
            wc.depth_min, wc.depth_max, wc.geom_factor)]
        out["weak body composition"] = cuda_ms(
            lambda: weak_body_composition(
                wc.data, wc.state, wc.cfg, wc.iteration, wc.draws, wc.x,
                wc.y, wc.anchors, wc.fit, *scalars), 5)
        print(f"weak body composition (two K6 launches and ~250 torch ops): "
              f"{out['weak body composition']:.4f} ms {what}", flush=True)
    try:
        from apde_mvs_tpu_torch.ops.cuda import weak
        from apde_mvs_tpu_torch.ops.deformable import contiguous_ref
    except ImportError:
        print("no K6 in this checkout", flush=True)
        return
    wref = contiguous_ref(WeakRefData.build(
        wc.data, wc.x.float(), wc.y.float(), wc.anchors, wc.state.selected,
        wc.cfg))
    r, inc = wc.cfg.weak_radius, wc.cfg.weak_increment
    for name, planes, vw in (("K6 candidates", wc.candidates, None),
                             ("K6 probes", wc.probes, wc.vw)):
        out[name] = cuda_ms(lambda: weak.weak_fused(
            wc.data, wref, planes, r, inc, geom=True, view_weights=vw), 20)
        print(f"{name}: {out[name]:.4f} ms ({planes.shape[1]} planes) "
              f"{what}", flush=True)


def init_times(real, out: dict) -> None:
    """The initial cost, ``init.initial_cost``, on the call a real APD
    REFINE_INIT pass makes (its state, SA windows and weak list): three
    kernel launches and no other torch op in a checkout with K2's stage
    form, K6's re-score form and K11, the window, reference-side and
    selection torch ops around K2's and K6's launches in one from before.
    Its time a call (CUDA events) and its host time a call (the host clock
    from the call to its return, the launches enqueued)."""
    import time
    if real.init is None:
        print("no initial cost captured", flush=True)
        return
    a, kw = real.init

    def call():
        return init.initial_cost(*a, **kw)
    out["initial cost"] = cuda_ms(call, 10)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    out["initial cost host"] = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    n = 0 if len(a) < 4 else a[3].numel()
    print(f"initial cost: {out['initial cost']:.4f} ms, host "
          f"{out['initial cost host']:.4f} ms a call ({a[0].num_src} views, "
          f"{a[0].height}x{a[0].width}, {n} weak pixels re-scored, a real "
          f"APD REFINE_INIT pass)", flush=True)
    # the same state without the weak list: K2's stage form and the
    # selection alone, SA and square, at the pass's views, 5 and 32
    from apde_mvs_tpu_torch.testing.kernel_cases import cycled_views
    data, state, params = a[:3]
    square = dataclasses.replace(params, use_sa=False)
    for name, views, prm in (("SA", data.num_src, params),
                             ("square", data.num_src, square),
                             ("SA", 5, params), ("SA", 32, params)):
        d = data if views == data.num_src else cycled_views(data, views)[0]
        key = f"initial cost, no weak list, {name}, {views} views"
        out[key] = cuda_ms(lambda: init.initial_cost(d, state, prm), 10)
        print(f"{key}: {out[key]:.4f} ms a call", flush=True)


def rescore_times(scene, wc, real, out: dict) -> None:
    """K6's re-score form alone (one launch a call) in both modes, by CUDA
    events and profiler device time: at the APD scan's first WEAK_CHUNK
    (``weak_chunk``'s state and weak list, the APD round's SA windows and
    its square ones) and on a real APD REFINE_INIT pass's weak list (its
    ``initial_cost`` call: state, SA windows, list). The selection mode
    writes maps of its own; the cost-out mode writes (S, H W) view-major
    costs into the pixels' raster columns."""
    from apde_mvs_tpu_torch.ops.cuda import weak
    if not hasattr(weak, "rescore_select_fused"):
        print("no K6 re-score form with the selection in this checkout",
              flush=True)
        return
    H, W = scene.images.shape[1:]
    params = next(sp.params for sp in cfg.build_schedule(
        max(H, W), base=APD_BASE) if sp.params.use_apd)
    n = min(wc.all_x.numel(), init.WEAK_CHUNK)
    cases = [("APD chunk, SA", wc.data, wc.state, params),
             ("APD chunk, square", wc.data, wc.state,
              dataclasses.replace(params, use_sa=False))]
    lists = [(wc.all_x, wc.all_y, wc.all_anchors, n)] * 2
    if real.init is not None:
        (d, st, prm, rx, ry, ran), _ = real.init
        cases.append(("real pass", d, st, prm))
        lists.append((rx, ry, ran, min(rx.numel(), init.WEAK_CHUNK)))
    for (tag, d, st, prm), (x, y, an, m) in zip(cases, lists):
        h, w, s = d.height, d.width, d.num_src
        kw = dict(strong_radius=prm.strong_radius,
                  strong_increment=prm.strong_increment,
                  weak_radius=prm.weak_radius,
                  weak_increment=prm.weak_increment,
                  use_sa=bool(prm.use_sa))
        cmap = torch.empty((h, w), device=d.device)
        smap = torch.empty((h, w, s), dtype=torch.bool, device=d.device)
        costs = torch.empty((s, h * w), device=d.device)
        what = f"({m} weak pixels, {s} views)"
        timed(out, f"K6 re-score, {tag}",
              lambda: weak.rescore_select_fused(
                  d, st.planes, st.selected, x, y, an, 0, m, st.valid,
                  prm.top_k, cmap, smap, **kw), 20, "rescore_weak_kernel",
              what)
        timed(out, f"K6 re-score cost-out, {tag}",
              lambda: weak.rescore_fused(
                  d, st.planes, st.selected, x, y, an, 0, m, costs,
                  view_major=True, **kw), 20, "rescore_weak_kernel", what)


def anchor_times(scene, wc, real, dev, out: dict, seed: int = 0) -> None:
    """K8 at chip_smoke.py's chunk and at a real APD pass's, the draw table
    of a chunk, K10 a call on the APD scan's map and K9 a call on the weak
    chunk's reliable pixels (camera-frame planes)."""
    args, _ = k8_chunk(scene, dev, seed)
    n, rt = args[4].numel(), args[9].shape[0] // 8
    what = f"({n} pixels, {8 * rt} directions)"
    timed(out, "K8", lambda: kern.gen_anchors(*args), 20, "gen_anchors",
          what)
    if real.k8 is not None:
        a, kw = real.k8
        timed(out, "K8 real pass", lambda: kern.gen_anchors(*a, **kw), 20,
              "gen_anchors", f"({a[4].numel()} pixels of a real APD pass)")
    out["K8 draw table"] = draw_table_ms(dev, n, rt)
    print(f"K8 draw table: {out['K8 draw table']:.4f} ms {what}",
          flush=True)
    depth = torch.as_tensor(scene.depths[0], device=dev)
    region = depth < depth.mean() * 0.95
    weak = torch.where(region, cfg.WEAK, cfg.STRONG).to(torch.int32)
    conf = torch.where(region, 40.0, 200.0)
    valid = torch.ones_like(region)
    # a call over the live sub-passes (a parent without them: every step)
    plan = anc.jfa_schedule(HEIGHT, WIDTH) if hasattr(anc, "jfa_schedule") \
        else anc.jfa_steps(HEIGHT, WIDTH)

    def k10():
        return kern.nearest_strong(weak, conf, valid, plan)
    launches = k10_launches(k10)
    timed(out, "K10", k10, 20, "jfa",
          f"({HEIGHT}x{WIDTH}, {launches} launches)",
          launches_a_call=launches)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tri = anc.ransac_draws(gen, wc.x.numel(), dev)
    cam = kern.camera(wc.data.ref_cam)
    timed(out, "K9", lambda: kern.fit_planes(
        wc.state.planes, wc.x, wc.y, wc.anchors, tri, cam), 20, "fit_planes",
        f"({wc.x.numel()} reliable weak pixels)")
    out["K9 draw table"] = cuda_ms(lambda: anc.ransac_draws(
        gen, wc.x.numel(), dev), 20)
    print(f"K9 draw table: {out['K9 draw table']:.4f} ms (torch.randint, "
          f"({anc.RANSAC_ITERS}, {wc.x.numel()}, 3))", flush=True)
    if real.k9 is not None:
        a, kw = real.k9
        timed(out, "K9 real pass", lambda: kern.fit_planes(*a, **kw), 20,
              "fit_planes", f"({a[1].numel()} reliable weak pixels of a "
              "real APD pass)")
    if real.k10 is not None:
        a, kw = real.k10
        launches = k10_launches(lambda: kern.nearest_strong(*a, **kw))
        timed(out, "K10 real pass", lambda: kern.nearest_strong(*a, **kw),
              20, "jfa", f"(a real APD pass's map, {launches} launches)",
              launches_a_call=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--weak_only", action="store_true",
                    help="time only the weak path's kernels and the "
                         "initial cost: the weak sweep's chunk, K7, K6, "
                         "the initial cost, K8, K9 and K10")
    ap.add_argument("--init_only", action="store_true",
                    help="time only the initial cost")
    ap.add_argument("--rescore_only", action="store_true",
                    help="time only K6's re-score form (both modes)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    libs = []
    weak_path = (("weak", "K6"), ("weak_sweep", "K7"), ("anchors", "K8-K10"))
    kernels = (("ncc", "K2"), ("weak", "K6"), ("select", "K11")) \
        if args.init_only else (("weak", "K6"),) if args.rescore_only \
        else weak_path if args.weak_only else (
        ("ncc", "K2"), ("sweep", "K5"), ("strong", "K3")) + weak_path
    for name, kernel in kernels:
        try:
            mod = importlib.import_module(
                f"apde_mvs_tpu_torch.ops.cuda.{name}")
            libs.append(mod.library().path.name)
        except ImportError:
            libs.append(f"no {kernel} in this checkout")
    print(f"{args.tag}: {', '.join(libs)} [{card}]", flush=True)
    out: dict = {}
    if args.init_only:
        init_times(real_pass_chunks(dev), out)
        print(json.dumps(dict(tag=args.tag, card=card, libs=libs, ms=out)))
        return 0
    if not args.weak_only:
        scene = synthetic.make_scene(num_views=VIEWS, height=HEIGHT,
                                     width=WIDTH, baseline=0.12)
        k2_times(scene, dev, out)
        k5_times(scene, dev, out)
        colour_update_times(scene, dev, out)
        del scene
    scene = apd_scene()
    wc = weak_chunk(scene, dev)
    real = real_pass_chunks(dev)
    if args.rescore_only:
        rescore_times(scene, wc, real, out)
        print(json.dumps(dict(tag=args.tag, card=card, libs=libs, ms=out)))
        return 0
    weak_times(scene, wc, real, dev, out)
    rescore_times(scene, wc, real, out)
    init_times(real, out)
    anchor_times(scene, wc, real, dev, out)
    print(json.dumps(dict(tag=args.tag, card=card, libs=libs, ms=out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
