"""Device times of K2, K5 and the strong sweep's colour update (K3) at the
main path's shapes, for comparing two checkouts of the port on one card.

The shapes are chip_smoke.py's, on view 0 of the 11-view 600x800 synthetic
scene (seed 0), u8 quad tables:

- K2 at the strong shape (10 sources x 240,000 black pixels, ground-truth
  planes, the 36-tap square window), at a tile-route rank's halo row block
  (10 x 120,000) and at the classify chunk (10 x 65,536, depths 2% off);
- K5 at the classify chunk (10 x 65,536 pixels, 61 probes, geometric cost)
  and in refine mode (12 probes), over near-truth planes with each pixel's
  top-k views of K2's costs selected and weighted 1-4; and with every view
  weighted;
- both at S = 32: the 10 sources cycled into 32 (K2 at the strong shape;
  K5 at the classify chunk with the weights cycled the same way, so the
  same share of pairs is weighted);
- the strong sweep's colour update, ``propagation._strong_body``, at the
  black pixels of view 0 (10 x 240,000, geometric cost, iteration 2) over
  the same near-truth planes as camera-frame planes, their top-k mean
  costs and views: K3 in a checkout that has it, the torch-op body (14 K2
  launches and ~100 torch ops) in one from before.

Each time is the mean over back-to-back launches after a warm-up (CUDA
events). The script imports the package by absolute name, so it times the
checkout found first on ``sys.path``: run it from another checkout's root
with that root on ``PYTHONPATH`` to time that checkout's kernels.

    python -m apde_mvs_tpu_torch.tools.kernel_times [--tag NAME]
    cd OTHER && PYTHONPATH=$PWD python /path/to/kernel_times.py --tag other

Needs a CUDA device. The last line is one JSON object: the tag, the card,
the libraries' file names and the times in ms.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from apde_mvs_tpu_torch import config as cfg
from apde_mvs_tpu_torch.core import checkerboard as cb
from apde_mvs_tpu_torch.core import geometry as geo
from apde_mvs_tpu_torch.core.platform import card_line
from apde_mvs_tpu_torch.ops import filters
from apde_mvs_tpu_torch.ops.cost import (CostData, contiguous_window,
                                         initial_cost_and_selection,
                                         ncc_strong, precompute_ref_window)
from apde_mvs_tpu_torch.ops.cuda import ncc, sweep
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.parallel.tiles import HALO_ROWS, halo_block
from apde_mvs_tpu_torch.pipeline.full_pass import CHUNK, MIN_MARGIN
from apde_mvs_tpu_torch.testing import synthetic

HEIGHT, WIDTH, VIEWS = 600, 800, 11
CYCLED = 32


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
        planes=planes, selected=sel.reshape(H, W, S),
        view_weights=vw.reshape(H, W, S))
    del costs
    margin = (xs < MIN_MARGIN) | (ys < MIN_MARGIN) \
        | (xs >= W - MIN_MARGIN) | (ys >= H - MIN_MARGIN)
    cy, cx = torch.nonzero(~margin, as_tuple=True)
    cx, cy = cx[:CHUNK].to(torch.int32), cy[:CHUNK].to(torch.int32)
    xf, yf = cx.float(), cy.float()
    sc = filters._sweep_scalars(data, state, cx, cy)
    px = sweep.SweepPixels(xf, yf, sc.plane_cam.contiguous(), sc.disp,
                           sc.base_line, sc.vw.contiguous(), sc.wnorm)
    win = contiguous_window(precompute_ref_window(data, xf, yf, 5, 2))
    every = px._replace(vw=torch.ones_like(px.vw),
                        wnorm=torch.full_like(px.wnorm, S))
    d32, idx = cycled_views(data, CYCLED)
    vw32 = px.vw[:, idx].contiguous()
    px32 = px._replace(vw=vw32, wnorm=vw32.sum(-1))

    def kw(refine):
        return dict(refine=refine, geom=True, geom_factor=params.geom_factor,
                    depth_min=dmin, depth_max=dmax)

    for name, d, p, refine, iters in (
            ("K5 classify", data, px, False, 20),
            ("K5 refine", data, px, True, 50),
            ("K5 classify every view", data, every, False, 10),
            ("K5 refine every view", data, every, True, 20),
            ("K5 classify S=32", d32, px32, False, 10)):
        out[name] = cuda_ms(lambda: sweep.sweep_fused(d, p, win, **kw(refine)),
                            iters)
        share = float((p.vw != 0).float().mean())
        print(f"{name}: {out[name]:.4f} ms ({d.num_src} views x "
              f"{p.x.numel()} pixels, {share:.3f} of the pairs weighted)",
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
    prop = propagation.PropCfg(geom_consistency=True)
    dmin, dmax, gf = (float(np.float32(v)) for v in (
        scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR,
        scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR,
        params.geom_factor))
    name = "colour update"
    out[name] = cuda_ms(lambda: propagation._strong_body(
        data, state, prop, 2, draws, x, y, dmin, dmax, gf), 10)
    print(f"{name}: {out[name]:.4f} ms ({S} views x {x.numel()} pixels, "
          "geometric)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    libs = [m.library().path.name for m in (ncc, sweep)]
    try:
        from apde_mvs_tpu_torch.ops.cuda import strong
        libs.append(strong.library().path.name)
    except ImportError:
        libs.append("no K3 in this checkout")
    print(f"{args.tag}: {', '.join(libs)} [{card}]", flush=True)
    scene = synthetic.make_scene(num_views=VIEWS, height=HEIGHT, width=WIDTH,
                                 baseline=0.12)
    out: dict = {}
    k2_times(scene, dev, out)
    k5_times(scene, dev, out)
    colour_update_times(scene, dev, out)
    print(json.dumps(dict(tag=args.tag, card=card, libs=libs, ms=out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
