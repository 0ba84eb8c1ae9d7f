"""Where one view's PatchMatch pass spends its device time.

Runs one FIRST_INIT and one REFINE_ITER pass of view 0 of a synthetic scan
(the shape chip_smoke.py uses) under torch.profiler, after one warm-up
pass each, and prints per pass: host wall, device busy time (sum of kernel
and copy time) and idle share, the device time of K1, and the torch ops
that hold the most device time. The REFINE_ITER pass gets the ground-truth
depth/normal maps as its priors and source depths, so it does the work of a
real geometric pass without running the whole scan first.

    python -m apde_mvs_tpu_torch.tools.profile_pass [--views 11] [--top 15]

The scan is 600x800; only the number of views may be cut, and a cut is
printed.

Needs a CUDA device. The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import config as cfg
from ..core import geometry as geo
from ..core.platform import card_line
from ..ops.cost import CostData
from ..ops.cuda import sampler
from ..pipeline.patchmatch import run_patchmatch
from ..testing import synthetic

HEIGHT, WIDTH = 600, 800
FULL_VIEWS = 11


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_pass(data, params, prior, dmin, dmax, top: int) -> dict:
    def run():
        out = run_patchmatch(data, params, prior_depth=prior[0],
                             prior_normal=prior[1], depth_min=dmin,
                             depth_max=dmax, seed=1)
        torch.cuda.synchronize()
        return out

    run()                                                  # warm-up
    sampler.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
    wall = time.perf_counter() - t0
    launches = sampler.launches
    kernels, ops = {}, {}
    for evt in prof.key_averages():
        t = _device_time_us(evt)
        if t <= 0:
            continue
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t
        elif evt.key.startswith("aten::"):
            ops[evt.key] = ops.get(evt.key, 0.0) + t
    busy = sum(kernels.values()) / 1e6
    k1 = sum(t for k, t in kernels.items() if "sample_" in k
             and "kernel" in k and ("packed" in k or "image" in k)) / 1e6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return dict(state=params.state, wall_s=wall, device_busy_s=busy,
                idle_share=max(0.0, 1.0 - busy / wall), k1_s=k1,
                k1_launches=launches,
                top_ops=[(k, round(t / 1e6, 6)) for k, t in top_ops])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=FULL_VIEWS)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not 2 <= args.views <= FULL_VIEWS:
        ap.error(f"--views must be in 2..{FULL_VIEWS}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_pass needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.views < FULL_VIEWS:
        print(f"REDUCED: {args.views} views instead of {FULL_VIEWS}; width "
              "and height kept", flush=True)
    scene = synthetic.make_scene(num_views=args.views, height=HEIGHT,
                                 width=WIDTH, baseline=0.12)
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]), imgs[0], imgs[1:],
        src_depths=torch.as_tensor(scene.depths[1:], device=dev),
        sampler_u8=True)
    schedule = cfg.build_schedule(max(HEIGHT, WIDTH), "General")
    dmin = scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR
    card = card_line()
    print(f"card: {card}", flush=True)
    results = []
    for spec, prior in ((schedule[0], (None, None)),
                        (schedule[1], (scene.depths[0], scene.normals[0]))):
        r = profile_pass(data, spec.params, prior, dmin, dmax, args.top)
        results.append(r)
        print(f"{r['state']}: wall {r['wall_s']:.3f} s, device busy "
              f"{r['device_busy_s']:.3f} s (idle {r['idle_share']:.1%}), K1 "
              f"{r['k1_s']:.3f} s over {r['k1_launches']} launches [{card}]")
        for k, t in r["top_ops"]:
            print(f"  {t:9.4f} s  {k}")
    print(json.dumps({"card": card, "views": args.views,
                      "shape": [HEIGHT, WIDTH],
                      "passes": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
