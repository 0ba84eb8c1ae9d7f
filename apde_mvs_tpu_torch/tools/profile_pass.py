"""Where one view's PatchMatch pass spends its device time.

Two passes of view 0 of a synthetic 600x800 scan can be profiled, each
after one warm-up run, under torch.profiler:

- ``--pass round0`` (default): one FIRST_INIT and one REFINE_ITER pass on
  the round-0 scan chip_smoke.py runs. The REFINE_ITER pass gets the
  ground-truth depth/normal maps as its priors and source depths, so it
  does the work of a real geometric pass without running the whole scan.
- ``--pass apd``: one APD REFINE_INIT pass (round 1's parameters) on the
  APD scan chip_smoke.py runs (a nearly textureless plane, its SA mask).
  Its priors come from a FIRST_INIT pass of the same view at full size, run
  once beforehand, as benchmarks/fullres_stress.py takes them; source
  depths are the ground truth.

Per pass it prints host wall, device busy time (sum of kernel and copy
time) and idle share, the wall of the same pass run without the profiler
(just before), the device time (CUDA events around each launch) and
launches of the fused strong NCC K2 by call site (the initial cost), of
the strong sweep's colour update K3, of the fused disparity sweep K5 by
mode (classify, refine), of the weak sweep's chunk update K7, of the
deformable NCC K6 by use (on the main path only the initial cost's
re-score form), of the initial cost's K2 stage form and K6 re-score form
with the selection in their epilogues (the serial route's) and of the
selection K11 where it runs (the tile route), of the APD setup's
K10 (the nearest-strong flooding), K8 (anchor generation) and K9 (the
fit-plane RANSAC) and of K1 by call site, each kernel's profiler time,
the device and host time of the pass's stages (anchors, fit planes, the
initial cost, the weak sweep, the classify and refine sweeps, ...), and
the torch ops that hold the most device time.

    python -m apde_mvs_tpu_torch.tools.profile_pass [--pass round0|apd]
        [--views 11] [--top 15]

The scan is 600x800; only the number of views may be cut, and a cut is
printed.

Needs a CUDA device. The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time

import numpy as np
import torch

from .. import config as cfg
from ..core import geometry as geo
from ..core.platform import card_line
from ..ops import anchors, filters, init
from ..ops.cost import CostData
from ..ops.cuda import anchors as kanchors
from ..ops.cuda import ncc, sampler, strong, sweep, weak, weak_sweep
from ..ops.cuda import select as k11
from ..pipeline import full_pass, patchmatch
from ..testing import synthetic

HEIGHT, WIDTH = 600, 800
FULL_VIEWS = 11
# the APD scan of chip_smoke.py: the scene benchmarks/fullres_stress.py
# measures the APD pass on, and the pyramid base that makes 600x800 round 1
APD_BASE = 400
WEAK_REGION = (-0.3, 0.3, -0.2, 0.2)

# (module, attribute, label): the stages whose device time is reported,
# each wrapped in a profiler range while this tool runs
_STAGES = (
    (anchors, "nearest_strong_jfa", "nearest_strong_jfa"),
    (anchors, "gen_anchors", "gen_anchors"),
    (anchors, "ransac_fit_planes", "ransac_fit_planes"),
    (init, "initial_cost", "initial_cost"),
    (full_pass, "propagate_strong", "propagate_strong"),
    (full_pass, "propagate_weak", "propagate_weak"),
    (filters, "depth_to_weak", "depth_to_weak"),
    (filters, "local_refine", "local_refine"),
)


def _device_time_us(evt, inclusive: bool = False) -> float:
    names = ("device_time_total", "cuda_time_total") if inclusive else (
        "self_device_time_total", "self_cuda_time_total")
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _labelled(fn, label):
    @functools.wraps(fn)
    def run(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return run


def _event_timed(fn, events: dict, name_of):
    """``fn`` with a pair of CUDA events around each call, kept under
    ``name_of(args, kwargs)`` (the kernel and its call site or mode): the
    profiler does not tie a kernel launched through ctypes to the range it
    was launched in."""
    @functools.wraps(fn)
    def run(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        events.setdefault(name_of(a, kw), []).append((start, end))
        return out
    return run


def _k1_site(a, kw):
    return kw.get("site", "other")


def _k2_site(a, kw):
    return "K2 " + (a[5] if len(a) > 5 else kw.get("site", "other"))


def _k5_mode(a, kw):
    return "K5 " + ("refine" if kw["refine"] else "classify")


def _k3_name(a, kw):
    return "K3 colour update"


def _anchor_kernel(name):
    return lambda a, kw: name


def _k7_name(a, kw):
    return "K7 chunk update"


def _k6_use(a, kw):
    if kw.get("view_weights") is not None:
        return "K6 probes"
    return "K6 re-score" if a[2].shape[1] == 1 else "K6 candidates"


def _named(name):
    return lambda a, kw: name


@contextlib.contextmanager
def stage_ranges(kernel_events: dict):
    """Wrap every stage of `_STAGES` in a named profiler range, and time
    K2 and K1 (by call site; K2's stage form apart, with the selection
    and without), K3, K5 (by mode), K6 (by use; its re-score form apart,
    with the selection and without), K7, K11 and K8-K10 into
    ``kernel_events``; restore the plain functions afterwards."""
    kernels = ((sampler, "sample_packed", _k1_site),
               (ncc, "ncc_strong_fused", _k2_site),
               (strong, "strong_fused", _k3_name),
               (sweep, "sweep_fused", _k5_mode),
               (sweep, "stage_fused", _k5_mode),
               (ncc, "init_stage_fused", _named("K2 init stage form")),
               (ncc, "init_stage_select_fused",
                _named("K2 init stage form with the selection")),
               (weak, "weak_fused", _k6_use),
               (weak, "rescore_fused", _named("K6 re-score form")),
               (weak, "rescore_select_fused",
                _named("K6 re-score form with the selection")),
               (k11, "select_fused", _named("K11 selection")),
               (weak_sweep, "weak_update_fused", _k7_name),
               (kanchors, "nearest_strong", _anchor_kernel("K10 flooding")),
               (kanchors, "gen_anchors", _anchor_kernel("K8 anchors")),
               (kanchors, "fit_planes", _anchor_kernel("K9 fit planes")))
    saved = [(m, a, getattr(m, a)) for m, a, _ in _STAGES + kernels]
    try:
        for m, a, label in _STAGES:
            setattr(m, a, _labelled(getattr(m, a), label))
        for m, a, name_of in kernels:
            setattr(m, a, _event_timed(getattr(m, a), kernel_events,
                                       name_of))
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def profile_pass(data, params, prior, dmin, dmax, top: int) -> dict:
    def run():
        out = run_patchmatch_with(data, params, prior, dmin, dmax)
        torch.cuda.synchronize()
        return out

    run()                                                  # warm-up
    t0 = time.perf_counter()
    run()
    plain_wall = time.perf_counter() - t0
    for mod in (sampler, ncc, strong, sweep, weak, weak_sweep, k11,
                kanchors):
        mod.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    labels = {label for _, _, label in _STAGES}
    kernel_events = {}
    with stage_ranges(kernel_events):
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            run()
        wall = time.perf_counter() - t0
    launches = sampler.launches
    sites = {site: len(ev) for site, ev in kernel_events.items()}
    kernels, ops, stages, stages_host = {}, {}, {}, {}
    for evt in prof.key_averages():
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.key in labels:
            if not on_device:
                stages[evt.key] = _device_time_us(evt, inclusive=True) / 1e6
                stages_host[evt.key] = evt.cpu_time_total / 1e6
            continue
        t = _device_time_us(evt)
        if t <= 0:
            continue
        if on_device:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + t
        elif evt.key.startswith("aten::"):
            ops[evt.key] = ops.get(evt.key, 0.0) + t
    busy = sum(kernels.values()) / 1e6
    k1 = sum(t for k, t in kernels.items() if "sample_" in k
             and "kernel" in k and ("packed" in k or "image" in k)) / 1e6
    k2 = sum(t for k, t in kernels.items() if "ncc_strong_kernel" in k
             or "ncc_stage_kernel" in k) / 1e6
    k5 = sum(t for k, t in kernels.items() if "sweep_kernel" in k) / 1e6
    k3 = sum(t for k, t in kernels.items() if "strong_kernel" in k
             and "ncc_strong" not in k) / 1e6
    k6 = sum(t for k, t in kernels.items() if "weak_kernel" in k) / 1e6
    k7 = sum(t for k, t in kernels.items() if "weak_update_kernel" in k) / 1e6
    k11_s = sum(t for k, t in kernels.items()
                if "topk_select_kernel" in k) / 1e6
    anchor = {name: sum(t for k, t in kernels.items() if kernel in k) / 1e6
              for name, kernel in (("k8_s", "gen_anchors"),
                                   ("k9_s", "fit_planes"),
                                   ("k10_s", "jfa_"))}
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    sites_s = {site: sum(s.elapsed_time(e) for s, e in ev) / 1e3
               for site, ev in kernel_events.items()}
    return dict(state=params.state, use_apd=bool(params.use_apd),
                wall_s=wall, device_busy_s=busy,
                idle_share=max(0.0, 1.0 - busy / wall),
                unprofiled_wall_s=plain_wall,
                unprofiled_idle_share=max(0.0, 1.0 - busy / plain_wall),
                k1_s=k1, k2_s=k2, k2_launches=ncc.launches, k3_s=k3,
                k3_launches=strong.launches, k5_s=k5,
                k5_launches=sweep.launches, k6_s=k6,
                k6_launches=weak.launches, k7_s=k7,
                k7_launches=weak_sweep.launches, k11_s=k11_s,
                k11_launches=k11.launches, **anchor,
                k8_launches=kanchors.anchor_launches,
                k9_launches=kanchors.fit_launches,
                k10_launches=kanchors.jfa_launches, k1_launches=launches,
                site_launches=sites,
                site_event_s={k: round(v, 6) for k, v in sites_s.items()},
                stage_device_s={k: round(v, 6) for k, v in sorted(
                    stages.items(), key=lambda kv: -kv[1])},
                stage_host_s={k: round(v, 6) for k, v in stages_host.items()},
                top_ops=[(k, round(t / 1e6, 6)) for k, t in top_ops])


def run_patchmatch_with(data, params, prior, dmin, dmax):
    return patchmatch.run_patchmatch(data, params, depth_min=dmin,
                                     depth_max=dmax, seed=1, **prior)


def _report(r, card):
    print(f"{r['state']}{' (APD)' if r['use_apd'] else ''}: wall "
          f"{r['wall_s']:.3f} s, device busy {r['device_busy_s']:.3f} s "
          f"(idle {r['idle_share']:.1%}), K2 {r['k2_s']:.3f} s over "
          f"{r['k2_launches']} launches, K3 {r['k3_s']:.3f} s over "
          f"{r['k3_launches']} launches, K5 {r['k5_s']:.3f} s over "
          f"{r['k5_launches']} launches, K6 {r['k6_s']:.3f} s over "
          f"{r['k6_launches']} launches, K7 {r['k7_s']:.4f} s over "
          f"{r['k7_launches']} launches, K11 {r['k11_s']:.4f} s over "
          f"{r['k11_launches']} launches, K8 {r['k8_s']:.4f} s over "
          f"{r['k8_launches']} launches, K9 {r['k9_s']:.4f} s over "
          f"{r['k9_launches']} launches, K10 {r['k10_s']:.4f} s over "
          f"{r['k10_launches']} launches, K1 {r['k1_s']:.3f} s over "
          f"{r['k1_launches']} launches (profiler kernel time) [{card}]",
          flush=True)
    for site, t in r["site_event_s"].items():
        calls = r["site_launches"].get(site, 0)
        kernel = site.split()[0] if site[0] == "K" else "K1"
        print(f"  {kernel:<5} {t:9.4f} s  {site}: {calls} calls, "
              f"{t / max(calls, 1) * 1e3:.4f} ms a call (CUDA events)")
    print(f"  unprofiled: wall {r['unprofiled_wall_s']:.3f} s, idle "
          f"{r['unprofiled_idle_share']:.1%} against the same device busy")
    for k, t in r["stage_device_s"].items():
        print(f"  stage {t:9.4f} s device, {r['stage_host_s'][k]:9.4f} s "
              f"host  {k}")
    for k, t in r["top_ops"]:
        print(f"  op    {t:9.4f} s  {k}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pass", dest="which", choices=("round0", "apd"),
                    default="round0")
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
    apd = args.which == "apd"
    scene = synthetic.make_scene(
        num_views=args.views, height=HEIGHT, width=WIDTH, baseline=0.12,
        **(dict(focal=1.25 * WIDTH, weak_region=WEAK_REGION) if apd else {}))
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=dev)
    imgs = torch.as_tensor(scene.images, device=dev)
    region = scene.depths[0] < scene.depths[0].mean() * 0.95
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]), imgs[0], imgs[1:],
        src_depths=torch.as_tensor(scene.depths[1:], device=dev),
        sampler_u8=True,
        sa_mask=torch.as_tensor(region, device=dev) if apd else None)
    schedule = cfg.build_schedule(max(HEIGHT, WIDTH), "General",
                                  base=APD_BASE if apd
                                  else cfg.PYRAMID_BASE_MAX_DIM)
    dmin = scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR
    card = card_line()
    print(f"card: {card}", flush=True)
    if apd:
        first = run_patchmatch_with(data, schedule[0].params, {}, dmin, dmax)
        prior = dict(prior_depth=first.depth, prior_normal=first.normal,
                     prior_weak=first.weak.astype(np.int32),
                     prior_confidence=first.confidence.astype(np.float32))
        n_weak = int((first.weak == cfg.WEAK).sum())
        print(f"prior weak (FIRST_INIT): {n_weak} / {first.weak.size} = "
              f"{n_weak / first.weak.size:.1%}", flush=True)
        runs = [(next(s for s in schedule
                      if s.params.state == "refine_init"), prior)]
    else:
        runs = [(schedule[0], {}),
                (schedule[1], dict(prior_depth=scene.depths[0],
                                   prior_normal=scene.normals[0]))]
    results = []
    for spec, prior in runs:
        r = profile_pass(data, spec.params, prior, dmin, dmax, args.top)
        results.append(r)
        _report(r, card)
    print(json.dumps({"card": card, "views": args.views, "pass": args.which,
                      "shape": [HEIGHT, WIDTH], "passes": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
