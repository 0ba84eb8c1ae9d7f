"""Per-scan reconstruction driver — problems, pass schedule, per-view I/O
(reference: main.cpp:44-411 + APD::InuputInitialization, APD.cpp:501-685).

`run_scan` is the `APD --dense_folder ...` equivalent: it builds the problem
list from pair.txt, runs the pass schedule over all views, one view at a
time, on one device, and finishes with fusion. Only schedules without APD
passes run (round 0: images whose largest side is at most the pyramid
base); a schedule with APD passes raises before any pass runs.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config as cfg
from ..config import PYRAMID_BASE_MAX_DIM, UNKNOWN
from ..core import geometry as geo
from ..io import MemoryCache, read_bin_mat, write_bin_mat
from ..io.cameras import read_camera, read_pair
from ..io.images import (SUPPORTED_EXTS, pil_available, read_image_gray,
                         resize_bilinear, resize_nearest, scaled_size)
from ..ops.cost import CostData
from ..tools import visualize
from .patchmatch import pad_to_multiple, run_patchmatch

PAD_H = 8
PAD_W = 8


@dataclasses.dataclass
class Problem:
    """One reference view's reconstruction job (reference: main.h:102-115)."""

    ref_image_id: int
    src_image_ids: List[int]
    dense_folder: Path
    result_folder: Path
    img_ext: str
    used_time_ms: float = 0.0


def format_index(i: int) -> str:
    return f"{i:08d}"


def generate_sample_list(dense_folder) -> List[Problem]:
    """pair.txt -> problems (reference: GenerateSampleList, main.cpp:44-102)."""
    dense_folder = Path(dense_folder)
    image_folder = dense_folder / "images"
    problems = []
    for ref_id, src_ids in read_pair(dense_folder / "pair.txt"):
        ext = ""
        for cand in SUPPORTED_EXTS:
            if (image_folder / (format_index(ref_id) + cand)).exists():
                ext = cand
                break
        if not ext:
            raise FileNotFoundError(
                f"can not find image {format_index(ref_id)} in {image_folder}")
        result_folder = dense_folder / "APD" / format_index(ref_id)
        result_folder.mkdir(parents=True, exist_ok=True)
        problems.append(Problem(ref_id, src_ids, dense_folder, result_folder,
                                ext))
    return problems


def _image_path(p: Problem, view_id: int) -> Path:
    return p.dense_folder / "images" / (format_index(view_id) + p.img_ext)


def check_images(problems: Sequence[Problem],
                 cache: Optional[MemoryCache] = None) -> bool:
    """All images must share one resolution (reference: main.cpp:104-127)."""
    shapes = {read_image_gray(_image_path(p, p.ref_image_id), cache=cache).shape
              for p in problems}
    return len(shapes) <= 1


def compute_round_num(problems: Sequence[Problem],
                      cache: Optional[MemoryCache] = None,
                      base: int = PYRAMID_BASE_MAX_DIM) -> int:
    p = problems[0]
    img = read_image_gray(_image_path(p, p.ref_image_id), cache=cache)
    return cfg.compute_round_num(max(img.shape), base)


def _load_scaled_view(problem: Problem, view_id: int, scale_size: int,
                      cache) -> tuple:
    img = read_image_gray(_image_path(problem, view_id), cache=cache)
    cam = read_camera(
        problem.dense_folder / "cams" / (format_index(view_id) + "_cam.txt"),
        cache=cache)
    h, w = img.shape
    if scale_size != 1:
        nh, nw = scaled_size(h, w, scale_size)
        simg = resize_bilinear(img, (nh, nw))
        cam = cam.scaled(nw / w, nh / h, nw, nh)
    else:
        simg = img
        cam = dataclasses.replace(cam, width=w, height=h)
    return simg, cam


def process_problem(problem: Problem, spec: cfg.PassSpec,
                    cache: Optional[MemoryCache] = None,
                    seed: int = 0, device="cuda") -> None:
    """One PatchMatch pass for one view: load inputs, run the engine, persist
    results (reference: ProcessProblem, main.cpp:148-208)."""
    params = spec.params
    t0 = time.time()
    geom = params.geom_consistency

    ref_img, ref_cam = _load_scaled_view(problem, problem.ref_image_id,
                                         spec.scale_size, cache)
    src = [_load_scaled_view(problem, sid, spec.scale_size, cache)
           for sid in problem.src_image_ids]
    h, w = ref_img.shape
    depth_min = ref_cam.depth_min * cfg.DEPTH_MIN_FACTOR
    depth_max = ref_cam.depth_max * cfg.DEPTH_MAX_FACTOR

    # ---- padded device layout --------------------------------------------
    ref_p = pad_to_multiple(ref_img, PAD_H, PAD_W)
    ph, pw = ref_p.shape
    valid = np.zeros((ph, pw), bool)
    valid[:h, :w] = True
    src_imgs = np.stack([pad_to_multiple(s[0], PAD_H, PAD_W) for s in src]) \
        if src else np.zeros((0, ph, pw), np.float32)

    def _load_resized_bin(path):
        mat = read_bin_mat(path, cache=cache)
        if mat.shape[:2] != (h, w):
            mat = resize_nearest(mat, (h, w))
        return mat

    def dev(a):
        return torch.as_tensor(a, device=device)

    src_depths = None
    if geom:
        neigh = [_load_resized_bin(
            problem.dense_folder / "APD" / format_index(sid) / "depths.bin")
            for sid in problem.src_image_ids]
        src_depths = dev(np.stack(
            [pad_to_multiple(d.astype(np.float32), PAD_H, PAD_W,
                             mode="constant") for d in neigh])
            if neigh else np.zeros((0, ph, pw), np.float32))

    prior_depth = prior_normal = None
    if params.state != "first_init":
        depth = _load_resized_bin(problem.result_folder / "depths.bin")
        normal = _load_resized_bin(problem.result_folder / "normals.bin")
        prior_depth = pad_to_multiple(depth.astype(np.float32), PAD_H, PAD_W,
                                      mode="constant")
        prior_normal = pad_to_multiple(normal.astype(np.float32), PAD_H, PAD_W,
                                       mode="constant")

    cams = geo.CameraArrays.from_cameras([ref_cam] + [c for _, c in src],
                                         device=device)
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]),
        dev(ref_p.astype(np.float32)), dev(src_imgs.astype(np.float32)),
        src_depths=src_depths, real_width=w, real_height=h,
        sampler_u8=params.sampler_u8)

    pass_seed = (seed * 1000003 + problem.ref_image_id * 131 + spec.iteration)
    t_pm = time.time()
    out = run_patchmatch(
        data, params, prior_depth=prior_depth, prior_normal=prior_normal,
        valid=dev(valid), depth_min=depth_min, depth_max=depth_max,
        seed=pass_seed)
    pm_ms = (time.time() - t_pm) * 1000
    problem.used_time_ms += pm_ms

    persist_view_results(
        problem, spec, out.depth[:h, :w], out.normal[:h, :w],
        out.weak[:h, :w], out.confidence[:h, :w], depth_min, depth_max,
        geom, cache, show_medium_result=spec.show_medium_result)

    total_ms = (time.time() - t0) * 1000
    print(f"Processed view {format_index(problem.ref_image_id)} "
          f"iter {spec.iteration}: PatchMatch {pm_ms:.0f} ms, "
          f"total {total_ms:.0f} ms", flush=True)


def persist_view_results(problem: Problem, spec: cfg.PassSpec,
                         depth: np.ndarray, normal: np.ndarray,
                         weak: np.ndarray, confidence: np.ndarray,
                         depth_min: float, depth_max: float,
                         geom: bool, cache,
                         show_medium_result: bool = False) -> None:
    """Range-clamp + persist one view's pass outputs (already cropped to the
    real resolution) (reference: main.cpp:168-190). The .jpg previews need
    PIL; without it they are skipped with one printed line."""
    depth = depth.astype(np.float32)
    normal = normal.astype(np.float32)
    weak = weak.astype(np.uint8)
    out_of_range = (depth < depth_min) | (depth > depth_max)
    depth = np.where(out_of_range, 0.0, depth)
    weak = np.where(out_of_range, np.uint8(UNKNOWN), weak)

    write_bin_mat(problem.result_folder / "depths.bin", depth, cache=cache)
    write_bin_mat(problem.result_folder / "normals.bin", normal, cache=cache)
    write_bin_mat(problem.result_folder / "weak.bin", weak, cache=cache)
    if geom:
        write_bin_mat(problem.result_folder / "confidence.bin", confidence,
                      cache=cache)

    if show_medium_result:
        it = spec.iteration
        if pil_available():
            visualize.show_depth_map(
                problem.result_folder / f"depth_{it}.jpg", depth, depth_min,
                depth_max)
            visualize.show_normal_map(
                problem.result_folder / f"normal_{it}.jpg", normal)
        else:
            print(f"PIL not available: no depth_{it}.jpg / normal_{it}.jpg "
                  f"preview for view {format_index(problem.ref_image_id)}",
                  flush=True)
        visualize.show_weak_image(
            problem.result_folder / f"weak_{it}.png", weak)
        if geom:
            visualize.show_confidence_map(
                problem.result_folder / f"confidence_{it}.png", confidence)


def run_scan(dense_folder, dataset: str = "General", *,
             device="cuda",
             only_fuse: bool = False, no_fuse: bool = False,
             use_memory_cache: bool = True, use_sa: bool = True,
             use_impetus: bool = True, weak_filter: bool = True,
             flush: bool = False, export_color: bool = True,
             seed: int = 0, pyramid_base: int = PYRAMID_BASE_MAX_DIM,
             sampler_u8: bool = True, start_iteration: int = 0) -> None:
    """Full scan reconstruction (reference: main.cpp:210-411), serially over
    views on ``device``.

    ``start_iteration``: skip schedule passes below this iteration index
    (per-view bins are the checkpoint; every non-first pass rebuilds its
    state from disk)."""
    from .fusion import run_fusion

    device = torch.device(device)
    dense_folder = Path(dense_folder)
    (dense_folder / "APD").mkdir(exist_ok=True)
    cache = MemoryCache() if use_memory_cache and not only_fuse else None
    problems = generate_sample_list(dense_folder)
    if not check_images(problems, cache):
        raise RuntimeError("Images may error, check it!")
    print(f"There are {len(problems)} problems to be processed", flush=True)

    fusion_params = cfg.FusionParams(
        variant={"TaT_a": "tat_a", "TaT_i": "tat_i"}.get(dataset, "general"),
        weak_filter=weak_filter)
    if only_fuse:
        run_fusion(dense_folder, problems, "APD.ply", fusion_params,
                   export_color=export_color, cache=cache, device=device)
        return

    round_num = compute_round_num(problems, cache, base=pyramid_base)
    print(f"Round nums: {round_num}", flush=True)
    p0 = problems[0]
    img0 = read_image_gray(_image_path(p0, p0.ref_image_id), cache=cache)
    schedule = cfg.build_schedule(max(img0.shape), dataset, use_sa=use_sa,
                                  use_impetus=use_impetus, base=pyramid_base,
                                  sampler_u8=sampler_u8)
    apd = [s.iteration for s in schedule if s.params.use_apd]
    if apd:
        raise NotImplementedError(
            f"the schedule has {round_num} rounds; passes {apd} are APD "
            "passes, which belong to the APD slice of the port (not ported "
            f"yet). Raise --pyramid_base to at least {max(img0.shape)} for "
            "a single-round run")

    t0 = time.time()
    for spec in schedule:
        if spec.iteration < start_iteration:
            print(f"======== iteration {spec.iteration} skipped "
                  f"(resume from {start_iteration}) ========", flush=True)
            continue
        print(f"======== iteration {spec.iteration} (round {spec.round_index},"
              f" scale 1/{spec.scale_size}, {spec.params.state}) ========",
              flush=True)
        t_pass = time.time()
        for problem in problems:
            process_problem(problem, spec, cache=cache, seed=seed,
                            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"Pass {spec.iteration} ({spec.params.state}) wall "
              f"{time.time() - t_pass:.3f} s", flush=True)
    print(f"Cost time: {(time.time() - t0) * 1000:.0f} ms", flush=True)
    avg = np.mean([p.used_time_ms for p in problems]) if problems else 0
    print(f"Average used time: {avg:.0f} ms", flush=True)

    if cache is not None and flush:
        cache.flush()
    if no_fuse:
        print("Skip fusion, all done!", flush=True)
        return
    t_fuse = time.time()
    run_fusion(dense_folder, problems, "APD.ply", fusion_params,
               export_color=export_color, cache=cache, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"Fusion wall {time.time() - t_fuse:.3f} s", flush=True)
    print("All done", flush=True)
