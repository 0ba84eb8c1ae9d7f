"""Per-scan reconstruction driver — problems, pass schedule, per-view I/O
(reference: main.cpp:44-411 + APD::InuputInitialization, APD.cpp:501-685).

`run_scan` is the `APD --dense_folder ...` equivalent: it builds the problem
list from pair.txt, runs the coarse-to-fine pass schedule over all views,
one view at a time on one device or split over the ranks of a process
group (`pipeline.scan_parallel`), and finishes with fusion. On the last
pass it can write the reference's debug exports (anchors, anchors map,
nearest-strong and fit-normal images, reliability curves).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import config as cfg
from ..config import PYRAMID_BASE_MAX_DIM, UNKNOWN, WEAK
from ..core import geometry as geo
from ..core import spans
from ..io import MemoryCache, read_bin_mat, write_bin_mat
from ..io.cameras import read_camera, read_pair
from ..io.images import (SUPPORTED_EXTS, pil_available, read_image_gray,
                         resize_bilinear, resize_nearest, scaled_size,
                         write_image)
from ..ops.cost import CostData
from ..ops.cuda import anchors as anchor_kernels
from ..ops.cuda import ncc, sampler, strong, sweep, weak, weak_sweep
from ..ops.cuda import select as select_kernel
from ..tools import visualize
from .patchmatch import pad_to_multiple, run_patchmatch

PAD_H = 8
PAD_W = 8
# source views a problem may have: the NCC kernels' limit
MAX_VIEWS = ncc.MAX_VIEWS


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
    """pair.txt -> problems (reference: GenerateSampleList, main.cpp:44-102).
    A problem with more than ``MAX_VIEWS`` source views fails here, before
    any folder is made or image read: the NCC kernels run a view a lane of
    one warp."""
    dense_folder = Path(dense_folder)
    image_folder = dense_folder / "images"
    pairs = read_pair(dense_folder / "pair.txt")
    for ref_id, src_ids in pairs:
        if len(src_ids) > MAX_VIEWS:
            raise ValueError(
                f"reference view {ref_id} has {len(src_ids)} source views in "
                f"pair.txt; the port takes at most {MAX_VIEWS} a problem")
    problems = []
    for ref_id, src_ids in pairs:
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


class ViewInputs(NamedTuple):
    """One view's pass inputs at the padded device layout."""

    data: CostData
    valid: torch.Tensor          # (ph, pw) real-pixel mask
    h: int                       # real (unpadded) size
    w: int
    depth_min: float
    depth_max: float
    priors: dict                 # run_patchmatch's prior_* keywords


def load_view(problem: Problem, spec: cfg.PassSpec, cache=None,
              device="cuda", src_depths=None) -> ViewInputs:
    """Load one view's pass inputs (reference: InuputInitialization,
    APD.cpp:501-685): the scaled reference and source images, cameras,
    the sources' current depths (geometric / APD passes), the SA mask and
    the view's own priors, padded to a multiple of (PAD_H, PAD_W).
    ``src_depths`` ((S, ph, pw) on ``device``) replaces the sources' depth
    files on geometric / APD passes (the view-parallel engine's exchanged
    depths)."""
    with spans.span(spans.LOAD_VIEW):
        params = spec.params
        use_apd = params.use_apd and params.state != "first_init"
        geom_or_apd = params.geom_consistency or params.use_apd

        ref_img, ref_cam = _load_scaled_view(problem, problem.ref_image_id,
                                             spec.scale_size, cache)
        src = [_load_scaled_view(problem, sid, spec.scale_size, cache)
               for sid in problem.src_image_ids]
        h, w = ref_img.shape
        depth_min = ref_cam.depth_min * cfg.DEPTH_MIN_FACTOR
        depth_max = ref_cam.depth_max * cfg.DEPTH_MAX_FACTOR

        # ---- padded device layout ----------------------------------------
        ref_p = pad_to_multiple(ref_img, PAD_H, PAD_W)
        ph, pw = ref_p.shape
        valid = np.zeros((ph, pw), bool)
        valid[:h, :w] = True
        src_imgs = np.stack([pad_to_multiple(s[0], PAD_H, PAD_W)
                             for s in src]) \
            if src else np.zeros((0, ph, pw), np.float32)

        def _load_resized_bin(path):
            mat = read_bin_mat(path, cache=cache)
            if mat.shape[:2] != (h, w):
                mat = resize_nearest(mat, (h, w))
            return mat

        def dev(a):
            return torch.as_tensor(a, device=device)

        if not geom_or_apd:
            src_depths = None
        elif src_depths is None:
            neigh = [_load_resized_bin(problem.dense_folder / "APD"
                                       / format_index(sid) / "depths.bin")
                     for sid in problem.src_image_ids]
            src_depths = dev(np.stack(
                [pad_to_multiple(d.astype(np.float32), PAD_H, PAD_W,
                                 mode="constant") for d in neigh])
                if neigh else np.zeros((0, ph, pw), np.float32))

        sa_mask = None
        if use_apd and params.use_sa:
            sa_path = problem.dense_folder / "sa_masks" / \
                (format_index(problem.ref_image_id) + ".bin")
            if sa_path.exists():
                sa = _load_resized_bin(sa_path).astype(np.int32)
                sa_mask = dev(pad_to_multiple(sa, PAD_H, PAD_W,
                                              mode="constant"))

        priors = {}
        if params.state != "first_init":
            depth = _load_resized_bin(problem.result_folder / "depths.bin")
            normal = _load_resized_bin(problem.result_folder / "normals.bin")
            priors["prior_depth"] = pad_to_multiple(
                depth.astype(np.float32), PAD_H, PAD_W, mode="constant")
            priors["prior_normal"] = pad_to_multiple(
                normal.astype(np.float32), PAD_H, PAD_W, mode="constant")
        if use_apd:
            weak = _load_resized_bin(problem.result_folder / "weak.bin")
            conf = _load_resized_bin(problem.result_folder / "confidence.bin")
            n_weak = int((weak == WEAK).sum())
            print(f"Weak count: {n_weak} / {weak.size} = "
                  f"{n_weak / weak.size * 100:.1f}%", flush=True)
            priors["prior_weak"] = pad_to_multiple(
                weak.astype(np.int32), PAD_H, PAD_W, mode="constant")
            priors["prior_confidence"] = pad_to_multiple(
                conf.astype(np.float32), PAD_H, PAD_W, mode="constant")

        cams = geo.CameraArrays.from_cameras([ref_cam] + [c for _, c in src],
                                             device=device)
        data = CostData.build(
            cams.view(0), cams.map(lambda a: a[1:]),
            dev(ref_p.astype(np.float32)), dev(src_imgs.astype(np.float32)),
            src_depths=src_depths, real_width=w, real_height=h,
            sampler_u8=params.sampler_u8, sa_mask=sa_mask)
        return ViewInputs(data, dev(valid), h, w, depth_min, depth_max, priors)


def pass_seed(seed: int, ref_image_id: int, iteration: int) -> int:
    """The seed of one view's pass generator: a function of the view and
    the pass only, so every engine and every placement draws the same."""
    return seed * 1000003 + ref_image_id * 131 + iteration


def process_problem(problem: Problem, spec: cfg.PassSpec,
                    cache: Optional[MemoryCache] = None,
                    seed: int = 0, device="cuda",
                    export_anchor: bool = False,
                    export_curve: bool = False) -> None:
    """One PatchMatch pass for one view: load inputs, run the engine, persist
    results (reference: ProcessProblem, main.cpp:148-208). ``export_anchor``
    / ``export_curve`` also write the debug exports of an APD pass."""
    params = spec.params
    t0 = time.time()
    geom_or_apd = params.geom_consistency or params.use_apd
    vi = load_view(problem, spec, cache, device)
    h, w = vi.h, vi.w

    t_pm = time.time()
    out = run_patchmatch(
        vi.data, params, **vi.priors, valid=vi.valid,
        depth_min=vi.depth_min, depth_max=vi.depth_max,
        seed=pass_seed(seed, problem.ref_image_id, spec.iteration),
        export_curve=export_curve, export_debug=export_anchor)
    pm_ms = (time.time() - t_pm) * 1000
    problem.used_time_ms += pm_ms

    persist_view_results(
        problem, spec, out.depth[:h, :w], out.normal[:h, :w],
        out.weak[:h, :w], out.confidence[:h, :w], vi.depth_min,
        vi.depth_max, geom_or_apd, cache,
        show_medium_result=spec.show_medium_result)

    if export_anchor and out.anchors is not None:
        write_bin_mat(problem.result_folder / "anchors_map.bin",
                      out.anchors_map[:h, :w], cache=None)
        _write_anchors(problem.result_folder / "anchors.bin", out.anchors)
        _export_nearest_strong(
            problem.result_folder / f"nearest_strong_{spec.iteration}.png",
            out.nearest_strong[:h, :w])
        _write_fit_normal(
            problem.result_folder / f"fit_normal_{spec.iteration}.png",
            out.anchors_map[:h, :w], out.fit_normal)
    if export_curve and out.reliable_curve is not None:
        _write_reliable_curve(problem.result_folder / "reliable_curve.bin",
                              out.reliable_curve[:h, :w])

    total_ms = (time.time() - t0) * 1000
    print(f"Processed view {format_index(problem.ref_image_id)} "
          f"iter {spec.iteration}: PatchMatch {pm_ms:.0f} ms, "
          f"total {total_ms:.0f} ms", flush=True)


def persist_view_results(problem: Problem, spec: cfg.PassSpec,
                         depth: np.ndarray, normal: np.ndarray,
                         weak: np.ndarray, confidence: np.ndarray,
                         depth_min: float, depth_max: float,
                         geom: bool, cache,
                         show_medium_result: bool = False,
                         write_files: bool = True) -> None:
    """Range-clamp + persist one view's pass outputs (already cropped to the
    real resolution) (reference: main.cpp:168-190). The .jpg previews need
    PIL; without it they are skipped with one printed line.
    ``write_files=False`` updates only ``cache`` (a tile-route rank that
    holds the view's maps but does not own its files)."""
    if not write_files and cache is None:
        return
    with spans.span(spans.PERSIST):
        depth = depth.astype(np.float32)
        normal = normal.astype(np.float32)
        weak = weak.astype(np.uint8)
        out_of_range = (depth < depth_min) | (depth > depth_max)
        depth = np.where(out_of_range, 0.0, depth)
        weak = np.where(out_of_range, np.uint8(UNKNOWN), weak)

        for name, mat in (("depths.bin", depth), ("normals.bin", normal),
                          ("weak.bin", weak)) \
                + ((("confidence.bin", confidence),) if geom else ()):
            write_bin_mat(problem.result_folder / name, mat, cache=cache,
                          flush=write_files)

        if show_medium_result and write_files:
            it = spec.iteration
            if pil_available():
                visualize.show_depth_map(
                    problem.result_folder / f"depth_{it}.jpg", depth,
                    depth_min, depth_max)
                visualize.show_normal_map(
                    problem.result_folder / f"normal_{it}.jpg", normal)
            else:
                print(f"PIL not available: no depth_{it}.jpg / "
                      f"normal_{it}.jpg preview for view "
                      f"{format_index(problem.ref_image_id)}", flush=True)
            visualize.show_weak_image(
                problem.result_folder / f"weak_{it}.png", weak)
            if geom:
                visualize.show_confidence_map(
                    problem.result_folder / f"confidence_{it}.png", confidence)


def _export_nearest_strong(path, nearest: np.ndarray) -> None:
    """Random color per nearest-strong target (reference: ExportNearestStrong,
    APD.cu:2628-2649)."""
    h, w, _ = nearest.shape
    flat = nearest[..., 1].astype(np.int64) * w + nearest[..., 0]
    flat = np.where((nearest[..., 0] >= 0), flat, h * w)
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 255, size=(h * w + 1, 3)).astype(np.uint8)
    palette[h * w] = 0
    write_image(path, palette[flat])


def _write_fit_normal(path, anchors_map: np.ndarray,
                      fit_normal: np.ndarray) -> None:
    """Each weak pixel's debug fit-plane normal as a normal-map image, black
    elsewhere (reference: ExportFitNormal, APD.cu:2600-2649)."""
    h, w = anchors_map.shape
    fit_map = np.zeros((h, w, 3), np.float32)
    sel = anchors_map >= 0
    fit_map[sel] = fit_normal[anchors_map[sel], :3]
    visualize.show_normal_map(path, fit_map)


def _write_anchors(path, anchors: np.ndarray) -> None:
    """anchors.bin: int32 weak_count, int32 ANCHOR_NUM, then int16 (x, y)
    pairs (reference: ExportAnchors, APD.cu:2614-2626)."""
    with open(path, "wb") as f:
        nw, an, _ = anchors.shape
        np.asarray([nw, an], np.int32).tofile(f)
        anchors.astype(np.int16).tofile(f)


def _write_reliable_curve(path, curve: np.ndarray) -> None:
    """reliable_curve.bin: int32 width, height, num_samples, then floats
    (reference: ExportReliableCurve, APD.cu:2651-2661)."""
    h, w, n = curve.shape
    with open(path, "wb") as f:
        np.asarray([w, h, n], np.int32).tofile(f)
        curve.astype(np.float32).tofile(f)


def _fuse(dense_folder, problems, params, export_color, cache, shard,
          device) -> None:
    """Fusion into APD/APD.ply (or a shard's part), with its wall time."""
    from .fusion import run_fusion

    t_fuse = time.time()
    run_fusion(dense_folder, problems, "APD.ply", params,
               export_color=export_color, cache=cache, shard=shard,
               device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"Fusion wall {time.time() - t_fuse:.3f} s", flush=True)


def print_launches(tag: str) -> None:
    """The engine's last line: every kernel's launches in this process
    (``tag`` names the rank under a process group)."""
    # one write with its newline: ranks sharing a pipe interleave writes
    print(f"Sampler kernel launches: {sampler.launches}, by site "
          f"{json.dumps(sampler.site_launches, sort_keys=True)}, NCC kernel "
          f"launches: {ncc.launches}, by site "
          f"{json.dumps(ncc.site_launches, sort_keys=True)}, sweep kernel "
          f"launches: {sweep.launches}, by mode "
          f"{json.dumps(sweep.mode_launches, sort_keys=True)}, strong kernel "
          f"launches: {strong.launches} for {strong.colours} colour updates"
          f"{tag}, weak kernel launches: {weak.launches} for {weak.planes} "
          f"planes, weak sweep kernel launches: {weak_sweep.launches} for "
          f"{weak_sweep.chunks} chunks, selection kernel launches: "
          f"{select_kernel.launches}, anchor kernel launches: K10 "
          f"{anchor_kernels.jfa_launches}, K8 "
          f"{anchor_kernels.anchor_launches}, K9 "
          f"{anchor_kernels.fit_launches}\n", end="", flush=True)


def run_scan(dense_folder, dataset: str = "General", *,
             device="cuda",
             only_fuse: bool = False, no_fuse: bool = False,
             use_memory_cache: bool = True, use_sa: bool = True,
             use_impetus: bool = True, weak_filter: bool = True,
             flush: bool = False, export_anchor: bool = False,
             export_curve: bool = False, export_color: bool = True,
             seed: int = 0, pyramid_base: int = PYRAMID_BASE_MAX_DIM,
             fuse_shard=None, sampler_u8: bool = True,
             start_iteration: int = 0,
             views_parallel: Optional[bool] = None,
             view_batch: Optional[int] = None) -> None:
    """Full scan reconstruction (reference: main.cpp:210-411) on ``device``.

    Under a process group (`parallel.distributed.initialize`, one rank per
    process) ``views_parallel`` routes each pass: a scan with at least as
    many views as ranks runs view-parallel (`scan_parallel`, views split
    over the ranks, ``view_batch`` views a batch), a smaller one through
    the tile route (each view row-sharded over every rank). ``None``
    means: view-parallel when there is more than one rank. Serial passes
    (``views_parallel`` false, and the debug-export pass) run on rank 0,
    view after view, and so does fusion, after the last barrier.

    ``export_anchor`` / ``export_curve``: write the debug exports on the
    last pass. ``fuse_shard=(i, n)``: fuse only reference views i mod n
    into a partial PLY (see `fusion.merge_fusion_shards`).
    ``start_iteration``: skip schedule passes below this iteration index
    (per-view bins are the checkpoint; every non-first pass rebuilds its
    state from disk)."""
    from ..parallel import distributed as pdist

    device = torch.device(device)
    rank, world = pdist.rank_and_world()
    tag = f", rank {rank} of {world}" if world > 1 else ""
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
        if rank == 0:
            _fuse(dense_folder, problems, fusion_params, export_color, cache,
                  fuse_shard, device)
        return

    round_num = compute_round_num(problems, cache, base=pyramid_base)
    print(f"Round nums: {round_num}", flush=True)
    p0 = problems[0]
    img0 = read_image_gray(_image_path(p0, p0.ref_image_id), cache=cache)
    schedule = cfg.build_schedule(max(img0.shape), dataset, use_sa=use_sa,
                                  use_impetus=use_impetus, base=pyramid_base,
                                  sampler_u8=sampler_u8)
    if views_parallel is None:
        views_parallel = world > 1
    runner = tiled = None
    if views_parallel:
        from .scan_parallel import ViewParallelRunner
        runner = ViewParallelRunner(problems, cache, seed=seed,
                                    view_batch=view_batch, device=device)
        tiled = len(problems) < world
        route = "tile route" if tiled else "view-parallel"
        print(f"Scale-out: {route} over {world} rank(s){tag}", flush=True)

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
        sent = pdist.exchanged_bytes
        # the debug exports need the serial engine's whole-view stages
        debug_pass = spec.is_last_iteration and (export_anchor or export_curve)
        if runner is not None and not debug_pass:
            if tiled:
                runner.run_pass_tiled(spec)
            else:
                runner.run_pass(spec)
        elif rank == 0:
            for problem in problems:
                process_problem(
                    problem, spec, cache=cache, seed=seed, device=device,
                    export_anchor=export_anchor and spec.is_last_iteration,
                    export_curve=export_curve and spec.is_last_iteration)
        pdist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        exch = f", exchanged {pdist.exchanged_bytes - sent} B" \
            if world > 1 else ""
        print(f"Pass {spec.iteration} ({spec.params.state}) wall "
              f"{time.time() - t_pass:.3f} s{exch}{tag}", flush=True)
    print(f"Cost time: {(time.time() - t0) * 1000:.0f} ms", flush=True)
    avg = np.mean([p.used_time_ms for p in problems]) if problems else 0
    print(f"Average used time: {avg:.0f} ms", flush=True)
    print_launches(tag)

    if cache is not None and flush:
        cache.flush()
    if no_fuse:
        print("Skip fusion, all done!", flush=True)
        return
    if rank == 0:
        _fuse(dense_folder, problems, fusion_params, export_color, cache,
              fuse_shard, device)
    print("All done", flush=True)
