"""Depth-map fusion into a point cloud, general variant (reference:
RunFusion + WeakVisFilter, APD.cpp:962-1227).

Whole-image tensor math per (ref view, neighbor) pair on the engine's
device. Geometry runs in float64 (the cameras are float64 and the numpy
formulation of the JAX package promotes to it), the normal-angle test in
float32 as there; the consistency weight `dyn` and the colour sums
accumulate in float64.

Source pixels are consumed at ref-view granularity: all pixels of a view
observe the mask state from the view's start, and consumed pixels are
committed afterwards (the JAX package's documented relaxation of the
reference's serial scan).

WeakVisFilter compares confidences by value — the reference reads the uchar
confidence mat through a float accessor (APD.cpp:1010); we implement the
evident intent, as the JAX package does.

Not ported: the TaT variants (escalating-k consensus; `run_fusion` raises
for them), sharded fusion and the shard merge (the CLI refuses
`--fuse_shard` / `--merge_fusion`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from ..config import FusionParams, STRONG, WEAK
from ..core.geometry import pixel_grid
from ..io import read_bin_mat
from ..io.cameras import Camera, read_camera
from ..io.images import read_image_color, resize_bilinear, write_image
from ..io.ply import export_point_cloud


@dataclasses.dataclass
class FusionView:
    image: torch.Tensor      # (H, W, 3) uint8 BGR at depth resolution
    camera: Camera
    depth: torch.Tensor      # (H, W) f32
    normal: torch.Tensor     # (H, W, 3) f32
    weak: torch.Tensor       # (H, W) uint8
    confidence: torch.Tensor  # (H, W) uint8
    skip: torch.Tensor       # (H, W) bool  (visibility-conflict filter)
    mask: torch.Tensor       # (H, W) bool  (consumed)


def _cam64(cam: Camera, device):
    """(K, R, c) float64 tensors of a camera."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)
    return t(cam.K), t(cam.R), t(cam.c)


def _backproject_world(cam: Camera, xs, ys, depth):
    K, R, c = _cam64(cam, depth.device)
    d = depth.to(torch.float64)
    X = torch.stack([d * (xs.to(torch.float64) - K[0, 2]) / K[0, 0],
                     d * (ys.to(torch.float64) - K[1, 2]) / K[1, 1], d], -1)
    return X @ R + c


def _project(cam: Camera, Xw):
    K, R, c = _cam64(cam, Xw.device)
    Xc = (Xw - c) @ R.T
    d = Xc[..., 2]
    x = (K[0, 0] * Xc[..., 0] + K[0, 2] * Xc[..., 2]) / d
    y = (K[1, 1] * Xc[..., 1] + K[1, 2] * Xc[..., 2]) / d
    return x, y, d


def _norm3(v):
    """Euclidean norm over the last axis of 3, summed left to right and
    correctly rounded, as numpy's np.linalg.norm gives it (the arccos of the
    normal test amplifies a one-ulp difference near 1 into ~1e-4 rad;
    torch's float32 sqrt is not always correctly rounded, its float64 one
    is)."""
    sq = v * v
    return torch.sqrt((sq[..., 0] + sq[..., 1] + sq[..., 2]).double()
                      ).to(v.dtype)


def _nearest_pixel(px, py, sh: int, sw: int):
    """Rounded source pixel (floor(p + 0.5)), its in-image test (taken in
    float, so NaN and huge coordinates are simply out of the image), and
    the clamped integer row/col."""
    sr = torch.floor(py + 0.5)
    sc = torch.floor(px + 0.5)
    inb = (sc >= 0) & (sc < sw) & (sr >= 0) & (sr < sh)
    src = torch.clamp(torch.nan_to_num(sr, nan=0.0), 0, sh - 1).long()
    scc = torch.clamp(torch.nan_to_num(sc, nan=0.0), 0, sw - 1).long()
    return inb, src, scc


def load_fusion_views(dense_folder, problems, cache=None,
                      device="cuda") -> List[FusionView]:
    dense_folder = Path(dense_folder)
    views = []
    for p in problems:
        img = read_image_color(
            dense_folder / "images" / (f"{p.ref_image_id:08d}" + p.img_ext))
        cam = read_camera(
            dense_folder / "cams" / (f"{p.ref_image_id:08d}_cam.txt"),
            cache=cache)
        depth = read_bin_mat(p.result_folder / "depths.bin", cache=cache)
        normal = read_bin_mat(p.result_folder / "normals.bin", cache=cache)
        weak = read_bin_mat(p.result_folder / "weak.bin", cache=cache)
        conf = read_bin_mat(p.result_folder / "confidence.bin", cache=cache)
        h, w = depth.shape
        if img.shape[:2] != (h, w):
            sy, sx = h / img.shape[0], w / img.shape[1]
            img = resize_bilinear(img, (h, w))
            cam = cam.scaled(sx, sy, w, h)
        else:
            cam = dataclasses.replace(cam, width=w, height=h)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a).astype(dtype),
                                   device=device)
        views.append(FusionView(
            image=t(img, np.uint8), camera=cam,
            depth=t(depth, np.float32), normal=t(normal, np.float32),
            weak=t(weak, np.uint8), confidence=t(conf, np.uint8),
            skip=torch.zeros((h, w), dtype=torch.bool, device=device),
            mask=torch.zeros((h, w), dtype=torch.bool, device=device)))
    return views


def weak_vis_filter(views: Sequence[FusionView], problems, dense_folder,
                    params: FusionParams) -> None:
    """Visibility-conflict filter over weak pixels (reference: WeakVisFilter,
    APD.cpp:962-1049): a weak point is skipped when it floats in front of
    enough higher-priority surfaces in other views."""
    for ri, rv in enumerate(views):
        h, w = rv.depth.shape
        dev = rv.depth.device
        xs, ys = pixel_grid(h, w, dev)
        Xw = _backproject_world(rv.camera, xs, ys, rv.depth)
        strong_occ = torch.zeros((h, w), dtype=torch.int32, device=dev)
        weak_occ = torch.zeros((h, w), dtype=torch.int32, device=dev)
        c_ref = torch.as_tensor(rv.camera.c, dtype=torch.float64, device=dev)
        for si, sv in enumerate(views):
            if si == ri:
                continue
            a = c_ref - Xw
            b = torch.as_tensor(sv.camera.c, dtype=torch.float64,
                                device=dev) - Xw
            cosang = (a * b).sum(-1) / torch.clamp(_norm3(a) * _norm3(b),
                                                    min=1e-12)
            angle = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1, 1)))
            px, py, pd = _project(sv.camera, Xw)
            sh, sw = sv.depth.shape
            inb, src, scc = _nearest_pixel(px, py, sh, sw)
            inb = inb & (pd > 0) & (angle <= params.vis_max_baseline_deg)
            s_depth = sv.depth[src, scc]
            occluded = inb & (pd < s_depth - params.vis_depth_margin
                              * s_depth)
            strong_occ += (occluded & (sv.weak[src, scc] == STRONG)).int()
            weak_occ += (occluded & (sv.weak[src, scc] == WEAK)
                         & (sv.confidence[src, scc] < rv.confidence)).int()
        rv.skip = (rv.weak == WEAK) & (
            (strong_occ >= params.strong_occluded_max)
            | (weak_occ >= params.weak_occluded_max))
        out = Path(dense_folder) / "APD" / f"{problems[ri].ref_image_id:08d}" \
            / "skip.png"
        write_image(out, (rv.skip.cpu().numpy() * 255).astype(np.uint8))


def _neighbor_geometry(rv: FusionView, sv: FusionView, Xw):
    """Projection of a ref view's world points into a neighbor: returns
    (usable, reproj error, relative depth diff, normal angle, src rows/cols)."""
    px, py, _pd = _project(sv.camera, Xw)
    sh, sw = sv.depth.shape
    inb, src, scc = _nearest_pixel(px, py, sh, sw)
    s_depth = sv.depth[src, scc]
    usable = inb & ~sv.mask[src, scc] & (s_depth > 0)
    Xs = _backproject_world(sv.camera, scc.to(torch.float32),
                            src.to(torch.float32), s_depth)
    bx, by, bd = _project(rv.camera, Xs)
    h, w = rv.depth.shape
    xx, yy = pixel_grid(h, w, rv.depth.device)
    reproj = torch.sqrt((xx - bx) ** 2 + (yy - by) ** 2)
    rel_depth = torch.abs(bd - rv.depth) / torch.clamp(rv.depth, min=1e-12)
    s_normal = sv.normal[src, scc]
    dot = (rv.normal * s_normal).sum(-1)
    denom = _norm3(rv.normal) * _norm3(s_normal)
    ang = torch.arccos(torch.clamp(dot / torch.clamp(denom, min=1e-12), -1, 1))
    ang = torch.where(torch.isfinite(ang), ang, 0.0)
    return usable, reproj, rel_depth, ang, src, scc


def _fuse_general(views, problems, params: FusionParams):
    """Dynamic-consistency fusion (reference: RunFusion, APD.cpp:1051-1227).
    Returns (points (N, 3) f32, colours (N, 3) u8 BGR) as numpy arrays."""
    all_pts, all_cols = [], []
    id_to_index = {p.ref_image_id: i for i, p in enumerate(problems)}
    for ri, p in enumerate(problems):
        rv = views[ri]
        h, w = rv.depth.shape
        xs, ys = pixel_grid(h, w, rv.depth.device)
        base = (~rv.mask) & (~rv.skip) & (rv.depth > 0)
        Xw = _backproject_world(rv.camera, xs, ys, rv.depth)
        num_consistent = torch.zeros((h, w), dtype=torch.int32,
                                     device=rv.depth.device)
        dyn = torch.zeros((h, w), dtype=torch.float64, device=rv.depth.device)
        used = []
        for sid in p.src_image_ids:
            sv = views[id_to_index[sid]]
            usable, reproj, rel_d, ang, src, scc = _neighbor_geometry(rv, sv,
                                                                      Xw)
            ok = usable & (reproj < params.reproj_max) \
                & (rel_d < params.rel_depth_max) & (ang < params.angle_max)
            num_consistent += ok.int()
            dyn += torch.where(ok, torch.exp(-(reproj + 200.0 * rel_d
                                               + 10.0 * ang)), 0.0)
            used.append((sv, ok, src, scc))
        factor = torch.where(rv.weak == WEAK, params.dyn_factor_weak,
                             params.dyn_factor_strong).to(torch.float64)
        accept = base & (num_consistent >= 1) & (dyn > factor * num_consistent)
        color = rv.image.to(torch.float64)
        for sv, ok, src, scc in used:
            take = accept & ok
            color[take] += sv.image[src[take], scc[take]].to(torch.float64)
            sv.mask[src[take], scc[take]] = True
        color[accept] /= (num_consistent[accept] + 1)[:, None].to(
            torch.float64)
        all_pts.append(Xw[accept].to(torch.float32).cpu().numpy())
        all_cols.append(torch.clamp(color[accept], 0, 255).to(torch.uint8)
                        .cpu().numpy())
    if not all_pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return np.concatenate(all_pts), np.concatenate(all_cols)


def run_fusion(dense_folder, problems, name: str, params: FusionParams,
               export_color: bool = True, cache=None,
               device="cuda") -> Path:
    """Fuse all views' depth maps into one PLY (general variant)."""
    if params.variant != "general":
        raise NotImplementedError(
            f"fusion variant {params.variant!r} (TaT escalating-k) is not "
            "ported yet; only the general variant is")
    views = load_fusion_views(dense_folder, problems, cache=cache,
                              device=device)
    if cache is not None:
        cache.img_cache.clear()
    if params.weak_filter:
        weak_vis_filter(views, problems, dense_folder, params)
    coords, colors = _fuse_general(views, problems, params)
    ply_path = Path(dense_folder) / "APD" / name
    export_point_cloud(ply_path, coords, colors if export_color else None)
    print(f"Fusion: {len(coords)} points -> {ply_path}", flush=True)
    return ply_path
