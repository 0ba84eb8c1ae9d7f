"""Depth-map fusion into a point cloud (reference: RunFusion /
RunFusion_TAT_I / RunFusion_TAT_A + WeakVisFilter, APD.cpp:962-1608).

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

Sharded fusion (``run_fusion(..., shard=(i, n))``) fuses the reference views
i mod n into a partial PLY; for the general variant it also writes a
consumption sidecar (origin and consumed pixel ids per point), which
`merge_fusion_shards` replays to drop cross-shard duplicates (owner wins).
The sidecars and the merge are host numpy, streamed through mmap, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from ..config import FusionParams, STRONG, WEAK
from ..core.geometry import pixel_grid
from ..io import read_bin_mat
from ..io.cameras import Camera, read_camera
from ..io.images import read_image_color, resize_bilinear, write_image
from ..io.ply import export_point_cloud, read_ply


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


def _concat_points(all_pts, all_cols):
    """Concatenate per-view point/color chunks; empty input (e.g. a fusion
    shard with no reference views) yields empty (0, 3) arrays."""
    if not all_pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return np.concatenate(all_pts), np.concatenate(all_cols)


def _points(Xw, color, accepted):
    """One view's accepted points (f32) and clipped u8 colours, on the
    host."""
    return (Xw[accepted].to(torch.float32).cpu().numpy(),
            torch.clamp(color[accepted], 0, 255).to(torch.uint8).cpu().numpy())


def _fuse_general(views, problems, params: FusionParams, ref_indices=None,
                  record_consumption=False):
    """Dynamic-consistency fusion (reference: RunFusion, APD.cpp:1051-1227).
    Returns (points (N, 3) f32, colours (N, 3) u8 BGR) as numpy arrays.

    With ``record_consumption``, also returns per-point provenance (the
    origin ref pixel and every consumed source pixel, as global
    ``view_index * H * W + row * W + col`` ids) so sharded runs can apply
    the reference's cross-view consumption at merge time (owner-wins)."""
    all_pts, all_cols = [], []
    origins, consumed_flat, consumed_count = [], [], []
    n_points = 0
    id_to_index = {p.ref_image_id: i for i, p in enumerate(problems)}
    if ref_indices is None:
        ref_indices = range(len(problems))
    for ri in ref_indices:
        p = problems[ri]
        rv = views[ri]
        h, w = rv.depth.shape
        dev = rv.depth.device
        xs, ys = pixel_grid(h, w, dev)
        base = (~rv.mask) & (~rv.skip) & (rv.depth > 0)
        Xw = _backproject_world(rv.camera, xs, ys, rv.depth)
        num_consistent = torch.zeros((h, w), dtype=torch.int32, device=dev)
        dyn = torch.zeros((h, w), dtype=torch.float64, device=dev)
        used = []
        for sid in p.src_image_ids:
            si = id_to_index[sid]
            sv = views[si]
            usable, reproj, rel_d, ang, src, scc = _neighbor_geometry(rv, sv,
                                                                      Xw)
            ok = usable & (reproj < params.reproj_max) \
                & (rel_d < params.rel_depth_max) & (ang < params.angle_max)
            num_consistent += ok.int()
            dyn += torch.where(ok, torch.exp(-(reproj + 200.0 * rel_d
                                               + 10.0 * ang)), 0.0)
            used.append((si, sv, ok, src, scc))
        factor = torch.where(rv.weak == WEAK, params.dyn_factor_weak,
                             params.dyn_factor_strong).to(torch.float64)
        accept = base & (num_consistent >= 1) & (dyn > factor * num_consistent)
        color = rv.image.to(torch.float64)
        n_acc = int(accept.sum())
        if record_consumption:
            acc_order = torch.full((h, w), -1, dtype=torch.int64, device=dev)
            acc_order[accept] = n_points + torch.arange(n_acc, device=dev)
        for si, sv, ok, src, scc in used:
            take = accept & ok
            color[take] += sv.image[src[take], scc[take]].to(torch.float64)
            sv.mask[src[take], scc[take]] = True
            if record_consumption:
                consumed_count.append(acc_order[take].cpu().numpy())
                consumed_flat.append((si * h * w + src[take] * w
                                      + scc[take]).cpu().numpy())
        color[accept] /= (num_consistent[accept] + 1)[:, None].to(
            torch.float64)
        pts, cols = _points(Xw, color, accept)
        all_pts.append(pts)
        all_cols.append(cols)
        n_points += n_acc
        if record_consumption:
            yy, xx = torch.nonzero(accept, as_tuple=True)
            origins.append((ri * h * w + yy * w + xx).cpu().numpy())
    pts, cols = _concat_points(all_pts, all_cols)
    if not record_consumption:
        return pts, cols

    def cat(parts):
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.int64)).astype(np.int64)
    return pts, cols, {
        "origin": cat(origins),            # (N,) global ref-pixel id
        "cons_pt": cat(consumed_count),    # (K,) point rank
        "cons_gid": cat(consumed_flat),    # (K,) consumed pixel id
    }


def _fuse_tat(views, problems, params: FusionParams, advanced: bool,
              ref_indices=None):
    """Escalating-k consensus fusion (reference: RunFusion_TAT_I/_TAT_A,
    APD.cpp:1229-1608): a pixel is accepted at the first k in 2..num_ngb
    with at least k neighbours consistent under thresholds that widen with
    k. The intermediate variant also tests the normal angle and averages
    the colours of the neighbours used at acceptance; the advanced one
    drops the angle test and keeps the reference colour."""
    all_pts, all_cols = [], []
    id_to_index = {p.ref_image_id: i for i, p in enumerate(problems)}
    depth_base = params.depth_base_tat_a if advanced \
        else params.depth_base_tat_i
    if ref_indices is None:
        ref_indices = range(len(problems))
    for ri in ref_indices:
        p = problems[ri]
        rv = views[ri]
        h, w = rv.depth.shape
        dev = rv.depth.device
        xs, ys = pixel_grid(h, w, dev)
        base = (~rv.skip) & (rv.depth > 0)
        Xw = _backproject_world(rv.camera, xs, ys, rv.depth)
        num_ngb = len(p.src_image_ids)
        geo = [(views[id_to_index[sid]],
                *_neighbor_geometry(rv, views[id_to_index[sid]], Xw))
               for sid in p.src_image_ids]
        accepted = torch.zeros((h, w), dtype=torch.bool, device=dev)
        count_at_accept = torch.zeros((h, w), dtype=torch.int32, device=dev)
        use_at_accept = [torch.zeros((h, w), dtype=torch.bool, device=dev)
                         for _ in range(num_ngb)]
        for k in range(2, num_ngb + 1):
            oks = []
            count = torch.zeros((h, w), dtype=torch.int32, device=dev)
            for (sv, usable, reproj, rel_d, ang, src, scc) in geo:
                ok = usable & (reproj < k * params.dist_base) \
                    & (rel_d < k * depth_base)
                if not advanced:
                    ok &= ang < (k * params.angle_grad + params.angle_base)
                oks.append(ok)
                count += ok.int()
            newly = base & ~accepted & (count >= k)
            accepted |= newly
            count_at_accept = torch.where(newly, count, count_at_accept)
            if not advanced:
                for j, ok in enumerate(oks):
                    use_at_accept[j] |= newly & ok
        rv.mask |= accepted
        color = rv.image.to(torch.float64)
        if not advanced:
            for j, g in enumerate(geo):
                sv, src, scc = g[0], g[5], g[6]
                take = use_at_accept[j]
                color[take] += sv.image[src[take], scc[take]].to(
                    torch.float64)
            color[accepted] /= (count_at_accept[accepted] + 1)[:, None].to(
                torch.float64)
        pts, cols = _points(Xw, color, accepted)
        all_pts.append(pts)
        all_cols.append(cols)
    return _concat_points(all_pts, all_cols)


def run_fusion(dense_folder, problems, name: str, params: FusionParams,
               export_color: bool = True, cache=None, shard=None,
               device="cuda") -> Path:
    """Fuse all views' depth maps into one PLY (dispatches on variant).

    ``shard=(i, n)`` fuses only the reference views with index i (mod n)
    into a partial PLY (``<name>.part<i>of<n>``); `merge_fusion_shards`
    concatenates the parts. All views' maps are still loaded (they are
    every shard's neighbour inputs). For the general variant the shard also
    records its consumption, which the merge replays (owner wins)."""
    views = load_fusion_views(dense_folder, problems, cache=cache,
                              device=device)
    if cache is not None:
        cache.img_cache.clear()
    if params.weak_filter:
        weak_vis_filter(views, problems, dense_folder, params)
    ref_indices = list(range(len(problems)))
    if shard is not None:
        ref_indices = [i for i in ref_indices if i % shard[1] == shard[0]]
    consumption = None
    if params.variant == "general":
        if shard is not None:
            # the owner-wins replay buckets global pixel ids at multiples of
            # ONE hw (views[0]); mixed-resolution depth maps would misbucket
            # views at merge time
            shapes = {tuple(v.depth.shape) for v in views}
            if len(shapes) != 1:
                raise ValueError(
                    "sharded fusion with consumption recording requires all "
                    f"views to share one depth-map shape; got {shapes}")
            coords, colors, consumption = _fuse_general(
                views, problems, params, ref_indices,
                record_consumption=True)
        else:
            coords, colors = _fuse_general(views, problems, params,
                                           ref_indices)
    else:
        coords, colors = _fuse_tat(views, problems, params,
                                   advanced=(params.variant == "tat_a"),
                                   ref_indices=ref_indices)
    ply_path = Path(dense_folder) / "APD" / name
    if shard is not None:
        ply_path = ply_path.with_name(f"{name}.part{shard[0]}of{shard[1]}")
    export_point_cloud(ply_path, coords, colors if export_color else None)
    if consumption is not None:
        h, w = views[0].depth.shape
        _write_consumption(ply_path, consumption, h * w)
    print(f"Fusion: {len(coords)} points -> {ply_path}", flush=True)
    return ply_path


def _write_consumption(ply_path, consumption, hw: int) -> None:
    """Persist a shard's consumption sidecar as raw mmap-able .npy files in
    `<ply>.consume/`, at the smallest sufficient integer width (uint32
    unless an id reaches 2**32), with a meta.json of lengths and format
    version so the merge can detect a partially rewritten sidecar."""
    d = Path(str(ply_path) + ".consume")
    d.mkdir(parents=True, exist_ok=True)
    gid_max = max(int(consumption["origin"].max(initial=0)),
                  int(consumption["cons_gid"].max(initial=0)))
    gid_dt = np.uint32 if gid_max < 2 ** 32 else np.int64
    pt_max = int(consumption["cons_pt"].max(initial=0))
    pt_dt = np.uint32 if pt_max < 2 ** 32 else np.int64
    np.save(d / "origin.npy", consumption["origin"].astype(gid_dt))
    np.save(d / "cons_pt.npy", consumption["cons_pt"].astype(pt_dt))
    np.save(d / "cons_gid.npy", consumption["cons_gid"].astype(gid_dt))
    (d / "meta.json").write_text(json.dumps({
        "version": 1, "hw": int(hw),
        "n_origin": int(len(consumption["origin"])),
        "n_cons": int(len(consumption["cons_pt"]))}))


def _owner_wins_replay(sides, hw: int, chunk: int = 1 << 24):
    """Memory-lean exact equivalent of `owner_wins_filter` over mmap-ed
    shard sidecars: one ascending pass over ref views with a consumed
    bitmap.

    A point is dropped iff a KEPT point of an EARLIER ref view consumed its
    origin pixel. Blockers only come from earlier views, so one replay in
    view order computes the fixpoint exactly: decide all of view v's keeps
    against the bitmap, then mark the kept points' consumption. Memory: one
    bool per (view, pixel) id plus one view's entry slices; per-shard
    arrays stay on disk.

    sides: list of dicts with mmap-ed "origin"/"cons_pt"/"cons_gid".
    Returns per-shard keep masks.
    """
    n_views = 0
    for s in sides:
        if len(s["origin"]):
            n_views = max(n_views, int(s["origin"][-1]) // hw + 1)
        if len(s["cons_gid"]):
            # consumed ids can exceed any origin (source views past the
            # last ref view); scan chunked for the max
            m = 0
            cg = s["cons_gid"]
            for i in range(0, len(cg), chunk):
                m = max(m, int(cg[i:i + chunk].max()))
            n_views = max(n_views, m // hw + 1)
    bitmap = np.zeros(n_views * hw, bool)
    kept = [np.ones(len(s["origin"]), bool) for s in sides]

    # per shard: point ranges per view (origin ascends: points are appended
    # ref-view ascending, raster order within a view), and entry ranges per
    # view (entries are view-grouped by construction)
    pstarts = []
    eranges = []
    for s in sides:
        origin = s["origin"]
        ps = np.searchsorted(origin, np.arange(n_views + 1,
                                               dtype=np.int64) * hw)
        pstarts.append(ps)
        counts = np.zeros(n_views, np.int64)
        cp = s["cons_pt"]
        prev_v = -1
        for i in range(0, len(cp), chunk):
            c = cp[i:i + chunk]
            ev = np.searchsorted(ps, c, side="right") - 1
            counts += np.bincount(ev, minlength=n_views)
            if len(ev):
                if prev_v > int(ev[0]):
                    raise ValueError("consumption sidecar not view-grouped")
                prev_v = int(ev[-1])
        eranges.append(np.concatenate([[0], np.cumsum(counts)]))

    for v in range(n_views):
        # decide view v's points everywhere before marking any consumption
        for si, s in enumerate(sides):
            p0, p1 = int(pstarts[si][v]), int(pstarts[si][v + 1])
            if p1 > p0:
                kept[si][p0:p1] = ~bitmap[np.asarray(s["origin"][p0:p1],
                                                     np.int64)]
        for si, s in enumerate(sides):
            e0, e1 = int(eranges[si][v]), int(eranges[si][v + 1])
            for i in range(e0, e1, chunk):
                j = min(i + chunk, e1)
                cp = np.asarray(s["cons_pt"][i:j], np.int64)
                m = kept[si][cp]
                bitmap[np.asarray(s["cons_gid"][i:j], np.int64)[m]] = True
    return kept


def owner_wins_filter(origin, cons_pt, cons_gid, hw):
    """Cross-shard consumption at merge time: a point whose origin ref pixel
    was consumed by a kept point of an EARLIER ref view is dropped — the
    reason the reference's serial scan would have skipped that pixel
    (APD.cpp:1149). Iterates to a fixpoint so dropped points stop consuming.

    origin: (N,) global ref-pixel ids (view * hw + pixel); cons_pt: (K,)
    point ranks; cons_gid: (K,) consumed pixel ids. Returns a (N,) keep mask.
    """
    n = len(origin)
    origin_view = (origin // hw).astype(np.int64)
    # compact the id universe so the scatter table stays small
    all_gids = np.concatenate([origin, cons_gid])
    uniq, inv = np.unique(all_gids, return_inverse=True)
    origin_c = inv[:n]
    cons_c = inv[n:]
    entry_view = origin_view[cons_pt]
    kept = np.ones(n, bool)
    big = np.int64(1 << 60)
    # consumption chains are bounded by the number of distinct ref views
    # (+1 round to detect non-convergence, which cannot happen)
    max_rounds = len(np.unique(origin_view)) + 1
    for _ in range(max_rounds):
        min_view = np.full(len(uniq), big, np.int64)
        valid = kept[cons_pt]
        np.minimum.at(min_view, cons_c[valid], entry_view[valid])
        new_kept = min_view[origin_c] >= origin_view
        if np.array_equal(new_kept, kept):
            break
        kept = new_kept
    else:
        print("owner_wins_filter: no fixpoint after "
              f"{max_rounds} rounds (keeping last mask)", flush=True)
    return kept


def _consumption_side_ok(side, meta) -> bool:
    """Cross-check one shard's consumption sidecar against its recorded
    meta (format version, per-array lengths, point-rank bound) so a
    partially rewritten sidecar — one .npy regenerated while the others are
    stale — is caught before the replay trusts it."""
    if meta.get("version", 0) != 1:
        return False
    n_origin = meta.get("n_origin")
    n_cons = meta.get("n_cons")
    if n_origin is None or n_cons is None:
        return False
    if len(side["origin"]) != n_origin or len(side["cons_pt"]) != n_cons \
            or len(side["cons_gid"]) != n_cons:
        return False
    # cons_pt holds this shard's point ranks; a stale origin.npy shows up as
    # ranks past the point count (entries append in point order)
    if n_cons and (int(side["cons_pt"][-1]) >= n_origin
                   or int(side["cons_pt"][0]) >= n_origin):
        return False
    return True


def merge_fusion_shards(dense_folder, name: str, num_shards: int,
                        export_color: bool = True) -> Path:
    """Merge the partial PLYs of sharded fusion runs into ``APD/<name>``.

    When every part has a consistent consumption sidecar (general variant),
    applies the owner-wins filter so the merged cloud reproduces the
    reference's cross-view source-pixel consumption instead of keeping the
    shards' duplicated points."""
    coords, colors, sides, hw = [], [], [], None
    for i in range(num_shards):
        part = Path(dense_folder) / "APD" / f"{name}.part{i}of{num_shards}"
        c, col = read_ply(part)
        coords.append(c)
        if col is not None:
            colors.append(col)
        d = Path(str(part) + ".consume")
        if (d / "meta.json").exists():
            # mmap: the replay only touches one view's slices at a time
            side = {k: np.load(d / f"{k}.npy", mmap_mode="r")
                    for k in ("origin", "cons_pt", "cons_gid")}
            meta = json.loads((d / "meta.json").read_text())
            hw = int(meta["hw"])
            side["_meta_ok"] = _consumption_side_ok(side, meta)
            sides.append(side)
        else:
            sides.append(None)
    part_sizes = [len(c) for c in coords]
    coords = np.concatenate(coords)
    colors = np.concatenate(colors) if colors else None

    sides_ok = all(s is not None for s in sides) and all(
        len(s["origin"]) == m and s["_meta_ok"]
        for s, m in zip(sides, part_sizes))
    if any(s is not None for s in sides) and not sides_ok:
        print("merge_fusion_shards: consumption sidecars are stale or "
              "incomplete for the current part PLYs — merging without the "
              "owner-wins filter", flush=True)
    if sides_ok and len(coords):
        kept = np.concatenate(_owner_wins_replay(sides, hw))
        dropped = int((~kept).sum())
        coords = coords[kept]
        if colors is not None:
            colors = colors[kept]
        print(f"Owner-wins consumption merge: dropped {dropped} "
              f"cross-shard duplicate points", flush=True)

    ply_path = Path(dense_folder) / "APD" / name
    export_point_cloud(ply_path, coords,
                       colors if export_color and colors is not None else None)
    print(f"Merged {num_shards} fusion shards: {len(coords)} points -> "
          f"{ply_path}", flush=True)
    return ply_path
