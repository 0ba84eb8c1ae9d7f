"""Fabricated ETH3D-undistorted scan — the batch-drill fixture.

Writes a synthetic scene to disk laid out like an extracted ETH3D high-res
multi-view training scan (the reference pipeline's input, reference
run.py:94-138 + tools/eval_eth_train.py:39-48):

    <root>/<scan>/images/dslr_images_undistorted/DSC_####.JPG
    <root>/<scan>/dslr_calibration_undistorted/{cameras,images,points3D}.txt

The photos are JPEG (quality 95) where PIL imports, as ETH3D ships them;
without PIL they are lossless ``DSC_####.png`` through the port's PNG codec.

so the whole real-data pipeline (layout normalization -> COLMAP->MVSNet
conversion -> engine -> fusion -> evaluation harness) can be exercised
without the dataset. The COLMAP text model is genuine: PINHOLE cameras,
world-to-camera quaternions, and a sparse point cloud sampled from the
analytic surface with real multi-view tracks (the converter derives depth
ranges and covisibility view selection from them)."""

from __future__ import annotations

import os

import numpy as np

from ..datasets.colmap import rotmat2qvec
from .synthetic import SyntheticScene


def _project(cam, X):
    Xc = cam.R @ X + cam.t
    if Xc[2] <= 0:
        return None
    u = Xc[0] / Xc[2] * cam.K[0, 0] + cam.K[0, 2]
    v = Xc[1] / Xc[2] * cam.K[1, 1] + cam.K[1, 2]
    return u, v, Xc[2]


def write_eth3d_scan(scene: SyntheticScene, root, scan: str = "mini_scan",
                     num_points: int = 400, seed: int = 0) -> str:
    """Materialize `scene` as an ETH3D-undistorted-layout scan; returns the
    scan directory path."""
    from ..io.images import pil_available, write_png

    use_jpg = pil_available()
    scan_dir = os.path.join(root, scan)
    img_dir = os.path.join(scan_dir, "images", "dslr_images_undistorted")
    cal_dir = os.path.join(scan_dir, "dslr_calibration_undistorted")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(cal_dir, exist_ok=True)

    V = scene.num_views
    h, w = scene.images.shape[1:3]
    names = []
    for v in range(V):
        name = f"DSC_{v:04d}." + ("JPG" if use_jpg else "png")
        names.append(name)
        rgb = np.repeat(np.clip(scene.images[v], 0, 255)
                        .astype(np.uint8)[..., None], 3, axis=-1)
        if use_jpg:
            from PIL import Image
            Image.fromarray(rgb).save(os.path.join(img_dir, name), quality=95)
        else:
            write_png(os.path.join(img_dir, name), rgb)

    with open(os.path.join(cal_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera\n")
        for v in range(V):
            K = scene.cameras[v].K
            f.write(f"{v + 1} PINHOLE {w} {h} {K[0, 0]} {K[1, 1]} "
                    f"{K[0, 2]} {K[1, 2]}\n")

    # sparse surface points with multi-view tracks
    rng = np.random.default_rng(seed)
    pts_world = []
    while len(pts_world) < num_points:
        v = int(rng.integers(V))
        x = int(rng.integers(8, w - 8))
        y = int(rng.integers(8, h - 8))
        d = float(scene.depths[v][y, x])
        if d <= 0:
            continue
        cam = scene.cameras[v]
        d_cam = np.array([(x - cam.K[0, 2]) / cam.K[0, 0],
                          (y - cam.K[1, 2]) / cam.K[1, 1], 1.0])
        pts_world.append(cam.c + d * (d_cam @ cam.R))
    pts_world = np.asarray(pts_world)

    # visibility: project into each view, require in-bounds + unoccluded
    tracks = [[] for _ in range(num_points)]          # (image_id, p2d_idx)
    obs = [[] for _ in range(V)]                      # (u, v, point_id)
    for pid, X in enumerate(pts_world):
        for v in range(V):
            pr = _project(scene.cameras[v], X)
            if pr is None:
                continue
            u, vv, z = pr
            ui, vi = int(round(u)), int(round(vv))
            if not (0 <= ui < w and 0 <= vi < h):
                continue
            d_map = float(scene.depths[v][vi, ui])
            if d_map <= 0 or abs(d_map - z) / z > 0.02:
                continue                              # occluded
            tracks[pid].append((v + 1, len(obs[v])))
            obs[v].append((u, vv, pid + 1))

    # a point seen by one view only is not triangulated: points3D.txt leaves
    # it out, and its observation carries COLMAP's id -1
    with open(os.path.join(cal_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for v in range(V):
            cam = scene.cameras[v]
            q = rotmat2qvec(cam.R)
            t = cam.t
            f.write(f"{v + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {v + 1} "
                    f"dslr_images_undistorted/{names[v]}\n")
            f.write(" ".join(
                f"{u} {vv} {pid if len(tracks[pid - 1]) >= 2 else -1}"
                for u, vv, pid in obs[v]) + "\n")

    with open(os.path.join(cal_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point\n")
        for pid, X in enumerate(pts_world):
            if len(tracks[pid]) < 2:
                continue
            track = " ".join(f"{iid} {p2d}" for iid, p2d in tracks[pid])
            f.write(f"{pid + 1} {X[0]} {X[1]} {X[2]} 128 128 128 0.5 "
                    f"{track}\n")
    return scan_dir
