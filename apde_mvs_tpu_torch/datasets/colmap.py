"""COLMAP sparse model -> MVSNet scene conversion (reference:
tools/colmap2mvsnet.py).

Reads COLMAP cameras/images/points3D (text or binary), computes per-image
depth ranges from sparse-point quantiles, selects source views either by
covisibility scoring (triangulation-angle gated) or sequentially, and writes
`cams/%08d_cam.txt`, `pair.txt` and renamed/padded/rescaled images.

Images are read through the port's `io.images`. Where PIL imports, they are
written as `%08d.jpg` (quality 95), as the JAX package writes them; where it
does not, as lossless `%08d.png` through the port's standard-library PNG
codec — the one deviation from the JAX converter, so a scan converts on a
machine without an imaging package.
"""

from __future__ import annotations

import argparse
import collections
import multiprocessing
import os
import shutil
import struct
import sys
from functools import partial
from typing import Dict, List, Tuple

import numpy as np

CameraModel = collections.namedtuple("CameraModel",
                                     ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple(
    "ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys",
                    "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5), CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
MODEL_BY_ID = {m.model_id: m for m in CAMERA_MODELS}
MODEL_BY_NAME = {m.model_name: m for m in CAMERA_MODELS}

PARAM_TYPE = {
    "SIMPLE_PINHOLE": ["f", "cx", "cy"],
    "PINHOLE": ["fx", "fy", "cx", "cy"],
    "SIMPLE_RADIAL": ["f", "cx", "cy", "k"],
    "SIMPLE_RADIAL_FISHEYE": ["f", "cx", "cy", "k"],
    "RADIAL": ["f", "cx", "cy", "k1", "k2"],
    "RADIAL_FISHEYE": ["f", "cx", "cy", "k1", "k2"],
    "OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"],
    "OPENCV_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "FULL_OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3",
                    "k4", "k5", "k6"],
    "FOV": ["fx", "fy", "cx", "cy", "omega"],
    "THIN_PRISM_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                           "k3", "k4", "sx1", "sy1"],
}


# ---------------------------------------------------------------------------
# COLMAP readers (text + binary)
# ---------------------------------------------------------------------------

def _read_next_bytes(f, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, f.read(num_bytes))


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                id=int(el[0]), model=el[1], width=int(el[2]),
                height=int(el[3]), params=np.array(el[4:], float))
    return cams


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        n = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(n):
            cid, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
            model = MODEL_BY_ID[model_id]
            params = _read_next_bytes(f, 8 * model.num_params,
                                      "d" * model.num_params)
            cams[cid] = ColmapCamera(cid, model.model_name, width, height,
                                     np.array(params))
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    """Images with zero 2-D observations have an EMPTY points line; the pair
    structure (header line, points line) must be preserved positionally, so
    only comment lines are filtered before pairing."""
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(pts, float).reshape(-1, 3)[:, :2] if pts else \
            np.zeros((0, 2))
        ids = np.array(pts[2::3], int) if pts else np.zeros((0,), int)
        images[int(el[0])] = ColmapImage(
            id=int(el[0]), qvec=np.array(el[1:5], float),
            tvec=np.array(el[5:8], float), camera_id=int(el[8]), name=el[9],
            xys=xys, point3D_ids=ids)
    return images


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        n = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(n):
            props = _read_next_bytes(f, 64, "idddddddi")
            iid = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            cam_id = props[8]
            name = b""
            ch = f.read(1)
            while ch != b"\x00":
                name += ch
                ch = f.read(1)
            n2d = _read_next_bytes(f, 8, "Q")[0]
            data = _read_next_bytes(f, 24 * n2d, "ddq" * n2d)
            xys = np.column_stack([data[0::3], data[1::3]])
            ids = np.array(data[2::3], int)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode(), xys, ids)
    return images


def read_points3d_text(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pts[int(el[0])] = Point3D(
                id=int(el[0]), xyz=np.array(el[1:4], float),
                rgb=np.array(el[4:7], int), error=float(el[7]),
                image_ids=np.array(el[8::2], int),
                point2D_idxs=np.array(el[9::2], int))
    return pts


def read_points3d_binary(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        n = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(n):
            props = _read_next_bytes(f, 43, "QdddBBBd")
            pid = props[0]
            xyz = np.array(props[1:4])
            rgb = np.array(props[4:7])
            err = props[7]
            track_len = _read_next_bytes(f, 8, "Q")[0]
            track = _read_next_bytes(f, 8 * track_len, "ii" * track_len)
            pts[pid] = Point3D(pid, xyz, rgb, err,
                               np.array(track[0::2], int),
                               np.array(track[1::2], int))
    return pts


def read_model(path, ext=".txt"):
    if ext == ".txt":
        return (read_cameras_text(os.path.join(path, "cameras.txt")),
                read_images_text(os.path.join(path, "images.txt")),
                read_points3d_text(os.path.join(path, "points3D.txt")))
    return (read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")))


def rotmat2qvec(R):
    """Rotation matrix -> (w, x, y, z) quaternion (reference:
    tools/colmap2mvsnet.py:302-313)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


# ---------------------------------------------------------------------------
# View selection
# ---------------------------------------------------------------------------

def covisibility_score(pair, images, points3d, extrinsic,
                       angle_percentile=0.75, min_angle_deg=1.0):
    """Shared-point count, zeroed when the 75th-percentile triangulation
    angle is below 1 degree (reference: calc_score,
    tools/colmap2mvsnet.py:316-340)."""
    i, j = pair
    ids_i = set(int(p) for p in images[i + 1].point3D_ids if p != -1)
    ids_j = set(int(p) for p in images[j + 1].point3D_ids if p != -1)
    shared = ids_i & ids_j
    if not shared:
        return i, j, 0.0
    ci = -extrinsic[i + 1][:3, :3].T @ extrinsic[i + 1][:3, 3]
    cj = -extrinsic[j + 1][:3, :3].T @ extrinsic[j + 1][:3, 3]
    angles = []
    for pid in shared:
        p = points3d[pid].xyz
        a = ci - p
        b = cj - p
        cosang = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
        angles.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
    angles.sort()
    if angles[int(len(angles) * angle_percentile)] < min_angle_deg:
        return i, j, 0.0
    return i, j, float(len(shared))


def sequential_view_selection(num_images: int, k: int):
    """±k temporal neighbors with distance-based scores (reference:
    tools/colmap2mvsnet.py:453-468)."""
    max_neighbors = min(num_images - 1, k * 2)
    sel = []
    for i in range(num_images):
        neighbors = []
        for offset in range(1, k + 1):
            for direction in (-1, 1):
                j = i + direction * offset
                if 0 <= j < num_images:
                    neighbors.append((j, float(k + 1 - offset)))
        neighbors.sort(key=lambda e: (-e[1], abs(e[0] - i)))
        sel.append(neighbors[:max_neighbors])
    return sel


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def convert_scene(dense_folder, save_folder, *, model_ext=".txt", max_d=192,
                  interval_scale=1.0, scale_factor=1.0, sequential=False,
                  sequential_k=5, num_workers=None) -> None:
    from ..io.cameras import Camera, write_camera, write_pair
    from ..io.images import image_size, pil_available, read_image_color, \
        write_png

    image_dir = os.path.join(dense_folder, "images")
    model_dir = os.path.join(dense_folder, "sparse")
    cam_dir = os.path.join(save_folder, "cams")
    out_image_dir = os.path.join(save_folder, "images")
    for d in (cam_dir, out_image_dir):
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)

    cameras, images_raw, points3d = read_model(model_dir, model_ext)
    # renumber images 1..N in sorted-id order (reference: :404-407)
    images = {i + 1: images_raw[k]
              for i, k in enumerate(sorted(images_raw.keys()))}
    num_images = len(images)

    intrinsic = {}
    for cid, cam in cameras.items():
        if cam.model not in ("SIMPLE_PINHOLE", "PINHOLE"):
            raise ValueError(f"unsupported camera model {cam.model}")
        pd = dict(zip(PARAM_TYPE[cam.model], cam.params))
        fx = pd.get("fx", pd.get("f"))
        fy = pd.get("fy", pd.get("f"))
        intrinsic[cid] = np.array(
            [[fx / scale_factor, 0, pd["cx"] / scale_factor],
             [0, fy / scale_factor, pd["cy"] / scale_factor],
             [0, 0, 1.0]])

    extrinsic = {}
    for iid, image in images.items():
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(image.qvec)
        e[:3, 3] = image.tvec
        extrinsic[iid] = e

    # depth ranges from sparse-point depth quantiles (reference: :415-450)
    depth_ranges = {}
    for i in range(num_images):
        zs = []
        for pid in images[i + 1].point3D_ids:
            if pid == -1:
                continue
            X = np.append(points3d[pid].xyz, 1.0)
            zs.append(float((extrinsic[i + 1] @ X)[2]))
        depth_min = depth_max = 0.0
        if zs:
            zs.sort()
            depth_min = zs[int(len(zs) * 0.01)] * 0.75
            depth_max = zs[int(len(zs) * 0.99)] * 1.25
        if max_d == 0:
            K = intrinsic[images[i + 1].camera_id]
            E = extrinsic[i + 1]
            p1 = np.array([K[0, 2], K[1, 2], 1.0])
            p2 = np.array([K[0, 2] + 1, K[1, 2], 1.0])
            P1 = np.linalg.inv(E[:3, :3]) @ (np.linalg.inv(K) @ p1 * depth_min
                                             - E[:3, 3])
            P2 = np.linalg.inv(E[:3, :3]) @ (np.linalg.inv(K) @ p2 * depth_min
                                             - E[:3, 3])
            depth_num = (1 / depth_min - 1 / depth_max) / \
                (1 / depth_min - 1 / (depth_min + np.linalg.norm(P2 - P1)))
        else:
            depth_num = max_d
        interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
        depth_ranges[i + 1] = (depth_min, interval, depth_num, depth_max)

    # view selection
    if sequential:
        view_sel = sequential_view_selection(num_images, sequential_k)
    else:
        pairs = [(i, j) for i in range(num_images)
                 for j in range(i + 1, num_images)]
        func = partial(covisibility_score, images=images, points3d=points3d,
                       extrinsic=extrinsic)
        workers = num_workers or os.cpu_count()
        if workers > 1 and len(pairs) > 64:
            with multiprocessing.get_context("spawn").Pool(workers) as pool:
                results = pool.map(func, pairs)
        else:
            results = [func(p) for p in pairs]
        score = np.zeros((num_images, num_images))
        for i, j, s in results:
            score[i, j] = score[j, i] = s
        num_view = min(20, num_images - 1)
        view_sel = []
        for i in range(num_images):
            order = np.argsort(score[i])[::-1]
            view_sel.append([(int(k), float(score[i, k]))
                             for k in order[:num_view]])

    # write cams + pair
    for i in range(num_images):
        r = depth_ranges[i + 1]
        cam = Camera(K=intrinsic[images[i + 1].camera_id],
                     R=extrinsic[i + 1][:3, :3], t=extrinsic[i + 1][:3, 3],
                     depth_min=r[0], interval=r[1], depth_num=r[2],
                     depth_max=r[3])
        write_camera(os.path.join(cam_dir, f"{i:08d}_cam.txt"), cam)
    write_pair(os.path.join(save_folder, "pair.txt"),
               [(i, view_sel[i]) for i in range(num_images)])

    # pad to the common max size, rescale, renumber (reference: :520-547)
    sizes = [image_size(os.path.join(image_dir, images[i + 1].name))
             for i in range(num_images)]                  # (w, h)
    max_w = max(s[0] for s in sizes)
    max_h = max(s[1] for s in sizes)
    use_jpg = pil_available()
    for i in range(num_images):
        src = os.path.join(image_dir, images[i + 1].name)
        rgb = read_image_color(src)[..., ::-1]
        pad_h = max_h - rgb.shape[0]
        pad_w = max_w - rgb.shape[1]
        rgb = np.pad(rgb, ((0, pad_h), (0, pad_w), (0, 0)))
        if scale_factor != 1.0:
            new = (int(rgb.shape[1] / scale_factor),
                   int(rgb.shape[0] / scale_factor))
            idx_y = np.minimum((np.arange(new[1]) * rgb.shape[0] / new[1])
                               .astype(int), rgb.shape[0] - 1)
            idx_x = np.minimum((np.arange(new[0]) * rgb.shape[1] / new[0])
                               .astype(int), rgb.shape[1] - 1)
            rgb = rgb[idx_y][:, idx_x]
        if use_jpg:
            from PIL import Image
            Image.fromarray(np.ascontiguousarray(rgb)).save(
                os.path.join(out_image_dir, f"{i:08d}.jpg"), quality=95)
        else:
            write_png(os.path.join(out_image_dir, f"{i:08d}.png"), rgb)
    print(f"converted {num_images} views -> {save_folder}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="COLMAP -> MVSNet conversion")
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--save_folder", required=True)
    p.add_argument("--model_ext", default=".txt", choices=[".txt", ".bin"])
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1)
    p.add_argument("--scale_factor", type=float, default=1)
    p.add_argument("--sequential", action="store_true")
    p.add_argument("--sequential_k", type=int, default=5)
    args = p.parse_args(argv)
    convert_scene(args.dense_folder, args.save_folder,
                  model_ext=args.model_ext, max_d=args.max_d,
                  interval_scale=args.interval_scale,
                  scale_factor=args.scale_factor, sequential=args.sequential,
                  sequential_k=args.sequential_k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
