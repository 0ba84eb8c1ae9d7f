"""The scan folder a cell runs on and the priors of its pass.

`write_scan` writes what the engine reads from disk into the run's
`TMPDIR`: the images (8-bit PNG), the cameras, `pair.txt` with every other
view as a source and the SA segment maps. `make_priors` makes each view's
previous-pass maps (depth, normal, weak class, confidence) from the
scene's analytic ones with the traffic's perturbation, on the device and
from the seed. `RawScan` holds what both sides are handed: the images as
the engine's reader converts them, the SA maps and the priors; both read
the cameras from the scan's files. The writers are frozen copies of the
port's (`reference.plain.io`).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .reference.plain.config import STRONG, WEAK
from .reference.plain.io.binmat import write_bin_mat
from .reference.plain.io.cameras import write_camera, write_pair
from .reference.plain.io.images import write_png
from .scene import Scene


@dataclasses.dataclass
class RawScan:
    root: Path
    gray: List[np.ndarray]          # (H, W) f32, the engine reader's values
    sa: List[np.ndarray]            # (H, W) u8 segment ids
    priors: List[Dict[str, np.ndarray]]   # depths, normals, weak, confidence
    sources: List[List[int]]


def gray_of(img8: np.ndarray) -> np.ndarray:
    """A gray PNG's values as the engine's reader gives them: the luma of
    the grey replicated over three channels, in float32."""
    rgb = np.repeat(img8[..., None], 3, axis=2).astype(np.float32)
    return (rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587
            + rgb[..., 2] * 0.114).astype(np.float32)


def make_priors(scene: Scene, traffic: dict, seed: int) -> List[dict]:
    """Each view's previous-pass maps: the analytic depth times (1 + a
    normal draw of ``prior_depth_sigma``) with ``prior_outlier_share`` of
    the pixels drawn anew over the view's depth range, the analytic normal
    plus a normal draw of ``prior_normal_sigma`` (normalised), WEAK on the
    low-texture segment and STRONG elsewhere, and the confidence a
    consistent view gives (1 + 5 for each of the top 4 views; the weak
    segment and the outliers fewer)."""
    dev = scene.depths.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 2654435761 + 97) % (1 << 63))
    out = []
    for v, cam in enumerate(scene.cameras):
        gt = scene.depths[v]
        shape = gt.shape
        depth = gt * (1.0 + float(traffic["prior_depth_sigma"]) * torch.randn(
            shape, generator=gen, device=dev))
        outlier = torch.rand(shape, generator=gen, device=dev) \
            < float(traffic["prior_outlier_share"])
        anew = cam.depth_min + (cam.depth_max - cam.depth_min) * torch.rand(
            shape, generator=gen, device=dev)
        depth = torch.where(outlier, anew, depth)
        normal = scene.normals[v] + float(traffic["prior_normal_sigma"]) \
            * torch.randn(shape + (3,), generator=gen, device=dev)
        normal = normal / torch.linalg.vector_norm(normal, dim=-1,
                                                   keepdim=True)
        weak_seg = scene.segments[v] == 1
        weak = torch.where(weak_seg, WEAK, STRONG).to(torch.uint8)
        conf = torch.where(weak_seg, 6, 21) - 10 * outlier.to(torch.int64)
        out.append(dict(
            depths=depth.to(torch.float32).cpu().numpy(),
            normals=normal.to(torch.float32).cpu().numpy(),
            weak=weak.cpu().numpy(),
            confidence=conf.clamp(min=1).to(torch.uint8).cpu().numpy()))
    return out


def write_scan(root: Path, scene: Scene, traffic: dict, seed: int,
               sources: int) -> RawScan:
    """Write the scan folder under ``root`` and return what both sides
    are handed. ``sources`` views a reference view, the nearest by index
    (every other view where the scan has ``sources`` + 1)."""
    root = Path(root)
    for sub in ("images", "cams", "sa_masks"):
        os.makedirs(root / sub, exist_ok=True)
    v_count = len(scene.cameras)
    entries, src_lists, gray, sa = [], [], [], []
    segments = scene.segments.to(torch.uint8).cpu().numpy()
    for v in range(v_count):
        write_png(root / "images" / f"{v:08d}.png", scene.images[v])
        write_camera(root / "cams" / f"{v:08d}_cam.txt", scene.cameras[v])
        write_bin_mat(root / "sa_masks" / f"{v:08d}.bin", segments[v])
        near = sorted((u for u in range(v_count) if u != v),
                      key=lambda u: (abs(u - v), u))[:sources]
        entries.append((v, [(u, float(v_count - abs(u - v))) for u in near]))
        src_lists.append(near)
        gray.append(gray_of(scene.images[v]))
        sa.append(segments[v])
    write_pair(root / "pair.txt", entries)
    return RawScan(root, gray, sa,
                   make_priors(scene, traffic, seed), src_lists)


def bytes_written(scan: RawScan) -> int:
    """The bytes the scan folder holds."""
    return sum(p.stat().st_size for p in scan.root.rglob("*") if p.is_file())
