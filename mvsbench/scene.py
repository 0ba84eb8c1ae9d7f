"""The benchmark's scenes: plane primitives ray-cast through pinhole cameras
on an arc, with a procedural texture, analytic depth and normal maps and a
segment id a pixel, made from the seed on the run's device.

A frozen form of the port's test-scene renderer (its `make_scene`: a tilted
textured background plane, a textured foreground rectangle and a
low-texture rectangle for the weak region, cameras on a horizontal arc
looking at one target), written in torch float64 so that a scan of tens of
views at full resolution renders on the card in a second. The texture's
frequencies scale with the focal length, so a texel period in pixels is the
same at every resolution (5 to 90 pixels at the reference depth).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .reference.plain.io.cameras import Camera

# the base texture's angular frequencies (world units at focal 160 px)
TEXTURE_FREQS = (1.7, 3.9, 8.3, 17.0, 31.0)
BASE_FOCAL = 160.0
WEAK_AMPLITUDE = 1.5           # the low-texture segment's amplitude


@dataclasses.dataclass
class Plane:
    """World plane n . X + w = 0 over an optional x/y rectangle."""

    normal: Tuple[float, float, float]
    w: float
    bounds: Optional[Tuple[float, float, float, float]]
    amplitude: float
    segment: int


@dataclasses.dataclass
class Scene:
    cameras: List[Camera]
    images: np.ndarray          # (V, H, W) uint8
    depths: torch.Tensor        # (V, H, W) f32, analytic
    normals: torch.Tensor       # (V, H, W, 3) f32 world-frame unit normals
    segments: torch.Tensor      # (V, H, W) int32 primitive segment ids


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def look_at(center, target, up, K) -> Camera:
    z = _unit(np.asarray(target) - np.asarray(center))
    x = _unit(np.cross(z, up))
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return Camera(K=K, R=R, t=-R @ np.asarray(center, np.float64))


def primitives(cfg: dict, weak_share: float, height: int, width: int,
               focal: float) -> List[Plane]:
    """The scene's planes: the tilted background (segment 0), with a
    weak share a fronto-parallel low-texture rectangle at 0.82 of the
    depth sized to cover that share of the middle view (segment 1), and a
    textured foreground rectangle at 0.6 of the depth off the axis
    (segment 2)."""
    d = float(cfg["plane_depth"])
    n = _unit([0.25, -0.15, -1.0])
    planes = [Plane(tuple(n), float(-n @ np.array([0.0, 0.0, d])), None,
                    float(cfg["texture_amplitude"]), 0)]
    if weak_share > 0:
        z = 0.82 * d
        half_w = 0.5 * z * width * math.sqrt(weak_share) / focal
        half_h = 0.5 * z * height * math.sqrt(weak_share) / focal
        planes.append(Plane((0.0, 0.0, -1.0), z, (-half_w, half_w, -half_h,
                                                   half_h),
                            WEAK_AMPLITUDE, 1))
    z = 0.6 * d
    fx, fy = 0.5 * z * width / focal, 0.5 * z * height / focal
    nf = _unit([0.05, 0.0, -1.0])
    planes.append(Plane(tuple(nf), float(-nf @ np.array([0.0, 0.0, z])),
                        (-0.95 * fx, -0.45 * fx, 0.35 * fy, 0.9 * fy),
                        float(cfg["texture_amplitude"]), 2))
    return planes


def _texture(X: torch.Tensor, amplitude: float, scale: float,
             dirs: torch.Tensor, phases: torch.Tensor) -> torch.Tensor:
    """The procedural texture at world points X (..., 3), about 0..255: a
    sinusoid a frequency along ``dirs`` (F, 3) with ``phases`` (F,)."""
    val = torch.zeros(X.shape[:-1], dtype=torch.float64, device=X.device)
    for f, w, ph in zip(TEXTURE_FREQS, dirs, phases):
        val += torch.sin(f * scale * (X @ w) + ph)
    return torch.clamp(127.5 + amplitude * val / math.sqrt(5.0), 0.0, 255.0)


def render(cam: Camera, planes: List[Plane], textures: list, height: int,
           width: int, device) -> tuple:
    """Ray-cast the planes for one camera: (image f64, depth f64, normal
    f64 (H, W, 3), segment int32); the nearest plane wins a pixel."""
    K = cam.K
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float64, device=device),
        torch.arange(width, dtype=torch.float64, device=device),
        indexing="ij")
    d_cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                         torch.ones_like(xs)], -1)
    R = torch.as_tensor(cam.R, dtype=torch.float64, device=device)
    c = torch.as_tensor(cam.c, dtype=torch.float64, device=device)
    d_world = d_cam @ R
    depth = torch.full((height, width), math.inf, dtype=torch.float64,
                       device=device)
    img = torch.zeros_like(depth)
    nrm = torch.zeros((height, width, 3), dtype=torch.float64, device=device)
    seg = torch.zeros((height, width), dtype=torch.int32, device=device)
    for pl, tex in zip(planes, textures):
        n = torch.as_tensor(pl.normal, dtype=torch.float64, device=device)
        tt = -(pl.w + c @ n) / (d_world @ n)
        X = c + tt[..., None] * d_world
        hit = (tt > 0) & torch.isfinite(tt)
        if pl.bounds is not None:
            x0, x1, y0, y1 = pl.bounds
            hit &= (X[..., 0] >= x0) & (X[..., 0] <= x1) \
                & (X[..., 1] >= y0) & (X[..., 1] <= y1)
        z_cam = tt * d_cam[..., 2]
        hit &= z_cam < depth
        img = torch.where(hit, tex(X), img)
        nrm = torch.where(hit[..., None], n.expand_as(nrm), nrm)
        seg = torch.where(hit, pl.segment, seg)
        depth = torch.where(hit, z_cam, depth)
    depth = torch.where(torch.isfinite(depth), depth, 0.0)
    return img, depth, nrm, seg


def make_scene(cfg: dict, weak_share: float, seed: int, device) -> Scene:
    """The configuration's scan: every view's u8 image (with a per-view
    gain and bias drawn from the configuration's ``texture_seed`` and
    pixel noise drawn from ``seed``), its camera with the depth range the
    converter would write, and its analytic maps. The geometry, the
    texture and each view's gain and bias are the configuration's, so
    that a seed changes no image's contrast; the seed draws the noise."""
    h, w, v = int(cfg["height"]), int(cfg["width"]), int(cfg["views"])
    focal = float(cfg["focal_per_width"]) * w
    K = np.array([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0],
                  [0.0, 0.0, 1.0]])
    planes = primitives(cfg, weak_share, h, w, focal)
    scale = focal / BASE_FOCAL
    textures = []
    tex_gen = torch.Generator(device=device)
    tex_gen.manual_seed(int(cfg["texture_seed"]))
    for pl in planes:
        dirs = torch.randn((len(TEXTURE_FREQS), 3), generator=tex_gen,
                           dtype=torch.float64, device=device)
        phases = torch.rand(len(TEXTURE_FREQS), generator=tex_gen,
                            dtype=torch.float64, device=device) * 2 * math.pi
        textures.append(lambda X, a=pl.amplitude, d=dirs, p=phases:
                        _texture(X, a, scale, d, p))
    d = float(cfg["plane_depth"])
    target = np.array([0.0, 0.0, d])
    up = np.array([0.0, -1.0, 0.0])
    cams, imgs, deps, nrms, segs = [], [], [], [], []
    photo = torch.randn((v, 2), generator=tex_gen, dtype=torch.float64,
                        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for i in range(v):
        off = (i - (v - 1) / 2.0) * float(cfg["baseline"])
        cam = look_at(np.array([off, 0.05 * off, 0.0]), target, up, K)
        img, dep, nrm, seg = render(cam, planes, textures, h, w, device)
        valid = dep[dep > 0]
        cam.depth_min = float(valid.min()) * 0.8
        cam.depth_max = float(valid.max()) * 1.2
        cam.interval = (cam.depth_max - cam.depth_min) / 192.0
        cam.width, cam.height = w, h
        gain = 1.0 + float(cfg["gain_sigma"]) * photo[i, 0]
        bias = float(cfg["bias_sigma"]) * photo[i, 1]
        noise = torch.randn((h, w), generator=gen, dtype=torch.float64,
                            device=device) * float(cfg["noise_sigma"])
        img = torch.clamp(gain * img + bias + noise, 0.0, 255.0)
        cams.append(cam)
        imgs.append(img.to(torch.uint8))
        deps.append(dep.to(torch.float32))
        nrms.append(nrm.to(torch.float32))
        segs.append(seg)
    return Scene(cams, torch.stack(imgs).cpu().numpy(), torch.stack(deps),
                 torch.stack(nrms), torch.stack(segs))

