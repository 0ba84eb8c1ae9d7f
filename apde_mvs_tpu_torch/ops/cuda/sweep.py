"""K5 — the disparity sweeps of DepthToWeak and LocalRefine, with the
geometric cost K4 inside: CUDA kernel, its plain PyTorch version, and the
wrapper that picks between them by the tensors' device.

Replaces the probe loops of the JAX package's ``filters.depth_to_weak``
(``apde_mvs_tpu/ops/filters.py`` :234) and ``filters.local_refine`` (:476)
around ``_sweep_cost`` (:196) and ``cost.geom_cost`` (:418). For a chunk of
B pixels with fixed camera-frame normals, and every source view, each
probe depth gives a plane; its cost is the selection-gated weighted mean
over the views of K2's strong NCC (plus ``geom_factor`` times the
geometric cost), COST_MAX where the weight sum is 0 or the probe depth
leaves ``[depth_min, depth_max]``. Two modes:

- classify (DepthToWeak): 61 probes at disparity offsets -30 .. 30, each
  cost clamped at COST_MAX: the (B, 61) reliability curve;
- refine (LocalRefine): the current depth first (never depth-masked), then
  11 probes at offsets -5 .. 5: (B, 12) costs.

The kernel (``csrc/sweep.cu``) runs the probe loop inside one launch, K2's
layout (32 pixels x S views a block), the window staged once for every
probe; only the curve is written. What bounds it on the H100: operations
(K2's 38 f32 operations a tap for every probe and view).

The plain version fixes every operation's order: the probe depth of
``probe_depths``, the plane's w of ``geometry.plane_dist_to_origin`` with
its three products summed in order, K2's plain NCC (``ncc_strong_plain``),
``cost.geom_cost``'s torch ops, then the view sum as ordered adds over
s = 0 .. S-1 (torch's ``.sum`` has a device-dependent order). The kernel
computes the same sequence with every operation rounded on its own, so the
two agree bit for bit on the card.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches, and
``mode_launches`` splits them into "classify" and "refine".
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ...config import RELIABLE_CURVE_SAMPLE_NUM
from ..cost import COST_MAX, geom_cost
from . import build as _build
from . import ncc

launches = 0      # kernel launches since the last reset (plain runs excluded)
mode_launches: dict = {}   # the same launches by mode

MAX_VIEWS = ncc.MAX_VIEWS
CAM_STRIDE = 40   # csrc/sweep.cu kSweepCamStride
SMEM_LIMIT = ncc.SMEM_LIMIT
# disparity offsets of the swept probes: DepthToWeak's 61, LocalRefine's 11
CLASSIFY_OFFSETS = tuple(range(-(RELIABLE_CURVE_SAMPLE_NUM // 2),
                               RELIABLE_CURVE_SAMPLE_NUM // 2 + 1))
REFINE_OFFSETS = tuple(range(-5, 6))
_SOURCES = ("sweep.cu",)


class SweepPixels(NamedTuple):
    """A chunk's per-pixel inputs of the sweep."""

    x: torch.Tensor          # (B,) f32
    y: torch.Tensor          # (B,) f32
    plane: torch.Tensor      # (B, 4) camera-frame normal, current depth
    disp: torch.Tensor       # (B,) current disparity f * baseline / depth
    base_line: torch.Tensor  # (B,)
    vw: torch.Tensor         # (B, S) selection-gated view weights
    wnorm: torch.Tensor      # (B,) their sum


def reset_launches() -> None:
    global launches
    launches = 0
    mode_launches.clear()


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with its
    entry points' ctypes signatures declared."""
    built = _build.build("apde_sweep", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    f32 = ctypes.c_float
    lib.apde_sweep.argtypes = [
        ptr, i32, ptr, ptr, i32, i32, f32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, f32, f32, f32, i32, i32, i32,
        ptr, ctypes.c_int64, i32, i32, i32, i32, i32, i32, ptr]
    lib.apde_sweep.restype = i32
    for fn in (lib.apde_sweep_max_views, lib.apde_sweep_cam_stride):
        fn.argtypes = []
        fn.restype = i32
    lib.apde_sweep_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.apde_sweep_smem_bytes.restype = ctypes.c_longlong
    if (lib.apde_sweep_max_views(), lib.apde_sweep_cam_stride()) \
            != (MAX_VIEWS, CAM_STRIDE):
        raise RuntimeError("csrc/sweep.cu's view limit or camera table "
                           "differs from the wrapper's")
    return built


def camera_table(data) -> torch.Tensor:
    """(S + 1, 40) f32 per-view constants of the kernel: K2's 16 columns
    (``ncc.camera_table``), then each view's R (9, row major), t (3), K
    (9, row major) and world centre c (3) for the geometric cost; row S
    holds the reference camera's."""
    def columns(cam):
        n = cam.K.reshape(-1, 9).shape[0]
        return torch.cat([cam.R.reshape(n, 9), cam.t.reshape(n, 3),
                          cam.K.reshape(n, 9), cam.c.reshape(n, 3)], -1)
    geo_cols = torch.cat([columns(data.src_cams), columns(data.ref_cam)])
    return torch.cat([ncc.camera_table(data), geo_cols.to(torch.float32)],
                     -1).contiguous()


_tables: dict = {}    # id(CostData) -> (weak reference, camera table)


def cached_camera_table(data) -> torch.Tensor:
    """``camera_table(data)``, built once per CostData object and dropped
    with it."""
    return ncc.cache_per_data(_tables, data, camera_table)


def _f32(v) -> float:
    """A scalar parameter as the float32 value the sweep computes with."""
    return float(np.float32(float(v)))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def probe_depths(fx, disp, base_line, offsets) -> torch.Tensor:
    """(B, len(offsets)) depths at the disparity offsets from the current
    disparity: f * baseline / (disp + offset), 1e-20 for a zero
    denominator (reference: APD.cu:2165-2171)."""
    d = disp[:, None] + torch.as_tensor(offsets, dtype=torch.float32,
                                        device=disp.device)
    return (fx * base_line)[:, None] / torch.where(d != 0, d, 1e-20)


def sweep_plain(data, px: SweepPixels, win, *, refine: bool, geom: bool,
                geom_factor, depth_min, depth_max) -> torch.Tensor:
    """The sweep's (B, 61) classify curve or (B, 12) refine costs as torch
    ops, in the kernel's operation order."""
    cam = data.ref_cam
    offsets = REFINE_OFFSETS if refine else CLASSIFY_OFFSETS
    depths = probe_depths(cam.fx, px.disp, px.base_line, offsets)
    lo, hi = _f32(depth_min), _f32(depth_max)
    probes = [(depths[:, i], lo, hi) for i in range(len(offsets))]
    if refine:
        probes.insert(0, (px.plane[:, 3], -math.inf, math.inf))
    gf = _f32(geom_factor)
    n0, n1, n2 = px.plane[:, 0], px.plane[:, 1], px.plane[:, 2]
    cols = []
    for pd, lo, hi in probes:
        X = pd * (px.x - cam.cx) / cam.fx
        Y = pd * (px.y - cam.cy) / cam.fy
        w = -((n0 * X + n1 * Y) + n2 * pd)
        plane = torch.stack([n0, n1, n2, w], -1)
        cv = ncc.ncc_strong_plain(data, px.x, px.y, plane, win)   # (B, S)
        if geom:
            cv = cv + gf * geom_cost(data, px.x, px.y, plane)
        acc = torch.zeros_like(pd)
        for s in range(cv.shape[1]):
            acc = acc + px.vw[:, s] * cv[:, s]
        cost = acc / torch.clamp(px.wnorm, min=1e-20)
        cost = torch.where(px.wnorm > 0, cost, COST_MAX)
        cost = torch.where((pd >= lo) & (pd <= hi), cost, COST_MAX)
        cols.append(cost if refine else torch.clamp(cost, max=COST_MAX))
    return torch.stack(cols, 1)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _check_args(data, px: SweepPixels, win, geom: bool) -> tuple:
    """K2's checks of the pixels, planes, window and tables, then the
    sweep's own inputs, on every device. Returns (B, T, per-pixel offsets,
    {name: tensor})."""
    b, t, pixel_offsets, want = ncc._check_args(data, px.x, px.y, px.plane,
                                                win)
    tensors = {name: a for name, (a, _) in want.items()}
    s = data.num_src
    shapes = {"disp": (px.disp, (b,)), "base_line": (px.base_line, (b,)),
              "vw": (px.vw, (b, s)), "wnorm": (px.wnorm, (b,))}
    if geom:
        depths = data.src_depths
        shapes["src_depths"] = (depths, (s,) + tuple(depths.shape[1:]))
        if depths.ndim != 3:
            raise ValueError(f"src_depths must be (S, H, W), got "
                             f"{tuple(depths.shape)}")
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} is {tuple(a.shape)}, expected {shape}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {a.dtype}, expected float32")
        if a.device != data.src_quads.device:
            raise ValueError(f"{name} is on {a.device}, the quad tables on "
                             f"{data.src_quads.device}")
        tensors[name] = a
    return b, t, pixel_offsets, tensors


def sweep_fused(data, px: SweepPixels, win, *, refine: bool, geom: bool,
                geom_factor, depth_min, depth_max) -> torch.Tensor:
    """The disparity sweep of a chunk (``px``, over the reference window
    ``win``, a ``cost.RefWindow``) against every source view of ``data``
    (a ``cost.CostData``): DepthToWeak's (B, 61) curve, or with ``refine``
    LocalRefine's (B, 12) costs. With ``geom`` each view's cost adds
    ``geom_factor`` times the geometric cost against ``data.src_depths``.
    Every tensor must be contiguous on CUDA."""
    b, t, pixel_offsets, tensors = _check_args(data, px, win, geom)
    quads = data.src_quads
    if quads.device.type == "cpu":
        return sweep_plain(data, px, win, refine=refine, geom=geom,
                           geom_factor=geom_factor, depth_min=depth_min,
                           depth_max=depth_max)
    if quads.device.type != "cuda":
        raise ValueError(f"unsupported device {quads.device}")
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not quads.is_contiguous():
        raise ValueError("quads must be contiguous")
    if quads.data_ptr() % (4 * quads.element_size()):
        raise ValueError("quad table rows must be aligned to their size")
    offsets = REFINE_OFFSETS if refine else CLASSIFY_OFFSETS
    num_probes = len(offsets) + int(refine)
    weighted = win.tap_w is not None
    lib = library().lib
    smem = lib.apde_sweep_smem_bytes(data.num_src, t, int(pixel_offsets),
                                     int(weighted), num_probes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a {t}-tap window needs {smem} B of shared memory "
                         f"a block, more than {SMEM_LIMIT}")
    cams = cached_camera_table(data)
    if cams.device != quads.device:
        raise ValueError(f"cameras on {cams.device}, the quad tables on "
                         f"{quads.device}")
    if isinstance(win.wsum, torch.Tensor):
        wsum_ptr, inv = win.wsum.data_ptr(), 0.0
    else:
        wsum_ptr, inv = None, float(np.float32(1.0) / np.float32(win.wsum))
    depths = data.src_depths
    out = torch.empty((b, num_probes), dtype=torch.float32,
                      device=quads.device)
    if b == 0:
        return out
    global launches
    launches += 1
    mode = "refine" if refine else "classify"
    mode_launches[mode] = mode_launches.get(mode, 0) + 1
    ncc._raise_on(lib.apde_sweep(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        depths.data_ptr() if geom else None,
        depths.shape[1] if geom else 0, depths.shape[2] if geom else 0,
        _f32(geom_factor), px.x.data_ptr(), px.y.data_ptr(),
        px.plane.data_ptr(), px.disp.data_ptr(), px.base_line.data_ptr(),
        px.vw.data_ptr(), px.wnorm.data_ptr(), win.tap_dx.data_ptr(),
        win.tap_dy.data_ptr(), int(pixel_offsets), win.tap_val.data_ptr(),
        win.tap_w.data_ptr() if weighted else None, win.sum_ref.data_ptr(),
        win.sum_rr.data_ptr(), wsum_ptr, inv, _f32(depth_min),
        _f32(depth_max), int(refine), num_probes, offsets[0],
        out.data_ptr(), b, data.num_src, t, data.width, data.quad_h,
        data.img_w, data.img_h,
        torch.cuda.current_stream(quads.device).cuda_stream),
        "apde_sweep")
    return out
