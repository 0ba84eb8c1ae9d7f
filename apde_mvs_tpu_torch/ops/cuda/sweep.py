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

The kernel (``csrc/sweep.cu``) runs the whole sweep inside one launch: a
warp a pixel, only the pixel's weighted (pixel, view) pairs, in view
order, its probes across the warp's lanes, the view sum in each lane's
registers; only the curve is written. What bounds it on the H100:
operations (for every probe and weighted pair, K2's 38 f32 operations a
tap and 90 a pair, and 115 for the geometric cost).

The plain version fixes every operation's order: the probe depth of
``probe_depths``, the plane's w of ``geometry.plane_dist_to_origin`` with
its three products summed in order, K2's plain NCC (``ncc_strong_plain``),
``cost.geom_cost``'s torch ops, then the view sum as ordered adds over
s = 0 .. S-1 (torch's ``.sum`` has a device-dependent order). The kernel
computes the same sequence with every operation rounded on its own, so the
two agree bit for bit on the card.

The stage form (``stage_fused``, ``filters.depth_to_weak`` and
``filters.local_refine`` on the main path) is the whole JAX function in
one launch, with no torch op around it: the setup from the state's maps
(``filters._sweep_scalars``, its sums in view order), the reference window
built in the kernel as K3 builds it (``strong.window_plain``), the sweep,
and the decision rule (``filters._classify_peaks``: the int32 classes, and
the curve on request; ``filters._refine_depths``: the new depths). Its
plain version is ``stage_plain``. The sweep form (``sweep_fused``) takes a
chunk's per-pixel inputs and window and writes the costs.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches of
either form, and ``mode_launches`` splits them into "classify" and
"refine".
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ...config import RELIABLE_CURVE_SAMPLE_NUM
from ...core.sampling import device_constant, fetch
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
    lib.apde_sweep_stage.argtypes = [
        ptr, i32, ptr, ptr, i32, i32, f32, ptr, ptr, ptr, ptr, ptr, ptr, i32,
        i32, ptr, ptr, i32, ptr, i32, i32, f32, f32, f32, i32, f32, i32, ptr,
        ptr, ptr, ctypes.c_int64, i32, i32, i32, i32, i32, ptr]
    lib.apde_sweep_stage.restype = i32
    lib.apde_sweep_stage_kernel_info.argtypes = [i32] * 4 + [ptr] * 3
    lib.apde_sweep_stage_kernel_info.restype = i32
    for fn in (lib.apde_sweep_max_views, lib.apde_sweep_cam_stride):
        fn.argtypes = []
        fn.restype = i32
    lib.apde_sweep_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.apde_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.apde_sweep_kernel_info.argtypes = [i32] * 5 + [ptr] * 3
    lib.apde_sweep_kernel_info.restype = i32
    if (lib.apde_sweep_max_views(), lib.apde_sweep_cam_stride()) \
            != (MAX_VIEWS, CAM_STRIDE):
        raise RuntimeError("csrc/sweep.cu's view limit or camera table "
                           "differs from the wrapper's")
    return built


def kernel_info(quads_u8: bool, pixel_offsets: bool, weighted: bool,
                num_taps: int, num_views: int) -> dict:
    """The kernel instantiation's registers, local memory (spill) bytes and
    resident blocks an SM at ``num_views`` views, from the CUDA runtime."""
    return ncc.read_kernel_info(library().lib.apde_sweep_kernel_info,
                                quads_u8, pixel_offsets, weighted, num_taps,
                                num_views)


def stage_kernel_info(quads_u8: bool, sa: bool, num_taps: int,
                      num_views: int) -> dict:
    """The same for the stage form's instantiation (SA window or the
    square)."""
    return ncc.read_kernel_info(library().lib.apde_sweep_stage_kernel_info,
                                quads_u8, sa, num_taps, num_views)


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


def view_distances(data) -> torch.Tensor:
    """(S,) f32 distances |c_ref - c_src| of the source cameras from the
    reference's, whose selection-gated mean is a pixel's baseline."""
    return torch.linalg.vector_norm(
        data.ref_cam.c[None, :] - data.src_cams.c, dim=-1).contiguous()


_distances: dict = {}   # id(CostData) -> (weak reference, distances)


def cached_view_distances(data) -> torch.Tensor:
    """``view_distances(data)``, computed once per CostData object and
    dropped with it."""
    return ncc.cache_per_data(_distances, data, view_distances)


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
    d = disp[:, None] + device_constant(
        ("probe_offsets", tuple(offsets)),
        lambda: np.asarray(offsets, np.float32), disp.device)
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
                                     int(weighted))
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


# ---------------------------------------------------------------------------
# The stage form: DepthToWeak and LocalRefine whole
# ---------------------------------------------------------------------------

# DepthToWeak's margin: pixels within it come out UNKNOWN (the pipeline
# skips them)
MIN_MARGIN = 6


def stage_plain(data, state, x, y, *, refine: bool, radius: int,
                increment: int, use_sa: bool, geom: bool, geom_factor,
                depth_min, depth_max, weak_peak_radius=0,
                return_curve: bool = False):
    """DepthToWeak (``refine`` False: (int32 classes (B,), the (B, 61)
    curve with ``return_curve`` or None)) or LocalRefine (the (B,) new
    depths) of pixels (x, y) int32 as torch ops, in the stage kernel's
    operation order: ``filters._sweep_scalars``' setup (its sums in view
    order), ``strong.window_plain``'s window, ``sweep_plain``, then
    ``filters._classify_peaks`` or ``filters._refine_depths``."""
    from .. import filters
    from .strong import window_plain
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    sc = filters._sweep_scalars(data, state, x, y)
    win = window_plain(data, xf, yf, radius, increment, use_sa)
    px = SweepPixels(xf, yf, sc.plane_cam, sc.disp, sc.base_line, sc.vw,
                     sc.wnorm)
    costs = sweep_plain(data, px, win, refine=refine, geom=geom,
                        geom_factor=geom_factor, depth_min=depth_min,
                        depth_max=depth_max)
    if refine:
        ok = sc.ok & (sc.wnorm > 0) & fetch(state.valid, x, y)
        return torch.where(ok, filters._refine_depths(data, sc, costs),
                           sc.depth)
    weak = filters._classify_peaks(data, state, x, y, costs,
                                   weak_peak_radius, sc.ok)
    return weak, (costs if return_curve else None)


def _check_stage_args(data, state, x, y, radius, increment, use_sa,
                      geom: bool) -> tuple:
    """The view limit and quad tables, the window's radius and increment,
    the pixels, the state's maps, the reference image and segment ids and
    the source depths, on every device. Returns (B, T, SA on, {name:
    tensor})."""
    from ..cost import square_taps
    if x.ndim != 1 or y.shape != x.shape:
        raise ValueError(f"pixels x {tuple(x.shape)}, y {tuple(y.shape)}: "
                         "need (B,) and (B,)")
    b = x.shape[0]
    ncc.check_tables(data)
    if int(radius) != radius or int(increment) != increment or radius < 0 \
            or increment < 1:
        raise ValueError(f"window radius {radius}, increment {increment}: "
                         "need integers >= 0 and >= 1")
    t = len(square_taps(int(radius), int(increment)))
    sa = bool(use_sa) and data.sa_mask is not None
    if sa and t != 36:
        raise ValueError("SA mixing assumes 36-tap square windows")
    s = data.num_src
    grid = tuple(state.planes.shape[:2])
    image = (data.height, data.width)
    want = {"planes": (state.planes, grid + (4,), torch.float32),
            "view_weights": (state.view_weights, grid + (s,),
                             torch.float32),
            "selected": (state.selected, grid + (s,), torch.bool),
            "valid": (state.valid, grid, torch.bool),
            "x": (x, (b,), torch.int32), "y": (y, (b,), torch.int32),
            "ref_image": (data.ref_image, image, torch.float32)}
    if sa:
        want["sa_mask"] = (data.sa_mask, image, torch.int32)
    if geom:
        depths = data.src_depths
        if depths.ndim != 3:
            raise ValueError(f"src_depths must be (S, H, W), got "
                             f"{tuple(depths.shape)}")
        want["src_depths"] = (depths, (s,) + tuple(depths.shape[1:]),
                              torch.float32)
    dev = data.src_quads.device
    for name, (a, shape, dtype) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} is {tuple(a.shape)}, expected {shape}")
        if a.dtype != dtype:
            raise TypeError(f"{name} has dtype {a.dtype}, expected {dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the quad tables on "
                             f"{dev}")
    return b, t, sa, {name: a for name, (a, _, _) in want.items()}


def stage_fused(data, state, x, y, *, refine: bool, radius: int,
                increment: int, use_sa: bool, geom: bool, geom_factor,
                depth_min, depth_max, weak_peak_radius=0,
                return_curve: bool = False):
    """DepthToWeak (``refine`` False) or LocalRefine (``refine``) of pixels
    (x, y) (B,) int32 from the state's maps (a ``PMState``: planes as
    (world normal, depth), selections, view weights, valid mask) against
    every source view of ``data``: the setup, the reference window of
    (``radius``, ``increment``, ``use_sa``) and the decision rule in one
    launch of the stage form, its result ``stage_plain``'s. The scalars
    are best Python numbers (a device tensor's value is read back, which
    waits for the device). Every tensor must be contiguous on CUDA."""
    b, t, sa, tensors = _check_stage_args(data, state, x, y, radius,
                                          increment, use_sa, geom)
    kw = dict(refine=refine, radius=radius, increment=increment,
              use_sa=use_sa, geom=geom, geom_factor=geom_factor,
              depth_min=depth_min, depth_max=depth_max,
              weak_peak_radius=weak_peak_radius, return_curve=return_curve)
    quads = data.src_quads
    if quads.device.type == "cpu":
        return stage_plain(data, state, x, y, **kw)
    if quads.device.type != "cuda":
        raise ValueError(f"unsupported device {quads.device}")
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not quads.is_contiguous():
        raise ValueError("quads must be contiguous")
    if quads.data_ptr() % (4 * quads.element_size()):
        raise ValueError("quad table rows must be aligned to their size")
    lib = library().lib
    smem = lib.apde_sweep_smem_bytes(data.num_src, t, int(sa), int(sa))
    if smem > SMEM_LIMIT:
        raise ValueError(f"a {t}-tap window needs {smem} B of shared memory "
                         f"a block, more than {SMEM_LIMIT}")
    cams = cached_camera_table(data)
    dists = cached_view_distances(data)
    for name, a in (("cameras", cams), ("distances", dists)):
        if a.device != quads.device:
            raise ValueError(f"{name} on {a.device}, the quad tables on "
                             f"{quads.device}")
    dev = quads.device
    weak = curve = depth = None
    if refine:
        depth = torch.empty((b,), dtype=torch.float32, device=dev)
    else:
        weak = torch.empty((b,), dtype=torch.int32, device=dev)
        if return_curve:
            curve = torch.empty((b, len(CLASSIFY_OFFSETS)),
                                dtype=torch.float32, device=dev)
    result = depth if refine else (weak, curve)
    if b == 0:
        return result
    global launches
    launches += 1
    mode = "refine" if refine else "classify"
    mode_launches[mode] = mode_launches.get(mode, 0) + 1
    depths = data.src_depths
    gh, gw = state.planes.shape[:2]
    ncc._raise_on(lib.apde_sweep_stage(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        depths.data_ptr() if geom else None,
        depths.shape[1] if geom else 0, depths.shape[2] if geom else 0,
        _f32(geom_factor), x.data_ptr(), y.data_ptr(),
        state.planes.data_ptr(), state.selected.data_ptr(),
        state.view_weights.data_ptr(), state.valid.data_ptr(), gh, gw,
        dists.data_ptr(), data.ref_image.data_ptr(), data.height,
        data.sa_mask.data_ptr() if sa else None, int(radius),
        int(increment), float(np.float32(1.0) / np.float32(t)),
        _f32(depth_min), _f32(depth_max), int(refine),
        _f32(weak_peak_radius), MIN_MARGIN,
        None if refine else weak.data_ptr(),
        None if curve is None else curve.data_ptr(),
        depth.data_ptr() if refine else None, b, data.num_src, data.width,
        data.quad_h, data.img_w, data.img_h,
        torch.cuda.current_stream(dev).cuda_stream), "apde_sweep_stage")
    return result
