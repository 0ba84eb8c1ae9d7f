"""K7 — the weak sweep's chunk update: CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by the tensors' device.

Replaces the weak chunk body the JAX package leaves to XLA
(``apde_mvs_tpu/ops/propagation.py:739`` ``_weak_body``): for each weak
pixel of a chunk, the reference side of its deformable NCC (the centre
window and its 8 anchors' sparse windows), the 10 plane slots (the 8
anchor candidates, the current plane, the fit plane) against every view
through K6's deformable NCC (with the geometric cost K4 when the pass is
geometric), the joint view selection (the existing anchors' priors, the
sampling probabilities, 15 Monte-Carlo samples from the injected
uniforms), the adoption of the best candidate, the fit-plane test, the 5
refinement hypotheses from the injected draws costed over the selected
views, and the REFINE_INIT commit. ``propagation._weak_body`` is one call
of ``weak_update_fused``; the body it replaced (two K6 launches and ~250
torch ops a chunk) is ``testing/weak_composition.py``'s
``weak_body_composition``.

The kernel (``csrc/weak_sweep.cu``) runs the whole update in one launch: a
warp a pixel, its (plane, view) pairs across the lanes; it builds each
pixel's reference side from ``data.ref_image`` (and, under SA,
``data.sa_mask``) itself, so the inputs are the image, the state, the
pixels, their anchors and fit planes and the draws, and only the four
outputs are written. What bounds it on the H100: operations (K6's for
every evaluated pair, K4's, the selection's and the hypotheses').
``weak_update_timing`` runs timing-only forms that stop after a stage, for
``tools/kernel_split.py``.

The plain version fixes every operation's order: the reference side of
``deformable.WeakRefData.build`` with its sums in tap order
(``weak_ref_plain``), K6's plain deformable NCC (``weak.weak_plain``), the
selection of ``selection.ordered_*``, every view sum as ordered adds over
s = 0 .. S-1, K3's plain adoption and hypotheses
(``strong.adopt_plain``, ``strong.refinement_planes_plain``: lengths in
float64), every division a true one between tensors. The kernel computes
the same sequence with every operation rounded on its own, so the two agree
bit for bit on the card.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches and
``chunks`` the weak-sweep chunks they updated (one launch each).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ...config import STRONG
from ...core import geometry as geo
from ...core.sampling import clamped_fetch, fetch
from .. import selection
from ..cost import COST_MAX, GEOM_COST_MAX, RefWindow, square_taps
from ..deformable import WeakRefData
from . import build as _build
from . import ncc, strong, sweep, weak
from .strong import ordered_sum, weighted_sum
from .sweep import _f32

launches = 0      # kernel launches since the last reset (plain runs excluded)
chunks = 0        # weak-sweep chunks those launches updated

MAX_VIEWS = ncc.MAX_VIEWS
CAM_STRIDE = sweep.CAM_STRIDE   # the camera table is K5's
SMEM_LIMIT = ncc.SMEM_LIMIT
NUM_SAMPLES = selection.NUM_SAMPLES
NUM_HYPOTHESES = strong.NUM_HYPOTHESES
ANCHORS = weak.ANCHORS
_SOURCES = ("weak_sweep.cu",)


class WeakOutputs(NamedTuple):
    """A weak-sweep chunk's per-pixel outputs."""

    planes: torch.Tensor     # (B, 4)
    costs: torch.Tensor      # (B,)
    selected: torch.Tensor   # (B, S) bool
    view_weights: torch.Tensor   # (B, S) f32 counts


def reset_launches() -> None:
    global launches, chunks
    launches = 0
    chunks = 0


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with its
    entry points' ctypes signatures declared."""
    built = _build.build("apde_weak_sweep", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    f32 = ctypes.c_float
    lib.apde_weak_sweep.argtypes = (
        [ptr, i32, ptr, ptr, i32, i32, f32, ptr, ptr, ptr, i32, i32, ptr,
         ptr, ptr, ptr, ptr, i32, ptr, i32, i32, i32, i32, ptr, ptr, ptr,
         ptr, ptr, f32, f32, f32, f32, i32, ptr, ptr, ptr, ptr,
         ctypes.c_int64, i32, i32, i32, i32, i32, i32, ptr])
    lib.apde_weak_sweep.restype = i32
    for fn in (lib.apde_weak_sweep_max_views, lib.apde_weak_sweep_cam_stride,
               lib.apde_weak_sweep_num_samples):
        fn.argtypes = []
        fn.restype = i32
    lib.apde_weak_sweep_smem_bytes.argtypes = [i32] * 7
    lib.apde_weak_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.apde_weak_sweep_kernel_info.argtypes = [i32] * 8 + [ptr] * 3
    lib.apde_weak_sweep_kernel_info.restype = i32
    if (lib.apde_weak_sweep_max_views(), lib.apde_weak_sweep_cam_stride(),
            lib.apde_weak_sweep_num_samples()) \
            != (MAX_VIEWS, CAM_STRIDE, NUM_SAMPLES):
        raise RuntimeError("csrc/weak_sweep.cu's view limit, camera table or "
                           "sample count differs from the wrapper's")
    return built


def kernel_info(quads_u8: bool, sa: bool, geom: bool, num_views: int,
                windows=(5, 2, 5, 5)) -> dict:
    """The kernel instantiation's registers, local memory (spill) bytes and
    resident blocks an SM at ``num_views`` views, from the CUDA runtime:
    u8 or f32 tables, SA windows or not, the geometric cost or not, the
    windows (strong radius, increment, weak radius, increment)."""
    return ncc.read_kernel_info(library().lib.apde_weak_sweep_kernel_info,
                                quads_u8, sa, geom, *windows, num_views)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def weak_ref_plain(data, x, y, anchors, selected, strong_radius: int,
                   strong_increment: int, weak_radius: int,
                   weak_increment: int, use_sa: bool) -> WeakRefData:
    """The reference side K7 builds for weak pixels (x, y) f32 with their
    (B, 9, 2) anchors: ``deformable.WeakRefData.build``'s taps, weights,
    anchor masks and selections, every window's sums taken in tap order.
    The centre window is the square of (strong_radius, strong_increment);
    under SA a tap weighs 1 where the pixel is in no segment (id <= 0) or
    the tap's id is the pixel's (no star, no truncation), and the anchors'
    windows weigh against the weak pixel's segment too."""
    sa = bool(use_sa) and data.sa_mask is not None
    dev = x.device
    xi, yi = x.to(torch.int32), y.to(torch.int32)
    seg = fetch(data.sa_mask, xi, yi) if sa else None

    def weights(tx, ty):
        extra = (1,) * (tx.ndim - 1)
        keep = (seg <= 0).reshape(seg.shape + extra) \
            | (fetch(data.sa_mask, tx, ty) == seg.reshape(seg.shape + extra))
        return keep.to(torch.float32)

    def sums(val, w):
        """(sum_ref, sum_rr, weight sum) in tap order: the terms w v and
        (w v) v, the weights' count; T without weights."""
        wv = val if w is None else w * val
        count = torch.full(val.shape[:-1], float(val.shape[-1]), device=dev) \
            if w is None else w.sum(-1)
        return ordered_sum(wv), ordered_sum(wv * val), count

    if sa:
        sq = torch.as_tensor(square_taps(strong_radius, strong_increment),
                             device=dev)
        ctx, cty = xi[:, None] + sq[:, 0], yi[:, None] + sq[:, 1]
        cval = clamped_fetch(data.ref_image, ctx, cty)
        cw = weights(ctx, cty)
        centre = RefWindow(sq[:, 0].to(torch.float32),
                           sq[:, 1].to(torch.float32), cval, *sums(cval, cw),
                           cw)
    else:
        centre = strong.window_plain(data, x, y, strong_radius,
                                     strong_increment, False)
    ax, ay = anchors[:, 1:, 0], anchors[:, 1:, 1]
    exists = (ax >= 0) & (ay >= 0)
    axc, ayc = torch.clamp(ax, min=0), torch.clamp(ay, min=0)
    valid = exists
    if sa:
        valid = exists & ((seg <= 0)[:, None]
                          | (fetch(data.sa_mask, axc, ayc) == seg[:, None]))
    wk = torch.as_tensor(square_taps(weak_radius, weak_increment),
                         device=dev)
    tx, ty = axc[..., None] + wk[:, 0], ayc[..., None] + wk[:, 1]
    tval = clamped_fetch(data.ref_image, tx, ty)              # (B, 8, T')
    tw = weights(tx, ty) if sa else None
    sum_ref, sum_rr, wsum = sums(tval, tw)
    return WeakRefData(
        x=x, y=y, center_win=centre, anchor_x=ax.to(torch.float32),
        anchor_y=ay.to(torch.float32), anchor_valid=valid,
        anchor_sel=fetch(selected, axc, ayc), tap_val=tval, tap_w=tw,
        sum_ref=sum_ref, sum_rr=sum_rr, wsum=wsum)


class WeakStage(NamedTuple):
    """What a chunk's update holds before its refinement probes are costed:
    the reference side, the anchors' masks, the selection, the adopted or
    fitted plane and cost, and the 5 hypotheses of that plane."""

    wref: WeakRefData
    exists: torch.Tensor         # (B, 8) the anchor exists
    flags: torch.Tensor          # (B, 8) ... and is STRONG
    cur_plane: torch.Tensor      # (B, 4) the state's plane at the pixel
    vw: torch.Tensor             # (B, S) view weights
    sel_new: torch.Tensor        # (B, S) the selection the pixel keeps
    inv_norm: torch.Tensor       # (B,) 1 / wnorm, 0 without views
    has_views: torch.Tensor      # (B,)
    cost_recomputed: torch.Tensor    # (B,) the current plane's cost
    fit_ok: torch.Tensor         # (B,) the fit plane has a normal
    plane_cur: torch.Tensor      # (B, 4) after the adoption and fit test
    cost_cur: torch.Tensor       # (B,)
    hypotheses: torch.Tensor     # (B, 5, 4) refinement planes of plane_cur
    scalars: tuple               # depth_min, depth_max, geom_factor (0-d)


def weak_stage_plain(data, state, x, y, anchors, fit_planes, draws, *,
                     strong_radius: int, strong_increment: int,
                     weak_radius: int, weak_increment: int, use_sa: bool,
                     iteration, depth_min, depth_max, geom_factor,
                     geom: bool) -> WeakStage:
    """The chunk update of weak pixels (x, y) int32 as torch ops, in the
    kernel's operation order, up to the refinement hypotheses: the
    reference side, the 10 slots' costs (phase 0), the selection, the
    adoption and the fit-plane test."""
    dev = x.device
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    cam = data.ref_cam
    dmin, dmax, gf = (geo.f32_scalar(_f32(v), dev)
                      for v in (depth_min, depth_max, geom_factor))
    wref = weak_ref_plain(data, xf, yf, anchors, state.selected,
                          strong_radius, strong_increment, weak_radius,
                          weak_increment, use_sa)

    # the anchors: `exists` gates the priors, `flags` the cost array and
    # the adoption (wref.anchor_valid, the NCC)
    ax, ay = anchors[:, 1:, 0], anchors[:, 1:, 1]
    exists = (ax >= 0) & (ay >= 0)
    axc, ayc = torch.clamp(ax, min=0), torch.clamp(ay, min=0)
    flags = exists & (fetch(state.weak, axc, ayc) == STRONG)
    cand_planes = fetch(state.planes, axc, ayc)                # (B, 8, 4)
    cur_plane = fetch(state.planes, x, y)
    all_planes = torch.cat([cand_planes, cur_plane[:, None],
                            fit_planes[:, None]], 1).contiguous()
    costs, gcosts = weak.weak_plain(data, wref, all_planes, weak_radius,
                                    weak_increment, geom=geom)
    cost_array = torch.where(flags[..., None], costs[:, :ANCHORS], 0.0)
    # C aggregate-init quirk (APD.cu:1464): an unflagged anchor 0 leaves
    # cost_array[0][0] = 2.0
    cost_array[:, 0, 0] = torch.where(flags[:, 0], cost_array[:, 0, 0], 2.0)

    priors = selection.ordered_priors(wref.anchor_sel, exists)
    probs = selection.ordered_probabilities(
        cost_array, priors, *selection.selection_thresholds(iteration))
    vw, temp_sel, wnorm = selection.ordered_view_weights(draws.sel_u, probs)
    has_views = wnorm > 0
    inv_norm = torch.where(has_views, torch.ones_like(wnorm)
                           / torch.clamp(wnorm, min=1e-20), 0.0)

    # the geometric cost has no impetus gate here; an unflagged candidate
    # pays the flat GEOM_COST_MAX (APD.cu:1556-1576, 1589-1599)
    if geom:
        total = cost_array + gf * torch.where(flags[..., None],
                                              gcosts[:, :ANCHORS],
                                              GEOM_COST_MAX)
        own = costs[:, ANCHORS:] + gf * gcosts[:, ANCHORS:]
    else:
        total, own = cost_array, costs[:, ANCHORS:]
    final_costs = weighted_sum(vw[:, None, :], total) * inv_norm[:, None]
    cost_recomputed = torch.where(
        has_views, weighted_sum(vw, own[:, 0]) * inv_norm, COST_MAX)
    adopt, best_plane, best_cost = strong.adopt_plain(
        cam, xf, yf, cand_planes, flags, final_costs, cost_recomputed,
        has_views, dmin, dmax)
    plane_cur = torch.where(adopt[:, None], best_plane, cur_plane)
    cost_cur = torch.where(adopt, best_cost, cost_recomputed)
    sel_new = torch.where(adopt[:, None], temp_sel,
                          fetch(state.selected, x, y))

    # the fit-plane test (PlaneHypothesisRefinementWeak, APD.cu:1026-1052)
    fit_ok = (fit_planes[:, :3] != 0.0).any(-1)
    fit_cost = weighted_sum(vw, own[:, 1]) * inv_norm
    fit_depth = geo.depth_from_plane(cam, fit_planes, xf, yf)
    take_fit = fit_ok & (fit_depth >= dmin) & (fit_depth <= dmax) \
        & (fit_cost < cost_cur) & has_views
    plane_cur = torch.where(take_fit[:, None], fit_planes, plane_cur)
    cost_cur = torch.where(take_fit, fit_cost, cost_cur)

    depth_cur = geo.depth_from_plane(cam, plane_cur, xf, yf)
    hypotheses = strong.refinement_planes_plain(draws.raws, cam, xf, yf,
                                                plane_cur, depth_cur, dmin,
                                                dmax)
    return WeakStage(wref, exists, flags, cur_plane, vw, sel_new, inv_norm,
                     has_views, cost_recomputed, fit_ok, plane_cur, cost_cur,
                     hypotheses, (dmin, dmax, gf))


def weak_update_plain(data, state, x, y, anchors, fit_planes, draws, *,
                      strong_radius: int, strong_increment: int,
                      weak_radius: int, weak_increment: int, use_sa: bool,
                      iteration, depth_min, depth_max, geom_factor,
                      geom: bool, refine_init: bool) -> WeakOutputs:
    """The chunk update of weak pixels (x, y) int32 as torch ops, in the
    kernel's operation order: `weak_stage_plain`, then the hypotheses
    costed over the weighted views (phase 1), the first minimum taken where
    lower and the fit plane has a normal (no refinement without a fit: the
    early return at APD.cu:1029-1032), and the commit."""
    st = weak_stage_plain(
        data, state, x, y, anchors, fit_planes, draws,
        strong_radius=strong_radius, strong_increment=strong_increment,
        weak_radius=weak_radius, weak_increment=weak_increment,
        use_sa=use_sa, iteration=iteration, depth_min=depth_min,
        depth_max=depth_max, geom_factor=geom_factor, geom=geom)
    dmin, dmax, gf = st.scalars
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    pc, pg = weak.weak_plain(data, st.wref, st.hypotheses, weak_radius,
                             weak_increment, geom=geom, view_weights=st.vw)
    if geom:
        pc = pc + gf * pg
    r_costs = []
    for i in range(NUM_HYPOTHESES):
        d_i = geo.depth_from_plane(data.ref_cam, st.hypotheses[:, i], xf, yf)
        ok = (d_i >= dmin) & (d_i <= dmax) & st.has_views
        r_costs.append(torch.where(
            ok, weighted_sum(st.vw, pc[:, i]) * st.inv_norm, math.inf))
    r_costs = torch.stack(r_costs, 1)
    r_best = torch.argmin(r_costs, -1)[:, None]
    r_cost = torch.gather(r_costs, 1, r_best)[:, 0]
    r_plane = torch.gather(st.hypotheses, 1,
                           r_best[:, :, None].expand(-1, 1, 4))[:, 0]
    take = (r_cost < st.cost_cur) & st.fit_ok
    plane_cur = torch.where(take[:, None], r_plane, st.plane_cur)
    cost_cur = torch.where(take, r_cost, st.cost_cur)
    plane_cur, cost_cur = strong.commit_plain(plane_cur, cost_cur,
                                              st.cur_plane,
                                              st.cost_recomputed, refine_init)
    return WeakOutputs(plane_cur, cost_cur, st.sel_new, st.vw)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _check_args(data, state, x, y, anchors, fit_planes, draws, windows,
                use_sa: bool, geom: bool) -> tuple:
    """K2's checks of the quad tables, then the windows, the reference image
    and segment ids, the pixels, anchors and fit planes, the state, the
    draws and the source depths, on every device. Returns (B, SA on,
    {name: tensor})."""
    if x.ndim != 1 or y.shape != x.shape:
        raise ValueError(f"pixels x {tuple(x.shape)}, y {tuple(y.shape)}: "
                         "need (B,) and (B,)")
    b = x.shape[0]
    ncc.check_tables(data)
    if any(int(v) != v for v in windows) or windows[0] < 0 \
            or windows[2] < 0 or windows[1] < 1 or windows[3] < 1:
        raise ValueError(f"windows (radius, increment) x 2 {windows}: need "
                         "integers >= 0 and >= 1")
    sa = bool(use_sa) and data.sa_mask is not None
    s = data.num_src
    grid = tuple(state.costs.shape)
    if len(grid) != 2:
        raise ValueError(f"costs must be (H, W), got {grid}")
    raws = draws.raws
    image = (data.height, data.width)
    want = {
        "ref_image": (data.ref_image, image),
        "planes": (state.planes, grid + (4,)),
        "fit_planes": (fit_planes, (b, 4)),
        "sel_u": (draws.sel_u, (b, NUM_SAMPLES)),
        "u_rand": (raws.u_rand, (b,)), "g": (raws.g, (b, 3)),
        "u_pert": (raws.u_pert, (b,)), "angles": (raws.angles, (b, 3))}
    if geom:
        depths = data.src_depths
        if depths.ndim != 3:
            raise ValueError(f"src_depths must be (S, H, W), got "
                             f"{tuple(depths.shape)}")
        want["src_depths"] = (depths, (s,) + tuple(depths.shape[1:]))
    dev = data.src_quads.device
    ncc._check_tensors(want, dev)
    others = {"x": (x, (b,), torch.int32), "y": (y, (b,), torch.int32),
              "anchors": (anchors, (b, ANCHORS + 1, 2), torch.int32),
              "selected": (state.selected, grid + (s,), torch.bool),
              "weak": (state.weak, grid, torch.int32)}
    if sa:
        others["sa_mask"] = (data.sa_mask, image, torch.int32)
    for name, (a, shape, dtype) in others.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} is {tuple(a.shape)}, expected {shape}")
        if a.dtype != dtype:
            raise TypeError(f"{name} has dtype {a.dtype}, expected {dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the quad tables on "
                             f"{dev}")
    tensors = {name: a for name, (a, _) in want.items()}
    tensors.update((name, a) for name, (a, _, _) in others.items())
    return b, sa, tensors


def weak_update_fused(data, state, x, y, anchors, fit_planes, draws, *,
                      strong_radius: int, strong_increment: int,
                      weak_radius: int, weak_increment: int, use_sa: bool,
                      iteration, depth_min, depth_max, geom_factor,
                      geom: bool, refine_init: bool,
                      _stop: int = 0) -> WeakOutputs:
    """The weak sweep's update of a chunk of weak pixels (x, y) (B,) int32
    against every source view of ``data`` (a ``cost.CostData``): their
    ``anchors`` (B, 9, 2) int32 (x, y), -1 where missing, slot 0 the pixel
    itself, and ``fit_planes`` (B, 4) (zeros where there is no fit);
    ``state`` (a ``PMState``) gives the planes, pixel states and selections
    the anchors are read from, ``draws`` (a ``propagation.SweepDraws``) the
    selection uniforms and refinement draws. The centre window is the
    square of (``strong_radius``, ``strong_increment``), the anchors' the
    square of (``weak_radius``, ``weak_increment``), SA-weighted with
    ``use_sa`` and ``data.sa_mask``. With ``geom`` each view's cost adds
    ``geom_factor`` times the geometric cost against ``data.src_depths``;
    ``refine_init`` is REFINE_INIT's commit rule. The depth bounds and the
    geometric factor are best Python numbers: a device tensor's value is
    read back, which waits for the device. Every tensor must be contiguous
    on CUDA. ``_stop`` is for `weak_update_timing` only."""
    windows = (strong_radius, strong_increment, weak_radius, weak_increment)
    b, sa, tensors = _check_args(data, state, x, y, anchors, fit_planes,
                                 draws, windows, use_sa, geom)
    kw = dict(strong_radius=strong_radius, strong_increment=strong_increment,
              weak_radius=weak_radius, weak_increment=weak_increment,
              use_sa=use_sa, iteration=iteration, depth_min=depth_min,
              depth_max=depth_max, geom_factor=geom_factor, geom=geom,
              refine_init=refine_init)
    quads = data.src_quads
    if quads.device.type == "cpu":
        return weak_update_plain(data, state, x, y, anchors, fit_planes,
                                 draws, **kw)
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
    s = data.num_src
    windows = tuple(int(v) for v in windows)
    smem = lib.apde_weak_sweep_smem_bytes(s, *windows, int(sa), int(geom))
    if smem > SMEM_LIMIT:
        taps = [len(square_taps(*windows[i:i + 2])) for i in (0, 2)]
        raise ValueError(f"{taps[0]}- and {taps[1]}-tap windows at {s} views "
                         f"need {smem} B of shared memory a block, more than "
                         f"{SMEM_LIMIT}")
    cams = sweep.cached_camera_table(data)
    if cams.device != quads.device:
        raise ValueError(f"cameras on {cams.device}, the quad tables on "
                         f"{quads.device}")
    gh, gw = state.costs.shape
    threshold, fallback = selection.selection_thresholds(iteration)
    depths = data.src_depths
    out = WeakOutputs(
        torch.empty((b, 4), dtype=torch.float32, device=quads.device),
        torch.empty((b,), dtype=torch.float32, device=quads.device),
        torch.empty((b, s), dtype=torch.bool, device=quads.device),
        torch.empty((b, s), dtype=torch.float32, device=quads.device))
    if b == 0:
        return out
    raws = draws.raws
    global launches, chunks
    if not _stop:
        launches += 1
        chunks += 1
    ncc._raise_on(lib.apde_weak_sweep(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        depths.data_ptr() if geom else None,
        depths.shape[1] if geom else 0, depths.shape[2] if geom else 0,
        _f32(geom_factor), state.planes.data_ptr(),
        state.selected.data_ptr(), state.weak.data_ptr(), gh, gw,
        x.data_ptr(), y.data_ptr(), anchors.data_ptr(),
        fit_planes.data_ptr(), data.ref_image.data_ptr(), data.height,
        data.sa_mask.data_ptr() if sa else None, *windows,
        draws.sel_u.data_ptr(), raws.u_rand.data_ptr(), raws.g.data_ptr(),
        raws.u_pert.data_ptr(), raws.angles.data_ptr(), threshold, fallback,
        _f32(depth_min), _f32(depth_max), int(refine_init),
        out.planes.data_ptr(), out.costs.data_ptr(),
        out.selected.data_ptr(), out.view_weights.data_ptr(), b, s,
        data.width, data.quad_h, data.img_w, data.img_h, _stop,
        torch.cuda.current_stream(quads.device).cuda_stream),
        "apde_weak_sweep")
    return out


def weak_update_timing(stop: int, *args, **kw) -> WeakOutputs:
    """For measuring where K7's time goes, never on the main path: the
    kernel run up to a stage, on CUDA tensors with the main path's windows
    and u8 tables. ``stop`` 1 ends after the reference side, 2 after the
    selection, the adoption and the fit-plane test, 3 after the refinement
    hypotheses; the outputs hold what the stage computed, not the update.
    Counts no launch."""
    if stop not in (1, 2, 3):
        raise ValueError(f"stop must be 1, 2 or 3, got {stop}")
    if args[0].src_quads.device.type != "cuda":
        raise ValueError("weak_update_timing runs the kernel only")
    return weak_update_fused(*args, **kw, _stop=stop)
