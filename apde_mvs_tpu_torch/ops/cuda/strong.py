"""K3 — the strong checkerboard sweep's colour update: CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by the tensors'
device.

Replaces the colour update the JAX package leaves to XLA
(``apde_mvs_tpu/ops/propagation.py`` ``_strong_body`` :239-427): for each
pixel of one colour's flat batch, the 8 adaptive-region candidates, K2's
strong NCC of each against every source view, the joint view selection
(neighbour priors, sampling probabilities, 15 Monte-Carlo samples from the
injected uniforms), the adoption of the best candidate, the 5 refinement
hypotheses from the injected draws, each costed over the selected views
(with the geometric cost K4 when it is on), and the REFINE_INIT commit.
``propagation._strong_body`` is one call of ``strong_fused``; the torch-op
body it replaced is ``testing/strong_composition.py``. In its commit form
(``commit=True``, ``propagation.propagate_strong``'s serial route) the
kernel also commits: it writes the active pixels' (not WEAK, valid)
outputs into fresh copies of the state's maps, in place of the JAX
package's commit (``propagate_strong``, apde_mvs_tpu/ops/propagation.py
:429-460) as torch ops; ``commit_maps_plain`` is its plain version.

The kernel (``csrc/strong.cu``) runs the whole update in one launch: a warp
a pixel, its (plane, view) pairs across the lanes; it builds each pixel's
reference window from ``data.ref_image`` (and, under SA, ``data.sa_mask``)
itself, so the inputs are the image, the state, the pixels and the draws,
and only the four outputs are written. What bounds it on the H100:
operations (30 f32 operations a tap and 138 a pair for every evaluated
pair, K4's 115 a pair, the selection's and the hypotheses' per pixel).

The plain version fixes every operation's order: the window of
``cost.precompute_ref_window`` with its sums in tap order
(``window_plain``), K2's plain NCC (``ncc_strong_plain``),
``cost.geom_cost``'s torch ops, the selection of
``selection.ordered_*`` (the priors, the probabilities and the CDF as
ordered adds), every view sum as ordered adds over s = 0 .. S-1, the
hypotheses' norms and dot products written out x, y, z, every division a
true one between tensors. The kernel computes the same sequence with every
operation rounded on its own, so the two agree bit for bit on the card.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches,
``colours`` the colour updates they served (one launch each) and
``sa_launches`` those with an SA window.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...config import WEAK
from ...core import geometry as geo
from ...core.sampling import fetch
from .. import selection
from ..cost import COST_MAX, RefWindow, geom_cost, ref_window_taps, \
    square_taps
from . import build as _build
from . import ncc, sweep
from .sweep import _f32

launches = 0      # kernel launches since the last reset (plain runs excluded)
colours = 0       # colour updates those launches served
sa_launches = 0   # those launches whose window was SA's

MAX_VIEWS = ncc.MAX_VIEWS
CAM_STRIDE = sweep.CAM_STRIDE   # the camera table is K5's
SMEM_LIMIT = ncc.SMEM_LIMIT
NUM_SAMPLES = selection.NUM_SAMPLES
NUM_HYPOTHESES = 5
_SOURCES = ("strong.cu",)


class StrongOutputs(NamedTuple):
    """A colour update's per-pixel outputs."""

    planes: torch.Tensor     # (B, 4)
    costs: torch.Tensor      # (B,)
    selected: torch.Tensor   # (B, S) bool
    view_weights: torch.Tensor   # (B, S) f32 counts


def reset_launches() -> None:
    global launches, colours, sa_launches
    launches = 0
    colours = 0
    sa_launches = 0


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with its
    entry points' ctypes signatures declared."""
    built = _build.build("apde_strong", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    f32 = ctypes.c_float
    lib.apde_strong.argtypes = (
        [ptr, i32, ptr, ptr, i32, i32, f32, ptr, ptr, ptr, i32, i32, i32,
         i32, ptr, ptr, ptr, i32, ptr, i32, i32, f32, ptr, ptr, ptr, ptr,
         ptr, f32, f32, f32, f32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
         ctypes.c_int64, i32, i32, i32, i32, i32, ptr])
    lib.apde_strong.restype = i32
    for fn in (lib.apde_strong_max_views, lib.apde_strong_cam_stride,
               lib.apde_strong_num_samples):
        fn.argtypes = []
        fn.restype = i32
    lib.apde_strong_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.apde_strong_smem_bytes.restype = ctypes.c_longlong
    lib.apde_strong_kernel_info.argtypes = [i32] * 5 + [ptr] * 3
    lib.apde_strong_kernel_info.restype = i32
    lib.apde_strong_div_check.argtypes = [ptr, ptr, ctypes.c_int64, ptr, ptr]
    lib.apde_strong_div_check.restype = i32
    if (lib.apde_strong_max_views(), lib.apde_strong_cam_stride(),
            lib.apde_strong_num_samples()) \
            != (MAX_VIEWS, CAM_STRIDE, NUM_SAMPLES):
        raise RuntimeError("csrc/strong.cu's view limit, camera table or "
                           "sample count differs from the wrapper's")
    return built


def kernel_info(quads_u8: bool, sa: bool, radius: int, increment: int,
                num_views: int) -> dict:
    """The kernel instantiation's registers, local memory (spill) bytes and
    resident blocks an SM at ``num_views`` views, from the CUDA runtime:
    u8 or f32 tables, with or without SA, the window of (radius,
    increment)."""
    return ncc.read_kernel_info(library().lib.apde_strong_kernel_info,
                                quads_u8, sa, radius, increment, num_views)


def div_check(num: torch.Tensor, den: torch.Tensor) -> Tuple[int, int]:
    """The division K3's taps take without checks (a refined reciprocal
    shared by a tap's two quotients) against ``__fdiv_rn`` on the card:
    ``num`` (n, 2) numerators over ``den`` (n,) denominators, f32 CUDA
    tensors. Returns (quotients whose bits differ, triples compared: those
    whose operands all lie in the fast range)."""
    if num.shape != (den.shape[0], 2) or num.dtype != torch.float32 \
            or den.dtype != torch.float32 or num.device.type != "cuda" \
            or den.device != num.device:
        raise ValueError("div_check takes (n, 2) and (n,) f32 CUDA tensors")
    num, den = num.contiguous(), den.contiguous()
    counts = torch.zeros(2, dtype=torch.int64, device=num.device)
    ncc._raise_on(library().lib.apde_strong_div_check(
        num.data_ptr(), den.data_ptr(), den.shape[0], counts.data_ptr(),
        torch.cuda.current_stream(num.device).cuda_stream),
        "apde_strong_div_check")
    bad, compared = counts.tolist()
    return bad, compared


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """sum_t v[..., t], added in order from +0."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for t in range(v.shape[-1]):
        acc = acc + v[..., t]
    return acc


def window_plain(data, x, y, radius: int, increment: int,
                 use_sa: bool) -> RefWindow:
    """The reference window K3 builds for pixels (x, y) f32: the taps,
    weights and values of ``cost.precompute_ref_window``, its sums taken in
    tap order. With u8 tables the values are integers, so the sums equal
    ``precompute_ref_window``'s in any order."""
    dx, dy, val, w = ref_window_taps(data, x, y, radius, increment, use_sa)
    wv = val if w is None else w * val
    return RefWindow(dx, dy, val, ordered_sum(wv), ordered_sum(wv * val),
                     float(dx.shape[0]) if w is None else w.sum(-1), w)


def weighted_sum(vw: torch.Tensor, costs: torch.Tensor) -> torch.Tensor:
    """sum_s vw[..., s] * costs[..., s], added in view order from 0."""
    acc = torch.zeros(torch.broadcast_shapes(vw.shape, costs.shape)[:-1],
                      dtype=torch.float32, device=costs.device)
    for s in range(costs.shape[-1]):
        acc = acc + vw[..., s] * costs[..., s]
    return acc


def plane_costs_plain(data, x, y, plane, win, geom: bool,
                      geom_factor) -> torch.Tensor:
    """(B, S) costs of ``plane`` at pixels (x, y) f32: K2's NCC, plus
    ``geom_factor`` times the geometric cost with ``geom``."""
    cv = ncc.ncc_strong_plain(data, x, y, plane, win)
    if geom:
        cv = cv + geom_factor * geom_cost(data, x, y, plane)
    return cv


def candidate_costs_plain(data, state, x, y, win, row_bounds=None):
    """The candidates' (B, 8, 4) planes, (B, 8) region flags and (B, 8, S)
    cost array: K2's NCC of each candidate, 0 on an invalid region's row
    but 2 at [0][0] when region 0 is invalid (``float cost_array[8][32] =
    {2.0f}``, APD.cu:1120)."""
    from ..propagation import checkerboard_candidates
    cand_x, cand_y, flags = checkerboard_candidates(state.costs, x, y,
                                                    row_bounds)
    planes = fetch(state.planes, cand_x, cand_y)
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    costs = torch.stack([ncc.ncc_strong_plain(data, xf, yf, planes[:, c], win)
                         for c in range(8)], 1)
    costs = torch.where(flags[..., None], costs, 0.0)
    costs[:, 0, 0] = torch.where(flags[:, 0], costs[:, 0, 0], 2.0)
    return planes, flags, costs


def select_views_plain(state, x, y, flags, cost_array, sel_u, iteration):
    """(vw, temporary selection, wnorm): the 0.9 / 0.1 votes of the
    neighbours (x, y -+ 1), (x -+ 1, y), valid by regions 0, 2, 4, 6, the
    sampling probabilities and the 15 Monte-Carlo samples, every sum in its
    fixed order."""
    nb_sel = fetch(state.selected, torch.stack([x, x, x - 1, x + 1], -1),
                   torch.stack([y - 1, y + 1, y, y], -1))       # (B, 4, S)
    priors = selection.ordered_priors(nb_sel, flags[:, [0, 2, 4, 6]])
    probs = selection.ordered_probabilities(
        cost_array, priors, *selection.selection_thresholds(iteration))
    return selection.ordered_view_weights(sel_u, probs)


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _norm(v) -> torch.Tensor:
    """The length of the 3-vector ``v`` (a sequence of f32 tensors), rounded
    once: sqrt((v0^2 + v1^2) + v2^2) in float64 (each square exact), then
    to float32. A float32 sum of the squares lands an ulp off the correctly
    rounded length often enough to flip the choice between two nearly equal
    hypotheses against the JAX package and the reference oracle."""
    d = [c.to(torch.float64) for c in v]
    return torch.sqrt(_dot(d, d)).to(torch.float32)


def _normalized(v, floor: Optional[float]):
    """v / |v|, the norm clamped below at ``floor`` unless it is None."""
    norm = _norm(v)
    if floor is not None:
        norm = torch.clamp(norm, min=floor)
    return [c / norm for c in v]


def refinement_planes_plain(raws, cam, x, y, plane_cur, depth_cur, depth_min,
                            depth_max) -> torch.Tensor:
    """The (B, 5, 4) planes of ``propagation.refinement_from_raws``'
    (depth, normal) pairs, with the norms and dot products written out."""
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    d_rand = torch.maximum(depth_min,
                           raws.u_rand * (depth_max - depth_min) + depth_min)
    # the Gaussian's direction, flipped to face the camera
    n_rand = _normalized(raws.g.unbind(-1), 1e-12)
    view_dir = _normalized(((depth_cur * (x - cx)) / fx,
                            (depth_cur * (y - cy)) / fy, depth_cur), None)
    flip = _dot(n_rand, view_dir) > 0
    n_rand = [torch.where(flip, -c, c) for c in n_rand]
    # the depth perturbed by up to +-2%
    lo = 0.98 * depth_cur
    d_pert = torch.maximum(lo, raws.u_pert * (1.02 * depth_cur - lo) + lo)
    # the current normal rotated by the Euler angles, kept where the
    # rotated one would face away from the camera
    s1, s2, s3 = torch.sin(raws.angles).unbind(-1)
    c1, c2, c3 = torch.cos(raws.angles).unbind(-1)
    rot = ((c2 * c3, c3 * s1 * s2 - c1 * s3, s1 * s3 + c1 * c3 * s2),
           (c2 * s3, c1 * c3 + s1 * s2 * s3, c1 * s2 * s3 - c3 * s1),
           (-s2, c2 * s1, c1 * c2))
    n_cur = plane_cur.unbind(-1)[:3]
    n_pert = [_dot(row, n_cur) for row in rot]
    unit_dir = _normalized(((x - cx) / fx, (y - cy) / fy,
                            torch.ones_like(x)), None)
    away = _dot(n_pert, unit_dir) >= 0
    n_pert = _normalized([torch.where(away, a, b)
                          for a, b in zip(n_cur, n_pert)], 1e-12)
    planes = []
    for depth, n in ((d_rand, n_cur), (depth_cur, n_rand), (d_rand, n_rand),
                     (depth_cur, n_pert), (d_pert, n_cur)):
        X = (depth * (x - cx)) / fx
        Y = (depth * (y - cy)) / fy
        w = -((n[0] * X + n[1] * Y) + n[2] * depth)
        planes.append(torch.stack([*n, w], -1))
    return torch.stack(planes, 1)


def adopt_plain(cam, x, y, cand_planes, flags, final_costs, cost_recomputed,
                has_views, depth_min, depth_max):
    """(adopt (B,) bool, best plane (B, 4), its cost (B,)): the last minimum
    of the (B, 8) weighted candidate costs (FindMinCostIndex's <=,
    APD.cu:60-71), adopted only where its region is valid, its depth lies
    in range, its cost is below ``cost_recomputed`` and the pixel has views.
    An invalid region's 0 can win and so block the adoption."""
    from ..propagation import last_min_index
    best = last_min_index(final_costs)[:, None]
    best_plane = torch.gather(cand_planes, 1,
                              best[:, :, None].expand(-1, 1, 4))[:, 0]
    best_cost = torch.gather(final_costs, 1, best)[:, 0]
    depth = geo.depth_from_plane(cam, best_plane, x, y)
    adopt = torch.gather(flags, 1, best)[:, 0] & (depth >= depth_min) \
        & (depth <= depth_max) & (best_cost < cost_recomputed) & has_views
    return adopt, best_plane, best_cost


def refine_choice(r_costs, r_planes, plane_cur, cost_cur):
    """The first minimum of the (B, 5) hypotheses' costs, taken where it is
    below ``cost_cur``: (plane, cost)."""
    r_best = torch.argmin(r_costs, -1)[:, None]
    r_cost = torch.gather(r_costs, 1, r_best)[:, 0]
    r_plane = torch.gather(r_planes, 1,
                           r_best[:, :, None].expand(-1, 1, 4))[:, 0]
    take = r_cost < cost_cur
    return (torch.where(take[:, None], r_plane, plane_cur),
            torch.where(take, r_cost, cost_cur))


def commit_plain(plane_cur, cost_cur, cur_plane, cost_recomputed,
                 refine_init: bool):
    """(plane, cost) a pixel keeps: under REFINE_INIT the new ones only on
    an improvement of more than 0.1 (APD.cu:1430-1439)."""
    if not refine_init:
        return plane_cur, cost_cur
    commit = cost_cur < cost_recomputed - 0.1
    return (torch.where(commit[:, None], plane_cur, cur_plane),
            torch.where(commit, cost_cur, cost_recomputed))


def strong_plain(data, state, x, y, draws, *, radius, increment, use_sa,
                 iteration, depth_min, depth_max, geom_factor, geom: bool,
                 refine_init: bool, row_bounds=None) -> StrongOutputs:
    """The colour update of pixels (x, y) int32 as torch ops, in the
    kernel's operation order."""
    dev = x.device
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    cam = data.ref_cam
    win = window_plain(data, xf, yf, radius, increment, use_sa)
    dmin, dmax, gf = (geo.f32_scalar(_f32(v), dev)
                      for v in (depth_min, depth_max, geom_factor))

    cand_planes, flags, cost_array = candidate_costs_plain(
        data, state, x, y, win, row_bounds)
    cur_plane = fetch(state.planes, x, y)
    vw, temp_sel, wnorm = select_views_plain(state, x, y, flags, cost_array,
                                             draws.sel_u, iteration)
    has_views = wnorm > 0
    inv_norm = torch.where(has_views, torch.ones_like(wnorm)
                           / torch.clamp(wnorm, min=1e-20), 0.0)

    def weighted_cost(plane):
        return weighted_sum(vw, plane_costs_plain(data, xf, yf, plane, win,
                                                  geom, gf)) * inv_norm

    final_costs = weighted_sum(vw[:, None, :], cost_array) \
        * inv_norm[:, None]
    cost_recomputed = torch.where(has_views, weighted_cost(cur_plane),
                                  COST_MAX)
    adopt, best_plane, best_cost = adopt_plain(
        cam, xf, yf, cand_planes, flags, final_costs, cost_recomputed,
        has_views, dmin, dmax)
    plane_cur = torch.where(adopt[:, None], best_plane, cur_plane)
    cost_cur = torch.where(adopt, best_cost, cost_recomputed)
    sel_new = torch.where(adopt[:, None], temp_sel,
                          fetch(state.selected, x, y))

    depth_cur = geo.depth_from_plane(cam, plane_cur, xf, yf)
    r_planes = refinement_planes_plain(draws.raws, cam, xf, yf, plane_cur,
                                       depth_cur, dmin, dmax)
    r_costs = []
    for i in range(NUM_HYPOTHESES):
        plane_i = r_planes[:, i]
        d_i = geo.depth_from_plane(cam, plane_i, xf, yf)
        ok = (d_i >= dmin) & (d_i <= dmax) & has_views
        r_costs.append(torch.where(ok, weighted_cost(plane_i), math.inf))
    plane_cur, cost_cur = refine_choice(torch.stack(r_costs, 1), r_planes,
                                        plane_cur, cost_cur)
    plane_cur, cost_cur = commit_plain(plane_cur, cost_cur, cur_plane,
                                       cost_recomputed, refine_init)
    return StrongOutputs(plane_cur, cost_cur, sel_new, vw)


def commit_maps_plain(state, x, y, out: StrongOutputs) -> StrongOutputs:
    """The commit of a colour update's outputs ``out`` for pixels (x, y):
    fresh copies of the state's planes, costs, selections and view weights
    with ``out`` written at the active pixels (weak state not WEAK, valid),
    as ``propagation.propagate_strong``'s ``put`` writes them; every other
    cell keeps its value."""
    active = (fetch(state.weak, x, y) != WEAK) & fetch(state.valid, x, y)
    cells = y.long() * state.costs.shape[1] + x.long()

    def put(full, vals):
        new = full.clone()
        flat = new.view((-1,) + tuple(full.shape[2:]))
        keep = active.reshape(active.shape + (1,) * (vals.ndim - 1))
        flat[cells] = torch.where(keep, vals, flat[cells])
        return new
    return StrongOutputs(put(state.planes, out.planes),
                         put(state.costs, out.costs),
                         put(state.selected, out.selected),
                         put(state.view_weights, out.view_weights))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _check_args(data, state, x, y, draws, radius, increment, use_sa,
                geom: bool, commit: bool = False) -> tuple:
    """K2's checks of the quad tables, then the window, the reference image
    and segment ids, the pixels, the state (with ``commit`` the view
    weights, weak states and valid mask too), the draws and the source
    depths, on every device. Returns (B, T, SA on, {name: tensor})."""
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
    grid = tuple(state.costs.shape)
    if len(grid) != 2:
        raise ValueError(f"costs must be (H, W), got {grid}")
    raws = draws.raws
    image = (data.height, data.width)
    want = {
        "ref_image": (data.ref_image, image),
        "costs": (state.costs, grid), "planes": (state.planes, grid + (4,)),
        "sel_u": (draws.sel_u, (b, NUM_SAMPLES)),
        "u_rand": (raws.u_rand, (b,)), "g": (raws.g, (b, 3)),
        "u_pert": (raws.u_pert, (b,)), "angles": (raws.angles, (b, 3))}
    if commit:
        want["view_weights"] = (state.view_weights, grid + (s,))
    if geom:
        depths = data.src_depths
        if depths.ndim != 3:
            raise ValueError(f"src_depths must be (S, H, W), got "
                             f"{tuple(depths.shape)}")
        want["src_depths"] = (depths, (s,) + tuple(depths.shape[1:]))
    dev = data.src_quads.device
    ncc._check_tensors(want, dev)
    others = {"x": (x, (b,), torch.int32), "y": (y, (b,), torch.int32),
              "selected": (state.selected, grid + (s,), torch.bool)}
    if commit:
        others["weak"] = (state.weak, grid, torch.int32)
        others["valid"] = (state.valid, grid, torch.bool)
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
    return b, t, sa, tensors


def strong_fused(data, state, x, y, draws, *, radius: int, increment: int,
                 use_sa: bool, iteration, depth_min, depth_max, geom_factor,
                 geom: bool, refine_init: bool,
                 row_bounds: Optional[Tuple[int, int]] = None,
                 commit: bool = False) -> StrongOutputs:
    """The strong sweep's colour update of pixels (x, y) (B,) int32, all of
    one checkerboard colour, against every source view of ``data`` (a
    ``cost.CostData``): ``state`` (a ``PMState``) gives the costs, planes
    and selections the candidates and neighbours are read from, ``draws``
    (a ``propagation.SweepDraws``) the selection uniforms and refinement
    draws. The reference window is ``cost.precompute_ref_window``'s of
    (``radius``, ``increment``, ``use_sa``), built from ``data.ref_image``
    and ``data.sa_mask``. With ``geom`` each view's cost of the current
    plane and the hypotheses adds ``geom_factor`` times the geometric cost
    against ``data.src_depths``; ``refine_init`` is REFINE_INIT's commit
    rule; ``row_bounds`` (lo, hi) the rows a candidate region may use (the
    state arrays' own by default). With ``commit`` the result is the
    committed maps (``commit_maps_plain``'s: copies of the state's planes,
    costs, selections and view weights, the outputs written at the active
    pixels), which K3 writes itself. Every tensor must be contiguous on
    CUDA."""
    b, t, sa, tensors = _check_args(data, state, x, y, draws, radius,
                                    increment, use_sa, geom, commit)
    quads = data.src_quads
    if quads.device.type == "cpu":
        out = strong_plain(data, state, x, y, draws, radius=radius,
                           increment=increment, use_sa=use_sa,
                           iteration=iteration, depth_min=depth_min,
                           depth_max=depth_max, geom_factor=geom_factor,
                           geom=geom, refine_init=refine_init,
                           row_bounds=row_bounds)
        return commit_maps_plain(state, x, y, out) if commit else out
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
    smem = lib.apde_strong_smem_bytes(s, int(radius), int(increment),
                                      int(sa))
    if smem > SMEM_LIMIT:
        raise ValueError(f"a {t}-tap window at {s} views needs {smem} B of "
                         f"shared memory a block, more than {SMEM_LIMIT}")
    cams = sweep.cached_camera_table(data)
    if cams.device != quads.device:
        raise ValueError(f"cameras on {cams.device}, the quad tables on "
                         f"{quads.device}")
    gh, gw = state.costs.shape
    lo, hi = (0, gh - 1) if row_bounds is None else row_bounds
    threshold, fallback = selection.selection_thresholds(iteration)
    depths = data.src_depths
    if commit:
        out = StrongOutputs(state.planes.clone(), state.costs.clone(),
                            state.selected.clone(),
                            state.view_weights.clone())
    else:
        out = StrongOutputs(
            torch.empty((b, 4), dtype=torch.float32, device=quads.device),
            torch.empty((b,), dtype=torch.float32, device=quads.device),
            torch.empty((b, s), dtype=torch.bool, device=quads.device),
            torch.empty((b, s), dtype=torch.float32, device=quads.device))
    if b == 0:
        return out
    raws = draws.raws
    global launches, colours, sa_launches
    launches += 1
    colours += 1
    sa_launches += int(sa)
    ncc._raise_on(lib.apde_strong(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        depths.data_ptr() if geom else None,
        depths.shape[1] if geom else 0, depths.shape[2] if geom else 0,
        _f32(geom_factor), state.costs.data_ptr(), state.planes.data_ptr(),
        state.selected.data_ptr(), gh, gw, int(lo), int(hi), x.data_ptr(),
        y.data_ptr(), data.ref_image.data_ptr(), data.height,
        data.sa_mask.data_ptr() if sa else None, int(radius),
        int(increment), float(np.float32(1.0) / np.float32(t)),
        draws.sel_u.data_ptr(), raws.u_rand.data_ptr(), raws.g.data_ptr(),
        raws.u_pert.data_ptr(), raws.angles.data_ptr(), threshold, fallback,
        _f32(depth_min), _f32(depth_max), int(refine_init),
        out.planes.data_ptr(), out.costs.data_ptr(),
        out.selected.data_ptr(), out.view_weights.data_ptr(),
        state.weak.data_ptr() if commit else None,
        state.valid.data_ptr() if commit else None, b, s,
        data.width, data.quad_h, data.img_w, data.img_h,
        torch.cuda.current_stream(quads.device).cuda_stream),
        "apde_strong")
    return out
