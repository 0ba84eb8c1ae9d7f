"""Multi-view matching cost — the hot path of PatchMatch.

Costs are evaluated for a flat batch of pixels (a checkerboard color half, a
chunk of a filter sweep, or the whole image) against all S source views at
once: K2's plain NCC (stages/ncc.py) warps, samples and sums the window
taps of one plane hypothesis for all views (reference:
ComputeBilateralNCCOld, APD.cu:596-662; ComputeMultiViewCostVectorOld,
APD.cu:820-829).

The reference-image window (`RefWindow`, its taps from `ref_window_taps`)
depends only on the pixel. It is the plain square, or, with SA (segment
masks, loaded for APD passes only) and the pixel inside a segment, the
36-tap star truncated at the segment's edge.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core import geometry as geo
from ..core.sampling import clamped_fetch, device_constant, fetch, \
    pack_bilinear, pack_bilinear_u8, texel_fetch

COST_MAX = 2.0
GEOM_COST_MAX = 3.0
MIN_VAR = 1e-5

# Fixed 36-tap star pattern used inside SA segments (4 quadrants x 9 taps,
# truncated at segment boundaries; reference: APD.cu:664-719).
_STAR_SIGNS = np.array([[1, 1], [-1, -1], [1, -1], [-1, 1]])
_STAR_OFFSETS = np.array([[1, 1], [3, 1], [1, 3], [1, 5], [3, 3],
                          [5, 1], [5, 3], [3, 5], [5, 5]])


def star_taps() -> np.ndarray:
    """(36, 2) star taps ordered quadrant-major (truncation order)."""
    return np.asarray([(ox * sx, oy * sy) for sx, sy in _STAR_SIGNS
                       for ox, oy in _STAR_OFFSETS], np.int32)


def square_taps(radius: int, increment: int) -> np.ndarray:
    axis = list(range(-radius, radius + 1, increment))
    return np.asarray([(dx, dy) for dy in axis for dx in axis], np.int32)


@dataclasses.dataclass(frozen=True)
class CostData:
    """Per-problem device data for cost evaluation (one reference view and
    its S source views)."""

    ref_cam: geo.CameraArrays            # unbatched
    src_cams: geo.CameraArrays           # batched over S
    ref_image: torch.Tensor              # (H, W) f32
    src_quads: torch.Tensor              # (S, H*W, 4) u8 (default) or f32
    src_depths: torch.Tensor             # (S, H, W) f32; zeros when unused
    width: int
    height: int
    num_src: int
    # real (unpadded) image bounds: out-of-image tests must use these, or
    # warps landing in the pad strip score edge-replicated NCC instead of
    # the reference's COST_MAX
    real_width: int = 0
    real_height: int = 0
    # (H, W) int32 SA segment ids, 0 = no segment; None when no mask was
    # loaded (every pixel outside any segment)
    sa_mask: Optional[torch.Tensor] = None

    @property
    def img_w(self):
        return self.real_width or self.width

    @property
    def img_h(self):
        return self.real_height or self.height

    @property
    def device(self) -> torch.device:
        return self.ref_image.device

    @property
    def src_views(self) -> geo.CameraArrays:
        """Source cameras shaped (S, 1, ...) to broadcast against a pixel
        batch."""
        return self.src_cams.map(lambda a: a[:, None])

    @classmethod
    def build(cls, ref_cam, src_cams, ref_image, src_images, src_depths=None,
              real_width=0, real_height=0, sampler_u8=False, sa_mask=None):
        """With ``sampler_u8`` the source images are packed as u8 quads and
        both ref and source values are rounded to the integer grid so the
        two sides stay photometrically consistent (lossless for raw
        images)."""
        h, w = ref_image.shape
        s = src_images.shape[0]
        if sampler_u8:
            ref_image = torch.clamp(torch.round(ref_image), 0.0, 255.0)
            quads = pack_bilinear_u8(src_images)
        else:
            quads = pack_bilinear(src_images)
        if src_depths is None:
            src_depths = torch.zeros((s, h, w), device=ref_image.device)
        return cls(ref_cam=ref_cam, src_cams=src_cams,
                   ref_image=ref_image.contiguous(),
                   src_quads=quads.contiguous(),
                   src_depths=src_depths.to(torch.float32),
                   width=w, height=h, num_src=s,
                   real_width=real_width, real_height=real_height,
                   sa_mask=None if sa_mask is None
                   else sa_mask.to(torch.int32).contiguous())


class RefWindow(NamedTuple):
    """Pixel-batch reference-side window data, independent of candidate and
    view. Plain square window: shared (T,) offsets, every tap weighs 1
    (``tap_w`` None, ``wsum`` the float T). SA window: per-pixel (B, T)
    offsets and 0/1 weights, (B,) weight sums."""

    tap_dx: torch.Tensor   # (T,) or (B, T) f32
    tap_dy: torch.Tensor   # (T,) or (B, T)
    tap_val: torch.Tensor  # (B, T) ref image values
    sum_ref: torch.Tensor  # (B,)
    sum_rr: torch.Tensor   # (B,)
    wsum: Union[float, torch.Tensor]    # T, or (B,) weight sums
    tap_w: Optional[torch.Tensor] = None   # (B, T) 0/1 weights, or None


def ref_window_taps(data: CostData, x, y, radius: int, increment: int,
                    use_sa: bool = False):
    """A reference window's taps before any sum: (dx, dy) offsets f32, (T,)
    or (B, T) per pixel, the (B, T) clamped reference values and the
    (B, T) 0/1 weights, None for the plain square."""
    sq = device_constant(("square_taps", radius, increment),
                         lambda: square_taps(radius, increment), x.device)
    xi = x.to(torch.int32)
    yi = y.to(torch.int32)
    if not use_sa or data.sa_mask is None:
        valc = clamped_fetch(data.ref_image, xi[..., None] + sq[:, 0],
                             yi[..., None] + sq[:, 1])
        return (sq[:, 0].to(torch.float32), sq[:, 1].to(torch.float32), valc,
                None)
    if sq.shape[0] != 36:
        raise ValueError("SA mixing assumes 36-tap square windows")
    st = device_constant("star_taps", star_taps, x.device)   # (36, 2)
    center_sa = fetch(data.sa_mask, xi, yi)                   # (B,)
    tx = xi[..., None] + st[:, 0]
    ty = yi[..., None] + st[:, 1]
    inb = (tx >= 0) & (tx < data.img_w) & (ty >= 0) & (ty < data.img_h)
    brk = inb & (fetch(data.sa_mask, tx, ty) != center_sa[..., None])
    # per-quadrant prefix truncation: a tap survives until the first
    # in-image tap of its quadrant that leaves the segment
    cut = torch.cumsum(brk.reshape(brk.shape[:-1] + (4, 9)).to(torch.int32),
                       dim=-1) > 0
    valid_star = (inb.reshape(cut.shape) & ~cut).reshape(inb.shape)
    sel = (center_sa > 0)[..., None]
    dx = torch.where(sel, st[:, 0], sq[:, 0])
    dy = torch.where(sel, st[:, 1], sq[:, 1])
    w = torch.where(sel, valid_star.to(torch.float32), 1.0)
    val = clamped_fetch(data.ref_image, xi[..., None] + dx,
                        yi[..., None] + dy)
    return dx.to(torch.float32), dy.to(torch.float32), val, w


def ncc_from_sums(sum_ref, sum_rr, sum_src, sum_ss, sum_rs, wsum):
    """NCC matching cost from window sums (reference:
    APD.cu:543-563,644-662): cost = clip(1 - covar/sqrt(var_ref var_src)),
    COST_MAX where either variance is degenerate, the weight sum is 0, or
    the sums are not finite (degenerate w=0 planes warp to NaN
    coordinates). ``wsum`` is a float or a tensor of weight sums."""
    if isinstance(wsum, torch.Tensor):
        empty = wsum <= 0
        inv = torch.where(empty, 0.0, 1.0 / torch.clamp(wsum, min=1e-20))
    else:
        empty = None
        inv = float(np.float32(1.0) / np.float32(wsum))  # float32 1/T
    m_ref = sum_ref * inv
    m_rr = sum_rr * inv
    m_src = sum_src * inv
    m_ss = sum_ss * inv
    m_rs = sum_rs * inv
    var_ref = m_rr - m_ref * m_ref
    var_src = m_ss - m_src * m_src
    covar = m_rs - m_ref * m_src
    denom = torch.sqrt(torch.clamp(var_ref * var_src, min=1e-30))
    cost = torch.clamp(1.0 - covar / denom, 0.0, COST_MAX)
    degenerate = (var_ref < MIN_VAR) | (var_src < MIN_VAR) \
        | ~torch.isfinite(cost)
    if empty is not None:
        degenerate = degenerate | empty
    return torch.where(degenerate, COST_MAX, cost)


def geom_cost(data: CostData, x, y, plane) -> torch.Tensor:
    """Geometric consistency cost vector (B, S): forward-backward reprojection
    distance against source depth maps, clamped to 3; missing source depth
    costs 3 (reference: ComputeGeomConsistencyCost, APD.cu:865-902)."""
    depth = geo.depth_from_plane(data.ref_cam, plane, x, y)
    Xw = geo.backproject_world(data.ref_cam, x, y, depth)         # (B, 3)
    src = data.src_views
    sx, sy, _sd = geo.project(src, Xw)                            # (S, B)
    src_depth = texel_fetch(data.src_depths, sx, sy)
    Xs = geo.backproject_world(src, sx, sy, src_depth)
    bx, by, _bd = geo.project(data.ref_cam, Xs)
    dist = torch.sqrt((x - bx) ** 2 + (y - by) ** 2)
    cost = torch.clamp(dist, max=GEOM_COST_MAX)
    bad = (src_depth == 0.0) | ~torch.isfinite(cost)
    return torch.where(bad, GEOM_COST_MAX, cost).T


def initial_cost_and_selection(costs: torch.Tensor, top_k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k view selection from a (B, S) cost vector (reference:
    ComputeMultiViewInitialCostandSelectedViews, APD.cu:723-774).

    Returns (mean top-k cost (B,), selected mask (B, S)). Views are selected
    when their cost is <= the k-th smallest (ties select extra views, as in
    the reference); all-invalid pixels get cost_max and empty selection.
    The k smallest are summed in ascending order from +0 and the mean is a
    true division by k (K11's plain version, stages/select.py).
    """
    from .stages.strong import ordered_sum
    S = costs.shape[-1]
    k = torch.clamp((costs < COST_MAX).sum(-1), max=top_k)        # (B,)
    csort = torch.sort(costs, dim=-1).values
    idx = torch.arange(S, device=costs.device)
    topk_sum = ordered_sum(torch.where(idx[None, :] < k[:, None], csort,
                                       0.0))
    mean_cost = torch.where(k > 0, topk_sum / torch.clamp(k, min=1),
                            COST_MAX)
    thresh = torch.gather(csort, -1, torch.clamp(k - 1, min=0)[:, None])[:, 0]
    selected = (costs <= thresh[:, None]) & (k[:, None] > 0)
    return mean_cost, selected
