"""Multi-view matching cost — the hot path of PatchMatch.

Costs are evaluated for a flat batch of pixels (a checkerboard color half, a
chunk of a filter sweep, or the whole image) against all S source views at
once: the per-view homographies, warps and samples carry a leading view
dimension, so one plane hypothesis costs one launch of the sampler K1 for
all views (reference: ComputeBilateralNCCOld, APD.cu:596-662;
ComputeMultiViewCostVectorOld, APD.cu:820-829).

The reference-image window sums depend only on the pixel, so
`precompute_ref_window` hoists them out of the candidate x view loops.

Only the plain square window is built. The SA star window
(apde_mvs_tpu/ops/cost.py:170-201) reads segment masks, which the JAX
engine loads only for APD passes; with an all-zero mask it reduces exactly
to the square window, so round 0 needs nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..core.sampling import bilinear_sample_packed, clamped_fetch, \
    pack_bilinear, pack_bilinear_u8, texel_fetch

COST_MAX = 2.0
GEOM_COST_MAX = 3.0
MIN_VAR = 1e-5


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
              real_width=0, real_height=0, sampler_u8=False):
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
        return cls(ref_cam=ref_cam, src_cams=src_cams, ref_image=ref_image,
                   src_quads=quads.contiguous(),
                   src_depths=src_depths.to(torch.float32),
                   width=w, height=h, num_src=s,
                   real_width=real_width, real_height=real_height)


class RefWindow(NamedTuple):
    """Pixel-batch reference-side window data, independent of candidate and
    view. All taps weigh 1 (square window)."""

    tap_dx: torch.Tensor   # (T,) f32
    tap_dy: torch.Tensor   # (T,)
    tap_val: torch.Tensor  # (B, T) ref image values
    sum_ref: torch.Tensor  # (B,)
    sum_rr: torch.Tensor   # (B,)
    wsum: float            # T


def precompute_ref_window(data: CostData, x, y, radius: int,
                          increment: int) -> RefWindow:
    """The plain square window (reference: APD.cu:629-643): tap offsets,
    clamped reference values, and their sums."""
    sq = torch.as_tensor(square_taps(radius, increment), device=x.device)
    xi = x.to(torch.int32)
    yi = y.to(torch.int32)
    valc = clamped_fetch(data.ref_image, xi[..., None] + sq[:, 0],
                         yi[..., None] + sq[:, 1])
    return RefWindow(sq[:, 0].to(torch.float32), sq[:, 1].to(torch.float32),
                     valc, valc.sum(-1), (valc * valc).sum(-1),
                     float(sq.shape[0]))


def ncc_from_sums(sum_ref, sum_rr, sum_src, sum_ss, sum_rs, wsum):
    """NCC matching cost from window sums (reference:
    APD.cu:543-563,644-662): cost = clip(1 - covar/sqrt(var_ref var_src)),
    COST_MAX where either variance is degenerate or the sums are not finite
    (degenerate w=0 planes warp to NaN coordinates)."""
    inv = float(np.float32(1.0) / np.float32(wsum))   # float32 1/T, as JAX
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
    return torch.where(degenerate, COST_MAX, cost)


def ncc_strong(data: CostData, x, y, plane, win: RefWindow) -> torch.Tensor:
    """Multi-view NCC cost vector (B, S) of `plane` (B, 4) at pixels
    (x, y) (B,) f32 against every source view. One K1 launch samples the
    (S, B, T) warped taps of all views."""
    H = geo.homography(data.ref_cam, data.src_views, plane)   # (S, B, 3, 3)
    cx, cy = geo.warp(H, x, y)                                # (S, B)
    oob = (cx < 0) | (cx >= data.img_w) | (cy < 0) | (cy >= data.img_h)
    tx = x[:, None] + win.tap_dx                              # (B, T)
    ty = y[:, None] + win.tap_dy
    wx, wy = geo.warp(H[..., None, :, :], tx, ty)             # (S, B, T)
    sv = bilinear_sample_packed(data.src_quads, data.width, data.height,
                                wx.contiguous(), wy.contiguous())
    cost = ncc_from_sums(win.sum_ref, win.sum_rr, sv.sum(-1),
                         (sv * sv).sum(-1), (win.tap_val * sv).sum(-1),
                         win.wsum)
    return torch.where(oob, COST_MAX, cost).T


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
    """
    S = costs.shape[-1]
    k = torch.clamp((costs < COST_MAX).sum(-1), max=top_k)        # (B,)
    csort = torch.sort(costs, dim=-1).values
    idx = torch.arange(S, device=costs.device)
    topk_sum = torch.where(idx[None, :] < k[:, None], csort, 0.0).sum(-1)
    mean_cost = torch.where(k > 0, topk_sum / torch.clamp(k, min=1),
                            COST_MAX)
    thresh = torch.gather(csort, -1, torch.clamp(k - 1, min=0)[:, None])[:, 0]
    selected = (costs <= thresh[:, None]) & (k[:, None] > 0)
    return mean_cost, selected
