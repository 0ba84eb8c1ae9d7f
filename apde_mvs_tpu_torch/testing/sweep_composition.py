"""The disparity sweep as the port ran it before K5, kept as the one witness
that both the CPU tests and ``chip_smoke.py`` hold K5 and its plain version
against.

``sweep_composition`` is the old per-probe loop of ``filters._sweep_cost``:
for each probe depth, the plane, one K2 call, the geometric cost's torch
ops, the view weighting as ``.sum`` and the masks. One thing is taken from
K5 rather than from the old loop: the plane's w sums its three products in
K5's order, not in the order of ``geometry.plane_dist_to_origin``'s
``.sum``. Two orders give w values an ulp or so apart, and far more for a
plane seen nearly edge-on, where the products cancel; the costs move with
w, by steps where the geometric cost's nearest-texel fetch crosses a texel
boundary. With w fixed, the composition differs from K5 only in the order
of its view sum, and holds to it within 1e-4 at every cost.
"""

from __future__ import annotations

import math

import torch

from ..core import geometry as geo
from ..ops import cost


def sweep_composition(data, sc, px, win, *, refine: bool, geom: bool,
                      geom_factor, depth_min, depth_max) -> torch.Tensor:
    """The (B, 61) classify curve or (B, 12) refine costs, one probe depth
    at a time: ``sc`` is ``filters._sweep_scalars``' output for the pixels
    ``px`` (a ``sweep.SweepPixels``), ``win`` their reference window."""
    dev = px.x.device
    cam = data.ref_cam
    gf = geo.f32_scalar(geom_factor, dev)
    n = sc.plane_cam[..., :3]

    def cost_at(p_depth, lo, hi):
        X = p_depth * (px.x - cam.cx) / cam.fx
        Y = p_depth * (px.y - cam.cy) / cam.fy
        wdist = -((n[..., 0] * X + n[..., 1] * Y) + n[..., 2] * p_depth)
        plane = torch.cat([n, wdist[..., None]], -1)
        cv = cost.ncc_strong(data, px.x, px.y, plane, win)
        if geom:
            cv = cv + gf * cost.geom_cost(data, px.x, px.y, plane)
        c = (sc.vw * cv).sum(-1) / torch.clamp(sc.wnorm, min=1e-20)
        c = torch.where(sc.wnorm > 0, c, cost.COST_MAX)
        return torch.where((p_depth >= lo) & (p_depth <= hi), c,
                           cost.COST_MAX)

    def probe(p_disp):
        d = sc.disp + float(p_disp)
        return cam.fx * sc.base_line / torch.where(d != 0, d, 1e-20)

    lo, hi = (geo.f32_scalar(v, dev) for v in (depth_min, depth_max))
    if refine:
        return torch.stack([cost_at(sc.depth, -math.inf, math.inf)]
                           + [cost_at(probe(i - 5), lo, hi)
                              for i in range(11)], 1)
    return torch.stack([torch.clamp(cost_at(probe(i - 30), lo, hi),
                                    max=cost.COST_MAX) for i in range(61)],
                       1)
