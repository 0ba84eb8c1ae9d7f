"""The view group: a scan's views split over the ranks of the process group.

The reference scales by running independent scans on separate GPUs
(run.py:218-226) and exchanges neighbour depth maps through bin files
between iterations (SURVEY.md §5.8). Here every rank holds a contiguous
slice of the scan's views and the between-iteration depth exchange is one
all-gather of the depth stack.

`make_mesh` builds the `ViewGroup`: the slice is padded so every rank holds
the same count (the all-gather needs equal parts); a padded slot is not
run (its outputs would be discarded).

`view_parallel_step` is the strong-only round-1 prototype of the JAX
package: one full PatchMatch iteration (black + red strong sweeps, the
geometric cost against the gathered neighbour depths) for every local
view. The production engine is `parallel.scene` / `pipeline.scan_parallel`.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import torch

from ..core import geometry as geo
from ..core.sampling import pack_bilinear
from ..ops.cost import CostData
from ..ops.propagation import PropCfg, propagate_strong
from ..ops.state import PMState
from . import distributed as pdist


@dataclasses.dataclass(frozen=True)
class ViewGroup:
    """This rank's contiguous slice of ``num_views`` views."""

    rank: int
    world: int
    num_views: int

    @property
    def per(self) -> int:
        """Slots per rank (the padded share)."""
        return -(-self.num_views // self.world)

    @property
    def padded(self) -> int:
        return self.per * self.world

    def slots(self) -> List[int]:
        """This rank's slots: global view indices, padding included (a slot
        >= num_views is padding)."""
        return list(range(self.rank * self.per, (self.rank + 1) * self.per))

    def local(self) -> List[int]:
        """The real views this rank runs."""
        return [s for s in self.slots() if s < self.num_views]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(per, ...) rows of this rank's slots -> (padded, ...) rows of
        every slot, in slot order."""
        return pdist.all_gather_parts(t, [self.per] * self.world)


def make_mesh(num_views: int) -> ViewGroup:
    """The view group of this process (the whole scan without a process
    group)."""
    rank, world = pdist.rank_and_world()
    return ViewGroup(rank, world, num_views)


class SceneBatch(NamedTuple):
    """A scan's views: images, cameras and sources replicated, the state of
    this rank's slots (leading dim ``per``)."""

    images: torch.Tensor         # (V, H, W) f32
    quads: torch.Tensor          # (V, H*W, 4) packed bilinear
    cams: geo.CameraArrays       # batched (V, ...)
    pair: torch.Tensor           # (V, S) int64 source-view indices
    planes: torch.Tensor         # (per, H, W, 4) camera-frame planes
    costs: torch.Tensor          # (per, H, W)
    selected: torch.Tensor       # (per, H, W, S) bool
    view_weights: torch.Tensor   # (per, H, W, S) f32
    weak: torch.Tensor           # (per, H, W) int32
    depths: torch.Tensor         # (per, H, W) previous-iteration depths


def scene_batch_from_arrays(images: torch.Tensor, cams: geo.CameraArrays,
                            pair, group: ViewGroup, seed: int = 0,
                            depth_min: float = 1.0,
                            depth_max: float = 10.0) -> SceneBatch:
    """Random plane hypotheses in [depth_min, depth_max] for this rank's
    slots; slot v draws from a generator seeded with ``seed + v``
    (padded slots repeat view 0)."""
    V, H, W = images.shape
    dev = images.device
    pair = torch.as_tensor(pair, dtype=torch.int64, device=dev)
    S = pair.shape[1]
    xs, ys = geo.pixel_grid(H, W, dev)
    planes = []
    for slot in group.slots():
        v = slot if slot < V else 0
        gen = torch.Generator(device=dev).manual_seed(seed + v)
        u = torch.rand((H, W), generator=gen, device=dev)
        g = torch.randn((H, W, 3), generator=gen, device=dev)
        planes.append(geo.random_plane_from_draws(
            u, g, cams.view(v), xs, ys, geo.f32_scalar(depth_min, dev),
            geo.f32_scalar(depth_max, dev)))
    n = group.per
    return SceneBatch(
        images=images, quads=pack_bilinear(images), cams=cams, pair=pair,
        planes=torch.stack(planes),
        costs=torch.full((n, H, W), 2.0, device=dev),
        selected=torch.ones((n, H, W, S), dtype=torch.bool, device=dev),
        view_weights=torch.ones((n, H, W, S), device=dev),
        weak=torch.ones((n, H, W), dtype=torch.int32, device=dev),  # STRONG
        depths=torch.zeros((n, H, W), device=dev))


def view_parallel_step(scene: SceneBatch, group: ViewGroup, cfg: PropCfg,
                       iteration: int, seed: int, depth_min, depth_max,
                       geom_factor) -> SceneBatch:
    """One full PatchMatch iteration for every view of this rank. Every
    view's previous depths are all-gathered first (the replacement for the
    reference's cross-view depths.bin reads, APD.cpp:592-610); view v's
    draws come from a generator seeded with ``seed + 7919 * iteration +
    v``, so the result does not depend on how views are split."""
    V, H, W = scene.images.shape
    dev = scene.images.device
    all_depths = group.gather(scene.depths)          # (padded, H, W)
    xs, ys = geo.pixel_grid(H, W, dev)
    out = {f: getattr(scene, f).clone()
           for f in ("planes", "costs", "selected", "view_weights",
                     "depths")}
    for i, slot in enumerate(group.slots()):
        if slot >= V:
            continue
        srcs = scene.pair[slot]
        data = CostData(
            ref_cam=scene.cams.view(slot),
            src_cams=scene.cams.map(lambda a: a[srcs]),
            ref_image=scene.images[slot], src_quads=scene.quads[srcs],
            src_depths=all_depths[srcs], width=W, height=H,
            num_src=srcs.shape[0])
        state = PMState(planes=scene.planes[i], costs=scene.costs[i],
                        selected=scene.selected[i],
                        view_weights=scene.view_weights[i],
                        weak=scene.weak[i],
                        confidence=torch.ones((H, W), device=dev),
                        valid=torch.ones((H, W), dtype=torch.bool,
                                         device=dev))
        gen = torch.Generator(device=dev).manual_seed(
            seed + 7919 * iteration + slot)
        for color in (0, 1):
            state = propagate_strong(data, state, cfg, iteration, color,
                                     depth_min, depth_max, geom_factor,
                                     generator=gen)
        out["planes"][i] = state.planes
        out["costs"][i] = state.costs
        out["selected"][i] = state.selected
        out["view_weights"][i] = state.view_weights
        out["depths"][i] = geo.depth_from_plane(data.ref_cam, state.planes,
                                                xs, ys)
    return scene._replace(**out)
