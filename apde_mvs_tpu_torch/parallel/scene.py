"""The view-parallel pass: every rank runs the complete pass of its own
views of a batch, with the neighbour-depth exchange as one all-gather.

The reference scales across GPUs at scan granularity and exchanges
neighbour depth maps through bin files between passes (run.py:218-226,
APD.cpp:592-610). Here, at the start of a pass, each rank contributes the
prior depths of its slots of the batch (`mesh.ViewGroup`), one all-gather
hands every rank the batch's depth stack, and each rank then runs its views
one after another through `pipeline.full_pass` (via
`patchmatch.run_patchmatch`), their source depths read from that stack:

- rows [0, Vp): the batch's reference views in slot order, gathered (a
  padded slot's row is zeros and is never addressed);
- row Vp: zeros, for a source that is never a reference view;
- rows Vp + 1 + e: reference views of other batches of the scan, read from
  their depth files (``ext_ids``).

`_RoundData.depth_slot` maps each image-table slot to its row: the JAX
package's `depth_slot` addressing (parallel/scene.py:96-104 there).

Because the exchanged depths are the previous pass's, every view's pass
depends only on the previous pass's files and its own seed: the result
does not depend on the world size or the batching. Not ported from the JAX
module: the three-program split (a remote TPU worker's per-program time
budget) and the compiled-program cache.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..pipeline.driver import load_view, pass_seed
from ..pipeline.patchmatch import run_patchmatch
from .mesh import ViewGroup


class ScenePassInputs(NamedTuple):
    """One batch's pass inputs on one rank."""

    spec: object                 # config.PassSpec
    problems: list               # the batch's driver.Problem, slot order
    rd: object                   # scan_parallel._RoundData
    group: ViewGroup
    prior_depth: torch.Tensor    # (per, ph, pw) this rank's slots' priors
    ext_depth: torch.Tensor      # (E, ph, pw) other batches' depths


class ScenePassOutputs(NamedTuple):
    """This rank's views' maps at the real resolution (slot order)."""

    slots: List[int]
    depth: List[np.ndarray]       # (h, w) f32
    normal: List[np.ndarray]      # (h, w, 3) world frame
    weak: List[np.ndarray]        # (h, w) u8
    confidence: List[np.ndarray]  # (h, w) u8


def _gathered_depths(scene: ScenePassInputs) -> torch.Tensor:
    """Every reference view's prior depth, addressed by `depth_slot`: the
    batch's rows through one all-gather, a zero row, then the ext rows."""
    stack = scene.group.gather(scene.prior_depth)
    zero = stack.new_zeros((1,) + stack.shape[1:])
    return torch.cat([stack, zero, scene.ext_depth])


def _view_setup(scene: ScenePassInputs, all_depths: Optional[torch.Tensor],
                g: int, cache, device):
    """Slot ``g``'s `driver.ViewInputs`: its images, cameras, SA mask and
    priors as the serial engine loads them, its sources' depths from the
    exchanged stack (geometric / APD passes)."""
    rd = scene.rd
    src_depths = None
    if all_depths is not None:
        n = rd.n_src[g]
        src_depths = all_depths[torch.as_tensor(
            rd.depth_slot[rd.pair[g, :n]], device=all_depths.device)]
    return load_view(scene.problems[g], scene.spec, cache, device,
                     src_depths=src_depths)


def run_scene_pass(scene: ScenePassInputs, seed: int, cache,
                   device) -> ScenePassOutputs:
    """This rank's views' complete passes, one after another."""
    params = scene.spec.params
    geom_or_apd = params.geom_consistency or params.use_apd
    all_depths = _gathered_depths(scene) if geom_or_apd else None
    outs = ScenePassOutputs([], [], [], [], [])
    for g in scene.group.local():
        vi = _view_setup(scene, all_depths, g, cache, device)
        out = run_patchmatch(
            vi.data, params, **vi.priors, valid=vi.valid,
            depth_min=vi.depth_min, depth_max=vi.depth_max,
            seed=pass_seed(seed, scene.problems[g].ref_image_id,
                           scene.spec.iteration))
        h, w = vi.h, vi.w
        outs.slots.append(g)
        outs.depth.append(out.depth[:h, :w])
        outs.normal.append(out.normal[:h, :w])
        outs.weak.append(out.weak[:h, :w])
        outs.confidence.append(out.confidence[:h, :w])
    return outs
