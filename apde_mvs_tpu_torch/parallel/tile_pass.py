"""Tile route: ONE reference view's complete pass row-sharded over the ranks
of the process group.

Complements the view-parallel engine (`parallel.scene`): a scan with fewer
views than ranks would otherwise leave ranks idle (the reference's device
engine serves one view at a time, APD.cu:2663-2737; SURVEY §5.7 maps it to
row sharding).

Design (the JAX package's `parallel/tile_pass.py`, on torch.distributed):

- Every input (images, cameras, priors) is replicated; each rank holds the
  whole state. The per-pixel stages (initial cost, the strong sweeps'
  candidate / refinement evaluation, classification, local refine)
  evaluate this rank's rows at global coordinates against the full state,
  then one all-gather per stage (per colour in the sweeps) hands every
  rank every row, and every rank commits the same full-state update.
- The weak machinery is sharded over the compacted weak list: anchor
  generation, the deformable rescore of the initial cost, the fit-plane
  RANSAC and the weak sweeps each run on this rank's slice of the list.
  The nearest-strong JFA, the median filter and the confidence stay
  replicated (full-image transforms).
- Rows split into shards of even height (`row_split`), as the checkerboard
  parity of the halo sweep (`parallel.tiles`) needs; an odd height raises.
- Randomness, a deliberate difference from the JAX package (which folds
  the device index into its keys and is equal across mesh sizes only in
  quality): every rank draws a colour sweep's or a weak sweep's whole draw
  set from the view's one generator and takes its own slice, so the tile
  route takes exactly the serial pass's draws.

`RowShard` is the object the stages of `pipeline.full_pass` take.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import distributed as pdist


def row_split(h: int, world: int) -> List[Tuple[int, int]]:
    """(r0, r1) row bounds of each rank's shard: even heights, as equal as
    the height allows. Raises when ``h`` cannot split into even-height
    shards of at least two rows."""
    if h % 2 or h < 2 * world:
        raise ValueError(f"rows {h} must split into even-height shards on "
                         f"{world} rank(s)")
    pairs, extra = divmod(h // 2, world)
    bounds, r0 = [], 0
    for r in range(world):
        r1 = r0 + 2 * (pairs + (r < extra))
        bounds.append((r0, r1))
        r0 = r1
    return bounds


def list_split(n: int, world: int) -> List[Tuple[int, int]]:
    """(lo, hi) bounds of each rank's contiguous slice of an n-item list,
    as equal as possible (a rank's slice may be empty)."""
    per, extra = divmod(n, world)
    bounds, lo = [], 0
    for r in range(world):
        hi = lo + per + (r < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


class RowShard:
    """This rank's part of a row-sharded pass, and the gather that joins the
    parts (`distributed.all_gather_parts`)."""

    def __init__(self, rank: int, world: int):
        self.rank = rank
        self.world = world

    def _part(self, bounds, per_item: int):
        counts = [(b - a) * per_item for a, b in bounds]
        lo = bounds[self.rank][0] * per_item
        return slice(lo, lo + counts[self.rank]), counts

    def row_part(self, h: int, per_row: int):
        """This rank's slice of a raster-order pixel batch with ``per_row``
        items per image row, and every rank's item count."""
        return self._part(row_split(h, self.world), per_row)

    def list_part(self, n: int):
        """This rank's slice of an n-item list, and every rank's count."""
        return self._part(list_split(n, self.world), 1)

    def gather(self, t: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
        return pdist.all_gather_parts(t, counts)
