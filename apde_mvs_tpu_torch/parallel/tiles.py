"""Within-view tile parallelism for the strong sweep: one view's state
sharded over the ranks by image rows.

Two forms of one black + red strong sweep (reference kernels
CheckerboardPropagationStrong, APD.cu:1617-1692):

- `tile_sharded_sweep`: each rank holds its rows; the full state is
  all-gathered once, each colour evaluates this rank's rows and all-gathers
  the outputs (one full-state gather per colour). The JAX package builds
  this from XLA sharding constraints and its partitioner collapses them to
  exactly these full-state gathers (tests/test_tiles.py); here they are
  explicit. Equal to the unsharded sweep bitwise: every rank takes its
  slice of the one generator's draws.
- `halo_tile_sweep`: the lower-communication variant. Candidate regions
  reach ±23 rows (`propagation._REGIONS`, far offsets 3 + 2*10) and NCC
  windows ±5, so before each colour a rank exchanges `HALO_ROWS` boundary
  rows of its state with each neighbour (one batch of isend / irecv), runs
  the sweep on the extended block and keeps its own rows. Global row
  bounds keep out-of-image halo rows out of the candidate regions; the
  reference camera's principal point is shifted so a block row maps to its
  global ray (camera-frame planes are invariant to that shift), and the
  source tables keep their own height (`CostData.src_height`). The shift
  reassociates float32 arithmetic, so the result equals the unsharded
  sweep in quality, not bitwise.

Shard heights are even (`tile_pass.row_split`): an odd block origin would
flip the checkerboard parity.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import geometry as geo
from ..ops.cost import CostData
from ..ops.propagation import PropCfg, RefineRaws, SweepDraws, \
    _take_draws, propagate_strong, sweep_draws
from ..ops.state import PMState
from . import distributed as pdist
from .tile_pass import RowShard, row_split

# Checkerboard candidate regions reach ±23 rows and NCC windows another ±5;
# 24 halo rows cover the state reads of one colour sweep.
HALO_ROWS = 24

_FIELDS = ("planes", "costs", "selected", "view_weights", "weak",
           "confidence", "valid")


def shard_state_rows(state: PMState, shard: RowShard) -> PMState:
    """This rank's rows of a full state."""
    r0, r1 = row_split(state.costs.shape[0], shard.world)[shard.rank]
    return PMState(*(getattr(state, f)[r0:r1] for f in _FIELDS))


def gather_state_rows(rows: PMState, shard: RowShard, h: int) -> PMState:
    """The full state from every rank's rows."""
    counts = [r1 - r0 for r0, r1 in row_split(h, shard.world)]
    return PMState(*(shard.gather(getattr(rows, f), counts)
                     for f in _FIELDS))


def tile_sharded_sweep(data: CostData, rows: PMState, cfg: PropCfg,
                       iteration, depth_min, depth_max, geom_factor,
                       shard: RowShard,
                       generator: Optional[torch.Generator] = None,
                       draws=None) -> PMState:
    """One full (black + red) strong sweep on row-sharded state; returns
    this rank's rows. ``draws`` = the two colours' `SweepDraws` (else
    taken from ``generator``)."""
    state = gather_state_rows(rows, shard, data.height)
    for color in (0, 1):
        state = propagate_strong(
            data, state, cfg, iteration, color, depth_min, depth_max,
            geom_factor, generator=generator,
            draws=None if draws is None else draws[color], shard=shard)
    return shard_state_rows(state, shard)


def _extend(rows: PMState, shard: RowShard, halo: int) -> PMState:
    """(rl, W, ...) rows -> (rl + 2*halo, W, ...) with the neighbours' halo
    rows, every field in one batch of isend / irecv; the chain's ends get
    zeros (outside the image)."""
    prev, nxt = shard.rank - 1, shard.rank + 1
    send, recv = {}, {}
    for tag, f in enumerate(_FIELDS):
        a = getattr(rows, f)
        if prev >= 0:
            send[(prev, tag)] = recv[(prev, tag)] = a[:halo]
        if nxt < shard.world:
            send[(nxt, tag)] = recv[(nxt, tag)] = a[-halo:]
    got = pdist.exchange(send, recv)
    out = []
    for tag, f in enumerate(_FIELDS):
        a = getattr(rows, f)
        zeros = a.new_zeros((halo,) + a.shape[1:])
        out.append(torch.cat([got.get((prev, tag), zeros), a,
                              got.get((nxt, tag), zeros)]))
    return PMState(*out)


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    z = t.new_zeros((n,) + t.shape[1:])
    return torch.cat([z, t, z])


def halo_tile_sweep(data: CostData, rows: PMState, cfg: PropCfg, iteration,
                    depth_min, depth_max, geom_factor, shard: RowShard,
                    generator: Optional[torch.Generator] = None,
                    draws=None, halo: int = HALO_ROWS) -> PMState:
    """One full (black + red) strong sweep with explicit halo exchange;
    returns this rank's rows. ``data`` is the whole view's; ``draws`` /
    ``generator`` as in `tile_sharded_sweep` (whole-image draws, this
    rank takes its rows' slice). Requires shards of at least ``halo``
    rows."""
    h, w = data.height, data.width
    r0, r1 = row_split(h, shard.world)[shard.rank]
    rl = r1 - r0
    if rl < halo:
        raise ValueError(f"shard height {rl} must be >= halo ({halo})")
    row0 = r0 - halo                 # global row of block row 0
    ext_h = rl + 2 * halo
    lo = max(0, -row0)               # globally valid rows of the block
    hi = min(ext_h - 1, h - 1 - row0)

    # the block's reference side: image rows edge-replicated past the
    # image (the unsharded sweep's clamp), principal point shifted so
    # block pixel (x, y) is global pixel (x, y + row0); window and warp
    # bounds stay global
    img = data.ref_image
    img = torch.cat([img[:1].expand(halo, w), img, img[-1:].expand(halo, w)])
    sa = data.sa_mask
    if sa is not None:
        sa = torch.cat([sa.new_zeros((halo, w)), sa, sa.new_zeros((halo, w))])
        sa = sa[r0:r0 + ext_h]
    K = data.ref_cam.K.clone()
    K[1, 2] -= float(row0)
    cam = data.ref_cam
    block = data.replace(
        ref_cam=geo.CameraArrays(K, cam.R, cam.t, cam.c),
        ref_image=img[r0:r0 + ext_h], sa_mask=sa, height=ext_h,
        src_height=data.quad_h, real_width=data.img_w,
        real_height=data.img_h)

    per_row = w // 2
    state = rows
    for color in (0, 1):
        d = draws[color] if draws is not None \
            else sweep_draws(generator, h * per_row, data.device)
        # this rank's rows' draws; the halo rows' pixels are evaluated and
        # dropped, so their draws are zeros
        mine = _take_draws(d, slice(r0 * per_row, r1 * per_row))
        d_ext = SweepDraws(_pad_rows(mine.sel_u, halo * per_row),
                           RefineRaws(*(_pad_rows(r, halo * per_row)
                                        for r in mine.raws)))
        full = _extend(state, shard, halo)
        out = propagate_strong(block, full, cfg, iteration, color, depth_min,
                               depth_max, geom_factor, draws=d_ext,
                               row_bounds=(lo, hi))
        state = state.replace(
            planes=out.planes[halo:halo + rl], costs=out.costs[halo:halo + rl],
            selected=out.selected[halo:halo + rl],
            view_weights=out.view_weights[halo:halo + rl])
    return state
