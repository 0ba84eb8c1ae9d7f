#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (apde_mvs_tpu_torch) on one NVIDIA GPU:
builds the hand-written kernels from this checkout (every library by two
processes, all at once, as two ranks would) and prints, per kernel, its
registers, spills and resident blocks an SM and the SASS instructions of
one window tap by opcode class (``tools/sass_taps.py``; a diagnostic,
skipped with a note where ``cuobjdump`` is missing), holds each kernel
against its plain PyTorch version at the shapes its call sites give it,
then drives the port's paths through its entry points and checks each
result. K1, the bilinear sampler, is held at the strong window's shape, a
tile-route row shard's and one pixel's, and at the deformable NCC's centre
and anchor windows (with the time of an empty launch of its grid there),
though no main path launches it any more;
K2, the fused strong NCC, bitwise at the strong sweep's black pixels (u8
and f32), the classify chunk, a tile-route rank's halo row block, one
pixel, an SA star window, 25-tap windows (the generic tap loop), 32 source
views and degenerate planes, and timed against the torch-op composition it
replaced (homography, warp, K1, window sums, NCC); K5, the fused disparity
sweep of DepthToWeak and LocalRefine with the geometric cost inside,
bitwise at the classify chunk in both modes (u8 and f32, geometric cost on
and off), an SA star window, a tile-route halo row block, degenerate planes
with empty view weights on a ragged chunk, view-weight patterns (none, one,
every view, a NaN weight, -0 weights), 32 source views, and every pixel of
a view in the export-curve form, timed against the per-probe composition it
replaced (a K2 call, the geometric cost and the view weighting a probe),
and its stage form (DepthToWeak or LocalRefine whole: the setup read from
the state's maps, the window built in the kernel, the sweep and the peak
or accept rule) bitwise (classes, curve, depths) at the classify chunk (u8
and f32, geometric on and off, classify with and without its curve,
refine), an SA star window, degenerate planes on a ragged chunk, one
pixel, 32 views, a halo row block and a real APD pass's first classify and
refine chunks, timed against the old stage composition (the window and
the rule as torch ops around the sweep form) and its plain version;
K3, the strong sweep's colour update with K2's NCC and the geometric cost
inside and the reference window built in the kernel, bitwise at the black
pixels of a view (u8 and f32, geometric cost on and off, iterations 0 and
2, REFINE_INIT), selection draws weighting one view or many, every plane
NaN, an SA star window (u8 and f32), a tile-route halo row block with its
row bounds (square and SA), 1 and 32 source views, a ragged batch and one
pixel, held to the torch-op body it replaced (``testing.strong_composition``:
the window's torch ops, 14 K2 calls and the selection's torch ops a
colour) at the CPU tests' tolerance and timed against it with the square
and the SA star window; its commit form (the active pixels' outputs written
into copies of the maps) bitwise against the plain commit (square and SA,
u8 and f32, REFINE_INIT), the state left as it was, timed against the
launch and the torch-op commit it replaced
(``strong_composition.put_composition``);
and the division K3's taps take without checks
against ``__fdiv_rn`` bit for bit on 2^27 random triples each in a pass's
ranges, over the fast range and of random bits, and every triple of
special values; K6, the deformable NCC of weak pixels with the geometric
cost inside, bitwise on a weak-sweep chunk of the APD scan (its 10
candidate planes with u8 and f32 tables, SA weights on and off and the
geometric cost on and off; its 5 probes with the chunk's view weights and
with none, one, every view and random ones weighted; one plane, as the
initial cost's re-score; planes with NaN, w = 0 and the zero fit plane; 1
and 32 source views; a ragged batch and one pixel), held to the torch-op
composition it replaced (``testing.weak_composition``: two K1 launches and
~575 torch ops a plane, the torch-op geometric cost) on a chunk of
textured windows and on the weak plane's nearly textureless ones, both
held to the plain version taken in float64 (K6 no farther from it on
average than the composition), and timed against it at the candidates,
the probes, the re-score and with square windows; K7, the weak sweep's
chunk update with K6's deformable NCC and the geometric cost inside and
the reference side built in the kernel, bitwise on the same chunk
(planes, costs, selections, view weights) in REFINE_INIT and in a
geometric REFINE_ITER pass, SA and square windows, u8 and f32 tables,
selection draws weighting one view or many, every plane NaN, 1 and 32
source views, a ragged batch and one pixel, and on the first chunk a real
APD pass hands it in both pass forms, timed a chunk against its plain
version and the torch-op body it replaced
(``testing.weak_composition.weak_body_composition``: two K6 launches and
~250 torch ops), the share of the pixels where that body differs printed
as a diagnostic, and with square windows and on the real pass's chunk;
K10, K8 and K9 bitwise on the APD scan's setup (K8 at rotate_time 1, 2
and 4; unaligned jitter draws refused) and crafted cases, K8
also timed on a real pass's chunk and beside its draw table, K10 and K9
also bitwise and timed on a real pass's map and first fit (K9 beside its
draw table, K10 with its launches a call and live sub-passes); the
synchronising calls of a real APD pass's iteration loop with K9's camera
read in the loop as before, then of the whole APD pass and a FIRST_INIT
pass, by stage and site (fails if a fit in the loop still reads the
camera, if any comes from ``core/sampling.py``, if the classify or the
refine stage makes more than its ``nonzero``, or if the initial cost
makes any); the initial cost's K2 stage form and K6 re-score form,
each with the selection in its epilogue and in its cost-out mode, and the
selection K11 bitwise against their plain versions (``init_phase``: the
full 600x800 image, u8 and f32, square and SA, a padded image, the APD
scan's weak list and a real APD pass's, a tile rank's row block and list
slice, 32 views, K11 on crafted rows), the windows K2's stage form builds
a pixel in its old layout and its new, each form timed a launch against
its plain version and the torch ops it replaced, the selection modes
against the cost-out modes and K11 (the parent's composition) at 5, 10
and 32 views, K11 beside ``torch.sort`` and ``torch.topk``, and the whole
stage against ``testing.init_composition``; and where a
K7 and a K8 launch spend their device time, stage by stage
(``tools/kernel_split.py``). The paths:

- the round-0 scan: FIRST_INIT + 3 REFINE_ITER passes over every view of a
  textured synthetic scan, then fusion;
- the APD scan: a scan with a nearly textureless plane and SA masks, run
  with ``--pyramid_base 400`` — round 0 at 300x400, then round 1 at
  600x800 with the APD weak path (anchors, fit-plane RANSAC, deformable
  NCC, weak sweeps, SA windows) in all four passes — then fusion;
- fusion variants on the APD scan's bins: General, TaT_i and TaT_a
  (``--only_fuse``), two fusion shards (one under ``--profile_dir``, whose
  trace must hold CUDA kernels) and their merge, within 5% of General;
- debug exports: the APD scan's last pass again with ``--export_anchor``
  and ``--export_curve``, then ``tools.anchor_vis`` and
  ``tools.debug_point --device cuda --geom`` on one weak pixel;
- the view-parallel scan: the round-0 schedule on all 11 views through
  ``torch.distributed.run --nproc_per_node 2 -m apde_mvs_tpu_torch.cli.apd
  --views_parallel true`` in a subprocess, two ranks sharing the card
  (gloo), then fusion on rank 0; its pass walls are printed beside the
  batch path's serial engine passes (same views, shape and schedule);
- the tile route: view 0's last REFINE_ITER pass again, row-sharded over
  two ranks on the card (torchrun subprocess), against the serial engine's
  pass on the same priors;
- engine agreement under NCCL: a process group of one rank on the card;
  the view-parallel FIRST_INIT pass of a 3-view scan against the serial
  engine's (bitwise), then one geometric pass through the NCCL exchange;
- the batch path: an ETH3D-layout scan (COLMAP model, 11 views 600x800)
  through ``tools.eth3d_train`` in a subprocess (conversion, ``cli.run``,
  the port's engine CLI on the card), then ``tools.collect``.

    python3 chip_smoke.py [--views 6] [--apd_views 6] [--seed 0]

Every scan is 600x800, the shape bench.py times; only the number of views
of the round-0 and APD scans may be cut, and a cut is printed. Both run 6
of the 11 views by default: the view-parallel scan and the batch path run
the round-0 schedule on all 11 views of the same scene, and the earlier
paths are the ones cut in depth to keep the script well inside its time
limit (the exports pass follows the APD scan). The kernel checks, the
view-parallel scan, the tile route and the batch scan always use all 11
views.

Every path must run its initial cost's NCC through K2's stage form (at
least one launch, all at the initial cost's and debug_point's sites, none
at the strong sweep's) with its selection in the epilogue (no K11 launch
but the tile route's, one an initial cost; in the round-0 and APD scans
every ``initial_cost`` call one K2 launch, one K6 launch a 65,536 weak
pixels, no K11 launch and no other torch op but its outputs'
allocations), its classify and refine
sweeps through K5 (at least one
launch of each mode on a path that runs a pass; in the round-0 and APD
scans every ``depth_to_weak`` and ``local_refine`` call one launch and no
other torch op but its output's allocation), its strong sweeps through
K3 (on a path that runs a pass at least one launch, at most two a colour
update; the APD scan at least one with an SA window), its weak sweep
through K7 (a launch a weak-sweep chunk) and its initial cost's re-score
through K6's re-score form (one plane a launch; the APD scan and the
exports pass at least one chunk of each); no path may launch K1.
Every phase raises on failure, a subprocess's exit code included; the exit
code is non-zero on any failure, and without a CUDA device the script stops
before printing any result. Output ends with: one JSON line of per-kernel
numbers, the card's name and power limit as nvidia-smi gives them, and the
final status JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# the scan: bench.py's shape, each view's 10 others as sources
HEIGHT, WIDTH = 600, 800
FULL_VIEWS = 11
ROUND0_VIEWS = 6
APD_VIEWS = 6
# the view-parallel and tile routes: two ranks sharing the one card
RANKS = 2
# the APD scan: the scene benchmarks/fullres_stress.py measures the APD pass
# on (focal 1.25 W, a weak plane in the middle); its round 1 runs at full
# size, round 0 at half
APD_BASE = 400
WEAK_REGION = (-0.3, 0.3, -0.2, 0.2)

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the float32
# rate outside the tensor cores (the sampler's arithmetic is plain f32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# operations of one K1 sample: 2 clamps, 2 floors, 2 fractions, 2 (1 - f),
# 6 multiplies, 3 adds
K1_OPS_PER_SAMPLE = 17
# operations of the strong NCC on a square window, as the function needs
# them: a tap costs 2 offset adds, the 3-row warp (6 multiplies, 6 adds)
# and its 2 divisions, one K1 sample (17), 2 products and 3 sums; an SA
# tap 2 products more. A (pixel, view) pair costs ~90 more: the homography
# (3 + 6 divisions, 27 multiplies, 21 adds), the centre warp and test (18)
# and the NCC from the sums (~15). K2's merge of its partial sums (9 adds a
# pair) is its own choice and not counted.
K2_OPS_PER_TAP = 38
K2_OPS_PER_PAIR = 90
# operations of the disparity sweep K5 as the function needs them, beside
# K2's per tap and per pair for every probe: per (pixel, view, probe) 2 for
# the weighting (a product, the view sum's add) and with the geometric cost
# 115 more (projection into the source view 35, the texel index 10,
# back-projection 24, projection into the reference 35, distance, clamp and
# checks 9, the factor and its add 2); per (pixel, probe) 22 (the probe
# depth 3, the plane's w 12, the mean and masks 7) and with the geometric
# cost 36 more (depth from the plane 12, back-projection 24). A (pixel,
# view) pair whose weight is 0 needs nothing: its term is +0.
K5_OPS_PER_PAIR = 2
K5_GEOM_OPS_PER_PAIR = 115
K5_OPS_PER_PIXEL = 22
K5_GEOM_OPS_PER_PIXEL = 36
# K5's stage form, beside its sweep, as the JAX functions need them (data
# movement between lanes is the kernel's own and not counted): per (pixel,
# view) 5 for the setup (the weight's and the distance's selects, their two
# adds, the source count); per pixel 30 (R n: 9 products and 6 adds, the
# baseline's division, the disparity's product and division, the guards)
# and K3's 4 a (pixel, tap) for the window; per (pixel, probe) the rule's:
# classify 14 (the two neighbour compares and their and, the range test,
# the peak count, the peak cost's select, the minimum's compare and select,
# the other-peak test and its and, the difference, its square, the select
# and the sum), refine 4 (the NaN test and select, the minimum's compare
# and select)
K5_STAGE_OPS_PER_VIEW = 5
K5_STAGE_OPS_PER_PIXEL = 30
K5_STAGE_CLASSIFY_OPS_PER_PROBE = 14
K5_STAGE_REFINE_OPS_PER_PROBE = 4
# operations of the strong sweep's colour update K3 as the function needs
# them, beside K2's per tap and per pair for every valid (candidate, view)
# pair and every (plane, weighted view) pair of the current plane and the 5
# hypotheses, and with the geometric cost K5's 115 a (plane, weighted view)
# and 36 a (pixel, plane): per (pixel, view) 80 for the selection (8
# candidates' threshold, square, division, exponential, weight sum and
# counts, the prior's 4 adds, the probability, the CDF's add and division,
# 15 sample comparisons); per (pixel, weighted view) 28 (a product and an
# add for each of the 8 candidates' and 6 planes' sums); per pixel 300 (the
# candidate scan's 8 regions of 7-11 positions, the adoption, the 5
# hypotheses' normals, rotation, norms, planes and depths, the commit). A
# pair whose weight is 0 needs nothing: its term is +0.
K3_SELECT_OPS_PER_VIEW = 80
K3_OPS_PER_WEIGHTED_PAIR = 28
K3_OPS_PER_PIXEL = 300
K3_PLANES = 6                # the current plane and the 5 hypotheses
# K3's strong NCC forms each offset's warp products once a pair, so its
# taps and pairs need other counts than K2's: a tap 6 adds for the 3 warp
# rows, 2 divisions, one K1 sample (17), 2 products and 3 sums (an SA tap
# 2 products more); a pair K2's 90 and, on the square window, the 6 x- and
# 6 y-offsets' adds and their 3 rows' products (48; the star's 4 quadrants
# form theirs each: 96). The window itself: 4 a (pixel, tap) for the
# weight-value product, its square and the two sums.
K3_OPS_PER_TAP = 30
K3_OPS_PER_PAIR = 138
K3_STAR_OPS_PER_PAIR = 48
K3_WINDOW_OPS_PER_TAP = 4
# operations of the deformable NCC K6 as the function needs them, counted
# on the call's data: per evaluated (pixel, plane, view) 75 for the
# homography (57) and the centre's warp and test (18), with the geometric
# cost K5's 115 more and 36 a (pixel, plane); per pair whose centre stays
# in the image 20 (the centre's NCC from its sums 15, the blend and the
# softmax's division 5) and K2's 38 a centre tap (40 with SA weights); per
# valid anchor such a pair tests 18 (its warp and test); per anchor window
# it computes 15 (the NCC from its sums) and 38 (40) a tap; per anchor
# that counts 6 (the max, the difference, exp, the two products and
# sums).
K6_OPS_PER_PAIR = 75
K6_OPS_PER_LIVE_PAIR = 20
K6_OPS_PER_TESTED_ANCHOR = 18
K6_OPS_PER_ANCHOR_WINDOW = 15
K6_OPS_PER_COUNTING_ANCHOR = 6
# operations of the weak sweep's chunk update K7 as the function needs
# them, beside K6's for every evaluated pair of both phases (the flagged
# candidates, the current plane and a fit plane with a normal against every
# view; the 5 hypotheses against the weighted views of a pixel with a fit)
# and K4's 115 a pair and 36 a (pixel, evaluated plane): per (pixel, view)
# 84 for the selection (K3's 80 with 8 anchors' votes for 4 neighbours');
# per (pixel, weighted view) 30 (a product and an add for each of the 8
# candidates', the current and fit planes' and the 5 hypotheses' sums); per
# pixel 250 (the anchors' masks, the adoption, the fit test, the 5
# hypotheses' normals, rotation, norms, planes and depths, the commit); per
# (pixel, reference tap) 4 (the weight-value product, its square, the two
# sums), 36 + 8 x 9 taps a pixel.
K7_SELECT_OPS_PER_VIEW = 84
K7_OPS_PER_WEIGHTED_PAIR = 30
K7_OPS_PER_PIXEL = 250
K7_OPS_PER_REF_TAP = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, what: str, tol: float = 1e-3) -> float:
    """Max abs difference over non-NaN samples; raises unless NaN sits in
    the same positions and the difference is within ``tol``."""
    import torch
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ from the plain "
                             "version")
    ok = ~torch.isnan(want)
    err = float((got[ok] - want[ok]).abs().max()) if bool(ok.any()) else 0.0
    log(f"  {what}: max |K1 - plain| = {err:.3g} over {got.numel()} samples, "
        f"{int((~ok).sum())} NaN in the same places")
    if not err <= tol:
        raise AssertionError(f"{what}: max abs error {err} > {tol}")
    return err


def special_coords(S: int, n: int, w: int, h: int, seed: int, device):
    """NaN, +-inf and far-out coordinates mixed with in-range ones."""
    import torch
    vals = torch.tensor([float("nan"), float("inf"), float("-inf"), -1e30,
                         1e30, -5.0, w + 5.0, h + 5.0, -0.0, w - 1.0,
                         h - 1.0, 0.25], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((S, n), generator=gen, device=device) * (w + 20) - 10
    y = torch.rand((S, n), generator=gen, device=device) * (h + 20) - 10
    idx = torch.randint(0, len(vals), (S, n), generator=gen, device=device)
    pick = torch.rand((S, n), generator=gen, device=device)
    x = torch.where(pick < 0.3, vals[idx], x)
    y = torch.where((pick > 0.2) & (pick < 0.5), vals[idx.flip(-1)], y)
    return x.contiguous(), y.contiguous()


def mark_rows(hit, idx, where=None) -> None:
    """Set in ``hit`` (S, rows) the rows ``idx`` (S, ...) of each view's
    table; ``where`` (a leading part of idx's shape) keeps only the
    samples that are read."""
    import torch
    s = hit.shape[0]
    idx = idx + (torch.arange(s, device=idx.device) * hit.shape[1]).reshape(
        (s,) + (1,) * (idx.ndim - 1))
    hit.view(-1)[(idx if where is None else idx[where]).reshape(-1)] = True


def touched_rows(quads, width: int, height: int, x, y) -> int:
    """Distinct quad-table rows the samples read: the table bytes this run's
    data needs, each counted once."""
    import torch

    from apde_mvs_tpu_torch.core.sampling import quad_coords
    hit = torch.zeros((quads.shape[0], width * height), dtype=torch.bool,
                      device=x.device)
    mark_rows(hit, quad_coords(width, height, x, y)[0])
    return int(hit.sum())


def time_packed(q, width: int, height: int, x, y, what: str,
                card: str) -> dict:
    """K1's and the plain version's mean time on one set of samples, and
    the least time the card could take for them."""
    from apde_mvs_tpu_torch.ops.cuda import sampler
    n = x.numel()
    ms = cuda_ms(lambda: sampler.sample_packed(q, width, height, x, y), 20)
    plain_ms = cuda_ms(
        lambda: sampler.sample_packed_plain(q, width, height, x, y), 5, 1)
    nbytes = 12 * n + touched_rows(q, width, height, x, y) * 4 \
        * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = K1_OPS_PER_SAMPLE * n / F32_FLOPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    log(f"  {what}: K1 {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e9:.4f} GB, {n} samples) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def grid_sample_ms(q_u8, width: int, height: int, x, y, card: str) -> float:
    """The yardstick: grid_sample computes the same bilinear, border-clamped
    function on the u8-rounded images; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from apde_mvs_tpu_torch.ops.cuda import sampler
    s = q_u8.shape[0]
    img = q_u8[..., 0].reshape(s, 1, height, width).float()
    grid = torch.stack([x * (2.0 / (width - 1)) - 1.0,
                        y * (2.0 / (height - 1)) - 1.0],
                       -1).reshape(s, -1, x.shape[-1], 2)

    def lib_call():
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
    lib = lib_call()[:, 0].reshape(x.shape)
    ref = sampler.sample_packed_plain(q_u8, width, height, x, y)
    ok = torch.isfinite(ref)
    log(f"  grid_sample vs plain (u8 images): max abs diff "
        f"{float((lib - ref)[ok].abs().max()):.3g} over finite samples")
    ms = cuda_ms(lib_call, 10)
    log(f"  grid_sample, same samples: {ms:.4f} ms [{card}]")
    return ms


def kernel_phase(scene, seed: int, device, card: str) -> dict:
    """K1 against its plain version at main-path shapes; timings."""
    import torch
    import torch.nn.functional as F

    from apde_mvs_tpu_torch.core import checkerboard as cb
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops.cost import CostData
    from apde_mvs_tpu_torch.ops.cuda import sampler

    S = scene.num_views - 1
    H, W = scene.images.shape[1:]
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    data = {u8: CostData.build(cams.view(0), cams.map(lambda a: a[1:]),
                               imgs[0], imgs[1:], sampler_u8=u8)
            for u8 in (True, False)}
    # one strong-sweep hypothesis: the black pixels, their ground-truth
    # planes, warped through each source view's homography at the 36 taps
    xs2, ys2 = cb.color_coords(H, W, 0, device=device)
    x = xs2.reshape(-1).float()
    y = ys2.reshape(-1).float()
    depth = cb.gather_color(torch.as_tensor(scene.depths[0], device=device), 0)
    normal = cb.gather_color(torch.as_tensor(scene.normals[0], device=device),
                             0)
    plane = geo.make_plane(cams.view(0), x, y, depth.reshape(-1),
                           geo.normal_world_to_cam(
                               cams.view(0).R,
                               torch.cat([normal.reshape(-1, 3),
                                          torch.zeros_like(x)[:, None]],
                                         -1))[:, :3])
    Hm = geo.homography(cams.view(0), data[True].src_views, plane)
    taps = torch.arange(-5, 6, 2, device=device, dtype=torch.float32)
    tdx = taps.repeat(6)
    tdy = taps.repeat_interleave(6)
    wx, wy = geo.warp(Hm[..., None, :, :], x[:, None] + tdx, y[:, None] + tdy)
    wx, wy = wx.contiguous(), wy.contiguous()          # (S, B, 36)
    n = wx.numel()
    log(f"K1 packed form: {S} views x {x.numel()} pixels x 36 taps = {n} "
        "samples per launch")
    sx, sy = special_coords(S, 1 << 16, W, H, seed, device)

    errs = []
    res = {}
    for u8 in (True, False):
        q = data[u8].src_quads
        tag = "u8" if u8 else "f32"
        errs.append(compare(sampler.sample_packed(q, W, H, wx, wy),
                            sampler.sample_packed_plain(q, W, H, wx, wy),
                            f"packed {tag}, one hypothesis"))
        errs.append(compare(sampler.sample_packed(q, W, H, sx, sy),
                            sampler.sample_packed_plain(q, W, H, sx, sy),
                            f"packed {tag}, NaN/inf/far-out block"))
        res[tag] = time_packed(q, W, H, wx, wy, f"packed {tag}", card)
    res["u8"]["library_ms"] = grid_sample_ms(data[True].src_quads, W, H, wx,
                                             wy, card)

    # the image form (the Pallas entry's own contract) at (600, 800)
    img = imgs[1].contiguous()
    ix, iy = wx[0].reshape(-1), wy[0].reshape(-1)
    errs.append(compare(sampler.sample_blocks(img, ix, iy),
                        sampler.sample_blocks_plain(img, ix, iy),
                        "image form"))
    errs.append(compare(sampler.sample_blocks(img, sx[0], sy[0]),
                        sampler.sample_blocks_plain(img, sx[0], sy[0]),
                        "image form, NaN/inf/far-out block"))
    m = ix.numel()
    igrid = torch.stack([ix * (2.0 / (W - 1)) - 1.0,
                         iy * (2.0 / (H - 1)) - 1.0], -1).reshape(1, 1, m, 2)
    img4 = img[None, None]
    res["image"] = dict(
        ms=cuda_ms(lambda: sampler.sample_blocks(img, ix, iy), 20),
        plain_ms=cuda_ms(lambda: sampler.sample_blocks_plain(img, ix, iy),
                         5, 1),
        library_ms=cuda_ms(lambda: F.grid_sample(
            img4, igrid, mode="bilinear", padding_mode="border",
            align_corners=True), 10),
        bound_ms=max((12 * m + 4 * H * W) / HBM_BYTES_PER_S,
                     K1_OPS_PER_SAMPLE * m / F32_FLOPS_PER_S) * 1e3)
    r = res["image"]
    log(f"  image form ({H}x{W}, {m} samples): K1 {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, grid_sample {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms [{card}]")
    # one tile-route rank's strong sweep: the black pixels of its row shard
    # (rows 0 .. H / RANKS - 1), all sources, the 36 taps
    nb = (H // RANKS) * (W // 2)
    rx, ry = wx[:, :nb].contiguous(), wy[:, :nb].contiguous()
    res["shard"] = {}
    for u8 in (True, False):
        q = data[u8].src_quads
        tag = "u8" if u8 else "f32"
        errs.append(compare(sampler.sample_packed(q, W, H, rx, ry),
                            sampler.sample_packed_plain(q, W, H, rx, ry),
                            f"packed {tag}, row shard {tuple(rx.shape)}",
                            tol=0.0))
        res["shard"][tag] = time_packed(q, W, H, rx, ry,
                                        f"row shard {tag}", card)
    res["shard"]["u8"]["library_ms"] = grid_sample_ms(
        data[True].src_quads, W, H, rx, ry, card)
    res["shard"]["shape"] = tuple(rx.shape)
    # one pixel's window, the shape tools.debug_point samples at
    for u8 in (True, False):
        q = data[u8].src_quads
        px, py = wx[:, :1].contiguous(), wy[:, :1].contiguous()
        errs.append(compare(sampler.sample_packed(q, W, H, px, py),
                            sampler.sample_packed_plain(q, W, H, px, py),
                            f"packed {'u8' if u8 else 'f32'}, one pixel "
                            f"{tuple(px.shape)}", tol=0.0))
    res["max_abs_err"] = max(errs)
    return res


def composition(data, x, y, plane, win):
    """The strong NCC as the port computed it before K2, from the
    package's public pieces: the homography, an (S, B, 36) warp, K1,
    ``window_sums`` and ``ncc_from_sums``."""
    import torch

    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops import cost
    from apde_mvs_tpu_torch.ops.cuda import sampler
    hom = geo.homography(data.ref_cam, data.src_views, plane)
    cx, cy = geo.warp(hom, x, y)
    oob = (cx < 0) | (cx >= data.img_w) | (cy < 0) | (cy >= data.img_h)
    wx, wy = geo.warp(hom[..., None, :, :], x[:, None] + win.tap_dx,
                      y[:, None] + win.tap_dy)
    sv = sampler.sample_packed(data.src_quads, data.width, data.quad_h,
                               wx.contiguous(), wy.contiguous())
    c = cost.ncc_from_sums(win.sum_ref, win.sum_rr,
                           *cost.window_sums(win.tap_w, win.tap_val, sv),
                           win.wsum)
    return torch.where(oob, cost.COST_MAX, c).T


def k2_bound(data, x, y, plane, win) -> tuple:
    """The least time the card could take for one K2 call: the bytes its
    inputs and output need (each read or written once; the quad-table rows
    this call's taps touch, each once) over the memory rate, against its
    f32 operations over the plain-f32 rate. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    from apde_mvs_tpu_torch.core import geometry as geo
    s, b = data.num_src, x.numel()
    t = win.tap_val.shape[1]
    hom = geo.homography(data.ref_cam, data.src_views, plane)
    wx, wy = geo.warp(hom[..., None, :, :], x[:, None] + win.tap_dx,
                      y[:, None] + win.tap_dy)
    rows = touched_rows(data.src_quads, data.width, data.quad_h, wx, wy)
    del hom, wx, wy
    per_pixel = 4 * (2 + 4 + t + 2)              # x, y, plane, values, sums
    if win.tap_w is not None:
        per_pixel += 4 * (1 + t)                 # weight sum, weights
    nbytes = b * per_pixel + 4 * (win.tap_dx.numel() + win.tap_dy.numel()) \
        + (s + 1) * 16 * 4 + rows * 4 * data.src_quads.element_size() \
        + 4 * s * b
    per_tap = K2_OPS_PER_TAP + (2 if win.tap_w is not None else 0)
    ops = s * b * (t * per_tap + K2_OPS_PER_PAIR)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def k2_check(data, x, y, plane, win, what: str) -> float:
    """K2 against its plain version on the card: bitwise, so the COST_MAX
    placements too. Returns the max abs difference read from the two."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import ncc
    got = ncc.ncc_strong_fused(data, x, y, plane, win)
    want = ncc.ncc_strong_plain(data, x, y, plane, win)
    torch.cuda.synchronize()
    n_max = int((want == 2.0).sum())
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        err = float((got - want).abs().max()) if bad >= 0 else float("inf")
        raise AssertionError(f"K2 {what}: {bad} costs differ from the plain "
                             f"version, max abs {err}")
    log(f"  K2 {what} {tuple(want.T.shape)}: bitwise equal to the plain "
        f"version, {n_max} of {want.numel()} at COST_MAX")
    return float((got - want).abs().max())


def k2_times(data, x, y, plane, win, what: str, card: str) -> dict:
    """K2's, the plain version's and the composition's mean times
    (CUDA events, warm), the composition held to K2 within 1e-4, and the
    bound."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import ncc
    comp = composition(data, x, y, plane, win)
    got = ncc.ncc_strong_fused(data, x, y, plane, win)
    torch.cuda.synchronize()
    same = (comp == 2.0) == (got == 2.0)
    at_clamp = torch.minimum(comp, got) >= 2.0 - 1e-4
    diff = float((comp - got).abs().max())
    log(f"  K2 {what} against the composition: max abs {diff:.3g}, "
        f"COST_MAX placed differently at {int((~same).sum())} costs, "
        f"{int((~same & ~at_clamp).sum())} of them away from the clamp")
    if not diff <= 1e-4 or not bool((same | at_clamp).all()):
        raise AssertionError(f"K2 {what} disagrees with the composition")
    del comp, got
    ms = cuda_ms(lambda: ncc.ncc_strong_fused(data, x, y, plane, win), 20)
    plain_ms = cuda_ms(lambda: ncc.ncc_strong_plain(data, x, y, plane, win),
                       3, 1)
    comp_ms = cuda_ms(lambda: composition(data, x, y, plane, win), 10)
    bound, by, nbytes, ops = k2_bound(data, x, y, plane, win)
    log(f"  K2 {what}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"composition {comp_ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                composition_ms=comp_ms, library_ms=None)


def segment_masks(depth, seed: int):
    """Synthetic SA segment ids on the card: the weak plane is segment 1,
    seeded rectangles of segments 2-9 cut across it, 0 elsewhere."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    m = weak_region(depth).astype(np.int32)
    h, w = m.shape
    for k in range(2, 10):
        y0, x0 = rng.integers(0, h - h // 10), rng.integers(0, w - w // 10)
        m[y0:y0 + rng.integers(h // 30, h // 10),
          x0:x0 + rng.integers(w // 40, w // 10)] = k
    return torch.as_tensor(m)


def k2_phase(scene, seed: int, device, card: str) -> dict:
    """K2, the fused strong NCC, against its plain version on the card,
    bitwise, at every shape the main path gives it (the strong sweep's
    black pixels, u8 and f32; the classify chunk; one tile-route rank's
    halo row block; one pixel; an SA star window; degenerate planes), and
    its times against the plain version and the composition it replaced."""
    import torch

    from apde_mvs_tpu_torch.core import checkerboard as cb
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops.cost import CostData, precompute_ref_window
    from apde_mvs_tpu_torch.ops.cuda import ncc
    from apde_mvs_tpu_torch.parallel.tiles import HALO_ROWS, halo_block
    from apde_mvs_tpu_torch.pipeline.full_pass import CHUNK
    from apde_mvs_tpu_torch.testing.kernel_cases import cycled_views, \
        window_25

    H, W = scene.images.shape[1:]
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    sa = segment_masks(scene.depths[0], seed).to(device)
    data = {u8: CostData.build(cams.view(0), cams.map(lambda a: a[1:]),
                               imgs[0], imgs[1:], sampler_u8=u8, sa_mask=sa)
            for u8 in (True, False)}
    depth = torch.as_tensor(scene.depths[0], device=device)
    normal = torch.as_tensor(scene.normals[0], device=device)
    ncam = geo.normal_world_to_cam(cams.view(0).R, torch.cat(
        [normal, torch.zeros_like(depth)[..., None]], -1))[..., :3]

    def black(rows=slice(None), cam=None, row0=0, scale=1.0):
        """The black pixels of image rows ``rows`` and their ground-truth
        planes (depth times ``scale``), in the coordinates of a block whose
        row 0 is image row ``row0``."""
        xs, ys = cb.color_coords(H, W, 0, device=device)
        xs, ys = xs[rows].reshape(-1), ys[rows].reshape(-1)
        xf, yf = xs.float(), (ys - row0).float()
        plane = geo.make_plane(cam or cams.view(0), xf, yf,
                               depth[ys.long(), xs.long()] * scale,
                               ncam[ys.long(), xs.long()])
        return xf.contiguous(), yf.contiguous(), plane.contiguous()

    res, errs = {}, []
    # the strong sweep's hypothesis: every black pixel, all 10 sources
    x, y, plane = black()
    log(f"K2 strong shape: {data[True].num_src} views x {x.numel()} pixels "
        "x 36 taps in one launch")
    for u8 in (True, False):
        win = precompute_ref_window(data[u8], x, y, 5, 2)
        errs.append(k2_check(data[u8], x, y, plane, win,
                             f"strong {'u8' if u8 else 'f32'}"))
    win = precompute_ref_window(data[True], x, y, 5, 2)
    res["strong"] = k2_times(data[True], x, y, plane, win, "strong u8", card)
    # the classify sweep's chunk at a probe depth off the truth
    cx, cy, cplane = black(scale=1.02)
    cx, cy, cplane = cx[:CHUNK], cy[:CHUNK], cplane[:CHUNK].contiguous()
    cwin = precompute_ref_window(data[True], cx, cy, 5, 2)
    errs.append(k2_check(data[True], cx, cy, cplane, cwin,
                         "classify chunk u8"))
    res["chunk"] = k2_times(data[True], cx, cy, cplane, cwin,
                            "classify chunk u8", card)
    # one tile-route rank: rows 0 .. H / RANKS - 1 with their halo, the
    # source tables at full height
    shard = {}
    for u8 in (True, False):
        block, row0, _, _ = halo_block(data[u8].replace(sa_mask=None), 0,
                                       H // RANKS, HALO_ROWS)
        bx, by, bplane = black(slice(0, H // RANKS), block.ref_cam, row0)
        if not block.quad_h > block.height:
            raise AssertionError("the row block has no halo table")
        bwin = precompute_ref_window(block, bx, by, 5, 2)
        errs.append(k2_check(
            block, bx, by, bplane, bwin,
            f"row shard {'u8' if u8 else 'f32'} (block {block.height} "
            f"rows, tables {block.quad_h})"))
        shard[u8] = (block, bx, by, bplane, bwin)
    res["shard"] = k2_times(*shard[True], "row shard u8", card)
    res["shard"]["shape"] = (data[True].num_src, shard[True][1].numel())
    del shard
    # one pixel, tools.debug_point's shape
    errs.append(k2_check(
        data[True], x[:1], y[:1], plane[:1],
        precompute_ref_window(data[True], x[:1], y[:1], 5, 2),
        "one pixel u8"))
    # the SA star window on the segment masks
    for u8 in (True, False):
        swin = precompute_ref_window(data[u8], x, y, 5, 2, use_sa=True)
        cut = int((swin.wsum < 36).sum())
        if cut == 0:
            raise AssertionError("no SA window was truncated")
        errs.append(k2_check(
            data[u8], x, y, plane, swin,
            f"SA star {'u8' if u8 else 'f32'} ({cut} windows cut)"))
    # degenerate planes: w = 0, NaN, +-inf, and centres off the image
    n = CHUNK
    sp = plane[:n].clone()
    near = geo.make_plane(cams.view(0), x[:n], y[:n],
                          torch.full_like(x[:n], 0.01), plane[:n, :3])
    sp[0::7, 3] = 0.0
    sp[1::7] = float("nan")
    sp[2::7, 3] = float("inf")
    sp[3::7, 3] = float("-inf")
    sp[4::7, 0] = float("inf")
    sp[5::7] = near[5::7]
    sp[6::7, 2] = float("-inf")
    swin = precompute_ref_window(data[True], x[:n], y[:n], 5, 2)
    errs.append(k2_check(data[True], x[:n], y[:n], sp.contiguous(), swin,
                         "degenerate planes u8"))
    # the generic tap loop: 25-tap windows, shared and per-pixel offsets
    for per_pixel in (False, True):
        errs.append(k2_check(
            data[True], x, y, plane, window_25(data[True], x, y, per_pixel),
            f"25-tap {'per-pixel weighted' if per_pixel else 'square'} "
            "window u8"))
    # 32 source views, the kernel's limit: the 10 cycled
    d32, _ = cycled_views(data[True], 32)
    errs.append(k2_check(d32, x, y, plane,
                         precompute_ref_window(d32, x, y, 5, 2),
                         "strong u8, 32 views (the 10 cycled)"))
    del d32
    got = ncc.ncc_strong_fused(data[True], x[:n], y[:n], sp.contiguous(),
                               swin)
    for k, what in ((0, "w = 0"), (1, "NaN")):
        if not bool((got[k::7] == 2.0).all()):
            raise AssertionError(f"K2: {what} planes not all at COST_MAX")
    near_max = float((got[5::7] == 2.0).float().mean())
    log(f"  K2 degenerate planes: w = 0 and NaN all at COST_MAX, planes "
        f"0.01 in front of the camera {near_max:.4f} at COST_MAX")
    res["max_abs_err"] = max(errs)
    return res


def k5_bound(data, px, win, refine: bool, geom: bool) -> tuple:
    """The least time the card could take for one K5 call: its f32
    operations over the plain-f32 rate (only the (pixel, view) pairs whose
    weight is not 0 need any), against the bytes of its inputs (the quad
    tables and source depth maps whole, each read once), and output over the
    memory rate. Returns (ms, "bytes" or "operations", bytes, operations)."""
    s, b = data.num_src, px.x.numel()
    t = win.tap_val.shape[1]
    probes = 12 if refine else 61
    pairs = int((px.vw != 0).sum())
    per_tap = K2_OPS_PER_TAP + (2 if win.tap_w is not None else 0)
    ops = probes * (
        pairs * (t * per_tap + K2_OPS_PER_PAIR + K5_OPS_PER_PAIR
                 + (K5_GEOM_OPS_PER_PAIR if geom else 0))
        + b * (K5_OPS_PER_PIXEL + (K5_GEOM_OPS_PER_PIXEL if geom else 0)))
    per_pixel = 4 * (2 + 4 + 3 + s + t + 2)   # x, y, plane, scalars, vw,
    if win.tap_w is not None:                 # values, sums
        per_pixel += 4 * (3 * t + 1)          # offsets, weights, weight sum
    nbytes = b * (per_pixel + 4 * probes) + data.src_quads.numel() \
        * data.src_quads.element_size() + (s + 1) * 40 * 4
    if win.tap_w is None:
        nbytes += 8 * t
    if geom:
        nbytes += 4 * data.src_depths.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def bitwise(got, want) -> bool:
    """Bit-for-bit equality of two f32 tensors, NaN payloads included."""
    import torch
    return got.shape == want.shape and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


def k5_check(data, px, win, kw: dict, what: str) -> float:
    """K5 against its plain version on the card: bitwise. Returns the max
    abs difference read from the two (over non-NaN costs)."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import sweep
    got = sweep.sweep_fused(data, px, win, **kw)
    want = sweep.sweep_plain(data, px, win, **kw)
    torch.cuda.synchronize()
    if not bitwise(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"K5 {what}: {bad} costs differ from the plain "
                             f"version")
    ok = ~torch.isnan(want)
    n_max = int((want[ok] >= 2.0).sum())
    log(f"  K5 {what} {tuple(want.shape)}: bitwise equal to the plain "
        f"version, {n_max} of {want.numel()} at or above COST_MAX, "
        f"{int((~ok).sum())} NaN")
    return float((got[ok] - want[ok]).abs().max()) if bool(ok.any()) \
        else 0.0


def k5_times(data, sc, px, win, kw: dict, what: str, card: str) -> dict:
    """K5's, the plain version's and the per-probe composition's mean times
    (CUDA events, warm), K5 with every view weighted (no pair skipped), and
    the bound; the composition held to K5 within 1e-4 at every cost, and
    non-finite at the same costs (it sums the plane's w in K5's order:
    ``testing.sweep_composition``)."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import sweep
    from apde_mvs_tpu_torch.testing.sweep_composition import \
        sweep_composition
    comp = sweep_composition(data, sc, px, win, **kw)
    got = sweep.sweep_fused(data, px, win, **kw)
    torch.cuda.synchronize()
    ok = torch.isfinite(comp) & torch.isfinite(got)
    diff = torch.where(ok, comp - got, 0.0).abs()
    max_diff = float(diff.max())
    log(f"  K5 {what} against the composition: max abs {max_diff:.3g} over "
        f"{comp.numel()} costs, {int((diff > 1e-6).sum())} more than 1e-6 "
        f"apart")
    if not max_diff <= 1e-4 \
            or not torch.equal(torch.isfinite(comp), torch.isfinite(got)):
        raise AssertionError(f"K5 {what} disagrees with the composition")
    del comp, got, diff
    ms = cuda_ms(lambda: sweep.sweep_fused(data, px, win, **kw), 10)
    plain_ms = cuda_ms(lambda: sweep.sweep_plain(data, px, win, **kw), 1, 1)
    comp_ms = cuda_ms(
        lambda: sweep_composition(data, sc, px, win, **kw), 3, 1)
    every = px._replace(vw=torch.ones_like(px.vw),
                        wnorm=torch.full_like(px.wnorm, px.vw.shape[1]))
    all_ms = cuda_ms(lambda: sweep.sweep_fused(data, every, win, **kw), 5)
    bound, by, nbytes, ops = k5_bound(data, px, win, kw["refine"],
                                      kw["geom"])
    pairs = float((px.vw != 0).float().mean())
    log(f"  K5 {what}: {ms:.4f} ms, plain {plain_ms:.4f} ms, composition "
        f"{comp_ms:.4f} ms, every view weighted {all_ms:.4f} ms ({pairs:.3f} "
        f"of the pairs weighted here), bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                composition_ms=comp_ms, all_views_ms=all_ms,
                composition_max_abs=max_diff,
                library_ms=None)


def k5_stage_bound(data, state, x, y, kw: dict) -> tuple:
    """The least time the card could take for one call of K5's stage form
    (``sweep.stage_fused``): the sweep's f32 operations as ``k5_bound``
    counts them over the pairs this call's setup weights, with the setup's,
    the window's and the rule's (K5_STAGE_*, K3_WINDOW_OPS_PER_TAP),
    against the bytes of its inputs (the pixels and their state cells, the
    reference image and segment ids, the quad tables and source depth maps
    whole, each read once) and outputs. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    from apde_mvs_tpu_torch.ops import filters
    from apde_mvs_tpu_torch.ops.cost import square_taps
    s, b = data.num_src, x.numel()
    geom = kw["geom"]
    t = len(square_taps(kw["radius"], kw["increment"]))
    sa = kw["use_sa"] and data.sa_mask is not None
    probes = 12 if kw["refine"] else 61
    sc = filters._sweep_scalars(data, state, x, y)
    pairs = int(((sc.vw != 0) & (sc.wnorm > 0)[:, None]).sum())
    per_tap = K2_OPS_PER_TAP + (2 if sa else 0)
    ops = probes * (
        pairs * (t * per_tap + K2_OPS_PER_PAIR + K5_OPS_PER_PAIR
                 + (K5_GEOM_OPS_PER_PAIR if geom else 0))
        + b * (K5_OPS_PER_PIXEL + (K5_STAGE_REFINE_OPS_PER_PROBE
                                   if kw["refine"] else
                                   K5_STAGE_CLASSIFY_OPS_PER_PROBE)
               + (K5_GEOM_OPS_PER_PIXEL if geom else 0))) \
        + b * (s * K5_STAGE_OPS_PER_VIEW + K5_STAGE_OPS_PER_PIXEL
               + t * K3_WINDOW_OPS_PER_TAP)
    out = 4 + (4 * probes if kw.get("return_curve") else 0)
    nbytes = b * (8 + 16 + 5 * s + 1 + out) \
        + 4 * data.ref_image.numel() * (2 if sa else 1) \
        + data.src_quads.numel() * data.src_quads.element_size() \
        + (s + 1) * 40 * 4 + 4 * s
    if geom:
        nbytes += 4 * data.src_depths.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def stage_kwargs(refine: bool, geom: bool, params, dmin, dmax,
                 use_sa=False) -> dict:
    """``sweep.stage_fused``'s keyword arguments as the pass gives them:
    the 36-tap window, the pass's geometric factor, depth bounds and peak
    radius (classify with its curve)."""
    kw = dict(refine=refine, radius=5, increment=2, use_sa=use_sa, geom=geom,
              geom_factor=float(params.geom_factor), depth_min=float(dmin),
              depth_max=float(dmax))
    if not refine:
        kw.update(weak_peak_radius=params.weak_peak_radius,
                  return_curve=True)
    return kw


def k5_stage_check(data, state, x, y, kw: dict, what: str) -> float:
    """K5's stage form against its plain version on the card: the depths or
    the classes and the curve bitwise; classify also without its curve (the
    classes alone, the main path's form). Returns the max abs difference
    read from the two (over non-NaN values)."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import sweep
    got = sweep.stage_fused(data, state, x, y, **kw)
    want = sweep.stage_plain(data, state, x, y, **kw)
    bare = None if kw["refine"] else sweep.stage_fused(
        data, state, x, y, **dict(kw, return_curve=False))
    torch.cuda.synchronize()
    if kw["refine"]:
        if not bitwise(got, want):
            raise AssertionError(f"K5 stage {what}: {int((got != want).sum())}"
                                 f" depths differ from the plain version")
        old = state.planes[y.long(), x.long(), 3]
        log(f"  K5 stage {what} ({x.numel()} pixels): depths bitwise equal "
            f"to the plain version, {float((want != old).float().mean()):.4f}"
            f" of them refined")
        vals = (got, want)
    else:
        if not torch.equal(got[0], want[0]) or not bitwise(got[1], want[1]) \
                or not torch.equal(bare[0], want[0]) or bare[1] is not None:
            raise AssertionError(
                f"K5 stage {what}: {int((got[0] != want[0]).sum())} classes, "
                f"{int((got[1] != want[1]).sum())} curve values, "
                f"{int((bare[0] != want[0]).sum())} classes without the "
                "curve differ from the plain version")
        counts = torch.bincount(want[0].long(), minlength=3).tolist()
        log(f"  K5 stage {what} ({x.numel()} pixels): classes and curve "
            f"bitwise equal to the plain version, and the classes without "
            f"the curve; WEAK / STRONG / UNKNOWN {counts}")
        vals = (got[1], want[1])
    ok = ~torch.isnan(vals[1])
    return float((vals[0][ok] - vals[1][ok]).abs().max()) \
        if bool(ok.any()) else 0.0


def old_stage(data, state, x, y, kw: dict):
    """The stage as the route before K5's stage form ran it: the setup
    (``filters._sweep_scalars``), the window
    (``cost.precompute_ref_window``) and the peak or accept rule as torch
    ops around one launch of K5's sweep form. Its setup and rule sum in
    the stage form's fixed order, a few ops more than before."""
    import torch

    from apde_mvs_tpu_torch.core.sampling import fetch
    from apde_mvs_tpu_torch.ops import filters
    from apde_mvs_tpu_torch.ops.cost import contiguous_window, \
        precompute_ref_window
    from apde_mvs_tpu_torch.ops.cuda import sweep
    xf, yf = x.float(), y.float()
    sc = filters._sweep_scalars(data, state, x, y)
    win = contiguous_window(precompute_ref_window(
        data, xf, yf, kw["radius"], kw["increment"], kw["use_sa"]))
    px = sweep.SweepPixels(xf, yf, sc.plane_cam.contiguous(),
                           sc.disp.contiguous(), sc.base_line.contiguous(),
                           sc.vw.contiguous(), sc.wnorm.contiguous())
    costs = sweep.sweep_fused(data, px, win, refine=kw["refine"],
                              geom=kw["geom"], geom_factor=kw["geom_factor"],
                              depth_min=kw["depth_min"],
                              depth_max=kw["depth_max"])
    if kw["refine"]:
        ok = sc.ok & (sc.wnorm > 0) & fetch(state.valid, x, y)
        return torch.where(ok, filters._refine_depths(data, sc, costs),
                           sc.depth)
    return (filters._classify_peaks(data, state, x, y, costs,
                                    kw["weak_peak_radius"], sc.ok),
            costs if kw.get("return_curve") else None)


def k5_stage_times(data, state, x, y, kw: dict, what: str,
                   card: str) -> dict:
    """K5's stage form's, its plain version's and the old stage
    composition's (``old_stage``) mean times (CUDA events, warm; the
    composition's include the host's gaps between its ops), the old
    composition's result held to the stage's (classes equal, depths and
    curve bitwise: u8 tables make the windows' sums exact in any order),
    and the bound. Times the main path's form: classify without its
    curve."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import sweep
    kw = dict(kw, return_curve=False) if not kw["refine"] else kw
    got = sweep.stage_fused(data, state, x, y, **kw)
    old = old_stage(data, state, x, y, kw)
    torch.cuda.synchronize()
    same = bitwise(got, old) if kw["refine"] else torch.equal(got[0], old[0])
    if not same:
        raise AssertionError(f"K5 stage {what} differs from the old stage "
                             "composition")
    ms = cuda_ms(lambda: sweep.stage_fused(data, state, x, y, **kw), 10)
    old_ms = cuda_ms(lambda: old_stage(data, state, x, y, kw), 10)
    plain_ms = cuda_ms(lambda: sweep.stage_plain(data, state, x, y, **kw),
                       1, 1)
    bound, by, nbytes, ops = k5_stage_bound(data, state, x, y, kw)
    log(f"  K5 stage {what}: {ms:.4f} ms, the old stage composition "
        f"{old_ms:.4f} ms (equal results), plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
        f"GFLOP) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                old_stage_ms=old_ms, library_ms=None)


def k5_stage_phase(data: dict, state, cx, cy, params, dmin, dmax, block,
                   card: str) -> dict:
    """K5's stage form (the setup from the state's maps, the window, the
    sweep and the rule in one launch) against its plain version on the
    card, bitwise, at the classify chunk (u8 and f32, the geometric cost on
    and off, classify with and without its curve, refine), with the SA
    star window, on degenerate planes and empty weights in a ragged chunk,
    one pixel, 32 views and a tile-route halo row block (``block``: its
    data, state and pixels); then its times against the old stage
    composition and its plain version (square and SA windows)."""
    import torch

    from apde_mvs_tpu_torch.testing.kernel_cases import cycled_views
    errs, res = [], {}

    def kw(refine, geom=True, use_sa=False):
        return stage_kwargs(refine, geom, params, dmin, dmax, use_sa)

    log(f"K5 stage form at the classify chunk: {cx.numel()} pixels, the "
        "setup, window and rule in the launch")
    for u8 in (True, False):
        for geom in (True, False):
            for refine in (False, True):
                errs.append(k5_stage_check(
                    data[u8], state, cx, cy, kw(refine, geom),
                    f"{'refine' if refine else 'classify'} chunk "
                    f"{'u8' if u8 else 'f32'}"
                    f"{', geometric' if geom else ''}"))
    for refine in (False, True):
        errs.append(k5_stage_check(
            data[True], state, cx, cy, kw(refine, use_sa=True),
            f"{'refine' if refine else 'classify'} SA star u8, geometric"))
    # degenerate planes and empty view weights on a ragged chunk
    n = cx.numel() - 17
    planes = state.planes.clone().reshape(-1, 4)
    planes[0::7, 3] = 0.0
    planes[1::7] = float("nan")
    planes[2::7, 3] = float("inf")
    planes[3::7, 3] = float("-inf")
    planes[4::7, 0] = float("inf")
    vw = state.view_weights.clone().reshape(planes.shape[0], -1)
    vw[5::7] = 0.0
    bad = state.replace(planes=planes.reshape(state.planes.shape),
                        view_weights=vw.reshape(state.view_weights.shape))
    for refine in (False, True):
        errs.append(k5_stage_check(
            data[True], bad, cx[:n], cy[:n], kw(refine),
            f"{'refine' if refine else 'classify'} degenerate planes, "
            "empty weights, ragged u8"))
        errs.append(k5_stage_check(
            data[True], state, cx[:1], cy[:1], kw(refine),
            f"{'refine' if refine else 'classify'} one pixel u8"))
    d32, idx = cycled_views(data[True], 32)
    s32 = state.replace(selected=state.selected[..., idx].contiguous(),
                        view_weights=state.view_weights[..., idx]
                        .contiguous())
    errs.append(k5_stage_check(d32, s32, cx, cy, kw(False),
                               "classify 32 views (the 10 cycled) u8"))
    del d32, s32, bad
    bdata, bstate, bx, by = block
    errs.append(k5_stage_check(bdata, bstate, bx, by, kw(False),
                               f"classify row shard u8 (block "
                               f"{bdata.height} rows, tables "
                               f"{bdata.quad_h})"))
    for mode, refine in (("classify", False), ("refine", True)):
        res[mode] = k5_stage_times(data[True], state, cx, cy, kw(refine),
                                   f"{mode} chunk u8, geometric", card)
    res["classify_sa"] = k5_stage_times(
        data[True], state, cx, cy, kw(False, use_sa=True),
        "classify chunk SA star u8, geometric", card)
    res["max_abs_err"] = max(errs)
    return res


def stage_real_phase(rp, card: str) -> dict:
    """K5's stage form on the first classify and the first refine chunk a
    real APD REFINE_INIT pass hands it (``rp``:
    ``tools.kernel_times.real_pass_inputs``; its calls captured as made):
    bitwise against its plain version, timed against it and the old stage
    composition."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import sweep
    from apde_mvs_tpu_torch.pipeline import patchmatch
    log("==== K5's stage form on a real APD pass's chunks ====")
    fused = sweep.stage_fused
    calls = {}

    def capture(*a, **kw):
        calls.setdefault("refine" if kw["refine"] else "classify", (a, kw))
        return fused(*a, **kw)
    sweep.stage_fused = capture
    try:
        patchmatch.run_patchmatch(rp.data, rp.params, depth_min=rp.depth_min,
                                  depth_max=rp.depth_max, seed=1, **rp.prior)
    finally:
        sweep.stage_fused = fused
    torch.cuda.synchronize()
    res, errs = {}, []
    for mode in ("classify", "refine"):
        a, kw = calls[mode]
        what = f"{mode}, a real APD pass's first chunk"
        errs.append(k5_stage_check(*a, dict(kw, return_curve=True)
                                   if mode == "classify" else kw, what))
        res[mode] = k5_stage_times(*a, kw, what, card)
        res[mode]["pixels"] = a[2].numel()
    res["max_abs_err"] = max(errs)
    return res


def refine_iter_state(scene, data, params, seed: int, device) -> tuple:
    """A REFINE_ITER pass's state on view 0: planes near the truth (depth
    noise 0.2%, a fifth of the pixels 3% off), each pixel's top-k views of
    K2's costs selected with weights 1-4. Returns (the state with (world
    normal, depth) planes, as the classify and refine sweeps read it; the
    camera-frame planes and the top-k mean costs, as the strong sweep reads
    them)."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops import filters
    from apde_mvs_tpu_torch.ops.cost import initial_cost_and_selection, \
        ncc_strong, precompute_ref_window
    from apde_mvs_tpu_torch.ops.state import PMState

    H, W = scene.images.shape[1:]
    S = data.num_src
    rng = np.random.default_rng(seed)
    depth = scene.depths[0] * (1 + rng.normal(0, 0.002, (H, W)))
    depth = np.where(rng.random((H, W)) < 0.2,
                     depth * (1 + rng.choice([-0.03, 0.03], (H, W))), depth)
    planes = torch.as_tensor(np.concatenate(
        [scene.normals[0], depth[..., None]], -1).astype(np.float32),
        device=device)
    xs, ys = geo.pixel_grid(H, W, device)
    cam_planes = filters.depth_normal_to_planes(data, planes[..., 3],
                                                planes[..., :3])
    win_all = precompute_ref_window(data, xs.reshape(-1), ys.reshape(-1), 5,
                                    2)
    costs = ncc_strong(data, xs.reshape(-1), ys.reshape(-1),
                       cam_planes.reshape(-1, 4), win_all)
    del win_all
    mean_cost, sel = initial_cost_and_selection(costs, params.top_k)
    vw = sel.float() * torch.randint(1, 5, sel.shape, device=device,
                                     generator=torch.Generator(
                                         device=device).manual_seed(seed))
    state = PMState.create(H, W, S, device=device).replace(
        planes=planes, selected=sel.reshape(H, W, S).contiguous(),
        view_weights=vw.reshape(H, W, S).contiguous())
    return state, cam_planes.contiguous(), mean_cost.reshape(H, W)


def k5_phase(scene, seed: int, device, card: str) -> dict:
    """K5, the fused disparity sweep, against its plain version on the card,
    bitwise, at the shapes the main path gives it: the classify chunk
    (65,536 pixels, all 10 sources) in classify and refine modes with u8
    and f32 tables and the geometric cost on and off, an SA star window, a
    tile-route rank's halo row block, degenerate planes and empty weights
    on a ragged chunk, and every pixel of a view in the export-curve form;
    then its times against the plain version and the composition it
    replaced. The state: near-truth planes (some 3% off), each pixel's
    top-k views of K2's costs selected with weights 1-4."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch import config as cfg
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops import filters
    from apde_mvs_tpu_torch.ops.cost import CostData, contiguous_window, \
        precompute_ref_window
    from apde_mvs_tpu_torch.ops.cuda import sweep
    from apde_mvs_tpu_torch.ops.state import PMState
    from apde_mvs_tpu_torch.parallel.tiles import HALO_ROWS, halo_block
    from apde_mvs_tpu_torch.pipeline.full_pass import CHUNK, MIN_MARGIN
    from apde_mvs_tpu_torch.testing.kernel_cases import WEIGHT_PATTERNS, \
        cycled_views, weight_pattern
    from apde_mvs_tpu_torch.testing.sweep_composition import \
        sweep_composition

    H, W = scene.images.shape[1:]
    S = scene.num_views - 1
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    sa = segment_masks(scene.depths[0], seed).to(device)
    src_depths = torch.as_tensor(np.stack(scene.depths[1:]), device=device)
    data = {u8: CostData.build(cams.view(0), cams.map(lambda a: a[1:]),
                               imgs[0], imgs[1:], src_depths=src_depths,
                               sampler_u8=u8, sa_mask=sa)
            for u8 in (True, False)}
    params = cfg.build_schedule(max(H, W))[1].params      # REFINE_ITER
    dmin = scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR
    state, _, _ = refine_iter_state(scene, data[True], params, seed, device)
    sel = state.selected.reshape(H * W, S)
    xs, ys = geo.pixel_grid(H, W, device)
    # the classify chunk: the first CHUNK sweepable pixels off the margins
    margin = (xs < MIN_MARGIN) | (ys < MIN_MARGIN) \
        | (xs >= W - MIN_MARGIN) | (ys >= H - MIN_MARGIN)
    cy, cx = torch.nonzero(~margin, as_tuple=True)
    cx, cy = cx[:CHUNK].to(torch.int32), cy[:CHUNK].to(torch.int32)

    def inputs(d, st, x, y, use_sa=False):
        xf, yf = x.float(), y.float()
        sc = filters._sweep_scalars(d, st, x, y)
        px = sweep.SweepPixels(xf, yf, sc.plane_cam.contiguous(), sc.disp,
                               sc.base_line, sc.vw.contiguous(), sc.wnorm)
        return sc, px, contiguous_window(
            precompute_ref_window(d, xf, yf, 5, 2, use_sa))

    def kwargs(refine, geom):
        return dict(refine=refine, geom=geom,
                    geom_factor=params.geom_factor, depth_min=dmin,
                    depth_max=dmax)

    log(f"K5 classify chunk: {S} views x {cx.numel()} pixels x 36 taps x 61 "
        f"probes (refine: 12) in one launch; "
        f"{float(sel.float().sum(-1).mean()):.2f} views selected a pixel")
    errs, res = [], {}
    for u8 in (True, False):
        sc, px, win = inputs(data[u8], state, cx, cy)
        for geom in (True, False):
            for refine in (False, True):
                errs.append(k5_check(
                    data[u8], px, win, kwargs(refine, geom),
                    f"{'refine' if refine else 'classify'} chunk "
                    f"{'u8' if u8 else 'f32'}"
                    f"{', geometric' if geom else ''}"))
    sc, px, win = inputs(data[True], state, cx, cy)
    # view-weight patterns on the classify chunk
    for pattern in WEIGHT_PATTERNS:
        for refine in (False, True):
            errs.append(k5_check(
                data[True], weight_pattern(px, pattern), win,
                kwargs(refine, True), f"{'refine' if refine else 'classify'}"
                f" chunk u8, geometric, weights {pattern}"))
    # 32 source views, the kernel's limit: the 10 and their weights cycled
    d32, idx = cycled_views(data[True], 32)
    vw32 = px.vw[:, idx].contiguous()
    for refine in (False, True):
        errs.append(k5_check(
            d32, px._replace(vw=vw32, wnorm=vw32.sum(-1)), win,
            kwargs(refine, True), f"{'refine' if refine else 'classify'} "
            "chunk u8, geometric, 32 views (the 10 cycled)"))
    del d32, vw32
    for refine in (False, True):
        mode = "refine" if refine else "classify"
        res[mode] = k5_times(data[True], sc, px, win, kwargs(refine, True),
                             f"{mode} chunk u8, geometric", card)
    res["classify"]["no_geom_ms"] = cuda_ms(lambda: sweep.sweep_fused(
        data[True], px, win, **kwargs(False, False)), 10)
    res["classify"]["no_geom_composition_ms"] = cuda_ms(
        lambda: sweep_composition(data[True], sc, px, win,
                                  **kwargs(False, False)), 3, 1)
    log(f"  K5 classify chunk u8 without the geometric cost (FIRST_INIT): "
        f"{res['classify']['no_geom_ms']:.4f} ms, composition "
        f"{res['classify']['no_geom_composition_ms']:.4f} ms [{card}]")
    # L2 residency: the u8 quad tables and the f32 source depth maps (19.2
    # MB each at 600x800x10) fit the 50 MB L2 together, f32 tables (76.8 MB)
    # do not
    _, fpx, fwin = inputs(data[False], state, cx, cy)
    res["classify"]["f32_ms"] = cuda_ms(lambda: sweep.sweep_fused(
        data[False], fpx, fwin, **kwargs(False, True)), 10)
    log(f"  K5 classify chunk f32 tables, geometric: "
        f"{res['classify']['f32_ms']:.4f} ms (u8 "
        f"{res['classify']['ms']:.4f} ms) [{card}]")
    del fpx, fwin
    # the SA star window on the segment masks
    sc, px, win = inputs(data[True], state, cx, cy, use_sa=True)
    cut = int((win.wsum < 36).sum())
    if cut == 0:
        raise AssertionError("no SA window was truncated")
    for refine in (False, True):
        errs.append(k5_check(data[True], px, win, kwargs(refine, True),
                             f"{'refine' if refine else 'classify'} SA star "
                             f"u8, geometric ({cut} windows cut)"))
    # one tile-route rank: rows 0 .. H / RANKS - 1 with their halo
    block, row0, _, _ = halo_block(data[True], 0, H // RANKS, HALO_ROWS)
    if not block.quad_h > block.height:
        raise AssertionError("the row block has no halo table")
    rows = torch.clamp(torch.arange(block.height, device=device) + row0, 0,
                       H - 1)
    bstate = PMState.create(block.height, W, S, device=device).replace(
        planes=state.planes[rows], selected=state.selected[rows],
        view_weights=state.view_weights[rows])
    by, bx = torch.nonzero(~margin[:H // RANKS], as_tuple=True)
    bx, by = bx[:CHUNK].to(torch.int32), (by[:CHUNK] - row0).to(torch.int32)
    _, bpx, bwin = inputs(block, bstate, bx, by)
    errs.append(k5_check(block, bpx, bwin, kwargs(False, True),
                         f"classify row shard u8, geometric (block "
                         f"{block.height} rows, tables {block.quad_h})"))
    # degenerate planes and empty view weights on a ragged chunk
    n = CHUNK - 17
    sc, px, win = inputs(data[True], state, cx[:n], cy[:n])
    plane = px.plane.clone()
    plane[0::7, 3] = 0.0
    plane[1::7] = float("nan")
    plane[2::7, 3] = float("inf")
    plane[3::7, 3] = float("-inf")
    plane[4::7, 0] = float("inf")
    plane[6::7, 2] = float("-inf")
    vw_d = px.vw.clone()
    vw_d[5::7] = 0.0
    bad = px._replace(plane=plane, vw=vw_d, wnorm=vw_d.sum(-1))
    for refine in (False, True):
        errs.append(k5_check(data[True], bad, win, kwargs(refine, True),
                             f"{'refine' if refine else 'classify'} "
                             "degenerate planes, empty weights u8"))
    got = sweep.sweep_fused(data[True], bad, win, **kwargs(False, True))
    if not bool((got[1::7] == 2.0).all()) or \
            not bool((got[5::7] == 2.0).all()):
        raise AssertionError("K5: NaN planes or empty weights not all at "
                             "COST_MAX")
    # the export-curve form: every pixel of the view, chunk by chunk
    ey, ex = ys.reshape(-1).to(torch.int32), xs.reshape(-1).to(torch.int32)
    for lo in range(0, ex.numel(), CHUNK):
        _, epx, ewin = inputs(data[True], state, ex[lo:lo + CHUNK],
                              ey[lo:lo + CHUNK])
        err = k5_check(data[True], epx, ewin, kwargs(False, True),
                       f"export-curve chunk at pixel {lo} u8, geometric")
        errs.append(err)
    res["max_abs_err"] = max(errs)
    res["stage"] = k5_stage_phase(data, state, cx, cy, params, dmin, dmax,
                                  (block, bstate, bx, by), card)
    return res


def k3_bound(data, x, y, kw: dict, flags, out, commit: bool = False
             ) -> tuple:
    """The least time the card could take for one K3 call: its f32
    operations over the plain-f32 rate (the pixels' windows built from the
    reference image, the valid candidates against every view, the current
    plane and the hypotheses against the weighted views this run's
    selection gave; a star window's taps weighted), against the bytes of
    its inputs (the state arrays, reference image, segment ids, quad tables
    and source depth maps whole, each read once) and outputs over the
    memory rate; with ``commit`` the outputs are the committed maps
    (planes, costs, selections, view weights), read once and written once,
    and the weak and valid maps are read. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    import torch

    from apde_mvs_tpu_torch.core.sampling import fetch
    from apde_mvs_tpu_torch.ops.cost import square_taps
    s, b = data.num_src, x.numel()
    geom = kw["geom"]
    t = len(square_taps(kw["radius"], kw["increment"]))
    sa = kw["use_sa"] and data.sa_mask is not None
    star = (fetch(data.sa_mask, x, y) > 0) if sa \
        else torch.zeros_like(x, dtype=torch.bool)
    per_pair = t * K3_OPS_PER_TAP + K3_OPS_PER_PAIR
    pairs = int(flags.sum(-1).mul(s).sum())
    weighted = int((out.view_weights != 0).sum())
    # a star pixel's pairs weigh each tap and form 4 quadrants' products
    star_pairs = int((flags.sum(-1) * s + K3_PLANES
                      * (out.view_weights != 0).sum(-1))[star].sum())
    ops = pairs * per_pair \
        + K3_PLANES * weighted * (per_pair + (K5_GEOM_OPS_PER_PAIR if geom
                                              else 0)) \
        + star_pairs * (2 * t + K3_STAR_OPS_PER_PAIR) \
        + weighted * K3_OPS_PER_WEIGHTED_PAIR + b * s * K3_SELECT_OPS_PER_VIEW \
        + b * (K3_OPS_PER_PIXEL + t * K3_WINDOW_OPS_PER_TAP
               + (K3_PLANES * K5_GEOM_OPS_PER_PIXEL if geom else 0))
    cells = data.height * data.width
    nbytes = b * (4 * (2 + 15 + 8) + 4 * 5 + 5 * s) \
        + cells * (4 + 16 + s) + 4 * cells * (2 if sa else 1) \
        + data.src_quads.numel() * data.src_quads.element_size() \
        + (s + 1) * 40 * 4
    if geom:
        nbytes += 4 * data.src_depths.numel()
    if commit:
        # the maps in and out, and the weak and valid maps, in place of
        # the batch's rows
        nbytes += cells * (2 * (16 + 4 + 5 * s) + 5) \
            - b * (4 * 5 + 5 * s)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def k3_commit_check(data, state, x, y, draws, kw: dict, what: str) -> float:
    """K3's commit form against its plain version on the card (the
    committed planes, costs, selections and view weights, bitwise), the
    state's maps left as they were. Returns the max abs difference read
    from the two (over non-NaN costs and planes)."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import strong
    old = [m.clone() for m in (state.planes, state.costs, state.selected,
                               state.view_weights)]
    got = strong.strong_fused(data, state, x, y, draws, commit=True, **kw)
    want = strong.commit_maps_plain(
        state, x, y, strong.strong_plain(data, state, x, y, draws, **kw))
    torch.cuda.synchronize()
    for name, g, w, o, m in zip(got._fields, got, want, old,
                                (state.planes, state.costs, state.selected,
                                 state.view_weights)):
        if g.dtype == torch.float32:
            g, w, o, m = (v.view(torch.int32) for v in (g, w, o, m))
        if not torch.equal(g, w):
            raise AssertionError(f"K3 commit {what}: {name} differs from the "
                                 f"plain commit at {int((g != w).sum())} "
                                 "values")
        if not torch.equal(o, m):
            raise AssertionError(f"K3 commit {what}: the state's {name} "
                                 "changed")
    xl, yl = x.long(), y.long()
    active = (state.weak[yl, xl] != 0) & state.valid[yl, xl]
    log(f"  K3 commit {what}: the committed maps bitwise equal to the plain "
        f"commit, {int(active.sum())} of {x.numel()} pixels active, the "
        "state's maps untouched")
    errs = [float((g - w)[~torch.isnan(w)].abs().max()) if bool(
        (~torch.isnan(w)).any()) else 0.0
        for g, w in ((got.costs, want.costs), (got.planes, want.planes))]
    return max(errs)


def k3_commit_times(data, state, x, y, draws, kw: dict, what: str,
                    card: str) -> dict:
    """K3's commit form's mean time (the maps' copies and the launch, CUDA
    events, warm) against the launch that writes the batch's rows plus the
    commit it replaced (``strong_composition.put_composition``, its fetch,
    where and scatter a map), the launch alone and the plain commit; the
    bound."""
    from apde_mvs_tpu_torch.ops.cuda import strong
    from apde_mvs_tpu_torch.ops.propagation import checkerboard_candidates
    from apde_mvs_tpu_torch.testing.strong_composition import put_composition

    def launch():
        return strong.strong_fused(data, state, x, y, draws, **kw)
    ms = cuda_ms(lambda: strong.strong_fused(data, state, x, y, draws,
                                             commit=True, **kw), 10)
    put_ms = cuda_ms(lambda: put_composition(state, 0, launch()), 10)
    launch_ms = cuda_ms(launch, 10)
    plain_ms = cuda_ms(lambda: strong.commit_maps_plain(
        state, x, y, strong.strong_plain(data, state, x, y, draws, **kw)),
        1, 1)
    _, _, flags = checkerboard_candidates(state.costs, x, y,
                                          kw["row_bounds"])
    bound, by, nbytes, ops = k3_bound(data, x, y, kw, flags, launch(),
                                      commit=True)
    log(f"  K3 commit {what}: {ms:.4f} ms (copies and launch), the launch "
        f"and the put composition {put_ms:.4f} ms, the launch alone {launch_ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                launch_put_ms=put_ms, launch_ms=launch_ms, library_ms=None)


def strong_mismatch(got, want):
    """Per-pixel disagreement of two colour updates' outputs: view weights
    or selections not equal, or a cost or a plane's component more than
    2e-5 apart (the JAX parity tests' rule, tests/test_torch_strong.py)."""
    import torch
    planes, costs, sel, vw = got
    bad = (vw != want.view_weights).any(-1) | (sel != want.selected).any(-1)
    bad |= ~torch.isclose(costs, want.costs, rtol=2e-5, atol=2e-5,
                          equal_nan=True)
    bad |= ~torch.isclose(planes, want.planes, rtol=2e-5, atol=2e-5,
                          equal_nan=True).all(-1)
    return bad


def k3_check(data, state, x, y, draws, kw: dict, what: str) -> float:
    """K3 against its plain version on the card: bitwise, every output.
    Returns the max abs difference read from the two (over non-NaN costs
    and planes)."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import strong
    got = strong.strong_fused(data, state, x, y, draws, **kw)
    want = strong.strong_plain(data, state, x, y, draws, **kw)
    torch.cuda.synchronize()
    bad = {}
    for name, g, w in zip(got._fields, got, want):
        same = g.shape == w.shape and torch.equal(
            g.view(torch.int32) if g.dtype == torch.float32 else g,
            w.view(torch.int32) if w.dtype == torch.float32 else w)
        if not same:
            bad[name] = int((g != w).reshape(g.shape[0], -1).any(-1).sum()) \
                if g.shape == w.shape else -1
    if bad:
        raise AssertionError(f"K3 {what}: pixels differing from the plain "
                             f"version by output {bad}")
    views = (want.view_weights > 0).sum(-1).float()
    old = state.planes[y.long(), x.long()]
    moved = ((want.planes != old)
             & ~(torch.isnan(want.planes) & torch.isnan(old))).any(-1)
    log(f"  K3 {what} ({x.numel()} pixels, {data.num_src} views): bitwise "
        f"equal to the plain version; {float(views.mean()):.2f} views "
        f"weighted a pixel, {float((views == 0).float().mean()):.4f} of the "
        f"pixels none; {float(moved.float().mean()):.3f} of the planes "
        "changed")
    errs = [float((g - w)[~torch.isnan(w)].abs().max()) if bool(
        (~torch.isnan(w)).any()) else 0.0
        for g, w in ((got.costs, want.costs), (got.planes, want.planes))]
    return max(errs)


def k3_times(data, state, x, y, draws, kw: dict, what: str,
             card: str) -> dict:
    """K3's, the plain version's and the composition's (the torch-op body
    it replaced, ``testing.strong_composition``, its window built as torch
    ops) mean times (CUDA events, warm), the composition held to K3 at the
    CPU tests' tolerance (view weights and selections exact, planes and
    costs to 2e-5, at most 0.5% of the pixels flipped on a float tie), and
    the bound."""
    import torch

    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops.cuda import strong
    from apde_mvs_tpu_torch.ops.propagation import PropCfg, \
        checkerboard_candidates
    from apde_mvs_tpu_torch.testing.strong_composition import \
        strong_composition
    dev = x.device
    scalars = [geo.f32_scalar(kw[k], dev)
               for k in ("depth_min", "depth_max", "geom_factor")]
    cfg = PropCfg(geom_consistency=kw["geom"], use_sa=kw["use_sa"],
                  refine_init=kw["refine_init"],
                  strong_radius=kw["radius"],
                  strong_increment=kw["increment"])

    def comp():
        return strong_composition(data, state, cfg, kw["iteration"], draws,
                                  x, y, *scalars, kw["row_bounds"])
    got = strong.strong_fused(data, state, x, y, draws, **kw)
    bad = strong_mismatch(comp(), got)
    torch.cuda.synchronize()
    share = float(bad.float().mean())
    log(f"  K3 {what} against the composition: {int(bad.sum())} of "
        f"{bad.numel()} pixels differ ({share:.5f}; at most 0.005)")
    if not share <= 0.005:
        raise AssertionError(f"K3 {what} disagrees with the composition")
    ms = cuda_ms(lambda: strong.strong_fused(data, state, x, y, draws, **kw),
                 10)
    plain_ms = cuda_ms(lambda: strong.strong_plain(data, state, x, y, draws,
                                                   **kw), 1, 1)
    comp_ms = cuda_ms(comp, 3, 1)
    _, _, flags = checkerboard_candidates(state.costs, x, y,
                                          kw["row_bounds"])
    bound, by, nbytes, ops = k3_bound(data, x, y, kw, flags, got)
    log(f"  K3 {what}: {ms:.4f} ms, plain {plain_ms:.4f} ms, composition "
        f"{comp_ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                composition_ms=comp_ms, composition_flipped=share,
                library_ms=None)


def k3_phase(scene, seed: int, device, card: str) -> dict:
    """K3, the strong sweep's colour update, against its plain version on
    the card, bitwise, at the shapes the main path gives it: the black
    colour of view 0 (240,000 pixels, all 10 sources) with u8 and f32
    tables, the geometric cost on and off, iterations 0 and 2, and
    REFINE_INIT's commit; an SA star window, and one where some segment
    ids are negative (no segment: the square); a tile-route rank's halo
    row block with its row bounds, square and SA; 1 and 32 source views,
    square and SA at 32; selection draws that
    weight one view or many; every plane NaN (no view weighted); a ragged
    batch and one pixel; then its times against the plain version and the
    composition it replaced, with the square and the SA star window. K3
    builds each pixel's window from the reference image and segment ids
    itself. The state: a REFINE_ITER pass's (near-truth planes, some 3%
    off; the top-k mean costs and views of K2's costs). Last, the division
    K3's taps take against __fdiv_rn (``div_phase``)."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch import config as cfg
    from apde_mvs_tpu_torch.core import checkerboard as cb
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops.cost import CostData
    from apde_mvs_tpu_torch.ops.cuda import strong
    from apde_mvs_tpu_torch.parallel.tiles import HALO_ROWS, halo_block
    from apde_mvs_tpu_torch.testing.kernel_cases import block_state, \
        cycled_views, strong_draws

    H, W = scene.images.shape[1:]
    S = scene.num_views - 1
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    sa = segment_masks(scene.depths[0], seed).to(device)
    src_depths = torch.as_tensor(np.stack(scene.depths[1:]), device=device)
    data = {u8: CostData.build(cams.view(0), cams.map(lambda a: a[1:]),
                               imgs[0], imgs[1:], src_depths=src_depths,
                               sampler_u8=u8, sa_mask=sa)
            for u8 in (True, False)}
    params = cfg.build_schedule(max(H, W))[1].params      # REFINE_ITER
    dmin = scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR
    dmax = scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR
    base, planes, costs = refine_iter_state(scene, data[True], params, seed,
                                            device)
    state = base.replace(planes=planes, costs=costs.contiguous())
    xs, ys = cb.color_coords(H, W, 0, device=device)
    x, y = xs.reshape(-1).contiguous(), ys.reshape(-1).contiguous()

    def kwargs(it, geom, refine_init=False, row_bounds=None, use_sa=False):
        return dict(radius=5, increment=2, use_sa=use_sa, iteration=it,
                    depth_min=dmin, depth_max=dmax,
                    geom_factor=params.geom_factor, geom=geom,
                    refine_init=refine_init, row_bounds=row_bounds)

    def draws(n, pattern="random"):
        return strong_draws(n, pattern, seed, device)

    log(f"K3 strong shape: {S} views x {x.numel()} pixels x 36 taps, 8 "
        "candidates, the current plane and 5 hypotheses in one launch, the "
        "window built in the kernel")
    errs, res = [], {}
    dr = draws(x.numel())
    for u8 in (True, False):
        for it, geom in ((2, True), (0, False)):
            errs.append(k3_check(
                data[u8], state, x, y, dr, kwargs(it, geom),
                f"black u8={u8}, iteration {it}"
                f"{', geometric' if geom else ''}"))
    errs.append(k3_check(data[True], state, x, y, dr,
                         kwargs(2, True, refine_init=True),
                         "black u8, geometric, REFINE_INIT"))
    for pattern in ("one", "spread"):
        errs.append(k3_check(data[True], state, x, y,
                             draws(x.numel(), pattern), kwargs(2, True),
                             f"black u8, geometric, selection {pattern}"))
    nan_state = state.replace(planes=torch.full_like(state.planes,
                                                     float("nan")))
    errs.append(k3_check(data[True], nan_state, x, y, dr, kwargs(2, True),
                         "black u8, every plane NaN"))
    res["strong"] = k3_times(data[True], state, x, y, dr, kwargs(2, True),
                             "black u8, geometric", card)
    # the SA star window on the segment masks, u8 and f32, timed on u8
    swin = strong.window_plain(data[True], x.float(), y.float(), 5, 2, True)
    star = int((swin.tap_w is not None) and (swin.wsum < 36).sum())
    if star == 0:
        raise AssertionError("no SA window was truncated")
    del swin
    for u8 in (True, False):
        errs.append(k3_check(data[u8], state, x, y, dr,
                             kwargs(2, True, use_sa=True),
                             f"SA star u8={u8}, geometric ({star} windows "
                             "cut)"))
    res["sa"] = k3_times(data[True], state, x, y, dr,
                         kwargs(2, True, use_sa=True),
                         "SA star u8, geometric", card)
    # negative segment ids: no segment, so the square window (ids > 0 take
    # the star), and their pixels leave their neighbours' segments
    neg = torch.where(sa % 2 == 1, -sa, sa)
    n_neg = int((neg[y.long(), x.long()] < 0).sum())
    if n_neg == 0:
        raise AssertionError("no pixel has a negative segment id")
    errs.append(k3_check(data[True].replace(sa_mask=neg), state, x, y, dr,
                         kwargs(2, True, use_sa=True),
                         f"SA u8, geometric, odd segment ids negative "
                         f"({n_neg} pixels)"))
    # one tile-route rank: rows 0 .. H / RANKS - 1 with their halo, the
    # halo rows above the image zero, the candidates held to the image rows
    block, row0, lo, hi = halo_block(data[True], 0, H // RANKS, HALO_ROWS)
    if not (block.quad_h > block.height and lo > 0):
        raise AssertionError("the row block has no halo table or bounds")
    bstate = block_state(state, row0, block.height)
    bxs, bys = cb.color_coords(block.height, W, 0, device=device)
    bx, by = bxs.reshape(-1).contiguous(), bys.reshape(-1).contiguous()
    for use_sa in (False, True):
        errs.append(k3_check(block, bstate, bx, by, draws(bx.numel()),
                             kwargs(2, True, row_bounds=(lo, hi),
                                    use_sa=use_sa),
                             f"row shard u8, geometric{', SA' * use_sa} "
                             f"(block {block.height} rows, tables "
                             f"{block.quad_h}, rows {lo}..{hi})"))
    res["shard"] = k3_times(block, bstate, bx, by, draws(bx.numel()),
                            kwargs(2, True, row_bounds=(lo, hi)),
                            "row shard u8, geometric", card)
    del block, bstate
    # 1 and 32 source views (the 10 cycled)
    d1 = data[True].replace(src_quads=data[True].src_quads[:1].contiguous(),
                            src_cams=data[True].src_cams.map(lambda a: a[:1]),
                            src_depths=src_depths[:1].contiguous(), num_src=1)
    errs.append(k3_check(d1, state.replace(
        selected=state.selected[..., :1].contiguous()), x, y, dr,
        kwargs(2, True), "black u8, geometric, 1 view"))
    d32, idx = cycled_views(data[True], 32)
    for use_sa in (False, True):
        errs.append(k3_check(d32, state.replace(
            selected=state.selected[..., idx].contiguous()), x, y, dr,
            kwargs(2, True, use_sa=use_sa),
            f"black u8, geometric{', SA' * use_sa}, 32 views (the 10 "
            "cycled)"))
    del d1, d32
    # a ragged batch and one pixel
    n = x.numel() - 17
    errs.append(k3_check(data[True], state, x[:n], y[:n], draws(n),
                         kwargs(2, True), "ragged batch u8, geometric"))
    errs.append(k3_check(data[True], state, x[:1], y[:1], draws(1),
                         kwargs(2, True), "one pixel u8, geometric"))
    # the commit form: the active pixels' outputs (not WEAK, valid) written
    # into copies of the maps; a fifth of the pixels WEAK, 3% invalid
    rng = np.random.default_rng(seed + 17)
    cstate = state.replace(
        weak=torch.as_tensor(np.where(rng.random((H, W)) < 0.2, 0, 1)
                             .astype(np.int32), device=device),
        valid=torch.as_tensor(rng.random((H, W)) < 0.97, device=device))
    for use_sa in (False, True):
        for u8 in (True, False):
            errs.append(k3_commit_check(
                data[u8], cstate, x, y, dr, kwargs(2, True, use_sa=use_sa),
                f"black u8={u8}, geometric{', SA' * use_sa}"))
    errs.append(k3_commit_check(data[True], cstate, x, y, dr,
                                kwargs(0, False, refine_init=True),
                                "black u8, REFINE_INIT"))
    res["commit"] = k3_commit_times(data[True], cstate, x, y, dr,
                                    kwargs(2, True), "black u8, geometric",
                                    card)
    res["commit_sa"] = k3_commit_times(data[True], cstate, x, y, dr,
                                       kwargs(2, True, use_sa=True),
                                       "black u8, geometric, SA", card)
    res["max_abs_err"] = max(errs)
    res["div"] = div_phase(seed, device, card)
    return res


def div_phase(seed: int, device, card: str, n: int = 1 << 27) -> dict:
    """The division K3's taps take where a pair's window lies in the fast
    range (``strong.div_check``: a refined reciprocal of tz shared by both
    quotients, no checks) against ``__fdiv_rn``, bit for bit, over ``n``
    (two numerators, one denominator) triples of each kind: in the ranges
    of a pass's warp (tz log-uniform in 1e-3 .. 1e3 of either sign, the
    quotient uniform in -2000 .. 2000), uniform over the fast range's
    exponents and mantissas, and random bit patterns (only their triples
    inside the fast range are compared); then every triple of the special
    values (NaN, +-inf, +-0, subnormals, the range's edges and their
    neighbours)."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch.ops.cuda import strong
    gen = torch.Generator(device=device).manual_seed(seed)
    total = bad = compared = 0
    chunk = 1 << 25

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=device)

    for kind in ("pass", "range", "bits"):
        for _ in range(max(1, n // chunk)):
            if kind == "pass":
                den = torch.pow(10.0, uniform(chunk) * 6 - 3)
                den = torch.where(uniform(chunk) < 0.5, -den, den)
                num = (uniform((chunk, 2)) - 0.5) * 4000 * den[:, None]
            elif kind == "range":
                v = torch.ldexp(1 + uniform((chunk, 3)), torch.randint(
                    -30, 30, (chunk, 3), generator=gen, device=device))
                v = torch.where(uniform((chunk, 3)) < 0.5, -v, v)
                num, den = v[:, :2], v[:, 2]
            else:
                bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (chunk, 3),
                                     generator=gen, device=device,
                                     dtype=torch.int64).to(torch.int32)
                num = bits[:, :2].contiguous().view(torch.float32)
                den = bits[:, 2].contiguous().view(torch.float32)
            b, c = strong.div_check(num.contiguous(), den.contiguous())
            total, bad, compared = total + chunk, bad + b, compared + c
    edges = [2.0 ** -30, 2.0 ** 30, 2.0 ** -126, 2.0 ** -149, 1.0, 3.0,
             float(np.finfo(np.float32).max), float("inf"), 0.0]
    vals = np.array(edges + [np.nextafter(np.float32(v), np.float32(0))
                             for v in edges[:2]]
                    + [np.nextafter(np.float32(v), np.float32(np.inf))
                       for v in edges[:2]], np.float32)
    vals = np.concatenate([vals, -vals, [np.nan]]).astype(np.float32)
    g = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1)
    g = torch.as_tensor(g.reshape(-1, 3), device=device)
    b, c = strong.div_check(g[:, :2].contiguous(), g[:, 2].contiguous())
    total, bad, compared = total + g.shape[0], bad + b, compared + c
    log(f"K3 division without checks against __fdiv_rn: {bad} of "
        f"{2 * compared} quotients differ ({compared} of {total} triples in "
        f"the fast range) [{card}]")
    if bad:
        raise AssertionError(f"K3's division differs from __fdiv_rn in {bad} "
                             "quotients")
    return dict(triples=total, compared=compared, differ=bad)


def weak_region(depth):
    """The scene's weak (nearly textureless) plane: nearer than 95% of the
    mean depth. It is segment 1 of the scan's SA masks."""
    return depth < depth.mean() * 0.95


def deformable_work(data, wref, planes, params, evaluated, geom: bool,
                    rows, texels) -> int:
    """The f32 operations K6's deformable NCC needs for the (pixel, plane,
    view) pairs ``evaluated`` (P, S, B) bool of ``planes`` (B, P, 4),
    counted on this data (every evaluated pair; the windows of the pairs
    whose centre stays in the image; the anchors each such pair tests,
    computes and counts; with ``geom`` K4's 115 a pair), without K4's 36 a
    (pixel, plane); marks in ``rows`` (S, width x quad_h) the quad-table
    rows those centre and anchor windows touch and, with ``geom``, in
    ``texels`` (S, dh x dw) the source depth texels its pairs read (the
    windows warped as the composition warps them, ``weak_taps``)."""
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.core.sampling import quad_coords, trunc_index
    from apde_mvs_tpu_torch.testing.weak_composition import weak_taps
    sel = wref.anchor_sel.permute(2, 0, 1)                      # (S, B, 8)
    dh, dw = data.src_depths.shape[-2:]
    pairs = live = tested = computed = counting = 0
    for c in range(planes.shape[1]):
        ev = evaluated[c]
        if not bool(ev.any()):
            continue
        plane = planes[:, c]
        tp = weak_taps(data, wref, plane, params)
        on = ev & ~tp.center_oob
        test = on[..., None] & wref.anchor_valid
        comp = test & ~tp.anchor_oob & (wref.wsum > 0)
        pairs += int(ev.sum())
        live += int(on.sum())
        tested += int(test.sum())
        computed += int(comp.sum())
        counting += int((comp | (test & tp.anchor_oob & sel)).sum())
        mark_rows(rows, quad_coords(data.width, data.quad_h, tp.cwx,
                                    tp.cwy)[0], on)
        mark_rows(rows, quad_coords(data.width, data.quad_h, tp.awx,
                                    tp.awy)[0], comp)
        del tp
        if geom:
            # cost.geom_cost's texel: the plane's point seen from view s
            xw = geo.backproject_world(data.ref_cam, wref.x, wref.y,
                                       geo.depth_from_plane(
                                           data.ref_cam, plane, wref.x,
                                           wref.y))
            sx, sy, _ = geo.project(data.src_views, xw)
            mark_rows(texels, trunc_index(sy, dh) * dw + trunc_index(sx, dw),
                      ev)
    per_tap = K2_OPS_PER_TAP + (2 if wref.tap_w is not None else 0)
    t = wref.center_win.tap_val.shape[1]
    ta = wref.tap_val.shape[2]
    return pairs * (K6_OPS_PER_PAIR + (K5_GEOM_OPS_PER_PAIR if geom else 0)) \
        + live * (K6_OPS_PER_LIVE_PAIR + t * per_tap) \
        + tested * K6_OPS_PER_TESTED_ANCHOR \
        + computed * (K6_OPS_PER_ANCHOR_WINDOW + ta * per_tap) \
        + counting * K6_OPS_PER_COUNTING_ANCHOR


def k6_bound(data, wref, planes, params, vw, geom: bool) -> tuple:
    """The least time the card could take for one K6 call: its f32
    operations over the plain-f32 rate, counted on this call's data
    (``deformable_work``: the evaluated pairs, every view or the weighted
    ones), against the bytes of its inputs and outputs over the memory
    rate: the reference side, planes and weights read once, and of the quad
    tables the rows that those centre and anchor windows touch, with the
    geometric cost of the source depth maps the texels its pairs read, each
    once. Returns (ms, "bytes" or "operations", bytes, operations)."""
    import torch
    b, p = planes.shape[:2]
    s = data.num_src
    dev = planes.device
    evaluated = torch.ones((s, b), dtype=torch.bool, device=dev) \
        if vw is None else (vw > 0).T
    rows = torch.zeros((s, data.width * data.quad_h), dtype=torch.bool,
                       device=dev)
    dh, dw = data.src_depths.shape[-2:]
    texels = torch.zeros((s, dh * dw), dtype=torch.bool, device=dev)
    ops = deformable_work(data, wref, planes, params,
                          evaluated.expand(p, s, b), geom, rows, texels) \
        + (b * p * K5_GEOM_OPS_PER_PIXEL if geom else 0)
    weighted = wref.tap_w is not None
    t = wref.center_win.tap_val.shape[1]
    ta = wref.tap_val.shape[2]
    w = 2 if weighted else 1
    per_pixel = 4 * (2 + w * t + 3 + 8 * (2 + w * ta + 3)) + 8 + 8 * s
    nbytes = b * (per_pixel + 16 * p + (4 * s if vw is not None else 0)) \
        + 4 * b * p * s * (2 if geom else 1) + 8 * (t + ta) \
        + int(rows.sum()) * 4 * data.src_quads.element_size() \
        + (s + 1) * 40 * 4 + (4 * int(texels.sum()) if geom else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def k6_check(data, wref, planes, radius: int, increment: int, geom: bool,
             vw, what: str) -> float:
    """K6 against its plain version on the card: bitwise, both outputs.
    Returns the max abs difference read from the two (over non-NaN
    costs)."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import weak
    got = weak.weak_fused(data, wref, planes, radius, increment, geom=geom,
                          view_weights=vw)
    want = weak.weak_plain(data, wref, planes, radius, increment, geom=geom,
                           view_weights=vw)
    torch.cuda.synchronize()
    for name, g, w in (("costs", got.ncc, want.ncc),
                       ("geometric costs", got.geom, want.geom)):
        if (g is None) != (w is None) or (g is not None
                                          and not bitwise(g, w)):
            bad = int((g != w).sum()) if g is not None and w is not None \
                and g.shape == w.shape else -1
            raise AssertionError(f"K6 {what}: {bad} {name} differ from the "
                                 "plain version")
    c = want.ncc
    at_max = float((c == 2.0).float().mean())
    log(f"  K6 {what} {tuple(c.shape)}: bitwise equal to the plain version"
        f"{' (both outputs)' if geom else ''}; {at_max:.4f} of the costs at "
        "COST_MAX")
    ok = ~torch.isnan(c)
    return float((got.ncc[ok] - c[ok]).abs().max()) if bool(ok.any()) \
        else 0.0


def float64_copy(data, wref):
    """``data`` and ``wref`` with every float32 tensor in float64 (the
    quad tables keep their texels: the plain sample promotes them): K6's
    plain version run on them takes each operation in float64, a referee
    for the float32 orders of K6 and of the composition."""
    import torch

    def dbl(v):
        return v.double() if isinstance(v, torch.Tensor) \
            and v.dtype == torch.float32 else v
    cw = wref.center_win
    return (data.replace(ref_cam=data.ref_cam.map(dbl),
                         src_cams=data.src_cams.map(dbl),
                         ref_image=dbl(data.ref_image),
                         src_depths=dbl(data.src_depths)),
            wref._replace(center_win=type(cw)(*map(dbl, cw)),
                          **{f: dbl(getattr(wref, f)) for f in wref._fields
                             if f != "center_win"}))


def k6_against_composition(data, wref, planes, params, geom: bool, vw,
                           what: str) -> float:
    """K6 against the torch-op composition it replaced
    (``testing.weak_composition``; every view, so only the views K6
    evaluates are compared), the geometric costs equal, and both against
    the plain version taken in float64 (``float64_copy``): K6 must be no
    farther from it, on average, than the composition. On these 600x800
    windows a source variance can sit at float32's resolution at its mean,
    so the cost is noise of either order of the sums at the CPU tests'
    1e-4 (and crosses MIN_VAR to COST_MAX either way); the float64 plain
    version says which order is nearer the function. Returns the share of
    the costs more than 1e-2 from the composition."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import weak
    from apde_mvs_tpu_torch.testing.weak_composition import weak_composition
    r, inc = params.weak_radius, params.weak_increment
    got = weak.weak_fused(data, wref, planes, r, inc, geom=geom,
                          view_weights=vw)
    want, gwant = weak_composition(data, wref, planes, params, geom=geom)
    torch.cuda.synchronize()
    keep = torch.ones_like(got.ncc, dtype=torch.bool) if vw is None \
        else (vw > 0)[:, None].expand_as(got.ncc)
    diff = (got.ncc - want).abs()[keep]
    far = float((diff > 1e-2).float().mean())
    log(f"  K6 {what} against the composition: median abs "
        f"{float(diff.median()):.3g}, 99th percentile "
        f"{float(diff.quantile(0.99)):.3g}, max {float(diff.max()):.3g}; "
        f"{float((diff > 1e-4).float().mean()):.4f} of {diff.numel()} costs "
        f"beyond 1e-4, {far:.5f} beyond 1e-2")
    d64, w64 = float64_copy(data, wref)
    ref = weak.weak_plain(d64, w64, planes.double(), r, inc, geom=False,
                          view_weights=vw).ncc[keep]
    errs = [(v[keep].double() - ref).abs() for v in (got.ncc, want)]
    log(f"  K6 {what} against the plain version in float64: mean abs "
        f"{float(errs[0].mean()):.4g} (the composition "
        f"{float(errs[1].mean()):.4g}), 99th percentile "
        f"{float(errs[0].quantile(0.99)):.4g} "
        f"({float(errs[1].quantile(0.99)):.4g}), max "
        f"{float(errs[0].max()):.4g} ({float(errs[1].max()):.4g}), beyond "
        f"1e-4 {float((errs[0] > 1e-4).float().mean()):.5f} "
        f"({float((errs[1] > 1e-4).float().mean()):.5f}), beyond 1e-2 "
        f"{float((errs[0] > 1e-2).float().mean()):.5f} "
        f"({float((errs[1] > 1e-2).float().mean()):.5f})")
    if bool(torch.isnan(diff).any()) \
            or (geom and not torch.equal(got.geom[keep], gwant[keep])) \
            or not float(errs[0].mean()) <= float(errs[1].mean()):
        raise AssertionError(f"K6 {what} disagrees with the composition")
    return far


def k6_times(data, wref, planes, params, geom: bool, vw, what: str,
             card: str) -> dict:
    """K6's, the plain version's and the composition's mean times (CUDA
    events, warm; the composition it replaced, ``testing.weak_composition``:
    two K1 launches and ~575 torch ops a plane, the torch-op geometric cost
    a plane, every view), the agreement with the composition
    (``k6_against_composition``, the weak plane's windows), and the
    bound."""
    from apde_mvs_tpu_torch.ops.cuda import weak
    from apde_mvs_tpu_torch.testing.weak_composition import weak_composition
    r, inc = params.weak_radius, params.weak_increment
    far = k6_against_composition(data, wref, planes, params, geom, vw, what)
    ms = cuda_ms(lambda: weak.weak_fused(data, wref, planes, r, inc,
                                         geom=geom, view_weights=vw), 20)
    plain_ms = cuda_ms(lambda: weak.weak_plain(
        data, wref, planes, r, inc, geom=geom, view_weights=vw), 2, 1)
    comp_ms = cuda_ms(lambda: weak_composition(data, wref, planes, params,
                                               geom=geom), 3, 1)
    bound, by, nbytes, ops = k6_bound(data, wref, planes, params, vw, geom)
    log(f"  K6 {what}: {ms:.4f} ms, plain {plain_ms:.4f} ms, composition "
        f"{comp_ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                composition_ms=comp_ms, composition_far=far,
                library_ms=None)


def k7_kwargs(wc, sa: bool, geom: bool, refine_init: bool) -> dict:
    """``weak_sweep.weak_update_fused``'s keywords for the weak chunk ``wc``
    (``tools.kernel_times.weak_chunk``) in one pass form."""
    cfg = wc.cfg
    return dict(strong_radius=cfg.strong_radius,
                strong_increment=cfg.strong_increment,
                weak_radius=cfg.weak_radius,
                weak_increment=cfg.weak_increment, use_sa=sa,
                iteration=wc.iteration, depth_min=wc.depth_min,
                depth_max=wc.depth_max, geom_factor=wc.geom_factor,
                geom=geom, refine_init=refine_init)


def k7_bound(data, state, x, y, anchors, fit, draws, kw: dict) -> tuple:
    """The least time the card could take for one K7 call: its f32
    operations over the plain-f32 rate, counted on this call's data (the
    pairs of both phases as ``deformable_work`` counts them, with the
    hypotheses the plain version's ``weak_stage_plain`` gives; the
    selection, the weighted sums, the per-pixel steps and the reference
    side), against the bytes of its inputs and outputs over the memory
    rate: the pixels, anchors, fit planes and draws, the state at the
    distinct cells the pixels and their anchors read, the reference image
    (and segment ids) at the distinct window taps, the quad-table rows and
    depth texels the evaluated pairs read, each once, and the four outputs.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    import torch

    from apde_mvs_tpu_torch.ops.cost import square_taps
    from apde_mvs_tpu_torch.ops.cuda import weak_sweep
    from apde_mvs_tpu_torch.ops.propagation import PropCfg
    b, s = x.numel(), data.num_src
    dev = x.device
    geom = kw["geom"]
    st = weak_sweep.weak_stage_plain(
        data, state, x, y, anchors, fit, draws,
        **{k: v for k, v in kw.items() if k != "refine_init"})
    params = PropCfg(weak_radius=kw["weak_radius"],
                     weak_increment=kw["weak_increment"])
    rows = torch.zeros((s, data.width * data.quad_h), dtype=torch.bool,
                       device=dev)
    dh, dw = data.src_depths.shape[-2:]
    texels = torch.zeros((s, dh * dw), dtype=torch.bool, device=dev)
    every = torch.ones((s, b), dtype=torch.bool, device=dev)
    slots = torch.cat([st.flags, torch.ones_like(st.fit_ok)[:, None],
                       st.fit_ok[:, None]], 1).T[:, None] & every  # (10,S,B)
    planes0 = torch.cat([torch.zeros((b, 8, 4), device=dev),
                         st.cur_plane[:, None], fit[:, None]], 1)
    cand = anchors[:, 1:].clamp(min=0).long()
    planes0[:, :8] = state.planes[cand[..., 1], cand[..., 0]]
    weighted = (st.vw > 0).T & st.fit_ok                        # (S, B)
    ops = deformable_work(data, st.wref, planes0, params, slots, geom, rows,
                          texels) \
        + deformable_work(data, st.wref, st.hypotheses, params,
                          weighted.expand(5, s, b), geom, rows, texels)
    if geom:
        ops += K5_GEOM_OPS_PER_PIXEL * (int(slots.any(1).sum())
                                        + 5 * int(weighted.any(0).sum()))
    t = len(square_taps(kw["strong_radius"], kw["strong_increment"]))
    ta = len(square_taps(kw["weak_radius"], kw["weak_increment"]))
    ops += b * (s * K7_SELECT_OPS_PER_VIEW + K7_OPS_PER_PIXEL
                + (t + 8 * ta) * K7_OPS_PER_REF_TAP) \
        + int((st.vw > 0).sum()) * K7_OPS_PER_WEIGHTED_PAIR
    # the state's cells and the reference taps read, each once
    w = data.width
    cells = torch.cat([y.long() * w + x.long(),
                       (cand[..., 1] * w + cand[..., 0]).reshape(-1)])
    n_cells = int(torch.unique(cells).numel())
    sa = kw["use_sa"] and data.sa_mask is not None
    taps = []
    for (r, inc), cx, cy in (
            ((kw["strong_radius"], kw["strong_increment"]), x[:, None],
             y[:, None]),
            ((kw["weak_radius"], kw["weak_increment"]), cand[..., 0, None],
             cand[..., 1, None])):
        off = torch.as_tensor(square_taps(r, inc), device=dev)
        tx = (cx + off[:, 0]).clamp(0, w - 1)
        ty = (cy + off[:, 1]).clamp(0, data.height - 1)
        taps.append((ty.long() * w + tx.long()).reshape(-1))
    n_taps = int(torch.unique(torch.cat(taps)).numel())
    nbytes = b * (8 + 72 + 16 + 4 * (15 + 8) + 16 + 4 + 5 * s) \
        + n_cells * (16 + 4 + s) + n_taps * 4 * (2 if sa else 1) \
        + int(rows.sum()) * 4 * data.src_quads.element_size() \
        + (s + 1) * 40 * 4 + (4 * int(texels.sum()) if geom else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def k7_check(data, state, x, y, anchors, fit, draws, kw: dict,
             what: str) -> float:
    """K7 against its plain version on the card: bitwise, every output.
    Returns the max abs difference read from the two (over non-NaN costs
    and planes)."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import weak_sweep
    got = weak_sweep.weak_update_fused(data, state, x, y, anchors, fit,
                                       draws, **kw)
    want = weak_sweep.weak_update_plain(data, state, x, y, anchors, fit,
                                        draws, **kw)
    torch.cuda.synchronize()
    bad = {}
    for name, g, w in zip(got._fields, got, want):
        same = g.shape == w.shape and torch.equal(
            g.view(torch.int32) if g.dtype == torch.float32 else g,
            w.view(torch.int32) if w.dtype == torch.float32 else w)
        if not same:
            bad[name] = int((g != w).reshape(g.shape[0], -1).any(-1).sum()) \
                if g.shape == w.shape else -1
    if bad:
        raise AssertionError(f"K7 {what}: pixels differing from the plain "
                             f"version by output {bad}")
    views = (want.view_weights > 0).sum(-1).float()
    old = state.planes[y.long(), x.long()]
    moved = ((want.planes != old)
             & ~(torch.isnan(want.planes) & torch.isnan(old))).any(-1)
    log(f"  K7 {what} ({x.numel()} pixels, {data.num_src} views): bitwise "
        f"equal to the plain version; {float(views.mean()):.2f} views "
        f"weighted a pixel, {float((views == 0).float().mean()):.4f} of the "
        f"pixels none; {float(moved.float().mean()):.3f} of the planes "
        "changed")
    errs = [float((g - w)[~torch.isnan(w)].abs().max()) if bool(
        (~torch.isnan(w)).any()) else 0.0
        for g, w in ((got.costs, want.costs), (got.planes, want.planes))]
    return max(errs)


def k7_times(wc, data, kw: dict, what: str, card: str) -> dict:
    """K7's, the plain version's and the composition's (the body it
    replaced, ``testing.weak_composition.weak_body_composition``: two K6
    launches and ~250 torch ops) mean times a chunk (CUDA events, warm);
    as a diagnostic, not a gate, the share of the pixels where K7 and the
    composition differ (view weights or selections, or a cost or plane
    more than 2e-5 apart: on these flat u8 windows the float32 NCC is noise
    of either order of the sums, ROADMAP Queue 3); and the bound."""
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops.cuda import weak_sweep
    from apde_mvs_tpu_torch.testing.weak_composition import \
        weak_body_composition
    args = (data, wc.state, wc.x, wc.y, wc.anchors, wc.fit, wc.draws)
    cfg = wc.cfg._replace(use_sa=kw["use_sa"], geom_consistency=kw["geom"],
                          refine_init=kw["refine_init"])
    scalars = [geo.f32_scalar(kw[k], wc.x.device)
               for k in ("depth_min", "depth_max", "geom_factor")]

    def comp():
        return weak_body_composition(data, wc.state, cfg, kw["iteration"],
                                     wc.draws, wc.x, wc.y, wc.anchors,
                                     wc.fit, *scalars)
    got = weak_sweep.weak_update_fused(*args, **kw)
    bad = strong_mismatch(comp(), got)
    share = float(bad.float().mean())
    log(f"  K7 {what} against the composition (a diagnostic): "
        f"{int(bad.sum())} of {bad.numel()} pixels differ ({share:.5f})")
    ms = cuda_ms(lambda: weak_sweep.weak_update_fused(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: weak_sweep.weak_update_plain(*args, **kw), 2,
                       1)
    comp_ms = cuda_ms(comp, 5, 1)
    bound, by, nbytes, ops = k7_bound(*args, kw)
    log(f"  K7 {what}: {ms:.4f} ms a chunk, plain {plain_ms:.4f} ms, "
        f"composition {comp_ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                composition_ms=comp_ms, composition_differ=share,
                library_ms=None)


def weak_sweep_phase(scene, wc, real, seed: int, device, card: str) -> dict:
    """K7, the weak sweep's chunk update, against its plain version on the
    card, bitwise (planes, costs, selections, view weights), on the APD
    scan's weak chunk (``tools.kernel_times.weak_chunk``: 22,034 reliable
    weak pixels, 5 views, anchors and fit planes made on the card): in
    REFINE_INIT (no geometric cost, the 0.1 commit) and in a geometric
    REFINE_ITER pass, each with SA and square windows (every valid anchor
    counting), with u8 and f32 tables; selection draws that weight one
    view or many; the current planes NaN; 1 and 32 source views; a ragged
    batch and one pixel; and on the first chunk a real APD pass hands K7
    (``real``: ``tools.kernel_times.real_pass_chunks``) in both pass forms;
    then its times a chunk against the plain version and the composition it
    replaced in both pass forms, with the share of the pixels where the
    composition differs printed beside them, and against the plain version
    with square windows and on the real pass's chunk. ``wc`` is the
    chunk."""
    import torch

    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops.cost import CostData
    from apde_mvs_tpu_torch.ops.propagation import RefineRaws, SweepDraws
    from apde_mvs_tpu_torch.testing.kernel_cases import cycled_views, \
        strong_draws

    b = wc.x.numel()
    S = wc.data.num_src
    log(f"K7 on the weak chunk: {b} pixels, {S} views, 10 plane slots and "
        "5 hypotheses a pixel in one launch, the reference side built in "
        "the kernel")
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    f32 = CostData.build(cams.view(0), cams.map(lambda a: a[1:]), imgs[0],
                         imgs[1:], src_depths=wc.data.src_depths,
                         sampler_u8=False, sa_mask=wc.data.sa_mask)
    errs, out = [], {}

    def check(what, data=None, state=None, sl=slice(None), draws=None,
              **form):
        kw = k7_kwargs(wc, **form)
        d = draws or wc.draws
        if sl != slice(None):
            d = SweepDraws(d.sel_u[sl].contiguous(), RefineRaws(
                *(r[sl].contiguous() for r in d.raws)))
        tag = (f"{'SA' if form['sa'] else 'square'}, "
               f"{'REFINE_INIT' if form['refine_init'] else 'REFINE_ITER'}"
               f"{', geometric' if form['geom'] else ''}")
        errs.append(k7_check(data or wc.data, state or wc.state,
                             wc.x[sl].contiguous(), wc.y[sl].contiguous(),
                             wc.anchors[sl].contiguous(),
                             wc.fit[sl].contiguous(), d, kw,
                             f"{what} ({tag})"))
    forms = [dict(sa=sa, geom=not ri, refine_init=ri)
             for ri in (True, False) for sa in (True, False)]
    for form in forms:
        check("u8", **form)
        check("f32", data=f32, **form)
    for pattern in ("one", "spread"):
        check(f"u8, selection {pattern}",
              draws=strong_draws(b, pattern, seed, device), **forms[2])
    nan_state = wc.state.replace(planes=torch.full_like(wc.state.planes,
                                                        float("nan")))
    check("u8, every plane NaN", state=nan_state, **forms[2])
    for n_views in (1, 32):
        data_n, idx = cycled_views(wc.data, n_views)
        state_n = wc.state.replace(
            selected=wc.state.selected[..., idx].contiguous())
        for form in (forms[0], forms[3]):
            check(f"u8, {n_views} views (the {S} cycled)", data=data_n,
                  state=state_n, sl=slice(0, 4096), **form)
    for sl, what in ((slice(0, 1001), "a ragged batch of 1001 pixels"),
                     (slice(b // 2, b // 2 + 1), "one pixel")):
        check(f"u8, {what}", sl=sl, **forms[2])
    a, kw_real = real.k7
    for form in (dict(geom=False, refine_init=True),
                 dict(geom=True, refine_init=False)):
        tag = "REFINE_INIT" if form["refine_init"] \
            else "REFINE_ITER, geometric"
        errs.append(k7_check(*a, dict(kw_real, **form),
                             f"a real APD pass's first chunk (SA, {tag})"))
    out["max_abs_err"] = max(errs)
    for key, form, what in (("refine_init", forms[0], "SA, REFINE_INIT"),
                            ("refine_iter", forms[2],
                             "SA, REFINE_ITER, geometric")):
        out[key] = k7_times(wc, wc.data, k7_kwargs(wc, **form),
                            f"u8, {what}", card)
    for key, args, kw, what in (
            ("square", (wc.data, wc.state, wc.x, wc.y, wc.anchors, wc.fit,
                        wc.draws), k7_kwargs(wc, **forms[3]),
             "square windows, REFINE_ITER, geometric"),
            ("real_pass", a, dict(kw_real, geom=True, refine_init=False),
             "a real APD pass's first chunk, SA, REFINE_ITER, geometric")):
        out[key] = k7_plain_times(args, kw, f"u8, {what}", card)
    return out


def measured(ms: float, what: str) -> float:
    """``ms``, a device time the profiler took; a NaN (no kernel record
    caught: not measured) fails the run."""
    if ms != ms:
        raise AssertionError(f"{what}: not measured (the profiler caught "
                             "no kernel record)")
    return ms


def k7_plain_times(args, kw: dict, what: str, card: str) -> dict:
    """K7's and its plain version's mean times a chunk (CUDA events, warm)
    on the chunk ``args``, K7's device time (profiler) and the bound."""
    from apde_mvs_tpu_torch.ops.cuda import weak_sweep
    from apde_mvs_tpu_torch.tools.kernel_times import device_ms

    def run():
        return weak_sweep.weak_update_fused(*args, **kw)
    ms = cuda_ms(run, 20)
    dev_ms = measured(device_ms(run, 20, "weak_update_kernel"),
                      f"K7's device time, {what}")
    plain_ms = cuda_ms(lambda: weak_sweep.weak_update_plain(*args, **kw), 2,
                       1)
    bound, by, nbytes, ops = k7_bound(*args, kw)
    log(f"  K7 {what} ({args[2].numel()} pixels): {ms:.4f} ms a chunk "
        f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
        f"GFLOP) [{card}]")
    return dict(ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, pixels=args[2].numel())


def weak_kernel_phase(scene, wc, seed: int, device, card: str,
                      textured) -> dict:
    """K1 at the deformable NCC's two old call sites, and K6 against its
    plain version, on one weak-sweep chunk ``wc`` of the APD scan's round 1
    (``tools.kernel_times.weak_chunk``: the weak plane's reliable pixels,
    anchors and fit planes generated on the card, the ground-truth state,
    REFINE_ITER's SA windows and geometric cost). K1 samples the centre
    and anchor windows of each pixel's current plane (the composition's
    ``weak_taps``). K6 bitwise at the chunk's 10 candidate planes (u8 and
    f32 tables, SA weights on and off, the geometric cost on and off), its
    5 probes with the chunk's view weights and with the patterns of
    ``kernel_cases`` (none, one, all, random), one plane (the initial cost's
    re-score), planes with NaN, w = 0 and the zero fit plane, 1 and 32
    source views, a ragged batch and one pixel; K6 against the composition
    it replaced (``k6_against_composition``) on the same kind of chunk of
    the ``textured`` scene (the APD scene's cameras with a textured
    foreground plane where its weak plane was), and then on the weak
    plane's windows together with its times against the plain version and
    the composition at the candidates, the probes, the re-score and with
    square windows."""
    import torch

    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops.cost import CostData
    from apde_mvs_tpu_torch.ops.cuda import sampler
    from apde_mvs_tpu_torch.ops.deformable import WeakRefData, \
        contiguous_ref
    from apde_mvs_tpu_torch.testing.kernel_cases import (VIEW_PATTERNS,
                                                         cycled_views,
                                                         weak_planes,
                                                         weak_view_weights)
    from apde_mvs_tpu_torch.testing.weak_composition import weak_taps
    from apde_mvs_tpu_torch.tools.kernel_times import weak_chunk

    H, W = scene.images.shape[1:]
    x, y = wc.x.float(), wc.y.float()
    b = x.numel()
    S = wc.data.num_src
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    datas = {True: wc.data, False: CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]), imgs[0], imgs[1:],
        src_depths=wc.data.src_depths, sampler_u8=False,
        sa_mask=wc.data.sa_mask)}
    refs = {(u8, sa): contiguous_ref(WeakRefData.build(
        datas[u8], x, y, wc.anchors, wc.state.selected,
        wc.cfg._replace(use_sa=sa)))
        for u8 in (True, False) for sa in (True, False)}
    r, inc = wc.cfg.weak_radius, wc.cfg.weak_increment
    current = wc.candidates[:, 8:9].contiguous()

    # K1 at its two old weak sites: the current planes' windows
    taps = weak_taps(datas[True], refs[(True, True)], current[:, 0], wc.cfg)
    out = {}
    for site, (sx, sy) in (("weak_centre", (taps.cwx, taps.cwy)),
                           ("weak_anchor", (taps.awx, taps.awy))):
        log(f"K1 at {site}: {tuple(sx.shape)} samples per launch")
        errs = []
        res = {}
        for u8 in (True, False):
            q = datas[u8].src_quads
            tag = "u8" if u8 else "f32"
            errs.append(compare(sampler.sample_packed(q, W, H, sx, sy),
                                sampler.sample_packed_plain(q, W, H, sx, sy),
                                f"{site} {tag}", tol=0.0))
            res[tag] = time_packed(q, W, H, sx, sy, f"{site} {tag}", card)
        res["u8"]["library_ms"] = grid_sample_ms(datas[True].src_quads, W,
                                                 H, sx, sy, card)
        if site == "weak_centre":
            # K1a: the fixed cost of a launch of K1's grid at this size
            total = sx.numel()
            res["u8"]["empty_launch_ms"] = cuda_ms(
                lambda: sampler.launch_empty(total, device), 20)
            log(f"  {site}: an empty launch of K1's grid "
                f"({(total + 255) // 256} blocks of 256) takes "
                f"{res['u8']['empty_launch_ms']:.4f} ms, K1 "
                f"{res['u8']['ms']:.4f} ms, bound "
                f"{res['u8']['bound_ms']:.4f} ms [{card}]")
        res["max_abs_err"] = max(errs)
        res["shape"] = tuple(sx.shape)
        out[site] = res
    del taps

    # K6 bitwise against its plain version
    log(f"K6 on the weak chunk: {b} pixels, {S} views")
    errs = []

    def check(u8, sa, geom, planes, vw, what, ref=None, data=None):
        tag = (f"{'u8' if u8 else 'f32'}, {'SA' if sa else 'square'}"
               f"{', geometric' if geom else ''}")
        errs.append(k6_check(data or datas[u8], ref or refs[(u8, sa)],
                             planes, r, inc, geom, vw, f"{what} ({tag})"))
    for u8 in (True, False):
        for sa in (True, False):
            for geom in (True, False):
                check(u8, sa, geom, wc.candidates, None, "10 candidates")
    check(True, True, True, wc.probes, wc.vw, "5 probes, the chunk's "
          "view weights")
    check(False, False, False, wc.probes, wc.vw, "5 probes, the chunk's "
          "view weights")
    for pattern in VIEW_PATTERNS:
        check(True, True, True, wc.probes,
              weak_view_weights(b, S, pattern, seed, device),
              f"5 probes, view weights {pattern}")
    check(True, True, False, current, None, "1 plane (re-score)")
    depth = torch.as_tensor(scene.depths[0], device=device)[
        wc.y.long(), wc.x.long()]
    normal = geo.normal_world_to_cam(cams.view(0).R, torch.cat(
        [torch.as_tensor(scene.normals[0], device=device)[
            wc.y.long(), wc.x.long()], torch.zeros_like(x)[:, None]],
        -1))[:, :3]
    odd = weak_planes(cams.view(0), x, y, depth, normal, 10, seed)
    check(True, True, True, odd, None, "10 planes with NaN, w = 0 and the "
          "zero plane")
    check(True, False, True, odd, None, "10 planes with NaN, w = 0 and the "
          "zero plane")

    def part(ref, sl):
        """The rows ``sl`` of a WeakRefData; the shared offsets whole."""
        def cut(v):
            return v[sl].contiguous() if isinstance(v, torch.Tensor) else v
        cw = ref.center_win
        return ref._replace(
            center_win=cw._replace(**{f: cut(getattr(cw, f)) for f in (
                "tap_val", "sum_ref", "sum_rr", "wsum", "tap_w")}),
            **{f: cut(getattr(ref, f)) for f in ref._fields
               if f != "center_win"})
    few = slice(0, 4096)
    for n_views in (1, 32):
        data_n, idx = cycled_views(datas[True], n_views)
        ref_n = part(refs[(True, True)], few)
        ref_n = ref_n._replace(
            anchor_sel=ref_n.anchor_sel[..., idx].contiguous())
        check(True, True, True, wc.candidates[few].contiguous(), None,
              f"10 candidates of {ref_n.x.numel()} pixels, {n_views} views",
              ref=ref_n, data=data_n)
    for sl, what in ((slice(0, 1001), "a ragged batch of 1001 pixels"),
                     (slice(b // 2, b // 2 + 1), "one pixel")):
        check(True, True, True, wc.candidates[sl].contiguous(), None,
              f"10 candidates, {what}", ref=part(refs[(True, True)], sl))
        check(True, True, True, wc.probes[sl].contiguous(),
              wc.vw[sl].contiguous(), f"5 probes, {what}",
              ref=part(refs[(True, True)], sl))
    out["k6_max_abs_err"] = max(errs)
    tc = weak_chunk(textured, device, seed)
    log(f"K6 against the composition on a chunk of {tc.x.numel()} textured "
        f"pixels (a foreground plane at the APD scene's focal length), "
        f"{tc.data.num_src} views")
    if tc.x.numel() == 0:
        raise AssertionError("the textured scene has no weak chunk")
    for sa in (True, False):
        cfg = tc.cfg._replace(use_sa=sa)
        ref = contiguous_ref(WeakRefData.build(
            tc.data, tc.x.float(), tc.y.float(), tc.anchors,
            tc.state.selected, cfg))
        tag = "SA" if sa else "square"
        for planes, vw, what in ((tc.candidates, None, "10 candidates"),
                                 (tc.probes, tc.vw, "5 probes")):
            k6_against_composition(tc.data, ref, planes, cfg, True, vw,
                                   f"{what}, textured (u8, {tag})")
    del tc
    # the APD scan's windows are SA's (its weak plane is one segment, so
    # no anchor outside it counts); without a segment mask every valid
    # anchor does: timed too, as "candidates_square"
    for key, planes, vw, geom, sa, what in (
            ("candidates", wc.candidates, None, True, True, "10 candidates"),
            ("probes", wc.probes, wc.vw, True, True, "5 probes"),
            ("rescore", current, None, False, True, "1 plane (re-score)"),
            ("candidates_square", wc.candidates, None, True, False,
             "10 candidates")):
        out[key] = k6_times(datas[True], refs[(True, sa)], planes,
                            wc.cfg._replace(use_sa=sa), geom, vw,
                            f"{what} (u8, {'SA' if sa else 'square'})", card)
    return out


# operations of the APD setup's kernels as the functions need them, counted
# on the call's data. K10, a pixel a (step, neighbour) sub-pass: the
# neighbour's coordinates (2) and bounds test (4), the acceptance (2), the
# two squared distances (10), the choice (2).
K10_OPS_PER_PIXEL_PASS = 20
# K8: a probe walked (up to its direction's first accepted one, or every
# probe whose test point is in the image): the offset (4), its length (5),
# the position (8), the test point (4), 8 bounds tests, the snap's 2
# tests, the cone (12); per RANSAC iteration of a pixel with >= 6 hits (no
# fewer can be usable) 80 (the triangle test 44, the plane 30, the
# centre's distance 6) and 9 a hit (its distance 7, the division and
# test); a hit 16 (back-projection 6, the final distance, division, test
# and boost 10) and 2 a direction for its rank.
K8_OPS_PER_PROBE = 43
K8_OPS_PER_ITERATION = 80
K8_OPS_PER_ITERATION_HIT = 9
K8_OPS_PER_HIT = 16
# K9: an anchor 18 (depth from its plane 12, back-projection 6); per
# iteration of a pixel with >= 3 anchors 74 (the triangle test 44, the
# plane 30) and 9 an anchor (its distance 7, the selection, the sum); a
# pixel 30 (its depth and back-projection 18, the float64 length's 6
# operations counted twice, the flip's dot 5 minus one).
K9_OPS_PER_ANCHOR = 18
K9_OPS_PER_ITERATION = 74
K9_OPS_PER_ITERATION_ANCHOR = 9
K9_OPS_PER_PIXEL = 30
ANCHOR_ROTATE_TIMES = (1, 2, 4)
# the real scan's weak share a weak set of the map stands for (PERF.md §7)
WEAK_SHARE = 0.15


def apd_setup(scene, device):
    """The APD scan's round-1 setup at full size (view 0): the weak plane
    WEAK (confidence 40) in a STRONG field (200), the ground-truth depths
    and normals as the state's planes (depths, as `gen_anchors` takes
    them) and as camera-frame planes (as `ransac_fit_planes` takes them),
    REFINE_INIT's parameters of the APD round and the depth range."""
    import types

    import numpy as np
    import torch

    from apde_mvs_tpu_torch import config as cfg
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops import filters
    from apde_mvs_tpu_torch.ops.state import PMState
    cams = geo.CameraArrays.from_cameras(scene.cameras, device=device)
    data = types.SimpleNamespace(ref_cam=cams.view(0), img_h=HEIGHT,
                                 img_w=WIDTH)
    depth = torch.as_tensor(scene.depths[0], device=device)
    normal = torch.as_tensor(scene.normals[0], device=device)
    region = weak_region(depth)
    params = next(sp.params for sp in cfg.build_schedule(
        max(HEIGHT, WIDTH), base=APD_BASE) if sp.params.use_apd)
    state = PMState.create(HEIGHT, WIDTH, scene.num_views - 1,
                           device=device).replace(
        planes=torch.cat([normal, depth[..., None]], -1).contiguous(),
        weak=torch.where(region, cfg.WEAK, cfg.STRONG).to(torch.int32),
        confidence=torch.where(region, 40.0, 200.0))
    cam_planes = filters.depth_normal_to_planes(data, depth,
                                                normal).contiguous()
    dmin = float(np.float32(scene.cameras[0].depth_min
                            * cfg.DEPTH_MIN_FACTOR))
    dmax = float(np.float32(scene.cameras[0].depth_max
                            * cfg.DEPTH_MAX_FACTOR))
    return types.SimpleNamespace(data=data, state=state,
                                 cam_planes=cam_planes, params=params,
                                 dmin=dmin, dmax=dmax)


ANCHOR_ERRS = []   # max |kernel - plain| of every K8, K9, K10 check
K10_A_CALL = []    # K10's launches a call as anchor_kernel_phase counted
#                    them on its 600x800 maps (check_counts holds the main
#                    paths' calls to them)


def same_bits(got, want) -> int:
    """The elements where two tensors' bits differ (float32 compared as
    int32: NaN payloads and -0 count); keeps the max abs difference over
    the values finite in both in ANCHOR_ERRS."""
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape or dtype {tuple(got.shape)} "
                             f"{got.dtype} against {tuple(want.shape)} "
                             f"{want.dtype}")
    g, w = got.double(), want.double()
    ok = torch.isfinite(g) & torch.isfinite(w)
    ANCHOR_ERRS.append(float((g[ok] - w[ok]).abs().max())
                       if bool(ok.any()) else 0.0)
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return int((got != want).sum())


def k10_check(weak, conf, valid, what: str):
    """K10 against its plain version, bitwise; returns the map."""
    from apde_mvs_tpu_torch.ops import anchors as anc
    got = anc.nearest_strong_jfa(weak, conf, valid)
    want = anc.nearest_strong_jfa_plain(weak, conf, valid)
    bad = same_bits(got, want)
    h, w = weak.shape
    log(f"  K10 {what} ({h}x{w}): {bad} of {got.numel()} values differ "
        f"from the plain version; {int((got[..., 0] >= 0).sum())} pixels "
        f"with a strong pixel")
    if bad:
        raise AssertionError(f"K10 {what}: {bad} values differ")
    return got


def k8_check(data, state, wx, wy, rt: int, thr, dmin, dmax, ns, raws,
             what: str):
    """K8 against its plain version, chunk by chunk (ANCHOR_CHUNK),
    bitwise on the anchors, reliability and hit counts; returns K8's
    result."""
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops import anchors as anc
    from apde_mvs_tpu_torch.ops.cuda import anchors as kern
    dev = wx.device
    before = kern.anchor_launches
    got = anc.gen_anchors(data, state, wx, wy, rt, thr, dmin, dmax, ns,
                          raws=raws)
    launched = kern.anchor_launches - before
    n = wx.numel()
    f32 = [geo.f32_scalar(v, dev) for v in (thr, dmin, dmax)]
    bad = {}
    for lo in range(0, n, anc.ANCHOR_CHUNK):
        sl = slice(lo, min(lo + anc.ANCHOR_CHUNK, n))
        want = anc.gen_anchors_chunk_plain(
            data.ref_cam, data.img_h, data.img_w, state.planes[..., 3], ns,
            wx[sl], wy[sl], rt, *f32, anc.AnchorRaws(
                raws.shift_x[sl], raws.shift_y[sl], raws.triplets[:, sl]))
        for name, g, w_ in zip(want._fields, got, want):
            bad[name] = bad.get(name, 0) + same_bits(g[sl], w_)
    chunks = -(-n // anc.ANCHOR_CHUNK)
    rel = got.reliable
    log(f"  K8 {what}, rotate_time {rt} ({8 * rt} directions), {n} weak "
        f"pixels in {launched} launches: differing {bad}; "
        f"{int(rel.sum())} reliable, mean hits "
        f"{float(got.hit_count.float().mean()) if n else 0:.2f}")
    if any(bad.values()) or launched != chunks:
        raise AssertionError(f"K8 {what}, rotate_time {rt}: differing "
                             f"{bad}, {launched} launches for {chunks} "
                             "chunks")
    return got


def k8_refuses_unaligned(data, state, wx, wy, rt: int, thr, dmin, dmax, ns,
                         raws):
    """K8 reads a radius's 4 jitter draws as one 16-byte vector: draws 4
    bytes past a 16-byte boundary must fail the call, nothing launched."""
    from apde_mvs_tpu_torch.ops import anchors as anc
    from apde_mvs_tpu_torch.ops.cuda import anchors as kern
    sl = slice(0, min(anc.ANCHOR_CHUNK, wx.numel()))
    odd = []
    for r in (raws.shift_x, raws.shift_y):
        o = r.new_empty(r[sl].numel() + 1)[1:].view(r[sl].shape)
        o.copy_(r[sl])
        assert o.data_ptr() % 16 == 4
        odd.append(o)
    before = kern.anchor_launches
    try:
        anc.gen_anchors(data, state, wx[sl], wy[sl], rt, thr, dmin, dmax, ns,
                        raws=anc.AnchorRaws(*odd, raws.triplets[:, sl]))
    except RuntimeError as e:
        if "apde_gen_anchors" not in str(e):
            raise
    else:
        raise AssertionError("K8 took jitter draws 4 bytes past a 16-byte "
                             "boundary")
    if kern.anchor_launches != before:
        raise AssertionError("K8 counted a launch it refused")
    log(f"  K8 refuses jitter draws 4 bytes past a 16-byte boundary "
        f"(rotate_time {rt})")


def k9_check(data, state, wx, wy, anchors, triplets, what: str):
    """K9 against its plain version, bitwise; returns K9's fits."""
    from apde_mvs_tpu_torch.ops import anchors as anc
    got = anc.ransac_fit_planes(data, state, wx, wy, anchors,
                                triplets=triplets)
    want = anc.ransac_fit_planes_plain(data.ref_cam, state.planes, wx, wy,
                                       anchors, triplets)
    bad = same_bits(got, want)
    log(f"  K9 {what}: {wx.numel()} pixels, {bad} of {got.numel()} values "
        f"differ from the plain version; "
        f"{int((got[:, :3] != 0).any(1).sum())} fits")
    if bad:
        raise AssertionError(f"K9 {what}: {bad} values differ")
    return got


def k10_bound(h: int, w: int, sub_passes: int) -> tuple:
    """K10's least time on an (h, w) map: its ``sub_passes`` live
    sub-passes' operations (whatever its launches), the maps read and the
    result written once."""
    nbytes = h * w * (4 + 4 + 1 + 8)
    ops = h * w * sub_passes * K10_OPS_PER_PIXEL_PASS
    return bound_of(nbytes, ops)


def k8_bound(data, ns, wx, wy, rt: int, raws) -> tuple:
    """K8's least time on this chunk: the probes its directions need (up
    to the first accepted one, or every probe whose test point lies in the
    image), the hits, and the RANSAC of the pixels with >= 6 hits, counted
    from the plain version's probe table; the jitter draws of the needed
    probes, the nearest-strong texels they read and the hits' depths, the
    texels and depths each once."""
    import torch

    from apde_mvs_tpu_torch.ops import anchors as anc
    n = wx.numel()
    d = 8 * rt
    h, w = data.img_h, data.img_w
    in_image, ok, sx, sy, texel = anc.probe_table(h, w, ns, wx, wy, rt, raws)
    ok = ok.reshape(n, d, -1)
    found = ok.any(-1)
    first = ok.to(torch.uint8).argmax(-1)
    needed = found * (first + 1) + ~found * in_image.reshape(n, d, -1).sum(-1)
    probes = int(needed.sum())
    hits = found.sum(-1)
    ransac = hits >= 6
    hit_total = int(hits.sum())
    ops = probes * K8_OPS_PER_PROBE + hit_total * (K8_OPS_PER_HIT + 2 * d) \
        + anc.RANSAC_ITERS * (int(ransac.sum()) * K8_OPS_PER_ITERATION
                              + int(hits[ransac].sum())
                              * K8_OPS_PER_ITERATION_HIT)
    texel = texel.reshape(n, d, -1)
    read = (torch.arange(texel.shape[-1], device=texel.device) < needed[
        ..., None]) & (texel >= 0)
    texels = torch.zeros((1, h * w), dtype=torch.bool, device=texel.device)
    mark_rows(texels, texel[None], read[None])
    del texel, read
    first = first[..., None]
    hit_px = torch.gather(sy.reshape(n, d, -1), -1, first)[..., 0] * w \
        + torch.gather(sx.reshape(n, d, -1), -1, first)[..., 0]
    depths = torch.zeros((1, h * w), dtype=torch.bool, device=found.device)
    mark_rows(depths, hit_px[None], found[None])
    nbytes = n * (8 + 4 + 72 + 1 + 4) + int(ransac.sum()) * 600 \
        + probes * 8 + int(texels.sum()) * 8 + int(depths.sum()) * 4
    return bound_of(nbytes, ops) + (probes,)


def k9_bound(anchors) -> tuple:
    """K9's least time: the draws of the pixels with >= 3 anchors and the
    planes of the distinct anchor pixels read once, the 50 iterations of
    those pixels."""
    import torch

    from apde_mvs_tpu_torch.ops import anchors as anc
    a = anchors[:, 1:]
    exists = (a >= 0).all(-1)
    count = exists.sum(-1)
    enough = count >= 3
    n = anchors.shape[0]
    ops = int(count.sum()) * K9_OPS_PER_ANCHOR + n * K9_OPS_PER_PIXEL \
        + anc.RANSAC_ITERS * (int(enough.sum()) * K9_OPS_PER_ITERATION
                              + int(count[enough].sum())
                              * K9_OPS_PER_ITERATION_ANCHOR)
    pixels = a[exists].long()
    distinct = torch.unique(pixels[:, 1] * (int(pixels[:, 0].max()) + 1)
                            + pixels[:, 0]).numel() if pixels.numel() else 0
    nbytes = n * (8 + 72 + 16 + 16) + distinct * 16 \
        + int(enough.sum()) * 600
    return bound_of(nbytes, ops)


def bound_of(nbytes: int, ops: int) -> tuple:
    """(ms, "bytes" or "operations", bytes, operations) over the card's
    memory rate and plain-f32 rate (integer and compare operations counted
    at that rate too: the guide's table has no int32 rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def anchor_kernel_phase(scene, real, seed: int, device, card: str) -> dict:
    """K10, K8 and K9 against their plain versions on the card, bitwise:
    on the APD scan's round-1 setup at full size (its weak plane's 163,060
    weak pixels, confidence ties everywhere) and on a weak set of
    WEAK_SHARE of the same map (random confidence; K8 over several
    ANCHOR_CHUNKs), K8 at rotate_time 1, 2 and 4 on both, K9 on the
    reliable pixels of each; then on the crafted cases of
    ``testing.anchor_cases`` (confidence ties, no strong pixel, one strong
    pixel, invalid strong pixels; degenerate, coincident, collinear and
    too few anchors, tying fits; a flat depth map, weak pixels at the
    border, too few strong pixels), the draws of the sharded fit (a column
    slice), K8's refusal of jitter draws not 16-byte aligned and torch's
    float32 cone comparison on the card; K10 and K9 also on a real APD
    pass's map and first fit (``real.k10``, ``real.k9``). Times each
    kernel warm with CUDA events against its plain version (the torch-op
    composition it replaced: K8's and K10's are the parent's ops, K9's
    differ only in the order of two sums) at the main path's shapes, K8
    also at the chunk a real APD pass hands it (``real``:
    ``tools.kernel_times.real_pass_chunks``) and beside its chunk's draw
    table, K10 and K9 also at the real pass's (K9 beside its draw table),
    each with its bound (K10's over its live sub-passes, whatever its
    launches)."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch import convert
    from apde_mvs_tpu_torch.config import STRONG, WEAK
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops import anchors as anc
    from apde_mvs_tpu_torch.ops.cuda import anchors as kern
    from apde_mvs_tpu_torch.ops.state import PMState
    from apde_mvs_tpu_torch.testing import anchor_cases as cases
    from apde_mvs_tpu_torch.tools.kernel_times import draw_table_ms

    log("==== K10, K8, K9: the APD setup's kernels against their plain "
        "versions ====")
    t_phase = time.perf_counter()
    setup = apd_setup(scene, device)
    p = setup.params
    gen = torch.Generator(device=device).manual_seed(seed)
    st = setup.state
    rand = torch.rand((HEIGHT, WIDTH), generator=gen, device=device)
    share = st.replace(
        weak=torch.where(rand < WEAK_SHARE, WEAK, STRONG).to(torch.int32),
        confidence=torch.randint(0, 256, (HEIGHT, WIDTH), generator=gen,
                                 device=device).to(torch.float32))
    out = {}
    maps = {}
    for key, s_, what in (("apd", st, "APD scan's weak plane, confidence "
                           "40 / 200"),
                          ("share", share, f"a {WEAK_SHARE:.0%} weak set, "
                           "random confidence")):
        maps[key] = k10_check(s_.weak, s_.confidence, s_.valid, what)
    reliable = {}
    for key, s_ in (("apd", st), ("share", share)):
        wy, wx = torch.nonzero(s_.weak == WEAK, as_tuple=True)
        wx, wy = wx.to(torch.int32), wy.to(torch.int32)
        for rt in ANCHOR_ROTATE_TIMES:
            raws = anc.anchor_raws(gen, wx.numel(), rt, device=device)
            res = k8_check(setup.data, s_, wx, wy, rt, p.ransac_threshold,
                           setup.dmin, setup.dmax, maps[key], raws,
                           f"{key} weak list")
            if rt == p.rotate_time:
                keep = torch.nonzero(res.reliable, as_tuple=True)[0]
                reliable[key] = (wx[keep], wy[keep], res.anchors[keep])
                if key == "apd":
                    out["k8_setup"] = (wx, wy, raws)
                    k8_refuses_unaligned(setup.data, s_, wx, wy, rt,
                                         p.ransac_threshold, setup.dmin,
                                         setup.dmax, maps[key], raws)
            del raws, res
    cam_state = st.replace(planes=setup.cam_planes)
    for key, (x, y, a) in reliable.items():
        tri = anc.ransac_draws(gen, x.numel(), device)
        k9_check(setup.data, cam_state, x, y, a, tri,
                 f"{key} reliable weak pixels")
        # the sharded fit's draws: a column slice of the whole list's
        wide = anc.ransac_draws(gen, 2 * x.numel() + 7, device)
        k9_check(setup.data, cam_state, x, y, a,
                 wide[:, 7:7 + x.numel()], f"{key}, a column slice of "
                 "longer draws")

    # crafted cases at the CPU tests' size
    small = cases.data(device)
    for name in cases.JFA_CASES:
        weak, conf, valid = (torch.as_tensor(v, device=device)
                             for v in cases.jfa_case(name, seed))
        k10_check(weak, conf, valid, f"crafted {name}")
    for name in ("scene",) + cases.GEN_CASES:
        if name == "scene":
            weak, conf, depth, valid = cases.scene(seed)
            ns = None
            wy_, wx_ = np.nonzero(weak == WEAK)
        else:
            g = cases.gen_case(name, seed)
            weak, conf, depth, valid, ns, wx_, wy_ = g
        s_ = PMState.create(cases.H, cases.W, 2, valid=torch.as_tensor(
            valid, device=device), device=device).replace(
            planes=torch.as_tensor(cases.depth_planes(depth),
                                   device=device),
            weak=torch.as_tensor(weak, device=device),
            confidence=torch.as_tensor(conf, device=device))
        ns = anc.nearest_strong_jfa_plain(s_.weak, s_.confidence, s_.valid) \
            if ns is None else torch.as_tensor(ns, device=device)
        for rt in ANCHOR_ROTATE_TIMES:
            raws = convert.anchor_raws(**cases.draws(
                np.random.default_rng(seed + rt), len(wx_), rt),
                device=device)
            k8_check(small, s_, convert.ints(wx_, device),
                     convert.ints(wy_, device), rt, cases.THRESH,
                     cases.DEPTH_MIN, cases.DEPTH_MAX, ns, raws,
                     f"crafted {name}")
    fc = cases.fit_crafted(seed)
    s_ = PMState.create(cases.H, cases.W, 2, device=device).replace(
        planes=torch.as_tensor(fc.planes, device=device))
    k9_check(small, s_, convert.ints(fc.wx, device),
             convert.ints(fc.wy, device), convert.ints(fc.anchors, device),
             convert.ints(fc.triplets, device),
             f"crafted {', '.join(cases.FIT_KINDS)}")
    # the cone test: torch's float32 tensor > Python float on the card
    # against K8's float32 comparison
    for rt in ANCHOR_ROTATE_TIMES:
        cc = anc._cone_cos(rt)
        c32 = np.float32(cc)
        vals = torch.as_tensor(np.array(
            [np.nextafter(c32, np.float32(0)), c32,
             np.nextafter(c32, np.float32(2))], np.float32), device=device)
        if not torch.equal(vals > cc, vals > torch.tensor(c32,
                                                          device=device)):
            raise AssertionError(f"rotate_time {rt}: torch compares the "
                                 "cone's cosine in another precision on "
                                 "the card")
    log("  the cone's comparison: float32 on the card at rotate_time 1, 2 "
        "and 4")

    # a real APD pass's K10 map and first K9 fit (the pass's own camera)
    a, kw = real.k10
    maps["real"] = k10_check(a[0], a[1], a[2], "a real APD pass's map")
    if tuple(a[3]) != anc.jfa_schedule(*a[0].shape):
        raise AssertionError("K10, a real APD pass: not the map's schedule")
    a9, kw9 = real.k9
    ref_cam = real.k8_plain[0]
    if kern.camera(ref_cam) != a9[5]:
        raise AssertionError("K9, a real APD pass's fit: the captured "
                             "camera is not the pass's")
    got = kern.fit_planes(*a9, **kw9)
    bad = same_bits(got, anc.ransac_fit_planes_plain(ref_cam, *a9[:5]))
    log(f"  K9 a real APD pass's first fit: {a9[1].numel()} pixels, {bad} "
        f"of {got.numel()} values differ from the plain version; "
        f"{int((got[:, :3] != 0).any(1).sum())} fits")
    if bad:
        raise AssertionError(f"K9, a real APD pass's fit: {bad} values "
                             "differ")

    # times at the main path's shapes: K10 a call on the APD map and on a
    # real pass's, K8 a chunk of the APD weak list at the pass's
    # rotate_time, K9 a call on its reliable pixels and a real pass's fit
    for key, (w_, c_, v_) in (("K10", (st.weak, st.confidence, st.valid)),
                              ("K10_real", a[:3])):
        h_, wd_ = w_.shape
        schedule = anc.jfa_schedule(h_, wd_)
        before = kern.jfa_launches
        kern.nearest_strong(w_, c_, v_, schedule)
        launches = kern.jfa_launches - before
        K10_A_CALL.append(launches)
        ms = cuda_ms(lambda: kern.nearest_strong(w_, c_, v_, schedule), 20)
        plain_ms = cuda_ms(lambda: anc.nearest_strong_jfa_plain(w_, c_, v_),
                           3, 1)
        bound = k10_bound(h_, wd_, len(schedule))
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                        bound_by=bound[1], library_ms=None,
                        launches_a_call=launches, sub_passes=len(schedule))
        log(f"  {key} a call ({h_}x{wd_}: {launches} launch(es) a call, "
            f"{len(schedule)} live sub-passes of "
            f"{8 * len(anc.jfa_steps(h_, wd_))}): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
            f"({bound[2] / 1e6:.2f} MB, {bound[3] / 1e9:.3f} G operations) "
            f"[{card}]")

    wx, wy, raws = out.pop("k8_setup")
    sl = slice(0, min(anc.ANCHOR_CHUNK, wx.numel()))
    cx, cy = wx[sl].contiguous(), wy[sl].contiguous()
    craws = anc.AnchorRaws(raws.shift_x[sl].contiguous(),
                           raws.shift_y[sl].contiguous(),
                           raws.triplets[:, sl])
    dirs, radii = anc._kernel_tables(p.rotate_time, str(device))
    cam = kern.camera(setup.data.ref_cam)
    scal = (float(np.float32(anc._cone_cos(p.rotate_time))),
            float(np.float32(p.ransac_threshold)),
            float(np.float32(setup.dmax) - np.float32(setup.dmin)))
    planes = st.planes.contiguous()
    ns = maps["apd"]
    ms = cuda_ms(lambda: kern.gen_anchors(
        ns, planes, HEIGHT, WIDTH, cx, cy, craws.shift_x, craws.shift_y,
        craws.triplets, dirs, radii, anc.JITTER_SAMPLES, cam, *scal,
        anc.MIN_MARGIN), 20)
    f32 = [geo.f32_scalar(v, device) for v in (p.ransac_threshold,
                                               setup.dmin, setup.dmax)]
    plain_ms = cuda_ms(lambda: anc.gen_anchors_chunk_plain(
        setup.data.ref_cam, HEIGHT, WIDTH, st.planes[..., 3], ns, cx, cy,
        p.rotate_time, *f32, craws), 3, 1)
    bound = k8_bound(setup.data, ns, cx, cy, p.rotate_time, craws)
    draws_ms = draw_table_ms(device, cx.numel(), p.rotate_time)
    out["K8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                     bound_by=bound[1], library_ms=None,
                     pixels=cx.numel(), directions=8 * p.rotate_time,
                     draws_ms=draws_ms)
    log(f"  K8 a chunk ({cx.numel()} pixels, rotate_time {p.rotate_time}, "
        f"{bound[4]} probes needed): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound[0]:.4f} ms by {bound[1]} ({bound[2] / 1e6:.2f} MB, "
        f"{bound[3] / 1e9:.3f} G operations); the chunk's jitter and "
        f"RANSAC draw table (torch.randint) {draws_ms:.4f} ms [{card}]")
    del craws, raws
    # a real APD pass's chunk, with the pass's own camera, threshold and
    # depth bounds for the plain version (the wrapper's host scalars must
    # be theirs)
    a, kw = real.k8
    ref_cam, thr, dmin, dmax = real.k8_plain
    if (kern.camera(ref_cam) != a[12]
            or float(np.float32(thr)) != a[14]
            or float(np.float32(dmax) - np.float32(dmin)) != a[15]):
        raise AssertionError("K8, a real APD pass's chunk: the captured "
                             "scalars are not the pass's")
    ra = anc.AnchorRaws(a[6], a[7], a[8])
    rt = a[9].shape[0] // 8
    f32r = [geo.f32_scalar(v, device) for v in (thr, dmin, dmax)]

    def plain_real():
        return anc.gen_anchors_chunk_plain(ref_cam, a[2], a[3], a[1][..., 3],
                                           a[0], a[4], a[5], rt, *f32r, ra)
    got = kern.gen_anchors(*a, **kw)
    want = plain_real()
    n_errs = len(ANCHOR_ERRS)
    bad = {name: same_bits(g, w_)
           for name, g, w_ in zip(want._fields, got, want)}
    real_err = max(ANCHOR_ERRS[n_errs:])
    log(f"  K8 a real APD pass's chunk, rotate_time {rt}: differing {bad}")
    if any(bad.values()):
        raise AssertionError(f"K8, a real APD pass's chunk: differing {bad}")
    del got, want
    ms = cuda_ms(lambda: kern.gen_anchors(*a, **kw), 20)
    plain_ms = cuda_ms(plain_real, 3, 1)
    bound = k8_bound(setup.data, a[0], a[4], a[5], rt, ra)
    out["K8_real"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                          bound_by=bound[1], library_ms=None,
                          max_abs_err=real_err, pixels=a[4].numel(),
                          directions=8 * rt)
    log(f"  K8 a real APD pass's chunk ({a[4].numel()} pixels, rotate_time "
        f"{rt}, {bound[4]} probes needed): {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
        f"({bound[2] / 1e6:.2f} MB, {bound[3] / 1e9:.3f} G operations) "
        f"[{card}]")

    x, y, a = reliable["apd"]
    tri = anc.ransac_draws(gen, x.numel(), device)
    for key, args, ref_cam in (
            ("K9", (setup.cam_planes, x, y, a, tri, cam),
             setup.data.ref_cam),
            ("K9_real", a9, real.k8_plain[0])):
        ms = cuda_ms(lambda: kern.fit_planes(*args), 20)
        plain_ms = cuda_ms(lambda: anc.ransac_fit_planes_plain(
            ref_cam, *args[:5]), 3, 1)
        bound = k9_bound(args[3])
        draws_ms = cuda_ms(lambda: anc.ransac_draws(gen, args[1].numel(),
                                                    device), 20)
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                        bound_by=bound[1], library_ms=None,
                        pixels=args[1].numel(), draws_ms=draws_ms)
        log(f"  {key} a call ({args[1].numel()} reliable pixels): {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms by "
            f"{bound[1]} ({bound[2] / 1e6:.2f} MB, {bound[3] / 1e9:.3f} G "
            f"operations); its draw table (torch.randint) {draws_ms:.4f} ms "
            f"[{card}]")
    for name in ("K8", "K9", "K10"):
        info = kern.kernel_info(name)
        out[name]["regs"] = info["regs"]
        log(f"  {name}: {info['regs']} registers, {info['local_bytes']} B "
            f"local (spills), {info['blocks_per_sm']} resident blocks an "
            f"SM [{card}]")
    out["max_abs_err"] = max(ANCHOR_ERRS)
    log(f"anchor kernel phase {time.perf_counter() - t_phase:.1f} s, "
        f"{len(ANCHOR_ERRS)} outputs compared, max |kernel - plain| "
        f"{out['max_abs_err']}")
    return out


# the selection's operations a (pixel, view): ~2 compares and selects a
# pass over the views, for the count and the k smallest (top_k = 4: ~5
# passes)
K11_OPS_PER_PAIR = 2 * 5

# operations of the initial cost's stage forms as the function needs them,
# beside K2's per tap and per pair (K2's stage form) and K6's per evaluated
# pair (its re-score form): the window's K3_WINDOW_OPS_PER_TAP a (pixel,
# tap) of K2's window, K7_OPS_PER_REF_TAP a reference tap of the re-score's
# reference side (36 a pixel and 9 a valid anchor: the costs read no other
# anchor's window). The selection K11 is
# bound by its bytes: the (S, H W) costs read, the validity read, the cost
# map and the selections written, each once.


def stage_costs_plain(data, state, params, wx=None, wy=None, anchors=None):
    """The initial cost's plain versions on the card's tensors, step by
    step: K2's stage form over the image ((H W, S) costs), with a weak list
    K6's re-score form placed at its pixels, and K11's cost map and
    selections. Returns (the strong costs, the costs after the re-score,
    the cost map, the selections)."""
    from apde_mvs_tpu_torch.ops.cuda import ncc, weak
    from apde_mvs_tpu_torch.ops.cuda import select as k11
    h, w = data.height, data.width
    strong = ncc.init_stage_plain(data, state.planes, 0, h * w,
                                  params.strong_radius,
                                  params.strong_increment,
                                  bool(params.use_sa))
    costs = strong.clone()
    if wx is not None:
        costs[wy.long() * w + wx.long()] = weak.rescore_plain(
            data, state.planes, state.selected, wx, wy, anchors,
            **rescore_kwargs(params))
    cost_map, selected = k11.select_plain(costs, state.valid, params.top_k)
    return strong, costs, cost_map, selected


def rescore_kwargs(params) -> dict:
    return dict(strong_radius=params.strong_radius,
                strong_increment=params.strong_increment,
                weak_radius=params.weak_radius,
                weak_increment=params.weak_increment,
                use_sa=bool(params.use_sa))


def init_stage_check(data, state, params, what: str, wx=None, wy=None,
                     anchors=None) -> float:
    """The initial cost's three forms against their plain versions on the
    card, bitwise, one at a time and as ``init.initial_cost``'s stage: K2's
    stage form over the whole image into view-major costs, K6's re-score
    form into those costs' columns, K11 on them. Returns the max abs
    difference read."""
    import torch

    from apde_mvs_tpu_torch.ops import init
    from apde_mvs_tpu_torch.ops.cuda import ncc, weak
    from apde_mvs_tpu_torch.ops.cuda import select as k11
    h, w, s = data.height, data.width, data.num_src
    strong, costs, cost_map, sel = stage_costs_plain(
        data, state, params, wx, wy, anchors)
    got = torch.empty((s, h * w), device=data.device)
    ncc.init_stage_fused(data, state.planes, 0, h * w, got,
                         radius=params.strong_radius,
                         increment=params.strong_increment,
                         use_sa=bool(params.use_sa), view_major=True)
    torch.cuda.synchronize()
    if not bitwise(got.T, strong):
        raise AssertionError(f"K2 stage form {what}: "
                             f"{int((got.T != strong).sum())} costs differ "
                             "from the plain version")
    errs = [0.0]
    n = 0 if wx is None else wx.numel()
    for i in range(0, n, init.WEAK_CHUNK):
        weak.rescore_fused(data, state.planes, state.selected, wx, wy,
                           anchors, i, min(i + init.WEAK_CHUNK, n), got,
                           view_major=True, **rescore_kwargs(params))
    torch.cuda.synchronize()
    if not bitwise(got.T, costs):
        raise AssertionError(f"K6 re-score form {what}: "
                             f"{int((got.T != costs).sum())} costs differ "
                             "from the plain version")
    got_map, got_sel = k11.select_fused(got, True, state.valid,
                                        params.top_k)
    torch.cuda.synchronize()
    if not bitwise(got_map, cost_map) or not torch.equal(got_sel, sel):
        raise AssertionError(
            f"K11 {what}: {int((got_map != cost_map).sum())} costs and "
            f"{int((got_sel != sel).sum())} selections differ from the "
            "plain version")
    # the selection modes: K2's stage form with the selection in its
    # epilogue (plain: K11's plain selection of the strong costs), then
    # K6's re-score form with it over K2's maps (plain: the composition)
    sel_map = torch.full((h, w), -1.0, device=data.device)
    sel_sel = torch.zeros((h, w, s), dtype=torch.bool, device=data.device)
    ncc.init_stage_select_fused(data, state.planes, 0, h * w, state.valid,
                                params.top_k, sel_map, sel_sel,
                                radius=params.strong_radius,
                                increment=params.strong_increment,
                                use_sa=bool(params.use_sa))
    torch.cuda.synchronize()
    k2_map, k2_sel = k11.select_plain(strong, state.valid, params.top_k)
    if not bitwise(sel_map, k2_map) or not torch.equal(sel_sel, k2_sel):
        raise AssertionError(
            f"K2 stage form with the selection {what}: "
            f"{int((sel_map != k2_map).sum())} costs and "
            f"{int((sel_sel != k2_sel).sum())} selections differ from the "
            "plain version")
    for i in range(0, n, init.WEAK_CHUNK):
        weak.rescore_select_fused(data, state.planes, state.selected, wx,
                                  wy, anchors, i, min(i + init.WEAK_CHUNK, n),
                                  state.valid, params.top_k, sel_map,
                                  sel_sel, **rescore_kwargs(params))
    torch.cuda.synchronize()
    if not bitwise(sel_map, cost_map) or not torch.equal(sel_sel, sel):
        raise AssertionError(
            f"K6 re-score form with the selection {what}: "
            f"{int((sel_map != cost_map).sum())} costs and "
            f"{int((sel_sel != sel).sum())} selections differ from the "
            "plain version")
    out = init.initial_cost(data, state, params, wx, wy, anchors)
    torch.cuda.synchronize()
    if not bitwise(out.costs, cost_map) or not torch.equal(out.selected,
                                                           sel):
        raise AssertionError(f"initial cost {what}: the stage differs from "
                             "its plain versions")
    for a, b in ((got.T, costs), (got_map, cost_map)):
        errs.append(float((a - b).abs().max()))
    changed = 0 if wx is None else int(
        (costs != strong).any(-1).sum())
    log(f"  initial cost {what} ({s} views, {h}x{w}, {n} weak pixels, "
        f"{changed} costs re-scored): K2's stage form and K6's re-score "
        f"form, each with the selection and in its cost-out mode, K11 and "
        f"the stage bitwise equal to their plain versions; "
        f"{float((cost_map >= 2.0).float().mean()):.4f} of the pixels at "
        f"COST_MAX or invalid, {float(sel.sum(-1).float().mean()):.3f} "
        "views selected a pixel")
    return max(errs)


def tile_stage_check(data, state, params, wx, wy, anchors,
                     what: str) -> float:
    """The tile route's forms on one rank's part: K2's stage form on rows
    0 .. H / RANKS - 1 into a pixel-major block, K6's re-score form on the
    second half of the weak list into a compact pixel-major block, K11 on
    pixel-major costs; each bitwise against its plain version."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import ncc, weak
    from apde_mvs_tpu_torch.ops.cuda import select as k11
    h, w, s = data.height, data.width, data.num_src
    hi = h // RANKS * w
    got = torch.empty((hi, s), device=data.device)
    ncc.init_stage_fused(data, state.planes, 0, hi, got,
                         radius=params.strong_radius,
                         increment=params.strong_increment,
                         use_sa=bool(params.use_sa), view_major=False)
    want = ncc.init_stage_plain(data, state.planes, 0, hi,
                                params.strong_radius,
                                params.strong_increment, bool(params.use_sa))
    n = wx.numel()
    lo = n // RANKS
    part = torch.empty((n - lo, s), device=data.device)
    weak.rescore_fused(data, state.planes, state.selected, wx, wy, anchors,
                       lo, n, part, view_major=False, col0=lo,
                       **rescore_kwargs(params))
    wpart = weak.rescore_plain(data, state.planes, state.selected, wx[lo:],
                               wy[lo:], anchors[lo:],
                               **rescore_kwargs(params))
    full = ncc.init_stage_plain(data, state.planes, 0, h * w,
                                params.strong_radius,
                                params.strong_increment,
                                bool(params.use_sa)).contiguous()
    got_map, got_sel = k11.select_fused(full, False, state.valid,
                                        params.top_k)
    want_map, want_sel = k11.select_plain(full, state.valid, params.top_k)
    torch.cuda.synchronize()
    for name, a, b in (("K2 stage form", got, want),
                       ("K6 re-score form", part, wpart),
                       ("K11", got_map, want_map)):
        if not bitwise(a, b):
            raise AssertionError(f"{name} {what}: {int((a != b).sum())} "
                                 "values differ from the plain version")
    if not torch.equal(got_sel, want_sel):
        raise AssertionError(f"K11 {what}: selections differ")
    log(f"  tile route {what}: K2's stage form on rows 0 .. {h // RANKS - 1}"
        f" ({hi} pixels), K6's re-score form on list items {lo} .. {n - 1} "
        f"(a compact block), K11 on pixel-major costs: bitwise equal to "
        "their plain versions")
    return float((got - want).abs().max())


def crafted_selection_costs(h: int, w: int, s: int, seed: int, device):
    """(H W, S) costs with crafted rows among seeded uniform ones: every
    view at COST_MAX, exact ties at the threshold, fewer views below
    COST_MAX than top_k, one view below it, NaN costs, -0 and +0, -inf,
    +inf and costs above COST_MAX (a geometric cost's range)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 2.0, (h * w, s)).astype(np.float32)
    c[rng.random(c.shape) < 0.3] = 2.0
    n = h * w // 16
    rows = [slice(i * n, (i + 1) * n) for i in range(10)]
    c[rows[0]] = 2.0
    c[rows[1], 1] = c[rows[1], 0]
    c[rows[1], 2] = c[rows[1], 0]
    c[rows[2], 2:] = 2.0
    c[rows[3], 1:] = 2.0
    c[rows[4], ::2] = np.nan
    c[rows[5], 0] = -0.0
    c[rows[5], 1] = 0.0
    c[rows[6], 0] = -np.inf
    c[rows[7], 1] = np.inf
    c[rows[8], ::3] = 3.0
    q = np.round(rng.uniform(0.0, 2.0, (n, s)) * 4) / 4
    c[rows[9]] = q.astype(np.float32)      # many exact ties
    return torch.as_tensor(c, device=device)


def k11_crafted_check(h: int, w: int, s: int, valid, top_k: int, seed: int,
                      device, what: str) -> None:
    """K11 against its plain version on crafted rows, bitwise, in both
    layouts."""
    import torch

    from apde_mvs_tpu_torch.ops.cuda import select as k11
    c = crafted_selection_costs(h, w, s, seed, device)
    want_map, want_sel = k11.select_plain(c, valid, top_k)
    for view_major, costs in ((False, c), (True, c.T.contiguous())):
        got_map, got_sel = k11.select_fused(costs, view_major, valid, top_k)
        torch.cuda.synchronize()
        if not bitwise(got_map, want_map) or not torch.equal(got_sel,
                                                             want_sel):
            raise AssertionError(
                f"K11 {what} ({'view' if view_major else 'pixel'}-major): "
                f"{int((got_map != want_map).sum())} costs, "
                f"{int((got_sel != want_sel).sum())} selections differ")
    log(f"  K11 {what} ({s} views, {h}x{w}, crafted rows: all COST_MAX, "
        f"ties, k < top_k, one view, NaN, -0 / +0, -inf, +inf, above "
        f"COST_MAX): bitwise equal to the plain version in both layouts, "
        f"{float(want_sel.sum(-1).float().mean()):.3f} views selected a "
        "pixel")


def init_stage_bound(data, state, params, select: bool = True) -> tuple:
    """The least time the card could take for one launch of K2's stage
    form over the image: its f32 operations (K2's a tap and a pair, the
    window's a (pixel, tap); with the selection K11's a (pixel, view),
    `k11_bound`'s count) over the plain-f32 rate, against the bytes of its
    inputs (the planes, the reference image and segment ids, the
    quad-table rows its taps touch, with the selection the validity map,
    each once) and its outputs (the cost map and the selections with the
    selection, else the (S, H W) costs). Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    import torch

    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.core.sampling import quad_coords
    from apde_mvs_tpu_torch.ops.cuda.strong import window_plain
    s, h, w = data.num_src, data.height, data.width
    sa = bool(params.use_sa) and data.sa_mask is not None
    t = 0
    mark = torch.zeros((s, w * data.quad_h), dtype=torch.bool,
                       device=data.device)
    step = 1 << 15
    for lo in range(0, h * w, step):
        f = torch.arange(lo, min(lo + step, h * w), device=data.device)
        x, y = (f % w).float(), (f // w).float()
        win = window_plain(data, x, y, params.strong_radius,
                           params.strong_increment, sa)
        t = win.tap_val.shape[1]
        plane = state.planes.reshape(-1, 4)[lo:lo + f.numel()]
        hom = geo.homography(data.ref_cam, data.src_views, plane)
        wx, wy = geo.warp(hom[..., None, :, :], x[:, None] + win.tap_dx,
                          y[:, None] + win.tap_dy)
        mark_rows(mark, quad_coords(data.width, data.quad_h, wx, wy)[0])
    rows = int(mark.sum())
    b = h * w
    per_tap = K2_OPS_PER_TAP + (2 if sa else 0)
    ops = s * b * (t * per_tap + K2_OPS_PER_PAIR) \
        + b * t * K3_WINDOW_OPS_PER_TAP
    nbytes = 16 * b + 4 * data.ref_image.numel() * (2 if sa else 1) \
        + rows * 4 * data.src_quads.element_size() + (s + 1) * 16 * 4
    if select:
        ops += b * s * K11_OPS_PER_PAIR
        nbytes += b * (1 + 4 + s)
    else:
        nbytes += 4 * s * b
    return bound_of(nbytes, ops)


def rescore_bound(data, state, params, wx, wy, anchors,
                  select: bool = True, every_anchor: bool = False) -> tuple:
    """The least time the card could take for one launch of K6's re-score
    form: its f32 operations (``k6_bound``'s on the pixels' own planes, the
    reference side's K7_OPS_PER_REF_TAP a tap of the windows the costs
    read: every centre's and the valid anchors'; with the selection K11's
    a (pixel, view)) over the plain-f32 rate, against the bytes of its
    inputs (the pixels, their anchors and planes, the prior selections at
    the valid anchors, the distinct reference-image texels of those
    windows, under SA their segment ids and those at the pixels and the
    existing anchors (the validity test), the quad-table rows the pairs
    touch, with the selection the pixels' validity, each once) and its
    outputs (with the selection the pixels' costs and selections, else
    their (S, B) costs). ``every_anchor``: the earlier count, every
    anchor's window and selections as if the costs read them. Returns (ms,
    "bytes" or "operations", bytes, operations)."""
    import torch

    from apde_mvs_tpu_torch.core.sampling import fetch
    from apde_mvs_tpu_torch.ops.cost import square_taps
    from apde_mvs_tpu_torch.ops.cuda import weak
    s, b = data.num_src, wx.numel()
    h, w = data.height, data.width
    sa = bool(params.use_sa) and data.sa_mask is not None
    wref = weak.weak_ref_plain(data, wx.float(), wy.float(), anchors,
                               state.selected, params.strong_radius,
                               params.strong_increment, params.weak_radius,
                               params.weak_increment, sa)
    own = fetch(state.planes, wx, wy)[:, None].contiguous()
    _, _, k6_bytes, k6_ops = k6_bound(data, wref, own, params, None, False)
    t = wref.center_win.tap_val.shape[1]
    ta = wref.tap_val.shape[2]
    w_ = 2 if sa else 1
    old_inputs = b * (4 * (2 + w_ * t + 3 + 8 * (2 + w_ * ta + 3)) + 8
                      + 8 * s + 16)
    built = torch.ones_like(wref.anchor_valid) if every_anchor \
        else wref.anchor_valid
    nbuilt = int(built.sum())
    # the distinct texels the windows read
    texels = torch.zeros((h, w), dtype=torch.bool, device=data.device)
    sq = torch.as_tensor(square_taps(params.strong_radius,
                                     params.strong_increment),
                         device=data.device)
    wk = torch.as_tensor(square_taps(params.weak_radius,
                                     params.weak_increment),
                         device=data.device)
    texels[(wy.long()[:, None] + sq[:, 1]).clamp(0, h - 1),
           (wx.long()[:, None] + sq[:, 0]).clamp(0, w - 1)] = True
    ax = anchors[:, 1:, 0].clamp(min=0).long()
    ay = anchors[:, 1:, 1].clamp(min=0).long()
    texels[(ay[built][:, None] + wk[:, 1]).clamp(0, h - 1),
           (ax[built][:, None] + wk[:, 0]).clamp(0, w - 1)] = True
    nbytes = k6_bytes - old_inputs + b * (8 + 72 + 16) + nbuilt * s \
        + int(texels.sum()) * 4 * w_
    if sa and not every_anchor:
        # the segment ids the validity test reads outside those windows
        ids = torch.zeros_like(texels)
        ids[wy.long(), wx.long()] = True
        exists = (anchors[:, 1:] >= 0).all(-1)
        inside = exists & (ax < w) & (ay < h)
        ids[ay[inside], ax[inside]] = True
        nbytes += 4 * int((ids & ~texels).sum())
    ops = k6_ops + (b * t + nbuilt * ta) * K7_OPS_PER_REF_TAP
    if select:
        # k6_bound counts the (S, B) f32 costs written
        ops += b * s * K11_OPS_PER_PAIR
        nbytes += b * (1 + 4 + s) - 4 * s * b
    return bound_of(nbytes, ops)


def k11_bound(h: int, w: int, s: int) -> tuple:
    """The least time the card could take for one K11 launch: the bytes of
    the (S, H W) costs and the validity map read and the cost map and
    selections written, each once, over the memory rate (its compares and
    adds, K11_OPS_PER_PAIR a (pixel, view), are far below)."""
    return bound_of(h * w * (4 * s + 1 + 4 + s), h * w * s * K11_OPS_PER_PAIR)


def init_phase(full_scene, apd_scene, wc, real, seed: int, device,
               card: str) -> dict:
    """The initial cost's stage on the card (``init.initial_cost``: K2's
    stage form and K6's re-score form a WEAK_CHUNK, each with the selection
    in its epilogue; on the tile route their cost-out modes and K11)
    against its plain versions, bitwise, every form: at the full 600x800
    image (u8 and f32, square and SA star windows, ground-truth and random
    planes with degenerate ones, a padded image's invalid border), with the
    APD scan's weak list (SA and square windows, u8 and f32) and a real APD
    pass's (its captured call), at a tile rank's row block and list slice,
    at 32 views, and K11 on crafted rows; then the windows K2's stage form
    builds a pixel in the old layout and the new, each form's time a launch
    against its plain version and the composition it replaced, the
    selection modes against the cost-out modes and K11 (the parent's
    composition) at 5, 10 and 32 views, the bounds,
    K11 beside ``torch.topk`` and ``torch.sort``, and the whole stage
    against ``testing.init_composition``."""
    import dataclasses

    import torch

    from apde_mvs_tpu_torch import config as cfg
    from apde_mvs_tpu_torch.core import geometry as geo
    from apde_mvs_tpu_torch.ops import filters, init
    from apde_mvs_tpu_torch.ops.cost import CostData, ncc_strong, \
        precompute_ref_window
    from apde_mvs_tpu_torch.ops.cuda import ncc, weak
    from apde_mvs_tpu_torch.ops.cuda import select as k11
    from apde_mvs_tpu_torch.ops.deformable import WeakRefData, ncc_weak
    from apde_mvs_tpu_torch.ops.state import PMState
    from apde_mvs_tpu_torch.testing.init_composition import init_composition
    from apde_mvs_tpu_torch.testing.kernel_cases import cycled_views

    log("==== the initial cost: K2's stage form and K6's re-score form with "
        "the selection, their cost-out modes, K11 ====")
    t_phase = time.perf_counter()
    errs = []
    H, W = full_scene.images.shape[1:]
    cams = geo.CameraArrays.from_cameras(full_scene.cameras, device=device)
    imgs = torch.as_tensor(full_scene.images, device=device)
    sa_ids = segment_masks(full_scene.depths[0], seed).to(device)
    params = next(sp.params for sp in cfg.build_schedule(
        max(H, W), base=APD_BASE) if sp.params.use_apd)
    square = dataclasses.replace(params, use_sa=False)
    depth = torch.as_tensor(full_scene.depths[0], device=device)
    normal = torch.as_tensor(full_scene.normals[0], device=device)
    dmin = float(full_scene.cameras[0].depth_min * cfg.DEPTH_MIN_FACTOR)
    dmax = float(full_scene.cameras[0].depth_max * cfg.DEPTH_MAX_FACTOR)

    def full_state(data, pad: int = 0):
        """Ground-truth planes on half the pixels, random ones on the
        other half, a few degenerate; seeded prior selections; the last
        ``pad`` rows and columns invalid (a padded image's border)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        gt = filters.depth_normal_to_planes(data, depth, normal)
        rnd = init.random_planes(data, dmin, dmax, generator=gen)
        pick = torch.rand((H, W), generator=gen, device=device) < 0.5
        planes = torch.where(pick[..., None], gt, rnd).contiguous()
        planes.view(-1, 4)[0::97, 3] = 0.0
        planes.view(-1, 4)[1::97] = float("nan")
        valid = torch.ones((H, W), dtype=torch.bool, device=device)
        if pad:
            valid[H - pad:] = False
            valid[:, W - pad:] = False
        sel = torch.rand((H, W, data.num_src), generator=gen,
                         device=device) < 0.4
        return PMState.create(H, W, data.num_src, valid, device=device
                              ).replace(planes=planes, selected=sel)

    # ---- the full image: u8 and f32, square and SA ------------------------
    data = {}
    for u8 in (True, False):
        data[u8] = CostData.build(cams.view(0), cams.map(lambda a: a[1:]),
                                  imgs[0], imgs[1:], sampler_u8=u8,
                                  sa_mask=sa_ids)
        for prm, form in ((square, "square"), (params, "SA star")):
            errs.append(init_stage_check(
                data[u8], full_state(data[u8]), prm,
                f"full image {'u8' if u8 else 'f32'}, {form} window"))
    # a padded image: the real bounds 8 pixels in, the border invalid
    padded = data[True].replace(real_width=W - 8, real_height=H - 8)
    errs.append(init_stage_check(padded, full_state(padded, 8), params,
                                 f"padded u8 (real {H - 8}x{W - 8}), SA"))
    # 32 views, the kernels' limit: the 10 cycled, prior selections cycled
    d32, idx = cycled_views(data[True], 32)
    st32 = full_state(data[True])
    st32 = st32.replace(selected=st32.selected[..., idx].contiguous())
    errs.append(init_stage_check(d32, st32, params, "u8, 32 views"))
    k11_crafted_check(H, W, 32, st32.valid, params.top_k, seed, device,
                      "32 views")
    del d32, st32
    k11_crafted_check(H, W, data[True].num_src,
                      full_state(data[True], 8).valid, params.top_k, seed,
                      device, "padded validity")

    # ---- the APD scan's weak list (every weak pixel, gen_anchors') --------
    wx, wy, wan = wc.all_x, wc.all_y, wc.all_anchors
    wdata = {True: wc.data}
    acams = geo.CameraArrays.from_cameras(apd_scene.cameras, device=device)
    aimgs = torch.as_tensor(apd_scene.images, device=device)
    wdata[False] = CostData.build(
        acams.view(0), acams.map(lambda a: a[1:]), aimgs[0], aimgs[1:],
        src_depths=wc.data.src_depths, sampler_u8=False,
        sa_mask=wc.data.sa_mask)
    wstate = wc.state.replace(planes=wc.state.planes.contiguous(),
                              selected=wc.state.selected.contiguous())
    for u8 in (True, False):
        for prm, form in ((params, "SA"), (square, "square")):
            if not u8 and form == "square":
                continue
            errs.append(init_stage_check(
                wdata[u8], wstate, prm,
                f"APD scan {'u8' if u8 else 'f32'}, {form} windows, its "
                "weak list", wx, wy, wan))
    errs.append(tile_stage_check(wdata[True], wstate, params, wx, wy, wan,
                                 "APD scan u8, SA"))
    # 32 views on a slice of the list
    a32, idx = cycled_views(wdata[True], 32)
    s32 = wstate.replace(selected=wstate.selected[..., idx].contiguous())
    n32 = min(wx.numel(), init.WEAK_CHUNK)
    errs.append(init_stage_check(a32, s32, params,
                                 "APD scan u8, 32 views, SA", wx[:n32],
                                 wy[:n32], wan[:n32].contiguous()))
    del a32, s32

    # ---- a real APD pass's call -----------------------------------------
    (rdata, rstate, rparams, rx, ry, ran), _ = real.init
    errs.append(init_stage_check(rdata, rstate, rparams,
                                 "a real APD REFINE_INIT pass", rx, ry, ran))

    # ---- the windows K2's stage form builds a pixel -----------------------
    for views in (5, 10, 32):
        g = ncc.stage_groups(views)
        log(f"  K2 stage form, {views} views at {H}x{W}: windows built a "
            f"pixel {ncc.window_builds(H * W, views):.4f} in the sweep "
            f"form's layout (8 (group, view) pairs a block), "
            f"{ncc.window_builds(H * W, views, g):.4f} with a block owning "
            f"all {views} views of {g} groups")

    # ---- times ------------------------------------------------------------
    res = {}
    d, st = data[True], full_state(data[True])
    xs, ys = geo.pixel_grid(H, W, device)
    xf, yf = xs.reshape(-1), ys.reshape(-1)
    out = torch.empty((d.num_src, H * W), device=device)
    cmap = torch.empty((H, W), device=device)
    for prm, key, form in ((params, "k2_sa", "SA star"),
                           (square, "k2", "square")):
        use_sa = bool(prm.use_sa)
        smap = torch.empty((H, W, d.num_src), dtype=torch.bool,
                           device=device)

        def k2():
            ncc.init_stage_select_fused(d, st.planes, 0, H * W, st.valid,
                                        prm.top_k, cmap, smap, radius=5,
                                        increment=2, use_sa=use_sa)

        def cost_out():
            ncc.init_stage_fused(d, st.planes, 0, H * W, out, radius=5,
                                 increment=2, use_sa=use_sa,
                                 view_major=True)

        def parent():
            cost_out()
            k11.select_fused(out, True, st.valid, prm.top_k)

        def comp():
            return ncc_strong(d, xf, yf, st.planes.reshape(-1, 4),
                              precompute_ref_window(d, xf, yf, 5, 2, use_sa),
                              site="init")
        ms = cuda_ms(k2, 20)
        parent_ms = cuda_ms(parent, 20)
        costout_ms = cuda_ms(cost_out, 20)
        ms_again = cuda_ms(k2, 20)
        plain_ms = cuda_ms(lambda: ncc.init_stage_select_plain(
            d, st.planes, 0, H * W, st.valid, prm.top_k, 5, 2, use_sa), 2, 1)
        costout_plain_ms = cuda_ms(lambda: ncc.init_stage_plain(
            d, st.planes, 0, H * W, 5, 2, use_sa), 2, 1)
        comp_ms = cuda_ms(comp, 10)
        bound, by, nbytes, ops = init_stage_bound(d, st, prm)
        cbound, cby, cbytes, cops = init_stage_bound(d, st, prm,
                                                     select=False)
        log(f"  K2 stage form with the selection, full image u8, {form} "
            f"window ({d.num_src} views x {H * W} pixels, "
            f"{ncc.stage_groups(d.num_src)} groups a block): {ms:.4f} / "
            f"{ms_again:.4f} ms a launch, against its cost-out mode and K11 "
            f"(the parent's composition) {parent_ms:.4f} ms (the cost-out "
            f"mode alone {costout_ms:.4f} ms), plain {plain_ms:.4f} ms, the "
            f"composition it replaced (the window's torch ops and K2's "
            f"sweep form) {comp_ms:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) [{card}]")
        log(f"  K2 stage form, cost-out mode (the tile route's), {form}: "
            f"{costout_ms:.4f} ms, plain {costout_plain_ms:.4f} ms, bound "
            f"{cbound:.4f} ms by {cby} ({cbytes / 1e6:.1f} MB, "
            f"{cops / 1e9:.3f} GFLOP) [{card}]")
        res[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, composition_ms=comp_ms,
                        parent_ms=parent_ms, library_ms=None)
        res[key + "_costout"] = dict(ms=costout_ms,
                                     plain_ms=costout_plain_ms,
                                     bound_ms=cbound, bound_by=cby,
                                     library_ms=None)
        del smap
    # at 5 and 32 views (the views cut and cycled), SA: the selection mode
    # against the parent's composition
    for views in (5, 32):
        dv, idx = cycled_views(d, views)
        outv = torch.empty((views, H * W), device=device)
        smap = torch.empty((H, W, views), dtype=torch.bool, device=device)

        def k2():
            ncc.init_stage_select_fused(dv, st.planes, 0, H * W, st.valid,
                                        params.top_k, cmap, smap, radius=5,
                                        increment=2, use_sa=True)

        def parent():
            ncc.init_stage_fused(dv, st.planes, 0, H * W, outv, radius=5,
                                 increment=2, use_sa=True, view_major=True)
            k11.select_fused(outv, True, st.valid, params.top_k)
        ms = cuda_ms(k2, 20)
        parent_ms = cuda_ms(parent, 20)
        again = cuda_ms(k2, 20)
        info = ncc.stage_kernel_info(True, True, 5, 2, views, True)
        log(f"  K2 stage form with the selection, {views} views, SA, u8: "
            f"{ms:.4f} / {again:.4f} ms a launch ("
            f"{ncc.stage_groups(views)} groups a block, "
            f"{info['blocks_per_sm']} blocks an SM, "
            f"{ncc.stage_smem_bytes(views, 5, 2, True, True)} B shared), "
            f"against the cost-out mode and K11 {parent_ms:.4f} ms "
            f"[{card}]")
        res[f"k2_sa_{views}"] = dict(ms=ms, again_ms=again,
                                     parent_ms=parent_ms)
        del outv, smap, dv
    # K6's re-score form at the APD scan's first WEAK_CHUNK, with the
    # selection over K2's maps and in its cost-out mode; SA windows (the
    # main path's: no anchor of this chunk is valid) and square ones (every
    # existing anchor valid)
    n = min(wx.numel(), init.WEAK_CHUNK)
    cx, cy, ca = wx[:n], wy[:n], wan[:n].contiguous()
    wout = torch.empty((wc.data.num_src, H * W), device=device)
    wmap = torch.empty((H, W), device=device)
    wsel = torch.empty((H, W, wc.data.num_src), dtype=torch.bool,
                       device=device)
    for prm, key, form in ((params, "k6", "SA"), (square, "k6_square",
                                                  "square windows")):
        rk = rescore_kwargs(prm)

        def k6():
            weak.rescore_select_fused(wc.data, wstate.planes,
                                      wstate.selected, wx, wy, wan, 0, n,
                                      wstate.valid, prm.top_k, wmap, wsel,
                                      **rk)

        def k6_costout():
            weak.rescore_fused(wc.data, wstate.planes, wstate.selected, wx,
                               wy, wan, 0, n, wout, view_major=True, **rk)

        def k6_comp():
            wref = WeakRefData.build(wc.data, cx.float(), cy.float(), ca,
                                     wstate.selected, prm)
            flat = cy.long() * W + cx.long()
            return ncc_weak(wc.data, wref,
                            wstate.planes.reshape(-1, 4)[flat], prm)
        ms = cuda_ms(k6, 20)
        costout_ms = cuda_ms(k6_costout, 20)
        ms_again = cuda_ms(k6, 20)
        costout_again = cuda_ms(k6_costout, 20)
        plain_ms = cuda_ms(lambda: weak.rescore_select_plain(
            wc.data, wstate.planes, wstate.selected, cx, cy, ca,
            wstate.valid, prm.top_k, **rk), 2, 1)
        costout_plain_ms = cuda_ms(lambda: weak.rescore_plain(
            wc.data, wstate.planes, wstate.selected, cx, cy, ca, **rk), 2, 1)
        comp_ms = cuda_ms(k6_comp, 10)
        bound, by, nbytes, ops = rescore_bound(wc.data, wstate, prm, cx, cy,
                                               ca)
        cbound, cby, cbytes, cops = rescore_bound(wc.data, wstate, prm, cx,
                                                  cy, ca, select=False)
        old_bound = rescore_bound(wc.data, wstate, prm, cx, cy, ca,
                                  every_anchor=True)[0]
        old_cbound = rescore_bound(wc.data, wstate, prm, cx, cy, ca,
                                   select=False, every_anchor=True)[0]
        valid = int(weak.weak_ref_plain(
            wc.data, cx.float(), cy.float(), ca, wstate.selected,
            prm.strong_radius, prm.strong_increment, prm.weak_radius,
            prm.weak_increment, bool(prm.use_sa)).anchor_valid.sum())
        log(f"  K6 re-score form with the selection, the APD scan's first "
            f"chunk ({n} weak pixels, {wc.data.num_src} views, {form}, u8; "
            f"{valid} valid anchors, {valid / n:.3f} a pixel): {ms:.4f} / "
            f"{ms_again:.4f} ms a launch, the cost-out mode {costout_ms:.4f} "
            f"/ {costout_again:.4f} ms, plain {plain_ms:.4f} ms, the "
            f"composition it replaced (WeakRefData.build and K6's "
            f"weak-sweep form) {comp_ms:.4f} ms, bound {bound:.4f} ms by "
            f"{by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP): "
            f"{100 * bound / ms:.1f}% of it; counting every anchor's window "
            f"(the earlier count) {old_bound:.4f} ms, "
            f"{100 * old_bound / ms:.1f}% [{card}]")
        log(f"  K6 re-score form, cost-out mode (the tile route's), the same "
            f"chunk, {form}: {costout_ms:.4f} ms, plain "
            f"{costout_plain_ms:.4f} ms, bound {cbound:.4f} ms by {cby} "
            f"({cbytes / 1e6:.1f} MB, {cops / 1e9:.3f} GFLOP): "
            f"{100 * cbound / costout_ms:.1f}%; every anchor's window "
            f"{old_cbound:.4f} ms, {100 * old_cbound / costout_ms:.1f}% "
            f"[{card}]")
        res[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, composition_ms=comp_ms, library_ms=None,
                        pixels=n)
        res[key + "_costout"] = dict(ms=costout_ms,
                                     plain_ms=costout_plain_ms,
                                     bound_ms=cbound, bound_by=cby,
                                     library_ms=None)
    # K11 at the full image, 10 views, beside torch.sort and torch.topk
    ncc.init_stage_fused(d, st.planes, 0, H * W, out, radius=5,
                         increment=2, use_sa=True, view_major=True)
    pix_major = out.T.contiguous()
    ms = cuda_ms(lambda: k11.select_fused(out, True, st.valid,
                                          params.top_k), 20)
    pix_ms = cuda_ms(lambda: k11.select_fused(pix_major, False, st.valid,
                                              params.top_k), 20)
    plain_ms = cuda_ms(lambda: k11.select_plain(pix_major, st.valid,
                                                params.top_k), 5)
    sort_ms = cuda_ms(lambda: torch.sort(pix_major, dim=-1), 20)
    lib_ms = cuda_ms(lambda: torch.topk(pix_major, k=params.top_k, dim=-1,
                                        largest=False), 20)
    bound, by, nbytes, ops = k11_bound(H, W, d.num_src)
    log(f"  K11, full image ({d.num_src} views x {H * W} pixels): {ms:.4f} "
        f"ms a launch view-major, {pix_ms:.4f} ms pixel-major (the tile "
        f"route's), plain (the torch ops it replaced, in a fixed sum "
        f"order) {plain_ms:.4f} ms, torch.topk(k={params.top_k}, "
        f"largest=False) of the ({H * W}, {d.num_src}) costs {lib_ms:.4f} "
        f"ms, torch.sort of them {sort_ms:.4f} ms, bound {bound:.4f} ms by "
        f"{by} ({nbytes / 1e6:.1f} MB) [{card}]")
    res["k11"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      library_ms=lib_ms)
    res["k11_extra"] = dict(pixel_major_ms=pix_ms, sort_ms=sort_ms)
    # the whole stage against the composition it replaced
    for key, args, what in (
            ("stage_round0", (d, st, square), "full image u8, square "
             "(a round-0 pass's)"),
            ("stage_real", (rdata, rstate, rparams, rx, ry, ran),
             f"a real APD REFINE_INIT pass's ({rx.numel()} weak pixels, "
             "SA)")):
        ms = cuda_ms(lambda: init.initial_cost(*args), 10)
        comp_ms = cuda_ms(lambda: init_composition(*args), 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            init.initial_cost(*args)
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            init_composition(*args)
        comp_host_ms = (time.perf_counter() - t0) / 5 * 1e3
        torch.cuda.synchronize()
        log(f"  the initial cost, {what}: {ms:.4f} ms a call (host "
            f"{host_ms:.4f} ms), the composition it replaced "
            f"(testing.init_composition) {comp_ms:.4f} ms (host "
            f"{comp_host_ms:.4f} ms) [{card}]")
        res[key] = dict(ms=ms, host_ms=host_ms, composition_ms=comp_ms,
                        composition_host_ms=comp_host_ms)
    res["max_abs_err"] = max(errs)
    log(f"initial-cost phase {time.perf_counter() - t_phase:.1f} s")
    return res


def sync_phase(rp, card: str) -> dict:
    """The synchronising CUDA calls (``torch.cuda.set_sync_debug_mode``) of
    real passes, by stage and call site: first the APD pass's iteration
    loop (``full_pass._iterations``; ``rp``:
    ``tools.kernel_times.real_pass_inputs``) with each fit reading the
    reference camera from the card, as K9's wrapper did before the camera
    was read once a pass ("before": the check must see those reads); then
    the whole APD REFINE_INIT pass and a whole FIRST_INIT pass of the same
    view (round 0's first pass), each call put under the innermost of the
    stages sweeps (its iteration loop apart), classify and refine, or the
    pass, the initial cost (``init.initial_cost``) under a label of its
    own. Fails if a fit in the loop still reads the camera, if any
    synchronising call comes from ``core/sampling.py``, if the classify or
    the refine stage makes more than one (its ``nonzero``), or if the
    initial cost makes any."""
    import collections
    import traceback
    import warnings

    import torch

    from apde_mvs_tpu_torch import config as cfg
    from apde_mvs_tpu_torch.ops import init as init_ops
    from apde_mvs_tpu_torch.pipeline import full_pass, patchmatch
    log("==== synchronising calls in real passes, by stage ====")
    port = REPO / "apde_mvs_tpu_torch"
    wrapped = {"pass_sweeps": "sweeps", "_iterations": "iterations",
               "pass_classify": "classify", "pass_finish": "refine"}
    saved = {name: getattr(full_pass, name) for name in wrapped}
    stack = ["pass"]
    calls = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if Path(f.filename).resolve().is_relative_to(port)]
        f = frames[-1] if frames else None
        site = (f"{Path(f.filename).resolve().relative_to(REPO)}:"
                f"{f.lineno} {f.name}" if f else f"{filename}:{lineno}")
        calls[(stack[-1], site)] += 1

    def staged(name, label, camera=True):
        inner = saved[name]

        def run(*args, **kwargs):
            if not camera:     # _iterations(..., cam, gen, shard)
                args = args[:5] + (None,) + args[6:]
            stack.append(label)
            try:
                return inner(*args, **kwargs)
            finally:
                stack.pop()
        return run

    initial_cost = init_ops.initial_cost

    def init_staged(*args, **kwargs):
        stack.append("initial_cost")
        try:
            return initial_cost(*args, **kwargs)
        finally:
            stack.pop()

    def watched(params, prior, camera=True):
        calls.clear()
        for name, label in wrapped.items():
            setattr(full_pass, name,
                    staged(name, label, camera or name != "_iterations"))
        init_ops.initial_cost = init_staged
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                patchmatch.run_patchmatch(rp.data, params,
                                          depth_min=rp.depth_min,
                                          depth_max=rp.depth_max, seed=1,
                                          **prior)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                for name, fn in saved.items():
                    setattr(full_pass, name, fn)
                init_ops.initial_cost = initial_cost
        return dict(calls)

    first = cfg.build_schedule(max(rp.data.height, rp.data.width),
                               "General", base=APD_BASE)[0].params
    runs = {"before": watched(rp.params, rp.prior, camera=False),
            "apd": watched(rp.params, rp.prior),
            "first_init": watched(first, {})}
    res = {}
    for label, got in runs.items():
        by_stage = collections.Counter()
        for (stage, site), n in got.items():
            by_stage[stage] += n
        res[label] = dict(
            stages=dict(by_stage),
            sites={f"{stage}: {site}": n for (stage, site), n in got.items()},
            camera=sum(n for (stage, site), n in got.items()
                       if stage == "iterations"
                       and site.endswith(" camera")),
            sampling=sum(n for (stage, site), n in got.items()
                         if "core/sampling.py" in site))
        log(f"  {label}: {sum(got.values())} synchronising calls, by stage "
            f"{json.dumps(dict(by_stage), sort_keys=True)}: " + "; ".join(
                f"{stage}: {site} x{n}"
                for (stage, site), n in sorted(got.items())))
    iters = rp.params.max_iterations
    if res["apd"]["camera"]:
        raise AssertionError("a fit in the APD iteration loop still reads "
                             "the reference camera from the card")
    if res["before"]["camera"] < iters:
        raise AssertionError("the sync check did not see a fit's camera "
                             "read")
    for label in ("apd", "first_init"):
        if res[label]["sampling"]:
            raise AssertionError(f"{label} pass: {res[label]['sampling']} "
                                 "synchronising calls from core/sampling.py")
        for stage in ("classify", "refine"):
            n = res[label]["stages"].get(stage, 0)
            if n > 1:
                raise AssertionError(f"{label} pass: the {stage} stage makes "
                                     f"{n} synchronising calls, more than "
                                     "its nonzero")
        n = res[label]["stages"].get("initial_cost", 0)
        if n:
            raise AssertionError(f"{label} pass: the initial cost makes {n} "
                                 "synchronising calls")
    loop = res["apd"]["stages"].get("iterations", 0)
    log(f"  K9's camera: read once a pass, none in the loop; the APD loop's "
        f"{iters} iterations {loop} synchronising calls, none from "
        f"core/sampling.py in either pass, the classify and refine stages "
        f"at most one each, the initial cost none [{card}]")
    return res


class Tee(io.TextIOBase):
    """Stdout that is also kept: what an entry point prints is shown as it
    comes and parsed afterwards."""

    def __init__(self):
        self.buf = io.StringIO()

    def write(self, s):
        sys.__stdout__.write(s)
        return self.buf.write(s)

    def flush(self):
        sys.__stdout__.flush()


def run_main(main, argv) -> str:
    """Call an entry point's ``main(argv)`` in this process; raises unless
    it returns 0. Returns what it printed."""
    import torch
    tee = Tee()
    with contextlib.redirect_stdout(tee):
        rc = main([str(a) for a in argv])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{main.__module__}.main returned {rc}")
    return tee.buf.getvalue()


def depth_errors(scene, root: Path) -> list:
    """Median relative depth error of each view's depths.bin against the
    scene's ground truth; raises at 1% or more."""
    import numpy as np

    from apde_mvs_tpu_torch.io import binmat
    errs = []
    for v in range(scene.num_views):
        d = binmat.read_bin_mat(root / "APD" / f"{v:08d}" / "depths.bin")
        gt = scene.depths[v]
        ok = (d > 0) & (gt > 0)
        errs.append(float(np.median(np.abs(d - gt)[ok] / gt[ok])))
    log(f"median relative depth error per view: "
        f"{', '.join(f'{e:.5f}' for e in errs)}")
    if not max(errs) < 0.01:
        raise AssertionError(f"median relative depth error {max(errs)} "
                             ">= 1%")
    return errs


def coloured_points(ply: Path, what: str) -> int:
    """Point count of a fused PLY; raises unless it has more than 1000
    points, each with a colour."""
    from apde_mvs_tpu_torch.io.ply import read_ply
    pts, cols = read_ply(ply)
    log(f"{what}: {len(pts)} points, colours "
        f"{'yes' if cols is not None else 'no'}")
    if len(pts) <= 1000 or cols is None or len(cols) != len(pts):
        raise AssertionError(f"{what}: too few coloured points")
    return len(pts)


def reset_counts() -> None:
    from apde_mvs_tpu_torch.ops.cuda import anchors as kern
    from apde_mvs_tpu_torch.ops.cuda import (ncc, sampler, select, strong,
                                             sweep, weak, weak_sweep)
    for mod in (sampler, ncc, strong, sweep, weak, weak_sweep, select, kern):
        mod.reset_launches()


def read_counts() -> dict:
    """Every kernel's launches since the last reset, in this process: K1's
    and K2's by call site, K3's with the colour updates they served, K5's
    by mode, K6's with the planes a pixel they evaluated, K7's with the
    weak-sweep chunks they updated, K11's, and the APD setup's K8, K9 and
    K10."""
    from apde_mvs_tpu_torch.ops.cuda import anchors as kern
    from apde_mvs_tpu_torch.ops.cuda import (ncc, sampler, select, strong,
                                             sweep, weak, weak_sweep)
    return dict(k1=sampler.launches, sites=dict(sampler.site_launches),
                k2=ncc.launches, k2_sites=dict(ncc.site_launches),
                k5=sweep.launches, k5_modes=dict(sweep.mode_launches),
                k3=strong.launches, k3_colours=strong.colours,
                k3_sa=strong.sa_launches, k6=weak.launches,
                k6_planes=weak.planes, k7=weak_sweep.launches,
                k7_chunks=weak_sweep.chunks, k11=select.launches,
                k8=kern.anchor_launches, k9=kern.fit_launches,
                k10=kern.jfa_launches)


def parsed_counts(match) -> dict:
    """``read_counts``'s dict from one LAUNCH_RE match of an engine's log;
    raises where the line lacks K6's, K7's, K11's or the anchor kernels'
    counts."""
    if not match[10] or not match[12] or not match[14] or not match[15]:
        raise AssertionError(f"engine launch line without K6's, K7's, K11's "
                             f"or the anchor kernels' counts: {match}")
    return dict(k1=int(match[0]), sites=json.loads(match[1]),
                k2=int(match[2]), k2_sites=json.loads(match[3]),
                k5=int(match[4]), k5_modes=json.loads(match[5]),
                k3=int(match[6]), k3_colours=int(match[7]),
                k6=int(match[10]), k6_planes=int(match[11]),
                k7=int(match[12]), k7_chunks=int(match[13]),
                k11=int(match[14]), k10=int(match[15]), k8=int(match[16]),
                k9=int(match[17]))


# K2's: the initial cost and the debug tool; the strong sweep runs in K3, the
# classify and refine sweeps in K5, and K2 launched for either would count
# under another site ("strong", "other")
K2_SITES = ("init", "debug_point")
# K3 launches a colour update may take at most (it takes one)
K3_LAUNCHES_A_COLOUR = 2
# K7 launches a weak-sweep chunk may take at least (it takes one); K6 is
# launched only for the initial cost's re-score, one plane a chunk: its
# candidate and probe forms run inside K7
K7_LAUNCHES_A_CHUNK = 1


def k6_chunks(c: dict) -> tuple:
    """(weak-sweep chunks, re-score chunks) in a count: K7's chunks, and
    K6's launches where each evaluated one plane a pixel; None where K7
    took fewer than K7_LAUNCHES_A_CHUNK launches a chunk or K6 evaluated
    more than one plane in a launch."""
    if c["k6_planes"] != c["k6"] \
            or c["k7"] < K7_LAUNCHES_A_CHUNK * c["k7_chunks"]:
        return None
    return c["k7_chunks"], c["k6"]


def k2_elsewhere(k2_sites: dict) -> int:
    """K2 launches at any site but the initial cost's and the debug tool's
    in a by-site count: a strong, classify or refine sweep that reached K2
    (check_counts holds them at 0)."""
    return sum(n for site, n in k2_sites.items() if site not in K2_SITES)


@contextlib.contextmanager
def counted_k10_calls():
    """Counts the K10 calls of the main path run inside: the calls of
    ``ops.anchors.nearest_strong_jfa`` (the APD setup's and the anchor
    exports'), each with the K10 launches it made by the wrapper's count.
    Yields the list of launches a call."""
    from apde_mvs_tpu_torch.ops import anchors as anc
    from apde_mvs_tpu_torch.ops.cuda import anchors as kern
    fn = anc.nearest_strong_jfa
    calls = []

    def counted(*args, **kwargs):
        before = kern.jfa_launches
        out = fn(*args, **kwargs)
        calls.append(kern.jfa_launches - before)
        return out
    anc.nearest_strong_jfa = counted
    try:
        yield calls
    finally:
        anc.nearest_strong_jfa = fn


@contextlib.contextmanager
def counted_stage_calls():
    """Counts, for each ``filters.depth_to_weak`` and ``filters.local_refine``
    call of the main path run inside, K5's launches in the call and every
    torch op it dispatched (a ``TorchDispatchMode``) but the output's
    allocation. Yields the list of (name, launches, other ops)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from apde_mvs_tpu_torch.ops import filters
    from apde_mvs_tpu_torch.ops.cuda import sweep

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    calls = []
    saved = {name: getattr(filters, name)
             for name in ("depth_to_weak", "local_refine")}

    def counted(name, fn):
        def run(*args, **kwargs):
            before = sweep.launches
            with Ops() as mode:
                out = fn(*args, **kwargs)
            calls.append((name, sweep.launches - before,
                          [op for op in mode.ops
                           if not op.startswith("aten.empty")]))
            return out
        return run
    for name, fn in saved.items():
        setattr(filters, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(filters, name, fn)


@contextlib.contextmanager
def counted_init_calls():
    """Counts, for each ``init.initial_cost`` call of the main path run
    inside, the launches of K2's stage form (K2 at site "init"), of K6 and
    of K11 in the call, the weak list's length and every torch op it
    dispatched (a ``TorchDispatchMode``) but the outputs' allocations.
    Yields the list of (K2, K6, K11 launches, weak pixels, other ops)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from apde_mvs_tpu_torch.ops import init
    from apde_mvs_tpu_torch.ops.cuda import ncc, weak
    from apde_mvs_tpu_torch.ops.cuda import select as k11

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    calls = []
    fn = init.initial_cost

    def run(*args, **kwargs):
        before = (ncc.site_launches.get("init", 0), weak.launches,
                  k11.launches)
        with Ops() as mode:
            out = fn(*args, **kwargs)
        n = args[3].numel() if len(args) > 3 and args[3] is not None else 0
        calls.append((ncc.site_launches.get("init", 0) - before[0],
                      weak.launches - before[1], k11.launches - before[2],
                      n, [op for op in mode.ops
                          if not op.startswith("aten.empty")]))
        return out
    init.initial_cost = run
    try:
        yield calls
    finally:
        init.initial_cost = fn


def init_calls_ok(c: dict) -> bool:
    """Every initial-cost call of a path (the serial route): one launch of
    K2's stage form, one K6 launch a WEAK_CHUNK of its weak list, each with
    the selection in its epilogue, no K11 launch and no torch op but the
    outputs' allocations; at least one call."""
    from apde_mvs_tpu_torch.ops.init import WEAK_CHUNK
    calls = c.get("init_calls", [])
    return bool(calls) and all(
        (k2, k6, k11) == (1, -(-n // WEAK_CHUNK), 0) and not ops
        for k2, k6, k11, n, ops in calls)


def stage_calls_ok(c: dict) -> bool:
    """Every classify and refine call of a path: one K5 launch and no torch
    op but the output's allocation; at least one of each."""
    calls = c.get("stage_calls", [])
    names = {name for name, _, _ in calls}
    return names == {"depth_to_weak", "local_refine"} and all(
        n == 1 and not ops for _, n, ops in calls)


def k10_calls_ok(c: dict) -> bool:
    """A weak path's K10 launches: at least one call, each call with the
    launches K10_A_CALL measured (one count there), and they sum to the
    path's K10 count."""
    calls = c.get("k10_calls", [])
    return bool(calls) and len(set(K10_A_CALL)) == 1 \
        and set(calls) == set(K10_A_CALL) and sum(calls) == c["k10"]


def check_counts(what: str, c: dict, passes: bool = True,
                 weak: bool = False, tile: bool = False) -> None:
    """The initial cost's NCC went through K2 (at least one launch, every
    one at the initial cost's or the debug tool's site, none at the strong
    sweep's), K1 launched at no site, the disparity sweeps through K5 (at
    least one classify launch, and on a path that runs a pass at least one
    refine launch), on a path that runs a pass the strong sweep through K3
    (at least one launch, at most K3_LAUNCHES_A_COLOUR a colour update),
    the weak sweep through K7 (at least one launch a weak-sweep chunk) and
    the initial cost's re-score through K6 (one plane a launch), at least
    one of each on a ``weak`` path (one that runs APD passes), whose APD
    setup must launch K10 (in ``c["k10_calls"]`` calls, each with the
    launches ``anchor_kernel_phase`` counted a call, K10_A_CALL), K8 and
    K9, which no other path launches; the selection K11 on no path but
    the tile route's (``tile``), there once an initial cost (as many
    launches as K2 has at the initial cost's site), since the other
    routes select in K2's and K6's epilogues; where the path's
    initial-cost calls were counted in-process (``c["init_calls"]``) each
    call one launch of K2's stage form, one K6 launch a WEAK_CHUNK of its
    weak list, no K11 launch and no other torch op; each kernel's launches
    add up over its sites or modes."""
    split = k6_chunks(c)
    ok = c["k2"] > 0 and c["k1"] == 0 and not c["sites"] \
        and split is not None \
        and sum(c["k2_sites"].values()) == c["k2"] \
        and set(c["k2_sites"]) <= set(K2_SITES) \
        and c["k2_sites"].get("strong", 0) == 0 \
        and sum(c["k5_modes"].values()) == c["k5"] \
        and c["k5_modes"].get("classify", 0) > 0
    if passes:
        ok = ok and c["k5_modes"].get("refine", 0) > 0 \
            and c["k3"] > 0 and c["k3_colours"] > 0 \
            and c["k3"] <= K3_LAUNCHES_A_COLOUR * c["k3_colours"]
    if "stage_calls" in c:
        ok = ok and stage_calls_ok(c)
    if "init_calls" in c:
        ok = ok and init_calls_ok(c)
    if tile:
        # the tile route's selection K11: one launch an initial cost
        ok = ok and c["k11"] > 0 and c["k11"] == c["k2_sites"].get("init", 0)
    else:
        ok = ok and c["k11"] == 0
    if weak:
        ok = ok and min(split) > 0 and c["k8"] > 0 and c["k9"] > 0 \
            and k10_calls_ok(c)
    else:
        ok = ok and c["k8"] == c["k9"] == c["k10"] == 0
    if not ok:
        raise AssertionError(f"{what}: launches {json.dumps(c)}")


def counts_line(c: dict) -> str:
    split = k6_chunks(c)
    k10_in = f" in {len(c['k10_calls'])} calls" if "k10_calls" in c else ""
    return (f"K2 launches {c['k2']} by site "
            f"{json.dumps(c['k2_sites'], sort_keys=True)}, K3 launches "
            f"{c['k3']} for {c['k3_colours']} colour updates, K5 launches "
            f"{c['k5']} by mode {json.dumps(c['k5_modes'], sort_keys=True)}, "
            f"K7 launches {c['k7']} for {c['k7_chunks']} weak-sweep chunks, "
            f"K6 launches {c['k6']} for {c['k6_planes']} planes ("
            f"{split[1] if split else '?'} re-score chunks), K11 launches "
            f"{c['k11']}, K10 launches "
            f"{c['k10']}{k10_in}, K8 launches {c['k8']}, K9 launches "
            f"{c['k9']}, K1 "
            f"launches {c['k1']} by site "
            f"{json.dumps(c['sites'], sort_keys=True)}")


def scan_phase(label: str, cli_args, scene, root: Path, n_passes: int,
               card: str, weak: bool = False) -> dict:
    """The port's CLI on the card over the written scan; checks the pass
    count, depth error against ground truth, the fused PLY, and every
    kernel's launches (``check_counts``; ``weak``: the scan runs APD
    passes)."""
    import torch

    from apde_mvs_tpu_torch.cli import apd

    log(f"==== {label} ====")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with counted_k10_calls() as k10_calls, \
            counted_stage_calls() as stage_calls, \
            counted_init_calls() as init_calls:
        text = run_main(apd.main, ["--dense_folder", root, "--dataset",
                                   "General"] + list(cli_args))
    wall = time.perf_counter() - t0
    c = dict(read_counts(), k10_calls=k10_calls, stage_calls=stage_calls,
             init_calls=init_calls)
    passes = [ln for ln in text.splitlines() if ln.startswith("Pass ")]
    fusion = [ln for ln in text.splitlines() if ln.startswith("Fusion wall")]
    if len(passes) != n_passes:
        raise AssertionError(f"expected {n_passes} passes, saw {passes}")
    errs = depth_errors(scene, root)
    points = coloured_points(root / "APD" / "APD.ply", "fused PLY")
    check_counts(label, c, weak=weak)
    log(f"{label}: {wall:.3f} s wall, {counts_line(c)} [{card}]")
    by_name = {}
    for name, n, ops in stage_calls:
        by_name.setdefault(name, []).append((n, len(ops)))
    log(f"  K5 a classify / refine call: " + "; ".join(
        f"{name} {len(v)} calls, K5 launches a call {sorted({n for n, _ in v})}"
        f", other torch ops a call {sorted({k for _, k in v})}"
        for name, v in sorted(by_name.items())))
    log(f"  the initial cost: {len(init_calls)} calls, (K2 stage, K6, K11) "
        f"launches and weak pixels a call "
        f"{sorted({(a, b, k, n) for a, b, k, n, _ in init_calls})}, other "
        f"torch ops a call {sorted({len(ops) for *_, ops in init_calls})}")
    for ln in passes + fusion:
        log(f"  {ln} [{card}]")
    return dict(c, wall_s=wall, errors=errs, points=points, passes=passes,
                fusion=fusion, text=text)


def write_sa_masks(scene, root: Path) -> None:
    """One segment mask per view: the weak plane is segment 1, the rest 0."""
    import numpy as np

    from apde_mvs_tpu_torch.io import binmat
    (root / "sa_masks").mkdir()
    for v in range(scene.num_views):
        binmat.write_bin_mat(root / "sa_masks" / f"{v:08d}.bin",
                             weak_region(scene.depths[v]).astype(np.uint8))


def apd_checks(scan: dict, root: Path, num_views: int, card: str) -> float:
    """What the APD scan must show beyond a scan's checks: weak pixels in
    round 1 (K6's launches are ``check_counts``'). Returns the final weak
    fraction over all views."""
    import numpy as np

    from apde_mvs_tpu_torch.config import WEAK
    from apde_mvs_tpu_torch.io import binmat
    counts = [int(ln.split()[2]) for ln in scan["text"].splitlines()
              if ln.startswith("Weak count:")]
    if len(counts) != 4 * num_views or min(counts[:num_views]) <= 0:
        raise AssertionError(f"round-1 weak counts {counts}")
    weak = [binmat.read_bin_mat(root / "APD" / f"{v:08d}" / "weak.bin")
            for v in range(num_views)]
    frac = float(np.mean([np.mean(w == WEAK) for w in weak]))
    log(f"APD scan: weak count at REFINE_INIT per view "
        f"{counts[:num_views]}, final weak fraction {frac:.4f} [{card}]")
    return frac


def fusion_phase(root: Path, prof_dir: Path, card: str) -> dict:
    """Fusion variants on the APD scan's bins through the CLI: General,
    TaT_i, TaT_a, then shards 0 and 1 of 2 (shard 0 under --profile_dir)
    and their merge. Checks the point counts, the merge against General
    (within 5%, the JAX package's bar, tests/test_fusion.py:106) and that
    the trace holds CUDA kernel events."""
    from apde_mvs_tpu_torch.cli import apd
    from apde_mvs_tpu_torch.io.ply import read_ply

    log("==== fusion variants on the APD scan's bins ====")
    base = ["--dense_folder", root, "--only_fuse", "true"]

    def wall_of(text):
        return float(next(ln for ln in text.splitlines()
                          if ln.startswith("Fusion wall")).split()[2])
    out = {}
    for ds in ("General", "TaT_i", "TaT_a"):
        text = run_main(apd.main, base + ["--dataset", ds])
        n = coloured_points(root / "APD" / "APD.ply", f"{ds} fusion")
        out[ds] = dict(points=n, wall_s=wall_of(text))
        log(f"  {ds}: {n} points, Fusion wall {out[ds]['wall_s']:.3f} s "
            f"[{card}]")
    parts = []
    for i in range(2):
        extra = ["--profile_dir", prof_dir] if i == 0 else []
        text = run_main(apd.main, base + ["--dataset", "General",
                                          "--fuse_shard", f"{i},2"] + extra)
        pts, _ = read_ply(root / "APD" / f"APD.ply.part{i}of2")
        parts.append(dict(points=len(pts), wall_s=wall_of(text)))
        log(f"  shard {i} of 2: {len(pts)} points, Fusion wall "
            f"{parts[-1]['wall_s']:.3f} s{' (profiled)' if i == 0 else ''} "
            f"[{card}]")
    t0 = time.perf_counter()
    run_main(apd.main, ["--dense_folder", root, "--merge_fusion", "2"])
    merge_s = time.perf_counter() - t0
    merged = coloured_points(root / "APD" / "APD.ply", "merged shards")
    general = out["General"]["points"]
    log(f"  merge: {merged} points in {merge_s:.3f} s, unsharded General "
        f"{general} ({(merged - general) / general * 100:+.2f}%) [{card}]")
    if not abs(merged - general) < 0.05 * general:
        raise AssertionError(f"merged shards {merged} not within 5% of "
                             f"General {general}")
    traces = sorted(prof_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"expected one profiler trace, got {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"  profiler trace {traces[0].name}: "
        f"{traces[0].stat().st_size / 1e6:.1f} MB, {len(events)} events, "
        f"{len(kernels)} CUDA kernel events")
    if not kernels:
        raise AssertionError("the profiler trace holds no CUDA kernel event")
    traces[0].unlink()
    return dict(variants=out, shards=parts, merged=merged, merge_s=merge_s,
                kernel_events=len(kernels))


EXPORTS = ("anchors.bin", "anchors_map.bin", "reliable_curve.bin",
           "nearest_strong_7.png", "fit_normal_7.png")


def exports_phase(root: Path, num_views: int, seed: int, out_dir: Path,
                  card: str) -> dict:
    """The APD scan's last pass (iteration 7) again with both debug exports;
    checks every view's five files and the curve's shape, deletes the
    curves (117 MB a view), then renders one weak pixel's anchors with
    tools.anchor_vis and inspects it with tools.debug_point on the card."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch.cli import apd
    from apde_mvs_tpu_torch.io import binmat
    from apde_mvs_tpu_torch.tools import anchor_vis, debug_point

    log("==== debug exports: the APD scan's last pass again ====")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with counted_k10_calls() as k10_calls:
        text = run_main(apd.main, [
            "--dense_folder", root, "--dataset", "General", "--seed", seed,
            "--pyramid_base", APD_BASE, "--start_iteration", 7,
            "--export_anchor", "true", "--export_curve", "true",
            "--no_fuse", "true"])
    wall = time.perf_counter() - t0
    c = dict(read_counts(), k10_calls=k10_calls)
    passes = [ln for ln in text.splitlines() if ln.startswith("Pass ")]
    weak = [int(ln.split()[2]) for ln in text.splitlines()
            if ln.startswith("Weak count:")]
    if len(passes) != 1 or len(weak) != num_views:
        raise AssertionError(f"exports pass: {passes}, weak counts {weak}")
    check_counts("exports pass", c, weak=True)
    for v in range(num_views):
        rf = root / "APD" / f"{v:08d}"
        missing = [n for n in EXPORTS if not (rf / n).is_file()]
        if missing:
            raise AssertionError(f"view {v} (weak count {weak[v]}) lacks "
                                 f"{missing}")
        curve = rf / "reliable_curve.bin"
        with open(curve, "rb") as f:
            head = np.frombuffer(f.read(12), np.int32).tolist()
        if head != [WIDTH, HEIGHT, 61] or curve.stat().st_size \
                != 12 + WIDTH * HEIGHT * 61 * 4:
            raise AssertionError(f"view {v}: curve header {head}, "
                                 f"{curve.stat().st_size} bytes")
        amap = binmat.read_bin_mat(rf / "anchors_map.bin")
        if anchor_vis.read_anchors(rf / "anchors.bin").shape[0] != weak[v] \
                or int((amap >= 0).sum()) != weak[v]:
            raise AssertionError(f"view {v}: anchors do not match the "
                                 f"weak count {weak[v]}")
        curve.unlink()
    log(f"exports pass: {passes[0]}, {wall:.3f} s wall, weak counts "
        f"{weak}; {counts_line(c)}; all five files on every view, curves "
        f"(H, W, 61) f32 checked and deleted [{card}]")

    rf = root / "APD" / "00000000"
    amap = binmat.read_bin_mat(rf / "anchors_map.bin")
    anchors = anchor_vis.read_anchors(rf / "anchors.bin")
    reliable = np.nonzero((anchors[:, 1:, 0] >= 0).any(-1))[0]
    if len(reliable) == 0:
        raise AssertionError("view 0 has no weak pixel with anchors")
    y, x = (int(c[0]) for c in np.nonzero(amap == reliable[0]))
    overlay = out_dir / "anchor_overlay.png"
    run_main(anchor_vis.main, ["--result_folder", rf, "--point",
                               f"{x},{y}", "--out", overlay])
    if not overlay.is_file():
        raise AssertionError("anchor_vis wrote no overlay")
    reset_counts()
    text = run_main(debug_point.main, [
        "--dense_folder", root, "--view", 0, "--point", f"{x},{y}",
        "--device", "cuda", "--geom"])
    dp = read_counts()
    curve_line = text.splitlines()[[i for i, ln in enumerate(
        text.splitlines()) if "reliability curve" in ln][0] + 1]
    if len(curve_line.split()) != 61:
        raise AssertionError(f"debug_point: curve {curve_line!r}")
    check_counts("debug_point", dp, passes=False)
    log(f"debug_point at ({x}, {y}) of view 0: {counts_line(dp)}")
    return dict(c, wall_s=wall, pass_line=passes[0], weak=weak,
                debug_point=dp)


def batch_phase(scene, tmp: Path, card: str) -> dict:
    """An ETH3D-layout scan through tools.eth3d_train in a subprocess
    (conversion, cli.run, whose pool worker starts the port's engine CLI on
    the card), then tools.collect. cli.run does not report the engine's
    exit status, so the engine's log, depths and cloud are checked."""
    from apde_mvs_tpu_torch.testing import eth3d_fixture
    from apde_mvs_tpu_torch.tools import collect

    log("==== batch path: ETH3D layout -> eth3d_train -> cli.run -> "
        "engine ====")
    raw, work = tmp / "ETH3D_raw", tmp / "ETH3D_work"
    t0 = time.perf_counter()
    eth3d_fixture.write_eth3d_scan(scene, str(raw), "drill_scan")
    log(f"fixture written in {time.perf_counter() - t0:.1f} s")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [v for v in [env.get("PYTHONPATH")] if v])
    cmd = [sys.executable, "-m", "apde_mvs_tpu_torch.tools.eth3d_train",
           "--eth3d_dir", str(raw), "--work_dir", str(work), "--skip_eval",
           "--", "--no_sam"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    for ln in proc.stdout.splitlines()[-12:]:
        log(f"  | {ln}")
    if proc.returncode != 0:
        raise RuntimeError(f"eth3d_train exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    scan = work / "drill_scan"
    text = (scan / "APD" / "log.txt").read_text()
    passes = [ln for ln in text.splitlines() if ln.startswith("Pass ")]
    fusion = [ln for ln in text.splitlines() if ln.startswith("Fusion wall")]
    counts = LAUNCH_RE.findall(text)
    if len(passes) != 4 or len(fusion) != 1 or len(counts) != 1 \
            or "dataset       : ETH3D" not in text:
        raise AssertionError(f"engine log: passes {passes}, fusion {fusion}"
                             f", launches {counts}\n{text[-3000:]}")
    c = parsed_counts(counts[0])
    check_counts("batch engine", c)
    errs = depth_errors(scene, scan)
    points = coloured_points(scan / "APD" / "APD.ply", "batch fused PLY")
    out = tmp / "collected"
    run_main(collect.main, ["eth", "--data_dir", work, "--out_dir", out])
    if (out / "drill_scan.ply").read_bytes() \
            != (scan / "APD" / "APD.ply").read_bytes():
        raise AssertionError("collect did not copy the fused cloud")
    log(f"batch path: {wall:.3f} s for the eth3d_train subprocess; engine "
        f"{counts_line(c)} [{card}]")
    for ln in passes + fusion:
        log(f"  {ln} [{card}]")
    return dict(c, wall_s=wall, passes=passes, fusion=fusion, errors=errs,
                points=points)


KERNEL_MODULES = {"K1": "sampler", "K2": "ncc", "K3": "strong",
                  "K5": "sweep", "K6": "weak", "K7": "weak_sweep",
                  "K8-K10": "anchors", "K11": "select"}


def build_race(card: str) -> dict:
    """Build each kernel library from this checkout in RANKS processes,
    all started together (one nvcc a source in parallel, and two ranks of
    a fresh torchrun racing for each: `ops/cuda/build.py` compiles to a
    per-process temporary file, then renames it into place); each must
    load its library. Returns each process's nvcc seconds by kernel."""
    from apde_mvs_tpu_torch.ops.cuda import build as kbuild
    existing = sorted(kbuild.BUILD_DIR.glob("lib*.so")) \
        if kbuild.BUILD_DIR.exists() else []
    procs = [(k, subprocess.Popen(
        [sys.executable, "-c", f"from apde_mvs_tpu_torch.ops.cuda import "
         f"{mod}; print({mod}.library().seconds)"], cwd=REPO,
        env=repo_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for k, mod in KERNEL_MODULES.items()
        for _ in range(RANKS)]
    secs = {k: [] for k in KERNEL_MODULES}
    for k, p in procs:
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"{k} build in a rank-like process exited "
                               f"{p.returncode}:\n{err[-4000:]}")
        secs[k].append(float(out.split()[-1]))
    log(f"{', '.join(KERNEL_MODULES)} built by {RANKS} processes each, all "
        f"at once: nvcc "
        f"{secs} s "
        f"({'a library existed' if existing else 'fresh build'}); "
        f"{len(list(kbuild.BUILD_DIR.glob('lib*.so')))} library "
        f"file(s), no temporary left: "
        f"{not list(kbuild.BUILD_DIR.glob('*.tmp'))} [{card}]")
    if list(kbuild.BUILD_DIR.glob("*.tmp")):
        raise AssertionError("a build left its temporary file")
    return secs


def kernel_report(card: str) -> None:
    """A diagnostic: the main path's K2, K3, K5, K6 and K7 instantiations
    (u8 tables, 36-tap square and SA star windows, 10 views; K6's and K7's
    36-tap centre and 9-tap anchor windows with SA weights and the
    geometric cost, and without either) with their registers, local-memory
    (spill) bytes and resident blocks an SM from the CUDA runtime, and each
    of the five libraries' SASS instructions a window tap by opcode class
    (``tools/sass_taps.py``: static instructions of the tap loop, the
    divisions' slow-path calls included; K6's 9-tap anchor windows unroll
    whole and have no loop), or a note where ``cuobjdump`` is missing."""
    from apde_mvs_tpu_torch.ops.cuda import (ncc, strong, sweep, weak,
                                             weak_sweep)
    from apde_mvs_tpu_torch.tools import sass_taps
    kernels = (("K2", ncc), ("K3", strong), ("K5", sweep), ("K6", weak),
               ("K7", weak_sweep))
    for form, sa in (("SA weights, geometric cost", True),
                     ("square, no geometric cost", False)):
        for name, info in (
                ("K6", weak.kernel_info(True, sa, sa, 36, 9,
                                        FULL_VIEWS - 1)),
                ("K7", weak_sweep.kernel_info(True, sa, sa,
                                              FULL_VIEWS - 1))):
            log(f"{name} u8, {form}, 36 + 8 x 9 taps, {FULL_VIEWS - 1} "
                f"views: {info['regs']} registers, {info['local_bytes']} B "
                f"local (spills), {info['blocks_per_sm']} resident blocks "
                f"an SM [{card}]")
    for name, mod in kernels[:3]:
        for form, sa in (("square", False), ("SA star", True)):
            # K3 builds its window (radius 5, increment 2) itself
            info = strong.kernel_info(True, sa, 5, 2, FULL_VIEWS - 1) \
                if mod is strong else mod.kernel_info(True, sa, sa, 36,
                                                      FULL_VIEWS - 1)
            log(f"{name} u8, {form} window, 36 taps, {FULL_VIEWS - 1} views: "
                f"{info['regs']} registers, {info['local_bytes']} B local "
                f"(spills), {info['blocks_per_sm']} resident blocks an SM "
                f"[{card}]")
            if mod is sweep:
                info = sweep.stage_kernel_info(True, sa, 36, FULL_VIEWS - 1)
                log(f"K5 stage form u8, {form} window, 36 taps, "
                    f"{FULL_VIEWS - 1} views: {info['regs']} registers, "
                    f"{info['local_bytes']} B local (spills), "
                    f"{info['blocks_per_sm']} resident blocks an SM [{card}]")
    # the initial cost's stage forms and K11
    from apde_mvs_tpu_torch.ops.cuda import select
    for form, sa in (("square", False), ("SA star", True)):
        for views, select_mode in ((FULL_VIEWS - 1, True),
                                   (APD_VIEWS - 1, True),
                                   (FULL_VIEWS - 1, False)):
            info = ncc.stage_kernel_info(True, sa, 5, 2, views, select_mode)
            smem = ncc.stage_smem_bytes(views, 5, 2, sa, select_mode)
            log(f"K2 stage form u8, "
                f"{'with the selection' if select_mode else 'cost-out'}, "
                f"{form} window, 36 taps, {views} views, "
                f"{ncc.stage_groups(views)} groups a block: {info['regs']} "
                f"registers, {info['local_bytes']} B local (spills), "
                f"{smem} B shared a block, {info['blocks_per_sm']} resident "
                f"blocks an SM [{card}]")
        # every re-score instantiation (the mode is chosen at run time:
        # one instantiation serves both), at the APD scan's and the full
        # scan's views
        for u8, windows in ((True, (5, 2, 5, 5)), (False, (5, 2, 5, 5)),
                            (True, (4, 2, 4, 2)), (False, (4, 2, 4, 2))):
            taps = "36 + 8 x 9 taps (the main windows)" \
                if windows == (5, 2, 5, 5) else "25 + 8 x 25 taps"
            for views in (APD_VIEWS - 1, FULL_VIEWS - 1):
                info = weak.rescore_kernel_info(u8, sa, views, windows)
                smem = weak.rescore_smem_bytes(views, windows, sa)
                log(f"K6 re-score form {'u8' if u8 else 'f32'}, "
                    f"{'SA' if sa else 'square'} windows, {taps}, {views} "
                    f"views, both modes: {info['regs']} registers, "
                    f"{info['local_bytes']} B local (spills), {smem} B "
                    f"shared a block, {info['blocks_per_sm']} resident "
                    f"blocks an SM [{card}]")
    for views in (FULL_VIEWS - 1, 32):
        info = select.kernel_info(views)
        log(f"K11, {views} views: {info['regs']} registers, "
            f"{info['local_bytes']} B local (spills), "
            f"{info['blocks_per_sm']} resident blocks an SM [{card}]")
    cuobjdump = sass_taps.find_cuobjdump()
    if cuobjdump is None:
        log("SASS a tap: cuobjdump missing, not counted")
        return
    for name, mod in kernels:
        taps = sass_taps.library_taps(mod.library().path, cuobjdump)
        for kernel, r in taps.items():
            log(f"  SASS a tap, {name} {kernel}: {r['per_tap_total']:g} "
                f"({r['taps']} taps an iteration): " + ", ".join(
                    f"{c} {n:g}" for c, n in r["per_tap"].items())
                + f"; every tap loop (taps, a tap): {r['loops']}")


def repo_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [v for v in [env.get("PYTHONPATH")] if v])
    return env


class Utilization:
    """``nvidia-smi``'s utilization.gpu (the share of each sample period in
    which a kernel ran) sampled twice a second while a phase runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "500"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        vals = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
        self.mean = sum(vals) / len(vals) if vals else float("nan")
        self.samples = len(vals)
        return False


PASS_RE = re.compile(r"Pass (\d+) \((\w+)\) wall ([\d.]+) s, exchanged "
                     r"(\d+) B, rank (\d+) of (\d+)")
LAUNCH_RE = re.compile(r"Sampler kernel launches: (\d+), by site "
                       r"(\{[^}]*\}), NCC kernel launches: (\d+), by site "
                       r"(\{[^}]*\}), sweep kernel launches: (\d+), by mode "
                       r"(\{[^}]*\}), strong kernel launches: (\d+) for "
                       r"(\d+) colour updates(?:, rank (\d+) of (\d+))?"
                       r"(?:, weak kernel launches: (\d+) for (\d+) "
                       r"planes)?(?:, weak sweep kernel launches: (\d+) for "
                       r"(\d+) chunks)?(?:, selection kernel launches: "
                       r"(\d+))?(?:, anchor kernel launches: K10 "
                       r"(\d+), K8 (\d+), K9 (\d+))?")


def torchrun(cli_args, what: str, timeout: int = 900,
             tile: bool = False) -> tuple:
    """The port's engine CLI under ``torch.distributed.run`` with RANKS
    ranks on the one card (``tile``: the tile route's, which selects with
    K11); raises on a non-zero exit (a dead rank).
    Returns (stdout, wall seconds, per-rank pass walls, per-rank launch
    counts as ``read_counts`` gives them)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(RANKS), "-m",
           "apde_mvs_tpu_torch.cli.apd"] + [str(a) for a in cli_args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=repo_env(), capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{what}: torchrun exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    text = proc.stdout
    if text.count("process group backend gloo") != RANKS:
        raise AssertionError(f"{what}: expected {RANKS} gloo ranks:\n"
                             f"{text[-3000:]}")
    passes = {r: [] for r in range(RANKS)}
    for it, state, sec, sent, r, n in PASS_RE.findall(text):
        passes[int(r)].append((int(it), state, float(sec), int(sent)))
    sites = {}
    for m in LAUNCH_RE.findall(text):
        sites[int(m[8])] = parsed_counts(m)
        check_counts(f"{what}, rank {m[8]}", sites[int(m[8])], tile=tile)
    if sorted(sites) != list(range(RANKS)):
        raise AssertionError(f"{what}: launch lines of ranks "
                             f"{sorted(sites)}")
    return text, wall, passes, sites


def vp_scan_phase(scene, root: Path, seed: int, card: str) -> dict:
    """The round-0 schedule on every view, view-parallel over RANKS ranks
    sharing the card, then fusion on rank 0."""
    import torch
    log("==== view-parallel scan: torchrun, 2 ranks on one card (gloo) ====")
    torch.cuda.synchronize()
    with Utilization() as util:
        text, wall, passes, sites = torchrun(
            ["--dense_folder", root, "--dataset", "General", "--seed", seed,
             "--views_parallel", "true"], "view-parallel scan")
    for r in range(RANKS):
        if len(passes[r]) != 4:
            raise AssertionError(f"rank {r}: passes {passes[r]}")
    fusion = [ln for ln in text.splitlines() if ln.startswith("Fusion wall")]
    if len(fusion) != 1:
        raise AssertionError(f"fusion lines {fusion}")
    errs = depth_errors(scene, root)
    points = coloured_points(root / "APD" / "APD.ply", "view-parallel PLY")
    launches = {"K1": sum(sites[r]["k1"] for r in range(RANKS))}
    launches["K2"] = sum(sites[r]["k2"] for r in range(RANKS))
    launches["K3"] = sum(sites[r]["k3"] for r in range(RANKS))
    launches["K6"] = sum(sites[r]["k6"] for r in range(RANKS))
    launches["K7"] = sum(sites[r]["k7"] for r in range(RANKS))
    launches["K11"] = sum(sites[r]["k11"] for r in range(RANKS))
    for k in ("K8", "K9", "K10"):
        launches[k] = sum(sites[r][k.lower()] for r in range(RANKS))
    k5 = {mode: sum(sites[r]["k5_modes"].get(mode, 0) for r in range(RANKS))
          for mode in ("classify", "refine")}
    log(f"view-parallel scan: {wall:.3f} s for the torchrun subprocess; "
        f"utilization.gpu mean {util.mean:.1f}% over {util.samples} "
        f"samples; launches {launches}, K5 by mode {k5} [{card}]")
    for r in range(RANKS):
        for it, state, sec, sent in passes[r]:
            log(f"  rank {r}: Pass {it} ({state}) wall {sec:.3f} s, "
                f"exchanged {sent} B [{card}]")
    log(f"  {fusion[0]} [{card}]")
    return dict(wall_s=wall, passes=passes, launches=launches, k5=k5,
                k2_elsewhere=sum(k2_elsewhere(sites[r]["k2_sites"])
                                 for r in range(RANKS)),
                errors=errs, points=points, util=util.mean, fusion=fusion)


def keep_only_view0(root: Path) -> None:
    """Rewrite pair.txt so the scan's problem list is view 0 alone (its
    sources, their images and depths stay)."""
    lines = (root / "pair.txt").read_text().split("\n")
    (root / "pair.txt").write_text("\n".join(["1"] + lines[1:3]) + "\n")


def tile_phase(scene, vp_root: Path, tmp: Path, seed: int,
               card: str) -> dict:
    """View 0's REFINE_ITER pass 3 again, on the view-parallel scan's
    bins: row-sharded over RANKS ranks on the card (the tile route: fewer
    views than ranks), and by the serial engine on a copy of the same
    bins. Bitwise agreement is expected; differing pixels are printed and
    each result must pass the verify bar (median relative depth error
    under 1%)."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch.cli import apd
    from apde_mvs_tpu_torch.io import binmat
    log("==== tile route: view 0's pass 3 row-sharded over 2 ranks ====")
    roots = {}
    for name in ("tiled", "serial"):
        roots[name] = tmp / f"tile_{name}"
        shutil.copytree(vp_root, roots[name])
        keep_only_view0(roots[name])
    args = ["--dense_folder", None, "--dataset", "General", "--seed", seed,
            "--start_iteration", 3, "--no_fuse", "true"]
    text, wall, passes, sites = torchrun(
        [roots["tiled"] if a is None else a for a in args]
        + ["--views_parallel", "true"], "tile route", tile=True)
    if text.count("TILED over 2 rank(s)") != RANKS \
            or "Scale-out: tile route over 2 rank(s)" not in text:
        raise AssertionError(f"tile route not taken:\n{text[-3000:]}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run_main(apd.main, [roots["serial"] if a is None else a for a in args])
    serial_s = time.perf_counter() - t0
    diff = {}
    errs = {}
    for m in ("depths.bin", "normals.bin", "weak.bin", "confidence.bin"):
        a = binmat.read_bin_mat(roots["tiled"] / "APD" / "00000000" / m)
        b = binmat.read_bin_mat(roots["serial"] / "APD" / "00000000" / m)
        d = a != b
        diff[m] = int(d.any(-1).sum() if d.ndim == 3 else d.sum())
    gt = scene.depths[0]
    for name, root in roots.items():
        dep = binmat.read_bin_mat(root / "APD" / "00000000" / "depths.bin")
        ok = (dep > 0) & (gt > 0)
        errs[name] = float(np.median(np.abs(dep - gt)[ok] / gt[ok]))
    launches = sum(sites[r]["k2"] for r in range(RANKS))
    k3 = sum(sites[r]["k3"] for r in range(RANKS))
    k5 = {mode: sum(sites[r]["k5_modes"].get(mode, 0) for r in range(RANKS))
          for mode in ("classify", "refine")}
    k1 = sum(sites[r]["k1"] for r in range(RANKS))
    anchors = {k: sum(sites[r][k] for r in range(RANKS))
               for k in ("k6", "k8", "k9", "k10", "k11")}
    log(f"tile route: differing pixels against the serial pass {diff} of "
        f"{gt.size}; median relative depth error tiled {errs['tiled']:.5f}, "
        f"serial {errs['serial']:.5f}; torchrun {wall:.3f} s, rank walls "
        f"{[p[0][2] for p in passes.values()]} s, exchanged "
        f"{[p[0][3] for p in passes.values()]} B, serial CLI "
        f"{serial_s:.3f} s; K2 launches {launches}, K3 launches {k3}, K5 "
        f"launches by mode {k5} [{card}]")
    if not max(errs.values()) < 0.01:
        raise AssertionError(f"tile route above the verify bar: {errs}")
    for root in roots.values():
        shutil.rmtree(root)
    return dict(diff=diff, errors=errs, wall_s=wall, serial_s=serial_s,
                launches=launches, k3=k3, k5=k5, k1=k1, **anchors,
                k2_elsewhere=sum(k2_elsewhere(sites[r]["k2_sites"])
                                 for r in range(RANKS)),
                passes=passes)


def nccl_phase(seed: int, tmp: Path, device, card: str) -> dict:
    """A process group of one rank on the card: NCCL by the placement
    rule. The view-parallel FIRST_INIT pass of a 3-view 600x800 scan
    against the serial engine's on a copy (bitwise), then one geometric
    pass through the NCCL depth exchange (exchanged bytes and depth error
    checked)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from apde_mvs_tpu_torch import config as cfg
    from apde_mvs_tpu_torch.io import MemoryCache, binmat
    from apde_mvs_tpu_torch.parallel import distributed as pdist
    from apde_mvs_tpu_torch.pipeline import driver
    from apde_mvs_tpu_torch.pipeline.scan_parallel import ViewParallelRunner
    from apde_mvs_tpu_torch.testing import synthetic

    log("==== engine agreement: NCCL, one rank on the card ====")
    scene = synthetic.make_scene(num_views=3, height=HEIGHT, width=WIDTH,
                                 baseline=0.12)
    roots = {n: tmp / f"agree_{n}" for n in ("serial", "parallel")}
    for root in roots.values():
        synthetic.write_scene_to_disk(scene, root)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    pdist.initialize(device, init_method=f"tcp://localhost:{port}", rank=0,
                     world_size=1)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        specs = cfg.build_schedule(max(HEIGHT, WIDTH), "General")
        t0 = time.perf_counter()
        for p in driver.generate_sample_list(roots["serial"]):
            driver.process_problem(p, specs[0], cache=None, seed=seed,
                                   device=device)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        runner = ViewParallelRunner(
            driver.generate_sample_list(roots["parallel"]), MemoryCache(),
            seed=seed, device=device)
        reset_counts()
        t0 = time.perf_counter()
        runner.run_pass(specs[0])
        torch.cuda.synchronize()
        vp_s = time.perf_counter() - t0
        diff = {}
        for v in range(3):
            for m in ("depths.bin", "normals.bin", "weak.bin"):
                a, b = (binmat.read_bin_mat(r / "APD" / f"{v:08d}" / m)
                        for r in roots.values())
                d = a != b
                diff[(v, m)] = int(d.any(-1).sum() if d.ndim == 3
                                   else d.sum())
        log(f"FIRST_INIT, 3 views: differing pixels view-parallel vs serial "
            f"{sum(diff.values())} ({diff}); serial {serial_s:.3f} s, "
            f"view-parallel {vp_s:.3f} s [{card}]")
        if any(diff.values()):
            raise AssertionError(f"view-parallel FIRST_INIT differs from "
                                 f"the serial engine: {diff}")
        sent = pdist.exchanged_bytes
        t0 = time.perf_counter()
        runner.run_pass(specs[1])
        torch.cuda.synchronize()
        geom_s = time.perf_counter() - t0
        sent = pdist.exchanged_bytes - sent
        c = read_counts()
        check_counts("NCCL agreement", c)
        want = 3 * HEIGHT * WIDTH * 4
        log(f"geometric pass through NCCL: {sent} B exchanged (expected "
            f"{want}), {geom_s:.3f} s; over both passes {counts_line(c)} "
            f"[{card}]")
        if sent != want:
            raise AssertionError(f"exchanged {sent} B, expected {want}")
        errs = depth_errors(scene, roots["parallel"])
    finally:
        dist.destroy_process_group()
    for root in roots.values():
        shutil.rmtree(root)
    return dict(c, serial_s=serial_s, vp_s=vp_s, geom_s=geom_s,
                errors=errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=ROUND0_VIEWS,
                    help=f"views of the round-0 scan (2..{FULL_VIEWS}); "
                         f"fewer than {FULL_VIEWS} is a reduction and is "
                         "printed")
    ap.add_argument("--apd_views", type=int, default=APD_VIEWS,
                    help="views of the APD scan, as --views")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for name in ("views", "apd_views"):
        if not 2 <= getattr(args, name) <= FULL_VIEWS:
            ap.error(f"--{name} must be in 2..{FULL_VIEWS}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    # the 3x3 camera algebra is unrolled f32 (no matmul); state the
    # precision anyway for anything else that may reach a matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from apde_mvs_tpu_torch.core.platform import card_line
    from apde_mvs_tpu_torch.io.images import pil_available
    from apde_mvs_tpu_torch.ops.cuda import anchors as kern
    from apde_mvs_tpu_torch.ops.cuda import (ncc, sampler, select, strong,
                                             sweep, weak, weak_sweep)
    from apde_mvs_tpu_torch.testing import synthetic
    from apde_mvs_tpu_torch.tools import kernel_split
    from apde_mvs_tpu_torch.tools.kernel_times import (real_pass_chunks,
                                                       weak_chunk)

    t_all = time.perf_counter()
    card = card_line()
    device = torch.device("cuda", 0)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"PIL {'imports' if pil_available() else 'missing'}")

    # ---- setup: build K1-K3 and K5-K11 from this checkout -----------------
    build_race(card)
    for name, mod in (("K1", sampler), ("K2", ncc), ("K3", strong),
                      ("K5", sweep), ("K6", weak), ("K7", weak_sweep),
                      ("K8-K10", kern), ("K11", select)):
        t0 = time.perf_counter()
        built = mod.library()
        log(f"{name} load: {time.perf_counter() - t0:.2f} s -> "
            f"{built.path.name}")
        for ln in built.log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                log(f"  ptxas: {ln.strip()}")
    kernel_report(card)

    t0 = time.perf_counter()
    full_scene = synthetic.make_scene(num_views=FULL_VIEWS, height=HEIGHT,
                                      width=WIDTH, baseline=0.12)
    scene = full_scene if args.views == FULL_VIEWS else \
        synthetic.make_scene(num_views=args.views, height=HEIGHT,
                             width=WIDTH, baseline=0.12)
    apd_scene = synthetic.make_scene(
        num_views=args.apd_views, height=HEIGHT, width=WIDTH, baseline=0.12,
        focal=1.25 * WIDTH, weak_region=WEAK_REGION)
    log(f"scenes: {args.views} and {args.apd_views} views {HEIGHT}x{WIDTH} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, n in (("round-0 scan", args.views),
                    ("APD scan", args.apd_views)):
        if n < FULL_VIEWS:
            log(f"REDUCED: {name} has {n} views instead of {FULL_VIEWS}; "
                "width and height kept")

    # ---- kernel checks -----------------------------------------------------
    k = kernel_phase(full_scene, args.seed, device, card)
    kk = k2_phase(full_scene, args.seed, device, card)
    k5 = k5_phase(full_scene, args.seed, device, card)
    k3 = k3_phase(full_scene, args.seed, device, card)
    # the APD scene's cameras with a textured foreground plane before a
    # fronto-parallel background, so that the foreground alone is nearer
    # than 0.95 of the mean depth: a weak chunk whose windows carry the
    # full texture amplitude
    textured = synthetic.make_scene(
        num_views=args.apd_views, height=HEIGHT, width=WIDTH, baseline=0.12,
        focal=1.25 * WIDTH, with_foreground=True, plane_tilt=(0.0, 0.0))
    t0 = time.perf_counter()
    wc = weak_chunk(apd_scene, device, args.seed)
    torch.cuda.synchronize()
    have = (wc.anchors[:, 1:, 0] >= 0).sum(-1)
    log(f"weak chunk: {wc.x.numel()} reliable weak pixels of the APD scan's "
        f"view 0, {float(have.float().mean()):.2f} anchors a pixel, "
        f"{float((wc.fit == 0).all(-1).float().mean()):.3f} without a fit "
        f"plane, {float((wc.vw > 0).sum(-1).float().mean()):.2f} views "
        f"weighted a pixel; built in {time.perf_counter() - t0:.1f} s")
    if wc.x.numel() == 0:
        raise AssertionError("no weak pixel found anchors")
    kw = weak_kernel_phase(apd_scene, wc, args.seed, device, card,
                           textured=textured)
    del textured
    t0 = time.perf_counter()
    real = real_pass_chunks(device)
    log(f"a real APD pass of view 0 (profile_pass.py's: 11 views, priors of "
        f"a FIRST_INIT pass): K7's first chunk {real.k7[0][2].numel()} "
        f"pixels, K8's {real.k8[0][4].numel()}; "
        f"{time.perf_counter() - t0:.1f} s")
    sync_phase(real.inputs, card)
    k5_real = stage_real_phase(real.inputs, card)
    k7 = weak_sweep_phase(apd_scene, wc, real, args.seed, device, card)
    ki = init_phase(full_scene, apd_scene, wc, real, args.seed, device, card)
    del wc
    ka = anchor_kernel_phase(apd_scene, real, args.seed, device, card)
    # step 0's split of K7 and K8 (tools/kernel_split.py): where a launch's
    # device time goes, stage by stage, at the chunks above
    log("==== K7 and K8 split by stage (tools/kernel_split.py) ====")
    split = kernel_split.report(apd_scene, device, card, args.seed,
                                log=log, real=real)
    for kernel, chunks in split.items():
        for chunk, r in chunks.items():
            for key, v in r.items():
                if key.endswith("ms"):
                    measured(v, f"{kernel} split, {chunk}, {key}")
    del real
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- main paths: the round-0 scan, then the APD scan -------------------
    seed_args = ["--seed", str(args.seed)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp) / "scan"
        synthetic.write_scene_to_disk(scene, root)
        r0 = scan_phase("round-0 scan", seed_args, scene, root, 4, card)
        root = Path(tmp) / "apd_scan"
        synthetic.write_scene_to_disk(apd_scene, root)
        write_sa_masks(apd_scene, root)
        ap = scan_phase("APD scan", seed_args + [
            "--pyramid_base", str(APD_BASE)], apd_scene, root, 8, card,
            weak=True)
        apd_checks(ap, root, apd_scene.num_views, card)
        fusion_phase(root, Path(tmp) / "profile", card)
        ex = exports_phase(root, apd_scene.num_views, args.seed, Path(tmp),
                           card)
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        root = Path(tmp) / "vp_scan"
        synthetic.write_scene_to_disk(full_scene, root)
        vp = vp_scan_phase(full_scene, root, args.seed, card)
        tl = tile_phase(full_scene, root, Path(tmp), args.seed, card)
        shutil.rmtree(root)
        ag = nccl_phase(args.seed, Path(tmp), device, card)
        torch.cuda.empty_cache()
        with Utilization() as bu:
            bt = batch_phase(full_scene, Path(tmp), card)
    torch.cuda.synchronize()

    log(f"chip_smoke total {time.perf_counter() - t_all:.1f} s")
    log("phase walls: round-0 scan {:.1f} s, APD scan {:.1f} s, exports "
        "pass {:.1f} s, view-parallel scan {:.1f} s, tile route {:.1f} s, "
        "batch path {:.1f} s [{}]".format(
            r0["wall_s"], ap["wall_s"], ex["wall_s"], vp["wall_s"],
            tl["wall_s"], bt["wall_s"], card))
    # the round-0 schedule on the same 11 views: two ranks sharing the card
    # against the batch path's serial engine
    serial = [float(ln.split()[4]) for ln in bt["passes"]]
    for i, sec in enumerate(serial):
        ranks = ", ".join(f"rank {r} {vp['passes'][r][i][2]:.3f} s"
                          for r in range(RANKS))
        log(f"pass {i}: view-parallel ({ranks}) vs serial batch engine "
            f"{sec:.3f} s [{card}]")
    log(f"utilization.gpu mean: view-parallel scan {vp['util']:.1f}%, "
        f"batch path {bu.mean:.1f}% ({bu.samples} samples) [{card}]")
    # launches on every path, each read from its own counters (the
    # subprocess engines' from their logs): K1's (no main-path site is
    # left: check_counts holds them at 0), K2's, K5's by mode, K3's and
    # K6's
    k1_launches = sum(c["k1"] for c in (r0, ap, ex, ex["debug_point"], ag,
                                        bt)) + vp["launches"]["K1"] + tl["k1"]
    k6_paths = dict(round0=r0["k6"], apd=ap["k6"], exports=ex["k6"],
                    debug_point=ex["debug_point"]["k6"],
                    view_parallel=vp["launches"]["K6"], nccl=ag["k6"],
                    batch=bt["k6"])
    k7_paths = dict(round0=r0["k7"], apd=ap["k7"], exports=ex["k7"],
                    debug_point=ex["debug_point"]["k7"],
                    view_parallel=vp["launches"]["K7"], nccl=ag["k7"],
                    batch=bt["k7"])
    k6_split = [k6_chunks(c) for c in (ap, ex)]
    weak_chunks = sum(c for c, _ in k6_split)
    k6_rescores = sum(r for _, r in k6_split)
    log(f"K7 launches by path: {json.dumps(k7_paths)}; K6 launches by path: "
        f"{json.dumps(k6_paths)}; the APD scan and the exports pass: "
        f"{weak_chunks} weak-sweep chunks (one K7 launch each), "
        f"{k6_rescores} re-score chunks (one K6 launch each); K1 "
        f"launches on every path {k1_launches} [{card}]")
    k2_paths = dict(round0=r0["k2"], apd=ap["k2"], exports=ex["k2"],
                    debug_point=ex["debug_point"]["k2"],
                    view_parallel=vp["launches"]["K2"], nccl=ag["k2"],
                    batch=bt["k2"])
    # K2 at any other than the strong path's sites: the sweeps' probes ran
    # there until K5 took them
    k2_sweeps = sum(k2_elsewhere(c["k2_sites"]) for c in (
        r0, ap, ex, ex["debug_point"], ag, bt)) + vp["k2_elsewhere"] \
        + tl["k2_elsewhere"]
    log(f"K2 launches by path: {json.dumps(k2_paths)}, tile route "
        f"{tl['launches']}; outside the strong path {k2_sweeps} [{card}]")
    k5_paths = {mode: dict(
        round0=r0["k5_modes"].get(mode, 0), apd=ap["k5_modes"].get(mode, 0),
        exports=ex["k5_modes"].get(mode, 0),
        debug_point=ex["debug_point"]["k5_modes"].get(mode, 0),
        view_parallel=vp["k5"][mode],
        nccl=ag["k5_modes"].get(mode, 0), batch=bt["k5_modes"].get(mode, 0))
        for mode in ("classify", "refine")}
    log(f"K5 launches by path: {json.dumps(k5_paths)}, tile route "
        f"{json.dumps(tl['k5'])} [{card}]")
    # K3: every strong sweep's colour update, one launch each
    k3_paths = dict(round0=r0["k3"], apd=ap["k3"], exports=ex["k3"],
                    view_parallel=vp["launches"]["K3"], nccl=ag["k3"],
                    batch=bt["k3"], tile_route=tl["k3"])
    log(f"K3 launches by path: {json.dumps(k3_paths)}; colour updates "
        f"in-process: round0 {r0['k3_colours']}, apd {ap['k3_colours']}, "
        f"exports {ex['k3_colours']}, nccl {ag['k3_colours']}, batch "
        f"{bt['k3_colours']}; with an SA window: apd {ap['k3_sa']}, exports "
        f"{ex['k3_sa']} [{card}]")
    if not ap["k3_sa"] > 0:
        raise AssertionError("the APD scan ran no K3 launch with an SA "
                             "window")
    # K8, K9, K10: the APD setup of every APD pass (check_counts holds the
    # APD scan and the exports pass at one launch of each at least, every
    # other path at none)
    anchor_paths = {k: dict(
        round0=r0[k], apd=ap[k], exports=ex[k],
        debug_point=ex["debug_point"][k],
        view_parallel=vp["launches"][k.upper()], nccl=ag[k], batch=bt[k],
        tile_route=tl[k]) for k in ("k8", "k9", "k10")}
    log(f"K8 launches by path: {json.dumps(anchor_paths['k8'])}; K9: "
        f"{json.dumps(anchor_paths['k9'])}; K10: "
        f"{json.dumps(anchor_paths['k10'])} [{card}]")
    k1 = {"route": "cuda", "source": "apde_mvs_tpu_torch/csrc/sampler.cu",
          "replaces": "apde_mvs_tpu/ops/pallas/sampler.py:38"}
    # K1 launches on no main path now: its rows' launches are every path's
    # K1 launches, 0 (check_counts)
    rows = [dict(name="K1 bilinear sampler (packed u8 quads)", **k1,
                 launches=k1_launches,
                 max_abs_err=k["max_abs_err"], **k["u8"])]
    rows.append(dict(name="K1 bilinear sampler, tile-route row shard "
                          "(packed u8 quads)", **k1,
                     launches=k1_launches,
                     max_abs_err=k["max_abs_err"], **k["shard"]["u8"]))
    for site, what in (("weak_centre", "weak centre windows"),
                       ("weak_anchor", "weak anchor windows")):
        r = kw[site]
        rows.append(dict(name=f"K1 bilinear sampler, {what}, redesigned as "
                              "K6 (packed u8 quads)", **k1,
                         launches=k1_launches,
                         max_abs_err=r["max_abs_err"], **r["u8"]))
    k2 = {"route": "cuda", "source": "apde_mvs_tpu_torch/csrc/ncc.cu",
          "replaces": "apde_mvs_tpu/ops/cost.py:248-297 (XLA-compiled jnp)"}
    # the main paths launch K2's stage form (the initial cost: with the
    # selection on every route but the tile route's, which runs its
    # cost-out mode) and the debug tool its sweep form
    k2_sweep_form = ex["debug_point"]["k2"]
    k2_stage = sum(k2_paths.values()) - k2_sweep_form
    rows.append(dict(name="K2 fused strong NCC, sweep form (u8 quads)",
                     **k2, launches=k2_sweep_form,
                     max_abs_err=kk["max_abs_err"], **kk["strong"]))
    rows.append(dict(name="K2 fused strong NCC, sweep form, tile-route row "
                          "shard (u8 quads)", **k2, launches=0,
                     max_abs_err=kk["max_abs_err"],
                     **{k_: v for k_, v in kk["shard"].items()
                        if k_ != "shape"}))
    k2_stage_src = dict(k2, replaces="apde_mvs_tpu/ops/cost.py:140 "
                        "(precompute_ref_window), :248-297 and :430 "
                        "(initial_cost_and_selection) with ops/init.py:43-90"
                        " (XLA-compiled jnp)")
    for key, what in (("k2", "square window"), ("k2_sa", "SA star window")):
        rows.append(dict(name=f"K2 stage form with the selection in its "
                              f"epilogue, the initial cost over the full "
                              f"image, {what} (u8 quads)",
                         **k2_stage_src, launches=k2_stage,
                         max_abs_err=ki["max_abs_err"],
                         **{k_: v for k_, v in ki[key].items()
                            if k_ not in ("composition_ms", "parent_ms")}))
        rows.append(dict(name=f"K2 stage form, cost-out mode (the tile "
                              f"route's), the full image, {what} (u8 "
                              "quads)",
                         **dict(k2_stage_src, replaces="apde_mvs_tpu/ops/"
                                "cost.py:140 (precompute_ref_window) and "
                                ":248-297 with ops/init.py:43-90 "
                                "(XLA-compiled jnp)"),
                         launches=tl["launches"],
                         max_abs_err=ki["max_abs_err"],
                         **ki[key + "_costout"]))
    rows.append(dict(name="K2 fused strong NCC, classify chunk (u8 quads)",
                     **k2, launches=k2_sweeps, max_abs_err=kk["max_abs_err"],
                     **kk["chunk"]))
    k5_src = {"route": "cuda", "source": "apde_mvs_tpu_torch/csrc/sweep.cu",
              "replaces": "apde_mvs_tpu/ops/filters.py:196-263 and :476-507 "
                          "with cost.py:418 (XLA-compiled jnp)"}
    # the main paths launch K5's stage form (DepthToWeak and LocalRefine
    # whole): its rows count every path's launches; the sweep form's rows
    # count none (held as K1 is)
    for mode, what in (("classify", "DepthToWeak classify chunk, 61 probes"),
                       ("refine", "LocalRefine chunk, 12 probes")):
        rows.append(dict(name=f"K5 fused disparity sweep, sweep form, {what} "
                              "(u8 quads, geometric cost)", **k5_src,
                         launches=0, max_abs_err=k5["max_abs_err"],
                         **k5[mode]))
    k5_stage_src = dict(k5_src, replaces="apde_mvs_tpu/ops/filters.py:234-"
                        "307 (depth_to_weak, _classify_peaks) and :476-507 "
                        "(local_refine) with _sweep_setup :178 and cost.py:"
                        "418 (XLA-compiled jnp)")
    st = k5["stage"]
    for key, mode, what in (
            ("classify", "classify", "DepthToWeak whole, classify chunk"),
            ("refine", "refine", "LocalRefine whole, refine chunk"),
            ("classify_sa", "classify", "DepthToWeak whole, classify chunk, "
             "SA star window")):
        rows.append(dict(name=f"K5 stage form, {what} (u8 quads, geometric "
                              "cost)", **k5_stage_src,
                         launches=sum(k5_paths[mode].values())
                         + tl["k5"][mode],
                         max_abs_err=st["max_abs_err"], **st[key]))
    for mode in ("classify", "refine"):
        r = k5_real[mode]
        rows.append(dict(name=f"K5 stage form, a real APD pass's first "
                              f"{mode} chunk ({r['pixels']} pixels, SA, u8 "
                              "quads)", **k5_stage_src,
                         launches=sum(k5_paths[mode].values())
                         + tl["k5"][mode],
                         max_abs_err=k5_real["max_abs_err"],
                         **{k_: v for k_, v in r.items() if k_ != "pixels"}))
    k3_src = {"route": "cuda", "source": "apde_mvs_tpu_torch/csrc/strong.cu",
              "replaces": "apde_mvs_tpu/ops/propagation.py:239-427 "
                          "(XLA-compiled jnp)"}
    rows.append(dict(name="K3 strong sweep colour update, black pixels of a "
                          "view (u8 quads, geometric cost)", **k3_src,
                     launches=sum(k3_paths.values()),
                     max_abs_err=k3["max_abs_err"], **k3["strong"]))
    rows.append(dict(name="K3 strong sweep colour update, black pixels of a "
                          "view, SA star window (u8 quads, geometric cost)",
                     **k3_src, launches=ap["k3_sa"] + ex["k3_sa"],
                     max_abs_err=k3["max_abs_err"], **k3["sa"]))
    rows.append(dict(name="K3 strong sweep colour update, tile-route halo "
                          "row block (u8 quads, geometric cost)", **k3_src,
                     launches=tl["k3"], max_abs_err=k3["max_abs_err"],
                     **k3["shard"]))
    # the serial and view-parallel routes launch the commit form: every
    # path's launches but the tile route's
    k3_commit_src = dict(k3_src, replaces="apde_mvs_tpu/ops/propagation.py:"
                         "239-460 (_strong_body and propagate_strong's "
                         "commit, XLA-compiled jnp)")
    for key, what, n in (
            ("commit", "", sum(k3_paths.values()) - tl["k3"]),
            ("commit_sa", ", SA star window", ap["k3_sa"] + ex["k3_sa"])):
        rows.append(dict(name=f"K3 strong sweep colour update with its "
                              f"commit, black pixels of a view{what} (u8 "
                              "quads, geometric cost)", **k3_commit_src,
                         launches=n, max_abs_err=k3["max_abs_err"],
                         **k3[key]))
    k6_src = {"route": "cuda", "source": "apde_mvs_tpu_torch/csrc/weak.cu",
              "replaces": "apde_mvs_tpu/ops/pallas/sampler.py:38 at the weak "
                          "sites, with apde_mvs_tpu/ops/deformable.py:124-198"
                          " and cost.py:418 (XLA-compiled jnp)"}
    # the main paths' weak windows are all SA's: the square's row counts
    # no launch; the weak sweep's candidates and probes run inside K7, so
    # their rows count none either (K6's forms held as K1 is)
    for key, what, n in (
            ("candidates", "weak-sweep chunk, 10 candidate planes, every "
             "view", 0),
            ("probes", "weak-sweep chunk, 5 probes, weighted views", 0),
            ("rescore", "initial cost's re-score chunk, 1 plane, "
             "weak-sweep form (the re-score form replaced it)", 0),
            ("candidates_square", "weak-sweep chunk, 10 candidate planes, "
             "every view, square windows", 0)):
        geo_tag = "" if key == "rescore" else ", geometric cost"
        sa_tag = "" if key == "candidates_square" else ", SA"
        rows.append(dict(name=f"K6 deformable NCC, {what} (u8 quads"
                              f"{sa_tag}{geo_tag})", **k6_src, launches=n,
                         max_abs_err=kw["k6_max_abs_err"],
                         **kw[key]))
    # the main paths' re-score runs K6's re-score form with the selection
    # (the serial route's), every K6 launch; the tile route's cost-out mode
    # runs where the tile route has a weak list
    k6_rescore_src = dict(
        k6_src, replaces="apde_mvs_tpu/ops/deformable.py:30 "
        "(WeakRefData.build) and :124-198 with ops/init.py:72-90 and "
        "cost.py:430 (XLA-compiled jnp)")
    rows.append(dict(
        name=f"K6 re-score form with the selection in its epilogue, the "
             f"initial cost's re-score, the APD scan's first chunk "
             f"({ki['k6']['pixels']} pixels, 1 plane, u8 quads, SA)",
        **k6_rescore_src, launches=k6_rescores,
        max_abs_err=ki["max_abs_err"],
        **{k_: v for k_, v in ki["k6"].items()
           if k_ not in ("composition_ms", "pixels")}))
    rows.append(dict(
        name=f"K6 re-score form, cost-out mode (the tile route's), the same "
             f"chunk ({ki['k6']['pixels']} pixels)", **k6_rescore_src,
        launches=tl["k6"], max_abs_err=ki["max_abs_err"],
        **ki["k6_costout"]))
    # the same chunk with square windows: no main path re-scores with them
    # (its weak windows are SA's), so these rows count no launch
    for key, what in (("k6_square", "with the selection in its epilogue"),
                      ("k6_square_costout", "cost-out mode")):
        rows.append(dict(
            name=f"K6 re-score form, {what}, the same chunk with square "
                 "windows (every existing anchor valid)", **k6_rescore_src,
            launches=0, max_abs_err=ki["max_abs_err"],
            **{k_: v for k_, v in ki[key].items()
               if k_ not in ("composition_ms", "pixels")}))
    k11_paths = dict(round0=r0["k11"], apd=ap["k11"], exports=ex["k11"],
                     view_parallel=vp["launches"]["K11"], nccl=ag["k11"],
                     batch=bt["k11"], tile_route=tl["k11"])
    log(f"K11 launches by path (the tile route's alone; the others select "
        f"in K2's and K6's epilogues): {json.dumps(k11_paths)} [{card}]")
    rows.append(dict(
        name="K11 top-k view selection, the full image (10 views, "
             "600x800; the tile route's)", route="cuda",
        source="apde_mvs_tpu_torch/csrc/select.cu",
        replaces="apde_mvs_tpu/ops/cost.py:430 (initial_cost_and_selection)"
                 " with ops/init.py:85-90 (XLA-compiled jnp)",
        launches=sum(k11_paths.values()), max_abs_err=ki["max_abs_err"],
        **ki["k11"]))
    k7_src = {"route": "cuda",
              "source": "apde_mvs_tpu_torch/csrc/weak_sweep.cu",
              "replaces": "apde_mvs_tpu/ops/propagation.py:739 (_weak_body, "
                          "XLA-compiled jnp; K6's weak-sweep forms inside)"}
    # a weak-sweep chunk is one K7 launch, geometric in REFINE_ITER and not
    # in REFINE_INIT: each form's row counts the launches of both
    for key, what in (("refine_iter", "the APD scan's weak chunk, "
                                      "REFINE_ITER (SA, geometric cost)"),
                      ("refine_init", "the APD scan's weak chunk, "
                                      "REFINE_INIT (SA, no geometric "
                                      "cost)"),
                      ("real_pass", "a real APD pass's first chunk, "
                                    "REFINE_ITER (SA, geometric cost)")):
        rows.append(dict(name=f"K7 weak sweep chunk update, {what}; "
                              "launches of both forms (u8 quads)", **k7_src,
                         launches=sum(k7_paths.values()),
                         max_abs_err=k7["max_abs_err"],
                         **k7[key]))
    # the main paths' weak windows are SA's: the square's row counts none
    rows.append(dict(name="K7 weak sweep chunk update, the APD scan's weak "
                          "chunk with square windows (every valid anchor "
                          "counts), REFINE_ITER (geometric cost, u8 quads)",
                     **k7_src, launches=0, max_abs_err=k7["max_abs_err"],
                     **k7["square"]))
    a_src = {"route": "cuda", "source": "apde_mvs_tpu_torch/csrc/anchors.cu"}
    for key, what, replaces in (
            ("K10", f"K10 nearest-strong jump flooding, the APD scan's "
             f"round-1 map (600x800, {ka['K10']['launches_a_call']} "
             f"launch(es) a call over {ka['K10']['sub_passes']} live "
             "sub-passes)", ":44-99"),
            ("K10_real", f"K10 nearest-strong jump flooding, a real APD "
             f"pass's map (600x800, {ka['K10_real']['launches_a_call']} "
             f"launch(es) a call over {ka['K10_real']['sub_passes']} live "
             "sub-passes)", ":44-99"),
            ("K8", f"K8 anchor generation, a chunk of the APD scan's weak "
             f"list ({ka['K8']['pixels']} pixels, "
             f"{ka['K8']['directions']} directions)", ":191-373"),
            ("K8_real", f"K8 anchor generation, a real APD pass's chunk "
             f"({ka['K8_real']['pixels']} pixels, "
             f"{ka['K8_real']['directions']} directions)", ":191-373"),
            ("K9", f"K9 fit-plane RANSAC, the APD scan's reliable weak "
             f"pixels ({ka['K9']['pixels']})", ":386-467"),
            ("K9_real", f"K9 fit-plane RANSAC, a real APD pass's first fit "
             f"({ka['K9_real']['pixels']} pixels)", ":386-467")):
        rows.append(dict(
            name=what, **a_src,
            replaces=f"apde_mvs_tpu/ops/anchors.py{replaces} "
                     "(XLA-compiled jnp)",
            launches=sum(anchor_paths[key.split("_")[0].lower()].values()),
            **{"max_abs_err": ka["max_abs_err"], **ka[key]}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
