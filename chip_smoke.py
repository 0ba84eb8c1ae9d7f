#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (apde_mvs_tpu_torch) on one NVIDIA
GPU: builds the hand-written kernels from this checkout, holds each against
its plain PyTorch version at main-path shapes, then drives the port's main
path — the engine CLI on a synthetic scan (round 0: FIRST_INIT + 3
REFINE_ITER passes over every view, then fusion) — and checks the result
against ground truth.

    python3 chip_smoke.py [--views 11] [--seed 0]

The scan is 600x800, the shape bench.py times; only the number of views
may be cut, and a cut is printed.

Every phase raises on failure; the exit code is non-zero on any failure,
and without a CUDA device the script stops before printing any result.
Output ends with: one JSON line of per-kernel numbers, the card's name and
power limit as nvidia-smi gives them, and the final status JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path

# the scan: bench.py's shape, each view's 10 others as sources
HEIGHT, WIDTH = 600, 800
FULL_VIEWS = 11

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the float32
# rate outside the tensor cores (the sampler's arithmetic is plain f32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# operations of one K1 sample: 2 clamps, 2 floors, 2 fractions, 2 (1 - f),
# 6 multiplies, 3 adds
K1_OPS_PER_SAMPLE = 17


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


def touched_rows(quads, width: int, height: int, x, y) -> int:
    """Distinct quad-table rows the samples read: the table bytes this run's
    data needs, each counted once."""
    import torch

    from apde_mvs_tpu_torch.core.sampling import quad_coords
    idx, _, _ = quad_coords(width, height, x, y)
    s = quads.shape[0]
    base = torch.arange(s, device=idx.device) * (width * height)
    hit = torch.zeros(s * width * height, dtype=torch.bool, device=idx.device)
    hit[(idx + base.reshape((s,) + (1,) * (idx.ndim - 1))).reshape(-1)] = True
    return int(hit.sum())


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
        ms = cuda_ms(lambda: sampler.sample_packed(q, W, H, wx, wy), 20)
        plain_ms = cuda_ms(
            lambda: sampler.sample_packed_plain(q, W, H, wx, wy), 5, 1)
        nbytes = 12 * n + touched_rows(q, W, H, wx, wy) * 4 * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = K1_OPS_PER_SAMPLE * n / F32_FLOPS_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        res[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"  packed {tag}: K1 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB) [{card}]")

    # the yardstick: grid_sample computes the same bilinear, border-clamped
    # function on the (u8-rounded) images; the port never calls it
    img_u8 = data[True].src_quads[..., 0].reshape(S, 1, H, W).float()
    grid = torch.stack([wx * (2.0 / (W - 1)) - 1.0,
                        wy * (2.0 / (H - 1)) - 1.0], -1)   # (S, B, 36, 2)

    def lib_call():
        return F.grid_sample(img_u8, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
    lib = lib_call()[:, 0]
    ref = sampler.sample_packed_plain(data[True].src_quads, W, H, wx, wy)
    ok = torch.isfinite(ref)
    log(f"  grid_sample vs plain (u8 images): max abs diff "
        f"{float((lib - ref)[ok].abs().max()):.3g} over finite samples")
    res["u8"]["library_ms"] = cuda_ms(lib_call, 10)
    log(f"  grid_sample, same samples: {res['u8']['library_ms']:.4f} ms "
        f"[{card}]")
    del grid, lib, ref

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
    res["max_abs_err"] = max(errs)
    return res


def main_path_phase(args, scene, root: Path, card: str) -> dict:
    """The port's CLI on the card over the written scan; checks depth error
    against ground truth, the fused PLY, and that K1 carried the sampling."""
    import numpy as np
    import torch

    from apde_mvs_tpu_torch.cli import apd
    from apde_mvs_tpu_torch.io import binmat
    from apde_mvs_tpu_torch.io.ply import read_ply
    from apde_mvs_tpu_torch.ops.cuda import sampler

    class Tee(io.TextIOBase):
        def __init__(self):
            self.buf = io.StringIO()

        def write(self, s):
            sys.__stdout__.write(s)
            return self.buf.write(s)

        def flush(self):
            sys.__stdout__.flush()

    tee = Tee()
    torch.cuda.synchronize()
    sampler.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = apd.main(["--dense_folder", str(root), "--dataset", "General",
                       "--seed", str(args.seed)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sampler.launches
    if rc != 0:
        raise RuntimeError(f"apd.main returned {rc}")
    text = tee.buf.getvalue()
    passes = [ln for ln in text.splitlines() if ln.startswith("Pass ")]
    fusion = [ln for ln in text.splitlines() if ln.startswith("Fusion wall")]
    if len(passes) != 4:
        raise AssertionError(f"expected 4 passes, saw {passes}")
    errs = []
    for v in range(scene.num_views):
        d = binmat.read_bin_mat(root / "APD" / f"{v:08d}" / "depths.bin")
        gt = scene.depths[v]
        ok = (d > 0) & (gt > 0)
        errs.append(float(np.median(np.abs(d - gt)[ok] / gt[ok])))
    worst = max(errs)
    log(f"median relative depth error per view: "
        f"{', '.join(f'{e:.5f}' for e in errs)}")
    if not worst < 0.01:
        raise AssertionError(f"median relative depth error {worst} >= 1%")
    pts, cols = read_ply(root / "APD" / "APD.ply")
    log(f"fused PLY: {len(pts)} points, colours "
        f"{'yes' if cols is not None else 'no'}")
    if len(pts) <= 1000 or cols is None or len(cols) != len(pts):
        raise AssertionError("fused PLY has too few coloured points")
    if launches <= 0:
        raise AssertionError("K1 was not launched on the main path")
    log(f"main path: {wall:.3f} s wall, K1 launches {launches} [{card}]")
    for ln in passes + fusion:
        log(f"  {ln} [{card}]")
    return dict(launches=launches, wall_s=wall, errors=errs,
                points=len(pts), passes=passes, fusion=fusion)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=FULL_VIEWS,
                    help=f"views of the scan (2..{FULL_VIEWS}); fewer than "
                         f"{FULL_VIEWS} is a reduction and is printed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not 2 <= args.views <= FULL_VIEWS:
        ap.error(f"--views must be in 2..{FULL_VIEWS}")

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
    from apde_mvs_tpu_torch.ops.cuda import sampler
    from apde_mvs_tpu_torch.testing import synthetic

    t_all = time.perf_counter()
    card = card_line()
    device = torch.device("cuda", 0)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"PIL {'imports' if pil_available() else 'missing'}")

    # ---- setup: build K1 from this checkout --------------------------------
    t0 = time.perf_counter()
    built = sampler.library()
    log(f"K1 build: {built.seconds:.2f} s nvcc "
        f"({time.perf_counter() - t0:.2f} s incl. load) -> {built.path.name}")
    for ln in built.log.splitlines():
        if "registers" in ln or "spill" in ln or "error" in ln.lower():
            log(f"  ptxas: {ln.strip()}")

    t0 = time.perf_counter()
    scene = synthetic.make_scene(num_views=args.views, height=HEIGHT,
                                 width=WIDTH, baseline=0.12)
    log(f"scene: {args.views} views {HEIGHT}x{WIDTH} in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.views < FULL_VIEWS:
        log(f"REDUCED: {args.views} views instead of {FULL_VIEWS}; width "
            "and height kept")

    # ---- kernel check ------------------------------------------------------
    k = kernel_phase(scene, args.seed, device, card)
    torch.cuda.synchronize()

    # ---- main path ---------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp) / "scan"
        synthetic.write_scene_to_disk(scene, root)
        mp = main_path_phase(args, scene, root, card)
    torch.cuda.synchronize()

    log(f"chip_smoke total {time.perf_counter() - t_all:.1f} s")
    u8 = k["u8"]
    print(json.dumps({"kernels": [{
        "name": "K1 bilinear sampler (packed u8 quads)",
        "route": "cuda",
        "source": "apde_mvs_tpu_torch/csrc/sampler.cu",
        "replaces": "apde_mvs_tpu/ops/pallas/sampler.py:38",
        "launches": mp["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": u8["ms"],
        "plain_ms": u8["plain_ms"],
        "bound_ms": u8["bound_ms"],
        "bound_by": u8["bound_by"],
        "library_ms": u8["library_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
