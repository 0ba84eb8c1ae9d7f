"""The plain reference of one view's pass.

`plain` is a frozen copy of the port's plain route (its CPU route: the
torch-op forms every hand kernel is held bitwise to), cut to what one
view's pass reaches: the plain version of each kernel called directly,
none of the kernels' wrappers, counters or checks, and no sharded or
debug route. `tests/test_mvsbench_copy.py` holds it bitwise to the port's
plain route on every kind of pass. Here it runs on the run's device from the raw scan (the images
as the engine's reader gives them, the cameras read from the scan's
files, the SA maps and the priors), builds its own tables and draws its
pass from its own generator seeded with the step's pass seed. ``lower``
gives the control: the same pass with its planes and costs rounded to
bfloat16 after the initial cost and after every sweep.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .plain import config as plain_config
from .plain.core import geometry as geo
from .plain.io.cameras import read_camera
from .plain.io.images import resize_bilinear, resize_nearest, scaled_size
from .plain.ops.cost import CostData
from .plain.pipeline.full_pass import PassStatic, full_pass, prior_state

PAD = 8


class Maps(NamedTuple):
    depth: np.ndarray        # (H, W) f32
    normal: np.ndarray       # (H, W, 3)
    weak: np.ndarray         # (H, W) uint8
    confidence: np.ndarray   # (H, W) uint8
    cost: np.ndarray         # (H, W) f32


def schedule_pass(cfg: dict, traffic: dict):
    sched = plain_config.build_schedule(
        max(int(cfg["height"]), int(cfg["width"])), cfg["dataset"],
        use_sa=bool(cfg["use_sa"]), sampler_u8=bool(cfg["sampler_u8"]),
        base=int(cfg.get("pyramid_base", 800)))
    rounds = sched[-1].round_index + 1
    r = int(traffic["round"]) % rounds
    return [s for s in sched if s.round_index == r][int(traffic["pass_in_round"])]


def _pad(a: np.ndarray, mode="edge") -> np.ndarray:
    h, w = a.shape[:2]
    pad = [(0, (-h) % PAD), (0, (-w) % PAD)] + [(0, 0)] * (a.ndim - 2)
    return a if not (pad[0][1] or pad[1][1]) else np.pad(a, pad, mode=mode)


def _scaled(scan, v: int, scale: int):
    img = scan.gray[v]
    cam = read_camera(scan.root / "cams" / f"{v:08d}_cam.txt")
    h, w = img.shape
    if scale != 1:
        nh, nw = scaled_size(h, w, scale)
        return resize_bilinear(img, (nh, nw)), cam.scaled(nw / w, nh / h,
                                                          nw, nh)
    return img, dataclasses.replace(cam, width=w, height=h)


def run_pass(scan, view: int, spec, seed: int, device,
             lower: bool = False) -> Maps:
    """View ``view``'s pass of ``spec`` (a schedule entry of the frozen
    configuration) with pass seed ``seed``; maps cropped to the image."""
    params = spec.params
    use_apd = params.use_apd and params.state != "first_init"
    ref_img, ref_cam = _scaled(scan, view, spec.scale_size)
    src = [_scaled(scan, s, spec.scale_size) for s in scan.sources[view]]
    h, w = ref_img.shape

    def resized(mat):
        return mat if mat.shape[:2] == (h, w) else resize_nearest(mat, (h, w))

    def dev(a):
        return torch.as_tensor(a, device=device)

    ref_p = _pad(ref_img)
    ph, pw = ref_p.shape
    valid = np.zeros((ph, pw), bool)
    valid[:h, :w] = True
    src_imgs = np.stack([_pad(s[0]) for s in src])
    src_depths = None
    if params.geom_consistency or params.use_apd:
        src_depths = dev(np.stack([
            _pad(resized(scan.priors[s]["depths"]).astype(np.float32),
                 "constant") for s in scan.sources[view]]))
    sa = None
    if use_apd and params.use_sa:
        sa = dev(_pad(resized(scan.sa[view]).astype(np.int32), "constant"))
    prior = scan.priors[view]
    priors = {}
    if params.state != "first_init":
        priors["prior_depth"] = _pad(resized(prior["depths"]).astype(
            np.float32), "constant")
        priors["prior_normal"] = _pad(resized(prior["normals"]).astype(
            np.float32), "constant")
    if use_apd:
        priors["prior_weak"] = _pad(resized(prior["weak"]).astype(np.int32),
                                    "constant")
        priors["prior_confidence"] = _pad(resized(
            prior["confidence"]).astype(np.float32), "constant")
    cams = geo.CameraArrays.from_cameras([ref_cam] + [c for _, c in src],
                                         device=device)
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]),
        dev(ref_p.astype(np.float32)), dev(src_imgs.astype(np.float32)),
        src_depths=src_depths, real_width=w, real_height=h,
        sampler_u8=params.sampler_u8, sa_mask=sa)

    cfg = PassStatic.from_params(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dmin = geo.f32_scalar(ref_cam.depth_min * plain_config.DEPTH_MIN_FACTOR,
                          device)
    dmax = geo.f32_scalar(ref_cam.depth_max * plain_config.DEPTH_MAX_FACTOR,
                          device)
    state = prior_state(data, cfg, valid=dev(valid), **priors)
    state, _ = full_pass(data, state, cfg, dmin, dmax, gen, lower=lower)
    planes = state.planes.cpu().numpy()
    return Maps(
        depth=planes[:h, :w, 3].copy(), normal=planes[:h, :w, :3].copy(),
        weak=state.weak.cpu().numpy().astype(np.uint8)[:h, :w],
        confidence=np.clip(state.confidence.cpu().numpy(), 0, 255).astype(
            np.uint8)[:h, :w],
        cost=state.costs.cpu().numpy()[:h, :w])
