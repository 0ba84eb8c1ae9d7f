"""Single-pixel cost inspection (the runtime analogue of the reference's
compile-time DEBUG_POINT_X/Y hooks, main.h:43-44 / DEBUG_COST_LINE,
APD.h:187-189 — but usable without recompiling).

Loads a scan's current state for one reference view and prints, for one
pixel: its plane hypothesis, per-source-view NCC and geometric-consistency
costs, and the 61-sample reliability curve. The costs are evaluated with
the engine's own ops on ``--device`` (default the card, where every NCC
samples through the CUDA sampler).

Usage:
    python -m apde_mvs_tpu_torch.tools.debug_point --dense_folder <scan> \
        --view 3 --point 417,266 [--scale 1] [--geom] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

STATE_NAMES = {0: "WEAK", 1: "STRONG", 2: "UNKNOWN"}


def inspect_point(dense_folder, view: int, x: int, y: int, scale: int = 1,
                  geom: bool = False, sampler_u8: bool = True,
                  device="cuda") -> dict:
    """The pixel's stored depth / normal / state, its per-source-view NCC
    (and, with ``geom``, geometric) costs at its current plane, the 61-step
    reliability curve around its depth and the class that curve gives
    (all views selected, unit weights, weak peak radius 2)."""
    import torch

    from ..core import geometry as geo
    from ..io.binmat import read_bin_mat
    from ..io.images import resize_nearest
    from ..ops import filters
    from ..ops.cost import CostData, geom_cost, ncc_strong, \
        precompute_ref_window
    from ..ops.state import PMState
    from ..pipeline import driver as drv

    problems = drv.generate_sample_list(dense_folder)
    problem = next(pb for pb in problems if pb.ref_image_id == view)
    ref_img, ref_cam = drv._load_scaled_view(problem, problem.ref_image_id,
                                             scale, None)
    src = [drv._load_scaled_view(problem, sid, scale, None)
           for sid in problem.src_image_ids]
    h, w = ref_img.shape

    def load(path):
        mat = read_bin_mat(path)
        return resize_nearest(mat, (h, w)) if mat.shape[:2] != (h, w) \
            else mat
    depth = load(problem.result_folder / "depths.bin")
    normal = load(problem.result_folder / "normals.bin")
    weak = load(problem.result_folder / "weak.bin")

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    src_depths = None
    if geom:
        src_depths = dev(np.stack([
            load(problem.dense_folder / "APD" / f"{sid:08d}" / "depths.bin")
            for sid in problem.src_image_ids]).astype(np.float32))
    cams = geo.CameraArrays.from_cameras([ref_cam] + [c for _, c in src],
                                         device=device)
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]),
        dev(ref_img.astype(np.float32)),
        dev(np.stack([s[0] for s in src]).astype(np.float32)),
        src_depths=src_depths, real_width=w, real_height=h,
        sampler_u8=sampler_u8)

    planes = filters.depth_normal_to_planes(
        data, dev(depth.astype(np.float32)), dev(normal.astype(np.float32)))
    plane = planes[y, x][None]
    xf = torch.tensor([float(x)], device=device)
    yf = torch.tensor([float(y)], device=device)
    win = precompute_ref_window(data, xf, yf, 5, 2, False)
    out = dict(depth=float(depth[y, x]), normal=np.asarray(normal[y, x]),
               state=STATE_NAMES.get(int(weak[y, x]), "?"),
               ncc=ncc_strong(data, xf, yf, plane, win,
                              site="debug_point")[0].cpu().numpy(),
               geom=None, src_ids=list(problem.src_image_ids))
    if geom:
        out["geom"] = geom_cost(data, xf, yf, plane)[0].cpu().numpy()

    # reliability curve (the DEBUG_COST_LINE analogue)
    S = data.num_src
    st = PMState.create(h, w, S, device=device).replace(
        planes=planes,
        selected=torch.ones((h, w, S), dtype=torch.bool, device=device),
        view_weights=torch.ones((h, w, S), device=device))
    depth_lo = np.float32(depth[depth > 0].min() * 0.6
                          if (depth > 0).any() else 0)
    depth_hi = np.float32(depth.max() * 1.2 + 1e-6)
    new_weak, curve = filters.depth_to_weak(
        data, st, torch.tensor([x], dtype=torch.int32, device=device),
        torch.tensor([y], dtype=torch.int32, device=device), 2, geom,
        0.2, float(depth_lo), float(depth_hi), return_curve=True,
        use_sa=False)
    out["curve"] = curve[0].cpu().numpy()
    out["reclass"] = STATE_NAMES.get(int(new_weak[0]), "?")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--view", type=int, required=True)
    p.add_argument("--point", required=True, help="x,y pixel")
    p.add_argument("--scale", type=int, default=1,
                   help="pyramid scale_size to inspect at")
    p.add_argument("--geom", action="store_true",
                   help="include geometric-consistency costs")
    p.add_argument("--sampler", choices=("u8", "f32"), default="u8",
                   help="sampling-table dtype; must match what the engine "
                        "ran with (cli defaults to u8) or the printed costs "
                        "will not reproduce the engine's")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="compute device; cuda raises when no card is "
                        "visible")
    p.add_argument("--gpu_index", type=int, default=0)
    args = p.parse_args(argv)

    from ..core.platform import bind_device

    device = bind_device(args.gpu_index, args.device)
    x, y = (int(v) for v in args.point.split(","))
    r = inspect_point(args.dense_folder, args.view, x, y, scale=args.scale,
                      geom=args.geom, sampler_u8=(args.sampler == "u8"),
                      device=device)
    print(f"pixel ({x}, {y}) of view {args.view} at scale 1/{args.scale}:")
    print(f"  depth   : {r['depth']:.6f}")
    print(f"  normal  : {r['normal']}")
    print(f"  state   : {r['state']}")
    print("  per-view NCC cost:")
    for i, sid in enumerate(r["src_ids"]):
        print(f"    src {sid:3d}: ncc={r['ncc'][i]:.4f}")
    if args.geom:
        print("  per-view geometric cost:")
        for i, sid in enumerate(r["src_ids"]):
            print(f"    src {sid:3d}: geom={r['geom'][i]:.4f}")
    c = r["curve"]
    print(f"  reliability curve (61 samples, center=current depth): "
          f"min={c.min():.4f} at offset {int(c.argmin()) - 30}")
    print("   ", " ".join(f"{v:.2f}" for v in c))
    print(f"  reclassification -> {r['reclass']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
