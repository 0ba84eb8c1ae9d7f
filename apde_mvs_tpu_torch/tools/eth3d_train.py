"""One-command ETH3D training-set pipeline: layout-normalize the raw
undistorted scans, convert COLMAP models to MVSNet scenes, reconstruct and
fuse through the batch scheduler (`cli.run`, which starts the port's engine
per scan), and (optionally) evaluate against ground truth:

    python -m apde_mvs_tpu_torch.tools.eth3d_train \
        --eth3d_dir /data/ETH3D --work_dir /data/ETH3D_mvs \
        --gt_dir /data/ETH3D_gt [-- <cli.run arguments>]

(reference protocol: run.py:94-138 drives converted scans; evaluation via
tools/eval_eth_train.py:39-48 with the official ETH3DMultiViewEvaluation
binary). `--skip_eval` stops after fusion for environments without the
binary. The scheduler does not report the engine's exit status, so check a
scan's `APD/log.txt` and `APD/APD.ply`. The chain is drilled on a
fabricated scan (testing.eth3d_fixture, tests/test_torch_batch.py)."""

from __future__ import annotations

import argparse
import os
import sys


def run_pipeline(eth3d_dir: str, work_dir: str, gt_dir: str = "",
                 scans=None, eval_bin: str = "ETH3DMultiViewEvaluation",
                 skip_eval: bool = False, max_d: int = 192,
                 run_args=None) -> int:
    from ..datasets import layout
    from ..datasets.colmap import convert_scene
    from ..cli import run as run_cli

    scans = scans or sorted(
        d for d in os.listdir(eth3d_dir)
        if os.path.isdir(os.path.join(eth3d_dir, d)))
    os.makedirs(work_dir, exist_ok=True)

    for scan in scans:
        scan_dir = os.path.join(eth3d_dir, scan)
        out_dir = os.path.join(work_dir, scan)
        if os.path.exists(os.path.join(out_dir, "pair.txt")):
            print(f"[eth3d] {scan}: already converted", flush=True)
            continue
        layout.normalize_sparse_dir(scan_dir)
        print(f"[eth3d] converting {scan}", flush=True)
        convert_scene(scan_dir, out_dir, model_ext=".txt", max_d=max_d)

    argv = ["--data_dir", work_dir] + list(run_args or [])
    print(f"[eth3d] reconstructing: run {' '.join(argv)}", flush=True)
    rc = run_cli.main(argv)
    if rc:
        return rc

    if skip_eval or not gt_dir:
        print("[eth3d] evaluation skipped", flush=True)
        return 0
    from . import eval_eth
    return eval_eth.main(["--data_dir", work_dir, "--gt_dir", gt_dir,
                          "--eval_bin", eval_bin, "--scans"] + list(scans))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="ETH3D train pipeline: convert -> run -> fuse -> eval")
    p.add_argument("--eth3d_dir", required=True,
                   help="root of raw undistorted ETH3D scans")
    p.add_argument("--work_dir", required=True,
                   help="output root for converted MVSNet scenes + results")
    p.add_argument("--gt_dir", default="",
                   help="ground-truth root (<scan>/dslr_scan_eval/...)")
    p.add_argument("--scans", nargs="+", default=None)
    p.add_argument("--eval_bin", default="ETH3DMultiViewEvaluation")
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("run_args", nargs="*",
                   help="extra args forwarded to cli.run (after --)")
    args = p.parse_args(argv)
    return run_pipeline(args.eth3d_dir, args.work_dir, args.gt_dir,
                        scans=args.scans, eval_bin=args.eval_bin,
                        skip_eval=args.skip_eval, max_d=args.max_d,
                        run_args=args.run_args)


if __name__ == "__main__":
    sys.exit(main())
