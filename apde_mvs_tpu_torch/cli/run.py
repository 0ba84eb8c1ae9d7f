"""Batch reconstruction scheduler (reference: run.py).

Schedules scans over a pool of worker processes bound to device slots
(`--device_num x --work_num`; `--gpu_num` is accepted as an alias),
LPT-ordered by image count; lazily generates SAM masks; builds and executes
the per-scan engine command (by default the port's engine CLI) with log
redirection; supports resume / review / reservation / code backup.

A worker does not look at the engine's exit status (as in the reference):
callers check a scan's outputs (`APD/log.txt`, `APD/APD.ply`), not this
command's return code.

Usage:
    python -m apde_mvs_tpu_torch.cli.run --data_dir /data/ETH3D \
        --ETH3D_train ...
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
import subprocess
import sys
import time

from .. import config as cfg
from ..datasets import layout


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="apde-run")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--engine_cmd", type=str,
                   default=f"{sys.executable} -m apde_mvs_tpu_torch.cli.apd",
                   help="per-scan engine command (APD_path equivalent)")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--device_num", "--gpu_num", type=int, default=1,
                   dest="device_num")
    p.add_argument("--work_num", type=int, default=1)
    p.add_argument("--scans", type=str, nargs="+", default=[])
    p.add_argument("--reservation", type=str, default=None,
                   help="delayed start, e.g. 3h30m10s")
    p.add_argument("--only_fuse", action="store_true", default=False)
    p.add_argument("--no_fuse", action="store_true", default=False)
    p.add_argument("--memory_cache", action="store_true", default=False)
    p.add_argument("--no_sam", action="store_true", default=False)
    p.add_argument("--no_impetus", action="store_true", default=False)
    p.add_argument("--no_weak_filter", action="store_true", default=False)
    p.add_argument("--no_color", action="store_true", default=False)
    p.add_argument("--flush", action="store_true", default=False)
    p.add_argument("--dry_run", action="store_true", default=False)
    p.add_argument("--backup_code", action="store_true", default=False)
    p.add_argument("--ETH3D_train", action="store_true", default=False)
    p.add_argument("--ETH3D_test", action="store_true", default=False)
    p.add_argument("--TaT_intermediate", action="store_true", default=False)
    p.add_argument("--TaT_advanced", action="store_true", default=False)
    p.add_argument("--view_batch", type=int, default=None,
                   help="forwarded to the engine: cap reference views per "
                        "view-parallel SPMD batch (large-scan memory bound)")
    p.add_argument("--export_anchor", action="store_true", default=False)
    p.add_argument("--export_curve", action="store_true", default=False)
    p.add_argument("--image_dir_name", type=str, nargs="+",
                   default=["images", "undist/images"])
    p.add_argument("--image_suffixes", type=str, nargs="+",
                   default=[".jpg", ".jpeg", ".png"])
    p.add_argument("--no_image_symlink", action="store_true", default=False)
    p.add_argument("--review", action="store_true", default=False)
    return p


def parse_reservation(spec: str) -> float:
    """'3h30m10s' -> seconds."""
    total, num = 0.0, ""
    for ch in spec:
        if ch.isdigit() or ch == ".":
            num += ch
        else:
            mult = {"h": 3600, "m": 60, "s": 1}.get(ch.lower())
            if mult is None or not num:
                raise ValueError(f"bad reservation spec: {spec}")
            total += float(num) * mult
            num = ""
    if num:
        total += float(num)
    return total


_positions = None
_lock = None


def _init_pool(positions, lock):
    global _positions, _lock
    _positions = positions
    _lock = lock


def _acquire_slot() -> int:
    _lock.acquire()
    try:
        for j in range(len(_positions)):
            if _positions[j] == 0:
                _positions[j] = 1
                return j
        return 0
    finally:
        _lock.release()


def _release_slot(j: int) -> None:
    _lock.acquire()
    _positions[j] = 0
    _lock.release()


def worker(args, scan: str) -> None:
    scan_dir = os.path.join(args.data_dir, scan)
    if not os.path.isdir(scan_dir):
        print(f"{scan_dir} is not a dir")
        return
    try:
        layout.normalize_image_dir(scan_dir, args.image_dir_name,
                                   link=not args.no_image_symlink)
    except (FileNotFoundError, FileExistsError) as exc:
        print(f"[{scan}] cannot prepare image directory: {exc}")
        return

    pos = _acquire_slot()
    try:
        device_index = pos // args.work_num
        dataset = cfg.infer_dataset(args.data_dir, scan)

        if not args.no_sam:
            mask_folder = os.path.join(scan_dir, "sa_masks")
            if not os.path.exists(mask_folder):
                from ..datasets.sam import SAMRunner
                SAMRunner(args.data_dir, [scan], max_size=2560).run()

        apd_path = os.path.join(scan_dir, "APD")
        os.makedirs(apd_path, exist_ok=True)
        cmd = (
            f"{args.engine_cmd} --dense_folder {scan_dir} "
            f"--gpu_index {device_index} --dataset {dataset} "
            f"--only_fuse {str(args.only_fuse).lower()} "
            f"--no_fuse {str(args.no_fuse).lower()} "
            f"--use_sa {str(not args.no_sam).lower()} "
            f"--memory_cache {str(args.memory_cache).lower()} "
            f"--flush {str(args.flush).lower()} "
            f"--export_anchor {str(args.export_anchor).lower()} "
            f"--export_curve {str(args.export_curve).lower()} "
            f"--export_color {str(not args.no_color).lower()} "
            f"--use_impetus {str(not args.no_impetus).lower()} "
            f"--weak_filter {str(not args.no_weak_filter).lower()}"
        )
        if args.view_batch:
            cmd += f" --view_batch {args.view_batch}"
        if args.device_num * args.work_num > 1:
            # slot mode: each engine process owns one device slot; the
            # engine's view-parallel auto-enable (which meshes ALL local
            # devices) would oversubscribe the chips across slots
            cmd += " --views_parallel false"
        log_path = os.path.join(apd_path, "log.txt")
        ply_path = os.path.join(apd_path, "APD.ply")
        if args.resume and os.path.exists(ply_path):
            print(f"APD result exists for {scan_dir}")
            return
        print(cmd, flush=True)
        if not args.review:
            with open(log_path, "a") as log:
                subprocess.run(cmd, shell=True, stdout=log,
                               stderr=subprocess.STDOUT)
        if args.backup_code:
            _backup_code(apd_path)
    finally:
        _release_slot(pos)


def _backup_code(apd_path: str) -> None:
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        ver = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=pkg_root, capture_output=True,
                             text=True).stdout.strip() or "unknown"
    except OSError:
        ver = "unknown"
    dst = os.path.join(apd_path, f"code_{ver}")
    os.makedirs(dst, exist_ok=True)
    for path in glob.glob(os.path.join(pkg_root, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, pkg_root)
        target = os.path.join(dst, rel)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(path, "rb") as fin, open(target, "wb") as fout:
            fout.write(fin.read())
    print(f"backup code to {dst}")


def select_scans(args):
    if args.ETH3D_train:
        return list(cfg.ETH3D_TRAIN_SCANS)
    if args.ETH3D_test:
        return list(cfg.ETH3D_TEST_SCANS)
    if args.TaT_intermediate:
        return list(cfg.TAT_INTERMEDIATE_SCANS)
    if args.TaT_advanced:
        return list(cfg.TAT_ADVANCED_SCANS)
    if args.scans:
        return list(args.scans)
    return sorted(os.listdir(args.data_dir))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    if args.reservation:
        secs = parse_reservation(args.reservation)
        print(f"sleep for reservation: {args.reservation} ({secs:.0f}s)")
        time.sleep(secs)

    counted = []
    for scan in select_scans(args):
        scan_dir = os.path.join(args.data_dir, scan)
        if not os.path.isdir(scan_dir):
            print(f"{scan_dir} is not a dir")
            continue
        try:
            if not args.no_image_symlink:
                layout.normalize_image_dir(scan_dir, args.image_dir_name)
            counted.append((scan, layout.count_images(
                scan_dir, args.image_dir_name, args.image_suffixes)))
        except (FileNotFoundError, FileExistsError) as exc:
            print(f"skip {scan_dir}: {exc}")
    if not counted:
        print("No valid scans found.")
        return 0
    counted.sort(key=lambda e: -e[1])   # LPT: largest scans first
    scans = [s for s, _ in counted]
    print(f"scans: {scans}\nscans size: {len(scans)}")
    total = min(args.work_num * args.device_num, len(scans))
    print(f"total_work_num: {total}")
    ctx = multiprocessing.get_context("spawn")
    positions = ctx.Array("i", [0] * total)
    lock = ctx.Lock()
    with ctx.Pool(processes=total, initializer=_init_pool,
                  initargs=(positions, lock)) as pool:
        for scan in scans:
            pool.apply_async(worker, args=(args, scan))
        pool.close()
        pool.join()
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
