"""Submission-layout result collectors (reference:
tools/collect_{dtu,eth,tat}_result.py): copy each scan's APD.ply into the
benchmark's expected naming scheme."""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys


def collect_dtu(data_dir: str, out_dir: str) -> None:
    """DTU: scanN/APD/APD.ply -> apd{N:03d}_l3.ply."""
    os.makedirs(out_dir, exist_ok=True)
    for scan in sorted(os.listdir(data_dir)):
        m = re.match(r"scan(\d+)", scan)
        src = os.path.join(data_dir, scan, "APD", "APD.ply")
        if m and os.path.exists(src):
            dst = os.path.join(out_dir, f"apd{int(m.group(1)):03d}_l3.ply")
            shutil.copyfile(src, dst)
            print(f"{src} -> {dst}")


def collect_eth(data_dir: str, out_dir: str) -> None:
    """ETH3D: <scan>.ply + <scan>.txt runtime file."""
    os.makedirs(out_dir, exist_ok=True)
    for scan in sorted(os.listdir(data_dir)):
        src = os.path.join(data_dir, scan, "APD", "APD.ply")
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out_dir, f"{scan}.ply"))
            with open(os.path.join(out_dir, f"{scan}.txt"), "w") as f:
                f.write("runtime 0.0\n")
            print(f"collected {scan}")


def collect_tat(data_dir: str, out_dir: str) -> None:
    """Tanks and Temples: <scan>.ply + <scan>.log."""
    os.makedirs(out_dir, exist_ok=True)
    for scan in sorted(os.listdir(data_dir)):
        src = os.path.join(data_dir, scan, "APD", "APD.ply")
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out_dir, f"{scan}.ply"))
            log_src = os.path.join(data_dir, scan, f"{scan}.log")
            log_dst = os.path.join(out_dir, f"{scan}.log")
            if os.path.exists(log_src):
                shutil.copyfile(log_src, log_dst)
            else:
                with open(log_dst, "w") as f:
                    f.write("")
            print(f"collected {scan}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("benchmark", choices=["dtu", "eth", "tat"])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    {"dtu": collect_dtu, "eth": collect_eth, "tat": collect_tat}[
        args.benchmark](args.data_dir, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
