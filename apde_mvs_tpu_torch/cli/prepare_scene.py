"""Scene preparation CLI (reference: prepare_scene.py): normalize one or many
scan directories to the canonical `images/` layout."""

from __future__ import annotations

import argparse
import os
import sys

from ..datasets import layout


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="apde-prepare-scene")
    p.add_argument("--data_dir", type=str, default=None,
                   help="root containing scan subdirectories")
    p.add_argument("--scan_dir", type=str, nargs="+", default=[],
                   help="explicit scan directories")
    p.add_argument("--image_dir_name", type=str, nargs="+",
                   default=["images", "undist/images"])
    p.add_argument("--image_suffixes", type=str, nargs="+",
                   default=[".jpg", ".jpeg", ".png"])
    p.add_argument("--no_image_symlink", action="store_true", default=False)
    return p


def prepare(scan_dir: str, candidates, suffixes, link: bool) -> bool:
    try:
        canonical = layout.normalize_image_dir(scan_dir, candidates, link=link)
        n = layout.count_images(scan_dir, candidates, suffixes)
    except (FileNotFoundError, FileExistsError) as exc:
        print(f"[{scan_dir}] failed: {exc}")
        return False
    print(f"[{scan_dir}] images -> {canonical} ({n} files)")
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    scans = list(args.scan_dir)
    if args.data_dir:
        scans += [os.path.join(args.data_dir, d)
                  for d in sorted(os.listdir(args.data_dir))
                  if os.path.isdir(os.path.join(args.data_dir, d))]
    if not scans:
        print("nothing to prepare (pass --data_dir or --scan_dir)")
        return 1
    ok = sum(prepare(s, args.image_dir_name, args.image_suffixes,
                     not args.no_image_symlink) for s in scans)
    print(f"{ok}/{len(scans)} scans prepared")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
