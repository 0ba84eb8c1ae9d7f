"""Scan-directory layout normalization.

The engine expects every scan to expose its photos under ``<scan>/images``.
Captured datasets frequently keep them elsewhere (``undist/images`` is the
common COLMAP-undistortion layout), so the batch tools normalize each scan
once up front: locate the photo directory, alias it to ``images/`` via a
symlink, and report how many photos it holds (the batch scheduler orders
scans largest-first from that count).

Capability parity with the reference's layout-normalization script
(reference: scripts/dataset_loader.py); the implementation here is a small
set of path helpers rather than a loader object, since nothing about the
task carries state beyond the scan path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Tuple

DEFAULT_IMAGE_DIR_CANDIDATES: Tuple[str, ...] = ("images", "undist/images")
DEFAULT_IMAGE_SUFFIXES: Tuple[str, ...] = (".jpg", ".jpeg", ".png")


def find_image_dir(scan_dir,
                   candidates: Iterable[str] = DEFAULT_IMAGE_DIR_CANDIDATES,
                   ) -> Path:
    """First existing photo directory under `scan_dir`, tried in order."""
    scan_dir = Path(scan_dir)
    candidates = tuple(candidates)
    for cand in candidates:
        path = scan_dir.joinpath(*Path(cand).parts)
        if path.is_dir():
            return path
    raise FileNotFoundError(
        f"no image directory among {list(candidates)} under {scan_dir}")


def normalize_image_dir(scan_dir,
                        candidates: Iterable[str] = DEFAULT_IMAGE_DIR_CANDIDATES,
                        link: bool = True) -> Path:
    """Guarantee `<scan_dir>/images` exists, aliasing the real photo
    directory with a symlink when it lives elsewhere. Returns the canonical
    path; raises if it cannot be materialized."""
    scan_dir = Path(scan_dir)
    canonical = scan_dir / "images"
    if canonical.is_dir():
        return canonical
    if canonical.exists():
        raise FileExistsError(f"{canonical} exists but is not a directory")
    source = find_image_dir(scan_dir, candidates)
    if not link:
        raise FileNotFoundError(
            f"{canonical} missing and symlink creation disabled")
    # the OS resolves a relative symlink target against the link's own
    # directory, so a relative scan_dir would produce a dangling link
    canonical.symlink_to(Path(source).resolve())
    return canonical


def count_images(scan_dir,
                 candidates: Iterable[str] = DEFAULT_IMAGE_DIR_CANDIDATES,
                 suffixes: Iterable[str] = DEFAULT_IMAGE_SUFFIXES) -> int:
    """Number of photo files in the scan's image directory."""
    image_dir = find_image_dir(scan_dir, candidates)
    wanted = {("" if s.startswith(".") else ".") + s.lower()
              for s in suffixes if s}
    return sum(1 for e in image_dir.iterdir()
               if e.is_file() and e.suffix.lower() in wanted)


# ETH3D's undistorted download keeps the COLMAP model under
# dslr_calibration_undistorted/ (and photos under
# images/dslr_images_undistorted/, which the converter resolves through the
# model's relative image names); COLMAP itself writes sparse/ or sparse/0.
DEFAULT_SPARSE_DIR_CANDIDATES: Tuple[str, ...] = (
    "sparse", "sparse/0", "dslr_calibration_undistorted")


def normalize_sparse_dir(scan_dir,
                         candidates: Iterable[str] =
                         DEFAULT_SPARSE_DIR_CANDIDATES) -> Path:
    """Guarantee `<scan_dir>/sparse` exists (the COLMAP->MVSNet converter's
    model directory), aliasing the real model directory with a symlink when
    it lives elsewhere — the ETH3D-undistorted case."""
    scan_dir = Path(scan_dir)
    canonical = scan_dir / "sparse"
    if canonical.is_dir():
        return canonical
    if canonical.exists():
        raise FileExistsError(f"{canonical} exists but is not a directory")
    for cand in candidates:
        path = scan_dir.joinpath(*Path(cand).parts)
        if path.is_dir():
            canonical.symlink_to(path.resolve())
            return canonical
    raise FileNotFoundError(
        f"no COLMAP model among {list(candidates)} under {scan_dir}")
