"""Anchor inspection tool (reference: tools/anchor_vis.py).

Reads the `anchors_map.bin` / `anchors.bin` exports (and optionally the SA
mask) of a view and renders anchor sets. Works headless: `--point x,y` dumps
one pixel's anchors to stdout / an overlay PNG; `--interactive` opens the
click-to-inspect matplotlib UI when a display is available.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

from ..config import ANCHOR_NUM
from ..io.binmat import read_bin_mat
from ..io.images import read_image_color, write_image


def read_anchors(anchors_path) -> np.ndarray:
    """anchors.bin: int32 weak_count, int32 anchor_num, int16 (x, y) pairs."""
    with open(anchors_path, "rb") as f:
        weak_count, anchor_num = np.fromfile(f, np.int32, 2)
        data = np.fromfile(f, np.int16, weak_count * anchor_num * 2)
    return data.reshape(weak_count, anchor_num, 2)


def anchors_of_pixel(anchors_map: np.ndarray, anchors: np.ndarray,
                     x: int, y: int) -> Optional[np.ndarray]:
    idx = int(anchors_map[y, x])
    if idx < 0:
        return None
    return anchors[idx]


def ncc_window_taps(cx: int, cy: int, h: int, w: int, increment: int,
                    sa_mask: Optional[np.ndarray] = None,
                    center_sa: int = 0) -> List[Tuple[int, int, bool]]:
    """In-image NCC window taps around (cx, cy) — radius 5, the weak
    center's increment 2 / anchors' increment 5 (reference:
    tools/anchor_vis.py:143-181). Returns (x, y, same_segment) triples;
    same_segment is True without an SA mask."""
    taps = []
    for j in range(-5, 6, increment):
        for k in range(-5, 6, increment):
            if j == 0 and k == 0:
                continue
            tx, ty = cx + j, cy + k
            if tx < 0 or tx >= w or ty < 0 or ty >= h:
                continue
            same = True if sa_mask is None \
                else bool(sa_mask[ty, tx] == center_sa)
            taps.append((tx, ty, same))
    return taps


def render_overlay(image: np.ndarray, anchor_set: np.ndarray,
                   point: Tuple[int, int], radius: int = 2,
                   sa_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Anchor + NCC-window-tap overlay (reference colors: green center /
    light-green center taps, red anchors / khaki anchor taps, blue taps
    falling outside the center's SA segment)."""
    out = image.copy()
    h, w = out.shape[:2]

    def mark(x, y, color, r=radius):
        y0, y1 = max(0, y - r), min(h, y + r + 1)
        x0, x1 = max(0, x - r), min(w, x + r + 1)
        out[y0:y1, x0:x1] = color

    center_sa = int(sa_mask[point[1], point[0]]) if sa_mask is not None else 0
    # the weak center's dense window (radius 5, increment 2)
    for tx, ty, same in ncc_window_taps(point[0], point[1], h, w, 2,
                                        sa_mask, center_sa):
        mark(tx, ty, (144, 238, 144) if same else (225, 105, 65), r=1)
    mark(point[0], point[1], (0, 100, 0))
    for k in range(1, anchor_set.shape[0]):
        ax, ay = int(anchor_set[k, 0]), int(anchor_set[k, 1])
        if ax < 0 or ay < 0:
            continue
        if sa_mask is not None and int(sa_mask[ay, ax]) != center_sa:
            continue
        # each anchor's sparse window (radius 5, increment 5)
        for tx, ty, same in ncc_window_taps(ax, ay, h, w, 5, sa_mask,
                                            center_sa):
            mark(tx, ty, (140, 230, 240) if same else (225, 105, 65), r=1)
        mark(ax, ay, (34, 34, 178))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--result_folder", required=True,
                   help="<scan>/APD/<view> folder with anchors exports")
    p.add_argument("--image", default=None, help="background image")
    p.add_argument("--point", default=None, help="x,y pixel to inspect")
    p.add_argument("--out", default=None, help="overlay PNG output path")
    p.add_argument("--sa_mask", default=None,
                   help="SA segment mask bin (colors window taps crossing "
                        "the segment boundary)")
    p.add_argument("--interactive", action="store_true")
    args = p.parse_args(argv)

    anchors_map = read_bin_mat(
        os.path.join(args.result_folder, "anchors_map.bin"))
    anchors = read_anchors(os.path.join(args.result_folder, "anchors.bin"))
    sa_mask = read_bin_mat(args.sa_mask) if args.sa_mask else None
    print(f"{anchors.shape[0]} weak pixels, {anchors.shape[1]} anchors each")

    if args.point:
        x, y = (int(v) for v in args.point.split(","))
        a = anchors_of_pixel(anchors_map, anchors, x, y)
        if a is None:
            print(f"({x}, {y}) is not a weak pixel")
            return 1
        print(f"anchors of ({x}, {y}):")
        for k in range(a.shape[0]):
            print(f"  [{k}] ({a[k, 0]}, {a[k, 1]})")
        if args.out:
            if args.image:
                img = read_image_color(args.image)
            else:
                img = np.full(anchors_map.shape + (3,), 32, np.uint8)
            write_image(args.out, render_overlay(img, a, (x, y),
                                                 sa_mask=sa_mask))
            print(f"overlay -> {args.out}")
        return 0

    if args.interactive:
        import matplotlib.pyplot as plt
        img = read_image_color(args.image)[..., ::-1] if args.image else \
            np.full(anchors_map.shape + (3,), 32, np.uint8)
        fig, ax = plt.subplots()
        ax.imshow(img)

        def on_click(event):
            if event.xdata is None:
                return
            x, y = int(event.xdata), int(event.ydata)
            a = anchors_of_pixel(anchors_map, anchors, x, y)
            ax.clear()
            ax.imshow(img)
            if a is not None:
                h, w = anchors_map.shape
                center_sa = int(sa_mask[y, x]) if sa_mask is not None else 0
                # NCC window taps (reference anchor_vis.py:143-181 palette)
                taps = ncc_window_taps(x, y, h, w, 2, sa_mask, center_sa)
                if taps:
                    t = np.asarray([(tx, ty) for tx, ty, _ in taps])
                    same = np.asarray([s for _, _, s in taps])
                    ax.scatter(t[same, 0], t[same, 1], c="lightgreen", s=8)
                    ax.scatter(t[~same, 0], t[~same, 1], c="royalblue", s=8)
                ax.scatter([x], [y], c="darkgreen", s=20)
                valid = a[1:][(a[1:, 0] >= 0)]
                for axx, ayy in valid:
                    if sa_mask is not None \
                            and int(sa_mask[ayy, axx]) != center_sa:
                        continue
                    taps = ncc_window_taps(int(axx), int(ayy), h, w, 5,
                                           sa_mask, center_sa)
                    for tx, ty, s in taps:
                        ax.scatter([tx], [ty],
                                   c="khaki" if s else "royalblue", s=8)
                ax.scatter(valid[:, 0], valid[:, 1], c="firebrick", s=12)
            fig.canvas.draw_idle()

        fig.canvas.mpl_connect("button_press_event", on_click)
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
