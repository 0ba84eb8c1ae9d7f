"""SAM segmentation-mask plug-in (reference: tools/run_SAM.py).

Generates per-image instance-id masks (`sa_masks/<id>.bin` in the bin-mat
ABI + a color PNG) used by the SA-gated NCC windows. Requires the optional
`segment_anything` package + a checkpoint; both are gated so the rest of the
framework works without them. The model runs on an explicit ``device``
(default ``cuda``); images are read through the port's `io.images` and
downscaled past ``max_size`` with its bilinear resize.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..io.binmat import write_bin_mat
from ..io.images import read_image_color, resize_bilinear, write_image

_CHECKPOINT_URLS = {
    "vit_h": "https://dl.fbaipublicfiles.com/segment_anything/sam_vit_h_4b8939.pth",
    "vit_l": "https://dl.fbaipublicfiles.com/segment_anything/sam_vit_l_0b3195.pth",
    "vit_b": "https://dl.fbaipublicfiles.com/segment_anything/sam_vit_b_01ec64.pth",
}


def sam_available() -> bool:
    try:
        import segment_anything  # noqa: F401
        return True
    except ImportError:
        return False


def masks_to_instance_map(masks: List[dict], shape) -> np.ndarray:
    """Rasterize SAM annotations (area-descending) into a uint8 instance-id
    map; 0 = background (reference: save_anns, tools/run_SAM.py:53-71)."""
    out = np.zeros(shape[:2], np.uint8)
    for i, ann in enumerate(sorted(masks, key=lambda a: a["area"],
                                   reverse=True)):
        out[ann["segmentation"]] = min(i + 1, 255)
    return out


def prepare_checkpoint(model: str = "vit_h",
                       checkpoint_dir: str = "checkpoints") -> str:
    if model not in _CHECKPOINT_URLS:
        raise NotImplementedError(model)
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"{model}.pth")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SAM checkpoint missing at {path}; download from "
            f"{_CHECKPOINT_URLS[model]}")
    return path


class SAMRunner:
    """Per-scan mask generation (reference: SAMRunner, tools/run_SAM.py:92-113)."""

    def __init__(self, work_dir: str, scans: List[str],
                 model_type: str = "vit_h", max_size: int = 2560,
                 checkpoint_dir: str = "checkpoints", device="cuda"):
        self.work_dir = work_dir
        self.scans = scans
        self.model_type = model_type
        self.max_size = max_size
        self.checkpoint_dir = checkpoint_dir
        self.device = device

    def run(self) -> None:
        if not sam_available():
            print("segment_anything not installed; skipping SAM masks "
                  "(engine falls back to use_sa=false behavior)")
            return
        from segment_anything import SamAutomaticMaskGenerator, \
            sam_model_registry

        ckpt = prepare_checkpoint(self.model_type, self.checkpoint_dir)
        sam = sam_model_registry[self.model_type](checkpoint=ckpt)
        sam.to(device=self.device)
        gen = SamAutomaticMaskGenerator(sam)
        print("SAM model loaded")
        for scan in self.scans:
            scan_path = os.path.join(self.work_dir, scan)
            image_folder = os.path.join(scan_path, "images")
            if not os.path.exists(image_folder):
                raise FileNotFoundError(f"no images/ for scan {scan}")
            mask_folder = os.path.join(scan_path, "sa_masks")
            os.makedirs(mask_folder, exist_ok=True)
            for name in sorted(os.listdir(image_folder)):
                stem = name.split(".")[0]
                rgb = read_image_color(
                    os.path.join(image_folder, name))[..., ::-1]
                if max(rgb.shape[:2]) > self.max_size:
                    scale = self.max_size / max(rgb.shape[:2])
                    new = (int(rgb.shape[0] * scale), int(rgb.shape[1] * scale))
                    rgb = resize_bilinear(rgb, new)
                rgb = np.ascontiguousarray(rgb)
                masks = gen.generate(rgb)
                inst = masks_to_instance_map(masks, rgb.shape)
                write_bin_mat(os.path.join(mask_folder, stem + ".bin"), inst)
                rng = np.random.default_rng(0)
                palette = rng.integers(0, 255, size=(256, 3)).astype(np.uint8)
                palette[0] = 255
                write_image(os.path.join(mask_folder, stem + ".png"),
                            palette[inst])
            print(f"SAM masks written for scan {scan}")
