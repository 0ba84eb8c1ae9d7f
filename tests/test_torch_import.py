"""The PyTorch port's package boundary and host side: importing it loads no
JAX and nothing of apde_mvs_tpu; its stdlib PNG codec reads what PIL
writes; the JAX-state converter and the device binding behave, and every
entry point runs on the card unless the caller asks for the CPU."""

import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import apde_mvs_tpu_torch
from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.cli import apd
from apde_mvs_tpu_torch.core.platform import bind_device, profile_trace
from apde_mvs_tpu_torch.datasets.sam import SAMRunner
from apde_mvs_tpu_torch.io import images
from apde_mvs_tpu_torch.pipeline import driver, fusion
from apde_mvs_tpu_torch.tools import debug_point

ROOT = Path(__file__).resolve().parents[1]


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        apde_mvs_tpu_torch.__path__, "apde_mvs_tpu_torch."))


def test_import_loads_no_jax_or_jax_package():
    mods = ["apde_mvs_tpu_torch"] + _submodules()
    assert "apde_mvs_tpu_torch.ops.cuda.sampler" in mods
    assert {"apde_mvs_tpu_torch.pipeline.full_pass",
            "apde_mvs_tpu_torch.pipeline.scan_parallel",
            "apde_mvs_tpu_torch.parallel.distributed",
            "apde_mvs_tpu_torch.parallel.mesh",
            "apde_mvs_tpu_torch.parallel.scene",
            "apde_mvs_tpu_torch.parallel.tile_pass",
            "apde_mvs_tpu_torch.parallel.tiles",
            "apde_mvs_tpu_torch.testing.ranks"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'apde_mvs_tpu'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_codec_reads_pil_files(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(0)
    shape = {"L": (37, 53), "LA": (37, 53, 2), "RGB": (37, 53, 3),
             "RGBA": (37, 53, 4)}[mode]
    # smooth + noisy content so PIL's adaptive filtering picks several
    # filter types
    ramp = np.add.outer(np.arange(37), np.arange(53)) * 3
    arr = (ramp.reshape(37, 53, *([1] * (len(shape) - 2)))
           + rng.integers(0, 40, shape)).astype(np.uint8)
    path = tmp_path / "x.png"
    Image.fromarray(arr).save(path)
    got = images.read_png(path)
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), np.float32)
    gray = (rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587
            + rgb[..., 2] * 0.114).astype(np.float32)
    np.testing.assert_array_equal(images.read_image_gray(path), gray)


def test_png_codec_roundtrip_bgr(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (20, 31, 3)).astype(np.uint8)
    path = tmp_path / "c.png"
    images.write_image(path, bgr)
    np.testing.assert_array_equal(images.read_image_color(path), bgr)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), bgr[..., ::-1])


def test_convert_builds_port_state():
    rng = np.random.default_rng(2)
    K = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    R = rng.normal(size=(3, 3, 3)).astype(np.float32)
    t = rng.normal(size=(3, 3)).astype(np.float32)
    c = rng.normal(size=(3, 3)).astype(np.float32)
    quads = rng.integers(0, 256, (2, 8 * 6, 4)).astype(np.uint8)
    data = convert.cost_data(
        ref_cam=(K[0], R[0], t[0], c[0]), src_cams=(K[1:], R[1:], t[1:],
                                                    c[1:]),
        ref_image=rng.uniform(0, 255, (6, 8)), src_quads=quads,
        src_depths=np.zeros((2, 6, 8)), width=8, height=6, real_width=7,
        real_height=5, device="cpu")
    assert data.num_src == 2 and data.img_w == 7 and data.img_h == 5
    assert data.src_quads.dtype == torch.uint8
    np.testing.assert_array_equal(data.src_quads.numpy(), quads)
    assert data.ref_image.dtype == torch.float32
    state = convert.pm_state(
        planes=np.zeros((6, 8, 4)), costs=np.ones((6, 8)),
        selected=np.zeros((6, 8, 2), bool), view_weights=np.zeros((6, 8, 2)),
        weak=np.ones((6, 8)), confidence=np.ones((6, 8)),
        valid=np.ones((6, 8), bool), device="cpu")
    assert state.weak.dtype == torch.int32
    assert state.selected.dtype == torch.bool


def test_bind_device(monkeypatch):
    assert bind_device(0, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        bind_device(0, "tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        bind_device(0, "cuda")


@pytest.mark.parametrize("fn", [
    driver.run_scan, driver.process_problem, fusion.run_fusion,
    fusion.load_fusion_views, convert.camera_arrays, convert.cost_data,
    convert.pm_state, debug_point.inspect_point, SAMRunner, profile_trace],
    ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_cuda():
    args = apd.build_parser().parse_args(["--dense_folder", "scan"])
    assert args.device == "cuda"
