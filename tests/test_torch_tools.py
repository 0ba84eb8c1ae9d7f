"""The port's host modules against the JAX package's: scan layout and
`prepare_scene`, the PFM codec, the COLMAP->MVSNet converter and the
ETH3D-layout fixture (with PIL, and without it through the PNG codec), the
result collectors and ETH3D evaluation parsing, the SAM plug-in with a
fake mask generator, and the batch scheduler's parser, presets,
reservations and engine command."""

import filecmp
import os
import re
import sys
import types

import numpy as np
import pytest

from apde_mvs_tpu.cli import run as jrun
from apde_mvs_tpu.datasets import colmap as jcolmap
from apde_mvs_tpu.testing import eth3d_fixture as jfixture
from apde_mvs_tpu.testing import synthetic as jsynthetic
from apde_mvs_tpu_torch.cli import prepare_scene
from apde_mvs_tpu_torch.cli import run as trun
from apde_mvs_tpu_torch.datasets import colmap as tcolmap
from apde_mvs_tpu_torch.datasets import layout
from apde_mvs_tpu_torch.datasets import sam as sam_mod
from apde_mvs_tpu_torch.io import images, pfm
from apde_mvs_tpu_torch.io.binmat import read_bin_mat
from apde_mvs_tpu_torch.testing import eth3d_fixture as tfixture
from apde_mvs_tpu_torch.testing import synthetic as tsynthetic
from apde_mvs_tpu_torch.tools import collect, eval_eth


def _touch(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"x")


# ---- layout and prepare_scene (as tests/test_layout.py) -------------------

def test_layout_find_and_normalize(tmp_path):
    _touch(tmp_path / "undist" / "images" / "00000000.jpg")
    assert layout.find_image_dir(tmp_path) == tmp_path / "undist" / "images"
    with pytest.raises(FileNotFoundError):
        layout.normalize_image_dir(tmp_path, link=False)
    canonical = layout.normalize_image_dir(tmp_path)
    assert canonical == tmp_path / "images"
    assert os.path.samefile(canonical, tmp_path / "undist" / "images")
    assert layout.normalize_image_dir(tmp_path) == canonical
    with pytest.raises(FileNotFoundError):
        layout.find_image_dir(tmp_path / "nope")


def test_layout_collision_and_relative(tmp_path, monkeypatch):
    bad = tmp_path / "bad"
    _touch(bad / "undist" / "images" / "0.jpg")
    (bad / "images").write_bytes(b"not a dir")
    with pytest.raises(FileExistsError):
        layout.normalize_image_dir(bad)
    _touch(tmp_path / "scan" / "undist" / "images" / "0.jpg")
    monkeypatch.chdir(tmp_path)
    out = layout.normalize_image_dir("scan")
    assert out.is_dir() and (out / "0.jpg").exists()


def test_layout_count_and_sparse(tmp_path):
    for name in ["a.jpg", "b.JPEG", "c.png", "d.txt", "e"]:
        _touch(tmp_path / "images" / name)
    (tmp_path / "images" / "subdir").mkdir()
    assert layout.count_images(tmp_path) == 3
    assert layout.count_images(tmp_path, suffixes=["png"]) == 1
    (tmp_path / "dslr_calibration_undistorted").mkdir()
    sparse = layout.normalize_sparse_dir(tmp_path)
    assert os.path.samefile(sparse, tmp_path / "dslr_calibration_undistorted")
    with pytest.raises(FileNotFoundError):
        layout.normalize_sparse_dir(tmp_path / "images" / "subdir")


def test_prepare_scene_cli(tmp_path, capsys):
    scan = tmp_path / "scan1"
    _touch(scan / "undist" / "images" / "00000000.jpg")
    assert prepare_scene.main(["--scan_dir", str(scan)]) == 0
    assert (scan / "images").is_dir()
    assert prepare_scene.main(["--scan_dir", str(tmp_path / "empty")]) == 1
    assert prepare_scene.main([]) == 1
    assert "nothing to prepare" in capsys.readouterr().out


# ---- pfm ------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((7, 9), -1.0), ((5, 6, 3), -1.0),
                                         ((4, 3), 1.0)])
def test_pfm_roundtrip(tmp_path, shape, scale):
    from apde_mvs_tpu.io import pfm as jpfm
    img = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    pfm.write_pfm(tmp_path / "t.pfm", img, scale=scale)
    jpfm.write_pfm(tmp_path / "j.pfm", img, scale=scale)
    assert filecmp.cmp(tmp_path / "t.pfm", tmp_path / "j.pfm", shallow=False)
    np.testing.assert_array_equal(pfm.read_pfm(tmp_path / "t.pfm"), img)
    (tmp_path / "bad.pfm").write_bytes(b"P5\n1 1\n-1\n\0\0\0\0")
    with pytest.raises(ValueError):
        pfm.read_pfm(tmp_path / "bad.pfm")


# ---- fixture and converter ------------------------------------------------

def _scenes():
    kw = dict(num_views=4, height=48, width=64)
    return jsynthetic.make_scene(**kw), tsynthetic.make_scene(**kw)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fixture_matches_jax(tmp_path):
    jscene, tscene = _scenes()
    jdir = jfixture.write_eth3d_scan(jscene, str(tmp_path / "j"), "s")
    tdir = tfixture.write_eth3d_scan(tscene, str(tmp_path / "t"), "s")
    files = _tree_files(jdir)
    assert files == _tree_files(tdir) and len(files) == 7
    for f in files:
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(tdir, f),
                           shallow=False), f


def test_fixture_marks_untriangulated_points(tmp_path):
    """At 600x800 x 11 views a few sampled points are seen by one view
    only: points3D.txt leaves them out and images.txt gives their
    observations id -1, so every other id resolves."""
    scene = tsynthetic.make_scene(num_views=11, height=600, width=800,
                                  baseline=0.12)
    scan = tfixture.write_eth3d_scan(scene, str(tmp_path), "s")
    _, imgs, pts = tcolmap.read_model(
        os.path.join(scan, "dslr_calibration_undistorted"), ".txt")
    ids = np.concatenate([im.point3D_ids for im in imgs.values()])
    assert (ids == -1).any()
    assert set(ids[ids != -1].tolist()) <= set(pts)


def _convert_both(tmp_path, tscan):
    layout.normalize_sparse_dir(tscan)
    jcolmap.convert_scene(tscan, str(tmp_path / "j_out"))
    tcolmap.convert_scene(tscan, str(tmp_path / "t_out"))
    jout, tout = tmp_path / "j_out", tmp_path / "t_out"
    cams = sorted(os.listdir(jout / "cams"))
    assert cams == sorted(os.listdir(tout / "cams")) and len(cams) == 4
    for name in cams + ["../pair.txt"]:
        assert (tout / "cams" / name).read_bytes() \
            == (jout / "cams" / name).read_bytes(), name
    return jout, tout


def test_convert_scene_matches_jax(tmp_path):
    _, tscene = _scenes()
    tscan = tfixture.write_eth3d_scan(tscene, str(tmp_path / "raw"), "s")
    jout, tout = _convert_both(tmp_path, tscan)
    names = sorted(os.listdir(jout / "images"))
    assert names == sorted(os.listdir(tout / "images"))
    assert names[0] == "00000000.jpg"
    for name in names:
        np.testing.assert_array_equal(
            images.read_image_color(tout / "images" / name),
            images.read_image_color(jout / "images" / name), err_msg=name)


def test_convert_scene_without_pil(tmp_path, monkeypatch):
    """Where PIL does not import, the fixture and the converter write
    lossless PNG through the port's codec: the converted images are the
    scene's exactly, the cameras and pairs still the JAX converter's."""
    _, tscene = _scenes()
    monkeypatch.setattr(images, "pil_available", lambda: False)
    tscan = tfixture.write_eth3d_scan(tscene, str(tmp_path / "raw"), "s")
    assert sorted(os.listdir(os.path.join(
        tscan, "images", "dslr_images_undistorted")))[0] == "DSC_0000.png"
    tout = tmp_path / "t_out"
    layout.normalize_sparse_dir(tscan)
    tcolmap.convert_scene(tscan, str(tout))
    monkeypatch.undo()
    jout = tmp_path / "j_out"
    jcolmap.convert_scene(tscan, str(jout))
    for name in sorted(os.listdir(jout / "cams")) + ["../pair.txt"]:
        assert (tout / "cams" / name).read_bytes() \
            == (jout / "cams" / name).read_bytes(), name
    assert sorted(os.listdir(tout / "images"))[0] == "00000000.png"
    for v in range(4):
        bgr = images.read_image_color(tout / "images" / f"{v:08d}.png")
        want = np.clip(tscene.images[v], 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(bgr, np.repeat(want[..., None], 3, -1))


def test_image_size_reads_png_header(tmp_path):
    images.write_png(tmp_path / "a.png", np.zeros((13, 29, 3), np.uint8))
    assert tuple(images.image_size(tmp_path / "a.png")) == (29, 13)
    from PIL import Image
    Image.new("RGB", (31, 7)).save(tmp_path / "b.jpg")
    assert tuple(images.image_size(tmp_path / "b.jpg")) == (31, 7)


# ---- collectors and evaluation parsing (as tests/test_eval_tools.py) ------

def test_parse_result_and_show(tmp_path):
    p = tmp_path / "result.txt"
    p.write_text(
        "Some header\n"
        "Tolerances: 0.01 0.02 0.05 0.1 0.2 0.5\n"
        "Completenesses: 0.5 0.6 0.7 0.8 0.9 0.95\n"
        "Accuracies: 0.8 0.85 0.9 0.92 0.95 0.99\n"
        "F1-scores: 0.61 0.7 0.78 0.85 0.92 0.96\n")
    m = eval_eth.parse_result(str(p))
    assert m["tolerances"][1] == 0.02 and m["f1"][1] == 0.7
    text = eval_eth.show({"office": m, "missing": None})
    assert "office" in text and "0.7000" in text and "AVERAGE" in text
    from apde_mvs_tpu.tools import eval_eth as jeval
    assert text == jeval.show({"office": m, "missing": None})
    assert eval_eth.parse_result(str(tmp_path / "nope.txt")) is None


def test_collectors(tmp_path):
    data = tmp_path / "data"
    for scan in ("scan9", "scan24"):
        d = data / scan / "APD"
        d.mkdir(parents=True)
        (d / "APD.ply").write_bytes(b"ply-bytes")
    out = tmp_path / "dtu"
    assert collect.main(["dtu", "--data_dir", str(data),
                         "--out_dir", str(out)]) == 0
    assert (out / "apd009_l3.ply").read_bytes() == b"ply-bytes"
    assert (out / "apd024_l3.ply").exists()
    collect.collect_eth(str(data), str(tmp_path / "eth"))
    assert (tmp_path / "eth" / "scan9.ply").exists()
    assert (tmp_path / "eth" / "scan9.txt").read_text() == "runtime 0.0\n"
    (data / "scan9" / "scan9.log").write_text("log")
    collect.collect_tat(str(data), str(tmp_path / "tat"))
    assert (tmp_path / "tat" / "scan9.log").read_text() == "log"
    assert (tmp_path / "tat" / "scan24.log").read_text() == ""


# ---- SAM plug-in (as tests/test_sam.py) -----------------------------------

def test_masks_to_instance_map():
    shape = (6, 8)
    small = np.zeros(shape, bool)
    small[0:2, 0:2] = True
    big = np.zeros(shape, bool)
    big[0:4, 0:6] = True
    mid = np.zeros(shape, bool)
    mid[4:6, 0:4] = True
    masks = [{"segmentation": small, "area": 4},
             {"segmentation": big, "area": 24},
             {"segmentation": mid, "area": 8}]
    inst = sam_mod.masks_to_instance_map(masks, shape)
    assert inst.dtype == np.uint8
    assert (inst[3, 5], inst[5, 1], inst[0, 0], inst[5, 7]) == (1, 2, 3, 0)
    many = []
    for i in range(300):
        m = np.zeros((16, 32), bool)
        m[i % 16, (i * 7) % 32] = True
        many.append({"segmentation": m, "area": 300 - i})
    assert sam_mod.masks_to_instance_map(many, (16, 32)).max() == 255


def _fake_segment_anything(monkeypatch, generate_fn, seen):
    fake = types.ModuleType("segment_anything")

    class _FakeModel:
        def __init__(self, checkpoint):
            assert os.path.exists(checkpoint)

        def to(self, device):
            seen["device"] = device
            return self

    class _FakeGen:
        def __init__(self, model):
            pass

        def generate(self, rgb):
            seen["shape"] = rgb.shape
            return generate_fn(rgb)

    fake.sam_model_registry = {k: _FakeModel for k in
                               ("vit_h", "vit_l", "vit_b")}
    fake.SamAutomaticMaskGenerator = _FakeGen
    monkeypatch.setitem(sys.modules, "segment_anything", fake)


def test_sam_runner_with_fake_generator(tmp_path, monkeypatch):
    def gen(rgb):
        h, w = rgb.shape[:2]
        a = np.zeros((h, w), bool)
        a[: h // 2] = True
        b = np.zeros((h, w), bool)
        b[h // 2:, : w // 2] = True
        return [{"segmentation": b, "area": int(b.sum())},
                {"segmentation": a, "area": int(a.sum())}]

    seen = {}
    _fake_segment_anything(monkeypatch, gen, seen)
    scan = tmp_path / "scan1"
    (scan / "images").mkdir(parents=True)
    rng = np.random.RandomState(1)
    images.write_image(scan / "images" / "00000000.png",
                       rng.randint(0, 255, (20, 30, 3)).astype(np.uint8))
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    (ckpt_dir / "vit_h.pth").write_bytes(b"fake")
    sam_mod.SAMRunner(str(tmp_path), ["scan1"], checkpoint_dir=str(ckpt_dir),
                      device="cpu").run()
    assert seen == {"device": "cpu", "shape": (20, 30, 3)}
    inst = read_bin_mat(scan / "sa_masks" / "00000000.bin")
    assert inst.shape == (20, 30)
    assert (inst[0, 0], inst[15, 0], inst[15, 29]) == (1, 2, 0)
    assert (scan / "sa_masks" / "00000000.png").exists()


def test_sam_runner_resize_and_errors(tmp_path, monkeypatch):
    seen = {}
    _fake_segment_anything(
        monkeypatch, lambda rgb: [{"segmentation": np.ones(rgb.shape[:2],
                                                           bool),
                                   "area": rgb.shape[0] * rgb.shape[1]}],
        seen)
    scan = tmp_path / "s"
    (scan / "images").mkdir(parents=True)
    images.write_image(scan / "images" / "a.png",
                       np.zeros((40, 80, 3), np.uint8))
    ckpt_dir = tmp_path / "ck"
    ckpt_dir.mkdir()
    (ckpt_dir / "vit_h.pth").write_bytes(b"x")
    sam_mod.SAMRunner(str(tmp_path), ["s"], max_size=40,
                      checkpoint_dir=str(ckpt_dir)).run()
    assert seen["shape"][:2] == (20, 40) and seen["device"] == "cuda"
    assert read_bin_mat(scan / "sa_masks" / "a.bin").shape == (20, 40)
    (tmp_path / "empty_scan").mkdir()
    with pytest.raises(FileNotFoundError):
        sam_mod.SAMRunner(str(tmp_path), ["empty_scan"],
                          checkpoint_dir=str(ckpt_dir)).run()
    with pytest.raises(NotImplementedError):
        sam_mod.prepare_checkpoint("vit_x")
    with pytest.raises(FileNotFoundError, match="checkpoint missing"):
        sam_mod.prepare_checkpoint("vit_b", str(tmp_path / "none"))


def test_sam_runner_skips_without_segment_anything(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setitem(sys.modules, "segment_anything", None)
    assert not sam_mod.sam_available()
    sam_mod.SAMRunner(str(tmp_path), ["s"]).run()
    assert "segment_anything not installed; skipping" in \
        capsys.readouterr().out


# ---- batch scheduler (as tests/test_cli.py) -------------------------------

def test_run_parser_presets_and_reservations():
    args = trun.build_parser().parse_args(
        ["--data_dir", "/d/ETH3D", "--ETH3D_train", "--gpu_num", "4",
         "--work_num", "2", "--resume"])
    assert args.device_num == 4
    assert trun.select_scans(args) == jrun.select_scans(args)
    assert len(trun.select_scans(args)) == 13
    for preset in ("--ETH3D_test", "--TaT_intermediate", "--TaT_advanced"):
        a = trun.build_parser().parse_args(["--data_dir", "/d", preset])
        assert trun.select_scans(a) == jrun.select_scans(a)
    assert "Palace" in trun.select_scans(trun.build_parser().parse_args(
        ["--data_dir", "/d", "--TaT_advanced"]))
    assert args.engine_cmd == \
        f"{sys.executable} -m apde_mvs_tpu_torch.cli.apd"
    assert trun.parse_reservation("3h30m10s") == 3 * 3600 + 30 * 60 + 10
    assert trun.parse_reservation("90s") == 90
    assert trun.parse_reservation("45") == 45
    with pytest.raises(ValueError):
        trun.parse_reservation("3x")


def test_run_review_command_matches_jax(tmp_path, capfd):
    """`--review --dry_run` prints each scan's engine command without
    running it: the JAX scheduler's command with the port's engine."""
    data = tmp_path / "ETH3D"
    for scan, n in (("big", 3), ("small", 1)):
        img_dir = data / scan / "undist" / "images"
        img_dir.mkdir(parents=True)
        for i in range(n):
            images.write_png(img_dir / f"{i}.png", np.zeros((4, 4), np.uint8))
    argv = ["--data_dir", str(data), "--review", "--dry_run", "--no_sam",
            "--export_anchor", "--view_batch", "4"]

    def commands(mod):
        capfd.readouterr()
        assert mod.main(argv) == 0
        out = capfd.readouterr().out
        return sorted(ln for ln in out.splitlines()
                      if ln.startswith(sys.executable)), out
    jcmds, _ = commands(jrun)
    tcmds, out = commands(trun)
    assert len(tcmds) == 2 and "scans: ['big', 'small']" in out
    assert tcmds == [c.replace(" -m apde_mvs_tpu.cli.apd ",
                               " -m apde_mvs_tpu_torch.cli.apd ")
                     for c in jcmds]
    assert re.search(r"--dataset ETH3D .*--export_anchor true", tcmds[0])
    assert not (data / "big" / "APD" / "log.txt").exists()
