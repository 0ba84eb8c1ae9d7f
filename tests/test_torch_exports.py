"""The port's debug exports and traces on the CPU: the anchors, curve,
nearest-strong and fit-normal writers against the JAX package's on the same
arrays; a 2-round CLI scan (`--pyramid_base 32`) with `--export_anchor` and
`--export_curve` writes every file; the curve export leaves the last
pass's weak map as it is; `tools/debug_point` prints what the JAX tool
prints on the same on-disk state; `--profile_dir` writes a trace."""

import contextlib
import io
import json
import re
import shutil

import numpy as np
import pytest
import torch

from apde_mvs_tpu.pipeline import driver as jdriver
from apde_mvs_tpu.tools import debug_point as jdebug
from apde_mvs_tpu.tools import visualize as jvis
from apde_mvs_tpu_torch.cli import apd
from apde_mvs_tpu_torch.io import binmat
from apde_mvs_tpu_torch.io.images import read_image_color
from apde_mvs_tpu_torch.pipeline import driver as tdriver
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.tools import anchor_vis, debug_point

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

V = 3
EXPORTS = ("anchors.bin", "anchors_map.bin", "reliable_curve.bin",
           "nearest_strong_7.png", "fit_normal_7.png")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = apd.main(argv)
    assert rc == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The 2-round verify scan through the port's CLI with both exports."""
    root = tmp_path_factory.mktemp("exports") / "scan"
    scene = synthetic.make_scene(num_views=V, height=48, width=64,
                                 weak_region=(-0.3, 0.3, -0.2, 0.2))
    synthetic.write_scene_to_disk(scene, root)
    log = _run(["--dense_folder", str(root), "--dataset", "General",
                "--device", "cpu", "--pyramid_base", "32",
                "--export_anchor", "true", "--export_curve", "true"])
    return root, scene, log


def test_writers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    h, w = 21, 34
    anchors = rng.integers(-1, 60, (17, 9, 2)).astype(np.int32)
    curve = rng.uniform(0, 2, (h, w, 61)).astype(np.float32)
    nearest = rng.integers(0, 20, (h, w, 2)).astype(np.int32)
    nearest[rng.random((h, w)) < 0.3] = -1
    amap = np.full((h, w), -1, np.int32)
    pick = rng.choice(h * w, 17, replace=False)
    amap.reshape(-1)[pick] = np.arange(17)
    fit = rng.normal(size=(17, 4)).astype(np.float32)
    fit[3] = 0.0                            # no fit: black pixel

    for mod, tag in ((jdriver, "j"), (tdriver, "t")):
        mod._write_anchors(tmp_path / f"{tag}_anchors.bin", anchors)
        mod._write_reliable_curve(tmp_path / f"{tag}_curve.bin", curve)
        mod._export_nearest_strong(tmp_path / f"{tag}_ns.png", nearest)
    # the JAX driver writes the fit-normal image inline (driver.py:229-235)
    fit_map = np.zeros((h, w, 3), np.float32)
    fit_map[amap >= 0] = fit[amap[amap >= 0], :3]
    jvis.show_normal_map(tmp_path / "j_fit.png", fit_map)
    tdriver._write_fit_normal(tmp_path / "t_fit.png", amap, fit)

    for name in ("anchors.bin", "curve.bin"):
        assert (tmp_path / f"t_{name}").read_bytes() \
            == (tmp_path / f"j_{name}").read_bytes(), name
    # the PNGs: JAX writes them through PIL, the port through its own
    # codec; the pixels are equal
    for name in ("ns.png", "fit.png"):
        np.testing.assert_array_equal(
            read_image_color(tmp_path / f"t_{name}"),
            read_image_color(tmp_path / f"j_{name}"), err_msg=name)


def test_cli_exports_every_file(exported):
    root, scene, log = exported
    assert log.count("Pass ") == 8
    # the last pass's weak counts: one anchor row per weak pixel
    weak = [int(ln.split()[2]) for ln in log.splitlines()
            if ln.startswith("Weak count:")][-V:]
    for v in range(V):
        rf = root / "APD" / f"{v:08d}"
        for name in EXPORTS:
            assert (rf / name).stat().st_size > 0, (v, name)
        amap = binmat.read_bin_mat(rf / "anchors_map.bin")
        anchors = anchor_vis.read_anchors(rf / "anchors.bin")
        assert amap.shape == (48, 64)
        assert anchors.shape == (weak[v], 9, 2)
        np.testing.assert_array_equal(np.sort(amap[amap >= 0]),
                                      np.arange(weak[v]))
        # slot 0 is the weak pixel itself
        ys, xs = np.nonzero(amap >= 0)
        np.testing.assert_array_equal(anchors[amap[ys, xs], 0],
                                      np.stack([xs, ys], -1))
        raw = (rf / "reliable_curve.bin").read_bytes()
        assert np.frombuffer(raw[:12], np.int32).tolist() == [64, 48, 61]
        curve = np.frombuffer(raw[12:], np.float32).reshape(48, 64, 61)
        assert (curve[6:-6, 6:-6] > 0).all()
        assert read_image_color(rf / "fit_normal_7.png").shape == (48, 64, 3)


def test_anchor_vis_renders_export(exported, tmp_path):
    root, _, _ = exported
    rf = root / "APD" / "00000000"
    amap = binmat.read_bin_mat(rf / "anchors_map.bin")
    anchors = anchor_vis.read_anchors(rf / "anchors.bin")
    reliable = np.nonzero((anchors[:, 1:, 0] >= 0).any(-1))[0]
    assert len(reliable) > 0
    y, x = (int(v[0]) for v in np.nonzero(amap == reliable[0]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = anchor_vis.main(["--result_folder", str(rf), "--point",
                              f"{x},{y}", "--out", str(tmp_path / "a.png")])
    assert rc == 0 and f"anchors of ({x}, {y}):" in out.getvalue()
    assert read_image_color(tmp_path / "a.png").shape == (48, 64, 3)


def test_curve_export_keeps_the_weak_map(exported, tmp_path):
    """Rerunning the last pass from the same bins and seed with and without
    --export_curve gives the same weak map: the extra pixels the exporter
    classifies come out UNKNOWN where they are skipped otherwise."""
    root, _, _ = exported
    maps = {}
    for flag in ("true", "false"):
        copy = tmp_path / f"curve_{flag}"
        shutil.copytree(root, copy)
        for v in range(V):
            (copy / "APD" / f"{v:08d}" / "reliable_curve.bin").unlink()
        _run(["--dense_folder", str(copy), "--dataset", "General",
              "--device", "cpu", "--pyramid_base", "32",
              "--start_iteration", "7", "--no_fuse", "true",
              "--export_curve", flag])
        maps[flag] = [binmat.read_bin_mat(copy / "APD" / f"{v:08d}" /
                                          "weak.bin") for v in range(V)]
        assert (copy / "APD" / "00000000" / "reliable_curve.bin").exists() \
            == (flag == "true")
    for v in range(V):
        np.testing.assert_array_equal(maps["true"][v], maps["false"][v])
    # the maps hold all three classes, so the comparison is not trivial
    assert {0, 1, 2} <= set(np.unique(np.concatenate(
        [m.ravel() for m in maps["true"]])).tolist())


_NUM = r"-?\d+\.\d+"


def _parse(text):
    ncc = [float(v) for v in re.findall(rf"ncc=({_NUM})", text)]
    geom = [float(v) for v in re.findall(rf"geom=({_NUM})", text)]
    curve_line = text.splitlines()[text.splitlines().index(next(
        ln for ln in text.splitlines() if "reliability curve" in ln)) + 1]
    curve = [float(v) for v in curve_line.split()]
    head = re.search(rf"min=({_NUM}) at offset (-?\d+)", text)
    reclass = re.search(r"reclassification -> (\w+)", text).group(1)
    return ncc, geom, curve, float(head.group(1)), int(head.group(2)), reclass


def test_debug_point_matches_jax(exported):
    """On a textured pixel (inside the nearly textureless plane the NCC's
    variances cancel to a few ulps of float32 and the two packages'
    summation orders part by far more than 1e-4)."""
    root, _, _ = exported
    argv = ["--dense_folder", str(root), "--view", "1", "--point", "20,20",
            "--sampler", "f32", "--geom"]
    outs = {}
    for name, mod, extra in (("jax", jdebug, []),
                             ("port", debug_point, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(argv + extra) == 0
        outs[name] = buf.getvalue()
    jn, jg, jc, jmin, joff, jcls = _parse(outs["jax"])
    tn, tg, tc, tmin, toff, tcls = _parse(outs["port"])
    assert len(tn) == len(jn) == V - 1 and len(tg) == len(jg) == V - 1
    np.testing.assert_allclose(tn, jn, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tg, jg, atol=1e-4, rtol=0)
    assert (toff, tcls) == (joff, jcls)
    assert abs(tmin - jmin) <= 1e-4
    # the curve prints with two decimals: hold the port's unrounded values
    # to the JAX tool's printed ones within half a printed unit + 1e-4
    assert len(tc) == len(jc) == 61
    raw = debug_point.inspect_point(root, 1, 20, 20, geom=True,
                                    sampler_u8=False, device="cpu")
    np.testing.assert_allclose(raw["curve"], jc, atol=0.005 + 1e-4, rtol=0)
    np.testing.assert_allclose(raw["ncc"], jn, atol=0.00005 + 1e-4, rtol=0)


def test_profile_dir_writes_trace_on_cpu(exported, tmp_path):
    root, _, _ = exported
    prof = tmp_path / "prof"
    log = _run(["--dense_folder", str(root), "--dataset", "General",
                "--device", "cpu", "--only_fuse", "true",
                "--profile_dir", str(prof)])
    assert "Fusion wall" in log
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert len(events) > 100 and any("aten::" in str(n) for n in names)
