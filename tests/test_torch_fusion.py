"""Parity of the port's fusion (pipeline/fusion.py) with the JAX
package's on the same per-view bins: the general and TaT variants give the
same point count, coordinates to atol 1e-5 and colours exactly; sharded
runs give the same part PLYs and consumption sidecars, the merge the same
cloud; the owner-wins filters agree on random consumption graphs."""

import json

import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import FusionParams as JFusionParams
from apde_mvs_tpu.io import binmat as jbin
from apde_mvs_tpu.io.ply import read_ply
from apde_mvs_tpu.pipeline import driver as jdriver
from apde_mvs_tpu.pipeline import fusion as jfusion
from apde_mvs_tpu_torch import config as tcfg
from apde_mvs_tpu_torch.pipeline import driver as tdriver
from apde_mvs_tpu_torch.pipeline import fusion as tfusion
from apde_mvs_tpu_torch.testing import synthetic

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)

WEAK, STRONG, UNKNOWN = 0, 1, 2


def _scan(root, seed):
    """A 5-view scan with noisy ground-truth bins: ~8% of depths off by 3%,
    a few holes, a quarter of the pixels WEAK with random confidence."""
    scene = synthetic.make_scene(num_views=5, height=40, width=56,
                                 with_foreground=True)
    synthetic.write_scene_to_disk(scene, root)
    rng = np.random.default_rng(seed)
    for v in range(scene.num_views):
        d = scene.depths[v] * (1 + rng.normal(0, 0.001, scene.depths[v].shape))
        d = np.where(rng.random(d.shape) < 0.08, d * 1.03, d)
        d[rng.random(d.shape) < 0.03] = 0.0
        n = scene.normals[v] + rng.normal(0, 0.02, scene.normals[v].shape)
        weak = np.where(rng.random(d.shape) < 0.25, WEAK, STRONG)
        weak[d == 0] = UNKNOWN
        conf = rng.integers(1, 40, d.shape)
        out = root / "APD" / f"{v:08d}"
        out.mkdir(parents=True, exist_ok=True)
        jbin.write_bin_mat(out / "depths.bin", d.astype(np.float32))
        jbin.write_bin_mat(out / "normals.bin", n.astype(np.float32))
        jbin.write_bin_mat(out / "weak.bin", weak.astype(np.uint8))
        jbin.write_bin_mat(out / "confidence.bin", conf.astype(np.uint8))


@pytest.mark.parametrize("variant,weak_filter", [
    pytest.param("general", True, id="True"),
    pytest.param("general", False, id="False"),
    ("tat_i", True), ("tat_a", True), ("tat_i", False), ("tat_a", False)])
def test_fusion_matches_jax(tmp_path, variant, weak_filter):
    root = tmp_path / "scan"
    _scan(root, seed=int(weak_filter))
    jpath = jfusion.run_fusion(
        root, jdriver.generate_sample_list(root), "jax.ply",
        JFusionParams(variant=variant, weak_filter=weak_filter))
    jskip = [(root / "APD" / f"{v:08d}" / "skip.png").read_bytes()
             for v in range(5)] if weak_filter else None
    tpath = tfusion.run_fusion(
        root, tdriver.generate_sample_list(root), "port.ply",
        tcfg.FusionParams(variant=variant, weak_filter=weak_filter),
        device="cpu")
    jp, jc = read_ply(jpath)
    tp, tc = read_ply(tpath)
    assert len(jp) > (1000 if variant == "general" else 200)
    assert len(tp) == len(jp)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc, jc)
    if weak_filter:
        from apde_mvs_tpu_torch.io.images import read_png
        from PIL import Image
        import io
        for v in range(5):
            tskip = read_png(root / "APD" / f"{v:08d}" / "skip.png")
            want = np.asarray(Image.open(io.BytesIO(jskip[v])))
            np.testing.assert_array_equal(tskip[..., 0], want)
        assert any((read_png(root / "APD" / f"{v:08d}" / "skip.png") > 0).any()
                   for v in range(5))


def _consume_dir(root, name, i, n):
    return root / "APD" / f"{name}.part{i}of{n}.consume"


@pytest.mark.parametrize("variant", ["general", "tat_i"])
def test_sharded_fusion_and_merge_match_jax(tmp_path, variant):
    """Each shard's part PLY and consumption sidecar (general variant)
    equal the JAX package's; the merge of the port's shards equals the JAX
    merge of the JAX shards."""
    root = tmp_path / "scan"
    _scan(root, seed=3)
    jprob = jdriver.generate_sample_list(root)
    tprob = tdriver.generate_sample_list(root)
    for i in range(2):
        jfusion.run_fusion(root, jprob, "jax.ply",
                           JFusionParams(variant=variant), shard=(i, 2))
        tfusion.run_fusion(root, tprob, "port.ply",
                           tcfg.FusionParams(variant=variant), shard=(i, 2),
                           device="cpu")
        jp, jc = read_ply(root / "APD" / f"jax.ply.part{i}of2")
        tp, tc = read_ply(root / "APD" / f"port.ply.part{i}of2")
        assert len(jp) > 100 and len(tp) == len(jp)
        np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tc, jc)
        jd, td = _consume_dir(root, "jax.ply", i, 2), \
            _consume_dir(root, "port.ply", i, 2)
        assert jd.exists() == (variant == "general") == td.exists()
        if variant == "general":
            for k in ("origin", "cons_pt", "cons_gid"):
                a, b = np.load(jd / f"{k}.npy"), np.load(td / f"{k}.npy")
                assert a.dtype == b.dtype == np.uint32, k
                np.testing.assert_array_equal(b, a, err_msg=k)
            assert json.loads((td / "meta.json").read_text()) \
                == json.loads((jd / "meta.json").read_text())
    jfusion.merge_fusion_shards(root, "jax.ply", 2)
    tfusion.merge_fusion_shards(root, "port.ply", 2)
    jp, jc = read_ply(root / "APD" / "jax.ply")
    tp, tc = read_ply(root / "APD" / "port.ply")
    assert len(tp) == len(jp)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc, jc)
    if variant == "general":
        # the owner-wins merge brings the cloud near the unsharded count
        base, _ = read_ply(tfusion.run_fusion(
            root, tdriver.generate_sample_list(root), "whole.ply",
            tcfg.FusionParams(), device="cpu"))
        assert abs(len(tp) - len(base)) < 0.05 * len(base)


def test_sharded_fusion_rejects_mixed_shapes(tmp_path):
    root = tmp_path / "scan"
    _scan(root, seed=4)
    out = root / "APD" / "00000001"
    for name, dt in (("depths", np.float32), ("normals", np.float32),
                     ("weak", np.uint8), ("confidence", np.uint8)):
        m = jbin.read_bin_mat(out / f"{name}.bin")
        jbin.write_bin_mat(out / f"{name}.bin", m[::2, ::2].astype(dt).copy())
    with pytest.raises(ValueError, match="one depth-map shape"):
        tfusion.run_fusion(root, tdriver.generate_sample_list(root), "x.ply",
                           tcfg.FusionParams(), shard=(0, 2), device="cpu")


def test_merge_skips_stale_consume_sidecars(tmp_path, capsys):
    """A sidecar whose origin no longer matches its part PLY (one .npy
    rewritten) is not applied: the merge concatenates, as the JAX merge
    does on the same files."""
    root = tmp_path / "scan"
    _scan(root, seed=5)
    tprob = tdriver.generate_sample_list(root)
    for i in range(2):
        tfusion.run_fusion(root, tprob, "stale.ply", tcfg.FusionParams(),
                           shard=(i, 2), device="cpu")
    side = _consume_dir(root, "stale.ply", 0, 2)
    orig = np.load(side / "origin.npy")
    np.save(side / "origin.npy", orig[: max(1, len(orig) // 2)])
    capsys.readouterr()
    tfusion.merge_fusion_shards(root, "stale.ply", 2)
    assert "stale or incomplete" in capsys.readouterr().out
    tp, _ = read_ply(root / "APD" / "stale.ply")
    parts = sum(len(read_ply(root / "APD" / f"stale.ply.part{i}of2")[0])
                for i in range(2))
    assert len(tp) == parts
    jfusion.merge_fusion_shards(root, "stale.ply", 2)
    jp, _ = read_ply(root / "APD" / "stale.ply")
    assert len(jp) == len(tp)


def _random_sides(rng, hw=16):
    """Random view-grouped consumption over a tiny grid, split into two
    shards by ref view parity (tests/test_fusion_oracle.py's generator)."""
    n_views = rng.randint(2, 6)
    sides, origin, cons_pt, cons_gid, n_total = [], [], [], [], 0
    for s in range(2):
        o, cp, cg = [], [], []
        for v in range(s, n_views, 2):
            npts = rng.randint(0, 5)
            pix = np.sort(rng.choice(hw, npts, replace=False))
            base = len(o)
            o.extend(v * hw + pix)
            for k in range(npts):
                for _ in range(rng.randint(0, 4)):
                    cp.append(base + k)
                    cg.append(rng.randint(0, n_views * hw))
        sides.append({"origin": np.asarray(o, np.int64),
                      "cons_pt": np.asarray(cp, np.int64),
                      "cons_gid": np.asarray(cg, np.int64)})
        origin.append(sides[-1]["origin"])
        cons_pt.append(sides[-1]["cons_pt"] + n_total)
        cons_gid.append(sides[-1]["cons_gid"])
        n_total += len(o)
    return sides, origin, cons_pt, cons_gid, n_total


def test_owner_wins_filters_match_jax():
    rng = np.random.RandomState(0)
    hw = 16
    checked = 0
    for trial in range(20):
        sides, origin, cons_pt, cons_gid, n_total = _random_sides(rng, hw)
        if n_total == 0:
            continue
        args = (np.concatenate(origin), np.concatenate(cons_pt),
                np.concatenate(cons_gid), hw)
        want = jfusion.owner_wins_filter(*args)
        np.testing.assert_array_equal(tfusion.owner_wins_filter(*args), want,
                                      err_msg=f"trial {trial}")
        for chunk in (3, 1 << 24):
            got = tfusion._owner_wins_replay(sides, hw, chunk=chunk)
            ref = jfusion._owner_wins_replay(sides, hw, chunk=chunk)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r, err_msg=f"trial {trial}")
            np.testing.assert_array_equal(np.concatenate(got), want)
        checked += 1
    assert checked >= 15
