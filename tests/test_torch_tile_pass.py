"""The port's tile route on the CPU (`parallel.tile_pass`, `parallel.tiles`):
one view's pass row-sharded over gloo ranks (spawned processes).

- Two ranks equal the serial pass bitwise on a FIRST_INIT pass and on an
  APD REFINE_INIT pass with a non-empty weak list: every rank takes its
  slice of the one generator's draws (the JAX package folds the device
  index into its keys and pins quality only, tests/test_tile_pass.py).
- Rows split into even-height shards; an odd height raises.
- `run_scan` routes a scan with fewer views than ranks through the tile
  route, which then equals the serial engine bitwise, file for file.
- The strong sweep on row-sharded state: `tile_sharded_sweep` (full-state
  gathers) equals the unsharded sweep bitwise; the halo sweep sends only
  halo rows, carries a change across a shard boundary, and matches the
  unsharded sweep in quality (tests/test_tiles.py)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch import config as tcfg
from apde_mvs_tpu_torch.core import geometry as geo
from apde_mvs_tpu_torch.io import binmat
from apde_mvs_tpu_torch.ops import filters
from apde_mvs_tpu_torch.ops.cost import CostData
from apde_mvs_tpu_torch.ops.init import initial_cost, random_planes
from apde_mvs_tpu_torch.ops.propagation import PropCfg, propagate_strong, \
    sweep_draws
from apde_mvs_tpu_torch.ops.state import PMState
from apde_mvs_tpu_torch.parallel import distributed as pdist
from apde_mvs_tpu_torch.parallel import tiles
from apde_mvs_tpu_torch.parallel.tile_pass import RowShard, list_split, \
    row_split
from apde_mvs_tpu_torch.pipeline import driver
from apde_mvs_tpu_torch.pipeline.patchmatch import run_patchmatch
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.testing.ranks import run_ranks
from test_torch_full_pass import view_problem

# several test workers share the machine: one intra-op thread each
torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
OUTPUTS = ("depth", "normal", "weak", "confidence", "cost")


def tile_worker(rank, world):
    """Rank body: view 0's FIRST_INIT and APD passes, row-sharded."""
    out = {}
    for kind in ("first_init", "apd"):
        data, params, kw = view_problem(kind)
        res = run_patchmatch(data, params, shard=RowShard(rank, world), **kw)
        out[kind] = {k: getattr(res, k) for k in OUTPUTS + ("anchors",)}
    return out


@pytest.fixture(scope="module")
def tiled(tmp_path_factory):
    return run_ranks(f"{__name__}:tile_worker", 2,
                     tmp_path_factory.mktemp("tiled"), path=[TESTS],
                     timeout=240)


@pytest.mark.parametrize("kind", ["first_init", "apd"])
def test_tile_route_equals_serial_bitwise(tiled, kind):
    data, params, kw = view_problem(kind)
    serial = run_patchmatch(data, params, **kw)
    for rank, res in enumerate(tiled):
        for k in OUTPUTS:
            np.testing.assert_array_equal(res[kind][k], getattr(serial, k),
                                          err_msg=f"rank {rank} {kind} {k}")
    if kind == "apd":
        assert serial.anchors is not None and len(serial.anchors) > 32


@pytest.mark.parametrize("h, world, want", [
    (48, 2, [(0, 24), (24, 48)]),
    (56, 3, [(0, 20), (20, 38), (38, 56)]),
    (600, 2, [(0, 300), (300, 600)]),
])
def test_rows_split_into_even_shards(h, world, want):
    assert row_split(h, world) == want
    assert all((b - a) % 2 == 0 for a, b in want)


@pytest.mark.parametrize("h, world", [(49, 1), (51, 2), (4, 3)])
def test_odd_or_short_shards_raise(h, world):
    with pytest.raises(ValueError, match="even-height shards"):
        RowShard(0, world).row_part(h, 1)


def test_list_split_covers_the_list():
    assert list_split(5, 2) == [(0, 3), (3, 5)]
    assert list_split(1, 2) == [(0, 1), (1, 1)]


def route_worker(rank, world, root):
    from apde_mvs_tpu_torch.pipeline import driver as d
    d.run_scan(root, dataset="General", device="cpu", use_sa=False,
               pyramid_base=32, no_fuse=True)
    return rank


def test_run_scan_routes_tiles_when_views_below_ranks(tmp_path):
    """A 2-view scan on 3 ranks takes the tile route (auto: more than one
    rank), and its files equal the serial engine's, view for view."""
    scene = synthetic.make_scene(num_views=2, height=24, width=32,
                                 baseline=0.4)
    for name in ("tiled", "serial"):
        synthetic.write_scene_to_disk(scene, tmp_path / name)
    run_ranks(f"{__name__}:route_worker", 3, tmp_path / "work",
              dict(root=str(tmp_path / "tiled")), path=[TESTS], timeout=240)
    logs = "".join((tmp_path / "work" / f"rank{r}.log").read_text()
                   for r in range(3))
    assert "Scale-out: tile route over 3 rank(s)" in logs
    assert logs.count("TILED over 3 rank(s)") == 3 * 2 * 4
    driver.run_scan(tmp_path / "serial", dataset="General", device="cpu",
                    use_sa=False, pyramid_base=32, no_fuse=True)
    for v in range(2):
        for m in ("depths.bin", "normals.bin", "weak.bin",
                  "confidence.bin"):
            a = binmat.read_bin_mat(tmp_path / "tiled" / "APD" / f"{v:08d}"
                                    / m)
            b = binmat.read_bin_mat(tmp_path / "serial" / "APD"
                                    / f"{v:08d}" / m)
            np.testing.assert_array_equal(a, b, err_msg=f"view {v} {m}")
    gt = scene.depths[0]
    d = binmat.read_bin_mat(tmp_path / "tiled" / "APD" / "00000000"
                            / "depths.bin")
    ok = (d > 0) & (gt > 0)
    assert np.median(np.abs(d - gt)[ok] / gt[ok]) < 0.01


# ---- the strong sweep on row-sharded state ---------------------------------

SH, SW = 96, 64          # two shards of 48 rows >= the 24-row halo
ARGS = (2.0, 8.0, 0.2)   # depth_min, depth_max, geom_factor


def sweep_problem(seed=0):
    scene = synthetic.make_scene(num_views=3, height=SH, width=SW)
    cams = geo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    data = CostData.build(cams.view(0), cams.map(lambda a: a[1:]),
                          torch.as_tensor(scene.images[0]),
                          torch.as_tensor(scene.images[1:]))
    params = tcfg.PatchMatchParams(use_sa=False)
    state = PMState.create(SH, SW, 2, device="cpu")
    planes = random_planes(data, *(geo.f32_scalar(v, "cpu")
                                   for v in ARGS[:2]),
                           generator=torch.Generator().manual_seed(seed))
    state = initial_cost(data, state.replace(planes=planes), params)
    return scene, data, state, params


def draws_for(seed):
    gen = torch.Generator().manual_seed(seed)
    return [sweep_draws(gen, SH * SW // 2, "cpu") for _ in range(2)]


def unsharded(data, state, draws, iteration=0):
    for color in (0, 1):
        state = propagate_strong(data, state, PropCfg(use_sa=False),
                                 iteration, color, *ARGS, draws=draws[color])
    return state


def sweep_worker(rank, world):
    shard = RowShard(rank, world)
    cfg = PropCfg(use_sa=False)
    scene, data, state, params = sweep_problem()
    rows = tiles.shard_state_rows(state, shard)
    out = {}
    gathered = tiles.tile_sharded_sweep(data, rows, cfg, 0, *ARGS, shard,
                                        draws=draws_for(3))
    out["gathered"] = tiles.gather_state_rows(gathered, shard, SH).costs
    before = pdist.exchanged_bytes
    halo = tiles.halo_tile_sweep(data, rows, cfg, 0, *ARGS, shard,
                                 draws=draws_for(3))
    out["halo_sent"] = pdist.exchanged_bytes - before
    out["halo"] = tiles.gather_state_rows(halo, shard, SH).costs
    # cross-shard propagation: ground-truth planes in rank 0's last rows
    gt = filters.depth_normal_to_planes(
        data, torch.as_tensor(scene.depths[0]),
        torch.as_tensor(scene.normals[0]))
    band = torch.zeros((SH, SW, 1), dtype=torch.bool)
    band[24:48] = True
    seeded = initial_cost(data, state.replace(
        planes=torch.where(band, gt, state.planes)), params)
    rows = tiles.shard_state_rows(seeded, shard)
    for it in range(2):
        rows = tiles.halo_tile_sweep(data, rows, cfg, it, *ARGS, shard,
                                     draws=draws_for(10 + it))
    out["seeded_before"] = seeded.costs
    out["seeded_after"] = tiles.gather_state_rows(rows, shard, SH).costs
    return out


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    return run_ranks(f"{__name__}:sweep_worker", 2,
                     tmp_path_factory.mktemp("sweeps"), path=[TESTS],
                     timeout=240)


def test_tile_sharded_sweep_equals_unsharded(sweeps):
    _, data, state, _ = sweep_problem()
    want = unsharded(data, state, draws_for(3)).costs
    for res in sweeps:
        torch.testing.assert_close(res["gathered"], want, rtol=0, atol=0)


def test_halo_sweep_sends_halo_rows_only(sweeps):
    _, _, state, _ = sweep_problem()
    halo = tiles.HALO_ROWS
    row_bytes = sum(getattr(state, f)[0].numel()
                    * getattr(state, f).element_size() for f in tiles._FIELDS)
    # two colours, one neighbour each in a two-rank chain
    for res in sweeps:
        assert res["halo_sent"] == 2 * halo * row_bytes
    assert halo * row_bytes < SH // 2 * row_bytes


def test_halo_sweep_propagates_across_shards(sweeps):
    """Rows 48-59 (rank 1) improve through the halo from ground-truth
    planes seeded in rows 24-47 (rank 0)."""
    res = sweeps[0]
    inner = (slice(48, 60), slice(8, -8))
    before = float(res["seeded_before"][inner].median())
    after = float(res["seeded_after"][inner].median())
    assert after < before - 0.05, (before, after)


def test_halo_sweep_quality_matches_unsharded(sweeps):
    """The block's shifted principal point reassociates float32
    arithmetic, so the halo sweep equals the unsharded sweep in quality."""
    _, data, state, _ = sweep_problem()
    ref = unsharded(data, state, draws_for(3)).costs
    halo = sweeps[0]["halo"]
    assert abs(float(ref.median()) - float(halo.median())) < 0.02
    assert abs(float(ref.mean()) - float(halo.mean())) < 0.05
    assert torch.isclose(ref, halo, rtol=1e-3, atol=1e-3).float().mean() \
        > 0.95


def test_halo_sweep_needs_halo_tall_shards():
    _, data, state, _ = sweep_problem()
    shard = RowShard(0, 3)    # 96 rows: shards of 32 >= 24 would pass
    rows = tiles.shard_state_rows(state, shard)
    with pytest.raises(ValueError, match="halo"):
        tiles.halo_tile_sweep(data, rows, PropCfg(use_sa=False), 0, *ARGS,
                              shard, draws=draws_for(3), halo=40)
