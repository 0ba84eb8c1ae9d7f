"""The port's view-parallel engine on the CPU (`pipeline.scan_parallel`,
`parallel.{scene,mesh,distributed}`).

- FIRST_INIT: the view-parallel pass equals the serial engine bitwise
  (every view's generator is seeded as the serial engine seeds it).
- World size: two gloo ranks (spawned processes) equal one rank bitwise on
  every pass of the 2-round schedule (`pyramid_base 32`: round 0 at 24x32,
  round 1 with the APD weak path at 48x64), and the strong-only prototype
  `mesh.view_parallel_step` likewise.
- ``view_batch``: 2 equals the whole scan bitwise on FIRST_INIT; 1 reads
  the other views' depths from their files (ext rows) on the geometric
  passes and still reconstructs the scene.
- Against the JAX package: `partition_scans` / `throughput_report` exactly;
  `_RoundData`'s tables on the entries the port keeps; and the slice as a
  whole: the JAX `ViewParallelRunner` and the port's engine over FIRST_INIT
  + one geometric pass of the same scan, both under 1% median relative
  depth error, within a stated tolerance of each other (torch cannot
  reproduce threefry, so this comparison is statistical).
- The CLI under ``torch.distributed.run --nproc_per_node 2`` with
  ``--views_parallel true --device cpu`` passes the verify recipe.

The JAX package is imported inside the tests that use it: the spawned
ranks import this module and need torch only."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch import config as tcfg
from apde_mvs_tpu_torch.core import geometry as geo
from apde_mvs_tpu_torch.io import MemoryCache, binmat
from apde_mvs_tpu_torch.io.images import resize_nearest
from apde_mvs_tpu_torch.io.ply import read_ply
from apde_mvs_tpu_torch.ops.propagation import PropCfg
from apde_mvs_tpu_torch.parallel import distributed as pdist
from apde_mvs_tpu_torch.parallel import mesh
from apde_mvs_tpu_torch.pipeline import driver
from apde_mvs_tpu_torch.pipeline.scan_parallel import ViewParallelRunner, \
    _RoundData
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.testing.ranks import run_ranks

# several test workers share the machine: one intra-op thread each
torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
H, W, V = 48, 64, 3
WEAK_REGION = (-0.3, 0.3, -0.2, 0.2)
MAPS = ("depths.bin", "normals.bin", "weak.bin")


def make_scan(root, num_views=V):
    scene = synthetic.make_scene(num_views=num_views, height=H, width=W,
                                 weak_region=WEAK_REGION)
    synthetic.write_scene_to_disk(scene, root)
    return scene


def schedule():
    return tcfg.build_schedule(W, "General", use_sa=False, base=32)


def read_maps(root, num_views=V):
    return {(v, m): binmat.read_bin_mat(Path(root) / "APD" / f"{v:08d}" / m)
            for v in range(num_views) for m in MAPS}


def assert_maps_equal(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def median_rel(depth, gt):
    if depth.shape != gt.shape:
        gt = resize_nearest(gt, depth.shape)
    ok = (depth > 0) & (gt > 0)
    return float(np.median(np.abs(depth - gt)[ok] / gt[ok]))


def run_schedule(root, rank=0, world=1, passes=None, view_batch=None):
    """The view-parallel engine over the schedule (or its first
    ``passes``); rank 0 returns every view's maps after each pass."""
    runner = ViewParallelRunner(driver.generate_sample_list(root),
                                MemoryCache(), seed=0, view_batch=view_batch,
                                device="cpu")
    snaps = []
    for spec in schedule()[:passes]:
        runner.run_pass(spec)
        if rank == 0:
            snaps.append(read_maps(root))
    return snaps, runner


def two_rank_worker(rank, world, root):
    """Rank body of the two-rank run: the whole schedule, then the
    strong-only prototype."""
    snaps, _ = run_schedule(root, rank, world)
    return dict(passes=snaps, step=mesh_step(rank, world))


def mesh_step(rank=0, world=1):
    """Two iterations of `mesh.view_parallel_step` on a 3-view scene;
    rank 0 returns every view's costs and depths."""
    scene = synthetic.make_scene(num_views=V, height=32, width=48)
    cams = geo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    group = mesh.ViewGroup(rank, world, V)
    pair = [[v for v in range(V) if v != r] for r in range(V)]
    batch = mesh.scene_batch_from_arrays(
        torch.as_tensor(scene.images), cams, pair, group, seed=3,
        depth_min=2.0, depth_max=8.0)
    first = batch.costs.clone()
    for it in range(2):
        batch = mesh.view_parallel_step(
            batch, group, PropCfg(use_sa=False, geom_consistency=True), it,
            3, 2.0, 8.0, 0.2)
    costs = group.gather(batch.costs)[:V]
    depths = group.gather(batch.depths)[:V]
    return dict(first=group.gather(first)[:V], costs=costs, depths=depths)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    root = tmp_path_factory.mktemp("one") / "scan"
    scene = make_scan(root)
    snaps, _ = run_schedule(root)
    return dict(scene=scene, passes=snaps, step=mesh_step())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("two")
    make_scan(work / "scan")
    res = run_ranks(f"{__name__}:two_rank_worker", 2, work,
                    dict(root=str(work / "scan")), path=[TESTS],
                    timeout=240)
    return res[0]


# ---- host code against the JAX package -------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_and_throughput_match_jax(seed):
    from apde_mvs_tpu.parallel import distributed as jdist
    rng = np.random.default_rng(seed)
    scans = [(f"scan{i}", int(rng.integers(1, 60))) for i in range(11)]
    times = {s: float(rng.uniform(10, 500)) for s, _ in scans}
    for hosts in (1, 2, 3, 5):
        for h in range(hosts):
            assert pdist.partition_scans(scans, hosts, h) \
                == jdist.partition_scans(scans, hosts, h)
        base = float(rng.uniform(100, 900))
        assert pdist.throughput_report(times, hosts, base) \
            == jdist.throughput_report(times, hosts, base)


def test_backend_follows_placement(monkeypatch):
    assert pdist.backend_for(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pdist.backend_for(torch.device("cuda", 0), 1) == "nccl"
    # two ranks sharing one card: NCCL refuses that, gloo does not
    assert pdist.backend_for(torch.device("cuda", 0), 2) == "gloo"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pdist.initialize("cpu") == (0, 1)
    assert pdist.rank_and_world() == (0, 1)


def test_round_data_matches_jax(tmp_path):
    """view_batch=1: each batch's tables against the JAX package's on the
    entries the port keeps (the JAX table pads its slots to a multiple of
    8 and its ext rows to 4; the port does neither)."""
    from apde_mvs_tpu.pipeline import driver as jdriver
    from apde_mvs_tpu.pipeline.scan_parallel import _RoundData as JRound
    make_scan(tmp_path / "scan", num_views=4)
    probs = driver.generate_sample_list(tmp_path / "scan")
    jprobs = jdriver.generate_sample_list(tmp_path / "scan")
    ids = [p.ref_image_id for p in probs]
    for scale in (1, 2):
        for i in range(len(probs)):
            rd = _RoundData([probs[i]], scale, None, 1, scan_ref_ids=ids)
            jd = JRound([jprobs[i]], scale, None, 1, scan_ref_ids=ids)
            n = len(probs[i].src_image_ids)
            M = len(rd.ids)
            np.testing.assert_array_equal(rd.pair[:, :n], jd.pair[:, :n])
            np.testing.assert_array_equal(rd.ref_slot, jd.ref_slot)
            np.testing.assert_array_equal(rd.depth_slot[:M],
                                          jd.depth_slot[:M])
            assert rd.ext_ids == jd.ext_ids and len(rd.ext_ids) == 3
            np.testing.assert_array_equal(rd.dmin.astype(np.float32),
                                          jd.dmin)
            np.testing.assert_array_equal(rd.dmax.astype(np.float32),
                                          jd.dmax)
            assert (rd.h, rd.w, rd.ph, rd.pw) == (jd.h, jd.w, jd.ph, jd.pw)


# ---- the engine -------------------------------------------------------------

def test_first_init_matches_serial_bitwise(tmp_path):
    make_scan(tmp_path / "serial")
    make_scan(tmp_path / "parallel")
    spec = schedule()[0]
    assert spec.params.state == "first_init"
    for p in driver.generate_sample_list(tmp_path / "serial"):
        driver.process_problem(p, spec, cache=None, seed=0, device="cpu")
    run_schedule(tmp_path / "parallel", passes=1)
    assert_maps_equal(read_maps(tmp_path / "serial"),
                      read_maps(tmp_path / "parallel"), "serial vs parallel")


def test_view_batch_two_matches_whole_scan(tmp_path, one_rank):
    make_scan(tmp_path / "scan")
    snaps, runner = run_schedule(tmp_path / "scan", passes=1, view_batch=2)
    assert [len(b) for b in runner._batches()] == [2, 1]
    assert_maps_equal(snaps[0], one_rank["passes"][0], "view_batch 2")


def test_world_size_two_equals_one_on_every_pass(one_rank, two_ranks):
    specs = schedule()
    assert len(specs) == 8 and len(two_ranks["passes"]) == 8
    assert any(s.params.use_apd and s.params.state == "refine_init"
               for s in specs)
    for i, (a, b) in enumerate(zip(one_rank["passes"], two_ranks["passes"])):
        assert_maps_equal(a, b, f"pass {i} ({specs[i].params.state})")
    # and the scan is right
    for v in range(V):
        depth = one_rank["passes"][-1][(v, "depths.bin")]
        assert median_rel(depth, one_rank["scene"].depths[v]) < 0.01


def test_view_parallel_step_world_invariant(one_rank, two_ranks):
    a, b = one_rank["step"], two_ranks["step"]
    for k in ("first", "costs", "depths"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # the iterations did work: the median cost fell
    assert float(a["costs"].median()) < float(a["first"].median()) - 0.1


def test_view_group_slots():
    groups = [mesh.ViewGroup(r, 2, 3) for r in range(2)]
    assert [g.slots() for g in groups] == [[0, 1], [2, 3]]
    assert [g.local() for g in groups] == [[0, 1], [2]]
    assert groups[0].padded == 4
    g = mesh.make_mesh(5)
    assert (g.rank, g.world, g.local()) == (0, 1, [0, 1, 2, 3, 4])


def test_view_batch_one_reads_ext_rows(tmp_path):
    """Batches of one view: every geometric pass reads the other views'
    depths from their files. Round 0 (FIRST_INIT + 3 geometric passes at
    24x32) still lands under 1% against ground truth."""
    scene = make_scan(tmp_path / "scan")
    snaps, runner = run_schedule(tmp_path / "scan", passes=4, view_batch=1)
    rd = next(iter(runner._rounds.values()))
    assert rd.ext_ids and len(rd.ext_ids) == V - 1
    for v in range(V):
        assert median_rel(snaps[-1][(v, "depths.bin")],
                          scene.depths[v]) < 0.01


def test_slice_matches_jax_view_parallel_runner(tmp_path):
    """FIRST_INIT + one geometric pass of the 2-round schedule (round 0,
    24x32) through the JAX `ViewParallelRunner` on a one-device mesh and
    through the port's engine: both under 1% median relative depth error
    against ground truth, and within 1% of each other in median (measured:
    see the assertion's message on failure)."""
    from apde_mvs_tpu import config as jcfg
    from apde_mvs_tpu.parallel.mesh import make_mesh
    from apde_mvs_tpu.pipeline import driver as jdriver
    from apde_mvs_tpu.pipeline.scan_parallel import \
        ViewParallelRunner as JRunner
    scene = make_scan(tmp_path / "jax")
    make_scan(tmp_path / "port")
    jspecs = jcfg.build_schedule(W, "General", use_sa=False, base=32)[:2]
    assert jspecs[1].params.geom_consistency
    jr = JRunner(jdriver.generate_sample_list(tmp_path / "jax"), cache=None,
                 seed=0, mesh=make_mesh(1))
    for spec in jspecs:
        jr.run_pass(spec)
    run_schedule(tmp_path / "port", passes=2)
    j, t = read_maps(tmp_path / "jax"), read_maps(tmp_path / "port")
    for v in range(V):
        jd, td = j[(v, "depths.bin")], t[(v, "depths.bin")]
        gt = scene.depths[v]
        jerr, terr = median_rel(jd, gt), median_rel(td, gt)
        both = (jd > 0) & (td > 0)
        cross = float(np.median(np.abs(td - jd)[both] / jd[both]))
        assert jerr < 0.01 and terr < 0.01, (v, jerr, terr)
        assert cross < 0.01, (v, cross, jerr, terr)


def test_cli_torchrun_two_ranks_cpu(tmp_path):
    """The verify recipe through torchrun: 2 ranks, gloo, 2 rounds."""
    scene = make_scan(tmp_path / "scan")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "apde_mvs_tpu_torch.cli.apd",
         "--dense_folder", str(tmp_path / "scan"), "--dataset", "General",
         "--device", "cpu", "--pyramid_base", "32", "--views_parallel",
         "true"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    log = proc.stdout
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert log.count("process group backend gloo") == 2
    # the ranks share one pipe: their lines may interleave, not their words
    passes = re.findall(r"Pass (\d) \(\w+\) wall [\d.]+ s, exchanged "
                        r"(\d+) B, rank (\d) of 2", log)
    assert sorted((int(p), int(r)) for p, _, r in passes) \
        == [(p, r) for p in range(8) for r in range(2)]
    # the geometric / APD passes exchange depth rows; FIRST_INIT does not
    assert {int(b) > 0 for p, b, _ in passes if p != "0"} == {True}
    assert len(re.findall(r"Sampler kernel launches: 0, .*rank \d of 2",
                          log)) == 2
    for v in range(V):
        depth = binmat.read_bin_mat(tmp_path / "scan" / "APD" / f"{v:08d}"
                                    / "depths.bin")
        assert median_rel(depth, scene.depths[v]) < 0.01
    pts, cols = read_ply(tmp_path / "scan" / "APD" / "APD.ply")
    assert len(pts) > 1000 and cols is not None and len(cols) == len(pts)
