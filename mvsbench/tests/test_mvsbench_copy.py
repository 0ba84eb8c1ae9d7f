"""The frozen reference (`mvsbench/reference/plain`) against the port's
plain route, the code the port's own tests hold against the JAX package:
every kind of pass of the schedule, on a scan at a test's size, gives the
same bits on every map. A change to either side's arithmetic fails here,
so the copy's link to the code those tests check is checked, not
assumed."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from mvsbench import judge, manifest, program, scan, scene
from mvsbench.reference import pass_ref

SEED = 2**31 + 5
CPU = torch.device("cpu")
# (round, pass in round): FIRST_INIT; round 0's geometric pass (no APD);
# REFINE_INIT with APD; the first and the last geometric pass with APD
PASSES = [(0, 0), (0, 1), (1, 0), (1, 1), (1, 3)]


@pytest.fixture(scope="module")
def tiny_scan(tmp_path_factory):
    torch.set_num_threads(1)
    cfg = manifest.load(Path(__file__).parent / "tiny.json")
    traffic = manifest.load(manifest.REPO / "mvsbench" / "traffic"
                            / "final_geom_weak31.json")
    sc = scene.make_scene(cfg, traffic["weak_share"], SEED, CPU)
    raw = scan.write_scan(tmp_path_factory.mktemp("copy") / "scan", sc,
                          traffic, SEED, cfg["sources"])
    return cfg, traffic, raw


@pytest.mark.parametrize("round_,pass_in_round", PASSES,
                         ids=[f"r{r}p{p}" for r, p in PASSES])
def test_copy_equals_the_ports_plain_route(tiny_scan, round_, pass_in_round):
    cfg, traffic, raw = tiny_scan
    traffic = dict(traffic, round=round_, pass_in_round=pass_in_round)
    prog = program.Program.load(raw, program.schedule_pass(cfg, traffic),
                                CPU)
    spec = pass_ref.schedule_pass(cfg, traffic)
    assert spec.params.state == prog.spec.params.state
    i = 1
    s = prog.seed(SEED, 0, i)
    got = prog.step(i, s)
    want = pass_ref.run_pass(raw, prog.problems[i].ref_image_id, spec, s,
                             CPU)
    off = judge.compare(got, want)
    assert all(v == 0.0 for v in off.values()), off
