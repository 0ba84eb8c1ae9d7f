"""Run a function on several local CPU ranks (torch.distributed with gloo,
a ``file://`` rendezvous), each rank its own Python process: how the tests
drive the scale-out engines without a card.

    results = run_ranks("module:function", world=2, workdir=tmp, kwargs={},
                        path=[tests_dir], timeout=120)

Rank r calls ``function(rank=r, world=world, **kwargs)`` after joining the
group, with one torch intra-op thread; ``results[r]`` is its return value
(through ``torch.save``). A rank that fails or outlives ``timeout``
raises here with its output; every process started is ended.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

_CHILD = """
import json, sys
sys.path[:0] = json.loads(sys.argv[1])
from apde_mvs_tpu_torch.testing.ranks import _child
_child(*sys.argv[2:])
"""


def run_ranks(target: str, world: int, workdir, kwargs=None, path=(),
              timeout: float = 300.0) -> list:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    init = workdir / "rendezvous"
    if init.exists():
        init.unlink()
    (workdir / "kwargs.json").write_text(json.dumps(kwargs or {}))
    repo = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _CHILD,
             json.dumps([repo] + [str(p) for p in path]), target, str(r),
             str(world), str(init), str(workdir)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass                     # the ranks still running are killed below
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    import torch
    out = []
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"rank {r} of {world} exited {p.returncode}:\n"
                + (workdir / f"rank{r}.log").read_text()[-4000:])
        out.append(torch.load(workdir / f"result{r}.pt", weights_only=False))
    return out


def _child(target: str, rank: str, world: str, init: str,
           workdir: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    from ..parallel import distributed as pdist

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    pdist.initialize("cpu", init_method=f"file://{init}", rank=rank,
                     world_size=world)
    kwargs = json.loads((Path(workdir) / "kwargs.json").read_text())
    mod, fn = target.split(":")
    try:
        res = getattr(importlib.import_module(mod), fn)(
            rank=rank, world=world, **kwargs)
        torch.save(res, Path(workdir) / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()
