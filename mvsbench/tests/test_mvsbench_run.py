"""The harness's run on the CPU at a test's size: its last line, its
refusal without a card, the modules it leaves loaded, and what the
reference imports."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from mvsbench import manifest

from .conftest import TINY_CELL

REPO = manifest.REPO
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "compared"]


def _python(code: str, timeout: int = 600) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "mvsbench.run", "--workload",
         "dtu.r1_geom_weak", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert "{" not in proc.stdout
    assert "no result" in proc.stderr


def test_added_cell_runs_on_the_cpu(tiny_manifest: Path):
    """The added cell's whole run at 48x64 on the CPU (the program's plain
    route against the frozen reference), its report as the card's run
    prints it, and no JAX or JAX-package module loaded in its process."""
    proc = _python(f"""
        import json, sys, torch
        torch.set_num_threads(1)
        from mvsbench import manifest, run
        cell = manifest.cell({str(tiny_manifest)!r}, {TINY_CELL!r})
        result, info = run.run_cell(cell, 2**31 + 7, 0.1, False,
                                    torch.device("cpu"))
        run.emit(result, info)
        print(json.dumps(run.forbidden_modules()), file=sys.stderr)
    """)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = proc.stdout.strip().splitlines()[-1]
    result = json.loads(last)
    assert list(result) == RESULT_KEYS
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"view_ms", "setup_s"}
    assert result["metrics"]["view_ms"]["unit"] == "ms"
    assert result["metrics"]["setup_s"]["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name, v in result["compared"].items():
        assert v["value"] == 0.0 and v["limit"] > 0
    err = proc.stderr.strip().splitlines()
    assert json.loads(err[-1]) == []
    tail = err[-1 - len(result["compared"]):-1]
    assert [line.split()[0] for line in tail] == list(result["compared"])


def test_no_jax_in_the_harness_or_the_port():
    """Whole top-level names: the port's name begins with the JAX
    package's."""
    proc = _python("""
        import sys, json
        import mvsbench.run, mvsbench.program, mvsbench.trace
        import mvsbench.reference.pass_ref
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert proc.returncode == 0, proc.stderr
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "apde_mvs_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "apde_mvs_tpu"}


def test_reference_imports_nothing_of_the_port():
    proc = _python("""
        import sys, json
        import mvsbench.reference.pass_ref, mvsbench.judge, mvsbench.scene
        import mvsbench.scan, mvsbench.k3_count
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert proc.returncode == 0, proc.stderr
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not top & {"apde_mvs_tpu_torch", "apde_mvs_tpu", "jax", "jaxlib"}


@pytest.mark.parametrize("path", sorted(
    (REPO / "mvsbench" / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_sources_name_no_port_module(path: Path):
    text = path.read_text()
    for line in text.splitlines():
        if line.lstrip().startswith(("import ", "from ")):
            assert "apde_mvs_tpu" not in line, line
