"""The result line: its keys on a run at a tiny size on the CPU, and the
command's refusals (no card; a checkout without the program)."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from harness import runner, spec as spec_mod

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = spec_mod.load_spec()
TINY = dict(width=8, height=4, samples_per_pixel=8)


def tiny_run(workload, seed, seconds, trace=False, **cfg_over):
    """A Run of `workload` on the CPU at a tiny size, its keys slowed to
    what the CPU's frames keep up with."""
    run = runner.Run(workload, seed, seconds, trace, "cpu", spec=SPEC)
    run.cfg = dict(run.cfg, **dict(TINY, **cfg_over))
    if run.mix["driver"] == "view":
        run.mix = dict(run.mix, key_rate_hz=2.0, warmup_s=0.3,
                       warmup_presses=2)
    else:
        run.mix = dict(run.mix, frames_per_image=4)
    return run


@pytest.mark.parametrize("workload,trace", [
    ("cornell.view", False), ("cornell.view", True),
    ("northstar.headless", False), ("cornell.headless", True)])
def test_result_keys(workload, trace):
    run = tiny_run(workload, 2**31 + 3, 2.0, trace, max_depth=3)
    out = runner.run_cell(run, time.perf_counter(), log=lambda m: None)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec_mod.metrics_for(SPEC, workload,
                                                     section)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert "setup_s" in out["metrics"]
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0.0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cornell.view",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=str(cwd))


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    got = _command(ROOT)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "no CUDA device" in got.stderr


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _command(tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""
