"""run.py's outer behaviour: no card, no result; and, on the card, a
short run of each cell prints a correct result line, and a directory
that holds only the benchmark's files prints none."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def _run(cwd, *extra, timeout=600):
    return subprocess.run(
        [sys.executable, "tswap_bench/run.py", "--workload",
         "random-1k-512.solve", "--seed", "2147483647", "--seconds", "3",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT, "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tswap_bench", tmp_path / "tswap_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["random-1k-512.solve",
                                  "warehouse-10k-1024.solve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, "tswap_bench/run.py", "--workload", cell,
         "--seed", "2147483647", "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] >= 1
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"
    want = {"solve_step_ms", "step_ms_p95", "setup_s"} if trace == 0 else \
        {"host_syncs_per_step", "replan_ms_per_step",
         "tswap_step_ms_per_step", "sweep_scan_roofline", "device_idle"}
    assert set(r["metrics"]) == want
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["metrics"]["sweep_scan_roofline"]["value"] <= 105
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
