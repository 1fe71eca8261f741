"""The fleet sections of the field and sector bench twins end to end (slow,
as the live-fleet twins' tests): ``analysis/torch_field_bench.py`` and
``analysis/torch_sector_bench.py`` with ``--cpu`` run their
dynamic-obstacle rung through ``analysis/torch_fleetsim.py`` with the
port's daemon, walls close mid-run, the completion ratio holds 1.0, and
the rung's map, logs and output stay under ``--log-dir``.  Tier-1 excludes
it through the ``slow`` marker."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not (ROOT / "cpp" / "build" / "mapd_bus").exists()
        and (shutil.which("cmake") is None or shutil.which("ninja") is None),
        reason="C++ toolchain unavailable"),
]


@pytest.mark.parametrize("bench,args", [
    ("field_bench", ["--side", "64", "--events", "2", "--repeats", "1"]),
    ("sector_bench", ["--side", "64", "--sizes", "16", "--goals", "2",
                      "--full-goals", "1", "--eps-goals", "2"]),
])
def test_bench_fleet_rung(tmp_path, bench, args):
    out = tmp_path / "bench.json"
    logs = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "analysis" / f"torch_{bench}.py"), *args,
         "--cpu",
         "--fleet-window", "10", "--log-dir", str(logs), "--out", str(out)],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.exists(), proc.stdout[-2000:] + proc.stderr[-2000:]
    fleet = json.loads(out.read_text())["fleet"]
    assert "error" not in fleet and "skipped" not in fleet, fleet
    assert fleet["completion_ratio_is_1"], fleet
    assert (fleet.get("world") or {}).get("requests"), fleet
    assert (logs / f"{bench}_fleet.json").exists()
    assert (logs / "fleet_logs").is_dir()
