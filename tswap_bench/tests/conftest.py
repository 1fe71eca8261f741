"""Tests of the benchmark harness, on the CPU at small sizes; the one test
that needs the card is marked ``cuda`` and skips without one.

    python -m pytest tswap_bench/tests -q -p no:cacheprovider
"""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# A small configuration in the shape of the real ones: a 24 x 300 open
# strip is long enough (distances to 322) that bfloat16 distances break.
SMALL = {
    "name": "small",
    "source": "test",
    "grid": {"kind": "random_obstacles", "height": 32, "width": 40,
             "density": 0.1, "seed": 0},
    "num_agents": 24,
    "planner": {"mode": "centralized", "replan_chunk": 8,
                "replan_chunk_small": 4, "max_timesteps": 400,
                "field_path": "default"},
    "assumed": [], "reduced": [],
}
LONG = dict(SMALL, name="long",
            grid={"kind": "warehouse", "height": 24, "width": 300,
                  "shelf_h": 2, "shelf_w": 8, "aisle": 2, "margin": 4})


def make_root(tmp: Path, configs=(SMALL,), check=None) -> Path:
    """A checkout root in ``tmp``: the benchmark's files, and a manifest
    that adds one ``<config>.solve`` cell per configuration given."""
    shutil.copytree(ROOT / "tswap_bench", tmp / "tswap_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in configs:
        name = cfg["name"]
        (tmp / "tswap_bench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        (tmp / "tswap_bench" / "workloads" / f"{name}.solve.json").write_text(
            json.dumps({"config": name, "traffic": "whole-solves",
                        "solves_prepared": 2,
                        "check": check or {"steps": 8, "step_span": 60,
                                           "agents": 6, "stayed": 6,
                                           "reference_batch": 8}}))
        manifest["configs"].append({"name": name, "source": "test",
                                    "file": f"tswap_bench/configs/{name}"
                                            ".json",
                                    "reduced": [], "why": "test"})
        manifest["workloads"].append({"name": f"{name}.solve",
                                      "config": name,
                                      "traffic": "whole-solves",
                                      "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp


def run_cpu(root: Path, cell: str, seconds: float = 1.5, patches=None,
            seed: int = 3, trace: bool = False) -> dict:
    from tswap_bench import harness

    torch.set_num_threads(1)
    return harness.run(root, cell, seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter(),
                       patches=patches)


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path)
