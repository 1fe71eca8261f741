"""The sector fuzz and sector-bench twins (``scripts/torch_sector_fuzz.py``,
``analysis/torch_sector_bench.py``) against the JAX package's originals.

- ``fuzz_seed``: the three contracts (route validity, suboptimality within
  ``EPS``, repair == recompute) hold on the port, with the original's
  (reachable pairs, largest epsilon) on the same seed.  On the CPU the
  twin's planners take the host path, the original's ``use_jit=False``.
- ``bench_epsilon`` and ``resident_bytes``: the same pairs and the same
  epsilon distribution, and the same per-goal byte rows.
"""

import numpy as np
import pytest
import torch

from analysis import sector_bench, torch_sector_bench
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from scripts import sector_fuzz, torch_sector_fuzz

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _host_path(monkeypatch):
    monkeypatch.delenv("JG_SECTOR_JIT", raising=False)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_seed_matches_jax(seed):
    assert torch_sector_fuzz.EPS == sector_fuzz.EPS == 0.05
    want = sector_fuzz.fuzz_seed(seed, 4)
    assert torch_sector_fuzz.fuzz_seed(seed, 4, CPU) == want


def _free(side: int) -> np.ndarray:
    free = np.asarray(Grid.random_obstacles(side, side, 0.15, 1).free)
    np.testing.assert_array_equal(
        free, np.asarray(JaxGrid.random_obstacles(side, side, 0.15, 1).free))
    return free.copy()


def test_bench_epsilon_matches_jax():
    free = _free(96)
    want = sector_bench.bench_epsilon(free.copy(), 32, 4, 2, 1)
    got = torch_sector_bench.bench_epsilon(free.copy(), 32, 4, 2, 1, CPU)
    assert got == want
    assert got["pairs"] > 0 and got["within_bound"]


def test_resident_bytes_matches_jax():
    free = _free(64)
    fresh = {"sector": [
        {"s": 16, "packed_row_bytes": 2048, "corridor_fraction": 0.25},
        {"s": 32, "packed_row_bytes": 1024, "corridor_fraction": 0.5}]}
    assert torch_sector_bench.resident_bytes(fresh, free) \
        == sector_bench.resident_bytes(fresh, free)


def test_fresh_goal_rows_match_jax():
    """The full pipeline's and the planner's draws: the same corridors
    (cells, bytes, fraction) per sector size, times excluded."""
    free = _free(64)
    keep = ("s", "goals", "starts_per_goal", "corridor_cells_mean",
            "corridor_fraction", "packed_row_bytes")
    want = sector_bench.bench_fresh_goal(free.copy(), [16, 32], 3, 1, 2, 1)
    got = torch_sector_bench.bench_fresh_goal(free.copy(), [16, 32], 3, 1, 2,
                                              1, CPU)
    assert got["grid"] == want["grid"]
    assert [{k: r[k] for k in keep} for r in got["sector"]] \
        == [{k: r[k] for k in keep} for r in want["sector"]]
