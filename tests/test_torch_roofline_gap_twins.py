"""The roofline and quality-gap twins (``analysis/torch_roofline.py``,
``analysis/torch_quality_gap.py``) against the JAX package's originals.

- ``measure_fixpoint_rounds``: the host-driven sweep rounds to convergence
  of chunks of 4 delivery goals on a 64^2 warehouse (the flagship's grid
  kind, cut to size) take the original's round counts, and the twin's byte
  model gives the original's arithmetic.
- The quality gap: on a tiny rung monkeypatched into both packages'
  ``scenarios`` (neither file edited), the twin's estimate dict equals the
  one the original's ``main`` writes.
"""

import json
import sys

import numpy as np
import pytest
import torch

from analysis import quality_gap, roofline, torch_quality_gap, torch_roofline
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.models import scenarios as jsc
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.models import scenarios as tsc
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _warehouse_tasks():
    scn = tsc.Scenario("wh64", lambda: Grid.warehouse(64, 64), 40, 40)
    grid, _, tasks, cfg = scn.build(seed=0)
    return grid, tasks, cfg


@pytest.mark.parametrize("chunk", range(3))
def test_fixpoint_rounds_match_jax(chunk):
    import jax.numpy as jnp

    grid, tasks, _ = _warehouse_tasks()
    jgrid = JaxGrid.warehouse(64, 64)
    rng = np.random.default_rng(chunk)
    goals = tasks[rng.choice(len(tasks), size=4, replace=False), 1]
    want, _ = roofline.measure_fixpoint_rounds(
        jgrid, jnp.asarray(goals, jnp.int32))
    got, _ = torch_roofline.measure_fixpoint_rounds(
        grid, torch.as_tensor(goals, dtype=torch.int32))
    plain, _ = torch_roofline.measure_fixpoint_rounds(
        grid, torch.as_tensor(goals, dtype=torch.int32),
        sweep=sweep_kernel.sweep_plain)
    assert got == plain == want
    assert got > 1  # the shelf maze needs more than one round


def test_roofline_byte_model_is_the_originals():
    """The original's arithmetic (its ``main`` with the measured inputs
    substituted) on the same round counts, makespan and ms/step."""
    _, tasks, cfg = _warehouse_tasks()
    counts, makespan, ms = [3, 4, 3], 120, 2.5
    res = torch_roofline.roofline(counts, makespan, ms, len(tasks), cfg)
    r = cfg.replan_chunk_small
    loops = (2 * len(tasks) - cfg.num_agents) / makespan / r
    hw = cfg.num_cells * 4
    per_round = 4 * (2 * r * hw + hw) + 2 * r * hw
    per_loop = np.mean(counts) * per_round + 3 * r * hw \
        + r * cfg.num_cells // 2
    total = loops * per_loop + 6 * hw
    assert res["total_bytes"] == pytest.approx(total, rel=1e-12)
    assert res["ideal_ms"] == pytest.approx(
        total / (torch_roofline.H100_HBM_GBPS * 1e9) * 1e3, rel=1e-12)
    assert res["bandwidth_bound_fraction"] == pytest.approx(
        res["ideal_ms"] / ms, rel=1e-12)
    assert torch_roofline.H100_HBM_GBPS == 3350.0
    assert roofline.V5E_HBM_GBPS != torch_roofline.H100_HBM_GBPS


def test_quality_gap_matches_jax(monkeypatch, tmp_path):
    for module, grid_cls in ((jsc, JaxGrid), (tsc, Grid)):
        monkeypatch.setattr(module, "TINY_GAP", module.Scenario(
            "tiny-gap", lambda g=grid_cls: g.warehouse(48, 48), 10, 14),
            raising=False)
    out = tmp_path / "gap.json"
    monkeypatch.setattr(sys, "argv", [
        "quality_gap.py", "--rung", "tiny_gap", "--measured-makespan", "90",
        "--chunk", "4", "--out", str(out)])
    quality_gap.main()
    want = json.loads(out.read_text())
    got = torch_quality_gap.quality_gap(tsc.TINY_GAP, 90, 4, CPU,
                                        log=lambda m: None)
    assert got == want
    assert got["routing_est_assigned"] >= got["routing_est_nearest_start"]
