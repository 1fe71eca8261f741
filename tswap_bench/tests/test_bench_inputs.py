"""The frozen copy of the program's input generators draws the ladder's
arrays: the grid, the starts and the tasks of seed 0 of both rungs."""

import numpy as np
import pytest

from tswap_bench.traffic import inputs


@pytest.mark.parametrize("rung, config", [("FLAGSHIP", "warehouse-10k-1024"),
                                          ("MEDIUM", "random-1k-512")])
def test_frozen_inputs_equal_ladder(rung, config):
    import json

    from conftest import ROOT
    from p2p_distributed_tswap_tpu_torch.models import scenarios

    grid, starts, tasks, cfg = getattr(scenarios, rung).build(seed=0)
    spec = json.loads((ROOT / "tswap_bench" / "configs"
                       / f"{config}.json").read_text())
    free = inputs.build_grid(spec["grid"])
    np.testing.assert_array_equal(free, grid.free)
    s, t = inputs.solve_inputs(free, spec["num_agents"], spec["num_agents"],
                               0)
    np.testing.assert_array_equal(s, starts)
    np.testing.assert_array_equal(t, tasks)
    assert s.dtype == np.int32 and t.dtype == np.int32
    assert cfg.replan_chunk == spec["planner"]["replan_chunk"]
    # the flagship's cap is raised past the ladder's (its file says why)
    assert spec["planner"]["max_timesteps"] >= cfg.max_timesteps
    assert cfg.replan_chunk_small == spec["planner"]["replan_chunk_small"]


def test_large_and_negative_seeds_draw():
    free = inputs.warehouse(40, 60)
    a = inputs.solve_inputs(free, 50, 50, 2**41 + 7)
    b = inputs.solve_inputs(free, 50, 50, 2**41 + 7)
    c = inputs.solve_inputs(free, 50, 50, -3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(np.unique(a[0])) == 50 and free.reshape(-1)[a[1]].all()
    assert len(np.unique(c[0])) == 50
