"""Seeded sampling of start positions and start/goal pairs.

Capability parity with src/map/make_node.rs:
- ``get_free_cells``      -> Grid.free_cells (core/grid.py)
- ``generate_start_goal_pair(s)`` (:17-43)  -> sample_start_goal_pairs
- ``generate_start_positions``    (:45-49)  -> sample_start_positions

All sampling is deterministic given a seed (the reference's thread_rng is not),
and collision-free by construction — this also replaces the reference's racy
distributed initial-position protocol (src/bin/decentralized/agent.rs:518-650)
with deterministic collision-free assignment, per SURVEY §3.4.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from p2p_distributed_tswap_tpu_torch.core.grid import Grid, Point


def sample_start_positions(grid: Grid, count: int, seed: int) -> List[Point]:
    """``count`` distinct random free cells (ref make_node.rs:45-49)."""
    free = grid.free_cells()
    assert count <= len(free), f"{count} agents > {len(free)} free cells"
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(free), size=count, replace=False)
    return [(int(free[i][0]), int(free[i][1])) for i in pick]


def sample_start_goal_pairs(grid: Grid, count: int, seed: int) -> List[Tuple[Point, Point]]:
    """``count`` (start, goal) pairs over distinct free cells
    (ref make_node.rs:17-31: shuffle free cells, take disjoint pairs)."""
    free = grid.free_cells()
    assert 2 * count <= len(free), "not enough free cells for disjoint pairs"
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(free), size=2 * count, replace=False)

    def pt(k: int) -> Point:
        return (int(free[k][0]), int(free[k][1]))

    return [(pt(pick[2 * i]), pt(pick[2 * i + 1])) for i in range(count)]


def start_positions_array(grid: Grid, count: int, seed: int) -> np.ndarray:
    """(count,) int32 flat indices of distinct random free cells."""
    pts = sample_start_positions(grid, count, seed)
    return np.array([grid.idx(p) for p in pts], dtype=np.int32)
