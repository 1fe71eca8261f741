"""The inputs of a solve: the grid, the agents' starts and the task set.

A frozen copy of the program's generators (``core/grid.py``
``Grid.warehouse`` and ``Grid.random_obstacles``, ``core/sampling.py``
``start_positions_array``, ``core/tasks.py``
``TaskGenerator.generate_task_arrays``), in numpy alone, so that a later
change to the program cannot move the work the benchmark hands it.  For the
same arguments it draws the same arrays as the program's scenario ladder
(``models/scenarios.py`` ``Scenario.build``); ``tests/test_bench_inputs.py``
pins that for seed 0.

Cells are flat row-major indices ``y * W + x`` (int32), free cells in the
row-major order of ``np.nonzero``.
"""

from __future__ import annotations

import numpy as np


def warehouse(height: int, width: int, shelf_h: int = 2, shelf_w: int = 8,
              aisle: int = 2, margin: int = 4) -> np.ndarray:
    """(H, W) bool, True where free: aligned shelf blocks of ``shelf_h`` x
    ``shelf_w`` cells separated by ``aisle``-cell aisles, inside a free
    ``margin``."""
    free = np.ones((height, width), dtype=np.bool_)
    y = margin
    while y + shelf_h <= height - margin:
        x = margin
        while x + shelf_w <= width - margin:
            free[y:y + shelf_h, x:x + shelf_w] = False
            x += shelf_w + aisle
        y += shelf_h + aisle
    return free


def random_obstacles(height: int, width: int, density: float,
                     seed: int) -> np.ndarray:
    """(H, W) bool: each cell an obstacle with probability ``density``,
    then only the largest 4-connected free component kept free, so that
    every free cell reaches every other."""
    rng = np.random.default_rng(seed)
    free = rng.random((height, width)) >= density
    if not free.any():
        return free
    from scipy import ndimage

    four = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    labels, n = ndimage.label(free, structure=four)
    if n <= 1:
        return free
    counts = np.bincount(labels.reshape(-1))
    counts[0] = 0
    return labels == int(np.argmax(counts))


def build_grid(spec: dict) -> np.ndarray:
    """The grid a configuration file's ``grid`` object describes."""
    kind = spec["kind"]
    if kind == "warehouse":
        return warehouse(spec["height"], spec["width"], spec["shelf_h"],
                         spec["shelf_w"], spec["aisle"], spec["margin"])
    if kind == "random_obstacles":
        return random_obstacles(spec["height"], spec["width"],
                                spec["density"], spec["seed"])
    raise ValueError(f"unknown grid kind {kind!r}")


def _rng(seed: int) -> np.random.Generator:
    # default_rng takes any non-negative integer, however large; a
    # negative seed gets a stream of its own
    return np.random.default_rng(seed if seed >= 0 else [1, -seed])


def starts(free: np.ndarray, count: int, seed: int) -> np.ndarray:
    """(count,) int32 distinct free cells, drawn as the program's
    ``start_positions_array`` draws them."""
    cells = np.flatnonzero(free)
    if count > len(cells):
        raise ValueError(f"{count} agents > {len(cells)} free cells")
    pick = _rng(seed).choice(len(cells), size=count, replace=False)
    return cells[pick].astype(np.int32)


def tasks(free: np.ndarray, count: int, seed: int) -> np.ndarray:
    """(count, 2) int32 [pickup, delivery]: each task two distinct random
    free cells, one draw per task as the program's
    ``TaskGenerator.generate_task_arrays`` (and the reference's task
    generator, src/map/task_generator.rs:14-49) samples them.  Cells may
    repeat across tasks."""
    cells = np.flatnonzero(free)
    rng = _rng(seed)
    out = np.empty((count, 2), dtype=np.int32)
    for k in range(count):
        i, j = rng.choice(len(cells), size=2, replace=False)
        out[k, 0] = cells[i]
        out[k, 1] = cells[j]
    return out


def solve_inputs(free: np.ndarray, num_agents: int, num_tasks: int,
                 seed: int):
    """(starts, tasks) of one solve of seed ``seed``: starts from ``seed``
    and tasks from ``seed + 1``, as the program's ``Scenario.build``."""
    return (starts(free, num_agents, seed),
            tasks(free, num_tasks, seed + 1))
