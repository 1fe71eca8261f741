"""Tasks and task generation.

Reference: ``Task { pickup, delivery, peer_id, task_id }`` (the only shared
serde struct on the wire, src/map/task_generator.rs:6-12) and
``TaskGeneratorAgent`` which samples random free start/goal pairs
(src/map/task_generator.rs:14-49 via src/map/make_node.rs:31-43).

Differences by design: generation is seeded (the reference uses thread_rng —
unreproducible), and batch generation returns dense (K, 2) index arrays ready
for device upload alongside the dataclass view.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from p2p_distributed_tswap_tpu_torch.core.grid import Grid, Point


@dataclasses.dataclass
class Task:
    pickup: Point
    delivery: Point
    peer_id: Optional[str] = None
    task_id: Optional[int] = None

    def to_json_dict(self) -> dict:
        """Wire form: matches the reference's serde serialization of Task
        (tuples as [x, y] arrays)."""
        return {
            "pickup": [int(self.pickup[0]), int(self.pickup[1])],
            "delivery": [int(self.delivery[0]), int(self.delivery[1])],
            "peer_id": self.peer_id,
            "task_id": None if self.task_id is None else int(self.task_id),
        }

    @staticmethod
    def from_json_dict(d: dict) -> "Task":
        return Task(
            pickup=tuple(d["pickup"]),
            delivery=tuple(d["delivery"]),
            peer_id=d.get("peer_id"),
            task_id=d.get("task_id"),
        )


class TaskGenerator:
    """Seeded random task generator (capability of TaskGeneratorAgent,
    src/map/task_generator.rs:14-49)."""

    def __init__(self, grid: Grid, seed: int = 0):
        self.grid = grid
        self.rng = np.random.default_rng(seed)
        self._free = grid.free_cells()
        assert len(self._free) >= 2, "need at least 2 free cells for a task"
        self._next_id = 0

    def generate_task(self) -> Task:
        i, j = self.rng.choice(len(self._free), size=2, replace=False)
        t = Task(pickup=(int(self._free[i][0]), int(self._free[i][1])),
                 delivery=(int(self._free[j][0]), int(self._free[j][1])),
                 task_id=self._next_id)
        self._next_id += 1
        return t

    def generate_multiple_tasks(self, count: int) -> List[Task]:
        return [self.generate_task() for _ in range(count)]

    def generate_task_arrays(self, count: int) -> np.ndarray:
        """(count, 2) int32 array of [pickup_idx, delivery_idx] flat cell
        indices — the dense form the batched solver consumes."""
        tasks = self.generate_multiple_tasks(count)
        out = np.empty((count, 2), dtype=np.int32)
        for k, t in enumerate(tasks):
            out[k, 0] = self.grid.idx(t.pickup)
            out[k, 1] = self.grid.idx(t.delivery)
        return out

    def generate_distinct_task_arrays(self, count: int,
                                      exclude: Optional[np.ndarray] = None
                                      ) -> np.ndarray:
        """Like :meth:`generate_task_arrays`, but ALL 2*count endpoints are
        distinct cells (optionally also disjoint from ``exclude``, e.g.
        agent start cells).

        Shared endpoints trigger the reference's shared-delivery deadlock
        (Rule-3 swap of identical goals no-ops forever, tswap.rs:197-202) —
        with random endpoints the birthday bound makes that near-certain
        once tasks number in the hundreds, which would starve the
        makespan-parity comparison of oracle-completing seeds
        (analysis/parity_table.py).  Distinct endpoints model the
        warehouse-station setting and keep the *sequential semantics*
        comparable at scale.
        """
        free_idx = np.array([self.grid.idx(p) for p in self._free],
                            dtype=np.int32)
        if exclude is not None and len(exclude):
            free_idx = np.setdiff1d(free_idx, np.asarray(exclude,
                                                         dtype=np.int32))
        need = 2 * count
        assert len(free_idx) >= need, (
            f"{need} distinct endpoints requested but only {len(free_idx)} "
            "eligible free cells")
        cells = self.rng.choice(free_idx, size=need, replace=False)
        self._next_id += count
        return cells.reshape(count, 2).astype(np.int32)


def tasks_to_arrays(grid: Grid, tasks: List[Task]) -> np.ndarray:
    out = np.empty((len(tasks), 2), dtype=np.int32)
    for k, t in enumerate(tasks):
        out[k, 0] = grid.idx(t.pickup)
        out[k, 1] = grid.idx(t.delivery)
    return out
