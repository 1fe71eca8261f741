"""Sequential TSWAP oracle — the executable spec for parity tests.

This is a pure-Python/numpy transcription of the *semantics* of the reference's
offline solver (``tswap_mapd`` + ``tswap_step`` + ``get_path``,
src/algorithm/tswap.rs:39-390).  It is TEST ORACLE code, not product code
(SURVEY §7 layer 3): the batched TPU solver is validated against it for
collision-freedom and makespan, never the other way around.

Documented deviations from the reference (shared with the TPU solver so the
two remain comparable):

1. Next-hop selection descends an exact BFS distance-to-goal field with
   first-minimum tie-breaking in the reference's neighbor order
   ``[(0,1),(1,0),(0,-1),(-1,0)]`` (src/algorithm/tswap.rs:62), instead of
   replaying A* heap order (src/algorithm/tswap.rs:288-390).  Both always step
   along *a* shortest path; only equal-length tie-breaks differ.
2. On an unreachable goal the agent waits, where the reference takes one
   greedy Manhattan step if strictly improving (src/algorithm/tswap.rs:378-389).
   Irrelevant on connected grids (all shipped generators guarantee this).

Everything else is step-for-step: Rule 1 stay-at-goal, Rule 3 goal swap with
an at-goal blocker, Rule 4 deadlock-chain walk with abort-on-revisit and goal
rotation, the sequential movement pass with mutual position swaps (including
the reference's quirk that a swap-moved agent can move again later in the same
pass), greedy nearest-pickup task assignment in agent-id order, the
Idle -> ToPickup -> ToDelivery machine, and the t > max_timesteps cutoff.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from p2p_distributed_tswap_tpu_torch.core.agent import AgentPhase, AgentState
from p2p_distributed_tswap_tpu_torch.core.grid import Grid

_NEIGHBOR_ORDER = ((0, 1), (1, 0), (0, -1), (-1, 0))  # (dx, dy)
_INF = 1 << 30


class OracleSim:
    """Sequential MAPD/TSWAP simulator over flat cell indices."""

    def __init__(self, grid: Grid, starts_idx: np.ndarray, tasks: np.ndarray,
                 max_timesteps: int = 2000):
        self.grid = grid
        self.free = grid.free
        self.h, self.w = grid.free.shape
        self.n = len(starts_idx)
        self.v = np.array(starts_idx, dtype=np.int64)  # current cell per agent
        self.g = self.v.copy()                         # goal cell per agent
        self.tasks = np.array(tasks, dtype=np.int64)   # (T, 2) pickup, delivery
        self.task_used = np.zeros(len(tasks), dtype=bool)
        self.agent_task: List[Optional[int]] = [None] * self.n
        self.phase = np.full(self.n, AgentPhase.IDLE, dtype=np.int64)
        self.max_timesteps = max_timesteps
        self.t = 0
        self.paths: List[List[Tuple[int, int]]] = [[] for _ in range(self.n)]
        self._dist_cache: Dict[int, np.ndarray] = {}
        assert len(np.unique(self.v)) == self.n, "duplicate start cells"

    # -- pathfinding (BFS field descent; deviation 1 above) ------------------

    def _dist_field(self, goal: int) -> np.ndarray:
        cached = self._dist_cache.get(goal)
        if cached is not None:
            return cached
        dist = np.full(self.h * self.w, _INF, dtype=np.int64)
        gy, gx = divmod(goal, self.w)
        if self.free[gy, gx]:
            dist[goal] = 0
            q = deque([goal])
            while q:
                c = q.popleft()
                cy, cx = divmod(c, self.w)
                for dx, dy in _NEIGHBOR_ORDER:
                    ny, nx = cy + dy, cx + dx
                    if 0 <= ny < self.h and 0 <= nx < self.w and self.free[ny, nx]:
                        nc = ny * self.w + nx
                        if dist[nc] > dist[c] + 1:
                            dist[nc] = dist[c] + 1
                            q.append(nc)
        self._dist_cache[goal] = dist
        return dist

    def next_hop(self, v: int, g: int) -> Optional[int]:
        """First cell after ``v`` on a shortest path to ``g`` (= path[1] of the
        reference's get_path); None when at goal or unreachable."""
        if v == g:
            return None
        dist = self._dist_field(g)
        if dist[v] >= _INF:
            return None
        vy, vx = divmod(v, self.w)
        best, best_d = None, dist[v]
        for dx, dy in _NEIGHBOR_ORDER:
            ny, nx = vy + dy, vx + dx
            if 0 <= ny < self.h and 0 <= nx < self.w:
                nc = ny * self.w + nx
                if dist[nc] < best_d:
                    best, best_d = nc, dist[nc]
        return best

    # -- one TSWAP step (ref tswap_step, src/algorithm/tswap.rs:174-286) -----

    def tswap_step(self) -> None:
        n, v, g = self.n, self.v, self.g

        def occupant(cell: int) -> Optional[int]:
            """First agent at ``cell`` (ref agents.iter().position, :192)."""
            hits = np.nonzero(v == cell)[0]
            return int(hits[0]) if len(hits) else None

        # --- goal-swapping phase (Rules 1, 3, 4; ref :180-252) ---
        for i in range(n):
            if v[i] == g[i]:
                continue  # Rule 1
            u = self.next_hop(v[i], g[i])
            if u is None:
                continue
            j = occupant(u)
            if j is None or j == i:
                continue
            if v[j] == g[j]:
                # Rule 3: blocker parked on its goal -> swap goals (:197-202)
                g[i], g[j] = g[j], g[i]
            else:
                # Rule 4: walk the blocking chain (:204-238)
                a_p = [i]
                cur = j
                deadlock = False
                while True:
                    if v[cur] == g[cur]:
                        break
                    wh = self.next_hop(v[cur], g[cur])
                    if wh is None:
                        break
                    c = occupant(wh)
                    if c is None:
                        break
                    if cur in a_p:
                        a_p = []
                        break  # revisit that is not a cycle through i: abort
                    a_p.append(cur)
                    cur = c
                    if cur == i:
                        deadlock = True
                        break
                if deadlock and len(a_p) > 1:
                    # rotate goals backward along the cycle (:241-248)
                    last_goal = g[a_p[-1]]
                    for k in range(len(a_p) - 1, 0, -1):
                        g[a_p[k]] = g[a_p[k - 1]]
                    g[a_p[0]] = last_goal

        # --- movement phase (Rules 2, 5, mutual swap; ref :257-285) ---
        for i in range(n):
            if v[i] == g[i]:
                continue
            u = self.next_hop(v[i], g[i])
            if u is None:
                continue
            j = occupant(u)
            if j is not None:
                if i != j:
                    uj = self.next_hop(v[j], g[j])
                    if uj is not None and uj == v[i]:
                        v[i], v[j] = v[j], v[i]  # mutual position swap (:274-278)
                    # else Rule 5: stay
            else:
                v[i] = u  # Rule 2

    # -- MAPD loop (ref tswap_mapd, src/algorithm/tswap.rs:104-170) ----------

    def run(self) -> int:
        """Run to completion; returns the makespan (number of recorded steps)."""
        while True:
            self.step_mapd()
            if self.finished():
                return self.t

    def step_mapd(self) -> None:
        v, g = self.v, self.g
        for i in range(self.n):
            # arrival transitions (:106-121)
            if v[i] == g[i]:
                if self.phase[i] == AgentPhase.TO_PICKUP:
                    self.phase[i] = AgentPhase.TO_DELIVERY
                    g[i] = self.tasks[self.agent_task[i]][1]
                elif self.phase[i] == AgentPhase.TO_DELIVERY:
                    self.phase[i] = AgentPhase.IDLE
                    self.agent_task[i] = None
            # greedy nearest-pickup assignment (:123-138)
            if self.phase[i] == AgentPhase.IDLE:
                unused = np.nonzero(~self.task_used)[0]
                if len(unused):
                    py, px = divmod(v[i], self.w)
                    d = (np.abs(self.tasks[unused, 0] % self.w - px)
                         + np.abs(self.tasks[unused, 0] // self.w - py))
                    k = unused[int(np.argmin(d))]  # first min = lowest task idx
                    self.task_used[k] = True
                    self.agent_task[i] = int(k)
                    self.phase[i] = AgentPhase.TO_PICKUP
                    g[i] = self.tasks[k][0]

        self.tswap_step()

        # record paths (:143-158)
        for i in range(self.n):
            if self.phase[i] == AgentPhase.IDLE:
                s = AgentState.IDLE
            elif self.phase[i] == AgentPhase.TO_PICKUP:
                s = AgentState.PICKING
            elif v[i] == g[i]:
                s = AgentState.DELIVERED
            else:
                s = AgentState.CARRYING
            self.paths[i].append((int(v[i]), int(s)))
        self.t += 1

    def finished(self) -> bool:
        return (bool(self.task_used.all())
                and bool((self.phase == AgentPhase.IDLE).all())) \
            or self.t > self.max_timesteps

    # -- invariants ----------------------------------------------------------

    def assert_no_collisions(self) -> None:
        assert len(np.unique(self.v)) == self.n, "vertex collision"
