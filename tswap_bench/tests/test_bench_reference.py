"""The plain reference against the definitions it follows and against the
program on the CPU: distances against a breadth-first search, codes and
the first assignment against the program's, the plan checks against
planted faults."""

from collections import deque

import numpy as np
import pytest
import torch

from tswap_bench.reference import assign, fields, plans
from tswap_bench.traffic import inputs

GRIDS = {
    "random": lambda: inputs.random_obstacles(23, 31, 0.25, seed=4),
    "warehouse": lambda: inputs.warehouse(30, 44),
    "walled": lambda: np.pad(np.ones((6, 9), bool), 1) | np.eye(8, 11,
                                                               dtype=bool),
}


def bfs(free: np.ndarray, goal: int) -> np.ndarray:
    h, w = free.shape
    d = np.full(h * w, fields.INF, np.int64)
    if not free.reshape(-1)[goal]:
        return d.reshape(h, w)
    d[goal] = 0
    q = deque([goal])
    while q:
        c = q.popleft()
        y, x = divmod(c, w)
        for dx, dy in fields.DIRS:
            nx, ny = x + dx, y + dy
            n = ny * w + nx
            if 0 <= nx < w and 0 <= ny < h and free[ny, nx] \
                    and d[n] == fields.INF:
                d[n] = d[c] + 1
                q.append(n)
    return d.reshape(h, w)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_distances_are_bfs(grid):
    free = GRIDS[grid]()
    rng = np.random.default_rng(1)
    goals = rng.choice(free.size, size=12, replace=False)
    got = fields.distances(torch.from_numpy(free), torch.tensor(goals))
    for g, d in zip(goals, got):
        np.testing.assert_array_equal(d.numpy(), bfs(free, int(g)))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_codes_equal_the_programs(grid):
    from p2p_distributed_tswap_tpu_torch.ops import distance

    free = torch.from_numpy(GRIDS[grid]())
    goals = torch.arange(0, free.numel(), 7, dtype=torch.int32)
    ref = fields.codes(fields.distances(free, goals), free)
    prog = distance.direction_fields(free, goals)
    assert torch.equal(ref, prog)
    packed = distance.pack_directions(prog.reshape(len(goals), -1))
    assert torch.equal(fields.unpack(packed, free.numel()),
                       ref.reshape(len(goals), -1))


def test_codes_lead_downhill():
    free = torch.from_numpy(GRIDS["warehouse"]())
    goals = torch.tensor([5, 400, 1000])
    d = fields.distances(free, goals)
    c = fields.codes(d, free)
    cells = torch.arange(free.numel())
    for k in range(3):
        flat = d[k].reshape(-1)
        nxt = fields.next_cell(cells, c[k].reshape(-1), free.shape[1])
        move = c[k].reshape(-1) != fields.STAY
        assert torch.all(flat[nxt[move]] == flat[move] - 1)
        stay = ~move & free.reshape(-1) & (flat < fields.INF)
        assert torch.all(flat[stay] == 0)


def test_bfloat16_distances_break_past_256():
    free = torch.from_numpy(inputs.warehouse(24, 300))
    goals = torch.tensor([0, 7000])
    exact = fields.codes(fields.distances(free, goals), free)
    low = fields.codes(fields.distances(free, goals).to(torch.bfloat16),
                       free)
    assert int((exact != low).sum()) > 100


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_first_assignment_equals_the_programs(seed):
    from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
    from p2p_distributed_tswap_tpu_torch.solver import mapd

    free = inputs.warehouse(40, 60)
    starts, tasks = inputs.solve_inputs(free, 150, 150, seed)
    cfg = SolverConfig(height=40, width=60, num_agents=150)
    s, _ = mapd.prepare_state_unprimed(cfg, starts, tasks, device="cpu")
    ref = assign.first_assignment(torch.from_numpy(starts),
                                  torch.from_numpy(tasks), 60)
    assert torch.equal(s.agent_task.long(), ref)
    assert sorted(ref.tolist()) == list(range(150))


def test_plan_checks_find_planted_faults():
    free = torch.ones(4, 5, dtype=torch.bool)
    free[2, 2] = False
    starts = torch.tensor([0, 4])
    pos = torch.tensor([[1, 9], [2, 14], [3, 19]])
    assert plans.faults(starts, pos, free, 5) == 0
    assert plans.faults(starts, torch.tensor([[1, 9], [2, 2], [3, 7]]),
                        free, 5) == 2          # a jump, and a shared cell
    assert plans.faults(starts, torch.tensor([[1, 9], [12, 14], [3, 19]]),
                        free, 5) == 3          # an obstacle and two jumps
    state = torch.tensor([[1, 1], [2, 3], [3, 0], [0, 0]])
    owner = torch.tensor([0, 1])
    assert plans.undelivered(state, owner, 4, 10) == 0
    assert plans.undelivered(state, torch.tensor([0, 1, -1]), 4, 10) == 1
    assert plans.undelivered(state[:3], owner, 3, 10) == 1
    assert plans.undelivered(state, owner, 11, 10) == 1
    # a task delivered twice (one DELIVERED row per row would count 2 of
    # 2), and one dropped to IDLE before its delivery
    twice = torch.tensor([[1, 1], [3, 1], [3, 0], [0, 0]])
    assert plans.undelivered(twice, owner, 4, 10) == 2
    # wrong_moves: agents at 0, 5, 7 with next cells 1, 6, 8; the end row
    # holds every agent's cell
    pos_in = torch.tensor([0, 5, 7])
    nxt = torch.tensor([1, 6, 8])
    ends = torch.tensor([[1, 5, 8, 6]] * 3)
    assert plans.wrong_moves(pos_in, torch.tensor([1, 5, 7]), nxt,
                             ends) == 0     # moved; stayed with 6, 8 taken
    free_end = torch.tensor([[1, 5, 7, 9]] * 3)
    assert plans.wrong_moves(pos_in, torch.tensor([1, 5, 7]), nxt,
                             free_end) == 2  # stayed though 6, 8 came free
    assert plans.wrong_moves(pos_in, torch.tensor([1, 4, 7]), nxt,
                             ends) == 1      # a move to another cell
