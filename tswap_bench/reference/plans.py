"""Plain reference checks of a solve's recorded plan.

A plan is the recorded position and state of every agent at every
timestep: ``pos`` (T, N) flat cells and ``state`` (T, N) codes, row t the
end of step t.  What the configuration guarantees, checked on every row
(the last on the sampled agents of sampled steps):

- every agent on a free cell, no two agents on one cell;
- every transition a stay or a unit step to a 4-neighbour (the start row
  before step 0 included);
- a finished solve delivered every task once: the agent that took it
  (the reference's first assignment; one task per agent) stands
  DELIVERED in exactly one row, its states run PICKING, CARRYING,
  DELIVERED, IDLE in that order, and the last row has every agent IDLE,
  within the horizon;
- an agent's move is to its next cell (the reference's, toward the goal
  it ends the step with), or a stay where another agent ends the step on
  that cell: a step moves an agent whose next cell comes free.
"""

from __future__ import annotations

import torch

# Recorded states, as the configuration's path format numbers them
# (the reference's src/map/agent.rs:9-15).
IDLE, PICKING, CARRYING, DELIVERED = 0, 1, 2, 3


def faults(starts: torch.Tensor, pos: torch.Tensor, free: torch.Tensor,
           width: int) -> int:
    """Transitions that break the plan's guarantees, counted per agent and
    row: off a free cell, sharing a cell, or moving further than one unit
    step."""
    prev = torch.cat([starts.long()[None], pos.long()[:-1]])
    cur = pos.long()
    hw = free.numel()
    outside = (cur < 0) | (cur >= hw)
    on_free = free.reshape(-1)[cur.clamp(0, hw - 1)] & ~outside
    ordered = cur.sort(dim=1).values
    shared = (ordered[:, 1:] == ordered[:, :-1]).sum()
    step = (cur % width - prev % width).abs() + (cur // width
                                                  - prev // width).abs()
    return int((~on_free).sum() + shared + (step > 1).sum())


# The order of an agent's recorded states over a solve: IDLE comes last,
# after its one task is delivered.
_ORDER = torch.tensor([3, 0, 1, 2])


def undelivered(state: torch.Tensor, owner: torch.Tensor, makespan: int,
                horizon: int) -> int:
    """Tasks of a finished solve that the agent which took them
    (``owner``, (T,) agent per task, -1 none) did not deliver exactly once
    and in order, and one more where the last row is not all IDLE or the
    solve ran past the horizon."""
    cols = state[:, owner.clamp(min=0)].long()
    once = (cols == DELIVERED).sum(0) == 1
    order = _ORDER.to(cols.device)[cols]
    in_order = (order[1:] >= order[:-1]).all(0)
    missing = int((~(once & in_order & (owner >= 0))).sum())
    open_end = bool((state[-1] != IDLE).any()) or makespan > horizon
    return missing + int(open_end)


def wrong_moves(pos_in: torch.Tensor, pos_out: torch.Tensor,
                nxt: torch.Tensor, ends: torch.Tensor) -> int:
    """Sampled agents whose move is neither to their next cell ``nxt``
    nor a stay where another agent ends the step on ``nxt``; ``ends`` is,
    per sampled agent, the row of every agent's cell at the end of its
    step."""
    taken = (ends == nxt[:, None]).any(1)
    ok = (pos_out == nxt) | ((pos_out == pos_in) & taken)
    return int((~ok).sum())
