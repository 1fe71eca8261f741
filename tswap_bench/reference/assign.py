"""Plain reference for the first task assignment of a solve.

Greedy nearest-pickup assignment in parallel rounds, as the configuration
states it: every idle agent proposes the unused task whose pickup is
nearest to it (Manhattan distance, the lowest task index on ties); each
proposed task goes to the lowest proposing agent id; the losers propose
again in the next round, until a round assigns nothing.  At a solve's
start every agent is idle at its start cell and every task is unused.
"""

from __future__ import annotations

import torch


def first_assignment(starts: torch.Tensor, tasks: torch.Tensor,
                     width: int) -> torch.Tensor:
    """(N,) int64 task index per agent, -1 where an agent gets none."""
    n, t = starts.shape[0], tasks.shape[0]
    dev = starts.device
    a = starts.long()
    p = tasks[:, 0].long()
    dist = ((a % width)[:, None] - (p % width)[None, :]).abs() \
        + ((a // width)[:, None] - (p // width)[None, :]).abs()
    far = dist.max() + 1
    owner = torch.full((n,), -1, dtype=torch.int64, device=dev)
    used = torch.zeros(t, dtype=torch.bool, device=dev)
    agents = torch.arange(n, device=dev)
    while True:
        idle = owner < 0
        if not bool(idle.any()) or bool(used.all()):
            return owner
        masked = torch.where(used[None, :], far, dist)
        # argmin returns the first minimum: the lowest task index
        want = masked.argmin(dim=1)
        ok = idle & ~used[want]
        claim = torch.full((t,), n, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, want[ok], agents[ok], "amin")
        win = ok & (claim[want] == agents)
        if not bool(win.any()):
            return owner
        owner = torch.where(win, want, owner)
        used[want[win]] = True


def owners(assigned: torch.Tensor, num_tasks: int) -> torch.Tensor:
    """(T,) int64 agent per task of an assignment (-1 where none)."""
    out = torch.full((num_tasks,), -1, dtype=torch.int64,
                     device=assigned.device)
    agents = torch.nonzero(assigned >= 0)[:, 0]
    out[assigned[agents]] = agents
    return out
