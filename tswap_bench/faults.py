"""Faults planted under the timed path, to show that the correctness check
catches them: each is a replacement for one program function, named by
"module:attr" as ``harness.run``'s ``patches`` take it, with the number
compared that it has to fail.  ``tests/test_bench_faults.py`` runs each on
the CPU, ``control.py --fault <name>`` on the card at a cell's own size.
The benchmark's own runs never plant one.
"""

from __future__ import annotations

import dataclasses

from p2p_distributed_tswap_tpu_torch.ops import distance
from p2p_distributed_tswap_tpu_torch.solver import mapd, step

MAPD = "p2p_distributed_tswap_tpu_torch.solver.mapd"
ASSIGN = mapd._assign


def unchanged(cfg, pos, goal, slot, dirs, *a, **kw):
    """A step that returns its state unchanged."""
    return pos.clone(), goal.clone(), slot.clone()


def half_batch(cfg, pos, goal, slot, dirs, *a, **kw):
    """Half of the agents stepped, the other half left out."""
    p, g, s = step.step_parallel(cfg, pos, goal, slot, dirs, *a, **kw)
    h = pos.shape[0] // 2
    p, g, s = p.clone(), g.clone(), s.clone()
    p[h:], g[h:], s[h:] = pos[h:], goal[h:], slot[h:]
    return p, g, s


def moved_answer(cfg, pos, goal, slot, dirs, *a, **kw):
    """An answer altered where it is produced: agent 0 jumps two cells."""
    p, g, s = step.step_parallel(cfg, pos, goal, slot, dirs, *a, **kw)
    p = p.clone()
    p[0] = (p[0] + 2) % (cfg.height * cfg.width)
    return p, g, s


def cascade_cut(cfg, pos, goal, slot, dirs, *a, **kw):
    """A step that does less: the movement cascade cut after one round,
    so an agent whose next cell comes free only in a later round waits."""
    cut = dataclasses.replace(cfg, max_move_rounds=1)
    return step.step_parallel(cut, pos, goal, slot, dirs, *a, **kw)


def no_goal_swaps(cfg, pos, goal, slot, dirs, *a, **kw):
    """A step that does less: no Rule-3 or Rule-4 goal swap."""
    bare = dataclasses.replace(cfg, swap_rounds=0)
    return step.step_parallel(bare, pos, goal, slot, dirs, *a, **kw)


def altered_field(free, goals_idx, max_rounds=128):
    """Every field's code at one cell altered where it is produced."""
    codes = distance.direction_fields(free, goals_idx, max_rounds).clone()
    codes[:, 0, 0] = (codes[:, 0, 0] + 1) % 5
    return codes


def swapped_tasks(cfg, s, tasks):
    """An assignment altered where it is produced: agents 0 and 1 hold
    each other's tasks."""
    out = ASSIGN(cfg, s, tasks)
    task = out.agent_task.clone()
    task[0], task[1] = out.agent_task[1], out.agent_task[0]
    return out.replace(agent_task=task)


# name -> (target, replacement, the number it has to fail)
FAULTS = {
    "swapped_tasks": (f"{MAPD}:_assign", swapped_tasks, "assign_mismatch"),
    "unchanged": (f"{MAPD}:step_parallel", unchanged, "move_mismatch"),
    "half_batch": (f"{MAPD}:step_parallel", half_batch, "move_mismatch"),
    "moved_answer": (f"{MAPD}:step_parallel", moved_answer, "plan_faults"),
    "cascade_cut": (f"{MAPD}:step_parallel", cascade_cut, "move_mismatch"),
    "no_goal_swaps": (f"{MAPD}:step_parallel", no_goal_swaps,
                      "undelivered"),
    "altered_field": (f"{MAPD}:direction_fields", altered_field,
                      "field_mismatch"),
}
