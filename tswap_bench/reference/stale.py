"""Plain reference for one MAPD step of the decentralized agent under stale
views, for every agent at once.

Written from the rules of the reference's decentralized agent
(RenKoya1/p2p_distributed_tswap, ``src/bin/decentralized/agent.rs``) as the
JAX package's ``step_stale`` docstring sets them on a grid of discrete
steps; plain PyTorch and Python, no code of the program.  Decisions are
taken agent by agent over Python lists, as each agent's own tick would take
them; only the distance fields (``reference/fields.py``) are tensor code.

One step, from the state before it (cells flat ``y * W + x``):

1. Commit.  The goal exchanges decided a step ago land: agent i takes the
   goal agent ``pend_from[i]`` held, and an agent with a push target
   (``pend_push[i] >= 0``) takes that cell as its goal instead (the peer
   mutates its goal when the request or response arrives,
   agent.rs:1041-1107).
2. Task machine (the reference's ``tswap_mapd``, src/algorithm/tswap.rs:
   106-121).  An agent on its goal on the way to a pickup turns toward its
   own task's delivery; one on its goal on the way to a delivery turns
   idle.  Goals move between agents; tasks do not.  (Every task goes out
   at the solve's start, one an agent, so no step assigns one; a step that
   would is refused.)
3. View.  Agent i broadcasts its cell and goal at the steps t with
   ``(t + i mod K) mod K == 0``, K the refresh period (each agent's
   position timer, agent.rs:730, on a phase of its own).  An entry older
   than the TTL is not seen (agent.rs:156-167); with none, every entry is.
4. Next cell, from the agent's own true cell and goal: on its goal it
   stays; else the neighbour first in the order (0, 1), (1, 0), (0, -1),
   (-1, 0) whose shortest-path distance to the goal is least, if that is
   less than its own (``fields.codes``).
5. Blocker: the seen agent whose broadcast cell is that next cell (the
   lowest id where several claim one), unless that is the agent itself or
   its broadcast cell lies more than the radius (Manhattan) from the
   agent's true cell: then it is out of the agent's cache (agent.rs:
   796-801) and the cell is believed free.
6. Rule 3 (WaitForGoalSwap).  An agent claims its blocker when the view
   shows the blocker on its own goal.  Each blocker goes to its lowest
   claimant; a winning claim forms a pair unless its claimant or its
   blocker is also in a winning claim of a lower claimant.  A pair
   exchanges goals (pending), or, where the blocker's goal is the
   claimant's own goal, the blocker is pushed toward the claimant's cell;
   under the rule ``park`` a claimant with no task takes its own cell as
   its goal (pending) instead, and the blocker keeps its goal.
7. Rule 4 (WaitForRotation, agent.rs:379-448, 907-921).  Each agent's
   successor is its blocker, unless either of them is in a pair or in a
   goal-mutual pair (two agents next to each other, each wanting and
   holding as goal the other's cell).  A ring of successors rotates, every
   member handing its goal to its successor (pending), when some member
   (the initiator) sees every member of the ring, itself included, where
   the view places it within the radius; then all members rotate.
8. Movement.  Goal-mutual pairs swap cells.  An agent moves only where the
   view shows its next cell free.  Each cell goes to its lowest mover,
   which moves when the cell is empty, or in the round after the cell's
   occupant moved on, up to ``max_move_rounds`` rounds; an occupant that
   stays, or swaps with its partner, keeps the cell closed.
9. With a commit delay of 0 the exchanges of this step land at its end.

Departures from the reference agent, as the program makes them:

- Decisions read the view; movement is physical.  The reference's agents
  declare their own cells and may overlap for a while; here a move is
  granted only into a cell that is really free or vacated, so an agent
  whose believed-free cell is taken stays, and plans stay vertex-disjoint.
- Time is discrete: the 500 ms timers are steps, the refresh a period of
  K steps on per-agent phases, the wire's latency one step of commit
  delay, the TTL a number of steps.
- Next cells come from shortest-path distances with a fixed order of
  directions, not from each agent's A*.
- Conflicts go to the lowest agent id: blockers' claims, shared cells in
  the view, and cells in the movement.
- Rings come from one successor function shared by all agents, so every
  detected ring is consistent (the reference's initiator lists the members
  in its message); a ring is found when it has at most ``cycle_cap + 1``
  members (its walk takes ``cycle_cap`` hops past the first successor).
- Two agents that want each other's cells never swap, except a goal-mutual
  pair, the state a committed push leaves (the reference's decentralized
  mode has no swap action).
- The push: where the blocker's goal is the claimant's own (two tasks share
  a delivery cell), the blocker's goal becomes the claimant's cell, where
  the reference's Rule 3 would exchange equal goals for ever.  Idle agents
  that share a goal can push it from one to another round a crowded
  crossing for ever, and hold an agent with a task behind them; under the
  rule ``park`` (``Rules.idle_claimant``) an idle claimant parks on its
  own cell instead, which the reference agent, whose Rule 3 knows only
  exchanges, never needs.
"""

from __future__ import annotations

import dataclasses

import torch

from tswap_bench.reference import fields

# The task machine's phases, as the captured state numbers them.
IDLE, TO_PICKUP, TO_DELIVERY = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Rules:
    """The configuration's settings that one step reads."""
    width: int
    radius: int
    refresh: int            # view refresh period K, in steps
    ttl: int | None         # view age-out in steps; None: never
    delay: int              # commit delay, 0 or 1
    cycle_cap: int
    max_move_rounds: int
    idle_claimant: str = "push"     # Rule 3's push case for an idle claimant

    def __post_init__(self):
        if self.idle_claimant not in ("push", "park"):
            raise ValueError(f"idle claimant rule {self.idle_claimant!r}")


class NextCells:
    """Each agent's next cell toward its goal (step 4), from the direction
    codes of ``reference/fields.py``, computed once per goal cell in batches
    of ``batch`` goals and kept."""

    def __init__(self, free: torch.Tensor, width: int, batch: int):
        self.free, self.width, self.batch = free, width, batch
        self.rows: dict = {}

    def __call__(self, pos: list, goal: list) -> list:
        dev = self.free.device
        new = sorted({g for p, g in zip(pos, goal)
                      if p != g and g not in self.rows})
        for o in range(0, len(new), self.batch):
            cells = new[o:o + self.batch]
            g = torch.tensor(cells, dtype=torch.int64, device=dev)
            codes = fields.codes(fields.distances(self.free, g), self.free)
            for cell, row in zip(cells, codes.reshape(len(cells), -1)):
                self.rows[cell] = row
        out = list(pos)
        away = [i for i in range(len(pos)) if pos[i] != goal[i]]
        if away:
            rows = torch.stack([self.rows[goal[i]] for i in away])
            p = torch.tensor([pos[i] for i in away], dtype=torch.int64,
                             device=dev)
            code = rows.gather(1, p[:, None])[:, 0]
            for i, c in zip(away, fields.next_cell(p, code,
                                                   self.width).tolist()):
                out[i] = c
        return out


def step(state: dict, tasks: torch.Tensor, rules: Rules,
         next_cells: NextCells) -> dict:
    """One stale MAPD step for every agent, from ``state`` (tensors
    ``pos``, ``goal``, ``phase``, ``task``, ``used``, ``vpos``, ``vgoal``,
    ``vstamp``, ``pend_from``, ``pend_push`` and the int ``t``) and the
    solve's ``tasks`` ((T, 2) pickup, delivery).  Returns lists: ``pos``
    after the step, ``goal`` after it (every commit of the step applied),
    the exchanges left pending, ``pend_from`` and ``pend_push``, the task
    machine's ``phase``, and the view as refreshed, ``vpos``, ``vgoal`` and
    ``vstamp``."""
    pos, goal, phase, task, used, vpos, vgoal, vstamp, pfrom, ppush = (
        state[k].tolist() for k in ("pos", "goal", "phase", "task", "used",
                                    "vpos", "vgoal", "vstamp", "pend_from",
                                    "pend_push"))
    t, n, w, r = int(state["t"]), len(pos), rules.width, rules.radius

    def far(a, b):
        return abs(a % w - b % w) + abs(a // w - b // w)

    def commit(goal, pfrom, ppush):
        return [ppush[i] if ppush[i] >= 0 else goal[pfrom[i]]
                for i in range(n)]

    # 1. commit; 2. task machine
    goal = commit(goal, pfrom, ppush)
    pairs_of_tasks = tasks.tolist()
    for i in range(n):
        if pos[i] == goal[i] and phase[i] == TO_PICKUP:
            goal[i], phase[i] = pairs_of_tasks[task[i]][1], TO_DELIVERY
        elif pos[i] == goal[i] and phase[i] == TO_DELIVERY:
            phase[i], task[i] = IDLE, -1
    if IDLE in phase and not all(used):
        raise ValueError("a task is left to hand out: this reference covers "
                         "solves whose tasks all go out at their start")

    # 3. view
    for i in range(n):
        if (t + i % rules.refresh) % rules.refresh == 0:
            vpos[i], vgoal[i], vstamp[i] = pos[i], goal[i], t
    believed: dict = {}
    for j in range(n):
        if rules.ttl is None or t - vstamp[j] <= rules.ttl:
            believed.setdefault(vpos[j], j)

    # 4. next cells; 5. blockers
    u = next_cells(pos, goal)
    blocker = [-1] * n
    for i in range(n):
        j = believed.get(u[i], -1) if u[i] != pos[i] else -1
        if j >= 0 and j != i and far(pos[i], vpos[j]) <= r:
            blocker[i] = j

    # 6. Rule 3
    granted: dict = {}                       # blocker -> lowest claimant
    for i in range(n):
        b = blocker[i]
        if b >= 0 and vpos[b] == vgoal[b]:
            granted.setdefault(b, i)
    lowest: dict = {}                        # agent -> lowest claimant
    for b, c in granted.items():
        for a in (b, c):
            lowest[a] = min(lowest.get(a, n), c)
    pend_from, pend_push = list(range(n)), [-1] * n
    in_pair = set()
    for b, c in granted.items():
        if lowest[b] == c and lowest[c] == c:
            in_pair |= {b, c}
            if vgoal[b] != goal[c]:
                pend_from[c], pend_from[b] = b, c
            elif rules.idle_claimant == "park" and phase[c] == IDLE:
                pend_push[c] = pos[c]
            else:
                pend_push[b] = pos[c]

    # 7. Rule 4
    occupant = {pos[j]: j for j in range(n)}
    mutual = [False] * n
    for i in range(n):
        j = occupant.get(u[i], -1) if u[i] != pos[i] else -1
        mutual[i] = (j >= 0 and goal[i] == u[i] and goal[j] == pos[i]
                     and u[j] == pos[i])
    succ = [b if b >= 0 and not ({i, b} & in_pair) and not mutual[i]
            and not mutual[b] else -1 for i, b in enumerate(blocker)]
    seen_ring = set()
    for i in range(n):
        if succ[i] < 0 or i in seen_ring:
            continue
        ring, j = [i], succ[i]
        while j >= 0 and j != i and len(ring) <= rules.cycle_cap:
            ring.append(j)
            j = succ[j]
        if j != i:
            continue
        seen_ring.update(ring)
        if any(all(far(pos[a], vpos[m]) <= r for m in ring) for a in ring):
            for x in ring:
                pend_from[succ[x]] = x

    # 8. movement
    new = [u[i] if mutual[i] else pos[i] for i in range(n)]
    first: dict = {}                         # cell -> lowest mover
    for i in range(n):
        if u[i] != pos[i] and blocker[i] < 0 and not mutual[i]:
            first.setdefault(u[i], i)
    winners = set(first.values())
    rounds: dict = {}                        # winner -> its move's round
    never = float("inf")
    for i in sorted(winners):
        chain, on_chain, j = [], set(), i
        while j not in rounds:
            if j in on_chain:                # a ring of movers: none moves
                base = never
                break
            chain.append(j)
            on_chain.add(j)
            b = occupant.get(u[j], -1)
            if b < 0:                        # an empty cell: round 1
                base = 0
                break
            if b not in winners:             # its occupant stays or swaps
                base = never
                break
            j = b
        else:
            base = rounds[j]
        for k in reversed(chain):
            base += 1
            rounds[k] = base
    for i, k in rounds.items():
        if k <= rules.max_move_rounds:
            new[i] = u[i]

    # 9. a commit delay of 0 lands this step's exchanges now
    if rules.delay == 0:
        goal = commit(goal, pend_from, pend_push)
        pend_from, pend_push = list(range(n)), [-1] * n
    return {"pos": new, "goal": goal, "pend_from": pend_from,
            "pend_push": pend_push, "phase": phase, "vpos": vpos,
            "vgoal": vgoal, "vstamp": vstamp}


# Rank of each recorded state (IDLE, PICKING, CARRYING, DELIVERED, as
# ``reference/plans.py`` numbers them) in an owner's run through its task.
_RANK = torch.tensor([2, 0, 1, 1])


def undelivered(state: torch.Tensor, owner: torch.Tensor, makespan: int,
                horizon: int) -> int:
    """Tasks of a finished solve that the agent which took them (``owner``,
    (T,) agent per task, -1 none) did not carry and then leave idle: its
    recorded states run PICKING, then CARRYING or DELIVERED (one row at
    least), then IDLE, in that order; and one more where the last row is
    not all IDLE or the solve ran past the horizon.

    ``reference/plans.py`` asks for exactly one DELIVERED row, which a
    stale step need not record: a committed exchange can land an agent's
    goal on its own cell at the start of a step, and the task machine then
    turns it idle before any row records the arrival (step 1 before step
    2); or hand an agent that has just arrived another goal, which it
    reaches later, DELIVERED a second time."""
    cols = state[:, owner.clamp(min=0)].long()
    rank = _RANK.to(cols.device)[cols]
    in_order = (rank[1:] >= rank[:-1]).all(0)
    carried = (rank == 1).any(0)
    missing = int((~(in_order & carried & (owner >= 0))).sum())
    open_end = bool((state[-1] != 0).any()) or makespan > horizon
    return missing + int(open_end)


def out_of_order(state: torch.Tensor, owner: torch.Tensor) -> int:
    """Tasks of a solve cut before its end that no agent took, or whose
    agent's recorded states so far break :func:`undelivered`'s order:
    PICKING, then CARRYING or DELIVERED, then IDLE."""
    cols = state[:, owner.clamp(min=0)].long()
    rank = _RANK.to(cols.device)[cols]
    in_order = (rank[1:] >= rank[:-1]).all(0)
    return int((~(in_order & (owner >= 0))).sum())


# What one step leaves, by the program's and the reference's names.
COMPARED = ("pos", "goal", "pend_from", "pend_push", "phase", "vpos",
            "vgoal", "vstamp")


def mismatches(want: dict, got: dict) -> int:
    """Agents whose position, goal, pending source, push target, phase or
    view entry in ``got`` (tensors) differs from the reference's
    ``want``."""
    cols = [got[k].tolist() for k in COMPARED]
    return sum(any(c[i] != want[k][i] for c, k in zip(cols, COMPARED))
               for i in range(len(want["pos"])))
