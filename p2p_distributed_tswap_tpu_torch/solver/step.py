"""Batched parallel TSWAP step.

Counterpart of the JAX package's ``solver/step.py`` (fresh-atomic step only;
the stale-view step is a later slice).  All agents act at once on dense (N,)
tensors; conflicts resolve with deterministic lowest-agent-id priority.
Each agent's next hop is one gather from its goal's packed direction field,
and goal exchanges never recompute fields: they permute the ``slot``
indirection that maps agents to field rows.

One call = one timestep for all N agents:

1. Goal-swapping phase, ``swap_rounds`` rounds of Rule 3 (swap goals with a
   blocker parked on its own goal; the push extension when that goal is the
   mover's own) and Rule 4 (rotate goals around blocking cycles up to
   ``cycle_cap`` long).
2. Movement phase: mutual position swaps, then a cascade into free or
   vacated cells until nothing moves, lowest id winning contested cells.

The module docstring of the JAX package's ``solver/step.py`` sets out the
rules and the documented divergences from the sequential reference; this
port keeps them bit for bit.

Scatter idioms, as in the JAX package: every ``.at[].set`` writes through a
padded scratch slot at index ``n`` (or ``num_cells``), so the only duplicate
indices land in the discarded slot (or carry one and the same value), which
keeps ``index_put_`` deterministic on CUDA.  ``.at[].min`` is
``scatter_reduce_(..., "amin", include_self=True)``.  The movement fixpoint
decides on the host (``hostsync.flag``) where the JAX package looped on the
device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    apply_direction,
    gather_packed,
)

_I32 = torch.int32


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _scatter_min(size: int, fill: int, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``jnp.full(size, fill).at[index].min(src)`` for int32."""
    out = torch.full((size,), fill, dtype=_I32, device=src.device)
    return out.scatter_reduce_(0, index.long(), src, "amin",
                               include_self=True)


def next_hops(cfg: SolverConfig, dirs: torch.Tensor, slot: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Desired next cell per agent: one nibble gather from that agent's
    packed direction field (row ``slot[i]``).  Equals ``pos`` for stay."""
    code = gather_packed(dirs, slot, pos)
    return apply_direction(pos, code, cfg.width)


def _occupancy(cfg: SolverConfig, pos: torch.Tensor) -> torch.Tensor:
    """(HW+1,) int32: agent id at each cell, -1 if empty."""
    occ = torch.full((cfg.num_cells + 1,), -1, dtype=_I32, device=pos.device)
    occ[pos] = _arange(cfg.num_agents, pos.device)
    return occ


def _blockers(occ, pos, u):
    """Agent occupying each agent's desired next cell (-1 free / no move)."""
    has_move = u != pos
    return torch.where(has_move, occ[u], -1), has_move


def _within_radius(cfg: SolverConfig, pos, i_idx, j_idx):
    """Manhattan-visibility mask for agent pairs (decentralized mode, ref
    TSWAP_RADIUS=15).  Centralized mode (visibility_radius=None) sees
    everyone."""
    if cfg.visibility_radius is None:
        return torch.ones_like(i_idx, dtype=torch.bool)
    w = cfg.width
    a, b = pos[i_idx], pos[j_idx]
    mh = (a % w - b % w).abs() + (a // w - b // w).abs()
    return mh <= cfg.visibility_radius


def _apply_pair_swaps(goal, slot, sel, partner, n):
    """Permute (goal, slot) by the disjoint transpositions {i <-> partner[i]}
    for selected i, through the padded scratch slot ``n``."""
    idx = _arange(n, goal.device)
    p = _arange(n + 1, goal.device)
    p[torch.where(sel, idx, n)] = torch.where(sel, partner, n)
    p[torch.where(sel, partner, n)] = torch.where(sel, idx, n)
    p = p[:n]
    return goal[p], slot[p]


def _hops(cfg: SolverConfig, nh_fn, slot, pos, goal):
    """Next hops with Rule 1 (at-goal agents never move) and the
    goal-adjacency shortcut explicit."""
    u = nh_fn(slot, pos)
    w = cfg.width
    mh = (pos % w - goal % w).abs() + (pos // w - goal // w).abs()
    u = torch.where(mh == 1, goal, u)
    return torch.where(pos == goal, pos, u)


def _swap_phase_round(cfg: SolverConfig, pos, goal, slot, pushed, nh_fn, occ):
    n = cfg.num_agents
    dev = pos.device
    idx = _arange(n, dev)

    # ---- Rule 3: swap goals with a blocker parked on its own goal ----
    at_goal = pos == goal
    u = _hops(cfg, nh_fn, slot, pos, goal)
    b, has_move = _blockers(occ, pos, u)
    bc = b.clamp(0, n - 1)
    cand = (has_move & (b >= 0) & at_goal[bc]
            & _within_radius(cfg, pos, idx, bc))
    # lowest claimant id per blocker wins
    winner = _scatter_min(n + 1, n, torch.where(cand, b, n), idx)
    sel = cand & (winner[bc] == idx)
    # blocker parked on the mover's own goal: push it toward the mover's
    # cell instead (see the JAX package's step.py), and keep pushed agents
    # out of the cycle graph for the rest of the step.
    same_goal = goal[bc] == goal
    sel3 = sel & ~same_goal
    push = sel & same_goal
    goal, slot = _apply_pair_swaps(goal, slot, sel3, bc, n)
    ge = torch.cat([goal, goal.new_zeros(1)])
    ge[torch.where(push, bc, n)] = torch.where(push, pos, 0)
    goal = ge[:n]
    pe = torch.cat([pushed, pushed.new_zeros(1)])
    pe[torch.where(push, bc, n)] = True
    pushed = pe[:n]

    # ---- Rule 4: rotate goals around blocking cycles ----
    at_goal = pos == goal
    u = _hops(cfg, nh_fn, slot, pos, goal)
    b, has_move = _blockers(occ, pos, u)
    # blocking-graph successor; n = absorbing sentinel.  Freshly-pushed
    # agents absorb: no cycle may pass through them this step.
    f = torch.where(has_move & (b >= 0) & ~pushed, b, n)
    f_ext = torch.cat([f, f.new_full((1,), n)])

    if cfg.visibility_radius is None:
        # global view: everyone is an initiator
        y = f
        on_cycle = torch.zeros(n, dtype=torch.bool, device=dev)
        for _ in range(cfg.cycle_cap):
            y = f_ext[y]
            on_cycle = on_cycle | (y == idx)
    else:
        # One walk computes plain cycle membership and the radius-checked
        # initiator flag; a second ORs the initiator flag around each cycle
        # so members rotate all-or-nothing.
        y = f
        on_cycle_plain = torch.zeros(n, dtype=torch.bool, device=dev)
        init_ok = torch.zeros(n, dtype=torch.bool, device=dev)
        within = torch.ones(n, dtype=torch.bool, device=dev)
        for _ in range(cfg.cycle_cap):
            y = f_ext[y]
            within = within & _within_radius(cfg, pos, idx, y.clamp(0, n - 1))
            hit = y == idx
            on_cycle_plain = on_cycle_plain | hit
            init_ok = init_ok | (hit & within)
        init_ext = torch.cat([init_ok, init_ok.new_zeros(1)])
        y, any_ok = f, init_ok
        for _ in range(cfg.cycle_cap):
            y = f_ext[y]
            any_ok = any_ok | init_ext[y]
        on_cycle = on_cycle_plain & any_ok
    # each cycle member hands its goal to its successor: perm q[f[x]] = x
    q = _arange(n + 1, dev)
    q[torch.where(on_cycle, f, n)] = torch.where(on_cycle, idx, n)
    q = q[:n]
    return goal[q], slot[q], pushed


def _movement_phase(cfg: SolverConfig, pos, goal, slot, nh_fn, occ):
    n = cfg.num_agents
    idx = _arange(n, pos.device)
    u = _hops(cfg, nh_fn, slot, pos, goal)
    b, has_move = _blockers(occ, pos, u)
    bc = b.clamp(0, n - 1)

    # mutual position swap: i and blocker want each other's cells
    mutual = has_move & (b >= 0) & (u[bc] == pos) & (b != idx)
    newpos = torch.where(mutual, u, pos)
    decided = ~has_move | mutual

    changed, r = True, 0
    while changed and r < cfg.max_move_rounds:
        # final occupancy of decided agents only (padded scratch cell)
        occf = torch.full((cfg.num_cells + 1,), -1, dtype=_I32,
                          device=pos.device)
        occf[torch.where(decided, newpos, cfg.num_cells)] = idx
        # target available: nobody finalized there, and its original
        # occupant (if any) has finalized a move away
        orig_gone = (b < 0) | (decided[bc] & (newpos[bc] != u))
        open_cell = (occf[u] == -1) & orig_gone
        claimant = ~decided & open_cell
        win = _scatter_min(cfg.num_cells + 1, n,
                           torch.where(claimant, u, cfg.num_cells), idx)
        mover = claimant & (win[u] == idx)
        decided = decided | mover
        newpos = torch.where(mover, u, newpos)
        changed = hostsync.flag(torch.any(mover))
        r += 1
    return newpos


def step_parallel(cfg: SolverConfig, pos: torch.Tensor, goal: torch.Tensor,
                  slot: torch.Tensor, dirs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TSWAP timestep for all agents.

    Args:
      cfg: solver config.
      pos:  (N,) int32 flat cell per agent (vertex-disjoint).
      goal: (N,) int32 flat goal cell per agent.
      slot: (N,) int32 agent -> direction-field row (a permutation).
      dirs: (N, ceil(H*W/8)) int32 nibble-packed direction fields
        (ops.distance.pack_directions); row ``slot[i]`` is agent i's field.

    Returns:
      (pos, goal, slot) after the step; ``dirs`` is never modified.
    """
    return step_with_next_hops(
        cfg, pos, goal, slot, lambda sl, po: next_hops(cfg, dirs, sl, po))


def step_with_next_hops(cfg: SolverConfig, pos, goal, slot, nh_fn):
    """Step core parameterized by the next-hop lookup ``nh_fn(slot, pos)``.
    Every agent lane is active: the JAX package's ``active`` lane mask
    serves only its multi-tenant and mesh layers, which are not ported."""
    occ = _occupancy(cfg, pos)
    pushed = torch.zeros(cfg.num_agents, dtype=torch.bool, device=pos.device)
    for _ in range(cfg.swap_rounds):
        goal, slot, pushed = _swap_phase_round(cfg, pos, goal, slot, pushed,
                                               nh_fn, occ)
    pos = _movement_phase(cfg, pos, goal, slot, nh_fn, occ)
    return pos, goal, slot
