"""Batched parallel TSWAP step.

Counterpart of the JAX package's ``solver/step.py``: the fresh-atomic step
(:func:`step_parallel`) and the stale-view decentralized step
(:func:`step_stale`).  All agents act at once on dense (N,) tensors;
conflicts resolve with deterministic lowest-agent-id priority.
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
``scatter_reduce_(..., "amin", include_self=True)``.  The movement fixpoints
decide on the host (``hostsync.flag``) where the JAX package looped on the
device; the fixed-length ``lax.scan`` walks are Python loops with no host
sync.
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

    if cfg.visibility_radius is None:
        # global view: everyone is an initiator
        f_ext = torch.cat([f, f.new_full((1,), n)])
        y = f
        on_cycle = torch.zeros(n, dtype=torch.bool, device=dev)
        for _ in range(cfg.cycle_cap):
            y = f_ext[y]
            on_cycle = on_cycle | (y == idx)
    else:
        on_cycle = _initiated_cycles(
            cfg, f, lambda y: _within_radius(cfg, pos, idx, y.clamp(0, n - 1)))
    # each cycle member hands its goal to its successor: perm q[f[x]] = x
    q = _arange(n + 1, dev)
    q[torch.where(on_cycle, f, n)] = torch.where(on_cycle, idx, n)
    q = q[:n]
    return goal[q], slot[q], pushed


def _initiated_cycles(cfg: SolverConfig, f, sees):
    """Agents on a blocking cycle (successor ``f``, ``n`` absorbing) of at
    most ``cycle_cap`` members that rotates: some member's own walk round
    the cycle ``sees(y)`` every member ``y`` it passes (that member is the
    initiator).  One walk computes plain membership and the initiator flag;
    a second ORs the flag round each cycle, so members rotate
    all-or-nothing."""
    n = cfg.num_agents
    idx = _arange(n, f.device)
    f_ext = torch.cat([f, f.new_full((1,), n)])
    y = f
    on_cycle_plain = torch.zeros(n, dtype=torch.bool, device=f.device)
    init_ok = torch.zeros(n, dtype=torch.bool, device=f.device)
    within = torch.ones(n, dtype=torch.bool, device=f.device)
    for _ in range(cfg.cycle_cap):
        y = f_ext[y]
        within = within & sees(y)
        hit = y == idx
        on_cycle_plain = on_cycle_plain | hit
        init_ok = init_ok | (hit & within)
    init_ext = torch.cat([init_ok, init_ok.new_zeros(1)])
    y, any_ok = f, init_ok
    for _ in range(cfg.cycle_cap):
        y = f_ext[y]
        any_ok = any_ok | init_ext[y]
    return on_cycle_plain & any_ok


def _cascade(cfg: SolverConfig, u, b, decided, newpos):
    """Movement fixpoint: each round, every undecided agent whose target
    ``u`` is open -- no decided agent ends there, and its original occupant
    ``b`` (-1 none) has decided to move away -- claims it, the lowest id
    winning.  Rounds repeat until nobody moves (one host sync each)."""
    n = cfg.num_agents
    idx = _arange(n, u.device)
    bc = b.clamp(0, n - 1)
    changed, r = True, 0
    while changed and r < cfg.max_move_rounds:
        # final occupancy of decided agents only (padded scratch cell)
        occf = torch.full((cfg.num_cells + 1,), -1, dtype=_I32,
                          device=u.device)
        occf[torch.where(decided, newpos, cfg.num_cells)] = idx
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
    return _cascade(cfg, u, b, decided, newpos)


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


def _within_radius_pts(cfg: SolverConfig, a, b):
    """Manhattan-visibility between explicit cell arrays: the stale-mode
    variant of :func:`_within_radius`, where the observed side comes from
    the broadcast view, not the true positions."""
    if cfg.visibility_radius is None:
        return torch.ones_like(a, dtype=torch.bool)
    w = cfg.width
    mh = (a % w - b % w).abs() + (a // w - b // w).abs()
    return mh <= cfg.visibility_radius


def _view_occupancy(cfg: SolverConfig, vpos, visible):
    """(HW+1,) int32 agent id believed to occupy each cell, -1 if believed
    empty.  Stale positions can coincide; the lowest id wins."""
    n = cfg.num_agents
    occ = _scatter_min(cfg.num_cells + 1, n,
                       torch.where(visible, vpos, cfg.num_cells),
                       _arange(n, vpos.device))
    return torch.where(occ == n, -1, occ)


def step_stale(cfg: SolverConfig, pos, goal, slot, nh_fn, vpos, vgoal,
               visible):
    """One decentralized TSWAP timestep under stale views: each agent
    decides from its own fresh state and the last-broadcast ``(vpos,
    vgoal)`` view of the others, and goal exchanges are returned as a
    pending permutation (+ push targets) for the caller to commit
    ``swap_commit_delay`` steps later.  Decisions read the view; movement
    stays physical (a move is granted only into a cell really free or
    vacated).  The JAX package's ``step_stale`` docstring sets out the
    semantics and the divergences from the reference; this port keeps them
    bit for bit.

    Returns ``(newpos, pend_from, pend_push)``: ``pend_from`` the
    goal-source permutation (identity where no exchange), ``pend_push`` the
    pushed-goal cell per agent (-1 none).
    """
    n = cfg.num_agents
    dev = pos.device
    idx = _arange(n, dev)
    occ = _occupancy(cfg, pos)                  # physical truth
    vocc = _view_occupancy(cfg, vpos, visible)

    # own desired next hop: fresh self-knowledge (pos, goal, own field row)
    u = _hops(cfg, nh_fn, slot, pos, goal)
    has_move = u != pos
    bv = torch.where(has_move, vocc[u], -1)
    bv = torch.where(bv == idx, -1, bv)         # own stale ghost != blocker
    bvc = bv.clamp(0, n - 1)
    # an out-of-radius occupant was evicted from the cache: believed free
    bv = torch.where((bv >= 0) & _within_radius_pts(cfg, pos, vpos[bvc]),
                     bv, -1)
    bvc = bv.clamp(0, n - 1)
    blocked = bv >= 0

    # ---- Rule 3 on the view: blocker parked (in view) on its view goal ----
    parked_v = vpos == vgoal
    cand3 = blocked & parked_v[bvc]
    same_goal = vgoal[bvc] == goal              # push case (shared delivery)
    # each agent joins at most one pair: grant each blocker its lowest
    # claimant, then resolve claimant-vs-blocker role conflicts by lowest id
    grant = _scatter_min(n + 1, n, torch.where(cand3, bvc, n), idx)
    win = cand3 & (grant[bvc] == idx)
    tgt = grant[:n]                             # claimant granted agent j
    keep = win & ((tgt == n) | (idx < tgt))
    keep = keep & ~(win[bvc] & (bvc < idx))
    push = keep & same_goal
    sw = keep & ~same_goal

    pend_from = _arange(n + 1, dev)
    pend_from[torch.where(sw, idx, n)] = torch.where(sw, bvc, n)
    pend_from[torch.where(sw, bvc, n)] = torch.where(sw, idx, n)
    pend_push = torch.full((n + 1,), -1, dtype=_I32, device=dev)
    pend_push[torch.where(push, bvc, n)] = torch.where(push, pos, -1)
    pend_push = pend_push[:n]

    # ---- Rule 4 on the view graph: f(j) = the agent j believes occupies
    # j's desired next cell; pair participants and goal-mutual pairs are
    # left out of it ----
    in_pair = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    in_pair[torch.where(keep, idx, n)] = True
    in_pair[torch.where(keep, bvc, n)] = True
    in_pair = in_pair[:n]
    # goal-mutual pairs (each holds the other's cell as goal: what a
    # committed push leaves) swap physically in the cascade and must not
    # also read as a Rule-4 2-cycle
    occ_u = torch.where(has_move, occ[u], -1)
    ouc = occ_u.clamp(0, n - 1)
    mutual = (has_move & (occ_u >= 0) & (occ_u != idx)
              & (goal == u) & (goal[ouc] == pos) & (u[ouc] == pos))
    fmask = blocked & ~in_pair & ~in_pair[bvc] & ~mutual & ~mutual[bvc]
    f = torch.where(fmask, bv, n)
    # the initiator sees each member where the view places it
    on_cycle = _initiated_cycles(
        cfg, f, lambda y: _within_radius_pts(
            cfg, pos, vpos[y.clamp(0, n - 1)]) & (y < n))
    # members hand goals backward along the ring, pending like swaps
    pend_from[torch.where(on_cycle, f, n)] = torch.where(on_cycle, idx, n)
    pend_from = pend_from[:n]

    # ---- movement: only believed-free moves are attempted ----
    movers = has_move & ~blocked
    newpos = _movement_cascade(cfg, pos, u, movers, occ, mutual)
    return newpos, pend_from, pend_push


def _movement_cascade(cfg: SolverConfig, pos, u, want, occ, mutual):
    """Physical movement arbitration for stale mode: :func:`_movement_phase`
    with an explicit mover mask and no mutual swaps, except the terminal
    mutual swap of a goal-mutual pair (``mutual``, computed by
    :func:`step_stale`)."""
    b = torch.where(want & ~mutual, occ[u], -1)  # true occupant of target
    return _cascade(cfg, u, b, mutual | ~want, torch.where(mutual, u, pos))
