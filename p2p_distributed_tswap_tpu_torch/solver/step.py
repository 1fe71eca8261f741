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

Tenant fold (``tenants=T`` of :func:`step_parallel`): the multi-tenant
daemon steps T fleets of L lanes each, T x L in all, as one lane axis of
``T * L`` agents, where the JAX package vmaps the step over the tenant axis
with the shared direction-field cache broadcast.  (``torch.vmap`` cannot
run this step: the cascade decides its loop on the host.)  Lane ``(t, l)``
is agent ``t * L + l``; the occupancy grows a tenant axis, one plane of
``H * W`` cells and its own scratch cell per tenant (see :class:`_Cells`),
so two tenants' agents on the same cell of their separate worlds never
meet.  Positions, goals and next hops stay plain cells.  The fold is exact:

- an agent's blocker is read from its own tenant's plane, so every id that
  one lane compares with or walks to lies in its own tenant, and the ids
  of one tenant keep their order (``t * L`` is added to each), so lowest-id
  priority within a tenant is unchanged: the Rule-3 winners (a scatter-min
  over blocker ids) and the cascade's winners (a scatter-min in the
  tenant's own plane) are the vmapped step's;
- the Rule-4 cycle walks have a fixed length;
- under ``vmap`` the JAX cascade's ``while_loop`` runs until no tenant
  changes, each tenant's carry frozen once its own round moved nothing or
  its round count reached ``max_move_rounds``.  The folded loop runs until
  no lane of any tenant moves, at most ``max_move_rounds`` rounds: a round
  of a tenant that has settled reads the same state and moves nothing, so
  the extra rounds change nothing, and a tenant still moving at the cap is
  cut at the same round as under ``vmap``.

One cascade sync per round serves the whole slab.

Tracing: :func:`step_with_next_hops` and :func:`step_stale` record two
spans, ``step.swap`` (the occupancy and the goal-swap rounds) and
``step.cascade`` (the movement phase), and ``cascade_rounds`` counts the
movement rounds (a host sync each).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.obs import trace
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    apply_direction,
    gather_packed,
)

_I32 = torch.int32

# Movement rounds of :func:`_cascade` since the last reset (callers reset it
# to 0): each round is one host sync.
cascade_rounds = 0


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


class _Cells:
    """Addressing of the occupancy planes: ``rows`` planes of ``num_cells``
    cells and one scratch cell each (``size`` entries), lane ``i`` in plane
    ``i // (num_agents / rows)``.  With one plane (a single fleet) a cell
    is its own index and no index op runs; with more, flat indices are
    int64, so ``rows * (H*W + 1)`` never overflows int32 indexing."""

    def __init__(self, cfg: SolverConfig, rows: int, device):
        if rows < 1 or cfg.num_agents % rows:
            raise ValueError(f"{cfg.num_agents} lanes do not fold into "
                             f"{rows} tenant rows")
        plane = cfg.num_cells + 1
        self.size = rows * plane
        self.base = None
        if rows > 1:
            lanes = cfg.num_agents // rows
            self.base = (torch.arange(cfg.num_agents, device=device)
                         // lanes * plane)

    def of(self, cells: torch.Tensor) -> torch.Tensor:
        """Index of each lane's cell ``cells[i]`` in the lane's own plane
        (``num_cells`` is the plane's scratch cell)."""
        return cells if self.base is None else self.base + cells


def _occupancy(cfg: SolverConfig, pos: torch.Tensor, active: torch.Tensor,
               cells: _Cells) -> torch.Tensor:
    """(rows * (HW+1),) int32: agent id at each cell of each plane, -1 if
    empty.  Inactive agents write their plane's scratch cell and never
    occupy the grid."""
    occ = torch.full((cells.size,), -1, dtype=_I32, device=pos.device)
    occ[cells.of(torch.where(active, pos, cfg.num_cells))] = _arange(
        cfg.num_agents, pos.device)
    return occ


def _blockers(occ, pos, u, cells: _Cells):
    """Agent occupying each agent's desired next cell (-1 free / no move)."""
    has_move = u != pos
    return torch.where(has_move, occ[cells.of(u)], -1), has_move


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


def _hops(cfg: SolverConfig, nh_fn, slot, pos, goal, active):
    """Next hops with Rule 1 (at-goal agents never move) and the
    goal-adjacency shortcut explicit; an inactive lane's hop is its own
    cell."""
    u = torch.where(active, nh_fn(slot, pos), pos)
    w = cfg.width
    mh = (pos % w - goal % w).abs() + (pos // w - goal // w).abs()
    u = torch.where(active & (mh == 1), goal, u)
    return torch.where(pos == goal, pos, u)


def _swap_phase_round(cfg: SolverConfig, pos, goal, slot, pushed, nh_fn, occ,
                      active, cells: _Cells):
    n = cfg.num_agents
    dev = pos.device
    idx = _arange(n, dev)

    # ---- Rule 3: swap goals with a blocker parked on its own goal ----
    at_goal = pos == goal
    u = _hops(cfg, nh_fn, slot, pos, goal, active)
    b, has_move = _blockers(occ, pos, u, cells)
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
    u = _hops(cfg, nh_fn, slot, pos, goal, active)
    b, has_move = _blockers(occ, pos, u, cells)
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


def _cascade(cfg: SolverConfig, u, b, decided, newpos, active,
             cells: _Cells):
    """Movement fixpoint: each round, every undecided agent whose target
    ``u`` is open -- no decided active agent ends there, and its original
    occupant ``b`` (-1 none) has decided to move away -- claims it, the
    lowest id winning.  Rounds repeat until nobody moves (one host sync
    each, counted in ``cascade_rounds``), in every plane of ``cells`` at
    once."""
    global cascade_rounds
    n = cfg.num_agents
    idx = _arange(n, u.device)
    bc = b.clamp(0, n - 1)
    cu = cells.of(u)
    changed, r = True, 0
    while changed and r < cfg.max_move_rounds:
        # final occupancy of decided agents only (padded scratch cell)
        occf = torch.full((cells.size,), -1, dtype=_I32, device=u.device)
        occf[cells.of(torch.where(decided & active, newpos,
                                  cfg.num_cells))] = idx
        orig_gone = (b < 0) | (decided[bc] & (newpos[bc] != u))
        open_cell = (occf[cu] == -1) & orig_gone
        claimant = ~decided & open_cell
        win = _scatter_min(cells.size, n,
                           cells.of(torch.where(claimant, u, cfg.num_cells)),
                           idx)
        mover = claimant & (win[cu] == idx)
        decided = decided | mover
        newpos = torch.where(mover, u, newpos)
        changed = hostsync.flag(torch.any(mover))
        r += 1
        cascade_rounds += 1
    return newpos


def _movement_phase(cfg: SolverConfig, pos, goal, slot, nh_fn, occ, active,
                    cells: _Cells):
    n = cfg.num_agents
    idx = _arange(n, pos.device)
    u = _hops(cfg, nh_fn, slot, pos, goal, active)
    b, has_move = _blockers(occ, pos, u, cells)
    bc = b.clamp(0, n - 1)

    # mutual position swap: i and blocker want each other's cells
    mutual = has_move & (b >= 0) & (u[bc] == pos) & (b != idx)
    newpos = torch.where(mutual, u, pos)
    decided = ~has_move | mutual
    return _cascade(cfg, u, b, decided, newpos, active, cells)


def step_parallel(cfg: SolverConfig, pos: torch.Tensor, goal: torch.Tensor,
                  slot: torch.Tensor, dirs: torch.Tensor,
                  active: Optional[torch.Tensor] = None,
                  tenants: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TSWAP timestep for all agents.

    Args:
      cfg: solver config.
      pos:  (N,) int32 flat cell per agent (vertex-disjoint).
      goal: (N,) int32 flat goal cell per agent.
      slot: (N,) int32 agent -> direction-field row (a permutation).
      dirs: (N, ceil(H*W/8)) int32 nibble-packed direction fields
        (ops.distance.pack_directions); row ``slot[i]`` is agent i's field.
      active: (N,) bool lane mask, ``None`` for all lanes (see
        :func:`step_with_next_hops`).
      tenants: T, the number of fleets folded into the N lanes (N / T
        lanes each, fleet t in lanes ``t * N/T ..``; see the module
        docstring).  1, the default, is one fleet on one occupancy plane.

    Returns:
      (pos, goal, slot) after the step, new tensors (no output is one of
      the inputs); ``dirs`` is never modified.
    """
    return step_with_next_hops(
        cfg, pos, goal, slot, lambda sl, po: next_hops(cfg, dirs, sl, po),
        active, tenants)


def all_lanes(cfg: SolverConfig, device) -> torch.Tensor:
    """The ``active`` mask of a step in which every lane is an agent."""
    return torch.ones(cfg.num_agents, dtype=torch.bool, device=device)


def step_with_next_hops(cfg: SolverConfig, pos, goal, slot, nh_fn,
                        active=None, tenants: int = 1):
    """Step core parameterized by the next-hop lookup ``nh_fn(slot, pos)``.

    ``active`` masks padded or parked lanes out entirely (``None`` = all
    lanes): an inactive lane never occupies a cell (it writes the scratch
    cell of the occupancy, so a padded lane at cell 0 leaves cell 0 to the
    agent standing there), never moves and never enters the Rule-3/4 graph
    or the cascade.  Nothing selects an inactive lane, so its goal and
    slot come back unchanged.  ``tenants`` folds that many fleets into the
    lanes (see :func:`step_parallel`)."""
    cells = _Cells(cfg, tenants, pos.device)
    if active is None:
        active = all_lanes(cfg, pos.device)
    with trace.span("step.swap"):
        occ = _occupancy(cfg, pos, active, cells)
        pushed = torch.zeros(cfg.num_agents, dtype=torch.bool,
                             device=pos.device)
        goal, slot = goal.clone(), slot.clone()
        for _ in range(cfg.swap_rounds):
            goal, slot, pushed = _swap_phase_round(
                cfg, pos, goal, slot, pushed, nh_fn, occ, active, cells)
    with trace.span("step.cascade"):
        pos = _movement_phase(cfg, pos, goal, slot, nh_fn, occ, active,
                              cells)
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
               visible, active=None):
    """One decentralized TSWAP timestep under stale views: each agent
    decides from its own fresh state and the last-broadcast ``(vpos,
    vgoal)`` view of the others, and goal exchanges are returned as a
    pending permutation (+ push targets) for the caller to commit
    ``swap_commit_delay`` steps later.  Decisions read the view; movement
    stays physical (a move is granted only into a cell really free or
    vacated).  The JAX package's ``step_stale`` docstring sets out the
    semantics and the divergences from the reference; this port keeps them
    bit for bit.  ``active`` is the lane mask of :func:`step_with_next_hops`
    (``None`` = all lanes).

    Returns ``(newpos, pend_from, pend_push)``: ``pend_from`` the
    goal-source permutation (identity where no exchange), ``pend_push`` the
    pushed-goal cell per agent (-1 none).
    """
    n = cfg.num_agents
    dev = pos.device
    idx = _arange(n, dev)
    if active is None:
        active = all_lanes(cfg, dev)
    with trace.span("step.swap"):
        cells = _Cells(cfg, 1, dev)
        occ = _occupancy(cfg, pos, active, cells)   # physical truth
        vocc = _view_occupancy(cfg, vpos, visible & active)

        # own desired next hop: fresh self-knowledge (pos, goal, own field row)
        u = _hops(cfg, nh_fn, slot, pos, goal, active)
        has_move = active & (u != pos)
        bv = torch.where(has_move, vocc[u], -1)
        bv = torch.where(bv == idx, -1, bv)     # own stale ghost != blocker
        bvc = bv.clamp(0, n - 1)
        # an out-of-radius occupant was evicted from the cache: believed free
        bv = torch.where((bv >= 0) & _within_radius_pts(cfg, pos, vpos[bvc]),
                         bv, -1)
        bvc = bv.clamp(0, n - 1)
        blocked = bv >= 0

        # ---- Rule 3 on the view: blocker parked (in view) on its view
        # goal ----
        parked_v = vpos == vgoal
        cand3 = blocked & parked_v[bvc]
        same_goal = vgoal[bvc] == goal      # push case (shared delivery)
        # each agent joins at most one pair: grant each blocker its lowest
        # claimant, then resolve claimant-vs-blocker role conflicts by
        # lowest id
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
    with trace.span("step.cascade"):
        newpos = _movement_cascade(cfg, pos, u, movers, occ, active, mutual,
                                   cells)
    return newpos, pend_from, pend_push


def _movement_cascade(cfg: SolverConfig, pos, u, want, occ, active, mutual,
                      cells: _Cells):
    """Physical movement arbitration for stale mode: :func:`_movement_phase`
    with an explicit mover mask and no mutual swaps, except the terminal
    mutual swap of a goal-mutual pair (``mutual``, computed by
    :func:`step_stale`)."""
    b = torch.where(want & ~mutual, occ[u], -1)  # true occupant of target
    return _cascade(cfg, u, b, mutual | ~want, torch.where(mutual, u, pos),
                    active, cells)
