"""Offline MAPD loop: the PyTorch counterpart of the JAX package's
``solver/mapd.py`` (itself the equivalent of the reference's ``tswap_mapd``,
src/algorithm/tswap.rs:39-172): greedy nearest-pickup task assignment, the
Idle -> ToPickup -> ToDelivery machine, TSWAP stepping, per-step path
recording, and the all-done-or-horizon termination rule.

The state is a plain dataclass of tensors on one device.  The entry points
(:func:`solve_offline`, :func:`run_mapd`, :func:`prepare_state`) run on
``device``, which defaults to ``cuda`` and is never swapped for the CPU
behind the caller's back: without CUDA they raise unless the caller passes
``device="cpu"``.  :func:`mapd_step` runs where its state lies.

Where the JAX package's solve is one device program (``lax.while_loop`` and
``lax.cond``), this loop is driven from the host: every data-dependent exit
is one counted host sync (``hostsync.flag``).

Replanning: goal changes from the task lifecycle (assignment, pickup ->
delivery) need fresh direction fields; goal swaps never do (slot
permutation).  The t=0 burst computes every field in ``replan_chunk``-wide
chunks (:func:`prime_fields`); each step then drains the dirty set in
``replan_chunk_small``-wide chunks (:func:`_replan`).  Both write the packed
rows of ``dirs`` IN PLACE (no second copy of the largest tensor of the
solve, 5.2 GB at the flagship rung), and :func:`_record` writes the path
buffers in place: a state handed to :func:`mapd_step` shares those buffers
with the state it returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.agent import AgentPhase, AgentState
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.device import resolve_device
from p2p_distributed_tswap_tpu_torch.obs import trace
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    PACKED_STAY,
    direction_fields,
    pack_directions,
    packed_cells,
)
from p2p_distributed_tswap_tpu_torch.solver.step import (
    next_hops,
    step_parallel,
    step_stale,
    step_with_next_hops,
)

_FAR = 1 << 20  # > any grid manhattan distance
_I32 = torch.int32
_IDLE = int(AgentPhase.IDLE)
_TO_PICKUP = int(AgentPhase.TO_PICKUP)
_TO_DELIVERY = int(AgentPhase.TO_DELIVERY)


@dataclasses.dataclass
class MapdState:
    pos: torch.Tensor          # (N,) int32 flat cell
    goal: torch.Tensor         # (N,) int32 flat cell
    slot: torch.Tensor         # (N,) int32 agent -> field row
    dirs: torch.Tensor         # (N, ceil(HW/8)) int32 packed direction fields
    phase: torch.Tensor        # (N,) int8 AgentPhase
    agent_task: torch.Tensor   # (N,) int32 task index or -1
    task_used: torch.Tensor    # (T,) bool
    need_replan: torch.Tensor  # (N,) bool: agent's goal changed, field stale
    t: torch.Tensor            # () int32 timestep counter
    paths_pos: torch.Tensor    # (Tmax+1, N) int32 recorded positions
    paths_state: torch.Tensor  # (Tmax+1, N) int8 recorded AgentState
    # --- stale/async decentralized view (cfg.stale_mode); carried in
    # every mode so states convert both ways with the JAX package ---
    vpos: torch.Tensor         # (N,) int32 last-broadcast position
    vgoal: torch.Tensor        # (N,) int32 last-broadcast goal
    vstamp: torch.Tensor       # (N,) int32 step of last broadcast
    pend_from: torch.Tensor    # (N,) int32 pending goal-source permutation
    pend_push: torch.Tensor    # (N,) int32 pending pushed-goal cell or -1

    def replace(self, **changes) -> "MapdState":
        return dataclasses.replace(self, **changes)


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def init_state(cfg: SolverConfig, starts: torch.Tensor,
               num_tasks: int, dirs=None) -> MapdState:
    """The state before the first step; ``dirs`` replaces the all-STAY
    packed rows (the sharded solvers pass theirs, laid out over a mesh)."""
    n, hw, tmax = cfg.num_agents, cfg.num_cells, cfg.max_timesteps
    dev = starts.device
    # path buffers shrink to one dummy row when recording is off
    tdim = tmax + 1 if cfg.record_paths else 1
    starts = starts.to(_I32)
    return MapdState(
        pos=starts.clone(),
        goal=starts.clone(),
        slot=torch.arange(n, dtype=_I32, device=dev),
        dirs=(torch.full((n, packed_cells(hw)), PACKED_STAY, dtype=_I32,
                         device=dev) if dirs is None else dirs),
        phase=torch.full((n,), _IDLE, dtype=torch.int8, device=dev),
        agent_task=torch.full((n,), -1, dtype=_I32, device=dev),
        task_used=torch.zeros(num_tasks, dtype=torch.bool, device=dev),
        # All rows start stale: Rule-3 swaps can hand an uncomputed row to
        # an agent away from its start, so every field is computed first.
        need_replan=torch.ones(n, dtype=torch.bool, device=dev),
        t=torch.zeros((), dtype=_I32, device=dev),
        paths_pos=torch.zeros((tdim, n), dtype=_I32, device=dev),
        paths_state=torch.zeros((tdim, n), dtype=torch.int8, device=dev),
        vpos=starts.clone(),
        vgoal=starts.clone(),
        vstamp=torch.zeros(n, dtype=_I32, device=dev),
        pend_from=torch.arange(n, dtype=_I32, device=dev),
        pend_push=torch.full((n,), -1, dtype=_I32, device=dev),
    )


def _transitions(cfg: SolverConfig, s: MapdState,
                 tasks: torch.Tensor) -> MapdState:
    """Arrival transitions (ref tswap.rs:106-121), vectorized."""
    arrived = s.pos == s.goal
    tp = arrived & (s.phase == _TO_PICKUP)
    td = arrived & (s.phase == _TO_DELIVERY)
    task = s.agent_task.clamp(min=0)
    goal = torch.where(tp, tasks[task, 1], s.goal)
    phase = torch.where(tp, _TO_DELIVERY,
                        torch.where(td, _IDLE, s.phase)).to(torch.int8)
    agent_task = torch.where(td, -1, s.agent_task)
    return s.replace(goal=goal, phase=phase, agent_task=agent_task,
                     need_replan=s.need_replan | tp)


def _nearest_unused(cfg: SolverConfig, pos: torch.Tensor,
                    task_used: torch.Tensor, tasks: torch.Tensor):
    """Per-agent (distance, index) of the nearest unused task pickup,
    Manhattan metric, lowest task index on ties.  Chunked over the task axis
    so the transient is (N, assign_chunk) int32."""
    n, w = cfg.num_agents, cfg.width
    dev = pos.device
    t = tasks.shape[0]
    c = min(cfg.assign_chunk, t)
    nchunks = -(-t // c)
    pad = nchunks * c - t
    zeros = torch.zeros(pad, dtype=_I32, device=dev)
    px = torch.cat([tasks[:, 0] % w, zeros])
    py = torch.cat([tasks[:, 0] // w, zeros])
    used = torch.cat([task_used,
                      torch.ones(pad, dtype=torch.bool, device=dev)])
    ax, ay = pos % w, pos // w
    best_d = torch.full((n,), _FAR, dtype=_I32, device=dev)
    best_k = torch.zeros(n, dtype=_I32, device=dev)
    for o in range(0, nchunks * c, c):
        d = ((px[None, o:o + c] - ax[:, None]).abs()
             + (py[None, o:o + c] - ay[:, None]).abs())
        d = torch.where(used[None, o:o + c], _FAR, d)
        k = torch.argmin(d, dim=1)  # first min in chunk
        dk = d.gather(1, k[:, None])[:, 0]
        better = dk < best_d  # strict: ties keep the earlier chunk's index
        best_d = torch.where(better, dk, best_d)
        best_k = torch.where(better, o + k.to(_I32), best_k)
    return best_d, best_k


def _assign(cfg: SolverConfig, s: MapdState,
            tasks: torch.Tensor) -> MapdState:
    """Greedy nearest-pickup assignment (ref tswap.rs:123-138), in parallel
    rounds: every idle agent proposes its nearest unused task, the lowest
    proposing id wins each task, losers re-propose next round, until no
    proposal succeeds (the JAX package's documented approximation of the
    sequential greedy)."""
    n = cfg.num_agents
    t = tasks.shape[0]
    dev = s.pos.device
    idx = torch.arange(n, dtype=_I32, device=dev)
    task_used, goal, phase = s.task_used, s.goal, s.phase
    agent_task, need = s.agent_task, s.need_replan
    while True:
        idle = phase == _IDLE
        bd, bk = _nearest_unused(cfg, s.pos, task_used, tasks)
        want = idle & (bd < _FAR)
        # lowest claimant id per task wins (scratch slot t)
        winner = torch.full((t + 1,), n, dtype=_I32, device=dev)
        winner.scatter_reduce_(0, torch.where(want, bk, t).long(), idx,
                               "amin", include_self=True)
        win = want & (winner[bk] == idx)
        claimed = torch.zeros(t + 1, dtype=torch.bool, device=dev)
        claimed[torch.where(win, bk, t)] = True
        task_used = task_used | claimed[:t]
        goal = torch.where(win, tasks[bk, 0], goal)
        phase = torch.where(win, _TO_PICKUP, phase).to(torch.int8)
        agent_task = torch.where(win, bk, agent_task)
        need = need | win
        if not hostsync.flag(torch.any(win)):
            break
    return s.replace(task_used=task_used, goal=goal, phase=phase,
                     agent_task=agent_task, need_replan=need)


def _replan(cfg: SolverConfig, s: MapdState,
            free: torch.Tensor) -> MapdState:
    """Recompute the packed rows of agents whose goal changed, in chunks of
    ``replan_chunk_small`` lowest flagged ids until the set drains."""
    n = cfg.num_agents
    r = min(cfg.replan_chunk_small, n)
    idx = torch.arange(n, dtype=_I32, device=s.pos.device)
    need = s.need_replan
    while hostsync.flag(torch.any(need)):
        priority = torch.where(need, idx, n)
        sel = torch.topk(priority, r, largest=False).values  # r lowest ids
        valid = sel < n
        selc = sel.clamp(0, n - 1)
        fields = direction_fields(free, s.goal[selc],
                                  max_rounds=cfg.max_sweep_rounds)
        # Invalid lanes clip to agent n-1, whose (goal, slot) pair is
        # consistent: their rows repeat agent n-1's row exactly.
        s.dirs[s.slot[selc]] = pack_directions(
            fields.reshape(r, cfg.num_cells))
        # scatter-max, not a set: clipped lanes carry False beside agent
        # n-1's own lane
        cleared = torch.zeros(n, dtype=_I32, device=need.device)
        cleared.scatter_reduce_(0, selc.long(), valid.to(_I32), "amax",
                                include_self=True)
        need = need & (cleared == 0)
    return s.replace(need_replan=need)


def _prime_chunks(cfg: SolverConfig, s: MapdState, free: torch.Tensor,
                  traced: bool) -> MapdState:
    """The t=0 burst's loop of ``replan_chunk``-wide chunks, each chunk in
    a ``mapd.prime_chunk`` span when ``traced``.  The tail chunk clips to
    agent n-1 and recomputes its row."""
    n, r = cfg.num_agents, min(cfg.replan_chunk, cfg.num_agents)
    lane = torch.arange(r, dtype=_I32, device=s.pos.device)
    for ci, o in enumerate(range(0, n, r)):
        with (trace.span("mapd.prime_chunk", chunk=ci) if traced
              else contextlib.nullcontext()):
            sel = (o + lane).clamp(0, n - 1)
            fields = direction_fields(free, s.goal[sel],
                                      max_rounds=cfg.max_sweep_rounds)
            s.dirs[s.slot[sel]] = pack_directions(
                fields.reshape(r, cfg.num_cells))
    return s.replace(need_replan=torch.zeros_like(s.need_replan))


def prime_fields(cfg: SolverConfig, s: MapdState,
                 free: torch.Tensor) -> MapdState:
    """Compute the direction field of EVERY agent's current goal in
    ``replan_chunk``-wide chunks: the t=0 burst, one host-driven loop of
    chunks."""
    return _prime_chunks(cfg, s, free, traced=False)


def host_prime_fields(cfg: SolverConfig, s: MapdState,
                      free: torch.Tensor) -> MapdState:
    """The t=0 field burst as a host-driven loop of per-chunk programs,
    under the JAX package's name and trace spans.

    The JAX package needs it beside its one fused ``prime_fields`` scan
    at the largest grids, where one program over every chunk is unstable
    on its accelerator; here ``prime_fields`` is already that loop, so
    both compute the same rows.  This one records a
    ``mapd.host_prime_fields`` span (``agents``, ``chunks``) around the
    burst and a ``mapd.prime_chunk`` span (``chunk``) around each chunk,
    so that a trace of either package reads the same."""
    n, r = cfg.num_agents, min(cfg.replan_chunk, cfg.num_agents)
    with trace.span("mapd.host_prime_fields", agents=n, chunks=-(-n // r)):
        return _prime_chunks(cfg, s, free, traced=True)


def _record(cfg: SolverConfig, s: MapdState) -> MapdState:
    """Path recording (ref tswap.rs:143-158), in place; only the timestep
    increment when ``cfg.record_paths`` is off."""
    if not cfg.record_paths:
        return s.replace(t=s.t + 1)
    state = torch.where(
        s.phase == _IDLE, int(AgentState.IDLE),
        torch.where(s.phase == _TO_PICKUP, int(AgentState.PICKING),
                    torch.where(s.pos == s.goal, int(AgentState.DELIVERED),
                                int(AgentState.CARRYING)))).to(torch.int8)
    # clamped like the JAX package's dynamic_update_index_in_dim
    row = s.t.clamp(0, s.paths_pos.shape[0] - 1).long().reshape(1)
    s.paths_pos.index_copy_(0, row, s.pos[None])
    s.paths_state.index_copy_(0, row, state[None])
    return s.replace(t=s.t + 1)


def _commit_pending(cfg: SolverConfig, s: MapdState) -> MapdState:
    """Apply the goal exchanges decided ``swap_commit_delay`` steps ago
    (:func:`~p2p_distributed_tswap_tpu_torch.solver.step.step_stale`):
    permute (goal, slot, need_replan) by ``pend_from`` -- exchanged rows stay
    consistent with exchanged goals -- then land pushed goals, whose rows
    are stale and flagged for replan.  An identity pend is a no-op."""
    p = s.pend_from
    goal, slot, need = s.goal[p], s.slot[p], s.need_replan[p]
    pushed = s.pend_push >= 0
    goal = torch.where(pushed, s.pend_push, goal)
    n, dev = cfg.num_agents, s.pos.device
    return s.replace(goal=goal, slot=slot, need_replan=need | pushed,
                     pend_from=torch.arange(n, dtype=_I32, device=dev),
                     pend_push=torch.full((n,), -1, dtype=_I32, device=dev))


def _broadcast_view(cfg: SolverConfig, s: MapdState) -> MapdState:
    """Refresh the shared view for agents whose broadcast is due this step:
    every ``view_refresh_steps`` steps on a per-agent phase offset (i mod
    K), the analog of the reference's per-process 500 ms position timers."""
    n, k = cfg.num_agents, cfg.view_refresh_steps
    phase = torch.arange(n, dtype=_I32, device=s.pos.device) % k
    due = (s.t + phase) % k == 0
    return s.replace(vpos=torch.where(due, s.pos, s.vpos),
                     vgoal=torch.where(due, s.goal, s.vgoal),
                     vstamp=torch.where(due, s.t, s.vstamp))


def mapd_step(cfg: SolverConfig, s: MapdState, tasks: torch.Tensor,
              free, replan_fn=None, nh_factory=None) -> MapdState:
    """One full MAPD timestep, on the state's device: (pending commit) ->
    transitions -> assignment -> replan -> TSWAP step -> record.

    ``replan_fn(cfg, s, free)`` and ``nh_factory(cfg, dirs) -> nh_fn`` let
    the sharded solvers (``parallel/sharded.py``, ``parallel/sharded2d.py``)
    swap in their distributed replan and next-hop lookup, in the fresh and
    the stale branch alike, while the MAPD sequencing lives here only;
    ``free`` is then whatever their ``replan_fn`` takes.

    Stale mode (``cfg.stale_mode``): last step's pending goal exchanges
    commit first, the view is refreshed after the replan, and
    :func:`~p2p_distributed_tswap_tpu_torch.solver.step.step_stale` replaces
    the fresh-atomic step; with ``swap_commit_delay == 0`` its exchanges
    commit at the end of the same step instead."""
    dev = s.pos.device
    tasks = _as_tensor(tasks, _I32, dev)
    if replan_fn is None:
        free = _as_tensor(free, torch.bool, dev)
    stale = cfg.stale_mode
    if stale:
        s = _commit_pending(cfg, s)
    s = _transitions(cfg, s, tasks)
    if hostsync.flag(torch.any((s.phase == _IDLE) & ~torch.all(s.task_used))):
        s = _assign(cfg, s, tasks)
    s = (replan_fn or _replan)(cfg, s, free)
    if not stale:
        if nh_factory is None:
            pos, goal, slot = step_parallel(cfg, s.pos, s.goal, s.slot,
                                            s.dirs)
        else:
            pos, goal, slot = step_with_next_hops(
                cfg, s.pos, s.goal, s.slot, nh_factory(cfg, s.dirs))
        return _record(cfg, s.replace(pos=pos, goal=goal, slot=slot))
    s = _broadcast_view(cfg, s)
    if cfg.view_ttl_steps is None:
        visible = torch.ones(cfg.num_agents, dtype=torch.bool, device=dev)
    else:
        visible = (s.t - s.vstamp) <= cfg.view_ttl_steps
    dirs = s.dirs
    if nh_factory is None:
        nh_fn = lambda sl, po: next_hops(cfg, dirs, sl, po)  # noqa: E731
    else:
        nh_fn = nh_factory(cfg, dirs)
    pos, pend_from, pend_push = step_stale(
        cfg, s.pos, s.goal, s.slot, nh_fn, s.vpos, s.vgoal, visible)
    s = s.replace(pos=pos, pend_from=pend_from, pend_push=pend_push)
    if cfg.swap_commit_delay == 0:
        s = _commit_pending(cfg, s)
    return _record(cfg, s)


def _finished(cfg: SolverConfig, s: MapdState) -> torch.Tensor:
    """Ref tswap.rs:162-168: all tasks used and all agents idle, or
    horizon.  A () bool tensor on the state's device."""
    done = torch.all(s.task_used) & torch.all(s.phase == _IDLE)
    return done | (s.t > cfg.max_timesteps)


def validate_starts(grid: Grid, starts_idx) -> None:
    """Host-side input validation shared by every solver front door."""
    starts_np = np.asarray(starts_idx)
    if len(np.unique(starts_np)) != len(starts_np):
        raise ValueError("duplicate start cells: agents must be vertex-disjoint")
    if not grid.free.reshape(-1)[starts_np].all():
        raise ValueError("start cell on an obstacle")


def validate_tasks(grid: Grid, tasks) -> None:
    """Reject pickups/deliveries on obstacles — such tasks would otherwise
    pin their agent on an all-INF field and burn the whole solve horizon."""
    tasks_np = np.asarray(tasks)
    if tasks_np.size and not grid.free.reshape(-1)[tasks_np.reshape(-1)].all():
        raise ValueError("task pickup/delivery cell on an obstacle")


def prepare_state_unprimed(cfg: SolverConfig, starts, tasks, device=None
                           ) -> Tuple[MapdState, torch.Tensor]:
    """:func:`prepare_state` minus the field burst: init + pre-loop
    transitions + first assignment."""
    dev = resolve_device(device)
    starts = _as_tensor(starts, _I32, dev)
    tasks = _as_tensor(tasks, _I32, dev)
    if tasks.shape[0] == 0:
        tasks = torch.zeros((1, 2), dtype=_I32, device=dev)
        s = init_state(cfg, starts, 1)
        s = s.replace(task_used=torch.ones(1, dtype=torch.bool, device=dev))
    else:
        s = init_state(cfg, starts, tasks.shape[0])
    s = _transitions(cfg, s, tasks)
    s = _assign(cfg, s, tasks)
    return s, tasks


def prepare_state(cfg: SolverConfig, starts, tasks, free, device=None
                  ) -> Tuple[MapdState, torch.Tensor]:
    """Initial state ready for stepping on ``device`` (default ``cuda``):
    init, first task assignment, and the field burst (:func:`prime_fields`).
    Returns ``(state, tasks)`` with the zero-task case substituted by one
    pre-used dummy task.  (The JAX package documents the one-step-early
    pickup flip of an agent whose start is its pickup; the same holds.)"""
    dev = resolve_device(device)
    s, tasks = prepare_state_unprimed(cfg, starts, tasks, dev)
    return prime_fields(cfg, s, _as_tensor(free, torch.bool, dev)), tasks


def run_mapd(cfg: SolverConfig, starts, tasks, free,
             device=None) -> MapdState:
    """End-to-end MAPD solve on ``device`` (default ``cuda``).  Returns the
    final state; makespan is ``state.t`` and paths are in
    ``paths_pos/paths_state[: state.t]``."""
    dev = resolve_device(device)
    free = _as_tensor(free, torch.bool, dev)
    s, tasks = prepare_state(cfg, starts, tasks, free, dev)
    while not hostsync.flag(_finished(cfg, s)):
        s = mapd_step(cfg, s, tasks, free)
    return s


def solve_offline(grid: Grid, starts_idx: np.ndarray, tasks: np.ndarray,
                  cfg: SolverConfig | None = None, device=None
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-facing offline solver (capability of ref tswap_mapd), run on
    ``device`` (default ``cuda``).

    Args:
      grid: the world.
      starts_idx: (N,) flat start cells (distinct).
      tasks: (T, 2) int32 [pickup_idx, delivery_idx].

    Returns:
      (paths_pos (makespan, N), paths_state (makespan, N), makespan).
    """
    dev = resolve_device(device)
    if cfg is None:
        cfg = SolverConfig(height=grid.height, width=grid.width,
                           num_agents=len(starts_idx))
    validate_starts(grid, starts_idx)
    validate_tasks(grid, tasks)
    n = len(starts_idx)
    if len(tasks) == 0:
        return (np.zeros((0, n), np.int32), np.zeros((0, n), np.int8), 0)
    with trace.span("mapd.solve_offline", agents=len(starts_idx),
                    tasks=int(len(tasks))):
        final = run_mapd(cfg, starts_idx, tasks, grid.free, dev)
        makespan = int(final.t)  # the fetch that syncs the device
    if not cfg.record_paths:
        return (np.zeros((0, n), np.int32), np.zeros((0, n), np.int8),
                makespan)
    return (final.paths_pos[:makespan].cpu().numpy(),
            final.paths_state[:makespan].cpu().numpy(), makespan)
