"""Agent-axis sharded TSWAP solver: the port of the JAX package's
``parallel/sharded.py``.

The direction fields, O(N * H * W) bytes and the only large state, are
split by field row over the agents axis of a mesh (``parallel/mesh.py``):
each shard holds N / A packed rows on its device.  Everything else (a few
int32 per agent) is replicated control state, held once on the mesh's lead
device, where the rule phases run; the JAX package runs the same
deterministic phases on every device instead.  Each step has two
distributed pieces:

- the next-hop lookup ``dirs[slot[i], pos[i]]``: each shard reads the rows
  it owns for the agents that hold them (the inverse of the slot
  permutation) and one :func:`~mesh.psum` of (N,) int32 contributions on
  the lead assembles the codes;
- the replan: each shard recomputes only the stale rows it owns, sweeping
  its own (R, H, W) batch on its device (``ops.distance.direction_fields``:
  ``sweep_scan``, or the fused field kernel under ``MAPD_FUSED``).

The results are bit-identical to the single-device solver.  ``num_agents``
must divide over the agent shards.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    PACKED_STAY,
    apply_direction,
    direction_fields,
    gather_packed,
    pack_directions,
    packed_cells,
)
from p2p_distributed_tswap_tpu_torch.parallel.mesh import (
    AGENTS_AXIS,
    TILES_AXIS,
    Mesh,
    Sharded,
    agent_mesh,
    psum,
)
from p2p_distributed_tswap_tpu_torch.solver import mapd as mapd_mod
from p2p_distributed_tswap_tpu_torch.solver.mapd import MapdState, init_state

_I32 = torch.int32


def agent_state_specs() -> Dict[str, tuple]:
    """The layout of each ``MapdState`` field on the agent mesh: only the
    direction-field rows split (the dominant buffer); every other field is
    replicated control state ((), held once on the mesh's lead).  The one
    source of truth for the 1-D mesh's entry points and ``convert``."""
    specs = {f: () for f in MapdState.__dataclass_fields__}
    specs["dirs"] = (AGENTS_AXIS, None)
    return specs


def _inverse(slot: torch.Tensor) -> torch.Tensor:
    """Which agent holds each field row (the inverse of the slot
    permutation)."""
    n = slot.shape[0]
    inv = torch.zeros(n, dtype=_I32, device=slot.device)
    return inv.index_put_((slot.long(),),
                          torch.arange(n, dtype=_I32, device=slot.device))


def _rows_local(mesh: Mesh, dirs: Sharded) -> int:
    return dirs.shape[0] // mesh.shape[AGENTS_AXIS]


def _write_rows(mesh: Mesh, dirs: Sharded, a: int, rows: torch.Tensor,
                packed: torch.Tensor) -> None:
    """Write packed rows into agent block ``a``'s local ``rows``, in place,
    on every tile of that block."""
    for t in range(mesh.shape[TILES_AXIS]):
        blk = dirs.block(a, t)
        blk[rows.to(blk.device).long()] = packed.to(blk.device)


def _sharded_next_hops(cfg: SolverConfig, mesh: Mesh, dirs: Sharded,
                       slot: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Distributed ``dirs[slot[i], pos[i]]``: one psum of (N,) int32."""
    n = cfg.num_agents
    rows_local = _rows_local(mesh, dirs)
    inv = _inverse(slot)
    parts = []
    for a in range(mesh.shape[AGENTS_AXIS]):
        blk = dirs.block(a)
        dev = blk.device
        rows = torch.arange(rows_local, dtype=_I32, device=dev)
        holders = inv.to(dev)[a * rows_local + rows].long()
        vals = gather_packed(blk, rows, pos.to(dev)[holders])
        contrib = torch.zeros(n, dtype=_I32, device=dev)
        parts.append(contrib.index_put_((holders,), vals.to(_I32)))
    codes = psum(parts, pos.device).to(torch.uint8)
    return apply_direction(pos, codes, cfg.width)


def _sharded_prime(cfg: SolverConfig, mesh: Mesh, s: MapdState,
                   free) -> MapdState:
    """The t=0 field burst, sharded: every shard computes all the rows it
    owns in wide ``replan_chunk`` batches on its own device (the tail chunk
    clips to the last row and writes it again).  ``free[a]`` is the mask
    on agent block ``a``'s device."""
    rows_local = _rows_local(mesh, s.dirs)
    inv = _inverse(s.slot)
    r = min(cfg.replan_chunk, rows_local)
    for a in range(mesh.shape[AGENTS_AXIS]):
        dev = free[a].device
        inv_a, goal_a = inv.to(dev), s.goal.to(dev)
        lane = torch.arange(r, dtype=_I32, device=dev)
        for o in range(0, rows_local, r):
            row_local = (o + lane).clamp(0, rows_local - 1)
            holder = inv_a[a * rows_local + row_local].long()
            fields = direction_fields(free[a], goal_a[holder],
                                      max_rounds=cfg.max_sweep_rounds)
            _write_rows(mesh, s.dirs, a, row_local,
                        pack_directions(fields.reshape(r, cfg.num_cells)))
    return s.replace(need_replan=torch.zeros_like(s.need_replan))


def _sharded_replan(cfg: SolverConfig, mesh: Mesh, s: MapdState,
                    free) -> MapdState:
    """Each shard recomputes the stale rows it owns, in narrow
    ``replan_chunk_small`` chunks of the lowest flagged ids, until its set
    drains; every stale row is owned by exactly one shard, so the union
    drains all.  A chunk's unused lanes repeat its first lane, so they
    write that lane's row with that lane's field again."""
    n = cfg.num_agents
    rows_local = _rows_local(mesh, s.dirs)
    r = min(cfg.replan_chunk_small, n)
    idx = torch.arange(n, dtype=_I32, device=s.pos.device)
    owner = s.slot // rows_local
    for a in range(mesh.shape[AGENTS_AXIS]):
        dev = free[a].device
        own = s.need_replan & (owner == a)
        while hostsync.flag(torch.any(own)):
            priority = torch.where(own, idx, n)
            sel = torch.topk(priority, r, largest=False).values
            valid = sel < n
            selc = torch.where(valid, sel, sel[0])
            fields = direction_fields(free[a], s.goal[selc].to(dev),
                                      max_rounds=cfg.max_sweep_rounds)
            _write_rows(mesh, s.dirs, a, s.slot[selc] - a * rows_local,
                        pack_directions(fields.reshape(r, cfg.num_cells)))
            cleared = torch.zeros(n, dtype=_I32, device=own.device)
            cleared.scatter_reduce_(0, selc.long(), valid.to(_I32), "amax",
                                    include_self=True)
            own = own & (cleared == 0)
    return s.replace(need_replan=torch.zeros_like(s.need_replan))


def sharded_mapd_step(cfg: SolverConfig, mesh: Mesh, s: MapdState,
                      tasks: torch.Tensor, free) -> MapdState:
    """One MAPD timestep on the mesh: the single-device sequencing
    (``mapd.mapd_step``) with the distributed replan and next-hop lookup
    swapped in."""
    return mapd_mod.mapd_step(
        cfg, s, tasks, free,
        replan_fn=lambda c, st, f: _sharded_replan(c, mesh, st, f),
        nh_factory=lambda c, dirs: functools.partial(
            _sharded_next_hops, c, mesh, dirs))


def _start(cfg: SolverConfig, mesh: Mesh, starts, tasks, spec
           ) -> Tuple[MapdState, torch.Tensor]:
    """The state before the prime, on the mesh: init with the packed rows
    laid out as ``spec`` says, the pre-loop transitions and the first
    assignment (``mapd.prepare_state``'s order, so an agent starting on
    its pickup flips in the first step as on one device); the zero-task
    case becomes one pre-used dummy task."""
    lead = mesh.lead
    starts = mapd_mod._as_tensor(starts, _I32, lead)
    tasks = mapd_mod._as_tensor(tasks, _I32, lead)
    dirs = Sharded.full(mesh, (cfg.num_agents, packed_cells(cfg.num_cells)),
                        PACKED_STAY, _I32, spec)
    if tasks.shape[0] == 0:
        tasks = torch.zeros((1, 2), dtype=_I32, device=lead)
        s = init_state(cfg, starts, 1, dirs=dirs)
        s = s.replace(task_used=torch.ones(1, dtype=torch.bool, device=lead))
    else:
        s = init_state(cfg, starts, tasks.shape[0], dirs=dirs)
    s = mapd_mod._transitions(cfg, s, tasks)
    return mapd_mod._assign(cfg, s, tasks), tasks


def prepare_state_sharded(cfg: SolverConfig, mesh: Mesh, starts, tasks,
                          free):
    """The state after the prime on the agent mesh, the task tensor and the
    mask on each agent block's device: what the step loop of
    :func:`make_sharded_runner` starts from."""
    s, tasks = _start(cfg, mesh, starts, tasks, agent_state_specs()["dirs"])
    free = mapd_mod._as_tensor(free, torch.bool, mesh.lead)
    free = [free.to(mesh.device(a))
            for a in range(mesh.shape[AGENTS_AXIS])]
    return _sharded_prime(cfg, mesh, s, free), tasks, free


def make_sharded_runner(cfg: SolverConfig, mesh: Mesh | None = None):
    """An end-to-end MAPD solve over ``mesh`` (default: every CUDA
    device).  Returns ``run(starts (N,), tasks (T, 2), free (H, W)) ->
    MapdState``, its ``dirs`` a :class:`~mesh.Sharded` tensor."""
    if mesh is None:
        mesh = agent_mesh()
    n_dev = mesh.shape[AGENTS_AXIS]
    if cfg.num_agents % n_dev:
        raise ValueError(f"num_agents={cfg.num_agents} must divide over "
                         f"{n_dev} agent shards")

    def run(starts, tasks, free) -> MapdState:
        s, tasks, free = prepare_state_sharded(cfg, mesh, starts, tasks,
                                               free)
        while not hostsync.flag(mapd_mod._finished(cfg, s)):
            s = sharded_mapd_step(cfg, mesh, s, tasks, free)
        return s

    return run


def _paths(cfg: SolverConfig, final: MapdState, n: int):
    makespan = int(final.t)
    if not cfg.record_paths:
        return (np.zeros((0, n), np.int32), np.zeros((0, n), np.int8),
                makespan)
    return (final.paths_pos[:makespan].cpu().numpy(),
            final.paths_state[:makespan].cpu().numpy(), makespan)


def solve_offline_sharded(grid: Grid, starts_idx: np.ndarray,
                          tasks: np.ndarray, cfg: SolverConfig | None = None,
                          mesh: Mesh | None = None
                          ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sharded counterpart of ``mapd.solve_offline`` (same contract)."""
    if cfg is None:
        cfg = SolverConfig(height=grid.height, width=grid.width,
                           num_agents=len(starts_idx))
    mapd_mod.validate_starts(grid, starts_idx)
    mapd_mod.validate_tasks(grid, tasks)
    run = make_sharded_runner(cfg, mesh)
    final = run(starts_idx, np.asarray(tasks, np.int32).reshape(-1, 2),
                grid.free)
    return _paths(cfg, final, len(starts_idx))
