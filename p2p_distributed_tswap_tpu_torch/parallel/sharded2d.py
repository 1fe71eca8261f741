"""2-D (agents x tiles) sharded MAPD solver: the port of the JAX package's
``parallel/sharded2d.py``, the deployment shape of grids and fleets past
one device's field budget.

It composes the two shardings:

- the agents axis (``parallel/sharded.py``): field rows split over one
  mesh dimension, N / A rows per agent block;
- the tiles axis (``ops/tiled_distance.py``): each row's cells split over
  the other as horizontal grid bands, so a shard holds (N / A rows) x
  (H / T band) and the sweep's workspace shrinks by T too.

Control state stays replicated (held once on the mesh's lead).  Per step:

- the next-hop lookup: the shard holding both agent i's row (agents axis)
  and the band containing ``pos[i]`` (tiles axis) contributes the code,
  and one psum over the whole mesh assembles the (N,) vector;
- the replan: every tile of an agent block takes the same stale rows, the
  tiled sweep computes each band with halo exchanges, and each shard
  writes its (rows x band) block.  The JAX package runs every agent block
  for the pmax of the blocks' chunk counts, a block that is done doing
  no-op rounds that write only a scratch row, so that the collectives line
  up; one process has nothing to line up, so a block sweeps only its own
  rounds, and the rows written are the same.

Results are bit-identical to the single-device solver.  Constraints:
``num_agents % A == 0``, ``H % T == 0``, and ``(H / T) * W % 8 == 0``
(whole packed words per band).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    apply_direction,
    pack_directions,
)
from p2p_distributed_tswap_tpu_torch.ops.tiled_distance import (
    bands_of,
    tiled_direction_fields,
)
from p2p_distributed_tswap_tpu_torch.parallel.mesh import (
    AGENTS_AXIS,
    TILES_AXIS,
    Mesh,
    Sharded,
    agent_tile_mesh,
    psum,
)
from p2p_distributed_tswap_tpu_torch.parallel.sharded import (
    _inverse,
    _paths,
    _start,
)
from p2p_distributed_tswap_tpu_torch.solver import mapd as mapd_mod
from p2p_distributed_tswap_tpu_torch.solver.mapd import MapdState

_I32 = torch.int32


def state_specs_2d() -> Dict[str, tuple]:
    """The layout of each ``MapdState`` field on the 2-D mesh: the packed
    rows split over both axes, the rest replicated control state."""
    specs = {f: () for f in MapdState.__dataclass_fields__}
    specs["dirs"] = (AGENTS_AXIS, TILES_AXIS)
    return specs


def _next_hops_2d(cfg: SolverConfig, mesh: Mesh, dirs: Sharded,
                  slot: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Distributed ``dirs[slot[i], pos[i]]`` on the 2-D mesh: one psum over
    (agents, tiles) of an (N,) int32 contribution vector."""
    n = cfg.num_agents
    inv = _inverse(slot)
    parts = []
    for a, t in mesh.positions():
        blk = dirs.block(a, t)
        rows_local, words_local = blk.shape
        dev = blk.device
        rows = torch.arange(rows_local, dtype=_I32, device=dev)
        holders = inv.to(dev)[a * rows_local + rows].long()
        p = pos.to(dev)[holders]
        word_global = p >> 3
        in_band = ((word_global >= t * words_local)
                   & (word_global < (t + 1) * words_local))
        word = blk[rows, (word_global - t * words_local).clamp(
            0, words_local - 1)]
        code = (word >> ((p & 7) * 4)) & 0xF
        contrib = torch.zeros(n, dtype=_I32, device=dev)
        parts.append(contrib.index_put_(
            (holders,), torch.where(in_band, code, 0).to(_I32)))
    codes = psum(parts, pos.device).to(torch.uint8)
    return apply_direction(pos, codes, cfg.width)


def _write_blocks(dirs: Sharded, a: int, rows: torch.Tensor, bands) -> None:
    """Write one agent block's new fields: each tile's band, packed, into
    its rows of that shard."""
    for t, band in enumerate(bands):
        blk = dirs.block(a, t)
        blk[rows.to(blk.device).long()] = pack_directions(
            band.reshape(band.shape[0], -1)).to(blk.device)


def _prime_2d(cfg: SolverConfig, mesh: Mesh, s: MapdState,
              free_local) -> MapdState:
    """The t=0 field burst on the 2-D mesh: every agent block computes all
    its rows in wide ``replan_chunk`` batches, one tiled sweep per chunk
    over the whole mesh (each block its own goals)."""
    n_agents = mesh.shape[AGENTS_AXIS]
    rows_local = s.dirs.shape[0] // n_agents
    inv = _inverse(s.slot)
    r = min(cfg.replan_chunk, rows_local)
    lane = torch.arange(r, dtype=_I32, device=s.pos.device)
    for o in range(0, rows_local, r):
        row_local = (o + lane).clamp(0, rows_local - 1)
        goals = [s.goal[inv[a * rows_local + row_local].long()]
                 for a in range(n_agents)]
        fields = tiled_direction_fields(free_local, goals, cfg.width,
                                        max_rounds=cfg.max_sweep_rounds)
        for a in range(n_agents):
            _write_blocks(s.dirs, a, row_local, fields[a])
    return s.replace(need_replan=torch.zeros_like(s.need_replan))


def _replan_2d(cfg: SolverConfig, mesh: Mesh, s: MapdState,
               free_local) -> MapdState:
    """Drain the stale rows each agent block owns, in narrow
    ``replan_chunk_small`` chunks; each round sweeps the blocks that still
    have rows in one tiled call.  One host sync reads every block's chunk
    count; a chunk's unused lanes repeat its first lane."""
    n = cfg.num_agents
    n_agents = mesh.shape[AGENTS_AXIS]
    rows_local = s.dirs.shape[0] // n_agents
    r = min(cfg.replan_chunk_small, n)
    idx = torch.arange(n, dtype=_I32, device=s.pos.device)
    owner = s.slot // rows_local
    own = [s.need_replan & (owner == a) for a in range(n_agents)]
    counts = hostsync.values(torch.stack([o.sum() for o in own]))
    rounds = [-(-c // r) for c in counts]
    for i in range(max(rounds)):
        blocks = [a for a in range(n_agents) if i < rounds[a]]
        picks = []
        for a in blocks:
            priority = torch.where(own[a], idx, n)
            sel = torch.topk(priority, r, largest=False).values
            valid = sel < n
            picks.append((valid, torch.where(valid, sel, sel[0])))
        fields = tiled_direction_fields(
            [free_local[a] for a in blocks],
            [s.goal[selc] for _, selc in picks], cfg.width,
            max_rounds=cfg.max_sweep_rounds)
        for a, (valid, selc), bands in zip(blocks, picks, fields):
            _write_blocks(s.dirs, a, s.slot[selc] - a * rows_local, bands)
            cleared = torch.zeros(n, dtype=_I32, device=idx.device)
            cleared.scatter_reduce_(0, selc.long(), valid.to(_I32), "amax",
                                    include_self=True)
            own[a] = own[a] & (cleared == 0)
    return s.replace(need_replan=torch.zeros_like(s.need_replan))


def sharded2d_mapd_step(cfg: SolverConfig, mesh: Mesh, s: MapdState,
                        tasks: torch.Tensor, free_local) -> MapdState:
    """One MAPD timestep on the 2-D mesh: the single-device sequencing
    with the 2-D replan and next-hop lookup swapped in."""
    return mapd_mod.mapd_step(
        cfg, s, tasks, free_local,
        replan_fn=lambda c, st, f: _replan_2d(c, mesh, st, f),
        nh_factory=lambda c, dirs: (
            lambda sl, po: _next_hops_2d(c, mesh, dirs, sl, po)))


def check_2d(cfg: SolverConfig, mesh: Mesh) -> None:
    """The 2-D mesh's divisibility constraints, as ValueErrors."""
    n_agent_shards = mesh.shape[AGENTS_AXIS]
    n_tiles = mesh.shape[TILES_AXIS]
    if cfg.num_agents % n_agent_shards:
        raise ValueError(f"num_agents={cfg.num_agents} must divide over "
                         f"{n_agent_shards} agent shards")
    if cfg.height % n_tiles:
        raise ValueError(f"height={cfg.height} must divide over {n_tiles} "
                         "tiles")
    band_cells = (cfg.height // n_tiles) * cfg.width
    if band_cells % 8:
        raise ValueError(f"band cell count {band_cells} must be a multiple "
                         "of 8 (whole packed words per band)")


def prepare_state_2d(cfg: SolverConfig, mesh: Mesh, starts, tasks, free):
    """The state after the prime on the 2-D mesh, the task tensor and the
    (A, T) free bands: what the step loop of :func:`make_sharded2d_runner`
    starts from."""
    check_2d(cfg, mesh)
    s, tasks = _start(cfg, mesh, starts, tasks, state_specs_2d()["dirs"])
    free = mapd_mod._as_tensor(free, torch.bool, mesh.lead)
    free_local = bands_of(free, mesh)
    return _prime_2d(cfg, mesh, s, free_local), tasks, free_local


def make_sharded2d_runner(cfg: SolverConfig, mesh: Mesh):
    """An end-to-end MAPD solve over a 2-D (agents x tiles) mesh.  Returns
    ``run(starts (N,), tasks (T, 2), free (H, W)) -> MapdState``."""
    check_2d(cfg, mesh)

    def run(starts, tasks, free) -> MapdState:
        s, tasks, free_local = prepare_state_2d(cfg, mesh, starts, tasks,
                                                free)
        while not hostsync.flag(mapd_mod._finished(cfg, s)):
            s = sharded2d_mapd_step(cfg, mesh, s, tasks, free_local)
        return s

    return run


def solve_offline_sharded2d(grid: Grid, starts_idx: np.ndarray,
                            tasks: np.ndarray,
                            cfg: SolverConfig | None = None,
                            mesh: Mesh | None = None,
                            n_agent_shards: int = 2, n_tiles: int = 4
                            ) -> Tuple[np.ndarray, np.ndarray, int]:
    """2-D sharded counterpart of ``mapd.solve_offline`` (same contract)."""
    if cfg is None:
        cfg = SolverConfig(height=grid.height, width=grid.width,
                           num_agents=len(starts_idx))
    if mesh is None:
        mesh = agent_tile_mesh(n_agent_shards, n_tiles)
    mapd_mod.validate_starts(grid, starts_idx)
    mapd_mod.validate_tasks(grid, tasks)
    run = make_sharded2d_runner(cfg, mesh)
    final = run(starts_idx, np.asarray(tasks, np.int32).reshape(-1, 2),
                grid.free)
    return _paths(cfg, final, len(starts_idx))
