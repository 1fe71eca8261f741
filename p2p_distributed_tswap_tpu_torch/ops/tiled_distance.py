"""Grid-tile-sharded distance and direction fields (bands of rows).

The port of the JAX package's ``ops/tiled_distance.py``.  The H axis of the
grid is split over the tiles axis of a mesh (``parallel/mesh.py``): each
shard holds a horizontal band of every field, and the fast-sweeping
relaxation runs as local sweeps plus a one-row halo exchange per round
(``mesh.ppermute`` of the boundary rows, a copy between devices).  A round
is the four directional sweeps within each band (``ops.distance._sweep``:
``sweep_scan`` on a CUDA band, the plain doubling scan on a CPU band), then
each band's boundary rows relaxed against the neighbours' adjacent rows.
Information crosses at least one band boundary per round, so the fixpoint
needs at most T - 1 rounds more than one device's; it is the exact BFS
distance, bit for bit the single-device fields.

Blocks: the functions take an (A, T) nested list of per-shard tensors.
``free_local[a][t]`` is band ``t`` of the grid on the device of mesh
position ``(a, t)``, and ``goals_idx[a]`` the goal batch of agent block
``a`` (global flat cells).  Each agent block sweeps its own goals; the
halo exchange runs along the tiles of one agent block.

The fixpoint: the JAX package stops when no band of the psum's axes
changed (``fixpoint_axes``, all of the mesh on the 2-D solver).  Here a
round sweeps every block still moving and one host sync
(``hostsync.values``) reads each block's change flag, the psum over its
bands; a block whose round changed nothing is done, since another round
would give the same bands.  The results equal the JAX package's whether
its fixpoint spans one agent block or the whole mesh, ``max_rounds``
binding or not: a block's rounds depend on its own bands only.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    INF,
    _sweep,
    directions_from_distance,
)
from p2p_distributed_tswap_tpu_torch.parallel.mesh import (
    AGENTS_AXIS,
    TILES_AXIS,
    Mesh,
    ppermute,
    psum,
)

Blocks = Sequence[Sequence[torch.Tensor]]


def bands_of(free: torch.Tensor, mesh: Mesh) -> List[List[torch.Tensor]]:
    """The (A, T) blocks of a global (H, W) mask: band ``t`` on the device
    of each position ``(a, t)``."""
    n_tiles = mesh.shape[TILES_AXIS]
    h = free.shape[0]
    if h % n_tiles:
        raise ValueError(f"height {h} must divide over {n_tiles} tiles")
    hl = h // n_tiles
    return [[free[t * hl:(t + 1) * hl].to(mesh.device(a, t)).contiguous()
             for t in range(n_tiles)]
            for a in range(mesh.shape[AGENTS_AXIS])]


def join_bands(bands: Sequence[torch.Tensor], device) -> torch.Tensor:
    """One agent block's bands joined along H on ``device``."""
    return torch.cat([b.to(device) for b in bands], dim=-2)


def _exchange_boundary_rows(d: Sequence[torch.Tensor]):
    """(above, below) halo rows for each band of one agent block: the last
    row of the band above and the first row of the band below, INF on the
    edge bands (no neighbour: a zero there would look like distance 0)."""
    n = len(d)
    devs = [x.device for x in d]
    above = ppermute([x[:, -1:, :] for x in d],
                     [(i, i + 1) for i in range(n - 1)], devs)
    below = ppermute([x[:, :1, :] for x in d],
                     [(i + 1, i) for i in range(n - 1)], devs)
    above[0] = torch.full_like(d[0][:, :1, :], INF)
    below[n - 1] = torch.full_like(d[n - 1][:, :1, :], INF)
    return above, below


def _halo_relax(d: Sequence[torch.Tensor],
                free_local: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Relax each band's boundary rows against the neighbours' adjacent
    rows, ``d[:, 0] <- min(d[:, 0], above + 1)`` and the same for the last
    row; ``INF + 1`` is clamped to INF, and the band is masked by its free
    cells again."""
    if len(d) == 1:
        return list(d)
    above, below = _exchange_boundary_rows(d)
    out = []
    for x, f, up, down in zip(d, free_local, above, below):
        x = x.clone()
        x[:, :1, :] = torch.minimum(x[:, :1, :], (up + 1).clamp(max=INF))
        x[:, -1:, :] = torch.minimum(x[:, -1:, :], (down + 1).clamp(max=INF))
        out.append(torch.where(f[None], x, INF))
    return out


def _seed(free: torch.Tensor, goals: torch.Tensor, t: int) -> torch.Tensor:
    hl, w = free.shape
    g = goals.shape[0]
    cell = (torch.arange(hl * w, dtype=torch.int32, device=free.device)
            .reshape(1, hl, w) + t * hl * w)
    hit = (cell == goals.to(free.device).reshape(g, 1, 1)) & free[None]
    return torch.where(hit, torch.zeros((), dtype=torch.int32,
                                        device=free.device), INF)


def tiled_distance_fields(free_local: Blocks, goals_idx, width: int,
                          max_rounds: int = 256) -> List[List[torch.Tensor]]:
    """Exact BFS distances on an H-sharded grid.

    Args:
      free_local: (A, T) blocks of (H_local, W) bool bands.
      goals_idx: A goal batches, (G_a,) int32 global flat cell indices.
      width: the grid width (each band's width).
      max_rounds: cap on the rounds.

    Returns the (A, T) blocks of (G_a, H_local, W) int32 bands of the
    exact global fields.
    """
    blocked = [[(~f).to(torch.uint8).contiguous() for f in row]
               for row in free_local]
    d = []
    for a, row in enumerate(free_local):
        assert all(f.shape[1] == width for f in row)
        d.append([_seed(f, goals_idx[a], t) for t, f in enumerate(row)])
    lead = free_local[0][0].device
    moving = list(range(len(d)))
    i = 0
    while moving and i < max_rounds:
        changed = []
        for a in moving:
            nd = []
            for x, b in zip(d[a], blocked[a]):
                x = _sweep(x, b, axis=2, reverse=False)
                x = _sweep(x, b, axis=2, reverse=True)
                x = _sweep(x, b, axis=1, reverse=False)
                nd.append(_sweep(x, b, axis=1, reverse=True))
            nd = _halo_relax(nd, free_local[a])
            changed.append(psum([torch.any(y != x).to(torch.int32)
                                 for x, y in zip(d[a], nd)], lead) > 0)
            d[a] = nd
        flags = hostsync.values(torch.stack(changed))
        moving = [a for a, c in zip(moving, flags) if c]
        i += 1
    return d


def tiled_directions_from_distance(d: Blocks, free_local: Blocks
                                   ) -> List[List[torch.Tensor]]:
    """Direction codes from banded distances: each band is padded with its
    neighbours' adjacent rows, marked not free, and the codes of the
    padding are sliced off, so a cell on a band edge reads its
    neighbour's row and the first-min tie-break is the single device's."""
    out = []
    for row, frow in zip(d, free_local):
        if len(row) == 1:
            out.append([directions_from_distance(row[0], frow[0])])
            continue
        above, below = _exchange_boundary_rows(row)
        codes = []
        for x, f, up, down in zip(row, frow, above, below):
            padded = torch.cat([up, x, down], dim=1)
            edge = torch.zeros((1, f.shape[1]), dtype=torch.bool,
                               device=f.device)
            free_pad = torch.cat([edge, f, edge], dim=0)
            codes.append(directions_from_distance(padded, free_pad)[:, 1:-1])
        out.append(codes)
    return out


def tiled_direction_fields(free_local: Blocks, goals_idx, width: int,
                           max_rounds: int = 256
                           ) -> List[List[torch.Tensor]]:
    """(A, T) blocks of (G_a, H_local, W) uint8 next-hop codes on an
    H-sharded grid, bit-identical to the single-device
    ``direction_fields``."""
    d = tiled_distance_fields(free_local, goals_idx, width, max_rounds)
    return tiled_directions_from_distance(d, free_local)
