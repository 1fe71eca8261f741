"""The serving daemon's planning plane over a device mesh: the port of the
JAX package's ``parallel/solver_mesh.py``.

Everything the daemon keeps on the device (``runtime/solverd.py``) is laid
out over a :class:`~mesh.Mesh` of one process:

- the direction-field cache's rows split over the agents axis, each agent
  block on every device of its row of the mesh (the JAX layout
  ``P(agents, None)``), so a shard holds ``rows / A`` packed rows.  The
  step's only cross-shard traffic is the next-hop lookup: the shard owning
  ``slot[i]``'s row block contributes lane i's code and one psum on the
  lead assembles the (N,) vector;
- the lanes (pos, goal, slot, active) split over the agents axis when
  their length divides, replicated when it does not, and the tenant slab's
  planes split along the lane axis; the step gathers them on the lead, where
  the replicated control flow (occupancy, swap rules, the movement
  cascade) runs once;
- an optional tiles axis (``AxT``): the field sweeps run as banded local
  sweeps with halo exchanges (``ops/tiled_distance.py``); the cache itself
  stays row-split only.

The daemon keeps its wire and host bookkeeping; the mesh changes where the
bytes live and where the sweeps run, and the replies, packed rows and
audit digests stay byte-identical to the single-device daemon's.

``parse_mesh_spec`` grammar (``JG_SOLVER_MESH`` / solverd ``--mesh``):
``"4"`` is a 4-way agent mesh, ``"2x4"`` 2 agent shards x 4 grid tiles,
and ``"1"`` / ``"1x1"`` one device (the flat path).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch

from p2p_distributed_tswap_tpu_torch.ops.distance import (
    apply_direction,
    direction_fields,
    directions_from_distance,
    distance_fields,
    gather_packed,
    pack_directions,
)
from p2p_distributed_tswap_tpu_torch.ops.tiled_distance import (
    bands_of,
    join_bands,
    tiled_directions_from_distance,
    tiled_distance_fields,
)
from p2p_distributed_tswap_tpu_torch.parallel.mesh import (
    AGENTS_AXIS,
    Mesh,
    Sharded,
    _default_devices,
    psum,
    replicate,
    shard_bytes,
)
from p2p_distributed_tswap_tpu_torch.solver.step import step_with_next_hops

_SPEC_RE = re.compile(r"^(\d+)(?:x(\d+))?$")
_I32 = torch.int32


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """``"N"`` -> (N, 1); ``"AxT"`` -> (A, T).  Raises ValueError on
    anything else (zero counts included): a malformed mesh spec fails at
    startup, never serves on one device."""
    m = _SPEC_RE.match(str(spec).strip().lower())
    if m is None:
        raise ValueError(f"bad mesh spec {spec!r} (want N or AxT)")
    a = int(m.group(1))
    t = int(m.group(2)) if m.group(2) is not None else 1
    if a < 1 or t < 1:
        raise ValueError(f"bad mesh spec {spec!r}: counts must be >= 1")
    return a, t


def mesh_spec_from_env(env: Optional[str]) -> Optional[Tuple[int, int]]:
    """``JG_SOLVER_MESH`` value -> (A, T), with unset / empty / 1 / 1x1 ->
    None (the single-device path)."""
    if not env:
        return None
    a, t = parse_mesh_spec(env)
    if a * t == 1:
        return None
    return a, t


def _local_next_hops(cfg, mesh: Mesh, dirs: Sharded):
    """The distributed ``dirs[slot[i], pos[i]]`` for the daemon's lanes:
    slot is not a permutation (many lanes share a goal row, rows may be
    unreferenced), so ownership is by row block: the agent block holding
    ``slot[i] // rows_local`` contributes lane i's code, read from the
    block on its first tile, and one psum assembles all N.  Exact: exactly
    one shard contributes a nonzero int32 per lane."""
    n_agents = mesh.shape[AGENTS_AXIS]
    rows_local = dirs.shape[0] // n_agents

    def nh(slot, pos):
        parts = []
        for a in range(n_agents):
            blk = dirs.block(a)
            s, p = slot.to(blk.device), pos.to(blk.device)
            local = (s // rows_local) == a
            lrow = torch.where(local, s - a * rows_local, 0)
            vals = gather_packed(blk, lrow, p)
            parts.append(torch.where(local, vals.to(_I32), 0))
        codes = psum(parts, pos.device).to(torch.uint8)
        return apply_direction(pos, codes, cfg.width)

    return nh


class SolverMesh:
    """One daemon's device mesh and its sharded programs.

    ``n_agent_shards`` (A) splits field rows and lanes; ``n_tiles`` (T)
    bands the sweeps over grid rows.  The mesh is (A x T) even when
    T == 1.  ``devices`` defaults to the first A*T CUDA devices (raising
    when there are fewer); pass ``virtual_mesh.virtual_devices`` for a
    virtual mesh."""

    def __init__(self, n_agent_shards: int, n_tiles: int = 1, devices=None):
        if n_agent_shards < 1 or n_tiles < 1:
            raise ValueError("mesh axes must be >= 1")
        self.n_agent_shards = n_agent_shards
        self.n_tiles = n_tiles
        self.n_devices = n_agent_shards * n_tiles
        if devices is None:
            devices = _default_devices(self.n_devices)
        self.mesh = Mesh(devices, n_agent_shards, n_tiles)
        self.row_spec = (AGENTS_AXIS, None)
        self.lane_spec = (AGENTS_AXIS,)
        self.slab_spec = (None, AGENTS_AXIS)

    @property
    def shape_str(self) -> str:
        return f"{self.n_agent_shards}x{self.n_tiles}"

    @property
    def lead(self) -> torch.device:
        return self.mesh.lead

    # -- geometry -------------------------------------------------------
    def round_lanes(self, n: int) -> int:
        """Next multiple of the agent-shard count (lane capacities divide
        over the shards; pow2 doubling keeps the property)."""
        a = self.n_agent_shards
        return -(-n // a) * a

    def round_rows(self, rows: int) -> int:
        return self.round_lanes(rows)

    def validate_grid(self, grid) -> None:
        if self.n_tiles > 1 and grid.height % self.n_tiles:
            raise ValueError(
                f"grid height {grid.height} must divide over "
                f"{self.n_tiles} tiles (mesh {self.shape_str})")

    # -- placement --------------------------------------------------------
    def _put(self, arr, spec) -> Sharded:
        if isinstance(arr, Sharded):
            if arr.spec == tuple(spec) + (None,) * (arr.dim() - len(spec)):
                return arr
            arr = arr.gather()
        return Sharded.put(self.mesh, arr, spec)

    def pin_rows(self, arr) -> Sharded:
        """Row-split the (rows, words) dirs cache (rows % A == 0, which the
        callers' ``round_rows`` growth keeps)."""
        return self._put(arr, self.row_spec)

    def pin_lanes(self, arr) -> Sharded:
        """Agent-axis-split a per-lane vector, replicated when its length
        does not divide (correctness never depends on the layout)."""
        if arr.shape[0] % self.n_agent_shards:
            return self._put(arr, ())
        return self._put(arr, self.lane_spec)

    def pin_slab(self, arr) -> Sharded:
        """Lane-axis-split a [T_cap, L_cap] slab plane."""
        if arr.shape[1] % self.n_agent_shards:
            return self._put(arr, ())
        return self._put(arr, self.slab_spec)

    def shard_bytes(self, arrays) -> Dict[int, int]:
        """Bytes each mesh position holds of ``arrays``, keyed by flat
        position 0..n_devices-1 (what the port really allocates: a virtual
        mesh holds every position's copy on its one device)."""
        return shard_bytes(self.mesh, arrays)

    # -- sharded programs -------------------------------------------------
    def make_step(self):
        """``step(cfg, pos, goal, slot, dirs, active)`` with the contract of
        ``solver.step.step_parallel``: the lanes gathered on the lead, the
        next hops read from the row-split cache.  Bit-identical to the flat
        step."""
        mesh = self.mesh

        def mesh_step(cfg, pos, goal, slot, dirs, active):
            lead = mesh.lead
            return step_with_next_hops(
                cfg, replicate(pos, lead), replicate(goal, lead),
                replicate(slot, lead), _local_next_hops(cfg, mesh, dirs),
                replicate(active, lead))

        return mesh_step

    def make_slab_step(self):
        """The multi-tenant super-step on the mesh: the [T, L] planes
        gathered on the lead and folded into one lane axis of ``T * L``
        lanes (the port's tenant fold, ``step_with_next_hops(...,
        tenants=T)``), each lane's next hop read from the shared row-split
        cache.  ``slab_step(cfg, pos, goal, slot, dirs, active)`` with
        ``cfg.num_agents == T * L``; returns flat (T * L,) tensors."""
        mesh = self.mesh

        def slab_step(cfg, pos, goal, slot, dirs, active):
            lead = mesh.lead
            tenants = pos.shape[0]
            flat = [replicate(x, lead).reshape(-1)
                    for x in (pos, goal, slot, active)]
            return step_with_next_hops(
                cfg, flat[0], flat[1], flat[2],
                _local_next_hops(cfg, mesh, dirs), flat[3], tenants=tenants)

        return slab_step

    def _pad_goals(self, goals: torch.Tensor) -> torch.Tensor:
        """Repeat the last goal up to a multiple of the agent shards."""
        pad = -goals.shape[0] % self.n_agent_shards
        if pad:
            goals = torch.cat([goals, goals[-1:].expand(pad)])
        return goals

    def _split_goals(self, goals: torch.Tensor):
        per = goals.shape[0] // self.n_agent_shards
        return [goals[a * per:(a + 1) * per]
                for a in range(self.n_agent_shards)]

    def _placer(self):
        """``place(free)``: the mask on each agent block's first device, or
        its (A, T) bands with a tiles axis; the last mask's placement is
        kept (a world toggle swaps in a new mask tensor)."""
        cache = {}

        def place(free):
            if cache.get("free") is not free:
                cache["free"] = free
                if self.n_tiles == 1:
                    cache["at"] = [free.to(self.mesh.device(a))
                                   for a in range(self.n_agent_shards)]
                else:
                    cache["at"] = bands_of(free, self.mesh)
            return cache["at"]

        return place

    def _tiled(self, place, free, goals):
        """Distances and codes of the padded goal batch over the tiles:
        each agent block sweeps its share of the goals, banded."""
        bands = place(free)
        d = tiled_distance_fields(bands, self._split_goals(goals),
                                  free.shape[1])
        codes = tiled_directions_from_distance(d, bands)
        lead = self.lead
        return (torch.cat([join_bands(x, lead) for x in d]),
                torch.cat([join_bands(x, lead) for x in codes]))

    def make_fields(self, grid):
        """The sharded twin of the service's field sweep: the goal batch
        split over the agents axis (per-goal sweeps are independent, so the
        split is bit-identical), each goal's sweep banded over the tiles
        axis when T > 1 (also bit-identical).  Returns ``fields(free,
        goals)`` -> (G, words) packed rows on the lead: it pads the batch
        to a shard multiple and slices the result back.  With tiles the
        codes are packed after the bands are joined, so a packed word never
        straddles a band."""
        place = self._placer()
        lead = self.lead

        def fields(free, goals):
            g = goals.shape[0]
            padded = self._pad_goals(goals)
            if self.n_tiles == 1:
                parts = []
                for a, ga in enumerate(self._split_goals(padded)):
                    fa = place(free)[a]
                    d = direction_fields(fa, ga.to(fa.device))
                    parts.append(pack_directions(
                        d.reshape(ga.shape[0], -1)).to(lead))
                return torch.cat(parts)[:g]
            _, codes = self._tiled(place, free, padded)
            return pack_directions(codes.reshape(padded.shape[0], -1))[:g]

        return fields

    def make_fields_dist(self, grid):
        """The sharded twin of the service's dynamic-world sweep: packed
        rows plus the (G, H, W) distances and codes the host repair
        mirrors start from, all on the lead."""
        place = self._placer()
        lead = self.lead

        def fields_dist(free, goals):
            g = goals.shape[0]
            padded = self._pad_goals(goals)
            if self.n_tiles == 1:
                ds, cs = [], []
                for a, ga in enumerate(self._split_goals(padded)):
                    fa = place(free)[a]
                    d = distance_fields(fa, ga.to(fa.device))
                    ds.append(d.to(lead))
                    cs.append(directions_from_distance(d, fa).to(lead))
                d, codes = torch.cat(ds), torch.cat(cs)
            else:
                d, codes = self._tiled(place, free, padded)
            packed = pack_directions(codes.reshape(padded.shape[0], -1))
            return packed[:g], d[:g], codes[:g]

        return fields_dist
