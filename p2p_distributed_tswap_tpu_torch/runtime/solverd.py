"""solverd -- the solver daemon behind the centralized manager's
``--solver=tpu`` mode, on PyTorch: the port of the JAX package's
``runtime/solverd.py``.

The C++ centralized manager ships global agent state over bus topic
"solver" as a plan_request each planning tick; this daemon runs ONE batched
TSWAP step on the card and replies with per-agent next positions (and
possibly swapped goals).  The manager stays the system of record.  For the
same request stream the replies are byte-identical to the JAX daemon's
(packed ``data``, JSON ``moves`` and the audit digests; only
``duration_micros`` differs): the solver is integer math.

Device-side design: fixed-capacity lanes (next power of two over the fleet
size) with the step's ``active`` lane mask; direction-field rows are cached
per goal in one preallocated packed buffer (LRU eviction, goals of resident
agents pinned) and swept only for goals not seen before, in power-of-two
chunks of at most ``FIELD_CHUNK`` through ``ops.distance.direction_fields``
(the ``sweep_scan`` kernel, or the fused field kernel under ``MAPD_FUSED``).

Wire (legacy JSON, always accepted):
      plan_request  {type, seq, agents:[{peer_id, pos:[x,y], goal:[x,y]}]}
      plan_response {type, seq, duration_micros,
                     moves:[{peer_id, next_pos:[x,y], goal:[x,y]}]}
Fast path (packed1, negotiated via the request's ``caps``, see
``runtime/plan_codec.py``): packed snapshots and deltas; the fleet lives on
the device between ticks (pos/goal/slot/active at capacity) and a delta
scatters in only the changed lanes; a seq gap makes the daemon publish
``plan_snapshot_request``.  The daemon loop is pipelined: request k+1 is
decoded and its delta scattered before the outputs of step k are fetched.
PyTorch tensors are mutable where JAX arrays are not, so every write that a
pending step could see is made safe: the resident lane scatter is out of
place (a new tensor per write), the host mirrors are copied into a
dispatched plan's baselines, a step returns new tensors only
(``solver.step.step_parallel``), and the in-place writes of packed field
rows are ordered after every read of the step by the device stream.

Multi-tenant mode (``--tenants ns,..`` and/or ``--multi-tenant``): many
namespaced fleets (``JG_BUS_NS``) share one daemon, one device-resident
``[tenants, lanes]`` slab and one field cache; every tenant that asked in a
burst is answered by one super-step, the tenant rows folded into one lane
axis of the step (``solver/step.py``).  Replies are byte-identical to the
JAX multi-tenant daemon's.  ``--multi-tenant`` also admits tenants that
announce themselves with ``tenant_hello`` on ``solver.admit``.

Dynamic worlds (``world_update`` frames) repair stale cached rows as the
JAX daemon does: incrementally from host distance mirrors
(``ops.field_repair``; ``JG_DYNAMIC_WORLD=1`` keeps mirrors from the start,
unset from the first accepted toggle), or by a full recompute where no
mirror exists or the dirty region overflows.  ``JG_SECTOR=1`` plans fresh
goals on corridors of the sector graph (``ops.sector``) instead of full
sweeps.  Both run their window sweeps through ``sweep_scan`` on the card.

Mesh mode (``--mesh N`` or ``--mesh AxT``, or ``JG_SOLVER_MESH``; with or
without tenants): the field cache, the lanes and the tenant slab are laid
out over a mesh of devices of this one process
(``parallel/solver_mesh.py``): the cache's rows over the agent shards, the
sweeps of a fresh batch split over them (and banded over the tiles), the
step's next hops read where the rows live.  Replies stay byte-identical to
the single-device daemon's.  On ``--cpu`` the mesh is virtual (every shard
on the CPU); on the card it takes A*T CUDA devices and exits 2 when there
are fewer, unless ``JG_SOLVER_MESH_VIRTUAL=1`` lays every shard on
``cuda:0`` (a virtual mesh of one card, which measures what the mesh costs
there, not how it scales).  A malformed spec exits 2; ``1`` and ``1x1``
are the flat path.

Usage: python -m p2p_distributed_tswap_tpu_torch.runtime.solverd
           [--port 7400] [--map FILE] [--capacity-min 16] [--warm N]
           [--trace] [--cpu] [--mesh N|AxT] [--solver-topic T]
           [--audit-ns NS]
           [--tenants NS,.. | --multi-tenant] [--max-tenants 64]
           [--tenant-lanes 65536] [--tenant-idle-ms 2000]

It plans on ``cuda`` unless ``--cpu`` is passed, and exits non-zero
without CUDA.  The kernels are built, and ``--warm N`` sweeps N field rows
and runs one step at capacity(N), before the ``solverd up`` banner, so the
first ticks of a fleet never wait on ``nvcc``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import sys
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.obs import HeartbeatWriter, registry, trace
from p2p_distributed_tswap_tpu_torch.obs import audit as obs_audit
from p2p_distributed_tswap_tpu_torch.obs import events as obs_events
from p2p_distributed_tswap_tpu_torch.obs import flightrec
from p2p_distributed_tswap_tpu_torch.obs.beacon import MetricsBeacon
from p2p_distributed_tswap_tpu_torch.obs.heartbeat import TICK_BUDGET_MS
from p2p_distributed_tswap_tpu_torch.ops import field_fused
from p2p_distributed_tswap_tpu_torch.ops import field_repair
from p2p_distributed_tswap_tpu_torch.ops import sector
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    DIR_DXDY,
    DIR_STAY,
    PACKED_STAY,
    direction_fields,
    directions_from_distance,
    distance_fields,
    pack_directions,
    packed_cells,
)
from p2p_distributed_tswap_tpu_torch.parallel import solver_mesh
from p2p_distributed_tswap_tpu_torch.parallel import virtual_mesh
from p2p_distributed_tswap_tpu_torch.parallel.mesh import Sharded, replicate
from p2p_distributed_tswap_tpu_torch.runtime import busns
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pcodec
from p2p_distributed_tswap_tpu_torch.solver.mapd import resolve_device
from p2p_distributed_tswap_tpu_torch.solver.step import step_parallel

_I32 = torch.int32
# Dynamic tenant admission: an un-namespaced orchestrator announces
# tenants here (tenant_hello -> tenant_welcome).
ADMIT_TOPIC = "solver.admit"
# Frames the multi-tenant loop drains behind the first of a burst.
TENANT_DRAIN_MAX = 256


def _pad_pow2_chunk(min_chunk: int, *arrays):
    """Pad parallel per-lane arrays to the next power-of-two chunk >=
    ``min_chunk`` with duplicate writes of entry 0 (same values ->
    idempotent): the resident scatter's lane batches, as in the JAX
    package."""
    m = len(arrays[0])
    chunk = min_chunk
    while chunk < m:
        chunk *= 2
    if chunk == m:
        return arrays
    pad = chunk - m
    return tuple(np.concatenate([a, np.full(pad, a[0], a.dtype)])
                 for a in arrays)


class FieldQueueEntry:
    """One queued field sweep: its cause (``fresh_goal`` -- a lane is
    parked on the STAY row waiting for it; ``prime`` -- a manager prefetch
    hint; ``repair`` -- a world toggle invalidated the cached row) and the
    queue clock at enqueue time, for the starvation age bound."""

    __slots__ = ("cause", "enq")

    def __init__(self, cause: str, enq: int):
        self.cause = cause
        self.enq = enq


def parse_world_update(data: dict) -> Optional[List[Tuple[int, bool]]]:
    """``[(cell, blocked)]`` from a ``world_update`` message -- packed
    world1 block (``codec: packed1``) or the JSON ``toggles`` list; None on
    a malformed frame."""
    if data.get("codec") == pcodec.CODEC_NAME:
        try:
            pkt = pcodec.decode_b64(data.get("data") or "")
            return pcodec.decode_world(pkt)
        except pcodec.CodecError:
            return None
    raw = data.get("toggles")
    if not isinstance(raw, list):
        return None
    out = []
    for e in raw:
        try:
            out.append((int(e[0]), bool(e[1])))
        except (TypeError, ValueError, IndexError):
            return None
    return out


class PendingPlan:
    """A dispatched but unfetched step: the output tensors plus everything
    :meth:`PlanService.fetch` needs to finish the plan after host work has
    overlapped the device execution."""

    __slots__ = ("mode", "agents", "cap", "n", "new_pos", "new_goal",
                 "base_pos", "base_goal", "base_active",
                 "t_plan0", "t_sweep0", "t_disp0", "t_disp_end")


class PlanService:
    """Batched one-step planner with goal-field caching, on one device.

    Two request paths share the step and the field cache:

    - ``plan()`` / ``dispatch()``: the stateless legacy path -- the request
      carries the whole fleet (JSON wire).
    - ``resident_apply()`` + ``resident_dispatch()``: the packed fast path
      -- fleet state (pos/goal/slot/active) stays on the device between
      ticks and deltas scatter in O(churn) lanes.  Goals referenced by
      resident agents are pinned against LRU eviction via refcounts.
    """

    # Fresh-goal sweeps per chunk: new goals arrive a few per tick, so
    # chunks of 1, 2, 4 or 8 bound the padding waste; a burst loops chunks.
    FIELD_CHUNK = 8
    # Packed field-cache memory ceiling: rows are preallocated at the full
    # budget up front (the buffer grows only when live goals pin more).
    CACHE_BYTES = 256 << 20
    # Delta scatters pad to the next power of two at least this size.
    SCATTER_CHUNK_MIN = 8
    # Dynamic-world bounds: the toggle log compacts past this many entries
    # (every cached row is then stale and repairs on next touch), and
    # queued sweeps older than FIELD_QUEUE_MAX_AGE process_field_queue
    # calls jump the whole queue, so fresh-goal churn cannot starve them.
    WORLD_LOG_MAX = 4096
    FIELD_QUEUE_MAX_AGE = 8
    # Host repair-mirror budget: dist (int32) + dirs (uint8) = 5
    # bytes/cell/goal, unpacked.  A goal whose mirror is evicted keeps its
    # packed row; its next repair is one full recompute.
    MIRROR_BYTES = 256 << 20
    # Start-cell hints kept per goal for the sector planner: more distinct
    # lane positions in one corridor add sectors, not route information
    # (plan_goal folds at most sector.MAX_PLAN_STARTS per call; later
    # lanes re-enter lazily).
    SECTOR_HINTS_MAX = 64

    def __init__(self, grid: Grid, capacity_min: int = 16,
                 field_cache: int = 4096, device=None,
                 mesh: Optional["solver_mesh.SolverMesh"] = None):
        self.grid = grid
        # Mesh mode: the field cache and the lanes are laid out over a
        # mesh of devices and the step and sweeps run there; None is the
        # single-device path, and every mesh branch below is gated on it.
        # The replicated state lives on the mesh's lead device.
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self._step = step_parallel
        else:
            mesh.validate_grid(grid)
            self.device = mesh.lead
            self._step = mesh.make_step()
            self._mesh_fields = mesh.make_fields(grid)
            self._mesh_fields_dist = mesh.make_fields_dist(grid)
            # lane capacities divide over the agent shards; pow2 doubling
            # from a shard-multiple floor keeps the property
            capacity_min = mesh.round_lanes(capacity_min)
        self.capacity_min = capacity_min
        pc = packed_cells(grid.num_cells)
        self.max_fields = max(capacity_min,
                              min(field_cache, self.CACHE_BYTES // (4 * pc)))
        # goal cell -> row index into the dirs buffer
        self.goal_rows: "OrderedDict[int, int]" = OrderedDict()
        self.dirs: Optional[torch.Tensor] = None  # (rows, pc) packed int32
        # Dynamic world: obstacle cells toggle mid-run via world_update
        # frames.  JG_DYNAMIC_WORLD=0 ignores them (no bookkeeping at all);
        # =1 keeps dist/dirs host mirrors from the start, so the first
        # toggle already repairs incrementally; unset turns mirror-keeping
        # on at the first accepted update (rows swept before it then repair
        # by one full recompute each).
        env_dw = os.environ.get("JG_DYNAMIC_WORLD", "")
        self.dynamic_world = env_dw != "0"
        self.keep_dist = env_dw == "1"
        registry.get_registry().gauge("solverd.world_seq", 0)
        registry.get_registry().gauge("solverd.dynamic_world",
                                      1 if self.dynamic_world else 0)
        # injected-corruption test hook: lane -> (field, forced_value,
        # view), re-imposed after every state application
        self.corrupt: Dict[int, Tuple[str, int, str]] = {}
        self.free_np = np.asarray(grid.free).copy()
        self.free = torch.from_numpy(self.free_np.copy()).to(self.device)
        self.world_seq = 0
        self.world_log: List[int] = []      # toggled cells, in order
        self.dist_mirror: Dict[int, np.ndarray] = {}  # goal -> (H,W) i32
        self.dirs_mirror: Dict[int, np.ndarray] = {}  # goal -> (H,W) u8
        self.dist_seq: Dict[int, int] = {}  # goal -> log length at sweep
        self.max_mirrors = max(16, self.MIRROR_BYTES // (5 * grid.num_cells))
        # Sector planner: with JG_SECTOR=1 a fresh goal gets a corridor plan
        # instead of a full-grid sweep; unset, self.sector stays None and
        # no sector branch runs.  The planner holds free_np by reference:
        # apply_world_update mutates the mask in place, then repairs the
        # portal graph with apply_toggles.
        self.sector: Optional[sector.SectorPlanner] = None
        self.sector_hints: Dict[int, set] = {}  # goal -> start cells
        if sector.sector_enabled():
            self.sector = sector.SectorPlanner(self.free_np,
                                               device=self.device)
            registry.get_registry().gauge("solverd.sector_cells",
                                          self.sector.s)
        self.queue_clock = 0                # process_field_queue calls
        self._last_cap = 0
        # device-resident fleet state (packed fast path); host mirrors stay
        # in lockstep so responses and delta diffs never fetch the tensors
        self.r_cap = 0
        self.d_pos = self.d_goal = self.d_slot = self.d_active = None
        self.h_pos = np.zeros(0, np.int32)
        self.h_goal = np.zeros(0, np.int32)
        self.h_slot = np.zeros(0, np.int32)
        self.h_active = np.zeros(0, bool)
        self.goal_ref: Dict[int, int] = {}  # resident goal -> lane count
        # Deferred fields (packed fast path): a fresh goal whose field is
        # not cached yet parks its lane on the all-STAY row for a tick while
        # the sweep runs in the daemon's idle window (process_field_queue).
        # On by default on the CPU, where one sweep is a large share of the
        # 500 ms tick; JG_DEFER_FIELDS=1/0 overrides.
        env_defer = os.environ.get("JG_DEFER_FIELDS", "")
        if env_defer in ("0", "1"):
            self.defer_fields = env_defer == "1"
        else:
            self.defer_fields = self.device.type == "cpu"
        self.field_queue: "OrderedDict[int, FieldQueueEntry]" = OrderedDict()
        self.lane_wait: Dict[int, int] = {}   # lane -> goal it awaits
        self.wait_lanes: Dict[int, set] = {}  # goal -> waiting lanes
        # observability: cumulative counters + the last plan's per-phase
        # wall times; ``recompiles`` stays 0 (nothing here is compiled per
        # shape) and keeps its key in the stats
        self.cache_hits = 0
        self.cache_misses = 0
        self.recompiles = 0
        self.last_phase_ms: Dict[str, float] = {}

    def _capacity(self, n: int) -> int:
        c = self.capacity_min
        while c < n:
            c *= 2
        return c

    def _fields(self, goals: torch.Tensor) -> torch.Tensor:
        """(G, pc) packed rows of ``goals`` on the live mask (split over
        the mesh in mesh mode)."""
        if self.mesh is not None:
            return self._mesh_fields(self.free, goals)
        return pack_directions(
            direction_fields(self.free, goals).reshape(goals.shape[0], -1))

    def _fields_dist(self, goals: torch.Tensor) -> tuple:
        """The dynamic-world variant of :meth:`_fields`: the packed rows,
        and the (G, H, W) int32 distances and uint8 codes the host repair
        mirrors start from.  Always through the sweeps, ``MAPD_FUSED`` or
        not, as in the JAX package."""
        if self.mesh is not None:
            return self._mesh_fields_dist(self.free, goals)
        d = distance_fields(self.free, goals)
        dirs = directions_from_distance(d, self.free)
        return pack_directions(dirs.reshape(goals.shape[0], -1)), d, dirs

    def _rows_index(self, rows):
        if self.mesh is not None:  # the mesh routes host rows to blocks
            return np.asarray(rows, np.int64)
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def _drop_goal(self, g: int) -> int:
        """Evict one cached goal row: cache entry plus any dynamic-world
        host mirrors and sector plan.  Returns the freed row index."""
        row = self.goal_rows.pop(g)
        self.dist_mirror.pop(g, None)
        self.dirs_mirror.pop(g, None)
        self.dist_seq.pop(g, None)
        if self.sector is not None:
            self.sector.forget(g)
            self.sector_hints.pop(g, None)
        return row

    def _store_mirror(self, g: int, dist_row: np.ndarray,
                      dirs_row: np.ndarray) -> None:
        """Keep one goal's repair mirrors, within budget (oldest-first
        eviction; an evicted goal's next repair full-recomputes) and as
        copies."""
        if g not in self.dist_mirror:
            while len(self.dist_mirror) >= self.max_mirrors:
                victim = next(iter(self.dist_mirror))
                self.dist_mirror.pop(victim)
                self.dirs_mirror.pop(victim, None)
                registry.get_registry().count("solverd.mirror_evictions")
        self.dist_mirror[g] = np.array(dist_row)
        self.dirs_mirror[g] = np.array(dirs_row)

    def _write_rows(self, rows, packed_np: np.ndarray) -> None:
        """Write host-packed uint32 rows (repairs, corridor plans) into
        the cache rows ``rows``, in place (see :meth:`_sweep_into_rows`);
        the device words are int32 with the same bits."""
        self.dirs[self._rows_index(rows)] = torch.from_numpy(
            np.ascontiguousarray(packed_np).view(np.int32)).to(self.device)

    def _sweep_into_rows(self, goals: List[int], rows: List[int]) -> None:
        """Sweep ``goals`` in pow2 chunks no larger than FIELD_CHUNK and
        write their packed rows into ``rows`` with one scatter, in place
        (the step never writes ``dirs``, and the device stream orders this
        write after every read of a step already dispatched).  Shared by
        the fresh-sweep path and the repair recompute.  In dynamic mode
        the host repair mirrors record per goal; with the sector planner
        on, goals it can corridor-plan never reach the full sweep
        (:meth:`_sector_sweep` peels them off first)."""
        if self.sector is not None:
            goals, rows = self._sector_sweep(goals, rows)
            if not goals:
                return
        parts = []
        o, c = 0, self.FIELD_CHUNK
        while o < len(goals):
            rem = len(goals) - o
            take = c if rem >= c else rem
            size = c if rem >= c else 1 << (take - 1).bit_length()
            chunk = goals[o:o + take]
            padded = chunk + [chunk[-1]] * (size - take)
            gvec = torch.tensor(padded, dtype=_I32, device=self.device)
            if self.keep_dist:
                packed, dist, dirs = self._fields_dist(gvec)
                parts.append(packed[:take])
                dist_np = dist[:take].cpu().numpy()
                dirs_np = dirs[:take].cpu().numpy()
                for j, g in enumerate(chunk):
                    self._store_mirror(g, dist_np[j], dirs_np[j])
            else:
                parts.append(self._fields(gvec)[:take])
            o += take
        for g in goals:
            self.dist_seq[g] = len(self.world_log)
        fields = parts[0] if len(parts) == 1 else torch.cat(parts)
        self.dirs[self._rows_index(rows)] = fields

    # -- hierarchical sector planning ---------------------------------------

    def _sector_hint(self, goal: int, pos: int) -> None:
        """Record one lane position as a corridor start for ``goal``'s
        next sector plan (no-op when the planner is off or the goal is the
        STAY pseudo-goal)."""
        if self.sector is None or goal == -1:
            return
        hs = self.sector_hints.setdefault(int(goal), set())
        if len(hs) < self.SECTOR_HINTS_MAX:
            hs.add(int(pos))

    def _sector_sweep(self, goals: List[int], rows: List[int]
                      ) -> Tuple[List[int], List[int]]:
        """Corridor-plan as many of ``goals`` as the planner can (consuming
        the start hints recorded at state-application time), write their
        packed rows in one scatter, and return the remainder for the
        full-sweep path.  A goal with no recorded start falls back to the
        full sweep (``solverd.sector_fallbacks``): that row is whole-grid
        exact."""
        reg = registry.get_registry()
        rem_g: List[int] = []
        rem_r: List[int] = []
        srows: List[int] = []
        packed: List[np.ndarray] = []
        for g, r in zip(goals, rows):
            starts = self.sector_hints.pop(g, ())
            plan = self.sector.plan_goal(g, starts)
            if plan is None:
                rem_g.append(g)
                rem_r.append(r)
                reg.count("solverd.sector_fallbacks")
                continue
            srows.append(r)
            packed.append(plan.packed)
            self.dist_seq[g] = len(self.world_log)
            reg.count("solverd.sector_routes")
            reg.observe("solverd.sector_plan_ms", self.sector.last_plan_ms)
        if srows:
            self._write_rows(srows, np.stack(packed))
        return rem_g, rem_r

    def _sector_reenter(self, goal: int, pos: int) -> None:
        """Extend ``goal``'s corridor when a lane reads STAY outside it:
        one plan_goal call folds the lane's cell (plus any hints banked
        since the last plan) into the existing corridor and rewrites the
        goal's cached row in place.  plan_goal plans against the live mask
        at the planner's current epoch, so a re-entry also heals
        staleness and the world stamp advances."""
        if self.sector is None or not self.sector.manages(goal):
            return
        if not self.sector.needs_reentry(goal, pos):
            return
        starts = self.sector_hints.pop(goal, set()) | {int(pos)}
        plan = self.sector.plan_goal(goal, starts)
        if plan is None:
            return
        self.dist_seq[goal] = len(self.world_log)
        reg = registry.get_registry()
        reg.count("solverd.sector_reentries")
        reg.observe("solverd.sector_plan_ms", self.sector.last_plan_ms)
        self._write_rows([self.goal_rows[goal]], plan.packed[None])

    def _is_stale(self, g: int) -> bool:
        """A cached row swept before the latest world toggle no longer
        matches the live mask (static runs: never)."""
        if not self.world_log or g == -1:
            return False
        return self.dist_seq.get(g, -1) < len(self.world_log)

    def _ensure_fields(self, goals: List[int], min_rows: int = 0) -> None:
        missing = [g for g in dict.fromkeys(goals) if g not in self.goal_rows]
        rows_budget = max(self.max_fields,
                          self._capacity(max(len(goals), min_rows)))
        if self.dirs is None or self.dirs.shape[0] < rows_budget:
            self._grow_dirs(rows_budget)
        if not missing:
            self._repair_stale(goals)
            return
        # evict LRU rows when over budget -- never a goal of the current
        # request nor one a resident agent references (goal_ref pin; it
        # also covers the all-STAY pseudo-goal row, key -1)
        keep = set(goals)
        while len(self.goal_rows) + len(missing) > self.dirs.shape[0]:
            victim = next((g for g in self.goal_rows
                           if self.goal_ref.get(g, 0) == 0
                           and g not in keep), None)
            if victim is None:
                break
            self._drop_goal(victim)
        if len(self.goal_rows) + len(missing) > self.dirs.shape[0]:
            # every cached row is pinned by live goals: grow the buffer
            self._grow_dirs(self._capacity(len(self.goal_rows)
                                           + len(missing)))
        used = set(self.goal_rows.values())
        free_rows = [r for r in range(self.dirs.shape[0]) if r not in used]
        rows = free_rows[:len(missing)]
        self._sweep_into_rows(missing, rows)
        for g, r in zip(missing, rows):
            self.goal_rows[g] = r
        self._repair_stale(goals)

    def _repair_stale(self, goals: List[int]) -> None:
        stale = [g for g in dict.fromkeys(goals)
                 if g in self.goal_rows and self._is_stale(g)]
        if stale:
            self._repair_goals(stale)

    def _repair_goals(self, goals: List[int]) -> None:
        """Bring stale cached rows up to the live mask: bounded-region
        incremental repair (``ops.field_repair``, big windows swept on the
        service's device) where a dist mirror and the toggle suffix exist,
        a full recompute otherwise or when the dirty region overflows.  One
        scatter for every repaired packed row."""
        reg = registry.get_registry()
        rows, packed_rows = [], []
        fallback = []
        h, _w = self.free_np.shape
        for g in goals:
            if g not in self.goal_rows or not self._is_stale(g):
                continue
            seq = self.dist_seq.get(g, -1)
            mirror = self.dist_mirror.get(g)
            res = None
            if mirror is not None and 0 <= seq <= len(self.world_log):
                t0 = time.perf_counter()
                res = field_repair.repair_field(mirror, self.free_np,
                                                self.world_log[seq:],
                                                device=self.device)
                reg.observe("solverd.field_repair_ms",
                            1000.0 * (time.perf_counter() - t0))
            if res is None:
                fallback.append(g)
                continue
            new_dist, (y0, y1, x0, x1) = res
            # direction codes change only where distances (or their row
            # neighbours') did: re-derive the band, repack the whole row on
            # the host
            b0, b1 = max(0, y0 - 1), min(h, y1 + 1)
            dirs_m = self.dirs_mirror[g]
            if b1 > b0:
                dirs_m[b0:b1] = field_repair.directions_np(
                    new_dist, self.free_np, b0, b1)
            self.dist_mirror[g] = new_dist
            self.dist_seq[g] = len(self.world_log)
            rows.append(self.goal_rows[g])
            packed_rows.append(field_repair.pack_rows_np(
                dirs_m.reshape(-1)))
            reg.count("solverd.field_repairs")
            reg.count("solverd.field_sweeps", cause="repair")
        if rows:
            self._write_rows(rows, np.stack(packed_rows))
        if fallback:
            # full recompute repairs: recompute into the SAME rows (the
            # fresh-sweep path would allocate new ones), then re-mirror
            reg.count("solverd.field_repair_fallbacks", len(fallback))
            reg.count("solverd.field_sweeps", len(fallback),
                      cause="repair")
            self._sweep_into_rows(fallback,
                                  [self.goal_rows[g] for g in fallback])

    # -- stateless legacy path (JSON wire) --------------------------------

    def dispatch(self, agents: List[Tuple[str, int, int]]) -> PendingPlan:
        """Start one step for an explicit fleet; returns the unfetched
        output tensors (see :class:`PendingPlan`)."""
        n = len(agents)
        cap = self._capacity(n)
        t_plan0 = time.perf_counter()
        goals = [g for _, _, g in agents]
        if self.sector is not None:
            # cached goals get a corridor re-entry check for each agent
            # position; fresh ones bank the positions as corridor starts
            # for the sweep below
            for _, p, g in agents:
                if g in self.goal_rows:
                    self._sector_reenter(g, int(p))
                else:
                    self._sector_hint(g, int(p))
        with trace.span("solverd.cache_lookup", agents=n,
                        parent="solverd.tick"):
            # counts hits/misses and LRU-touches cached request goals
            # FIRST so eviction inside _ensure_fields can only hit goals
            # absent from this request
            misses = self._count_cache(goals)
        t_sweep0 = time.perf_counter()
        if misses:
            registry.get_registry().count("solverd.field_sweeps", misses,
                                          cause="fresh_goal")
        with trace.span("solverd.field_sweep", fresh_goals=misses,
                        parent="solverd.tick"):
            self._ensure_fields(goals)
        t_disp0 = time.perf_counter()
        with trace.span("solverd.step_dispatch", capacity=cap,
                        parent="solverd.tick"):
            cfg = SolverConfig(height=self.grid.height, width=self.grid.width,
                               num_agents=cap)
            pos = np.zeros(cap, np.int32)
            goal = np.zeros(cap, np.int32)
            slot = np.zeros(cap, np.int32)
            active = np.zeros(cap, bool)
            # agents map onto cached field rows via the slot indirection;
            # padded lanes reuse row 0 but are masked inactive
            for k, (_, p, g) in enumerate(agents):
                pos[k], goal[k], slot[k] = p, g, self.goal_rows[g]
                active[k] = True
            new_pos, new_goal, _ = self._step(
                cfg, self._upload(pos), self._upload(goal),
                self._upload(slot), self.dirs, self._upload(active))
        p = PendingPlan()
        p.mode = "legacy"
        p.agents = agents
        p.cap, p.n = cap, n
        p.new_pos, p.new_goal = new_pos, new_goal
        p.base_pos = p.base_goal = p.base_active = None
        p.t_plan0, p.t_sweep0, p.t_disp0 = t_plan0, t_sweep0, t_disp0
        p.t_disp_end = time.perf_counter()
        return p

    def fetch(self, p: PendingPlan):
        """Wait for the outputs of a dispatched step and finish the plan.
        Legacy mode returns ``[(peer_id, next_cell, goal_cell)]``; resident
        mode returns ``(lanes, next_cells, goal_cells)`` int32 arrays
        holding only the lanes that moved or changed goal."""
        t_sync0 = time.perf_counter()
        with trace.span("solverd.device_sync", parent="solverd.tick"):
            new_pos = p.new_pos.cpu().numpy()
            new_goal = p.new_goal.cpu().numpy()
        t_end = time.perf_counter()
        self._last_cap = p.cap
        self.last_phase_ms = {
            "cache_lookup": 1000.0 * (p.t_sweep0 - p.t_plan0),
            "field_sweep": 1000.0 * (p.t_disp0 - p.t_sweep0),
            "step_dispatch": 1000.0 * (p.t_disp_end - p.t_disp0),
            "device_sync": 1000.0 * (t_end - t_sync0),
        }
        if p.mode == "legacy":
            return [(p.agents[k][0], int(new_pos[k]), int(new_goal[k]))
                    for k in range(p.n)]
        changed = p.base_active & ((new_pos != p.base_pos)
                                   | (new_goal != p.base_goal))
        lanes = np.flatnonzero(changed).astype(np.int32)
        return (lanes, new_pos[lanes].astype(np.int32),
                new_goal[lanes].astype(np.int32))

    def plan(self, agents: List[Tuple[str, int, int]]
             ) -> List[Tuple[str, int, int]]:
        """agents: [(peer_id, pos_cell, goal_cell)] ->
        [(peer_id, next_cell, goal_cell)] after one TSWAP step."""
        return self.fetch(self.dispatch(agents))

    # -- device-resident fast path (packed wire) --------------------------

    def _upload(self, np_arr) -> torch.Tensor:
        """Host -> device copy of a per-lane vector.  Always a copy: on the
        CPU ``torch.from_numpy`` would share memory with the host mirror
        that later deltas write in place."""
        return torch.from_numpy(np.array(np_arr)).to(self.device)

    def _lane_put(self, np_arr):
        """Host -> device upload of a per-lane vector, laid out over the
        agent shards in mesh mode."""
        if self.mesh is None:
            return self._upload(np_arr)
        return self.mesh.pin_lanes(np.array(np_arr))

    def _resident_grow(self, lanes_needed: int) -> None:
        cap = self._capacity(max(lanes_needed, 1))
        if cap <= self.r_cap:
            return
        pad = cap - self.r_cap
        self.h_pos = np.concatenate([self.h_pos, np.zeros(pad, np.int32)])
        self.h_goal = np.concatenate([self.h_goal, np.zeros(pad, np.int32)])
        self.h_slot = np.concatenate([self.h_slot, np.zeros(pad, np.int32)])
        self.h_active = np.concatenate([self.h_active, np.zeros(pad, bool)])
        if self.mesh is not None:
            self.r_cap = cap
            self._resident_grow_mesh(pad)
            return
        dev = self.device
        if self.d_pos is None:
            self.d_pos = torch.zeros(cap, dtype=_I32, device=dev)
            self.d_goal = torch.zeros(cap, dtype=_I32, device=dev)
            self.d_slot = torch.zeros(cap, dtype=_I32, device=dev)
            self.d_active = torch.zeros(cap, dtype=torch.bool, device=dev)
        else:
            zi = torch.zeros(pad, dtype=_I32, device=dev)
            self.d_pos = torch.cat([self.d_pos, zi])
            self.d_goal = torch.cat([self.d_goal, zi])
            self.d_slot = torch.cat([self.d_slot, zi])
            self.d_active = torch.cat(
                [self.d_active, torch.zeros(pad, dtype=torch.bool,
                                            device=dev)])
        self.r_cap = cap

    def _resident_grow_mesh(self, pad: int) -> None:
        """Mesh mode of the lane growth: the grown lanes laid out over the
        agent shards again (growth is rare, O(log N) per fleet)."""
        if self.d_pos is None:
            self.d_pos = self._lane_put(np.zeros(self.r_cap, np.int32))
            self.d_goal = self._lane_put(np.zeros(self.r_cap, np.int32))
            self.d_slot = self._lane_put(np.zeros(self.r_cap, np.int32))
            self.d_active = self._lane_put(np.zeros(self.r_cap, bool))
            return
        lead = self.device
        grown = []
        for x in (self.d_pos, self.d_goal, self.d_slot, self.d_active):
            x = replicate(x, lead)
            grown.append(self.mesh.pin_lanes(torch.cat(
                [x, torch.zeros(pad, dtype=x.dtype, device=lead)])))
        self.d_pos, self.d_goal, self.d_slot, self.d_active = grown

    def _ref_goal(self, goal: int, delta: int) -> None:
        r = self.goal_ref.get(goal, 0) + delta
        if r > 0:
            self.goal_ref[goal] = r
        else:
            self.goal_ref.pop(goal, None)

    def _count_cache(self, goals: List[int]) -> int:
        uniq = dict.fromkeys(goals)
        misses = sum(1 for g in uniq if g not in self.goal_rows)
        hits = len(uniq) - misses
        self.cache_hits += hits
        self.cache_misses += misses
        trace.count("solverd.field_cache_hits", hits)
        trace.count("solverd.field_cache_misses", misses)
        for g in goals:
            if g in self.goal_rows:
                self.goal_rows.move_to_end(g)
        return misses

    def _grow_dirs(self, rows: int) -> None:
        """Reallocate the dirs buffer at ``rows`` capacity, preserving
        existing rows."""
        pc = packed_cells(self.grid.num_cells)
        old = self.dirs
        if self.mesh is not None:
            # the row count divides over the agent shards
            rows = self.mesh.round_rows(rows)
            self.dirs = Sharded.full(self.mesh.mesh, (rows, pc), PACKED_STAY,
                                     _I32, self.mesh.row_spec)
            if old is not None:
                self.dirs[:old.shape[0]] = old.gather()
            return
        self.dirs = torch.full((rows, pc), PACKED_STAY, dtype=_I32,
                               device=self.device)
        if old is not None:
            self.dirs[:old.shape[0]] = old

    def _stay_row(self) -> int:
        """The permanent all-STAY row (pseudo-goal key -1, pinned): lanes
        whose field is still being swept park here for a tick or two."""
        row = self.goal_rows.get(-1)
        if row is not None:
            return row
        if self.dirs is None:
            self._ensure_fields([])  # allocates the dirs buffer
        used = set(self.goal_rows.values())
        row = next((r for r in range(self.dirs.shape[0]) if r not in used),
                   None)
        if row is None:
            # cache saturated: evict an unpinned LRU goal, else grow
            victim = next((g for g in self.goal_rows
                           if self.goal_ref.get(g, 0) == 0), None)
            if victim is not None:
                row = self._drop_goal(victim)
            else:
                row = self.dirs.shape[0]
                self._grow_dirs(self._capacity(row + 1))
        # a reused (previously evicted) row still holds its old field --
        # the reserved row must genuinely say STAY everywhere
        self.dirs[row] = PACKED_STAY
        self.goal_rows[-1] = row
        self.goal_ref[-1] = 1  # never evicted, never swept
        return row

    def _unwait(self, lane: int) -> None:
        g = self.lane_wait.pop(lane, None)
        if g is not None:
            s = self.wait_lanes.get(g)
            if s is not None:
                s.discard(lane)
                if not s:
                    del self.wait_lanes[g]

    def _queue_goal(self, goal: int, cause: str,
                    front: bool = False) -> None:
        """Enqueue (or re-prioritize) one idle-window sweep.  A goal
        already queued keeps its original enqueue clock but upgrades to
        ``fresh_goal`` when a lane starts waiting on it."""
        e = self.field_queue.get(goal)
        if e is None:
            self.field_queue[goal] = FieldQueueEntry(cause,
                                                     self.queue_clock)
        elif cause == "fresh_goal":
            e.cause = cause
        if front:
            self.field_queue.move_to_end(goal, last=False)

    def _queue_gauges(self) -> None:
        reg = registry.get_registry()
        reg.gauge("solverd.field_queue", len(self.field_queue))
        reg.gauge("solverd.field_queue_max_age",
                  max((self.queue_clock - e.enq
                       for e in self.field_queue.values()), default=0))

    def _pop_field_queue(self, budget: int
                         ) -> List[Tuple[int, FieldQueueEntry]]:
        """Pop up to ``budget`` queued sweeps, oldest-starved first: an
        entry older than FIELD_QUEUE_MAX_AGE process calls jumps the whole
        queue."""
        self.queue_clock += 1
        aged = [g for g, e in self.field_queue.items()
                if self.queue_clock - e.enq > self.FIELD_QUEUE_MAX_AGE]
        # promote oldest to the very front (front-insertion reverses, so
        # iterate youngest-first)
        for g in sorted(aged, key=lambda g: self.field_queue[g].enq,
                        reverse=True):
            self.field_queue.move_to_end(g, last=False)
        if aged:
            registry.get_registry().count("solverd.field_queue_promotions",
                                          len(aged))
        popped = []
        while self.field_queue and len(popped) < budget:
            popped.append(self.field_queue.popitem(last=False))
        self._queue_gauges()
        return popped

    def _sweep_popped(self, popped) -> None:
        """Idle-window work for popped queue entries: sweep the missing
        rows, repair the stale ones, count per cause."""
        reg = registry.get_registry()
        missing = [g for g, _ in popped if g not in self.goal_rows]
        by_cause: Dict[str, int] = {}
        for g, e in popped:
            # cached-but-stale entries are counted by _repair_goals
            if g not in self.goal_rows:
                by_cause[e.cause] = by_cause.get(e.cause, 0) + 1
        for cause, n in by_cause.items():
            if cause != "repair":
                reg.count("solverd.field_sweeps", n, cause=cause)
        if missing:
            with trace.span("solverd.field_prefetch", goals=len(missing)):
                self._ensure_fields(missing, min_rows=len(self.goal_ref))
            reg.count("solverd.prefetched_fields", len(missing))
        self._repair_stale([g for g, _ in popped])

    def _slot_of(self, lane: int, goal: int,
                 pos: Optional[int] = None) -> int:
        """Field row for a lane's goal; with deferred fields on, a missing
        row parks the lane on the STAY row and queues the sweep at the
        front of the queue.  A stale cached row serves as-is (the STAY
        safety patch keeps it wall-legal) with its repair queued.  ``pos``
        (when the caller knows it) feeds the sector planner: a corridor
        start hint for a goal not yet planned, a re-entry check for one
        that is."""
        self._unwait(lane)
        if pos is not None:
            self._sector_hint(goal, pos)
        row = self.goal_rows.get(goal)
        if row is not None:
            if pos is not None:
                self._sector_reenter(goal, int(pos))
            if self._is_stale(goal):
                self._queue_goal(goal, "repair")
            return row
        self.lane_wait[lane] = goal
        self.wait_lanes.setdefault(goal, set()).add(lane)
        self._queue_goal(goal, "fresh_goal", front=True)
        return self._stay_row()

    def prefetch_goals(self, cells) -> None:
        """Queue future goals (manager hints: e.g. delivery cells at task
        assignment) for the idle-window sweep."""
        for g in cells:
            try:
                g = int(g)
            except (TypeError, ValueError):
                continue
            if 0 <= g < self.grid.num_cells and g not in self.goal_rows \
                    and g not in self.field_queue:
                self._queue_goal(g, "prime")
        self._queue_gauges()

    def process_field_queue(self, max_goals: Optional[int] = None) -> int:
        """Sweep up to one chunk of queued goal fields (the daemon's idle
        window, not the tick path) and release lanes parked on the STAY
        row.  Returns goals processed."""
        if not self.field_queue:
            return 0
        budget = max_goals or self.FIELD_CHUNK
        popped_entries = self._pop_field_queue(budget)
        self._sweep_popped(popped_entries)
        popped = [g for g, _ in popped_entries]
        # release waiters of EVERY popped goal: a goal can enter goal_rows
        # through another request path while queued
        lanes, slots = [], []
        for g in popped:
            for lane in sorted(self.wait_lanes.pop(g, ())):
                if self.lane_wait.get(lane) == g and self.h_active[lane] \
                        and int(self.h_goal[lane]) == g:
                    del self.lane_wait[lane]
                    lanes.append(lane)
                    slots.append(self.goal_rows[g])
                else:
                    self.lane_wait.pop(lane, None)
        if lanes:
            la = np.asarray(lanes, np.int32)
            vs = np.asarray(slots, np.int32)
            self.h_slot[la] = vs
            self._scatter_lanes(la, self.h_pos[la].copy(),
                                self.h_goal[la].copy(), vs,
                                self.h_active[la].copy())
        return len(popped)

    # -- dynamic world ------------------------------------------------------

    def apply_world_update(self, toggles: List[Tuple[int, bool]]) -> int:
        """Fold one obstacle-toggle batch into the live mask.

        Returns the number of cells whose state actually changed.  Per
        accepted batch: the host and device masks update, every cached row
        gets a STAY safety patch (no stale field points an agent into a
        newly blocked cell before its repair lands), pinned cached goals
        enqueue ``repair`` sweeps for the idle window, and unpinned rows
        repair on next touch."""
        if not self.dynamic_world:
            return 0
        flat = self.free_np.reshape(-1)
        changed = []
        for c, blocked in toggles:
            c = int(c)
            if not 0 <= c < self.grid.num_cells:
                continue
            if bool(flat[c]) != (not blocked):
                flat[c] = not blocked
                changed.append((c, bool(blocked)))
        if not changed:
            return 0
        self.world_seq += 1
        self.keep_dist = True
        if len(self.world_log) + len(changed) > self.WORLD_LOG_MAX:
            # log compaction: every cached row becomes stale and repairs
            # on next touch
            self.world_log = []
            self.dist_seq = {}
            registry.get_registry().count("solverd.world_log_compactions")
        self.world_log.extend(c for c, _ in changed)
        self.free = torch.from_numpy(self.free_np.copy()).to(self.device)
        if self.sector is not None:
            # the mask already mutated in place above: repair the portal
            # graph (dirty sectors and their neighbours); corridor plans
            # re-derive through the staleness and repair queue below
            t0 = time.perf_counter()
            n_sect = self.sector.apply_toggles([c for c, _ in changed])
            reg_s = registry.get_registry()
            reg_s.count("solverd.sector_rebuilds", n_sect)
            reg_s.observe("solverd.sector_repair_ms",
                          1000.0 * (time.perf_counter() - t0))
        newly_blocked = [c for c, b in changed if b]
        if newly_blocked and self.dirs is not None:
            self._stay_patch(newly_blocked)
        for g in list(self.goal_rows):
            if g != -1 and self.goal_ref.get(g, 0) > 0 \
                    and self._is_stale(g):
                self._queue_goal(g, "repair")
        self._queue_gauges()
        reg = registry.get_registry()
        reg.count("solverd.world_toggles", len(changed))
        reg.gauge("solverd.world_seq", self.world_seq)
        return len(changed)

    def _stay_patch(self, blocked_cells: List[int]) -> None:
        """Wall-safety overlay on every cached packed row: a newly blocked
        cell's own code becomes STAY, and any neighbour whose code points
        into it becomes STAY.  One gather and one scatter of the affected
        words across all rows; the nibbles are patched on a uint32 view of
        the host copy (the device words are int32 with the same bits)."""
        h, w = self.free_np.shape
        # word index -> [(nibble, required_code | None)]; None forces STAY
        words: Dict[int, list] = {}
        for c in blocked_cells:
            words.setdefault(c >> 3, []).append((c & 7, None))
            cy, cx = divmod(c, w)
            for k, (dx, dy) in enumerate(DIR_DXDY):
                nx, ny = cx - dx, cy - dy  # neighbor whose code k lands on c
                if 0 <= nx < w and 0 <= ny < h:
                    n = ny * w + nx
                    words.setdefault(n >> 3, []).append((n & 7, k))
        cols = sorted(words)
        col_idx = self._rows_index(cols)
        cur = self.dirs[:, col_idx].cpu().numpy().copy().view(np.uint32)
        stay = np.uint32(DIR_STAY)
        for j, wi in enumerate(cols):
            for nib, req in words[wi]:
                shift = np.uint32(4 * nib)
                keep = np.uint32(0xFFFFFFFF) ^ (np.uint32(0xF) << shift)
                vals = (cur[:, j] >> shift) & np.uint32(0xF)
                hit = np.ones(cur.shape[0], bool) if req is None \
                    else vals == req
                patched = (cur[:, j] & keep) | (stay << shift)
                cur[:, j] = np.where(hit, patched, cur[:, j])
        self.dirs[:, col_idx] = torch.from_numpy(cur.view(np.int32)).to(
            self.device)
        # host dirs mirrors get the same overlay (a repair re-derives the
        # exact band from the repaired distances later)
        for dirs_m in self.dirs_mirror.values():
            flat = dirs_m.reshape(-1)
            for c in blocked_cells:
                flat[c] = DIR_STAY
                cy, cx = divmod(c, w)
                for k, (dx, dy) in enumerate(DIR_DXDY):
                    nx, ny = cx - dx, cy - dy
                    if 0 <= nx < w and 0 <= ny < h:
                        n = ny * w + nx
                        if flat[n] == k:
                            flat[n] = DIR_STAY

    # -- audit plane --------------------------------------------------------

    def set_corruption(self, lane: int, field: str = "goal",
                       delta: int = 1, view: str = "both") -> bool:
        """Register one sticky single-lane corruption (test hook for the
        injected-corruption drill): ``field`` of ``lane`` is forced to its
        current true value + ``delta`` after every state application.
        ``view`` = "both" corrupts host mirror and device, "device" the
        device lanes only."""
        lane = int(lane)
        if field not in ("pos", "goal") or view not in ("both", "device"):
            return False
        if lane >= self.r_cap or not self.h_active[lane]:
            return False
        true = int((self.h_pos if field == "pos" else self.h_goal)[lane])
        self.corrupt[lane] = (field, true + int(delta), view)
        registry.get_registry().count("solverd.audit_corruptions")
        self._apply_corruption()
        return True

    def _apply_corruption(self) -> None:
        for lane, (field, value, view) in self.corrupt.items():
            if lane >= self.r_cap or not self.h_active[lane]:
                continue
            if view != "device":
                (self.h_pos if field == "pos" else self.h_goal)[lane] = value
            vp = int(self.h_pos[lane])
            vg = int(self.h_goal[lane])
            if view == "device":
                if field == "pos":
                    vp = value
                else:
                    vg = value
            self._scatter_lanes(np.asarray([lane], np.int32),
                                np.asarray([vp], np.int32),
                                np.asarray([vg], np.int32),
                                np.asarray([int(self.h_slot[lane])],
                                           np.int32),
                                np.asarray([True]))

    def audit_views(self, view: str):
        """``(lanes, pos, goal)`` active-lane arrays of one audited view
        ("mirror" = host arrays, "device" = a pull of the device lanes)."""
        if view == "device" and self.d_pos is not None:
            da = self.d_active.cpu().numpy()
            pos = self.d_pos.cpu().numpy()
            goal = self.d_goal.cpu().numpy()
        else:
            da, pos, goal = self.h_active, self.h_pos, self.h_goal
        act = np.flatnonzero(da)
        return act, pos[act], goal[act]

    def _scatter_lanes(self, lanes, vp, vg, vs, va) -> None:
        """O(churn) device update of the resident lanes, out of place: each
        write makes new tensors, so a step dispatched earlier -- and any
        output tensor it returned -- never sees a later delta."""
        m = len(lanes)
        lanes, vp, vg, vs, va = _pad_pow2_chunk(
            self.SCATTER_CHUNK_MIN, lanes, vp, vg, vs, va)
        idx = (torch.from_numpy(lanes.astype(np.int64)).to(self.device),)
        self.d_pos = self.d_pos.index_put(idx, self._upload(vp))
        self.d_goal = self.d_goal.index_put(idx, self._upload(vg))
        self.d_slot = self.d_slot.index_put(idx, self._upload(vs))
        self.d_active = self.d_active.index_put(idx, self._upload(va))
        registry.get_registry().count("solverd.resident_scatter_lanes", m)

    def _ensure_rows_or_defer(self, goals: List[int]) -> None:
        """Inline sweep for fresh goals -- unless deferred fields are on,
        in which case the tick path never sweeps (lanes park on the STAY
        row via _slot_of and the idle window catches up)."""
        misses = self._count_cache(goals)
        if self.defer_fields:
            return
        if misses:
            registry.get_registry().count("solverd.field_sweeps", misses,
                                          cause="fresh_goal")
        with trace.span("solverd.field_sweep", fresh_goals=misses,
                        parent="solverd.tick"):
            self._ensure_fields(goals, min_rows=len(self.goal_ref))

    def resident_apply(self, upd: "pcodec.DecodedUpdate") -> int:
        """Fold one decoded snapshot/delta into the resident fleet state;
        returns the number of lanes written."""
        reg = registry.get_registry()
        if upd.is_snapshot:
            lanes = upd.idx.astype(np.int64)
            self._resident_grow(int(lanes.max()) + 1 if lanes.size
                                else self.capacity_min)
            self.h_active[:] = False
            self.h_pos[:] = 0
            self.h_goal[:] = 0
            self.h_slot[:] = 0
            stay_pin = self.goal_ref.get(-1)
            self.goal_ref = {} if stay_pin is None else {-1: stay_pin}
            self.lane_wait = {}
            self.wait_lanes = {}
            goals = [int(g) for g in upd.goal]
            for g in goals:
                self._ref_goal(g, +1)
            if self.sector is not None:
                # corridor starts must be banked BEFORE the sweep below
                # plans the fresh goals
                for p, g in zip(upd.pos, goals):
                    self._sector_hint(g, int(p))
            self._ensure_rows_or_defer(goals)
            self.h_pos[lanes] = upd.pos
            self.h_goal[lanes] = upd.goal
            self.h_slot[lanes] = np.fromiter(
                (self._slot_of(int(l), g, int(p))
                 for l, g, p in zip(lanes, goals, upd.pos)),
                np.int32, len(goals))
            self.h_active[lanes] = True
            # a snapshot IS the O(N) resync: one full upload (copies)
            self.d_pos = self._lane_put(self.h_pos)
            self.d_goal = self._lane_put(self.h_goal)
            self.d_slot = self._lane_put(self.h_slot)
            self.d_active = self._lane_put(self.h_active)
            reg.count("solverd.snapshots_applied")
            self._apply_corruption()
            return int(lanes.size)
        # delta: one final value per lane (a lane can be vacated AND
        # re-assigned to a new peer in the same packet -- last write wins,
        # matching PackedStateDecoder order)
        final: Dict[int, Optional[Tuple[int, int]]] = {}
        for lane in upd.removed:
            final[int(lane)] = None
        for lane, p, g in zip(upd.idx, upd.pos, upd.goal):
            final[int(lane)] = (int(p), int(g))
        if not final:
            return 0
        self._resident_grow(max(final) + 1)
        goals = []
        for lane, v in final.items():
            if self.h_active[lane]:
                self._ref_goal(int(self.h_goal[lane]), -1)
            if v is not None:
                self._ref_goal(v[1], +1)
                goals.append(v[1])
                self._sector_hint(v[1], v[0])
        self._ensure_rows_or_defer(goals)
        m = len(final)
        lanes = np.fromiter(final.keys(), np.int32, m)
        vp = np.zeros(m, np.int32)
        vg = np.zeros(m, np.int32)
        vs = np.zeros(m, np.int32)
        va = np.zeros(m, bool)
        for k, (lane, v) in enumerate(final.items()):
            if v is None:
                self._unwait(lane)
                continue
            vp[k], vg[k] = v
            vs[k] = self._slot_of(lane, v[1], v[0])
            va[k] = True
        self.h_pos[lanes] = vp
        self.h_goal[lanes] = vg
        self.h_slot[lanes] = vs
        self.h_active[lanes] = va
        self._scatter_lanes(lanes, vp, vg, vs, va)
        self._apply_corruption()
        return m

    def resident_dispatch(self) -> Optional[PendingPlan]:
        """Start one step over the device-resident fleet; None if no lanes
        are active."""
        n = int(self.h_active.sum())
        if n == 0:
            return None
        cap = self.r_cap
        t0 = time.perf_counter()
        with trace.span("solverd.step_dispatch", capacity=cap,
                        parent="solverd.tick"):
            cfg = SolverConfig(height=self.grid.height,
                               width=self.grid.width, num_agents=cap)
            new_pos, new_goal, _ = self._step(
                cfg, self.d_pos, self.d_goal, self.d_slot, self.dirs,
                self.d_active)
        p = PendingPlan()
        p.mode = "resident"
        p.agents = None
        p.cap, p.n = cap, n
        p.new_pos, p.new_goal = new_pos, new_goal
        # diff baselines: the resident mirrors AS OF this dispatch (the
        # pipelined loop may scatter the next delta before fetch())
        p.base_pos = self.h_pos.copy()
        p.base_goal = self.h_goal.copy()
        p.base_active = self.h_active.copy()
        p.t_plan0 = p.t_sweep0 = p.t_disp0 = t0
        p.t_disp_end = time.perf_counter()
        return p

    def resident_shard_bytes(self, extra=()) -> Dict[int, int]:
        """Bytes each mesh position holds of the planning state (the dirs
        cache, the lanes and ``extra``, e.g. the tenant slab's planes), as
        allocated: a virtual mesh holds every position's copy on its one
        device.  Empty on the flat path."""
        if self.mesh is None:
            return {}
        return self.mesh.shard_bytes(
            [self.dirs, self.d_pos, self.d_goal, self.d_slot,
             self.d_active, *extra])

    def update_mesh_gauges(self, extra=()) -> None:
        """Refresh the per-shard residency gauges (block sizes only, no
        device sync; a no-op on the flat path)."""
        per = self.resident_shard_bytes(extra)
        if not per:
            return
        reg = registry.get_registry()
        for k, b in per.items():
            reg.gauge("solverd.resident_bytes", b, shard=str(k))

    def mesh_stats(self) -> Optional[dict]:
        """The ``mesh`` entry of the stats (None on the flat path)."""
        if self.mesh is None:
            return None
        return {"shape": self.mesh.shape_str,
                "devices": self.mesh.n_devices,
                "resident_bytes": self.resident_shard_bytes()}


def apply_world_frame(service: PlanService, reg, data: dict) -> int:
    """One ``world_update`` frame into the service.  With
    JG_DYNAMIC_WORLD=0 the frame is counted and dropped."""
    if not service.dynamic_world:
        reg.count("solverd.world_updates_ignored")
        return 0
    toggles = parse_world_update(data)
    if toggles is None:
        reg.count("solverd.bad_packets")
        return 0
    n = service.apply_world_update(toggles)
    reg.count("solverd.world_updates")
    # epoch adoption: the frame carries the manager's monotone world_seq,
    # adopted so both sides' audit digests agree on the epoch
    ws = data.get("world_seq")
    if isinstance(ws, (int, float)) and int(ws) > service.world_seq:
        service.world_seq = int(ws)
        reg.gauge("solverd.world_seq", service.world_seq)
    if n:
        print(f"🌍 world_update (seq {data.get('world_seq')}): {n} "
              f"cell(s) toggled, {len(service.field_queue)} repair(s) "
              f"queued", flush=True)
    return n


# ---------------------------------------------------------------------------
# audit plane: digest entries, drill answering, corruption hook
# ---------------------------------------------------------------------------


def audit_entries(service: PlanService, seq: int
                  ) -> Tuple[list, dict]:
    """The daemon's audit-beacon body: host-mirror and device-pull lane
    digests at the last applied seq (their equality is the device/mirror
    consistency proof), plus the fresh field-cache cell digest keyed by
    the world epoch."""
    epoch = service.world_seq
    entries = []
    act, pos, goal = service.audit_views("mirror")
    d, n = obs_audit.lane_digest(act, pos, goal)
    entries.append(obs_audit.AuditEntry(obs_audit.SEC_MIRROR, n, seq,
                                        epoch, d))
    if service.d_pos is not None:
        dact, dpos, dgoal = service.audit_views("device")
        dd, dn = obs_audit.lane_digest(dact, dpos, dgoal)
        entries.append(obs_audit.AuditEntry(obs_audit.SEC_DEVICE, dn, seq,
                                            epoch, dd))
    fresh = [g for g in service.goal_rows
             if g != -1 and not service._is_stale(g)]
    fd, fn = obs_audit.cells_digest(fresh)
    entries.append(obs_audit.AuditEntry(obs_audit.SEC_FIELDS, fn, seq,
                                        epoch, fd))
    extra = {"dynamic_world": bool(service.dynamic_world),
             "epoch": epoch, "seq": seq}
    return entries, extra


def audit_drill_reply(service: PlanService, names, req: dict,
                      peer_id: str = "solverd") -> dict:
    """Range-digest (plus leaf rows) over one audited view of the resident
    fleet -- the solverd side of the bisect protocol."""
    view = req.get("view") or "mirror"
    act, pos, goal = service.audit_views(
        "device" if view == "device" else "mirror")
    return obs_audit.drill_answer(req, act, pos, goal, names=names,
                                  peer_id=peer_id)


def handle_audit_frame(data: dict, service: PlanService, names,
                       bus, reg, peer_id: str = "solverd") -> bool:
    """Audit-plane frame handling for the daemon loop (drill requests and
    the env-gated corruption hook).  Returns True when the frame was an
    audit frame (handled or deliberately ignored)."""
    typ = data.get("type")
    if typ == "audit_drill_request":
        if data.get("target") in ("solverd", peer_id):
            bus.publish(obs_audit.AUDIT_TOPIC,
                        audit_drill_reply(service, names, data,
                                          peer_id=peer_id), raw=True)
        return True
    if typ == "audit_corrupt":
        if not obs_audit.hooks_enabled():
            # never a silent no-op: a drill harness must see its injection
            # refused rather than wait for a divergence that cannot come
            reg.count("solverd.audit_corrupt_ignored")
            print("🧪 audit_corrupt ignored (JG_AUDIT_TEST_HOOKS unset)",
                  flush=True)
            return True
        ok = service.set_corruption(int(data.get("lane", -1)),
                                    data.get("field") or "goal",
                                    int(data.get("delta") or 1),
                                    data.get("view") or "both")
        print(f"🧪 audit_corrupt lane={data.get('lane')} "
              f"field={data.get('field') or 'goal'} "
              f"view={data.get('view') or 'both'} applied={ok}",
              flush=True)
        return True
    if typ in ("audit_beacon", "audit_drill_response"):
        return True  # other peers' audit traffic on the shared topic
    return False


class PendingTick:
    """A tick in flight between :meth:`TickRunner.begin` and
    :meth:`TickRunner.finish` (its step is dispatched, its response not
    yet encoded)."""

    __slots__ = ("req", "plan", "t_dispatched")


class TickRunner:
    """One solverd planning tick, decode -> plan -> encode -- as a plain
    synchronous callable (:meth:`handle`) or as the split :meth:`ingest` /
    :meth:`begin` / :meth:`finish` phases the pipelined daemon loop
    interleaves across requests.  Owns the tick span, the per-tick
    heartbeat line, and the on-demand stats snapshot."""

    def __init__(self, service: PlanService, grid: Grid,
                 heartbeat: Optional[HeartbeatWriter] = None,
                 budget_ms: float = TICK_BUDGET_MS):
        self.service = service
        self.grid = grid
        self.heartbeat = heartbeat
        self.budget_ms = budget_ms
        self.ticks = 0
        self.dropped_total = 0
        self.registry = registry.get_registry()
        self.packed = pcodec.PackedStateDecoder()
        self.snapshot_needed = False
        self._req: Optional[dict] = None

    MAX_LANES = 1 << 20  # sanity ceiling on roster lanes (1M agents)

    def _packet_sane(self, pkt) -> bool:
        """Range-validate a decoded request packet: lanes within the sane
        roster ceiling, cells within this grid."""
        for a in (pkt.idx, pkt.named_idx, pkt.removed):
            if a.size and (int(a.min()) < 0
                           or int(a.max()) >= self.MAX_LANES):
                return False
        n_cells = self.grid.num_cells
        for a in (pkt.pos, pkt.goal):
            if a.size and (int(a.min()) < 0 or int(a.max()) >= n_cells):
                return False
        return True

    def ingest(self, data: dict, stale: bool = False) -> bool:
        """Decode one plan_request and fold it into solver state.  Packed
        deltas are order-sensitive, so superseded (stale-drained) packed
        requests are still applied; stale JSON requests are skipped.
        Returns True when ``data`` became the request to plan."""
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        if data.get("codec") == pcodec.CODEC_NAME:
            with trace.span("solverd.request_decode", parent="solverd.tick"):
                try:
                    raw = base64.b64decode(data.get("data") or "",
                                           validate=True)
                    pkt = pcodec.decode(raw)
                except (ValueError, pcodec.CodecError):
                    self.registry.count("solverd.bad_packets")
                    return False
                if pkt.trace is not None:
                    # the receive side of the manager->solverd hop
                    obs_events.emit("plan.request",
                                    trace_id=pkt.trace.trace_id,
                                    hop=pkt.trace.hop,
                                    send_ms=pkt.trace.send_ms,
                                    seq=data.get("seq"))
                if not self._packet_sane(pkt):
                    self.registry.count("solverd.bad_packets")
                    return False
                self.registry.count("solverd.decode_bytes", len(raw))
                if pkt.kind == pcodec.KIND_DELTA:
                    self.registry.count("solverd.delta_agents",
                                        int(pkt.idx.size))
                    self.registry.gauge("solverd.last_delta_agents",
                                        int(pkt.idx.size))
                prev_names = ({n for n in self.packed.names
                               if n is not None} if pkt.names else None)
                try:
                    upd = self.packed.apply(pkt)
                except pcodec.SeqGapError as e:
                    self.snapshot_needed = True
                    self.registry.count("solverd.seq_gaps")
                    trace.instant("solverd.seq_gap", have=e.have_seq,
                                  base=e.base_seq)
                    return False
                if prev_names is not None:
                    # lane-admission attribution: a newly named lane is an
                    # admitted agent (cause=handoff for a cross-region
                    # transfer the manager flagged)
                    handoff_names = set(data.get("handoff_peers") or [])
                    for n in pkt.names:
                        if n not in prev_names:
                            self.registry.count(
                                "solverd.lanes_admitted",
                                cause=("handoff" if n in handoff_names
                                       else "fresh"))
                self.service.resident_apply(upd)
                # manager hints: sweep their fields in the idle window
                self.service.prefetch_goals(data.get("hints") or [])
            if stale:
                return False
            caps = data.get("caps") or []
            self._req = {"mode": "packed", "seq": data.get("seq"),
                         "caps": caps, "t0": t0, "t0_ns": t0_ns,
                         "tc": pkt.trace, "t_dec": time.perf_counter()}
            if pcodec.CODEC_NAME not in caps:
                # JSON-response fallback: the pipelined loop ingests
                # request k+1 (mutating the roster) before finishing k,
                # so the names are captured as of THIS request
                self._req["names"] = list(self.packed.names)
            return True
        if stale:
            return False  # stateless wire: only the newest matters
        with trace.span("solverd.request_decode", parent="solverd.tick"):
            agents = []
            w = self.grid.width
            for e in data.get("agents", []):
                px, py = e["pos"]
                gx, gy = e["goal"]
                agents.append((e["peer_id"], py * w + px, gy * w + gx))
        if not agents:
            self._req = None
            return False
        json_tc = obs_events.parse_tc(data)
        if json_tc is not None:
            obs_events.emit("plan.request", trace_id=json_tc[0],
                            hop=json_tc[1], send_ms=json_tc[2],
                            seq=data.get("seq"))
            json_tc = pcodec.TraceCtx(*json_tc)
        self._req = {"mode": "json", "seq": data.get("seq"),
                     "agents": agents, "t0": t0, "t0_ns": t0_ns,
                     "tc": json_tc, "t_dec": time.perf_counter()}
        return True

    def begin(self) -> Optional[PendingTick]:
        """Dispatch the step for the last ingested request."""
        r, self._req = self._req, None
        if r is None:
            return None
        if r["mode"] == "json":
            plan = self.service.dispatch(r["agents"])
        else:
            plan = self.service.resident_dispatch()
            if plan is None:
                return None
        p = PendingTick()
        p.req, p.plan = r, plan
        p.t_dispatched = time.perf_counter()
        return p

    def finish(self, pending: PendingTick,
               pipelined: bool = False) -> Optional[dict]:
        """Fetch the step outputs, encode and return the plan_response."""
        r, plan = pending.req, pending.plan
        t_fetch0 = time.perf_counter()
        # host time that ran concurrently with the device step
        overlap_ms = 1000.0 * (t_fetch0 - pending.t_dispatched)
        self.registry.observe("solverd.pipeline_overlap_ms", overlap_ms)
        result = self.service.fetch(plan)
        t_plan = time.perf_counter()
        # busy time only: decode+dispatch plus fetch
        us = int(1e6 * ((pending.t_dispatched - r["t0"])
                        + (t_plan - t_fetch0)))
        with trace.span("solverd.reply_encode", parent="solverd.tick"):
            w = self.grid.width
            # echo the request's trace context one hop on
            resp_tc = None
            req_tc = r.get("tc")
            if req_tc is not None and obs_events.ctx_enabled():
                resp_tc = req_tc.next_hop()
            if r["mode"] == "json":
                resp = {
                    "type": "plan_response",
                    "seq": r["seq"],
                    "duration_micros": us,
                    "moves": [{"peer_id": pid,
                               "next_pos": [c % w, c // w],
                               "goal": [g % w, g // w]}
                              for pid, c, g in result],
                }
                if resp_tc is not None:
                    resp["tc"] = [resp_tc.trace_id, resp_tc.hop,
                                  resp_tc.send_ms]
            else:
                lanes, npos, ngoal = result
                if pcodec.CODEC_NAME in r["caps"]:
                    rpkt = pcodec.encode_response(r["seq"], lanes, npos,
                                                  ngoal)
                    rpkt.trace = resp_tc
                    resp = {
                        "type": "plan_response",
                        "seq": r["seq"],
                        "codec": pcodec.CODEC_NAME,
                        "duration_micros": us,
                        "data": pcodec.encode_b64(rpkt),
                    }
                else:
                    # packed request from a peer that cannot read packed
                    # responses: answer on the legacy wire via the roster
                    # as of this request
                    names = r.get("names") or []
                    moves = []
                    for lane, c, g in zip(lanes, npos, ngoal):
                        pid = names[int(lane)] \
                            if 0 <= int(lane) < len(names) else None
                        if pid is None:
                            continue
                        moves.append({"peer_id": pid,
                                      "next_pos": [int(c) % w, int(c) // w],
                                      "goal": [int(g) % w, int(g) // w]})
                    resp = {"type": "plan_response", "seq": r["seq"],
                            "duration_micros": us, "moves": moves}
                    if resp_tc is not None:
                        resp["tc"] = [resp_tc.trace_id, resp_tc.hop,
                                      resp_tc.send_ms]
        t_end = time.perf_counter()
        self.ticks += 1
        total_ms = 1000.0 * (t_end - r["t0"])
        # the tick span is stamped retroactively (pipelined phases of one
        # tick interleave with other requests' work)
        trace.complete("solverd.tick",
                       r["t0_ns"], time.perf_counter_ns() - r["t0_ns"],
                       seq=r["seq"], pipelined=pipelined)
        self.registry.observe("tick_ms", total_ms)
        if total_ms > self.budget_ms:
            self.registry.count("tick.over_budget")
        self.registry.gauge("tick.agents", plan.n)
        # mesh residency gauges: block sizes only, no device sync (a flat
        # service returns at once)
        self.service.update_mesh_gauges()
        if self.heartbeat is not None:
            phase_ms = dict(self.service.last_phase_ms)
            phase_ms["decode"] = 1000.0 * (r["t_dec"] - r["t0"])
            phase_ms["encode"] = 1000.0 * (t_end - t_plan)
            if pipelined:
                phase_ms["overlap"] = overlap_ms
            phase_ms["total"] = total_ms
            self.heartbeat.beat(r["seq"], plan.n, phase_ms,
                                counters=trace.snapshot()["counters"])
            trace.flush()
        return resp

    def handle(self, data: dict) -> Optional[dict]:
        """plan_request dict -> plan_response dict (None for empty fleets
        or non-planning packets): the synchronous decode->plan->encode
        path of tests and simple drivers."""
        if data.get("type") == "world_update":
            self.handle_world(data)
            return None
        pending = self.begin() if self.ingest(data) else None
        if pending is None:
            return None
        return self.finish(pending)

    def handle_world(self, data: dict) -> int:
        """Dynamic-world toggle frame: see :func:`apply_world_frame`."""
        return apply_world_frame(self.service, self.registry, data)

    def stats(self) -> dict:
        """Machine-readable daemon state: tracer snapshot + service view."""
        svc = self.service
        snap = trace.snapshot()
        snap["service"] = {
            "ticks": self.ticks,
            "dropped_stale": self.dropped_total,
            "cache_hits": svc.cache_hits,
            "cache_misses": svc.cache_misses,
            "cached_fields": len(svc.goal_rows),
            "max_fields": svc.max_fields,
            "recompiles": svc.recompiles,
            "capacity": svc._last_cap,
            "resident_lanes": int(svc.h_active.sum()),
            "resident_capacity": svc.r_cap,
            "packed_last_seq": self.packed.last_seq,
            "defer_fields": svc.defer_fields,
            "field_queue": len(svc.field_queue),
            "deferred_lanes": len(svc.lane_wait),
            "dynamic_world": svc.dynamic_world,
            "world_seq": svc.world_seq,
            "world_log": len(svc.world_log),
            "dist_mirrors": len(svc.dist_mirror),
            "mesh": svc.mesh_stats(),
            "last_phase_ms": {k: round(v, 3)
                              for k, v in svc.last_phase_ms.items()},
        }
        if self.heartbeat is not None:
            snap["service"]["over_budget_ticks"] = \
                self.heartbeat.over_budget_ticks
        snap["network"] = self.registry.network_summary()
        return snap


# ---------------------------------------------------------------------------
# multi-tenant serving: one super-step for many namespaced fleets
# ---------------------------------------------------------------------------
#
# Each tenant (a whole fleet behind a bus namespace, runtime/busns.py) gets
# one ROW of a [T_cap, L_cap] device-resident super-batch, pow2-padded on
# both axes like the single-tenant lane padding.  One step plans EVERY
# tenant's lanes per tick burst: the rows are folded into one lane axis of
# T_cap * L_cap agents (``step_parallel(..., tenants=T_cap)``), with one
# occupancy plane per row, so two tenants' agents can occupy the same cell
# of their separate worlds without interacting.  The direction-field cache
# is SHARED across tenants (all of them run the same grid, so tenant B hits
# the rows tenant A swept), with the refcount pinning counting every
# tenant's resident goals.


class Tenant:
    """One admitted fleet: its slab row, packed-delta decoder chain and
    admission bookkeeping."""

    __slots__ = ("ns", "topic", "row", "decoder", "last_req_ms",
                 "admitted_ms", "resyncs", "snapshot_needed")

    def __init__(self, ns: str, row: int):
        self.ns = ns
        self.topic = busns.wire_topic(ns, "solver")
        self.row = row
        self.decoder = pcodec.PackedStateDecoder()
        self.last_req_ms = time.monotonic() * 1000.0
        self.admitted_ms = self.last_req_ms
        self.resyncs = 0
        self.snapshot_needed = False


class PendingSuper:
    """A dispatched but unfetched super-step: its output tensors plus the
    per-tenant requests (and per-row diff baselines) its replies need.
    Baselines are captured per REQUESTING row at dispatch time, so a row
    evicted and reassigned while the step is in flight is never diffed
    against another tenant's state."""

    __slots__ = ("new_pos", "new_goal", "bases", "reqs", "t0",
                 "t_disp_end", "lanes")


class TenantSlab:
    """[T_cap, L_cap] device-resident fleet state for many tenants,
    sharing one :class:`PlanService`'s direction-field cache (dirs rows,
    goal refcount pins, deferred-field queue).  The service's own flat
    single-tenant resident state stays untouched: the daemon runs one mode
    or the other.  Every device write is out of place (a new tensor), so a
    dispatched step never sees a later delta, and every upload copies the
    host mirrors."""

    def __init__(self, service: PlanService, grid: Grid,
                 tenant_lanes: int = 1 << 16):
        self.service = service
        self.grid = grid
        self.tenant_lanes = tenant_lanes  # per-tenant lane budget
        self.T_cap = 0
        self.L_cap = 0
        self.h_pos = np.zeros((0, 0), np.int32)
        self.h_goal = np.zeros((0, 0), np.int32)
        self.h_slot = np.zeros((0, 0), np.int32)
        self.h_active = np.zeros((0, 0), bool)
        self.d_pos = self.d_goal = self.d_slot = self.d_active = None
        self.rows_used: set = set()
        # deferred-field parking, keyed (row, lane): the slab analog of
        # PlanService.lane_wait/wait_lanes
        self.lane_wait: Dict[Tuple[int, int], int] = {}
        self.wait_lanes: Dict[int, set] = {}
        self._mesh_step = None  # the mesh's super-step, built on first use

    # -- geometry ---------------------------------------------------------
    def _grow(self, rows: int, lanes: int) -> None:
        """Ensure capacity for ``rows`` tenant rows x ``lanes`` lanes;
        pow2 padding on both axes, full re-upload on growth (rare,
        O(log) times over a fleet's life; deltas never come here)."""
        cap_t = max(self.T_cap, 1)
        while cap_t < rows:
            cap_t *= 2
        cap_l = max(self.L_cap, self.service.capacity_min)
        while cap_l < lanes:
            cap_l *= 2
        if cap_t <= self.T_cap and cap_l <= self.L_cap and self.T_cap:
            return
        grown = np.zeros((cap_t, cap_l), np.int32)
        grown[:self.h_pos.shape[0], :self.h_pos.shape[1]] = self.h_pos
        g_goal = np.zeros((cap_t, cap_l), np.int32)
        g_goal[:self.h_goal.shape[0], :self.h_goal.shape[1]] = self.h_goal
        g_slot = np.zeros((cap_t, cap_l), np.int32)
        g_slot[:self.h_slot.shape[0], :self.h_slot.shape[1]] = self.h_slot
        g_act = np.zeros((cap_t, cap_l), bool)
        g_act[:self.h_active.shape[0], :self.h_active.shape[1]] = \
            self.h_active
        self.h_pos, self.h_goal = grown, g_goal
        self.h_slot, self.h_active = g_slot, g_act
        self.T_cap, self.L_cap = cap_t, cap_l
        self._upload()
        registry.get_registry().gauge("solverd.slab_lanes", cap_t * cap_l)

    def _upload(self) -> None:
        """Full host->device resync (growth/admission/eviction: the
        structural edges; steady-state deltas use the row scatter).  In
        mesh mode the planes split over the lane axis."""
        mesh = self.service.mesh
        up = self.service._upload if mesh is None else mesh.pin_slab
        self.d_pos = up(self.h_pos)
        self.d_goal = up(self.h_goal)
        self.d_slot = up(self.h_slot)
        self.d_active = up(self.h_active)

    def alloc_row(self) -> int:
        row = next((r for r in range(self.T_cap)
                    if r not in self.rows_used), None)
        if row is None:
            row = self.T_cap
            self._grow(self.T_cap + 1, max(self.L_cap, 1))
        self.rows_used.add(row)
        return row

    def free_row(self, row: int) -> None:
        """Evict a tenant's row: unpin its goals, clear its deferred
        parking, zero host + device state."""
        for lane in np.flatnonzero(self.h_active[row]):
            self.service._ref_goal(int(self.h_goal[row, lane]), -1)
        for key in [k for k in self.lane_wait if k[0] == row]:
            g = self.lane_wait.pop(key)
            s = self.wait_lanes.get(g)
            if s is not None:
                s.discard(key)
                if not s:
                    del self.wait_lanes[g]
        self.h_pos[row] = 0
        self.h_goal[row] = 0
        self.h_slot[row] = 0
        self.h_active[row] = False
        self._row_set(row)
        self.rows_used.discard(row)

    # -- device writes (out of place) -------------------------------------
    def _put(self, index, vp, vg, vs, va) -> None:
        up = self.service._upload
        self.d_pos = self.d_pos.index_put(index, up(vp))
        self.d_goal = self.d_goal.index_put(index, up(vg))
        self.d_slot = self.d_slot.index_put(index, up(vs))
        self.d_active = self.d_active.index_put(index, up(va))

    def _row_set(self, row: int) -> None:
        """Device row <- host mirror row (snapshot / eviction)."""
        if self.d_pos is None:
            return
        index = (torch.tensor([row], device=self.service.device),)
        self._put(index, self.h_pos[row], self.h_goal[row],
                  self.h_slot[row], self.h_active[row])

    def _scatter_row_lanes(self, row, lanes, vp, vg, vs, va) -> None:
        """O(churn) device update of one tenant row, pow2-chunk-padded
        (the 2-D analog of PlanService._scatter_lanes; the shared
        _pad_pow2_chunk keeps the padding invariant identical)."""
        m = len(lanes)
        lanes, vp, vg, vs, va = _pad_pow2_chunk(
            PlanService.SCATTER_CHUNK_MIN, lanes, vp, vg, vs, va)
        li = torch.from_numpy(lanes.astype(np.int64)).to(self.service.device)
        self._put((torch.full_like(li, row), li), vp, vg, vs, va)
        registry.get_registry().count("solverd.resident_scatter_lanes", m)

    # -- deferred fields (slab flavor) ------------------------------------
    def _unwait(self, row: int, lane: int) -> None:
        g = self.lane_wait.pop((row, lane), None)
        if g is not None:
            s = self.wait_lanes.get(g)
            if s is not None:
                s.discard((row, lane))
                if not s:
                    del self.wait_lanes[g]

    def _slot_of(self, row: int, lane: int, goal: int,
                 pos: Optional[int] = None) -> int:
        """Field row for a lane's goal; a missing row parks the lane on
        the shared STAY row and front-queues the sweep (a waiting agent
        outranks speculative prefetch).  Stale rows (world toggle since
        their sweep) queue a repair, like the flat path -- which also owns
        the sector planner: hints and re-entry route through the shared
        service, so corridors fold starts across tenants."""
        svc = self.service
        self._unwait(row, lane)
        if pos is not None:
            svc._sector_hint(goal, pos)
        r = svc.goal_rows.get(goal)
        if r is not None:
            if pos is not None:
                svc._sector_reenter(goal, int(pos))
            if svc._is_stale(goal):
                svc._queue_goal(goal, "repair")
            return r
        self.lane_wait[(row, lane)] = goal
        self.wait_lanes.setdefault(goal, set()).add((row, lane))
        svc._queue_goal(goal, "fresh_goal", front=True)
        return svc._stay_row()

    def _ensure_rows_or_defer(self, goals: List[int]) -> None:
        svc = self.service
        misses = svc._count_cache(goals)
        if svc.defer_fields:
            return
        if misses:
            registry.get_registry().count("solverd.field_sweeps", misses,
                                          cause="fresh_goal")
        with trace.span("solverd.field_sweep", fresh_goals=misses,
                        parent="solverd.tick"):
            svc._ensure_fields(goals, min_rows=len(svc.goal_ref))

    def process_field_queue(self, max_goals: Optional[int] = None) -> int:
        """Idle-window sweep of queued goal fields + repair of slab lanes
        parked on the STAY row (the multi-tenant analog of
        PlanService.process_field_queue; popping, ageing promotion and
        per-cause counting are the SHARED service helpers)."""
        svc = self.service
        if not svc.field_queue:
            return 0
        budget = max_goals or PlanService.FIELD_CHUNK
        popped_entries = svc._pop_field_queue(budget)
        svc._sweep_popped(popped_entries)
        popped = [g for g, _ in popped_entries]
        by_row: Dict[int, List[Tuple[int, int]]] = {}
        for g in popped:
            for key in sorted(self.wait_lanes.pop(g, ())):
                row, lane = key
                if self.lane_wait.get(key) == g \
                        and self.h_active[row, lane] \
                        and int(self.h_goal[row, lane]) == g:
                    del self.lane_wait[key]
                    by_row.setdefault(row, []).append(
                        (lane, svc.goal_rows[g]))
                else:
                    self.lane_wait.pop(key, None)
        for row, pairs in by_row.items():
            la = np.asarray([p[0] for p in pairs], np.int32)
            vs = np.asarray([p[1] for p in pairs], np.int32)
            self.h_slot[row, la] = vs
            self._scatter_row_lanes(row, la, self.h_pos[row, la].copy(),
                                    self.h_goal[row, la].copy(), vs,
                                    self.h_active[row, la].copy())
        return len(popped)

    # -- state application ------------------------------------------------
    def apply(self, row: int, upd: "pcodec.DecodedUpdate") -> int:
        """Fold one decoded snapshot/delta into tenant ``row``'s slab
        slice (the multi-tenant port of PlanService.resident_apply);
        returns lanes written."""
        svc = self.service
        reg = registry.get_registry()
        if upd.is_snapshot:
            lanes = upd.idx.astype(np.int64)
            top = int(lanes.max()) + 1 if lanes.size else 1
            self._grow(max(len(self.rows_used), row + 1), top)
            for lane in np.flatnonzero(self.h_active[row]):
                svc._ref_goal(int(self.h_goal[row, lane]), -1)
            for key in [k for k in self.lane_wait if k[0] == row]:
                self._unwait(*key)
            self.h_active[row] = False
            self.h_pos[row] = 0
            self.h_goal[row] = 0
            self.h_slot[row] = 0
            goals = [int(g) for g in upd.goal]
            for g in goals:
                svc._ref_goal(g, +1)
            if svc.sector is not None:
                for p, g in zip(upd.pos, goals):
                    svc._sector_hint(g, int(p))
            self._ensure_rows_or_defer(goals)
            self.h_pos[row, lanes] = upd.pos
            self.h_goal[row, lanes] = upd.goal
            self.h_slot[row, lanes] = np.fromiter(
                (self._slot_of(row, int(l), g, int(p))
                 for l, g, p in zip(lanes, goals, upd.pos)),
                np.int32, len(goals))
            self.h_active[row, lanes] = True
            self._row_set(row)  # a snapshot IS the O(fleet) row resync
            reg.count("solverd.snapshots_applied")
            return int(lanes.size)
        # delta: one final value per lane, last write wins (a lane can be
        # vacated AND re-assigned in the same packet)
        final: Dict[int, Optional[Tuple[int, int]]] = {}
        for lane in upd.removed:
            final[int(lane)] = None
        for lane, p, g in zip(upd.idx, upd.pos, upd.goal):
            final[int(lane)] = (int(p), int(g))
        if not final:
            return 0
        self._grow(max(len(self.rows_used), row + 1), max(final) + 1)
        goals = []
        for lane, v in final.items():
            if self.h_active[row, lane]:
                svc._ref_goal(int(self.h_goal[row, lane]), -1)
            if v is not None:
                svc._ref_goal(v[1], +1)
                goals.append(v[1])
                svc._sector_hint(v[1], v[0])
        self._ensure_rows_or_defer(goals)
        m = len(final)
        lanes = np.fromiter(final.keys(), np.int32, m)
        vp = np.zeros(m, np.int32)
        vg = np.zeros(m, np.int32)
        vs = np.zeros(m, np.int32)
        va = np.zeros(m, bool)
        for k, (lane, v) in enumerate(final.items()):
            if v is None:
                self._unwait(row, lane)
                continue
            vp[k], vg[k] = v
            vs[k] = self._slot_of(row, lane, v[1], v[0])
            va[k] = True
        self.h_pos[row, lanes] = vp
        self.h_goal[row, lanes] = vg
        self.h_slot[row, lanes] = vs
        self.h_active[row, lanes] = va
        self._scatter_row_lanes(row, lanes, vp, vg, vs, va)
        return m

    # -- planning ---------------------------------------------------------
    def dispatch(self, reqs: Dict[str, dict],
                 rows: Dict[str, int]) -> Optional[PendingSuper]:
        """One folded device step over the WHOLE slab (every admitted
        tenant's lanes, responders and idlers alike: the step is
        stateless w.r.t. resident pos, so stepping a tenant without a
        pending request costs only masked compute); ``reqs`` maps tenant
        ns -> its ingested request, ``rows`` its slab row (the rows that
        get responses).  The step's outputs are never written back into
        the slab: the next delta carries the positions the fleet
        adopted."""
        n = int(self.h_active.sum())
        if n == 0 or not reqs:
            return None
        t0 = time.perf_counter()
        with trace.span("solverd.step_dispatch", capacity=self.L_cap,
                        tenants=len(self.rows_used),
                        parent="solverd.tick"):
            shape = (self.T_cap, self.L_cap)
            cfg = SolverConfig(height=self.grid.height,
                               width=self.grid.width,
                               num_agents=self.T_cap * self.L_cap)
            if self.service.mesh is None:
                new_pos, new_goal, _ = step_parallel(
                    cfg, self.d_pos.reshape(-1), self.d_goal.reshape(-1),
                    self.d_slot.reshape(-1), self.service.dirs,
                    self.d_active.reshape(-1), tenants=self.T_cap)
            else:
                # the tenant fold on the mesh: the planes gathered on the
                # lead, the next hops read from the row-split cache
                if self._mesh_step is None:
                    self._mesh_step = self.service.mesh.make_slab_step()
                new_pos, new_goal, _ = self._mesh_step(
                    cfg, self.d_pos, self.d_goal, self.d_slot,
                    self.service.dirs, self.d_active)
        p = PendingSuper()
        p.new_pos = new_pos.reshape(shape)
        p.new_goal = new_goal.reshape(shape)
        p.bases = {ns: (row, self.h_pos[row].copy(),
                        self.h_goal[row].copy(),
                        self.h_active[row].copy())
                   for ns, row in rows.items()}
        p.reqs = reqs
        p.lanes = n
        p.t0 = t0
        p.t_disp_end = time.perf_counter()
        reg = registry.get_registry()
        reg.gauge("solverd.superbatch_tenants", len(reqs))
        reg.gauge("solverd.superbatch_lanes", n)
        return p

    def fetch(self, p: PendingSuper) -> Tuple[np.ndarray, np.ndarray]:
        """Block on the super-step outputs; per-tenant diffs are cut by
        the runner against the dispatch-time baselines."""
        with trace.span("solverd.device_sync", parent="solverd.tick"):
            return p.new_pos.cpu().numpy(), p.new_goal.cpu().numpy()


class MultiTenantRunner:
    """Admission, ingest and response encoding for the tenant slab.

    The daemon loop feeds it raw bus frames (wire topics: this runner and
    the slab are the only tenant-AWARE layer; managers and agents run
    unmodified behind their namespaces).  ``publish`` abstracts the bus so
    tests can drive the runner against a list."""

    def __init__(self, slab: TenantSlab, grid: Grid,
                 publish, max_tenants: int = 64,
                 idle_evict_ms: float = 2000.0,
                 heartbeat: Optional[HeartbeatWriter] = None,
                 budget_ms: float = TICK_BUDGET_MS):
        self.slab = slab
        self.grid = grid
        self.publish = publish
        self.max_tenants = max_tenants
        self.idle_evict_ms = idle_evict_ms
        self.heartbeat = heartbeat
        self.budget_ms = budget_ms
        self.tenants: Dict[str, Tenant] = {}
        self.pending_reqs: Dict[str, dict] = {}
        self.registry = registry.get_registry()
        self.ticks = 0
        self.dropped_total = 0
        # the last finished super-step's ms: dispatch, device sync, encode
        self.last_phase_ms: Dict[str, float] = {}

    MAX_LANES = TickRunner.MAX_LANES

    # -- admission / eviction --------------------------------------------
    def ensure_tenant(self, ns: str) -> Optional[Tenant]:
        t = self.tenants.get(ns)
        if t is not None:
            return t
        if len(self.tenants) >= self.max_tenants:
            victim = self._evictable()
            if victim is None:
                # everyone is actively planning: refuse rather than
                # thrash (the caller's requests drop until a slot idles)
                self.registry.count("solverd.tenant_admission_rejected")
                return None
            self.evict(victim, reason="lru")
        t = Tenant(ns, self.slab.alloc_row())
        self.tenants[ns] = t
        self.registry.count("solverd.tenant_admissions")
        self.registry.gauge("solverd.tenants", len(self.tenants))
        print(f"🏷️  tenant {ns or '<default>'} admitted "
              f"(row {t.row}, {len(self.tenants)} resident)", flush=True)
        return t

    def _evictable(self) -> Optional[Tenant]:
        """The least-recently-active tenant idle past the threshold."""
        now_ms = time.monotonic() * 1000.0
        idle = [t for t in self.tenants.values()
                if now_ms - t.last_req_ms >= self.idle_evict_ms]
        if not idle:
            return None
        return min(idle, key=lambda t: t.last_req_ms)

    def evict(self, t: Tenant, reason: str = "manual") -> None:
        """Release a tenant's device memory; its bus subscription stays,
        and the next plan_request re-admits it with a fresh decoder, whose
        seq gap triggers the plan_snapshot_request resync, so the manager
        (the system of record) rebuilds the row losslessly."""
        self.slab.free_row(t.row)
        self.tenants.pop(t.ns, None)
        self.pending_reqs.pop(t.ns, None)
        self.registry.count("solverd.tenant_evictions")
        self.registry.gauge("solverd.tenants", len(self.tenants))
        self.publish(t.topic, {"type": "tenant_evicted", "ns": t.ns,
                               "reason": reason})
        print(f"🏷️  tenant {t.ns or '<default>'} evicted ({reason}); "
              f"re-admission will snapshot-resync", flush=True)

    # -- ingest -----------------------------------------------------------
    def _packet_sane(self, pkt) -> bool:
        for a in (pkt.idx, pkt.named_idx, pkt.removed):
            if a.size and (int(a.min()) < 0
                           or int(a.max()) >= min(self.MAX_LANES,
                                                  self.slab.tenant_lanes)):
                return False
        n_cells = self.grid.num_cells
        for a in (pkt.pos, pkt.goal):
            if a.size and (int(a.min()) < 0 or int(a.max()) >= n_cells):
                return False
        return True

    def ingest(self, ns: str, data: dict, stale: bool = False) -> bool:
        """Decode one tenant's plan_request into its slab row.  Packed
        deltas are order-sensitive, so superseded requests still apply
        (``stale=True``); returns True when ``data`` became the tenant's
        request to answer this burst."""
        if data.get("codec") != pcodec.CODEC_NAME:
            # multi-tenant mode is packed-wire only, and an unservable
            # request must not ADMIT (a legacy-JSON manager would evict a
            # healthy idle tenant just to squat a slab row forever)
            self.registry.count("solverd.json_requests_ignored")
            return False
        t = self.ensure_tenant(ns)
        if t is None:
            return False
        t.last_req_ms = time.monotonic() * 1000.0
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        with trace.span("solverd.request_decode", parent="solverd.tick"):
            try:
                raw = base64.b64decode(data.get("data") or "",
                                       validate=True)
                pkt = pcodec.decode(raw)
            except (ValueError, pcodec.CodecError):
                self.registry.count("solverd.bad_packets")
                return False
            if pkt.trace is not None:
                obs_events.emit("plan.request", trace_id=pkt.trace.trace_id,
                                hop=pkt.trace.hop,
                                send_ms=pkt.trace.send_ms,
                                seq=data.get("seq"))
            if not self._packet_sane(pkt):
                self.registry.count("solverd.bad_packets")
                return False
            self.registry.count("solverd.decode_bytes", len(raw))
            if pkt.kind == pcodec.KIND_DELTA:
                self.registry.count("solverd.delta_agents",
                                    int(pkt.idx.size))
            try:
                upd = t.decoder.apply(pkt)
            except pcodec.SeqGapError as e:
                t.snapshot_needed = True
                self.registry.count("solverd.seq_gaps")
                trace.instant("solverd.seq_gap", have=e.have_seq,
                              base=e.base_seq, tenant=ns)
                return False
            self.slab.apply(t.row, upd)
            self.slab.service.prefetch_goals(data.get("hints") or [])
        if stale:
            return False
        caps = data.get("caps") or []
        req = {"ns": ns, "seq": data.get("seq"), "caps": caps,
               "t0": t0, "t0_ns": t0_ns, "tc": pkt.trace,
               "t_dec": time.perf_counter()}
        if pcodec.CODEC_NAME not in caps:
            req["names"] = list(t.decoder.names)
        self.pending_reqs[ns] = req
        return True

    def handle_world(self, data: dict) -> int:
        """Operator-plane dynamic-world toggle: the shared grid mutates for
        every tenant at once."""
        return apply_world_frame(self.slab.service, self.registry, data)

    def flush_snapshot_requests(self) -> None:
        for t in self.tenants.values():
            if t.snapshot_needed:
                t.snapshot_needed = False
                t.resyncs += 1
                self.registry.count("solverd.tenant_resyncs")
                self.publish(t.topic, {
                    "type": "plan_snapshot_request",
                    "have_seq": (t.decoder.last_seq
                                 if t.decoder.last_seq is not None
                                 else -1)})

    # -- plan / respond ---------------------------------------------------
    def begin(self) -> Optional[PendingSuper]:
        reqs, self.pending_reqs = self.pending_reqs, {}
        if not reqs:
            return None
        rows = {ns: self.tenants[ns].row for ns in reqs
                if ns in self.tenants}
        return self.slab.dispatch(reqs, rows)

    def finish(self, p: PendingSuper, pipelined: bool = False) -> None:
        """Fetch the super-step and publish one response per requesting
        tenant (packed when its request advertised the codec, legacy JSON
        otherwise)."""
        t_fetch0 = time.perf_counter()
        overlap_ms = 1000.0 * (t_fetch0 - p.t_disp_end)
        self.registry.observe("solverd.pipeline_overlap_ms", overlap_ms)
        new_pos, new_goal = self.slab.fetch(p)
        t_fetched = time.perf_counter()
        w = self.grid.width
        for ns, r in p.reqs.items():
            t = self.tenants.get(ns)
            base = p.bases.get(ns)
            if t is None or base is None or t.row != base[0]:
                continue  # evicted (or evicted+re-admitted) in flight
            row, base_pos, base_goal, base_active = base
            changed = base_active \
                & ((new_pos[row] != base_pos)
                   | (new_goal[row] != base_goal))
            lanes = np.flatnonzero(changed).astype(np.int32)
            npos = new_pos[row][lanes].astype(np.int32)
            ngoal = new_goal[row][lanes].astype(np.int32)
            us = int(1e6 * ((p.t_disp_end - r["t0"])
                            + (t_fetched - t_fetch0)))
            resp_tc = None
            if r.get("tc") is not None and obs_events.ctx_enabled():
                resp_tc = r["tc"].next_hop()
            with trace.span("solverd.reply_encode", parent="solverd.tick"):
                if pcodec.CODEC_NAME in r["caps"]:
                    rpkt = pcodec.encode_response(r["seq"], lanes, npos,
                                                  ngoal)
                    rpkt.trace = resp_tc
                    resp = {"type": "plan_response", "seq": r["seq"],
                            "codec": pcodec.CODEC_NAME,
                            "duration_micros": us,
                            "data": pcodec.encode_b64(rpkt)}
                else:
                    names = r.get("names") or []
                    moves = []
                    for lane, c, g in zip(lanes, npos, ngoal):
                        pid = names[int(lane)] \
                            if 0 <= int(lane) < len(names) else None
                        if pid is None:
                            continue
                        moves.append({"peer_id": pid,
                                      "next_pos": [int(c) % w, int(c) // w],
                                      "goal": [int(g) % w, int(g) // w]})
                    resp = {"type": "plan_response", "seq": r["seq"],
                            "duration_micros": us, "moves": moves}
                    if resp_tc is not None:
                        resp["tc"] = [resp_tc.trace_id, resp_tc.hop,
                                      resp_tc.send_ms]
            self.publish(t.topic, resp)
        t_end = time.perf_counter()
        self.last_phase_ms = {
            "step_dispatch": 1000.0 * (p.t_disp_end - p.t0),
            "device_sync": 1000.0 * (t_fetched - t_fetch0),
            "encode": 1000.0 * (t_end - t_fetched)}
        self.ticks += 1
        first = min(r["t0"] for r in p.reqs.values())
        total_ms = 1000.0 * (time.perf_counter() - first)
        trace.complete("solverd.tick",
                       min(r["t0_ns"] for r in p.reqs.values()),
                       time.perf_counter_ns()
                       - min(r["t0_ns"] for r in p.reqs.values()),
                       tenants=len(p.reqs), pipelined=pipelined)
        self.registry.observe("tick_ms", total_ms)
        if total_ms > self.budget_ms:
            self.registry.count("tick.over_budget")
        self.registry.gauge("tick.agents", p.lanes)
        # mesh residency gauges: the dirs cache and the slab's planes
        self.slab.service.update_mesh_gauges(
            extra=(self.slab.d_pos, self.slab.d_goal, self.slab.d_slot,
                   self.slab.d_active))
        if self.heartbeat is not None:
            self.heartbeat.beat(
                self.ticks, p.lanes,
                {"total": total_ms,
                 "overlap": overlap_ms if pipelined else 0.0},
                counters=trace.snapshot()["counters"])
            trace.flush()

    def stats(self) -> dict:
        snap = trace.snapshot()
        svc = self.slab.service
        snap["service"] = {
            "mode": "multi_tenant",
            "ticks": self.ticks,
            "dropped_stale": self.dropped_total,
            "tenants": {
                (t.ns or "<default>"): {
                    "row": t.row,
                    "lanes": int(self.slab.h_active[t.row].sum())
                    if t.row < self.slab.T_cap else 0,
                    "last_seq": t.decoder.last_seq,
                    "resyncs": t.resyncs,
                    "idle_ms": round(time.monotonic() * 1000.0
                                     - t.last_req_ms, 1),
                } for t in self.tenants.values()},
            "slab": {"t_cap": self.slab.T_cap, "l_cap": self.slab.L_cap,
                     "lanes": int(self.slab.h_active.sum())},
            "cached_fields": len(svc.goal_rows),
            "max_fields": svc.max_fields,
            "cache_hits": svc.cache_hits,
            "cache_misses": svc.cache_misses,
            "defer_fields": svc.defer_fields,
            "field_queue": len(svc.field_queue),
            "deferred_lanes": len(self.slab.lane_wait),
            "dynamic_world": svc.dynamic_world,
            "world_seq": svc.world_seq,
            "mesh": svc.mesh_stats(),
        }
        snap["network"] = self.registry.network_summary()
        return snap


def audit_entries_tenant(slab: TenantSlab, tenant: Tenant
                         ) -> Tuple[list, dict]:
    """One tenant's audit-beacon body: its slab-row host-mirror and
    device-pull digests at ITS decoder seq (the manager behind this
    tenant's namespace publishes the matching shadow ring)."""
    svc = slab.service
    row = tenant.row
    seq = (tenant.decoder.last_seq
           if tenant.decoder.last_seq is not None else 0)
    epoch = svc.world_seq
    act = np.flatnonzero(slab.h_active[row])
    d, n = obs_audit.lane_digest(act, slab.h_pos[row][act],
                                 slab.h_goal[row][act])
    entries = [obs_audit.AuditEntry(obs_audit.SEC_MIRROR, n, seq,
                                    epoch, d)]
    if slab.d_pos is not None and row < slab.T_cap:
        dmask = slab.d_active[row].cpu().numpy()
        dact = np.flatnonzero(dmask)
        dd, dn = obs_audit.lane_digest(dact,
                                       slab.d_pos[row].cpu().numpy()[dact],
                                       slab.d_goal[row].cpu().numpy()[dact])
        entries.append(obs_audit.AuditEntry(obs_audit.SEC_DEVICE, dn, seq,
                                            epoch, dd))
    extra = {"dynamic_world": bool(svc.dynamic_world),
             "epoch": epoch, "seq": seq}
    return entries, extra


def tenant_audit_peer(ns: str) -> str:
    """The per-tenant audit peer id: one daemon publishes one digest
    stream per tenant, and the joiner keys streams by peer."""
    return f"solverd[{ns or 'default'}]"


def multi_tenant_loop(bus, runner: MultiTenantRunner, slab: TenantSlab,
                      beacon, stats_requested: dict, dump_stats) -> None:
    """The multi-tenant daemon loop: tenant-tagged ingest (wire topics
    carry the namespace), one pipelined folded super-step per request
    burst, per-tenant responses, dynamic admission via ``solver.admit``."""

    def subscribe_tenant(ns: str) -> None:
        bus.subscribe(busns.wire_topic(ns, "solver"), raw=True)

    svc = slab.service
    pending: Optional[PendingSuper] = None

    # audit plane: one digest stream PER TENANT (each joins against its own
    # namespaced manager's shadow ring) plus a shared field-cache stream,
    # all on the raw operator topic
    audit_on = obs_audit.enabled()
    audit_interval = obs_audit.interval_s()
    audit_state = {"last": 0.0, "effective": audit_interval}

    def audit_beat() -> None:
        if not audit_on:
            return
        now = time.monotonic()
        if audit_state["last"] \
                and now - audit_state["last"] < audit_state["effective"]:
            return
        audit_state["last"] = now
        t0 = time.perf_counter()
        ts_ms = time.time_ns() // 1_000_000
        payloads = []
        for t in list(runner.tenants.values()):
            entries, extra = audit_entries_tenant(slab, t)
            payloads.append({
                "type": "audit_beacon",
                "peer_id": tenant_audit_peer(t.ns),
                "proc": "solverd", "ns": t.ns, "pid": os.getpid(),
                "ts_ms": ts_ms,
                "caps": [obs_audit.AUDIT_CAP],
                "data": obs_audit.encode_audit_b64(entries),
                **extra})
        fresh = [g for g in svc.goal_rows
                 if g != -1 and not svc._is_stale(g)]
        fd, fn = obs_audit.cells_digest(fresh)
        payloads.append({
            "type": "audit_beacon", "peer_id": "solverd",
            "proc": "solverd", "ns": "", "pid": os.getpid(),
            "ts_ms": ts_ms,
            "caps": [obs_audit.AUDIT_CAP],
            "dynamic_world": bool(svc.dynamic_world),
            "epoch": svc.world_seq,
            "data": obs_audit.encode_audit_b64(
                [obs_audit.AuditEntry(obs_audit.SEC_FIELDS, fn, 0,
                                      svc.world_seq, fd)])})
        # self-throttle like AuditBeacon: per-tenant digest bodies re-hash
        # every slab row, so the cadence stretches when a beat runs long
        # (audit overhead capped at ~2% of the loop).  Published AFTER the
        # recompute so every stream advertises the cadence this beat set
        audit_state["effective"] = max(
            audit_interval, 50.0 * (time.perf_counter() - t0))
        for p in payloads:
            p["interval_s"] = audit_state["effective"]
            bus.publish(obs_audit.AUDIT_TOPIC, p, raw=True)

    def handle_audit(data: dict) -> None:
        typ = data.get("type")
        if typ == "audit_drill_request":
            tns = data.get("ns") or ""
            t = runner.tenants.get(tns)
            if t is None or data.get("target") not in (
                    "solverd", tenant_audit_peer(tns)):
                return
            view = data.get("view") or "mirror"
            row = t.row
            if view == "device" and slab.d_pos is not None:
                mask = slab.d_active[row].cpu().numpy()
                pos = slab.d_pos[row].cpu().numpy()
                goal = slab.d_goal[row].cpu().numpy()
            else:
                mask, pos, goal = (slab.h_active[row], slab.h_pos[row],
                                   slab.h_goal[row])
            act = np.flatnonzero(mask)
            bus.publish(obs_audit.AUDIT_TOPIC, obs_audit.drill_answer(
                data, act, pos[act], goal[act], names=t.decoder.names,
                peer_id=tenant_audit_peer(tns)), raw=True)
        elif typ == "audit_corrupt":
            # the sticky corruption hook is a flat-daemon test fixture
            runner.registry.count("solverd.audit_corrupt_ignored")

    def route(frame) -> Optional[Tuple[str, dict]]:
        """(tenant ns, plan_request payload) of a frame, handling the
        control messages inline; None for everything else."""
        if frame.get("op") != "msg":
            return None
        data = frame.get("data") or {}
        topic = frame.get("topic") or ""
        ns, logical = busns.split_ns(topic)
        typ = data.get("type")
        if logical == obs_audit.AUDIT_TOPIC:
            # raw operator plane: drill requests resolve a tenant row via
            # the request's ns field; beacons from other peers are noise
            if ns == "":
                handle_audit(data)
            return None
        if logical == ADMIT_TOPIC:
            if typ == "tenant_hello" and isinstance(data.get("ns"), str):
                try:
                    hello_ns = busns.validate(data["ns"])
                except ValueError:
                    return None
                subscribe_tenant(hello_ns)
                if runner.ensure_tenant(hello_ns) is not None:
                    bus.publish(ADMIT_TOPIC,
                                {"type": "tenant_welcome", "ns": hello_ns})
            return None
        if logical != "solver":
            return None
        if typ == "stats_request":
            # cross-tenant stats enumerate EVERY tenant's namespace and
            # activity (operator tooling only): answered on the
            # un-namespaced topic, never into a tenant's namespace
            if ns == "":
                bus.publish(topic, {"type": "stats_response",
                                    **runner.stats()}, raw=True)
            return None
        if typ == "flight_dump":
            if ns != "":
                return None  # operator tooling, same rule as stats
            path = flightrec.dump(reason="bus_request")
            bus.publish(topic, {
                "type": "flight_dump_response", "proc": "solverd",
                "peer_id": "solverd", "path": path,
                "events": len(flightrec.get_recorder())}, raw=True)
            return None
        if typ == "world_update":
            # The grid is SHARED across every tenant's slab row, so only
            # the UN-NAMESPACED operator plane may mutate it: a single
            # tenant's manager must not re-shape every other fleet's world
            if ns == "":
                runner.handle_world(data)
            else:
                runner.registry.count("solverd.world_updates_ignored")
            return None
        if typ != "plan_request":
            return None
        return ns, data

    while True:
        frame = bus.recv(timeout=0.002 if pending is not None
                         else (0.02 if svc.field_queue else 1.0))
        beacon.maybe_beat()
        audit_beat()
        if stats_requested["flag"]:
            stats_requested["flag"] = False
            dump_stats()
        if frame is None:
            if pending is not None:
                runner.finish(pending, pipelined=True)
                pending = None
            elif svc.field_queue:
                slab.process_field_queue()
            continue
        routed = route(frame)
        if routed is None:
            continue
        # stale drain, PER TENANT: every packed request applies in order,
        # only the newest per tenant is planned this burst.  BOUNDED: with
        # many tenants ticking fast the inter-arrival gap can stay under
        # the drain timeout forever, and an in-flight step's responses
        # must not be withheld behind an endless drain
        bursts: Dict[str, List[dict]] = {routed[0]: [routed[1]]}
        drained = 0
        while drained < TENANT_DRAIN_MAX:
            nxt = bus.recv(timeout=0.005)
            if nxt is None:
                break
            drained += 1
            r = route(nxt)
            if r is not None:
                bursts.setdefault(r[0], []).append(r[1])
        any_ok = False
        for ns, reqs in bursts.items():
            for stale_req in reqs[:-1]:
                runner.ingest(ns, stale_req, stale=True)
            if runner.ingest(ns, reqs[-1]):
                any_ok = True
            dropped = len(reqs) - 1
            if dropped:
                runner.dropped_total += dropped
                trace.count("solverd.dropped_stale", dropped)
        runner.flush_snapshot_requests()
        nxt_pending = runner.begin() if any_ok else None
        if pending is not None:
            runner.finish(pending, pipelined=True)
        pending = nxt_pending


VIRTUAL_MESH_ENV = "JG_SOLVER_MESH_VIRTUAL"


def virtual_mesh_on_card() -> bool:
    """Whether a mesh on the card lays every shard on ``cuda:0``
    (``JG_SOLVER_MESH_VIRTUAL``) instead of taking A*T cards."""
    return os.environ.get(VIRTUAL_MESH_ENV, "") not in ("", "0")


def refusal(args) -> Optional[str]:
    """Why the daemon refuses to start with these arguments (or None): a
    custom plan topic in multi-tenant mode (as the JAX daemon refuses it),
    a malformed mesh spec, a mesh on the card with fewer cards than it
    names, and a card that is missing."""
    multi_tenant = args.tenants is not None or args.multi_tenant
    if multi_tenant and args.solver_topic != "solver":
        # tenant plan wires are namespaced topics; a custom flat topic
        # would silently split the plane
        return "--solver-topic is incompatible with multi-tenant mode"
    try:
        mesh_shape = solver_mesh.mesh_spec_from_env(mesh_spec(args))
    except ValueError as e:
        return str(e)
    if mesh_shape is not None and not args.cpu \
            and not virtual_mesh_on_card():
        try:
            solver_mesh.SolverMesh(*mesh_shape)
        except RuntimeError as e:
            return f"mesh {mesh_spec(args)}: {e}"
    if not args.cpu and not torch.cuda.is_available():
        return ("CUDA is not available: the daemon plans on the card; pass "
                "--cpu to plan on the CPU")
    return None


def mesh_spec(args) -> Optional[str]:
    """The mesh spec: ``--mesh`` wins over ``JG_SOLVER_MESH``."""
    return (args.mesh if args.mesh is not None
            else os.environ.get("JG_SOLVER_MESH"))


def build_mesh(args, grid: Grid) -> Optional["solver_mesh.SolverMesh"]:
    """The daemon's mesh, or None for the flat path: virtual CPU shards
    under ``--cpu`` (the JAX daemon forces virtual CPU devices there),
    virtual shards of ``cuda:0`` under ``JG_SOLVER_MESH_VIRTUAL``, else the
    first A*T CUDA devices.  Raises ValueError or RuntimeError for a spec
    the grid or the machine cannot take."""
    shape = solver_mesh.mesh_spec_from_env(mesh_spec(args))
    if shape is None:
        return None
    n = shape[0] * shape[1]
    devices = (virtual_mesh.virtual_devices(n, "cpu") if args.cpu
               else virtual_mesh.virtual_devices(n, "cuda:0")
               if virtual_mesh_on_card() else None)
    mesh = solver_mesh.SolverMesh(*shape, devices=devices)
    mesh.validate_grid(grid)
    return mesh


def warm(service: PlanService, grid: Grid, n_agents: int) -> int:
    """Build the kernels (on the card) and run the whole planning path once
    for an ``n_agents`` fleet: its field rows, one step at its capacity and
    the small sweep chunks.  Returns the warmed agent count."""
    if service.device.type == "cuda":
        from p2p_distributed_tswap_tpu_torch.ops import cuda_build
        cuda_build.build()
    if n_agents <= 0:
        return 0
    rng = np.random.default_rng(0)
    free_idx = np.flatnonzero(np.asarray(grid.free).reshape(-1))
    n = min(n_agents, len(free_idx) // 2)
    sel = rng.choice(free_idx, size=2 * n, replace=False)
    service.plan([(f"warm{k}", int(sel[k]), int(sel[n + k]))
                  for k in range(n)])
    for size in (1, 2, 4):
        gvec = torch.full((size,), int(sel[0]), dtype=_I32,
                          device=service.device)
        # dynamic mode sweeps through the dist-returning variant
        if service.keep_dist:
            service._fields_dist(gvec)
        else:
            service._fields(gvec)
    if service.device.type == "cuda":
        torch.cuda.synchronize(service.device)
    return n


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by kernel.  Launches on the
    card only; on the CPU the plain versions run and the counts stay 0."""
    return {"sweep_scan": sweep_kernel.launches,
            **{f"field_fused_{mode}": n
               for mode, n in sorted(field_fused.launches.items())}}


def launch_gauges() -> None:
    """This process's kernel launch counts as gauges
    (``solverd.kernel_launches{kernel=...}``), so that they ride the
    metrics beacon: a harness outside the daemon reads from them which
    kernels served its fleet."""
    reg = registry.get_registry()
    for kernel, n in launch_counts().items():
        reg.gauge("solverd.kernel_launches", n, kernel=kernel)


def report_launches_on_sigterm() -> None:
    """On SIGTERM, print this process's kernel launches (in all, and since
    this call: the ``solverd up`` banner) as one ``solverd kernel
    launches`` JSON line, then die of the signal as before.  A harness
    that stops the daemon reads from its log which kernels served the
    fleet, the warm-up apart."""
    at_up = launch_counts()

    def report(signum, frame):
        now = launch_counts()
        print("🧮 solverd kernel launches " + json.dumps(
            {"total": now,
             "since_up": {k: n - at_up.get(k, 0) for k, n in now.items()}}),
            flush=True)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    signal.signal(signal.SIGTERM, report)


class LaunchBeacon(MetricsBeacon):
    """The daemon's metrics beacon: it sets the launch gauges just before it
    builds each payload, and not on every pass of the loop."""

    def build_payload(self) -> dict:
        launch_gauges()
        return super().build_payload()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=7400)
    ap.add_argument("--map", default=None)
    ap.add_argument("--capacity-min", type=int, default=16)
    ap.add_argument("--warm", type=int, default=0,
                    help="build the kernels and run the planning path for "
                         "an N-agent fleet before the readiness banner")
    ap.add_argument("--trace", action="store_true",
                    help="force span tracing on (equivalent to JG_TRACE=1)")
    ap.add_argument("--cpu", action="store_true",
                    help="plan on the CPU (the default is the card)")
    # Mesh mode: shard the planning plane over a mesh of devices.
    ap.add_argument("--mesh", default=None,
                    help="device mesh spec N or AxT (JG_SOLVER_MESH); "
                         "1 or 1x1 is one device; with --cpu the shards "
                         "are virtual")
    # Multi-tenant mode: serve many namespaced fleets from one
    # device-resident super-batch.  --tenants pre-subscribes a static
    # tenant list; --multi-tenant additionally listens on solver.admit for
    # dynamic tenant_hello admission.  Either flag enables the mode.
    ap.add_argument("--tenants", default=None,
                    help="comma list of bus namespaces to serve "
                         "(JG_BUS_NS values; '' = the un-namespaced "
                         "default fleet)")
    ap.add_argument("--multi-tenant", action="store_true",
                    help="dynamic tenant admission via solver.admit")
    ap.add_argument("--max-tenants", type=int, default=64,
                    help="device-memory admission budget: tenants beyond "
                         "this evict the least-recently-active idle "
                         "tenant (snapshot-resync on re-admission)")
    ap.add_argument("--tenant-lanes", type=int, default=1 << 16,
                    help="per-tenant lane budget (requests addressing "
                         "lanes past it are rejected)")
    ap.add_argument("--tenant-idle-ms", type=float, default=2000.0,
                    help="a tenant is eviction-eligible only after this "
                         "long without a plan_request")
    ap.add_argument("--solver-topic",
                    default=os.environ.get("JG_SOLVER_TOPIC") or "solver",
                    help="plan-wire bus topic (JG_SOLVER_TOPIC)")
    ap.add_argument("--audit-ns",
                    default=os.environ.get("JG_AUDIT_NS") or "",
                    help="audit-beacon pairing namespace (JG_AUDIT_NS)")
    args = ap.parse_args(argv)
    why = refusal(args)
    if why is not None:
        print(f"❌ {why}", file=sys.stderr)
        return 2
    tenant_list = ([busns.validate(t.strip()) for t in
                    args.tenants.split(",")] if args.tenants is not None
                   else [])
    multi_tenant = bool(tenant_list) or args.multi_tenant
    solver_topic = args.solver_topic
    device = torch.device("cpu" if args.cpu else "cuda")

    tracer = trace.configure(enabled=True if args.trace else None,
                             proc="solverd")
    obs_events.configure("solverd")
    flightrec.install("solverd")

    if args.map:
        with open(args.map) as f:
            text = f.read()
        grid = (Grid.from_mapf_file(args.map) if text.startswith("type")
                else Grid.from_ascii(text))
    else:
        grid = Grid.default()

    # Subscribe before the kernels are built: plan_requests published
    # meanwhile would be lost (the bus does not replay).  The banner below
    # is the readiness signal harnesses wait for.  reconnect=True: a busd
    # restart must not kill the planning daemon.  Multi-tenant solverd IS
    # the cross-tenant infrastructure: its own client is un-namespaced
    # whatever JG_BUS_NS the spawning environment exported, and the tenant
    # plan wires are subscribed as wire topics.
    from p2p_distributed_tswap_tpu_torch.runtime.bus_client import BusClient
    bus = BusClient(port=args.port, peer_id="solverd", reconnect=True,
                    namespace="" if multi_tenant else None)
    if multi_tenant:
        for ns in tenant_list:
            bus.subscribe(busns.wire_topic(ns, "solver"), raw=True)
        if args.multi_tenant:
            bus.subscribe(ADMIT_TOPIC)
        if "" not in tenant_list:
            bus.subscribe("solver")  # the un-namespaced default fleet
    else:
        bus.subscribe(solver_topic)
    if obs_audit.enabled():
        bus.subscribe(obs_audit.AUDIT_TOPIC, raw=True)

    mesh_obj = None
    try:
        mesh_obj = build_mesh(args, grid)
    except (RuntimeError, ValueError) as e:
        print(f"❌ mesh {mesh_spec(args)}: {e}", file=sys.stderr)
        return 2
    if mesh_obj is not None:
        reg = registry.get_registry()
        reg.gauge("solverd.mesh_devices", mesh_obj.n_devices)
        reg.gauge("solverd.mesh_agents", mesh_obj.n_agent_shards)
        reg.gauge("solverd.mesh_tiles", mesh_obj.n_tiles)
        # the shape string rides a labeled unit gauge (gauge values are
        # floats); the fleet aggregator lifts the label into its mesh
        # section
        reg.gauge("solverd.mesh_shape", 1, shape=mesh_obj.shape_str)
    service = PlanService(grid, capacity_min=args.capacity_min,
                          device=device, mesh=mesh_obj)
    if mesh_obj is not None:
        # residency gauges exist from the first beacon, not the first tick
        service.update_mesh_gauges()
    t0 = time.perf_counter()
    n = warm(service, grid, args.warm)
    print(f"🔥 pre-warmed on {device}: capacity {service._capacity(n)} "
          f"step, {n} field rows in {time.perf_counter() - t0:.1f}s",
          flush=True)
    heartbeat = None
    if tracer.enabled:
        heartbeat = HeartbeatWriter(tracer.default_path("heartbeat"))
        print(f"🔎 tracing on: {tracer.default_path('trace')} "
              f"(+ heartbeat sidecar)", flush=True)
    runner = TickRunner(service, grid, heartbeat=heartbeat)
    mt_runner = slab = None
    if multi_tenant:
        slab = TenantSlab(service, grid, tenant_lanes=args.tenant_lanes)
        mt_runner = MultiTenantRunner(
            slab, grid,
            publish=lambda topic, data: bus.publish(topic, data, raw=True),
            max_tenants=args.max_tenants,
            idle_evict_ms=args.tenant_idle_ms, heartbeat=heartbeat)
        for ns in tenant_list:
            mt_runner.ensure_tenant(ns)

    http_srv = registry.maybe_serve_http()
    if http_srv is not None:
        print(f"📡 /metrics on http://127.0.0.1:{http_srv.server_port}",
              flush=True)
    beacon = LaunchBeacon(bus, proc="solverd")
    audit_beacon = None
    if obs_audit.enabled() and not multi_tenant:
        audit_beacon = obs_audit.AuditBeacon(
            bus, "solverd",
            lambda: audit_entries(
                service,
                runner.packed.last_seq
                if runner.packed.last_seq is not None else 0),
            ns=args.audit_ns)

    # SIGUSR1 = operator stats dump: the handler only flips a flag, the
    # loop dumps between frames
    stats_requested = {"flag": False}
    signal.signal(signal.SIGUSR1,
                  lambda *_: stats_requested.__setitem__("flag", True))

    def dump_stats() -> None:
        print("📈 stats " + json.dumps((mt_runner or runner).stats()),
              flush=True)
        trace.flush()

    def answer_stats() -> None:
        bus.publish(solver_topic, {"type": "stats_response", **runner.stats()})
        trace.flush()

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    shown = (torch.device("cuda", torch.cuda.current_device())
             if device.type == "cuda" else device)  # with the card's index
    trace.instant("solverd.up", port=args.port, multi_tenant=multi_tenant,
                  mesh=mesh_obj.shape_str if mesh_obj else None)
    print(f"🧮 solverd up on port {args.port} "
          f"(grid {grid.height}x{grid.width}, device={shown} [{name}]"
          + (f", tenants={[t or '<default>' for t in tenant_list]}"
             f" max={args.max_tenants}" if multi_tenant else "")
          + (f", mesh={mesh_obj.shape_str}"
             f" [{mesh_obj.n_devices} devices"
             f"{', virtual' if mesh_obj.mesh.virtual else ''}]"
             if mesh_obj else "") + ")")
    sys.stdout.flush()
    report_launches_on_sigterm()

    if multi_tenant:
        # the tenant-aware loop replaces the single-fleet one end to end
        multi_tenant_loop(bus, mt_runner, slab, beacon, stats_requested,
                          dump_stats)
        return 0

    # Pipelined tick loop (dispatch-then-poll): after dispatching the step
    # for request k the daemon returns to the bus; the decode of request
    # k+1 and the publish of response k overlap the device work.
    pending: Optional[PendingTick] = None
    caps_logged = False
    while True:
        # short poll while a step is in flight; medium poll while queued
        # field sweeps wait for an idle window
        frame = bus.recv(timeout=0.002 if pending is not None
                         else (0.02 if service.field_queue else 1.0))
        beacon.maybe_beat()
        if audit_beacon is not None:
            audit_beacon.maybe_beat()
        if not caps_logged and bus.hub_caps is not None:
            caps_logged = True
            print(f"🚌 bus caps {bus.hub_caps}: relay fast framing "
                  f"{'on' if bus.fast_hub else 'off'}", flush=True)
        if stats_requested["flag"]:
            stats_requested["flag"] = False
            dump_stats()
        if frame is None:
            if pending is not None:
                resp = runner.finish(pending, pipelined=True)
                pending = None
                if resp is not None:
                    bus.publish(solver_topic, resp)
            elif service.field_queue:
                # idle window between ticks: sweep queued goal fields
                service.process_field_queue()
            continue
        if frame.get("op") != "msg":
            continue
        data = frame.get("data") or {}
        if data.get("type") == "stats_request":
            answer_stats()
            continue
        if data.get("type") == "flight_dump":
            path = flightrec.dump(reason="bus_request")
            bus.publish(solver_topic, {
                "type": "flight_dump_response", "proc": "solverd",
                "peer_id": "solverd", "path": path,
                "events": len(flightrec.get_recorder())})
            continue
        if data.get("type") == "world_update":
            runner.handle_world(data)
            continue
        if obs_audit.enabled() and handle_audit_frame(
                data, service, runner.packed.names, bus,
                registry.get_registry()):
            continue
        if data.get("type") != "plan_request":
            continue
        # Staleness drop: if planning fell behind the manager's tick, only
        # the newest request is planned; superseded packed deltas still
        # fold into resident state (ingest stale=True).
        reqs = [data]
        while True:
            # small positive timeout: 0.0 would flip the socket into
            # non-blocking mode
            nxt = bus.recv(timeout=0.005)
            if nxt is None:
                break
            if nxt.get("op") != "msg":
                continue
            ndata = nxt.get("data") or {}
            if ndata.get("type") == "plan_request":
                reqs.append(ndata)
            elif ndata.get("type") == "stats_request":
                answer_stats()
            elif ndata.get("type") == "world_update":
                # world toggles are order-sensitive against the deltas
                # around them
                runner.handle_world(ndata)
            elif obs_audit.enabled() and str(
                    ndata.get("type") or "").startswith("audit_"):
                handle_audit_frame(ndata, service, runner.packed.names,
                                   bus, registry.get_registry())
        for stale_req in reqs[:-1]:
            runner.ingest(stale_req, stale=True)
        ok = runner.ingest(reqs[-1])
        if runner.snapshot_needed:
            runner.snapshot_needed = False
            bus.publish(solver_topic, {
                "type": "plan_snapshot_request",
                "have_seq": (runner.packed.last_seq
                             if runner.packed.last_seq is not None else -1)})
            print("🔁 plan delta chain broken; requested full snapshot",
                  flush=True)
        dropped = len(reqs) - 1
        if dropped:
            runner.dropped_total += dropped
            trace.count("solverd.dropped_stale", dropped)
            print(f"⏭️  dropped {dropped} stale plan_request(s) "
                  f"({runner.dropped_total} total); planning seq "
                  f"{reqs[-1].get('seq')}", flush=True)
        nxt_pending = runner.begin() if ok else None
        if pending is not None:
            # request k+1 is already dispatched; this fetch + encode +
            # publish of response k is the overlap
            resp = runner.finish(pending, pipelined=True)
            if resp is not None:
                bus.publish(solver_topic, resp)
        pending = nxt_pending


if __name__ == "__main__":
    sys.exit(main())
