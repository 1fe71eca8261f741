#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``p2p_distributed_tswap_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, and drives the port's paths (the
offline MAPD solve: default, stale-view decentralized, and the fused field
engine under ``MAPD_FUSED``) on the card.  Each phase prints one JSON line;
any failed phase raises and the script exits non-zero.  ``MAPD_FUSED`` is
set and restored inside every phase that solves, so no phase leaks its mode
into the next.  Phases:

1. device   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name.
2. build    — seconds ``nvcc`` took for every ``csrc/*.cu`` (or a cache
               hit), and the ``ptxas`` report of each source's kernels.
3. kernel   — ``sweep_scan`` == its plain version (``torch.equal``) for all
               four (axis, reverse) pairs at the shapes the flagship,
               1k-512 and congested solves give it (in-step and prime
               chunks, on their own masks) and at ragged ones (R = 70 000,
               H or W one past a segment, single cells, whole blocked
               columns on tile edges); each row gives the layout the
               kernel took; at the path shapes also the kernel's device
               time per launch (CUDA events around 25 back-to-back
               launches, median of 5 runs, each run listed), its bytes
               bound at 3.35 TB/s, and the plain version's time.  Then the
               same with one mask per field (the repair and sector
               windows): the sector planner's portal rebuild batch at
               S = 64 (512, 128, 128), its corridor batch (16, 128, 128)
               and (8, 256, 256), timed, with fully blocked padded layers,
               and ragged shapes; the bound counts R masks.  Timed too:
               the 4096² rung's chunk (8, 4096, 4096) and the bands of the
               mesh at two tiles, (4, 512, 1024) of the flagship and
               (8, 2048, 4096) of the 4096² warehouse.
4. fused    — both instances of the fused field kernel == their plain
               version (``torch.equal``): multi at the congested rung's
               in-step and prime chunks on its warehouse, single at the
               flagship's and 1k-512's on theirs, and ragged and
               adversarial cases (G = 1, 5, 11 and 13, goals in a corner
               and on an obstacle, a non-aligned grid, a maze where
               ``max_rounds`` = 2 binds, a serpentine maze whose shortest
               paths cross every band edge many times, with
               ``max_rounds`` binding and not), and the in-step chunks
               again at every cluster size forced (1, 2, 4, 8, 16); each
               row gives the launch's layout (blocks per cluster, blocks
               launched) and the rounds each field ran; at the path
               shapes the time per launch (with each of its runs, for the
               spread), the bound (bytes or integer operations, whichever
               is larger) and the plain time.
5. parity   — a full ``solve_offline`` of ``ref-50x100x100`` (seed 0) on
               ``cuda`` and on ``cpu``: paths and makespan identical, and the
               CUDA run went through the kernel.
6. stale_parity — the same for ``ref-50x100x100-decent-stale``.
7. medium   — ``1k-512`` (seed 0) solved to completion on the card, every
               recorded transition certified host-side.
8. congested — ``3k-256-congested-decent-stale`` (seed 0), the stale-view
               solve at full width, solved to completion with
               ``MAPD_FUSED=1`` (the multi kernel) and without (the sweeps):
               both certified, paths and makespan identical.
9. flagship — ``10k-1024-warehouse`` (seed 0) at full size: the prime burst,
               then a window of ``mapd_step`` calls with ``step_invariants``
               folded over every step.
10. flagship_single — the same under ``MAPD_FUSED=single``: its prime's
               packed rows == the default prime's, then the same window.
11. serve_parity — the serving path (``runtime/solverd.py``'s
               ``TickRunner``, in process) on ``ref-50x100x100``: one
               closed-loop fleet, 100 ticks, each tick sent on the packed1
               wire and on JSON to a runner on ``cuda`` and one on ``cpu``
               (deferred fields off on all four): every reply's ``data``
               and ``moves`` identical across the devices, and the packed
               plan equal to the JSON plan.
12. serve_1k_512 — ``1k-512`` served: one snapshot, then 300 delta ticks
               from the closed-loop fleet below; every tick's move
               set certified; tick ms p50/p95/max, per-phase ms, fresh
               sweeps, host syncs and kernel launches per tick, cache rows
               and bytes, tasks completed, ticks over the 500 ms budget.
               Run unset and under ``MAPD_FUSED=single``: every reply's
               bytes identical.
13. serve_congested_fused — ``3k-256-congested`` served, 100 ticks, unset
               and under ``MAPD_FUSED=1``: replies identical.
14. serve_flagship — ``10k-1024-warehouse`` served: the snapshot (about
               10k fresh goals swept in chunks of 8 into a 16 384-row
               cache) timed, then 50 delta ticks, numbers as in 12.
15. serve_tenants_parity — multi-tenant serving (``MultiTenantRunner``
               over ``TenantSlab``, the tenant rows folded into one step)
               on the ref rung's grid: 3 tenants (seeds 0, 1, 2) on a slab
               of at most 3, 60 bursts fed to a runner on ``cuda`` and one
               on ``cpu``.  Mid-stream a fourth namespace arrives while t2
               is idle (t2 evicted; back later, it is re-admitted with a
               snapshot resync) and an un-namespaced world toggle blocks a
               cell.  Publishes identical across the devices, every tick of
               every tenant certified.
16. serve_tenants_8x1k_512 — 8 tenants, each the 1k-512 fleet of seed
               k = 0..7 on the shared 512² grid, served by one runner on
               ``cuda``: one snapshot burst, then 100 delta bursts, each
               answered by one super-step over the ``[8, 1024]`` slab.
               Every tick of every tenant certified; each tenant's reply
               bytes equal those of a single-tenant ``TickRunner`` on
               ``cuda`` fed that tenant's stream alone; super-step tick ms
               p50/p95/max against the sum of the 8 single ticks of the
               same burst, per-phase ms, host syncs and launches per tick,
               slab lanes, cache rows and bytes, peak memory, ticks over
               the 500 ms budget.  Run unset and under
               ``MAPD_FUSED=single``: replies identical.
17. checkpoint — the ref rung on ``cuda``: saved at step 60, loaded into a
               fresh state and finished: paths and makespan identical to
               the uninterrupted solve.
18. repair_1024 — ``ops/field_repair.py`` on the flagship's 1024²
               warehouse with a closed room: 16 goals swept with
               distances on the card, 8 events of a 3-cell wall closing
               on a route, then the room's door opening (its repair
               window, past 16 384 cells, sweeps by ``sweep_scan``);
               every repaired field equal to a full recompute on the card.
               Repair ms p50/p95 per field against full-recompute ms per
               field (the sweeps, and ``MAPD_FUSED=single``; chunks of 1
               and 8), fallbacks, ``sweep_scan`` launches per event.
19. sector_1024 — ``ops/sector.py`` on the same grid at S = 64: portal
               graph built on ``cuda`` (the jit path) and on ``cpu`` (the
               host path), equal; 20 goals planned from 2 starts each on
               both, rows and distances equal; plan ms p50/p95 against the
               fresh sweep of one goal; ε of every start against the full
               field at most 0.05; launches per plan; a 3-cell toggle.
20. serve_dynamic_1k_512 — 1k-512 served, 200 delta ticks, a 3-cell wall
               closing near an agent's route every 10 ticks and opening
               10 later, the field queue drained after each tick (the
               daemon's idle window); under ``JG_DYNAMIC_WORLD=1`` and
               unset: replies identical, every tick certified on the live
               mask, incremental repairs under ``=1``; tick ms, idle ms,
               the repair, mirror and sector counters.
21. serve_sector_parity — ``JG_SECTOR=1``: the ref rung served on
               ``cuda`` and ``cpu`` from one fleet, 60 ticks with one
               world toggle, replies identical; then 1k-512 served for
               100 ticks, every tick certified, snapshot and tick ms
               beside the unset run of phase 12.
22. extreme_lite_4096 — ``512a-4096-warehouse`` (seed 0) flat on the card:
               the host chunked prime, then 20 steps, each certified;
               prime seconds, ms/step, launches and host syncs per step,
               peak memory; every step's (pos, goal, slot) kept.  (No
               cuda-vs-cpu run: the plain scan at 4096² on a CPU does not
               fit the time limit; phase 3 holds the kernel to its plain
               version at (8, 4096, 4096) and phase 26 holds the solve to
               a sharded one.)
23. tiled_1024 — ``ops/tiled_distance.py`` on the flagship's 1024²
               warehouse, 16 goals, on meshes of tiles 2, tiles 4 and
               2 x 2: each equal to flat ``direction_fields``; rounds,
               launches and ms beside the flat sweep.
24. sharded_1k_512 — ``1k-512`` solved whole by ``solve_offline_sharded``
               on a 4-shard agent mesh, unset and under
               ``MAPD_FUSED=single``: paths and makespan equal phase 7's,
               every step certified.
25. sharded_flagship — the flagship on a 4-shard agent mesh: prime, the
               warm-up and the window of phase 9, every step's (pos, goal,
               slot) equal to phase 9's; ms/step beside it.
26. sharded2d_4096 — ``512a-4096-warehouse`` on a 2 x 2 agents x tiles
               mesh: the banded prime and 20 steps, each equal to phase
               22's.
27. serve_mesh_parity — the ref rung served on (2, 1) and (2, 2) meshes
               beside a flat runner on the card, 60 ticks with a world
               toggle at tick 30 (then the mesh's distance-returning
               sweeps run): replies identical, per-shard resident bytes;
               then 3 ref tenants on a (2, 1) mesh slab beside a flat
               slab: publishes identical.
28. serve_mesh_1k_512 — ``1k-512`` served on (2, 1) and (2, 2): a snapshot
               and 100 delta ticks, each reply equal to the same tick of
               phase 12's unset run; tick ms, ticks over 500 ms (none),
               per-shard resident bytes.
29. kernels — one JSON object describing every kernel of the paths, with
               its launches per mesh step (phase 25) and per mesh tick
               (phase 28, 2 x 2).
30. the last line: ``{"ok": true, "device": {...}}``.

Mesh phases (22-28) run their shards on real cards when
``torch.cuda.device_count()`` is at least the shard count, else on a
virtual mesh of ``cuda:0`` (``parallel/virtual_mesh.py``); each phase line
gives its mesh's shape, devices and ``virtual``.  A virtual mesh's times
are the mesh's overhead on one card (the extra launches, copies and host
syncs), not scaling.

Each path (phase 9 for ``sweep_scan``, 8 for the multi instance, 10 for
the single instance, each served run of 12-16, 20-21 and 28 for the
kernels it takes, the repair and sector phases 18-19, and the mesh phases
22-26) is driven with every kernel's and the host syncs' counts set to 0
just before it and read just after it (in phase 16 around each super-step burst, not around the
single-tenant runs it is compared with; in 18 around each event's
repairs, not the full recomputes that check them; in 19 around each plan
on the card).

The fleet (``ServeFleet``) does with each reply what the C++ centralized
manager does: it adopts the moves; it adopts returned goals, the task
following its goal (``adopt_goal_exchanges`` in
``cpp/manager_centralized/main.cpp``: the agent whose old goal a returned
goal was takes that agent's task, a donor left with nothing goes idle, a
displaced task is re-queued); an agent on its pickup heads for the
delivery, and one on its delivery cell completes the task and takes the
scenario's next (the task list read in a cycle).

Exits non-zero, before printing any result, when CUDA is not available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.models import scenarios
from p2p_distributed_tswap_tpu_torch.obs import registry
from p2p_distributed_tswap_tpu_torch.ops import (
    cuda_build,
    distance,
    field_fused,
    field_repair,
    sector,
    sweep_kernel,
    tiled_distance,
)
from p2p_distributed_tswap_tpu_torch.parallel import (
    sharded,
    sharded2d,
    solver_mesh,
    virtual_mesh,
)
from p2p_distributed_tswap_tpu_torch.parallel.mesh import (
    agent_mesh,
    agent_tile_mesh,
)
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pcodec
from p2p_distributed_tswap_tpu_torch.runtime import solverd
from p2p_distributed_tswap_tpu_torch.solver import checkpoint, invariants, mapd

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory rate
# H100 SXM published rate outside the tensor cores for 32-bit operands (the
# float32 figure); integer min/add/select run no faster, so operations over
# it give a lower bound on time.
OPS_PER_S = 67e12
# Fewest integer operations the fused function needs per cell: 3 per pass
# (add, min, reset) x 4 passes per round, and 15 for the seed and the codes.
OPS_PER_CELL_ROUND = 12
OPS_PER_CELL_ONCE = 15
INF = sweep_kernel.INF
DIRECTIONS = ((1, False), (1, True), (2, False), (2, True))
TIMED_LAUNCHES = 25
PLAIN_TIMED = 5
SLEEP_CYCLES = 200_000_000  # ~0.1 s of device time to queue launches behind
FLAGSHIP_WARMUP = 5
FLAGSHIP_WINDOW = 50
SERVE_PARITY_TICKS = 100
SERVE_MEDIUM_TICKS = 300
SERVE_CONGESTED_TICKS = 100
SERVE_FLAGSHIP_TICKS = 50
TENANT_PARITY_TICKS = 60
TENANTS = 8
TENANT_TICKS = 100
CHECKPOINT_STEP = 60
NO_SNAPSHOT = 1 << 30  # snapshot_every: one snapshot, then deltas only
REPAIR_GOALS = 16
REPAIR_EVENTS = 8
SECTOR_CELLS = 64           # the planner's default sector side
SECTOR_GOALS = 20
SECTOR_STARTS = 2
SECTOR_EPS = 0.05           # the committed bound on corridor suboptimality
SERVE_DYNAMIC_TICKS = 200
WALL_EVERY = 10             # ticks between a wall closing and opening
SERVE_SECTOR_PARITY_TICKS = 60
SERVE_SECTOR_TICKS = 100
EXTREME_STEPS = 20          # steps of the 4096^2 rung, flat and on 2 x 2
TILED_GOALS = 16
MESH_SHARDS = 4             # the agent mesh of the sharded solves
SERVE_MESH_PARITY_TICKS = 60
SERVE_MESH_TENANT_TICKS = 30
SERVE_MESH_TICKS = 100
# The counters of the repair and sector layers that the serve phases read.
LAYER_COUNTERS = (
    "solverd.field_repairs", "solverd.field_repair_fallbacks",
    "solverd.mirror_evictions", "solverd.world_toggles",
    "solverd.sector_routes", "solverd.sector_fallbacks",
    "solverd.sector_reentries", "solverd.sector_rebuilds")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    import scipy  # the sector planner's host path runs scipy's BFS

    info = {"nvidia_smi": card, "torch_name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "scipy": scipy.__version__}
    emit("device", **info)
    return info


@contextlib.contextmanager
def env_vars(values: dict):
    """Each ``values`` entry set ('' = unset) inside the block, restored
    after."""
    old = {k: os.environ.pop(k, None) for k in values}
    for k, v in values.items():
        if v:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def fused_env(value: str):
    """``MAPD_FUSED=value`` ('' = unset) inside the block, restored after."""
    return env_vars({"MAPD_FUSED": value})


def reset_counts() -> None:
    sweep_kernel.launches = 0
    for mode in field_fused.launches:
        field_fused.launches[mode] = 0
    hostsync.count = 0


def phase_build() -> None:
    info = cuda_build.build()
    emit("build", cached=info["cached"], nvcc_seconds=info["seconds"],
         library=info["path"], sources=[p.name for p in cuda_build.sources()],
         ptxas=info["ptxas"])


def _per_launch_ms(fn, launches: int, reps: int = 5) -> float:
    """Device ms per call of ``fn``: the median of :func:`_launch_ms_runs`."""
    return statistics.median(_launch_ms_runs(fn, launches, reps))


def _launch_ms_runs(fn, launches: int, reps: int = 5) -> list:
    """Device ms per call of ``fn`` in each of ``reps`` runs: ``launches``
    calls queued behind a device-side sleep, so the host's enqueue time is
    hidden and they run back to back, timed with CUDA events."""
    fn()  # warm the allocator's cache for this shape
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


SCENARIO_MASKS = {"warehouse": scenarios.FLAGSHIP, "1k-512": scenarios.MEDIUM,
                  "congested": scenarios.CONGESTED,
                  "warehouse4096": scenarios.EXTREME_LITE}


SERPENTINE_PERIOD = 16  # columns per corridor and its wall


def _mask(kind: str, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """(H, W) bool free mask: a scenario's own grid (``kind/2``: its top
    band at two tiles), a serpentine maze, or random obstacles."""
    base, _, band = kind.partition("/")
    if base in SCENARIO_MASKS:
        free = SCENARIO_MASKS[base].grid_fn().free
        if band:
            free = free[:free.shape[0] // int(band)]
        check(free.shape == (h, w), f"{kind} grid is not {h}x{w}")
        return free
    if kind == "serpentine":
        # full-height walls with one gap each, at the bottom and the top in
        # turn: a path across the grid runs the height of every corridor
        free = np.ones((h, w), dtype=bool)
        for j, x in enumerate(range(SERPENTINE_PERIOD - 1, w,
                                    SERPENTINE_PERIOD)):
            free[:, x] = False
            free[h - 1 if j % 2 == 0 else 0, x] = True
        return free
    free = rng.random((h, w)) > (0.35 if kind == "maze" else 0.2)
    if kind == "border":
        free[[0, -1], :] = False
        free[:, [0, -1]] = False
    return free


KERNEL_CASES = (
    # (R, H, W, mask, timed): the in-step replan chunk and the prime chunk
    # of the flagship, of 1k-512 and of the congested rung, then ragged
    # shapes and obstacles on every edge: whole blocked columns on tile
    # edges (serpentine), R past a grid's 65 535, H and W one past a
    # segment of bands or of a row, single cells
    (4, 1024, 1024, "warehouse", True),
    (64, 1024, 1024, "warehouse", True),
    (4, 512, 512, "1k-512", True),
    (128, 512, 512, "1k-512", True),
    (4, 256, 256, "congested", True),
    (64, 256, 256, "congested", True),
    # the banded sweeps of the mesh: the 4096^2 rung's chunk, a flagship
    # band at two tiles, and a 4096^2 band at two tiles
    (8, 4096, 4096, "warehouse4096", True),
    (4, 512, 1024, "warehouse/2", True),
    (8, 2048, 4096, "warehouse4096/2", True),
    (3, 100, 100, "random", False),
    (2, 257, 131, "random", False),
    (1, 8, 4096, "border", False),
    (2, 1024, 1024, "serpentine", False),
    (70000, 3, 5, "random", False),
    (2, 1025, 33, "border", False),
    (3, 31, 1025, "border", False),
    (1, 1, 1, "random", False),
    (2, 33, 1, "random", False),
)


def sweep_inputs(dev: torch.device, r: int, h: int, w: int, kind: str,
                 rng: np.random.Generator) -> tuple:
    """(d, blocked) for a sweep case: d (R, H, W) int32 with about 3 % of
    the free cells seeded in [0, 60), the rest INF, made on the card from a
    seed of the shape; blocked (H, W) uint8 from :func:`_mask`."""
    free = torch.from_numpy(_mask(kind, h, w, rng)).to(dev)
    blocked = (~free).to(torch.uint8).contiguous()
    gen = torch.Generator(device=dev).manual_seed(r * h + w)
    seeds = torch.rand((r, h, w), generator=gen, device=dev) > 0.97
    vals = torch.randint(0, 60, (r, h, w), generator=gen, device=dev,
                         dtype=torch.int32)
    return torch.where(seeds & free[None], vals, INF).contiguous(), blocked


def sweep_bound(r: int, h: int, w: int, per_field: bool = False) -> dict:
    """Each cell read and written once (int32) and the mask read once (one
    plane, or one per field), over the memory rate: the least time a sweep
    could take."""
    nbytes = 2 * r * h * w * 4 + (r if per_field else 1) * h * w
    return {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def phase_kernel(dev: torch.device, card: str) -> list:
    rows = []
    rng = np.random.default_rng(0)
    for r, h, w, kind, timed in KERNEL_CASES:
        d, blocked = sweep_inputs(dev, r, h, w, kind, rng)
        for axis, reverse in DIRECTIONS:
            got = sweep_kernel.sweep_scan(d, blocked, axis, reverse)
            want = sweep_kernel.sweep_plain(d, blocked, axis, reverse)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            equal = bool(torch.equal(got, want))
            row = {"shape": [r, h, w], "mask": kind, "axis": axis,
                   "reverse": reverse,
                   **sweep_kernel.launch_layout(r, h, w, axis),
                   "equal": equal, "max_abs_err": err}
            if timed:
                row["ms_runs"] = _launch_ms_runs(
                    lambda: sweep_kernel.sweep_scan(d, blocked, axis,
                                                    reverse), TIMED_LAUNCHES)
                row["ms"] = statistics.median(row["ms_runs"])
                row["plain_ms"] = _per_launch_ms(
                    lambda: sweep_kernel.sweep_plain(d, blocked, axis,
                                                     reverse), PLAIN_TIMED,
                    reps=3)
                row.update(sweep_bound(r, h, w))
                row["card"] = card  # name and power limit beside the bound
            emit("kernel", **row)
            check(equal, f"sweep_scan != plain at {row}")
            rows.append(row)
    for r, h, w, pad, timed in PER_FIELD_CASES:
        d, blocked = per_field_inputs(dev, r, h, w, pad)
        for axis, reverse in DIRECTIONS:
            got = sweep_kernel.sweep_scan(d, blocked, axis, reverse)
            want = sweep_kernel.sweep_plain(d, blocked, axis, reverse)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            equal = bool(torch.equal(got, want))
            row = {"shape": [r, h, w], "mask": "per_field",
                   "padded_layers": pad, "axis": axis, "reverse": reverse,
                   **sweep_kernel.launch_layout(r, h, w, axis),
                   "equal": equal, "max_abs_err": err}
            if timed:
                row["ms_runs"] = _launch_ms_runs(
                    lambda: sweep_kernel.sweep_scan(d, blocked, axis,
                                                    reverse), TIMED_LAUNCHES)
                row["ms"] = statistics.median(row["ms_runs"])
                row["plain_ms"] = _per_launch_ms(
                    lambda: sweep_kernel.sweep_plain(d, blocked, axis,
                                                     reverse), PLAIN_TIMED,
                    reps=3)
                row.update(sweep_bound(r, h, w, per_field=True))
                row["card"] = card
            emit("kernel", **row)
            check(equal, f"sweep_scan != plain with per-field masks at {row}")
            rows.append(row)
    return rows


PER_FIELD_CASES = (
    # (R, H, W, fully blocked layers, timed), one mask per field: the
    # sector planner's portal rebuild batch at S = 64 (512 windows of 66^2
    # padded to 128^2), its corridor batch (16 sectors), a corridor batch
    # of 256^2 windows, then ragged shapes
    (512, 128, 128, 12, True),
    (16, 128, 128, 3, True),
    (8, 256, 256, 1, True),
    (5, 37, 53, 1, False),
    (3, 1025, 33, 1, False),
    (70000, 3, 5, 1000, False),
)


def per_field_inputs(dev: torch.device, r: int, h: int, w: int,
                     pad: int) -> tuple:
    """(d, blocked) with one mask per field, made on the card from a seed
    of the shape: each window's own random obstacles (20 %) inside a
    blocked halo ring, the pow2 padding past 66 of every 128 cells blocked
    (as a 66^2 sector window padded to 128^2), the last ``pad`` layers
    fully blocked, and about 3 % of the free cells seeded."""
    gen = torch.Generator(device=dev).manual_seed(7 * r * h + w)
    free = torch.rand((r, h, w), generator=gen, device=dev) > 0.2
    free[:, [0, -1], :] = False
    free[:, :, [0, -1]] = False
    if h >= 128:
        free[:, (h * 66) // 128:, :] = False
    if w >= 128:
        free[:, :, (w * 66) // 128:] = False
    if pad:
        free[r - pad:] = False
    seeds = torch.rand((r, h, w), generator=gen, device=dev) > 0.97
    vals = torch.randint(0, 60, (r, h, w), generator=gen, device=dev,
                         dtype=torch.int32)
    d = torch.where(seeds & free, vals, INF).contiguous()
    return d, (~free).to(torch.uint8).contiguous()


FUSED_CASES = (
    # (mode, G, H, W, mask, max_rounds, timed, forced layout): the in-step
    # replan chunk and the prime chunk of each path, on its own grid, then
    # ragged and adversarial calls made directly, then the in-step chunks
    # at every cluster size (timed, to compare layouts; no plain time).
    # Every case puts goal 0 in the top-left corner, goal 1 on an obstacle
    # (where the grid has one) and the last goal in the bottom-right
    # corner.
    ("multi", 4, 256, 256, "congested", 128, True, {}),
    ("multi", 64, 256, 256, "congested", 128, True, {}),
    ("single", 4, 1024, 1024, "warehouse", 128, True, {}),
    ("single", 64, 1024, 1024, "warehouse", 128, True, {}),
    ("single", 4, 512, 512, "1k-512", 128, True, {}),
    ("single", 128, 512, 512, "1k-512", 128, True, {}),
    ("single", 1, 1024, 1024, "warehouse", 128, False, {}),
    ("single", 3, 1024, 1024, "serpentine", 128, False, {}),
    ("single", 3, 1024, 1024, "serpentine", 20, False, {}),
    ("multi", 5, 256, 256, "serpentine", 128, False, {}),
    ("multi", 5, 256, 256, "serpentine", 6, False, {}),
    ("multi", 5, 256, 256, "congested", 128, False, {}),
    ("single", 5, 256, 256, "congested", 128, False, {}),
    ("multi", 13, 256, 256, "congested", 128, False, {}),
    ("single", 13, 256, 256, "congested", 128, False, {}),
    ("multi", 11, 256, 256, "congested", 128, False, {}),
    ("single", 11, 256, 256, "congested", 128, False, {}),
    ("multi", 3, 100, 100, "random", 128, False, {}),
    ("single", 3, 100, 100, "random", 128, False, {}),
    ("multi", 11, 64, 256, "maze", 2, False, {}),
    ("single", 11, 64, 256, "maze", 2, False, {}),
    *(("single", 4, 1024, 1024, "warehouse", 128, True, {"cluster": k})
      for k in (1, 2, 4, 8, 16)),
    *(("multi", 4, 256, 256, "congested", 128, True, {"cluster": k})
      for k in (1, 2, 4, 8, 16)),
)
PLAIN_FUSED_TIMED = 3
# The in-step replan chunk of each kernel's path: the shape whose times the
# kernels line reports (every timed shape is in its "timed" list).
STEP_SHAPES = {"sweep_scan": [4, 1024, 1024], "multi": [4, 256, 256],
               "single": [4, 1024, 1024]}


def _fused_goals(free: np.ndarray, g: int,
                 rng: np.random.Generator) -> np.ndarray:
    goals = rng.choice(np.flatnonzero(free.reshape(-1)), g).astype(np.int32)
    goals[0] = 0
    if g > 2 and (~free).any():
        goals[1] = np.flatnonzero(~free.reshape(-1))[0]
    goals[-1] = free.size - 1
    return goals


def _fused_bound(g: int, h: int, w: int, field_rounds: torch.Tensor) -> dict:
    """The least time the card could take: the mask read once and the codes
    written once over the memory rate, against the integer work these
    fields' measured rounds need over the operations rate."""
    nbytes = h * w + g * h * w
    ops = h * w * (OPS_PER_CELL_ROUND * int(field_rounds.long().sum())
                   + OPS_PER_CELL_ONCE * g)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_fused(dev: torch.device, card: str) -> list:
    rows = []
    plain = {}  # the plain codes of each input, computed once
    for mode, g, h, w, kind, max_rounds, timed, forced in FUSED_CASES:
        # one input per (G, H, W, mask): both instances and every layout
        # see the same grid and goals
        rng = np.random.default_rng(h * w + g)
        free_np = _mask(kind, h, w, rng)
        free = torch.from_numpy(free_np).to(dev)
        goals = torch.from_numpy(_fused_goals(free_np, g, rng)).to(dev)
        layout = field_fused.launch_layout(dev, g, h, w, **forced)
        got, rounds = field_fused.fused_kernel(free, goals, max_rounds, mode,
                                               **forced)
        key = (g, h, w, kind, max_rounds)
        if key not in plain:
            plain[key] = field_fused.fields_plain(free, goals, max_rounds)
        want = plain[key]
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        equal = bool(torch.equal(got, want))
        row = {"mode": mode, "shape": [g, h, w], "mask": kind,
               "max_rounds": max_rounds, "forced": forced, **layout,
               "equal": equal, "max_abs_err": err,
               "field_rounds": rounds.tolist(),
               "field_rounds_mean": float(rounds.double().mean()),
               "field_rounds_max": int(rounds.max())}
        if timed:
            row.update(_fused_bound(g, h, w, rounds))
            row["ms_runs"] = _launch_ms_runs(
                lambda: field_fused.fused_kernel(free, goals, max_rounds,
                                                 mode, **forced),
                TIMED_LAUNCHES)
            row["ms"] = statistics.median(row["ms_runs"])
            if not forced:
                row["plain_ms"] = _per_launch_ms(
                    lambda: field_fused.fields_plain(free, goals,
                                                     max_rounds),
                    PLAIN_FUSED_TIMED, reps=3)
            row["card"] = card
        emit("fused", **row)
        check(equal, f"field_fused {mode} != plain at {row}")
        rows.append(row)
    return rows


def _verify_paths(width: int, free: np.ndarray, paths_pos: np.ndarray) -> bool:
    """Every recorded transition is a legal collision-free MAPF step:
    distinct cells, free cells, unit moves (the host-side check of
    ``solver.invariants``)."""
    free = free.reshape(-1)
    for t in range(paths_pos.shape[0]):
        p = paths_pos[t]
        if len(np.unique(p)) != len(p) or not free[p].all():
            return False
        if t:
            q = paths_pos[t - 1]
            if (np.abs(p % width - q % width)
                    + np.abs(p // width - q // width) > 1).any():
                return False
    return True


def _timed_solve(grid, starts, tasks, cfg, device) -> tuple:
    """One solve with every count set to 0 just before it; returns its
    output, seconds, sweep_scan launches and host syncs (the fused
    instances' launches stay in ``field_fused.launches``)."""
    cpu = torch.device(device).type == "cpu"
    threads = torch.get_num_threads()
    if cpu:  # many small ops: intra-op threads cost more than they give
        torch.set_num_threads(1)
    reset_counts()
    try:
        t0 = time.perf_counter()
        out = mapd.solve_offline(grid, starts, tasks, cfg, device=device)
        if not cpu:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    return out, secs, sweep_kernel.launches, hostsync.count


def _parity(phase: str, scn, dev: torch.device) -> None:
    grid, starts, tasks, cfg = scn.build(seed=0)
    with fused_env(""):
        (pc, sc, mc), secs_c, launches_c, syncs_c = _timed_solve(
            grid, starts, tasks, cfg, dev)
        (pp, sp, mp), secs_p, launches_p, _ = _timed_solve(
            grid, starts, tasks, cfg, "cpu")
    same = (mc == mp and np.array_equal(pc, pp) and np.array_equal(sc, sp))
    emit(phase, scenario=scn.name, mode=scn.mode, makespan_cuda=mc,
         makespan_cpu=mp, identical=same, cuda_seconds=secs_c,
         cpu_seconds=secs_p, cuda_ms_per_step=1e3 * secs_c / max(mc, 1),
         sweep_launches_cuda=launches_c, sweep_launches_cpu=launches_p,
         host_syncs_cuda=syncs_c,
         invariants_ok=_verify_paths(cfg.width, grid.free, pc))
    check(same, f"{scn.name}: cuda and cpu solves differ")
    check(launches_c > 0, f"{scn.name}: the CUDA solve launched no sweep_scan")
    check(launches_p == 0, f"{scn.name}: the CPU solve launched the kernel")


def phase_parity(dev: torch.device) -> None:
    _parity("parity", scenarios.REFERENCE_DEMO, dev)


def phase_stale_parity(dev: torch.device) -> None:
    _parity("stale_parity", scenarios.REFERENCE_DEMO_DECENT_STALE, dev)


def phase_congested(dev: torch.device) -> dict:
    """The stale-view solve of the congested rung to completion, with the
    multi kernel (``MAPD_FUSED=1``, this slice's path: counts set to 0 just
    before, read just after) and with the sweeps; both must agree."""
    scn = scenarios.CONGESTED_DECENT_STALE
    grid, starts, tasks, cfg = scn.build(seed=0)
    runs = {}
    for label, env in (("fused", "1"), ("default", "")):
        with fused_env(env):
            (paths, states, makespan), secs, sweeps, syncs = _timed_solve(
                grid, starts, tasks, cfg, dev)
            fused = dict(field_fused.launches)
        steps = max(makespan, 1)
        runs[label] = {
            "paths": paths, "states": states, "makespan": makespan,
            "seconds": secs, "ms_per_step": 1e3 * secs / steps,
            "host_syncs_per_step": syncs / steps,
            "sweep_launches": sweeps, "multi_launches": fused["multi"],
            "single_launches": fused["single"],
            "completed": 0 < makespan <= cfg.max_timesteps,
            "invariants_ok": _verify_paths(cfg.width, grid.free, paths)}
    f, d = runs["fused"], runs["default"]
    identical = (f["makespan"] == d["makespan"]
                 and np.array_equal(f["paths"], d["paths"])
                 and np.array_equal(f["states"], d["states"]))
    out = {"scenario": scn.name, "mode": scn.mode, "agents": cfg.num_agents,
           "grid": [cfg.height, cfg.width], "identical": identical,
           **{f"{label}_{k}": v for label, run in runs.items()
              for k, v in run.items() if k not in ("paths", "states")}}
    emit("congested", **out)
    for label, run in runs.items():
        check(run["completed"], f"congested {label}: not completed")
        check(run["invariants_ok"], f"congested {label}: illegal transition")
    check(identical, "congested: fused and default solves differ")
    check(f["multi_launches"] > 0 and f["sweep_launches"] == 0,
          "congested fused: the path did not run the multi kernel alone")
    check(d["multi_launches"] == 0 and d["sweep_launches"] > 0,
          "congested default: the path did not run the sweeps alone")
    return out


def phase_medium(dev: torch.device) -> dict:
    scn = scenarios.MEDIUM
    grid, starts, tasks, cfg = scn.build(seed=0)
    with fused_env(""):
        (paths, _, makespan), secs, launches, syncs = _timed_solve(
            grid, starts, tasks, cfg, dev)
    completed = 0 < makespan <= cfg.max_timesteps
    inv_ok = _verify_paths(cfg.width, grid.free, paths)
    emit("medium", scenario=scn.name, mode=scn.mode, makespan=makespan,
         completed=completed, invariants_ok=inv_ok, seconds=secs,
         ms_per_step=1e3 * secs / max(makespan, 1),
         sweep_launches_per_step=launches / max(makespan, 1),
         host_syncs_per_step=syncs / max(makespan, 1))
    check(completed, "1k-512 did not complete within its horizon")
    check(inv_ok, "1k-512 recorded an illegal transition")
    return {"paths": paths, "makespan": makespan,
            "ms_per_step": 1e3 * secs / max(makespan, 1)}


def _steps(cfg, s, tasks_t, free, steps: int, step=None, step_free=None,
           trail=None) -> tuple:
    """``steps`` calls of ``step`` (``mapd_step``, or a sharded solver's
    step on ``step_free``) with ``step_invariants`` folded over each;
    returns the state, whether every step held, and the seconds.  With
    ``trail``, each step's (pos, goal, slot) is appended as a copy on the
    card (no host sync)."""
    step = step or mapd.mapd_step
    step_free = free if step_free is None else step_free
    ok = torch.ones((), dtype=torch.bool, device=free.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        prev = s.pos
        s = step(cfg, s, tasks_t, step_free)
        ok = ok & invariants.step_invariants(cfg, prev, s.pos, free)
        if trail is not None:
            trail.append(torch.stack([s.pos, s.goal, s.slot]))
    torch.cuda.synchronize()
    return s, bool(ok), time.perf_counter() - t0


def _counts() -> dict:
    return {"sweep": sweep_kernel.launches, "syncs": hostsync.count,
            **field_fused.launches}


def _flagship_window(cfg, starts, tasks, free, dev, on_prime=None,
                     prepare=None, step=None, trail=None,
                     warmup=FLAGSHIP_WARMUP, window=FLAGSHIP_WINDOW) -> dict:
    """The prime burst, the warm-up steps and the timed window of the
    flagship (or of another rung), counts set to 0 just before and read
    just after.  ``on_prime(state)`` sees the state right after the
    prime; ``prepare()`` -> (state, tasks, step_free) and ``step`` replace
    the flat solve's (the sharded solvers), ``trail`` keeps each step's
    (pos, goal, slot)."""
    reset_counts()
    t0 = time.perf_counter()
    if prepare is None:
        s, tasks_t = mapd.prepare_state(cfg, starts, tasks, free,
                                        device=dev)
        step_free = free
    else:
        s, tasks_t, step_free = prepare()
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    prime = _counts()
    if on_prime is not None:
        on_prime(s)
    s, ok_warm, _ = _steps(cfg, s, tasks_t, free, warmup, step, step_free,
                           trail)
    before = _counts()
    s, ok_win, window_s = _steps(cfg, s, tasks_t, free, window, step,
                                 step_free, trail)
    after = _counts()
    per_step = {k: (after[k] - before[k]) / window for k in after}
    return {"prepare_seconds": prepare_s, "prime_counts": prime,
            "ms_per_step": 1e3 * window_s / window,
            "host_syncs_per_step": per_step["syncs"],
            "per_step_counts": per_step, "main_path_counts": after,
            "invariants_ok": ok_warm and ok_win, "t": int(s.t),
            "tasks_used": int(s.task_used.sum()),
            "packed_rows_bytes": s.dirs.numel() * s.dirs.element_size()}


def phase_flagship(dev: torch.device) -> dict:
    scn = scenarios.FLAGSHIP
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trail: list = []
    with fused_env(""):  # the main path of sweep_scan
        win = _flagship_window(cfg, starts, tasks, free, dev, trail=trail)
    main = win["main_path_counts"]
    out = {"scenario": scn.name, "agents": cfg.num_agents,
           "grid": [cfg.height, cfg.width],
           "warmup_steps": FLAGSHIP_WARMUP, "window_steps": FLAGSHIP_WINDOW,
           **win,
           "prepare_sweep_launches": win["prime_counts"]["sweep"],
           "sweep_launches_per_step": win["per_step_counts"]["sweep"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "main_path_sweep_launches": main["sweep"],
           "main_path_host_syncs": main["syncs"]}
    emit("flagship", **out)
    check(win["invariants_ok"], "flagship: a transition broke the step "
          "invariants")
    check(main["sweep"] > 0, "flagship: no sweep_scan launch on the main path")
    return {**out, "trail": trail}


def phase_flagship_single(dev: torch.device, default: dict) -> dict:
    """The flagship under ``MAPD_FUSED=single``: the prime's packed rows
    equal the default prime's, then the same window as the default path."""
    scn = scenarios.FLAGSHIP
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    with fused_env(""):
        held = {"default": mapd.prepare_state(cfg, starts, tasks, free,
                                              device=dev)[0].dirs}
    primes = {}

    def compare(s):
        primes["equal"] = bool(torch.equal(s.dirs, held.pop("default")))
        torch.cuda.empty_cache()

    with fused_env("single"):  # the main path of the single instance
        win = _flagship_window(cfg, starts, tasks, free, dev, compare)
    prime_equal = primes["equal"]
    prime, main = win["prime_counts"], win["main_path_counts"]
    check(prime_equal, "flagship: the single-kernel prime differs from the "
          "default prime")
    check(prime["single"] > 0 and prime["sweep"] == 0,
          "flagship: the single-kernel prime did not run the kernel alone")
    out = {"scenario": scn.name, "fused_mode": "single",
           "prime_equal_to_default": prime_equal,
           "warmup_steps": FLAGSHIP_WARMUP, "window_steps": FLAGSHIP_WINDOW,
           **win,
           "single_launches_per_step": win["per_step_counts"]["single"],
           "default_ms_per_step": default["ms_per_step"],
           "default_host_syncs_per_step": default["host_syncs_per_step"]}
    emit("flagship_single", **out)
    check(win["invariants_ok"], "flagship single: a transition broke the "
          "step invariants")
    check(main["single"] > 0 and main["sweep"] == 0,
          "flagship single: the path did not run the single kernel alone")
    return out


class ServeFleet:
    """A closed-loop stand-in for the C++ centralized manager: the fleet
    state it sends each tick, and what it does with each reply (see the
    module docstring).  Lane k of the packed wire is agent k (one roster,
    no joins or leaves)."""

    IDLE, PICKUP, DELIVERY = 0, 1, 2

    def __init__(self, grid, starts, tasks):
        self.w = grid.width
        self.free = np.asarray(grid.free).reshape(-1)
        self.tasks = np.asarray(tasks, np.int64)
        n = len(starts)
        self.names = [f"a{k}" for k in range(n)]
        self.pos = np.asarray(starts, np.int64).copy()
        self.goal = self.pos.copy()
        self.task = np.full(n, -1, np.int64)
        self.phase = np.zeros(n, np.int8)
        self.requeued: list = []
        self.next_task = 0
        self.completed = 0
        self.exchanges = 0

    def _take(self, k: int) -> None:
        if self.requeued:
            t = self.requeued.pop(0)
        else:
            t = self.next_task % len(self.tasks)
            self.next_task += 1
        self.task[k], self.phase[k] = t, self.PICKUP
        self.goal[k] = self.tasks[t, 0]

    def transitions(self) -> None:
        """Arrivals, then idle agents take the next task."""
        at = self.pos == self.goal
        for k in np.flatnonzero(at & (self.phase == self.PICKUP)):
            self.phase[k] = self.DELIVERY
            self.goal[k] = self.tasks[self.task[k], 1]
        done = (self.pos == self.goal) & (self.phase == self.DELIVERY)
        self.completed += int(done.sum())
        self.phase[done] = self.IDLE
        self.task[done] = -1
        for k in np.flatnonzero(self.phase == self.IDLE):
            self._take(int(k))

    def items(self) -> list:
        return list(zip(self.names, self.pos.tolist(), self.goal.tolist()))

    def json_request(self, seq: int) -> dict:
        w = self.w
        return {"type": "plan_request", "seq": seq, "agents": [
            {"peer_id": n, "pos": [p % w, p // w], "goal": [g % w, g // w]}
            for n, p, g in self.items()]}

    def certify(self, lanes, npos) -> bool:
        """The move set of one reply: unit steps, on free cells,
        vertex-disjoint over the whole fleet."""
        nxt = self.pos.copy()
        nxt[lanes] = npos
        d = (np.abs(nxt % self.w - self.pos % self.w)
             + np.abs(nxt // self.w - self.pos // self.w))
        return bool((d <= 1).all() and self.free[nxt].all()
                    and np.unique(nxt).size == nxt.size)

    def adopt(self, lanes, npos, ngoal) -> None:
        """Moves, and goal exchanges with the task following its goal."""
        lanes = np.asarray(lanes, np.int64)
        self.pos[lanes] = npos
        old = self.goal.copy()
        new = old.copy()
        new[lanes] = ngoal
        changed = np.flatnonzero(new != old)
        if changed.size == 0:
            return
        donors: dict = {}
        for k in changed:
            donors.setdefault(int(old[k]), []).append(int(k))
        task, phase = self.task.copy(), self.phase.copy()
        incoming, donated = {}, set()
        for k in changed:
            for j in donors.get(int(new[k]), ()):
                if j in donated or j == k:
                    continue
                incoming[int(k)] = (task[j], phase[j])
                donated.add(j)
                break
        for k in (int(k) for k in changed):
            if k in donated and k not in incoming:
                self.task[k], self.phase[k] = -1, self.IDLE
                self.goal[k] = self.pos[k]
            elif k in incoming:
                if k not in donated and task[k] >= 0:
                    self.requeued.append(int(task[k]))
                t, ph = incoming[k]
                # an idle donor's positional goal leaves the agent idle
                self.task[k], self.phase[k] = t, (ph if t >= 0 else
                                                  self.IDLE)
                self.goal[k] = (self.pos[k] if t < 0 else
                                self.tasks[t, 1 if ph == self.DELIVERY
                                           else 0])
                self.exchanges += 1


class _PhaseBeats:
    """The heartbeat hook of ``TickRunner``: keeps each served tick's
    per-phase ms (the service's ``last_phase_ms`` plus decode and
    encode) instead of writing them to a file."""

    def __init__(self):
        self.over_budget_ticks = 0
        self.ticks: list = []

    def beat(self, seq, agents, phase_ms, counters=None) -> None:
        self.ticks.append(dict(phase_ms))


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _layer_counters() -> dict:
    c = registry.get_registry().snapshot()["counters"]
    return {k: c.get(k, 0) for k in LAYER_COUNTERS}


def _serve(scn, dev: torch.device, ticks: int, fused: str = "",
           keep_bytes: bool = True, env=None, world=None, mesh=None) -> dict:
    """Serve ``scn`` (seed 0) through the port's ``TickRunner`` on ``dev``:
    one packed snapshot, then ``ticks`` delta ticks of the closed-loop
    fleet, every move set certified.  Counts are set to 0 just before the
    snapshot and read after the last tick.  ``env`` is set around the run
    (``JG_DYNAMIC_WORLD``, ``JG_SECTOR``); ``world(seq, runner, fleet)``
    may send world updates before each tick, and then the field queue is
    drained after each tick, as the daemon's idle window does.  ``mesh``
    serves on a ``SolverMesh`` instead of one device."""
    grid, starts, tasks, _ = scn.build(seed=0)
    fleet = ServeFleet(grid, starts, tasks)
    fleet.free = fleet.free.copy()  # the live mask the moves are held to
    beats = _PhaseBeats()
    with fused_env(fused), env_vars(env or {}):
        svc = solverd.PlanService(grid, device=dev, mesh=mesh)
        runner = solverd.TickRunner(svc, grid, heartbeat=beats)
        enc = pcodec.PackedFleetEncoder(snapshot_every=NO_SNAPSHOT)
        datas, tick_ms, fresh, syncs, launches = [], [], [], [], []
        idle_ms = []
        certified = True
        layers0 = _layer_counters()
        reset_counts()
        for seq in range(ticks + 1):
            if world is not None:
                world(seq, runner, fleet)
            fleet.transitions()
            req = {"type": "plan_request", "seq": seq,
                   "codec": pcodec.CODEC_NAME, "caps": [pcodec.CODEC_NAME],
                   "data": pcodec.encode_b64(
                       enc.encode_tick(seq, fleet.items()))}
            c0, m0 = _counts(), svc.cache_misses
            t0 = time.perf_counter()
            resp = runner.handle(req)
            ms = 1e3 * (time.perf_counter() - t0)
            c1 = _counts()
            check(resp is not None, f"{scn.name}: no reply at seq {seq}")
            rp = pcodec.decode_b64(resp["data"])
            check(rp.seq == seq, f"{scn.name}: reply seq {rp.seq} != {seq}")
            ok = fleet.certify(rp.idx, rp.pos)
            certified = certified and ok
            check(ok, f"{scn.name}: tick {seq} moves are not certified")
            fleet.adopt(rp.idx, rp.pos, rp.goal)
            if keep_bytes:
                datas.append(resp["data"])
            if world is not None:
                t1 = time.perf_counter()
                while svc.field_queue:
                    svc.process_field_queue()
                idle_ms.append(1e3 * (time.perf_counter() - t1))
            if seq == 0:
                snap = {"snapshot_ms": ms, "snapshot_fresh_sweeps":
                        svc.cache_misses - m0,
                        "snapshot_launches": {k: c1[k] - c0[k]
                                              for k in c1}}
                continue
            tick_ms.append(ms)
            fresh.append(svc.cache_misses - m0)
            syncs.append(c1["syncs"] - c0["syncs"])
            launches.append({k: c1[k] - c0[k] for k in c1 if k != "syncs"})
        main_counts = _counts()
    phases = {k: statistics.median(t[k] for t in beats.ticks[1:])
              for k in beats.ticks[-1]}
    per_tick = {k: sum(x[k] for x in launches) / ticks for k in launches[0]}
    rows = int(svc.dirs.shape[0])
    out = {
        "scenario": scn.name, "agents": len(starts),
        "grid": [grid.height, grid.width], "fused_mode": fused or "unset",
        "delta_ticks": ticks, **snap,
        "tick_ms_p50": _pct(tick_ms, 50), "tick_ms_p95": _pct(tick_ms, 95),
        "tick_ms_max": max(tick_ms), "tick_ms_mean": float(np.mean(tick_ms)),
        "phase_ms_median": phases,
        "fresh_sweeps_per_tick": sum(fresh) / ticks,
        "host_syncs_per_tick": sum(syncs) / ticks,
        "launches_per_tick": per_tick,
        "main_path_counts": main_counts,
        "cache_rows_used": len(svc.goal_rows), "cache_rows": rows,
        "cache_bytes": svc.dirs.numel() * svc.dirs.element_size(),
        "tasks_completed": fleet.completed,
        "goal_exchanges_adopted": fleet.exchanges,
        "over_budget_ticks": sum(1 for m in tick_ms
                                 if m > solverd.TICK_BUDGET_MS),
        "certified": certified, "recompiles": svc.recompiles}
    layers1 = _layer_counters()
    out["layer_counters"] = {k: layers1[k] - layers0[k]
                             for k in LAYER_COUNTERS}
    out["dist_mirrors"] = len(svc.dist_mirror)
    if idle_ms:
        out["idle_ms_p50"] = _pct(idle_ms, 50)
        out["idle_ms_max"] = max(idle_ms)
    if svc.sector is not None:
        out["sector"] = svc.sector.stats()
    if mesh is not None:
        out["mesh"] = mesh.mesh.describe()
        out["resident_shard_bytes"] = svc.resident_shard_bytes()
    return {"out": out, "datas": datas}


def phase_serve_parity(dev: torch.device) -> dict:
    """The ref rung served on both devices and both wires from one fleet;
    the fleet follows the cuda JSON reply."""
    scn = scenarios.REFERENCE_DEMO
    grid, starts, tasks, _ = scn.build(seed=0)
    fleet = ServeFleet(grid, starts, tasks)
    runners = {}
    with fused_env(""):
        for d in (dev, torch.device("cpu")):
            for wire in ("packed", "json"):
                svc = solverd.PlanService(grid, capacity_min=16, device=d)
                svc.defer_fields = False
                runners[(d.type, wire)] = solverd.TickRunner(svc, grid)
        enc = pcodec.PackedFleetEncoder(snapshot_every=NO_SNAPSHOT)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        reset_counts()
        same_dev = same_wire = True
        try:
            for seq in range(SERVE_PARITY_TICKS + 1):
                fleet.transitions()
                preq = {"type": "plan_request", "seq": seq,
                        "codec": pcodec.CODEC_NAME,
                        "caps": [pcodec.CODEC_NAME],
                        "data": pcodec.encode_b64(
                            enc.encode_tick(seq, fleet.items()))}
                jreq = fleet.json_request(seq)
                r = {k: run.handle(preq if k[1] == "packed" else jreq)
                     for k, run in runners.items()}
                same_dev = (same_dev
                            and r[("cuda", "packed")]["data"]
                            == r[("cpu", "packed")]["data"]
                            and r[("cuda", "json")]["moves"]
                            == r[("cpu", "json")]["moves"])
                check(same_dev, f"serve_parity: cuda and cpu replies differ "
                      f"at seq {seq}")
                rp = pcodec.decode_b64(r[("cuda", "packed")]["data"])
                w = grid.width
                packed_plan = {fleet.names[int(l)]: ([int(c) % w, int(c) // w],
                                                     [int(g) % w, int(g) // w])
                               for l, c, g in zip(rp.idx, rp.pos, rp.goal)}
                for m in r[("cuda", "json")]["moves"]:
                    k = fleet.names.index(m["peer_id"])
                    p, g = int(fleet.pos[k]), int(fleet.goal[k])
                    want = packed_plan.get(m["peer_id"],
                                           ([p % w, p // w], [g % w, g // w]))
                    same_wire = same_wire and want == (m["next_pos"],
                                                       m["goal"])
                check(same_wire, f"serve_parity: packed and JSON plans "
                      f"differ at seq {seq}")
                check(fleet.certify(rp.idx, rp.pos),
                      f"serve_parity: tick {seq} moves are not certified")
                fleet.adopt(rp.idx, rp.pos, rp.goal)
        finally:
            torch.set_num_threads(threads)
        counts = _counts()
    out = {"scenario": scn.name, "ticks": SERVE_PARITY_TICKS,
           "identical_across_devices": same_dev,
           "packed_equals_json": same_wire,
           "tasks_completed": fleet.completed,
           "goal_exchanges_adopted": fleet.exchanges,
           "main_path_counts": counts}
    emit("serve_parity", **out)
    check(counts["sweep"] > 0, "serve_parity: the cuda runners launched no "
          "sweep_scan")
    return out


def _serve_pair(phase: str, scn, dev, ticks: int, fused: str,
                keep=None) -> dict:
    """``scn`` served unset and under ``MAPD_FUSED=fused``: replies
    identical, every tick certified, each run through its own kernel.
    ``keep`` (a dict) receives the unset run's reply bytes."""
    runs = {}
    for label, mode in (("unset", ""), (fused, fused)):
        runs[label] = _serve(scn, dev, ticks, mode)
        torch.cuda.empty_cache()
    a, b = runs["unset"], runs[fused]
    identical = a["datas"] == b["datas"]
    if keep is not None:
        keep["datas"] = a["datas"]
    instance = "single" if fused == "single" else "multi"
    out = {"scenario": scn.name, "identical": identical,
           "unset": a["out"], fused: b["out"]}
    emit(phase, **out)
    check(identical, f"{phase}: replies differ between unset and "
          f"MAPD_FUSED={fused}")
    ua, ub = a["out"]["main_path_counts"], b["out"]["main_path_counts"]
    check(ua["sweep"] > 0 and ua[instance] == 0,
          f"{phase} unset: the path did not run sweep_scan alone")
    check(ub[instance] > 0 and ub["sweep"] == 0,
          f"{phase} {fused}: the path did not run the {instance} kernel alone")
    return out


def phase_serve_medium(dev: torch.device, keep=None) -> dict:
    return _serve_pair("serve_1k_512", scenarios.MEDIUM, dev,
                       SERVE_MEDIUM_TICKS, "single", keep)


def phase_serve_congested(dev: torch.device) -> dict:
    return _serve_pair("serve_congested_fused", scenarios.CONGESTED, dev,
                       SERVE_CONGESTED_TICKS, "1")


def phase_serve_flagship(dev: torch.device) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    run = _serve(scenarios.FLAGSHIP, dev, SERVE_FLAGSHIP_TICKS,
                 keep_bytes=False)["out"]
    out = {**run, "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    emit("serve_flagship", **out)
    check(run["main_path_counts"]["sweep"] > 0,
          "serve_flagship: no sweep_scan launch on the path")
    torch.cuda.empty_cache()
    return out


def _tenant_request(seq: int, fleet: ServeFleet, enc) -> dict:
    return {"type": "plan_request", "seq": seq,
            "codec": pcodec.CODEC_NAME, "caps": [pcodec.CODEC_NAME],
            "data": pcodec.encode_b64(enc.encode_tick(seq, fleet.items()))}


def _tenant_runner(grid, dev, publish, **kw):
    svc = solverd.PlanService(grid, capacity_min=16, device=dev)
    svc.defer_fields = False
    slab = solverd.TenantSlab(svc, grid)
    return solverd.MultiTenantRunner(slab, grid, publish=publish, **kw)


def phase_serve_tenants_parity(dev: torch.device) -> dict:
    """Three tenants of the ref rung on a slab of at most three, one
    closed-loop fleet each, the same frames to a runner on ``cuda`` and one
    on ``cpu``; a fourth namespace evicts the idle t2, t2 comes back with a
    snapshot resync, and an operator-plane world toggle lands mid-stream.
    The idle threshold is 0, so the least recently active tenant is the
    one evicted and nothing depends on the clock."""
    scn = scenarios.REFERENCE_DEMO
    fleets, encs = {}, {}
    for k in range(4):
        grid, starts, tasks, _ = scn.build(seed=k)
        fleets[f"t{k}"] = ServeFleet(grid, starts, tasks)
        encs[f"t{k}"] = pcodec.PackedFleetEncoder(snapshot_every=NO_SNAPSHOT)
    pubs = {"cuda": [], "cpu": []}
    runners = {}
    with fused_env(""):
        for key, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            runners[key] = _tenant_runner(
                grid, d, lambda t, m, key=key: pubs[key].append((t, m)),
                max_tenants=3, idle_evict_ms=0.0)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        reset_counts()
        certified, kinds, seqs = True, [], {ns: 0 for ns in fleets}
        toggled = None
        try:
            for tick in range(TENANT_PARITY_TICKS):
                asking = ["t0", "t1"]
                if tick < 20 or tick >= 40:
                    asking.append("t2")
                if 25 <= tick < 35:
                    asking.append("t3")
                if tick == 30:
                    taken = {int(p) for f in fleets.values() for p in f.pos}
                    cells = set(np.flatnonzero(grid.free.reshape(-1)))
                    for f in fleets.values():
                        cells -= set(f.tasks.reshape(-1).tolist())
                    # the free cell nearest the middle, off every task
                    # and every agent
                    toggled = min(cells - taken, key=lambda c: (
                        abs(c // grid.width - grid.height // 2)
                        + abs(c % grid.width - grid.width // 2), c))
                    msg = {"type": "world_update", "world_seq": 1,
                           "toggles": [[int(toggled), 1]]}
                    for run in runners.values():
                        run.handle_world(msg)
                    for f in fleets.values():
                        f.free[toggled] = False
                reqs = {}
                for ns in asking:
                    fleets[ns].transitions()
                    seqs[ns] += 1
                    reqs[ns] = _tenant_request(seqs[ns], fleets[ns],
                                               encs[ns])
                n = len(pubs["cpu"])
                for key, run in runners.items():
                    ok = [run.ingest(ns, r) for ns, r in reqs.items()]
                    run.flush_snapshot_requests()
                    p = run.begin() if any(ok) else None
                    if p is not None:
                        run.finish(p)
                strip = lambda xs: [  # noqa: E731
                    (t, {k: v for k, v in m.items()
                         if k != "duration_micros"}) for t, m in xs[n:]]
                same = strip(pubs["cuda"]) == strip(pubs["cpu"])
                check(same, f"serve_tenants_parity: cuda and cpu publishes "
                      f"differ at tick {tick}")
                for topic, m in pubs["cuda"][n:]:
                    ns = topic.split(":")[0]
                    kinds.append((ns, m["type"]))
                    if m["type"] == "plan_snapshot_request":
                        encs[ns].request_snapshot()
                    if m["type"] != "plan_response":
                        continue
                    rp = pcodec.decode_b64(m["data"])
                    ok = fleets[ns].certify(rp.idx, rp.pos)
                    certified = certified and ok
                    check(ok, f"serve_tenants_parity: {ns} tick {tick} "
                          f"moves are not certified")
                    fleets[ns].adopt(rp.idx, rp.pos, rp.goal)
        finally:
            torch.set_num_threads(threads)
        counts = _counts()
    answered = {ns: kinds.count((ns, "plan_response")) for ns in fleets}
    out = {"scenario": scn.name, "tenants": 4, "max_tenants": 3,
           "ticks": TENANT_PARITY_TICKS, "identical_across_devices": True,
           "certified": certified, "world_toggle_cell": int(toggled),
           "evicted": sorted({ns for ns, k in kinds
                              if k == "tenant_evicted"}),
           "snapshot_requests": kinds.count(("t2", "plan_snapshot_request")),
           "replies": answered,
           "tasks_completed": {ns: f.completed for ns, f in fleets.items()},
           "main_path_counts": counts}
    emit("serve_tenants_parity", **out)
    check(("t2", "tenant_evicted") in kinds, "serve_tenants_parity: the idle "
          "tenant was not evicted")
    check(out["snapshot_requests"] >= 1 and kinds[-3:].count(
        ("t2", "plan_response")) == 1, "serve_tenants_parity: t2 was not "
          "re-admitted with a snapshot resync")
    check(counts["sweep"] > 0, "serve_tenants_parity: the cuda runner "
          "launched no sweep_scan")
    return out


def _serve_tenants(dev: torch.device, fused: str, compare: bool) -> dict:
    """The 8-tenant 1k-512 stream through one ``MultiTenantRunner`` on
    ``dev``: a snapshot burst, then TENANT_TICKS delta bursts in which
    every tenant asks.  With ``compare``, each tenant's stream also goes
    to its own single-tenant ``TickRunner`` on ``dev`` and every reply
    must be the same bytes.  Counts are summed over the super-step bursts
    only."""
    fleets, encs, singles = [], [], []
    for k in range(TENANTS):
        grid, starts, tasks, _ = scenarios.MEDIUM.build(seed=k)
        fleets.append(ServeFleet(grid, starts, tasks))
        encs.append(pcodec.PackedFleetEncoder(snapshot_every=NO_SNAPSHOT))
    names = [f"t{k}" for k in range(TENANTS)]
    pub = []
    with fused_env(fused):
        runner = _tenant_runner(grid, dev, lambda t, m: pub.append((t, m)))
        svc = runner.slab.service
        if compare:
            for _ in range(TENANTS):
                s = solverd.PlanService(grid, device=dev)
                s.defer_fields = False
                singles.append(solverd.TickRunner(s, grid))
        datas, tick_ms, single_ms, phases = [], [], [], []
        syncs, launches = [], []
        total = {k: 0 for k in _counts()}
        certified = same = True
        for seq in range(TENANT_TICKS + 1):
            reqs = []
            for f, enc in zip(fleets, encs):
                f.transitions()
                reqs.append(_tenant_request(seq, f, enc))
            del pub[:]
            m0 = svc.cache_misses
            reset_counts()
            t0 = time.perf_counter()
            for ns, r in zip(names, reqs):
                check(runner.ingest(ns, r), f"tenants: {ns} seq {seq} "
                      f"was not taken")
            t1 = time.perf_counter()
            p = runner.begin()
            t2 = time.perf_counter()
            runner.finish(p)
            t3 = time.perf_counter()
            c = _counts()
            for k in total:
                total[k] += c[k]
            ms = 1e3 * (t3 - t0)
            got = dict(pub)
            check(len(got) == TENANTS, f"tenants: {len(got)} replies at "
                  f"seq {seq}")
            burst = []
            for k, ns in enumerate(names):
                m = got[f"{ns}:solver"]
                rp = pcodec.decode_b64(m["data"])
                check(rp.seq == seq, f"tenants: {ns} reply seq {rp.seq}")
                ok = fleets[k].certify(rp.idx, rp.pos)
                certified = certified and ok
                check(ok, f"tenants: {ns} tick {seq} moves are not "
                      f"certified")
                burst.append(m["data"])
                if compare:
                    s0 = time.perf_counter()
                    want = singles[k].handle(reqs[k])
                    single_ms.append((seq, 1e3 * (time.perf_counter() - s0)))
                    same = same and want["data"] == m["data"]
                    check(same, f"tenants: {ns} reply at seq {seq} differs "
                          f"from its single-tenant reply")
                fleets[k].adopt(rp.idx, rp.pos, rp.goal)
            datas.append(burst)
            if seq == 0:
                snap = {"snapshot_burst_ms": ms,
                        "snapshot_fresh_sweeps": svc.cache_misses - m0,
                        "snapshot_launches": {k: c[k] for k in c}}
                continue
            tick_ms.append(ms)
            phases.append({"decode": 1e3 * (t1 - t0),
                           "step_dispatch": 1e3 * (t2 - t1),
                           **runner.last_phase_ms})
            syncs.append(c["syncs"])
            launches.append({k: c[k] for k in c if k != "syncs"})
    sums = {}
    for seq, ms in single_ms:
        if seq:
            sums[seq] = sums.get(seq, 0.0) + ms
    rows = int(svc.dirs.shape[0])
    out = {
        "scenario": scenarios.MEDIUM.name, "tenants": TENANTS,
        "agents_per_tenant": len(fleets[0].names),
        "grid": [grid.height, grid.width], "fused_mode": fused or "unset",
        "delta_ticks": TENANT_TICKS, **snap,
        "slab": [runner.slab.T_cap, runner.slab.L_cap],
        "slab_lanes_active": int(runner.slab.h_active.sum()),
        "tick_ms_p50": _pct(tick_ms, 50), "tick_ms_p95": _pct(tick_ms, 95),
        "tick_ms_max": max(tick_ms), "tick_ms_mean": float(np.mean(tick_ms)),
        "phase_ms_median": {k: statistics.median(x[k] for x in phases)
                            for k in phases[0]},
        "host_syncs_per_tick": sum(syncs) / TENANT_TICKS,
        "launches_per_tick": {k: sum(x[k] for x in launches) / TENANT_TICKS
                              for k in launches[0]},
        "main_path_counts": total,
        "cache_rows_used": len(svc.goal_rows), "cache_rows": rows,
        "cache_bytes": svc.dirs.numel() * svc.dirs.element_size(),
        "tasks_completed": sum(f.completed for f in fleets),
        "over_budget_ticks": sum(1 for m in tick_ms
                                 if m > solverd.TICK_BUDGET_MS),
        "certified": certified}
    if compare:
        out["identical_to_single_tenant"] = same
        out["single_tenant_sum_ms_p50"] = _pct(list(sums.values()), 50)
        out["single_tenant_sum_ms_mean"] = float(np.mean(list(
            sums.values())))
        out["single_tenant_tick_ms_p50"] = _pct(
            [ms for seq, ms in single_ms if seq], 50)
    return {"out": out, "datas": datas}


def phase_serve_tenants(dev: torch.device) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    a = _serve_tenants(dev, "", compare=True)
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    b = _serve_tenants(dev, "single", compare=False)
    torch.cuda.empty_cache()
    identical = a["datas"] == b["datas"]
    out = {"scenario": f"{TENANTS}x{scenarios.MEDIUM.name}",
           "identical": identical, "max_memory_allocated": peak,
           "unset": a["out"], "single": b["out"]}
    emit("serve_tenants_8x1k_512", **out)
    check(identical, "serve_tenants_8x1k_512: replies differ between unset "
          "and MAPD_FUSED=single")
    ua, ub = a["out"]["main_path_counts"], b["out"]["main_path_counts"]
    check(ua["sweep"] > 0 and ua["single"] == 0,
          "serve_tenants_8x1k_512 unset: the path did not run sweep_scan "
          "alone")
    check(ub["single"] > 0 and ub["sweep"] == 0,
          "serve_tenants_8x1k_512 single: the path did not run the single "
          "kernel alone")
    return out


def phase_checkpoint(dev: torch.device, tmpdir: str) -> dict:
    """The ref rung solved on the card: saved at step CHECKPOINT_STEP,
    loaded into a fresh state and finished, against the uninterrupted
    solve."""
    scn = scenarios.REFERENCE_DEMO
    grid, starts, tasks, cfg = scn.build(seed=0)
    free = torch.from_numpy(grid.free).to(dev)

    def finish(s, tasks_t):
        while not hostsync.flag(mapd._finished(cfg, s)):
            s = mapd.mapd_step(cfg, s, tasks_t, free)
        return s

    with fused_env(""):
        ref, tasks_t = mapd.prepare_state(cfg, starts, tasks, free, dev)
        ref = finish(ref, tasks_t)
        s, _ = mapd.prepare_state(cfg, starts, tasks, free, dev)
        for _ in range(CHECKPOINT_STEP):
            s = mapd.mapd_step(cfg, s, tasks_t, free)
        path = os.path.join(tmpdir, "ref_step60.npz")
        checkpoint.save_state(path, s, extra={"step": CHECKPOINT_STEP})
        del s
        restored = checkpoint.load_state(
            path, cfg, expected_num_tasks=int(tasks_t.shape[0]), device=dev)
        done = finish(restored, tasks_t)
    makespan = int(ref.t)
    identical = (int(done.t) == makespan
                 and bool(torch.equal(done.paths_pos, ref.paths_pos))
                 and bool(torch.equal(done.paths_state, ref.paths_state))
                 and bool(torch.equal(done.pos, ref.pos)))
    out = {"scenario": scn.name, "saved_at_step": CHECKPOINT_STEP,
           "makespan": makespan, "makespan_resumed": int(done.t),
           "identical": identical,
           "archive_bytes": os.path.getsize(path),
           "extra": int(checkpoint.load_extra(path)["step"])}
    emit("checkpoint", **out)
    check(makespan > CHECKPOINT_STEP, "checkpoint: solve ended before the "
          "save step")
    check(identical, "checkpoint: the resumed solve differs")
    return out


# ---------------------------------------------------------------------------
# dynamic worlds: field repair and the sector planner
# ---------------------------------------------------------------------------

ROOM = (402, 522, 402, 522)  # top, bottom, left, right walls of the room
DOOR = (402, 462)            # on the top wall, over an aisle column


def _room_world(free: np.ndarray) -> np.ndarray:
    """The flagship warehouse with a closed room (walls on rows 402, 522
    and columns 402, 522; the shelves inside untouched): its door, when it
    opens, re-routes only the room, a region larger than
    ``DIJKSTRA_MAX_CELLS``."""
    free = free.copy()
    top, bottom, left, right = ROOM
    free[[top, bottom], left:right + 1] = False
    free[top:bottom + 1, [left, right]] = False
    return free


def _wall_on_route(dist: np.ndarray, free: np.ndarray, w: int,
                   rng: np.random.Generator, avoid: set) -> list:
    """Three cells of a route of ``dist``'s field: from a reachable start,
    the 10th, 11th and 12th steps down the field (none in ``avoid``)."""
    flat, fr = dist.reshape(-1), free.reshape(-1)
    h = flat.size // w
    starts = np.flatnonzero((flat < INF) & (flat > 20) & fr)
    while True:
        c = int(rng.choice(starts))
        route = []
        for _ in range(12):
            y, x = divmod(c, w)
            nbrs = [n for n in (c - w if y else -1,
                                c + w if y + 1 < h else -1,
                                c - 1 if x else -1,
                                c + 1 if x + 1 < w else -1)
                    if n >= 0 and fr[n]]
            c = min(nbrs, key=lambda n: (flat[n], n))
            route.append(c)
        wall = route[9:12]
        if not avoid.intersection(wall):
            return wall


def phase_repair(dev: torch.device, card: str) -> dict:
    """Incremental field repair at the flagship's size: 16 goals swept
    with distances on the card, then 8 events of a 3-cell wall closing
    across a route, then the room's door opening; every repaired field of
    every event equals a full recompute on the card.  Against it, the
    full recompute's time per field (the sweeps, and the fused kernel
    under ``MAPD_FUSED=single``)."""
    grid = scenarios.FLAGSHIP.grid_fn()
    h, w = grid.height, grid.width
    free = _room_world(np.asarray(grid.free))
    rng = np.random.default_rng(0)
    top, bottom, left, right = ROOM
    outside = free.copy()
    outside[top:bottom + 1, left:right + 1] = False
    goals = rng.choice(np.flatnonzero(outside.reshape(-1)), REPAIR_GOALS,
                       replace=False).astype(np.int32)
    goals_t = torch.from_numpy(goals).to(dev)

    def full(f: np.ndarray) -> np.ndarray:
        return distance.distance_fields(torch.from_numpy(f).to(dev),
                                        goals_t).cpu().numpy()

    fields = list(full(free))
    door = DOOR[0] * w + DOOR[1]
    avoid = set(goals.tolist()) | {door}
    events = []
    for e in range(REPAIR_EVENTS):
        events.append(("wall", _wall_on_route(fields[e % REPAIR_GOALS],
                                              free, w, rng, avoid), True))
    events.append(("door", [door], False))
    repair_ms, row_ms, per_event, fallbacks = [], [], [], 0
    all_equal = True
    for kind, cells, blocked in events:
        for c in cells:
            free.reshape(-1)[c] = not blocked
        reset_counts()
        t_event = []
        for k in range(REPAIR_GOALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = field_repair.repair_field(fields[k], free, cells,
                                            device=dev)
            t1 = time.perf_counter()
            if res is None:
                fallbacks += 1
                continue
            new, (y0, y1, x0, x1) = res
            b0, b1 = max(0, y0 - 1), min(h, y1 + 1)
            codes = field_repair.directions_np(new, free, b0, b1)
            field_repair.pack_rows_np(codes.reshape(-1))
            t2 = time.perf_counter()
            repair_ms.append(1e3 * (t1 - t0))
            row_ms.append(1e3 * (t2 - t0))
            t_event.append(1e3 * (t1 - t0))
            fields[k] = new
        launches = sweep_kernel.launches
        ref = full(free)
        same = all(np.array_equal(fields[k], ref[k])
                   for k in range(REPAIR_GOALS))
        all_equal = all_equal and same
        fields = list(ref)  # fallbacks take the full recompute
        per_event.append({"kind": kind, "cells": cells,
                          "sweep_scan_launches": launches,
                          "repairs": len(t_event),
                          "repair_ms_max": max(t_event, default=0.0),
                          "equal_to_full": same})
        check(same, f"repair_1024: a repaired field differs from the full "
              f"recompute after the {kind} event {cells}")
    free_t = torch.from_numpy(free).to(dev)
    times = {}
    for label, mode in (("sweeps", ""), ("fused_single", "single")):
        with fused_env(mode):
            for g in (1, 8):
                gv = goals_t[:g]

                def run():
                    if mode:
                        return distance.pack_directions(
                            distance.direction_fields(free_t, gv).reshape(
                                g, -1))
                    d = distance.distance_fields(free_t, gv)
                    return distance.pack_directions(
                        distance.directions_from_distance(d, free_t)
                        .reshape(g, -1))

                run()
                runs = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    runs.append(1e3 * (time.perf_counter() - t0) / g)
                times[f"{label}_chunk{g}_ms_per_field"] = \
                    statistics.median(runs)
    walls = [e for e in per_event if e["kind"] == "wall"]
    door_ev = per_event[-1]
    out = {"grid": [h, w], "goals": REPAIR_GOALS, "events": per_event,
           "repair_ms_p50": _pct(repair_ms, 50),
           "repair_ms_p95": _pct(repair_ms, 95),
           "repair_ms_max": max(repair_ms),
           "repair_row_ms_p50": _pct(row_ms, 50),
           "repair_row_ms_p95": _pct(row_ms, 95),
           "full_recompute": times, "fallbacks": fallbacks,
           "sweep_scan_launches_per_wall_event": float(np.mean(
               [e["sweep_scan_launches"] for e in walls])),
           "sweep_scan_launches_door_event": door_ev["sweep_scan_launches"],
           "window_ceiling": field_repair.default_max_window(h * w, dev),
           "equal_to_full": all_equal, "card": card}
    emit("repair_1024", **out)
    check(door_ev["sweep_scan_launches"] > 0, "repair_1024: the door's "
          "repair windows did not sweep by sweep_scan")
    return out


def phase_sector(dev: torch.device, card: str, fresh_ms: float) -> dict:
    """The sector planner at the flagship's size (S = 64): the portal graph
    built on the card (jit path) and on the CPU (host path), equal; 20
    goals planned from 2 starts each on both, packed rows and distances
    equal; ε of each start against the full field on the card within the
    committed bound."""
    grid = scenarios.FLAGSHIP.grid_fn()
    h, w = grid.height, grid.width
    free = np.asarray(grid.free)
    masks = {"cuda": free.copy(), "cpu": free.copy()}
    planners, build_s = {}, {}
    reset_counts()
    for key, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planners[key] = sector.SectorPlanner(masks[key], s=SECTOR_CELLS,
                                             device=d)
        torch.cuda.synchronize()
        build_s[key] = time.perf_counter() - t0
    build_launches = sweep_kernel.launches
    pc, ph = planners["cuda"], planners["cpu"]
    check(pc.use_jit and not ph.use_jit, "sector_1024: the planners did not "
          "take the card's jit path and the CPU's host path")
    same_graph = pc.graph_state() == ph.graph_state()
    check(same_graph, "sector_1024: portal graphs differ between cuda and "
          "cpu")
    rng = np.random.default_rng(1)
    cells = np.flatnonzero(free.reshape(-1))
    goals = rng.choice(cells, SECTOR_GOALS, replace=False).astype(np.int32)
    ref = distance.distance_fields(torch.from_numpy(free).to(dev),
                                   torch.from_numpy(goals).to(dev)
                                   ).cpu().numpy().reshape(SECTOR_GOALS, -1)
    plan_ms = {"cuda": [], "cpu": []}
    launches, eps, corridor = [], [], []
    same_rows = True
    for k, g in enumerate(goals.tolist()):
        reach = cells[(ref[k][cells] < INF) & (cells != g)]
        starts = [int(c) for c in rng.choice(reach, SECTOR_STARTS,
                                             replace=False)]
        plans = {}
        for key, p in planners.items():
            before = sweep_kernel.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans[key] = p.plan_goal(g, starts, keep_dist=True)
            plan_ms[key].append(1e3 * (time.perf_counter() - t0))
            if key == "cuda":
                launches.append(sweep_kernel.launches - before)
        a, b = plans["cuda"], plans["cpu"]
        same_rows = (same_rows and np.array_equal(a.packed, b.packed)
                     and np.array_equal(a.dist, b.dist))
        corridor.append(len(a.sectors))
        for st in starts:
            eps.append((int(a.dist.reshape(-1)[st]) - int(ref[k][st]))
                       / max(1, int(ref[k][st])))
    check(same_rows, "sector_1024: corridor plans differ between cuda and "
          "cpu")
    check(max(eps) <= SECTOR_EPS, f"sector_1024: eps {max(eps)} over the "
          f"bound {SECTOR_EPS}")
    # one world toggle, repaired incrementally on both
    tog = [int(c) for c in rng.choice(cells, 3, replace=False)]
    toggle_ms = {}
    for key, p in planners.items():
        masks[key].reshape(-1)[tog] = False
        t0 = time.perf_counter()
        p.apply_toggles(tog)
        toggle_ms[key] = 1e3 * (time.perf_counter() - t0)
    check(pc.graph_state() == ph.graph_state(), "sector_1024: repaired "
          "portal graphs differ between cuda and cpu")
    out = {"grid": [h, w], "sector_cells": SECTOR_CELLS,
           "sectors": pc.sy * pc.sx,
           "portal_cells": pc.stats()["portal_cells"],
           "build_seconds": build_s, "build_sweep_scan_launches":
               build_launches, "graph_equal": same_graph,
           "plans": SECTOR_GOALS, "starts_per_plan": SECTOR_STARTS,
           "plan_ms_p50": {k: _pct(v, 50) for k, v in plan_ms.items()},
           "plan_ms_p95": {k: _pct(v, 95) for k, v in plan_ms.items()},
           "fresh_sweep_ms_per_goal": fresh_ms,
           "sweep_scan_launches_per_plan": float(np.mean(launches)),
           "corridor_sectors_mean": float(np.mean(corridor)),
           "corridor_sectors_max": max(corridor),
           "rows_equal": same_rows, "eps_max": max(eps),
           "eps_mean": float(np.mean(eps)), "eps_bound": SECTOR_EPS,
           "toggle_repair_ms": toggle_ms, "card": card}
    emit("sector_1024", **out)
    check(out["sweep_scan_launches_per_plan"] > 0, "sector_1024: the plans "
          "on the card launched no sweep_scan")
    return out


class WallToggler:
    """Every ``WALL_EVERY`` ticks a 3-cell wall closes near an agent's
    route, and the next time it opens again: world_update frames to the
    runner, the fleet's live mask kept in step.  The wall never covers an
    agent, a goal or a task's cell."""

    def __init__(self, grid):
        self.w, self.h = grid.width, grid.height
        self.cells: list = []
        self.seq = 0

    def _pick(self, fleet, k: int) -> list:
        busy = (set(fleet.pos.tolist()) | set(fleet.goal.tolist())
                | set(fleet.tasks.reshape(-1).tolist()))
        n = len(fleet.pos)
        for a in range(k, k + n):
            y0, x0 = divmod(int(fleet.pos[a % n]), self.w)
            for dy in range(-6, 7):
                for dx in range(-6, 5):
                    y, x = y0 + dy, x0 + dx
                    if not (0 <= y < self.h and 0 <= x and x + 2 < self.w):
                        continue
                    wall = [y * self.w + x + i for i in range(3)]
                    if all(fleet.free[c] and c not in busy for c in wall):
                        return wall
        raise RuntimeError("chip_smoke: no place for a wall")

    def __call__(self, seq, runner, fleet) -> None:
        if seq == 0 or seq % WALL_EVERY:
            return
        closing = not self.cells
        if closing:
            self.cells = self._pick(fleet, seq // WALL_EVERY)
        self.seq += 1
        runner.handle({"type": "world_update", "world_seq": self.seq,
                       "toggles": [[c, int(closing)] for c in self.cells]})
        for c in self.cells:
            fleet.free[c] = not closing
        if not closing:
            self.cells = []


def phase_serve_dynamic(dev: torch.device) -> dict:
    """1k-512 served with a 3-cell wall closing and opening every
    WALL_EVERY ticks, under ``JG_DYNAMIC_WORLD=1`` (repair mirrors from the
    start) and unset (from the first toggle): every tick certified on the
    live mask, replies identical between the two."""
    runs = {}
    for label, value in (("dynamic_world_1", "1"), ("unset", "")):
        grid = scenarios.MEDIUM.grid_fn()
        runs[label] = _serve(scenarios.MEDIUM, dev, SERVE_DYNAMIC_TICKS,
                             env={"JG_DYNAMIC_WORLD": value},
                             world=WallToggler(grid))
        torch.cuda.empty_cache()
    a, b = runs["dynamic_world_1"], runs["unset"]
    identical = a["datas"] == b["datas"]
    out = {"scenario": scenarios.MEDIUM.name, "identical": identical,
           "wall_every": WALL_EVERY,
           "dynamic_world_1": a["out"], "unset": b["out"]}
    emit("serve_dynamic_1k_512", **out)
    check(identical, "serve_dynamic_1k_512: replies differ between "
          "JG_DYNAMIC_WORLD=1 and unset")
    check(a["out"]["layer_counters"]["solverd.field_repairs"] > 0,
          "serve_dynamic_1k_512: no incremental repair under "
          "JG_DYNAMIC_WORLD=1")
    check(a["out"]["main_path_counts"]["sweep"] > 0,
          "serve_dynamic_1k_512: no sweep_scan launch on the path")
    return out


def phase_serve_sector(dev: torch.device, unset: dict) -> dict:
    """``JG_SECTOR=1``: the ref rung served on ``cuda`` and ``cpu`` from one
    fleet, one world toggle mid-stream, replies identical; then 1k-512
    served, every tick certified, beside the unset run."""
    scn = scenarios.REFERENCE_DEMO
    grid, starts, tasks, _ = scn.build(seed=0)
    fleet = ServeFleet(grid, starts, tasks)
    fleet.free = fleet.free.copy()
    runners = {}
    with fused_env(""), env_vars({"JG_SECTOR": "1"}):
        for key, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            svc = solverd.PlanService(grid, capacity_min=16, device=d)
            svc.defer_fields = False
            runners[key] = solverd.TickRunner(svc, grid)
        enc = pcodec.PackedFleetEncoder(snapshot_every=NO_SNAPSHOT)
        layers0 = _layer_counters()
        reset_counts()
        toggled = None
        for seq in range(SERVE_SECTOR_PARITY_TICKS + 1):
            if seq == SERVE_SECTOR_PARITY_TICKS // 2:
                busy = (set(fleet.pos.tolist()) | set(fleet.goal.tolist())
                        | set(fleet.tasks.reshape(-1).tolist()))
                toggled = min((c for c in np.flatnonzero(fleet.free)
                               if int(c) not in busy), key=lambda c: (
                    abs(c // grid.width - grid.height // 2)
                    + abs(c % grid.width - grid.width // 2), c))
                for run in runners.values():
                    run.handle({"type": "world_update", "world_seq": 1,
                                "toggles": [[int(toggled), 1]]})
                fleet.free[toggled] = False
            fleet.transitions()
            req = {"type": "plan_request", "seq": seq,
                   "codec": pcodec.CODEC_NAME, "caps": [pcodec.CODEC_NAME],
                   "data": pcodec.encode_b64(
                       enc.encode_tick(seq, fleet.items()))}
            r = {k: run.handle(req) for k, run in runners.items()}
            check(r["cuda"]["data"] == r["cpu"]["data"], f"serve_sector: "
                  f"cuda and cpu replies differ at seq {seq}")
            rp = pcodec.decode_b64(r["cuda"]["data"])
            check(fleet.certify(rp.idx, rp.pos), f"serve_sector: tick {seq} "
                  f"moves are not certified")
            fleet.adopt(rp.idx, rp.pos, rp.goal)
        counts = _counts()
    layers1 = _layer_counters()
    parity = {"scenario": scn.name, "ticks": SERVE_SECTOR_PARITY_TICKS,
              "identical_across_devices": True,
              "world_toggle_cell": int(toggled),
              "tasks_completed": fleet.completed,
              "layer_counters_both_devices": {
                  k: layers1[k] - layers0[k] for k in LAYER_COUNTERS},
              "main_path_counts": counts}
    check(counts["sweep"] > 0, "serve_sector: the cuda runner launched no "
          "sweep_scan")
    torch.cuda.empty_cache()
    run = _serve(scenarios.MEDIUM, dev, SERVE_SECTOR_TICKS,
                 keep_bytes=False, env={"JG_SECTOR": "1"})["out"]
    out = {"parity": parity, "sector_1k_512": run,
           "unset_1k_512": {k: unset[k] for k in (
               "snapshot_ms", "tick_ms_p50", "tick_ms_p95",
               "launches_per_tick", "host_syncs_per_tick")}}
    emit("serve_sector_parity", **out)
    check(run["layer_counters"]["solverd.sector_routes"] > 0,
          "serve_sector: no corridor plan on the 1k-512 run")
    check(run["main_path_counts"]["sweep"] > 0, "serve_sector: the 1k-512 "
          "run launched no sweep_scan")
    torch.cuda.empty_cache()
    return out


def mesh_devices(n: int) -> tuple:
    """``n`` real cards when the machine has them, else ``n`` virtual
    shards on ``cuda:0``; and whether the shards are virtual."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", k) for k in range(n)], False
    return virtual_mesh.virtual_devices(n, "cuda"), True


def _host_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``fn`` ended by a device sync (the path's host
    syncs and copies included)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _trails_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_extreme_lite(dev: torch.device) -> dict:
    """``EXTREME_LITE`` flat on the card: 512 agents on the 4096²
    warehouse, the host chunked prime (``replan_chunk`` 8), then
    EXTREME_STEPS steps, each certified; every step's (pos, goal, slot)
    kept for the 2-D mesh phase.  (A cuda-vs-cpu run at 4096² does not
    fit the time limit: the kernel is held to its plain version at
    (8, 4096, 4096) in the ``kernel`` phase instead.)"""
    scn = scenarios.EXTREME_LITE
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trail: list = []
    with fused_env(""):
        win = _flagship_window(cfg, starts, tasks, free, dev, trail=trail,
                               warmup=0, window=EXTREME_STEPS)
    out = {"scenario": scn.name, "agents": cfg.num_agents,
           "grid": [cfg.height, cfg.width], "steps": EXTREME_STEPS, **win,
           "prime_sweep_launches": win["prime_counts"]["sweep"],
           "sweep_launches_per_step": win["per_step_counts"]["sweep"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    emit("extreme_lite_4096", **out)
    check(win["invariants_ok"], "extreme_lite_4096: a step broke the "
          "invariants")
    check(win["main_path_counts"]["sweep"] > 0,
          "extreme_lite_4096: no sweep_scan launch on the path")
    return {**out, "trail": trail}


def phase_tiled(dev: torch.device) -> dict:
    """``tiled_direction_fields`` on the flagship's 1024² warehouse with
    TILED_GOALS goals over tiles 2, tiles 4 and 2 x 2 (each agent block
    its half of the goals): each equal to flat ``direction_fields`` on the
    card; rounds (one host sync each), launches and ms beside the flat
    sweep."""
    grid = scenarios.FLAGSHIP.grid_fn()
    free = torch.from_numpy(grid.free).to(dev)
    rng = np.random.default_rng(0)
    cells = np.flatnonzero(grid.free.reshape(-1))
    goals = torch.from_numpy(rng.choice(cells, TILED_GOALS, replace=False)
                             .astype(np.int32)).to(dev)
    with fused_env(""):
        reset_counts()
        want = distance.direction_fields(free, goals, 256)
        torch.cuda.synchronize()
        flat = {"launches": sweep_kernel.launches, "rounds": hostsync.count,
                "ms": _host_ms(lambda: distance.direction_fields(
                    free, goals, 256))}
        rows = []
        for a, t in ((1, 2), (1, 4), (2, 2)):
            devices, _ = mesh_devices(a * t)
            mesh = agent_tile_mesh(a, t, devices)
            bands = tiled_distance.bands_of(free, mesh)
            per = TILED_GOALS // a
            parts = [goals[k * per:(k + 1) * per].to(mesh.device(k))
                     for k in range(a)]

            def run():
                return tiled_distance.tiled_direction_fields(
                    bands, parts, grid.width)

            reset_counts()
            codes = run()
            torch.cuda.synchronize()
            got = torch.cat([tiled_distance.join_bands(codes[k], dev)
                             for k in range(a)])
            row = {"mesh": mesh.describe(), "equal": bool(torch.equal(
                got, want)), "rounds": hostsync.count,
                "sweep_launches": sweep_kernel.launches, "ms": _host_ms(run)}
            rows.append(row)
            check(row["equal"], f"tiled_1024: {a}x{t} differs from the flat "
                  f"fields")
            check(row["sweep_launches"] > 0, "tiled_1024: no sweep_scan")
    out = {"grid": [grid.height, grid.width], "goals": TILED_GOALS,
           "flat": flat, "meshes": rows}
    emit("tiled_1024", **out)
    return out


def phase_sharded_medium(dev: torch.device, medium: dict) -> dict:
    """The whole 1k-512 solve through ``solve_offline_sharded`` on a
    MESH_SHARDS agent mesh, unset and under ``MAPD_FUSED=single``: paths
    and makespan equal the flat solve of the ``medium`` phase, every step
    certified."""
    scn = scenarios.MEDIUM
    grid, starts, tasks, cfg = scn.build(seed=0)
    devices, _ = mesh_devices(MESH_SHARDS)
    mesh = agent_mesh(MESH_SHARDS, devices)
    runs = {}
    for label, env in (("unset", ""), ("single", "single")):
        with fused_env(env):
            reset_counts()
            t0 = time.perf_counter()
            paths, _, makespan = sharded.solve_offline_sharded(
                grid, starts, tasks, cfg, mesh=mesh)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _counts()
        steps = max(makespan, 1)
        runs[label] = {
            "makespan": makespan, "seconds": secs,
            "ms_per_step": 1e3 * secs / steps,
            "identical_to_flat": bool(makespan == medium["makespan"]
                                      and np.array_equal(paths,
                                                         medium["paths"])),
            "certified": _verify_paths(cfg.width, grid.free, paths),
            "launches_per_step": {k: v / steps for k, v in counts.items()
                                  if k != "syncs"},
            "host_syncs_per_step": counts["syncs"] / steps,
            "main_path_counts": counts}
    out = {"scenario": scn.name, "mesh": mesh.describe(),
           "flat_ms_per_step": medium["ms_per_step"], **runs}
    emit("sharded_1k_512", **out)
    for label, run in runs.items():
        check(run["identical_to_flat"], f"sharded_1k_512 {label}: differs "
              f"from the flat solve")
        check(run["certified"], f"sharded_1k_512 {label}: illegal step")
    check(runs["unset"]["main_path_counts"]["sweep"] > 0,
          "sharded_1k_512: no sweep_scan on the unset path")
    check(runs["single"]["main_path_counts"]["single"] > 0
          and runs["single"]["main_path_counts"]["sweep"] == 0,
          "sharded_1k_512: the single kernel did not run alone")
    return out


def phase_sharded_flagship(dev: torch.device, flag: dict) -> dict:
    """The flagship on a MESH_SHARDS agent mesh: prime, warm-up and the
    timed window as in the ``flagship`` phase; every step's (pos, goal,
    slot) equal to the flat run's."""
    scn = scenarios.FLAGSHIP
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    devices, _ = mesh_devices(MESH_SHARDS)
    mesh = agent_mesh(MESH_SHARDS, devices)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trail: list = []
    with fused_env(""):
        win = _flagship_window(
            cfg, starts, tasks, free, dev, trail=trail,
            prepare=lambda: sharded.prepare_state_sharded(
                cfg, mesh, starts, tasks, grid.free),
            step=lambda c, st, tk, f: sharded.sharded_mapd_step(
                c, mesh, st, tk, f))
    same = _trails_equal(trail, flag["trail"])
    out = {"scenario": scn.name, "mesh": mesh.describe(),
           "warmup_steps": FLAGSHIP_WARMUP, "window_steps": FLAGSHIP_WINDOW,
           **win, "identical_to_flat": same,
           "flat_ms_per_step": flag["ms_per_step"],
           "flat_host_syncs_per_step": flag["host_syncs_per_step"],
           "sweep_launches_per_step": win["per_step_counts"]["sweep"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    emit("sharded_flagship", **out)
    check(same, "sharded_flagship: a step differs from the flat flagship's")
    check(win["invariants_ok"], "sharded_flagship: a step broke the "
          "invariants")
    check(win["main_path_counts"]["sweep"] > 0,
          "sharded_flagship: no sweep_scan launch on the path")
    torch.cuda.empty_cache()
    return out


def phase_sharded2d(dev: torch.device, extreme: dict) -> dict:
    """``EXTREME_LITE`` on a 2 x 2 agents x tiles mesh: the banded prime,
    then EXTREME_STEPS steps; every step equal to the flat run's."""
    scn = scenarios.EXTREME_LITE
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    devices, _ = mesh_devices(4)
    mesh = agent_tile_mesh(2, 2, devices)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trail: list = []
    with fused_env(""):
        win = _flagship_window(
            cfg, starts, tasks, free, dev, trail=trail, warmup=0,
            window=EXTREME_STEPS,
            prepare=lambda: sharded2d.prepare_state_2d(
                cfg, mesh, starts, tasks, grid.free),
            step=lambda c, st, tk, f: sharded2d.sharded2d_mapd_step(
                c, mesh, st, tk, f))
    same = _trails_equal(trail, extreme["trail"])
    out = {"scenario": scn.name, "mesh": mesh.describe(),
           "steps": EXTREME_STEPS, **win, "identical_to_flat": same,
           "flat_prepare_seconds": extreme["prepare_seconds"],
           "flat_ms_per_step": extreme["ms_per_step"],
           "sweep_launches_per_step": win["per_step_counts"]["sweep"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    emit("sharded2d_4096", **out)
    check(same, "sharded2d_4096: a step differs from the flat run's")
    check(win["invariants_ok"], "sharded2d_4096: a step broke the "
          "invariants")
    torch.cuda.empty_cache()
    return out


def _solver_mesh(a: int, t: int) -> "solver_mesh.SolverMesh":
    devices, _ = mesh_devices(a * t)
    return solver_mesh.SolverMesh(a, t, devices=devices)


def phase_serve_mesh_parity(dev: torch.device) -> dict:
    """The ref rung served by a flat runner on the card and by runners on
    (2, 1) and (2, 2) meshes of the card: one fleet, a world toggle at tick
    30 (after it the fresh sweeps return distances, ``make_fields_dist``
    on the mesh), every reply the same bytes; then three ref tenants on a
    flat slab and on a (2, 1) mesh slab, every publish the same."""
    scn = scenarios.REFERENCE_DEMO
    grid, starts, tasks, _ = scn.build(seed=0)
    fleet = ServeFleet(grid, starts, tasks)
    fleet.free = fleet.free.copy()
    meshes = {"2x1": _solver_mesh(2, 1), "2x2": _solver_mesh(2, 2)}
    runners = {}
    with fused_env(""):
        for key, mesh in (("flat", None), *meshes.items()):
            svc = solverd.PlanService(grid, capacity_min=16, device=dev,
                                      mesh=mesh)
            svc.defer_fields = False
            runners[key] = solverd.TickRunner(svc, grid)
        enc = pcodec.PackedFleetEncoder(snapshot_every=NO_SNAPSHOT)
        reset_counts()
        toggled = None
        for seq in range(SERVE_MESH_PARITY_TICKS + 1):
            if seq == 30:
                busy = (set(fleet.pos.tolist()) | set(fleet.goal.tolist())
                        | set(fleet.tasks.reshape(-1).tolist()))
                toggled = next(c for c in np.flatnonzero(fleet.free)[::-1]
                               if int(c) not in busy)
                msg = {"type": "world_update", "world_seq": 1,
                       "toggles": [[int(toggled), 1]]}
                for run in runners.values():
                    run.handle_world(msg)
                fleet.free[toggled] = False
            fleet.transitions()
            req = {"type": "plan_request", "seq": seq,
                   "codec": pcodec.CODEC_NAME, "caps": [pcodec.CODEC_NAME],
                   "data": pcodec.encode_b64(
                       enc.encode_tick(seq, fleet.items()))}
            r = {k: run.handle(req) for k, run in runners.items()}
            same = all(x["data"] == r["flat"]["data"] for x in r.values())
            check(same, f"serve_mesh_parity: mesh and flat replies differ "
                  f"at seq {seq}")
            rp = pcodec.decode_b64(r["flat"]["data"])
            check(fleet.certify(rp.idx, rp.pos),
                  f"serve_mesh_parity: tick {seq} moves are not certified")
            fleet.adopt(rp.idx, rp.pos, rp.goal)
        counts = _counts()
    mirrors = {k: len(run.service.dist_mirror) for k, run in runners.items()}
    check(all(v > 0 for v in mirrors.values()), "serve_mesh_parity: no "
          "distance sweep after the toggle")
    tenants = _serve_mesh_tenants(dev)
    out = {"scenario": scn.name, "ticks": SERVE_MESH_PARITY_TICKS,
           "identical_to_flat": True, "world_toggle_cell": int(toggled),
           "dist_mirrors": mirrors,
           "meshes": {k: m.mesh.describe() for k, m in meshes.items()},
           "resident_shard_bytes": {
               k: runners[k].service.resident_shard_bytes() for k in meshes},
           "tasks_completed": fleet.completed,
           "main_path_counts": counts, "tenants": tenants}
    emit("serve_mesh_parity", **out)
    check(counts["sweep"] > 0, "serve_mesh_parity: no sweep_scan launch")
    return out


def _serve_mesh_tenants(dev: torch.device) -> dict:
    """Three ref tenants (seeds 0, 1, 2), every tenant asking in every
    burst, on a flat slab and on a (2, 1) mesh slab of the card."""
    scn = scenarios.REFERENCE_DEMO
    fleets, encs = {}, {}
    for k in range(3):
        grid, starts, tasks, _ = scn.build(seed=k)
        fleets[f"t{k}"] = ServeFleet(grid, starts, tasks)
        encs[f"t{k}"] = pcodec.PackedFleetEncoder(snapshot_every=NO_SNAPSHOT)
    mesh = _solver_mesh(2, 1)
    pubs = {"flat": [], "mesh": []}
    runners = {}
    for key, m in (("flat", None), ("mesh", mesh)):
        svc = solverd.PlanService(grid, capacity_min=16, device=dev, mesh=m)
        svc.defer_fields = False
        runners[key] = solverd.MultiTenantRunner(
            solverd.TenantSlab(svc, grid), grid,
            publish=lambda t, d, key=key: pubs[key].append((t, d)))
    strip = lambda xs: [(t, {k: v for k, v in d.items()  # noqa: E731
                             if k != "duration_micros"}) for t, d in xs]
    with fused_env(""):
        for seq in range(SERVE_MESH_TENANT_TICKS + 1):
            n = len(pubs["flat"])
            reqs = {}
            for ns, f in fleets.items():
                f.transitions()
                reqs[ns] = _tenant_request(seq, f, encs[ns])
            for run in runners.values():
                for ns, r in reqs.items():
                    run.ingest(ns, r)
                run.finish(run.begin())
            check(strip(pubs["flat"][n:]) == strip(pubs["mesh"][n:]),
                  f"serve_mesh_parity: tenant publishes differ at {seq}")
            for topic, d in pubs["flat"][n:]:
                rp = pcodec.decode_b64(d["data"])
                f = fleets[topic.split(":")[0]]
                check(f.certify(rp.idx, rp.pos), "serve_mesh_parity: a "
                      "tenant tick is not certified")
                f.adopt(rp.idx, rp.pos, rp.goal)
    slab = runners["mesh"].slab
    return {"tenants": 3, "ticks": SERVE_MESH_TENANT_TICKS,
            "identical_to_flat": True, "mesh": mesh.mesh.describe(),
            "replies": len(pubs["mesh"]),
            "resident_shard_bytes": slab.service.resident_shard_bytes(
                (slab.d_pos, slab.d_goal, slab.d_slot, slab.d_active))}


def phase_serve_mesh_medium(dev: torch.device, unset_datas: list) -> dict:
    """1k-512 served on (2, 1) and (2, 2) meshes of the card: a snapshot
    and SERVE_MESH_TICKS delta ticks, every reply equal to the same tick
    of ``serve_1k_512``'s unset run, every tick certified."""
    runs = {}
    for a, t in ((2, 1), (2, 2)):
        key = f"{a}x{t}"
        run = _serve(scenarios.MEDIUM, dev, SERVE_MESH_TICKS,
                     mesh=_solver_mesh(a, t))
        same = run["datas"] == unset_datas[:SERVE_MESH_TICKS + 1]
        runs[key] = {**run["out"], "identical_to_flat": same}
        check(same, f"serve_mesh_1k_512 {key}: replies differ from the "
              f"flat run")
        check(run["out"]["over_budget_ticks"] == 0,
              f"serve_mesh_1k_512 {key}: ticks over the budget")
        check(run["out"]["main_path_counts"]["sweep"] > 0,
              f"serve_mesh_1k_512 {key}: no sweep_scan launch")
        torch.cuda.empty_cache()
    out = {"scenario": scenarios.MEDIUM.name, **runs}
    emit("serve_mesh_1k_512", **out)
    return out


def _kernel_entry(name: str, replaces: str, tpu_kernel: str, launches: int,
                  rows: list, step_shape: list, card: str, **extra) -> dict:
    """One kernel of the kernels line; ``ms``, ``plain_ms`` and the bound
    are at ``step_shape``, the in-step replan chunk of its path, in the
    layout the path takes (rows with a forced layout are listed in
    ``timed`` only)."""
    at = [r for r in rows if r["shape"] == step_shape and "ms" in r
          and not r.get("forced")]
    mean = lambda key: sum(r[key] for r in at) / len(at)  # noqa: E731
    timed_keys = ("shape", "forced", "cluster", "tile", "rows", "bands",
                  "cells", "blocks", "ms", "ms_runs", "plain_ms", "bound_ms",
                  "bound_by", "bytes_ms", "ops_ms", "field_rounds_mean",
                  "axis", "reverse")
    return {
        "name": name, "route": "cuda", "source": (
            "p2p_distributed_tswap_tpu_torch/csrc/" +
            ("sweep_scan.cu" if name == "sweep_scan" else "field_fused.cu")),
        "replaces": replaces, "replaces_kernel": tpu_kernel,
        "launches": launches, "equal": all(r["equal"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": at[0].get("bound_by", "bytes"),
        "library_ms": None,  # no PyTorch call computes this function
        "timed": [{k: r[k] for k in timed_keys if k in r}
                  for r in rows if "ms" in r],
        "card": card, **extra,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = phase_device()
    card = info["nvidia_smi"]
    phase_build()
    rows = phase_kernel(dev, card)
    fused = phase_fused(dev, card)
    phase_parity(dev)
    phase_stale_parity(dev)
    medium = phase_medium(dev)
    congested = phase_congested(dev)
    flag = phase_flagship(dev)
    single = phase_flagship_single(dev, flag)
    torch.cuda.empty_cache()
    phase_serve_parity(dev)
    kept: dict = {}
    serve_medium = phase_serve_medium(dev, kept)
    serve_congested = phase_serve_congested(dev)
    serve_flag = phase_serve_flagship(dev)
    phase_serve_tenants_parity(dev)
    tenants = phase_serve_tenants(dev)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmpdir:
        phase_checkpoint(dev, tmpdir)
    torch.cuda.empty_cache()
    repair = phase_repair(dev, card)
    sect = phase_sector(
        dev, card, repair["full_recompute"]["sweeps_chunk1_ms_per_field"])
    torch.cuda.empty_cache()
    phase_serve_dynamic(dev)
    phase_serve_sector(dev, serve_medium["unset"])
    # the multi-device layers: real cards where there are enough, else
    # virtual shards of cuda:0
    extreme = phase_extreme_lite(dev)
    phase_tiled(dev)
    phase_sharded_medium(dev, medium)
    mesh_flag = phase_sharded_flagship(dev, flag)
    flag.pop("trail")
    phase_sharded2d(dev, extreme)
    extreme.pop("trail")
    phase_serve_mesh_parity(dev)
    mesh_serve = phase_serve_mesh_medium(dev, kept.pop("datas"))
    served = {
        "sweep_scan": {
            "1k-512": serve_medium["unset"]["launches_per_tick"]["sweep"],
            "3k-256-congested":
                serve_congested["unset"]["launches_per_tick"]["sweep"],
            "10k-1024-warehouse": serve_flag["launches_per_tick"]["sweep"],
            "8x1k-512 tenants":
                tenants["unset"]["launches_per_tick"]["sweep"]},
        "field_fused_multi": {"3k-256-congested": serve_congested["1"][
            "launches_per_tick"]["multi"]},
        "field_fused_single": {
            "1k-512": serve_medium["single"]["launches_per_tick"]["single"],
            "8x1k-512 tenants":
                tenants["single"]["launches_per_tick"]["single"]},
    }

    multi_rows = [r for r in fused if r["mode"] == "multi"]
    single_rows = [r for r in fused if r["mode"] == "single"]
    kernels = [
        # sweep_scan: mean of the four directions' medians at (4,1024,1024);
        # it replaces the strip kernel sweep_pallas.py:86 too
        _kernel_entry(
            "sweep_scan", "p2p_distributed_tswap_tpu/ops/sweep_pallas.py:209",
            "sweep_pallas._scan8_kernel (and _scan_kernel at :86)",
            flag["main_path_sweep_launches"], rows,
            STEP_SHAPES["sweep_scan"], card,
            design="along H: bands of rows per column tile, two-phase scan "
                   "in one block; along W: row segments loaded ahead, "
                   "raking warp scan"),
        _kernel_entry(
            "field_fused_multi",
            "p2p_distributed_tswap_tpu/ops/field_fused.py:357",
            "field_fused._multi_kernel", congested["fused_multi_launches"],
            multi_rows, STEP_SHAPES["multi"], card, design="cluster-split"),
        _kernel_entry(
            "field_fused_single",
            "p2p_distributed_tswap_tpu/ops/field_fused.py:166",
            "field_fused._kernel", single["main_path_counts"]["single"],
            single_rows, STEP_SHAPES["single"], card,
            design="cluster-split"),
    ]
    for k in kernels:
        k["launches_per_served_tick"] = served[k["name"]]
    kernels[0]["launches_per_repair_event"] = {
        "wall": repair["sweep_scan_launches_per_wall_event"],
        "door": repair["sweep_scan_launches_door_event"]}
    kernels[0]["launches_per_sector_plan"] = \
        sect["sweep_scan_launches_per_plan"]
    counter = {"sweep_scan": "sweep", "field_fused_multi": "multi",
               "field_fused_single": "single"}
    for k in kernels:
        c = counter[k["name"]]
        # the flagship on the 4-shard agent mesh and 1k-512 served on the
        # 2 x 2 mesh, both on the unset path (the sweeps)
        k["launches_per_mesh_step"] = mesh_flag["per_step_counts"][c]
        k["launches_per_mesh_tick"] = mesh_serve["2x2"][
            "launches_per_tick"][c]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
