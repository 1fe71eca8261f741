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
               bound at 3.35 TB/s, and the plain version's time.
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
11. kernels — one JSON object describing every kernel of the paths.
12. the last line: ``{"ok": true, "device": {...}}``.

Each path (phase 9 for ``sweep_scan``, 8 for the multi instance, 10 for the
single instance) is driven with every kernel's and the host syncs' counts set
to 0 just before it and read just after it.

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
import time

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.models import scenarios
from p2p_distributed_tswap_tpu_torch.ops import (
    cuda_build,
    field_fused,
    sweep_kernel,
)
from p2p_distributed_tswap_tpu_torch.solver import invariants, mapd

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
    info = {"nvidia_smi": card, "torch_name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


@contextlib.contextmanager
def fused_env(value: str):
    """``MAPD_FUSED=value`` ('' = unset) inside the block, restored after."""
    old = os.environ.pop("MAPD_FUSED", None)
    if value:
        os.environ["MAPD_FUSED"] = value
    try:
        yield
    finally:
        os.environ.pop("MAPD_FUSED", None)
        if old is not None:
            os.environ["MAPD_FUSED"] = old


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
                  "congested": scenarios.CONGESTED}


SERPENTINE_PERIOD = 16  # columns per corridor and its wall


def _mask(kind: str, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """(H, W) bool free mask: a scenario's own grid, a serpentine maze, or
    random obstacles."""
    if kind in SCENARIO_MASKS:
        free = SCENARIO_MASKS[kind].grid_fn().free
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


def sweep_bound(r: int, h: int, w: int) -> dict:
    """Each cell read and written once (int32) and the mask read once, over
    the memory rate: the least time a sweep could take."""
    nbytes = 2 * r * h * w * 4 + h * w
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
    return rows


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


def phase_medium(dev: torch.device) -> None:
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


def _steps(cfg, s, tasks_t, free, steps: int) -> tuple:
    """``steps`` calls of ``mapd_step`` with ``step_invariants`` folded over
    each; returns the state, whether every step held, and the seconds."""
    ok = torch.ones((), dtype=torch.bool, device=free.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        prev = s.pos
        s = mapd.mapd_step(cfg, s, tasks_t, free)
        ok = ok & invariants.step_invariants(cfg, prev, s.pos, free)
    torch.cuda.synchronize()
    return s, bool(ok), time.perf_counter() - t0


def _counts() -> dict:
    return {"sweep": sweep_kernel.launches, "syncs": hostsync.count,
            **field_fused.launches}


def _flagship_window(cfg, starts, tasks, free, dev, on_prime=None) -> dict:
    """The prime burst, the warm-up steps and the timed window of the
    flagship, counts set to 0 just before and read just after.
    ``on_prime(state)`` sees the state right after the prime."""
    reset_counts()
    t0 = time.perf_counter()
    s, tasks_t = mapd.prepare_state(cfg, starts, tasks, free, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    prime = _counts()
    if on_prime is not None:
        on_prime(s)
    s, ok_warm, _ = _steps(cfg, s, tasks_t, free, FLAGSHIP_WARMUP)
    before = _counts()
    s, ok_win, window_s = _steps(cfg, s, tasks_t, free, FLAGSHIP_WINDOW)
    after = _counts()
    per_step = {k: (after[k] - before[k]) / FLAGSHIP_WINDOW for k in after}
    return {"prepare_seconds": prepare_s, "prime_counts": prime,
            "ms_per_step": 1e3 * window_s / FLAGSHIP_WINDOW,
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
    with fused_env(""):  # the main path of sweep_scan
        win = _flagship_window(cfg, starts, tasks, free, dev)
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
    return out


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
    phase_medium(dev)
    congested = phase_congested(dev)
    flag = phase_flagship(dev)
    single = phase_flagship_single(dev, flag)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
