#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``p2p_distributed_tswap_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds it
against its plain PyTorch version, and drives the port's main path (the
offline MAPD solve) on the card.  Each phase prints one JSON line; any
failed phase raises and the script exits non-zero.  Phases:

1. device   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name.
2. build    — seconds ``nvcc`` took for ``csrc/sweep_scan.cu`` (or a cache hit).
3. kernel   — ``sweep_scan`` == its plain version (``torch.equal``) for all
               four (axis, reverse) pairs at the shapes the flagship and
               1k-512 solves give it (in-step and prime chunks, on their
               own masks) and at ragged ones; at those path shapes also
               the kernel's device time per launch (CUDA events around 25
               back-to-back launches, median of 5 runs), its bytes bound at
               3.35 TB/s, and the plain version's time.
4. parity   — a full ``solve_offline`` of ``ref-50x100x100`` (seed 0) on
               ``cuda`` and on ``cpu``: paths and makespan identical, and the
               CUDA run went through the kernel.
5. medium   — ``1k-512`` (seed 0) solved to completion on the card, every
               recorded transition certified host-side.
6. flagship — ``10k-1024-warehouse`` (seed 0) at full size: the prime burst,
               then a window of ``mapd_step`` calls with ``step_invariants``
               folded over every step.
               The kernel's and the host syncs' counts are set to 0 just
               before this phase and read just after it.
7. kernels  — one JSON object describing every kernel of the path.
8. the last line: ``{"ok": true, "device": {...}}``.

Exits non-zero, before printing any result, when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.models import scenarios
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel
from p2p_distributed_tswap_tpu_torch.solver import invariants, mapd

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory rate
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


def phase_build() -> None:
    info = sweep_kernel.build()
    emit("build", cached=info["cached"], nvcc_seconds=info["seconds"],
         library=info["path"], ptxas=info["ptxas"][-1500:])


def _per_launch_ms(fn, launches: int, reps: int = 5) -> float:
    """Device ms per call of ``fn``: ``launches`` calls queued behind a
    device-side sleep, so the host's enqueue time is hidden and they run
    back to back, timed with CUDA events; the median of ``reps`` runs."""
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
    return statistics.median(times)


SCENARIO_MASKS = {"warehouse": scenarios.FLAGSHIP, "1k-512": scenarios.MEDIUM}


def _mask(kind: str, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """(H, W) bool free mask: a scenario's own grid, or random obstacles."""
    if kind in SCENARIO_MASKS:
        free = SCENARIO_MASKS[kind].grid_fn().free
        check(free.shape == (h, w), f"{kind} grid is not {h}x{w}")
        return free
    free = rng.random((h, w)) > 0.2
    if kind == "border":
        free[[0, -1], :] = False
        free[:, [0, -1]] = False
    return free


KERNEL_CASES = (
    # (R, H, W, mask, timed): the in-step replan chunk and the prime chunk
    # of the flagship and of 1k-512, then ragged shapes and obstacles on
    # every edge
    (4, 1024, 1024, "warehouse", True),
    (64, 1024, 1024, "warehouse", True),
    (4, 512, 512, "1k-512", True),
    (128, 512, 512, "1k-512", True),
    (3, 100, 100, "random", False),
    (2, 257, 131, "random", False),
    (1, 8, 4096, "border", False),
)


def phase_kernel(dev: torch.device, card: str) -> list:
    rows = []
    rng = np.random.default_rng(0)
    for r, h, w, kind, timed in KERNEL_CASES:
        free = torch.from_numpy(_mask(kind, h, w, rng)).to(dev)
        blocked = (~free).to(torch.uint8).contiguous()
        gen = torch.Generator(device=dev).manual_seed(r * h + w)
        seeds = torch.rand((r, h, w), generator=gen, device=dev) > 0.97
        vals = torch.randint(0, 60, (r, h, w), generator=gen, device=dev,
                             dtype=torch.int32)
        d = torch.where(seeds & free[None], vals, INF).contiguous()
        for axis, reverse in DIRECTIONS:
            got = sweep_kernel.sweep_scan(d, blocked, axis, reverse)
            want = sweep_kernel.sweep_plain(d, blocked, axis, reverse)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            equal = bool(torch.equal(got, want))
            row = {"shape": [r, h, w], "mask": kind, "axis": axis,
                   "reverse": reverse, "equal": equal, "max_abs_err": err}
            if timed:
                nbytes = 2 * r * h * w * 4 + h * w
                row["ms"] = _per_launch_ms(
                    lambda: sweep_kernel.sweep_scan(d, blocked, axis,
                                                    reverse), TIMED_LAUNCHES)
                row["plain_ms"] = _per_launch_ms(
                    lambda: sweep_kernel.sweep_plain(d, blocked, axis,
                                                     reverse), PLAIN_TIMED,
                    reps=3)
                row["bytes"] = nbytes
                row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                row["card"] = card  # name and power limit beside the bound
            emit("kernel", **row)
            check(equal, f"sweep_scan != plain at {row}")
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
    sweep_kernel.launches = 0
    hostsync.count = 0
    t0 = time.perf_counter()
    out = mapd.solve_offline(grid, starts, tasks, cfg, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, sweep_kernel.launches, \
        hostsync.count


def phase_parity(dev: torch.device) -> None:
    grid, starts, tasks, cfg = scenarios.REFERENCE_DEMO.build(seed=0)
    (pc, sc, mc), secs_c, launches_c, syncs_c = _timed_solve(
        grid, starts, tasks, cfg, dev)
    (pp, sp, mp), secs_p, launches_p, _ = _timed_solve(
        grid, starts, tasks, cfg, "cpu")
    same = (mc == mp and np.array_equal(pc, pp) and np.array_equal(sc, sp))
    emit("parity", scenario=scenarios.REFERENCE_DEMO.name, makespan_cuda=mc,
         makespan_cpu=mp, identical=same, cuda_seconds=secs_c,
         cpu_seconds=secs_p, cuda_ms_per_step=1e3 * secs_c / max(mc, 1),
         sweep_launches_cuda=launches_c, sweep_launches_cpu=launches_p,
         host_syncs_cuda=syncs_c,
         invariants_ok=_verify_paths(cfg.width, grid.free, pc))
    check(same, "ref rung: cuda and cpu solves differ")
    check(launches_c > 0, "ref rung: the CUDA solve launched no sweep_scan")
    check(launches_p == 0, "ref rung: the CPU solve launched the kernel")


def phase_medium(dev: torch.device) -> None:
    scn = scenarios.MEDIUM
    grid, starts, tasks, cfg = scn.build(seed=0)
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


def phase_flagship(dev: torch.device) -> dict:
    scn = scenarios.FLAGSHIP
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- the main path: counts set to 0 here, read at the end ----
    sweep_kernel.launches = 0
    hostsync.count = 0
    t0 = time.perf_counter()
    s, tasks_t = mapd.prepare_state(cfg, starts, tasks, free, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    prepare_launches = sweep_kernel.launches
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(FLAGSHIP_WARMUP):
        prev = s.pos
        s = mapd.mapd_step(cfg, s, tasks_t, free)
        ok = ok & invariants.step_invariants(cfg, prev, s.pos, free)
    torch.cuda.synchronize()
    launches0, syncs0 = sweep_kernel.launches, hostsync.count
    t0 = time.perf_counter()
    for _ in range(FLAGSHIP_WINDOW):
        prev = s.pos
        s = mapd.mapd_step(cfg, s, tasks_t, free)
        ok = ok & invariants.step_invariants(cfg, prev, s.pos, free)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    window_launches = sweep_kernel.launches - launches0
    window_syncs = hostsync.count - syncs0
    inv_ok = bool(ok)
    main_launches, main_syncs = sweep_kernel.launches, hostsync.count
    # ---- end of the main path ----

    out = {"scenario": scn.name, "agents": cfg.num_agents,
           "grid": [cfg.height, cfg.width],
           "packed_rows_bytes": s.dirs.numel() * s.dirs.element_size(),
           "prepare_seconds": prepare_s,
           "prepare_sweep_launches": prepare_launches,
           "warmup_steps": FLAGSHIP_WARMUP, "window_steps": FLAGSHIP_WINDOW,
           "ms_per_step": 1e3 * window_s / FLAGSHIP_WINDOW,
           "host_syncs_per_step": window_syncs / FLAGSHIP_WINDOW,
           "sweep_launches_per_step": window_launches / FLAGSHIP_WINDOW,
           "t": int(s.t), "tasks_used": int(s.task_used.sum()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "invariants_ok": inv_ok,
           "main_path_sweep_launches": main_launches,
           "main_path_host_syncs": main_syncs}
    emit("flagship", **out)
    check(inv_ok, "flagship: a transition broke the step invariants")
    check(main_launches > 0, "flagship: no sweep_scan launch on the main path")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = phase_device()
    phase_build()
    rows = phase_kernel(dev, info["nvidia_smi"])
    phase_parity(dev)
    phase_medium(dev)
    flag = phase_flagship(dev)

    timed = [r for r in rows if r["shape"] == [4, 1024, 1024]]
    mean = lambda key: sum(r[key] for r in timed) / len(timed)  # noqa: E731
    kernels = [{
        "name": "sweep_scan", "route": "cuda",
        "source": "p2p_distributed_tswap_tpu_torch/csrc/sweep_scan.cu",
        "replaces": ["p2p_distributed_tswap_tpu/ops/sweep_pallas.py:209",
                     "p2p_distributed_tswap_tpu/ops/sweep_pallas.py:86"],
        "replaces_kernels": ["sweep_pallas._scan8_kernel",
                             "sweep_pallas._scan_kernel"],
        "launches": flag["main_path_sweep_launches"],
        "equal": all(r["equal"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # one launch at the in-step shape (4, 1024, 1024), mean of the four
        # directions' medians; every timed shape is in "timed"
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": "bytes",
        "library_ms": None,
        "timed": [{k: r[k] for k in ("shape", "axis", "reverse", "ms",
                                     "plain_ms", "bound_ms")}
                  for r in rows if "ms" in r],
        "card": info["nvidia_smi"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
