"""Device-memory roofline for the flagship step on the PyTorch port.

The port's twin of ``analysis/roofline.py``.  The flagship step is
replan-dominated and each directional sweep (``sweep_scan``) is about one
memory pass, so a bytes-touched-per-step / bandwidth roofline is computable
from first principles plus measured quantities:

1. **Fixpoint rounds per replanned field** — measured here by running the
   sweep round host-side to convergence on real flagship task fields (the
   warehouse shelf maze sets the count; an empty grid would converge in 1).
2. **Dirty rows per step** — steady-state replan traffic.  Goal SWAPS are
   slot permutations and dirty nothing; only task-lifecycle goal changes
   (assignment, pickup->delivery flip) recompute fields, so total in-loop
   dirties across a solve are 2T - N (T tasks assigned + T flips, minus the
   N first assignments folded into the t=0 prime), spread over the
   makespan.  The makespan is the port's own: ``--makespan``, or else a
   whole flagship solve on the device.
3. **ms per step** — the port's own: the host clock over a window of
   flagship steps on the device (after the prime and a few warm-up
   steps), ended by ``torch.cuda.synchronize()``; and, where the flagship
   was solved whole here, that solve's seconds over its makespan (the
   average step the byte model's average dirty rows describe; the window
   is the replan-heavy start).

Byte model per fixpoint round over a (R, H, W) int32 batch (R =
replan_chunk_small), the original's: 4 directional sweeps, each reading and
writing the batch once plus the shared (H, W) mask; one convergence check
reading old+new.  Extraction adds ~3 passes (direction compare + nibble
pack) and the dirs scatter writes R packed rows.  Device-memory rate: the
H100 SXM's published 3.35 TB/s.

Usage: python analysis/torch_roofline.py [--chunks 8] [--makespan N] [--cpu]
Prints the roofline table (the card unless ``--cpu``; without CUDA and
without ``--cpu`` it exits nonzero).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from p2p_distributed_tswap_tpu_torch import hostsync  # noqa: E402
from p2p_distributed_tswap_tpu_torch.models import scenarios  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import distance  # noqa: E402
from p2p_distributed_tswap_tpu_torch.solver import mapd  # noqa: E402

H100_HBM_GBPS = 3350.0  # NVIDIA H100 SXM published device-memory rate
WARMUP_STEPS = 5
WINDOW_STEPS = 50


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_fixpoint_rounds(grid, goals, max_rounds=256,
                            sweep=distance._sweep):
    """Host-driven replica of distance_fields' fixpoint, counting rounds
    to convergence for one (R, H, W) seed batch; ``goals`` is an int32
    tensor on the device to run on, ``sweep`` the directional sweep (the
    kernel on the card by default, or ``sweep_kernel.sweep_plain``)."""
    h, w = grid.height, grid.width
    dev = goals.device
    free = torch.as_tensor(np.asarray(grid.free), device=dev)
    blocked = (~free).to(torch.uint8).contiguous()
    g = goals.shape[0]
    cell = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(1, h, w)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    d = torch.where(cell == goals.reshape(g, 1, 1), zero, distance.INF)
    d = torch.where(free[None], d, distance.INF)

    def one_round(d):
        d = sweep(d, blocked, axis=2, reverse=False)
        d = sweep(d, blocked, axis=2, reverse=True)
        d = sweep(d, blocked, axis=1, reverse=False)
        d = sweep(d, blocked, axis=1, reverse=True)
        return d

    rounds = 0
    t0 = time.perf_counter()
    while rounds < max_rounds:
        nd = one_round(d)
        rounds += 1
        if not hostsync.flag(torch.any(nd != d)):
            break
        d = nd
    elapsed = time.perf_counter() - t0
    return rounds, elapsed


def sample_round_counts(grid, tasks, r: int, chunks: int, device,
                        sweep=distance._sweep, log=print) -> list:
    """Fixpoint rounds of ``chunks`` chunks of ``r`` delivery goals drawn
    from the rung's tasks with seed 0 (the original's draw)."""
    rng = np.random.default_rng(0)
    counts = []
    for i in range(chunks):
        sel = rng.choice(len(tasks), size=r, replace=False)
        goals = torch.as_tensor(tasks[sel, 1], dtype=torch.int32,
                                device=device)
        rounds, secs = measure_fixpoint_rounds(grid, goals, sweep=sweep)
        counts.append(rounds)
        log(f"# chunk {i}: {rounds} fixpoint rounds ({secs:.2f}s incl. "
            "host loop)")
    return counts


def measure_ms_per_step(cfg, starts, tasks, free, device,
                        warmup=WARMUP_STEPS, window=WINDOW_STEPS) -> float:
    """Host ms per ``mapd_step`` over ``window`` steps after the prime and
    ``warmup`` steps, on ``device``."""
    free_t = torch.as_tensor(np.asarray(free), dtype=torch.bool,
                             device=device)
    s, tasks_t = mapd.prepare_state(cfg, starts, tasks, free_t, device)
    for _ in range(warmup):
        s = mapd.mapd_step(cfg, s, tasks_t, free_t)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(window):
        s = mapd.mapd_step(cfg, s, tasks_t, free_t)
    _sync(device)
    return 1000.0 * (time.perf_counter() - t0) / window


def solve_makespan(cfg, starts, tasks, free, device) -> int:
    """The makespan of a whole solve of the rung on ``device``."""
    final = mapd.run_mapd(cfg, starts, tasks, free, device)
    steps = int(final.t)
    if not (bool(final.task_used.all()) and steps <= cfg.max_timesteps):
        raise RuntimeError(f"the solve did not complete ({steps} steps)")
    return steps


def roofline(counts, makespan: int, ms_per_step: float, num_tasks: int,
             cfg) -> dict:
    """The original's byte model over the measured round counts, the
    port's makespan and its measured ms/step."""
    rounds_mean = float(np.mean(counts))
    r = cfg.replan_chunk_small

    # steady-state dirty rows per step: 2T - N task-lifecycle goal changes
    # over the makespan
    T, N = num_tasks, cfg.num_agents
    dirty_per_step = (2 * T - N) / makespan
    loops_per_step = dirty_per_step / r  # fixpoint loops per step (chunk = r)

    hw_bytes = cfg.num_cells * 4
    batch = r * hw_bytes                        # (R, H, W) int32
    per_round = 4 * (2 * batch + hw_bytes) + 2 * batch   # sweeps + converge
    extract = 3 * batch + r * cfg.num_cells // 2         # dirs + pack
    per_loop = rounds_mean * per_round + extract
    replan_bytes = loops_per_step * per_loop
    # TSWAP step traffic: occupancy scatter/gathers, a few (HW,) passes
    kernel_bytes = 6 * hw_bytes
    total = replan_bytes + kernel_bytes
    ideal_ms = total / (H100_HBM_GBPS * 1e9) * 1000.0
    return {"rounds_mean": rounds_mean, "dirty_per_step": dirty_per_step,
            "loops_per_step": loops_per_step, "replan_bytes": replan_bytes,
            "kernel_bytes": kernel_bytes, "total_bytes": total,
            "ideal_ms": ideal_ms, "ms_per_step": ms_per_step,
            "makespan": makespan,
            "bandwidth_bound_fraction": ideal_ms / ms_per_step}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=8,
                    help="how many 4-goal chunks to sample for round counts")
    ap.add_argument("--makespan", type=int, default=None,
                    help="the port's flagship makespan (default: solve the "
                         "flagship on the device for it)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_roofline: CUDA is not available; pass --cpu to run "
                 "on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")

    scn = scenarios.FLAGSHIP
    grid, starts, tasks, cfg = scn.build(seed=0)
    counts = sample_round_counts(grid, tasks, cfg.replan_chunk_small,
                                 args.chunks, device,
                                 log=lambda m: print(m, flush=True))
    makespan, solve_ms = args.makespan, None
    if makespan is None:
        t0 = time.perf_counter()
        makespan = solve_makespan(cfg, starts, tasks, grid.free, device)
        secs = time.perf_counter() - t0
        solve_ms = 1000.0 * secs / makespan
        print(f"# whole solve on {where}: makespan {makespan} "
              f"({secs:.1f}s)", flush=True)
    ms = measure_ms_per_step(cfg, starts, tasks, grid.free, device)
    print(f"# {WINDOW_STEPS}-step window on {where}: {ms:.2f} ms/step",
          flush=True)
    res = roofline(counts, makespan, ms, len(tasks), cfg)

    print()
    print("| quantity | value |")
    print("|---|---|")
    print(f"| fixpoint rounds per flagship field (measured, {args.chunks} "
          f"chunks) | {res['rounds_mean']:.1f} |")
    print(f"| dirty field rows per step ((2T-N)/makespan, makespan "
          f"{makespan}) | {res['dirty_per_step']:.1f} |")
    print(f"| replan fixpoint loops per step | "
          f"{res['loops_per_step']:.2f} |")
    print(f"| bytes touched per step (replan "
          f"{res['replan_bytes']/1e9:.2f} GB + step "
          f"{res['kernel_bytes']/1e9:.2f} GB) | "
          f"{res['total_bytes']/1e9:.2f} GB |")
    print(f"| ideal ms/step at {H100_HBM_GBPS:.0f} GB/s (H100) | "
          f"{res['ideal_ms']:.2f} |")
    print(f"| measured ms/step ({WINDOW_STEPS}-step window, {where}) | "
          f"{ms:.2f} |")
    print(f"| bandwidth-bound fraction | "
          f"{100.0 * res['bandwidth_bound_fraction']:.2f}% |")
    if solve_ms is not None:
        print(f"| whole-solve mean ms/step (prime included) | "
              f"{solve_ms:.2f} |")
        print(f"| bandwidth-bound fraction of the whole-solve mean | "
              f"{100.0 * res['ideal_ms'] / solve_ms:.2f}% |")


if __name__ == "__main__":
    main()
