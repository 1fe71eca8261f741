"""EXTREME-shaped rehearsal of the 2-D (agents x tiles) sharded solver on
the PyTorch port.

The port's twin of ``analysis/extreme_rehearsal.py``.  It runs the port's
``parallel/sharded2d.py`` at EXTREME's *shape* scaled by memory, not
structure -- thousands of agents, warehouse bands, EXTREME's per-device
replan chunk -- TO COMPLETION with the step invariants folded on the
device every step, and records the per-shard field residency arithmetic
(what EXTREME's memory plan rests on) next to the measured run and the
device's peak allocation.

The mesh is virtual: every shard of the A x T mesh lives on one device
(``parallel/virtual_mesh.virtual_devices``: ``cuda:0``, or the CPU under
``--cpu``), so the shards time-slice it and ms/step measures the mesh's
host overhead on one device, not scaling.  The point is capability and
residency, not speed.

Checkpoint/resume: ``--checkpoint PATH`` saves the full sharded MapdState
(``solver/checkpoint.py``, the packed rows gathered to the host) with the
loop latches in the same archive every ``--checkpoint-every`` steps and at
``--max-seconds`` session end; ``--resume`` restores it, lays the rows out
over the mesh again, skips the prime burst (the fields ride the
checkpoint) and continues bit-identically.

Usage:
  python analysis/torch_extreme_rehearsal.py --probe 8   # time 8 steps
  python analysis/torch_extreme_rehearsal.py            # full certified run
  python analysis/torch_extreme_rehearsal.py --out results/torch_rehearsal.json
  python analysis/torch_extreme_rehearsal.py --checkpoint ck.npz --max-seconds 3600
  python analysis/torch_extreme_rehearsal.py --checkpoint ck.npz --resume
(the card unless ``--cpu``; without CUDA and without ``--cpu`` it exits
nonzero.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FETCH_EVERY = 32


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=2048)
    ap.add_argument("--tasks", type=int, default=2048)
    ap.add_argument("--side", type=int, default=1024,
                    help="warehouse side (EXTREME is 4096)")
    ap.add_argument("--a-shards", type=int, default=2)
    ap.add_argument("--tiles", type=int, default=4)
    ap.add_argument("--replan-chunk", type=int, default=64,
                    help="EXTREME's 512 / 8 devices")
    ap.add_argument("--horizon", type=int, default=6000)
    ap.add_argument("--probe", type=int, default=0,
                    help="time N steps and exit (feasibility probe)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="save resumable state here periodically")
    ap.add_argument("--checkpoint-every", type=int, default=256,
                    help="steps between checkpoint saves")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    ap.add_argument("--max-seconds", type=float, default=0,
                    help="end this session (with a checkpoint) after N s")
    ap.add_argument("--cpu", action="store_true",
                    help="run the virtual mesh on the CPU (the default is "
                         "the card)")
    return ap


def rehearse(args, device="cuda", log=print) -> dict:
    """The rehearsal of ``args`` (this script's options) on a virtual mesh
    of ``device``: the probe's record, a paused session's record, or the
    completed run's.  The record's ``state`` is the final MapdState (its
    ``dirs`` laid out over the mesh); :func:`main` drops it."""
    import numpy as np
    import torch

    from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
    from p2p_distributed_tswap_tpu_torch.core.grid import Grid
    from p2p_distributed_tswap_tpu_torch.core.sampling import (
        start_positions_array)
    from p2p_distributed_tswap_tpu_torch.core.tasks import TaskGenerator
    from p2p_distributed_tswap_tpu_torch.ops.distance import packed_cells
    from p2p_distributed_tswap_tpu_torch.ops.tiled_distance import bands_of
    from p2p_distributed_tswap_tpu_torch.parallel import sharded, sharded2d
    from p2p_distributed_tswap_tpu_torch.parallel.mesh import (
        Sharded, agent_tile_mesh)
    from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
        virtual_devices)
    from p2p_distributed_tswap_tpu_torch.solver import invariants, mapd
    from p2p_distributed_tswap_tpu_torch.solver.checkpoint import (
        load_extra, load_state, save_state)

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    grid = Grid.warehouse(args.side, args.side)
    n = args.agents
    cfg = SolverConfig(height=args.side, width=args.side, num_agents=n,
                       max_timesteps=args.horizon, record_paths=False,
                       replan_chunk=args.replan_chunk)
    starts = start_positions_array(grid, n, seed=0)
    tasks = TaskGenerator(grid, seed=1).generate_task_arrays(args.tasks)
    n_shards = args.a_shards * args.tiles
    mesh = agent_tile_mesh(args.a_shards, args.tiles,
                           virtual_devices(n_shards, dev))
    sharded2d.check_2d(cfg, mesh)
    spec = sharded2d.state_specs_2d()["dirs"]

    # per-shard residency arithmetic (what EXTREME's memory plan scales up)
    rows_dev = n // args.a_shards
    band_words = packed_cells(cfg.num_cells) // args.tiles
    dirs_dev_mb = rows_dev * band_words * 4 / 2**20
    sweep_dev_mb = (args.replan_chunk * (args.side // args.tiles)
                    * args.side * 4) / 2**20

    free_full = torch.as_tensor(np.asarray(grid.free), dtype=torch.bool,
                                device=mesh.lead)
    free_local = bands_of(free_full, mesh)

    def fused_iter(s, tasks_t, ok, done_t):
        """One loop iteration: the step, the invariant fold, the makespan
        latch and the finished flag, all left on the device."""
        prev = s.pos
        s = sharded2d.sharded2d_mapd_step(cfg, mesh, s, tasks_t, free_local)
        ok = ok & invariants.step_invariants(cfg, prev, s.pos, free_full)
        fin = mapd._finished(cfg, s)
        done_t = torch.where((done_t < 0) & fin, s.t, done_t)
        return s, ok, done_t, fin

    log(f"# config: {n} agents, {args.side}^2 warehouse, mesh "
        f"{args.a_shards}x{args.tiles} (virtual: every shard on {dev}), "
        f"replan_chunk {args.replan_chunk}")
    log(f"# per-shard: {rows_dev} field rows x {args.side // args.tiles}-row "
        f"band = {dirs_dev_mb:.0f} MB packed dirs, "
        f"{sweep_dev_mb:.0f} MB sweep transient")

    base_bytes = None
    if on_card:
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base_bytes = int(torch.cuda.memory_allocated(dev))
    steps = 0
    prime_s = 0.0     # one-time field prime (paid once, rides checkpoints)
    prior_s = 0.0     # loop wall-clock banked by previous sessions
    sessions = 1
    ok = torch.ones((), dtype=torch.bool, device=mesh.lead)
    done_t = torch.full((), -1, dtype=torch.int32, device=mesh.lead)
    tasks_t = torch.as_tensor(tasks, dtype=torch.int32, device=mesh.lead)
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        # the state and its loop latches live in one archive
        s = load_state(args.checkpoint, cfg, expected_num_tasks=len(tasks),
                       device=mesh.lead)
        s = s.replace(dirs=Sharded.put(mesh, s.dirs, spec))
        meta = load_extra(args.checkpoint)
        steps = int(meta["steps"])
        ok = torch.tensor(bool(meta["invariants_ok"]), device=mesh.lead)
        done_t = torch.tensor(int(meta["done_t"]), dtype=torch.int32,
                              device=mesh.lead)
        prime_s = float(meta["prime_s"])
        prior_s = float(meta["loop_s"])
        sessions = int(meta["sessions"]) + 1
        log(f"# resumed session {sessions} at t={steps} "
            f"({prior_s:.0f}s loop banked; prime burst skipped -- the "
            f"fields ride the checkpoint)")
    else:
        s, tasks_t = sharded._start(cfg, mesh, starts, tasks, spec)
        sync()
        t0 = time.perf_counter()
        s = sharded2d._prime_2d(cfg, mesh, s, free_local)
        int(s.t)
        sync()
        prime_s = time.perf_counter() - t0
        log(f"# prime burst: {prime_s:.1f}s")

    residency = {
        "per_shard_dirs_mb": round(dirs_dev_mb, 1),
        "per_shard_sweep_mb": round(sweep_dev_mb, 1),
        "resident_bytes_per_shard": {
            str(k): int(v) for k, v in sorted(s.dirs.nbytes().items())},
        "virtual_shards": n_shards, "device": str(dev),
    }

    def peak() -> dict:
        """The device's peak allocation since the start (the process's
        allocations before it are ``base_bytes``)."""
        if not on_card:
            return {"peak_bytes": None, "base_bytes": None}
        sync()
        return {"peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
                "base_bytes": base_bytes}

    def save_ckpt(elapsed_now):
        # .npz suffix so np.savez doesn't append one behind our back
        tmp = args.checkpoint + ".tmp.npz"
        save_state(tmp, s, extra={
            "steps": steps, "done_t": int(done_t),
            "invariants_ok": bool(ok), "sessions": sessions,
            "prime_s": prime_s, "loop_s": prior_s + elapsed_now})
        os.replace(tmp, args.checkpoint)

    t0 = time.perf_counter()
    if args.probe:
        for _ in range(args.probe):
            s, ok, done_t, _ = fused_iter(s, tasks_t, ok, done_t)
            steps += 1
        int(s.t)
        sync()
        ms = 1000.0 * (time.perf_counter() - t0) / steps
        log(f"# probe: {ms:.0f} ms/step (virtual shards of one device, "
            f"time-sliced), invariants_ok={bool(ok)}")
        return {"probe_steps": steps, "ms_per_step_virtual": round(ms, 3),
                "invariants_ok": bool(ok), "prime_s": round(prime_s, 3),
                "mesh": f"{args.a_shards}x{args.tiles}",
                **residency, **peak(), "state": s}

    session_steps = 0
    last_saved = steps
    finished = False
    while not finished and steps < cfg.max_timesteps + FETCH_EVERY:
        for _ in range(FETCH_EVERY):
            s, ok, done_t, fin = fused_iter(s, tasks_t, ok, done_t)
            steps += 1
            session_steps += 1
        finished = bool(fin)
        elapsed = time.perf_counter() - t0
        if steps % 512 == 0:
            log(f"# t={steps} elapsed={elapsed:.0f}s (session {sessions})")
        # steps only lands on multiples of FETCH_EVERY, so compare against
        # the last save instead of a modulo that could never fire
        if args.checkpoint and steps - last_saved >= args.checkpoint_every:
            save_ckpt(elapsed)
            last_saved = steps
        if args.max_seconds and elapsed > args.max_seconds and not finished:
            save_ckpt(elapsed)
            return {"session": sessions, "paused_at_step": steps,
                    "session_steps": session_steps,
                    "session_s": round(elapsed, 1),
                    "total_s": round(prime_s + prior_s + elapsed, 1),
                    "resume": f"--checkpoint {args.checkpoint} --resume",
                    "state": s}
    sync()
    elapsed = time.perf_counter() - t0
    if args.checkpoint:
        save_ckpt(elapsed)
    makespan = int(done_t)
    completed = bool(s.task_used.all()) and 0 < makespan
    return {
        "experiment": "EXTREME-shaped 2-D mesh rehearsal (virtual shards of "
                      f"one {dev.type} device)",
        "agents": n, "grid": f"{args.side}x{args.side} warehouse",
        "tasks": args.tasks,
        "mesh": f"{args.a_shards}x{args.tiles}",
        "replan_chunk": args.replan_chunk,
        "per_device_dirs_mb": round(dirs_dev_mb, 1),
        "per_device_sweep_mb": round(sweep_dev_mb, 1),
        "ms_per_step_virtual": round(
            1000.0 * (prior_s + elapsed) / max(steps, 1), 1),
        "makespan": makespan if completed else None,
        "completed": completed,
        "invariants_ok": bool(ok),
        "steps_run": steps,
        "prime_s": round(prime_s, 1),
        "wallclock_s": round(prime_s + prior_s + elapsed, 1),
        "sessions": sessions,
        **residency, **peak(), "state": s,
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_extreme_rehearsal: CUDA is not available; pass "
                 "--cpu to run the virtual mesh on the CPU")
    if args.cpu:  # many small ops: intra-op threads cost more than they give
        torch.set_num_threads(1)
    result = rehearse(args, "cpu" if args.cpu else "cuda",
                      log=lambda m: print(m, flush=True))
    result.pop("state")
    print(json.dumps(result), flush=True)
    if args.out and "paused_at_step" not in result:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
