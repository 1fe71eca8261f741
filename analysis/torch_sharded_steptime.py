"""Virtual-mesh step-time comparison on the PyTorch port: one device vs the
8-way agent-sharded solver vs 2x4 (agents x tiles).

The port's twin of ``analysis/sharded_steptime.py``.  Its three rows run the
port's ``solver/mapd.py``, ``parallel/sharded.py`` and
``parallel/sharded2d.py`` on the same problem.  The shards are virtual:
every shard of a mesh lives on one device (``virtual_devices(8, ...)`` on
``cuda:0``, or on the CPU under ``--cpu``), so they time-slice it, and the
ratio sharded/single measures the work and host overhead that sharding adds
(the next-hop psum, the sharded replan's bookkeeping, the banded sweeps'
halo exchanges) on one device, not parallel scaling.

Usage: python analysis/torch_sharded_steptime.py [--steps K] [--cpu]
Prints one aligned table (the card unless ``--cpu``; without CUDA and
without ``--cpu`` it exits nonzero).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WARMUP = 8


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _measure(step, s, tasks, free, steps, device):
    for _ in range(WARMUP):
        s = step(s, tasks, free)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        s = step(s, tasks, free)
    _sync(device)
    return 1000.0 * (time.perf_counter() - t0) / steps, s


def build_problem(side: int = 128, n: int = 128, replan_chunk: int = 32):
    """The original's problem: ``n`` agents on a ``side``² random-obstacle
    grid (10 %), ``n`` tasks; host arrays."""
    import numpy as np

    from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
    from p2p_distributed_tswap_tpu_torch.core.grid import Grid
    from p2p_distributed_tswap_tpu_torch.core.sampling import (
        start_positions_array)
    from p2p_distributed_tswap_tpu_torch.core.tasks import TaskGenerator

    grid = Grid.random_obstacles(side, side, 0.1, seed=0)
    cfg = SolverConfig(height=side, width=side, num_agents=n,
                       replan_chunk=replan_chunk)
    starts = start_positions_array(grid, n, seed=0)
    tasks = TaskGenerator(grid, seed=1).generate_task_arrays(n)
    return (grid, cfg, np.asarray(starts, np.int32),
            np.asarray(tasks, np.int32), np.asarray(grid.free))


def bench_single(cfg, starts, tasks, free, steps, device="cuda"):
    import functools

    import torch

    from p2p_distributed_tswap_tpu_torch.solver import mapd

    s, tasks = mapd.prepare_state(cfg, starts, tasks, free, device)
    free = torch.as_tensor(free, dtype=torch.bool, device=s.pos.device)
    return _measure(functools.partial(mapd.mapd_step, cfg), s, tasks, free,
                    steps, device)


def bench_sharded(cfg, starts, tasks, free, steps, device="cuda"):
    from p2p_distributed_tswap_tpu_torch.parallel import sharded
    from p2p_distributed_tswap_tpu_torch.parallel.mesh import agent_mesh
    from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
        virtual_devices)

    mesh = agent_mesh(devices=virtual_devices(8, device))
    s, tasks, free = sharded.prepare_state_sharded(cfg, mesh, starts, tasks,
                                                   free)
    return _measure(
        lambda st, tk, fr: sharded.sharded_mapd_step(cfg, mesh, st, tk, fr),
        s, tasks, free, steps, device)


def bench_sharded2d(cfg, starts, tasks, free, steps, device="cuda"):
    from p2p_distributed_tswap_tpu_torch.parallel import sharded2d
    from p2p_distributed_tswap_tpu_torch.parallel.mesh import agent_tile_mesh
    from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
        virtual_devices)

    mesh = agent_tile_mesh(2, 4, devices=virtual_devices(8, device))
    s, tasks, free = sharded2d.prepare_state_2d(cfg, mesh, starts, tasks,
                                                free)
    return _measure(
        lambda st, tk, fr: sharded2d.sharded2d_mapd_step(cfg, mesh, st, tk,
                                                         fr),
        s, tasks, free, steps, device)


def run(steps: int, device="cuda", problem=None, log=print) -> dict:
    """The three rows in the original's order, each a (name, ms/step,
    ratio to single); ``states`` holds each variant's final state.  Raises
    if a sharded variant's positions differ from the single device's."""
    import torch

    grid, cfg, starts, tasks, free = problem or build_problem()
    dev = torch.device(device)
    where = ("virtual shards of cuda:0" if dev.type == "cuda"
             else "virtual CPU shards")
    log(f"# config: {cfg.num_agents} agents, {grid.height}x{grid.width} "
        f"random-obstacle grid, {int(tasks.shape[0])} tasks, "
        f"replan_chunk_small={cfg.replan_chunk_small}, "
        f"{steps} measured steps on 8 {where} (one device, time-sliced)")
    rows = []
    ms1, s1 = bench_single(cfg, starts, tasks, free, steps, device)
    rows.append(("single-device", ms1, 1.0))
    ms8, s8 = bench_sharded(cfg, starts, tasks, free, steps, device)
    rows.append(("sharded 8 (agents)", ms8, ms8 / ms1))
    ms2d, s2d = bench_sharded2d(cfg, starts, tasks, free, steps, device)
    rows.append(("sharded 2x4 (agents x tiles)", ms2d, ms2d / ms1))
    # same trajectory on every variant (bit-identity spot check)
    if not torch.equal(s1.pos.cpu(), s8.pos.cpu()):
        raise AssertionError("sharded-8 diverged from single-device")
    if not torch.equal(s1.pos.cpu(), s2d.pos.cpu()):
        raise AssertionError("sharded-2x4 diverged from single-device")
    return {"rows": rows, "steps": WARMUP + steps, "virtual": where,
            "states": {"single": s1, "sharded8": s8, "sharded2x4": s2d}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_sharded_steptime: CUDA is not available; pass --cpu "
                 "to run the virtual mesh on the CPU")
    if args.cpu:  # many small ops: intra-op threads cost more than they give
        torch.set_num_threads(1)
    res = run(args.steps, "cpu" if args.cpu else "cuda",
              log=lambda m: print(m, flush=True))
    print(f"{'variant':<30} {'ms/step':>9} {'vs single':>10}")
    for name, ms, ratio in res["rows"]:
        print(f"{name:<30} {ms:>9.2f} {ratio:>9.2f}x")
    print(f"# positions bit-identical across all variants after "
          f"{res['steps']} steps; the shards are {res['virtual']}: ms/step "
          "is the mesh's overhead on one device, not scaling")
    return 0


if __name__ == "__main__":
    sys.exit(main())
