"""The whole ``EXTREME_LITE_FULL`` solve (512 agents on the 4096² warehouse,
a 20 000-step horizon) on an NVIDIA GPU, through the PyTorch port.

It primes the fields (the host chunked prime), then steps until every task
is done or the horizon is passed, with ``step_invariants`` folded over
every step on the card, and reports the makespan, whether the solve
completed within its horizon, whether every step was certified, ms/step,
host syncs and ``sweep_scan`` launches per step, and peak device memory,
beside the card's name and power limit.  ``--budget-s`` stops the solve
after that many seconds of stepping and reports it as not finished.

Run from the root of a checkout on a machine with the card:

    python3 analysis/torch_extreme_full.py [--budget-s 900] [--out r.json]

``MAPD_FUSED`` in the environment selects the field path as for the solve
(the fused kernel's gates do not admit 4096², so it stays on the sweeps).
Prints one JSON line (and writes it to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from p2p_distributed_tswap_tpu_torch import hostsync  # noqa: E402
from p2p_distributed_tswap_tpu_torch.models import scenarios  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel  # noqa: E402
from p2p_distributed_tswap_tpu_torch.solver import (  # noqa: E402
    invariants,
    mapd,
)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget-s", type=float, default=900.0,
                    help="stop stepping after this many seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_extreme_full: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    scn = scenarios.EXTREME_LITE_FULL
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    hostsync.count = sweep_kernel.launches = 0
    t0 = time.perf_counter()
    s, tasks_t = mapd.prepare_state(cfg, starts, tasks, free, device=dev)
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    prime_syncs, prime_launches = hostsync.count, sweep_kernel.launches
    ok = torch.ones((), dtype=torch.bool, device=dev)
    t1 = time.perf_counter()
    steps = 0
    finished = False
    while time.perf_counter() - t1 < args.budget_s:
        if hostsync.flag(mapd._finished(cfg, s)):
            finished = True
            break
        prev = s.pos
        s = mapd.mapd_step(cfg, s, tasks_t, free)
        ok = ok & invariants.step_invariants(cfg, prev, s.pos, free)
        steps += 1
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    makespan = int(s.t)
    out = {
        "scenario": scn.name, "agents": cfg.num_agents,
        "grid": [cfg.height, cfg.width], "horizon": cfg.max_timesteps,
        "card": card(), "device": torch.cuda.get_device_name(0),
        "prime_seconds": prime_s, "prime_host_syncs": prime_syncs,
        "prime_sweep_launches": prime_launches,
        "finished": finished, "makespan": makespan if finished else None,
        "steps_run": steps,
        "completed": finished and 0 < makespan <= cfg.max_timesteps,
        "tasks_used": int(s.task_used.sum()),
        "tasks": int(s.task_used.numel()),
        "certified": bool(ok), "step_seconds": step_s,
        "ms_per_step": 1e3 * step_s / max(steps, 1),
        "host_syncs_per_step": (hostsync.count - prime_syncs) / max(steps, 1),
        "sweep_launches_per_step":
            (sweep_kernel.launches - prime_launches) / max(steps, 1),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if out["certified"] else 1


if __name__ == "__main__":
    sys.exit(main())
