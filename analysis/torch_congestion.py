"""Centralized-vs-decentralized divergence experiment on the PyTorch port.

The port's twin of ``analysis/congestion.py``.  It runs the CONGESTED config
(3k agents on a 256^2 warehouse, ~6% density, dense enough that local
visibility and staleness bite) over seeds in three modes:

- centralized            (global view, atomic)
- decentralized-r15      (fresh radius mask)
- decentralized-r15-stale (views refreshed every 2 steps, one-step
                           non-atomic swap commits)

and emits ms/step AND makespan per (mode, seed) plus per-seed makespan
ratios, as a markdown table (stdout) and a JSON artifact.  Each solve runs
twice on the device: a warm run (the first CUDA launch builds and loads the
port's kernels) and the timed run, ended by ``torch.cuda.synchronize()``.

Usage:  python analysis/torch_congestion.py [--seeds 5] [--cpu]
            [--out results/torch_congestion.json]
(the card unless ``--cpu``; without CUDA and without ``--cpu`` it exits
nonzero.)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(scn, seed, device="cuda"):
    import torch

    from p2p_distributed_tswap_tpu_torch.solver import mapd

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    grid, starts, tasks, cfg = scn.build(seed=seed)
    args = (cfg, starts, tasks, grid.free, device)
    final = mapd.run_mapd(*args)   # warm: kernels built and loaded
    sync()
    t0 = time.perf_counter()
    final = mapd.run_mapd(*args)
    sync()
    elapsed = time.perf_counter() - t0
    steps = int(final.t)
    completed = bool(final.task_used.all()) \
        and steps <= cfg.max_timesteps
    return {"seed": seed, "ms_per_step": round(1000.0 * elapsed / steps, 4),
            "makespan": steps if completed else None,
            "completed": completed}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--out", default="results/torch_congestion.json")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (the default is the card)")
    args = ap.parse_args()

    import torch

    from p2p_distributed_tswap_tpu_torch.models import scenarios

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_congestion: CUDA is not available; pass --cpu to "
                 "solve on the CPU")
    device = "cpu" if args.cpu else "cuda"
    if args.cpu:  # many small ops: intra-op threads cost more than they give
        torch.set_num_threads(1)

    modes = {
        "centralized": scenarios.CONGESTED,
        "decent-fresh": scenarios.CONGESTED_DECENT,
        "decent-stale": scenarios.CONGESTED_DECENT_STALE,
    }
    results = {name: [] for name in modes}
    for name, scn in modes.items():
        for seed in range(args.seeds):
            r = run_one(scn, seed, device)
            r["mode"] = scn.mode
            results[name].append(r)
            print(json.dumps({"rung": scn.name, **r}), flush=True)

    # per-seed ratios vs centralized
    rows = []
    for seed in range(args.seeds):
        c = results["centralized"][seed]
        f = results["decent-fresh"][seed]
        s = results["decent-stale"][seed]

        def ratio(x):
            if c["makespan"] and x["makespan"]:
                return round(x["makespan"] / c["makespan"], 3)
            return None

        rows.append({
            "seed": seed,
            "cent_ms": c["ms_per_step"], "cent_makespan": c["makespan"],
            "fresh_ms": f["ms_per_step"], "fresh_makespan": f["makespan"],
            "fresh_ratio": ratio(f),
            "stale_ms": s["ms_per_step"], "stale_makespan": s["makespan"],
            "stale_ratio": ratio(s),
        })

    artifact = {
        "experiment": "congested cent-vs-decent divergence",
        "config": {"agents": scenarios.CONGESTED.num_agents,
                   "grid": "256x256 warehouse",
                   "seeds": args.seeds,
                   "stale_mode": scenarios.CONGESTED_DECENT_STALE.mode},
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu"),
        "rows": rows,
        "raw": results,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=2)

    print("\n| seed | cent ms/step | cent makespan | fresh ms/step | "
          "fresh makespan (ratio) | stale ms/step | stale makespan (ratio) |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['seed']} | {r['cent_ms']} | {r['cent_makespan']} "
              f"| {r['fresh_ms']} | {r['fresh_makespan']} "
              f"({r['fresh_ratio']}) | {r['stale_ms']} "
              f"| {r['stale_makespan']} ({r['stale_ratio']}) |")
    print(f"\nartifact: {args.out}")


if __name__ == "__main__":
    main()
