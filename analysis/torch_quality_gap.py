"""Assignment-aware routing estimate against a measured makespan, on the
PyTorch port.

The port's twin of ``analysis/quality_gap.py``.  The swap-free routing
estimate charges each task the distance from the NEAREST agent start to its
pickup (min over ALL agents).  With few agents on a large grid the ASSIGNED
agent's journey is much longer than the nearest agent's.  This script
recomputes the estimate ASSIGNMENT-AWARE: a greedy nearest-pickup matching
(the solver's own assignment policy, solver/mapd._assign) over exact BFS
start->pickup distances, then
  assigned_est = max_i  bfs(start_assigned(i) -> pickup_i) + bfs(pickup_i
                 -> delivery_i).
If assigned_est lands near the measured makespan, the gap is assignment
geometry, not solve slack.

The BFS fields come from the port's ``distance_fields`` on the device, in
chunks, and the start and delivery distances are gathered there, so whole
fields never reach the host (a chunk of 8 fields at 4096^2 is 536 MB).

The default ``--measured-makespan`` 12782 is the makespan of the port's own
whole ``512a-4096-warehouse-full`` solve on an H100
(``analysis/torch_extreme_full.py``).

Usage: python analysis/torch_quality_gap.py [--rung extreme_lite_full]
           [--cpu] [--out results/torch_quality_gap.json]
(the card unless ``--cpu``; without CUDA and without ``--cpu`` it exits
nonzero.)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from p2p_distributed_tswap_tpu_torch.models import scenarios  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops.distance import (  # noqa: E402
    INF, distance_fields)


def quality_gap(scn, measured_makespan: int, chunk: int, device,
                log=print) -> dict:
    """The original's ``main`` body for the rung ``scn``: the estimate
    dict, with the BFS fields computed and gathered on ``device``."""
    grid, starts, tasks, cfg = scn.build(seed=0)
    starts = np.asarray(starts)
    tasks = np.asarray(tasks)
    n, t = len(starts), len(tasks)
    free_t = torch.as_tensor(np.asarray(grid.free), dtype=torch.bool,
                             device=device)

    starts_t = torch.as_tensor(starts, dtype=torch.long, device=device)

    def chunk_bfs_gather(free, goals, dl, r):
        # gather ON DEVICE: whole (r, H*W) fields never reach the host
        f = distance_fields(free, goals,
                            max_rounds=cfg.max_sweep_rounds).reshape(r, -1)
        rows = torch.arange(r, device=f.device)
        return f[:, starts_t], f[rows, dl.long()]

    # exact BFS start->pickup for ALL (agent, task) pairs, and pickup->
    # delivery per task, from pickup-sourced fields (chunked to bound
    # device memory at 4096²)
    r = chunk
    d_sp = np.zeros((t, n), np.int64)   # task x agent
    d_pd = np.zeros(t, np.int64)
    for o in range(0, t, r):
        sel = np.clip(np.arange(o, o + r), 0, t - 1)
        sp, pd = chunk_bfs_gather(
            free_t, torch.as_tensor(tasks[sel, 0], dtype=torch.int32,
                                    device=device),
            torch.as_tensor(tasks[sel, 1], dtype=torch.int32,
                            device=device), r)
        d_sp[sel] = sp.cpu().numpy()
        d_pd[sel] = pd.cpu().numpy()
        log(f"# fields {min(o + r, t)}/{t}")

    # the solver's greedy policy: agents in slot order take the nearest
    # unused pickup (mirrors solver/mapd._assign's parallel chunked greedy
    # closely enough for an estimate)
    unused = np.ones(t, bool)
    assigned = np.full(t, -1)
    for a in range(n):
        cand = np.where(unused)[0]
        if not len(cand):
            break
        best = cand[np.argmin(d_sp[cand, a])]
        assigned[best] = a
        unused[best] = False

    m = assigned >= 0
    per_task_assigned = d_sp[np.arange(t)[m], assigned[m]] + d_pd[m]
    per_task_nearest = d_sp[m].min(axis=1) + d_pd[m]
    valid = per_task_assigned < int(INF)
    return {
        "rung": scn.name, "agents": n, "tasks": t,
        "measured_makespan": measured_makespan,
        "routing_est_nearest_start": int(per_task_nearest[valid].max()),
        "routing_est_assigned": int(per_task_assigned[valid].max()),
        "assigned_over_measured": round(
            float(per_task_assigned[valid].max())
            / measured_makespan, 3),
        "measured_over_assigned": round(
            measured_makespan
            / float(per_task_assigned[valid].max()), 3),
        "mean_start_pickup_assigned": round(
            float(d_sp[np.arange(t)[m], assigned[m]][valid].mean()), 1),
        "mean_start_pickup_nearest": round(
            float(d_sp[m].min(axis=1)[valid].mean()), 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rung", default="extreme_lite_full")
    ap.add_argument("--measured-makespan", type=int, default=12782)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_quality_gap: CUDA is not available; pass --cpu to "
                 "run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    scn = getattr(scenarios, args.rung.upper())
    result = quality_gap(scn, args.measured_makespan, args.chunk, device,
                         log=lambda m: print(m, flush=True))
    print(json.dumps(result, indent=2))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
