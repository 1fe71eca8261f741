#!/usr/bin/env python
"""Sector-planner bench on the PyTorch port: fresh-goal latency of the
full field pipeline vs the hierarchical sector planner, on the
flagship-style grid.

The port's twin of ``analysis/sector_bench.py``.  Four measured sections:

1. ``fresh_goal`` — ms per FRESH goal: the full pipeline (fixpoint sweep
   -> direction extraction -> nibble pack, exactly what solverd's
   chunk-of-1 pays; ``sweep_scan`` on the card) against
   ``SectorPlanner.plan_goal`` (its path by device: the batched window
   sweeps on the card, scipy's BFS on the CPU) for S in {32, 64, 128},
   p50/p95 over seeded random goal/start draws, beside the full sweep at
   1024^2 (the 1024^2 warehouse, one goal a draw) measured in the same
   run;
2. ``epsilon`` — corridor suboptimality distribution: corridor distance
   at each start vs the true shortest path (scipy BFS reference), the
   committed bound is eps <= 0.05;
3. ``resident_bytes`` — per-goal host bytes: the corridor packed row
   (HW/2) vs the full repair mirror (5 bytes/cell: int32 distances +
   byte dirs), plus the corridor cell fraction actually computed;
4. ``fleet`` — a live-churn rung of ``analysis/torch_fleetsim.py`` (walls
   toggling mid-run via world_update_request) served with JG_SECTOR=1 by
   the port's daemon (on the card unless ``--cpu``); completion ratio
   must hold 1.0.  Its map, logs and output go under ``--log-dir``.

Usage:
  python analysis/torch_sector_bench.py --out results/torch_sector.json
  python analysis/torch_sector_bench.py --quick     # 512^2, S=64, no fleet
(the card unless ``--cpu``; without CUDA and without ``--cpu`` it exits
nonzero.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from p2p_distributed_tswap_tpu_torch.core.grid import Grid  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import sector  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops.distance import (  # noqa: E402
    direction_fields,
    pack_directions,
)

BASELINE_SIDE = 1024  # the full-sweep baseline's grid: the 1024^2 warehouse


def _pct(xs, p):
    return round(float(np.percentile(np.asarray(xs, np.float64), p)), 3)


def _ref_dist(free: np.ndarray, goal: int) -> np.ndarray:
    """True shortest-path distances from ``goal`` (scipy C BFS over the
    full-grid 4-adjacency CSR — independent of the planner's tables)."""
    from scipy.sparse.csgraph import dijkstra

    g = sector._grid_graph(free)
    d = dijkstra(g, directed=False, indices=goal, unweighted=True)
    d[~np.isfinite(d)] = float(sector.INF)
    return d


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _full_ms(free: np.ndarray, draws: int, rng, device) -> list:
    """ms of the full pipeline (one cached field end to end, as solverd's
    ``_fields``) for each of ``draws`` random goals, after a warm call."""
    cells = np.flatnonzero(free.reshape(-1))
    fj = torch.as_tensor(np.array(free), device=device)

    def full(gl):
        return pack_directions(direction_fields(fj, gl).reshape(1, -1))

    full(torch.tensor([int(cells[0])], dtype=torch.int32, device=device))
    _sync(device)
    out = []
    for _ in range(draws):
        gl = torch.tensor([int(rng.choice(cells))], dtype=torch.int32,
                          device=device)
        t0 = time.perf_counter()
        full(gl)
        _sync(device)
        out.append(1000.0 * (time.perf_counter() - t0))
    return out


def full_sweep_baseline_ms(draws: int, seed: int, device="cuda") -> float:
    """Mean ms of the full pipeline on the 1024^2 warehouse, measured on
    ``device`` in this run (the baseline a fresh goal's corridor plan is
    held to)."""
    free = np.asarray(Grid.warehouse(BASELINE_SIDE, BASELINE_SIDE).free)
    return float(np.mean(_full_ms(free, draws,
                                  np.random.default_rng(seed), device)))


def bench_fresh_goal(free: np.ndarray, sizes, goals: int, full_goals: int,
                     starts_per_goal: int, seed: int, device="cuda",
                     baseline_ms: float | None = None) -> dict:
    h, w = free.shape
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(free.reshape(-1))

    full_ms = _full_ms(free, full_goals, rng, device)

    out = {
        "grid": f"{h}x{w}",
        "full_goals": full_goals,
        "full_ms_p50": _pct(full_ms, 50),
        "full_ms_p95": _pct(full_ms, 95),
        "full_sweep_baseline_1024_ms": (round(baseline_ms, 3)
                                        if baseline_ms is not None
                                        else None),
        "sector": [],
    }
    for s in sizes:
        t0 = time.perf_counter()
        pl = sector.SectorPlanner(free, s=s, device=device)
        build_ms = 1000.0 * (time.perf_counter() - t0)
        plan_ms, corridor_cells, plan_bytes = [], [], []
        for _ in range(goals):
            gl = int(rng.choice(cells))
            sts = [int(c)
                   for c in rng.choice(cells, starts_per_goal,
                                       replace=False) if int(c) != gl]
            t0 = time.perf_counter()
            plan = pl.plan_goal(gl, sts)
            plan_ms.append(1000.0 * (time.perf_counter() - t0))
            corridor_cells.append(plan.cells)
            plan_bytes.append(int(plan.packed.nbytes))
            pl.forget(gl)  # every draw pays the FRESH-goal cost
        out["sector"].append({
            "s": s,
            "build_ms": round(build_ms, 1),
            "goals": goals,
            "starts_per_goal": starts_per_goal,
            "plan_ms_p50": _pct(plan_ms, 50),
            "plan_ms_p95": _pct(plan_ms, 95),
            "speedup_p95_vs_full": round(
                _pct(full_ms, 95) / max(1e-9, _pct(plan_ms, 95)), 1),
            "corridor_cells_mean": int(np.mean(corridor_cells)),
            "corridor_fraction": round(
                float(np.mean(corridor_cells)) / (h * w), 4),
            "packed_row_bytes": int(np.mean(plan_bytes)),
        })
    return out


def bench_epsilon(free: np.ndarray, s: int, goals: int,
                  starts_per_goal: int, seed: int, device="cuda") -> dict:
    """Corridor distance vs true shortest path on seeded draws."""
    rng = np.random.default_rng(seed + 1)
    cells = np.flatnonzero(free.reshape(-1))
    pl = sector.SectorPlanner(free, s=s, device=device)
    eps, checked = [], 0
    for _ in range(goals):
        gl = int(rng.choice(cells))
        sts = [int(c) for c in rng.choice(cells, starts_per_goal,
                                          replace=False) if int(c) != gl]
        plan = pl.plan_goal(gl, sts, keep_dist=True)
        fd = _ref_dist(free, gl)
        cdist = plan.dist.reshape(-1)
        for st in sts:
            if fd[st] >= float(sector.INF):
                continue
            cd, truth = int(cdist[st]), int(fd[st])
            assert cd >= truth, (gl, st)
            eps.append((cd - truth) / max(1, truth))
            checked += 1
        pl.forget(gl)
    return {
        "s": s,
        "pairs": checked,
        "eps_mean": round(float(np.mean(eps)), 5) if eps else None,
        "eps_p95": _pct(eps, 95) if eps else None,
        "eps_max": round(float(np.max(eps)), 5) if eps else None,
        "bound": 0.05,
        "within_bound": bool(eps and float(np.max(eps)) <= 0.05),
    }


def resident_bytes(fresh: dict, free: np.ndarray) -> dict:
    """Per-goal host-resident bytes: corridor vs full repair mirror.
    The device row is HW/2 packed either way — the saving is the host
    mirror solverd keeps per cached goal (5 bytes/cell: int32 distance
    + byte dirs, runtime/solverd.py MIRROR_BYTES sizing)."""
    hw = int(np.prod(free.shape))
    full_mirror = 5 * hw
    rows = []
    for r in fresh["sector"]:
        rows.append({
            "s": r["s"],
            "corridor_packed_bytes": r["packed_row_bytes"],
            "corridor_fraction_computed": r["corridor_fraction"],
            "full_mirror_bytes": full_mirror,
            "ratio_vs_full_mirror": round(
                full_mirror / max(1, r["packed_row_bytes"]), 1),
        })
    return {"grid_cells": hw, "per_goal": rows}


def bench_fleet(args) -> dict:
    """Live-churn rung of the fleetsim twin served with JG_SECTOR=1: walls
    toggle mid-run, the sector corridors re-plan through the repair queue,
    and completion ratio must hold 1.0."""
    root = Path(__file__).resolve().parents[1]
    from p2p_distributed_tswap_tpu_torch.runtime.fleet import BUILD_DIR
    import shutil

    if not (BUILD_DIR / "mapd_bus").exists() \
            and (shutil.which("cmake") is None
                 or shutil.which("ninja") is None):
        return {"skipped": "C++ runtime unavailable"}
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    out = log_dir / "sector_bench_fleet.json"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, str(root / "analysis" / "torch_fleetsim.py"),
           "--agents", str(args.fleet_agents),
           "--side", str(args.fleet_side),
           "--tick-ms", "250", "--settle", "16",
           "--window", str(args.fleet_window), "--seed", "1",
           "--solver", "tpu", "--world-toggle-cells", "5",
           "--world-toggle-every", "5", "--no-trace",
           "--log-dir", str(log_dir / "fleet_logs"),
           "--out", str(out), *(["--cpu"] if args.cpu else [])]
    env = dict(os.environ, JG_SECTOR="1",
               JG_SECTOR_CELLS=str(args.fleet_sector_cells))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900, env=env, cwd=root)
    except subprocess.TimeoutExpired:
        return {"error": "fleetsim timeout"}
    if not out.exists():
        return {"error": (proc.stderr or proc.stdout or "no output")[-300:]}
    rung = json.loads(out.read_text())["rungs"][0]
    sig = rung.get("signals") or {}
    return {
        "agents": rung.get("agents"),
        "side": args.fleet_side,
        "sector_cells": args.fleet_sector_cells,
        "world": rung.get("world"),
        "tasks_per_s": sig.get("fleet.tasks_per_s"),
        "completion_ratio": sig.get("fleet.completion_ratio"),
        "completion_ratio_is_1": sig.get("fleet.completion_ratio") == 1.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--sizes", default="32,64,128",
                    help="comma list of sector sizes S")
    ap.add_argument("--goals", type=int, default=20,
                    help="fresh-goal draws per sector size")
    ap.add_argument("--full-goals", type=int, default=5,
                    help="full-pipeline draws (each costs a full sweep)")
    ap.add_argument("--starts", type=int, default=2,
                    help="starts folded per fresh goal (serving hands "
                         "plan_goal the requesting lane positions — "
                         "one or two on a fresh goal; more starts "
                         "union more route corridors)")
    ap.add_argument("--eps-goals", type=int, default=8,
                    help="goals sampled for the suboptimality section")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help="bench.py axis scale: 512^2, S=64 only, "
                         "no fleet rung")
    ap.add_argument("--no-fleet", action="store_true")
    ap.add_argument("--fleet-agents", type=int, default=12)
    ap.add_argument("--fleet-side", type=int, default=48)
    ap.add_argument("--fleet-sector-cells", type=int, default=16)
    ap.add_argument("--fleet-window", type=float, default=30.0)
    ap.add_argument("--log-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_sector_bench_logs"),
        help="the fleet rung's map, logs and output")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_sector_bench: CUDA is not available; pass --cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    if args.quick:
        args.side, args.sizes = 512, "64"
        args.goals, args.full_goals, args.eps_goals = 8, 3, 4
        args.no_fleet = True
    sizes = [int(s) for s in args.sizes.split(",") if s.strip()]

    grid = Grid.random_obstacles(args.side, args.side, 0.15, args.seed)
    free = np.asarray(grid.free).copy()
    doc = {
        "experiment": "hierarchical sector-graph planner: fresh-goal "
                      "latency vs full field pipeline",
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    print(f"sector_bench: full-sweep baseline @ {BASELINE_SIDE}^2",
          flush=True)
    baseline = full_sweep_baseline_ms(args.full_goals, args.seed, device)
    print(f"sector_bench: fresh goal @ {args.side}^2, S={sizes}",
          flush=True)
    doc["fresh_goal"] = bench_fresh_goal(free, sizes, args.goals,
                                         args.full_goals, args.starts,
                                         args.seed, device, baseline)
    print(json.dumps(doc["fresh_goal"]), flush=True)
    print("sector_bench: suboptimality", flush=True)
    eps_s = 64 if 64 in sizes else sizes[0]
    doc["epsilon"] = bench_epsilon(free, eps_s, args.eps_goals,
                                   args.starts, args.seed, device)
    print(json.dumps(doc["epsilon"]), flush=True)
    doc["resident_bytes"] = resident_bytes(doc["fresh_goal"], free)
    if not args.no_fleet:
        print("sector_bench: live-churn fleet rung", flush=True)
        doc["fleet"] = bench_fleet(args)
        print(json.dumps(doc["fleet"]), flush=True)

    default_row = next((r for r in doc["fresh_goal"]["sector"]
                        if r["s"] == 64), doc["fresh_goal"]["sector"][0])
    doc["acceptance"] = {
        "fresh_goal_p95_speedup_at_default_s":
            default_row["speedup_p95_vs_full"],
        "speedup_ge_20x": default_row["speedup_p95_vs_full"] >= 20.0,
        "p95_vs_full_sweep_baseline": round(
            baseline / max(1e-9, default_row["plan_ms_p95"]),
            1) if args.side == BASELINE_SIDE else None,
        "eps_within_bound": doc["epsilon"]["within_bound"],
        "fleet_completion_1": (doc.get("fleet") or {}).get(
            "completion_ratio_is_1"),
    }
    ok = bool(doc["acceptance"]["speedup_ge_20x"]
              and doc["acceptance"]["eps_within_bound"])
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2) + "\n")
        fg, ep = doc["fresh_goal"], doc["epsilon"]
        md = [
            "# sector — hierarchical sector-graph planner (PyTorch port)",
            "",
            f"- grid: {fg['grid']} (15% obstacles), device "
            f"{doc['device']}",
            f"- full pipeline fresh goal: p50 {fg['full_ms_p50']} ms / "
            f"p95 {fg['full_ms_p95']} ms "
            f"(1024^2 full-sweep baseline "
            f"{fg['full_sweep_baseline_1024_ms']} ms, same run)",
        ]
        for r in fg["sector"]:
            md.append(
                f"- S={r['s']}: plan p50 {r['plan_ms_p50']} ms / p95 "
                f"{r['plan_ms_p95']} ms (**{r['speedup_p95_vs_full']}x** "
                f"vs full p95), corridor "
                f"{100 * r['corridor_fraction']:.1f}% of cells, build "
                f"{r['build_ms']} ms")
        md.append(
            f"- suboptimality (S={ep['s']}, {ep['pairs']} pairs): mean "
            f"{ep['eps_mean']}, p95 {ep['eps_p95']}, max {ep['eps_max']} "
            f"(bound {ep['bound']}; within: {ep['within_bound']})")
        rb = doc["resident_bytes"]["per_goal"][0]
        md.append(
            f"- per-goal host bytes: corridor packed row "
            f"{rb['corridor_packed_bytes']} vs full repair mirror "
            f"{rb['full_mirror_bytes']} "
            f"(**{rb['ratio_vs_full_mirror']}x** smaller)")
        if doc.get("fleet") and not doc["fleet"].get("skipped"):
            f = doc["fleet"]
            md.append(
                f"- live-churn fleet rung (JG_SECTOR=1, "
                f"{f['side']}^2, S={f['sector_cells']}): "
                f"{(f.get('world') or {}).get('requests')} wall "
                f"event(s), completion ratio {f['completion_ratio']} "
                f"(1.0: {f['completion_ratio_is_1']})")
        out.with_name(out.name + ".md").write_text("\n".join(md) + "\n")
    print(json.dumps({"acceptance": doc["acceptance"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
