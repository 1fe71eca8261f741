#!/usr/bin/env python
"""Field-engine bench on the PyTorch port: full resweep vs bounded-region
repair vs the multi-field fused kernel, plus the dynamic-obstacle fleet rung.

The port's twin of ``analysis/field_bench.py``.  Three sections:

1. ``repair_vs_full`` — ms/field of a FULL fixpoint resweep (the sweep ->
   extract -> pack pipeline solverd's chunk-of-1 pays, ``sweep_scan`` on
   the card) against the incremental path (ops/field_repair.py repair +
   band direction re-derivation + host repack) for localized obstacle
   toggles on the flagship-style grid, bit-identity asserted per event;
2. ``multi_field`` — the multi-field fused kernel (``field_fused``, the
   instance ``MAPD_FUSED=1`` runs) against the sweeps' ``direction_fields``
   at (16, 64, 128) (the original's shape) and at the congested rung's
   (4, 256, 256): codes equal, ms per field from CUDA events, and a GO /
   NO-GO verdict from the card's numbers.  With ``--cpu`` both are their
   plain versions: the section records their identity and measures
   nothing;
3. ``fleet`` — a dynamic-obstacle rung of ``analysis/torch_fleetsim.py``
   (walls closing mid-run via world_update_request) whose completion ratio
   must stay 1.0, the port's daemon on the card unless ``--cpu``; its map,
   logs and output go under ``--log-dir``.

Usage:
  python analysis/torch_field_bench.py --out results/torch_field_engine.json
  python analysis/torch_field_bench.py --quick          # CI-scale settings
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
from p2p_distributed_tswap_tpu_torch.ops import field_fused  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import field_repair  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops.distance import (  # noqa: E402
    direction_fields,
    directions_from_distance,
    distance_fields,
    pack_directions,
)

# (G, H, W) of the multi-field section: the original's shape, and the
# congested rung's in-step chunk on its 256^2 warehouse
MULTI_SHAPES = ((16, 64, 128), (4, 256, 256))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _grid(kind: str, side: int, seed: int) -> Grid:
    if kind == "warehouse":
        return Grid.warehouse(side, side)
    if kind == "obstacles":
        return Grid.random_obstacles(side, side, 0.15, seed)
    free = np.ones((side, side), np.bool_)
    return Grid(free)


def bench_repair(side: int, kind: str, events: int, toggle_cells: int,
                 repeats: int, seed: int, device="cuda") -> dict:
    grid = _grid(kind, side, seed)
    free = np.asarray(grid.free).copy()
    rng = np.random.default_rng(seed)
    h, w = free.shape
    free_flat = free.reshape(-1)
    goal = int(rng.choice(np.flatnonzero(free_flat)))

    def on_device(mask):
        return torch.as_tensor(np.array(mask), device=device)

    # the full pipeline one cached field costs solverd (sweep fixpoint ->
    # direction extraction -> nibble pack)
    def full(fr, gl):
        return pack_directions(direction_fields(fr, gl).reshape(1, -1))

    gvec = torch.tensor([goal], dtype=torch.int32, device=device)
    full(on_device(free), gvec)  # warm: kernels built and loaded
    _sync(device)
    full_ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        full(on_device(free), gvec)
        _sync(device)
        full_ms.append(1000.0 * (time.perf_counter() - t0))

    def field(mask):
        return distance_fields(on_device(mask), gvec).cpu().numpy()[0]

    dist = field(free)
    dirs = field_repair.directions_np(dist, free)

    def random_wall():
        """A localized vertical wall of free cells away from the goal."""
        for _ in range(200):
            x = int(rng.integers(1, w - 1))
            y = int(rng.integers(0, max(1, h - toggle_cells)))
            cells = [(y + i) * w + x for i in range(toggle_cells)]
            if goal in cells or not all(free_flat[c] for c in cells):
                continue
            return cells
        return []

    repair_ms = []
    fallbacks = 0
    prev_wall: list = []
    identical = True
    event = 0
    while event < events:
        toggles = list(prev_wall)  # reopen the previous wall
        wall = random_wall()
        if not wall:
            break
        toggles += wall
        for c in prev_wall:
            free_flat[c] = True
        for c in wall:
            free_flat[c] = False
        prev_wall = wall
        t0 = time.perf_counter()
        res = field_repair.repair_field(dist, free, toggles, device=device)
        if res is None:
            fallbacks += 1
            dist = field(free)
            dirs = field_repair.directions_np(dist, free)
            event += 1
            continue
        new_dist, (y0, y1, x0, x1) = res
        b0, b1 = max(0, y0 - 1), min(h, y1 + 1)
        if b1 > b0:
            dirs[b0:b1] = field_repair.directions_np(new_dist, free,
                                                     b0, b1)
        packed = field_repair.pack_rows_np(dirs.reshape(-1))
        ms = 1000.0 * (time.perf_counter() - t0)
        dist = new_dist
        if event > 0:  # event 0 warms the windowed-fixpoint path
            repair_ms.append(ms)
        # exactness against the ground truth, every event
        fr = on_device(free)
        ref = distance_fields(fr, gvec)
        ref_d = ref.cpu().numpy()[0]
        ref_p = pack_directions(directions_from_distance(ref, fr)
                                .reshape(1, -1)).cpu().numpy()[0]
        if not (np.array_equal(dist, ref_d)
                and np.array_equal(packed.view(np.int32), ref_p)):
            identical = False
        event += 1

    full_mean = float(np.mean(full_ms))
    repair_mean = float(np.mean(repair_ms)) if repair_ms else None
    return {
        "grid": f"{side}x{side} {kind}",
        "toggle_cells": toggle_cells,
        "events": events,
        "repeats": repeats,
        "full_resweep_ms": [round(v, 2) for v in full_ms],
        "full_resweep_ms_mean": round(full_mean, 2),
        "repair_ms": [round(v, 2) for v in repair_ms],
        "repair_ms_mean": (round(repair_mean, 2)
                           if repair_mean is not None else None),
        "repair_fallbacks": fallbacks,
        "speedup_vs_full": (round(full_mean / repair_mean, 1)
                            if repair_mean else None),
        "bit_identical_to_full_recompute": identical,
    }


def _multi_inputs(g: int, h: int, w: int, device):
    """The original's random grid and goals at (16, 64, 128); at the
    congested rung's shape its 256^2 warehouse, goals drawn from its free
    cells."""
    rng = np.random.default_rng(0)
    if (h, w) == (64, 128):
        free_np = rng.random((h, w)) > 0.25
    else:
        free_np = np.asarray(Grid.warehouse(h, w).free)
    goals = rng.choice(np.flatnonzero(free_np.reshape(-1)), g, replace=False)
    return (torch.as_tensor(np.array(free_np), device=device),
            torch.as_tensor(goals, dtype=torch.int32, device=device))


def _event_ms(fn, repeats: int) -> list:
    """Device ms of each of ``repeats`` calls of ``fn`` (after one warm
    call), from CUDA events around the call; a call that syncs with the
    host (the sweeps' fixpoint) is timed whole."""
    fn()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def bench_multi_field(repeats: int, device="cuda") -> dict:
    """The multi-field kernel against the sweeps' pipeline at each of
    ``MULTI_SHAPES``.  Measured on the card only; on the CPU both are
    their plain versions and the section records their identity."""
    dev = torch.device(device)
    out: dict = {"backend": dev.type}
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
    shapes = []
    for g, h, w in MULTI_SHAPES:
        free, goals = _multi_inputs(g, h, w, dev)

        def multi():
            return field_fused.multi_direction_fields(free, goals)

        def sweeps():
            return directions_from_distance(distance_fields(free, goals),
                                            free)

        row = {"shape": [g, h, w],
               "codes_equal": bool(torch.equal(multi(), sweeps()))}
        if dev.type == "cuda":
            ms_multi = [t / g for t in _event_ms(multi, repeats)]
            ms_sweeps = [t / g for t in _event_ms(sweeps, repeats)]
            row["ms_per_field_multi"] = round(float(np.mean(ms_multi)), 5)
            row["ms_per_field_sweeps"] = round(float(np.mean(ms_sweeps)), 5)
            row["ms_per_field_multi_runs"] = [round(t, 5) for t in ms_multi]
            row["ms_per_field_sweeps_runs"] = [round(t, 5)
                                               for t in ms_sweeps]
            row["verdict"] = ("GO" if row["ms_per_field_multi"]
                              < row["ms_per_field_sweeps"] else "NO-GO")
        shapes.append(row)
    out["shapes"] = shapes
    out["codes_equal"] = all(r["codes_equal"] for r in shapes)
    if dev.type != "cuda":
        out["verdict"] = "NO-GO (unmeasured)"
        out["decision"] = (
            "no card: both paths ran their plain versions, whose codes "
            "are recorded equal; the kernel's time is measured only on "
            "the card (run without --cpu).  The kernel stays opt-in "
            "(MAPD_FUSED=1).")
        return out
    win = all(r["verdict"] == "GO" for r in shapes)
    out["verdict"] = "GO" if win else "NO-GO"
    out["decision"] = (
        "the multi-field kernel wins the micro-measure at every shape — "
        "confirm on real steps (chip_smoke.py's congested solve under "
        "MAPD_FUSED=1) before flipping the default" if win else
        "the multi-field kernel loses the micro-measure at "
        + ", ".join(str(r["shape"]) for r in shapes
                    if r["verdict"] != "GO")
        + "; it stays opt-in (MAPD_FUSED=1)")
    return out


def bench_fleet(args) -> dict:
    """Dynamic-obstacle fleet rung of the fleetsim twin: walls close
    mid-run, completion ratio must hold 1.0."""
    root = Path(__file__).resolve().parents[1]
    from p2p_distributed_tswap_tpu_torch.runtime.fleet import BUILD_DIR
    import shutil

    if not (BUILD_DIR / "mapd_bus").exists() \
            and (shutil.which("cmake") is None
                 or shutil.which("ninja") is None):
        return {"skipped": "C++ runtime unavailable"}
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    out = log_dir / "field_bench_fleet.json"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, str(root / "analysis" / "torch_fleetsim.py"),
           "--agents", str(args.fleet_agents), "--side", "24",
           "--tick-ms", "250", "--settle", "14",
           "--window", str(args.fleet_window), "--seed", "1",
           "--solver", "tpu", "--world-toggle-cells", "6",
           "--world-toggle-every", "5", "--no-trace",
           "--log-dir", str(log_dir / "fleet_logs"),
           "--out", str(out), *(["--cpu"] if args.cpu else [])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=root)
    except subprocess.TimeoutExpired:
        return {"error": "fleetsim timeout"}
    if not out.exists():
        return {"error": (proc.stderr or proc.stdout or "no output")[-300:]}
    rung = json.loads(out.read_text())["rungs"][0]
    sig = rung.get("signals") or {}
    return {
        "agents": rung.get("agents"),
        "tick_ms": rung.get("tick_ms"),
        "world": rung.get("world"),
        "tasks_per_s": sig.get("fleet.tasks_per_s"),
        "completion_ratio": sig.get("fleet.completion_ratio"),
        "completion_ratio_is_1": sig.get("fleet.completion_ratio") == 1.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--map", choices=["warehouse", "obstacles", "empty"],
                    default="warehouse")
    ap.add_argument("--events", type=int, default=8,
                    help="toggle events (event 0 warms the window path "
                         "and is not timed)")
    ap.add_argument("--toggle-cells", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help="CI-scale: 256^2, 4 events, 1 repeat, no fleet")
    ap.add_argument("--no-fleet", action="store_true")
    ap.add_argument("--fleet-agents", type=int, default=12)
    ap.add_argument("--fleet-window", type=float, default=25.0)
    ap.add_argument("--log-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_field_bench_logs"),
        help="the fleet rung's map, logs and output")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_field_bench: CUDA is not available; pass --cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    if args.quick:
        args.side, args.events, args.repeats = 256, 4, 1
        args.no_fleet = True

    doc = {
        "experiment": "incremental field engine: full resweep vs "
                      "bounded-region repair vs multi-field kernel",
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    print(f"field_bench: repair vs full @ {args.side}^2 {args.map}",
          flush=True)
    doc["repair_vs_full"] = bench_repair(args.side, args.map, args.events,
                                         args.toggle_cells, args.repeats,
                                         args.seed, device)
    print(json.dumps(doc["repair_vs_full"]), flush=True)
    print("field_bench: multi-field kernel", flush=True)
    doc["multi_field"] = bench_multi_field(args.repeats, device)
    print(json.dumps(doc["multi_field"]), flush=True)
    if not args.no_fleet:
        print("field_bench: dynamic-obstacle fleet rung", flush=True)
        doc["fleet"] = bench_fleet(args)
        print(json.dumps(doc["fleet"]), flush=True)

    r = doc["repair_vs_full"]
    ok = bool(r["bit_identical_to_full_recompute"]
              and (r["speedup_vs_full"] or 0) >= 5.0)
    doc["acceptance"] = {
        "repair_ge_5x_cheaper": (r["speedup_vs_full"] or 0) >= 5.0,
        "repair_bit_identical": r["bit_identical_to_full_recompute"],
        "multi_field_verdict": doc["multi_field"]["verdict"],
        "fleet_completion_1": (doc.get("fleet") or {}).get(
            "completion_ratio_is_1"),
    }
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2) + "\n")
        md = [
            "# field_engine — incremental repair + multi-field kernel "
            "(PyTorch port)",
            "",
            f"- grid: {r['grid']}, device {doc['device']}",
            f"- full resweep: **{r['full_resweep_ms_mean']} ms/field**",
            f"- bounded-region repair: **{r['repair_ms_mean']} ms** per "
            f"localized {r['toggle_cells']}-cell wall event "
            f"(**{r['speedup_vs_full']}x** cheaper; "
            f"{r['repair_fallbacks']} fallback(s); bit-identical: "
            f"{r['bit_identical_to_full_recompute']})",
            f"- multi-field kernel: {doc['multi_field']['verdict']} — "
            f"{doc['multi_field']['decision']}",
        ]
        if doc.get("fleet") and not doc["fleet"].get("skipped"):
            f = doc["fleet"]
            md.append(f"- dynamic-obstacle fleet rung: {f['agents']} "
                      f"agents, {(f.get('world') or {}).get('requests')} "
                      f"wall event(s), completion ratio "
                      f"{f['completion_ratio']} "
                      f"(1.0: {f['completion_ratio_is_1']})")
        out.with_name(out.name + ".md").write_text("\n".join(md) + "\n")
    print(json.dumps({"acceptance": doc["acceptance"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
