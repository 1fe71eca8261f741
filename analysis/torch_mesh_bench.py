#!/usr/bin/env python
"""Mesh-daemon measurement harness of the PyTorch port: the rungs of the
sharded serving plane on virtual shards of one device.

The port's twin of ``analysis/mesh_bench.py``.  For each mesh rung (flat,
2-way, 8-way agent axis by default) a fresh subprocess drives a synthetic
packed-wire fleet through the port's ``TickRunner`` and reports:

- ``tick_ms`` p50/p95 of the whole decode->plan->encode tick;
- ``sweep_ms``: one cold 8-goal direction-field sweep chunk;
- per-shard resident bytes of the planning state (dirs cache + lanes);
- a determinism fingerprint: FNV-1a over every packed reply byte, plus
  the final mirror/device/fields audit digests;
- the rung's kernel launches (``sweep_scan``, ``field_fused``).

The shards are virtual: every shard of a rung's mesh lives on ``cuda:0``
(``parallel/virtual_mesh.virtual_devices``), or on the CPU under ``--cpu``,
so they time-slice one device: the committed verdict is exactness and the
per-shard residency, and tick times measure the mesh's host overhead on
one device, not scaling.  A rung runs in its own process as the original's
does (there, because of how JAX starts its client), which keeps the
``--rung`` CLI and the order of the work; each pays for starting CUDA
before its tick window.

The driver compares fingerprints across rungs (``bit_identical`` must be
true), and, unless ``--no-replay``, replays the committed CI capture
through a 2-way mesh daemon (``scripts/torch_chaos_gate.py --determinism
--solver tpu`` under ``JG_SOLVER_MESH=2``, its shards virtual shards of the
card through ``JG_SOLVER_MESH_VIRTUAL=1``) for the live determinism proof.

Usage:
  python analysis/torch_mesh_bench.py [--meshes 1,2,8] [--agents 16]
      [--side 32] [--ticks 12] [--no-replay] [--out results/...json] [--cpu]
  python analysis/torch_mesh_bench.py --rung --mesh 2 ...   # one subprocess
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
DEFAULT_CAPTURE = ROOT / "results" / "captures" / "ci_small.capture.json"


def run_rung(args) -> dict:
    """One mesh rung in THIS process, on virtual shards of ``cuda:0`` (or
    of the CPU under ``args.cpu``)."""
    import numpy as np
    import torch

    from p2p_distributed_tswap_tpu_torch.core.grid import Grid
    from p2p_distributed_tswap_tpu_torch.obs import audit as au
    from p2p_distributed_tswap_tpu_torch.ops import field_fused, sweep_kernel
    from p2p_distributed_tswap_tpu_torch.parallel import solver_mesh
    from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
        virtual_devices)
    from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
    from p2p_distributed_tswap_tpu_torch.runtime.solverd import (PlanService,
                                                                 TickRunner)

    device = "cpu" if args.cpu else "cuda:0"
    on_card = not args.cpu

    def sync():
        if on_card:
            torch.cuda.synchronize()

    spec = args.mesh
    shape = solver_mesh.mesh_spec_from_env(spec)
    n_dev = shape[0] * shape[1] if shape else 1

    grid = Grid.from_ascii("\n".join(["." * args.side] * args.side) + "\n")
    mesh = (solver_mesh.SolverMesh(*shape,
                                   devices=virtual_devices(n_dev, device))
            if shape else None)
    svc = PlanService(grid, capacity_min=16, mesh=mesh, device=device)
    svc.defer_fields = False
    runner = TickRunner(svc, grid)
    enc = pc.PackedFleetEncoder(snapshot_every=64)

    rng = np.random.default_rng(11)
    free = np.flatnonzero(np.asarray(grid.free).reshape(-1)).astype(int)
    n = args.agents
    cells = rng.choice(free, size=2 * n, replace=False)
    fleet = {f"p{k}": [int(cells[k]), int(cells[n + k])]
             for k in range(n)}

    def items():
        return [(nm, p, g) for nm, (p, g) in sorted(fleet.items())]

    launches0 = (sweep_kernel.launches, dict(field_fused.launches))
    # cold sweep chunk: 8 fresh goals through the (possibly sharded) field
    # path -- the kernels' build and load excluded via one warm call on 8
    # other goals
    warm_goals = [int(c) for c in rng.choice(free, size=8, replace=False)]
    svc._ensure_fields(warm_goals)
    sync()
    cold_goals = [int(c) for c in rng.choice(
        np.setdiff1d(free, warm_goals), size=8, replace=False)]
    t0 = time.perf_counter()
    svc._ensure_fields(cold_goals)
    sync()
    sweep_ms = 1000.0 * (time.perf_counter() - t0)

    fp = au.FNV64_OFFSET
    tick_ms = []
    for seq in range(1, args.ticks + 1):
        t0 = time.perf_counter()
        resp = runner.handle({"type": "plan_request", "seq": seq,
                              "codec": pc.CODEC_NAME,
                              "caps": [pc.CODEC_NAME],
                              "data": pc.encode_b64(
                                  enc.encode_tick(seq, items()))})
        tick_ms.append(1000.0 * (time.perf_counter() - t0))
        fp = au.fnv1a64(resp["data"].encode(), fp)
        rp = pc.decode_b64(resp["data"])
        for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
            fleet[runner.packed.name_of(int(lane))] = [int(c), int(g)]
        k = f"p{int(rng.integers(n))}"
        fleet[k][1] = int(rng.choice(free))  # task churn

    tick_ms.sort()
    m, _ = au.lane_digest(*svc.audit_views("mirror"))
    d, _ = au.lane_digest(*svc.audit_views("device"))
    fresh = [g for g in svc.goal_rows if g != -1 and not svc._is_stale(g)]
    fd, _ = au.cells_digest(fresh)
    per = svc.resident_shard_bytes()
    total = (sum(per.values()) if per else
             sum(a.numel() * a.element_size()
                 for a in (svc.dirs, svc.d_pos, svc.d_goal, svc.d_slot,
                           svc.d_active) if a is not None))
    fused = {k: v - launches0[1].get(k, 0)
             for k, v in field_fused.launches.items()}
    return {
        "mesh": spec or "1",
        "devices": n_dev,
        "virtual": True,
        "device": device,
        "agents": n,
        "side": args.side,
        "ticks": args.ticks,
        "tick_ms_p50": round(tick_ms[len(tick_ms) // 2], 2),
        # nearest-rank p95 (ceil, not trunc -- trunc under-reports by a
        # whole rank at these small tick counts)
        "tick_ms_p95": round(
            tick_ms[max(0, -(-len(tick_ms) * 19 // 20) - 1)], 2),
        "sweep_chunk8_ms": round(sweep_ms, 2),
        "resident_bytes_total": int(total),
        "resident_bytes_per_shard": {str(k): int(v)
                                     for k, v in sorted(per.items())},
        "resident_bytes_peak_shard": int(max(per.values())) if per
        else int(total),
        "kernel_launches": {
            "sweep_scan": sweep_kernel.launches - launches0[0],
            **{f"field_fused_{k}": v for k, v in sorted(fused.items())}},
        "fingerprint": {
            "responses": au.digest_hex(fp),
            "mirror": au.digest_hex(m),
            "device": au.digest_hex(d),
            "fields": au.digest_hex(fd),
        },
    }


def run_replay_proof(log_dir: str, capture: Path, cpu: bool = False) -> dict:
    """The live proof: the committed CI capture re-driven through a 2-way
    mesh daemon, twice -- the chaos twin's determinism pair must come back
    green (identical completed sets + equal audit digests at the drained
    watermark)."""
    import shutil

    if not capture.exists():
        return {"skipped": f"no capture at {capture}"}
    # the same availability rule as every other gate: prebuilt binaries
    # or the cmake+ninja toolchain ensure_built() uses
    if not (ROOT / "cpp" / "build" / "mapd_bus").exists() \
            and (shutil.which("cmake") is None
                 or shutil.which("ninja") is None):
        return {"skipped": "C++ runtime unavailable"}
    out = Path(tempfile.mkdtemp(prefix="torch-mesh-replay-")) / "chaos.json"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(JG_SOLVER_MESH="2", JG_SOLVER_MESH_VIRTUAL="1")
    cmd = [sys.executable, str(ROOT / "scripts" / "torch_chaos_gate.py"),
           "--capture", str(capture), "--determinism", "--solver", "tpu",
           "--out", str(out), "--log-dir", log_dir,
           *(["--cpu"] if cpu else [])]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900, env=env, cwd=str(ROOT))
    except subprocess.TimeoutExpired:
        return {"error": "replay timeout"}
    if not out.exists():
        return {"error": (proc.stderr or proc.stdout or "no output")[-400:]}
    doc = json.loads(out.read_text())
    det = doc.get("determinism") or {}
    return {
        "capture": str(capture.relative_to(ROOT)),
        "solver_mesh": "2",
        "determinism_ok": det.get("ok"),
        "completed_equal": det.get("completed_equal"),
        "digests": {k: v.get("equal")
                    for k, v in (det.get("digests") or {}).items()},
        "verdicts": {v["fault"]: v["verdict"]
                     for v in doc.get("matrix") or []},
        "seconds": round(time.perf_counter() - t0, 1),
    }


def render_md(doc: dict) -> str:
    md = ["# Mesh daemon of the port -- exactness + residency rungs", ""]
    md.append(f"- bit-identical across rungs: **{doc['bit_identical']}** "
              "(packed replies, mirror/device/fields digests)")
    rungs = doc["rungs"]
    md.append("")
    md.append("| mesh | devices (virtual) | tick p50 ms | tick p95 ms | "
              "sweep(8) ms | peak shard MB | total MB |")
    md.append("|---|---|---|---|---|---|---|")
    for r in rungs:
        md.append(
            f"| {r['mesh']} | {r['devices']} | {r['tick_ms_p50']} "
            f"| {r['tick_ms_p95']} | {r['sweep_chunk8_ms']} "
            f"| {r['resident_bytes_peak_shard'] / 2**20:.2f} "
            f"| {r['resident_bytes_total'] / 2**20:.2f} |")
    md.append("")
    rp = doc.get("replay") or {}
    if rp.get("determinism_ok") is not None:
        md.append(f"Replay through a 2-way mesh daemon "
                  f"(`{rp.get('capture')}`): determinism proof "
                  f"**{'PASS' if rp['determinism_ok'] else 'FAIL'}** "
                  f"(completed sets equal={rp.get('completed_equal')}, "
                  f"digests {rp.get('digests')}).")
    elif rp:
        md.append(f"Replay proof: {rp.get('skipped') or rp.get('error')}")
    md.append("")
    md.append(doc["note"])
    return "\n".join(md) + "\n"


def run_rungs(meshes, agents: int, side: int, ticks: int, cpu: bool,
              log=print) -> list:
    """Each rung in a fresh subprocess, in order; returns their records
    (raises RuntimeError when a rung fails)."""
    from p2p_distributed_tswap_tpu_torch.parallel.solver_mesh import (
        parse_mesh_spec)

    rungs = []
    for spec in meshes:
        a, t = parse_mesh_spec(spec)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--rung",
               "--mesh", spec, "--agents", str(agents),
               "--side", str(side), "--ticks", str(ticks),
               *(["--cpu"] if cpu else [])]
        log(f"mesh_bench: rung mesh={spec} ({a * t} virtual shards)...")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1200, cwd=str(ROOT))
        if proc.returncode != 0:
            raise RuntimeError(f"rung {spec} failed:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        rung = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"mesh_bench:   tick p50 {rung['tick_ms_p50']} ms, "
            f"peak shard {rung['resident_bytes_peak_shard'] / 2**20:.2f}"
            f" MB, responses {rung['fingerprint']['responses']}")
        rungs.append(rung)
    return rungs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rung", action="store_true",
                    help="internal: run ONE mesh rung in this process")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec for --rung (None/1 = flat)")
    ap.add_argument("--meshes", default="1,2,8",
                    help="comma list of rung specs for the driver")
    ap.add_argument("--agents", type=int, default=16)
    ap.add_argument("--side", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--no-replay", action="store_true")
    ap.add_argument("--capture", default=str(DEFAULT_CAPTURE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--log-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_mesh_bench_logs"))
    ap.add_argument("--cpu", action="store_true",
                    help="run the rungs and the daemon on the CPU (the "
                         "default is the card)")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_mesh_bench: CUDA is not available; pass --cpu to "
                 "run on the CPU")
    if args.cpu:  # many small ops: intra-op threads cost more than they give
        torch.set_num_threads(1)

    if args.rung:
        print(json.dumps(run_rung(args)), flush=True)
        return 0

    log = lambda m: print(m, flush=True)  # noqa: E731
    try:
        rungs = run_rungs([s.strip() for s in args.meshes.split(",")
                           if s.strip()], args.agents, args.side,
                          args.ticks, args.cpu, log=log)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1

    fps = {json.dumps(r["fingerprint"], sort_keys=True) for r in rungs}
    bit_identical = len(fps) == 1
    doc = {
        "experiment": "mesh daemon rungs (virtual shards of one "
                      f"{'CPU' if args.cpu else 'card'})",
        "bit_identical": bit_identical,
        "rungs": rungs,
        "replay": None,
        "note": ("Virtual-mesh rungs, every shard on one device: the "
                 "committed verdict is EXACTNESS (bit-identical replies + "
                 "audit digests) and the per-shard residency; tick times "
                 "measure the mesh's host overhead on one device, not "
                 "scaling."),
    }
    if not args.no_replay:
        doc["replay"] = run_replay_proof(args.log_dir, Path(args.capture),
                                         cpu=args.cpu)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2) + "\n")
        Path(str(out) + ".md").write_text(render_md(doc))
        print(f"mesh_bench: wrote {out} (+.md)", flush=True)
    print(json.dumps({"bit_identical": bit_identical,
                      "replay_ok": (doc["replay"] or {}).get(
                          "determinism_ok"),
                      "peak_shard_mb": [
                          round(r["resident_bytes_peak_shard"] / 2**20, 2)
                          for r in rungs]}), flush=True)
    return 0 if bit_identical else 1


if __name__ == "__main__":
    sys.exit(main())
