"""Decentralized-mode step-cost ablation on the PyTorch port.

The port's twin of ``analysis/decent_premium.py``.  Variants (each a FULL
solve on the device, run twice: a warm run, then the timed run ended by
``torch.cuda.synchronize()``):

  cent          — the rung (global view)
  decent        — the rung's radius-15 fresh-mask variant
  decent_nomask — the same config with ``solver/step.py``'s
                  ``_within_radius`` patched to all-true: keeps every
                  membership and initiator pass, ablates only the pairwise
                  Manhattan arithmetic.  (Behavior changes — swaps ignore
                  distance — so makespan may drift; the number is a
                  cost-structure probe, not a benchmark.)
  stale         — the rung's stale/async variant (ONE decision round
                  instead of swap_rounds x (Rule3+Rule4))

Each variant runs in a FRESH SUBPROCESS of this file: flagship solves hold
~5 GB of field rows, and several variants resident in one process would
share the allocator's cache.  A child gets ``--cpu`` only when the parent
has it.  Each child's JSON line also carries the kernel launches of its
timed run (``kernel_launches``).

Usage: python analysis/torch_decent_premium.py [--rung flagship] [--cpu]
Prints a markdown table (the card unless ``--cpu``; without CUDA and
without ``--cpu`` it exits nonzero).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

VARIANTS = ("cent", "decent", "decent_nomask", "stale")


def run_variant(rung: str, variant: str, device="cuda") -> dict:
    import torch

    from p2p_distributed_tswap_tpu_torch.models import scenarios
    from p2p_distributed_tswap_tpu_torch.ops import field_fused, sweep_kernel
    from p2p_distributed_tswap_tpu_torch.solver import mapd, step as step_mod

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    base = {"medium": scenarios.MEDIUM,
            "flagship": scenarios.FLAGSHIP}[rung]
    scn = {"cent": base,
           "decent": base.decentralized(),
           "decent_nomask": base.decentralized(),
           "stale": base.stale()}[variant]
    orig_wr = step_mod._within_radius
    try:
        if variant == "decent_nomask":
            step_mod._within_radius = (
                lambda cfg, pos, i_idx, j_idx:
                torch.ones_like(i_idx, dtype=torch.bool))
        grid, starts, tasks, cfg = scn.build(seed=0)
        args = (cfg, starts, tasks, grid.free, device)
        final = mapd.run_mapd(*args)
        sync()
        sweeps0 = sweep_kernel.launches
        fused0 = dict(field_fused.launches)
        t0 = time.perf_counter()
        final = mapd.run_mapd(*args)
        sync()
        steps = int(final.t)
    finally:
        step_mod._within_radius = orig_wr
    return {"variant": variant,
            "ms_per_step": round(1000.0 * (time.perf_counter() - t0) / steps,
                                 2),
            "makespan": steps,
            "completed": bool(final.task_used.all()),
            "kernel_launches": {
                "sweep_scan": sweep_kernel.launches - sweeps0,
                **{f"field_fused_{m}": field_fused.launches[m] - fused0[m]
                   for m in fused0}}}


def run_variants(rung: str, cpu: bool) -> list:
    """Every variant in a fresh subprocess of this file; the rows of those
    that answered, in ``VARIANTS`` order."""
    rows = []
    for v in VARIANTS:
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--rung",
                 rung, "--variant", v, *(["--cpu"] if cpu else [])],
                capture_output=True, text=True, timeout=3600)
        except subprocess.TimeoutExpired:
            print(f"# {v}: FAILED (timeout 3600s)", file=sys.stderr)
            continue
        out = None
        for line in reversed(proc.stdout.strip().splitlines()):
            try:
                out = json.loads(line)
                break
            except json.JSONDecodeError:
                continue
        if out is None:
            print(f"# {v}: FAILED\n{(proc.stderr or '')[-400:]}",
                  file=sys.stderr)
            continue
        rows.append(out)
        print(f"# {v}: {out['ms_per_step']} ms/step, makespan "
              f"{out['makespan']}, completed={out['completed']}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rung", default="flagship",
                    choices=["medium", "flagship"])
    ap.add_argument("--variant", default=None, help="(internal) child mode")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (the default is the card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_decent_premium: CUDA is not available; pass --cpu "
                 "to solve on the CPU")
    if args.variant:
        if args.cpu:  # many small ops: intra-op threads cost more
            torch.set_num_threads(1)
        device = "cpu" if args.cpu else "cuda"
        print(json.dumps(run_variant(args.rung, args.variant, device)),
              flush=True)
        return

    rows = run_variants(args.rung, args.cpu)
    if not rows or rows[0]["variant"] != "cent":
        sys.exit(1)
    cent_ms = rows[0]["ms_per_step"]
    print("\n| variant | ms/step | makespan | vs cent |")
    print("|---|---|---|---|")
    for r in rows:
        note = "" if r["completed"] else " (horizon)"
        print(f"| {r['variant']} | {r['ms_per_step']} "
              f"| {r['makespan']}{note} | "
              f"{r['ms_per_step'] / cent_ms:.2f}x |")


if __name__ == "__main__":
    main()
