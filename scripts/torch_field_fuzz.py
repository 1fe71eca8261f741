#!/usr/bin/env python
"""Field-repair fuzz gate on the PyTorch port: the twin of
``scripts/field_fuzz.py``.  Random obstacle toggle sequences through the
port's ops/field_repair.py must stay BIT-IDENTICAL to a full recompute
— distances AND derived direction codes — across chained repairs (each
event repairs the previous event's output, so any
drift compounds and trips).  Covers the targeted edges too: the
ROI-overflow fallback (must return None, never a wrong field), the
freed-door long-range decrease (window growth), and multi-cluster
batches (a wall reopening far from where one closes).

The full recomputes and the repairs' big-window sweeps run on the card
(``sweep_scan``) unless ``--cpu`` asks for the CPU; without CUDA and without
``--cpu`` it exits nonzero.  On the CPU a window past the Dijkstra ceiling
falls back to a full recompute (``field_repair.default_max_window``), so the
count of exact repairs may differ between the two; bit-identity holds on
both.

Usage: python scripts/torch_field_fuzz.py [--seeds 4] [--events 5] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from p2p_distributed_tswap_tpu_torch.core.grid import Grid  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import field_repair  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops.distance import (  # noqa: E402
    distance_fields,
    directions_from_distance,
)


def _full(free_np, goal, device):
    free = torch.as_tensor(np.array(free_np), device=device)
    d = distance_fields(free, torch.tensor([goal], dtype=torch.int32,
                                           device=device))
    # writable copies: the fuzz loop patches the dirs band in place
    return (np.array(d.cpu())[0],
            np.array(directions_from_distance(d, free).cpu())[0])


def fuzz_seed(seed: int, events: int, device="cuda") -> int:
    """One chained toggle sequence on one random world; returns the
    number of exact (non-fallback) repairs."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        free = rng.random((24, 24)) > 0.25
    elif kind == 1:
        free = np.asarray(Grid.warehouse(32, 32).free).copy()
    else:
        free = np.ones((16, 48), np.bool_)
    h, w = free.shape
    flat = free.reshape(-1)
    goal = int(rng.choice(np.flatnonzero(flat)))
    dist, dirs = _full(free, goal, device)
    repaired = 0
    prev_batch: list = []
    for _ in range(events):
        # sliding batches: reopen the previous cells AND close fresh
        # ones in one update — the multi-cluster shape
        toggles = list(prev_batch)
        fresh = [int(c) for c in rng.integers(0, h * w, size=3)
                 if c != goal and flat[c]][:2]
        toggles += fresh
        for c in prev_batch:
            flat[c] = True  # reopen
        for c in fresh:
            flat[c] = False
        prev_batch = fresh
        res = field_repair.repair_field(dist, free, toggles,
                                        device=device)
        ref_d, ref_dirs = _full(free, goal, device)
        if res is None:
            dist, dirs = ref_d, ref_dirs  # the caller's fallback
            continue
        new_dist, (y0, y1, x0, x1) = res
        assert np.array_equal(new_dist, ref_d), \
            f"seed {seed}: repaired distances diverged"
        b0, b1 = max(0, y0 - 1), min(h, y1 + 1)
        if b1 > b0:
            dirs[b0:b1] = field_repair.directions_np(new_dist, free,
                                                     b0, b1)
        assert np.array_equal(dirs, ref_dirs), \
            f"seed {seed}: band-derived directions diverged"
        assert np.array_equal(
            field_repair.pack_rows_np(dirs.reshape(-1)),
            field_repair.pack_rows_np(ref_dirs.reshape(-1)))
        dist = new_dist
        repaired += 1
    return repaired


def edge_cases(device="cuda") -> None:
    # ROI overflow must refuse, never mis-repair
    free = np.ones((16, 16), np.bool_)
    dist, _ = _full(free, 0, device)
    free[1, :] = False
    assert field_repair.repair_field(
        dist, free, [16 + x for x in range(16)], max_dirty=4,
        device=device) is None
    # freed door: far half re-routes through window growth, still exact
    free = np.ones((24, 24), np.bool_)
    free[:, 12] = False
    goal = 24 * 5 + 2
    dist, _ = _full(free, goal, device)
    free[8, 12] = True
    res = field_repair.repair_field(dist, free, [8 * 24 + 12],
                                    max_window=24 * 24, device=device)
    ref_d, _ = _full(free, goal, device)
    assert res is not None and np.array_equal(res[0], ref_d), \
        "freed-door growth diverged"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--events", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_field_fuzz: CUDA is not available; pass --cpu to "
                 "run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    t0 = time.perf_counter()
    total = 0
    for seed in range(args.seeds):
        total += fuzz_seed(seed, args.events, device)
    assert total > 0, "no toggle event exercised the exact-repair path"
    edge_cases(device)
    print(f"field-repair fuzz gate OK on {device}: {args.seeds} seeds x "
          f"{args.events} chained events, {total} exact repairs, "
          f"overflow + freed-door edges, {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
