#!/usr/bin/env python
"""Sector-planner fuzz gate on the PyTorch port: the twin of
``scripts/sector_fuzz.py``.  Seeded random worlds + chained toggles
through the port's ops/sector.py must keep all three contracts the
serving path relies on:

  1. route validity — the corridor's packed field strictly descends:
     a walk from every planned start reaches the goal in exactly
     corridor-distance steps over free cells, never reading STAY
     (unreachable starts must read STAY and must NOT demand re-entry);
  2. bounded suboptimality — corridor distance at each start is within
     EPS (0.05, the committed bound) of the true shortest path;
  3. repair == recompute — after every block/unblock batch,
     apply_toggles leaves the portal graph + intra tables equal to a
     from-scratch SectorPlanner on the final mask, and re-plans on the
     repaired graph are again exact per (1) and (2).

Also exercises corridor re-entry: off-corridor cells must either fold
into a replanned corridor or be provably unreachable.

Every planner takes the run's device and its path by device
(``sector._use_jit_default``): on the card the batched window sweeps run
through ``sweep_scan`` with one mask per window, on the CPU scipy's BFS.
The card unless ``--cpu``; without CUDA and without ``--cpu`` it exits
nonzero.

Usage: python scripts/torch_sector_fuzz.py [--seeds 6] [--trials 4] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from p2p_distributed_tswap_tpu_torch.core.grid import Grid  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import distance, sector  # noqa: E402

EPS = 0.05  # the committed bound (results/sector_r20.json)


def _bfs_dist(free: np.ndarray, goal: int) -> np.ndarray:
    """Reference full-grid BFS, independent of the planner."""
    h, w = free.shape
    d = np.full(h * w, int(sector.INF), np.int64)
    fr = free.reshape(-1)
    if fr[goal]:
        d[goal] = 0
        dq = deque([goal])
        while dq:
            c = dq.popleft()
            y, x = divmod(c, w)
            for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                ny, nx = y + dy, x + dx
                if 0 <= ny < h and 0 <= nx < w:
                    nc = ny * w + nx
                    if fr[nc] and d[nc] > d[c] + 1:
                        d[nc] = d[c] + 1
                        dq.append(nc)
    return d


def _check_descent(pl, free, gl, st, fd, tag) -> float:
    """Walk the corridor from st; returns the measured epsilon."""
    w = free.shape[1]
    plan = pl.plan_goal(gl, [st], keep_dist=True)
    assert plan is not None, tag
    if fd[st] >= int(sector.INF):
        # unreachable: STAY, and no re-entry churn
        assert pl.code_at(gl, st) == int(distance.DIR_STAY), tag
        assert not pl.needs_reentry(gl, st), tag
        return 0.0
    cd = int(plan.dist.reshape(-1)[st])
    assert cd >= int(fd[st]), (tag, cd, int(fd[st]))
    eps = (cd - int(fd[st])) / max(1, int(fd[st]))
    assert eps <= EPS, (tag, eps)
    c, steps = st, 0
    while c != gl and steps <= cd:
        code = pl.code_at(gl, c)
        assert code != int(distance.DIR_STAY), (tag, c)
        dx, dy = distance.DIR_DXDY[code]
        y, x = divmod(c, w)
        c = (y + dy) * w + (x + dx)
        assert free.reshape(-1)[c], (tag, c)
        steps += 1
    assert c == gl and steps == cd, (tag, steps, cd)
    return eps


def fuzz_seed(seed: int, trials: int, device="cuda") -> tuple:
    """One world, `trials` goal/start pairs + one block/unblock toggle
    round each; returns (reachable pairs checked, max epsilon seen)."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        free = rng.random((64, 64)) > 0.2
    elif kind == 1:
        free = np.asarray(Grid.warehouse(64, 64).free).copy()
    else:
        free = rng.random((48, 80)) > 0.3
    s = (16, 32)[seed % 2]
    pl = sector.SectorPlanner(free, s=s, device=device)
    flat = free.reshape(-1)
    eps_max, checked = 0.0, 0
    for t in range(trials):
        cells = np.flatnonzero(flat)
        st, gl = (int(c) for c in rng.choice(cells, 2, replace=False))
        fd = _bfs_dist(free, gl)
        eps_max = max(eps_max,
                      _check_descent(pl, free, gl, st, fd, (seed, t)))
        if fd[st] < int(sector.INF):
            checked += 1
        # corridor re-entry: an off-corridor free cell folds in exactly
        q = int(rng.choice(cells))
        if q != gl and pl.needs_reentry(gl, q):
            eps_max = max(eps_max, _check_descent(
                pl, free, gl, q, fd, (seed, t, "reenter")))
        # chained toggles: block a batch, verify repair == recompute,
        # re-plan exact on the repaired graph, then unblock and re-check
        batch = [int(c) for c in rng.choice(cells, 6, replace=False)
                 if c != gl and c != st][:4]
        for c in batch:
            flat[c] = False
        pl.apply_toggles(batch)
        assert pl.graph_state() == sector.SectorPlanner(
            free, s=s, device=device).graph_state(), (seed, t, "block")
        pl.forget(gl)
        eps_max = max(eps_max, _check_descent(
            pl, free, gl, st, _bfs_dist(free, gl), (seed, t, "post")))
        for c in batch:
            flat[c] = True
        pl.apply_toggles(batch)
        assert pl.graph_state() == sector.SectorPlanner(
            free, s=s, device=device).graph_state(), (seed, t, "unblock")
    return checked, eps_max


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_sector_fuzz: CUDA is not available; pass --cpu to "
                 "run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    t0 = time.perf_counter()
    total, eps_max = 0, 0.0
    for seed in range(args.seeds):
        n, e = fuzz_seed(seed, args.trials, device)
        total += n
        eps_max = max(eps_max, e)
    assert total >= args.seeds, \
        "too few reachable pairs exercised the corridor path"
    print(f"sector fuzz gate OK on {device}: {args.seeds} seeds x "
          f"{args.trials} "
          f"trials, {total} reachable pairs, eps_max={eps_max:.4f} "
          f"(bound {EPS}), repair==recompute on every toggle round, "
          f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
