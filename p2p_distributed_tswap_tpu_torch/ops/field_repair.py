"""Bounded-region incremental repair of BFS distance fields.

Counterpart of the JAX package's ``ops/field_repair.py``, with the same
results (the numpy and heapq parts are the same code).  Dynamic worlds
toggle obstacle cells mid-run; recomputing a whole direction field per
toggle costs a full fixpoint resweep, when the set of cells whose distance
actually changed is usually a small neighborhood of the toggle.  This
module repairs a cached field EXACTLY — bit-identical to a full recompute
— by re-sweeping only a dirty window:

1. **Invalidation cascade** (host, D*-Lite-shaped): a newly blocked cell
   invalidates every cell whose EVERY shortest path routed through it.
   Processed as a bucket cascade in increasing old-distance order: cell
   ``x`` at level ``k`` becomes dirty iff all its level-``k-1``
   neighbors are dirty or untraversable (goal level 0 is only ever dirty
   when toggled directly).  Freed cells are dirty by definition (their
   value is unknown).  Cells NOT in the dirty set provably keep their
   old distance under pure obstacle-addition — they seed the repair.
2. **Windowed fixpoint**: the bbox of the dirty set plus a margin,
   clipped to the grid.  The seed is the old field with dirty cells at
   INF; the relaxation fixpoint over the window is exact.  Small
   windows (<= DIJKSTRA_MAX_CELLS — the localized-toggle common case)
   run a host multi-source Dijkstra.  Larger windows PAD to power-of-two
   sides (blocked INF padding — virtual cells, not grid cells) and run
   the same directional sweeps as ``ops.distance.distance_fields`` to an
   early fixpoint on the window only (``ops.distance.window_fixpoint``:
   the ``sweep_scan`` kernel on the card).  Every dirty cell's true
   shortest path re-enters the still-valid frontier inside the window,
   so the fixpoint is exact.
3. **Rim check**: obstacle REMOVAL can shorten paths arbitrarily far
   away (opening a door re-routes a whole wing), and those decreases
   must not be truncated at the window edge.  Any change on the
   window's outermost real ring proves the changed set leaked past the
   window: grow the margin and redo.  A window that reaches the
   threshold (by device, see :func:`default_max_window`) gives up and
   returns None — the caller falls back to a full resweep.

Direction codes only change where distances (or their neighbors') did,
so the caller patches the affected row band with :func:`directions_np`
(+ :func:`pack_rows_np` for the packed-nibble cache rows) instead of
re-deriving the whole field.
"""

from __future__ import annotations

import heapq
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch.ops.distance import (
    DIR_STAY,
    INF,
    PACKED_LANES,
    window_fixpoint,
)
from p2p_distributed_tswap_tpu_torch.solver.mapd import resolve_device

# fallback thresholds as fractions of the grid cell count: the dirty
# cascade gives up past MAX_DIRTY_FRAC (a change that big IS a full
# resweep) and the window sweep past MAX_WINDOW_FRAC
MAX_DIRTY_FRAC = 8    # num_cells // 8
MAX_WINDOW_FRAC = 2   # num_cells // 2
_MARGIN0 = 2          # first window margin around the dirty bbox
_MARGIN_GROW = 4      # growth factor after a rim-check failure


def _pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def dirty_set(dist: np.ndarray, free: np.ndarray,
              cells: Iterable[int],
              max_dirty: Optional[int] = None) -> Optional[set]:
    """Cells whose distance may differ from ``dist`` after toggling
    ``cells`` to their CURRENT state in ``free``: the toggled cells plus
    the invalidation cascade of every newly blocked one.  None when the
    cascade exceeds ``max_dirty`` (caller falls back to full resweep)."""
    h, w = dist.shape
    n = h * w
    if max_dirty is None:
        max_dirty = max(64, n // MAX_DIRTY_FRAC)
    d = dist.reshape(-1)
    fr = free.reshape(-1)
    dirty: set = set()
    heap = []
    for c in {int(c) for c in cells}:
        if not 0 <= c < n:
            continue
        dirty.add(c)
        if not fr[c] and d[c] < INF:
            # newly blocked AND previously reachable: its loss can
            # orphan descendants — cascade from here.  Freed cells only
            # ever DECREASE neighbors; the window sweep handles that.
            heapq.heappush(heap, (int(d[c]), c))

    def neighbors(c: int):
        cy, cx = divmod(c, w)
        if cx + 1 < w:
            yield c + 1
        if cx:
            yield c - 1
        if cy + 1 < h:
            yield c + w
        if cy:
            yield c - w

    # Increasing-level pops mean: when a level-k cell is examined, the
    # dirty membership of every level-(k-1) cell is FINAL (level-k cells
    # are only ever discovered while popping level-(k-1) ones), so the
    # support check below is stable.
    while heap:
        if len(dirty) > max_dirty:
            return None
        k, c = heapq.heappop(heap)
        for nc in neighbors(c):
            if nc in dirty or not fr[nc]:
                continue
            dn = int(d[nc])
            if dn >= INF or dn != k + 1:
                continue
            supported = any(fr[y] and y not in dirty and int(d[y]) == dn - 1
                            for y in neighbors(nc))
            if not supported:
                dirty.add(nc)
                heapq.heappush(heap, (dn, nc))
    return dirty


# Windows up to this many cells run the host bucket-Dijkstra instead of
# the sweep fixpoint: a localized toggle's window is a few hundred cells,
# where the sweeps' launches and host syncs would dwarf the repair
# itself.  Bigger windows pad to pow2 sides and sweep on the device
# (``sweep_scan`` on the card).  Both paths compute the identical exact
# fixpoint.
DIJKSTRA_MAX_CELLS = 1 << 14


def default_max_window(num_cells: int, device) -> int:
    """Device-aware window ceiling, where the JAX package probes its
    backend: on the CPU a big window is not worth its sweeps against the
    full resweep it is meant to avoid, so windows past the Dijkstra regime
    fall back to a full recompute; on the card the pow2 window path stays
    in use up to half the grid."""
    cap = max(256, num_cells // MAX_WINDOW_FRAC)
    cpu = torch.device(device).type == "cpu"
    return min(cap, DIJKSTRA_MAX_CELLS) if cpu else cap


def _dijkstra(seed: np.ndarray, fw: np.ndarray) -> np.ndarray:
    """Exact relaxation fixpoint of one window by multi-source Dijkstra
    (unit edges): every finite seed is a source with its value as the
    initial bound — identical result to the sweep fixpoint, zero
    compile."""
    wh, ww = seed.shape
    dist = seed.copy()
    flat = dist.reshape(-1)
    ffree = fw.reshape(-1)
    heap = [(int(v), int(i)) for i, v in enumerate(flat)
            if v < INF and ffree[i]]
    heapq.heapify(heap)
    while heap:
        v, c = heapq.heappop(heap)
        if v > flat[c]:
            continue
        cy, cx = divmod(c, ww)
        for nc in ((c + 1 if cx + 1 < ww else -1),
                   (c - 1 if cx else -1),
                   (c + ww if cy + 1 < wh else -1),
                   (c - ww if cy else -1)):
            if nc >= 0 and ffree[nc] and flat[nc] > v + 1:
                flat[nc] = v + 1
                heapq.heappush(heap, (v + 1, nc))
    return dist


def _sweep_window(dist: np.ndarray, free: np.ndarray, dirty: set,
                  y0: int, y1: int, x0: int, x1: int,
                  device: torch.device) -> np.ndarray:
    """One windowed fixpoint: returns the (y1-y0, x1-x0) repaired
    values.  Small windows run the host Dijkstra; larger ones pad to
    pow2 sides with blocked INF cells (virtual padding, never grid
    cells) and run the sweep fixpoint on ``device``
    (``ops.distance.window_fixpoint``: ``sweep_scan`` on the card)."""
    bh, bw = y1 - y0, x1 - x0
    w = dist.shape[1]
    if bh * bw <= DIJKSTRA_MAX_CELLS:
        seed = dist[y0:y1, x0:x1].copy()
        fw = free[y0:y1, x0:x1]
        for c in dirty:
            cy, cx = divmod(c, w)
            if y0 <= cy < y1 and x0 <= cx < x1:
                seed[cy - y0, cx - x0] = INF
        seed[~fw] = INF
        return _dijkstra(seed, fw)
    wh, ww = _pow2(bh), _pow2(bw)
    seed = np.full((wh, ww), INF, np.int32)
    seed[:bh, :bw] = dist[y0:y1, x0:x1]
    fw = np.zeros((wh, ww), bool)
    fw[:bh, :bw] = free[y0:y1, x0:x1]
    for c in dirty:
        cy, cx = divmod(c, w)
        if y0 <= cy < y1 and x0 <= cx < x1:
            seed[cy - y0, cx - x0] = INF
    seed[~fw] = INF
    out = window_fixpoint(torch.from_numpy(seed[None]).to(device),
                          torch.from_numpy(fw).to(device))
    return out.cpu().numpy()[0, :bh, :bw]


def _cluster_cells(cells: set, w: int, tile: int = 32) -> list:
    """Partition dirty cells into spatial clusters: connected components
    of the coarse ``tile``-sized buckets they occupy (chebyshev
    adjacency), so far-apart toggle groups repair in separate windows."""
    from collections import defaultdict, deque

    tiles = defaultdict(set)
    for c in cells:
        tiles[((c // w) // tile, (c % w) // tile)].add(c)
    out = []
    seen = set()
    for t0 in tiles:
        if t0 in seen:
            continue
        comp: set = set()
        dq = deque([t0])
        seen.add(t0)
        while dq:
            ty, tx = dq.popleft()
            comp |= tiles[(ty, tx)]
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    nb = (ty + dy, tx + dx)
                    if nb in tiles and nb not in seen:
                        seen.add(nb)
                        dq.append(nb)
        out.append(comp)
    return out


def repair_field(dist: np.ndarray, free: np.ndarray,
                 toggles: Iterable[int],
                 max_dirty: Optional[int] = None,
                 max_window: Optional[int] = None,
                 device=None
                 ) -> Optional[Tuple[np.ndarray, Tuple[int, int, int, int]]]:
    """Exact post-toggle distance field from the pre-toggle field.

    Args:
      dist: (H, W) int32 — the EXACT field for the pre-toggle mask.
      free: (H, W) bool — the CURRENT (post-toggle) mask.
      toggles: flat cell indices whose traversability changed since
        ``dist`` was computed (batched updates fold into one repair; a
        cell toggled back to its old state is harmless).
      max_dirty / max_window: fallback thresholds (cells); defaults
        num_cells // 8 and, by ``device``, num_cells // 2 (see
        :func:`default_max_window`).
      device: where big windows sweep; ``cuda`` unless the caller names
        another (without CUDA it raises).

    Returns:
      ``(new_dist, (y0, y1, x0, x1))`` — the repaired full-grid field
      and the half-open row/col box outside which nothing changed (the
      caller re-derives direction codes for that band only) — or None
      when the dirty region overflowed the thresholds and a full
      resweep is the cheaper exact answer.
    """
    h, w = dist.shape
    n = h * w
    device = resolve_device(device)
    if max_window is None:
        max_window = default_max_window(n, device)
    dirty = dirty_set(dist, free, toggles, max_dirty=max_dirty)
    if dirty is None:
        return None
    if not dirty:
        return dist.copy(), (0, 0, 0, 0)
    # A batch can carry SEVERAL spatially separate toggle groups (a
    # sliding wall reopens far from where it closes): one bbox over all
    # of them would span most of the grid.  Cluster the dirty set and
    # repair each cluster in its OWN window, sequentially on the running
    # field — exactly the batch chaining the property tests cover.  A
    # window that grows into another cluster's territory merges with it
    # and redoes (interacting change regions must share one window).
    clusters = _cluster_cells(dirty, w)
    running = dist.copy()
    boxes = []
    while clusters:
        cl = clusters.pop()
        ys = [c // w for c in cl]
        xs = [c % w for c in cl]
        margin = _MARGIN0
        done = False
        while not done:
            y0 = max(0, min(ys) - margin)
            y1 = min(h, max(ys) + 1 + margin)
            x0 = max(0, min(xs) - margin)
            x1 = min(w, max(xs) + 1 + margin)
            merged = False
            for j in range(len(clusters) - 1, -1, -1):
                other = clusters[j]
                if any(y0 <= c // w < y1 and x0 <= c % w < x1
                       for c in other):
                    cl |= clusters.pop(j)
                    ys = [c // w for c in cl]
                    xs = [c % w for c in cl]
                    merged = True
            if merged:
                continue  # same margin, fresh bbox over the merged set
            full_span = (y0 == 0 and y1 == h and x0 == 0 and x1 == w)
            if (y1 - y0) * (x1 - x0) > max_window:
                # even a full-span window respects the ceiling: past it
                # the caller's full resweep does the same work on an
                # ALREADY-COMPILED program (the CPU cap exists exactly
                # to avoid a one-off big-window compile)
                return None
            out_w = _sweep_window(running, free, cl, y0, y1, x0, x1,
                                  device)
            if full_span:
                running[y0:y1, x0:x1] = out_w
                boxes.append((y0, y1, x0, x1))
                break
            # rim check: a change on the window's outermost REAL ring
            # (grid edges excluded — nothing propagates past the world
            # boundary) means the changed set leaked out; grow and redo
            # from the pristine seed
            leaked = False
            if y0 > 0:
                leaked |= bool((out_w[0] != running[y0, x0:x1]).any())
            if y1 < h:
                leaked |= bool(
                    (out_w[-1] != running[y1 - 1, x0:x1]).any())
            if x0 > 0:
                leaked |= bool((out_w[:, 0] != running[y0:y1, x0]).any())
            if x1 < w:
                leaked |= bool(
                    (out_w[:, -1] != running[y0:y1, x1 - 1]).any())
            if leaked:
                margin *= _MARGIN_GROW
                continue
            running[y0:y1, x0:x1] = out_w
            boxes.append((y0, y1, x0, x1))
            done = True
    y0 = min(b[0] for b in boxes)
    y1 = max(b[1] for b in boxes)
    x0 = min(b[2] for b in boxes)
    x1 = max(b[3] for b in boxes)
    return running, (y0, y1, x0, x1)


def directions_np(dist: np.ndarray, free: np.ndarray,
                  y0: int = 0, y1: Optional[int] = None) -> np.ndarray:
    """Next-hop direction codes for rows ``[y0, y1)`` — the numpy twin
    of ops.distance.directions_from_distance (same DIR_DXDY fold, same
    first-min strict tie-break), band-scoped so a repair only re-derives
    the rows whose distances (or row neighbors') changed."""
    h, w = dist.shape
    y1 = h if y1 is None else y1
    lo = y0 - 1  # local padded array covers the band plus a 1-cell halo
    pb = np.full((y1 - y0 + 2, w + 2), INF, np.int32)
    gy0, gy1 = max(0, lo), min(h, y1 + 1)
    pb[gy0 - lo:gy1 - lo, 1:-1] = dist[gy0:gy1]
    band = y1 - y0
    cur = pb[1:1 + band, 1:-1]
    down = pb[2:2 + band, 1:-1]       # (dx, dy) = (0, 1)
    right = pb[1:1 + band, 2:]        # (1, 0)
    up = pb[0:band, 1:-1]             # (0, -1)
    left = pb[1:1 + band, 0:-2]       # (-1, 0)
    best = np.full((band, w), DIR_STAY, np.uint8)
    best_val = np.full((band, w), INF, np.int32)
    for k, nv in enumerate((down, right, up, left)):
        better = nv < best_val
        best[better] = k
        best_val = np.minimum(best_val, nv)
    stay = ((cur == 0) | (cur >= INF) | (best_val >= INF)
            | (best_val >= cur) | ~free[y0:y1])
    return np.where(stay, np.uint8(DIR_STAY), best)


def pack_rows_np(fields: np.ndarray) -> np.ndarray:
    """numpy mirror of ops.distance.pack_directions: (..., HW) uint8
    codes -> (..., ceil(HW/8)) uint32 nibble words, as the JAX package
    stores them (the device rows are int32 with the same bits; trailing
    cells pad with DIR_STAY) — so a repaired host mirror repacks without a
    device round-trip."""
    hw = fields.shape[-1]
    pad = -hw % PACKED_LANES
    if pad:
        fields = np.concatenate(
            [fields, np.full(fields.shape[:-1] + (pad,), DIR_STAY,
                             fields.dtype)], axis=-1)
    lanes = fields.reshape(*fields.shape[:-1], -1,
                           PACKED_LANES).astype(np.uint32)
    word = lanes[..., 0]
    for lane in range(1, PACKED_LANES):
        word = word | (lanes[..., lane] << np.uint32(4 * lane))
    return word
