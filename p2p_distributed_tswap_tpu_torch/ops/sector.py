"""Hierarchical sector-graph planning.

Counterpart of the JAX package's ``ops/sector.py``, with the same results.
A full direction-field sweep costs O(world area), which makes every FRESH
goal a full-grid sweep even where bounded-region repair (``field_repair``)
rescues localized world edits.  This module bounds fresh-goal cost by
SECTOR area instead, HPA*-style (Botea et al. 2004), while preserving
TSWAP's field-descent contract exactly:

1. **Partition** the grid into S×S sectors (``JG_SECTOR_CELLS``,
   default 64; edge sectors clip to the grid, so any H×W works).
2. **Portal graph** (precomputed, incrementally repaired): along every
   sector border, maximal runs of cell pairs free on BOTH sides each
   contribute one portal at the run midpoint — two portal cells, one
   per sector, crossing cost 1.  Portal↔portal distances WITHIN a
   sector come from batched local BFS sweeps over the sector window
   (scipy's C BFS on the host path; on the jit path, the default on the
   card, the pow2-padded batched window fixpoint
   ``ops.distance.window_fixpoint`` with one mask per window, which is
   the ``sweep_scan`` kernel there).  A world
   toggle rebuilds only the touched sector's borders and the intra
   tables of it and its neighbors — never the whole graph.
3. **Coarse route** per fresh goal: Dijkstra over the portal graph
   from the goal (plus a local solve in the goal's and each start's
   sector to attach non-portal cells).  The *corridor* is the union of
   sectors on the best route per start, plus both endpoint sectors.
4. **Corridor field**: an exact BFS distance fixpoint restricted to
   the corridor (stitched per-sector windows relaxing in lockstep with
   halo exchange — O(corridor area) work; the jit path sweeps the
   windows as one batch with per-window masks), then direction codes via
   the same first-min tie-break as the full path
   (field_repair.directions_np) packed into a full-width row that is
   PACKED_STAY outside the corridor band.  Within the corridor the
   field strictly descends, so TSWAP's wait/swap/rotate semantics are
   untouched; a lane OUTSIDE the corridor reads STAY and the serving
   layer (runtime/solverd.py) extends the corridor from its cell
   (re-entry) instead of sweeping the world.

Suboptimality: the corridor field is EXACT within the corridor, so a
path is longer than the full-field path only when the true shortest
path leaves the chosen sectors.  The JAX package's fuzz gate and tests
measure ε = corridor_dist/full_dist - 1 on seeded random worlds and
enforce the committed bound of 0.05; the port's tests hold every plan to
the JAX planner's.  When the corridor covers the whole grid the packed
row is bit-identical to the full sweep's.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch.ops import field_repair
from p2p_distributed_tswap_tpu_torch.ops.distance import (
    DIR_STAY,
    INF,
    PACKED_LANES,
    PACKED_STAY,
    packed_cells,
    window_fixpoint,
)
from p2p_distributed_tswap_tpu_torch.device import resolve_device

SECTOR_ENV = "JG_SECTOR"
SECTOR_CELLS_ENV = "JG_SECTOR_CELLS"
SECTOR_JIT_ENV = "JG_SECTOR_JIT"
DEFAULT_SECTOR_CELLS = 64
# starts folded into one plan (re-entry extends past the cap lazily)
MAX_PLAN_STARTS = 16
# portal-window layers per solver batch during (re)builds: big enough to
# amortize per-round python cost across sectors, small enough to keep the
# working set (~d + masks + scan offsets) in tens of MB
REBUILD_CHUNK = 512


def sector_enabled() -> bool:
    """JG_SECTOR=1 opt-in; unset/0 keeps the serving path byte-identical
    (the planner is then never constructed — see PlanService)."""
    return os.environ.get(SECTOR_ENV, "") not in ("", "0", "false")


def sector_cells() -> int:
    try:
        s = int(os.environ.get(SECTOR_CELLS_ENV, DEFAULT_SECTOR_CELLS))
    except ValueError:
        s = DEFAULT_SECTOR_CELLS
    return max(8, s)


def _use_jit_default(device: torch.device) -> bool:
    """``JG_SECTOR_JIT`` when set, else the device's own path: the batched
    window sweeps on the card, scipy's host BFS on the CPU (where the JAX
    package probes its backend).  The name is the JAX package's."""
    env = os.environ.get(SECTOR_JIT_ENV, "")
    if env in ("0", "1"):
        return env == "1"
    return device.type == "cuda"


class GoalPlan:
    """One goal's corridor plan: the packed full-width direction row
    (host copy — nibble reads answer corridor-membership without a
    device sync), the corridor sector set, and the cached goal-side
    routing tables reused by start attachment and re-entry."""

    __slots__ = ("goal", "starts", "sectors", "packed", "cells", "band",
                 "epoch", "tables", "dist")

    def __init__(self, goal: int, starts: Set[int], sectors: Set[int],
                 packed: np.ndarray, cells: int, band: Tuple[int, int],
                 epoch: int, tables, dist: Optional[np.ndarray]):
        self.goal = goal
        self.starts = starts
        self.sectors = sectors
        self.packed = packed
        self.cells = cells
        self.band = band
        self.epoch = epoch
        self.tables = tables
        self.dist = dist


class _GoalTables:
    """Goal-side routing state: per-node distances/predecessors from
    one portal-graph Dijkstra plus the goal sector's local window
    (attaches same-sector starts)."""

    __slots__ = ("gdist", "parent", "gwin", "gbounds", "node_cells")

    def __init__(self, gdist, parent, gwin, gbounds, node_cells):
        self.gdist = gdist
        self.parent = parent
        self.gwin = gwin
        self.gbounds = gbounds
        self.node_cells = node_cells


class SectorPlanner:
    """Portal graph + corridor planner over a live obstacle mask.

    ``free`` is held BY REFERENCE: the owner (PlanService) mutates it in
    place on world toggles and then calls :meth:`apply_toggles` with the
    changed cells, mirroring the dist-mirror contract of field_repair.
    Standalone users (tests) can use :meth:`toggle`.  The jit path's window
    sweeps run on ``device`` (``cuda`` unless the caller names another).
    """

    def __init__(self, free: np.ndarray, s: Optional[int] = None,
                 use_jit: Optional[bool] = None, device=None):
        self.free = free
        self.h, self.w = free.shape
        self.s = s if s is not None else sector_cells()
        self.device = resolve_device(device)
        self.use_jit = (_use_jit_default(self.device) if use_jit is None
                        else use_jit)
        self.sy = -(-self.h // self.s)
        self.sx = -(-self.w // self.s)
        self.epoch = 0
        pc = packed_cells(self.h * self.w)
        self._stay_row = np.full(pc, PACKED_STAY, np.uint32)
        # border id -> [(cell_a, cell_b)]; 'h' borders separate (si,sj)
        # from (si,sj+1), 'v' borders (si,sj) from (si+1,sj)
        self.border_portals: Dict[tuple, List[Tuple[int, int]]] = {}
        self.portals: Dict[int, np.ndarray] = {}   # sid -> sorted cells
        self.intra: Dict[int, np.ndarray] = {}     # sid -> (P, P) i32
        self.cross: Dict[int, Set[int]] = {}
        self.plans: Dict[int, GoalPlan] = {}
        self._csr_epoch = -1
        self._csr = None
        self._adj: Dict[int, object] = {}  # sid -> sector 4-adjacency CSR
        t0 = time.perf_counter()
        for bid in self._all_borders():
            self._set_border(bid, self._scan_border(bid))
        self._rebuild_sectors(range(self.sy * self.sx))
        self.build_ms = 1000.0 * (time.perf_counter() - t0)
        self.last_plan_ms = 0.0

    # -- geometry ---------------------------------------------------------
    def sector_of(self, cell: int) -> int:
        cy, cx = divmod(int(cell), self.w)
        return (cy // self.s) * self.sx + (cx // self.s)

    def _bounds(self, sid: int) -> Tuple[int, int, int, int]:
        si, sj = divmod(sid, self.sx)
        return (si * self.s, min(self.h, (si + 1) * self.s),
                sj * self.s, min(self.w, (sj + 1) * self.s))

    def _neighbors(self, sid: int) -> List[int]:
        si, sj = divmod(sid, self.sx)
        out = []
        if sj + 1 < self.sx:
            out.append(sid + 1)
        if sj:
            out.append(sid - 1)
        if si + 1 < self.sy:
            out.append(sid + self.sx)
        if si:
            out.append(sid - self.sx)
        return out

    def _all_borders(self) -> List[tuple]:
        out = []
        for si in range(self.sy):
            for sj in range(self.sx - 1):
                out.append(("h", si, sj))
        for si in range(self.sy - 1):
            for sj in range(self.sx):
                out.append(("v", si, sj))
        return out

    def _sector_borders(self, sid: int) -> List[tuple]:
        si, sj = divmod(sid, self.sx)
        out = []
        if sj + 1 < self.sx:
            out.append(("h", si, sj))
        if sj:
            out.append(("h", si, sj - 1))
        if si + 1 < self.sy:
            out.append(("v", si, sj))
        if si:
            out.append(("v", si - 1, sj))
        return out

    # -- portal graph construction ----------------------------------------
    def _scan_border(self, bid: tuple) -> List[Tuple[int, int]]:
        """Maximal free runs along one border; one portal pair at each
        run's midpoint.  A run straddled by a wall on EITHER side splits
        — both columns must be free for a crossing."""
        kind, si, sj = bid
        if kind == "h":
            xa = (sj + 1) * self.s - 1
            xb = xa + 1
            y0, y1 = si * self.s, min(self.h, (si + 1) * self.s)
            ok = self.free[y0:y1, xa] & self.free[y0:y1, xb]
            span = lambda m: ((y0 + m) * self.w + xa,
                              (y0 + m) * self.w + xb)
        else:
            ya = (si + 1) * self.s - 1
            yb = ya + 1
            x0, x1 = sj * self.s, min(self.w, (sj + 1) * self.s)
            ok = self.free[ya, x0:x1] & self.free[yb, x0:x1]
            span = lambda m: (ya * self.w + x0 + m,
                              yb * self.w + x0 + m)
        pairs = []
        run0 = None
        for i, v in enumerate(np.append(ok, False)):
            if v and run0 is None:
                run0 = i
            elif not v and run0 is not None:
                pairs.append(span((run0 + i - 1) // 2))
                run0 = None
        return pairs

    def _set_border(self, bid: tuple, pairs: List[Tuple[int, int]]) -> None:
        for a, b in self.border_portals.get(bid, ()):
            for u, v in ((a, b), (b, a)):
                s = self.cross.get(u)
                if s is not None:
                    s.discard(v)
                    if not s:
                        del self.cross[u]
        self.border_portals[bid] = pairs
        for a, b in pairs:
            self.cross.setdefault(a, set()).add(b)
            self.cross.setdefault(b, set()).add(a)

    def _rebuild_sector(self, sid: int) -> None:
        self._rebuild_sectors([sid])

    def _rebuild_sectors(self, sids: Iterable[int],
                         force: Optional[Set[int]] = None) -> None:
        """Recompute portal cell sets (from the four borders) and the
        (P, P) intra-sector portal↔portal distance matrices for
        ``sids``.  ``force`` marks the sectors whose FREE MASK changed;
        the rest ride along only because a shared border may have moved
        their portals — when their portal set comes back unchanged,
        their intra table is still exact and the solve is skipped.
        Host path: one multi-source C BFS per sector over its cached
        4-adjacency graph — no windows materialize at all.  Jit path:
        every portal cell contributes one local BFS window layer,
        batched across SECTORS in fixed-size chunks so the solver cost
        amortizes over the whole rebuild."""
        sids = list(sids)
        if force is None:
            force = set(sids)
        jobs: List[Tuple[int, np.ndarray]] = []
        for sid in sids:
            if sid in force:
                self._adj.pop(sid, None)  # free mask changed
            y0, y1, x0, x1 = self._bounds(sid)
            cells: Set[int] = set()
            for bid in self._sector_borders(sid):
                for a, b in self.border_portals[bid]:
                    for c in (a, b):
                        cy, cx = divmod(c, self.w)
                        if y0 <= cy < y1 and x0 <= cx < x1:
                            cells.add(c)
            ps = np.asarray(sorted(cells), np.int64)
            old = self.portals.get(sid)
            if sid not in force and old is not None \
                    and np.array_equal(old, ps):
                continue
            self.portals[sid] = ps
            if ps.size:
                jobs.append((sid, ps))
            else:
                self.intra[sid] = np.zeros((0, 0), np.int32)
        if not self.use_jit:
            from scipy.sparse.csgraph import dijkstra
            for sid, ps in jobs:
                y0, y1, x0, x1 = self._bounds(sid)
                ww = x1 - x0
                loc = (ps // self.w - y0) * ww + (ps % self.w - x0)
                dij = dijkstra(self._sector_graph(sid), unweighted=True,
                               indices=loc, min_only=False)[:, loc]
                dij[np.isinf(dij)] = float(INF)
                # (P, P): [i, j] = d(ps_i, ps_j), rows in portal order
                self.intra[sid] = dij.astype(np.int32)
            return
        flat = [(sid, int(p)) for sid, ps in jobs for p in ps]
        rows: Dict[int, List[np.ndarray]] = {sid: [] for sid, _ in jobs}
        masks: Dict[int, np.ndarray] = {}
        locs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for sid, ps in jobs:
            y0, _, x0, _ = self._bounds(sid)
            locs[sid] = (1 + ps // self.w - y0, 1 + ps % self.w - x0)
        chunk = max(64, REBUILD_CHUNK)
        for lo in range(0, len(flat), chunk):
            part = flat[lo:lo + chunk]
            n = len(part)
            d = np.full((n, self.s + 2, self.s + 2), INF, np.int32)
            m = np.zeros((n, self.s + 2, self.s + 2), bool)
            for k, (sid, p) in enumerate(part):
                mw = masks.get(sid)
                if mw is None:
                    mw = masks[sid] = self._window_mask(sid)
                m[k] = mw
                y0, _, x0, _ = self._bounds(sid)
                ly, lx = 1 + p // self.w - y0, 1 + p % self.w - x0
                if mw[ly, lx]:
                    d[k, ly, lx] = 0
            self._fixpoint(d, m)
            for k, (sid, _p) in enumerate(part):
                lys, lxs = locs[sid]
                rows[sid].append(d[k, lys, lxs])
        for sid, ps in jobs:
            # (P, P): [i, j] = d(ps_i, ps_j), rows in portal order
            self.intra[sid] = np.stack(rows[sid])

    def graph_state(self) -> tuple:
        """Normalized portal-graph snapshot — the invalidation tests
        compare this against a freshly built planner's."""
        return (
            {k: tuple(v) for k, v in self.border_portals.items()},
            {k: tuple(int(c) for c in v) for k, v in self.portals.items()},
            {k: v.tobytes() for k, v in self.intra.items()},
            {k: frozenset(v) for k, v in self.cross.items()},
        )

    # -- local fixpoints --------------------------------------------------
    def _sector_graph(self, sid: int):
        """The sector's 4-adjacency CSR over its own cells (row-major
        node ids within the sector rect; blocked cells are isolated
        nodes), cached until the sector rebuilds.  Feeds scipy's C BFS
        for intra tables, local single-source solves, and indirectly
        the corridor solve on the host path."""
        g = self._adj.get(sid)
        if g is None:
            y0, y1, x0, x1 = self._bounds(sid)
            g = self._adj[sid] = _grid_graph(self.free[y0:y1, x0:x1])
        return g

    def _local_window(self, sid: int, cell: int) -> np.ndarray:
        """(s+2, s+2) sector-restricted BFS distance window from
        ``cell`` (halo ring INF, layout shared with the jit windows) —
        scipy C BFS on the host path, the batched window fixpoint on
        the jit path.  A blocked source yields an all-INF window,
        matching the window solver's unseedable-cell behavior."""
        if self.use_jit:
            return self._fixpoint_batch(sid, [{int(cell): 0}])[0]
        from scipy.sparse.csgraph import dijkstra
        y0, y1, x0, x1 = self._bounds(sid)
        hh, ww = y1 - y0, x1 - x0
        win = np.full((self.s + 2, self.s + 2), INF, np.int32)
        ly, lx = cell // self.w - y0, cell % self.w - x0
        if not self.free[y0 + ly, x0 + lx]:
            return win
        dij = dijkstra(self._sector_graph(sid), unweighted=True,
                       indices=ly * ww + lx)
        dij[np.isinf(dij)] = float(INF)
        win[1:1 + hh, 1:1 + ww] = dij.reshape(hh, ww).astype(np.int32)
        return win

    def _window_mask(self, sid: int) -> np.ndarray:
        """(s+2, s+2) traversability window: sector interior at [1:1+h,
        1:1+w], halo ring blocked (intra-sector distances never leave
        the sector)."""
        y0, y1, x0, x1 = self._bounds(sid)
        m = np.zeros((self.s + 2, self.s + 2), bool)
        m[1:1 + y1 - y0, 1:1 + x1 - x0] = self.free[y0:y1, x0:x1]
        return m

    def _fixpoint_batch(self, sid: int, seed_list: List[Dict[int, int]]
                        ) -> np.ndarray:
        """Batched exact BFS fixpoint over one sector window: one
        (s+2, s+2) layer per seed dict (flat-cell -> value)."""
        y0, _y1, x0, _x1 = self._bounds(sid)
        m = self._window_mask(sid)
        d = np.full((len(seed_list),) + m.shape, INF, np.int32)
        for k, seeds in enumerate(seed_list):
            for c, v in seeds.items():
                ly, lx = 1 + c // self.w - y0, 1 + c % self.w - x0
                if m[ly, lx]:
                    d[k, ly, lx] = v
        self._fixpoint(d, m)
        return d

    def _window_fixpoint(self, seed: np.ndarray, fw: np.ndarray
                         ) -> np.ndarray:
        """The batched window fixpoint on the planner's device, one
        (h2, w2) mask per window (``sweep_scan`` with per-field masks on
        the card, its plain version on the CPU)."""
        dev = self.device
        return window_fixpoint(torch.from_numpy(seed).to(dev),
                               torch.from_numpy(fw).to(dev)).cpu().numpy()

    def _fixpoint(self, d: np.ndarray, m: np.ndarray) -> None:
        """Relax ``d`` (batch, hh, ww) to the exact BFS fixpoint in
        place.  Host path: numpy fast-sweep rounds (4 directional passes
        each).  Jit path (the card / JG_SECTOR_JIT=1): the pow2-padded
        batched window fixpoint shared with field repair."""
        if self.use_jit:
            n, hh, ww = d.shape
            n2 = max(1, 1 << (n - 1).bit_length())
            h2, w2 = field_repair._pow2(hh), field_repair._pow2(ww)
            seed = np.full((n2, h2, w2), INF, np.int32)
            seed[:n, :hh, :ww] = d
            fw = np.zeros((n2, h2, w2), bool)
            fw[:n, :hh, :ww] = np.broadcast_to(m, d.shape)
            out = self._window_fixpoint(seed, fw)
            d[...] = out[:n, :hh, :ww]
            return
        dt = np.ascontiguousarray(np.moveaxis(d, 0, -1))
        mt = (m[:, :, None] if m.ndim == 2
              else np.ascontiguousarray(np.moveaxis(m, 0, -1)))
        off = _sweep_offsets(mt)
        while True:
            prev = dt.copy()
            _relax_round(dt, mt, off)
            if np.array_equal(dt, prev):
                break
        d[...] = np.moveaxis(dt, -1, 0)

    # -- corridor field ---------------------------------------------------
    def _corridor_field(self, sids: List[int], goal: int,
                        seeds: Optional[Dict[int, int]] = None,
                        gwin: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Exact BFS distance from ``goal`` restricted to the corridor
        ``sids``: per-sector windows relax in lockstep, exchanging halo
        values with corridor neighbors each round — O(corridor area)
        work regardless of world size.  ``seeds`` (cell -> value) must
        be upper bounds of the corridor-restricted distance (the
        monotone relaxation then still converges to the exact fixpoint
        — uniqueness of the Bellman fixpoint — just in far fewer
        rounds).  Returns the full-grid (H, W) field (INF outside the
        corridor) plus the corridor's row band."""
        s = self.s
        n = len(sids)
        pos = {sid: k for k, sid in enumerate(sids)}
        bounds = [self._bounds(sid) for sid in sids]
        band = (min(b[0] for b in bounds), max(b[1] for b in bounds))
        if not self.use_jit:
            # host path: one C BFS over the corridor's masked bounding
            # box.  Sector rects only admit edges inside the region, so
            # this is exactly the halo-stitched window solve.
            from scipy.sparse.csgraph import dijkstra
            by0, by1 = band
            bx0 = min(b[2] for b in bounds)
            bx1 = max(b[3] for b in bounds)
            bh, bw = by1 - by0, bx1 - bx0
            region = np.zeros((bh, bw), bool)
            for y0, y1, x0, x1 in bounds:
                region[y0 - by0:y1 - by0, x0 - bx0:x1 - bx0] = True
            sub = region & self.free[by0:by1, bx0:bx1]
            gy, gx = divmod(goal, self.w)
            dist = np.full((self.h, self.w), INF, np.int32)
            if sub[gy - by0, gx - bx0]:
                dij = dijkstra(_grid_graph(sub), unweighted=True,
                               indices=(gy - by0) * bw + (gx - bx0))
                dij[np.isinf(dij)] = float(INF)
                block = dij.reshape(bh, bw).astype(np.int32)
                for y0, y1, x0, x1 in bounds:
                    dist[y0:y1, x0:x1] = block[y0 - by0:y1 - by0,
                                               x0 - bx0:x1 - bx0]
            return dist, band
        # jit path: per-sector windows relax in lockstep on the shared
        # window fixpoint, exchanging halos each round.
        # batch-LAST (s+2, s+2, n): every sweep row op touches
        # contiguous memory, which is what makes long corridors cheap
        d = np.full((s + 2, s + 2, n), INF, np.int32)
        m = np.zeros((s + 2, s + 2, n), bool)
        for k, (y0, y1, x0, x1) in enumerate(bounds):
            m[1:1 + y1 - y0, 1:1 + x1 - x0, k] = self.free[y0:y1, x0:x1]
        ra, rb, da_, db = [], [], [], []
        for sid in sids:
            si, sj = divmod(sid, self.sx)
            if sj + 1 < self.sx and sid + 1 in pos:
                ra.append(pos[sid])
                rb.append(pos[sid + 1])
            if si + 1 < self.sy and sid + self.sx in pos:
                da_.append(pos[sid])
                db.append(pos[sid + self.sx])
        ra, rb = np.asarray(ra, int), np.asarray(rb, int)
        da_, db = np.asarray(da_, int), np.asarray(db, int)
        if ra.size:  # halo traversability mirrors the neighbor's edge
            m[1:s + 1, s + 1, ra] = m[1:s + 1, 1, rb]
            m[1:s + 1, 0, rb] = m[1:s + 1, s, ra]
        if da_.size:
            m[s + 1, 1:s + 1, da_] = m[1, 1:s + 1, db]
            m[0, 1:s + 1, db] = m[s, 1:s + 1, da_]
        gy, gx = divmod(goal, self.w)
        k = pos[self.sector_of(goal)]
        y0, _, x0, _ = bounds[k]
        if gwin is not None:
            # the goal-sector-restricted solve is an upper bound of the
            # corridor-restricted field everywhere in the goal sector
            d[:, :, k] = np.minimum(d[:, :, k], gwin)
        if m[1 + gy - y0, 1 + gx - x0, k]:
            d[1 + gy - y0, 1 + gx - x0, k] = 0
        if seeds:
            for c, v in seeds.items():
                kk = pos.get(self.sector_of(c))
                if kk is None:
                    continue
                y0, _, x0, _ = bounds[kk]
                ly, lx = 1 + c // self.w - y0, 1 + c % self.w - x0
                if m[ly, lx, kk] and v < d[ly, lx, kk]:
                    d[ly, lx, kk] = v
        off = None if self.use_jit else _sweep_offsets(m)
        while True:
            prev = d.copy()
            if ra.size:
                d[1:s + 1, s + 1, ra] = d[1:s + 1, 1, rb]
                d[1:s + 1, 0, rb] = d[1:s + 1, s, ra]
            if da_.size:
                d[s + 1, 1:s + 1, da_] = d[1, 1:s + 1, db]
                d[0, 1:s + 1, db] = d[s, 1:s + 1, da_]
            if self.use_jit:
                self._fixpoint_corr(d, m)
            else:
                _relax_round(d, m, off)
            if np.array_equal(d, prev):
                break
        dist = np.full((self.h, self.w), INF, np.int32)
        for k, (y0, y1, x0, x1) in enumerate(bounds):
            dist[y0:y1, x0:x1] = d[1:1 + y1 - y0, 1:1 + x1 - x0, k]
        return dist, band

    def _fixpoint_corr(self, d: np.ndarray, m: np.ndarray) -> None:
        """Jit-path inner solve for the corridor loop: batch-last
        (hh, ww, n) operands re-layout to the pow2-padded batch-first
        shape the shared window fixpoint expects."""
        hh, ww, n = d.shape
        n2 = max(1, 1 << (n - 1).bit_length())
        h2, w2 = field_repair._pow2(hh), field_repair._pow2(ww)
        seed = np.full((n2, h2, w2), INF, np.int32)
        seed[:n, :hh, :ww] = np.moveaxis(d, -1, 0)
        fw = np.zeros((n2, h2, w2), bool)
        fw[:n, :hh, :ww] = np.moveaxis(m, -1, 0)
        out = self._window_fixpoint(seed, fw)
        d[...] = np.moveaxis(out[:n, :hh, :ww], 0, -1)

    # -- routing ----------------------------------------------------------
    def _graph_csr(self):
        """Portal graph as one CSR matrix, rebuilt lazily per epoch:
        N portal-cell nodes (intra edges from the per-sector distance
        matrices, crossings weight 1) plus ONE virtual node (row N)
        pre-wired to every portal cell.  Per goal only the virtual
        row's WEIGHTS change (goal-side local distances; inf = absent),
        so the sparsity structure — and scipy's CSR validation — is
        paid once per world epoch, not per goal."""
        if self._csr_epoch == self.epoch:
            return self._csr
        from scipy.sparse import csr_matrix
        parts = [p for p in self.portals.values() if p.size]
        node_cells = (np.unique(np.concatenate(parts)) if parts
                      else np.zeros(0, np.int64))
        n = node_cells.size
        rows, cols, data = [], [], []
        for sid, ps in self.portals.items():
            if ps.size < 2:
                continue
            idx = np.searchsorted(node_cells, ps)
            mat = self.intra[sid]
            r, c = np.nonzero((mat < INF)
                              & ~np.eye(ps.size, dtype=bool))
            rows.append(idx[r])
            cols.append(idx[c])
            data.append(mat[r, c].astype(np.float64))
        cr, cc = [], []
        for a, partners in self.cross.items():
            for b in partners:
                cr.append(a)
                cc.append(b)
        if cr:
            rows.append(np.searchsorted(node_cells, np.asarray(cr)))
            cols.append(np.searchsorted(node_cells, np.asarray(cc)))
            data.append(np.ones(len(cr), np.float64))
        # virtual goal row: one slot per portal cell, weights set per goal
        rows.append(np.full(n, n, np.int64))
        cols.append(np.arange(n, dtype=np.int64))
        data.append(np.full(n, np.inf, np.float64))
        g = csr_matrix(
            (np.concatenate(data) if data else np.zeros(0),
             (np.concatenate(rows) if rows else np.zeros(0, np.int64),
              np.concatenate(cols) if cols else np.zeros(0, np.int64))),
            shape=(n + 1, n + 1))
        vs, ve = int(g.indptr[n]), int(g.indptr[n + 1])
        self._csr = (node_cells, g, vs, np.asarray(g.indices[vs:ve]))
        self._csr_epoch = self.epoch
        return self._csr

    def _goal_tables(self, goal: int) -> _GoalTables:
        """One Dijkstra from the goal over the portal graph: solve the
        goal's sector window locally, seed the virtual node's edges to
        the goal sector's portal cells with those distances, and let
        scipy's csgraph do the rest in C."""
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra
        gsid = self.sector_of(goal)
        gwin = self._local_window(gsid, goal)
        gb = self._bounds(gsid)
        node_cells, g, vs, virt_cols = self._graph_csr()
        n = node_cells.size
        data = g.data.copy()
        data[vs:] = np.inf
        ps = self.portals.get(gsid)
        if ps is not None and ps.size:
            lys = 1 + ps // self.w - gb[0]
            lxs = 1 + ps % self.w - gb[2]
            dl = gwin[lys, lxs].astype(np.float64)
            dl[dl >= INF] = np.inf
            idx = np.searchsorted(node_cells, ps)
            data[vs + np.searchsorted(virt_cols, idx)] = dl
        g2 = csr_matrix((data, g.indices, g.indptr), shape=g.shape)
        dist, pred = dijkstra(g2, directed=True, indices=n,
                              return_predecessors=True)
        return _GoalTables(dist, pred, gwin, gb, node_cells)

    def _attach(self, tables: _GoalTables, goal: int, start: int,
                seeds: Dict[int, int]) -> Set[int]:
        """Sectors on the best route from ``start`` to the goal (always
        includes both endpoint sectors; an unreachable start contributes
        just its own sector — its field cell stays STAY, matching the
        full sweep's behavior for unreachable cells).  Route-chain
        portal cells land in ``seeds`` with their goal distances: each
        is the length of a real path through corridor sectors (an UPPER
        bound of the corridor-restricted distance), so the corridor
        fixpoint starts near-correct along the whole route instead of
        propagating from the goal across every sector."""
        ssid = self.sector_of(start)
        gsid = self.sector_of(goal)
        sectors = {ssid, gsid}
        ps = self.portals.get(ssid)
        if ps is None or not ps.size:
            return sectors
        swin = self._local_window(ssid, start)
        y0, _, x0, _ = self._bounds(ssid)
        dl = swin[1 + ps // self.w - y0,
                  1 + ps % self.w - x0].astype(np.float64)
        dl[dl >= INF] = np.inf
        node_cells = tables.node_cells
        idx = np.searchsorted(node_cells, ps)
        tot = dl + tables.gdist[idx]
        j = int(np.argmin(tot))
        if not np.isfinite(tot[j]):
            return sectors
        n = node_cells.size
        u = int(idx[j])
        while 0 <= u < n:
            cell = int(node_cells[u])
            sectors.add(self.sector_of(cell))
            dv = int(tables.gdist[u])
            if dv < seeds.get(cell, INF):
                seeds[cell] = dv
            u = int(tables.parent[u])
        return sectors

    # -- plans ------------------------------------------------------------
    def plan_goal(self, goal: int, starts: Iterable[int],
                  keep_dist: bool = False) -> Optional[GoalPlan]:
        """Corridor plan for ``goal`` from ``starts`` (union-folded into
        any existing plan, so re-entry extension monotonically grows the
        corridor).  None when there is nothing to plan from (no starts
        and no prior plan) — the caller falls back to a full sweep."""
        t0 = time.perf_counter()
        goal = int(goal)
        hw = self.h * self.w
        if not 0 <= goal < hw:
            return None
        starts = {int(p) for p in starts
                  if 0 <= int(p) < hw and int(p) != goal}
        rec = self.plans.get(goal)
        if rec is not None:
            starts |= rec.starts
        if not starts and not self.free.reshape(-1)[goal]:
            starts = set()  # blocked goal plans from nothing
        elif not starts:
            return None
        if not self.free.reshape(-1)[goal]:
            # a blocked goal's full field is all-INF -> all-STAY; the
            # corridor twin is the bare STAY row (bit-identical)
            plan = GoalPlan(goal, starts, set(), self._stay_row.copy(),
                            0, (0, 0), self.epoch, None, None)
            self.plans[goal] = plan
            self.last_plan_ms = 1000.0 * (time.perf_counter() - t0)
            return plan
        if rec is not None and rec.tables is not None \
                and rec.epoch == self.epoch:
            tables = rec.tables
        else:
            tables = self._goal_tables(goal)
        sectors = {self.sector_of(goal)}
        seeds: Dict[int, int] = {}
        for st in sorted(starts)[:MAX_PLAN_STARTS]:
            sectors |= self._attach(tables, goal, st, seeds)
        dist, band = self._corridor_field(sorted(sectors), goal,
                                          seeds, tables.gwin)
        plan = GoalPlan(goal, starts, sectors,
                        self._pack_band(dist, band),
                        int((dist < INF).sum()), band, self.epoch, tables,
                        dist if keep_dist else None)
        self.plans[goal] = plan
        self.last_plan_ms = 1000.0 * (time.perf_counter() - t0)
        return plan

    def _pack_band(self, dist: np.ndarray, band: Tuple[int, int]
                   ) -> np.ndarray:
        """Full-width packed row: PACKED_STAY everywhere except the
        corridor row band, whose codes re-derive from the corridor
        distances with the full path's exact tie-break.  Work scales
        with the band, not the grid."""
        y0, y1 = band
        packed = self._stay_row.copy()
        if y1 <= y0:
            return packed
        dirs = field_repair.directions_np(dist, self.free, y0, y1)
        a, b = y0 * self.w, y1 * self.w
        wa, wb = a // PACKED_LANES, -(-b // PACKED_LANES)
        codes = np.full((wb - wa) * PACKED_LANES, DIR_STAY, np.uint8)
        codes[a - wa * PACKED_LANES:b - wa * PACKED_LANES] = dirs.reshape(-1)
        packed[wa:wb] = field_repair.pack_rows_np(codes)
        return packed

    def manages(self, goal: int) -> bool:
        return goal in self.plans

    def code_at(self, goal: int, cell: int) -> int:
        rec = self.plans[goal]
        word = int(rec.packed[cell >> 3])
        return (word >> (4 * (cell & 7))) & 0xF

    def needs_reentry(self, goal: int, cell: int) -> bool:
        """True when ``cell`` fell off ``goal``'s corridor: its code
        reads STAY on a free non-goal cell not yet folded into the plan
        (folding is what guards against re-extending a cell the planner
        already proved unreachable)."""
        rec = self.plans.get(goal)
        if rec is None or cell == goal or cell in rec.starts:
            return False
        if not self.free.reshape(-1)[cell]:
            return False
        return self.code_at(goal, cell) == DIR_STAY

    def forget(self, goal: int) -> None:
        self.plans.pop(goal, None)

    # -- world toggles ----------------------------------------------------
    def toggle(self, cell: int, blocked: bool) -> None:
        """Standalone flip helper (tests/fuzz): mutates the shared mask
        then repairs the graph.  PlanService mutates the mask itself and
        calls apply_toggles directly."""
        self.free.reshape(-1)[cell] = not blocked
        self.apply_toggles([cell])

    def apply_toggles(self, cells: Iterable[int]) -> int:
        """Incremental portal-graph repair after ``cells`` changed state
        in the shared mask.  Dirty = the sectors containing toggled
        cells (clustered with the field-repair tile machinery so a big
        batch maps to sectors in one pass); their borders rescan, and
        intra tables rebuild for dirty sectors AND their neighbors —
        whose portal sets may have changed through a shared border.
        Everything else provably matches a full rebuild (tested).
        Corridor plans are NOT recomputed here: the serving layer's
        staleness machinery re-plans affected goals through its normal
        repair queue.  Returns the number of sectors rebuilt."""
        cells = {int(c) for c in cells if 0 <= int(c) < self.h * self.w}
        if not cells:
            return 0
        dirty: Set[int] = set()
        for cluster in field_repair._cluster_cells(cells, self.w,
                                                   tile=self.s):
            dirty |= {self.sector_of(c) for c in cluster}
        rebuild = set(dirty)
        for sid in dirty:
            rebuild.update(self._neighbors(sid))
        for sid in dirty:
            for bid in self._sector_borders(sid):
                self._set_border(bid, self._scan_border(bid))
        self._rebuild_sectors(sorted(rebuild), force=dirty)
        self.epoch += 1
        return len(rebuild)

    # -- introspection ----------------------------------------------------
    def stats(self) -> dict:
        hw = self.h * self.w
        return {
            "sector_cells": self.s,
            "sectors": self.sy * self.sx,
            "portal_cells": sum(len(p) for p in self.portals.values()),
            "plans": len(self.plans),
            "build_ms": round(self.build_ms, 3),
            "last_plan_ms": round(self.last_plan_ms, 3),
            "corridor_cells_last": max(
                (p.cells for p in self.plans.values()), default=0),
            "grid_cells": hw,
        }


def _grid_graph(sub: np.ndarray):
    """4-adjacency CSR over a masked rectangle: row-major node ids,
    edges only between free 4-neighbors, blocked cells isolated.  The
    sparse-graph form is what lets scipy's C BFS replace whole-window
    relaxation on the host path."""
    from scipy.sparse import csr_matrix
    hh, ww = sub.shape
    idx = np.arange(hh * ww, dtype=np.int32).reshape(hh, ww)
    eh = sub[:, :-1] & sub[:, 1:]
    ev = sub[:-1, :] & sub[1:, :]
    r = np.concatenate([idx[:, :-1][eh], idx[:-1, :][ev],
                        idx[:, 1:][eh], idx[1:, :][ev]])
    c = np.concatenate([idx[:, 1:][eh], idx[1:, :][ev],
                        idx[:, :-1][eh], idx[:-1, :][ev]])
    return csr_matrix((np.ones(r.size, np.int8), (r, c)),
                      shape=(hh * ww, hh * ww))


_BIG = np.int64(1) << 40


def _sweep_offsets(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Scan offsets (x + segment_id * BIG, int64) for the forward and
    backward in-row segmented prefix scans; ``m`` is batch-LAST
    (hh, ww, n) or (hh, ww, 1).  The segment id increments at every
    blocked cell, so after subtracting the offset a single
    ``np.minimum.accumulate`` per row cannot carry a value across a
    wall: a cross-segment candidate comes back >= BIG after the offset
    is re-added and loses to the in-segment minimum (which includes the
    cell's own value, <= INF)."""
    x = np.arange(m.shape[1], dtype=np.int64)[:, None]
    fwd = x + np.cumsum(~m, axis=1, dtype=np.int64) * _BIG
    rev = x + np.cumsum(~m[:, ::-1], axis=1, dtype=np.int64) * _BIG
    return fwd, rev


def _corner_sweep(d: np.ndarray, m: np.ndarray, ydir: int, xdir: int,
                  off: np.ndarray) -> None:
    """One corner-ordered 2-D Gauss-Seidel sweep, in place: rows in
    ``ydir`` order, each first relaxed against the already-updated
    previous row, then closed along the row in ``xdir`` by a segmented
    min-plus prefix scan (d[y, x] = min over same-segment k of
    t[y, k] + |x - k|).  One sweep propagates any quadrant-monotone
    path end to end, so the fixpoint converges in ~#quadrant-turns
    rounds instead of ~path-length rounds.  Arrays are batch-LAST
    (hh, ww, n) so every row op and the accumulate run over contiguous
    memory; ``m`` may be (hh, ww, 1) when shared across the batch."""
    hh = d.shape[0]
    ys = range(hh) if ydir > 0 else range(hh - 1, -1, -1)
    prev = None
    for y in ys:
        t = d[y]
        if prev is not None:
            t = np.minimum(t, d[prev] + 1)
        t = np.where(m[y], np.minimum(t, INF), INF)
        if xdir < 0:
            t = t[::-1]
        o = off[y]
        q = t.astype(np.int64)
        q -= o
        np.minimum.accumulate(q, axis=0, out=q)
        q += o
        v = np.minimum(q, INF).astype(np.int32)
        if xdir < 0:
            v = v[::-1]
        d[y] = v
        prev = y


def _relax_round(d: np.ndarray, m: np.ndarray,
                 off: Optional[Tuple[np.ndarray, np.ndarray]] = None
                 ) -> None:
    """One fast-sweeping round: the four corner-ordered Gauss-Seidel
    sweeps of :func:`_corner_sweep` on batch-last (hh, ww, n) windows;
    ``m`` is (hh, ww, n) or (hh, ww, 1) when shared.  ``off`` caches
    :func:`_sweep_offsets` across rounds (the mask is static within a
    solve).  Values never exceed INF (blocked cells pin at INF), so
    int32 never overflows."""
    if off is None:
        off = _sweep_offsets(m)
    fwd, rev = off
    _corner_sweep(d, m, 1, 1, fwd)
    _corner_sweep(d, m, 1, -1, rev)
    _corner_sweep(d, m, -1, 1, fwd)
    _corner_sweep(d, m, -1, -1, rev)
