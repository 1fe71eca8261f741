"""Region-sharded position-gossip topic math.

The reference's scalability post-mortem proposes — but never builds —
geographic topic partitioning (DECENTRALIZED_ISSUES.md:62-96) to break the
O(N²) position broadcast.  This module is the Python half of that design
(native mirror: ``cpp/common/region.hpp``, kept rule-identical):

- the grid is partitioned into square regions of ``JG_REGION_CELLS``
  cells per edge (default 32);
- an agent publishes its position beacon on topic
  ``mapd.pos.<rx>.<ry>`` for the region containing its cell;
- a consumer interested in everything within Manhattan radius ``r`` of a
  cell subscribes to the ``(2k+1) x (2k+1)`` region neighborhood with
  ``k = ceil(r / region_cells)`` (clamped to the grid), re-subscribing
  when it crosses a region border.

Coverage guarantee (property-tested in tests/test_region_bus.py): for any
two cells within Manhattan distance ``r`` of each other, the publisher's
region topic is inside the subscriber's neighborhood — per-axis distance
``<= r`` implies region-index distance ``<= ceil(r / cells) = k``.

Managers (and other global consumers) subscribe the wildcard
``mapd.pos.*`` — busd matches topics ending in ``.*`` by prefix.
"""

from __future__ import annotations

from typing import List, Tuple

POS_TOPIC_PREFIX = "mapd.pos."
POS_TOPIC_WILDCARD = "mapd.pos.*"
DEFAULT_REGION_CELLS = 32

# ---------------------------------------------------------------------------
# Federated world regions — the OWNERSHIP canon.
#
# Gossip regions above shard the position-beacon *topic space*; federation
# regions shard the *world itself*: the grid splits into a COLSxROWS grid of
# rectangles, each owned by its own (manager, solverd) pair.  This module is
# the single source of truth for that partition (native mirror:
# cpp/common/region.hpp FedMap, kept rule-identical and golden-tested via
# codec_golden --fedmap, the same discipline as runtime/shardmap.py):
#
# - spec "CxR" = C columns x R rows ("2x1" = two side-by-side regions);
#   a bare "N" means Nx1; "1"/"1x1"/unset = federation OFF (single manager,
#   wire byte-identical);
# - rectangles are ceil-width slabs: column c covers
#   [c*cw, min((c+1)*cw, width)) with cw = ceil(width/cols) (last column
#   may be narrower) — chosen over balanced splits because one integer
#   division decides ownership identically in py and cpp;
# - region id = ry * cols + rx (row-major);
# - assignment is deterministic from the id alone: manager index = solverd
#   index = region id, bus shard = region id mod pool size — no registry,
#   no coordination, every process derives the same map;
# - HYSTERESIS: an agent owned by region A is handed off only once its
#   position sits MORE than `margin` cells outside A's rectangle on some
#   axis (fed_escaped) — an agent oscillating on the border stays owned
#   (the ping-pong guard, tested in tests/test_federation.py);
# - the manager-to-manager handoff wire rides bus topic
#   "mapd.fed.<region>" (control plane -> HOME shard, like "solver"), and
#   each region pair's plan wire is "solver.r<region>" so N planning
#   planes share one bus pool without cross-talk.
# ---------------------------------------------------------------------------

FED_TOPIC_PREFIX = "mapd.fed."
DEFAULT_FED_HYSTERESIS = 2
DEFAULT_FED_BORDER = 2


def fed_parse_spec(spec) -> Tuple[int, int]:
    """``(cols, rows)`` from a federation spec: ``"CxR"`` or a bare
    ``"N"`` (= Nx1).  None/''/'1'/'1x1' = (1, 1) = federation off.
    Malformed specs raise — a half-parsed world partition must never
    route silently."""
    if spec is None:
        return (1, 1)
    s = str(spec).strip().lower()
    if s in ("", "0", "1", "1x1"):
        return (1, 1)
    parts = s.split("x")
    try:
        if len(parts) == 1:
            cols, rows = int(parts[0]), 1
        elif len(parts) == 2:
            cols, rows = int(parts[0]), int(parts[1])
        else:
            raise ValueError
    except ValueError:
        raise ValueError(f"bad federation spec {spec!r} (want N or CxR)")
    if cols < 1 or rows < 1:
        raise ValueError(f"bad federation spec {spec!r} (want N or CxR)")
    return (cols, rows)


def _slab(extent: int, n: int) -> int:
    """Ceil-division slab width: one integer op, identical in cpp."""
    return (extent + n - 1) // n


def fed_region_of(x: int, y: int, cols: int, rows: int,
                  width: int, height: int) -> int:
    """Region id owning grid cell ``(x, y)`` (row-major ry*cols+rx)."""
    cw, rh = _slab(width, cols), _slab(height, rows)
    rx = min(x // cw, cols - 1)
    ry = min(y // rh, rows - 1)
    return ry * cols + rx


def fed_rect(rid: int, cols: int, rows: int, width: int,
             height: int) -> Tuple[int, int, int, int]:
    """Half-open rectangle ``(x0, y0, x1, y1)`` of region ``rid``."""
    cw, rh = _slab(width, cols), _slab(height, rows)
    rx, ry = rid % cols, rid // cols
    return (rx * cw, ry * rh,
            min((rx + 1) * cw, width), min((ry + 1) * rh, height))


def fed_escaped(x: int, y: int, rect: Tuple[int, int, int, int],
                margin: int) -> bool:
    """True once ``(x, y)`` sits MORE than ``margin`` cells outside
    ``rect`` on either axis — the handoff trigger.  margin >= 1 is the
    border-ping-pong hysteresis: a cell just across the line does not
    escape."""
    x0, y0, x1, y1 = rect
    return (x < x0 - margin or x > x1 - 1 + margin
            or y < y0 - margin or y > y1 - 1 + margin)


def fed_in_border(x: int, y: int, rect: Tuple[int, int, int, int],
                  border: int) -> bool:
    """True for a cell OUTSIDE ``rect`` but within ``border`` cells of
    it on both axes — the strip whose foreign agents are mirrored into
    this region's plans as stationary lanes (boundary planning
    correctness: TSWAP routes around them instead of planning two
    regions' agents into one border cell)."""
    x0, y0, x1, y1 = rect
    if x0 <= x < x1 and y0 <= y < y1:
        return False  # inside: owned, not mirrored
    return (x0 - border <= x <= x1 - 1 + border
            and y0 - border <= y <= y1 - 1 + border)


def fed_assignment(rid: int, cols: int, rows: int,
                   num_shards: int) -> dict:
    """The deterministic region -> (manager, solverd, bus-shard)
    assignment: every process (and every test) derives the same fleet
    layout from the region id alone.

    ``bus_shard`` is a PLACEMENT HINT, not current routing: today the
    region's control topics (``mapd.fed.<id>``, ``solver.r<id>``) ride
    the HOME shard like every control-plane topic (runtime/shardmap.py)
    — what actually spreads across the pool with region count is the
    region's POSITION-GOSSIP load, because federated managers subscribe
    only their rect's ``mapd.pos.<rx>.<ry>`` topics and those shard by
    the region indices.  The hint records where a future shard-routing
    of the control topics would deterministically place them."""
    total = cols * rows
    if not 0 <= rid < total:
        raise ValueError(f"region {rid} out of range for {cols}x{rows}")
    return {"region": rid, "manager": rid, "solverd": rid,
            "bus_shard": rid % max(1, num_shards),
            "handoff_topic": fed_topic(rid),
            "solver_topic": fed_solver_topic(rid, total)}


def fed_cli_args(rid: int, cols: int, rows: int, role: str) -> list:
    """The per-region CLI flags every spawn site shares, derived from
    :func:`fed_assignment` — one place to change the topic scheme or
    add a per-region flag (fleet.py, fleetsim run_rung/run_replay and
    federation_smoke all spawn region pairs).  ``role``: "manager"
    (regions + id + audit ns + solver topic) or "solverd" (solver
    topic + audit ns).  Empty for a 1x1 world (the kill switch)."""
    total = cols * rows
    if total <= 1:
        return []
    a = fed_assignment(rid, cols, rows, 1)
    common = ["--solver-topic", a["solver_topic"], "--audit-ns", f"r{rid}"]
    if role == "solverd":
        return common
    if role == "manager":
        return ["--regions", f"{cols}x{rows}", "--region-id", str(rid),
                *common]
    raise ValueError(f"unknown federation role {role!r}")


def fed_topic(rid: int) -> str:
    """Manager-to-manager handoff topic of region ``rid`` (control
    plane: shardmap routes it to the HOME shard)."""
    return f"{FED_TOPIC_PREFIX}{rid}"


def fed_solver_topic(rid: int, total: int) -> str:
    """Region ``rid``'s plan-wire topic.  A single-region world keeps
    the legacy "solver" topic — byte-identical wire with federation
    off."""
    return "solver" if total <= 1 else f"solver.r{rid}"


def topic_for(x: int, y: int, cells: int) -> str:
    """Region topic of grid cell ``(x, y)``."""
    return f"{POS_TOPIC_PREFIX}{x // cells}.{y // cells}"


def neighborhood_topics(x: int, y: int, radius: int, cells: int,
                        width: int, height: int) -> List[str]:
    """Region topics covering everything within Manhattan ``radius`` of
    ``(x, y)``, clamped to the grid; sorted for determinism."""
    k = max(1, -(-radius // cells))  # ceil div, never less than 3x3
    rx, ry = x // cells, y // cells
    nrx = (width + cells - 1) // cells
    nry = (height + cells - 1) // cells
    out = []
    for gy in range(max(0, ry - k), min(nry - 1, ry + k) + 1):
        for gx in range(max(0, rx - k), min(nrx - 1, rx + k) + 1):
            out.append(f"{POS_TOPIC_PREFIX}{gx}.{gy}")
    return out
