"""Deterministic traffic capture: the ``capture1`` artifact.

The reference paper's experiments are statistical — every run re-samples
tasks and timing — so a tail breach or a state divergence found once
cannot be reproduced on demand.  This module fixes the *record* half of
record/replay: a versioned, self-contained description of one live
window's traffic, assembled from evidence the fleet already produces
(the sim pool's wire view, lifecycle event logs, flight-recorder rings):

- **fleet**: the deterministic run configuration — agent count, map
  side, the pool seed (initial agent placement is a pure function of
  it), bus shard count, solver, planning tick, and the manager's
  ``--seed`` (the satellite that threads one seed through every
  stochastic path fleetsim touches);
- **tasks**: every task the window dispatched — id, arrival offset from
  the capture epoch (ms), pickup and delivery cells.  Replay re-injects
  them open-loop at the same offsets with the same ids (the manager's
  ``taskat`` command), so the LOAD is deterministic even though the
  planner's internal scheduling stays live;
- **world**: every accepted ``world_update`` — offset, epoch, the
  ``[x, y, blocked]`` toggle list — replayed as
  ``world_update_request`` frames at the same offsets;
- **baseline**: the original window's signals (tasks/s, phase
  percentiles) so a replay can state its fidelity drift.

Assembly paths (all produce the same schema):

1. live — ``analysis/fleetsim.py --capture out.json`` attaches a
   :class:`CaptureRecorder` to the run;
2. post-mortem — ``analysis/blackbox.py --capture out.json`` rebuilds
   the window from flight-recorder dumps (the pool emits ``capture.meta``
   / ``task.spec`` / ``world.update`` evidence events into the
   always-on ring exactly for this);
3. automatic — the standalone auditor dumps a capture next to the
   flight rings when it confirms a RED divergence, so a live incident
   arrives pre-packaged for replay.

The determinism CONTRACT replay proves (see scripts/chaos_gate.py and
ARCHITECTURE.md): two replays of one capture complete the identical
task-id set with zero duplicates and land equal audit ledger/view
digests at the final (drained) watermark; timeline phase stats land
within a stated tolerance of the baseline.  Lane digests (positions)
are recorded for diagnosis but not asserted — assignment interleaving
is the live planner's, by design.

Schema versioning is STRICT: :func:`validate` rejects any document
whose ``version`` is not exactly ``capture1`` — a replay driven by a
half-understood future capture would fabricate a "reproduction".
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CAPTURE_VERSION = "capture1"

# evidence event names (obs/events.py emissions the assembly paths scan)
EV_META = "capture.meta"
EV_TASK = "task.spec"
EV_WORLD = "world.update"

# fleet keys a capture must carry to be replayable at all; the rest
# (shards, solver, tick_ms, heartbeat_s, manager_seed) have defaults
_REQUIRED_FLEET = ("agents", "side", "seed")
_FLEET_DEFAULTS = {"shards": 1, "solver": "native", "tick_ms": 250,
                   "heartbeat_s": 2.0, "manager_seed": None}


class CaptureError(ValueError):
    """Malformed or wrong-version capture document."""


def _now_ms() -> int:
    return time.time_ns() // 1_000_000


def _check_cell(pt, side: int, what: str) -> List[int]:
    if (not isinstance(pt, (list, tuple)) or len(pt) != 2
            or not all(isinstance(v, int) for v in pt)):
        raise CaptureError(f"{what}: cell must be [x, y], got {pt!r}")
    x, y = pt
    if side and not (0 <= x < side and 0 <= y < side):
        raise CaptureError(f"{what}: cell {pt} outside {side}x{side} map")
    return [int(x), int(y)]


def validate(doc: dict) -> dict:
    """Validate (and normalize in place) a capture document.  Raises
    :class:`CaptureError` on anything replay could misinterpret —
    including any version other than ``capture1``: an unknown schema
    must be REJECTED, never half-replayed."""
    if not isinstance(doc, dict):
        raise CaptureError("capture must be a JSON object")
    version = doc.get("version")
    if version != CAPTURE_VERSION:
        raise CaptureError(
            f"unsupported capture version {version!r} "
            f"(this build replays {CAPTURE_VERSION!r} only)")
    fleet = doc.get("fleet")
    if not isinstance(fleet, dict):
        raise CaptureError("capture has no fleet section")
    for k in _REQUIRED_FLEET:
        if not isinstance(fleet.get(k), int):
            raise CaptureError(f"fleet.{k} missing or not an int")
    if fleet["agents"] <= 0 or fleet["side"] <= 1:
        raise CaptureError(
            f"fleet agents={fleet['agents']} side={fleet['side']} "
            "is not a runnable fleet")
    for k, dflt in _FLEET_DEFAULTS.items():
        fleet.setdefault(k, dflt)
    side = fleet["side"]
    tasks = doc.get("tasks")
    if not isinstance(tasks, list) or not tasks:
        raise CaptureError("capture has no tasks — nothing to replay")
    seen_ids = set()
    for i, t in enumerate(tasks):
        if not isinstance(t, dict):
            raise CaptureError(f"tasks[{i}] is not an object")
        for k in ("id", "t_ms"):
            if not isinstance(t.get(k), int):
                raise CaptureError(f"tasks[{i}].{k} missing or not an int")
        if t["id"] in seen_ids:
            raise CaptureError(f"duplicate task id {t['id']}")
        seen_ids.add(t["id"])
        t["pickup"] = _check_cell(t.get("pickup"), side,
                                  f"tasks[{i}].pickup")
        t["delivery"] = _check_cell(t.get("delivery"), side,
                                    f"tasks[{i}].delivery")
    tasks.sort(key=lambda t: (t["t_ms"], t["id"]))
    world = doc.setdefault("world", [])
    if not isinstance(world, list):
        raise CaptureError("world section must be a list")
    for i, w in enumerate(world):
        if not isinstance(w, dict) or not isinstance(w.get("t_ms"), int):
            raise CaptureError(f"world[{i}] needs an int t_ms")
        toggles = w.get("toggles")
        if not isinstance(toggles, list) or not toggles:
            raise CaptureError(f"world[{i}] has no toggles")
        for tg in toggles:
            # ints (or bools for the blocked flag); integral floats are
            # accepted too — the C++ wire's JSON numbers may land as
            # doubles.  Anything else must REJECT as CaptureError, never
            # escape as a bare TypeError (the exit-2 contract).
            if (not isinstance(tg, (list, tuple)) or len(tg) != 3
                    or not all(isinstance(v, (int, bool))
                               or (isinstance(v, float)
                                   and v.is_integer()) for v in tg)):
                raise CaptureError(
                    f"world[{i}] toggle must be [x, y, blocked] ints, "
                    f"got {tg!r}")
        w["toggles"] = [[int(a), int(b), 1 if c else 0]
                        for a, b, c in toggles]
        w.setdefault("seq", 0)
    world.sort(key=lambda w: w["t_ms"])
    if not isinstance(doc.get("duration_ms"), int):
        doc["duration_ms"] = max(
            [t["t_ms"] for t in tasks] + [w["t_ms"] for w in world])
    doc.setdefault("baseline", None)
    doc.setdefault("source", "unknown")
    doc.setdefault("created_ms", _now_ms())
    return doc


def save(path, doc: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(validate(doc), indent=2) + "\n")
    return path


def load(path) -> dict:
    path = Path(path)
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CaptureError(f"cannot read capture {path}: {e}") from None
    return validate(doc)


def task_ids(doc: dict) -> List[int]:
    return sorted(t["id"] for t in doc["tasks"])


def schedule(doc: dict) -> List[Tuple[int, str, dict]]:
    """The merged replay schedule: ``(t_ms, kind, payload)`` sorted by
    offset — ``kind`` is ``task`` or ``world``.  Ties replay tasks
    first (a toggle recorded in the same millisecond as a dispatch was
    validated against a ledger that already held the task)."""
    events = [(t["t_ms"], "task", t) for t in doc["tasks"]]
    events += [(w["t_ms"], "world", w) for w in doc.get("world") or []]
    events.sort(key=lambda e: (e[0], 0 if e[1] == "task" else 1))
    return events


# ---------------------------------------------------------------------------
# live recorder — the fleetsim --capture hook
# ---------------------------------------------------------------------------

class CaptureRecorder:
    """Accumulate one window's traffic as it happens.

    The sim pool feeds :meth:`record_task` on every first-seen task and
    :meth:`record_world` on every accepted world update; the harness
    calls :meth:`finalize` with the window's measured baseline.  Offsets
    are measured from construction time (the capture epoch) — replay
    re-anchors at its own fleet-ready moment."""

    def __init__(self, fleet: Dict, t0: Optional[float] = None):
        self.fleet = dict(fleet)
        self.t0 = time.monotonic() if t0 is None else t0
        self.tasks: List[dict] = []
        self.world: List[dict] = []
        self._seen: set = set()

    def _off_ms(self, t: Optional[float]) -> int:
        return int(((time.monotonic() if t is None else t)
                    - self.t0) * 1000.0)

    def record_task(self, task_id: int, pickup, delivery,
                    t: Optional[float] = None) -> bool:
        """First sighting wins; re-dispatches of a known id are not new
        traffic (a withdrawn/re-queued task replays from its original
        arrival)."""
        tid = int(task_id)
        if tid in self._seen:
            return False
        self._seen.add(tid)
        self.tasks.append({"id": tid, "t_ms": self._off_ms(t),
                           "pickup": [int(pickup[0]), int(pickup[1])],
                           "delivery": [int(delivery[0]),
                                        int(delivery[1])]})
        return True

    def record_world(self, seq: int, toggles, t: Optional[float] = None
                     ) -> None:
        if not toggles:
            return
        self.world.append({"t_ms": self._off_ms(t), "seq": int(seq or 0),
                           "toggles": [[int(a), int(b), 1 if c else 0]
                                       for a, b, c in toggles]})

    def finalize(self, baseline: Optional[dict] = None,
                 source: str = "live") -> dict:
        doc = {
            "version": CAPTURE_VERSION,
            "created_ms": _now_ms(),
            "source": source,
            "fleet": dict(self.fleet),
            "tasks": list(self.tasks),
            "world": list(self.world),
            "duration_ms": self._off_ms(None),
            "baseline": baseline,
        }
        return validate(doc)


# ---------------------------------------------------------------------------
# event-sourced assembly — flight rings / event logs to capture1
# ---------------------------------------------------------------------------

def from_events(events: Iterable[dict],
                fleet_overrides: Optional[dict] = None,
                source: str = "flight") -> dict:
    """Assemble a capture from structured evidence events (flight-ring
    dumps or ``*.events.jsonl`` lines): ``capture.meta`` carries the
    fleet config, ``task.spec`` one task's endpoints, ``world.update``
    one accepted toggle batch.  Offsets re-anchor at the earliest
    ``capture.meta`` timestamp (fallback: the earliest evidence event).
    ``fleet_overrides`` fills or overrides config keys the rings did
    not carry.  Raises :class:`CaptureError` when no tasks (or no
    usable fleet config) survive — a capture that cannot replay must
    fail loudly at build time, not at replay time."""
    fleet: Dict = {}
    metas: List[dict] = []
    tasks: Dict[int, dict] = {}
    world: List[dict] = []
    world_seen: set = set()
    t_min: Optional[int] = None
    for ev in events:
        if not isinstance(ev, dict):
            continue
        name = ev.get("event")
        ts = ev.get("ts_ms")
        if name not in (EV_META, EV_TASK, EV_WORLD) \
                or not isinstance(ts, int):
            continue
        if name == EV_META:
            metas.append(ev)
            continue
        if t_min is None or ts < t_min:
            t_min = ts
        if name == EV_TASK:
            tid = ev.get("task_id")
            if isinstance(tid, int) and tid not in tasks \
                    and isinstance(ev.get("pickup"), list) \
                    and isinstance(ev.get("delivery"), list):
                tasks[tid] = {"id": tid, "ts_ms": ts,
                              "pickup": ev["pickup"],
                              "delivery": ev["delivery"]}
        elif name == EV_WORLD:
            seq = ev.get("seq") or 0
            # several pool/agent processes may witness the same
            # world_update broadcast: dedup on (seq, toggles)
            key = (seq, json.dumps(ev.get("toggles")))
            if key in world_seen or not ev.get("toggles"):
                continue
            world_seen.add(key)
            world.append({"ts_ms": ts, "seq": seq,
                          "toggles": ev["toggles"]})
    # fleet config: merge every meta (earliest first — the pool emits
    # side/agents/seed, the harness adds shards/solver/tick), overrides
    # last
    for ev in sorted(metas, key=lambda e: e.get("ts_ms", 0)):
        for k in ("agents", "side", "seed", "shards", "solver",
                  "tick_ms", "heartbeat_s", "manager_seed"):
            if ev.get(k) is not None:
                fleet[k] = ev[k]
    fleet.update(fleet_overrides or {})
    if not tasks:
        raise CaptureError(
            "no task.spec evidence found — nothing to replay (was the "
            "ring dumped after the window, or did it rotate past it?)")
    t0 = min((e.get("ts_ms") for e in metas
              if isinstance(e.get("ts_ms"), int)), default=None)
    if t0 is None or (t_min is not None and t0 > t_min):
        t0 = t_min
    doc = {
        "version": CAPTURE_VERSION,
        "created_ms": _now_ms(),
        "source": source,
        "fleet": fleet,
        "tasks": [{"id": t["id"], "t_ms": max(0, t["ts_ms"] - t0),
                   "pickup": t["pickup"], "delivery": t["delivery"]}
                  for t in tasks.values()],
        "world": [{"t_ms": max(0, w["ts_ms"] - t0), "seq": w["seq"],
                   "toggles": w["toggles"]} for w in world],
        "baseline": None,
    }
    return validate(doc)


def iter_evidence_files(directory) -> Iterable[dict]:
    """Yield structured events from every flight dump and event log in a
    directory (the same sources analysis/blackbox.py merges)."""
    directory = Path(directory)
    for pattern in ("*.flight.jsonl", "*.events.jsonl",
                    "trace/*.events.jsonl"):
        for path in sorted(directory.glob(pattern)):
            try:
                text = path.read_text(errors="ignore")
            except OSError:
                continue
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    yield rec


def from_flight_dir(directory, fleet_overrides: Optional[dict] = None,
                    source: str = "flight") -> dict:
    """Post-mortem capture: rebuild the window from the flight-recorder
    dumps (and any event logs) in ``directory``."""
    return from_events(iter_evidence_files(directory),
                       fleet_overrides=fleet_overrides, source=source)
