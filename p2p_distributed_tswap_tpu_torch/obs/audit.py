"""Fleet audit plane: continuous state-consistency digests,
world-epoch tracking, and bus-driven divergence drill-down.

After device-resident fleet state, multi-tenant slabs and
dynamic worlds the SAME logical state lives in five places — the
manager's task ledger and packed-encoder shadow, solverd's device slab
and host mirrors, the per-goal field cache, and every (sim-)agent's
local task view — with nothing observing that they still agree.  This
module is that observer:

- **digest primitives** — FNV-1a-64 chains over canonically packed
  state tuples, mirrored byte-for-byte in ``cpp/common/audit.hpp``
  (golden-tested via ``codec_golden --audit-*`` like shardmap):
  :func:`lane_digest` (sorted active ``(lane, pos, goal)`` int32
  triples — the manager's encoder shadow and solverd's mirrors hash to
  the SAME value iff they hold the same fleet), :func:`ledger_digest`
  (sorted ``(task_id, state, pickup, delivery)`` tuples),
  :func:`view_digest` (sorted held task ids), :func:`cells_digest`
  (sorted fresh field-cache goal cells);
- **the audit beacon** — every stateful process publishes a compact
  ``audit1`` binary blob (list of ``(section, count, seq, epoch,
  digest)`` entries, base64 in an ``audit_beacon`` JSON frame) on bus
  topic ``mapd.audit`` every ~2 s.  ``seq`` is the packed plan-chain
  tick and ``epoch`` the monotone ``world_seq`` bumped by every
  ``world_update`` — the watermarks the auditor joins on.  The manager
  ships a RING of its last few per-tick shadow digests so the join
  lands despite beacon-cadence skew.  Capability negotiation rides the
  beacon payload (``caps: ["audit1"]``): the driller only queries
  peers that advertised it;
- **the auditor** (:class:`AuditJoiner`) — joins digests at matching
  ``(seq, epoch)`` watermarks and classifies mismatches:
  ``roster`` (manager shadow vs solverd mirror at the same seq),
  ``device_mirror`` (solverd device pull vs its own host mirror),
  ``view`` (manager in-flight task set vs agent-pool held set, judged
  only when both sides are STABLE across beacons — task churn must not
  read as divergence; AMBER — dispatch/withdraw/done propagation
  windows make it a lead, not a page), ``stale_epoch`` /
  ``epoch_unaware`` (world
  epochs drifting apart; the dynamic-world caveat — a namespaced manager
  defaulting dynamic-world OFF — surfaces here instead of in
  folklore), ``silent`` (a previously-beaconing peer gone quiet while
  the fleet advances).  Per-class streak thresholds confirm a
  divergence; confirmed records append to ``<dir>/auditor.audit.jsonl``
  (``analysis/blackbox.py --audit`` merges them into the black-box
  readout) and fire ``on_divergence`` (the standalone auditor publishes
  a bus ``flight_dump`` and turns the verdict RED);
- **the bisect driller** (:class:`AuditDriller`) — turns "digests
  differ" into "agent X's goal differs: manager says (88,12), solverd
  says (88,11)" WITHOUT shipping full state: ``audit_drill_request``
  frames ask both sides for range digests over lane halves, recursing
  into the first divergent half down to a leaf, where rows are fetched
  and diffed field-by-field.

``JG_AUDIT=0`` is the kill switch: no process publishes or subscribes
anything audit-related and the wire is byte-identical to the pre-audit
build (live pin test in tests/test_audit.py).  ``JG_AUDIT_TEST_HOOKS=1``
arms solverd's injected-corruption hook (``audit_corrupt`` frames) for
the CI drill (scripts/audit_smoke.py).

Standalone:
    python -m p2p_distributed_tswap_tpu_torch.obs.audit --port 7400 \
        [--once --wait 6] [--json] [--drill] [--record DIR]
"""

from __future__ import annotations

import base64
import json
import os
import struct
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

AUDIT_TOPIC = "mapd.audit"
AUDIT_CAP = "audit1"
AUDIT_INTERVAL_S = 2.0
KILL_ENV = "JG_AUDIT"
HOOKS_ENV = "JG_AUDIT_TEST_HOOKS"
INTERVAL_ENV = "JG_AUDIT_INTERVAL_S"

# digest sections (mirrored in cpp/common/audit.hpp — never renumber)
SEC_SHADOW = 1   # manager: packed-encoder shadow (lane,pos,goal) @ seq
SEC_MIRROR = 2   # solverd: host mirror lanes @ last applied seq
SEC_DEVICE = 3   # solverd: device-pulled lanes @ the same seq
SEC_FIELDS = 4   # solverd: fresh (epoch-current) field-cache goal cells
SEC_LEDGER = 5   # manager: full task ledger (id,state,pickup,delivery)
SEC_VIEW = 6     # in-flight task-id set (manager side and agent side)

SECTION_NAMES = {SEC_SHADOW: "shadow", SEC_MIRROR: "mirror",
                 SEC_DEVICE: "device", SEC_FIELDS: "fields",
                 SEC_LEDGER: "ledger", SEC_VIEW: "view"}

# task-ledger state bytes (ledger_digest tuples)
TASK_PENDING = 0
TASK_TO_PICKUP = 1
TASK_TO_DELIVERY = 2


def enabled() -> bool:
    """The audit plane is ON unless JG_AUDIT=0 (the kill switch that
    keeps the wire byte-identical to the pre-audit build)."""
    return os.environ.get(KILL_ENV, "") != "0"


def hooks_enabled() -> bool:
    return os.environ.get(HOOKS_ENV, "") == "1"


def interval_s() -> float:
    try:
        return float(os.environ.get(INTERVAL_ENV, "") or AUDIT_INTERVAL_S)
    except ValueError:
        return AUDIT_INTERVAL_S


# ---------------------------------------------------------------------------
# digest primitives — byte-identical to cpp/common/audit.hpp
# ---------------------------------------------------------------------------

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


def fnv1a64(data: bytes, h: int = FNV64_OFFSET) -> int:
    """FNV-1a over ``data`` (64-bit), chainable via ``h``."""
    for b in data:
        h = ((h ^ b) * FNV64_PRIME) & _U64
    return h


def digest_hex(d: int) -> str:
    """Canonical 16-char lowercase hex — digests cross the JSON wire as
    strings (a u64 would round through the double-typed C++ Json)."""
    return f"{d & _U64:016x}"


def lane_digest(lanes, pos, goal) -> Tuple[int, int]:
    """``(digest, count)`` over active-lane triples, sorted by lane
    ascending, each packed as little-endian ``<iii``.  The manager's
    encoder shadow and solverd's host/device mirrors hash equal iff
    they hold the same (lane -> pos, goal) map."""
    import numpy as np

    lanes = np.asarray(lanes, np.int32)
    pos = np.asarray(pos, np.int32)
    goal = np.asarray(goal, np.int32)
    order = np.argsort(lanes, kind="stable")
    tri = np.column_stack([lanes[order], pos[order],
                           goal[order]]).astype("<i4")
    return fnv1a64(tri.tobytes()), int(lanes.size)


_LEDGER_TUPLE = struct.Struct("<qBii")


def ledger_digest(tasks) -> Tuple[int, int]:
    """``(digest, count)`` over ``(task_id, state, pickup_cell,
    delivery_cell)`` tuples sorted by (task_id, state), each packed
    little-endian ``<qBii`` (17 bytes)."""
    buf = bytearray()
    for tid, state, pickup, delivery in sorted(tasks):
        buf += _LEDGER_TUPLE.pack(int(tid), int(state) & 0xFF,
                                  int(pickup), int(delivery))
    return fnv1a64(bytes(buf)), len(buf) // _LEDGER_TUPLE.size


def view_digest(task_ids) -> Tuple[int, int]:
    """``(digest, count)`` over sorted held/in-flight task ids, each
    packed ``<q``."""
    ids = sorted(int(t) for t in task_ids)
    buf = b"".join(struct.pack("<q", t) for t in ids)
    return fnv1a64(buf), len(ids)


def cells_digest(cells) -> Tuple[int, int]:
    """``(digest, count)`` over sorted int32 cells (field-cache goals
    fresh at the current epoch), each packed ``<i``."""
    cs = sorted(int(c) for c in cells)
    buf = b"".join(struct.pack("<i", c) for c in cs)
    return fnv1a64(buf), len(cs)


# ---------------------------------------------------------------------------
# audit1 binary blob — the digest-beacon payload body
# ---------------------------------------------------------------------------

AUDIT_MAGIC = 0x31445541  # b"AUD1" little-endian
AUDIT_VERSION = 1
_AUD_HEAD = struct.Struct("<IBBH")   # magic, version, flags, n_entries
_AUD_ENTRY = struct.Struct("<BIqqQ")  # section, count, seq, epoch, digest


class AuditCodecError(ValueError):
    """Malformed audit1 blob (bad magic/version/length)."""


@dataclass(frozen=True)
class AuditEntry:
    """One digest record: ``seq`` is the plan-chain watermark, ``epoch``
    the world epoch (monotone ``world_seq``) the digest was computed
    under, ``digest`` the u64 FNV chain over ``count`` state tuples."""
    section: int
    count: int
    seq: int
    epoch: int
    digest: int


def encode_audit(entries: List[AuditEntry]) -> bytes:
    out = bytearray(_AUD_HEAD.pack(AUDIT_MAGIC, AUDIT_VERSION, 0,
                                   len(entries)))
    for e in entries:
        out += _AUD_ENTRY.pack(e.section & 0xFF, e.count, e.seq, e.epoch,
                               e.digest & _U64)
    return bytes(out)


def decode_audit(buf: bytes) -> List[AuditEntry]:
    if len(buf) < _AUD_HEAD.size:
        raise AuditCodecError("short audit1 blob")
    magic, version, _flags, n = _AUD_HEAD.unpack_from(buf, 0)
    if magic != AUDIT_MAGIC:
        raise AuditCodecError(f"bad audit1 magic 0x{magic:08x}")
    if version != AUDIT_VERSION:
        raise AuditCodecError(f"unsupported audit1 version {version}")
    need = _AUD_HEAD.size + n * _AUD_ENTRY.size
    if len(buf) != need:
        raise AuditCodecError(f"audit1 length {len(buf)} != {need}")
    out = []
    off = _AUD_HEAD.size
    for _ in range(n):
        sec, count, seq, epoch, digest = _AUD_ENTRY.unpack_from(buf, off)
        off += _AUD_ENTRY.size
        out.append(AuditEntry(sec, count, seq, epoch, digest))
    return out


def encode_audit_b64(entries: List[AuditEntry]) -> str:
    return base64.b64encode(encode_audit(entries)).decode()


def decode_audit_b64(data: str) -> List[AuditEntry]:
    try:
        raw = base64.b64decode(data, validate=True)
    except Exception as e:
        raise AuditCodecError(f"bad audit1 base64: {e}") from None
    return decode_audit(raw)


# ---------------------------------------------------------------------------
# beacon publisher (the audit analog of obs/beacon.py MetricsBeacon)
# ---------------------------------------------------------------------------

class AuditBeacon:
    """Tick-driven audit beacon: ``build`` returns ``(entries, extra)``
    where ``extra`` merges into the payload (buckets, epoch, dynamic
    flag...).  Publishes raw (un-namespaced) — the audit plane is
    operator/cross-tenant infrastructure like ``mapd.metrics``; a
    tenant-scoped emitter says so via the ``ns`` payload field."""

    def __init__(self, bus, proc: str,
                 build: Callable[[], Tuple[List[AuditEntry], dict]],
                 interval: Optional[float] = None, ns: str = ""):
        self.bus = bus
        self.proc = proc
        self.build = build
        self.interval_s = interval_s() if interval is None else interval
        self.ns = ns
        self.published = 0
        self._last = 0.0
        self._effective_interval = self.interval_s

    def payload(self) -> Optional[dict]:
        built = self.build()
        if built is None:
            return None
        entries, extra = built
        out = {
            "type": "audit_beacon",
            "peer_id": getattr(self.bus, "peer_id", self.proc),
            "proc": self.proc,
            "ns": self.ns,
            "pid": os.getpid(),
            "ts_ms": time.time_ns() // 1_000_000,
            # advertise the EFFECTIVE cadence (self-throttle included):
            # the joiner's silent threshold is 3x this value, so a big
            # fleet whose digest build stretches the beat must not keep
            # promising the configured interval or it reads as silent
            "interval_s": self._effective_interval,
            "caps": [AUDIT_CAP],
            "data": encode_audit_b64(entries),
        }
        out.update(extra or {})
        return out

    def maybe_beat(self, now: Optional[float] = None) -> Optional[dict]:
        now = time.monotonic() if now is None else now
        if self._last and now - self._last < self._effective_interval:
            return None
        self._last = now
        t0 = time.perf_counter()
        payload = self.payload()
        build_s = time.perf_counter() - t0
        # self-throttle: the digest body re-hashes the whole fleet, and
        # its cost grows with resident lanes (~3.5 µs/lane pure-python
        # FNV).  Cap the always-on overhead at ~2% of the host loop by
        # stretching the effective cadence when a build runs long — a
        # 10k-lane fleet beacons every ~3.5 s instead of stalling every
        # tick-loop iteration at the configured 2 s.
        self._effective_interval = max(self.interval_s, 50.0 * build_s)
        if payload is None:
            return None
        # re-stamp with THIS beat's effective cadence — the payload was
        # built before the throttle update, and a first long build must
        # not promise a beat it will not keep
        payload["interval_s"] = self._effective_interval
        self.bus.publish(AUDIT_TOPIC, payload, raw=True)
        self.published += 1
        return payload


# ---------------------------------------------------------------------------
# drill responder helpers (solverd / tests use these; the C++ manager
# mirrors the range rule natively)
# ---------------------------------------------------------------------------

DRILL_LEAF = 4  # ranges at or under this size answer with rows


def range_digest(lanes, pos, goal, lo: int, hi: int) -> Tuple[int, int]:
    """Digest over the active triples whose lane falls in [lo, hi)."""
    import numpy as np

    lanes = np.asarray(lanes, np.int64)
    sel = (lanes >= lo) & (lanes < hi)
    return lane_digest(np.asarray(lanes)[sel],
                       np.asarray(pos)[sel], np.asarray(goal)[sel])


def drill_answer(req: dict, lanes, pos, goal,
                 names: Optional[List[Optional[str]]] = None,
                 peer_id: str = "") -> dict:
    """Build the ``audit_drill_response`` for one request over an
    active-lane view (``lanes``/``pos``/``goal`` parallel arrays)."""
    import numpy as np

    lo = int(req.get("lo") or 0)
    hi = int(req.get("hi") or 0)
    d, n = range_digest(lanes, pos, goal, lo, hi)
    resp = {"type": "audit_drill_response",
            "req_id": req.get("req_id"),
            "peer_id": peer_id,
            "target": req.get("target"),
            "view": req.get("view"),
            "lo": lo, "hi": hi,
            "digest": digest_hex(d), "count": n}
    if req.get("rows") or hi - lo <= DRILL_LEAF:
        la = np.asarray(lanes, np.int64)
        sel = np.flatnonzero((la >= lo) & (la < hi))
        rows = []
        for k in sel:
            lane = int(la[k])
            name = ""
            if names is not None and 0 <= lane < len(names):
                name = names[lane] or ""
            rows.append([lane, int(np.asarray(pos)[k]),
                         int(np.asarray(goal)[k]), 1, name])
        resp["rows"] = sorted(rows)
    return resp


# ---------------------------------------------------------------------------
# the auditor: join digests at matching watermarks, classify divergence
# ---------------------------------------------------------------------------

# red = state provably forked at a shared watermark (or a peer died);
# amber = advisory — `view` compares the manager's ledger against
# agent-side beacons through multi-second propagation windows (task
# dispatch/withdraw/done all in flight), so a sustained mismatch is a
# lead to investigate, not a page; epoch drift likewise.
def flight_dump_trigger(bus, throttle_s: float = 30.0):
    """An ``on_divergence`` callable that pulls the fleet's black boxes
    (bus ``flight_dump`` on both the operator and solver planes) so the
    moments before a state fork survive for ``blackbox --audit`` — at
    most once per ``throttle_s`` episode window.  Shared by the
    standalone auditor CLI and fleet_top's live mode."""
    state = {"at": 0.0}

    def trigger(rec: dict) -> None:
        now = time.monotonic()
        if now - state["at"] > throttle_s:
            state["at"] = now
            bus.publish("mapd", {"type": "flight_dump"}, raw=True)
            bus.publish("solver", {"type": "flight_dump"}, raw=True)

    return trigger


RED_CLASSES = ("roster", "device_mirror", "silent")
AMBER_CLASSES = ("view", "stale_epoch", "epoch_unaware")
# evidence rounds (fresh-beacon evaluations) a mismatch must survive
# before it is CONFIRMED — even the exact-watermark joins require two,
# because a process restart can briefly overlay old-run and new-run
# seqs at the same watermark
CONFIRM_STREAK = {"roster": 2, "device_mirror": 2, "view": 3,
                  "silent": 2, "stale_epoch": 3, "epoch_unaware": 3}
RING_KEEP = 64  # per-peer per-section (seq -> entry) history bound


class _AuditPeer:
    __slots__ = ("proc", "ns", "last_ms", "interval_s", "beacons",
                 "rings", "latest", "stable", "epoch", "dynamic",
                 "buckets")

    def __init__(self):
        self.proc = "?"
        self.ns = ""
        self.last_ms = 0
        self.interval_s = AUDIT_INTERVAL_S
        self.beacons = 0
        # section -> {seq: AuditEntry} (insertion-ordered, bounded)
        self.rings: Dict[int, Dict[int, AuditEntry]] = {}
        self.latest: Dict[int, AuditEntry] = {}
        # section -> consecutive beacons with an unchanged digest (the
        # stability evidence fuzzy comparisons require)
        self.stable: Dict[int, int] = {}
        self.epoch = 0
        self.dynamic: Optional[bool] = None
        self.buckets: Optional[dict] = None


class AuditJoiner:
    """Merge ``audit_beacon`` payloads and judge fleet consistency.

    Feed :meth:`ingest` every bus frame data dict (non-beacons are
    ignored); call :meth:`evaluate` about once per beacon interval;
    read :meth:`status` for the rollup."""

    def __init__(self, record_path=None,
                 on_divergence: Optional[Callable[[dict], None]] = None,
                 confirm: Optional[Dict[str, int]] = None):
        self._peers: Dict[str, _AuditPeer] = {}
        self.record_path = record_path
        self.on_divergence = on_divergence
        self.confirm = dict(CONFIRM_STREAK)
        if confirm:
            self.confirm.update(confirm)
        self.beacons = 0
        self.joins = 0
        # (peer_a, peer_b, kind) -> last joined seq (join-count dedup)
        self._join_marks: Dict[tuple, int] = {}
        self._streaks: Dict[tuple, tuple] = {}
        self._confirmed_keys: set = set()
        self.divergences: List[dict] = []

    # -- ingest -----------------------------------------------------------
    def ingest(self, payload: dict, now_ms: Optional[int] = None) -> bool:
        if not isinstance(payload, dict) \
                or payload.get("type") != "audit_beacon":
            return False
        try:
            entries = decode_audit_b64(payload.get("data") or "")
        except AuditCodecError:
            return False
        peer = str(payload.get("peer_id") or payload.get("proc") or "?")
        st = self._peers.get(peer)
        if st is None:
            st = self._peers[peer] = _AuditPeer()
        st.proc = str(payload.get("proc") or "?")
        st.ns = str(payload.get("ns") or "")
        st.last_ms = (time.time_ns() // 1_000_000
                      if now_ms is None else now_ms)
        iv = payload.get("interval_s")
        if isinstance(iv, (int, float)) and iv > 0:
            st.interval_s = float(iv)
        st.beacons += 1
        if isinstance(payload.get("dynamic_world"), bool):
            st.dynamic = payload["dynamic_world"]
        if isinstance(payload.get("buckets"), dict):
            st.buckets = payload["buckets"]
        for e in entries:
            ring = st.rings.setdefault(e.section, {})
            if ring and e.seq not in ring \
                    and max(ring) - e.seq > RING_KEEP:
                # seq regressed far past the re-ship window: the peer's
                # chain restarted (e.g. a new manager run) — old-run
                # entries must never join against new-run watermarks
                ring.clear()
                st.stable[e.section] = 0
            ring[e.seq] = e
            while len(ring) > RING_KEEP:
                ring.pop(next(iter(ring)))
            prev = st.latest.get(e.section)
            if prev is not None and prev.digest == e.digest \
                    and prev.count == e.count:
                st.stable[e.section] = st.stable.get(e.section, 0) + 1
            else:
                st.stable[e.section] = 0
            st.latest[e.section] = e
            st.epoch = max(st.epoch, e.epoch)
        self.beacons += 1
        return True

    # -- evaluation -------------------------------------------------------
    def _record(self, rec: dict) -> None:
        self.divergences.append(rec)
        del self.divergences[:-256]
        # callback BEFORE the jsonl write: on_divergence may enrich the
        # record (the standalone auditor attaches an automatic capture1
        # pointer) and the persisted line must carry it
        if self.on_divergence is not None:
            try:
                self.on_divergence(rec)
            except Exception:
                pass  # a side-channel must never lose the record itself
        if self.record_path:
            try:
                with open(self.record_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass

    def _fresh(self, st: _AuditPeer, now_ms: int) -> bool:
        """A peer still beaconing inside its silent threshold.  Only
        fresh peers participate in digest joins — a dead peer (e.g. a
        replaced manager whose random peer_id retired with it) must
        surface as `silent`, never lend its stale rings to a join."""
        return now_ms - st.last_ms <= 3000 * st.interval_s + 1000

    def _count_join(self, a: str, b: str, kind: str, seq: int) -> None:
        """Count a join only the first time this (pair, seq) watermark
        is compared — evaluate() may re-walk the same rings many times
        between beacons, and the join count must measure data, not
        polling cadence."""
        if self._join_marks.get((a, b, kind)) != seq:
            self._join_marks[(a, b, kind)] = seq
            self.joins += 1

    def _current(self, now_ms: int) -> List[dict]:
        """Raw (unconfirmed) divergences visible right now."""
        out = []
        by_ns: Dict[str, List[Tuple[str, _AuditPeer]]] = {}
        for name, st in self._peers.items():
            if self._fresh(st, now_ms):
                by_ns.setdefault(st.ns, []).append((name, st))
        for ns, peers in by_ns.items():
            mgrs = [(n, s) for n, s in peers if SEC_SHADOW in s.rings]
            sols = [(n, s) for n, s in peers if SEC_MIRROR in s.rings]
            for mn, ms in mgrs:
                for sn, ss in sols:
                    common = (set(ms.rings[SEC_SHADOW])
                              & set(ss.rings[SEC_MIRROR]))
                    if not common:
                        continue
                    seq = max(common)
                    a = ms.rings[SEC_SHADOW][seq]
                    b = ss.rings[SEC_MIRROR][seq]
                    self._count_join(mn, sn, "roster", seq)
                    if (a.digest, a.count) != (b.digest, b.count):
                        out.append({"class": "roster", "ns": ns,
                                    "peer_a": mn, "peer_b": sn,
                                    "seq": seq, "epoch": b.epoch,
                                    "_ev": (ms.beacons, ss.beacons),
                                    "detail": f"shadow {digest_hex(a.digest)}"
                                              f"/{a.count} != mirror "
                                              f"{digest_hex(b.digest)}"
                                              f"/{b.count}"})
            for sn, ss in sols:
                dev = ss.rings.get(SEC_DEVICE) or {}
                common = set(ss.rings[SEC_MIRROR]) & set(dev)
                if common:
                    seq = max(common)
                    a = ss.rings[SEC_MIRROR][seq]
                    b = dev[seq]
                    self._count_join(sn, sn, "device", seq)
                    if (a.digest, a.count) != (b.digest, b.count):
                        out.append({"class": "device_mirror", "ns": ns,
                                    "peer_a": sn, "peer_b": sn,
                                    "seq": seq, "epoch": b.epoch,
                                    "_ev": (ss.beacons,),
                                    "detail": "device slab != host mirror"})
            # view: manager in-flight set vs every agent-side view —
            # judged only when both digests held still across beacons
            # (stable), so live churn never reads as divergence
            for mn, ms in mgrs or [(n, s) for n, s in peers
                                   if SEC_LEDGER in s.rings]:
                mv = ms.latest.get(SEC_VIEW)
                if mv is None or ms.stable.get(SEC_VIEW, 0) < 1:
                    continue
                for pn, psn in peers:
                    if pn == mn or SEC_SHADOW in psn.rings \
                            or SEC_LEDGER in psn.rings:
                        continue
                    pv = psn.latest.get(SEC_VIEW)
                    if pv is None or psn.stable.get(SEC_VIEW, 0) < 1:
                        continue
                    if (mv.digest, mv.count) != (pv.digest, pv.count):
                        out.append({"class": "view", "ns": ns,
                                    "peer_a": mn, "peer_b": pn,
                                    "seq": pv.seq, "epoch": pv.epoch,
                                    "_ev": (ms.beacons, psn.beacons),
                                    "detail": f"manager holds {mv.count} "
                                              f"in-flight, agents hold "
                                              f"{pv.count}"})
            # epoch tracking: every epoch-aware peer in a namespace must
            # converge on the same world epoch; a dynamic-world-OFF peer
            # in an epoch>0 fleet is the dynamic-world caveat made visible
            aware = [(n, s) for n, s in peers if s.dynamic is not False
                     and (SEC_SHADOW in s.rings or SEC_MIRROR in s.rings
                          or SEC_LEDGER in s.rings)]
            epochs = {n: s.epoch for n, s in aware}
            if epochs and max(epochs.values()) != min(epochs.values()):
                hi = max(epochs, key=epochs.get)
                lo = min(epochs, key=epochs.get)
                out.append({"class": "stale_epoch", "ns": ns,
                            "peer_a": hi, "peer_b": lo,
                            "seq": 0, "epoch": epochs[hi],
                            "_ev": tuple(s.beacons for _, s in aware),
                            "detail": f"{hi}@{epochs[hi]} vs "
                                      f"{lo}@{epochs[lo]}"})
            off = [(n, s) for n, s in peers if s.dynamic is False]
            fleet_epoch = max((s.epoch for _, s in peers), default=0)
            if off and fleet_epoch > 0:
                out.append({"class": "epoch_unaware", "ns": ns,
                            "peer_a": off[0][0], "peer_b": "",
                            "seq": 0, "epoch": fleet_epoch,
                            "_ev": (off[0][1].beacons,),
                            "detail": f"{off[0][0]} runs dynamic-world "
                                      f"OFF while the fleet is at epoch "
                                      f"{fleet_epoch}"})
        # silent peers: quiet past 3 of their own intervals (plus a 1 s
        # absolute grace — beacons ride each process's idle loop window,
        # so sub-second intervals jitter by whole loop iterations) while
        # some other peer is still fresh (the whole fleet pausing is not
        # a divergence — the harness may simply have stopped)
        fresh = any(now_ms - s.last_ms < 1500 * s.interval_s
                    for s in self._peers.values())
        if fresh:
            for name, st in self._peers.items():
                if now_ms - st.last_ms > 3000 * st.interval_s + 1000:
                    quiet_s = (now_ms - st.last_ms) / 1000.0
                    out.append({"class": "silent", "ns": st.ns,
                                "peer_a": name, "peer_b": "",
                                "seq": 0, "epoch": st.epoch,
                                "detail": f"no audit beacon for "
                                          f"{quiet_s:.1f}s"})
        return out

    def evaluate(self, now_ms: Optional[int] = None) -> List[dict]:
        """One judgment pass: update streaks, confirm divergences that
        survived their class threshold, return the CONFIRMED records
        newly emitted by this call."""
        now_ms = time.time_ns() // 1_000_000 if now_ms is None else now_ms
        current = self._current(now_ms)
        seen_keys = set()
        confirmed = []
        for d in current:
            key = (d["class"], d["ns"], d["peer_a"], d["peer_b"])
            seen_keys.add(key)
            # fuzzy classes carry an evidence mark (the contributing
            # peers' beacon counts): their streak only advances on FRESH
            # beacons — evaluate() may run many times between beacons,
            # and one transient beacon pair must never count as a
            # "sustained" divergence
            mark = d.pop("_ev", None)
            count, prev_mark = self._streaks.get(key, (0, None))
            if mark is None or mark != prev_mark:
                count += 1
            self._streaks[key] = (count, mark)
            if count >= self.confirm.get(d["class"], 2) \
                    and key not in self._confirmed_keys:
                self._confirmed_keys.add(key)
                rec = {"ts_ms": now_ms, **d}
                self._record(rec)
                confirmed.append(rec)
        for key in list(self._streaks):
            if key not in seen_keys:
                # divergence healed: reset so a NEW episode re-confirms
                # (and re-records) instead of staying latched forever
                del self._streaks[key]
                self._confirmed_keys.discard(key)
        return confirmed

    # -- rollup -----------------------------------------------------------
    def active(self) -> List[dict]:
        """Confirmed divergences still diverging right now — one record
        per key (the NEWEST: after a heal -> re-confirm cycle the
        history holds several records for the same key, and the live
        view must show the current episode, not every past one)."""
        newest: Dict[tuple, dict] = {}
        for d in self.divergences:
            key = (d["class"], d["ns"], d["peer_a"], d["peer_b"])
            if key in self._confirmed_keys:
                newest[key] = d  # later records overwrite earlier ones
        return list(newest.values())

    def verdict(self) -> str:
        classes = {d["class"] for d in self.active()}
        if classes & set(RED_CLASSES):
            return "red"
        if classes & set(AMBER_CLASSES):
            return "amber"
        return "green"

    def epochs(self) -> Dict[str, dict]:
        return {name: {"epoch": st.epoch, "dynamic": st.dynamic,
                       "ns": st.ns, "proc": st.proc}
                for name, st in sorted(self._peers.items())}

    def status(self) -> dict:
        classes: Dict[str, int] = {}
        for d in self.divergences:
            classes[d["class"]] = classes.get(d["class"], 0) + 1
        return {
            "verdict": self.verdict(),
            "peers": len(self._peers),
            "beacons": self.beacons,
            "joins": self.joins,
            "divergences": len(self.divergences),
            "active": self.active(),
            "classes": classes,
            "epochs": self.epochs(),
            "last": self.divergences[-1] if self.divergences else None,
        }


# ---------------------------------------------------------------------------
# the bisect driller: range-hash recursion to the first divergent lane
# ---------------------------------------------------------------------------

class AuditDriller:
    """Bus-driven binary search over lane space.  ``transport`` sends one
    drill request and returns the matching response (or None on
    timeout); the default rides a BusClient.  ~2·log2(span) round trips
    localize one corrupted lane without shipping any fleet state."""

    def __init__(self, bus=None, timeout: float = 3.0,
                 leaf: int = DRILL_LEAF,
                 transport: Optional[Callable[[dict], Optional[dict]]]
                 = None):
        self.bus = bus
        self.timeout = timeout
        self.leaf = leaf
        self._req_id = 0
        self.requests = 0
        self._transport = transport or self._bus_transport

    def _bus_transport(self, req: dict) -> Optional[dict]:
        self.bus.publish(AUDIT_TOPIC, req, raw=True)
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            f = self.bus.recv(timeout=min(0.25,
                                          deadline - time.monotonic()))
            if not f or f.get("op") != "msg":
                continue
            d = f.get("data") or {}
            if d.get("type") == "audit_drill_response" \
                    and d.get("req_id") == req["req_id"]:
                return d
        return None

    def _ask(self, target: str, view: str, lo: int, hi: int,
             ns: str = "", rows: bool = False) -> Optional[dict]:
        self._req_id += 1
        self.requests += 1
        req = {"type": "audit_drill_request", "req_id": self._req_id,
               "target": target, "view": view, "lo": lo, "hi": hi,
               "ns": ns}
        if rows:
            req["rows"] = True
        return self._transport(req)

    def drill_lanes(self, target_a: str, view_a: str, target_b: str,
                    view_b: str, span: int = 1 << 20,
                    ns: str = "") -> dict:
        """Bisect [0, span) down to the first divergent leaf and diff its
        rows.  Returns ``{"findings": [...], "requests": n}`` — each
        finding names the lane, the peer id, the divergent field and
        both sides' values — or an ``error`` key when a side went
        unresponsive / no divergence was visible."""
        t0 = time.perf_counter()
        req0 = self.requests

        def pair(lo, hi):
            a = self._ask(target_a, view_a, lo, hi, ns)
            b = self._ask(target_b, view_b, lo, hi, ns)
            if a is None or b is None:
                return None
            return a, b

        def differ(a, b):
            return (a.get("digest"), a.get("count")) \
                != (b.get("digest"), b.get("count"))

        top = pair(0, span)
        if top is None:
            return {"error": "no_response", "requests": self.requests - req0}
        if not differ(*top):
            return {"findings": [], "requests": self.requests - req0,
                    "elapsed_s": round(time.perf_counter() - t0, 3)}
        lo, hi = 0, span
        while hi - lo > self.leaf:
            mid = (lo + hi) // 2
            left = pair(lo, mid)
            if left is None:
                return {"error": "no_response",
                        "requests": self.requests - req0}
            if differ(*left):
                hi = mid  # the FIRST divergent half (contract)
                continue
            right = pair(mid, hi)
            if right is None:
                return {"error": "no_response",
                        "requests": self.requests - req0}
            if differ(*right):
                lo = mid
                continue
            # transient: state advanced between the parent and child
            # queries and the halves agree again — report honestly
            return {"findings": [], "transient": True,
                    "requests": self.requests - req0}
        leaf = (self._ask(target_a, view_a, lo, hi, ns, rows=True),
                self._ask(target_b, view_b, lo, hi, ns, rows=True))
        if leaf[0] is None or leaf[1] is None:
            return {"error": "no_response", "requests": self.requests - req0}
        rows_a = {r[0]: r for r in leaf[0].get("rows") or []}
        rows_b = {r[0]: r for r in leaf[1].get("rows") or []}
        findings = []
        for lane in sorted(set(rows_a) | set(rows_b)):
            ra, rb = rows_a.get(lane), rows_b.get(lane)
            name = (ra or rb)[4] if (ra or rb) else ""
            if ra is None or rb is None:
                findings.append({"lane": lane, "peer": name,
                                 "field": "active",
                                 "a": None if ra is None else 1,
                                 "b": None if rb is None else 1})
                continue
            if not ra[4] and rb[4]:
                name = rb[4]
            for field, k in (("pos", 1), ("goal", 2)):
                if ra[k] != rb[k]:
                    findings.append({"lane": lane, "peer": name,
                                     "field": field,
                                     "a": ra[k], "b": rb[k]})
        return {"findings": findings, "lo": lo, "hi": hi,
                "requests": self.requests - req0,
                "elapsed_s": round(time.perf_counter() - t0, 3)}


def render_finding(f: dict, width: Optional[int] = None,
                   side_a: str = "manager", side_b: str = "solverd") -> str:
    """Operator string: "agent <id>'s goal differs: manager says (88,12),
    solverd says (88,11)"."""
    def cell(v):
        if v is None:
            return "absent"
        if width:
            return f"({v % width},{v // width})"
        return str(v)

    who = f.get("peer") or f"lane {f.get('lane')}"
    return (f"agent {who}'s {f['field']} differs: {side_a} says "
            f"{cell(f.get('a'))}, {side_b} says {cell(f.get('b'))}")


# ---------------------------------------------------------------------------
# standalone auditor CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    from p2p_distributed_tswap_tpu_torch.runtime.bus_client import BusClient

    ap = argparse.ArgumentParser(
        description="fleet state-consistency auditor (mapd.audit)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7400)
    ap.add_argument("--once", action="store_true",
                    help="collect for --wait seconds, judge, exit "
                         "0 green / 1 red or amber / 2 no beacons")
    ap.add_argument("--wait", type=float, default=6.0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--drill", action="store_true",
                    help="on a confirmed roster divergence, bisect to "
                         "the exact lane and print the finding")
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="append confirmed divergences to "
                         "DIR/auditor.audit.jsonl (blackbox --audit "
                         "merges them)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="where the fleet's flight rings dump "
                         "(default: $JG_FLIGHT_DIR, then --record). A "
                         "confirmed RED divergence then also dumps an "
                         "automatic capture1 next to the rings "
                         "and the audit record gains a `capture` "
                         "pointer — the incident arrives pre-packaged "
                         "for fleetsim --replay")
    args = ap.parse_args(argv)

    try:
        bus = BusClient(host=args.host, port=args.port, peer_id="auditor",
                        reconnect=not args.once)
    except OSError as e:
        import sys
        print(f"auditor: cannot reach bus at {args.host}:{args.port} "
              f"({e})", file=sys.stderr)
        return 2
    bus.subscribe(AUDIT_TOPIC, raw=True)

    record_path = None
    if args.record:
        os.makedirs(args.record, exist_ok=True)
        record_path = os.path.join(args.record, "auditor.audit.jsonl")

    dump = flight_dump_trigger(bus)
    flight_dir = (args.flight_dir or os.environ.get("JG_FLIGHT_DIR")
                  or args.record)
    cap_state = {"at": 0.0}

    def maybe_capture(rec: dict) -> None:
        """RED episode -> automatic capture dump:
        once the pulled flight rings land, rebuild the window as a
        replayable capture1 next to them; the jsonl record (written
        after this callback) carries the pointer.  Throttled like the
        flight dump — one capture per episode window."""
        if not flight_dir or rec.get("class") not in RED_CLASSES:
            return
        now = time.monotonic()
        if now - cap_state["at"] < 30.0:
            return
        cap_state["at"] = now
        time.sleep(1.2)  # flight_dump responses need a beat to land
        from p2p_distributed_tswap_tpu_torch.obs import capture as _capture
        try:
            doc = _capture.from_flight_dir(flight_dir, source="auto_red")
            path = _capture.save(
                os.path.join(flight_dir, "auditor.capture.json"), doc)
            rec["capture"] = str(path)
            print(f"📼 capture1 dumped to {path} "
                  f"({len(doc['tasks'])} task(s)) — replay with "
                  f"fleetsim --replay", flush=True)
        except (_capture.CaptureError, OSError) as e:
            print(f"📼 capture dump skipped: {e}", flush=True)

    def on_div(rec: dict) -> None:
        # sustained divergence: pull the fleet's black boxes (throttled)
        # so the moments before the fork survive
        dump(rec)
        maybe_capture(rec)
        print(f"🔴 AUDIT divergence [{rec['class']}] "
              f"{rec.get('peer_a')}↔{rec.get('peer_b')} "
              f"seq={rec.get('seq')} epoch={rec.get('epoch')}: "
              f"{rec.get('detail')}", flush=True)

    joiner = AuditJoiner(record_path=record_path, on_divergence=on_div)

    def pump(seconds: float) -> None:
        end = time.monotonic() + seconds
        last_eval = 0.0
        while True:
            remaining = end - time.monotonic()
            if remaining <= 0:
                return
            f = bus.recv(timeout=min(0.5, remaining))
            if f and f.get("op") == "msg":
                joiner.ingest(f.get("data") or {})
            if time.monotonic() - last_eval >= 1.0:
                last_eval = time.monotonic()
                joiner.evaluate()

    def maybe_drill() -> None:
        if not args.drill:
            return
        for d in joiner.active():
            if d["class"] != "roster":
                continue
            driller = AuditDriller(bus=bus)
            res = driller.drill_lanes(d["peer_a"], "shadow",
                                      d["peer_b"], "mirror",
                                      ns=d.get("ns") or "")
            for f in res.get("findings") or []:
                print("🔎 " + render_finding(f), flush=True)
            if res.get("error"):
                print(f"🔎 drill failed: {res['error']}", flush=True)

    if args.once:
        pump(args.wait)
        joiner.evaluate()
        maybe_drill()
        st = joiner.status()
        if args.json:
            print(json.dumps(st, indent=2))
        else:
            print(f"AUDIT {st['verdict'].upper()}: {st['peers']} peer(s), "
                  f"{st['joins']} join(s), {st['divergences']} "
                  f"divergence(s)")
            for d in st["active"]:
                print(f"  [{d['class']}] {d['peer_a']}↔{d['peer_b']}: "
                      f"{d['detail']}")
        if st["beacons"] == 0:
            return 2
        return 0 if st["verdict"] == "green" else 1

    try:
        while True:
            pump(2.0)
            st = joiner.status()
            print(f"AUDIT {st['verdict'].upper()} peers={st['peers']} "
                  f"joins={st['joins']} div={st['divergences']} "
                  f"epochs=" + ",".join(
                      f"{p}:{e['epoch']}" for p, e in st["epochs"].items()),
                  flush=True)
            maybe_drill()
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
