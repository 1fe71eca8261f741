"""Packed binary plan codec ("packed1") — the solverd fast-path wire format.

The JSON plan wire costs ~100 bytes per agent per direction per tick and a
full-fleet encode/decode on both sides (runtime/solverd.py,
cpp/manager_centralized/main.cpp) — the host-bound bottleneck that dominates
end-to-end ms/tick at the 1k–10k-agent rungs.  This codec replaces the
per-agent JSON objects with packed little-endian int32 arrays (12 bytes per
agent entry) and, after an initial full snapshot, **delta packets** carrying
only the agents whose pos/goal changed since the previous packet, so a
steady-state tick ships O(churn) bytes instead of O(N).

Framing: the binary packet rides base64 in a ``data`` field of the existing
line-framed bus JSON, so busd and every non-planning peer are untouched:

    {"type": "plan_request", "seq": N, "codec": "packed1",
     "caps": ["packed1"], "base_seq": B, "data": "<base64>"}
    {"type": "plan_response", "seq": N, "codec": "packed1",
     "duration_micros": U, "data": "<base64>"}

Negotiation rides the ``caps`` field: solverd answers packed iff the request
advertises ``packed1``; a plain-JSON manager never does and keeps getting
the legacy JSON wire, so mixed fleets interoperate.

Packet layout (all little-endian; header 40 bytes):

    u32 magic      "JGP1" (0x3150474A)
    u16 version    1
    u8  kind       1=snapshot  2=delta  3=response
    u8  flags      bit 0: narrow — arrays are u16, not i32 (chosen
                   automatically when every value < 65536, i.e. any grid
                   up to 256x256 and fleets up to 64k lanes; halves the
                   wire cost of the common rungs)
                   bit 1: trace — a 20-byte trace-context block follows
                   the header ("trace1": i64 trace_id,
                   i64 send_unix_ms, u32 hop), stamping the packet with
                   the sender's causal context for cross-process
                   correlation.  JG_TRACE_CTX=0 keeps the flag clear and
                   the wire byte-identical to the pre-trace1 format.
    i64 seq
    i64 base_seq   delta: the seq this packet's diff is relative to
    u32 n_entries
    u32 n_removed
    u32 n_named
    u32 names_len
    [i64 trace_id  i64 send_unix_ms  u32 hop]   only when flags bit 1
    i32 idx[n_entries]      roster lane per entry
    i32 pos[n_entries]      flat cell (request: pos; response: next_pos)
    i32 goal[n_entries]     flat cell
    i32 removed[n_removed]  roster lanes vacated since base_seq
    i32 named_idx[n_named]  lanes whose peer-id string is (re)declared
    u8  names[names_len]    '\\n'-joined peer ids, one per named_idx

Delta state machine (PackedFleetEncoder / PackedStateDecoder): packets form
a chain — each delta's ``base_seq`` must equal the seq the decoder last
applied.  A gap (lost packet, restarted solverd) raises :class:`SeqGapError`
and the decoder's owner publishes ``plan_snapshot_request``; the encoder
answers with a full snapshot, which also recurs every ``snapshot_every``
packets as belt-and-braces resync.  The C++ mirror
(cpp/common/plan_codec.hpp) is byte-identical — tests/test_plan_codec.py
locks the golden bytes across both encoders.
"""

from __future__ import annotations

import base64
import heapq
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0x3150474A  # b"JGP1" little-endian
VERSION = 1
KIND_SNAPSHOT = 1
KIND_DELTA = 2
KIND_RESPONSE = 3
# world1: an obstacle-toggle batch for dynamic worlds, riding
# the packed1 framing unchanged — idx[] carries flat cells, pos[] the new
# blocked flag (0/1), goal[] is all-zero padding so every packed1
# decoder (py and cpp) parses it with ZERO layout changes; narrow mode
# and the trace1 block compose exactly like the plan kinds.  seq carries
# the manager's monotone world_seq.  Caps token: "world1" (advertised on
# plan_request only while JG_DYNAMIC_WORLD is on, so the static wire
# stays byte-identical with the switch off).
KIND_WORLD = 4
WORLD_CAP = "world1"
# handoff1: a cross-region agent-lane + task-ledger transfer,
# riding the packed1 framing unchanged — one agent's full manager-side
# state (pos, goal, task phase, task endpoints, task id) as three
# 3-element arrays so every packed1 decoder parses it with ZERO layout
# changes; the peer id travels in the names blob (named_idx=[0]).
# seq = the per-(src,dst) handoff chain sequence (ack'd, retransmitted
# until ack, dedup-guarded on the receiver); base_seq = the SOURCE
# region id.  Layout:
#     idx  = [pos, goal, phase]            phase: 0 none, 1 pickup, 2 dlv
#     pos  = [pickup, delivery, has_task]  -less task: [0, 0, 0]
#     goal = [task_id_lo, task_id_hi, 0]   id = hi * 32768 + lo (keeps
#                                          narrow u16 arrays for ids
#                                          into the hundreds of millions)
KIND_HANDOFF = 5
HANDOFF_ID_BASE = 32768
CODEC_NAME = "packed1"
SNAPSHOT_EVERY = 64  # periodic resync cadence (packets)

_HEADER = struct.Struct("<IHBBqqIIII")


class CodecError(ValueError):
    """Malformed packet (bad magic/version/lengths)."""


@dataclass
class TraceCtx:
    """Compact per-message causal context ("trace1"): trace_id is
    rooted where the traced object was created (a task at dispatch, a plan
    chain at its manager), hop counts wire crossings monotonically, and
    send_ms is the SENDER's unix wall-clock at publish time — the receiver
    derives a clock-skew-clamped one-way latency from it."""
    trace_id: int
    hop: int
    send_ms: int

    def next_hop(self, send_ms: Optional[int] = None) -> "TraceCtx":
        import time as _t
        return TraceCtx(self.trace_id, self.hop + 1,
                        _t.time_ns() // 1_000_000 if send_ms is None
                        else send_ms)


_TRACE_EXT = struct.Struct("<qqI")  # trace_id, send_unix_ms, hop


class SeqGapError(RuntimeError):
    """A delta arrived whose base_seq is not the decoder's last applied
    seq: some packet in the chain was lost.  Owner must request a
    snapshot."""

    def __init__(self, have_seq: int, base_seq: int):
        super().__init__(f"delta base_seq {base_seq} != last applied "
                         f"{have_seq}")
        self.have_seq = have_seq
        self.base_seq = base_seq


@dataclass
class Packet:
    kind: int
    seq: int
    base_seq: int = 0
    idx: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    pos: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    goal: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    removed: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    named_idx: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    names: List[str] = field(default_factory=list)
    trace: Optional[TraceCtx] = None


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32))


FLAG_NARROW = 1  # u16 arrays (all values < 65536)
FLAG_TRACE = 2   # 20-byte trace-context block follows the header


def encode(pkt: Packet) -> bytes:
    idx, pos, goal = _i32(pkt.idx), _i32(pkt.pos), _i32(pkt.goal)
    removed, named_idx = _i32(pkt.removed), _i32(pkt.named_idx)
    if not (idx.size == pos.size == goal.size):
        raise CodecError("idx/pos/goal length mismatch")
    if named_idx.size != len(pkt.names):
        raise CodecError("named_idx/names length mismatch")
    arrays = (idx, pos, goal, removed, named_idx)
    narrow = all(a.size == 0 or (a.min() >= 0 and a.max() < 65536)
                 for a in arrays)
    flags = (FLAG_NARROW if narrow else 0) | \
        (FLAG_TRACE if pkt.trace is not None else 0)
    if narrow:
        arrays = tuple(a.astype("<u2") for a in arrays)
    blob = "\n".join(pkt.names).encode() if pkt.names else b""
    head = _HEADER.pack(MAGIC, VERSION, pkt.kind, flags, pkt.seq,
                        pkt.base_seq, idx.size, removed.size,
                        named_idx.size, len(blob))
    trace = b"" if pkt.trace is None else _TRACE_EXT.pack(
        pkt.trace.trace_id, pkt.trace.send_ms, pkt.trace.hop)
    return b"".join((head, trace) + tuple(a.tobytes() for a in arrays)
                    + (blob,))


def decode(buf: bytes) -> Packet:
    if len(buf) < _HEADER.size:
        raise CodecError("short packet")
    (magic, version, kind, flags, seq, base_seq, n_entries, n_removed,
     n_named, names_len) = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise CodecError(f"bad magic 0x{magic:08x}")
    if version != VERSION:
        raise CodecError(f"unsupported codec version {version}")
    width = 2 if flags & FLAG_NARROW else 4
    dtype = np.dtype("<u2") if width == 2 else np.dtype("<i4")
    trace_len = _TRACE_EXT.size if flags & FLAG_TRACE else 0
    need = _HEADER.size + trace_len \
        + width * (3 * n_entries + n_removed + n_named) + names_len
    if len(buf) != need:
        raise CodecError(f"packet length {len(buf)} != expected {need}")
    trace = None
    if trace_len:
        tid, send_ms, hop = _TRACE_EXT.unpack_from(buf, _HEADER.size)
        trace = TraceCtx(tid, hop, send_ms)
    off = _HEADER.size + trace_len

    def take(n):
        nonlocal off
        out = np.frombuffer(buf, dtype, count=n, offset=off)
        off += width * n
        return out.astype(np.int32, copy=True)

    idx, pos, goal = take(n_entries), take(n_entries), take(n_entries)
    removed, named_idx = take(n_removed), take(n_named)
    blob = buf[off:off + names_len]
    names = blob.decode().split("\n") if names_len else []
    if len(names) != n_named:
        raise CodecError("names blob count mismatch")
    return Packet(kind=kind, seq=seq, base_seq=base_seq, idx=idx, pos=pos,
                  goal=goal, removed=removed, named_idx=named_idx,
                  names=names, trace=trace)


def encode_b64(pkt: Packet) -> str:
    return base64.b64encode(encode(pkt)).decode()


def decode_b64(data: str) -> Packet:
    try:
        raw = base64.b64decode(data, validate=True)
    except Exception as e:  # binascii.Error subclasses ValueError
        raise CodecError(f"bad base64 framing: {e}") from None
    return decode(raw)


class PackedFleetEncoder:
    """Manager-side delta tracking: diff the current fleet against the
    state as of the last packet sent and emit the smallest valid packet.

    The C++ manager implements the same rules natively
    (cpp/common/plan_codec.hpp PackedFleetEncoder); determinism contract —
    identical fleet sequences produce identical bytes on both sides:

    - removals scan roster lanes ascending;
    - a new peer takes the lowest free lane, else appends;
    - entries follow the caller's fleet iteration order;
    - a snapshot compacts the roster to fleet order and resets the chain.
    """

    def __init__(self, snapshot_every: int = SNAPSHOT_EVERY):
        self.snapshot_every = snapshot_every
        self.roster: List[Optional[str]] = []  # lane -> peer id
        self.roster_idx: Dict[str, int] = {}
        self.free: List[int] = []  # min-heap of vacated lanes
        self.shadow: Dict[int, Tuple[int, int]] = {}  # lane -> (pos, goal)
        self.last_seq = 0
        self.since_snapshot = 0
        self.force_snapshot = True  # first packet is always a snapshot

    def request_snapshot(self) -> None:
        """The decoder reported a seq gap: resync on the next tick."""
        self.force_snapshot = True

    def encode_tick(self, seq: int,
                    fleet: Iterable[Tuple[str, int, int]]) -> Packet:
        """One planning tick's packet for ``fleet`` = ordered
        ``(peer_id, pos_cell, goal_cell)``."""
        fleet = list(fleet)
        snapshot = (self.force_snapshot
                    or self.since_snapshot + 1 >= self.snapshot_every)
        if snapshot:
            self.roster = [name for name, _, _ in fleet]
            self.roster_idx = {name: k for k, name in enumerate(self.roster)}
            self.free = []
            self.shadow = {k: (p, g) for k, (_, p, g) in enumerate(fleet)}
            self.force_snapshot = False
            self.since_snapshot = 0
            self.last_seq = seq
            lanes = np.arange(len(fleet), dtype=np.int32)
            return Packet(
                kind=KIND_SNAPSHOT, seq=seq, base_seq=0, idx=lanes,
                pos=_i32([p for _, p, _ in fleet]),
                goal=_i32([g for _, _, g in fleet]),
                named_idx=lanes.copy(), names=[n for n, _, _ in fleet])
        current = {name for name, _, _ in fleet}
        removed = []
        for lane, name in enumerate(self.roster):
            if name is not None and name not in current:
                removed.append(lane)
                del self.roster_idx[name]
                self.roster[lane] = None
                self.shadow.pop(lane, None)
                heapq.heappush(self.free, lane)
        idx, pos, goal, named_idx, names = [], [], [], [], []
        for name, p, g in fleet:
            lane = self.roster_idx.get(name)
            if lane is None:
                if self.free:
                    lane = heapq.heappop(self.free)
                    self.roster[lane] = name
                else:
                    lane = len(self.roster)
                    self.roster.append(name)
                self.roster_idx[name] = lane
                named_idx.append(lane)
                names.append(name)
            elif self.shadow.get(lane) == (p, g):
                continue  # unchanged since the last packet
            idx.append(lane)
            pos.append(p)
            goal.append(g)
            self.shadow[lane] = (p, g)
        pkt = Packet(kind=KIND_DELTA, seq=seq, base_seq=self.last_seq,
                     idx=_i32(idx), pos=_i32(pos), goal=_i32(goal),
                     removed=_i32(removed), named_idx=_i32(named_idx),
                     names=names)
        self.last_seq = seq
        self.since_snapshot += 1
        return pkt


@dataclass
class DecodedUpdate:
    """A validated, applied request packet, normalized for the consumer
    (solverd scatters ``idx/pos/goal`` into its device-resident arrays)."""
    seq: int
    is_snapshot: bool
    idx: np.ndarray
    pos: np.ndarray
    goal: np.ndarray
    removed: np.ndarray  # lanes deactivated this packet (incl. snapshot GC)


class PackedStateDecoder:
    """Solverd-side mirror of the manager's roster + fleet state.

    ``apply`` validates the delta chain (:class:`SeqGapError` on a break)
    and keeps a host-side state map so responses can be encoded per lane
    and tests can assert full-state equivalence."""

    def __init__(self):
        self.names: List[Optional[str]] = []  # lane -> peer id
        self.state: Dict[int, Tuple[int, int]] = {}  # lane -> (pos, goal)
        self.last_seq: Optional[int] = None

    def name_of(self, lane: int) -> Optional[str]:
        return self.names[lane] if 0 <= lane < len(self.names) else None

    def apply(self, pkt: Packet) -> DecodedUpdate:
        if pkt.kind == KIND_DELTA:
            if self.last_seq is None or pkt.base_seq != self.last_seq:
                raise SeqGapError(-1 if self.last_seq is None
                                  else self.last_seq, pkt.base_seq)
        elif pkt.kind != KIND_SNAPSHOT:
            raise CodecError(f"not a request packet (kind {pkt.kind})")
        removed = pkt.removed
        if pkt.kind == KIND_SNAPSHOT:
            live = set(int(i) for i in pkt.idx)
            removed = _i32(sorted(l for l in self.state if l not in live))
            self.names = []
            self.state = {}
        top = int(max(pkt.idx.max() if pkt.idx.size else -1,
                      pkt.named_idx.max() if pkt.named_idx.size else -1))
        if top >= len(self.names):
            self.names.extend([None] * (top + 1 - len(self.names)))
        # removals strictly BEFORE names/entries: a lane vacated and handed
        # to a new peer in the same packet belongs to the new peer
        for lane in pkt.removed:
            self.state.pop(int(lane), None)
            if 0 <= int(lane) < len(self.names):
                self.names[int(lane)] = None
        for lane, name in zip(pkt.named_idx, pkt.names):
            self.names[int(lane)] = name
        for lane, p, g in zip(pkt.idx, pkt.pos, pkt.goal):
            self.state[int(lane)] = (int(p), int(g))
        self.last_seq = pkt.seq
        return DecodedUpdate(seq=pkt.seq,
                             is_snapshot=pkt.kind == KIND_SNAPSHOT,
                             idx=pkt.idx, pos=pkt.pos, goal=pkt.goal,
                             removed=removed)


def encode_world(world_seq: int, cells: Sequence[int],
                 blocked: Sequence[int],
                 trace: Optional[TraceCtx] = None) -> Packet:
    """world1 toggle batch: ``cells[k]`` becomes an obstacle when
    ``blocked[k]`` is truthy, traversable otherwise."""
    cells = _i32(cells)
    flags = _i32([1 if b else 0 for b in blocked])
    if cells.size != flags.size:
        raise CodecError("cells/blocked length mismatch")
    return Packet(kind=KIND_WORLD, seq=world_seq, base_seq=0, idx=cells,
                  pos=flags, goal=np.zeros(cells.size, np.int32),
                  trace=trace)


def decode_world(pkt: Packet) -> List[Tuple[int, bool]]:
    """``[(cell, blocked)]`` from a world1 packet."""
    if pkt.kind != KIND_WORLD:
        raise CodecError(f"not a world packet (kind {pkt.kind})")
    return [(int(c), bool(b)) for c, b in zip(pkt.idx, pkt.pos)]


@dataclass
class HandoffRec:
    """One cross-region agent transfer: the owning manager's
    full per-agent state, moved to the neighbor manager as a seq-chained
    ``handoff1`` record.  ``phase``: 0 = idle, 1 = to-pickup, 2 =
    to-delivery; a task-less record carries ``task_id=None``."""
    seq: int
    src_region: int
    peer: str
    pos: int
    goal: int
    phase: int = 0
    task_id: Optional[int] = None
    pickup: int = 0
    delivery: int = 0


def encode_handoff(rec: HandoffRec,
                   trace: Optional[TraceCtx] = None) -> Packet:
    has_task = rec.task_id is not None
    tid = int(rec.task_id) if has_task else 0
    if tid < 0:
        raise CodecError(f"negative task id {tid} in handoff")
    return Packet(
        kind=KIND_HANDOFF, seq=rec.seq, base_seq=rec.src_region,
        idx=_i32([rec.pos, rec.goal, rec.phase]),
        pos=_i32([rec.pickup if has_task else 0,
                  rec.delivery if has_task else 0,
                  1 if has_task else 0]),
        goal=_i32([tid % HANDOFF_ID_BASE, tid // HANDOFF_ID_BASE, 0]),
        named_idx=_i32([0]), names=[rec.peer], trace=trace)


def decode_handoff(pkt: Packet) -> HandoffRec:
    if pkt.kind != KIND_HANDOFF:
        raise CodecError(f"not a handoff packet (kind {pkt.kind})")
    if pkt.idx.size != 3 or pkt.pos.size != 3 or pkt.goal.size != 3 \
            or len(pkt.names) != 1:
        raise CodecError("malformed handoff packet arrays")
    has_task = bool(pkt.pos[2])
    return HandoffRec(
        seq=pkt.seq, src_region=int(pkt.base_seq), peer=pkt.names[0],
        pos=int(pkt.idx[0]), goal=int(pkt.idx[1]), phase=int(pkt.idx[2]),
        task_id=(int(pkt.goal[1]) * HANDOFF_ID_BASE + int(pkt.goal[0])
                 if has_task else None),
        pickup=int(pkt.pos[0]), delivery=int(pkt.pos[1]))


def encode_response(seq: int, idx: Sequence[int], next_pos: Sequence[int],
                    goal: Sequence[int]) -> Packet:
    """Response packet: only lanes whose next_pos or goal changed (absent
    lanes mean "no move, goal unchanged" — exactly the no-op the manager
    already skips)."""
    return Packet(kind=KIND_RESPONSE, seq=seq, base_seq=0, idx=_i32(idx),
                  pos=_i32(next_pos), goal=_i32(goal))


# ---------------------------------------------------------------------------
# pos1 — packed position/heartbeat beacon (packed1 family).
#
# One beacon replaces the per-tick JSON `position` + `position_update` pair
# of the decentralized agent (and the centralized agent's heartbeat): pos
# cell, goal cell, and the optional busy-task id.  Peer identity rides the
# bus frame's own `from` field, so the packet carries no name.  Wire shape:
#     {"type": "pos1", "data": "<base64>"}
# published on a region topic `mapd.pos.<rx>.<ry>` (runtime/region.py) or,
# with region gossip off, on the flat legacy topic.
#
# Layout (little-endian, 8-byte header):
#     u32 magic   "POS1" (0x31534F50)
#     u8  version 1
#     u8  flags   bit 0: narrow — cells are u16 (any grid up to 256x256)
#                 bit 1: a busy-task id follows the cells
#                 bit 2: a 20-byte trace-context block (trace1:
#                        i64 trace_id, i64 send_unix_ms, u32 hop) trails
#                        the packet — a busy agent's heartbeat carries its
#                        task's causal context so claims correlate across
#                        processes.  JG_TRACE_CTX=0 keeps the bit clear.
#     u16 reserved (0)
#     pos, goal   u16 each when narrow, else i32
#     i64 task_id (only when flags bit 1)
#     trace block (only when flags bit 2)
#
# The C++ mirror (cpp/common/plan_codec.hpp encode_pos1/decode_pos1) is
# byte-identical; tests/test_region_bus.py locks golden bytes across both.
# ---------------------------------------------------------------------------

POS1_MAGIC = 0x31534F50  # b"POS1" little-endian
POS1_VERSION = 1
POS1_FLAG_NARROW = 1
POS1_FLAG_TASK = 2
POS1_FLAG_TRACE = 4
_POS1_HEAD = struct.Struct("<IBBH")


def encode_pos1(pos: int, goal: int, task_id: Optional[int] = None,
                trace: Optional[TraceCtx] = None) -> bytes:
    pos, goal = int(pos), int(goal)
    narrow = 0 <= pos < 65536 and 0 <= goal < 65536
    flags = (POS1_FLAG_NARROW if narrow else 0) | \
        (POS1_FLAG_TASK if task_id is not None else 0) | \
        (POS1_FLAG_TRACE if trace is not None else 0)
    out = _POS1_HEAD.pack(POS1_MAGIC, POS1_VERSION, flags, 0)
    out += struct.pack("<HH" if narrow else "<ii", pos, goal)
    if task_id is not None:
        out += struct.pack("<q", int(task_id))
    if trace is not None:
        out += _TRACE_EXT.pack(trace.trace_id, trace.send_ms, trace.hop)
    return out


def decode_pos1_full(buf: bytes
                     ) -> Tuple[int, int, Optional[int],
                                Optional[TraceCtx]]:
    """``(pos, goal, task_id-or-None, trace-or-None)``; raises
    :class:`CodecError` on a malformed packet (short/overlong, bad
    magic/version)."""
    if len(buf) < _POS1_HEAD.size:
        raise CodecError("short pos1 packet")
    magic, version, flags, _ = _POS1_HEAD.unpack_from(buf, 0)
    if magic != POS1_MAGIC:
        raise CodecError(f"bad pos1 magic 0x{magic:08x}")
    if version != POS1_VERSION:
        raise CodecError(f"unsupported pos1 version {version}")
    narrow = bool(flags & POS1_FLAG_NARROW)
    has_task = bool(flags & POS1_FLAG_TASK)
    has_trace = bool(flags & POS1_FLAG_TRACE)
    need = _POS1_HEAD.size + (4 if narrow else 8) + (8 if has_task else 0) \
        + (_TRACE_EXT.size if has_trace else 0)
    if len(buf) != need:
        raise CodecError(f"pos1 length {len(buf)} != expected {need}")
    pos, goal = struct.unpack_from("<HH" if narrow else "<ii", buf,
                                   _POS1_HEAD.size)
    off = _POS1_HEAD.size + (4 if narrow else 8)
    task_id = None
    if has_task:
        (task_id,) = struct.unpack_from("<q", buf, off)
        off += 8
    trace = None
    if has_trace:
        tid, send_ms, hop = _TRACE_EXT.unpack_from(buf, off)
        trace = TraceCtx(tid, hop, send_ms)
    return int(pos), int(goal), task_id, trace


def decode_pos1(buf: bytes) -> Tuple[int, int, Optional[int]]:
    """``(pos, goal, task_id-or-None)`` — the pre-trace1 3-tuple shape most
    consumers want (any trace block is validated, then dropped)."""
    pos, goal, task_id, _ = decode_pos1_full(buf)
    return pos, goal, task_id


def encode_pos1_b64(pos: int, goal: int, task_id: Optional[int] = None,
                    trace: Optional[TraceCtx] = None) -> str:
    return base64.b64encode(encode_pos1(pos, goal, task_id, trace)).decode()


def _pos1_raw(data: str) -> bytes:
    try:
        return base64.b64decode(data, validate=True)
    except Exception as e:
        raise CodecError(f"bad pos1 base64 framing: {e}") from None


def decode_pos1_b64(data: str) -> Tuple[int, int, Optional[int]]:
    return decode_pos1(_pos1_raw(data))


def decode_pos1_full_b64(data: str
                         ) -> Tuple[int, int, Optional[int],
                                    Optional[TraceCtx]]:
    return decode_pos1_full(_pos1_raw(data))


# ---------------------------------------------------------------------------
# agg1 — per-region beacon aggregate (packed1 family).
#
# busd coalesces the pos1 beacons of one region topic arriving within a
# tick window into ONE multi-agent frame delivered once per agg1-capable
# subscriber — the O(agents)→O(regions) fanout cut on the dominant topic
# class.  Wire shape (on the ORIGINAL region topic, e.g. mapd.pos.2.3,
# with busd as the frame `from`):
#
#     {"type": "agg1", "data": "<base64>"}
#
# Binary layout (little-endian, byte-identical to the C++ mirror in
# cpp/common/plan_codec.hpp — golden + fuzz gated):
#
#     u32 magic       "AGG1" (0x31474741)
#     u8  version     1
#     u8  flags       bit0 TRACE: 20-byte trace1 block follows the header
#                     (the aggregate's own span; each entry's pos1 blob
#                     keeps its sender's trace block intact, so trace1
#                     composes through the coalesce hop)
#     u16 n_entries
#     [trace1 block]  i64 trace_id, i64 send_unix_ms, u32 hop
#     per entry:      u16 name_len, u16 blob_len, name bytes,
#                     pos1 blob VERBATIM (re-encoded by nobody: the bytes
#                     the sender published are the bytes delivered)
#
# Legacy subscribers (no agg1 cap in their hello) keep receiving singles;
# capable clients transparently explode the aggregate back into per-peer
# pos1 messages inside BusClient, so consumer role code never sees agg1.
# ---------------------------------------------------------------------------

AGG1_MAGIC = 0x31474741  # b"AGG1" little-endian
AGG1_VERSION = 1
AGG1_FLAG_TRACE = 1
_AGG1_HEAD = struct.Struct("<IBBH")
_AGG1_ENTRY = struct.Struct("<HH")


def encode_agg1(entries: Sequence[Tuple[str, bytes]],
                trace: Optional[TraceCtx] = None) -> bytes:
    """``entries`` is ``[(sender_peer_id, pos1_blob), ...]`` in arrival
    order.  Raises :class:`CodecError` when an entry exceeds the u16
    field widths (busd flushes well below them)."""
    if len(entries) > 0xFFFF:
        raise CodecError(f"agg1 entry count {len(entries)} > 65535")
    flags = AGG1_FLAG_TRACE if trace is not None else 0
    parts = [_AGG1_HEAD.pack(AGG1_MAGIC, AGG1_VERSION, flags, len(entries))]
    if trace is not None:
        parts.append(_TRACE_EXT.pack(trace.trace_id, trace.send_ms,
                                     trace.hop))
    for name, blob in entries:
        nb = name.encode()
        if len(nb) > 0xFFFF or len(blob) > 0xFFFF:
            raise CodecError("agg1 entry field exceeds u16")
        parts.append(_AGG1_ENTRY.pack(len(nb), len(blob)))
        parts.append(nb)
        parts.append(blob)
    return b"".join(parts)


def decode_agg1(buf: bytes
                ) -> Tuple[List[Tuple[str, bytes]], Optional[TraceCtx]]:
    """``([(sender, pos1_blob), ...], trace-or-None)``; raises
    :class:`CodecError` on any malformation (short, bad magic/version,
    truncated entry, trailing bytes).  Inner pos1 blobs are NOT decoded
    here — they pass through verbatim for the consumer's own decode."""
    if len(buf) < _AGG1_HEAD.size:
        raise CodecError("short agg1 packet")
    magic, version, flags, n = _AGG1_HEAD.unpack_from(buf, 0)
    if magic != AGG1_MAGIC:
        raise CodecError(f"bad agg1 magic 0x{magic:08x}")
    if version != AGG1_VERSION:
        raise CodecError(f"unsupported agg1 version {version}")
    off = _AGG1_HEAD.size
    trace = None
    if flags & AGG1_FLAG_TRACE:
        if len(buf) < off + _TRACE_EXT.size:
            raise CodecError("agg1 trace block truncated")
        tid, send_ms, hop = _TRACE_EXT.unpack_from(buf, off)
        trace = TraceCtx(tid, hop, send_ms)
        off += _TRACE_EXT.size
    entries: List[Tuple[str, bytes]] = []
    for _ in range(n):
        if len(buf) < off + _AGG1_ENTRY.size:
            raise CodecError("agg1 entry header truncated")
        name_len, blob_len = _AGG1_ENTRY.unpack_from(buf, off)
        off += _AGG1_ENTRY.size
        if len(buf) < off + name_len + blob_len:
            raise CodecError("agg1 entry body truncated")
        try:
            name = buf[off:off + name_len].decode()
        except UnicodeDecodeError as e:
            raise CodecError(f"agg1 entry name not utf-8: {e}") from None
        off += name_len
        entries.append((name, bytes(buf[off:off + blob_len])))
        off += blob_len
    if off != len(buf):
        raise CodecError(f"agg1 trailing bytes ({len(buf) - off})")
    return entries, trace


def encode_agg1_b64(entries: Sequence[Tuple[str, bytes]],
                    trace: Optional[TraceCtx] = None) -> str:
    return base64.b64encode(encode_agg1(entries, trace)).decode()


def decode_agg1_b64(data: str
                    ) -> Tuple[List[Tuple[str, bytes]], Optional[TraceCtx]]:
    try:
        raw = base64.b64decode(data, validate=True)
    except Exception as e:
        raise CodecError(f"bad agg1 base64 framing: {e}") from None
    return decode_agg1(raw)
