"""Python client for the host-runtime message bus (cpp/busd).

Speaks the same line-framed JSON protocol as the C++ BusClient
(cpp/common/bus.hpp); used by the solver daemon, the process-spawn test
runner, and integration tests.

Relay fast framing (caps-negotiated): the client advertises
``caps:["relay1"]`` in hello; once the hub's welcome echoes the cap,
publishes switch to topic-prefix lines the hub relays without JSON
parsing (``P<topic> <payload>``), and deliveries may arrive as
``M<topic> <from> <payload>`` — :meth:`recv` normalizes those to the
same ``{"op":"msg","topic","from","data"}`` dict, so consumers are
agnostic.  ``JG_BUS_FASTFRAME=0`` (or ``fastframe=False``) pins the
client to the legacy JSON wire; against an old hub (welcome without
caps) it stays legacy automatically.  A topic ending in ``.*``
subscribes by prefix (busd wildcard matching — managers use
``mapd.pos.*`` for the region-sharded position gossip).

Sharded bus pool: when the environment advertises a pool
(``JG_BUS_SHARD_PORTS=7450,7451,...`` — or ``shard_ports=[...]`` is
passed), the client becomes SHARD-AWARE: it holds one connection per
shard it needs, routes every subscription and publish to the owning
shard (runtime/shardmap.py — region position topics spread across the
pool, the control plane lives on the home shard), advertises the
``shard1`` cap so busd can suppress duplicate peer-forwarded
deliveries, and reconnects/fails over PER SHARD — a dead shard degrades
its regions, not the fleet.  With a single port (the default and the
``JG_BUS_SHARDS=1`` kill switch) the wire is byte-identical to the
pre-pool client.

Tenant namespace: with ``JG_BUS_NS=<tenant>`` (or a
``namespace=`` arg) every logical topic is prefixed ``<tenant>:`` on
the wire and stripped on delivery (runtime/busns.py), so whole fleets
share one busd pool without cross-talk while their role code stays
tenant-agnostic; the hello advertises ``caps:["ns1"]``.  Cross-tenant
infrastructure (solverd serving many fleets) passes ``raw=True`` to
``subscribe``/``publish`` to address wire topics directly.  With no
namespace the wire is byte-identical to the pre-namespace client.

Like the C++ client, it can survive a bus restart: with ``reconnect=True``
a dropped connection is retried with exponential backoff (0.25 s .. 4 s);
on success the client re-sends hello, re-subscribes every topic, and calls
``on_reconnect``.  While disconnected, ``publish`` drops (the bus is a
lossy broadcast medium) and ``recv`` behaves like a timeout.  Every such
drop is now counted (``bus.pub_dropped_disconnected``), and CONTROL-PLANE
frames (anything busd itself would refuse to shed: not position beacons,
not metrics, not path samples) go to a small bounded replay outbox that
is flushed when the owning shard's connection comes back — so a manager
command published into a bus bounce is delayed, not lost.  Non-home
shards always self-heal with the same backoff, independent of the
``reconnect`` flag.  The reference's brokerless gossipsub mesh has no hub
to lose — with this, losing busd degrades the fleet instead of
destroying it (VERDICT r2 item 5).

Zero-copy same-host lanes (caps ``shm1``): with ``JG_BUS_SHM``
set truthy (or ``shm=True``) the client creates one shared-memory ring
pair per shard link (runtime/shmlane.py ≡ cpp/common/shmlane.hpp) and
offers it in hello (``"shm": {"path": ..., "v": 1}``); once the hub's
welcome echoes ``shm1``, droppable-class frames (beacons/metrics/path)
move through the rings as the exact relay lines — publishes via the c2s
ring, deliveries via the s2c ring — while TCP keeps the control plane,
oversized frames, and cross-host links.  Ring overflow falls back to TCP
per frame (``bus.shm_fallbacks`` — never a stall); the lane's lifetime is
the TCP session (torn down + unlinked on disconnect, rebuilt on
reconnect).  ``JG_BUS_SHM`` unset keeps the wire byte-identical (pinned
by tests/test_shmlane.py).

Beacon aggregation (caps ``agg1``): with ``JG_BUS_AGG_MS>0``
the client advertises ``agg1`` and the hub may deliver one coalesced
multi-agent frame per region topic per window; :meth:`recv` transparently
explodes it back into per-peer ``pos1`` message dicts, so consumers never
see the aggregate.

Network accounting lives in the unified live-metrics registry
(obs/registry.py): per-topic ``bus.msgs_sent`` / ``bus.bytes_sent`` /
``bus.msgs_received`` / ``bus.bytes_received`` counters, counting ACTUAL
wire bytes (the framed line including its newline — the pre-registry
NetworkMetrics counted the unframed line, so py and cpp bandwidth numbers
disagreed by one byte per message).  ``registry.network_summary()`` is the
rolled-up view; the ``mapd.metrics`` beacon ships the raw counters.
"""

from __future__ import annotations

import base64
import json
import os
import select
import socket
import time
from collections import deque
from typing import Callable, Iterator, List, Optional

from p2p_distributed_tswap_tpu_torch.obs import registry as _reg
from p2p_distributed_tswap_tpu_torch.obs import trace
from p2p_distributed_tswap_tpu_torch.runtime import busns, shardmap, shmlane
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec

# Topics busd's slow-consumer policy may shed (droppable streams) — the
# complement is the control plane the replay outbox preserves.  Judged
# on the LOGICAL topic: a tenant's beacons shed like anyone else's.
_DROPPABLE_PREFIX = "mapd.pos."
_DROPPABLE_TOPICS = ("mapd.metrics", "mapd.path")


def _is_control_topic(topic: str) -> bool:
    topic = busns.strip_ns(topic)
    return not (topic.startswith(_DROPPABLE_PREFIX)
                or topic in _DROPPABLE_TOPICS)


class _Link:
    """One shard connection: socket + framing buffer + per-link caps and
    backoff state (each shard negotiates and fails independently)."""

    __slots__ = ("shard", "port", "sock", "buf", "topics", "backoff",
                 "next_attempt", "attempted", "fast_hub", "hub_caps",
                 "lane", "shm_live")

    def __init__(self, shard: int, port: int):
        self.shard = shard
        self.port = port
        self.sock: Optional[socket.socket] = None
        self.buf = b""
        self.topics: set[str] = set()  # subscriptions owned by this shard
        self.backoff = 0.0
        self.next_attempt = 0.0
        self.attempted = False  # ever dialed (lazy links dial on demand)
        self.fast_hub = False
        self.hub_caps: Optional[list] = None
        self.lane: Optional[shmlane.ShmLane] = None  # offered ring pair
        self.shm_live = False  # hub's welcome echoed shm1: lane is on


class BusClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 7400,
                 peer_id: Optional[str] = None, timeout: float = 5.0,
                 reconnect: bool = False,
                 on_reconnect: Optional[Callable[[], None]] = None,
                 registry: Optional[_reg.Registry] = None,
                 fastframe: Optional[bool] = None,
                 shard_ports: Optional[List[int]] = None,
                 namespace: Optional[str] = None,
                 shm: Optional[bool] = None):
        self.peer_id = peer_id or f"py-{int(time.time() * 1000) % 10 ** 10}"
        self._host, self._timeout = host, timeout
        self._reconnect = reconnect
        self._on_reconnect = on_reconnect
        # tenant namespace: explicit arg beats JG_BUS_NS beats none
        self._ns = (busns.validate(namespace) if namespace is not None
                    else busns.namespace_from_env())
        self._ns_prefix = busns.wire_topic(self._ns, "") if self._ns else ""
        # relay fast framing: advertised in hello, armed by the hub's
        # welcome (see module docstring); None = the JG_BUS_FASTFRAME env
        self._fastframe = (os.environ.get("JG_BUS_FASTFRAME", "1")
                           not in ("0", "false", "")
                           if fastframe is None else fastframe)
        # shm lanes are OPT-IN: offered only when JG_BUS_SHM
        # is truthy (or shm=True); they ride the relay framing, so
        # JG_BUS_FASTFRAME=0 vetoes them too
        self._shm = (shmlane.shm_enabled() if shm is None
                     else bool(shm)) and self._fastframe
        # beacon-aggregation window: >0 advertises the agg1 cap (we can
        # decode coalesced region beacons); 0/unset = legacy singles
        self._agg_ms = int(os.environ.get("JG_BUS_AGG_MS", "0") or 0)
        # frames ready ahead of the TCP buffers: lane deliveries and
        # exploded agg1 entries queue here for recv()/_next_buffered
        self._pending: deque = deque()
        # shard pool map: explicit arg beats JG_BUS_SHARD_PORTS beats the
        # single `port` (the legacy single-hub wire, byte-identical)
        ports = (list(shard_ports) if shard_ports
                 else shardmap.shard_ports_from_env(port))
        self._links = [_Link(i, p) for i, p in enumerate(ports)]
        self._n = len(self._links)
        self._rr = 0  # round-robin cursor for buffered-frame draining
        # bounded control-plane replay outbox: (topic, payload) of frames
        # publish() had to drop while the owning shard was down, flushed
        # in arrival order when that shard's link reconnects.
        # JG_BUS_OUTBOX=0 disables replay entirely (same as the C++
        # client — never an unbounded queue)
        self._outbox_max = int(os.environ.get("JG_BUS_OUTBOX", "128")
                               or 128)
        self._outbox: deque = deque(maxlen=max(1, self._outbox_max))
        # network accounting sink: the process registry unless a test
        # injects its own (obs/registry.py is the single source of truth)
        self.registry = registry or _reg.get_registry()
        self._closed = False
        # initial connect to the HOME shard still raises: startup contract
        self._connect(self._links[shardmap.HOME_SHARD])

    # -- back-compat views (home-shard semantics) -------------------------
    @property
    def port(self) -> int:
        return self._links[shardmap.HOME_SHARD].port

    @property
    def sock(self):
        return self._links[shardmap.HOME_SHARD].sock

    @property
    def hub_caps(self) -> Optional[list]:
        return self._links[shardmap.HOME_SHARD].hub_caps

    @property
    def fast_hub(self) -> bool:
        """True once the hub's welcome negotiated the relay1 framing."""
        return self._links[shardmap.HOME_SHARD].fast_hub

    @property
    def connected(self) -> bool:
        return self._links[shardmap.HOME_SHARD].sock is not None

    @property
    def num_shards(self) -> int:
        return self._n

    # -- connection management -------------------------------------------
    def _connect(self, link: _Link,
                 dial_timeout: Optional[float] = None) -> None:
        """Dial one shard.  ``dial_timeout`` bounds the CONNECT only —
        reconnect/lazy dials inside a role loop must not block for the
        full I/O timeout against a SYN-dropping dead host (the C++
        client bounds the same dial to 250 ms–1 s)."""
        link.attempted = True
        link.sock = socket.create_connection(
            (self._host, link.port),
            timeout=self._timeout if dial_timeout is None else dial_timeout)
        link.sock.settimeout(self._timeout)
        link.buf = b""
        link.backoff = 0.0
        link.fast_hub = False  # renegotiated by the hub's welcome
        hello = {"op": "hello", "peer_id": self.peer_id}
        caps = (["relay1"] if self._fastframe else [])
        # shard1 is orthogonal to the relay framing: a pool client must
        # advertise it even with JG_BUS_FASTFRAME=0, or busd would count
        # its span wildcards as peering interest and double-deliver.  It
        # rides only on a real pool — the single-hub hello (and the
        # JG_BUS_SHARDS=1 kill switch) stays byte-identical.
        if self._n > 1:
            caps.append("shard1")
        if self._ns:
            # namespaced tenant client; absent = legacy wire
            caps.append("ns1")
        # shm lane offer: create the ring pair BEFORE the
        # hello so the hub can attach on receipt; frames ride it only
        # after the welcome echoes shm1.  A same-name leftover (stale
        # after a SIGKILL) is reclaimed by create_lane.
        self._teardown_lane(link)
        if self._shm:
            try:
                link.lane = shmlane.create_lane(
                    shmlane.lane_path_for(self.peer_id, link.shard))
                caps.append("shm1")
                hello["shm"] = {"path": str(link.lane.path), "v": 1}
            except OSError as e:
                link.lane = None
                trace.instant("bus.shm_create_failed", err=str(e))
        if self._agg_ms > 0:
            caps.append("agg1")
        if caps:
            hello["caps"] = caps
        self._send_raw(link, hello)
        for t in sorted(link.topics):
            self._send_raw(link, {"op": "sub", "topic": t})

    def _teardown_lane(self, link: _Link) -> None:
        """Detach and unlink a link's shm lane (its lifetime is the TCP
        session: a fresh ring pair is offered on every (re)connect)."""
        if link.lane is not None:
            try:
                link.lane.detach()
                link.lane.close(unlink=True)
            except OSError:
                pass
            link.lane = None
        link.shm_live = False

    def _drop(self, link: _Link) -> None:
        """Connection died: close and arm the backoff timer (reconnect
        mode / non-home shard), or propagate (legacy fail-fast mode —
        HOME shard only: one dead shard degrades, it doesn't destroy)."""
        if link.sock is not None:
            try:
                link.sock.close()
            except OSError:
                pass
            link.sock = None
        self._teardown_lane(link)
        link.fast_hub = False  # renegotiate with whatever hub comes back
        if link.shard == shardmap.HOME_SHARD and not self._reconnect:
            raise ConnectionError("bus closed")
        link.backoff = min(link.backoff * 2, 4.0) if link.backoff else 0.25
        link.next_attempt = time.monotonic() + link.backoff

    def _try_reconnect(self, link: _Link) -> bool:
        """One backoff-paced reconnect attempt; True if connected now."""
        if link.sock is not None:
            return True
        if self._closed:
            return False
        if link.shard == shardmap.HOME_SHARD and not self._reconnect:
            return False  # closed or fail-fast client: stay down
        if time.monotonic() < link.next_attempt:
            return False
        try:
            self._connect(link,
                          dial_timeout=min(max(link.backoff, 0.25), 1.0))
        except OSError:
            link.sock = None
            link.backoff = min(link.backoff * 2, 4.0) if link.backoff \
                else 0.25
            link.next_attempt = time.monotonic() + link.backoff
            return False
        trace.count("bus.reconnects")
        trace.instant("bus.reconnect", peer_id=self.peer_id,
                      shard=link.shard)
        self._flush_outbox(link)
        if self._on_reconnect and link.shard == shardmap.HOME_SHARD:
            self._on_reconnect()
        return True

    def _ensure_link(self, shard: int) -> _Link:
        """The link for ``shard``, connected lazily on first use (a shard
        nobody publishes or subscribes to is never dialed)."""
        link = self._links[shard]
        if link.sock is None and not link.attempted and not self._closed:
            # never attempted: dial now (failures arm the backoff; links
            # that HAVE died stay down until the reconnect machinery —
            # which honors the reconnect/home semantics — revives them)
            try:
                self._connect(link, dial_timeout=0.25)
            except OSError:
                link.sock = None
                link.backoff = 0.25
                link.next_attempt = time.monotonic() + link.backoff
        return link

    def _flush_outbox(self, link: _Link) -> None:
        """Replay outboxed control-plane frames owned by a link that just
        came back; frames for still-down shards stay queued.  Iterates a
        SNAPSHOT: a send failure mid-replay re-queues through
        _outbox_maybe, which must not mutate the deque being walked —
        and once the link drops again, the rest stays queued for the
        next reconnect."""
        if not self._outbox:
            return
        pending = list(self._outbox)
        self._outbox.clear()
        for i, (topic, data) in enumerate(pending):
            if shardmap.shard_of(topic, self._n) != link.shard:
                self._outbox.append((topic, data))
                continue
            if link.sock is None:
                # died mid-replay: keep this and everything after it
                for item in pending[i:]:
                    self._outbox.append(item)
                return
            self._publish_on(link, topic, data)
            self.registry.count("bus.pub_replayed", topic=topic)

    # -- protocol ---------------------------------------------------------
    def _send_raw(self, link: _Link, obj: dict) -> None:
        assert link.sock is not None
        link.sock.sendall((json.dumps(obj) + "\n").encode())

    def _send(self, link: _Link, obj: dict) -> None:
        if link.sock is None:
            self._try_reconnect(link)
        if link.sock is None:
            return  # disconnected: lossy medium, drop
        try:
            self._send_raw(link, obj)
        except OSError:
            self._drop(link)

    def _wire(self, topic: str, raw: bool) -> str:
        """The on-the-wire topic: namespaced unless ``raw`` (cross-tenant
        infrastructure addressing wire topics directly)."""
        return topic if raw else busns.wire_topic(self._ns, topic)

    def subscribe(self, topic: str, raw: bool = False) -> None:
        topic = self._wire(topic, raw)
        for s in shardmap.shards_for_subscription(topic, self._n):
            link = self._ensure_link(s)
            link.topics.add(topic)
            self._send(link, {"op": "sub", "topic": topic})

    def unsubscribe(self, topic: str, raw: bool = False) -> None:
        topic = self._wire(topic, raw)
        for s in shardmap.shards_for_subscription(topic, self._n):
            link = self._links[s]
            link.topics.discard(topic)
            self._send(link, {"op": "unsub", "topic": topic})

    def _publish_on(self, link: _Link, topic: str, data: dict) -> None:
        if link.fast_hub and " " not in topic:
            # fast framing: the hub relays on a topic peek, no JSON parse
            line = f"P{topic} " + json.dumps(data)
            # shm fast path: droppable-class frames ride the
            # c2s ring as the exact relay line (no newline); a full ring
            # falls back to TCP per frame — never a stall.  Control-plane
            # topics stay on TCP (ordered, outbox-replayed).
            if (link.shm_live and link.lane is not None
                    and not _is_control_topic(topic)):
                if link.lane.send(line.encode()):
                    self.registry.count("bus.shm_tx_frames")
                    self.registry.count("bus.msgs_sent", topic=topic)
                    self.registry.count("bus.bytes_sent", len(line) + 1,
                                        topic=topic)
                    return
                self.registry.count("bus.shm_fallbacks")
        else:
            line = json.dumps({"op": "pub", "topic": topic, "data": data})
        try:
            wire = (line + "\n").encode()
            link.sock.sendall(wire)
            # count ACTUAL wire bytes (framed line + newline), per topic
            self.registry.count("bus.msgs_sent", topic=topic)
            self.registry.count("bus.bytes_sent", len(wire), topic=topic)
        except OSError:
            self.registry.count("bus.send_drops")
            self._outbox_maybe(topic, data)
            self._drop(link)

    def _outbox_maybe(self, topic: str, data: dict) -> None:
        """Queue a dropped frame for replay-on-reconnect — control-plane
        topics only (droppable beacon streams are superseded by the next
        beat; replaying them would only add stale load)."""
        if self._outbox_max <= 0 or not _is_control_topic(topic):
            return
        if len(self._outbox) == self._outbox.maxlen:
            self.registry.count("bus.outbox_overflow")
        self._outbox.append((topic, data))

    def publish(self, topic: str, data: dict, raw: bool = False) -> None:
        topic = self._wire(topic, raw)
        link = self._ensure_link(shardmap.shard_of(topic, self._n))
        if link.sock is None:
            self._try_reconnect(link)
        if link.sock is None:
            # dropped frames are NOT counted as sent (matches C++); they
            # ARE counted as drops, and control-plane frames queue for
            # replay when the owning shard comes back
            self.registry.count("bus.pub_dropped_disconnected", topic=topic)
            self._outbox_maybe(topic, data)
            return
        self._publish_on(link, topic, data)

    def query_peers(self, topic: str, raw: bool = False) -> None:
        self._send(self._links[shardmap.HOME_SHARD],
                   {"op": "peers", "topic": self._wire(topic, raw)})

    # -- receive ----------------------------------------------------------
    def _deliver_topic(self, topic: str) -> str:
        """Strip THIS client's namespace off a delivered wire topic, so
        consumers see the logical topic they subscribed (an un-namespaced
        client — e.g. solverd serving many tenants — sees wire topics
        verbatim)."""
        if self._ns_prefix and topic.startswith(self._ns_prefix):
            return topic[len(self._ns_prefix):]
        return topic

    def _explode_agg1(self, topic: str, data: dict) -> Optional[dict]:
        """A coalesced ``agg1`` region frame -> the first per-peer pos1
        msg dict (the rest queue on ``self._pending``), so consumers see
        the same singles stream the hub would have sent without
        aggregation.  Malformed aggregates are dropped and counted —
        never surfaced (a bad frame must not crash a role loop)."""
        try:
            entries, _ = plan_codec.decode_agg1_b64(data.get("data") or "")
        except plan_codec.CodecError:
            self.registry.count("bus.agg_rx_malformed")
            return None
        if not entries:
            return None
        self.registry.count("bus.agg_rx_frames")
        self.registry.count("bus.agg_rx_entries", len(entries))
        msgs = [{"op": "msg", "topic": topic, "from": name,
                 "data": {"type": "pos1",
                          "data": base64.b64encode(blob).decode()}}
                for name, blob in entries]
        self._pending.extend(msgs[1:])
        return msgs[0]

    def _parse_line(self, link: _Link, line: bytes) -> Optional[dict]:
        """One framed line -> normalized frame dict, or None to skip."""
        if line[:1] == b"M":
            # fast relay frame: `M<topic> <from> <payload-json>` —
            # normalized to the legacy msg-dict shape for callers
            head, _, payload = line.partition(b" ")
            sender, _, payload = payload.partition(b" ")
            try:
                data = json.loads(payload)
            except json.JSONDecodeError:
                return None  # garbage payload: ignore like any frame
            topic = head[1:].decode(errors="replace")
            self.registry.count("bus.msgs_received", topic=topic)
            self.registry.count("bus.bytes_received", len(line) + 1,
                                topic=topic)
            if isinstance(data, dict) and data.get("type") == "agg1":
                return self._explode_agg1(self._deliver_topic(topic), data)
            return {"op": "msg", "topic": self._deliver_topic(topic),
                    "from": sender.decode(errors="replace"),
                    "data": data}
        try:
            frame = json.loads(line)
        except json.JSONDecodeError:
            return None
        if frame.get("op") == "msg":
            # wire bytes: the framed line plus its newline
            topic = frame.get("topic", "")
            self.registry.count("bus.msgs_received", topic=topic)
            self.registry.count("bus.bytes_received", len(line) + 1,
                                topic=topic)
            frame["topic"] = self._deliver_topic(topic)
            data = frame.get("data")
            if isinstance(data, dict) and data.get("type") == "agg1":
                return self._explode_agg1(frame["topic"], data)
        elif frame.get("op") == "welcome":
            # caps negotiation: switch publishes to fast framing only
            # when the hub advertises it (old hub -> legacy), per link
            link.hub_caps = frame.get("caps") or []
            link.fast_hub = (self._fastframe
                             and "relay1" in link.hub_caps)
            # the lane goes live only when the hub echoes shm1 (it
            # attached our rings); otherwise tear down the offer — an
            # old hub, a refused attach, or JG_BUS_SHM=0 hub-side
            if link.lane is not None:
                link.shm_live = "shm1" in link.hub_caps
                if not link.shm_live:
                    self._teardown_lane(link)
        return frame

    def _next_buffered(self) -> Optional[dict]:
        """Pop the next complete frame already buffered on any link
        (round-robin across shards, so one busy shard cannot starve the
        others).  Frames already exploded/drained ahead of the TCP
        buffers (agg1 entries, lane deliveries) come first — they are
        older than anything still framed."""
        if self._pending:
            return self._pending.popleft()
        for k in range(self._n):
            link = self._links[(self._rr + k) % self._n]
            while True:
                nl = link.buf.find(b"\n")
                if nl < 0:
                    break
                line = link.buf[:nl]
                link.buf = link.buf[nl + 1:]
                frame = self._parse_line(link, line)
                if frame is not None:
                    self._rr = (link.shard + 1) % self._n
                    return frame
        return None

    def _drain_lanes(self) -> None:
        """Pull every frame waiting in live s2c rings onto the pending
        queue.  Lane frames are the exact relay ``M`` lines (no
        newline), so they reuse :meth:`_parse_line` unchanged."""
        for link in self._links:
            lane = link.lane
            if lane is None or not link.shm_live:
                continue
            lane.unpark()  # also drains accumulated doorbell bytes
            while True:
                raw = lane.recv()
                if raw is None:
                    break
                self.registry.count("bus.shm_rx_frames")
                parsed = self._parse_line(link, raw)
                if parsed is not None:
                    self._pending.append(parsed)

    def _park_lanes(self) -> bool:
        """Arm every live lane's parked flag so the hub rings the
        doorbell; False when frames raced in (caller must drain before
        sleeping — the classic lost-wakeup guard)."""
        ok = True
        for link in self._links:
            if link.lane is not None and link.shm_live:
                if not link.lane.park():
                    ok = False
        return ok

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next frame (any op, any shard) or None on timeout.  In
        reconnect mode an outage reads as a timeout (backoff-paced
        reconnect attempts ride each call); a non-home shard outage never
        raises — its regions degrade while the rest of the pool flows."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._drain_lanes()
            frame = self._next_buffered()
            if frame is not None:
                return frame
            for link in self._links:
                if link.sock is None and link.next_attempt > 0.0:
                    self._try_reconnect(link)
            socks = [link.sock for link in self._links
                     if link.sock is not None]
            if not socks:
                # everything down: wait out the lesser of caller timeout /
                # the nearest due attempt (matches the old outage wait)
                wait = max((link.next_attempt for link in self._links),
                           default=0.0) - time.monotonic()
                wait = max(0.0, wait)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining)
                time.sleep(min(wait, 0.25))
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                continue
            slice_s = 0.25 if deadline is None else \
                max(0.001, min(0.25, deadline - time.monotonic()))
            if deadline is not None and deadline - time.monotonic() <= 0:
                return None
            # park live lanes so the hub rings the doorbell while we
            # sleep; a failed park means frames raced in — drain first
            if not self._park_lanes():
                continue
            rlist = socks + [link.lane.bell_fd() for link in self._links
                             if link.lane is not None and link.shm_live
                             and link.lane.bell_fd() >= 0]
            try:
                readable, _, _ = select.select(rlist, [], [], slice_s)
            except (OSError, ValueError):
                readable = []  # a sock died mid-select: sweep below
            if not readable and deadline is not None \
                    and time.monotonic() >= deadline:
                return None
            for sock in readable:
                if isinstance(sock, int):
                    continue  # doorbell fd: lanes drain at loop top
                link = next(l for l in self._links if l.sock is sock)
                try:
                    sock.settimeout(self._timeout)
                    chunk = sock.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    self._drop(link)
                    continue
                if not chunk:
                    self._drop(link)
                    continue
                link.buf += chunk

    def messages(self, duration: float) -> Iterator[dict]:
        """Application messages received within ``duration`` seconds."""
        deadline = time.monotonic() + duration
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            frame = self.recv(timeout=remaining)
            if frame and frame.get("op") == "msg":
                yield frame

    def close(self) -> None:
        self._reconnect = False
        self._closed = True
        for link in self._links:
            if link.sock is not None:
                try:
                    link.sock.close()
                except OSError:
                    pass
                link.sock = None
            self._teardown_lane(link)
