"""Periodic metrics beacon: every process publishes its registry snapshot.

Fleet-wide live telemetry rides the bus the fleet already has: each role
(solverd, the C++ managers and agents, busd itself) publishes a compact
:meth:`obs.registry.Registry.snapshot` on topic ``mapd.metrics`` every
~2 s.  The manager-side aggregator (obs/fleet_aggregator.py) and the
``analysis/fleet_top.py`` operator view subscribe and merge the beacons
into a fleet rollup; a peer whose beacons stop arriving surfaces as STALE
(complementing runtime/fleet.py's exit-code capture — a wedged-but-alive
process never exits, but its beacon goes quiet).

Beacon payload schema (topic ``mapd.metrics``):

    {"type": "metrics_beacon", "peer_id": s, "proc": s, "pid": n,
     "ts_ms": unix_ms, "interval_s": 2.0,
     "metrics": {"uptime_s": .., "counters": {...}, "gauges": {...},
                 "hists": {key: {"buckets": [...], "counts": [...],
                                 "sum": .., "count": ..}}}}

The C++ mirror (cpp/common/bus.hpp ``enable_metrics_beacon``) publishes the
exact same schema, so the aggregator is implementation-blind.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from p2p_distributed_tswap_tpu_torch.obs import registry as reg

METRICS_TOPIC = "mapd.metrics"
BEACON_INTERVAL_S = 2.0


class MetricsBeacon:
    """Tick-driven beacon: call :meth:`maybe_beat` from the owning main
    loop (any cadence >= ~1 Hz); it publishes at most once per interval.
    ``bus`` needs only ``publish(topic, data)`` and ``peer_id`` — the real
    BusClient or a test fake both qualify."""

    def __init__(self, bus, proc: str,
                 interval_s: float = BEACON_INTERVAL_S,
                 registry: Optional[reg.Registry] = None):
        self.bus = bus
        self.proc = proc
        self.interval_s = interval_s
        self.registry = registry or reg.get_registry()
        self.published = 0
        self._last = 0.0  # first maybe_beat publishes immediately

    def build_payload(self) -> dict:
        return {
            "type": "metrics_beacon",
            "peer_id": getattr(self.bus, "peer_id", self.proc),
            "proc": self.proc,
            "pid": os.getpid(),
            "ts_ms": time.time_ns() // 1_000_000,
            "interval_s": self.interval_s,
            "metrics": self.registry.snapshot(),
        }

    def maybe_beat(self, now: Optional[float] = None) -> Optional[dict]:
        """Publish a beacon if the interval elapsed; returns the payload
        published, else None."""
        now = time.monotonic() if now is None else now
        if self._last and now - self._last < self.interval_s:
            return None
        self._last = now
        payload = self.build_payload()
        self.bus.publish(METRICS_TOPIC, payload)
        self.published += 1
        return payload
