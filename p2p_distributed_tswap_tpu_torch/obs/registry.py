"""Unified live-metrics registry: the single backend for runtime counters.

Before this module, live counters were scattered across three ad-hoc
mechanisms — ``BusClient.net`` (NetworkMetrics), the tracer's counters dict
(obs/trace.py), and the heartbeat's budget counters (obs/heartbeat.py) —
with no single source of truth and no way to ask "how is the fleet doing
right now".  This registry is that source: counters, gauges, and
fixed-bucket histograms with label support, thread-safe, ALWAYS ON (an
increment is one dict op under a lock — no clock read, no allocation on the
hot path), and consumed by every read side:

- ``obs.trace`` counters/gauges delegate here (trace *spans* stay gated by
  JG_TRACE; the counters are live metrics and cost nothing to keep);
- solverd's SIGUSR1 / bus ``stats_request`` dumps snapshot it;
- the periodic ``mapd.metrics`` beacon (obs/beacon.py) publishes
  :meth:`Registry.snapshot` for manager-side aggregation
  (obs/fleet_aggregator.py) and the ``analysis/fleet_top.py`` view;
- :meth:`Registry.expose_text` renders the Prometheus text format, served
  on a tiny per-process HTTP endpoint when ``JG_METRICS_PORT`` is set
  (:func:`maybe_serve_http`).

Series are keyed by a flat Prometheus-style string — ``name`` or
``name{k="v",...}`` with labels sorted — so snapshots stay JSON-compact and
the C++ mirror (cpp/common/metrics.hpp MetricsRegistry) can emit the exact
same schema.  Metric names may contain dots (the tracer's historical
``bus.msgs_sent`` style); they are sanitized to underscores only at
Prometheus exposition time.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

# Default histogram bounds in milliseconds, chosen so the 500 ms planning
# budget sits on a bucket edge (over/under budget is exact, not
# interpolated).  The +Inf bucket is implicit.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)


def format_key(name: str, labels: Optional[dict] = None) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`format_key` (labels with quoted simple values)."""
    brace = key.find("{")
    if brace < 0:
        return key, {}
    name = key[:brace]
    labels: Dict[str, str] = {}
    for part in key[brace + 1:].rstrip("}").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[k] = v.strip('"')
    return name, labels


class _Hist:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for b in self.bounds:
            if value <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def to_dict(self) -> dict:
        return {"buckets": list(self.bounds), "counts": list(self.counts),
                "sum": round(self.sum, 6), "count": self.count}


def hist_quantile(hist: dict, q: float) -> Optional[float]:
    """Quantile estimate from a snapshot histogram dict (linear
    interpolation inside the winning bucket; the +Inf bucket reports its
    lower bound — an honest floor, not a fabricated value)."""
    count = hist.get("count", 0)
    if not count:
        return None
    bounds = hist["buckets"]
    counts = hist["counts"]
    rank = q * count
    seen = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):  # +Inf bucket
                return float(bounds[-1]) if bounds else None
            hi = bounds[i]
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += c
    return float(bounds[-1]) if bounds else None


def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalpha() or ch in "_:" or (ch.isdigit() and i > 0)
        out.append(ch if ok else "_")
    return "".join(out)


class Registry:
    """Thread-safe counters / gauges / fixed-bucket histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}
        self._mono0 = time.monotonic()

    # -- write side -------------------------------------------------------
    def count(self, name: str, n: float = 1, **labels) -> None:
        key = format_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def gauge(self, name: str, value: float, **labels) -> None:
        key = format_key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float,
                buckets: Optional[Iterable[float]] = None, **labels) -> None:
        key = format_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist(
                    tuple(buckets) if buckets else DEFAULT_MS_BUCKETS)
            h.observe(value)

    def clear(self) -> None:
        """Drop every series (process entry / test isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._mono0 = time.monotonic()

    # -- read side --------------------------------------------------------
    def uptime_s(self) -> float:
        return time.monotonic() - self._mono0

    def counter_value(self, name: str, **labels) -> float:
        """Sum of every series of ``name`` whose labels include ``labels``
        (no labels: sum across all series of the name)."""
        total = 0.0
        with self._lock:
            items = list(self._counters.items())
        for key, v in items:
            n, ls = parse_key(key)
            if n == name and all(ls.get(k) == str(w)
                                 for k, w in labels.items()):
                total += v
        return total

    def gauge_value(self, name: str, default: Optional[float] = None,
                    **labels) -> Optional[float]:
        key = format_key(name, labels)
        with self._lock:
            return self._gauges.get(key, default)

    def snapshot(self) -> dict:
        """Point-in-time JSON-ready view (the beacon payload body; same
        schema as the C++ mirror's snapshot_json)."""
        with self._lock:
            return {
                "uptime_s": round(self.uptime_s(), 3),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "hists": {k: h.to_dict() for k, h in self._hists.items()},
            }

    def counters_flat(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges_flat(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def network_summary(self) -> dict:
        """Bus accounting rollup (bus_client records here): message/byte
        totals plus uptime-averaged rates, the live equivalent of the
        reference's NetworkMetrics print."""
        e = self.uptime_s()
        sent_b = self.counter_value("bus.bytes_sent")
        recv_b = self.counter_value("bus.bytes_received")
        return {
            "messages_sent": int(self.counter_value("bus.msgs_sent")),
            "messages_received": int(self.counter_value("bus.msgs_received")),
            "bytes_sent": int(sent_b),
            "bytes_received": int(recv_b),
            "elapsed_s": round(e, 3),
            "send_kbps": round(sent_b * 8.0 / (e * 1000.0), 3) if e else 0.0,
            "recv_kbps": round(recv_b * 8.0 / (e * 1000.0), 3) if e else 0.0,
        }

    def expose_text(self) -> str:
        """Prometheus text exposition format (/metrics)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.to_dict() for k, h in self._hists.items()}
        lines = []
        typed: set = set()

        def emit(key: str, value, kind: str, suffix: str = "",
                 extra_label: str = "") -> None:
            name, labels = parse_key(key)
            pname = _prom_name(name)
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} {kind}")
            pairs = [f'{k}="{v}"' for k, v in sorted(labels.items())]
            if extra_label:
                pairs.append(extra_label)
            lab = "{" + ",".join(pairs) + "}" if pairs else ""
            v = int(value) if float(value).is_integer() else value
            lines.append(f"{pname}{suffix}{lab} {v}")

        for key in sorted(counters):
            emit(key, counters[key], "counter")
        for key in sorted(gauges):
            emit(key, gauges[key], "gauge")
        for key in sorted(hists):
            h = hists[key]
            cum = 0
            for bound, c in zip(h["buckets"], h["counts"]):
                cum += c
                emit(key, cum, "histogram", "_bucket", f'le="{bound:g}"')
            emit(key, h["count"], "histogram", "_bucket", 'le="+Inf"')
            emit(key, h["sum"], "histogram", "_sum")
            emit(key, h["count"], "histogram", "_count")
        return "\n".join(lines) + "\n"


# -- module-level singleton (the process registry) -------------------------

_registry = Registry()


def get_registry() -> Registry:
    return _registry


def count(name: str, n: float = 1, **labels) -> None:
    _registry.count(name, n, **labels)


def gauge(name: str, value: float, **labels) -> None:
    _registry.gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    _registry.observe(name, value, **labels)


def snapshot() -> dict:
    return _registry.snapshot()


def expose_text() -> str:
    return _registry.expose_text()


# -- optional per-process HTTP /metrics endpoint ---------------------------

def serve_http(port: int, registry: Optional[Registry] = None,
               host: str = "127.0.0.1"):
    """Start a daemon-thread HTTP server exposing ``/metrics`` (Prometheus
    text) and ``/metrics.json`` (the beacon snapshot).  Returns the server
    (its ``server_port`` reports the bound port — pass 0 for ephemeral)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    reg = registry or _registry

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.startswith("/metrics.json"):
                body = json.dumps(reg.snapshot()).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics") or self.path == "/":
                body = reg.expose_text().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrape noise stays out of stdout
            pass

    srv = HTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="jg-metrics-http").start()
    return srv


def maybe_serve_http(registry: Optional[Registry] = None):
    """Start the /metrics endpoint iff ``JG_METRICS_PORT`` is set (0 =
    ephemeral port).  Returns the server or None; a bind failure warns and
    returns None — metrics must never take a daemon down."""
    port = os.environ.get("JG_METRICS_PORT", "")
    if port == "":
        return None
    try:
        return serve_http(int(port), registry)
    except (OSError, ValueError) as e:
        import sys
        print(f"⚠️ metrics endpoint disabled (JG_METRICS_PORT={port}: {e})",
              file=sys.stderr)
        return None
