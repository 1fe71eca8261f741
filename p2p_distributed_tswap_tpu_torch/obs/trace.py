"""Structured span tracer: the runtime-observability core (obs/).

The metrics subsystem (metrics/task_metrics.py) is offline CSV; this module
is the LIVE side — monotonic-clock spans with nesting, a thread-safe ring
buffer, and a counters/gauges registry — exported as Chrome trace-event
JSONL (one event object per line; ``catapult``/Perfetto open a JSON array,
so :func:`analysis/trace_report.py --perfetto` wraps the lines, and the
lines themselves are what the merge tooling consumes).

Design constraints, in priority order:

1. **Near-zero cost when off.**  Tracing is gated by ``JG_TRACE=1`` (or an
   explicit :func:`configure` call).  Disabled, :func:`span` returns one
   shared no-op context manager and :func:`count`/:func:`gauge` return
   after a single attribute check — no allocation, no locking, no clock
   read.  Nothing in the jitted device programs is touched either way: all
   spans live on the HOST side of the dispatch boundary, where a
   ``perf_counter_ns`` pair per phase is noise against a ~100 ms tick.
2. **Mergeable across processes.**  Event timestamps are wall-clock-anchored
   microseconds: each tracer records ``(time_ns, perf_counter_ns)`` once at
   creation and emits ``anchor + (mono - mono0)``.  Durations stay purely
   monotonic; only the anchor is wall time, so host-runtime (C++,
   cpp/common/trace.hpp — same schema) and solver traces interleave on one
   Perfetto timeline with ~ms cross-process alignment.
3. **Bounded memory.**  The ring buffer keeps the newest ``capacity``
   events (default 64k ≈ a few MB); long-running daemons flush
   periodically (solverd flushes on heartbeat cadence) so nothing is lost
   in practice, and an unflushed crash still leaves the newest window.

Span nesting is tracked per thread (a thread-local stack); every event
carries its parent span name in ``args.parent`` so the report tool can
attribute child phases to their tick without relying on timestamp
containment alone.

Counters and gauges are NOT stored here anymore: :func:`count` and
:func:`gauge` delegate to the unified live-metrics registry
(obs/registry.py) unconditionally — they are live telemetry (beacons,
/metrics, stats dumps) and cost one dict op whether or not tracing is on.
Only the *span/event* side stays gated by ``JG_TRACE``; when tracing is
enabled, the registry's counters additionally ride the trace file as
Chrome counter ("C") events on every flush, exactly as before.

Environment:
  JG_TRACE=1        enable tracing
  JG_TRACE_DIR=DIR  where trace/heartbeat files land (default results/trace)
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Iterator, Optional

from p2p_distributed_tswap_tpu_torch.obs import registry as _registry

DEFAULT_CAPACITY = 65536
DEFAULT_DIR = "results/trace"


def _env_enabled() -> bool:
    return os.environ.get("JG_TRACE", "") not in ("", "0")


def trace_dir() -> str:
    return os.environ.get("JG_TRACE_DIR", DEFAULT_DIR)


class _NullSpan:
    """Shared no-op context manager: the entire cost of a disabled span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """One open span; appends a Chrome complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_parent")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_ns = time.perf_counter_ns() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._tracer._emit(self.name, self._t0, dur_ns, self._parent,
                           self.args)
        return False


class Tracer:
    """Thread-safe span/counter registry with a bounded event ring."""

    def __init__(self, proc: str = "py", enabled: Optional[bool] = None,
                 capacity: int = DEFAULT_CAPACITY):
        self.proc = proc
        self.pid = os.getpid()
        self.enabled = _env_enabled() if enabled is None else enabled
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        # counters/gauges live in the unified registry (obs/registry.py)
        self.registry = _registry.get_registry()
        # wall-clock anchor: ts_us = anchor + monotonic delta (see module doc)
        self._mono0 = time.perf_counter_ns()
        self._anchor_us = time.time_ns() // 1000
        self._meta_written: set = set()  # paths this INSTANCE wrote meta to

    # -- span / event emission -------------------------------------------
    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _ts_us(self, mono_ns: int) -> int:
        return self._anchor_us + (mono_ns - self._mono0) // 1000

    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, args or None)

    def _emit(self, name: str, t0_ns: int, dur_ns: int,
              parent: Optional[str], args: Optional[dict]) -> None:
        ev = {"name": name, "ph": "X", "ts": self._ts_us(t0_ns),
              "dur": max(0, dur_ns // 1000), "pid": self.pid,
              "tid": threading.get_ident() % (1 << 31),
              "args": dict(args) if args else {}}
        if parent:
            ev["args"]["parent"] = parent
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Point event (process lifecycle, faults): Chrome "i" phase."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "p",
              "ts": self._ts_us(time.perf_counter_ns()), "pid": self.pid,
              "tid": threading.get_ident() % (1 << 31), "args": args}
        with self._lock:
            self._events.append(ev)

    def flow(self, name: str, flow_id: int, phase: str = "t",
             **args) -> None:
        """Chrome flow event ("s" start / "t" step / "f" end): events
        sharing (cat, name, id) are linked into arrows across processes on
        the merged Perfetto timeline — obs/events.py emits one per
        sampled lifecycle hop so a task's journey renders as a chain.
        The id is masked to 63 bits: Chrome ids are unsigned."""
        if not self.enabled or phase not in ("s", "t", "f"):
            return
        ev = {"name": name, "ph": phase, "cat": "task",
              "id": int(flow_id) & ((1 << 63) - 1),
              "ts": self._ts_us(time.perf_counter_ns()), "pid": self.pid,
              "tid": threading.get_ident() % (1 << 31), "args": args}
        if phase in ("t", "f"):
            ev["bp"] = "e"  # bind to the enclosing slice when one exists
        with self._lock:
            self._events.append(ev)

    # -- counters / gauges (live metrics: ALWAYS on, see module doc) ------
    def count(self, name: str, n: int = 1) -> None:
        self.registry.count(name, n)

    def gauge(self, name: str, value: float) -> None:
        self.registry.gauge(name, value)

    def snapshot(self) -> dict:
        """Machine-readable point-in-time state (stats dumps, heartbeats)."""
        with self._lock:
            return {"proc": self.proc, "pid": self.pid,
                    "ts_ms": time.time_ns() // 1_000_000,
                    "counters": self.registry.counters_flat(),
                    "gauges": self.registry.gauges_flat(),
                    "buffered_events": len(self._events)}

    # -- export -----------------------------------------------------------
    def _drain(self) -> list:
        with self._lock:
            evs = list(self._events)
            self._events.clear()
            # registry counters ride along as Chrome counter ("C") events so
            # the merged timeline carries them without a side channel
            ts = self._ts_us(time.perf_counter_ns())
            for cname, v in self.registry.counters_flat().items():
                evs.append({"name": cname, "ph": "C", "ts": ts,
                            "pid": self.pid,
                            "args": {"value": int(v) if float(v).is_integer()
                                     else v}})
        return evs

    def jsonl_lines(self) -> Iterator[str]:
        meta = {"name": "process_name", "ph": "M", "pid": self.pid,
                "args": {"name": self.proc}}
        yield json.dumps(meta)
        for ev in self._drain():
            yield json.dumps(ev)

    def default_path(self, kind: str = "trace") -> str:
        return os.path.join(trace_dir(), f"{self.proc}-{self.pid}.{kind}.jsonl")

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Append buffered events (+ a metadata line on first write) as
        JSONL; returns the path written, or None when disabled."""
        if not self.enabled:
            return None
        path = path or self.default_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # The process_name meta line is written once per TRACER INSTANCE per
        # path — not "once per file": a re-run appending to an existing file
        # (new pid) still needs its own meta line or the report tool cannot
        # attribute the new events to a process.
        first = path not in self._meta_written
        self._meta_written.add(path)
        with open(path, "a") as f:
            for line in self.jsonl_lines() if first else map(
                    json.dumps, self._drain()):
                f.write(line + "\n")
        return path


# -- module-level singleton (the one most call sites use) -----------------

_tracer = Tracer()
_config_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _tracer


def configure(enabled: Optional[bool] = None, proc: Optional[str] = None,
              capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """(Re)build the global tracer — call once at process entry (daemons
    pass their role name so flush files are self-identifying) or from tests.
    Passing ``enabled=None`` re-reads JG_TRACE.  The process registry is
    cleared too: configure marks a fresh observation epoch (process entry,
    or test isolation)."""
    global _tracer
    with _config_lock:
        _tracer = Tracer(proc=proc or _tracer.proc, enabled=enabled,
                         capacity=capacity)
        _registry.get_registry().clear()
    return _tracer


def enabled() -> bool:
    return _tracer.enabled


def span(name: str, **args):
    return _tracer.span(name, **args)


def complete(name: str, t0_ns: int, dur_ns: int, **args) -> None:
    """Emit a span retroactively from explicit perf_counter_ns timestamps.

    The pipelined solverd tick dispatches request k, then decodes k+1 and
    encodes k-1 while the device runs — its phases no longer nest inside a
    live ``with span(...)`` block, so the tick span is stamped after the
    fact (children attribute via an explicit ``parent`` arg instead of the
    span stack)."""
    if not _tracer.enabled:
        return
    _tracer._emit(name, t0_ns, dur_ns, None, args or None)


def instant(name: str, **args) -> None:
    _tracer.instant(name, **args)


def flow(name: str, flow_id: int, phase: str = "t", **args) -> None:
    _tracer.flow(name, flow_id, phase, **args)


def count(name: str, n: int = 1) -> None:
    _tracer.count(name, n)


def gauge(name: str, value: float) -> None:
    _tracer.gauge(name, value)


def snapshot() -> dict:
    return _tracer.snapshot()


def flush(path: Optional[str] = None) -> Optional[str]:
    return _tracer.flush(path)


class disabled:
    """Context manager that forces tracing OFF inside the block — used by
    bench.py to measure the trace-on vs trace-off step-time delta."""

    def __enter__(self):
        self._was = _tracer.enabled
        _tracer.enabled = False
        return self

    def __exit__(self, *exc):
        _tracer.enabled = self._was
        return False
