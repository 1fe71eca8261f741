"""The program's own spans and counters in a traced window, on the host's
``perf_counter_ns`` clock, the clock of the device timeline
(``devtrace.py``).

Importing this module switches the port's tracer on
(``obs/trace.py`` ``configure(enabled=True, ...)``) for the rest of the
process.  Only the per-layer readers that read the program's spans or
counters import it, and the harness loads per-layer readers only in a
traced run (``--trace 1``), before set-up: an untraced run never imports
it, so its end-to-end metrics are measured with the tracer off, every span
the tracer's shared no-op.

Spans.  The tracer stamps its events in wall-anchored microseconds.  One
zero-length event ``tswap_bench.clock``, stamped from a ``perf_counter_ns``
reading taken here, ties the two clocks to 1 us.  After the window the
tracer's "X" events are read once through its public ``jsonl_lines`` and
kept; :func:`spans` returns those of a window as ``(name, start_ns,
end_ns, parent)``.  The ring keeps the newest ``CAPACITY`` events: a read
that finds it full may have lost older ones, and a window that opens
before the oldest event of such a read reads None (one line on standard
error says so).

Counters.  The program's counters are module integers
(``COUNTERS``).  The harness's own ``COUNTERS`` probe would read them after
the cut solve's ``finish`` too, and fails on a program that lacks one; so
they are read by ``CALLS`` probes instead (:data:`CALLS`): before the
window's first ``prepare_state`` and at every finish test
(``mapd._finished``), which the traffic kind calls after each step.  The
last reading less the first is the window's own count, and a counter the
program lacks reads None.
"""

from __future__ import annotations

import bisect
import importlib
import json
import sys
import time

from p2p_distributed_tswap_tpu_torch.obs import trace

CAPACITY = 1 << 18
CLOCK = "tswap_bench.clock"
_MAPD = "p2p_distributed_tswap_tpu_torch.solver.mapd"
COUNTERS = {
    "field_rows": f"{_MAPD}:field_rows",
    "cascade_rounds": "p2p_distributed_tswap_tpu_torch.solver.step"
                      ":cascade_rounds",
    "fixpoint_rounds": "p2p_distributed_tswap_tpu_torch.ops.distance"
                       ":fixpoint_rounds",
    "fixpoint_batches": "p2p_distributed_tswap_tpu_torch.ops.distance"
                        ":fixpoint_batches",
}


_HOMES = {name: (importlib.import_module(target.split(":")[0]),
                 target.split(":")[1]) for name, target in COUNTERS.items()}


def _counters(*args, **kw) -> dict:
    """Every program counter's value now, None for one it lacks."""
    return {name: getattr(mod, attr, None)
            for name, (mod, attr) in _HOMES.items()}


CALLS = {"progtrace.open": (f"{_MAPD}:prepare_state", _counters),
         "progtrace.close": (f"{_MAPD}:_finished", _counters)}


def counter(win, name: str):
    """The window's count of the program counter ``name``, or None."""
    opened = win.calls.get("progtrace.open")
    closed = win.calls.get("progtrace.close")
    if not opened or not closed:
        return None
    first, last = opened[0][name], closed[-1][name]
    if first is None or last is None:
        return None
    return last - first


class ProgramSpans:
    """The tracer's "X" events on the ``perf_counter_ns`` clock.  Built
    while the tracer to read is the port's current one, whose ring holds
    ``capacity`` events."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.kept: list = []     # (name, start_ns, end_ns, parent)
        self.lost_before = None  # a full ring's oldest event, in ns
        self._warned = set()
        t0 = time.perf_counter_ns()
        trace.complete(CLOCK, t0, 0)
        ring = self._drain()
        self._t0 = t0
        self._ts0 = next(e["ts"] for e in ring if e["name"] == CLOCK)
        self._take([e for e in ring if e["name"] != CLOCK])

    @staticmethod
    def _drain() -> list:
        """The ring's events, oldest first, and the ring emptied."""
        return [e for e in map(json.loads, trace.get_tracer().jsonl_lines())
                if e["ph"] not in ("M", "C")]

    def _ns(self, ts_us: int) -> int:
        return self._t0 + (ts_us - self._ts0) * 1000

    def _take(self, ring: list) -> None:
        if len(ring) >= self.capacity:
            # the ring was full: events older than its oldest may be lost
            self.lost_before = max(self.lost_before or 0,
                                   self._ns(ring[0]["ts"]))
        for e in ring:
            if e["ph"] == "X":
                start = self._ns(e["ts"])
                self.kept.append((e["name"], start, start + e["dur"] * 1000,
                                  e["args"].get("parent")))

    def window(self, lo: int, hi: int):
        """The spans that start in [lo, hi), by start; None if the ring may
        have lost some of them."""
        self._take(self._drain())
        if self.lost_before is not None and lo < self.lost_before:
            if (lo, hi) not in self._warned:
                self._warned.add((lo, hi))
                print(f"progtrace: the tracer's ring of {self.capacity} "
                      "events lost spans of the window", file=sys.stderr)
            return None
        return sorted(s for s in self.kept if lo <= s[1] < hi)


trace.configure(enabled=True, proc="tswap_bench", capacity=CAPACITY)
PROGRAM = ProgramSpans(CAPACITY)


def spans(win):
    """The program's spans of the traced window ``win``, or None."""
    return PROGRAM.window(win.trace_lo, win.trace_hi)


def span_ms_per_step(win, name: str):
    """Host ms inside the program's ``name`` spans over the window, per
    step; None where the window has no step or no such span."""
    got = spans(win)
    if not win.step_s or not got:
        return None
    ns = [e - s for n, s, e, _ in got if n == name]
    if not ns:
        return None
    return sum(ns) / 1e6 / len(win.step_s)


def ops_per_step(win, name: str):
    """Device operations of the window whose start falls inside one of the
    program's ``name`` spans, per step; None where the window has no step,
    no device trace or no such span.  Exact for a span that opens after a
    host sync and closes on one, since then no other host phase's
    operation can start inside it."""
    got = spans(win)
    if win.trace is None or not win.step_s or not got:
        return None
    inside = [(s, e) for n, s, e, _ in got if n == name]
    if not inside:
        return None
    starts = [s for s, _ in inside]
    ops = 0
    for _, s, _ in win.trace.events:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and s < inside[k][1]:
            ops += 1
    return ops / len(win.step_s)
