"""Structured task-lifecycle events with cross-process causal context.

The span tracer (obs/trace.py) answers "where does THIS process spend its
time"; this module answers the fleet question — *where does a task's
latency go* — by emitting one structured event per lifecycle hop (dispatch,
claim, pickup, delivery, done, done-ack, swap legs, plan frames), each
carrying the trace context that rode the triggering message:

- ``trace_id``: rooted at task creation (manager: run-epoch << 32 | task
  id) or at a plan chain; the same id appears in every process the task
  touches, so ``analysis/task_timeline.py`` can reconstruct the causal
  timeline from merged per-process event logs;
- ``hop``: a monotone wire-crossing counter (each SEND increments it), the
  happens-before order when wall clocks disagree;
- ``send_ms``: the sender's wall clock at publish time — the receive side
  derives a clock-skew-clamped one-way latency histogram per edge
  (``hop_latency_ms{edge=...}``, the same clamp discipline as the PR-1
  task-metric derivations; raw negatives count ``hop.clock_skew_events``).

Event sinks, in cost order:

1. the flight-recorder ring (obs/flightrec.py) — ALWAYS on;
2. hop-latency registry histograms — always on when a ``send_ms`` rode in;
3. with ``JG_TRACE=1`` and the trace_id sampled in: a write-through line in
   ``$JG_TRACE_DIR/<proc>-<pid>.events.jsonl`` (task-lifecycle rates are a
   few events per task, so per-event appends are noise) plus a Perfetto
   *flow* event in the span tracer, so ``trace_report.py --perfetto``
   renders cross-process arrows along each task's journey.

Wire format (JSON messages): ``"tc": [trace_id, hop, send_ms]``.  The
packed codecs carry the same triple natively (plan_codec trace1 blocks).

Environment:
  JG_TRACE_CTX=0        kill switch — no context goes on the wire (bytes
                        identical to the pre-trace1 format) and
                        trace-correlated events are suppressed on BOTH
                        send and receive sides (no registry hop
                        latencies, no event files, no flows).  Context-
                        free events (bus membership, crashes) still
                        reach the flight ring — the black box stays on.
  JG_TRACE_SAMPLE=F     fraction of trace_ids that emit event-log/flow
                        records (default 1.0).  Sampling is DETERMINISTIC
                        on trace_id (mod-997 residue, mirrored in
                        cpp/common/events.hpp) so a task's whole timeline
                        is either fully sampled or fully skipped — a
                        partially sampled timeline would read as gaps.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

from p2p_distributed_tswap_tpu_torch.obs import flightrec
from p2p_distributed_tswap_tpu_torch.obs import registry as _reg
from p2p_distributed_tswap_tpu_torch.obs import trace as _trace

SAMPLE_MOD = 997  # prime: sequential task ids cycle all residues uniformly

# clamp ceiling for one-way latency: beyond this the pair of stamps is
# evidence of clock trouble, not a real wire delay
HOP_CLAMP_MAX_MS = 60_000.0


def ctx_enabled() -> bool:
    return os.environ.get("JG_TRACE_CTX", "1") not in ("0", "false", "")


def sample_rate() -> float:
    try:
        return float(os.environ.get("JG_TRACE_SAMPLE", "1.0"))
    except ValueError:
        return 1.0


def sampled(trace_id: int) -> bool:
    """Deterministic per-trace sampling decision (mirrored byte-for-byte by
    cpp/common/events.hpp: same modulus, same threshold rounding)."""
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (int(trace_id) % SAMPLE_MOD) < int(rate * SAMPLE_MOD)


def now_ms() -> int:
    return time.time_ns() // 1_000_000


def make_tc(trace_id: int, hop: int,
            send_ms: Optional[int] = None) -> List[int]:
    """The JSON-wire trace context: ``[trace_id, hop, send_ms]``."""
    return [int(trace_id), int(hop),
            now_ms() if send_ms is None else int(send_ms)]


def parse_tc(msg: dict) -> Optional[Tuple[int, int, int]]:
    """``(trace_id, hop, send_ms)`` from a message's ``tc`` field, or None
    (absent/malformed — legacy peers simply don't carry it)."""
    tc = msg.get("tc")
    if not isinstance(tc, (list, tuple)) or len(tc) != 3:
        return None
    try:
        return int(tc[0]), int(tc[1]), int(tc[2])
    except (TypeError, ValueError):
        return None


def hop_latency_ms(send_ms: int, recv_ms: Optional[int] = None,
                   edge: str = "") -> float:
    """Clock-skew-clamped one-way latency, recorded into the registry
    (``hop_latency_ms{edge=...}``); raw negatives count
    ``hop.clock_skew_events`` so the clamp is never silent."""
    recv = now_ms() if recv_ms is None else recv_ms
    raw = float(recv - send_ms)
    if raw < 0:
        _reg.count("hop.clock_skew_events")
        _reg.gauge("hop.clock_skew_worst_ms",
                   max(-raw, _reg.get_registry().gauge_value(
                       "hop.clock_skew_worst_ms", 0.0)))
    lat = min(max(raw, 0.0), HOP_CLAMP_MAX_MS)
    if edge:
        _reg.observe("hop_latency_ms", lat, edge=edge)
    return lat


class EventLog:
    """Per-process lifecycle-event emitter (see module docstring)."""

    def __init__(self, proc: str = "py"):
        self.proc = proc
        self.pid = os.getpid()
        self._file = None
        self._file_path = None
        self.emitted = 0

    def _events_path(self) -> str:
        return os.path.join(_trace.trace_dir(),
                            f"{self.proc}-{self.pid}.events.jsonl")

    def _write_line(self, line: str) -> None:
        path = self._events_path()
        if self._file is None or self._file_path != path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = open(path, "a")
            self._file_path = path
        self._file.write(line + "\n")
        self._file.flush()

    def emit(self, event: str, trace_id: Optional[int] = None,
             hop: Optional[int] = None, task_id: Optional[int] = None,
             send_ms: Optional[int] = None, peer: Optional[str] = None,
             **extra) -> None:
        """One lifecycle event.  ``send_ms`` is the TRIGGERING message's
        sender stamp (present exactly when this event is the receive side
        of a wire hop).  The JG_TRACE_CTX kill switch suppresses
        trace-correlated events entirely (see module docstring)."""
        if trace_id is not None and not ctx_enabled():
            return
        ts = now_ms()
        ev = {"ts_ms": ts, "proc": self.proc, "pid": self.pid,
              "event": event}
        if trace_id is not None:
            ev["trace_id"] = int(trace_id)
        if hop is not None:
            ev["hop"] = int(hop)
        if task_id is not None:
            ev["task_id"] = int(task_id)
        if peer is not None:
            ev["peer"] = peer
        if send_ms is not None:
            ev["send_ms"] = int(send_ms)
            ev["wire_ms"] = round(hop_latency_ms(send_ms, ts, edge=event), 3)
        if extra:
            ev.update(extra)
        flightrec.record(ev)
        self.emitted += 1
        _reg.count("events.emitted", event=event)
        if trace_id is None or not _trace.enabled() \
                or not sampled(trace_id):
            return
        try:
            self._write_line(json.dumps(ev))
        except OSError:
            _reg.count("events.write_errors")
        # Perfetto flow event: constant name/cat, id = trace_id — the JSON
        # importer links s/t/f steps of one id into cross-process arrows
        phase = "t"
        if event == "task.dispatch" and (hop is None or hop <= 1):
            phase = "s"
        elif event.endswith("done_ack"):
            phase = "f"
        _trace.flow("task", trace_id, phase, step=event)

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None


_log = EventLog()


def get_log() -> EventLog:
    return _log


def configure(proc: str) -> EventLog:
    """Rebuild the process event log under its role name (process entry /
    test isolation), alongside flightrec.configure / trace.configure."""
    global _log
    _log.close()
    _log = EventLog(proc=proc)
    return _log


def emit(event: str, **kw) -> None:
    _log.emit(event, **kw)
