"""Flight recorder: an always-on black box of the last N structured events.

Every process keeps a fixed-size, lock-light ring of the most recent
structured lifecycle events (obs/events.py feeds it; the C++ mirror is
cpp/common/flightrec.hpp).  Unlike span tracing — opt-in, high-volume,
flushed on a cadence — the flight ring is ALWAYS recording and costs one
deque append under a lock per event, so when a process crashes, wedges, or
an e2e run fails, the fleet's last seconds are reconstructable even though
nobody asked for a trace beforehand (exactly the aviation black-box
contract; ``analysis/blackbox.py`` prints the merged fleet view).

Dump triggers:
- SIGUSR2 (``install()`` wires the handler; SIGUSR1 stays the stats dump);
- process exit (atexit) and unhandled exceptions (sys.excepthook chain);
- a bus ``flight_dump`` request (each daemon's message loop calls
  :func:`dump` and answers with the path);
- an e2e test failure (the pytest fixture collects the dumped files).

Dumps land in ``$JG_FLIGHT_DIR`` (the fleet runner points this at its
per-run log dir) or, unset, next to the trace files (``JG_TRACE_DIR``,
default ``results/trace``), as ``<proc>-<pid>.flight.jsonl`` — one event
object per line, newest last, plus a leading meta line.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import sys
import threading
import time
from typing import Optional

DEFAULT_CAPACITY = 4096


def flight_dir() -> str:
    d = os.environ.get("JG_FLIGHT_DIR", "")
    if d:
        return d
    return os.environ.get("JG_TRACE_DIR", "results/trace")


class FlightRecorder:
    """Bounded ring of structured events; thread-safe, always on."""

    def __init__(self, proc: str = "py", capacity: int = DEFAULT_CAPACITY):
        self.proc = proc
        self.pid = os.getpid()
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self.dumps = 0

    def record(self, event: dict) -> None:
        with self._lock:
            self._ring.append(event)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def tail(self, n: Optional[int] = None) -> list:
        with self._lock:
            evs = list(self._ring)
        return evs if n is None else evs[-n:]

    def default_path(self) -> str:
        return os.path.join(flight_dir(),
                            f"{self.proc}-{self.pid}.flight.jsonl")

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> Optional[str]:
        """Write the ring (oldest first) as JSONL; returns the path, or
        None when the write failed — a black box must never take the
        process down with it."""
        path = path or self.default_path()
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            evs = self.tail()
            with open(path, "w") as f:
                f.write(json.dumps({
                    "meta": "flight", "proc": self.proc, "pid": self.pid,
                    "reason": reason, "events": len(evs),
                    "dumped_ms": time.time_ns() // 1_000_000}) + "\n")
                for ev in evs:
                    f.write(json.dumps(ev) + "\n")
            self.dumps += 1
            return path
        except OSError:
            return None


_recorder = FlightRecorder()
_installed = False


def get_recorder() -> FlightRecorder:
    return _recorder


def record(event: dict) -> None:
    _recorder.record(event)


def dump(path: Optional[str] = None, reason: str = "manual"
         ) -> Optional[str]:
    return _recorder.dump(path, reason)


def configure(proc: str, capacity: int = DEFAULT_CAPACITY
              ) -> FlightRecorder:
    """Rebuild the process recorder under its role name (call at process
    entry, like trace.configure)."""
    global _recorder
    _recorder = FlightRecorder(proc=proc, capacity=capacity)
    return _recorder


def install(proc: Optional[str] = None) -> FlightRecorder:
    """Arm the dump triggers for a daemon process: SIGUSR2, process exit,
    and unhandled exceptions.  Idempotent per process; safe to call from
    non-main threads only for the atexit part (signal handlers require the
    main thread, so those are skipped there)."""
    global _installed
    if proc:
        configure(proc)
    if _installed:
        return _recorder
    _installed = True
    atexit.register(lambda: _recorder.dump(reason="exit"))

    prev_hook = sys.excepthook

    def hook(tp, val, tb):
        _recorder.record({"ts_ms": time.time_ns() // 1_000_000,
                          "proc": _recorder.proc, "pid": _recorder.pid,
                          "event": "crash.exception",
                          "error": f"{tp.__name__}: {val}"})
        _recorder.dump(reason="exception")
        prev_hook(tp, val, tb)

    sys.excepthook = hook
    if threading.current_thread() is threading.main_thread():
        try:
            signal.signal(
                signal.SIGUSR2,
                lambda *_: _recorder.dump(reason="sigusr2"))
        except (ValueError, OSError):
            pass  # embedded interpreters without signal support
    return _recorder
