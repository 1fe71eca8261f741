"""Per-tick heartbeat: one JSON line per planning tick to a sidecar file.

The trace ring answers "where did the time go inside a tick"; the heartbeat
answers "is the daemon keeping its 500 ms budget RIGHT NOW" — a line a
human can ``tail -f`` and a harness can parse without replaying a trace.
Schema (all times ms):

    {"tick": N, "seq": S, "ts_ms": unix_ms, "agents": A,
     "ms": {"decode": .., "field_sweep": .., "step_dispatch": ..,
            "device_sync": .., "encode": .., "total": ..},
     "counters": {...tracer counters snapshot...},
     "budget_ms": 500.0, "over_budget": false}

Writers are cheap enough to leave on whenever tracing is on: one dict, one
``json.dumps``, one buffered write per tick.  The file is line-buffered so
``tail -f`` sees ticks as they land.

The LIVE budget accounting (tick_ms histogram, tick.over_budget counter)
lives in the unified registry (obs/registry.py), written by
``TickRunner.handle`` whether or not a heartbeat file is open — this
writer's instance counters only feed the sidecar lines and the stats dump's
``over_budget_ticks`` convenience field.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

# the centralized manager's planning tick (cpp manager --planning-interval-ms
# default, ref manager.rs:567): the budget every heartbeat is judged against
TICK_BUDGET_MS = 500.0


class HeartbeatWriter:
    def __init__(self, path: str, budget_ms: float = TICK_BUDGET_MS):
        self.path = path
        self.budget_ms = budget_ms
        self.ticks = 0
        self.over_budget_ticks = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1)  # line-buffered: tail -f

    def beat(self, seq, agents: int, phase_ms: dict,
             counters: Optional[dict] = None) -> dict:
        total = phase_ms.get("total")
        if total is None:
            total = sum(phase_ms.values())
        over = total > self.budget_ms
        self.ticks += 1
        if over:
            self.over_budget_ticks += 1
        line = {"tick": self.ticks, "seq": seq,
                "ts_ms": time.time_ns() // 1_000_000, "agents": agents,
                "ms": {k: round(v, 3) for k, v in phase_ms.items()},
                "counters": counters or {},
                "budget_ms": self.budget_ms, "over_budget": over}
        self._f.write(json.dumps(line) + "\n")
        return line

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
