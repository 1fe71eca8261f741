"""The device timeline of a traced window, from ``torch.profiler``.

Only CUDA activity is recorded (kernels, copies, fills on the device): the
host side of a traced window is read from the harness's own spans
(``harness.Probes``), which cost two clock reads a call where the
profiler's CPU activity would record every operator.  The two clocks are
tied by a marker fill launched on an idle stream when the trace starts.
"""

from __future__ import annotations

import bisect
import time

import torch


class DeviceTrace:
    """Start before the window, stop after it; then ``events`` holds every
    device operation as (name, start_ns, end_ns) on the host's
    ``perf_counter_ns`` clock, sorted by start."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: list = []
        self._prof = None
        self._host0 = 0
        self._marker = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._marker = torch.empty(1, dtype=torch.int8, device=self.device)
        self._host0 = time.perf_counter_ns()
        self._marker.fill_(7)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        self._prof.stop()
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start, dur = _times_ns(e)
            raw.append((e.name(), start, start + dur))
        self._prof = None
        raw.sort(key=lambda ev: ev[1])
        # the marker is the first device operation; its start is the host
        # stamp taken just before its launch on an idle stream
        offset = self._host0 - raw[0][1] if raw else 0
        self.events = [(n, s + offset, e + offset) for n, s, e in raw[1:]]


def _times_ns(e) -> tuple:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return e.start_us() * 1000, e.duration_us() * 1000


def busy_ns(events: list, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some device operation ran."""
    total, end = 0, lo
    for _, s, e in events:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, namespaces and parameter
    list: its template arguments still tell one elementwise kernel from
    another."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(noise, "")
    return name.split("(", 1)[0][:limit]


def device_ops(events: list, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by = {}
    for n, s, e in events:
        by[n] = by.get(n, 0) + (e - s)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[short_name(n), ns / 1e9] for n, ns in rows]


def idle_gaps(events: list, lo: int, hi: int, spans: list,
              top: int = 10) -> list:
    """[label, seconds] of the idle time between device operations in
    [lo, hi), summed by what the host was doing at each gap's middle: the
    label of the host span around it (``spans``: (start_ns, end_ns, label),
    none nested), or ``other``; the labels with the most idle time
    first."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    by = {}
    end = lo
    for _, s, e in events + [("", hi, hi)]:
        s = min(s, hi)
        if s > end:
            mid = (s + end) // 2
            k = bisect.bisect_right(starts, mid) - 1
            label = (spans[k][2] if k >= 0 and spans[k][1] > mid
                     else "other")
            by[label] = by.get(label, 0) + (s - end)
        end = max(end, e)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[n, ns / 1e9] for n, ns in rows]
