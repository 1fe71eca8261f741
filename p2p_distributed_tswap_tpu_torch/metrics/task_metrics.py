"""Metrics subsystem: task lifecycle, path computation, network counters.

Behavior and CSV-schema parity with the reference's strongest subsystem
(src/map/task_metrics.rs, SURVEY C11):

- ``TaskMetric``: sent -> received -> started -> completed lifecycle with
  Unix-ms timestamps and derived total / processing / startup-latency times
  (task_metrics.rs:6-62).
- ``TaskMetricsCollector``: add/update/statistics and the exact CSV header
  ``task_id,peer_id,sent_time_ms,received_time_ms,start_time_ms,
  completion_time_ms,total_time_ms,processing_time_ms,startup_latency_ms,
  status`` (task_metrics.rs:179-182) — the reference's offline analysis
  scripts (analyze_metrics.py) consume our CSVs unchanged.
- ``PathComputationMetrics``: microsecond samples with
  ``sample_index,duration_micros,duration_millis`` CSV (task_metrics.rs:332-339),
  consumed unchanged by compare_path_metrics.py.
- ``NetworkMetrics``: message/byte counters with rate and kbps derivations
  (task_metrics.rs:382-476).

The C++ host runtime (cpp/) writes the same schemas natively; this module is
the Python-side implementation for the solver daemon and offline harnesses,
and the executable schema contract the tests pin down.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional


def now_ms() -> int:
    return int(time.time() * 1000)


class TaskStatus(enum.Enum):
    PENDING = "pending"
    SENT = "sent"
    RECEIVED = "received"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclasses.dataclass
class TaskMetric:
    task_id: int
    peer_id: str
    sent_time: int = dataclasses.field(default_factory=now_ms)
    received_time: Optional[int] = None
    start_time: Optional[int] = None
    completion_time: Optional[int] = None
    status: TaskStatus = TaskStatus.SENT

    # Derivations subtract timestamps STAMPED BY DIFFERENT PEERS (sent by
    # the manager, started/completed by the agent, each on its own wall
    # clock) and are clamped to >= 0: peer clock skew beyond the message
    # latency otherwise yields negative latencies that poison averages and
    # flip CSV consumers' sorts.  Skew occurrences are counted by the
    # collector (clock_skew_events) at update time so the clamp is never
    # silent.
    def get_total_time(self) -> Optional[int]:
        if self.completion_time is None:
            return None
        return max(0, self.completion_time - self.sent_time)

    def get_agent_processing_time(self) -> Optional[int]:
        if self.start_time is None or self.completion_time is None:
            return None
        return max(0, self.completion_time - self.start_time)

    def get_startup_latency(self) -> Optional[int]:
        if self.start_time is None:
            return None
        return max(0, self.start_time - self.sent_time)


@dataclasses.dataclass
class TaskStatistics:
    total_tasks: int
    completed_tasks: int
    failed_tasks: int
    avg_total_time: int
    avg_processing_time: int
    avg_startup_latency: int
    min_total_time: int
    max_total_time: int
    min_processing_time: int
    max_processing_time: int

    def __str__(self) -> str:  # display parity: task_metrics.rs:246-273
        rate = (100.0 * self.completed_tasks / self.total_tasks
                if self.total_tasks else 0.0)
        return (
            "\U0001F4CA Task Statistics:\n"
            f"├─ Total Tasks: {self.total_tasks}\n"
            f"├─ Completed: {self.completed_tasks} "
            f"(Success Rate: {rate:.1f}%)\n"
            f"├─ Failed: {self.failed_tasks}\n"
            f"├─ Avg Total Time: {self.avg_total_time} ms\n"
            f"├─ Avg Processing Time: {self.avg_processing_time} ms\n"
            f"├─ Avg Startup Latency: {self.avg_startup_latency} ms\n"
            f"├─ Min/Max Total Time: {self.min_total_time} ms / "
            f"{self.max_total_time} ms\n"
            f"└─ Min/Max Processing Time: {self.min_processing_time}"
            f" ms / {self.max_processing_time} ms")


class TaskMetricsCollector:
    """Task-metric sink (task_metrics.rs:65-227)."""

    CSV_HEADER = ("task_id,peer_id,sent_time_ms,received_time_ms,"
                  "start_time_ms,completion_time_ms,total_time_ms,"
                  "processing_time_ms,startup_latency_ms,status")

    def __init__(self):
        self.metrics: Dict[int, TaskMetric] = {}
        # NetworkMetrics-style counters: how often a peer-stamped timestamp
        # landed BEFORE its predecessor (wall clocks disagree); the
        # TaskMetric derivations clamp, these keep the evidence
        self.clock_skew_events = 0
        self.clock_skew_worst_ms = 0

    def _note_skew(self, earlier: Optional[int], later: int) -> None:
        if earlier is not None and later < earlier:
            self.clock_skew_events += 1
            self.clock_skew_worst_ms = max(self.clock_skew_worst_ms,
                                           earlier - later)

    def add_metric(self, metric: TaskMetric) -> None:
        self.metrics[metric.task_id] = metric

    def update_received(self, task_id: int, at_ms: Optional[int] = None) -> None:
        m = self.metrics.get(task_id)
        if m is not None:
            m.received_time = now_ms() if at_ms is None else at_ms
            self._note_skew(m.sent_time, m.received_time)
            m.status = TaskStatus.RECEIVED

    def update_started(self, task_id: int, at_ms: Optional[int] = None) -> None:
        m = self.metrics.get(task_id)
        if m is not None:
            m.start_time = now_ms() if at_ms is None else at_ms
            self._note_skew(m.sent_time, m.start_time)
            m.status = TaskStatus.RUNNING

    def update_completed(self, task_id: int, at_ms: Optional[int] = None) -> None:
        m = self.metrics.get(task_id)
        if m is not None:
            m.completion_time = now_ms() if at_ms is None else at_ms
            self._note_skew(m.start_time if m.start_time is not None
                            else m.sent_time, m.completion_time)
            m.status = TaskStatus.COMPLETED

    def update_failed(self, task_id: int) -> None:
        m = self.metrics.get(task_id)
        if m is not None:
            m.status = TaskStatus.FAILED

    def get_statistics(self) -> TaskStatistics:
        completed = [m for m in self.metrics.values()
                     if m.status == TaskStatus.COMPLETED]
        totals = [t for t in (m.get_total_time() for m in completed)
                  if t is not None]
        procs = [t for t in (m.get_agent_processing_time() for m in completed)
                 if t is not None]
        starts = [t for t in (m.get_startup_latency() for m in completed)
                  if t is not None]
        # integer division like the reference (u64 sums / len)
        return TaskStatistics(
            total_tasks=len(self.metrics),
            completed_tasks=len(completed),
            failed_tasks=sum(1 for m in self.metrics.values()
                             if m.status == TaskStatus.FAILED),
            avg_total_time=sum(totals) // len(totals) if totals else 0,
            avg_processing_time=sum(procs) // len(procs) if procs else 0,
            avg_startup_latency=sum(starts) // len(starts) if starts else 0,
            min_total_time=min(totals, default=0),
            max_total_time=max(totals, default=0),
            min_processing_time=min(procs, default=0),
            max_processing_time=max(procs, default=0))

    def to_csv_string(self) -> str:
        """Exact schema of task_metrics.rs:179-227: missing timestamps render
        as 0, missing derived times as empty strings."""
        lines = [self.CSV_HEADER]
        for m in sorted(self.metrics.values(), key=lambda m: m.task_id):
            def opt(v):
                return "" if v is None else str(v)
            lines.append(
                f"{m.task_id},{m.peer_id},{m.sent_time},"
                f"{m.received_time or 0},{m.start_time or 0},"
                f"{m.completion_time or 0},{opt(m.get_total_time())},"
                f"{opt(m.get_agent_processing_time())},"
                f"{opt(m.get_startup_latency())},{m.status.value}")
        return "\n".join(lines) + "\n"


@dataclasses.dataclass
class PathComputationStatistics:
    samples: int
    avg_micros: float
    min_micros: int
    max_micros: int

    def avg_millis(self) -> float:
        return self.avg_micros / 1000.0

    def min_millis(self) -> float:
        return self.min_micros / 1000.0

    def max_millis(self) -> float:
        return self.max_micros / 1000.0

    def __str__(self) -> str:
        return ("⏱️ Path Computation Stats:\n"
                f"├─ Samples: {self.samples}\n"
                f"├─ Avg: {self.avg_millis():.3f} ms\n"
                f"├─ Min: {self.min_millis():.3f} ms\n"
                f"└─ Max: {self.max_millis():.3f} ms")


class PathComputationMetrics:
    """Per-decision / per-planning-step wall-clock samples in microseconds
    (task_metrics.rs:277-340)."""

    def __init__(self):
        self.samples: List[int] = []
        self.timestamps_ms: List[Optional[int]] = []

    def clear(self) -> None:
        self.samples.clear()
        self.timestamps_ms.clear()

    def record_duration(self, seconds: float,
                        timestamp_ms: Optional[int] = None) -> None:
        self.record_micros(int(seconds * 1e6), timestamp_ms)

    def record_micros(self, micros: int,
                      timestamp_ms: Optional[int] = None) -> None:
        """``timestamp_ms`` is the optional wall-clock stamp the decentralized
        wire protocol carries in path_metric messages
        (src/bin/decentralized/agent.rs:302-308); compare_path_metrics.py
        groups decentralized samples into 100 ms buckets by it (:48-52)."""
        self.samples.append(int(micros))
        self.timestamps_ms.append(timestamp_ms)

    def __len__(self) -> int:
        return len(self.samples)

    def is_empty(self) -> bool:
        return not self.samples

    def get_statistics(self) -> Optional[PathComputationStatistics]:
        if not self.samples:
            return None
        s = sorted(self.samples)
        return PathComputationStatistics(
            samples=len(s), avg_micros=sum(s) / len(s),
            min_micros=s[0], max_micros=s[-1])

    def to_csv_string(self) -> str:
        """Reference schema (task_metrics.rs:332-339); when wall-clock stamps
        were recorded a trailing ``timestamp_ms`` column is appended (used by
        compare_path_metrics.py's per-step bucketing)."""
        with_ts = any(t is not None for t in self.timestamps_ms)
        header = "sample_index,duration_micros,duration_millis"
        lines = [header + ",timestamp_ms" if with_ts else header]
        for i, us in enumerate(self.samples):
            row = f"{i},{us},{us / 1000.0:.3f}"
            if with_ts:
                ts = self.timestamps_ms[i]
                # unstamped samples render empty (pandas NaN, dropped by the
                # bucketing groupby) rather than as epoch-0 rows
                row += f",{'' if ts is None else ts}"
            lines.append(row)
        return "\n".join(lines) + "\n"


class NetworkMetrics:
    """Message/byte counters with rates (task_metrics.rs:382-476)."""

    def __init__(self):
        self.messages_sent = 0
        self.messages_received = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self._start = time.monotonic()

    def record_sent(self, nbytes: int) -> None:
        self.messages_sent += 1
        self.bytes_sent += nbytes

    def record_received(self, nbytes: int) -> None:
        self.messages_received += 1
        self.bytes_received += nbytes

    def get_elapsed_secs(self) -> float:
        return time.monotonic() - self._start

    def get_send_rate(self) -> float:
        e = self.get_elapsed_secs()
        return self.messages_sent / e if e > 0 else 0.0

    def get_recv_rate(self) -> float:
        e = self.get_elapsed_secs()
        return self.messages_received / e if e > 0 else 0.0

    def get_bandwidth_sent_kbps(self) -> float:
        e = self.get_elapsed_secs()
        return (self.bytes_sent * 8.0) / (e * 1000.0) if e > 0 else 0.0

    def get_bandwidth_recv_kbps(self) -> float:
        e = self.get_elapsed_secs()
        return (self.bytes_received * 8.0) / (e * 1000.0) if e > 0 else 0.0

    def __str__(self) -> str:
        return (
            "\U0001F4E1 Network Communication Stats:\n"
            f"├─ Messages sent: {self.messages_sent} "
            f"({self.get_send_rate():.1f} msg/s)\n"
            f"├─ Messages received: {self.messages_received} "
            f"({self.get_recv_rate():.1f} msg/s)\n"
            f"├─ Bandwidth sent: {self.bytes_sent / 1024.0:.2f} KB "
            f"({self.get_bandwidth_sent_kbps():.1f} kbps)\n"
            f"├─ Bandwidth received: "
            f"{self.bytes_received / 1024.0:.2f} KB "
            f"({self.get_bandwidth_recv_kbps():.1f} kbps)\n"
            f"└─ Duration: {self.get_elapsed_secs():.1f}s")
