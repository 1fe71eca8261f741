"""One closed-loop fleetsim rung of the live fleet, read per request.

``run`` drives ``analysis/torch_fleetsim.py`` (the C++ centralized manager
over a busd pool, the sim-agent pool, and with ``--solver tpu`` the port's
daemon, on the card unless the rung's arguments hold ``--cpu``) in this
process and reads its 30 s measurement window two ways:

- per request, from the trace spans the twin records (it sets
  ``JG_TRACE=1`` and samples every span): the manager's plan round trip,
  from the end of ``manager.plan_request_encode`` (where the manager
  publishes the request and ``manager.plan_rtt_ms`` starts its clock) to
  the start of the fresh reply's ``manager.plan_response_apply`` (where
  that histogram observes it); the daemon's tick of the same request
  (``solverd.tick``); and the round trip less that tick, which is the
  packed wire through busd both ways with the queueing on either side.
  Also the manager's planning tick (``manager.plan_tick``) and its apply.
  Percentiles are nearest-rank over the spans, in ms.
- from the first and last ``mapd.metrics`` beacon of every peer, read as
  ``analysis/torch_solver_crossover.py`` reads them: the histograms'
  counts, exact means and the buckets of their p50 and p95 (set beside
  the spans' as a check), the daemon's
  ticks over the 500 ms budget (``tick.over_budget``), fresh field sweeps
  (``solverd.field_sweeps``) and kernel launches
  (``solverd.kernel_launches``) per tick.

And the fleet: tasks/s, completion ratio, dispatched and completed in the
window, the sim pool's moves and dones, the verdicts of the ci spec and of
the rated-load spec (``obs/slo.py``'s default).

The twin's own output goes to ``fleetsim.log`` in the rung's directory as
well as to this process's.  When a rung fails, ``diagnosis`` reads that
directory: the tails of the manager's, the daemon's and the twin's logs,
the seconds from the manager's first dispatch to the window's opening, the
dispatched and completed counts, the daemon's last tick and its beacons.

``chip_smoke.py`` runs it in its ``fleetsim_1k_512`` phase, and for other
sizes with ``--fleet-rungs``.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from analysis.torch_solver_crossover import _counter, _hist_delta  # noqa: E402,E501
from p2p_distributed_tswap_tpu_torch.obs import slo  # noqa: E402

KERNELS = ("sweep_scan", "field_fused_single", "field_fused_multi")
CI_SPEC = REPO / "scripts" / "fleetsim_ci.spec.json"
# the manager's and the daemon's traces are stamped on wall-clock anchors
# of their own; a daemon tick is matched to a round trip with this slack
CLOCK_SLACK_US = 2000


def _pct(xs: list, q: float) -> float:
    """Nearest-rank percentile of a sorted list."""
    return xs[min(len(xs) - 1, max(0, int(-(-q * len(xs) // 1)) - 1))]


def summary(ms: list) -> dict:
    """Count, p50, p95, largest and mean of a list of times in ms."""
    if not ms:
        return {"count": 0}
    xs = sorted(ms)
    return {"count": len(xs), "p50_ms": round(_pct(xs, 0.5), 3),
            "p95_ms": round(_pct(xs, 0.95), 3), "max_ms": round(xs[-1], 3),
            "mean_ms": round(sum(xs) / len(xs), 3)}


def beacon_hist(first: dict, last: dict, name: str) -> dict:
    """A beacon histogram over the window: its count, exact mean, and the
    bucket (lower edge, upper edge or None past the last) that holds the
    p50 and the p95 sample; a histogram keeps no finer percentile."""
    h = _hist_delta(first, last, name)
    if not h or not h["count"]:
        return {"count": 0}
    edges = [0, *h["buckets"], None]

    def bucket(q):
        rank, seen = -(-q * h["count"] // 1), 0
        for i, c in enumerate(h["counts"]):
            seen += c
            if seen >= rank:
                return [edges[i], edges[i + 1]]

    return {"count": h["count"], "mean_ms": round(h["sum"] / h["count"], 3),
            "p50_bucket_ms": bucket(0.5), "p95_bucket_ms": bucket(0.95)}


def spans(trace_dir: Path, proc: str) -> dict:
    """name -> sorted [(start µs, duration µs)] of the complete spans in
    ``proc``'s trace files."""
    out: dict = {}
    for f in sorted(Path(trace_dir).glob(f"{proc}-*.trace.jsonl")):
        for line in f.read_text(errors="replace").splitlines():
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # a line cut short where the process ended
            if ev.get("ph") == "X":
                out.setdefault(ev["name"], []).append(
                    (ev["ts"], ev.get("dur", 0)))
    for v in out.values():
        v.sort()
    return out


def within(span_list: list, t0_us: int, t1_us: int) -> list:
    """Durations in ms of the spans that start in [t0_us, t1_us)."""
    return [d / 1000.0 for s, d in span_list if t0_us <= s < t1_us]


def round_trips(encodes: list, applies: list, ticks: list, t0_us: int,
                t1_us: int) -> list:
    """(round trip ms, daemon tick ms or None) of every fresh reply the
    manager applied in [t0_us, t1_us): from the end of the last request
    encode before the apply to the apply's start, and the last daemon tick
    inside that interval."""
    rows = []
    for a, _ in applies:
        if not t0_us <= a < t1_us:
            continue
        sent = [s + d for s, d in encodes if s + d <= a]
        if not sent:
            continue
        e = sent[-1]
        inside = [d for s, d in ticks
                  if s >= e - CLOCK_SLACK_US and s + d <= a + CLOCK_SLACK_US]
        rows.append(((a - e) / 1000.0,
                     inside[-1] / 1000.0 if inside else None))
    return rows


def _verdicts(result: dict) -> dict:
    return {v["name"]: [v["status"], v.get("observed")]
            for v in result["verdicts"]}


def _snapshots(watch, proc: str) -> tuple:
    """(first, last) beacon snapshots of the one peer of ``proc`` in the
    twin's metrics window."""
    peers = [st for st in watch._peers.values() if st.proc == proc]
    if len(peers) != 1:
        raise RuntimeError(f"{len(peers)} {proc} peers beaconed in the "
                           "fleetsim window, not one")
    return peers[0].first, peers[0].last


class _Tee:
    """A text stream that writes to two others."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self) -> None:
        for s in self.streams:
            s.flush()


def run(solver: str, fleetsim_args: list, log_dir: Path) -> dict:
    """One fleetsim twin rung with ``solver``; ``fleetsim_args`` are the
    twin's own arguments (agents, side, settle, window, ...).  Whatever
    raises after the twin has run carries the row read so far as its
    ``row`` attribute, for :func:`diagnosis`."""
    from analysis import torch_fleetsim

    watches = []

    class Watch(torch_fleetsim.MetricsWindow):
        """The twin's metrics window, which also notes on the wall clock
        (the traces' clock) when the measurement window opens, and counts
        every process's beacons, in the run and in the window."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.window_t0_us = None
            self.beacons = {"run": {}, "window": {}}
            ingest = self.agg.ingest

            def counting(d):
                if d.get("type") == "metrics_beacon":
                    proc = d.get("proc", "?")
                    for counts in self.beacons.values():
                        counts[proc] = counts.get(proc, 0) + 1
                return ingest(d)

            self.agg.ingest = counting
            watches.append(self)

        def reset_window(self) -> None:
            super().reset_window()
            self.window_t0_us = time.time_ns() // 1000
            self.beacons["window"] = {}

    shutil.rmtree(log_dir, ignore_errors=True)  # one rung's files only
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    out_json = Path(log_dir) / "fleetsim.json"
    real = torch_fleetsim.MetricsWindow
    torch_fleetsim.MetricsWindow = Watch
    t0 = time.perf_counter()
    try:
        with open(Path(log_dir) / "fleetsim.log", "w") as log, \
                contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            rc = torch_fleetsim.main(
                [*fleetsim_args, "--solver", solver, "--spec",
                 str(CI_SPEC), "--out", str(out_json), "--log-dir",
                 str(log_dir)])
    finally:
        torch_fleetsim.MetricsWindow = real
    seconds = time.perf_counter() - t0
    if not watches or watches[-1].window_t0_us is None:
        raise RuntimeError("the fleetsim twin opened no metrics window")
    watch = watches[-1]
    row = {"solver": solver, "exit": rc, "seconds": round(seconds, 1),
           "window_t0_us": watch.window_t0_us, "beacons": watch.beacons}
    try:
        return _read(solver, watch, out_json, log_dir, row)
    except Exception as e:
        e.row = row
        raise


def _read(solver: str, watch, out_json: Path, log_dir: Path,
          row: dict) -> dict:
    """The rest of the row of a rung the twin has run, read into ``row``
    reading by reading."""
    rung = json.loads(out_json.read_text())["rungs"][0]
    signals = rung["signals"]
    rated = slo.evaluate(None, signals)
    row.update({
        "map": rung["map"], "agents": rung["agents"],
        "tasks_per_s": signals.get("fleet.tasks_per_s"),
        "completion_ratio": signals.get("fleet.completion_ratio"),
        "dispatched": rung["window_tasks_dispatched"],
        "completed": rung["window_tasks_completed"],
        "window_s": rung["window_s"], "settle_s": rung["settle_s"],
        "sim": rung["sim"],
        "claim_wire_p99_ms": signals.get("sim.claim_wire_p99_ms"),
        "ci_spec": {"ok": rung["slo"]["ok"],
                    "verdicts": _verdicts(rung["slo"])},
        "rated_load": {"ok": rated["ok"], "verdicts": _verdicts(rated)}})

    trace_dirs = list(Path(log_dir).glob("*/trace"))
    if len(trace_dirs) != 1:
        raise RuntimeError(f"no trace of the rung under {log_dir}")
    trace_dir = trace_dirs[0]
    w0 = watch.window_t0_us
    w1 = w0 + int(rung["window_s"] * 1e6)
    dispatches = _dispatch_times_us(trace_dir)
    row["first_dispatch_to_window_open_s"] = _seconds(
        w0, min(dispatches, default=None))
    row["dispatched_before_window"] = sum(t < w0 for t in dispatches)
    mgr = spans(trace_dir, "manager_centralized")
    m_first, m_last = _snapshots(watch, "manager_centralized")
    row["manager"] = {
        "plan_tick_ms": summary(within(mgr.get("manager.plan_tick", []),
                                       w0, w1)),
        "beacon_tick_ms": beacon_hist(m_first, m_last, "tick_ms")}
    if solver != "tpu":
        return row
    sd = spans(trace_dir, "solverd")
    pairs = round_trips(mgr.get("manager.plan_request_encode", []),
                        mgr.get("manager.plan_response_apply", []),
                        sd.get("solverd.tick", []), w0, w1)
    row["plan_rtt_ms"] = summary([r for r, _ in pairs])
    row["plan_rtt_less_daemon_tick_ms"] = summary(
        [r - t for r, t in pairs if t is not None])
    row["round_trips_without_a_daemon_tick"] = sum(
        t is None for _, t in pairs)
    row["manager"]["apply_ms"] = summary(
        within(mgr.get("manager.plan_response_apply", []), w0, w1))
    row["manager"]["beacon_plan_rtt_ms"] = beacon_hist(
        m_first, m_last, "manager.plan_rtt_ms")

    first, last = _snapshots(watch, "solverd")
    ticks = _hist_delta(first, last, "tick_ms")
    n = max(ticks["count"] if ticks else 0, 1)

    def delta(name):
        return _counter(last, name) - _counter(first, name)

    def launches(snap, kernel):
        return (snap.get("gauges") or {}).get(
            f'solverd.kernel_launches{{kernel="{kernel}"}}', 0)

    row["daemon"] = {
        "tick_ms": summary(within(sd.get("solverd.tick", []), w0, w1)),
        "beacon_tick_ms": beacon_hist(first, last, "tick_ms"),
        "over_budget": int(delta("tick.over_budget")),
        "field_sweeps_per_tick": round(delta("solverd.field_sweeps") / n, 3),
        "launches_per_tick": {
            k: round((launches(last, k) - launches(first, k)) / n, 3)
            for k in KERNELS},
        "launches_total": {k: launches(last, k) for k in KERNELS}}
    banners = [x for log in Path(log_dir).glob("*/solverd.log")
               for x in log.read_text(errors="replace").splitlines()
               if "solverd up" in x]
    row["banner"] = banners[0] if len(banners) == 1 else None
    return row


def _tail(path: Path, n: int = 2000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError as e:
        return f"({e})"


def _dispatch_times_us(trace_dir: Path) -> list:
    """Wall-clock µs of every ``task.dispatch`` event of the manager."""
    ts = []
    for f in Path(trace_dir).glob("manager*.events.jsonl"):
        for line in f.read_text(errors="replace").splitlines():
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if ev.get("event") == "task.dispatch" and "ts_ms" in ev:
                ts.append(int(ev["ts_ms"]) * 1000)
    return ts


def _seconds(a, b):
    """``a - b`` in seconds from µs, or None where either is missing."""
    return None if a is None or b is None else round((a - b) / 1e6, 3)


def diagnosis(log_dir: Path, row=None) -> dict:
    """What a failed rung left to read under ``log_dir``: the tails of the
    manager's, the daemon's and the twin's logs; the seconds from the
    manager's first dispatch to the window's opening (negative: the
    window opened first); the window's dispatched and completed counts;
    the end of the daemon's last tick, in seconds after the window
    opened, and its ticks in all; the beacons of every process, in the
    run and in the window.
    ``row`` is what :func:`run` returned or left on its exception."""
    log_dir = Path(log_dir)
    row = row or {}
    tails = {str(f.relative_to(log_dir)): _tail(f)
             for pattern in ("manager*.log", "solverd*.log", "fleetsim.log")
             for f in sorted(log_dir.rglob(pattern))}
    w0 = row.get("window_t0_us")
    first = last_tick = None
    ticks = []
    trace_dirs = sorted(log_dir.glob("*/trace"))
    if trace_dirs:
        first = min(_dispatch_times_us(trace_dirs[0]), default=None)
        ticks = spans(trace_dirs[0], "solverd").get("solverd.tick", [])
        if ticks:
            last_tick = max(s + d for s, d in ticks)
    return {"log_tails": tails,
            "first_dispatch_to_window_open_s": _seconds(w0, first),
            "dispatched": row.get("dispatched"),
            "completed": row.get("completed"),
            "daemon_last_tick_end_after_window_open_s":
                _seconds(last_tick, w0),
            "daemon_ticks": len(ticks),
            "beacons": row.get("beacons")}
