"""``analysis/torch_live_fleet.py``'s readings: the beacon histograms'
window counts, exact means and percentile buckets, the trace spans of one process, the
nearest-rank summary of span times, and the pairing of each fresh reply
the manager applied with its request and the daemon's tick."""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_live_fleet", ROOT / "analysis" / "torch_live_fleet.py")
live = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(live)

EDGES = [1, 2, 5, 10, 20, 50]


def _snap(counts, total):
    return {"hists": {"tick_ms": {"buckets": EDGES, "counts": counts,
                                  "sum": total, "count": sum(counts)}}}


def test_window_is_the_difference_of_two_snapshots():
    first = _snap([1, 0, 2, 0, 0, 0, 0], 8.0)
    last = _snap([1, 0, 6, 3, 1, 0, 0], 80.0)
    # the window: 4 samples in (2, 5], 3 in (5, 10], 1 in (10, 20]
    assert live.beacon_hist(first, last, "tick_ms") == {
        "count": 8, "mean_ms": 9.0, "p50_bucket_ms": [2, 5],
        "p95_bucket_ms": [10, 20]}
    assert live.beacon_hist(first, last, "other") == {"count": 0}
    assert live.beacon_hist(last, last, "tick_ms") == {"count": 0}
    # a histogram first seen in the last snapshot counts whole; past the
    # last edge a bucket has no upper edge
    whole = live.beacon_hist({}, last, "tick_ms")
    assert (whole["count"], whole["mean_ms"]) == (11, 7.273)
    assert whole["p50_bucket_ms"] == [2, 5]
    past = _snap([0, 0, 0, 0, 0, 0, 2], 150.0)
    assert live.beacon_hist({}, past, "tick_ms")["p95_bucket_ms"] == [
        50, None]
    first_bucket = _snap([3, 0, 0, 0, 0, 0, 0], 1.5)
    assert live.beacon_hist({}, first_bucket, "tick_ms")[
        "p50_bucket_ms"] == [0, 1]


def test_summary_of_a_window():
    s = live.summary([30.0, 10.0, 20.0, 40.0])
    assert s == {"count": 4, "p50_ms": 20.0, "p95_ms": 40.0,
                 "max_ms": 40.0, "mean_ms": 25.0}
    many = live.summary([float(x) for x in range(1, 101)])
    assert (many["p50_ms"], many["p95_ms"]) == (50.0, 95.0)
    assert live.summary([7.5]) == {"count": 1, "p50_ms": 7.5, "p95_ms": 7.5,
                                   "max_ms": 7.5, "mean_ms": 7.5}
    assert live.summary([]) == {"count": 0}


def test_spans_of_one_process(tmp_path):
    events = [{"name": "process_name", "ph": "M", "pid": 1},
              {"name": "solverd.tick", "ph": "X", "ts": 300, "dur": 20},
              {"name": "solverd.tick", "ph": "X", "ts": 100, "dur": 10},
              {"name": "solverd.field_sweeps", "ph": "C", "ts": 50}]
    (tmp_path / "solverd-1.trace.jsonl").write_text(
        "\n".join(map(json.dumps, events)) + '\n{"name": "solverd.ti')
    (tmp_path / "manager_centralized-2.trace.jsonl").write_text(
        json.dumps({"name": "manager.plan_tick", "ph": "X", "ts": 5,
                    "dur": 1}) + "\n")
    got = live.spans(tmp_path, "solverd")
    assert got == {"solverd.tick": [(100, 10), (300, 20)]}
    assert live.within(got["solverd.tick"], 100, 300) == [0.01]


def test_round_trips_pair_each_apply_with_its_request_and_tick():
    # requests published (encode ends) at 1 000, 251 000 and 501 000 µs;
    # the second request's reply came stale (no apply); the daemon's
    # first tick starts 500 µs before the request's publish on its clock
    encodes = [(900, 100), (250_900, 100), (500_900, 100)]
    applies = [(31_000, 4_000), (529_000, 3_000)]
    ticks = [(500, 18_000), (251_500, 21_000), (505_000, 20_000)]
    got = live.round_trips(encodes, applies, ticks, 0, 600_000)
    assert got == [(30.0, 18.0), (28.0, 20.0)]
    # the window holds only the applies that start in it
    assert live.round_trips(encodes, applies, ticks, 100_000, 600_000) \
        == [(28.0, 20.0)]
    # a round trip with no daemon tick inside it keeps None
    assert live.round_trips(encodes, applies, [], 0, 600_000) == [
        (30.0, None), (28.0, None)]


def test_dispatch_times_of_every_manager_file(tmp_path):
    """Every ``task.dispatch`` of every manager's event file, in µs; other
    events, other processes' files and torn lines are skipped.  Each rung
    row sets the first of them against the window's opening."""
    lines = [{"ts_ms": 5_000, "event": "task.dispatch"},
             {"ts_ms": 4_000, "event": "task.queue"},
             {"event": "task.dispatch"}]
    (tmp_path / "manager_centralized-1.events.jsonl").write_text(
        "\n".join(map(json.dumps, lines)) + "\n{torn")
    (tmp_path / "manager_centralized-2.events.jsonl").write_text(
        json.dumps({"ts_ms": 3_000, "event": "task.dispatch"}) + "\n")
    (tmp_path / "simfleet-3.events.jsonl").write_text(
        json.dumps({"ts_ms": 1_000, "event": "task.dispatch"}) + "\n")
    times = live._dispatch_times_us(tmp_path)
    assert sorted(times) == [3_000_000, 5_000_000]
    assert live._seconds(4_500_000, min(times)) == 1.5
    assert live._seconds(4_500_000, None) is None
    assert live._dispatch_times_us(tmp_path / "none") == []
