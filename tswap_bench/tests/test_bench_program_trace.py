"""The readers of the program's own spans and counters
(``tswap_bench/progtrace.py`` and the metrics that read it), on the CPU:
their arithmetic on synthetic windows, the clock tie on a real small
solve, the counters read through the harness's own probes over a real
window, and the ring's lost events.

Importing ``progtrace`` switches the port's tracer on and clears the obs
registry, so it is imported only through the ``progtrace`` fixture, which
puts the session's tracer and registry back after this module."""

import time

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL
from tswap_bench import harness
from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.obs import registry, trace
from p2p_distributed_tswap_tpu_torch.ops import distance
from p2p_distributed_tswap_tpu_torch.solver import mapd, step

MS = 1_000_000
SPAN_READERS = ("assign_ms_per_step", "swap_ms_per_step",
                "cascade_ms_per_step", "transitions_ms_per_step",
                "record_ms_per_step", "prime_ms_per_step",
                "tswap_ops_per_step", "replan_ops_per_step")
COUNTER_READERS = ("cascade_rounds_per_step", "fixpoint_rounds_per_batch",
                   "field_rows_per_step")


def reader(name):
    return harness.load_module(ROOT / "tswap_bench" / "metrics"
                               / f"{name}.py")


@pytest.fixture(scope="module")
def progtrace():
    """``tswap_bench.progtrace``, imported with the tracer and the registry
    that its import replaces put back afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "_tracer", trace.get_tracer())
        mp.setattr(registry, "_registry", registry.Registry())
        from tswap_bench import progtrace
        yield progtrace


@pytest.fixture
def program(monkeypatch, progtrace):
    """A tracer of its own, switched on, and the spans read from it."""
    def make(capacity=1 << 12):
        monkeypatch.setattr(trace, "_tracer",
                            trace.Tracer(enabled=True, capacity=capacity))
        prog = progtrace.ProgramSpans(capacity)
        monkeypatch.setattr(progtrace, "PROGRAM", prog)
        return prog
    return make


class _Trace:
    def __init__(self, events):
        self.events = events


def test_span_readers_on_a_synthetic_window(program):
    program()
    base = time.perf_counter_ns()
    lo, hi = base + 10 * MS, base + 110 * MS
    trace.complete("mapd.assign", base, 5 * MS)     # before the window
    trace.complete("mapd.prime", lo + MS // 2, 3 * MS)  # solve's prepare
    for k in range(4):                              # four steps of 25 ms
        t = lo + 4 * MS + k * 25 * MS
        trace.complete("mapd.transitions", t, MS // 2)
        trace.complete("mapd.assign", t + 1 * MS, 1 * MS)
        trace.complete("mapd.replan", t + 2 * MS, 2 * MS)
        trace.complete("step.swap", t + 5 * MS, 6 * MS,
                       parent="mapd.tswap")
        trace.complete("step.cascade", t + 11 * MS, 3 * MS,
                       parent="mapd.tswap")
        trace.complete("mapd.tswap", t + 5 * MS, 9 * MS)
        trace.complete("mapd.record", t + 15 * MS, MS // 4)
    t = lo + 4 * MS
    events = [("k", t + 6 * MS, t + 7 * MS),             # step 0's tswap
              ("k", t + 13 * MS, t + 16 * MS),           # step 0's tswap
              ("k", t + 15 * MS, t + 15 * MS + 10),      # after it
              ("k", t + 31 * MS, t + 32 * MS),           # step 1's tswap
              ("k", t + 2 * MS + 10, t + 3 * MS),        # step 0's replan
              ("k", t + 4 * MS, t + 5 * MS),             # after it
              ("k", t + 53 * MS, t + 54 * MS),           # step 2's replan
              ("k", lo + 2 * MS, lo + 3 * MS),           # in the prime
              ("k", lo + 108 * MS, lo + 109 * MS)]       # in none
    win = harness.Window(window_s=0.1, step_s=[0.025] * 4, setup_s=1.0,
                         trace=_Trace(events), trace_lo=lo, trace_hi=hi)
    got = {name: reader(name).read(win) for name in SPAN_READERS}
    assert got == pytest.approx({
        "assign_ms_per_step": 1.0, "swap_ms_per_step": 6.0,
        "cascade_ms_per_step": 3.0, "transitions_ms_per_step": 0.5,
        "record_ms_per_step": 0.25, "prime_ms_per_step": 0.75,
        "tswap_ops_per_step": 3 / 4, "replan_ops_per_step": 2 / 4},
        rel=1e-3)
    assert reader("cascade_rounds_per_step").read(win) is None  # no probe
    empty = harness.Window(window_s=0.0, step_s=[], setup_s=1.0,
                           trace=_Trace(events), trace_lo=lo, trace_hi=hi)
    later = harness.Window(window_s=0.1, step_s=[0.025] * 4, setup_s=1.0,
                           trace=_Trace(events), trace_lo=hi, trace_hi=hi
                           + 100 * MS)
    for name in SPAN_READERS:
        assert reader(name).read(empty) is None
        assert reader(name).read(later) is None     # no span of its own


def test_counter_readers_on_a_synthetic_window(progtrace):
    def _readings(**counts):
        return {name: counts.get(name) for name in progtrace.COUNTERS}

    first = _readings(field_rows=100, cascade_rounds=7, fixpoint_rounds=30,
                      fixpoint_batches=10)
    mid = _readings(field_rows=150, cascade_rounds=9, fixpoint_rounds=40,
                    fixpoint_batches=12)
    last = _readings(field_rows=164, cascade_rounds=17, fixpoint_rounds=63,
                     fixpoint_batches=17)
    calls = {"progtrace.open": [first, mid], "progtrace.close": [mid, last]}
    win = harness.Window(window_s=1.0, step_s=[0.25] * 4, setup_s=1.0,
                         calls=calls)
    assert reader("field_rows_per_step").read(win) == pytest.approx(16.0)
    assert reader("cascade_rounds_per_step").read(win) == pytest.approx(2.5)
    assert reader("fixpoint_rounds_per_batch").read(win) == \
        pytest.approx(33 / 7)
    # a program without the counters, or no probe reading: nothing
    for c in (dict(calls, **{"progtrace.open": [_readings()]}), {}):
        w = harness.Window(window_s=1.0, step_s=[0.25] * 4, setup_s=1.0,
                           calls=c)
        assert {reader(n).read(w) for n in COUNTER_READERS} == {None}
    # no step: only the ratio reads
    w = harness.Window(window_s=0.0, step_s=[], setup_s=1.0, calls=calls)
    assert reader("field_rows_per_step").read(w) is None
    assert reader("cascade_rounds_per_step").read(w) is None
    assert reader("fixpoint_rounds_per_batch").read(w) == \
        pytest.approx(33 / 7)
    # no batch: no ratio
    w = harness.Window(window_s=1.0, step_s=[0.25] * 4, setup_s=1.0,
                       calls=dict(calls, **{"progtrace.close": [first]}))
    assert reader("fixpoint_rounds_per_batch").read(w) is None
    assert reader("field_rows_per_step").read(w) == 0.0


def _small_problem():
    from tswap_bench.traffic import inputs

    free_np = inputs.build_grid(SMALL["grid"])
    starts, tasks = inputs.solve_inputs(free_np, SMALL["num_agents"],
                                        SMALL["num_agents"], 0)
    cfg = SolverConfig(height=free_np.shape[0], width=free_np.shape[1],
                       num_agents=SMALL["num_agents"], replan_chunk=8,
                       replan_chunk_small=4, max_timesteps=400)
    return (cfg, torch.from_numpy(starts), torch.from_numpy(tasks),
            torch.from_numpy(free_np))


def test_clock_tie_on_a_real_solve(program):
    """Every span of a small solve, on the ``perf_counter_ns`` clock, lies
    between the host stamps taken just before and just after the call that
    recorded it (the tie holds to 1 us, a duration to 1 us more)."""
    torch.set_num_threads(1)
    prog = program()
    cfg, starts, tasks, free = _small_problem()
    calls = []
    t0 = time.perf_counter_ns()
    s, tasks = mapd.prepare_state(cfg, starts, tasks, free, device="cpu")
    calls.append((t0, time.perf_counter_ns(), 2))
    while not hostsync.flag(mapd._finished(cfg, s)) and len(calls) < 60:
        t0 = time.perf_counter_ns()
        s = mapd.mapd_step(cfg, s, tasks, free)
        calls.append((t0, time.perf_counter_ns(), 7))
    spans = prog.window(calls[0][0] - 1000, calls[-1][1] + 1000)
    assert len(spans) == sum(k for _, _, k in calls)
    for before, after, k in calls:
        inside = [sp for sp in spans if before - 1000 <= sp[1] <= after]
        assert len(inside) == k
        assert all(sp[2] <= after + 2000 for sp in inside)


def test_counters_through_the_harness_probes(program, progtrace):
    """The counter readers over a real window of the traffic kind, read
    through the harness's own ``CALLS`` probes, against the counters read
    just before and after the window."""
    torch.set_num_threads(1)
    program()
    kind = harness.load_module(ROOT / "tswap_bench" / "traffic"
                               / "whole_solves.py")
    mix = {"kind": "whole_solves", "tasks_per_agent": 1, "seed_stride": 1000,
           "warmup_steps": 2}
    cell = {"solves_prepared": 2, "check": {"steps": 4, "step_span": 40,
                                            "agents": 4, "stayed": 4,
                                            "reference_batch": 8}}
    ctx = kind.setup(SMALL, mix, cell, 2147483659, torch.device("cpu"))
    probes = harness.Probes({}, progtrace.CALLS, {})
    before = (mapd.field_rows, step.cascade_rounds,
              distance.fixpoint_rounds, distance.fixpoint_batches)
    lo = time.perf_counter_ns()
    out = kind.window(ctx, 0.5)
    hi = time.perf_counter_ns()
    after = (mapd.field_rows, step.cascade_rounds,
             distance.fixpoint_rounds, distance.fixpoint_batches)
    probes.remove()
    kind.finish(ctx, out)
    win = harness.Window(window_s=out["window_s"], step_s=out["step_s"],
                         setup_s=1.0, calls=probes.calls, trace_lo=lo,
                         trace_hi=hi)
    steps = len(out["step_s"])
    rows, rounds, fix, batches = np.subtract(after, before).tolist()
    assert rows > 0 and rounds > 0 and batches > 0
    assert reader("field_rows_per_step").read(win) == rows / steps
    assert reader("cascade_rounds_per_step").read(win) == rounds / steps
    assert reader("fixpoint_rounds_per_batch").read(win) == fix / batches
    for name in ("assign_ms_per_step", "transitions_ms_per_step",
                 "record_ms_per_step", "prime_ms_per_step"):
        assert reader(name).read(win) > 0
    for name in ("tswap_ops_per_step", "replan_ops_per_step"):
        assert reader(name).read(win) is None               # no device


def test_lost_events_read_nothing(program, progtrace, capsys):
    prog = program(capacity=16)
    base = time.perf_counter_ns()
    for k in range(40):
        trace.complete("step.swap", base + k * MS, MS // 2)
    win = harness.Window(window_s=0.04, step_s=[0.001] * 40, setup_s=1.0,
                         trace_lo=base, trace_hi=base + 40 * MS)
    assert progtrace.spans(win) is None
    assert reader("swap_ms_per_step").read(win) is None
    assert capsys.readouterr().err.count("lost spans") == 1
    # a window that opens after the oldest event kept (24 ms, to the
    # tie's 1 us) reads whole
    kept = prog.window(base + 24 * MS + 1000, base + 40 * MS)
    assert [sp[0] for sp in kept] == ["step.swap"] * 15
