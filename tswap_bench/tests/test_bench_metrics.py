"""The arithmetic of the metric readers, on synthetic windows."""

import importlib.util

import numpy as np
import pytest

from conftest import ROOT
from tswap_bench import devtrace, harness, roofline


def reader(name):
    return harness.load_module(ROOT / "tswap_bench" / "metrics"
                               / f"{name}.py")


def window(step_s, **kw):
    return harness.Window(window_s=sum(step_s), step_s=list(step_s),
                          setup_s=kw.pop("setup_s", 1.0), **kw)


def test_solve_step_ms_and_p95_on_stamps():
    steps = [0.010] * 95 + [0.050] * 5
    win = window(steps)
    assert reader("solve_step_ms").read(win) == pytest.approx(12.0)
    assert reader("step_ms_p95").read(win) == pytest.approx(
        1000 * np.percentile(steps, 95))


def test_a_stall_moves_both():
    steps = [0.010] * 100
    base = window(steps)
    stalled = window(steps[:60] + [2.0] * 10 + steps[70:])
    for name in ("solve_step_ms", "step_ms_p95"):
        assert reader(name).read(stalled) > reader(name).read(base)


def test_empty_window_reads_nothing():
    win = window([])
    for name in ("solve_step_ms", "step_ms_p95", "host_syncs_per_step"):
        assert reader(name).read(win) is None


def test_per_step_spans_and_counters():
    win = window([0.01] * 50, spans={"replan": (0.2, 80), "step": (0.3, 50)},
                 counters={"host_syncs": 1000})
    assert reader("replan_ms_per_step").read(win) == pytest.approx(4.0)
    assert reader("tswap_step_ms_per_step").read(win) == pytest.approx(6.0)
    assert reader("host_syncs_per_step").read(win) == pytest.approx(20.0)


def test_sweep_scan_bytes():
    # (4, 1024, 1024) with one shared mask: 8 bytes a cell and one plane
    assert roofline.sweep_scan_bytes(4, 1024, 1024, False) == \
        4 * 1024 * 1024 * 8 + 1024 * 1024
    assert roofline.sweep_scan_bytes(64, 512, 512, True) == \
        64 * 512 * 512 * 9
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == \
        3.35e12


class _Trace:
    def __init__(self, events):
        self.events = events


def test_sweep_scan_roofline_reads_its_kernels():
    shape = (4, 1024, 1024, False)
    least = roofline.sweep_scan_bytes(*shape) / 3.35e12  # seconds
    ns = int(2 * least * 1e9)
    events = [("void (anonymous namespace)::sweep_along_h<32, 16>(int)",
               0, ns), ("elementwise", ns, 2 * ns),
              ("void (anonymous namespace)::sweep_along_w<4>(int)",
               2 * ns, 3 * ns)]
    win = window([0.01], calls={"sweep_scan": [shape, shape]},
                 trace=_Trace(events), card="NVIDIA H100 80GB HBM3")
    assert reader("sweep_scan_roofline").read(win) == pytest.approx(
        50.0, rel=1e-4)
    lost = window([0.01], calls={"sweep_scan": [shape] * 3},
                  trace=_Trace(events), card="NVIDIA H100 80GB HBM3")
    assert reader("sweep_scan_roofline").read(lost) is None
    none = window([0.01], calls={"sweep_scan": []}, trace=_Trace(events))
    assert reader("sweep_scan_roofline").read(none) is None


def test_device_idle_and_busy_union():
    events = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 90, 120)]
    assert devtrace.busy_ns(events, 0, 100) == 40
    win = window([0.01], trace=_Trace(events), trace_lo=0, trace_hi=100)
    assert reader("device_idle").read(win) == pytest.approx(60.0)
    idle = window([0.01], trace=_Trace([]), trace_lo=0, trace_hi=100)
    assert reader("device_idle").read(idle) is None


def test_idle_gaps_by_host_span():
    events = [("k", 0, 10), ("k", 50, 60), ("m", 100, 110)]
    spans = [(5, 55, "replan"), (60, 95, "step")]
    gaps = dict(devtrace.idle_gaps(events, 0, 130, spans))
    assert gaps == {"replan": 40e-9, "step": 40e-9, "other": 20e-9}
    ops = devtrace.device_ops(events)
    assert ops[0] == ["k", 20e-9]


def test_short_names():
    assert devtrace.short_name(
        "void (anonymous namespace)::sweep_along_h<32, 16>(int const*)") \
        == "sweep_along_h<32, 16>"
