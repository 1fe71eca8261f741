"""The benchmark harness: one run of one cell.

Everything that belongs to one configuration, traffic mix, traffic kind or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (grid, fleet, planner);
- ``workloads/<cell>.json``: the cell's configuration and traffic names,
  the solves its set-up prepares and the sizes of its correctness sample;
- ``traffic/<traffic>.json``: the mix's parameters and its ``kind``;
- ``traffic/<kind>.py``: the kind's driver, with ``setup``, ``window``,
  ``finish``, ``check`` and ``ATTRIBUTION`` (see
  ``traffic/whole_solves.py``);
- ``metrics/<metric>.py``: a reader ``read(win) -> float | None`` of the
  window record, which may declare the probes it reads: ``SPANS`` (label
  -> "module:attr", the host seconds and calls of that function),
  ``CALLS`` (label -> ("module:attr", f): f(*args) of every call),
  ``COUNTERS`` (label -> "module:attr", the attribute's change over the
  window); the device timeline is ``win.trace``.

Probes and the device trace are installed only in a traced run
(``--trace 1``), whose metrics are the per-layer ones; an untraced run
reports the end-to-end ones, measured with nothing installed.  Both
measure a window of ``seconds``; what the traffic kind still runs after
the close (``finish``) is neither timed nor traced.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from tswap_bench import devtrace

BENCH = "tswap_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "p2p_distributed_tswap_tpu")


@dataclasses.dataclass
class Window:
    """What a run measured, as the metric readers see it."""
    window_s: float
    step_s: list
    setup_s: float
    spans: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    trace: devtrace.DeviceTrace | None = None
    trace_lo: int = 0
    trace_hi: int = 0
    card: str = ""


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


class Probes:
    """Wrappers put around program functions for a traced window: the
    host-clock seconds and calls of each span label, the intervals of the
    ``attribution`` spans (none nested; the labels of the device's idle
    gaps), and the extracted arguments of every call of each call label.
    One wrapper a function, whatever labels read it."""

    def __init__(self, spans: dict, calls: dict, attribution: dict):
        self.seconds = {label: 0.0 for label in spans}
        self.count = {label: 0 for label in spans}
        self.intervals: list = []
        self.calls = {label: [] for label in calls}
        by_target: dict = {}

        def probe(target):
            return by_target.setdefault(target, {"spans": [], "calls": [],
                                                 "attribution": None})
        for label, target in spans.items():
            probe(target)["spans"].append(label)
        for label, (target, extract) in calls.items():
            probe(target)["calls"].append((label, extract))
        for label, target in attribution.items():
            probe(target)["attribution"] = label
        self._saved = []
        for target, p in by_target.items():
            mod, attr = _resolve(target)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, **p))

    def _wrap(self, fn, spans, calls, attribution):
        clock = time.perf_counter_ns

        def probed(*args, **kw):
            for label, extract in calls:
                self.calls[label].append(extract(*args, **kw))
            t0 = clock()
            try:
                return fn(*args, **kw)
            finally:
                t1 = clock()
                for label in spans:
                    self.seconds[label] += (t1 - t0) / 1e9
                    self.count[label] += 1
                if attribution is not None:
                    self.intervals.append((t0, t1, attribution))
        return probed

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


def load_module(path: Path):
    """The Python file ``path`` as a module of its own."""
    name = f"{BENCH}._loaded.{path.parent.name}.{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def card_info(device: torch.device) -> tuple:
    """(name, power limit) of the card, the limit as nvidia-smi reads it."""
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return name, limit or "unknown"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(root: Path, cell: str, seed: int, seconds: float, trace: bool,
        device: torch.device, process_start: float,
        patches: dict | None = None) -> dict:
    """Run ``cell`` once: set up, measure for ``seconds``, check.  Returns
    the result object; ``process_start`` is the ``perf_counter`` reading
    at the start of the process.  ``patches`` ("module:attr" ->
    replacement) puts other code in the program's place for the whole run
    (the control and the fault drills; never a benchmark run)."""
    bench = root / BENCH
    manifest = _json(root / "BENCHMARK.json")
    entry = next(w for w in manifest["workloads"] if w["name"] == cell)
    if device.type == "cuda" and torch.cuda.device_count() < entry["chips"]:
        raise RuntimeError(f"{cell} asks for {entry['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
    work = _json(bench / "workloads" / f"{cell}.json")
    if (work["config"], work["traffic"]) != (entry["config"],
                                            entry["traffic"]):
        raise ValueError(f"{cell}: workload file and manifest disagree")
    config = _json(bench / "configs" / f"{entry['config']}.json")
    mix = _json(bench / "traffic" / f"{entry['traffic']}.json")
    kind = load_module(bench / "traffic" / f"{mix['kind']}.py")
    # a reader that finds nothing to read in this cell returns None
    wanted = manifest["per_layer" if trace else "end_to_end"]
    readers = {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py")
               for m in wanted}

    saved = []
    for target, repl in (patches or {}).items():
        mod, attr = _resolve(target)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, repl)
    try:
        ctx = kind.setup(config, mix, work, seed, device)
        spans, calls, counters = {}, {}, {}
        if trace:
            for r in readers.values():
                spans.update(getattr(r, "SPANS", {}))
                calls.update(getattr(r, "CALLS", {}))
                counters.update(getattr(r, "COUNTERS", {}))
        probes = Probes(spans, calls, kind.ATTRIBUTION) if trace else None
        before = {k: getattr(*_resolve(t)) for k, t in counters.items()}
        dtrace = devtrace.DeviceTrace(device) if trace else None
        if dtrace is not None:
            dtrace.start()
        setup_s = time.perf_counter() - process_start
        print(f"tswap_bench: set-up {setup_s:.2f} s", file=sys.stderr)
        lo = time.perf_counter_ns()
        out = kind.window(ctx, seconds)
        hi = time.perf_counter_ns()
        if dtrace is not None:
            t_read = time.perf_counter()
            dtrace.stop()
            print(f"tswap_bench: {len(dtrace.events)} device operations "
                  f"read in {time.perf_counter() - t_read:.1f} s",
                  file=sys.stderr)
        if probes is not None:
            probes.remove()
        kind.finish(ctx, out)
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    win = Window(window_s=out["window_s"], step_s=out["step_s"],
                 setup_s=setup_s, trace=dtrace, trace_lo=lo, trace_hi=hi)
    if probes is not None:
        win.spans = {k: (probes.seconds[k], probes.count[k])
                     for k in probes.seconds}
        win.calls = probes.calls
    win.counters = {k: getattr(*_resolve(t)) - before[k]
                    for k, t in counters.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "count": 1}
    if device.type == "cuda":
        win.card, dev["power_limit"] = card_info(device)
        dev["kind"] = win.card
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        dev["kind"] = "cpu"
        dev["memory_peak_bytes"] = 0
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": None, "attempted": 0, "failed": 0,
              "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = devtrace.busy_ns(dtrace.events, lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = {
            "device_ops": devtrace.device_ops(dtrace.events),
            "idle_gaps": devtrace.idle_gaps(dtrace.events, lo, hi,
                                            probes.intervals)}
    del dtrace, probes, win
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, attempted, failed = kind.check(ctx, out)
    print(f"tswap_bench: checked in {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    result["correct"] = all(v <= limit for _, v, limit in checks)
    result["attempted"], result["failed"] = attempted, failed
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    return result
