"""The port's copies of ``obs/health.py`` and ``metrics/task_metrics.py``
give their originals' outputs.

The same seeded signal streams go through both packages' health engines
(burn windows, confirm and heal, forecasts, the history ring and its file),
forecasters, attribution and alert rendering; the same seeded task and
path-timing streams through both packages' task metrics.  Every output is
equal.  The copies' ``python -m`` runner imports only the port.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from p2p_distributed_tswap_tpu.metrics import task_metrics as jtm
from p2p_distributed_tswap_tpu.obs import health as jh
from p2p_distributed_tswap_tpu_torch.metrics import task_metrics as ttm
from p2p_distributed_tswap_tpu_torch.obs import health as th

ROOT = Path(__file__).resolve().parents[1]

SPEC = {"name": "t", "slos": [
    {"name": "lat", "signal": "x.p99", "max": 100.0},
    {"name": "ratio", "signal": "x.ratio", "min": 0.5},
    {"name": "wire", "signal": "bus.wire_p99_ms", "max": 40.0}]}


def _signals(seed: int, beats: int) -> list:
    """A seeded stream: noise, a ramp through the latency bound, a dip of
    the ratio, a transient wire spike, and a missing signal now and then."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(beats):
        sig = {"x.p99": float(50 + 4.5 * max(0, i - 10)
                              + rng.normal(0, 3)),
               "x.ratio": float(0.9 - (0.6 if 20 <= i < 32 else 0.0)
                                + rng.normal(0, 0.02)),
               "bus.wire_p99_ms": float(80.0 if i == 7 else
                                        10 + rng.normal(0, 1))}
        if rng.random() < 0.1:
            sig.pop("x.ratio")
        out.append(sig)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_engine_matches_the_original(tmp_path, seed):
    outs = []
    for mod, name in ((jh, "jax"), (th, "port")):
        ring = mod.HealthRing(str(tmp_path / f"{name}.ring.jsonl"), cap=8)
        eng = mod.HealthEngine(spec=SPEC, ring=ring, interval=2.0)
        alerts = []
        for i, sig in enumerate(_signals(seed, 48)):
            # every fourth beat repeats the last evidence (a stale rollup)
            mark = i + 1 - (i % 4 == 3)
            alerts += eng.observe({"beacons_ingested": mark},
                                  now_ms=1000 + 2000 * i, signals=sig)
        outs.append({"alerts": alerts, "status": eng.status(),
                     "active": eng.active(),
                     "burn": {s["name"]: eng.burn(s["name"])
                              for s in SPEC["slos"]},
                     "rendered": [mod.render_alert(a) for a in alerts],
                     "ring": list(ring.records),
                     "ring_file": (tmp_path / f"{name}.ring.jsonl")
                     .read_text()})
    assert outs[0] == outs[1]
    assert outs[0]["alerts"]  # the stream does alert


@pytest.mark.parametrize("kind", ["max", "min"])
def test_forecaster_matches_the_original(kind):
    rng = np.random.default_rng(5)
    series = (50 + np.cumsum(rng.normal(2.0 if kind == "max" else -2.0,
                                        0.5, 40))).tolist()
    got = []
    for mod in (jh, th):
        fc = mod.SlopeForecaster()
        seen = []
        for i, v in enumerate(series):
            fc.observe(2.0 * i, v)
            seen.append((fc.forecast(100.0 if kind == "max" else 10.0, kind),
                         fc.confidence()))
        got.append(seen)
    assert got[0] == got[1]
    assert any(f is not None for f, _ in got[0])


def test_attribution_matches_the_original():
    rollup = {
        "beacons_ingested": 9,
        "bus": {"shards": {"0": {"frames_in": 900, "frames_out": 880},
                           "1": {"frames_in": 120, "frames_out": 110}}},
        "tenants": {"t0": {"tasks_per_s": 0.2, "backlog": 40},
                    "t1": {"tasks_per_s": 3.0, "backlog": 1}},
        "peers": {"solverd-1": {"proc": "solverd", "tick_p99_ms": 480.0},
                  "manager-1": {"proc": "manager", "tick_p99_ms": 20.0}},
    }
    prev = {**rollup, "bus": {"shards": {
        "0": {"frames_in": 100, "frames_out": 100},
        "1": {"frames_in": 100, "frames_out": 100}}}}
    for slo in SPEC["slos"]:
        for status in ("fail", "pass"):
            verdict = {"name": slo["name"], "status": status,
                       "observed": 123.0}
            assert th.attribute(rollup, prev, slo, verdict) == \
                jh.attribute(rollup, prev, slo, verdict)


def _task_stream(mod, seed: int):
    rng = np.random.default_rng(seed)
    c = mod.TaskMetricsCollector()
    base = 1_700_000_000_000
    for tid in range(40):
        sent = base + int(rng.integers(0, 60_000))
        c.add_metric(mod.TaskMetric(task_id=tid, peer_id=f"peer{tid % 5}",
                                    sent_time=sent))
        r = rng.random()
        if r < 0.9:
            c.update_received(tid, at_ms=sent + int(rng.integers(-5, 80)))
        if r < 0.8:
            c.update_started(tid, at_ms=sent + int(rng.integers(10, 120)))
        if r < 0.7:
            c.update_completed(tid, at_ms=sent + int(rng.integers(200, 9000)))
        elif r < 0.75:
            c.update_failed(tid)
    p = mod.PathComputationMetrics()
    for k in range(25):
        p.record_micros(int(rng.integers(50, 50_000)))
    return c, p


@pytest.mark.parametrize("seed", [0, 7])
def test_task_metrics_match_the_original(seed):
    (jc, jp), (tc, tp) = _task_stream(jtm, seed), _task_stream(ttm, seed)
    assert tc.to_csv_string() == jc.to_csv_string()
    assert str(tc.get_statistics()) == str(jc.get_statistics())
    assert vars(tc.get_statistics()) == vars(jc.get_statistics())
    assert tp.to_csv_string() == jp.to_csv_string()
    assert str(tp.get_statistics()) == str(jp.get_statistics())
    jn, tn = jtm.NetworkMetrics(), ttm.NetworkMetrics()
    for n in (10, 200, 3000):
        jn.record_sent(n), tn.record_sent(n)
        jn.record_received(2 * n), tn.record_received(2 * n)
    assert (tn.messages_sent, tn.bytes_sent, tn.messages_received,
            tn.bytes_received) == (jn.messages_sent, jn.bytes_sent,
                                   jn.messages_received, jn.bytes_received)


def test_health_runner_imports_only_the_port():
    """``python -m p2p_distributed_tswap_tpu_torch.obs.health`` against no
    bus exits 2 (no beacons, as the original) and brings in nothing of
    JAX or the JAX package."""
    code = ("import sys, runpy\n"
            "sys.argv = ['health', '--port', '1', '--for', '0.2']\n"
            "try:\n"
            "    runpy.run_module('p2p_distributed_tswap_tpu_torch.obs.health',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    code = e.code\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax') or k == 'p2p_distributed_tswap_tpu' "
            "or k.startswith('p2p_distributed_tswap_tpu.'))\n"
            "print(json.dumps([code, bad]))\n").replace(
                "import sys", "import json, sys", 1)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    code, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert code == 2 and bad == []
