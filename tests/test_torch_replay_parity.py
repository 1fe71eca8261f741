"""Replay determinism between the JAX daemon and the port's.

The committed ``results/captures/ci_small.capture.json`` window (6 agents,
14², a 2-shard busd pool, 19 tasks) is replayed with ``--replay-solver
tpu`` through the JAX package's ``analysis/fleetsim.py`` (the JAX daemon)
and through its twin ``analysis/torch_fleetsim.py --cpu`` (the port's
daemon).  The determinism verdict of ``scripts/chaos_gate.py`` must pass
between the two: the identical completed task-id set and equal audit
ledger/view digests at the final watermark, with both outcomes ok (every
captured task completed once).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CAPTURE = ROOT / "results" / "captures" / "ci_small.capture.json"
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

import chaos_gate  # noqa: E402
import torch_chaos_gate  # noqa: E402


def _replay(script: str, tmp: Path, label: str, *extra) -> dict:
    out = tmp / f"{label}.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "analysis" / script), "--replay",
         str(CAPTURE), "--replay-solver", "tpu", *extra, "--out", str(out),
         "--log-dir", str(tmp / label)],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT),
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (banner,) = [x for x in (tmp / label / "replay" / "solverd.log")
                 .read_text().splitlines() if "solverd up" in x]
    return {"result": json.loads(out.read_text())["replay"],
            "banner": banner}


def test_replay_through_both_daemons_is_deterministic(tmp_path):
    jax_run = _replay("fleetsim.py", tmp_path, "jax")
    port_run = _replay("torch_fleetsim.py", tmp_path, "port", "--cpu")
    assert "devices=" in jax_run["banner"]
    assert "device=cpu [cpu]" in port_run["banner"]
    a, b = jax_run["result"], port_run["result"]
    assert a["solver"] == b["solver"] == "tpu"
    assert a["expected"] == b["expected"] == 19
    assert a["done_dups"] == b["done_dups"] == 0
    verdict = chaos_gate.determinism_verdict(a, b)
    assert verdict["ok"] and verdict["completed_equal"], verdict
    assert verdict["completed"] == 19
    assert verdict["digests"]["ledger"]["equal"]
    assert verdict["digests"]["view"]["equal"]
    assert torch_chaos_gate.determinism_verdict(a, b) == verdict


def _result(**kw) -> dict:
    digest = {"digest": "0f", "count": 19}
    return {"completed_ids": list(range(19)), "done_dups": 0, "ok": True,
            "digests": {"ledger": dict(digest), "view": dict(digest),
                        "view_agents": dict(digest), "lanes": dict(digest)},
            **kw}


def _digests(**kw) -> dict:
    return {**_result()["digests"], **kw}


@pytest.mark.parametrize("b", [
    _result(),
    _result(completed_ids=list(range(18))),
    _result(digests=_digests(ledger={"digest": "10", "count": 19})),
    _result(digests=_digests(view={"digest": "0f", "count": 18})),
    _result(digests={k: v for k, v in _digests().items() if k != "view"}),
    _result(digests=_digests(lanes={"digest": "11", "count": 19})),
    _result(ok=False),
    _result(done_dups=1),
], ids=["equal", "ids", "ledger", "view_count", "view_missing",
        "lanes_only", "outcome", "duplicate"])
def test_chip_smoke_verdict_is_chaos_gates(b):
    """``chip_smoke.py`` takes its replay verdict from the chaos gate's
    twin (``scripts/torch_chaos_gate.py``, which imports only the port):
    its ``determinism_verdict`` is the original's, whole and both ways, on
    every case.  (A duplicate completion is the chaos classifier's
    concern, not the verdict's: both pass the ``duplicate`` case.)"""
    a = _result()
    for x, y in ((a, b), (b, a)):
        assert torch_chaos_gate.determinism_verdict(x, y) == \
            chaos_gate.determinism_verdict(x, y)
