"""Chaos matrix on top of deterministic replay (scripts/ci.sh).

Replay (``analysis/fleetsim.py --replay``) makes the LOAD deterministic;
this gate schedules faults ON TOP of it and judges each run with the
audit plane and the SLO engine — chaos engineering
with a reproducible trigger and an automated judge:

- ``clean`` — no fault: the replay itself must complete every captured
  task exactly once with zero confirmed RED divergences (the control
  row, and — run twice — the DETERMINISM PROOF: identical completed-task
  sets and equal audit ledger/view digests at the final watermark);
- ``bus_shard_kill`` — hard-kill a non-home busd pool member mid-window
  (runtime/buspool.py kill_shard): a dead shard must cost its regions,
  not the fleet (the sharded bus's contract, now chaos-gated on every run);
- ``solverd_sigkill`` — SIGKILL solverd mid-window (mid-dynamic-world
  when the capture carries toggles) and respawn it: the auditor must
  DETECT the gap (a confirmed ``silent`` record naming solverd — the
  localization), and the restarted daemon's snapshot+world-replay
  resync must reconverge with nothing lost or duplicated;
- ``manager_sigstop`` — SIGSTOP the manager past its audit cadence
  (several claim windows), then SIGCONT: detected as a manager
  ``silent`` episode, healed after resume, outcome intact;
- ``peer_partition`` — SIGSTOP a busd pool member (a link partition:
  the process lives, its traffic stalls), then SIGCONT: the fleet rides
  through on the surviving shards + reconnects.
- ``shm_peer_kill`` — replay with the zero-copy lanes armed
  (JG_BUS_SHM=1), spawn a dedicated shm-lane beacon peer,
  SIGKILL it mid-window: busd must reap the dead peer's ring (lane file
  unlinked with the TCP session), the surviving lane users keep
  flowing, and the replay stays divergence-free.

Verdict per fault: ``green`` iff the outcome ledger is intact (every
captured task completed exactly once), any required detection fired AND
named the faulted role, no RED divergence is still active at the final
watermark, and the SLO engine passes the replay signals.  A gate that
cannot trip is no gate: ``--ci`` runs the determinism pair AND the
solverd kill, and fails unless the kill is detected + localized.

Usage:
  python scripts/torch_chaos_gate.py [--cpu] \
      --capture results/captures/ci_small.capture.json --ci
  python scripts/torch_chaos_gate.py --capture C --faults \
      clean,bus_shard_kill,solverd_sigkill,manager_sigstop,peer_partition \
      --out results/torch_replay.json
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from p2p_distributed_tswap_tpu_torch.obs import audit as au  # noqa: E402
from p2p_distributed_tswap_tpu_torch.obs import capture as _capture  # noqa: E402
from p2p_distributed_tswap_tpu_torch.obs import slo as _slo  # noqa: E402


# ---------------------------------------------------------------------------
# fault scripts — polled by fleetsim.run_replay with (ctx, t_rel_s)
# ---------------------------------------------------------------------------

class Fault:
    """Base fault: fires once at ``at_s`` into the replay.  Subclasses
    implement :meth:`fire` (and optionally :meth:`recover` at
    ``at_s + recover_after_s``)."""

    kind = "clean"
    needs_solverd = False
    needs_shards = 1
    needs_shm = False
    extra_drain_s = 0.0

    def __init__(self, at_s: float = 0.0, recover_after_s: float = 0.0):
        self.at_s = at_s
        self.recover_after_s = recover_after_s
        self.fired_at = None
        self.recovered_at = None

    def fire(self, ctx) -> None:  # pragma: no cover - overridden
        pass

    def recover(self, ctx) -> None:
        pass

    def poll(self, ctx, t_s: float) -> None:
        if self.fired_at is None and t_s >= self.at_s:
            self.fired_at = round(t_s, 2)
            self.fire(ctx)
        if self.fired_at is not None and self.recovered_at is None \
                and self.recover_after_s \
                and t_s >= self.at_s + self.recover_after_s:
            self.recovered_at = round(t_s, 2)
            self.recover(ctx)

    def summary(self) -> dict:
        return {"kind": self.kind, "at_s": self.at_s,
                "fired_at_s": self.fired_at,
                "recovered_at_s": self.recovered_at}


class CleanFault(Fault):
    kind = "clean"

    def poll(self, ctx, t_s: float) -> None:
        pass


class BusShardKill(Fault):
    kind = "bus_shard_kill"
    needs_shards = 2
    extra_drain_s = 20.0

    def __init__(self, at_s: float, shard: int = 1):
        super().__init__(at_s)
        self.shard = shard

    def fire(self, ctx) -> None:
        ctx.pool.kill_shard(self.shard)
        ctx.note(f"killed bus shard {self.shard} at t={self.fired_at}s")

    def summary(self) -> dict:
        return {**super().summary(), "shard": self.shard}


class SolverdSigkill(Fault):
    kind = "solverd_sigkill"
    needs_solverd = True
    # the respawned daemon re-warms JAX programs before planning resumes
    extra_drain_s = 90.0

    def __init__(self, at_s: float, restart_after_s: float = 3.0):
        super().__init__(at_s, recover_after_s=restart_after_s)

    def fire(self, ctx) -> None:
        ctx.solverd.send_signal(signal.SIGKILL)
        try:
            ctx.solverd.wait(timeout=10)
        except Exception:
            pass
        ctx.note(f"SIGKILLed solverd at t={self.fired_at}s")

    def recover(self, ctx) -> None:
        ctx.restart_solverd(wait=False)
        ctx.note(f"respawned solverd at t={self.recovered_at}s "
                 "(non-blocking; resync heals it)")


class ManagerSigstop(Fault):
    kind = "manager_sigstop"
    extra_drain_s = 25.0

    def __init__(self, at_s: float, stop_s: float = 4.0):
        super().__init__(at_s, recover_after_s=stop_s)

    def fire(self, ctx) -> None:
        os.kill(ctx.manager.pid, signal.SIGSTOP)
        ctx.note(f"SIGSTOPped manager at t={self.fired_at}s")

    def recover(self, ctx) -> None:
        os.kill(ctx.manager.pid, signal.SIGCONT)
        ctx.note(f"SIGCONTed manager at t={self.recovered_at}s")


class ManagerHandoffKill(Fault):
    """SIGKILL region 1's manager mid-window on a FEDERATED
    (2x1) replay — by then agents are crossing the border, so the kill
    lands mid-handoff-traffic.  The contract: the auditor must DETECT
    the silent manager, the surviving neighbor must NOT double-dispatch
    (no uncaptured completion, no ledger overcount — the handoff dedup
    guard under fire), and the handoff protocol must actually have been
    exercised (handoffs_sent >= 1).

    Verdict modes: without a standby (``ha=False``, the
    JG_HA=0 legacy row) tasks whose region of record died MAY strand —
    the row demands detection only.  With a standby configured the row
    is RECOVERY-REQUIRED: the dead region's warm standby must promote
    (digest-equal takeover watermark) and every captured task must
    complete exactly once — zero lost, zero duplicated."""

    kind = "manager_handoff_kill"
    needs_regions = "2x1"
    extra_drain_s = 25.0

    def __init__(self, at_s: float, ha: bool = False):
        super().__init__(at_s)
        self.ha = ha
        if ha:
            # the promoted standby needs the lease-expiry window plus a
            # sweep-hold before re-queued tasks can finish
            self.extra_drain_s = 45.0

    def fire(self, ctx) -> None:
        victim = ctx.managers[1]
        victim.send_signal(signal.SIGKILL)
        try:
            victim.wait(timeout=10)
        except Exception:
            pass
        ctx.note(f"SIGKILLed region-1 manager at t={self.fired_at}s")


class ManagerKillFailover(Fault):
    """SIGKILL the (flat fleet's) active manager mid-window
    with a warm standby configured.  The contract is full recovery:
    the auditor must confirm the silent active (detection), the standby
    must promote inside one claim window announcing ledger/view digests
    EQUAL to the active's last shipped ones (the takeover watermark
    proof), and every captured task must complete exactly once — zero
    lost, zero duplicated (the promoted manager's restore-hold +
    unknown-done dedup under fire)."""

    kind = "manager_kill_failover"
    ha = True
    extra_drain_s = 45.0

    def fire(self, ctx) -> None:
        ctx.manager.send_signal(signal.SIGKILL)
        try:
            ctx.manager.wait(timeout=10)
        except Exception:
            pass
        ctx.note(f"SIGKILLed the active manager at t={self.fired_at}s "
                 "(warm standby must take over)")


class PeerPartition(Fault):
    kind = "peer_partition"
    needs_shards = 2
    extra_drain_s = 20.0

    def __init__(self, at_s: float, stop_s: float = 4.0, shard: int = 1):
        super().__init__(at_s, recover_after_s=stop_s)
        self.shard = shard

    def fire(self, ctx) -> None:
        os.kill(ctx.pool.procs[self.shard].pid, signal.SIGSTOP)
        ctx.note(f"partitioned bus shard {self.shard} (SIGSTOP) at "
                 f"t={self.fired_at}s")

    def recover(self, ctx) -> None:
        os.kill(ctx.pool.procs[self.shard].pid, signal.SIGCONT)
        ctx.note(f"healed partition of shard {self.shard} at "
                 f"t={self.recovered_at}s")

    def summary(self) -> dict:
        return {**super().summary(), "shard": self.shard}


class ShmPeerKill(Fault):
    """the replay runs with the zero-copy lanes armed
    (JG_BUS_SHM=1 — the sim pool itself rides rings), a dedicated
    shm-lane beacon peer is spawned at ``at_s`` and SIGKILLed a few
    seconds later.  The contract: busd reaps the dead peer's ring with
    its TCP session (the lane FILE is unlinked — nothing stale
    survives), the surviving lane users keep flowing, and the replay
    outcome stays intact with no RED divergence."""

    kind = "shm_peer_kill"
    needs_shm = True
    extra_drain_s = 15.0

    def __init__(self, at_s: float, kill_after_s: float = 4.0):
        super().__init__(at_s, recover_after_s=kill_after_s)
        self.victim = None
        self.lane_negotiated = None
        self.reaped = None

    def _lane_path(self):
        from p2p_distributed_tswap_tpu_torch.runtime import shmlane
        return shmlane.lane_path_for("shm-victim", 0)

    def fire(self, ctx) -> None:
        import subprocess
        code = (
            "import sys, time, base64\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from p2p_distributed_tswap_tpu_torch.obs import registry as reg\n"
            "from p2p_distributed_tswap_tpu_torch.runtime import plan_codec\n"
            "from p2p_distributed_tswap_tpu_torch.runtime.bus_client import "
            "BusClient\n"
            f"c = BusClient(port={ctx.pool.home_port}, "
            "peer_id='shm-victim', shm=True, registry=reg.Registry())\n"
            "c.subscribe('mapd.pos.*')\n"
            "beat = {'type': 'pos1', 'data': base64.b64encode("
            "plan_codec.encode_pos1(66, 66)).decode()}\n"
            "while True:\n"
            "    c.publish('mapd.pos.66.66', beat)\n"
            "    c.recv(timeout=0.02)\n")
        self.victim = subprocess.Popen(
            [sys.executable, "-c", code],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        # the lane file appearing proves the ring pair was offered;
        # busd's welcome echo arms it moments later
        path, end = self._lane_path(), time.monotonic() + 5.0
        while not path.exists() and time.monotonic() < end:
            time.sleep(0.1)
        self.lane_negotiated = path.exists()
        ctx.note(f"spawned shm-lane victim (pid {self.victim.pid}, "
                 f"lane {'up' if self.lane_negotiated else 'MISSING'}) "
                 f"at t={self.fired_at}s")

    def recover(self, ctx) -> None:
        self.victim.send_signal(signal.SIGKILL)
        try:
            self.victim.wait(timeout=10)
        except Exception:
            pass
        ctx.note(f"SIGKILLed shm-lane victim at t={self.recovered_at}s")
        # busd sees the TCP session die in its next poll cycle and must
        # unlink the ring + doorbells — nothing stale survives
        path, end = self._lane_path(), time.monotonic() + 5.0
        while path.exists() and time.monotonic() < end:
            time.sleep(0.1)
        self.reaped = not path.exists()
        ctx.note("shm lane reaped (ring file unlinked)" if self.reaped
                 else f"shm lane NOT reaped: {path} survived the kill")

    def summary(self) -> dict:
        return {**super().summary(),
                "lane_negotiated": self.lane_negotiated,
                "reaped": self.reaped}


FAULT_KINDS = ("clean", "bus_shard_kill", "solverd_sigkill",
               "manager_sigstop", "peer_partition", "shm_peer_kill",
               "manager_handoff_kill", "manager_kill_failover")


def build_fault(kind: str, capture: dict,
                ha: Optional[bool] = None) -> Fault:
    """Instantiate a fault scheduled relative to the capture's own
    duration (mid-window: the fleet is busiest there).  ``ha`` arms the
    warm-standby rows; for ``manager_handoff_kill`` it defaults to the
    JG_HA env so the same row name upgrades from detection-only to
    recovery-required when a standby is configured."""
    dur_s = capture["duration_ms"] / 1000.0
    mid = max(1.0, 0.4 * dur_s)
    if kind == "clean":
        return CleanFault()
    if kind == "bus_shard_kill":
        return BusShardKill(at_s=mid)
    if kind == "solverd_sigkill":
        return SolverdSigkill(at_s=mid)
    if kind == "manager_sigstop":
        return ManagerSigstop(at_s=mid)
    if kind == "peer_partition":
        return PeerPartition(at_s=mid)
    if kind == "shm_peer_kill":
        return ShmPeerKill(at_s=mid)
    if kind == "manager_handoff_kill":
        if ha is None:
            ha = os.environ.get("JG_HA", "") not in ("", "0")
        return ManagerHandoffKill(at_s=mid, ha=ha)
    if kind == "manager_kill_failover":
        return ManagerKillFailover(at_s=mid)
    raise SystemExit(f"unknown fault {kind!r} (one of {FAULT_KINDS})")


# ---------------------------------------------------------------------------
# judges
# ---------------------------------------------------------------------------

# faults whose detection by the auditor is REQUIRED for a green verdict
# (the faulted role goes silent while its peers keep beaconing); the bus
# faults are judged on outcome + reconvergence — busd holds no audited
# fleet state to go silent with
_DETECTION_REQUIRED = {"solverd_sigkill": "solverd",
                       "manager_sigstop": "manager"}

CHAOS_SPEC = {
    "name": "chaos-replay",
    "slos": [
        {"name": "completion_ratio", "signal": "replay.completion_ratio",
         "min": 1.0},
        {"name": "tasks_missing", "signal": "replay.missing", "max": 0},
        # duplication is judged at the SYSTEM-OF-RECORD level: the
        # manager's dedup-guarded completion counter exceeding the
        # captured task count, or an id the capture never issued
        # completing.  Pool-side double-deliveries (the positional-done
        # / goal-exchange race) are reference behavior and ride the
        # artifact as evidence only.
        {"name": "ledger_overcount", "signal": "replay.ledger_overcount",
         "max": 0},
        {"name": "uncaptured_completions",
         "signal": "replay.extra_done", "max": 0},
    ],
}


def _proc_of(res: dict, peer: str) -> str:
    return ((res["audit"].get("epochs") or {}).get(peer) or {}).get(
        "proc") or ""


def _ha_takeover_checks(res: dict, reasons: list) -> dict:
    """Shared failover evidence: exactly >= 1 takeover must
    have been announced, and the promoted standby's ledger/view digests
    must equal the failed active's last shipped ones at the takeover
    watermark.  Appends failures to ``reasons``; returns the evidence."""
    takeovers = (res.get("ha") or {}).get("takeovers") or []
    if not takeovers:
        reasons.append("no ha_takeover was ever announced — the "
                       "standby never promoted")
        return {"takeovers": 0, "digests_equal": None,
                "takeover_latency_s": None}
    bad = [t for t in takeovers if not t["digests_equal"]]
    if bad:
        reasons.append("takeover watermark digests DIFFER from the "
                       f"failed active's last shipped ones: {bad}")
    fired = (res.get("chaos") or {}).get("fired_at_s")
    latency = None
    if fired is not None:
        latency = round(min(t["t_rel_s"] for t in takeovers) - fired, 2)
    return {"takeovers": len(takeovers),
            "digests_equal": not bad,
            "takeover_latency_s": latency}


def classify_kill_failover(res: dict) -> dict:
    """The warm-standby failover verdict: full recovery —
    detection (silent manager confirmed), digest-equal takeover, and
    the exact-once outcome ledger (zero lost, zero duplicated)."""
    reasons = []
    confirmed = res["audit"]["confirmed"]
    overcount = max(0, res.get("mgr_completed", 0) - res["expected"])
    if res["missing"]:
        reasons.append(f"{len(res['missing'])} task(s) lost across the "
                       f"failover: {res['missing'][:8]}")
    if res["extra_done"]:
        reasons.append(f"uncaptured task id(s) completed: "
                       f"{res['extra_done'][:8]}")
    if overcount:
        reasons.append(f"manager ledger double-counted {overcount} "
                       "completion(s) across the takeover")
    silent_mgr = [d for d in confirmed if d["class"] == "silent"
                  and _proc_of(res, d.get("peer_a") or "").startswith(
                      "manager")]
    detected = bool(silent_mgr)
    if not detected:
        reasons.append("auditor never confirmed the silent active — "
                       "the kill went undetected")
    ha_ev = _ha_takeover_checks(res, reasons)
    return {"fault": "manager_kill_failover",
            "verdict": "green" if not reasons else "red",
            "outcome_ok": not res["missing"] and not res["extra_done"]
            and not overcount,
            "healed": bool(ha_ev["takeovers"]),
            "detected": detected, "localized": detected,
            "ha": ha_ev,
            "confirmed_divergences": confirmed,
            "slo": {"ok": not reasons, "failed": []},
            "reasons": reasons}


def classify(kind: str, res: dict) -> dict:
    """The chaos verdict for one replayed fault: green iff the outcome
    ledger is intact, required detection fired and NAMED the faulted
    role (localization), no RED divergence is still active at the final
    watermark (reconvergence), and the SLO engine passes."""
    if kind == "manager_handoff_kill":
        return classify_handoff_kill(res)
    if kind == "manager_kill_failover":
        return classify_kill_failover(res)
    reasons = []
    confirmed = res["audit"]["confirmed"]
    red_confirmed = [d for d in confirmed
                     if d["class"] in au.RED_CLASSES]
    active_red = [d for d in res["audit"]["active"]
                  if d["class"] in au.RED_CLASSES]
    healed = not active_red
    outcome_ok = res["ok"]
    overcount = max(0, res.get("mgr_completed", 0) - res["expected"])
    if res["missing"]:
        reasons.append(f"{len(res['missing'])} task(s) lost: "
                       f"{res['missing'][:8]}")
    if res["extra_done"]:
        reasons.append(f"uncaptured task id(s) completed: "
                       f"{res['extra_done'][:8]}")
    if overcount:
        reasons.append(f"manager ledger double-counted {overcount} "
                       "completion(s)")
    if not healed:
        reasons.append("RED divergence still active at the final "
                       f"watermark: {active_red}")
    signals = {"replay.completion_ratio": res["completion_ratio"],
               "replay.ledger_overcount": overcount,
               "replay.extra_done": len(res["extra_done"]),
               "replay.missing": len(res["missing"])}
    slo = _slo.evaluate(CHAOS_SPEC, signals)
    if not slo["ok"]:
        reasons.append(f"SLO breach: {slo['failed'] + slo['unknown']}")

    detected = localized = None
    want = _DETECTION_REQUIRED.get(kind)
    if want is not None:
        hits = [d for d in confirmed if d["class"] == "silent"
                and _proc_of(res, d.get("peer_a") or "").startswith(want)]
        detected = bool(hits)
        localized = detected  # a silent record NAMES the quiet peer
        if not detected:
            reasons.append(f"auditor never confirmed a silent {want} "
                           "episode — the fault went undetected")
    elif kind == "clean":
        if red_confirmed:
            reasons.append("clean replay confirmed RED divergence(s): "
                           f"{red_confirmed}")
    elif kind == "shm_peer_kill":
        # the lane-hygiene contract: the victim's ring must
        # have been negotiated AND unlinked by busd after the kill
        notes = res.get("chaos_notes") or []
        if not any("lane up" in n for n in notes):
            reasons.append("victim never negotiated an shm lane — the "
                           "kill tested nothing")
        if not any("shm lane reaped" in n for n in notes):
            reasons.append("victim's ring file survived the kill — "
                           "busd never reaped the lane")
    verdict = "green" if not reasons else "red"
    return {"fault": kind, "verdict": verdict,
            "outcome_ok": outcome_ok, "healed": healed,
            "detected": detected, "localized": localized,
            "confirmed_divergences": confirmed,
            "slo": {"ok": slo["ok"], "failed": slo["failed"]},
            "reasons": reasons}


def classify_handoff_kill(res: dict) -> dict:
    """The federated-kill verdict:

    - the auditor must confirm a silent MANAGER episode (detection +
      localization; the dead peer never heals, so that record staying
      active at the final watermark is the expected end state);
    - the surviving neighbor must not double-dispatch: no uncaptured id
      completes, the dedup-guarded ledger never overcounts;
    - the handoff protocol must actually have been exercised
      (handoffs_sent >= 1 — a kill before any border crossing tests
      nothing) and the surviving region must still complete tasks.

    Without a standby (JG_HA=0) a dead region manager may strand ITS
    OPEN tasks and the row stays detection-only.  With a standby
    configured the row is RECOVERY-REQUIRED: the dead region's warm
    standby must promote with a digest-equal takeover watermark and
    every captured task must complete exactly once."""
    reasons = []
    confirmed = res["audit"]["confirmed"]
    overcount = max(0, res.get("mgr_completed", 0) - res["expected"])
    fed = res.get("federation") or {}
    ha_on = bool((res.get("ha") or {}).get("enabled"))
    ha_ev = None
    if res["extra_done"]:
        reasons.append(f"uncaptured task id(s) completed: "
                       f"{res['extra_done'][:8]}")
    if overcount:
        reasons.append(f"manager ledger double-counted {overcount} "
                       "completion(s)")
    if not fed.get("handoffs_sent"):
        reasons.append("no handoff ever fired — the kill tested nothing")
    if res["completed"] < 1:
        reasons.append("the surviving region completed no task at all")
    if ha_on:
        # recovery-required: the dead region's open tasks
        # must complete via the promoted manager — zero lost
        if res["missing"]:
            reasons.append(f"{len(res['missing'])} task(s) lost despite "
                           f"a standby: {res['missing'][:8]}")
        ha_ev = _ha_takeover_checks(res, reasons)
    silent_mgr = [d for d in confirmed if d["class"] == "silent"
                  and _proc_of(res, d.get("peer_a") or "").startswith(
                      "manager")]
    detected = bool(silent_mgr)
    if not detected:
        reasons.append("auditor never confirmed a silent manager "
                       "episode — the dead region went undetected")
    # reconvergence judged on every OTHER divergence: the killed
    # manager's own silence is the detection, not a failure to heal
    other_red = [d for d in res["audit"]["active"]
                 if d["class"] in au.RED_CLASSES
                 and not (d["class"] == "silent"
                          and _proc_of(res, d.get("peer_a") or ""
                                       ).startswith("manager"))]
    if other_red:
        reasons.append("RED divergence beyond the killed manager still "
                       f"active at the final watermark: {other_red}")
    return {"fault": "manager_handoff_kill",
            "verdict": "green" if not reasons else "red",
            "outcome_ok": not res["extra_done"] and not overcount
            and (not ha_on or not res["missing"]),
            "healed": not other_red,
            "detected": detected, "localized": detected,
            "ha": ha_ev,
            "recovery_required": ha_on,
            "handoffs_sent": fed.get("handoffs_sent"),
            "handoffs_dup_dropped": fed.get("handoffs_dup_dropped"),
            "confirmed_divergences": confirmed,
            "slo": {"ok": not reasons, "failed": []},
            "reasons": reasons}


def determinism_verdict(a: dict, b: dict) -> dict:
    """The replay determinism proof (acceptance): two replays
    of one capture must complete the IDENTICAL task-id set and land
    EQUAL audit ledger/view digests at the final (drained) watermark.
    Lane digests (positions) are compared informationally only — the
    planner's assignment interleaving is live by design."""
    completed_equal = a["completed_ids"] == b["completed_ids"]
    digests = {}
    proof_ok = completed_equal
    for key in ("ledger", "view", "view_agents", "lanes"):
        da, db = a["digests"].get(key), b["digests"].get(key)
        if da is None and db is None:
            # never beaconed on this solver path: absent, not unequal —
            # but for the PROOF sections absence still fails (a proof
            # needs evidence)
            equal = None
        else:
            equal = (da is not None and db is not None
                     and da["digest"] == db["digest"]
                     and da["count"] == db["count"])
        digests[key] = {
            "a": None if da is None else f"{da['digest']}/{da['count']}",
            "b": None if db is None else f"{db['digest']}/{db['count']}",
            "equal": equal}
        if key in ("ledger", "view"):
            proof_ok = proof_ok and equal is True
    return {"completed_equal": completed_equal,
            "completed": len(a["completed_ids"]),
            "digests": digests,
            "both_outcomes_ok": a["ok"] and b["ok"],
            "ok": proof_ok and a["ok"] and b["ok"]}


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def run_matrix(capture: dict, faults, log_dir, no_trace: bool,
               drain_s=None, solver_override=None,
               ha_kinds=()) -> dict:
    from analysis import torch_fleetsim as fleetsim

    rows = []
    for i, kind in enumerate(faults):
        fault = build_fault(kind, capture,
                            ha=True if kind in ha_kinds else None)
        solver = (solver_override or capture["fleet"].get("solver")
                  or "native")
        if fault.needs_solverd:
            solver = "tpu"
        shards = max(int(capture["fleet"].get("shards") or 1),
                     fault.needs_shards)
        regions = getattr(fault, "needs_regions", None)
        # the warm-standby rows replay with JG_HA=1 pairs
        ha = bool(getattr(fault, "ha", False))
        print(f"chaos_gate: [{i + 1}/{len(faults)}] fault={kind} "
              f"solver={solver} shards={shards}"
              + (f" regions={regions}" if regions else "")
              + (" ha" if ha else ""), flush=True)
        t0 = time.monotonic()
        res = fleetsim.run_replay(
            capture, log_dir, solver=solver, shards=shards,
            no_trace=no_trace, drain_s=drain_s,
            chaos=None if kind == "clean" else fault,
            label=f"{i}_{kind}", regions=regions, ha=ha)
        verdict = classify(kind, res)
        verdict["fault_detail"] = fault.summary()
        verdict["elapsed_s"] = round(time.monotonic() - t0, 1)
        verdict["replay"] = {k: res[k] for k in
                             ("completed", "expected", "missing",
                              "extra_done", "done_dups",
                              "mgr_completed", "window_tasks_per_s",
                              "drift", "wall_s", "digests",
                              "federation", "ha", "chaos_notes")}
        rows.append((verdict, res))
        print(f"chaos_gate: {kind} -> {verdict['verdict'].upper()}"
              + (f" ({'; '.join(verdict['reasons'])})"
                 if verdict["reasons"] else ""), flush=True)
    return rows


def write_artifact(out: Path, doc: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")
    md = ["# replay + chaos matrix", "",
          f"capture: `{doc['capture']}` "
          f"({doc['capture_tasks']} task(s), "
          f"{doc['capture_world_events']} world event(s), "
          f"{doc['capture_duration_s']}s)", ""]
    det = doc.get("determinism")
    if det:
        md.append(f"## determinism proof — "
                  f"{'**PASS**' if det['ok'] else '**FAIL**'}")
        md.append("")
        md.append(f"- completed-task sets identical: "
                  f"{det['completed_equal']} "
                  f"({det['completed']} tasks)")
        for k, v in det["digests"].items():
            state = ("absent (not beaconed)" if v["equal"] is None
                     else "equal" if v["equal"] else "DIFFER")
            md.append(f"- {k} digest: `{v['a']}` vs `{v['b']}` — "
                      + state
                      + (" (informational)" if k in ("lanes",)
                         else ""))
        md.append("")
    if doc.get("matrix"):
        md += ["## chaos matrix", "",
               "| fault | verdict | detected | localized | healed "
               "| completed | dups | tasks/s drift |",
               "|---|---|---|---|---|---|---|---|"]
        for v in doc["matrix"]:
            r = v["replay"]
            drift = (r.get("drift") or {}).get("tasks_per_s_pct")
            md.append(
                f"| {v['fault']} | {v['verdict'].upper()} "
                f"| {v.get('detected')} | {v.get('localized')} "
                f"| {v['healed']} "
                f"| {r['completed']}/{r['expected']} "
                f"| {r['done_dups']} "
                f"| {drift if drift is not None else '-'}% |")
        md.append("")
    out.with_name(out.name + ".md").write_text("\n".join(md) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--capture", required=True,
                    help="capture1 file to replay (fleetsim --capture / "
                         "blackbox --capture / auditor auto-dump)")
    ap.add_argument("--faults", default="clean",
                    help=f"comma list of {', '.join(FAULT_KINDS)}")
    ap.add_argument("--ci", action="store_true",
                    help="the CI gate: clean determinism PAIR (two "
                         "replays must agree on completed sets + "
                         "ledger/view digests) then an injected "
                         "solverd SIGKILL that MUST be detected + "
                         "localized by the audit plane")
    ap.add_argument("--determinism", action="store_true",
                    help="run the clean replay twice and add the "
                         "determinism verdict to the artifact")
    ap.add_argument("--trace", action="store_true",
                    help="run replays under JG_TRACE=1 (phase-drift "
                         "fidelity lands in the artifact; slower)")
    ap.add_argument("--solver", choices=["native", "tpu"], default=None,
                    help="override the capture's solver (e.g. drive a "
                         "native capture through a mesh solverd: --solver "
                         "tpu + JG_SOLVER_MESH=2)")
    ap.add_argument("--drain-s", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--log-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_chaos_logs"))
    ap.add_argument("--cpu", action="store_true",
                    help="run solverd on the CPU (the default is the card)")
    args = ap.parse_args(argv)
    from analysis import torch_fleetsim
    torch_fleetsim.SOLVERD_DEVICE_ARGS[:] = ["--cpu"] if args.cpu else []

    try:
        capture = _capture.load(args.capture)
    except _capture.CaptureError as e:
        print(f"chaos_gate: bad capture {args.capture}: {e}",
              file=sys.stderr)
        return 2

    faults = [f.strip() for f in args.faults.split(",") if f.strip()]
    ha_kinds = set()
    if args.ci:
        # the CI matrix (+ 14 + 15): determinism pair, the
        # solverd kill that MUST be detected, the flat SIGKILL-the-
        # active failover that MUST recover (warm standby, digest-equal
        # takeover, exact-once), and the federated manager kill —
        # recovery-required too now that every region pair has a
        # standby
        faults = ["clean", "clean", "solverd_sigkill",
                  "manager_kill_failover", "manager_handoff_kill"]
        ha_kinds = {"manager_kill_failover", "manager_handoff_kill"}
    elif args.determinism:
        faults = ["clean"] + faults

    rows = run_matrix(capture, faults, args.log_dir,
                      no_trace=not args.trace, drain_s=args.drain_s,
                      solver_override=args.solver, ha_kinds=ha_kinds)

    determinism = None
    clean_results = [res for v, res in rows if v["fault"] == "clean"]
    if len(clean_results) >= 2:
        determinism = determinism_verdict(clean_results[0],
                                          clean_results[1])
        print("chaos_gate: determinism proof "
              + ("PASS" if determinism["ok"] else "FAIL")
              + f" — completed sets equal={determinism['completed_equal']}"
              + ", " + ", ".join(
                  f"{k}={'absent' if v['equal'] is None else '==' if v['equal'] else '!='}"
                  for k, v in determinism["digests"].items()),
              flush=True)

    doc = {
        "experiment": "deterministic replay + audit-judged chaos matrix",
        "capture": str(args.capture),
        "solver_override": args.solver,
        "solver_mesh": os.environ.get("JG_SOLVER_MESH") or None,
        "capture_tasks": len(capture["tasks"]),
        "capture_world_events": len(capture.get("world") or []),
        "capture_duration_s": round(capture["duration_ms"] / 1000.0, 1),
        "baseline": capture.get("baseline"),
        "determinism": determinism,
        "matrix": [v for v, _ in rows],
    }
    if args.out:
        write_artifact(Path(args.out), doc)

    ok = all(v["verdict"] == "green" for v, _ in rows)
    if determinism is not None:
        ok = ok and determinism["ok"]
    if args.ci:
        kill = next(v for v, _ in rows if v["fault"] == "solverd_sigkill")
        ok = ok and kill["detected"] and kill["localized"]
        hk = next(v for v, _ in rows
                  if v["fault"] == "manager_handoff_kill")
        ok = ok and hk["detected"] and bool(hk.get("handoffs_sent"))
        # the failover acceptance: takeover announced with
        # digest-equal watermark AND nothing lost or duplicated
        fo = next(v for v, _ in rows
                  if v["fault"] == "manager_kill_failover")
        ok = ok and fo["detected"] and fo["outcome_ok"] \
            and bool((fo.get("ha") or {}).get("digests_equal"))
    print(json.dumps({"faults": faults,
                      "verdicts": {v["fault"]: v["verdict"]
                                   for v, _ in rows},
                      "determinism_ok": (determinism or {}).get("ok"),
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
