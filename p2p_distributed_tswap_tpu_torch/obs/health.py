"""Continuous fleet health plane: rollup history, multi-window
SLO burn rates, breach forecasting, and per-component attribution.

Every SLO surface before this PR is point-in-time — obs/slo.py judges
one saved signals blob, fleet_top renders the instantaneous rollup —
so nothing watches *trends*, predicts a breach before it lands, or
emits a machine-readable alert an autoscaler could act on.  This module
is that watcher, following the multi-window burn-rate discipline of the
SRE Workbook alerting chapter and the durable-rollup-history shape of
Monarch (VLDB '20):

- **the history ring** — :class:`HealthRing` samples the fleet rollup's
  flattened signals every evaluation beat into bounded, versioned
  ``health1`` records (same STRICT version discipline as ``capture1`` /
  ``ledger1``: any other version string is REJECTED, never
  half-interpreted), optionally persisted to an on-disk jsonl that is
  compacted in place once it doubles its capacity;
- **multi-window burn rates** — per SLO, the FAST window (default 3
  samples) confirms: every sample in it must breach, sustained for a
  fresh-evidence confirm streak (the auditor's episode idiom — one
  transient sample never alerts), while the SLOW window (default 12)
  de-flaps: a confirmed episode only heals once the slow window is
  clean, and a healed episode re-arms so a NEW breach re-confirms;
- **breach forecasting** — :class:`SlopeForecaster` keeps an EWMA of
  each signal's level, slope, and slope residual; a sustained monotone
  trend toward a threshold emits "crosses its SLO in ~45 s" with the
  forecast lead and a residual-gated confidence.  Flat, noisy, and
  step inputs must never forecast — the residual EWMA tracks exactly
  the evidence that the slope is NOT a trend;
- **attribution** — each alert names the driving component by diffing
  the rollup's per-shard (``bus``), per-region (``federation``),
  per-tenant (audit ``ns``) and per-peer sections, and carries a
  ``recommendation`` (direction + actuator hint out of
  ``spawn_shard``/``kill_shard``/``split_region``/``merge_regions``/
  ``evict_tenant``/``shed_load``) — the wire contract handed to
  ROADMAP item 1's future actuation daemon.

Alerts publish as versioned ``alert1`` records on the raw
``mapd.alert`` topic and append to ``<record dir>/healthd.alerts.jsonl``
(``analysis/blackbox.py --alerts`` merges them into the post-mortem
readout); a confirmed page-severity breach triggers the auditor's
auto-capture path, so every page ships with a replayable ``capture1``
regression artifact.

``JG_HEALTH`` unset/0 is the kill switch (HA idiom, default OFF): no
fleet component subscribes ``mapd.alert`` and the wire stays
byte-identical (live raw-socket pin test in tests/test_health.py).
The standalone runner is the explicit opt-in:

    JG_HEALTH=1 python -m p2p_distributed_tswap_tpu_torch.obs.health \\
        --port 7400 [--record DIR] [--spec FILE] [--for 60]
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from p2p_distributed_tswap_tpu_torch.obs import slo as _slo

ALERT_TOPIC = "mapd.alert"
HEALTH_VERSION = "health1"
ALERT_VERSION = "alert1"
KILL_ENV = "JG_HEALTH"
INTERVAL_ENV = "JG_HEALTH_INTERVAL_S"
# sample the rollup every beacon interval: evaluating faster only
# re-reads the same beacons (fresh-evidence gating would skip anyway)
HEALTH_INTERVAL_S = 2.0

FAST_WINDOW = 3     # samples — ALL must breach before an episode confirms
SLOW_WINDOW = 12    # samples — ALL must be clean before an episode heals
CONFIRM_STREAK = 2  # fresh-evidence evaluation rounds (auditor idiom)

FORECAST_MIN_SAMPLES = 5
FORECAST_CONFIDENCE = 0.5
FORECAST_HORIZON_S = 180.0
EWMA_ALPHA = 0.35

RING_CAP = 512

SEVERITY_PAGE = "page"
SEVERITY_WARN = "warn"
ALERT_KINDS = ("breach", "forecast")
ALERT_STATES = ("confirmed", "healed")

ACTUATORS = ("spawn_shard", "kill_shard", "split_region",
             "merge_regions", "evict_tenant", "shed_load")


def enabled() -> bool:
    """The health plane is OFF unless JG_HEALTH is set truthy — the
    default keeps the wire byte-identical to the pre-health build."""
    return os.environ.get(KILL_ENV, "") not in ("", "0")


def interval_s() -> float:
    try:
        return float(os.environ.get(INTERVAL_ENV, "")
                     or HEALTH_INTERVAL_S)
    except ValueError:
        return HEALTH_INTERVAL_S


def _now_ms() -> int:
    return time.time_ns() // 1_000_000


# ---------------------------------------------------------------------------
# health1 / alert1 records — STRICT versioned codecs (capture1 discipline)
# ---------------------------------------------------------------------------

class HealthError(ValueError):
    """Malformed health1/alert1 record (bad version, shape, or field)."""


def validate_health(rec: dict) -> dict:
    """Validate one ``health1`` ring record.  Raises
    :class:`HealthError` on anything a reader could misinterpret —
    including any version other than ``health1``: an unknown schema
    must be REJECTED, never half-read."""
    if not isinstance(rec, dict):
        raise HealthError("health record must be a JSON object")
    version = rec.get("version")
    if version != HEALTH_VERSION:
        raise HealthError(
            f"unsupported health version {version!r} "
            f"(this build reads {HEALTH_VERSION!r} only)")
    for k in ("ts_ms", "seq"):
        if not isinstance(rec.get(k), int):
            raise HealthError(f"health.{k} missing or not an int")
    if not isinstance(rec.get("signals"), dict):
        raise HealthError("health.signals missing or not an object")
    for k in ("failed", "unknown"):
        if not isinstance(rec.get(k, []), list):
            raise HealthError(f"health.{k} must be a list")
    return rec


def validate_alert(rec: dict) -> dict:
    """Validate one ``alert1`` record — the wire contract the future
    actuation daemon consumes, so every field it routes on is checked
    here, with the same strict-version rule as ``health1``."""
    if not isinstance(rec, dict):
        raise HealthError("alert must be a JSON object")
    version = rec.get("version")
    if version != ALERT_VERSION:
        raise HealthError(
            f"unsupported alert version {version!r} "
            f"(this build reads {ALERT_VERSION!r} only)")
    if not isinstance(rec.get("ts_ms"), int):
        raise HealthError("alert.ts_ms missing or not an int")
    for k in ("name", "signal"):
        if not isinstance(rec.get(k), str) or not rec[k]:
            raise HealthError(f"alert.{k} missing or empty")
    if rec.get("kind") not in ALERT_KINDS:
        raise HealthError(f"alert.kind {rec.get('kind')!r} not in "
                          f"{ALERT_KINDS}")
    if rec.get("state") not in ALERT_STATES:
        raise HealthError(f"alert.state {rec.get('state')!r} not in "
                          f"{ALERT_STATES}")
    if rec.get("severity") not in (SEVERITY_PAGE, SEVERITY_WARN):
        raise HealthError(f"alert.severity {rec.get('severity')!r} "
                          "must be page or warn")
    reco = rec.get("recommendation")
    if reco is not None:
        if not isinstance(reco, dict) \
                or reco.get("actuator") not in ACTUATORS \
                or reco.get("direction") not in ("up", "down"):
            raise HealthError(
                "alert.recommendation needs a known actuator "
                f"({'/'.join(ACTUATORS)}) and an up/down direction")
    fc = rec.get("forecast")
    if fc is not None:
        if not isinstance(fc, dict) \
                or not isinstance(fc.get("eta_s"), (int, float)) \
                or not isinstance(fc.get("confidence"), (int, float)):
            raise HealthError(
                "alert.forecast needs numeric eta_s and confidence")
    return rec


class HealthRing:
    """Bounded time-series of ``health1`` records — the durable rollup
    history the forecaster extrapolates over.  With a ``path`` the ring
    persists as append-only jsonl, compacted in place once the file
    doubles the cap (append stays O(1) amortized; a crash loses at most
    the compaction window, never corrupts — every load re-validates)."""

    def __init__(self, path: Optional[str] = None, cap: int = RING_CAP):
        self.path = str(path) if path else None
        self.cap = max(2, int(cap))
        self.records: Deque[dict] = collections.deque(maxlen=self.cap)
        self._file_lines = 0
        if self.path and os.path.exists(self.path):
            for rec in self.load(self.path):
                self.records.append(rec)
            self._file_lines = len(self.records)

    def append(self, rec: dict) -> dict:
        validate_health(rec)
        self.records.append(rec)
        if self.path:
            if self._file_lines >= 2 * self.cap:
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    for r in self.records:
                        f.write(json.dumps(r) + "\n")
                os.replace(tmp, self.path)
                self._file_lines = len(self.records)
            else:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                self._file_lines += 1
        return rec

    @staticmethod
    def load(path) -> List[dict]:
        """Read + validate a persisted ring.  A malformed or
        wrong-version record raises :class:`HealthError` — history a
        forecaster would silently misread is worse than no history."""
        out = []
        with open(path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise HealthError(
                        f"{path}:{i + 1}: not JSON: {e}") from None
                out.append(validate_health(rec))
        return out


# ---------------------------------------------------------------------------
# EWMA-slope breach forecasting
# ---------------------------------------------------------------------------

class SlopeForecaster:
    """EWMA level/slope/residual tracker for one signal.

    ``observe`` feeds ``(t_s, value)`` samples; ``forecast`` answers
    "does the current trend cross ``threshold`` within the horizon, and
    how sure are we".  Confidence is ``1 - residual/|slope|``: a
    monotone ramp drives the residual toward zero (confidence → 1),
    while flat series have no slope, noisy series carry residual ≥
    |slope|, and a step spikes the residual exactly when it spikes the
    slope — none of them forecast."""

    def __init__(self, alpha: float = EWMA_ALPHA,
                 min_samples: int = FORECAST_MIN_SAMPLES,
                 horizon_s: float = FORECAST_HORIZON_S,
                 min_confidence: float = FORECAST_CONFIDENCE):
        self.alpha = alpha
        self.min_samples = min_samples
        self.horizon_s = horizon_s
        self.min_confidence = min_confidence
        self.value: Optional[float] = None
        self.slope = 0.0   # EWMA of per-second deltas
        self.resid = 0.0   # EWMA of |delta - slope| (trend noise)
        self.n = 0
        self._last_t: Optional[float] = None

    def observe(self, t_s: float, value: float) -> None:
        if self.value is None or self._last_t is None:
            self.value, self._last_t, self.n = float(value), t_s, 1
            return
        dt = t_s - self._last_t
        if dt <= 0:
            return
        d = (float(value) - self.value) / dt
        a = self.alpha
        # residual against the PRE-update slope: a step's huge delta
        # lands in the residual in the same beat it lands in the slope
        self.resid = (1 - a) * self.resid + a * abs(d - self.slope)
        self.slope = (1 - a) * self.slope + a * d
        self.value, self._last_t = float(value), t_s
        self.n += 1

    def confidence(self) -> float:
        if abs(self.slope) < 1e-12:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.resid / abs(self.slope)))

    def forecast(self, threshold: float,
                 bound: str) -> Optional[dict]:
        """Crossing prediction for a ``max`` bound (value climbing into
        it) or a ``min`` bound (value falling out of it).  None unless
        the trend is sustained, monotone toward the bound, confident,
        and lands inside the horizon."""
        if self.value is None or self.n < self.min_samples:
            return None
        if bound == "max":
            if self.slope <= 0 or self.value > threshold:
                return None
        elif bound == "min":
            if self.slope >= 0 or self.value < threshold:
                return None
        else:
            return None
        conf = self.confidence()
        if conf < self.min_confidence:
            return None
        eta_s = (threshold - self.value) / self.slope
        if not (0.0 < eta_s <= self.horizon_s):
            return None
        return {"eta_s": round(eta_s, 1),
                "confidence": round(conf, 3),
                "slope_per_s": round(self.slope, 6)}


# ---------------------------------------------------------------------------
# attribution: name the driving component, recommend an actuator
# ---------------------------------------------------------------------------

def _counter(d: Optional[dict], k: str) -> float:
    v = (d or {}).get(k)
    return float(v) if isinstance(v, (int, float)) else 0.0


def _hot_shard(rollup: dict, prev: Optional[dict]) -> Optional[dict]:
    """The busd pool member under the most pressure: shed/eviction
    growth first (actual harm), then queue depth, then fanout load."""
    prev_bus = {peer: p.get("bus")
                for peer, p in ((prev or {}).get("peers") or {}).items()}
    best, best_score = None, 0.0
    for peer, p in (rollup.get("peers") or {}).items():
        bus = p.get("bus")
        if not bus:
            continue
        pb = prev_bus.get(peer)
        shed = (_counter(bus, "slow_consumer_drops")
                + _counter(bus, "slow_consumer_evictions")
                - _counter(pb, "slow_consumer_drops")
                - _counter(pb, "slow_consumer_evictions"))
        score = (max(0.0, shed) * 1e6
                 + _counter(bus, "queued_bytes")
                 + _counter(bus, "fanout_kbps"))
        if score > best_score:
            shard = p.get("shard")
            best_score = score
            best = {"kind": "bus_shard",
                    "id": f"s{shard}" if shard is not None else peer,
                    "peer": peer, "proc": p.get("proc"),
                    "detail": (f"q={int(_counter(bus, 'queued_bytes'))}B"
                               f" shed=+{int(max(0.0, shed))}"
                               f" fanout={bus.get('fanout_kbps')}kbps")}
    return best


def _hot_region(rollup: dict, direction: str) -> Optional[dict]:
    """The driving region: under pressure, the one with the most
    stuck handoffs / the hottest task rate; when shrinking, the
    coldest one (the merge candidate)."""
    fed = rollup.get("federation")
    per = (fed or {}).get("per_region") or {}
    if not per:
        return None
    def load(r):
        return (_counter(r, "pending_handoffs") * 1000.0
                + _counter(r, "tasks_per_s"))
    pick = (max if direction == "up" else min)(
        per.items(), key=lambda kv: load(kv[1]))
    rname, r = pick
    return {"kind": "region", "id": rname, "peer": r.get("peer"),
            "detail": (f"tasks/s={r.get('tasks_per_s')}"
                       f" pending={r.get('pending_handoffs')}"
                       f" sent/acked={r.get('handoffs_sent')}"
                       f"/{r.get('handoffs_acked')}")}


def _hot_tenant(rollup: dict) -> Optional[dict]:
    """A tenant implicated by the audit plane: the namespace of the
    newest active divergence (the only per-tenant evidence the rollup
    carries today)."""
    audit = rollup.get("audit") or {}
    for d in reversed(audit.get("active") or []):
        if d.get("ns"):
            return {"kind": "tenant", "id": d["ns"],
                    "peer": d.get("peer_a"),
                    "detail": f"audit [{d.get('class')}]: "
                              f"{d.get('detail')}"}
    return None


def _hot_peer(rollup: dict, prev: Optional[dict]) -> Optional[dict]:
    """Per-peer fallback: the manager with the largest open backlog
    growth, else the worst tick p95, else a stale peer."""
    prev_peers = (prev or {}).get("peers") or {}
    best, best_backlog = None, 0.0
    worst_tick, worst_p95 = None, 0.0
    stale = None
    for peer, p in (rollup.get("peers") or {}).items():
        mt = p.get("mgr_tasks")
        if mt:
            # open work = queued (capacity-gated, not yet assigned)
            # plus in-flight (dispatched but not completed)
            backlog = (_counter(mt, "pending")
                       + _counter(mt, "dispatched")
                       - _counter(mt, "completed"))
            pmt = (prev_peers.get(peer) or {}).get("mgr_tasks")
            growth = backlog - (_counter(pmt, "pending")
                                + _counter(pmt, "dispatched")
                                - _counter(pmt, "completed"))
            score = max(growth, 0.0) * 1000.0 + backlog
            if score > best_backlog and backlog > 0:
                best_backlog = score
                best = {"kind": "peer", "id": peer, "peer": peer,
                        "proc": p.get("proc"),
                        "detail": f"backlog={int(backlog)} open task(s)"
                                  f" (+{int(max(growth, 0.0))})"}
        t = p.get("tick")
        if t and (t.get("p95_ms") or 0) > worst_p95:
            worst_p95 = t["p95_ms"]
            worst_tick = {"kind": "peer", "id": peer, "peer": peer,
                          "proc": p.get("proc"),
                          "detail": f"tick p95={t['p95_ms']}ms"
                                    f" over={t.get('over_budget')}"}
        if p.get("stale") and stale is None:
            stale = {"kind": "peer", "id": peer, "peer": peer,
                     "proc": p.get("proc"),
                     "detail": f"stale {p.get('age_s')}s"}
    return best or worst_tick or stale


_ACTUATOR = {
    ("bus_shard", "up"): "spawn_shard",
    ("bus_shard", "down"): "kill_shard",
    ("region", "up"): "split_region",
    ("region", "down"): "merge_regions",
    ("tenant", "up"): "evict_tenant",
    ("tenant", "down"): "evict_tenant",
}


def attribute(rollup: Optional[dict], prev: Optional[dict],
              slo_entry: dict, verdict: dict
              ) -> Tuple[Optional[dict], Optional[dict]]:
    """``(attribution, recommendation)`` for one alerting SLO.

    The breached signal routes the search — a ``bus.*`` signal looks at
    shards first, a ``fed.*`` signal at regions — then the fallback
    chain walks shard → region → tenant → peer until a section yields a
    driver.  Direction: a ``max`` breach is rising pressure ("up"); a
    ``min`` breach is "up" too when the fleet holds a backlog (it
    cannot keep up), and "down" only when the fleet is genuinely idle
    (the scale-in signal)."""
    threshold = verdict.get("threshold") or {}
    fleet = (rollup or {}).get("fleet") or {}
    backlog = ((fleet.get("tasks_pending") or 0)
               + (fleet.get("tasks_dispatched") or 0)
               - (fleet.get("tasks_completed") or 0))
    if "max" in threshold and "min" not in threshold:
        direction = "up"
    else:
        direction = "up" if backlog > 0 else "down"
    sig = slo_entry.get("signal") or ""
    chain: List[Optional[dict]] = []
    if sig.startswith("bus."):
        chain.append(_hot_shard(rollup or {}, prev))
    if sig.startswith("fed."):
        chain.append(_hot_region(rollup or {}, direction))
    chain += [_hot_shard(rollup or {}, prev) if sig.startswith("bus.")
              else None,
              _hot_region(rollup or {}, direction),
              _hot_tenant(rollup or {}),
              _hot_peer(rollup or {}, prev)]
    att = next((c for c in chain if c), None)
    if att is None:
        return None, {"direction": direction, "actuator": "shed_load",
                      "target": "fleet"}
    actuator = _ACTUATOR.get((att["kind"], direction), "shed_load")
    return att, {"direction": direction, "actuator": actuator,
                 "target": att["id"]}


# ---------------------------------------------------------------------------
# the engine: burn windows + episodes + forecasts over the ring
# ---------------------------------------------------------------------------

class _SloState:
    __slots__ = ("window", "forecaster", "streak", "mark", "confirmed",
                 "forecast_active")

    def __init__(self, slow: int, forecaster: SlopeForecaster):
        # (seq, breached) per sample; maxlen = the slow window
        self.window: Deque[Tuple[int, bool]] = collections.deque(
            maxlen=slow)
        self.forecaster = forecaster
        self.streak = 0
        self.mark = None  # fresh-evidence mark (auditor idiom)
        self.confirmed = False
        self.forecast_active = False


class HealthEngine:
    """The evaluation core: feed :meth:`observe` one fleet rollup per
    beat; it samples the signals into the ring, judges every SLO through
    the shared obs/slo.py core, advances burn windows / forecasters /
    episodes, and returns the newly emitted ``alert1`` records."""

    def __init__(self, spec=None, ring: Optional[HealthRing] = None,
                 interval: Optional[float] = None,
                 fast: int = FAST_WINDOW, slow: int = SLOW_WINDOW,
                 confirm: int = CONFIRM_STREAK,
                 horizon_s: float = FORECAST_HORIZON_S,
                 min_confidence: float = FORECAST_CONFIDENCE):
        self.spec = _slo.load_spec(spec)
        self.ring = ring or HealthRing()
        self.interval_s = interval_s() if interval is None else interval
        self.fast = max(1, fast)
        self.slow = max(self.fast, slow)
        self.confirm = max(1, confirm)
        self.horizon_s = horizon_s
        self.min_confidence = min_confidence
        self.seq = 0
        self.alerts: List[dict] = []  # emitted history (bounded)
        self._states: Dict[str, _SloState] = {}
        self._prev_rollup: Optional[dict] = None

    def _state(self, name: str) -> _SloState:
        st = self._states.get(name)
        if st is None:
            st = self._states[name] = _SloState(
                self.slow,
                SlopeForecaster(horizon_s=self.horizon_s,
                                min_confidence=self.min_confidence))
        return st

    def burn(self, name: str) -> Dict[str, float]:
        """Fast/slow-window burn rates (breaching sample fraction) for
        one SLO — 0.0 when no samples landed yet."""
        st = self._state(name)
        samples = list(st.window)
        fast = samples[-self.fast:]
        def frac(xs):
            return (sum(1 for _, b in xs if b) / len(xs)) if xs else 0.0
        return {"fast": round(frac(fast), 3),
                "slow": round(frac(samples), 3),
                "fast_window": self.fast, "slow_window": self.slow}

    def _mk_alert(self, now_ms: int, slo_entry: dict, v: dict,
                  kind: str, state: str, severity: str,
                  rollup: Optional[dict],
                  forecast: Optional[dict] = None) -> dict:
        alert = {
            "type": "alert1", "version": ALERT_VERSION,
            "ts_ms": now_ms, "seq": self.seq,
            "name": slo_entry["name"], "signal": slo_entry["signal"],
            "kind": kind, "state": state, "severity": severity,
            "observed": v.get("observed"),
            "threshold": v.get("threshold"),
            "burn": self.burn(slo_entry["name"]),
        }
        if forecast is not None:
            fc = dict(forecast)
            # forecast lead in evaluation intervals: the acceptance
            # number ("fires >= 2 intervals before the hard breach")
            fc["eta_intervals"] = round(fc["eta_s"]
                                        / max(self.interval_s, 1e-9), 1)
            alert["forecast"] = fc
        att, reco = attribute(rollup, self._prev_rollup, slo_entry, v)
        if att is not None:
            alert["attribution"] = att
        alert["recommendation"] = reco
        return validate_alert(alert)

    def observe(self, rollup: dict, now_ms: Optional[int] = None,
                signals: Optional[dict] = None) -> List[dict]:
        """One evaluation beat.  ``signals`` overrides the rollup
        flattening (the smoke threads window-exact values through).
        Returns newly emitted alert1 records, in emit order."""
        now_ms = _now_ms() if now_ms is None else now_ms
        if signals is None:
            signals = _slo.signals_from_rollup(rollup or {})
        self.seq += 1
        verdicts = [_slo.evaluate_one(s, signals)
                    for s in self.spec["slos"]]
        self.ring.append({
            "version": HEALTH_VERSION, "ts_ms": now_ms, "seq": self.seq,
            "interval_s": self.interval_s, "signals": signals,
            "failed": [v["name"] for v in verdicts
                       if v["status"] == "fail"],
            "unknown": [v["name"] for v in verdicts
                        if v["status"] == "unknown"],
        })
        # fresh-evidence mark: a stalled fleet keeps serving the same
        # rollup — streaks and forecasters must only advance on new
        # beacons, or a wedged window would "sustain" itself into a page
        mark = (rollup or {}).get("beacons_ingested")
        out: List[dict] = []
        for slo_entry, v in zip(self.spec["slos"], verdicts):
            st = self._state(slo_entry["name"])
            fresh = mark is None or mark != st.mark
            st.mark = mark
            if not fresh:
                continue
            breached = v["status"] == "fail"
            st.window.append((self.seq, breached))
            if v["status"] != "unknown":
                st.forecaster.observe(now_ms / 1000.0,
                                      float(v["observed"]))
            burn = self.burn(slo_entry["name"])
            # confirm: the whole fast window burns, sustained for the
            # confirm streak — one transient sample never alerts
            fast_full = (len(st.window) >= self.fast
                         and burn["fast"] >= 1.0)
            if fast_full:
                st.streak += 1
            elif not st.confirmed:
                st.streak = 0
            if fast_full and not st.confirmed \
                    and st.streak >= self.confirm:
                st.confirmed = True
                st.forecast_active = False
                out.append(self._mk_alert(
                    now_ms, slo_entry, v, "breach", "confirmed",
                    SEVERITY_PAGE, rollup))
            elif st.confirmed and burn["slow"] <= 0.0:
                # heal only once the SLOW window is clean (de-flap),
                # then re-arm: a new episode re-confirms + re-records
                st.confirmed = False
                st.streak = 0
                out.append(self._mk_alert(
                    now_ms, slo_entry, v, "breach", "healed",
                    SEVERITY_PAGE, rollup))
            if not st.confirmed and not breached:
                fc = None
                threshold = v.get("threshold") or {}
                if "max" in threshold:
                    fc = st.forecaster.forecast(threshold["max"], "max")
                if fc is None and "min" in threshold:
                    fc = st.forecaster.forecast(threshold["min"], "min")
                if fc is not None and not st.forecast_active:
                    st.forecast_active = True
                    out.append(self._mk_alert(
                        now_ms, slo_entry, v, "forecast", "confirmed",
                        SEVERITY_WARN, rollup, forecast=fc))
                elif fc is None:
                    st.forecast_active = False
        self._prev_rollup = rollup
        self.alerts.extend(out)
        del self.alerts[:-256]
        return out

    def active(self) -> List[dict]:
        """Confirmed, un-healed breach episodes — newest record per SLO
        (the auditor's ``active()`` shape, for the rollup/fleet_top)."""
        newest: Dict[str, dict] = {}
        for a in self.alerts:
            if a["kind"] != "breach":
                continue
            if a["state"] == "confirmed":
                newest[a["name"]] = a
            else:
                newest.pop(a["name"], None)
        return [a for name, a in newest.items()
                if self._states.get(name) and self._states[name].confirmed]

    def status(self) -> dict:
        return {
            "seq": self.seq,
            "interval_s": self.interval_s,
            "spec": self.spec.get("name"),
            "alerts": len(self.alerts),
            "active": self.active(),
            "last": self.alerts[-1] if self.alerts else None,
        }


# ---------------------------------------------------------------------------
# the watcher: aggregator + engine behind a bus client (healthd's body)
# ---------------------------------------------------------------------------

class HealthWatcher:
    """Embeds a :class:`FleetAggregator` (which embeds the AuditJoiner)
    and runs the engine on the beacon cadence.  The standalone
    ``healthd`` runner and scripts/health_smoke.py both drive THIS, so
    the smoke proves the daemon's actual path.

    ``capture_dump`` is the flight-ring pull used by the auto-capture
    path: the default publishes bus ``flight_dump`` requests (the
    auditor's idiom); an in-process harness passes its own dumper."""

    def __init__(self, bus=None, engine: Optional[HealthEngine] = None,
                 record_dir: Optional[str] = None,
                 publish: bool = True,
                 capture_dump: Optional[Callable[[], None]] = None,
                 on_alert: Optional[Callable[[dict], None]] = None):
        self.bus = bus
        self.engine = engine or HealthEngine()
        self.record_dir = str(record_dir) if record_dir else None
        self.publish = publish and bus is not None
        self.on_alert = on_alert
        self._capture_dump = capture_dump
        self._cap_at = 0.0
        self._last_beat = 0.0
        self._last_audit_eval = 0.0
        self.alerts_path = None
        if self.record_dir:
            os.makedirs(self.record_dir, exist_ok=True)
            self.alerts_path = os.path.join(self.record_dir,
                                            "healthd.alerts.jsonl")
        from p2p_distributed_tswap_tpu_torch.obs.fleet_aggregator import (
            FleetAggregator)
        self.agg = FleetAggregator()
        if bus is not None:
            from p2p_distributed_tswap_tpu_torch.obs import audit as _audit
            from p2p_distributed_tswap_tpu_torch.obs.beacon import METRICS_TOPIC
            from p2p_distributed_tswap_tpu_torch.runtime import ha as _ha
            bus.subscribe(METRICS_TOPIC)
            if _audit.enabled():
                bus.subscribe(_audit.AUDIT_TOPIC, raw=True)
            if _ha.enabled():
                bus.subscribe(_ha.HA_TOPIC, raw=True)

    # -- the auto-capture path (auditor idiom) ------------------
    def _maybe_capture(self, alert: dict) -> None:
        flight_dir = self.record_dir or os.environ.get("JG_FLIGHT_DIR")
        if not flight_dir:
            return
        now = time.monotonic()
        if now - self._cap_at < 30.0:
            return
        self._cap_at = now
        if self._capture_dump is not None:
            self._capture_dump()
        elif self.bus is not None:
            self.bus.publish("mapd", {"type": "flight_dump"}, raw=True)
            self.bus.publish("solver", {"type": "flight_dump"}, raw=True)
            time.sleep(1.2)  # flight dumps need a beat to land
        from p2p_distributed_tswap_tpu_torch.obs import capture as _capture
        try:
            doc = _capture.from_flight_dir(flight_dir,
                                           source="auto_health")
            path = _capture.save(
                os.path.join(flight_dir, "healthd.capture.json"), doc)
            alert["capture"] = str(path)
        except (_capture.CaptureError, OSError) as e:
            alert["capture_error"] = str(e)

    def _emit(self, alert: dict) -> None:
        # capture FIRST: it enriches the record, and both the published
        # frame and the persisted jsonl line must carry the pointer
        if alert["severity"] == SEVERITY_PAGE \
                and alert["state"] == "confirmed" \
                and alert["kind"] == "breach":
            self._maybe_capture(alert)
        if self.publish:
            self.bus.publish(ALERT_TOPIC, alert, raw=True)
        if self.alerts_path:
            try:
                with open(self.alerts_path, "a") as f:
                    f.write(json.dumps(alert) + "\n")
            except OSError:
                pass
        if self.on_alert is not None:
            try:
                self.on_alert(alert)
            except Exception:
                pass  # a side-channel must never lose the alert itself

    def beat(self, now_ms: Optional[int] = None) -> List[dict]:
        """One evaluation beat: rollup → engine → emit.  Also publishes
        a ``health_beacon`` heartbeat so fleet_top can render the
        watcher's liveness even on a quiet fleet."""
        rollup = self.agg.rollup(now_ms)
        alerts = self.engine.observe(rollup, now_ms=now_ms)
        for a in alerts:
            self._emit(a)
        if self.publish:
            st = self.engine.status()
            self.bus.publish(ALERT_TOPIC, {
                "type": "health_beacon",
                "peer_id": getattr(self.bus, "peer_id", "healthd"),
                "ts_ms": _now_ms() if now_ms is None else now_ms,
                "seq": st["seq"],
                "interval_s": self.engine.interval_s,
                "spec": st["spec"],
                "active": len(st["active"]),
                "alerts": st["alerts"],
            }, raw=True)
        return alerts

    def pump(self, seconds: float) -> List[dict]:
        """Drive the watcher for ``seconds``: ingest beacons, judge the
        embedded auditor mid-window (fleet_top idiom — confirm streaks
        need repeated fresh-evidence rounds), beat on the interval."""
        out: List[dict] = []
        end = time.monotonic() + seconds
        while True:
            remaining = end - time.monotonic()
            if remaining <= 0:
                return out
            if self.bus is not None:
                f = self.bus.recv(timeout=min(0.25, remaining))
                if f and f.get("op") == "msg":
                    self.agg.ingest(f.get("data") or {})
            else:
                time.sleep(min(0.05, remaining))
            now = time.monotonic()
            if self.agg.audit.beacons \
                    and now - self._last_audit_eval > 0.5:
                self._last_audit_eval = now
                self.agg.audit.evaluate()
            if now - self._last_beat >= self.engine.interval_s:
                self._last_beat = now
                out.extend(self.beat())


def render_alert(a: dict) -> str:
    """One operator line per alert (the healthd stdout / smoke shape)."""
    mark = "🔴" if a["severity"] == SEVERITY_PAGE else "🟡"
    if a["state"] == "healed":
        mark = "🟢"
    line = (f"{mark} {a['severity'].upper()} {a['kind']} {a['state']} "
            f"[{a['name']}] {a['signal']}={a.get('observed')} "
            f"burn {a['burn']['fast']:g}/{a['burn']['slow']:g}")
    fc = a.get("forecast")
    if fc:
        line += (f" crosses in ~{fc['eta_s']:g}s "
                 f"({fc['eta_intervals']:g} intervals, "
                 f"conf {fc['confidence']:g})")
    att = a.get("attribution")
    if att:
        line += f" ← {att['kind']} {att['id']} ({att['detail']})"
    reco = a.get("recommendation")
    if reco:
        line += f" ⇒ {reco['actuator']}({reco['target']})"
    if a.get("capture"):
        line += f" 📼 {a['capture']}"
    return line


# ---------------------------------------------------------------------------
# the healthd runner
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    import sys

    from p2p_distributed_tswap_tpu_torch.runtime.bus_client import BusClient

    ap = argparse.ArgumentParser(
        description="continuous fleet health watcher (mapd.alert)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7400)
    ap.add_argument("--interval", type=float, default=None,
                    help="evaluation beat seconds (default: "
                         f"$JG_HEALTH_INTERVAL_S or {HEALTH_INTERVAL_S})")
    ap.add_argument("--spec", default=None,
                    help="SLO spec JSON (default: built-in rated-load)")
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="append alert1 records to DIR/healthd.alerts."
                         "jsonl, persist the health1 ring to "
                         "DIR/healthd.ring.jsonl, and dump auto-"
                         "captures next to them")
    ap.add_argument("--for", dest="duration", type=float, default=0.0,
                    help="run for N seconds then exit (0 = forever); "
                         "exit 1 if any page fired, 2 if no beacons")
    ap.add_argument("--json", action="store_true",
                    help="print the final status as JSON (with --for)")
    args = ap.parse_args(argv)

    # launching the daemon IS the opt-in — arm the plane in-process so
    # the embedded helpers (and any child we spawn) agree it is on
    os.environ.setdefault(KILL_ENV, "1")
    ring = None
    if args.record:
        os.makedirs(args.record, exist_ok=True)
        ring = HealthRing(os.path.join(args.record,
                                       "healthd.ring.jsonl"))
    engine = HealthEngine(spec=args.spec, ring=ring,
                          interval=args.interval)
    try:
        bus = BusClient(host=args.host, port=args.port,
                        peer_id="healthd",
                        reconnect=args.duration <= 0)
    except OSError as e:
        print(f"healthd: cannot reach bus at {args.host}:{args.port} "
              f"({e})", file=sys.stderr)
        return 2
    watcher = HealthWatcher(
        bus, engine, record_dir=args.record,
        on_alert=lambda a: print(render_alert(a), flush=True))

    pages = 0

    def count_pages(alerts):
        nonlocal pages
        pages += sum(1 for a in alerts
                     if a["severity"] == SEVERITY_PAGE
                     and a["state"] == "confirmed")

    try:
        if args.duration > 0:
            count_pages(watcher.pump(args.duration))
            st = engine.status()
            if args.json:
                print(json.dumps(st, indent=2))
            else:
                print(f"HEALTH spec={st['spec']} seq={st['seq']} "
                      f"alerts={st['alerts']} "
                      f"active={len(st['active'])}")
            if watcher.agg.beacons_ingested == 0:
                return 2
            return 1 if pages else 0
        while True:
            count_pages(watcher.pump(10.0))
            st = engine.status()
            print(f"HEALTH spec={st['spec']} seq={st['seq']} "
                  f"alerts={st['alerts']} active={len(st['active'])}",
                  flush=True)
    except KeyboardInterrupt:
        return 0
    finally:
        bus.close()


if __name__ == "__main__":
    import sys
    sys.exit(main())
