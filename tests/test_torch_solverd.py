"""The port's serving path (``runtime/solverd.py``) against the JAX
package's, reply for reply.

A closed-loop fleet (it adopts the moves and the returned goals of every
reply, and its tasks churn) feeds the same request stream to a JAX
``TickRunner`` and to the port's on the CPU.  Every reply must be the same
bytes apart from ``duration_micros``: the packed ``data``, the JSON
``moves``, and the audit digests.  Both runners pin their deferred-fields
mode.  Covered: the legacy JSON wire with padded lanes on an occupied cell
0, packed snapshots and deltas with joins, leaves and churn, a snapshot
resync after a seq gap, deferred fields parked on the STAY row, LRU
eviction under a small cache, world updates (STAY patch, then repair),
malformed packets, the trace context echo, the audit lane / mirror /
device / fields digests and drills, the pipelined order (request k+1
scattered before reply k is fetched), and a hand-off of the serving state
from the JAX daemon to the port's mid-stream (``convert``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.obs import audit as jaudit
from p2p_distributed_tswap_tpu.runtime import plan_codec as jpc
from p2p_distributed_tswap_tpu.runtime import solverd as jsd
from p2p_distributed_tswap_tpu_torch import convert
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.obs import registry as treg
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
from p2p_distributed_tswap_tpu_torch.runtime import solverd as tsd

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for k in ("JG_DYNAMIC_WORLD", "JG_DEFER_FIELDS", "JG_SECTOR",
              "MAPD_FUSED", "JG_TRACE_CTX"):
        monkeypatch.delenv(k, raising=False)


def _grid(side=20, seed=3):
    rng = np.random.default_rng(seed)
    free = rng.random((side, side)) > 0.12
    free[0, 0] = True
    return free


def _pair(free, defer, capacity_min=8):
    """A JAX runner and a port runner on the same grid, deferred fields
    pinned on both."""
    jg, tg = JaxGrid(free.copy()), Grid(free.copy())
    j = jsd.TickRunner(jsd.PlanService(jg, capacity_min=capacity_min), jg)
    t = tsd.TickRunner(tsd.PlanService(tg, capacity_min=capacity_min,
                                       device=CPU), tg)
    j.service.defer_fields = t.service.defer_fields = defer
    return j, t


def _strip(resp):
    if resp is None:
        return None
    return {k: v for k, v in resp.items() if k != "duration_micros"}


class Fleet:
    """The manager's side: a roster of (pos, goal) per peer that adopts
    every reply's moves and returned goals, churns its tasks, and admits
    and retires peers."""

    def __init__(self, free, n, seed):
        self.w = free.shape[1]
        self.rng = np.random.default_rng(seed)
        self.cells = np.flatnonzero(free.reshape(-1))
        starts = self.rng.choice(self.cells[self.cells != 0], n,
                                 replace=False)
        starts[0] = 0  # an agent on cell 0, where padded lanes sit
        self.fleet = {f"p{k}": [int(starts[k]), int(self.rng.choice(
            self.cells))] for k in range(n)}
        self.next_id = n

    def items(self):
        return [(n, p, g) for n, (p, g) in self.fleet.items()]

    def json_request(self, seq):
        w = self.w
        return {"type": "plan_request", "seq": seq, "agents": [
            {"peer_id": n, "pos": [p % w, p // w], "goal": [g % w, g // w]}
            for n, p, g in self.items()]}

    def adopt_json(self, resp):
        w = self.w
        for m in resp["moves"]:
            x, y = m["next_pos"]
            gx, gy = m["goal"]
            if m["peer_id"] in self.fleet:
                self.fleet[m["peer_id"]] = [y * w + x, gy * w + gx]

    def adopt_packed(self, resp, names):
        rp = pc.decode_b64(resp["data"])
        for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
            name = names[int(lane)]
            if name in self.fleet:
                self.fleet[name] = [int(c), int(g)]

    def churn(self, tick, joins=True):
        rng = self.rng
        for name in list(self.fleet):
            p, g = self.fleet[name]
            if p == g or rng.random() < 0.1:  # next task
                self.fleet[name][1] = int(rng.choice(self.cells))
        if joins and tick % 4 == 1 and len(self.fleet) > 3:
            self.fleet.pop(list(self.fleet)[int(rng.integers(
                len(self.fleet)))])
        if joins and tick % 3 == 2:
            taken = {p for p, _ in self.fleet.values()}
            c = int(rng.choice([c for c in self.cells if c not in taken]))
            self.fleet[f"p{self.next_id}"] = [c, int(rng.choice(self.cells))]
            self.next_id += 1


def _packed_request(seq, pkt, caps=True, **extra):
    return {"type": "plan_request", "seq": seq, "codec": pc.CODEC_NAME,
            "caps": [pc.CODEC_NAME] if caps else [],
            "data": pc.encode_b64(pkt), **extra}


def _idle(j, t):
    """The daemon's idle window between ticks, on both sides."""
    while j.service.field_queue or t.service.field_queue:
        assert j.service.process_field_queue() == \
            t.service.process_field_queue()


def _assert_services_equal(j, t):
    js, ts = j.service, t.service
    assert list(js.goal_rows.items()) == list(ts.goal_rows.items())
    assert js.goal_ref == ts.goal_ref
    assert js.lane_wait == ts.lane_wait
    assert list(js.field_queue) == list(ts.field_queue)
    for k in ("pos", "goal", "slot", "active"):
        np.testing.assert_array_equal(getattr(js, f"h_{k}"),
                                      getattr(ts, f"h_{k}"))
        dj, dt = getattr(js, f"d_{k}"), getattr(ts, f"d_{k}")
        assert (dj is None) == (dt is None)
        if dj is not None:
            np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    if js.dirs is not None:
        np.testing.assert_array_equal(
            np.asarray(js.dirs), ts.dirs.numpy().view(np.uint32))


def _assert_audit_equal(j, t):
    seq = t.packed.last_seq or 0
    ej, xj = jsd.audit_entries(j.service, seq)
    et, xt = tsd.audit_entries(t.service, seq)
    assert [dataclasses.astuple(e) for e in ej] == \
        [dataclasses.astuple(e) for e in et]
    assert xj == xt
    assert jaudit.encode_audit(ej) == jaudit.encode_audit(
        [jaudit.AuditEntry(*dataclasses.astuple(e)) for e in et])


def _drive_packed(j, t, fleet, ticks, snapshot_every=5, defer=False,
                  on_tick=None, caps=True, hints=False):
    """Feed both runners ``ticks`` packed requests of ``fleet``; returns
    (replies, the most lanes parked on the STAY row after a request)."""
    enc = pc.PackedFleetEncoder(snapshot_every=snapshot_every)
    replies = parked = 0
    for seq in range(1, ticks + 1):
        pkt = enc.encode_tick(seq, fleet.items())
        extra = {}
        if hints:
            extra["hints"] = [int(fleet.rng.choice(fleet.cells))]
        req = _packed_request(seq, pkt, caps=caps, **extra)
        rj, rt = j.handle(req), t.handle(req)
        assert _strip(rj) == _strip(rt), seq
        parked = max(parked, len(t.service.lane_wait))
        if rj is not None:
            replies += 1
            if caps:
                fleet.adopt_packed(rj, j.packed.names)
            else:
                fleet.adopt_json(rj)
        if defer:
            _idle(j, t)
        _assert_services_equal(j, t)
        _assert_audit_equal(j, t)
        if on_tick is not None:
            on_tick(seq, enc)
        fleet.churn(seq)
    return replies, parked


def test_legacy_json_stream_matches_jax(capsys):
    free = _grid()
    j, t = _pair(free, defer=False)
    fleet = Fleet(free, 6, seed=1)
    for seq in range(1, 13):
        req = fleet.json_request(seq)
        rj, rt = j.handle(req), t.handle(req)
        assert _strip(rj) == _strip(rt), seq
        fleet.adopt_json(rj)
        _assert_services_equal(j, t)
        fleet.churn(seq)
    assert t.service._last_cap == 8 and t.ticks == 12
    # nothing is compiled per shape: the key stays, at 0, and no stall line
    assert t.stats()["service"]["recompiles"] == 0
    capsys.readouterr()
    t.handle(fleet.json_request(13))
    assert "recompiled" not in capsys.readouterr().out


def test_warm_plans_a_fleet_before_the_banner():
    free = _grid()
    grid = Grid(free.copy())
    svc = tsd.PlanService(grid, capacity_min=4, device=CPU)
    assert tsd.warm(svc, grid, 6) == 6
    assert len(svc.goal_rows) == 6 and svc._last_cap == 8
    assert tsd.warm(svc, grid, 0) == 0


@pytest.mark.parametrize("defer", [False, True], ids=["inline", "deferred"])
def test_packed_stream_matches_jax(defer):
    free = _grid()
    j, t = _pair(free, defer=defer)
    fleet = Fleet(free, 7, seed=2)
    replies, parked = _drive_packed(j, t, fleet, 14, defer=defer,
                                    hints=True)
    assert replies >= 12
    assert t.service.r_cap >= 8
    if defer:  # lanes parked on the STAY row while their fields swept
        assert -1 in t.service.goal_rows and parked > 0


def test_packed_request_without_packed_caps_answers_json():
    free = _grid()
    j, t = _pair(free, defer=False)
    _drive_packed(j, t, Fleet(free, 6, seed=4), 8, caps=False)


def test_seq_gap_resyncs_with_a_snapshot():
    free = _grid()
    j, t = _pair(free, defer=False)
    fleet = Fleet(free, 6, seed=5)
    enc = pc.PackedFleetEncoder(snapshot_every=100)
    gaps = 0
    for seq in range(1, 12):
        pkt = enc.encode_tick(seq, fleet.items())
        if seq == 5:
            fleet.churn(seq)
            continue  # lost on the wire: the next delta's base is gone
        req = _packed_request(seq, pkt)
        rj, rt = j.handle(req), t.handle(req)
        assert _strip(rj) == _strip(rt), seq
        assert j.snapshot_needed == t.snapshot_needed
        if t.snapshot_needed:
            gaps += 1
            j.snapshot_needed = t.snapshot_needed = False
            enc.request_snapshot()
        if rj is not None:
            fleet.adopt_packed(rj, j.packed.names)
        _assert_services_equal(j, t)
        fleet.churn(seq)
    assert gaps == 1
    assert treg.get_registry().snapshot()["counters"].get(
        "solverd.seq_gaps", 0) >= 1


def test_lru_eviction_under_a_small_cache():
    free = _grid()
    j, t = _pair(free, defer=False, capacity_min=8)
    j.service.max_fields = t.service.max_fields = 8
    fleet = Fleet(free, 5, seed=6)
    evicted = set()

    def watch(seq, enc):
        evicted.update(g for g in range(free.size)
                       if g not in t.service.goal_rows)

    _drive_packed(j, t, fleet, 14, on_tick=watch)
    assert t.service.dirs.shape[0] == 8
    assert t.service.cache_misses > 8  # rows were reused


def test_world_updates_patch_then_repair():
    free = _grid(side=16, seed=7)
    j, t = _pair(free, defer=True)
    fleet = Fleet(free, 6, seed=7)
    w = free.shape[1]
    rng = np.random.default_rng(7)

    def toggle(seq, enc):
        if seq % 3:
            return
        # block a free cell no agent stands on and open a wall cell
        taken = {p for p, _ in fleet.fleet.values()}
        cand = [c for c in fleet.cells if c not in taken]
        cells = [int(rng.choice(cand))]
        walls = np.flatnonzero(~j.service.free_np.reshape(-1))
        if walls.size:
            cells.append(int(rng.choice(walls)))
        flags = [1] + [0] * (len(cells) - 1)
        if seq % 2:
            msg = {"type": "world_update", "world_seq": seq,
                   "codec": pc.CODEC_NAME,
                   "data": pc.encode_b64(pc.encode_world(seq, cells,
                                                         flags))}
        else:
            msg = {"type": "world_update", "world_seq": seq,
                   "toggles": [[c, f] for c, f in zip(cells, flags)]}
        assert j.handle(msg) is None and t.handle(msg) is None
        assert j.service.world_seq == t.service.world_seq == seq
        np.testing.assert_array_equal(j.service.free_np, t.service.free_np)
        # the STAY patch lands at once on every cached row
        _assert_services_equal(j, t)
        _assert_audit_equal(j, t)
        blocked = [c for c, f in zip(cells, flags) if f]
        for c in blocked:
            fleet.cells = fleet.cells[fleet.cells != c]
        opened = [c for c, f in zip(cells, flags) if not f]
        fleet.cells = np.sort(np.concatenate([fleet.cells, opened])
                              ).astype(fleet.cells.dtype)
        _idle(j, t)  # repairs in the idle window
        _assert_services_equal(j, t)

    _drive_packed(j, t, fleet, 13, defer=True, on_tick=toggle)
    counters = treg.get_registry().snapshot()["counters"]
    assert counters.get("solverd.field_repair_fallbacks", 0) > 0
    assert t.service.world_seq >= 12 and w == 16


def test_malformed_packets_are_contained():
    free = _grid()
    j, t = _pair(free, defer=False)
    fleet = Fleet(free, 5, seed=8)
    enc = pc.PackedFleetEncoder(snapshot_every=100)
    before = treg.get_registry().snapshot()["counters"].get(
        "solverd.bad_packets", 0)
    good = enc.encode_tick(1, fleet.items())
    bad_lane = dataclasses.replace(good, idx=good.idx - 1)
    bad_cell = dataclasses.replace(good, pos=good.pos + free.size)
    frames = [
        {"type": "plan_request", "seq": 1, "codec": pc.CODEC_NAME,
         "caps": [pc.CODEC_NAME], "data": "!!not base64!!"},
        {"type": "plan_request", "seq": 1, "codec": pc.CODEC_NAME,
         "caps": [pc.CODEC_NAME], "data": "AAAA"},
        _packed_request(1, bad_lane),
        _packed_request(1, bad_cell),
        {"type": "world_update", "toggles": "nope"},
        {"type": "plan_request", "seq": 1, "agents": []},
    ]
    for f in frames:
        assert j.handle(f) is None and t.handle(f) is None
    after = treg.get_registry().snapshot()["counters"].get(
        "solverd.bad_packets", 0)
    assert after - before == 5
    rj = j.handle(_packed_request(1, good))
    assert _strip(rj) == _strip(t.handle(_packed_request(1, good)))
    _assert_services_equal(j, t)


def test_trace_context_is_echoed_one_hop_on():
    free = _grid()
    j, t = _pair(free, defer=False)
    fleet = Fleet(free, 5, seed=9)
    enc = pc.PackedFleetEncoder(snapshot_every=100)
    for seq in range(1, 5):
        pkt = enc.encode_tick(seq, fleet.items())
        pkt.trace = pc.TraceCtx(1000 + seq, 2, 123456)
        req = _packed_request(seq, pkt)
        rj, rt = j.handle(req), t.handle(req)
        pj, pt = jpc.decode_b64(rj["data"]), pc.decode_b64(rt["data"])
        for f in ("kind", "seq", "base_seq"):
            assert getattr(pj, f) == getattr(pt, f)
        for f in ("idx", "pos", "goal"):
            np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f))
        assert (pt.trace.trace_id, pt.trace.hop) == (1000 + seq, 3)
        assert (pj.trace.trace_id, pj.trace.hop) == (1000 + seq, 3)
        fleet.adopt_packed(rj, j.packed.names)
        jreq = fleet.json_request(seq)
        jreq["tc"] = [77, 1, 5]
        rj, rt = j.handle(jreq), t.handle(jreq)
        assert rj["moves"] == rt["moves"]
        assert rt["tc"][:2] == rj["tc"][:2] == [77, 2]
        fleet.churn(seq, joins=False)


def test_audit_digests_drills_and_corruption(monkeypatch):
    monkeypatch.setenv("JG_AUDIT_TEST_HOOKS", "1")
    free = _grid()
    j, t = _pair(free, defer=False)
    fleet = Fleet(free, 6, seed=10)

    def corrupt(seq, enc):
        if seq == 4:
            assert j.service.set_corruption(2, "goal", 3, "device") == \
                t.service.set_corruption(2, "goal", 3, "device") is True
            entries, _ = tsd.audit_entries(t.service, seq)
            digest = {e.section: e.digest for e in entries}
            # the device-only corruption shows as a mirror/device fork
            assert digest[jaudit.SEC_MIRROR] != digest[jaudit.SEC_DEVICE]
        if seq == 7:
            assert j.service.set_corruption(1, "pos", 1, "both") == \
                t.service.set_corruption(1, "pos", 1, "both") is True
        for view in ("mirror", "device"):
            req = {"type": "audit_drill_request", "target": "solverd",
                   "view": view, "lo": 0, "hi": 16, "rows": True}
            names = t.packed.names
            assert jsd.audit_drill_reply(j.service, names, req) == \
                tsd.audit_drill_reply(t.service, names, req)

    _drive_packed(j, t, fleet, 10, snapshot_every=100, on_tick=corrupt)
    assert sorted(t.service.corrupt) == [1, 2]


def test_pipelined_order_matches_synchronous_handle():
    """begin(k), ingest(k+1), finish(k): the delta of request k+1 lands in
    the resident lanes before reply k is fetched, and reply k must still
    be the synchronous one (no step output aliases a resident lane)."""
    free = _grid()
    j, t = _pair(free, defer=False)
    pipe = tsd.TickRunner(tsd.PlanService(Grid(free.copy()), capacity_min=8,
                                          device=CPU), Grid(free.copy()))
    pipe.service.defer_fields = False
    fleet = Fleet(free, 7, seed=11)
    enc = pc.PackedFleetEncoder(snapshot_every=6)
    pending = None
    for seq in range(1, 13):
        req = _packed_request(seq, enc.encode_tick(seq, fleet.items()))
        rj, rt = j.handle(req), t.handle(req)
        assert _strip(rj) == _strip(rt), seq
        assert pipe.ingest(req)
        nxt = pipe.begin()
        if pending is not None:
            got, want = pipe.finish(pending, pipelined=True), prev
            assert _strip(got) == _strip(want), seq - 1
        pending, prev = nxt, rj
        fleet.adopt_packed(rj, j.packed.names)
        # the fleet moves on after the reply; the pipelined runner sees
        # request k+1 before it fetches reply k
        fleet.churn(seq)
    assert _strip(pipe.finish(pending, pipelined=True)) == _strip(prev)


def test_state_hands_off_from_jax_mid_stream():
    free = _grid()
    j, t = _pair(free, defer=True)
    fleet = Fleet(free, 7, seed=12)
    enc = pc.PackedFleetEncoder(snapshot_every=100)
    for seq in range(1, 16):
        req = _packed_request(seq, enc.encode_tick(seq, fleet.items()))
        rj = j.handle(req)
        if seq == 8:
            # hand-off: the port takes the JAX daemon's state as it stands
            state = convert.runner_state(j)
            convert.load_runner(t, state)
            _assert_services_equal(j, t)
            assert convert.runner_state(t).keys() == state.keys()
        if seq > 8:
            rt = t.handle(req)
            assert _strip(rj) == _strip(rt), seq
        if rj is not None:
            fleet.adopt_packed(rj, j.packed.names)
        j.service.process_field_queue()
        if seq >= 8:
            t.service.process_field_queue()
            _assert_services_equal(j, t)
        fleet.churn(seq)
