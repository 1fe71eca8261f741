"""The port's multi-tenant serving against the JAX package's.

Two layers, each held to the JAX package bit for bit on the CPU:

- The tenant fold of the step (``step_parallel(..., tenants=T)``): T fleets
  of L lanes stepped as one lane axis of T x L agents, against the JAX
  package's ``jax.vmap(step_parallel, in_axes=(0, 0, 0, 0, None))`` over
  ``[T, L]`` planes with the shared field rows broadcast, and against a
  loop of the port's own flat step over the rows.  The cases put inactive
  and padded lanes at cell 0, Rule-3 goal swaps and pushes and Rule-4
  rotations in several rows at once, and a row whose cascade runs on after
  the other rows have settled (with and without the round cap binding).
- ``MultiTenantRunner`` over ``TenantSlab``: one frame stream fed to a JAX
  runner and to the port's publishes the same ``(topic, payload)`` list
  (``duration_micros`` dropped), and after every burst the slab's host
  mirrors and device planes, its deferred-field parking, the shared field
  cache (rows and their order) and each tenant's audit digests are the
  same.  The stream covers identical fleets in two tenants, admission, LRU
  eviction and re-admission with a snapshot resync, a refused admission, the
  per-tenant lane budget, JSON requests, a seq gap, world updates on the
  un-namespaced plane (applied) and on a tenant's (ignored), and deferred
  fields released in the idle window.

Eviction tests set the idle threshold to 0 (every tenant idle, the least
recently active evicted) or to an hour (none idle), so no outcome depends
on the wall clock.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.config import SolverConfig as JaxConfig
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.obs import audit as jaudit
from p2p_distributed_tswap_tpu.ops import distance as jd
from p2p_distributed_tswap_tpu.runtime import solverd as jsd
from p2p_distributed_tswap_tpu.solver import step as jstep
from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.obs import registry as treg
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
from p2p_distributed_tswap_tpu_torch.runtime import solverd as tsd
from p2p_distributed_tswap_tpu_torch.solver import step as tstep

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
              "MAPD_FUSED", "JG_TRACE_CTX", "JG_AUDIT"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# the tenant fold of the step
# ---------------------------------------------------------------------------

SIDE = 16


def _free(seed, density):
    rng = np.random.default_rng(seed)
    free = rng.random((SIDE, SIDE)) > density
    free[0, 0] = True
    return free


def _random_rows(free, t, lanes, seed, fill):
    """[T, L] planes as the slab holds them: a random share ``fill`` of
    each row's lanes active on distinct cells of that row's world (row 0
    keeps an agent on cell 0), the rest padded at cell 0 with goal 0 and
    slot 0."""
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(free.reshape(-1))
    cells = cells[cells != 0]
    pos = np.zeros((t, lanes), np.int32)
    goal = np.zeros((t, lanes), np.int32)
    active = rng.random((t, lanes)) < fill
    for r in range(t):
        k = int(active[r].sum())
        pos[r, active[r]] = rng.choice(cells, k, replace=False)
        goal[r, active[r]] = rng.choice(cells, k)
    active[0, 0] = True
    pos[0, 0] = 0
    goal[0, 0] = int(rng.choice(cells))
    return pos, goal, active


def _patterns(t, lanes):
    """Hand-placed rows on an open grid: Rule-3 goal swaps, pushes at a
    shared delivery cell, a Rule-4 ring, a head-on pair, and one row whose
    chain of ten agents along a corridor takes ten cascade rounds; rows
    repeat the patterns at other offsets."""
    w = SIDE
    c = lambda x, y: y * w + x  # noqa: E731
    rows = [
        # Rule 3: 0 parks on its own goal in 1's way; a push pair beside it
        [(c(4, 2), c(7, 2)), (c(5, 2), c(5, 2)),
         (c(3, 6), c(4, 6)), (c(4, 6), c(4, 6))],
        # Rule 4: a ring on a 2x2 square, and a head-on pair
        [(c(5, 5), c(6, 5)), (c(6, 5), c(6, 6)), (c(6, 6), c(5, 6)),
         (c(5, 6), c(5, 5)), (c(2, 10), c(6, 10)), (c(3, 10), c(0, 10))],
        # the long cascade: a chain heading east along row 8
        [(c(x, 8), c(15, 8)) for x in range(10)],
        # the same patterns on the cells row 0 uses, and an agent on cell 0
        [(c(4, 2), c(7, 2)), (c(5, 2), c(5, 2)), (0, c(3, 0)),
         (c(5, 5), c(6, 5)), (c(6, 5), c(6, 6)), (c(6, 6), c(5, 6)),
         (c(5, 6), c(5, 5))],
    ]
    pos = np.zeros((t, lanes), np.int32)
    goal = np.zeros((t, lanes), np.int32)
    active = np.zeros((t, lanes), bool)
    for r in range(t):
        for k, (p, g) in enumerate(rows[r % len(rows)]):
            pos[r, k], goal[r, k], active[r, k] = p, g, True
    return pos, goal, active


def _shared_dirs(free, goal, active):
    """Field rows of every goal in the planes (the shared cache) and the
    slot of each lane: the row of its goal; padded lanes take slot 0."""
    goals = np.unique(goal[active])
    fields = jd.direction_fields(jnp.asarray(free),
                                 jnp.asarray(goals, jnp.int32))
    dirs_j = jd.pack_directions(fields.reshape(len(goals), -1))
    slot = np.where(active, np.searchsorted(goals, goal), 0).astype(np.int32)
    return dirs_j, torch.from_numpy(np.array(dirs_j).view(np.int32)), slot


def _case(name):
    if name == "random-dense":
        free = _free(0, 0.1)
        return (free, *_random_rows(free, 3, 32, 0, 0.9), {})
    if name == "random-padded":
        free = _free(1, 0.15)
        return (free, *_random_rows(free, 4, 16, 1, 0.4), {})
    if name == "identical-rows":
        free = _free(2, 0.1)
        pos, goal, active = _random_rows(free, 1, 32, 2, 0.8)
        rep = lambda a: np.repeat(a, 3, axis=0)  # noqa: E731
        return free, rep(pos), rep(goal), rep(active), {}
    free = np.ones((SIDE, SIDE), bool)
    pos, goal, active = _patterns(5, 16)
    kw = {"max_move_rounds": 3} if name == "patterns-capped" else {}
    return free, pos, goal, active, kw


CASES = ["random-dense", "random-padded", "identical-rows", "patterns",
         "patterns-capped"]
STEPS = 3


def _vstep(cfg):
    def one(pos, goal, slot, active, dirs):
        return jstep.step_parallel(cfg, pos, goal, slot, dirs, active)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))


@pytest.mark.parametrize("name", CASES)
def test_folded_step_equals_jax_vmap(name):
    free, pos, goal, active, kw = _case(name)
    t, lanes = pos.shape
    dirs_j, dirs_t, slot = _shared_dirs(free, goal, active)
    cfg_j = JaxConfig(height=SIDE, width=SIDE, num_agents=lanes, **kw)
    cfg_t = SolverConfig(height=SIDE, width=SIDE, num_agents=t * lanes, **kw)
    vstep = _vstep(cfg_j)
    sj = (jnp.asarray(pos), jnp.asarray(goal), jnp.asarray(slot))
    st = tuple(torch.from_numpy(x.reshape(-1).copy())
               for x in (pos, goal, slot))
    act_t = torch.from_numpy(active.reshape(-1).copy())
    start_goal = goal.copy()
    for _ in range(STEPS):
        sj = vstep(*sj, jnp.asarray(active), dirs_j)
        st = tstep.step_parallel(cfg_t, *st, dirs_t, act_t, tenants=t)
        for a, b in zip(sj, st):
            np.testing.assert_array_equal(np.asarray(a),
                                          b.numpy().reshape(t, lanes))
    end_pos, end_goal = (np.asarray(x) for x in sj[:2])
    # padded lanes stay parked at cell 0, goal 0
    assert (end_pos[~active] == 0).all() and (end_goal[~active] == 0).all()
    # every row with agents moved or exchanged goals
    for r in range(t):
        if active[r].sum() > 1:
            assert ((end_pos[r] != pos[r]) | (end_goal[r] != start_goal[r])
                    )[active[r]].any(), r
    if name == "identical-rows":
        assert (end_pos == end_pos[:1]).all() and (end_goal == end_goal[:1]
                                                   ).all()


@pytest.mark.parametrize("name", CASES)
def test_folded_step_equals_a_loop_over_rows(name):
    """The fold against the port's own flat step row by row; the fold's
    cascade makes as many host syncs as the row that ran longest."""
    free, pos, goal, active, kw = _case(name)
    t, lanes = pos.shape
    _, dirs_t, slot = _shared_dirs(free, goal, active)
    cfg_l = SolverConfig(height=SIDE, width=SIDE, num_agents=lanes, **kw)
    cfg_t = SolverConfig(height=SIDE, width=SIDE, num_agents=t * lanes, **kw)
    planes = tuple(torch.from_numpy(x.copy()) for x in (pos, goal, slot))
    act = torch.from_numpy(active.copy())
    rounds = []
    for _ in range(STEPS):
        want, syncs = [], []
        for r in range(t):
            before = hostsync.count
            want.append(tstep.step_parallel(cfg_l, *(x[r] for x in planes),
                                            dirs_t, act[r]))
            syncs.append(hostsync.count - before)
        before = hostsync.count
        got = tstep.step_parallel(cfg_t, *(x.reshape(-1) for x in planes),
                                  dirs_t, act.reshape(-1), tenants=t)
        assert hostsync.count - before == max(syncs)
        rounds.append(syncs)
        for k in range(3):
            assert torch.equal(got[k].reshape(t, lanes),
                               torch.stack([w[k] for w in want]))
        planes = tuple(x.reshape(t, lanes) for x in got)
    if name == "patterns":
        # the chain's row ran on after the others had settled
        assert rounds[0][2] == 11 > max(rounds[0][:2])
    if name == "patterns-capped":
        assert rounds[0][2] == kw["max_move_rounds"]  # the cap binds


def test_fold_rejects_lanes_that_do_not_divide():
    cfg = SolverConfig(height=4, width=4, num_agents=6)
    z = torch.zeros(6, dtype=torch.int32)
    dirs = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="tenant rows"):
        tstep.step_parallel(cfg, z, z, z, dirs, tenants=4)


# ---------------------------------------------------------------------------
# MultiTenantRunner / TenantSlab against the JAX package's
# ---------------------------------------------------------------------------


def _world(side=16, seed=3):
    rng = np.random.default_rng(seed)
    free = rng.random((side, side)) > 0.12
    free[0, 0] = True
    return free


class Fleet:
    """One tenant's manager: a roster of (pos, goal) per peer that adopts
    the moves and returned goals of each reply to its newest request,
    churns its tasks, admits and retires peers, and answers a snapshot
    request with a snapshot."""

    def __init__(self, free, n, seed, joins=True, caps=True):
        self.w = free.shape[1]
        self.rng = np.random.default_rng(seed)
        self.cells = np.flatnonzero(free.reshape(-1))
        starts = self.rng.choice(self.cells[self.cells != 0], n,
                                 replace=False)
        starts[0] = 0  # an agent on cell 0, where padded lanes sit
        self.fleet = {f"p{k}": [int(starts[k]), int(self.rng.choice(
            self.cells))] for k in range(n)}
        self.next_id = n
        self.joins = joins
        self.caps = caps
        self.enc = pc.PackedFleetEncoder(snapshot_every=100)
        self.seq = 0

    def request(self, hints=False):
        self.seq += 1
        pkt = self.enc.encode_tick(
            self.seq, [(n, p, g) for n, (p, g) in self.fleet.items()])
        req = {"type": "plan_request", "seq": self.seq,
               "codec": pc.CODEC_NAME,
               "caps": [pc.CODEC_NAME] if self.caps else [],
               "data": pc.encode_b64(pkt)}
        if hints:
            req["hints"] = [int(self.rng.choice(self.cells))]
        return req

    def lose(self):
        """A request encoded but lost on the wire."""
        self.request()

    def hear(self, data):
        typ = data.get("type")
        if typ == "plan_snapshot_request":
            self.enc.request_snapshot()
        if typ != "plan_response" or data["seq"] != self.seq:
            return
        w = self.w
        if "data" in data:
            rp = pc.decode_b64(data["data"])
            moves = [(self.enc.roster[int(l)], int(c), int(g))
                     for l, c, g in zip(rp.idx, rp.pos, rp.goal)]
        else:
            moves = [(m["peer_id"], m["next_pos"][1] * w + m["next_pos"][0],
                      m["goal"][1] * w + m["goal"][0])
                     for m in data["moves"]]
        for name, c, g in moves:
            if name in self.fleet:
                self.fleet[name] = [c, g]

    def churn(self):
        rng, tick = self.rng, self.seq
        for name in list(self.fleet):
            p, g = self.fleet[name]
            if p == g or rng.random() < 0.1:  # next task
                self.fleet[name][1] = int(rng.choice(self.cells))
        if self.joins and tick % 4 == 1 and len(self.fleet) > 3:
            self.fleet.pop(list(self.fleet)[int(rng.integers(
                len(self.fleet)))])
        if self.joins and tick % 3 == 2:
            taken = {p for p, _ in self.fleet.values()}
            c = int(rng.choice([c for c in self.cells if c not in taken]))
            self.fleet[f"p{self.next_id}"] = [c, int(rng.choice(self.cells))]
            self.next_id += 1


def _strip(data):
    return {k: v for k, v in data.items() if k != "duration_micros"}


class Pair:
    """A JAX runner and a port runner over their own slabs, on the same
    grid and settings, each publishing into its own list."""

    def __init__(self, free, defer=False, max_tenants=8, idle_evict_ms=0.0,
                 tenant_lanes=1 << 16, capacity_min=4):
        jg, tg = JaxGrid(free.copy()), Grid(free.copy())
        self.jpub, self.tpub = [], []
        jsvc = jsd.PlanService(jg, capacity_min=capacity_min)
        tsvc = tsd.PlanService(tg, capacity_min=capacity_min, device=CPU)
        jsvc.defer_fields = tsvc.defer_fields = defer
        self.j = jsd.MultiTenantRunner(
            jsd.TenantSlab(jsvc, jg, tenant_lanes=tenant_lanes), jg,
            publish=lambda t, d: self.jpub.append((t, d)),
            max_tenants=max_tenants, idle_evict_ms=idle_evict_ms)
        self.t = tsd.MultiTenantRunner(
            tsd.TenantSlab(tsvc, tg, tenant_lanes=tenant_lanes), tg,
            publish=lambda t, d: self.tpub.append((t, d)),
            max_tenants=max_tenants, idle_evict_ms=idle_evict_ms)
        self.seen = 0

    def burst(self, frames):
        """One burst of ``[(ns, request)]`` on both runners in the
        daemon's order; returns the JAX side's new publishes, after
        holding them, and both runners' state, equal."""
        oks = []
        for r in (self.j, self.t):
            ok = [r.ingest(ns, data) for ns, data in frames]
            r.flush_snapshot_requests()
            p = r.begin() if any(ok) else None
            if p is not None:
                r.finish(p)
            oks.append(ok)
        assert oks[0] == oks[1]
        return self.check()

    def idle(self):
        """The daemon's idle window: the field queue drained on both."""
        while self.j.slab.service.field_queue \
                or self.t.slab.service.field_queue:
            assert self.j.slab.process_field_queue() == \
                self.t.slab.process_field_queue()
        self.check()

    def world(self, msg):
        assert self.j.handle_world(msg) == self.t.handle_world(msg)
        self.check()

    def check(self):
        new = self.jpub[self.seen:]
        assert [(t, _strip(d)) for t, d in new] == \
            [(t, _strip(d)) for t, d in self.tpub[self.seen:]]
        self.seen = len(self.jpub)
        _assert_runners_equal(self.j, self.t)
        return new


def _assert_runners_equal(j, t):
    js, ts = j.slab, t.slab
    assert (js.T_cap, js.L_cap) == (ts.T_cap, ts.L_cap)
    assert js.rows_used == ts.rows_used
    for k in ("pos", "goal", "slot", "active"):
        np.testing.assert_array_equal(getattr(js, f"h_{k}"),
                                      getattr(ts, f"h_{k}"))
        dj, dt = getattr(js, f"d_{k}"), getattr(ts, f"d_{k}")
        assert (dj is None) == (dt is None)
        if dj is not None:
            np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    assert js.lane_wait == ts.lane_wait
    assert js.wait_lanes == ts.wait_lanes
    jv, tv = js.service, ts.service
    assert list(jv.goal_rows.items()) == list(tv.goal_rows.items())
    assert jv.goal_ref == tv.goal_ref
    assert list(jv.field_queue) == list(tv.field_queue)
    np.testing.assert_array_equal(jv.free_np, tv.free_np)
    if jv.dirs is not None:
        np.testing.assert_array_equal(
            np.asarray(jv.dirs), tv.dirs.numpy().view(np.uint32))
    assert {ns: (x.row, x.decoder.last_seq, x.resyncs, x.snapshot_needed)
            for ns, x in j.tenants.items()} == \
        {ns: (x.row, x.decoder.last_seq, x.resyncs, x.snapshot_needed)
         for ns, x in t.tenants.items()}
    for ns in j.tenants:
        ej, xj = jsd.audit_entries_tenant(js, j.tenants[ns])
        et, xt = tsd.audit_entries_tenant(ts, t.tenants[ns])
        assert [dataclasses.astuple(e) for e in ej] == \
            [dataclasses.astuple(e) for e in et]
        assert xj == xt
        assert jaudit.encode_audit(ej) == jaudit.encode_audit(
            [jaudit.AuditEntry(*dataclasses.astuple(e)) for e in et])
    assert tsd.tenant_audit_peer("t0") == jsd.tenant_audit_peer("t0")


def _deliver(fleets, published):
    for topic, data in published:
        ns, _ = tsd.busns.split_ns(topic)
        if ns in fleets:
            fleets[ns].hear(data)


def _counter(name):
    return treg.get_registry().snapshot()["counters"].get(name, 0)


def test_identical_fleets_get_identical_replies():
    """Two tenants with identical fleets get identical replies, equal to a
    single-tenant runner's; a third tenant's differ; both daemons agree on
    every reply and on the slab, cache and audit digests after every
    burst."""
    free = _world()
    pair = Pair(free)
    fleets = {"t0": Fleet(free, 6, seed=1), "t1": Fleet(free, 6, seed=1),
              "t2": Fleet(free, 9, seed=2)}
    tg = Grid(free.copy())
    single = tsd.TickRunner(tsd.PlanService(tg, capacity_min=4, device=CPU),
                            tg)
    single.service.defer_fields = False
    for tick in range(12):
        reqs = {ns: f.request(hints=True) for ns, f in fleets.items()}
        want = single.handle(reqs["t2"])
        pub = dict(pair.burst(list(reqs.items())))
        assert set(pub) == {"t0:solver", "t1:solver", "t2:solver"}
        assert pub["t0:solver"]["data"] == pub["t1:solver"]["data"]
        assert pub["t2:solver"]["data"] == want["data"], tick
        _deliver(fleets, pub.items())
        for f in fleets.values():
            f.churn()
    assert fleets["t0"].fleet == fleets["t1"].fleet
    assert pair.t.slab.T_cap == 4 and pair.t.ticks == 12


def test_deferred_fields_and_json_replies():
    """Deferred fields park lanes on the shared STAY row until the idle
    window sweeps them; a tenant whose requests lack the packed caps is
    answered on the legacy JSON wire."""
    free = _world(seed=4)
    pair = Pair(free, defer=True)
    fleets = {"t0": Fleet(free, 7, seed=3),
              "t1": Fleet(free, 5, seed=4, caps=False)}
    parked = 0
    for tick in range(12):
        pub = pair.burst([(ns, f.request(hints=True))
                          for ns, f in fleets.items()])
        parked = max(parked, len(pair.t.slab.lane_wait))
        assert "moves" in dict(pub)["t1:solver"]
        _deliver(fleets, pub)
        pair.idle()
        for f in fleets.values():
            f.churn()
    assert parked > 0 and -1 in pair.t.slab.service.goal_rows


def test_eviction_readmission_and_resync():
    """Past ``max_tenants`` the least-recently-active idle tenant is
    evicted; its next delta re-admits it with a fresh decoder, whose seq
    gap asks the manager for a snapshot; a request lost on the wire does
    the same without an eviction."""
    free = _world(seed=5)
    pair = Pair(free, max_tenants=2, idle_evict_ms=0.0)
    fleets = {ns: Fleet(free, 5, seed=10 + k)
              for k, ns in enumerate(("t0", "t1", "t2"))}
    schedule = [("t0", "t1"), ("t0", "t1"), ("t2",), ("t1", "t2"), ("t0",),
                ("t0", "t2"), ("t1",), ("t1", "t0"), ("t1", "t0"),
                ("t1", "t0"), ("t1", "t0")]
    evictions, resyncs = (_counter("solverd.tenant_evictions"),
                          _counter("solverd.tenant_resyncs"))
    kinds = []
    for tick, asking in enumerate(schedule):
        if tick == 8:
            fleets["t1"].lose()
        pub = pair.burst([(ns, fleets[ns].request()) for ns in asking])
        kinds.extend((t, d["type"]) for t, d in pub)
        _deliver(fleets, pub)
        for ns in asking:
            fleets[ns].churn()
    assert ("t0:solver", "tenant_evicted") in kinds
    assert ("t1:solver", "tenant_evicted") in kinds
    assert kinds.count(("t1:solver", "plan_snapshot_request")) >= 2
    assert ("t0:solver", "plan_snapshot_request") in kinds
    assert kinds[-2:] == [("t1:solver", "plan_response"),
                          ("t0:solver", "plan_response")]
    assert _counter("solverd.tenant_evictions") - evictions == 4
    assert _counter("solverd.tenant_resyncs") - resyncs >= 3


def test_refused_admission_lane_budget_and_json_requests():
    """A full slab with no idle tenant refuses a newcomer; a request past
    the per-tenant lane budget is a bad packet; a legacy JSON request is
    counted and never admits."""
    free = _world(seed=6)
    pair = Pair(free, max_tenants=2, idle_evict_ms=3.6e6, tenant_lanes=8)
    small = {"t0": Fleet(free, 4, seed=20, joins=False),
             "t1": Fleet(free, 4, seed=21, joins=False)}
    big = Fleet(free, 9, seed=22, joins=False)
    before = {k: _counter(k) for k in (
        "solverd.tenant_admission_rejected", "solverd.bad_packets",
        "solverd.json_requests_ignored")}
    pair.burst([("t0", small["t0"].request())])
    json_req = {"type": "plan_request", "seq": 1, "agents": [
        {"peer_id": "a", "pos": [1, 0], "goal": [3, 0]}]}
    pub = pair.burst([("t1", big.request()), ("t9", json_req)])
    assert pub == [] and set(pair.t.tenants) == {"t0", "t1"}
    pub = pair.burst([("t2", small["t1"].request())])
    assert pub == [] and set(pair.t.tenants) == {"t0", "t1"}
    after = {k: _counter(k) - v for k, v in before.items()}
    # the port's own registry counts the port's runner only
    assert after == {"solverd.tenant_admission_rejected": 1,
                     "solverd.bad_packets": 1,
                     "solverd.json_requests_ignored": 1}


def test_world_update_reaches_every_tenant():
    """A world toggle on the operator plane STAY-patches the shared cache
    and queues repairs, which the idle window sweeps; every tenant's
    replies stay equal to the JAX daemon's."""
    free = _world(seed=7)
    pair = Pair(free, defer=True)
    fleets = {"t0": Fleet(free, 6, seed=30), "t1": Fleet(free, 6, seed=31)}
    rng = np.random.default_rng(7)
    for tick in range(10):
        pub = pair.burst([(ns, f.request()) for ns, f in fleets.items()])
        _deliver(fleets, pub)
        if tick % 3 == 1:
            taken = {p for f in fleets.values() for p, _ in f.fleet.values()}
            cand = [c for c in fleets["t0"].cells if c not in taken]
            cell = int(rng.choice(cand))
            pair.world({"type": "world_update", "world_seq": tick,
                        "toggles": [[cell, 1]]})
            for f in fleets.values():
                f.cells = f.cells[f.cells != cell]
        pair.idle()
        for f in fleets.values():
            f.churn()
    assert pair.t.slab.service.world_seq == 7  # the last toggle's epoch
    assert _counter("solverd.field_repair_fallbacks") > 0


# ---------------------------------------------------------------------------
# the daemon loop: routing, the stale drain, pipelined begin/finish
# ---------------------------------------------------------------------------


class _LoopEnd(Exception):
    pass


class ScriptBus:
    """The bus as ``multi_tenant_loop`` sees it: ``recv`` pops scripted
    frames (None is a quiet poll); when they run out ``refill(bus)`` gives
    the next ones, or None to end the loop.  Every frame handed out is
    logged, so the same stream can be replayed to the other daemon."""

    def __init__(self, refill):
        self.refill = refill
        self.frames, self.log, self.sent, self.subs = [], [], [], []

    def recv(self, timeout=None):
        if not self.frames:
            more = self.refill(self)
            if more is None:
                raise _LoopEnd
            self.frames.extend(more)
        frame = self.frames.pop(0)
        self.log.append(frame)
        return frame

    def publish(self, topic, data, raw=False):
        self.sent.append((topic, data, raw))

    def subscribe(self, topic, raw=False):
        self.subs.append((topic, raw))


class _QuietBeacon:
    def maybe_beat(self):
        return None


def _run_loop(sd, grid, bus, defer):
    svc = sd.PlanService(grid, capacity_min=4,
                         **({"device": CPU} if sd is tsd else {}))
    svc.defer_fields = defer
    slab = sd.TenantSlab(svc, grid)
    runner = sd.MultiTenantRunner(
        slab, grid, publish=lambda t, d: bus.publish(t, d, raw=True),
        max_tenants=8, idle_evict_ms=0.0)
    for ns in ("t0", "t1"):
        runner.ensure_tenant(ns)
    with pytest.raises(_LoopEnd):
        sd.multi_tenant_loop(bus, runner, slab, _QuietBeacon(),
                             {"flag": False}, lambda: None)
    return runner


def _comparable(sent):
    out = []
    for topic, data, raw in sent:
        if data.get("type") == "stats_response":
            data = {"type": "stats_response"}  # timings and trace counters
        data = {k: v for k, v in data.items()
                if k not in ("duration_micros", "ts_ms")}
        out.append((topic, data, raw))
    return out


def _msg(topic, data):
    return {"op": "msg", "topic": topic, "data": data}


@pytest.mark.parametrize("defer", [False, True], ids=["inline", "deferred"])
def test_daemon_loop_matches_jax(monkeypatch, defer):
    """The JAX daemon loop serves four fleets (t0, t1 pre-admitted, t5
    admitted by ``tenant_hello``, the un-namespaced default fleet), with
    control frames mixed into the bursts; the port's loop, fed the same
    frames, publishes the same frames and subscribes the same topics.
    Every third burst arrives before the previous reply was fetched (the
    pipelined order), one burst holds two requests of one tenant (the
    stale drain), world updates and stats requests come on both planes, and
    an audit drill asks for a tenant's rows."""
    monkeypatch.setenv("JG_AUDIT_INTERVAL_S", "1000000")
    free = _world(seed=8)
    fleets = {"t0": Fleet(free, 6, seed=40), "t1": Fleet(free, 5, seed=41),
              "t5": Fleet(free, 4, seed=42), "": Fleet(free, 5, seed=43)}
    rng = np.random.default_rng(8)
    ticks = 10
    state = {"tick": 0, "heard": 0}

    def refill(bus):
        _deliver(fleets, [(t, d) for t, d, _ in bus.sent[state["heard"]:]])
        state["heard"] = len(bus.sent)
        k = state["tick"]
        state["tick"] += 1
        if k == 0:
            return [_msg("solver.admit", {"type": "tenant_hello",
                                          "ns": "t5"}), None]
        if k > ticks:
            return [None] if k == ticks + 1 else None
        frames = []
        for ns, f in fleets.items():
            frames.append(_msg(tsd.busns.wire_topic(ns, "solver"),
                               f.request(hints=True)))
            f.churn()
        if k == 2:  # a second request of t0 in one burst
            frames.append(_msg("t0:solver", fleets["t0"].request()))
        if k == 3:
            cell = int(rng.choice(fleets["t1"].cells))
            for topic in ("t0:solver", "solver"):
                frames.append(_msg(topic, {"type": "world_update",
                                           "world_seq": 5,
                                           "toggles": [[cell, 1]]}))
                frames.append(_msg(topic, {"type": "stats_request"}))
        if k == 4:
            frames.append(_msg("mapd.audit", {
                "type": "audit_drill_request", "target": "solverd[t0]",
                "ns": "t0", "view": "device", "lo": 0, "hi": 8,
                "rows": True}))
        frames.append(None)  # the end of the drain
        if k % 3:
            frames.append(None)  # a quiet poll: the reply is fetched
        return frames

    jbus = ScriptBus(refill)
    jrun = _run_loop(jsd, JaxGrid(free.copy()), jbus, defer)
    tbus = ScriptBus(lambda bus: None)
    tbus.frames = list(jbus.log)
    trun = _run_loop(tsd, Grid(free.copy()), tbus, defer)
    assert tbus.subs == jbus.subs
    assert ("t5:solver", True) in tbus.subs
    assert _comparable(tbus.sent) == _comparable(jbus.sent)
    kinds = [(t, d["type"]) for t, d, _ in tbus.sent]
    assert ("solver.admit", "tenant_welcome") in kinds
    assert kinds.count(("solver", "stats_response")) == 1
    assert ("mapd.audit", "audit_drill_response") in kinds
    for ns in ("t0", "t1", "t5", ""):
        assert (tsd.busns.wire_topic(ns, "solver"), "plan_response") in kinds
    assert trun.slab.service.world_seq == 5
    assert trun.dropped_total == jrun.dropped_total == 1
    _assert_runners_equal(jrun, trun)
