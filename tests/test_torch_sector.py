"""The port's sector planner (``ops/sector.py``) against the JAX package's.

The JAX package's planner cases (``tests/test_sector.py``) and the seeds of
its fuzz gate (``scripts/sector_fuzz.py``, S = 16 and 32) are replayed on
the CPU through both planners, with ``use_jit`` False (scipy's host BFS)
and True (the batched window fixpoint: the JAX package's jitted XLA scan
against the port's ``window_fixpoint``, whose per-window 3-D masks go to
``sweep_plain`` here and to ``sweep_scan`` on the card).  Equal, not
close: ``graph_state()``, each plan's ``dist`` and packed row, the ε of
each start against an independent BFS (at most the committed 0.05), and
the portal graph after every ``apply_toggles``, which must also equal a
fresh planner on the final mask.

The serving layer under ``JG_SECTOR=1`` (the JAX package's in-process
cases): the legacy JSON walk with corridor routes and a re-entry, a world
toggle repairing the portal graph, the resident path banking start hints
before its lanes park, and one sector spanning the grid serving the same
bytes as the planner off.  Replies, the sector counters and the portal
graph equal the JAX daemon's.
"""

from collections import deque

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.obs import registry as jreg
from p2p_distributed_tswap_tpu.ops import sector as jsec
from p2p_distributed_tswap_tpu.runtime import solverd as jsd
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.obs import registry as treg
from p2p_distributed_tswap_tpu_torch.ops import distance as td
from p2p_distributed_tswap_tpu_torch.ops import sector as tsec
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
from p2p_distributed_tswap_tpu_torch.runtime import solverd as tsd

CPU = torch.device("cpu")
INF = int(tsec.INF)
EPS = 0.05  # the committed bound of the JAX package's fuzz gate
COUNTERS = ("solverd.sector_routes", "solverd.sector_fallbacks",
            "solverd.sector_reentries", "solverd.sector_rebuilds",
            "solverd.field_repairs", "solverd.field_repair_fallbacks")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for k in ("JG_DYNAMIC_WORLD", "JG_DEFER_FIELDS", "JG_SECTOR",
              "JG_SECTOR_CELLS", "JG_SECTOR_JIT", "MAPD_FUSED"):
        monkeypatch.delenv(k, raising=False)


def _bfs(free: np.ndarray, goal: int) -> np.ndarray:
    """Full-grid BFS distance, independent of both planners."""
    h, w = free.shape
    d = np.full(h * w, INF, np.int64)
    fr = free.reshape(-1)
    if fr[goal]:
        d[goal] = 0
        dq = deque([goal])
        while dq:
            c = dq.popleft()
            y, x = divmod(c, w)
            for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                ny, nx = y + dy, x + dx
                if 0 <= ny < h and 0 <= nx < w:
                    nc = ny * w + nx
                    if fr[nc] and d[nc] > d[c] + 1:
                        d[nc] = d[c] + 1
                        dq.append(nc)
    return d


class Planners:
    """A JAX planner and the port's on one shared mask (each holds it by
    reference, as in the daemon), compared after every call."""

    def __init__(self, free, s, use_jit):
        self.free = free
        self.s, self.use_jit = s, use_jit
        self.j = jsec.SectorPlanner(free, s=s, use_jit=use_jit)
        self.t = tsec.SectorPlanner(free, s=s, use_jit=use_jit, device=CPU)
        self.check_graph()

    def check_graph(self):
        assert self.t.graph_state() == self.j.graph_state()

    def plan(self, goal, starts):
        pj = self.j.plan_goal(goal, starts, keep_dist=True)
        pt = self.t.plan_goal(goal, starts, keep_dist=True)
        assert (pj is None) == (pt is None)
        if pt is None:
            return None
        assert pt.packed.dtype == np.uint32
        np.testing.assert_array_equal(pt.packed, pj.packed)
        assert (pt.dist is None) == (pj.dist is None)
        if pt.dist is not None:
            np.testing.assert_array_equal(pt.dist, pj.dist)
        assert (pt.sectors, pt.starts, pt.cells, pt.band, pt.epoch) == \
            (pj.sectors, pj.starts, pj.cells, pj.band, pj.epoch)
        return pt

    def toggle(self, cells):
        assert self.t.apply_toggles(cells) == self.j.apply_toggles(cells)
        self.check_graph()
        assert self.t.graph_state() == tsec.SectorPlanner(
            self.free, s=self.s, use_jit=False, device=CPU).graph_state()

    def code_at(self, goal, cell):
        assert self.t.code_at(goal, cell) == self.j.code_at(goal, cell)
        return self.t.code_at(goal, cell)

    def needs_reentry(self, goal, cell):
        got = self.t.needs_reentry(goal, cell)
        assert got == self.j.needs_reentry(goal, cell)
        return got


def _eps_and_descent(pp: Planners, gl, st, fd) -> float:
    """The sector fuzz gate's route check on the port's plan: ε against
    the BFS, and a walk down the packed codes that reaches the goal in
    exactly the corridor distance."""
    w = pp.free.shape[1]
    plan = pp.plan(gl, [st])
    assert plan is not None
    if fd[st] >= INF:
        assert pp.code_at(gl, st) == td.DIR_STAY
        assert not pp.needs_reentry(gl, st)
        return 0.0
    cd = int(plan.dist.reshape(-1)[st])
    assert cd >= int(fd[st])
    eps = (cd - int(fd[st])) / max(1, int(fd[st]))
    c, steps = st, 0
    while c != gl and steps <= cd:
        code = pp.code_at(gl, c)
        assert code != td.DIR_STAY
        dx, dy = td.DIR_DXDY[code]
        y, x = divmod(c, w)
        c = (y + dy) * w + (x + dx)
        assert pp.free.reshape(-1)[c]
        steps += 1
    assert c == gl and steps == cd
    return eps


JIT = pytest.mark.parametrize("use_jit", [False, True], ids=["host", "jit"])


@JIT
def test_portal_cases_match_jax(use_jit):
    """A fully open border is one run (one portal a side); a wall on one
    side splits it; a wall column seals two sectors, whose unreachable
    start reads STAY and never asks for re-entry."""
    free = np.ones((4, 8), bool)
    pp = Planners(free, 4, use_jit)
    assert len(pp.t.portals[0]) == 1 and len(pp.t.portals[1]) == 1
    free = np.ones((4, 8), bool)
    free[2, 3] = False
    pp = Planners(free, 4, use_jit)
    assert len(pp.t.portals[0]) == 2
    pp.plan(6, [16])
    free = np.ones((4, 8), bool)
    free[:, 3] = False
    pp = Planners(free, 4, use_jit)
    assert len(pp.t.portals.get(0, ())) == 0
    assert pp.plan(6, [0]) is not None
    assert pp.code_at(6, 0) == td.DIR_STAY
    assert not pp.needs_reentry(6, 0)


@JIT
def test_non_divisible_grid_matches_jax(use_jit):
    """H, W not multiples of S: edge sectors clip; every plan equal to the
    JAX planner's and never shorter than the BFS."""
    rng = np.random.default_rng(5)
    free = rng.random((50, 70)) > 0.15
    pp = Planners(free, 16, use_jit)
    assert (pp.t.sy, pp.t.sx) == (4, 5)
    cells = np.flatnonzero(free.reshape(-1))
    for _ in range(3 if use_jit else 6):
        st, gl = (int(c) for c in rng.choice(cells, 2, replace=False))
        plan = pp.plan(gl, [st])
        assert int(plan.dist.reshape(-1)[st]) >= min(int(_bfs(free, gl)[st]),
                                                     INF)


def test_corridor_spanning_the_grid_is_the_full_sweep():
    """One sector covering the grid: the corridor IS the grid, so the
    packed row equals the port's full sweep (and the JAX planner's)."""
    rng = np.random.default_rng(3)
    free = rng.random((32, 32)) > 0.15
    pp = Planners(free, 64, False)
    cells = np.flatnonzero(free.reshape(-1))
    f = torch.from_numpy(free.copy())
    for _ in range(3):
        st, gl = (int(c) for c in rng.choice(cells, 2, replace=False))
        plan = pp.plan(gl, [st])
        d = td.distance_fields(f, torch.tensor([gl], dtype=torch.int32))
        pk = td.pack_directions(
            td.directions_from_distance(d, f).reshape(1, -1))[0]
        np.testing.assert_array_equal(plan.packed,
                                      pk.numpy().view(np.uint32))


@JIT
def test_bounded_suboptimality_and_toggles_match_jax(use_jit):
    """The JAX package's property test at 96² (S = 32; 48² and S = 16
    on the jit path, whose JAX side compiles per shape): plans equal, ε at
    most the committed bound, strict descent along the codes; then block
    and unblock rounds of ``apply_toggles``, equal to the JAX planner and
    to a fresh rebuild."""
    rng = np.random.default_rng(3)
    side, s = (48, 16) if use_jit else (96, 32)
    free = rng.random((side, side)) > 0.15
    pp = Planners(free, s, use_jit)
    cells = np.flatnonzero(free.reshape(-1))
    eps_max, checked = 0.0, 0
    trials = 8 if use_jit else 24
    for _ in range(trials):
        st, gl = (int(c) for c in rng.choice(cells, 2, replace=False))
        fd = _bfs(free, gl)
        eps_max = max(eps_max, _eps_and_descent(pp, gl, st, fd))
        checked += fd[st] < INF
    assert checked >= trials // 2 and eps_max <= EPS
    blocked = [int(c) for c in rng.choice(cells, 10 if use_jit else 40,
                                          replace=False)]
    for c in blocked:
        free.reshape(-1)[c] = False
    pp.toggle(blocked)
    back = blocked[::2]
    for c in back:
        free.reshape(-1)[c] = True
    pp.toggle(back)


def _fuzz_world(seed, rng):
    kind = seed % 3
    if kind == 0:
        return rng.random((64, 64)) > 0.2
    if kind == 1:
        return np.asarray(JaxGrid.warehouse(64, 64).free).copy()
    return rng.random((48, 80)) > 0.3


@pytest.mark.parametrize("seed,use_jit", [
    (0, False), (1, False), (2, False), (3, False), (4, False), (5, False),
    (0, True), (1, True)])
def test_sector_fuzz_seeds_match_jax(seed, use_jit):
    """A seed of the JAX package's sector fuzz gate (S = 16 on even seeds,
    32 on odd), two trials: plans, ε and descent; a re-entry from an
    off-corridor cell; a block batch, the forgotten goal re-planned on the
    repaired graph, and the unblock — every graph equal to the JAX
    planner's and to a fresh rebuild."""
    rng = np.random.default_rng(seed)
    free = _fuzz_world(seed, rng)
    s = (16, 32)[seed % 2]
    pp = Planners(free, s, use_jit)
    flat = free.reshape(-1)
    for _ in range(2):
        cells = np.flatnonzero(flat)
        st, gl = (int(c) for c in rng.choice(cells, 2, replace=False))
        fd = _bfs(free, gl)
        assert _eps_and_descent(pp, gl, st, fd) <= EPS
        q = int(rng.choice(cells))
        if q != gl and pp.needs_reentry(gl, q):
            assert _eps_and_descent(pp, gl, q, fd) <= EPS
        batch = [int(c) for c in rng.choice(cells, 6, replace=False)
                 if c != gl and c != st][:4]
        for c in batch:
            flat[c] = False
        pp.toggle(batch)
        pp.t.forget(gl)
        pp.j.forget(gl)
        assert _eps_and_descent(pp, gl, st, _bfs(free, gl)) <= EPS
        for c in batch:
            flat[c] = True
        pp.toggle(batch)


def test_use_jit_default_picks_by_device(monkeypatch):
    free = np.ones((16, 16), bool)
    assert not tsec.SectorPlanner(free, s=8, device=CPU).use_jit
    assert tsec._use_jit_default(torch.device("cuda"))
    monkeypatch.setenv("JG_SECTOR_JIT", "1")
    assert tsec.SectorPlanner(free, s=8, device=CPU).use_jit
    monkeypatch.setenv("JG_SECTOR_JIT", "0")
    assert not tsec._use_jit_default(torch.device("cuda"))
    for name in ("DEFAULT_SECTOR_CELLS", "MAX_PLAN_STARTS", "REBUILD_CHUNK"):
        assert getattr(tsec, name) == getattr(jsec, name)


# ---------------------------------------------------------------------------
# the serving layer under JG_SECTOR=1
# ---------------------------------------------------------------------------


def _counters():
    j = jreg.get_registry().snapshot()["counters"]
    t = treg.get_registry().snapshot()["counters"]
    return ({k: j.get(k, 0) for k in COUNTERS},
            {k: t.get(k, 0) for k in COUNTERS})


def _deltas(before):
    after = _counters()
    return tuple({k: a[k] - b[k] for k in COUNTERS}
                 for a, b in zip(after, before))


def _services(free, monkeypatch, s, enabled=True, defer=False):
    if enabled:
        monkeypatch.setenv("JG_SECTOR", "1")
        monkeypatch.setenv("JG_SECTOR_CELLS", str(s))
    else:
        monkeypatch.delenv("JG_SECTOR", raising=False)
    monkeypatch.setenv("JG_DYNAMIC_WORLD", "1")
    j = jsd.PlanService(JaxGrid(free.copy()), capacity_min=4)
    t = tsd.PlanService(Grid(free.copy()), capacity_min=4, device=CPU)
    j.defer_fields = t.defer_fields = defer
    return j, t


def _assert_sector_state(j, t):
    assert (j.sector is None) == (t.sector is None)
    assert list(j.goal_rows.items()) == list(t.goal_rows.items())
    np.testing.assert_array_equal(np.asarray(j.dirs),
                                  t.dirs.numpy().view(np.uint32))
    if t.sector is not None:
        assert t.sector.graph_state() == j.sector.graph_state()
        assert sorted(t.sector.plans) == sorted(j.sector.plans)
        assert t.sector_hints == j.sector_hints
    assert sorted(t.dist_mirror) == sorted(j.dist_mirror)


def _walk(j, t, free, fleet, max_steps):
    """The JAX package's legacy plan() walk, on both services at once:
    the same moves every step, every move onto a free cell."""
    pos = {pid: p for pid, p, _ in fleet}
    goal = {pid: g for pid, _, g in fleet}
    for step in range(max_steps):
        req = [(pid, pos[pid], goal[pid]) for pid in pos]
        moves = j.plan(req)
        assert t.plan(req) == moves, step
        for pid, np_, ng in moves:
            assert free.reshape(-1)[np_]
            pos[pid], goal[pid] = np_, ng
        if all(pos[p] == goal[p] for p in pos):
            _assert_sector_state(j, t)
            return step + 1
    raise AssertionError("stuck")


def test_service_corridor_rows_and_reentry_match_jax(monkeypatch):
    rng = np.random.default_rng(11)
    free = rng.random((36, 36)) > 0.12
    before = _counters()
    j, t = _services(free, monkeypatch, 12)
    assert t.sector is not None and t.sector.s == 12
    cells = np.flatnonzero(free.reshape(-1))
    fd, fleet = {}, []
    while len(fleet) < 3:
        s0, g0 = (int(c) for c in rng.choice(cells, 2, replace=False))
        fd.setdefault(g0, _bfs(free, g0))
        if fd[g0][s0] < INF:
            fleet.append((f"a{len(fleet)}", s0, g0))
    _walk(j, t, free, fleet, 600)
    jd_, td_ = _deltas(before)
    assert td_ == jd_ and td_["solverd.sector_routes"] >= 3
    gl = fleet[0][2]
    outside = [int(c) for c in cells if t.sector.needs_reentry(gl, int(c))
               and fd[gl][int(c)] < INF]
    assert outside, "the corridor covers every reachable cell"
    before = _counters()
    _walk(j, t, free, [("re", outside[0], gl)], 600)
    jd_, td_ = _deltas(before)
    assert td_ == jd_ and td_["solverd.sector_reentries"] == 1


def test_service_world_toggle_repairs_corridors_like_jax(monkeypatch):
    rng = np.random.default_rng(4)
    free = rng.random((36, 36)) > 0.12
    j, t = _services(free, monkeypatch, 12)
    cells = np.flatnonzero(free.reshape(-1))
    s0, g0 = (int(c) for c in rng.choice(cells, 2, replace=False))
    while _bfs(free, g0)[s0] >= INF:
        s0, g0 = (int(c) for c in rng.choice(cells, 2, replace=False))
    assert t.plan([("w", s0, g0)]) == j.plan([("w", s0, g0)])
    pick = next(int(c) for c in rng.permutation(cells)
                if int(c) not in (s0, g0))
    before = _counters()
    assert t.apply_world_update([(pick, True)]) == \
        j.apply_world_update([(pick, True)]) == 1
    free.reshape(-1)[pick] = False
    jd_, td_ = _deltas(before)
    assert td_ == jd_ and td_["solverd.sector_rebuilds"] > 0
    _assert_sector_state(j, t)
    assert t.sector.graph_state() == tsec.SectorPlanner(
        t.free_np, s=12, use_jit=False, device=CPU).graph_state()
    if _bfs(free, g0)[s0] < INF:
        _walk(j, t, free, [("w", s0, g0)], 800)


def test_one_sector_spanning_the_grid_serves_the_unset_bytes(monkeypatch):
    """JG_SECTOR unset builds no planner and never enters a sector hook;
    JG_SECTOR=1 with one sector over the grid serves the same moves,
    across a world toggle, in both packages."""
    rng = np.random.default_rng(9)
    free = rng.random((32, 32)) > 0.1
    cells = np.flatnonzero(free.reshape(-1))
    fleet = [(f"a{i}", int(s), int(g)) for i, (s, g) in enumerate(
        rng.choice(cells, (6, 2), replace=False))]
    pick = int(next(c for c in rng.permutation(cells)
                    if int(c) not in {x for _, s, g in fleet
                                      for x in (s, g)}))

    def run(svc):
        out, cur = [], list(fleet)
        for tick in range(14):
            if tick == 7:
                svc.apply_world_update([(pick, True)])
            moves = svc.plan(cur)
            out.append(moves)
            cur = [(pid, p, g) for pid, p, g in moves]
        return out

    j_off, t_off = _services(free, monkeypatch, 64, enabled=False)
    assert t_off.sector is None

    def _boom(*a, **k):  # must never run with JG_SECTOR unset
        raise AssertionError("sector path entered with JG_SECTOR unset")

    monkeypatch.setattr(t_off, "_sector_sweep", _boom)
    monkeypatch.setattr(t_off, "_sector_reenter", _boom)
    base = run(t_off)
    assert base == run(j_off) and t_off.sector_hints == {}
    j_on, t_on = _services(free, monkeypatch, 64)
    assert t_on.sector.sy * t_on.sector.sx == 1
    assert run(t_on) == base == run(j_on)


def test_resident_path_banks_hints_and_parks_like_jax(monkeypatch):
    """Packed resident path with deferred fields: the snapshot banks the
    lane's start before it parks on the STAY row, and the idle window
    corridor-plans the goal and releases the lane, in both daemons."""
    rng = np.random.default_rng(6)
    free = rng.random((48, 48)) > 0.1
    j, t = _services(free, monkeypatch, 16, defer=True)
    rj = jsd.TickRunner(j, JaxGrid(free.copy()))
    rt = tsd.TickRunner(t, Grid(free.copy()))
    cells = np.flatnonzero(free.reshape(-1))
    s0, g0 = (int(c) for c in rng.choice(cells, 2, replace=False))
    while _bfs(free, g0)[s0] >= INF or s0 == g0:
        s0, g0 = (int(c) for c in rng.choice(cells, 2, replace=False))
    enc = pc.PackedFleetEncoder(snapshot_every=1000)
    req = {"type": "plan_request", "seq": 1, "codec": pc.CODEC_NAME,
           "caps": [pc.CODEC_NAME],
           "data": pc.encode_b64(enc.encode_tick(1, [("a", s0, g0)]))}
    a, b = rj.handle(req), rt.handle(req)
    assert a["data"] == b["data"]
    assert pc.decode_b64(b["data"]).idx.size == 0  # parked
    assert s0 in t.sector_hints.get(g0, set())
    before = _counters()
    assert t.process_field_queue() == j.process_field_queue() == 1
    jd_, td_ = _deltas(before)
    assert td_ == jd_ and td_["solverd.sector_routes"] == 1
    assert t.sector.manages(g0) and not t.lane_wait
    _assert_sector_state(j, t)
