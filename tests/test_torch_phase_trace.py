"""The port's tracing of the solve step, on small grids on the CPU.

``mapd_step`` records one span a phase (``mapd.transitions``,
``mapd.assign``, ``mapd.replan``, ``mapd.tswap`` with ``step.swap`` and
``step.cascade`` inside it, ``mapd.record``) and ``prepare_state`` records
``mapd.assign`` and ``mapd.prime``; counters beside the work count the
sweep fixpoint's rounds and batches (``ops/distance.py``), the movement
cascade's rounds (``solver/step.py``) and the field rows computed
(``solver/mapd.py``).  Pinned here:

- the spans' names and parents, fresh and stale;
- with the tracer off a whole solve leaves the ring empty, and on or off
  the final state is the same, bit for bit;
- over a step with no assignment, the host syncs (``hostsync.count``) are
  the sum of their sites: the assignment's idle test, the replan's chunks
  and its last drain test, the fixpoint's rounds and the cascade's rounds;
- ``field_rows`` grows by the chunk width for every chunk computed, and
  the fixpoint runs one batch a chunk.
"""

import dataclasses

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.core.sampling import (
    start_positions_array,
)
from p2p_distributed_tswap_tpu_torch.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu_torch.obs import trace
from p2p_distributed_tswap_tpu_torch.ops import distance
from p2p_distributed_tswap_tpu_torch.solver import mapd, step

N, TASKS = 12, 10   # every task is handed out by the first assignment
STALE = dict(visibility_radius=8, view_refresh_steps=3,
             swap_commit_delay=1, view_ttl_steps=30)
GRIDS = {
    "random": lambda: Grid.random_obstacles(20, 24, 0.15, seed=3),
    "warehouse": lambda: Grid.warehouse(22, 30, shelf_w=6, margin=3),
}
STEP_SPANS = [("mapd.transitions", None), ("mapd.assign", None),
              ("mapd.replan", None), ("step.swap", "mapd.tswap"),
              ("step.cascade", "mapd.tswap"), ("mapd.tswap", None),
              ("mapd.record", None)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tracer(monkeypatch):
    """The port's tracer switched on for the test, restored after."""
    t = trace.Tracer(enabled=True)
    monkeypatch.setattr(trace, "_tracer", t)
    return t


def _problem(grid="random", stale=False, replan_chunk=5):
    g = GRIDS[grid]()
    cfg = SolverConfig(height=g.height, width=g.width, num_agents=N,
                       replan_chunk=replan_chunk, replan_chunk_small=3,
                       max_timesteps=300, **(STALE if stale else {}))
    starts = start_positions_array(g, N, seed=0)
    tasks = TaskGenerator(g, seed=1).generate_task_arrays(TASKS)
    return cfg, starts, tasks, torch.as_tensor(np.asarray(g.free))


def _spans(tracer) -> list:
    """(name, parent, start us, end us) of the ring's spans, emptied."""
    return [(ev["name"], ev["args"].get("parent"), ev["ts"],
             ev["ts"] + ev["dur"]) for ev in tracer._drain()
            if ev["ph"] == "X"]


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_step_records_its_phases(tracer, stale):
    cfg, starts, tasks, free = _problem(stale=stale)
    s, tasks = mapd.prepare_state(cfg, starts, tasks, free, device="cpu")
    assert [sp[:2] for sp in _spans(tracer)] == [("mapd.assign", None),
                                                 ("mapd.prime", None)]
    for _ in range(4):
        s = mapd.mapd_step(cfg, s, tasks, free)
        spans = _spans(tracer)
        assert [sp[:2] for sp in spans] == STEP_SPANS
        tswap = spans[5]
        for _, _, t0, t1 in spans[3:5]:     # inside mapd.tswap
            assert tswap[2] <= t0 <= t1 <= tswap[3]
        top = [spans[i] for i in (0, 1, 2, 5, 6)]
        for a, b in zip(top, top[1:]):      # one after another
            assert a[3] <= b[2]


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_tracing_changes_nothing(monkeypatch, stale):
    """Off, a whole solve leaves the ring empty; on or off, the final
    state is the same."""
    cfg, starts, tasks, free = _problem(stale=stale)
    finals = {}
    for on in (True, False):
        t = trace.Tracer(enabled=on)
        monkeypatch.setattr(trace, "_tracer", t)
        finals[on] = mapd.run_mapd(cfg, starts, tasks, free, device="cpu")
        assert (t.snapshot()["buffered_events"] > 0) == on
    assert int(finals[True].t) > 10
    for f in dataclasses.fields(mapd.MapdState):
        assert torch.equal(getattr(finals[True], f.name),
                           getattr(finals[False], f.name)), f.name


def _counts() -> dict:
    return {"syncs": hostsync.count, "rows": mapd.field_rows,
            "rounds": distance.fixpoint_rounds,
            "batches": distance.fixpoint_batches,
            "cascade": step.cascade_rounds}


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_host_syncs_are_the_sum_of_their_sites(monkeypatch, grid, stale):
    cfg, starts, tasks, free = _problem(grid, stale)
    chunks = []
    fields = mapd.direction_fields

    def counted(*args, **kw):
        chunks.append(1)
        return fields(*args, **kw)
    monkeypatch.setattr(mapd, "direction_fields", counted)
    s, tasks = mapd.prepare_state(cfg, starts, tasks, free, device="cpu")
    r = cfg.replan_chunk_small
    replanned = moved = 0
    while not hostsync.flag(mapd._finished(cfg, s)):
        assert bool(torch.all(s.task_used))   # so no assignment runs
        before, chunks[:] = _counts(), []
        s = mapd.mapd_step(cfg, s, tasks, free)
        d = {k: v - before[k] for k, v in _counts().items()}
        assert d["rows"] == r * len(chunks)
        assert d["batches"] == len(chunks)
        assert d["syncs"] == (1 + len(chunks) + 1 + d["rounds"]
                              + d["cascade"])
        assert d["cascade"] >= 1
        replanned += len(chunks)
        moved += d["cascade"] > 1
    assert replanned > 0 and moved > 0
    assert int(s.t) <= cfg.max_timesteps


@pytest.mark.parametrize("replan_chunk", [5, N], ids=["tail", "one-chunk"])
def test_prime_counts_its_rows(replan_chunk):
    cfg, starts, tasks, free = _problem(replan_chunk=replan_chunk)
    before = _counts()
    mapd.prepare_state(cfg, starts, tasks, free, device="cpu")
    chunks = -(-N // replan_chunk)
    assert mapd.field_rows - before["rows"] == replan_chunk * chunks
    assert distance.fixpoint_batches - before["batches"] == chunks
