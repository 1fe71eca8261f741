"""The ``stale_solves`` kind, its check and its readers, on the CPU at small
sizes: a sound run is correct with every number 0; the fresh step in the
stale step's place and three faults planted in the stale step each give
``stale_step_mismatch`` above 0; the four readers of stale mode's spans and
counter on made-up windows; the port's live tracer records one
``mapd.view``, ``mapd.commit`` and ``step.cycles`` span and one
``stale_steps`` a stale step, and none of them in a centralized step; the
stale reference loads nothing of the program; and the idle-claimant rule:
on a drill where the push rule livelocks, the program and the reference
under ``push`` take the same steps into a state that recurs for ever, the
reference under ``park`` finishes, vertex-disjoint at every step, and the
program's ``push`` laid under a ``park`` reference is caught; a program
whose configuration has no ``idle_claimant`` is refused a ``park``
configuration as "not served".  A mix that cuts each solve after a fixed
number of steps (``steps_per_solve``, the ``stale-steps`` traffic) is
judged by ``task_order_faults`` in place of ``undelivered``: a sound cut
run is correct, and a step that returns its state unchanged, one that
leaves half the agents out, one answer altered where it is produced, the
fresh step and the planted faults are each caught."""

import dataclasses
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, run_cpu
from tswap_bench import harness
from tswap_bench.reference import stale as ref_stale
from tswap_bench.stale_control import CONTROL, FAULTS
from tswap_bench.traffic import inputs, stale_solves
from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.obs import registry, trace
from p2p_distributed_tswap_tpu_torch.solver import mapd, step

MS = 1_000_000
STALE = {
    "name": "stale-small",
    "source": "test",
    "grid": {"kind": "warehouse", "height": 40, "width": 60, "shelf_h": 2,
             "shelf_w": 8, "aisle": 2, "margin": 4},
    "num_agents": 200,
    "planner": {"mode": "decentralized-stale", "visibility_radius": 15,
                "view_refresh_steps": 2, "view_ttl_steps": None,
                "swap_commit_delay": 1, "replan_chunk": 16,
                "replan_chunk_small": 4, "max_timesteps": 1500,
                "field_path": "default"},
    "assumed": [], "reduced": [],
}
# Rings that reach past the radius are rare: radius 1 on a dense random
# grid, every step sampled.
NARROW = dict(STALE, name="stale-narrow",
              grid={"kind": "random_obstacles", "height": 32, "width": 40,
                    "density": 0.1, "seed": 0},
              num_agents=300,
              planner=dict(STALE["planner"], visibility_radius=1))
CHECK = {"steps": 6, "step_span": 80, "agents": 6, "stayed": 6,
         "reference_batch": 32}
EVERY_STEP = dict(CHECK, steps=400, step_span=80)


def make_stale_root(tmp, cfg, check=CHECK, cut=None):
    """A checkout root in ``tmp`` with one ``<config>.stale`` cell of the
    ``stale-solves`` traffic, or with ``cut`` of a mix that cuts each solve
    after ``cut`` steps."""
    shutil.copytree(ROOT / "tswap_bench", tmp / "tswap_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = cfg["name"]
    bench = tmp / "tswap_bench"
    traffic = "stale-solves"
    if cut is not None:
        traffic = "stale-cut"
        mix = json.loads((bench / "traffic" / "stale-steps.json")
                         .read_text())
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(
            dict(mix, steps_per_solve=cut)))
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "workloads" / f"{name}.stale.json").write_text(json.dumps(
        {"config": name, "traffic": traffic, "solves_prepared": 2,
         "check": check}))
    m["configs"].append({"name": name, "source": "test",
                         "file": f"tswap_bench/configs/{name}.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": f"{name}.stale", "config": name,
                           "traffic": traffic, "chips": 1,
                           "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp


def test_sound_stale_run_is_correct(tmp_path):
    r = run_cpu(make_stale_root(tmp_path, STALE), "stale-small.stale",
                seconds=2.0)
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"assign_mismatch", "plan_faults",
                                "undelivered", "field_mismatch",
                                "stale_step_mismatch"}
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_centralized_configuration_is_refused(tmp_path):
    cfg = dict(STALE, planner=dict(STALE["planner"], mode="centralized"))
    with pytest.raises(ValueError, match="not served"):
        run_cpu(make_stale_root(tmp_path, cfg), "stale-small.stale")


@pytest.mark.parametrize("name", ["fresh_step", *sorted(FAULTS)])
def test_fresh_step_and_faults_are_caught(tmp_path, name):
    target, fn = CONTROL if name == "fresh_step" else FAULTS[name]
    cfg, check = ((NARROW, EVERY_STEP) if name == "no_radius_test"
                  else (STALE, CHECK))
    root = make_stale_root(tmp_path, cfg, check)
    r = run_cpu(root, f"{cfg['name']}.stale", seconds=2.0,
                patches={target: fn})
    assert r["correct"] is False
    assert r["checks"]["stale_step_mismatch"]["value"] > 0
    assert r["failed"] >= 1


# A cut of each solve well before its end on STALE's grid (makespans
# about 150), and the sample drawn within it.
CUT, CUT_CHECK = 40, dict(CHECK, step_span=40)


def test_sound_cut_run_is_correct(tmp_path):
    r = run_cpu(make_stale_root(tmp_path, STALE, CUT_CHECK, cut=CUT),
                "stale-small.stale", seconds=2.0)
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"assign_mismatch", "plan_faults",
                                "task_order_faults", "field_mismatch",
                                "stale_step_mismatch"}
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_cut_solves_end_at_the_cut(tmp_path):
    root = make_stale_root(tmp_path, STALE, CUT_CHECK, cut=CUT)
    kind = harness.load_module(root / "tswap_bench" / "traffic"
                               / "stale_solves.py")
    bench = root / "tswap_bench"
    cfg = json.loads((bench / "configs" / "stale-small.json").read_text())
    mix = json.loads((bench / "traffic" / "stale-cut.json").read_text())
    cell = json.loads((bench / "workloads" / "stale-small.stale.json")
                      .read_text())
    torch.set_num_threads(1)
    ctx = kind.setup(cfg, mix, cell, 5, torch.device("cpu"))
    out = kind.window(ctx, 1.0)
    kind.finish(ctx, out)
    assert [int(rec.t) for rec in out["solves"]] == [CUT] * len(
        out["solves"])


def out_of_order_counts():
    # rows: steps; columns: agents; 1 PICKING, 2 CARRYING, 3 DELIVERED,
    # 0 IDLE
    state = torch.tensor([[1, 1, 1, 2],
                          [2, 1, 3, 0],
                          [3, 2, 0, 1],
                          [0, 2, 0, 1]])
    return (ref_stale.out_of_order(state, torch.tensor([0, 1, 2, 3])),
            ref_stale.out_of_order(state, torch.tensor([0, 1, -1])))


def test_out_of_order_counts_only_a_broken_order():
    # agent 3 goes from IDLE back to PICKING; task 2 of the second call
    # has no owner
    assert out_of_order_counts() == (1, 1)


def _unchanged(cfg, s, tasks, free, *args, **kw):
    """A step that returns its state unchanged."""
    return s


def _half_left_out(cfg, s, nh_factory):
    """The TSWAP step applied to the first half of the agents only."""
    new = TSWAP(cfg, s, nh_factory)
    half = torch.arange(cfg.num_agents) < cfg.num_agents // 2
    return new.replace(pos=torch.where(half, new.pos, s.pos),
                       goal=torch.where(half, new.goal, s.goal))


def _one_goal_altered(cfg, s, nh_factory):
    """Agent 0's goal replaced by its own cell where the step makes it."""
    new = TSWAP(cfg, s, nh_factory)
    goal = new.goal.clone()
    goal[0] = new.pos[0]
    return new.replace(goal=goal)


TSWAP = mapd._tswap
MAPD = "p2p_distributed_tswap_tpu_torch.solver.mapd"
BROKEN = {"unchanged": (f"{MAPD}:mapd_step", _unchanged),
          "half_left_out": (f"{MAPD}:_tswap", _half_left_out),
          "one_goal_altered": (f"{MAPD}:_tswap", _one_goal_altered)}


@pytest.mark.parametrize("name", [*sorted(BROKEN), "fresh_step",
                                  *sorted(FAULTS)])
def test_faults_are_caught_in_cut_solves(tmp_path, name):
    target, fn = (BROKEN[name] if name in BROKEN else CONTROL
                  if name == "fresh_step" else FAULTS[name])
    cfg, check = ((NARROW, dict(EVERY_STEP, step_span=CUT))
                  if name == "no_radius_test" else (STALE, CUT_CHECK))
    root = make_stale_root(tmp_path, cfg, check, cut=CUT)
    r = run_cpu(root, f"{cfg['name']}.stale", seconds=2.0,
                patches={target: fn})
    assert r["correct"] is False
    assert r["checks"]["stale_step_mismatch"]["value"] > 0
    assert r["failed"] >= 1


def reader(name):
    return harness.load_module(ROOT / "tswap_bench" / "metrics"
                               / f"{name}.py")


@pytest.fixture(scope="module")
def progtrace():
    """``tswap_bench.progtrace``, imported with the tracer and the registry
    that its import replaces put back afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "_tracer", trace.get_tracer())
        mp.setattr(registry, "_registry", registry.Registry())
        from tswap_bench import progtrace
        yield progtrace


def test_span_readers_on_a_made_up_window(monkeypatch, progtrace):
    monkeypatch.setattr(trace, "_tracer",
                        trace.Tracer(enabled=True, capacity=1 << 12))
    monkeypatch.setattr(progtrace, "PROGRAM",
                        progtrace.ProgramSpans(1 << 12))
    base = time.perf_counter_ns()
    lo, hi = base + 10 * MS, base + 110 * MS
    trace.complete("mapd.view", base, 5 * MS)       # before the window
    for k in range(4):                              # four steps of 25 ms
        t = lo + MS + k * 25 * MS
        trace.complete("mapd.commit", t, MS // 2,
                       parent="mapd.transitions")
        trace.complete("mapd.view", t + 5 * MS, MS, parent="mapd.tswap")
        trace.complete("step.cycles", t + 7 * MS, 3 * MS,
                       parent="step.swap")
    win = harness.Window(window_s=0.1, step_s=[0.025] * 4, setup_s=1.0,
                         trace_lo=lo, trace_hi=hi)
    got = {n: reader(n).read(win) for n in ("view_ms_per_step",
                                             "commit_ms_per_step",
                                             "stale_cycles_ms_per_step")}
    assert got == pytest.approx({"view_ms_per_step": 1.0,
                                 "commit_ms_per_step": 0.5,
                                 "stale_cycles_ms_per_step": 3.0}, rel=1e-3)
    later = harness.Window(window_s=0.1, step_s=[0.025] * 4, setup_s=1.0,
                           trace_lo=hi, trace_hi=hi + 100 * MS)
    empty = harness.Window(window_s=0.0, step_s=[], setup_s=1.0,
                           trace_lo=lo, trace_hi=hi)
    for name in got:                # no span of its own, or no step
        assert reader(name).read(later) is None
        assert reader(name).read(empty) is None


def test_stale_steps_reader_on_a_made_up_window():
    read = reader("stale_steps_per_step").read

    def win(opened, closed, steps=4):
        return harness.Window(window_s=1.0, step_s=[0.25] * steps,
                              setup_s=1.0,
                              calls={"stale_steps.open": opened,
                                     "stale_steps.close": closed})
    assert read(win([10, 12], [11, 13, 14])) == pytest.approx(1.0)
    assert read(win([10], [18])) == pytest.approx(2.0)
    assert read(win([10], [10])) is None            # no stale step
    assert read(win([None], [None])) is None        # a program without it
    assert read(win([], [14])) is None              # no probe reading
    assert read(win([10], [14], steps=0)) is None   # no step


def _problem(stale: bool, delay: int = 1):
    from tswap_bench.traffic import inputs

    free_np = inputs.build_grid(STALE["grid"])
    n = 60
    starts, tasks = inputs.solve_inputs(free_np, n, n, 0)
    knobs = dict(visibility_radius=15, view_refresh_steps=2,
                 swap_commit_delay=delay) if stale else {}
    cfg = SolverConfig(height=40, width=60, num_agents=n, replan_chunk=16,
                       max_timesteps=400, **knobs)
    return cfg, torch.from_numpy(starts), torch.from_numpy(tasks), \
        torch.from_numpy(free_np)


NEW = ("mapd.view", "mapd.commit", "step.cycles")


@pytest.mark.parametrize("stale,delay", [(True, 1), (True, 0), (False, 0)],
                         ids=["stale-delay1", "stale-delay0", "centralized"])
def test_live_tracer_records_stale_spans_per_stale_step(monkeypatch, stale,
                                                        delay):
    torch.set_num_threads(1)
    tracer = trace.Tracer(enabled=True)
    monkeypatch.setattr(trace, "_tracer", tracer)
    cfg, starts, tasks, free = _problem(stale, delay)
    s, tasks = mapd.prepare_state(cfg, starts, tasks, free, device="cpu")
    tracer._drain()
    for _ in range(5):
        before = step.stale_steps
        s = mapd.mapd_step(cfg, s, tasks, free)
        names = [e["name"] for e in tracer._drain() if e["ph"] == "X"]
        counts = {n: names.count(n) for n in NEW}
        if stale:
            # a zero delay commits twice: last step's and this step's
            assert counts == {"mapd.view": 1, "mapd.commit": 2 - delay,
                              "step.cycles": 1}
            assert step.stale_steps == before + 1
        else:
            assert counts == dict.fromkeys(NEW, 0)
            assert step.stale_steps == before
    assert np.all(s.pos.numpy() >= 0)


def test_stale_reference_loads_nothing_of_the_program():
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.')\n"
         "import tswap_bench.reference.stale\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    tops = set(eval(p.stdout))
    assert not any(t.startswith("p2p_distributed") for t in tops)
    assert not tops & {"jax", "jaxlib", "flax"}


# The idle-push drill: 300 agents on STALE's 40 x 60 warehouse, whose 300
# tasks deliver to 40 shared cells (a few packing stations; seed 21).
# Under the push rule three idle agents that share the goal (15, 10) beside
# an aisle crossing push it among themselves, and ten agents with tasks
# wait behind them for good; under the park rule the solve ends at step
# 158.
DRILL_AGENTS, DRILL_SEED, DRILL_STATIONS = 300, 21, 40


def _drill():
    free_np = inputs.build_grid(STALE["grid"])
    n = DRILL_AGENTS
    starts, tasks = inputs.solve_inputs(free_np, n, n, DRILL_SEED * 1000)
    rng = np.random.default_rng(DRILL_SEED)
    stations = rng.choice(tasks[:, 1], DRILL_STATIONS, replace=False)
    tasks[:, 1] = rng.choice(stations, n)
    plan = STALE["planner"]
    cfg = SolverConfig(height=40, width=60, num_agents=n,
                       max_timesteps=plan["max_timesteps"],
                       replan_chunk=plan["replan_chunk"],
                       replan_chunk_small=plan["replan_chunk_small"],
                       visibility_radius=plan["visibility_radius"],
                       view_refresh_steps=plan["view_refresh_steps"],
                       swap_commit_delay=plan["swap_commit_delay"])
    assert cfg.stale_mode
    free = torch.from_numpy(free_np)
    s, tasks = mapd.prepare_state(cfg, torch.from_numpy(starts),
                                  torch.from_numpy(tasks), free,
                                  device="cpu")
    return cfg, free, s, tasks


def _rules(cfg, rule):
    return dataclasses.replace(stale_solves.rules(cfg), idle_claimant=rule)


def _recurring_key(state: dict, refresh: int) -> tuple:
    """All that the reference's step reads of ``state`` under no TTL: a
    state whose key recurs repeats for ever."""
    return tuple(tuple(state[k].tolist()) for k in (
        "pos", "goal", "phase", "task", "vpos", "vgoal", "pend_from",
        "pend_push")) + (int(state["t"]) % refresh,)


def test_push_drill_livelocks_in_the_program_and_the_reference():
    torch.set_num_threads(1)
    cfg, free, s, tasks = _drill()
    hops = ref_stale.NextCells(free, cfg.width, 64)
    rules = _rules(cfg, "push")
    seen, differ, recurred = set(), 0, False
    for _ in range(400):
        before = stale_solves.state_before(s)
        key = _recurring_key(before, cfg.view_refresh_steps)
        if key in seen:
            recurred = True
            break
        seen.add(key)
        want = ref_stale.step(before, tasks, rules, hops)
        s = mapd.mapd_step(cfg, s, tasks, free)
        differ += ref_stale.mismatches(want, vars(s))
    assert differ == 0
    assert recurred
    busy = before["phase"] != ref_stale.IDLE
    assert 0 < int(busy.sum()) <= 12        # agents with tasks held for ever
    assert not hostsync.flag(mapd._finished(cfg, s))


def _reference_solve(cfg, free, s, tasks, rule, horizon):
    """Step the reference alone from the program's first state ``s`` under
    ``rule``.  Returns (steps taken, finished, every step vertex-disjoint
    unit moves on free cells)."""
    hops = ref_stale.NextCells(free, cfg.width, 64)
    rules = _rules(cfg, rule)
    state = stale_solves.state_before(s)
    open_cells = set(torch.nonzero(free.reshape(-1)).flatten().tolist())
    w, sound = cfg.width, True
    for k in range(horizon):
        if bool(state["used"].all()) and not bool(
                (state["phase"] != ref_stale.IDLE).any()):
            return k, True, sound
        nxt = ref_stale.step(state, tasks, rules, hops)
        old, new = state["pos"].tolist(), nxt["pos"]
        sound &= (len(set(new)) == len(new) and set(new) <= open_cells
                  and all(abs(a % w - b % w) + abs(a // w - b // w) <= 1
                          for a, b in zip(old, new)))
        task = [-1 if ph == ref_stale.IDLE else tk
                for ph, tk in zip(nxt["phase"], state["task"].tolist())]
        state = {**{name: torch.tensor(v) for name, v in nxt.items()},
                 "task": torch.tensor(task), "used": state["used"],
                 "t": int(state["t"]) + 1}
    return horizon, False, sound


def test_park_reference_finishes_the_drill():
    torch.set_num_threads(1)
    cfg, free, s, tasks = _drill()
    steps, finished, sound = _reference_solve(cfg, free, s, tasks, "park",
                                              400)
    assert finished and steps == 158
    assert sound


def test_push_program_is_caught_by_a_park_reference():
    torch.set_num_threads(1)
    cfg, free, s, tasks = _drill()
    hops = ref_stale.NextCells(free, cfg.width, 64)
    rules = _rules(cfg, "park")
    differ = 0
    for _ in range(40):
        want = ref_stale.step(stale_solves.state_before(s), tasks, rules,
                              hops)
        s = mapd.mapd_step(cfg, s, tasks, free)
        differ += ref_stale.mismatches(want, vars(s))
    assert differ > 0


PARK = dict(STALE, name="stale-park",
            planner=dict(STALE["planner"], idle_claimant="park"))
PARK_FILE = (ROOT / "tswap_bench" / "configs"
             / "congested-3k-256-decent-stale-park.json")


def _without_rule():
    """``SolverConfig``'s fields but ``idle_claimant``, as a program that
    has no such setting."""
    fields = [(f.name, f.type, dataclasses.field(default=f.default))
              for f in dataclasses.fields(SolverConfig)
              if f.name != "idle_claimant"]
    keep = ("__post_init__", "num_cells", "stale_mode")
    return dataclasses.make_dataclass(
        "SolverConfig", fields, frozen=True,
        namespace={k: vars(SolverConfig)[k] for k in keep})


def test_park_configuration_is_refused_without_the_rule(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(stale_solves, "SolverConfig", _without_rule())
    with pytest.raises(ValueError, match="not served"):
        stale_solves._solver_config(json.loads(PARK_FILE.read_text()))
    cfg = stale_solves._solver_config(STALE)
    assert cfg.stale_mode and not hasattr(cfg, "idle_claimant")
    assert stale_solves.rules(cfg).idle_claimant == "push"
    if "idle_claimant" not in {f.name for f in
                               dataclasses.fields(SolverConfig)}:
        # the program as it stands: a run of the park cell is refused
        monkeypatch.undo()
        with pytest.raises(ValueError, match="not served"):
            run_cpu(make_stale_root(tmp_path, PARK), "stale-park.stale")


def test_rule_is_passed_on_where_the_program_has_it(monkeypatch):
    @dataclasses.dataclass(frozen=True)
    class WithRule(SolverConfig):
        idle_claimant: str = "push"

    monkeypatch.setattr(stale_solves, "SolverConfig", WithRule)
    cfg = stale_solves._solver_config(json.loads(PARK_FILE.read_text()))
    assert cfg.idle_claimant == "park"
    assert stale_solves.rules(cfg).idle_claimant == "park"
    cfg = stale_solves._solver_config(STALE)
    assert stale_solves.rules(cfg).idle_claimant == "push"
    with pytest.raises(ValueError, match="idle claimant"):
        _rules(cfg, "yield")
