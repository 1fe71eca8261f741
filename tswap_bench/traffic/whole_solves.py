"""Traffic kind ``whole_solves``: whole offline MAPD solves, back to back.

Each solve is what the program's ``run_mapd`` does: ``prepare_state``
(the first assignment and the prime of every agent's field), then
``mapd_step`` until ``_finished`` reads true.  Solve ``i`` of every run
poses one task set on one set of starts, drawn from seed
``i * seed_stride`` (``traffic/inputs.py``; solve 0 is the scenario
ladder's seed-0 instance); the run's seed deals the same starts and tasks
out in another order, a permutation of the agents and one of the tasks.
So every seed plans the same cells, and the seed changes which agent
starts where, the task order and the ties they break, not the size of the
work.

The window opens after set-up and closes at the first step boundary past
``seconds``: every step in it counts, a solve's prepare in its first step,
and the solve under way at the close is cut there.  After the close,
untimed, the cut solve runs on to its end (:func:`finish`), so that every
solve the window started is judged whole.

Correctness (:func:`check`, after the window): every solve's first
assignment against ``reference/assign.py``; every recorded row of every
solve against ``reference/plans.py`` (free cells, no shared cell, unit
steps) and every task's delivery, one per task; at sampled steps, the
direction rows of sampled agents against ``reference/fields.py``, and
each sampled agent's move: to the reference's next cell, or a stay where
another agent ends the step on that cell.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.solver import mapd
from tswap_bench.reference import assign as ref_assign
from tswap_bench.reference import fields as ref_fields
from tswap_bench.reference import plans as ref_plans
from tswap_bench.traffic import inputs

_MAPD = "p2p_distributed_tswap_tpu_torch.solver.mapd"
# Host phases of the window, by the program function that runs them: the
# labels of the device's idle gaps in a traced run.
ATTRIBUTION = {
    "assign": f"{_MAPD}:_assign",
    "prime": f"{_MAPD}:prime_fields",
    "transitions": f"{_MAPD}:_transitions",
    "replan": f"{_MAPD}:_replan",
    "step": f"{_MAPD}:step_parallel",
    "record": f"{_MAPD}:_record",
}
# Every number compared is a count of exact integer answers that differ
# from the reference or break a guarantee: the limit of each is 0.
LIMITS = {"assign_mismatch": 0, "plan_faults": 0, "undelivered": 0,
          "field_mismatch": 0, "move_mismatch": 0}


@dataclasses.dataclass
class Inputs:
    starts: torch.Tensor      # (N,) int32
    tasks: torch.Tensor       # (T, 2) int32
    rank: torch.Tensor        # (N,) int64: a permutation, the agents' draw
    check_steps: frozenset    # step indices whose moves are captured


@dataclasses.dataclass
class Solve:
    inputs: Inputs
    assigned: torch.Tensor = None   # agent_task after the first assignment
    paths_pos: torch.Tensor = None
    paths_state: torch.Tensor = None
    t: torch.Tensor = None          # steps taken: the makespan
    captures: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Open:
    """A solve under way: its record, the program's state, its steps."""
    rec: Solve
    s: object
    tasks: torch.Tensor
    k: int = 0
    done: bool = False


@dataclasses.dataclass
class Ctx:
    cfg: object
    free_np: np.ndarray
    free: torch.Tensor
    device: torch.device
    num_agents: int
    num_tasks: int
    seed: int
    stride: int
    check: dict
    prepared: list


def _solver_config(config: dict) -> SolverConfig:
    plan = config["planner"]
    if plan["mode"] != "centralized":
        raise ValueError(f"planner mode {plan['mode']!r} is not served")
    if plan["field_path"] != "default":
        raise ValueError(f"field path {plan['field_path']!r} is not served")
    g = config["grid"]
    return SolverConfig(height=g["height"], width=g["width"],
                        num_agents=config["num_agents"],
                        max_timesteps=plan["max_timesteps"],
                        replan_chunk=min(plan["replan_chunk"],
                                         config["num_agents"]),
                        replan_chunk_small=plan["replan_chunk_small"])


def _inputs(ctx: Ctx, i: int) -> Inputs:
    starts, tasks = inputs.solve_inputs(ctx.free_np, ctx.num_agents,
                                        ctx.num_tasks, i * ctx.stride)
    rng = np.random.default_rng([abs(ctx.seed), int(ctx.seed < 0), i])
    starts = starts[rng.permutation(ctx.num_agents)]
    tasks = tasks[rng.permutation(ctx.num_tasks)]
    chk = ctx.check
    steps = {0} | set(rng.integers(1, chk["step_span"],
                                   size=chk["steps"]).tolist())
    rank = rng.permutation(ctx.num_agents)
    dev = ctx.device
    return Inputs(starts=torch.from_numpy(starts).to(dev),
                  tasks=torch.from_numpy(tasks).to(dev),
                  rank=torch.from_numpy(rank).to(dev),
                  check_steps=frozenset(steps))


def setup(config: dict, mix: dict, cell: dict, seed: int,
          device: torch.device) -> Ctx:
    """Build the grid, the inputs of the solves the window is expected to
    run, and warm up: one whole prepare (assignment and prime) and a few
    steps on a solve outside the stream, at the cell's own shapes."""
    if mix["tasks_per_agent"] != 1:
        # the check ties each task to the agent that takes it first
        raise ValueError("whole_solves poses one task per agent")
    t0 = time.perf_counter()
    free_np = inputs.build_grid(config["grid"])
    ctx = Ctx(cfg=_solver_config(config), free_np=free_np,
              free=torch.from_numpy(free_np).to(device), device=device,
              num_agents=config["num_agents"],
              num_tasks=config["num_agents"], seed=seed,
              stride=mix["seed_stride"], check=cell["check"], prepared=[])
    ctx.prepared = [_inputs(ctx, i) for i in range(cell["solves_prepared"])]
    warm = _inputs(ctx, ctx.stride - 1)
    t1 = time.perf_counter()
    s, tasks = mapd.prepare_state(ctx.cfg, warm.starts, warm.tasks, ctx.free,
                                  device=device)
    for _ in range(mix["warmup_steps"]):
        s = mapd.mapd_step(ctx.cfg, s, tasks, ctx.free)
    hostsync.flag(mapd._finished(ctx.cfg, s))
    del s, tasks
    print(f"whole_solves: grid and inputs {t1 - t0:.2f} s, warm-up "
          f"{time.perf_counter() - t1:.2f} s", file=sys.stderr)
    return ctx


def _sample(ctx: Ctx, inp: Inputs, pos_in, goal_in, s) -> tuple:
    """(the agents captured after one step, which of all agents stand two
    or more cells from their goal): ``check["agents"]`` for their rows,
    and ``check["stayed"]`` more for their moves.  Rows
    first from agents whose goal changed in the step, then from any
    standing two or more cells from its goal (the step reads an agent's
    row only there: one cell away it steps onto its goal, on it it stays,
    and a goal pushed onto a neighbour cell keeps its row, the program's
    Rule-3 push in ``solver/step.py``).  Moves first from agents that
    stayed off their goal, where a cut cascade shows.  Within a tier, by
    the solve's seeded ``rank``."""
    n, w = ctx.num_agents, ctx.cfg.width
    far = ((s.pos % w - s.goal % w).abs()
           + (s.pos // w - s.goal // w).abs()) >= 2
    fresh = far & (s.goal != goal_in)
    rows = torch.topk(inp.rank + (2 - fresh.long() - far.long()) * n,
                      ctx.check["agents"], largest=False).indices
    stayed = (s.pos == pos_in) & (pos_in != s.goal)
    key = inp.rank + (~stayed).long() * n
    key[rows] = 3 * n
    moves = torch.topk(key, ctx.check["stayed"], largest=False).indices
    return torch.cat([rows, moves]), far


def _capture(ctx: Ctx, inp: Inputs, k: int, before, s) -> dict:
    """The rows and moves of the sampled agents after step ``k``; on the
    device, no sync."""
    pos_in, goal_in = before
    sel, far = _sample(ctx, inp, pos_in, goal_in, s)
    return {"k": k, "pos_in": pos_in[sel], "pos_out": s.pos[sel],
            "goal": s.goal[sel], "far": far[sel],
            "rows": s.dirs[s.slot[sel]]}


def _begin(ctx: Ctx, inp: Inputs) -> Open:
    s, tasks = mapd.prepare_state(ctx.cfg, inp.starts, inp.tasks, ctx.free,
                                  device=ctx.device)
    op = Open(rec=Solve(inputs=inp), s=s, tasks=tasks)
    op.rec.assigned = s.agent_task.clone()
    op.done = hostsync.flag(mapd._finished(ctx.cfg, s))
    return op


def _step(ctx: Ctx, op: Open) -> None:
    """One MAPD step of the solve under way, its capture where due, and
    the finish test (a host sync)."""
    s, inp = op.s, op.rec.inputs
    before = ((s.pos.clone(), s.goal.clone())
              if op.k in inp.check_steps else None)
    s = mapd.mapd_step(ctx.cfg, s, op.tasks, ctx.free)
    if before is not None:
        op.rec.captures.append(_capture(ctx, inp, op.k, before, s))
    op.s, op.k = s, op.k + 1
    op.done = hostsync.flag(mapd._finished(ctx.cfg, s))


def _close(op: Open) -> None:
    rec, s = op.rec, op.s
    rec.paths_pos, rec.paths_state, rec.t = (s.paths_pos, s.paths_state,
                                             s.t)
    op.s = op.tasks = None


def window(ctx: Ctx, seconds: float) -> dict:
    """Run solves back to back until ``seconds`` have passed, one step at
    least; return the host seconds of every step, the window's length, the
    solves' records and the solve cut at the close (``None`` if none)."""
    step_s, solves = [], []
    op = None
    t_open = time.perf_counter()
    last = t_open
    while True:
        if op is None or op.done:
            i = len(solves)
            if i < len(ctx.prepared):
                inp, ctx.prepared[i] = ctx.prepared[i], None
            else:
                print(f"whole_solves: solve {i} drawn inside the window",
                      file=sys.stderr)
                inp = _inputs(ctx, i)
            op = _begin(ctx, inp)
            solves.append(op.rec)
            if op.done:
                # nothing to plan: its prepare counts in the next step
                _close(op)
                continue
        _step(ctx, op)
        if op.done:
            _close(op)
        now = time.perf_counter()
        step_s.append(now - last)
        last = now
        if now - t_open >= seconds:
            break
    return {"step_s": step_s, "window_s": last - t_open, "solves": solves,
            "open": None if op.done else op}


def finish(ctx: Ctx, out: dict) -> None:
    """Run the solve cut at the window's close on to its end, untimed."""
    op = out.pop("open", None)
    if op is None:
        return
    steps = op.k
    while not op.done:
        _step(ctx, op)
    _close(op)
    print(f"whole_solves: the cut solve ran {op.k - steps} more steps "
          "after the close", file=sys.stderr)


def _field_checks(ctx: Ctx, rec: Solve) -> tuple:
    """(cells of the rows read by the step whose code differs from the
    reference's, sampled agents whose move is neither to the reference's
    next cell nor a stay where another agent ends the step on that
    cell)."""
    captures = rec.captures
    if not captures:
        return 0, 0
    hw = ctx.free.numel()
    w = ctx.cfg.width
    goal = torch.cat([c["goal"] for c in captures])
    rows = torch.cat([c["rows"] for c in captures])
    pos_in = torch.cat([c["pos_in"] for c in captures]).long()
    pos_out = torch.cat([c["pos_out"] for c in captures]).long()
    far = torch.cat([c["far"] for c in captures])
    # each sampled agent's step, and every agent's cell at its end
    k = torch.cat([torch.full_like(c["goal"], c["k"], dtype=torch.long)
                   for c in captures])
    ends = rec.paths_pos.long()
    field_bad = move_bad = 0
    batch = ctx.check["reference_batch"]
    for o in range(0, goal.shape[0], batch):
        g = goal[o:o + batch]
        ref = ref_fields.codes(ref_fields.distances(ctx.free, g),
                               ctx.free).reshape(g.shape[0], hw)
        got = ref_fields.unpack(rows[o:o + batch], hw)
        field_bad += int(((ref != got) & far[o:o + batch, None]).sum())
        p = pos_in[o:o + batch]
        code = ref.gather(1, p[:, None])[:, 0]
        nxt = ref_fields.next_cell(p, code, w)
        move_bad += ref_plans.wrong_moves(p, pos_out[o:o + batch], nxt,
                                          ends[k[o:o + batch]])
        del ref, got
    return field_bad, move_bad


def check(ctx: Ctx, out: dict) -> tuple:
    """Judge every solve of the window against the plain reference.
    Returns (checks: [(name, value, limit)], attempted, failed)."""
    w, horizon = ctx.cfg.width, ctx.cfg.max_timesteps
    totals = dict.fromkeys(LIMITS, 0)
    failed = 0
    for rec in out["solves"]:
        inp = rec.inputs
        t = int(rec.t)
        rows = min(t, rec.paths_pos.shape[0])
        ref = ref_assign.first_assignment(inp.starts, inp.tasks, w)
        found = {
            "assign_mismatch": int((rec.assigned.long() != ref).sum()),
            "plan_faults": ref_plans.faults(inp.starts, rec.paths_pos[:rows],
                                            ctx.free, w),
            "undelivered": ref_plans.undelivered(
                rec.paths_state[:rows], ref_assign.owners(ref, ctx.num_tasks),
                t, horizon),
        }
        found["field_mismatch"], found["move_mismatch"] = _field_checks(
            ctx, rec)
        for name, value in found.items():
            totals[name] += value
        failed += any(v > LIMITS[k] for k, v in found.items())
    checks = [(name, totals[name], LIMITS[name]) for name in LIMITS]
    return checks, len(out["solves"]), failed
