"""Traffic kind ``stale_solves``: whole offline MAPD solves back to back, as
``whole_solves`` runs them, under the decentralized agent's stale views.

The configuration's ``planner`` sets the radius, the view's refresh period
and TTL and the commit delay, so ``mapd_step`` takes its stale branch:
last step's goal exchanges commit, the view refreshes, ``step_stale``
decides on the view and moves on the true cells.  The solves, their
inputs, the warm-up, the window and the cut solve finished after it are
``whole_solves``'s (``traffic/whole_solves.py``), run from a private copy
of that module in which this file's ``_solver_config`` and ``_step`` take
the place of its own.

Correctness (:func:`check`): ``assign_mismatch``, ``plan_faults`` and
``field_mismatch`` as ``whole_solves`` computes them (the rows of an agent
whose field is due for a replan, a goal pushed at the end of a step under
a zero delay, are not compared); ``undelivered`` by the stale step's rule
(``reference/stale.py`` ``undelivered``: a committed exchange can land a
goal on an agent's own cell before the task machine turns it idle, so the
DELIVERED row that ``whole_solves`` counts once may be missing or
repeated); in place of its ``move_mismatch``, which holds a stay to the
fresh step's rule, ``stale_step_mismatch``: at each sampled step the state
before the step is kept on the device with no sync, and after the window
``reference/stale.py`` works the whole step out again for every agent;
every agent whose position, goal, pending source, push target, phase or
view entry (broadcast cell, goal and stamp) differs counts.

A mix may set ``steps_per_solve``: each solve then ends after that many
steps, or at its own finish if that comes first, and the solve cut at the
window's close runs on only to that step.  A solve so cut has no end to
judge, so ``task_order_faults`` (``reference/stale.py`` ``out_of_order``:
each owner's recorded states in the stale rule's order, so far) takes the
place of ``undelivered``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.solver import mapd
from tswap_bench.reference import assign as ref_assign
from tswap_bench.reference import plans as ref_plans
from tswap_bench.reference import stale as ref_stale


def _load_base():
    """A copy of ``whole_solves.py`` of this kind's own, so that the hooks
    put into it leave the ``whole_solves`` kind as it is."""
    name = f"{__name__}._whole_solves"
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).with_name("whole_solves.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_base = _load_base()
_MAPD = "p2p_distributed_tswap_tpu_torch.solver.mapd"
# Host phases of the window, by the program function that runs them, none
# inside another: the labels of the device's idle gaps in a traced run.
ATTRIBUTION = dict(_base.ATTRIBUTION, step=f"{_MAPD}:step_stale",
                   commit=f"{_MAPD}:_commit_pending",
                   view=f"{_MAPD}:_broadcast_view")
# Exact counts, each with the limit 0; a mix that cuts its solves counts
# "task_order_faults" in place of "undelivered".
LIMITS = {"assign_mismatch": 0, "plan_faults": 0, "undelivered": 0,
          "field_mismatch": 0, "stale_step_mismatch": 0}
CUT_LIMITS = {("task_order_faults" if k == "undelivered" else k): v
              for k, v in LIMITS.items()}
# The state a stale step reads, by the reference's names.
_BEFORE = {"pos": "pos", "goal": "goal", "phase": "phase",
           "task": "agent_task", "used": "task_used", "vpos": "vpos",
           "vgoal": "vgoal", "vstamp": "vstamp", "pend_from": "pend_from",
           "pend_push": "pend_push", "t": "t"}


def _solver_config(config: dict) -> SolverConfig:
    plan = config["planner"]
    if plan["mode"] != "decentralized-stale":
        raise ValueError(f"planner mode {plan['mode']!r} is not served")
    if plan["field_path"] != "default":
        raise ValueError(f"field path {plan['field_path']!r} is not served")
    # Rule 3's push case for an idle claimant; a program whose SolverConfig
    # has no such setting runs "push" alone.
    rule = plan.get("idle_claimant", "push")
    knobs = {}
    if "idle_claimant" in {f.name for f in dataclasses.fields(SolverConfig)}:
        knobs["idle_claimant"] = rule
    elif rule != "push":
        raise ValueError(f"idle claimant rule {rule!r} is not served")
    g = config["grid"]
    cfg = SolverConfig(height=g["height"], width=g["width"],
                       num_agents=config["num_agents"],
                       max_timesteps=plan["max_timesteps"],
                       replan_chunk=min(plan["replan_chunk"],
                                        config["num_agents"]),
                       replan_chunk_small=plan["replan_chunk_small"],
                       visibility_radius=plan["visibility_radius"],
                       view_refresh_steps=plan["view_refresh_steps"],
                       view_ttl_steps=plan["view_ttl_steps"],
                       swap_commit_delay=plan["swap_commit_delay"],
                       **knobs)
    if not cfg.stale_mode:
        raise ValueError("the planner's settings do not engage stale mode")
    return cfg


def _capture(ctx, inp, k: int, before: dict, s) -> dict:
    """``whole_solves``'s rows of the sampled agents after step ``k``, and
    the whole state before and after it; on the device, no sync."""
    sel, far = _base._sample(ctx, inp, before["pos"], before["goal"], s)
    return {"k": k, "pos_in": before["pos"][sel], "pos_out": s.pos[sel],
            "goal": s.goal[sel], "far": far[sel] & ~s.need_replan[sel],
            "rows": s.dirs[s.slot[sel]], "before": before,
            "after": {name: getattr(s, name).clone()
                      for name in ref_stale.COMPARED}}


def state_before(s) -> dict:
    """The program's state ``s`` as ``reference/stale.py`` ``step`` reads
    it, copied on its device."""
    return {ref: getattr(s, name).clone() for ref, name in _BEFORE.items()}


def _step(ctx, op) -> None:
    """One MAPD step of the solve under way, its capture where due, and
    the finish test (a host sync)."""
    s, inp = op.s, op.rec.inputs
    before = state_before(s) if op.k in inp.check_steps else None
    s = mapd.mapd_step(ctx.cfg, s, op.tasks, ctx.free)
    if before is not None:
        op.rec.captures.append(_capture(ctx, inp, op.k, before, s))
    op.s, op.k = s, op.k + 1
    op.done = (hostsync.flag(mapd._finished(ctx.cfg, s))
               or op.k == ctx.steps_per_solve)


def setup(config: dict, mix: dict, cell: dict, seed: int, device):
    """``whole_solves``'s set-up, and the mix's cut of each solve (``None``
    where it runs every solve to its end)."""
    ctx = _base.setup(config, mix, cell, seed, device)
    ctx.steps_per_solve = mix.get("steps_per_solve")
    return ctx


_base._solver_config = _solver_config
_base._step = _step
window, finish = _base.window, _base.finish


def rules(cfg: SolverConfig) -> ref_stale.Rules:
    """The settings of ``cfg`` that ``reference/stale.py`` reads."""
    return ref_stale.Rules(width=cfg.width, radius=cfg.visibility_radius,
                           refresh=cfg.view_refresh_steps,
                           ttl=cfg.view_ttl_steps,
                           delay=cfg.swap_commit_delay,
                           cycle_cap=cfg.cycle_cap,
                           max_move_rounds=cfg.max_move_rounds,
                           idle_claimant=getattr(cfg, "idle_claimant",
                                                 "push"))


def stale_mismatch(ctx, rec) -> int:
    """Agents of the solve ``rec``'s sampled steps whose state after the
    step differs from the reference's step from the same state."""
    hops = ref_stale.NextCells(ctx.free, ctx.cfg.width,
                               ctx.check["reference_batch"])
    settings = rules(ctx.cfg)
    tasks = rec.inputs.tasks
    return sum(ref_stale.mismatches(
        ref_stale.step(c["before"], tasks, settings, hops), c["after"])
        for c in rec.captures)


def check(ctx, out: dict) -> tuple:
    """Judge every solve of the window against the plain reference.
    Returns (checks: [(name, value, limit)], attempted, failed)."""
    w, horizon = ctx.cfg.width, ctx.cfg.max_timesteps
    cut = ctx.steps_per_solve is not None
    limits = CUT_LIMITS if cut else LIMITS
    totals = dict.fromkeys(limits, 0)
    failed = 0
    for rec in out["solves"]:
        inp = rec.inputs
        t = int(rec.t)
        rows = min(t, rec.paths_pos.shape[0])
        ref = ref_assign.first_assignment(inp.starts, inp.tasks, w)
        owners = ref_assign.owners(ref, ctx.num_tasks)
        states = rec.paths_state[:rows]
        found = {
            "assign_mismatch": int((rec.assigned.long() != ref).sum()),
            "plan_faults": ref_plans.faults(inp.starts, rec.paths_pos[:rows],
                                            ctx.free, w),
            **({"task_order_faults": ref_stale.out_of_order(states, owners)}
               if cut else {"undelivered": ref_stale.undelivered(
                   states, owners, t, horizon)}),
            "field_mismatch": _base._field_checks(ctx, rec)[0],
            "stale_step_mismatch": stale_mismatch(ctx, rec),
        }
        for name, value in found.items():
            totals[name] += value
        failed += any(v > limits[k] for k, v in found.items())
    checks = [(name, totals[name], limits[name]) for name in limits]
    return checks, len(out["solves"]), failed
