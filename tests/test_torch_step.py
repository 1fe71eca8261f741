"""The port's TSWAP step against the JAX package's, case by case.

Each case puts agents where one rule of the step must fire (a Rule-3 goal
swap, the push extension at a shared delivery cell, a Rule-4 rotation, a
mutual position swap) and checks both that the rule fired and that the
port's ``(pos, goal, slot)`` equal the JAX package's after every step.
Centralized and radius-limited (decentralized, fresh) views both run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.config import SolverConfig as JaxConfig
from p2p_distributed_tswap_tpu.core.grid import Grid
from p2p_distributed_tswap_tpu.ops import distance as jd
from p2p_distributed_tswap_tpu.solver import invariants as jinv
from p2p_distributed_tswap_tpu.solver import step as jstep
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.solver import invariants as tinv
from p2p_distributed_tswap_tpu_torch.solver import step as tstep

_jax_step = jax.jit(jstep.step_parallel, static_argnums=0)


def _run_both(grid, pos, goal, radius, steps=1, cycle_cap=32):
    """Step both packages ``steps`` times from the same state; assert equal
    (pos, goal, slot) after every step and return the trajectory."""
    h, w = grid.free.shape
    n = len(pos)
    kw = dict(height=h, width=w, num_agents=n, visibility_radius=radius,
              cycle_cap=cycle_cap)
    cfg_j, cfg_t = JaxConfig(**kw), SolverConfig(**kw)
    fields = jd.direction_fields(jnp.asarray(grid.free),
                                 jnp.asarray(goal, jnp.int32))
    dirs_j = jd.pack_directions(fields.reshape(n, h * w))
    dirs_t = torch.from_numpy(np.array(dirs_j).view(np.int32))
    pj = (jnp.asarray(pos, jnp.int32), jnp.asarray(goal, jnp.int32),
          jnp.arange(n, dtype=jnp.int32))
    pt = tuple(torch.from_numpy(np.array(x)) for x in pj)
    free_t = torch.from_numpy(grid.free.copy())
    traj = []
    for _ in range(steps):
        prev_j, prev_t = pj[0], pt[0]
        pj = _jax_step(cfg_j, *pj, dirs_j)
        pt = tstep.step_parallel(cfg_t, *pt, dirs_t)
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        ok_j = bool(jinv.step_invariants(cfg_j, prev_j, pj[0],
                                         jnp.asarray(grid.free)))
        ok_t = bool(tinv.step_invariants(cfg_t, prev_t, pt[0], free_t))
        assert ok_j == ok_t
        traj.append(tuple(np.asarray(x) for x in pj))
    return traj


LINE = Grid.from_ascii("." * 8)
SQUARE = Grid.from_ascii("\n".join(["." * 4] * 4))
RADII = [None, 15]


@pytest.mark.parametrize("radius", RADII)
def test_rule3_goal_swap(radius):
    # agent 1 parks on its own goal in agent 0's way
    (pos, goal, slot), = _run_both(LINE, [4, 5], [7, 5], radius)
    np.testing.assert_array_equal(goal, [5, 7])
    np.testing.assert_array_equal(slot, [1, 0])


@pytest.mark.parametrize("radius", RADII)
def test_push_at_shared_delivery_then_mutual_swap(radius):
    # agent 1 parks on agent 0's goal, which is also its own: push, and the
    # pair resolves by a mutual position swap in the same step
    (pos, goal, _), = _run_both(LINE, [3, 4], [4, 4], radius)
    np.testing.assert_array_equal(goal, [4, 3])
    np.testing.assert_array_equal(pos, [4, 3])


@pytest.mark.parametrize("radius", RADII)
def test_rule4_head_on_rotation(radius):
    (pos, goal, _), = _run_both(LINE, [2, 3], [6, 0], radius)
    np.testing.assert_array_equal(goal, [0, 6])
    np.testing.assert_array_equal(pos, [1, 4])


@pytest.mark.parametrize("radius", RADII)
def test_rule4_ring_rotation(radius):
    pos = [5, 6, 10, 9]
    (p, goal, _), = _run_both(SQUARE, pos, [6, 10, 9, 5], radius)
    np.testing.assert_array_equal(goal, pos)
    np.testing.assert_array_equal(p, pos)


@pytest.mark.parametrize("radius", RADII)
def test_mutual_position_swap(radius):
    # with no cycle walk the head-on pair is left to the movement phase,
    # which swaps the two positions
    (pos, goal, _), = _run_both(LINE, [2, 3], [6, 0], radius, cycle_cap=0)
    np.testing.assert_array_equal(pos, [3, 2])
    np.testing.assert_array_equal(goal, [6, 0])


@pytest.mark.parametrize("radius,rotates", [(None, True), (15, True),
                                            (2, False)])
def test_ring_wider_than_radius_does_not_rotate(radius, rotates):
    """An 8-ring round a 3x3 block: every member has a member 3 or 4 cells
    away, so under radius 2 no member sees the whole ring and it must not
    rotate."""
    grid = Grid.from_ascii("\n".join(["." * 5] * 5))
    ring = [(1, 1), (2, 1), (3, 1), (3, 2), (3, 3), (2, 3), (1, 3), (1, 2)]
    pos = [grid.idx(p) for p in ring]
    goal = pos[1:] + pos[:1]
    (p, g, _), = _run_both(grid, pos, goal, radius)
    np.testing.assert_array_equal(g, pos if rotates else goal)


@pytest.mark.parametrize("radius", [None, 15, 3])
def test_congested_warehouse_steps(radius):
    grid = Grid.warehouse(24, 24, margin=2)
    rng = np.random.default_rng(11)
    cells = np.flatnonzero(grid.free.reshape(-1))
    pos = rng.choice(cells, 90, replace=False)
    goal = rng.choice(cells, 90, replace=False)
    traj = _run_both(grid, pos, goal, radius, steps=6)
    assert any((t[0] != pos).any() for t in traj)


def _masked_case(seed, n, h=12, w=12):
    """A padded lane layout as the serving path builds it: random active
    agents (one of them standing on cell 0) and inactive lanes parked at
    cell 0 with slot 0 and goal 0."""
    rng = np.random.default_rng(seed)
    grid = Grid.random_obstacles(h, w, 0.1, seed=seed)
    grid.free.reshape(-1)[0] = True
    cells = np.flatnonzero(grid.free.reshape(-1))
    cells = cells[cells != 0]
    active = rng.random(n) < 0.6
    active[rng.integers(n)] = True
    k = int(active.sum())
    pos = np.zeros(n, np.int32)
    goal = np.zeros(n, np.int32)
    slot = np.zeros(n, np.int32)
    pos[active] = rng.choice(cells, k, replace=False)
    goal[active] = rng.choice(cells, k)
    pos[np.flatnonzero(active)[0]] = 0  # an agent on the padded lanes' cell
    slot[active] = np.arange(k)
    return grid, pos, goal, slot, active


def _masked_dirs(grid, goal, active):
    h, w = grid.free.shape
    goals = goal[active]
    fields = jd.direction_fields(jnp.asarray(grid.free),
                                 jnp.asarray(goals, jnp.int32))
    dirs_j = jd.pack_directions(fields.reshape(len(goals), h * w))
    return dirs_j, torch.from_numpy(np.array(dirs_j).view(np.int32))


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_active_mask_matches_jax(seed, radius):
    """Random ``active`` masks at ``step_parallel`` and
    ``step_with_next_hops``: padded lanes at cell 0 never block, move or
    swap, and every lane equals the JAX package's over several steps."""
    grid, pos, goal, slot, active = _masked_case(seed, 24)
    h, w = grid.free.shape
    kw = dict(height=h, width=w, num_agents=len(pos),
              visibility_radius=radius)
    cfg_j, cfg_t = JaxConfig(**kw), SolverConfig(**kw)
    dirs_j, dirs_t = _masked_dirs(grid, goal, active)
    act_j, act_t = jnp.asarray(active), torch.from_numpy(active)
    sj = tuple(jnp.asarray(x) for x in (pos, goal, slot))
    st = tuple(torch.from_numpy(x.copy()) for x in (pos, goal, slot))
    hj = jax.jit(lambda p, g, s: jstep.step_with_next_hops(
        cfg_j, p, g, s, lambda sl, po: jstep.next_hops(cfg_j, dirs_j, sl,
                                                       po), act_j))
    free_t = torch.from_numpy(grid.free.copy())
    k_cfg = SolverConfig(**{**kw, "num_agents": int(active.sum())})
    for _ in range(4):
        prev = st
        sj = _jax_step(cfg_j, *sj, dirs_j, act_j)
        st = tstep.step_parallel(cfg_t, *st, dirs_t, act_t)
        ht = tstep.step_with_next_hops(
            cfg_t, *prev, lambda sl, po: tstep.next_hops(cfg_t, dirs_t, sl,
                                                         po), act_t)
        for a, b, c in zip(sj, st, ht):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert torch.equal(b, c)
        for a, b in zip(hj(*(jnp.asarray(x.numpy()) for x in prev)), st):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        # padded lanes stay parked, untouched, off the grid
        for a, b in zip(st, prev):
            np.testing.assert_array_equal(a.numpy()[~active],
                                          b.numpy()[~active])
        assert bool(tinv.step_invariants(k_cfg, prev[0][act_t],
                                         st[0][act_t], free_t))
        live = st[0].numpy()[active]
        assert len(np.unique(live)) == len(live)
    assert (st[0].numpy()[active] != pos[active]).any()


def test_step_outputs_never_alias_inputs():
    """The serving path scatters the next delta into its resident lanes
    while a step's outputs are still to be read: no output may be an
    input tensor, at any ``swap_rounds``."""
    grid, pos, goal, slot, active = _masked_case(3, 16)
    h, w = grid.free.shape
    _, dirs_t = _masked_dirs(grid, goal, active)
    for rounds in (0, 2):
        cfg = SolverConfig(height=h, width=w, num_agents=len(pos),
                           swap_rounds=rounds)
        ins = tuple(torch.from_numpy(x.copy()) for x in (pos, goal, slot))
        act = torch.from_numpy(active)
        outs = tstep.step_parallel(cfg, *ins, dirs_t, act)
        ptrs = {t.data_ptr() for t in (*ins, act, dirs_t)}
        assert not ptrs & {t.data_ptr() for t in outs}


@pytest.mark.parametrize("seed", [4, 5])
def test_active_mask_in_stale_step_matches_jax(seed):
    grid, pos, goal, slot, active = _masked_case(seed, 20)
    h, w = grid.free.shape
    kw = dict(height=h, width=w, num_agents=len(pos), visibility_radius=5,
              view_refresh_steps=2, swap_commit_delay=1)
    cfg_j, cfg_t = JaxConfig(**kw), SolverConfig(**kw)
    dirs_j, dirs_t = _masked_dirs(grid, goal, active)
    rng = np.random.default_rng(seed)
    vis = rng.random(len(pos)) < 0.8
    want = jstep.step_stale(
        cfg_j, *map(jnp.asarray, (pos, goal, slot)),
        lambda sl, po: jstep.next_hops(cfg_j, dirs_j, sl, po),
        jnp.asarray(pos), jnp.asarray(goal), jnp.asarray(vis),
        jnp.asarray(active))
    t = tuple(torch.from_numpy(x.copy()) for x in (pos, goal, slot))
    got = tstep.step_stale(
        cfg_t, *t, lambda sl, po: tstep.next_hops(cfg_t, dirs_t, sl, po),
        t[0], t[1], torch.from_numpy(vis), torch.from_numpy(active))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(got[0].numpy()[~active], 0)
