"""The port's stale-view decentralized solve against the JAX package's.

The cases of tests/test_stale_mode.py (a trailing convoy waiting on a
ghost, the delayed-commit window, the push at a shared delivery cell, the
view TTL, slot and pending permutations) run through both packages, step
for step, with every field of the state equal; full solves of the
``ref-50x100x100-decent-stale`` rung with commit delay 0 and 1 and with a
TTL give the same paths and makespan; a state carried across mid-solve
(``convert``), with exchanges in flight and stale views, steps to the same
next state.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.config import SolverConfig as JaxConfig
from p2p_distributed_tswap_tpu.core.grid import Grid
from p2p_distributed_tswap_tpu.core.sampling import start_positions_array
from p2p_distributed_tswap_tpu.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu.models import scenarios as jscn
from p2p_distributed_tswap_tpu.solver import mapd as jmapd
from p2p_distributed_tswap_tpu.solver import step as jstep
from p2p_distributed_tswap_tpu_torch import convert
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.models import scenarios as tscn
from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd
from p2p_distributed_tswap_tpu_torch.solver import step as tstep

CPU = torch.device("cpu")
STALE = dict(visibility_radius=8, view_refresh_steps=3,
             swap_commit_delay=1, view_ttl_steps=30)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Thousands of small tensor ops: on the CPU, intra-op threads cost more
    # than they give, most of all with several test workers on the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(height, width, n, **kw):
    kw = dict(height=height, width=width, num_agents=n, **kw)
    return JaxConfig(**kw), SolverConfig(**kw)


def _jax_fields(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def _assert_states_equal(want: dict, got: dict):
    assert set(want) == set(got)
    for name in want:
        assert want[name].dtype == got[name].dtype, name
        np.testing.assert_array_equal(want[name], got[name], err_msg=name)


def _assert_legal(grid, paths):
    w = grid.width
    free = grid.free.reshape(-1)
    for t in range(paths.shape[0]):
        assert len(np.unique(paths[t])) == paths.shape[1]
        assert free[paths[t]].all()
        if t:
            d = (np.abs(paths[t] % w - paths[t - 1] % w)
                 + np.abs(paths[t] // w - paths[t - 1] // w))
            assert (d <= 1).all()


def _solve_both(grid, starts, tasks, cfg_j, cfg_t):
    pj, sj, mj = jmapd.solve_offline(grid, starts, tasks, cfg_j)
    pt, st, mt = tmapd.solve_offline(grid, starts, tasks, cfg_t, device=CPU)
    assert mt == mj
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(sj, st)
    return pt, st, mt


def _drive_both(grid, starts, tasks, cfg_j, cfg_t, steps):
    """Prepare and step both packages; every field of the two states equal
    after the prime and after every step.  Returns the port's states (each
    a snapshot in numpy: the port writes path buffers in place)."""
    free_j = jnp.asarray(grid.free)
    s_j, tasks_j = jmapd.prepare_state(cfg_j, jnp.asarray(starts, jnp.int32),
                                       jnp.asarray(tasks, jnp.int32), free_j)
    s_t, tasks_t = tmapd.prepare_state(cfg_t, starts, tasks, grid.free,
                                       device=CPU)
    _assert_states_equal(_jax_fields(s_j), convert.state_to_numpy(s_t))
    step = jax.jit(functools.partial(jmapd.mapd_step, cfg_j))
    free_t = torch.from_numpy(grid.free)
    out = []
    for _ in range(steps):
        s_j = step(s_j, tasks_j, free_j)
        s_t = tmapd.mapd_step(cfg_t, s_t, tasks_t, free_t)
        got = convert.state_to_numpy(s_t)
        _assert_states_equal(_jax_fields(s_j), got)
        out.append(got)
    return out


def _corridor(width):
    return Grid.from_ascii("." * width)


def test_trailing_convoy_waits_on_ghost():
    """B leads (2 -> 7), A trails one behind (1 -> 6): a 4-step-stale view
    makes A wait on B's ghost, which a fresh view does not."""
    grid = _corridor(8)
    starts, tasks = np.array([1, 2]), np.array([[1, 6], [2, 7]])

    def makespan(k):
        cfg_j, cfg_t = _configs(1, 8, 2, max_timesteps=100,
                                visibility_radius=8, view_refresh_steps=k,
                                swap_commit_delay=1)
        paths, _, m = _solve_both(grid, starts, tasks, cfg_j, cfg_t)
        _assert_legal(grid, paths)
        return m

    assert makespan(4) > makespan(1)


def test_delayed_swap_commit_window():
    """A Rule-3 goal swap decided at step t commits at step t+1; the
    requester waits in between."""
    cfg_j, cfg_t = _configs(1, 5, 2, max_timesteps=50, visibility_radius=5,
                            view_refresh_steps=1, swap_commit_delay=1)
    s1, s2, _ = _drive_both(_corridor(5), np.array([1, 2]),
                            np.array([[1, 4]]), cfg_j, cfg_t, 3)
    np.testing.assert_array_equal(s1["pos"], [1, 2])
    np.testing.assert_array_equal(s1["goal"], [4, 2])
    np.testing.assert_array_equal(s1["pend_from"], [1, 0])
    np.testing.assert_array_equal(s2["goal"], [2, 4])
    assert s2["pos"][1] == 3


def test_shared_delivery_push_resolves():
    """Two tasks delivering to cell 3, where B starts parked: the push
    resolves as the terminal mutual position swap and agent 0 reaches 3."""
    cfg_j, cfg_t = _configs(1, 6, 2, max_timesteps=60, visibility_radius=6,
                            view_refresh_steps=1, swap_commit_delay=1)
    grid = _corridor(6)
    paths, _, m = _solve_both(grid, np.array([0, 3]),
                              np.array([[0, 3], [3, 3]]), cfg_j, cfg_t)
    assert m < 60
    _assert_legal(grid, paths)
    assert (paths[:, 0] == 3).any()


@pytest.mark.parametrize("visible", [[True, False], [True, True]])
def test_ttl_expired_entry_reads_as_free(visible):
    """B's view entry aged out: A believes cell 2 free and tries the move,
    the physical cascade refuses it and no swap pends.  With the entry
    visible, A waits for a goal swap instead."""
    cfg_j, cfg_t = _configs(1, 5, 2, max_timesteps=50, visibility_radius=5,
                            view_refresh_steps=1, swap_commit_delay=1,
                            view_ttl_steps=2)
    pos, goal = np.array([1, 2], np.int32), np.array([4, 2], np.int32)
    slot = np.arange(2, dtype=np.int32)
    vis = np.array(visible)
    want = jstep.step_stale(
        cfg_j, *map(jnp.asarray, (pos, goal, slot)),
        lambda sl, po: jnp.minimum(po + 1, 4), jnp.asarray(pos),
        jnp.asarray(goal), jnp.asarray(vis), jnp.ones(2, bool))
    t = tuple(map(torch.from_numpy, (pos, goal, slot)))
    got = tstep.step_stale(cfg_t, *t, lambda sl, po: torch.clamp(po + 1,
                                                                 max=4),
                           t[0], t[1], torch.from_numpy(vis))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(got[0].numpy(), [1, 2])
    np.testing.assert_array_equal(got[1].numpy(),
                                  [0, 1] if not visible[1] else [1, 0])


def test_slot_and_pending_stay_permutations():
    grid = Grid.random_obstacles(12, 12, 0.1, seed=7)
    n = 10
    starts = start_positions_array(grid, n, seed=2)
    tasks = TaskGenerator(grid, seed=3).generate_task_arrays(n)
    cfg_j, cfg_t = _configs(12, 12, n, max_timesteps=120, **STALE)
    states = _drive_both(grid, starts, tasks, cfg_j, cfg_t, 60)
    for s in states:
        np.testing.assert_array_equal(np.sort(s["slot"]), np.arange(n))
        np.testing.assert_array_equal(np.sort(s["pend_from"]), np.arange(n))
    assert any((s["pend_from"] != np.arange(n)).any() for s in states)


@pytest.mark.parametrize("name,kw", [
    ("delay1", {}), ("delay0", dict(delay=0)),
    ("ttl", dict(refresh=4, ttl=2))])
def test_ref_decent_stale_solve_matches_jax(name, kw):
    """The ref rung under stale views (the scenario's own knobs: radius 15,
    refresh 2, commit delay 1), with an atomic commit, and with a view TTL
    that expires entries (refresh 4, TTL 2)."""
    scn_j = jscn.REFERENCE_DEMO.stale(**kw)
    scn_t = tscn.REFERENCE_DEMO.stale(**kw)
    assert scn_t.name == scn_j.name == "ref-50x100x100-decent-stale"
    assert scn_t.mode == scn_j.mode
    grid, starts, tasks, cfg_t = scn_t.build(seed=0)
    cfg_j = scn_j.build(seed=0)[3]
    assert cfg_t.stale_mode
    paths, _, m = _solve_both(grid, starts, tasks, cfg_j, cfg_t)
    assert 0 < m <= cfg_t.max_timesteps
    _assert_legal(grid, paths)


def test_mid_solve_handoff_in_stale_mode():
    """JAX steps until exchanges are in flight and views are stale; the
    state crosses to the port, which takes the next step; both next states
    are equal field for field."""
    grid = Grid.warehouse(64, 64)
    n = 40
    starts = start_positions_array(grid, n, seed=3)
    tasks = TaskGenerator(grid, seed=4).generate_task_arrays(40)
    cfg_j, cfg_t = _configs(64, 64, n, replan_chunk=16, visibility_radius=15,
                            view_refresh_steps=3, swap_commit_delay=1,
                            view_ttl_steps=5)
    free_j = jnp.asarray(grid.free)
    s, tasks_j = jax.jit(functools.partial(jmapd.prepare_state, cfg_j))(
        jnp.asarray(starts, jnp.int32), jnp.asarray(tasks, jnp.int32), free_j)
    step = jax.jit(functools.partial(jmapd.mapd_step, cfg_j))
    ident = np.arange(n)
    for _ in range(200):
        s = step(s, tasks_j, free_j)
        f = _jax_fields(s)
        if (f["pend_from"] != ident).any() and (f["vpos"] != f["pos"]).any():
            break
    else:
        pytest.fail("no step with a pending exchange and a stale view")
    handed = convert.state_from_numpy(f, CPU)
    _assert_states_equal(f, convert.state_to_numpy(handed))
    tasks_t = torch.from_numpy(np.array(tasks_j))
    for _ in range(2):
        s = step(s, tasks_j, free_j)
        handed = tmapd.mapd_step(cfg_t, handed, tasks_t,
                                 torch.from_numpy(grid.free))
        _assert_states_equal(_jax_fields(s), convert.state_to_numpy(handed))
