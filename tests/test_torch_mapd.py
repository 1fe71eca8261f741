"""The port's offline MAPD solve against the JAX package's.

Full solves must give the same recorded paths, states and makespan, and a
state carried across mid-solve (``convert``) must step to the same next
state.  The stale-view mode has its own file, tests/test_torch_stale.py.
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
from p2p_distributed_tswap_tpu.solver import mapd as jmapd
from p2p_distributed_tswap_tpu_torch import convert
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Thousands of small tensor ops: on the CPU, intra-op threads cost more
    # than they give, most of all with several test workers on the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _instance(grid, n_agents, n_tasks, seed):
    starts = start_positions_array(grid, n_agents, seed=seed)
    tasks = TaskGenerator(grid, seed=seed + 1).generate_task_arrays(n_tasks)
    return starts, tasks


def _configs(grid, n, **kw):
    kw = dict(height=grid.height, width=grid.width, num_agents=n, **kw)
    return JaxConfig(**kw), SolverConfig(**kw)


def _jax_fields(s):
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def _assert_states_equal(want: dict, got: dict):
    assert set(want) == set(got)
    for name in want:
        assert want[name].dtype == got[name].dtype, name
        np.testing.assert_array_equal(want[name], got[name], err_msg=name)


@pytest.mark.parametrize("grid_fn,na,nt,radius", [
    (lambda: Grid.random_obstacles(16, 16, 0.2, seed=9), 5, 6, None),
    (lambda: Grid.warehouse(64, 64), 40, 40, None),
    (lambda: Grid.warehouse(64, 64), 40, 40, 15),
], ids=["random16", "warehouse64", "warehouse64-r15"])
def test_full_solve_matches_jax(grid_fn, na, nt, radius):
    grid = grid_fn()
    starts, tasks = _instance(grid, na, nt, seed=2)
    cfg_j, cfg_t = _configs(grid, na, visibility_radius=radius)
    pj, sj, mj = jmapd.solve_offline(grid, starts, tasks, cfg_j)
    pt, st, mt = tmapd.solve_offline(grid, starts, tasks, cfg_t, device=CPU)
    assert 0 < mj <= cfg_j.max_timesteps
    assert mt == mj
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(sj, st)
    assert pt.dtype == np.int32 and st.dtype == np.int8


@pytest.mark.parametrize("radius", [None, 15])
def test_mid_solve_handoff_matches_jax(radius):
    """JAX prepares and steps k times; the state crosses to the port, which
    takes step k+1; the port's state equals the JAX package's at k+1, field
    for field.  The port's own prepare_state equals the JAX package's."""
    grid = Grid.warehouse(64, 64)
    n, k = 40, 12
    starts, tasks = _instance(grid, n, 40, seed=3)
    cfg_j, cfg_t = _configs(grid, n, visibility_radius=radius,
                            replan_chunk=16)
    free_j = jnp.asarray(grid.free)
    s, tasks_j = jax.jit(functools.partial(jmapd.prepare_state, cfg_j))(
        jnp.asarray(starts, jnp.int32), jnp.asarray(tasks, jnp.int32), free_j)
    s_t, tasks_t = tmapd.prepare_state(cfg_t, starts, tasks, grid.free,
                                       device=CPU)
    _assert_states_equal(_jax_fields(s), convert.state_to_numpy(s_t))

    step = jax.jit(functools.partial(jmapd.mapd_step, cfg_j))
    for _ in range(k):
        s = step(s, tasks_j, free_j)
    handed = convert.state_from_numpy(_jax_fields(s), CPU)
    assert handed.dirs.dtype == torch.int32
    _assert_states_equal(_jax_fields(s), convert.state_to_numpy(handed))
    s = step(s, tasks_j, free_j)
    got = tmapd.mapd_step(cfg_t, handed, tasks_t, torch.from_numpy(grid.free))
    assert int(got.t) == k + 1
    _assert_states_equal(_jax_fields(s), convert.state_to_numpy(got))


def test_nearest_unused_first_min_ties_match():
    """Equal Manhattan distances inside a chunk (first-min argmin) and
    across chunks (the strict ``<`` keeps the earlier chunk): the same task
    index per agent as the JAX package, with some tasks already used."""
    grid = Grid.from_ascii("\n".join(["." * 9] * 9))
    rng = np.random.default_rng(4)
    pos = np.array([40, 0, 80, 44, 36], np.int32)
    # pickups in mirrored pairs round the agents: many exact ties
    pick = np.array([31, 49, 39, 41, 30, 50, 4, 76, 8, 72, 22, 58], np.int32)
    tasks = np.stack([pick, np.roll(pick, 1)], axis=1)
    used = rng.random(len(pick)) > 0.7
    cfg_j, cfg_t = _configs(grid, len(pos), assign_chunk=5)
    dj, kj = jmapd._nearest_unused(cfg_j, jnp.asarray(pos), jnp.asarray(used),
                                   jnp.asarray(tasks))
    dt, kt = tmapd._nearest_unused(cfg_t, torch.from_numpy(pos),
                                   torch.from_numpy(used),
                                   torch.from_numpy(tasks))
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())


def test_zero_tasks_solve_is_empty():
    grid = Grid.from_ascii("\n".join(["." * 6] * 6))
    starts = np.array([0, 7], np.int32)
    tasks = np.zeros((0, 2), np.int32)
    pj, sj, mj = jmapd.solve_offline(grid, starts, tasks)
    pt, st, mt = tmapd.solve_offline(grid, starts, tasks, device=CPU)
    assert mj == mt == 0
    assert pj.shape == pt.shape and sj.shape == st.shape


def test_invalid_inputs_rejected():
    grid = Grid.from_ascii("..@\n...")
    with pytest.raises(ValueError, match="duplicate"):
        tmapd.solve_offline(grid, np.array([0, 0]), np.zeros((0, 2)),
                            device=CPU)
    with pytest.raises(ValueError, match="obstacle"):
        tmapd.solve_offline(grid, np.array([2]), np.zeros((0, 2)),
                            device=CPU)
    with pytest.raises(ValueError, match="obstacle"):
        tmapd.solve_offline(grid, np.array([0]), np.array([[1, 2]]),
                            device=CPU)
