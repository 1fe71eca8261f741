"""The port's agent-axis sharded solver (``parallel/sharded.py``) against
the JAX package's, on meshes of 2, 4 and 8 shards.

The JAX side runs ``solve_offline_sharded`` on the virtual CPU mesh of
``tests/conftest.py``; the port's on a virtual CPU mesh of as many shards.
Paths, states and makespan must be equal (and equal to the port's flat
solve), fresh and under stale views, the push extension included; the
validation errors and the zero-task case behave as in the JAX package; a
sharded state crosses between the packages through ``convert``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.config import SolverConfig as JaxConfig
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.core.sampling import start_positions_array
from p2p_distributed_tswap_tpu.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu.parallel import sharded as jsh
from p2p_distributed_tswap_tpu.parallel.mesh import agent_mesh as jax_mesh
from p2p_distributed_tswap_tpu_torch import convert, hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.ops.distance import PACKED_STAY
from p2p_distributed_tswap_tpu_torch.parallel import sharded as tsh
from p2p_distributed_tswap_tpu_torch.parallel.mesh import Sharded, agent_mesh
from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
    virtual_devices)
from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd

STALE = dict(visibility_radius=8, view_refresh_steps=3, swap_commit_delay=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(k):
    return agent_mesh(k, virtual_devices(k, "cpu"))


def _both(free, na, nt, seed, k, **kw):
    jg, tg = JaxGrid(free.copy()), Grid(free.copy())
    starts = start_positions_array(jg, na, seed=seed)
    tasks = TaskGenerator(jg, seed=seed + 1).generate_task_arrays(nt)
    h, w = free.shape
    cfg_j = JaxConfig(height=h, width=w, num_agents=na, **kw)
    cfg_t = SolverConfig(height=h, width=w, num_agents=na, **kw)
    want = jsh.solve_offline_sharded(jg, starts, tasks, cfg_j,
                                     mesh=jax_mesh(k))
    got = tsh.solve_offline_sharded(tg, starts, tasks, cfg_t, mesh=_mesh(k))
    flat = tmapd.solve_offline(tg, starts, tasks, cfg_t, device="cpu")
    return want, got, flat


def _assert_same(want, got):
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


GRIDS = {
    "open16": np.ones((16, 16), bool),
    "obstacles20": JaxGrid.random_obstacles(20, 20, 0.15, seed=11).free,
}


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("grid,na,nt", [("open16", 8, 8),
                                        ("obstacles20", 16, 10)])
def test_sharded_fresh_matches_jax(grid, na, nt, shards):
    want, got, flat = _both(GRIDS[grid], na, nt, 3, shards)
    _assert_same(want, got)
    _assert_same(flat, got)
    assert got[2] > 0


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_decent_stale_matches_jax(shards):
    want, got, flat = _both(GRIDS["obstacles20"], 16, 12, 5, shards,
                            **STALE)
    _assert_same(want, got)
    _assert_same(flat, got)


def test_sharded_push_extension_matches_jax():
    """A shared delivery cell: the push extension fires identically under
    agent-axis sharding (the pre-loop assignment order included)."""
    free = np.ones((16, 16), bool)
    jg, tg = JaxGrid(free.copy()), Grid(free.copy())
    starts = np.asarray([jg.idx((0, 0)), jg.idx((15, 0)), jg.idx((0, 15)),
                         jg.idx((15, 15)), jg.idx((7, 0)), jg.idx((8, 15)),
                         jg.idx((0, 7)), jg.idx((15, 8))], np.int32)
    tasks = np.asarray([[int(s), jg.idx((8, 8))] for s in starts], np.int32)
    want = jsh.solve_offline_sharded(jg, starts, tasks, mesh=jax_mesh(4))
    got = tsh.solve_offline_sharded(tg, starts, tasks, mesh=_mesh(4))
    assert 0 < got[2] < 300
    _assert_same(want, got)


def test_sharded_validation_matches_jax():
    free = np.ones((10, 10), bool)
    jg, tg = JaxGrid(free.copy()), Grid(free.copy())
    starts = start_positions_array(jg, 6, seed=0)  # 6 % 8 != 0
    tasks = TaskGenerator(jg, seed=1).generate_task_arrays(3)
    with pytest.raises(AssertionError):
        jsh.solve_offline_sharded(jg, starts, tasks, mesh=jax_mesh(8))
    with pytest.raises(ValueError, match="must divide over 8 agent shards"):
        tsh.solve_offline_sharded(tg, starts, tasks, mesh=_mesh(8))
    # zero tasks: a makespan of 0 on both; duplicate starts refused
    starts8 = start_positions_array(jg, 8, seed=0)
    none = np.zeros((0, 2), np.int32)
    assert jsh.solve_offline_sharded(jg, starts8, none,
                                     mesh=jax_mesh(8))[2] == 0
    assert tsh.solve_offline_sharded(tg, starts8, none,
                                     mesh=_mesh(8))[2] == 0
    dup = np.array([starts8[0]] * 8, np.int32)
    with pytest.raises(ValueError):
        jsh.solve_offline_sharded(jg, dup, none, mesh=jax_mesh(8))
    with pytest.raises(ValueError):
        tsh.solve_offline_sharded(tg, dup, none, mesh=_mesh(8))


def test_sharded_mesh_needs_its_devices():
    """No silent fold: asking for more CUDA devices than there are raises
    (here, with none), and a virtual mesh is asked for by name."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    with pytest.raises(RuntimeError, match="mesh needs 2 devices, have 0"):
        tsh.solve_offline_sharded(Grid(np.ones((8, 8), bool)),
                                  np.arange(2, dtype=np.int32),
                                  np.zeros((0, 2), np.int32),
                                  mesh=agent_mesh(2))
    assert _mesh(2).virtual


def test_sharded_state_crosses_and_steps_like_jax():
    """JAX primes and steps a sharded state; it crosses to the port laid
    out over a 4-shard mesh (and back, bit for bit), and the next sharded
    step of each package gives the same state."""
    free = JaxGrid.warehouse(32, 32).free
    jg = JaxGrid(free.copy())
    n = 16
    starts = start_positions_array(jg, n, seed=2)
    tasks = TaskGenerator(jg, seed=3).generate_task_arrays(16)
    cfg_j = JaxConfig(height=32, width=32, num_agents=n, replan_chunk=8)
    cfg_t = SolverConfig(height=32, width=32, num_agents=n, replan_chunk=8)
    jm = jax_mesh(4)
    specs = jsh.agent_state_specs()
    from p2p_distributed_tswap_tpu.parallel.mesh import shard_map
    from p2p_distributed_tswap_tpu.solver import mapd as jmapd
    from jax.sharding import PartitionSpec as P

    def steps(k):
        @functools.partial(shard_map, mesh=jm, in_specs=(specs, P(), P()),
                           out_specs=specs, check_vma=False)
        def run(s, tasks, free):
            s = jsh._sharded_prime(cfg_j, s, free)
            for _ in range(k):
                s = jsh.sharded_mapd_step(cfg_j, s, tasks, free)
            return s
        return run

    s0 = jmapd.init_state(cfg_j, jnp.asarray(starts, jnp.int32), len(tasks))
    tj = jnp.asarray(tasks, jnp.int32)
    s0 = jmapd._assign(cfg_j, jmapd._transitions(cfg_j, s0, tj), tj)
    fj = jnp.asarray(free)
    s_k = jax.jit(steps(2))(s0, tj, fj)
    s_next = jax.jit(steps(3))(s0, tj, fj)
    arrays = {f.name: np.asarray(getattr(s_k, f.name))
              for f in dataclasses.fields(s_k)}
    mesh = _mesh(4)
    tstate = convert.state_from_numpy(arrays, mesh=mesh,
                                      specs=tsh.agent_state_specs())
    assert isinstance(tstate.dirs, Sharded)
    assert tstate.dirs.block(3).shape == (4, 32 * 32 // 8)
    back = convert.state_to_numpy(tstate)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    frees = [torch.from_numpy(free)] * 4
    nxt = tsh.sharded_mapd_step(cfg_t, mesh, tstate,
                                torch.from_numpy(tasks), frees)
    got = convert.state_to_numpy(nxt)
    for f in dataclasses.fields(s_next):
        np.testing.assert_array_equal(got[f.name],
                                      np.asarray(getattr(s_next, f.name)),
                                      err_msg=f.name)
    assert (got["dirs"] != np.uint32(PACKED_STAY)).any()
    assert hostsync.count > 0
