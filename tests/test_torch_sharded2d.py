"""The port's 2-D (agents x tiles) sharded solver (``parallel/sharded2d.py``)
against the JAX package's, on meshes (2, 2), (2, 4) and (1, 4).

The JAX side runs ``solve_offline_sharded2d`` on the virtual CPU mesh of
``tests/conftest.py``; the port's on a virtual CPU mesh of the same shape.
Paths, states and makespan must be equal (and equal to the port's flat
solve), the push extension included; the divisibility constraints are
refused as in the JAX package.  The 4096² rungs this solver was written
for, and the ladder, are the JAX package's.
"""

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.config import SolverConfig as JaxConfig
from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.core.sampling import start_positions_array
from p2p_distributed_tswap_tpu.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu.parallel import sharded2d as jsh2
from p2p_distributed_tswap_tpu.parallel.mesh import (
    agent_tile_mesh as jax_mesh)
from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.parallel import sharded2d as tsh2
from p2p_distributed_tswap_tpu_torch.parallel.mesh import agent_tile_mesh
from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
    virtual_devices)
from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(a, t):
    return agent_tile_mesh(a, t, virtual_devices(a * t, "cpu"))


def _assert_same(want, got):
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("grid,na,nt,shape", [
    ("open32", 8, 10, (2, 4)),
    ("obstacles32", 8, 8, (2, 2)),
    ("warehouse32", 16, 12, (2, 4)),
    ("obstacles32", 8, 8, (1, 4)),
], ids=["open-2x4", "obstacles-2x2", "warehouse-2x4", "obstacles-1x4"])
def test_sharded2d_matches_jax(grid, na, nt, shape):
    free = {"open32": np.ones((32, 32), bool),
            "obstacles32": JaxGrid.random_obstacles(32, 32, 0.2, seed=5).free,
            "warehouse32": JaxGrid.warehouse(32, 32).free}[grid]
    jg, tg = JaxGrid(free.copy()), Grid(free.copy())
    starts = start_positions_array(jg, na, seed=3)
    tasks = TaskGenerator(jg, seed=4).generate_task_arrays(nt)
    want = jsh2.solve_offline_sharded2d(jg, starts, tasks,
                                        mesh=jax_mesh(*shape))
    before = hostsync.count
    got = tsh2.solve_offline_sharded2d(tg, starts, tasks, mesh=_mesh(*shape))
    assert hostsync.count > before
    _assert_same(want, got)
    _assert_same(tmapd.solve_offline(tg, starts, tasks, device="cpu"), got)


def test_sharded2d_push_extension_matches_jax():
    """Two tasks share one delivery cell: the push extension fires
    identically under 2-D sharding."""
    free = np.ones((16, 16), bool)
    jg, tg = JaxGrid(free.copy()), Grid(free.copy())
    corners = [(0, 0), (15, 0), (0, 15), (15, 15)]
    starts = np.asarray([jg.idx(c) for c in corners], np.int32)
    tasks = np.asarray([[jg.idx(c), jg.idx((8, 8))] for c in corners],
                       np.int32)
    want = jsh2.solve_offline_sharded2d(jg, starts, tasks,
                                        mesh=jax_mesh(2, 4))
    got = tsh2.solve_offline_sharded2d(tg, starts, tasks, mesh=_mesh(2, 4))
    assert 0 < got[2] < 200
    _assert_same(want, got)


def test_sharded2d_rejects_bad_divisibility_as_jax():
    def scenario(free, na):
        jg = JaxGrid(free)
        return (start_positions_array(jg, na, seed=0),
                TaskGenerator(jg, seed=1).generate_task_arrays(4))

    # H = 30 does not divide over 4 tiles
    free = np.ones((30, 32), bool)
    starts, tasks = scenario(free, 8)
    with pytest.raises(AssertionError, match="tiles"):
        jsh2.solve_offline_sharded2d(JaxGrid(free), starts, tasks,
                                     mesh=jax_mesh(2, 4))
    with pytest.raises(ValueError, match="must divide over 4 tiles"):
        tsh2.solve_offline_sharded2d(Grid(free), starts, tasks,
                                     mesh=_mesh(2, 4))
    # N = 6 does not divide over 4 agent shards
    free = np.ones((32, 32), bool)
    starts, tasks = scenario(free, 6)
    kw = dict(height=32, width=32, num_agents=6)
    with pytest.raises(AssertionError, match="agent shards"):
        jsh2.solve_offline_sharded2d(JaxGrid(free), starts, tasks,
                                     JaxConfig(**kw), mesh=jax_mesh(4, 2))
    with pytest.raises(ValueError, match="agent shards"):
        tsh2.solve_offline_sharded2d(Grid(free), starts, tasks,
                                     SolverConfig(**kw), mesh=_mesh(4, 2))
    # 4 x 6 = 24 cells a band at 4 tiles is a whole number of words, 3 x 6
    # = 18 is not
    free = np.ones((12, 6), bool)
    starts, tasks = scenario(free, 2)
    with pytest.raises(AssertionError, match="multiple of 8"):
        jsh2.solve_offline_sharded2d(JaxGrid(free), starts, tasks,
                                     mesh=jax_mesh(2, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        tsh2.solve_offline_sharded2d(Grid(free), starts, tasks,
                                     mesh=_mesh(2, 4))


@pytest.mark.parametrize("name", ["EXTREME", "EXTREME_LITE",
                                  "EXTREME_LITE_FULL"])
def test_4096_rungs_are_the_jax_packages(name):
    """The 4096² rungs are copied unchanged, and the ladder is the JAX
    package's rung for rung; a 4096² grid is the same grid."""
    from p2p_distributed_tswap_tpu.models import scenarios as jscn
    from p2p_distributed_tswap_tpu_torch.models import scenarios as tscn

    j, t = getattr(jscn, name), getattr(tscn, name)
    keep = lambda s: {k: v for k, v in vars(s).items()  # noqa: E731
                      if k != "grid_fn"}
    assert keep(t) == keep(j)
    assert [s.name for s in tscn.LADDER] == [s.name for s in jscn.LADDER]
    if name == "EXTREME_LITE":
        np.testing.assert_array_equal(t.grid_fn().free, j.grid_fn().free)
