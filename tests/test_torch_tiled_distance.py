"""The port's banded sweeps (``ops/tiled_distance.py``) against the JAX
package's, on the same grids and goals.

The JAX side runs ``tiled_distance_fields`` / ``tiled_direction_fields``
under ``shard_map`` on the virtual CPU mesh of ``tests/conftest.py``; the
port's runs on a virtual CPU mesh of the same shape.  Distances and codes
must be equal, ``max_rounds`` binding (1-3) or not, and equal to the flat
fields when it does not bind; edge bands must see INF beyond the grid, and
a relaxed boundary row must stay INF where the neighbour is INF.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from p2p_distributed_tswap_tpu.core.grid import Grid
from p2p_distributed_tswap_tpu.ops import tiled_distance as jtd
from p2p_distributed_tswap_tpu.parallel.mesh import shard_map
from p2p_distributed_tswap_tpu_torch.ops import distance as tdist
from p2p_distributed_tswap_tpu_torch.ops import tiled_distance as ttd
from p2p_distributed_tswap_tpu_torch.parallel import mesh as tmesh
from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
    virtual_devices)

INF = 1 << 30

GRIDS = [
    ("warehouse", Grid.warehouse(64, 64)),
    ("obstacles", Grid.random_obstacles(64, 64, 0.25, seed=3)),
    # a wall with one slit at the bottom: paths between the halves cross
    # many band edges, one per round
    ("slit", Grid.from_ascii("\n".join(
        ["." * 31 + "@" + "." * 32] * 63 + ["." * 64]))),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tiled(fn, grid, goals, n_tiles, **kw):
    mesh = JaxMesh(np.array(jax.devices("cpu")[:n_tiles]), (jtd.TILES_AXIS,))
    tiled = jax.jit(shard_map(
        functools.partial(fn, width=grid.width, **kw), mesh=mesh,
        in_specs=(P(jtd.TILES_AXIS, None), P()),
        out_specs=P(None, jtd.TILES_AXIS, None), check_vma=False))
    return np.asarray(tiled(jnp.asarray(grid.free),
                            jnp.asarray(goals, jnp.int32)))


def _port_tiled(fn, grid, goals, n_tiles, **kw):
    mesh = tmesh.agent_tile_mesh(1, n_tiles, virtual_devices(n_tiles))
    bands = ttd.bands_of(torch.from_numpy(grid.free), mesh)
    out = fn(bands, [torch.from_numpy(np.asarray(goals, np.int32))],
             grid.width, **kw)
    return ttd.join_bands(out[0], "cpu").numpy()


def _goals(grid, k, seed):
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(np.asarray(grid.free).reshape(-1))
    return rng.choice(cells, size=k, replace=False).astype(np.int32)


@pytest.mark.parametrize("n_tiles", [2, 4, 8])
@pytest.mark.parametrize("name,grid", GRIDS, ids=[g[0] for g in GRIDS])
def test_tiled_distances_and_codes_match_jax(name, grid, n_tiles):
    goals = _goals(grid, 5, 7)
    want_d = _jax_tiled(jtd.tiled_distance_fields, grid, goals, n_tiles)
    got_d = _port_tiled(ttd.tiled_distance_fields, grid, goals, n_tiles)
    np.testing.assert_array_equal(got_d, want_d)
    want_c = _jax_tiled(jtd.tiled_direction_fields, grid, goals, n_tiles)
    got_c = _port_tiled(ttd.tiled_direction_fields, grid, goals, n_tiles)
    np.testing.assert_array_equal(got_c, want_c)
    # and the flat port's fields
    free = torch.from_numpy(grid.free)
    g = torch.from_numpy(goals)
    np.testing.assert_array_equal(
        got_d, tdist.distance_fields(free, g, 256).numpy())
    np.testing.assert_array_equal(
        got_c, tdist.direction_fields(free, g, 256).numpy())


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
@pytest.mark.parametrize("n_tiles", [2, 4, 8])
def test_tiled_max_rounds_binding_matches_jax(n_tiles, max_rounds):
    grid = GRIDS[2][1]
    goals = _goals(grid, 3, 11)
    kw = {"max_rounds": max_rounds}
    want = _jax_tiled(jtd.tiled_distance_fields, grid, goals, n_tiles, **kw)
    got = _port_tiled(ttd.tiled_distance_fields, grid, goals, n_tiles, **kw)
    np.testing.assert_array_equal(got, want)
    # the cap binds: the fields are short of the fixpoint
    full = tdist.distance_fields(torch.from_numpy(grid.free),
                                 torch.from_numpy(goals), 256).numpy()
    assert (got != full).any()
    want = _jax_tiled(jtd.tiled_direction_fields, grid, goals, n_tiles, **kw)
    got = _port_tiled(ttd.tiled_direction_fields, grid, goals, n_tiles, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_tiles", [2, 4, 8])
def test_tiled_unreachable_and_obstacle_goals_match_jax(n_tiles):
    # a full wall seals the bottom off; one goal on an obstacle
    grid = Grid.from_ascii("\n".join(
        ["." * 16] * 6 + ["@" * 16] + ["." * 16] * 9))
    goals = np.asarray([grid.idx((2, 2)), grid.idx((2, 10)),
                        grid.idx((5, 6))], np.int32)
    for fn_j, fn_t in ((jtd.tiled_distance_fields, ttd.tiled_distance_fields),
                       (jtd.tiled_direction_fields,
                        ttd.tiled_direction_fields)):
        want = _jax_tiled(fn_j, grid, goals, n_tiles)
        got = _port_tiled(fn_t, grid, goals, n_tiles)
        np.testing.assert_array_equal(got, want)
    d = _port_tiled(ttd.tiled_distance_fields, grid, goals, n_tiles)
    assert (d[2] == INF).all()            # goal on the wall
    assert (d[0][7:] == INF).all()        # the sealed part


def test_halo_edges_are_inf_and_relax_clamps():
    """The top band sees INF above it and the bottom band INF below (a
    zero there would invent distance 0 at the grid's edges); ``INF + 1``
    from a neighbour clamps to INF and stays int32."""
    mesh = tmesh.agent_tile_mesh(1, 3, virtual_devices(3))
    bands = [torch.full((2, 4, 5), v, dtype=torch.int32) for v in (0, 7, 3)]
    above, below = ttd._exchange_boundary_rows(bands)
    assert (above[0] == INF).all() and (below[2] == INF).all()
    assert (above[1] == 0).all() and (below[1] == 3).all()
    free = [torch.ones((4, 5), dtype=torch.bool)] * 3
    d = [torch.full((1, 4, 5), INF, dtype=torch.int32) for _ in range(3)]
    out = ttd._halo_relax(d, free)
    assert all(x.dtype == torch.int32 and (x == INF).all() for x in out)
    assert mesh.virtual and mesh.size == 3


def test_two_agent_blocks_sweep_their_own_goals():
    """On an (A, T) mesh each agent block sweeps its own goal batch; every
    block equals the flat fields of its goals."""
    grid = GRIDS[1][1]
    mesh = tmesh.agent_tile_mesh(2, 4, virtual_devices(8))
    bands = ttd.bands_of(torch.from_numpy(grid.free), mesh)
    goals = [torch.from_numpy(_goals(grid, 2, s)) for s in (1, 2)]
    out = ttd.tiled_direction_fields(bands, goals, grid.width)
    free = torch.from_numpy(grid.free)
    for a in range(2):
        assert torch.equal(ttd.join_bands(out[a], "cpu"),
                           tdist.direction_fields(free, goals[a], 256))
