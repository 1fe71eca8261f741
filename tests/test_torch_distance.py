"""The port's distance / direction fields against the JAX package's.

Same goals, same grids, bit-identical results: distance fields, the
multi-source field, direction codes (first-min ties in DIR_DXDY order),
packed rows (the port's int32 words read back as the JAX package's uint32
words) and the next-hop gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.grid import Grid
from p2p_distributed_tswap_tpu.ops import distance as jd
from p2p_distributed_tswap_tpu_torch.ops import distance as td

GRIDS = {
    "random": lambda: Grid.random_obstacles(24, 31, 0.25, seed=4),
    "warehouse": lambda: Grid.warehouse(32, 40),
}


def _goals(grid, k, seed, on_obstacle=False):
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(grid.free.reshape(-1))
    goals = rng.choice(cells, size=k, replace=False)
    if on_obstacle:
        goals[0] = np.flatnonzero(~grid.free.reshape(-1))[0]
    return goals.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_distance_fields_match(kind):
    grid = GRIDS[kind]()
    goals = _goals(grid, 5, seed=1, on_obstacle=True)
    want = np.asarray(jd.distance_fields(jnp.asarray(grid.free),
                                         jnp.asarray(goals)))
    got = td.distance_fields(_t(grid.free), _t(goals)).numpy()
    np.testing.assert_array_equal(want, got)
    # the goal on an obstacle gives an all-INF field
    assert (got[0] == td.INF).all()


def test_distance_fields_round_cap_matches():
    """A cap below the fixpoint stops both at the same partial field."""
    grid = GRIDS["warehouse"]()
    goals = _goals(grid, 3, seed=2)
    want = np.asarray(jd.distance_fields(jnp.asarray(grid.free),
                                         jnp.asarray(goals), max_rounds=1))
    got = td.distance_fields(_t(grid.free), _t(goals), max_rounds=1).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_multi_source_field_matches(kind):
    grid = GRIDS[kind]()
    src = _goals(grid, 7, seed=3)
    want = np.asarray(jd.multi_source_field(jnp.asarray(grid.free),
                                            jnp.asarray(src)))
    got = td.multi_source_field(_t(grid.free), _t(src)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_direction_fields_match(kind):
    grid = GRIDS[kind]()
    goals = _goals(grid, 6, seed=5, on_obstacle=True)
    want = np.asarray(jd.direction_fields(jnp.asarray(grid.free),
                                          jnp.asarray(goals)))
    got = td.direction_fields(_t(grid.free), _t(goals)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(want, got)


def test_directions_first_min_ties_match():
    """Small random distances with many equal neighbours (and INF cells):
    the strict ``<`` fold must pick the same first minimum."""
    rng = np.random.default_rng(6)
    free = rng.random((13, 17)) > 0.15
    dist = rng.integers(0, 4, (3, 13, 17)).astype(np.int32)
    dist = np.where(rng.random(dist.shape) > 0.9, int(jd.INF), dist)
    dist = dist.astype(np.int32)
    want = np.asarray(jd.directions_from_distance(jnp.asarray(dist),
                                                  jnp.asarray(free)))
    got = td.directions_from_distance(_t(dist), _t(free)).numpy()
    np.testing.assert_array_equal(want, got)
    # ties are really there: some cell has two equal minimal neighbours
    assert (want < 4).any()


def test_empty_grid_diagonal_goal_tie():
    """On an open grid every cell off the goal's row and column has two
    equally short next hops; both packages take the first in DIR_DXDY."""
    free = np.ones((9, 9), bool)
    goals = np.array([40], np.int32)
    want = np.asarray(jd.direction_fields(jnp.asarray(free),
                                          jnp.asarray(goals)))
    got = td.direction_fields(_t(free), _t(goals)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("hw", [64, 61])  # 61: padded tail word
def test_pack_directions_match_as_uint32(hw):
    rng = np.random.default_rng(hw)
    codes = rng.integers(0, 5, (4, hw)).astype(np.uint8)
    want = np.asarray(jd.pack_directions(jnp.asarray(codes)))
    got = td.pack_directions(_t(codes))
    assert got.dtype == torch.int32
    assert got.shape[-1] == td.packed_cells(hw) == jd.packed_cells(hw)
    np.testing.assert_array_equal(want, got.numpy().view(np.uint32))
    np.testing.assert_array_equal(td.unpack_rows_np(got.numpy(), hw), codes)
    row = got.numpy()[1]
    assert all(td.unpack_code_np(row, c) == codes[1, c] for c in range(hw))


def test_packed_stay_word_is_the_same_bits():
    assert np.uint32(td.PACKED_STAY) == np.uint32(jd.PACKED_STAY)
    assert 0 < td.PACKED_STAY < 2 ** 31


@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_gather_and_apply_direction_match(kind):
    grid = GRIDS[kind]()
    h, w = grid.free.shape
    goals = _goals(grid, 6, seed=7)
    fields = jd.direction_fields(jnp.asarray(grid.free), jnp.asarray(goals))
    packed_j = jd.pack_directions(fields.reshape(6, h * w))
    packed_t = _t(np.asarray(packed_j).view(np.int32))
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 6, 50).astype(np.int32)
    pos = rng.choice(np.flatnonzero(grid.free.reshape(-1)), 50).astype(
        np.int32)
    code_j = np.asarray(jd.gather_packed(packed_j, jnp.asarray(rows),
                                         jnp.asarray(pos)))
    code_t = td.gather_packed(packed_t, _t(rows), _t(pos))
    np.testing.assert_array_equal(code_j, code_t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jd.apply_direction(jnp.asarray(pos), jnp.asarray(code_j),
                                      w)),
        td.apply_direction(_t(pos), code_t, w).numpy())
