"""The port's bounded-region field repair (``ops/field_repair.py``) against
the JAX package's.

The JAX package's own cases (``tests/test_field_repair.py``) and the seeds
of its fuzz gate (``scripts/field_fuzz.py``) are replayed at small size
through both packages on the CPU.  Every repair must come back the same
from both: the same ``None`` where the dirty region overflows, else the
same field and the same changed box, and both must equal the port's full
recompute.  Chains continue from the repaired field, so a drift compounds.
The band-derived direction codes and the host packer are held to the JAX
package's and to the port's device packer, and the big-window path (past
``DIJKSTRA_MAX_CELLS``: the sweep fixpoint with one mask, ``sweep_plain``
here) to the JAX package's jitted ``_window_fixpoint`` on the same window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.ops import distance as jd
from p2p_distributed_tswap_tpu.ops import field_repair as jfr
from p2p_distributed_tswap_tpu_torch.ops import distance as td
from p2p_distributed_tswap_tpu_torch.ops import field_repair as tfr
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _full(free: np.ndarray, goal: int) -> np.ndarray:
    """The port's full recompute on the CPU."""
    return td.distance_fields(torch.from_numpy(free.copy()),
                              torch.tensor([goal], dtype=torch.int32)
                              ).numpy()[0]


def _full_dirs(free: np.ndarray, goal: int) -> np.ndarray:
    f = torch.from_numpy(free.copy())
    d = td.distance_fields(f, torch.tensor([goal], dtype=torch.int32))
    return td.directions_from_distance(d, f).numpy()[0]


def _repair_both(dist, free, toggles, **kw):
    """The JAX and the port repair of one event: the same outcome, which
    is returned (None or ``(field, box)``)."""
    want = jfr.repair_field(dist.copy(), free.copy(), list(toggles), **kw)
    got = tfr.repair_field(dist.copy(), free.copy(), list(toggles),
                           device=CPU, **kw)
    assert (want is None) == (got is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(int(v) for v in got[1]) == \
            tuple(int(v) for v in want[1])
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_toggle_chains_match_jax_and_recompute(seed):
    """The JAX package's cumulative random toggle batches: every event
    repairs the previous event's output in both packages alike, equal to
    the full recompute; nothing outside the box changes."""
    rng = np.random.default_rng(seed)
    h = w = 24
    free = rng.random((h, w)) > 0.25
    goal = int(rng.choice(np.flatnonzero(free.reshape(-1))))
    free.reshape(-1)[goal] = True
    dist = _full(free, goal)
    exact = 0
    for _ in range(8):
        k = int(rng.integers(1, 4))
        cand = [c for c in rng.integers(0, h * w, size=16).tolist()
                if c != goal][:k]
        if not cand:
            continue
        for c in cand:
            free.reshape(-1)[c] = ~free.reshape(-1)[c]
        res = _repair_both(dist, free, cand)
        ref = _full(free, goal)
        if res is None:
            dist = ref  # the caller's full recompute
            continue
        new_dist, (y0, y1, x0, x1) = res
        np.testing.assert_array_equal(new_dist, ref)
        outside = np.ones((h, w), bool)
        outside[y0:y1, x0:x1] = False
        np.testing.assert_array_equal(new_dist[outside], dist[outside])
        dist = new_dist
        exact += 1
    assert exact > 0


def _fuzz_world(seed: int, rng) -> np.ndarray:
    kind = seed % 3
    if kind == 0:
        return rng.random((24, 24)) > 0.25
    if kind == 1:
        return np.asarray(JaxGrid.warehouse(32, 32).free).copy()
    return np.ones((16, 48), np.bool_)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_field_fuzz_seeds_match_jax(seed):
    """A seed of the JAX package's fuzz gate: sliding batches that reopen
    the previous cells and close fresh ones (multi-cluster events), five
    chained events.  The band-patched direction codes and their packed
    words equal the full recompute's too."""
    rng = np.random.default_rng(seed)
    free = _fuzz_world(seed, rng)
    h, w = free.shape
    flat = free.reshape(-1)
    goal = int(rng.choice(np.flatnonzero(flat)))
    dist, dirs = _full(free, goal), _full_dirs(free, goal)
    prev: list = []
    for _ in range(5):
        toggles = list(prev)
        fresh = [int(c) for c in rng.integers(0, h * w, size=3)
                 if c != goal and flat[c]][:2]
        toggles += fresh
        for c in prev:
            flat[c] = True
        for c in fresh:
            flat[c] = False
        prev = fresh
        res = _repair_both(dist, free, toggles)
        ref_d, ref_dirs = _full(free, goal), _full_dirs(free, goal)
        if res is None:
            dist, dirs = ref_d, ref_dirs
            continue
        new_dist, (y0, y1, x0, x1) = res
        np.testing.assert_array_equal(new_dist, ref_d)
        b0, b1 = max(0, y0 - 1), min(h, y1 + 1)
        if b1 > b0:
            band = tfr.directions_np(new_dist, free, b0, b1)
            np.testing.assert_array_equal(
                band, jfr.directions_np(new_dist, free, b0, b1))
            dirs[b0:b1] = band
        np.testing.assert_array_equal(dirs, ref_dirs)
        np.testing.assert_array_equal(tfr.pack_rows_np(dirs.reshape(-1)),
                                      jfr.pack_rows_np(ref_dirs.reshape(-1)))
        dist = new_dist


def test_freed_door_grows_the_window():
    """Freeing the one door of a wall re-routes the whole far half: the
    rim check grows the window until it holds every decrease (the fuzz
    gate's edge case, with the window ceiling lifted), and once more
    under the default ceiling."""
    h = w = 24
    free = np.ones((h, w), np.bool_)
    free[:, 12] = False
    goal = w * 5 + 2
    dist = _full(free, goal)
    free[8, 12] = True
    res = _repair_both(dist, free, [8 * w + 12], max_window=h * w)
    assert res is not None
    np.testing.assert_array_equal(res[0], _full(free, goal))
    h = w = 32
    free = np.ones((h, w), np.bool_)
    free[:, 16] = False
    goal = 5 * w + 3
    dist = _full(free, goal)
    free.reshape(-1)[8 * w + 16] = True
    res = _repair_both(dist, free, [8 * w + 16])
    if res is not None:
        np.testing.assert_array_equal(res[0], _full(free, goal))


def test_wall_close_reroutes_exactly():
    """Closing the only gap of a wall: exact with the ceilings lifted,
    and None (the full-recompute fallback) under the defaults."""
    h = w = 24
    free = np.ones((h, w), np.bool_)
    free[10, 1:23] = False
    free[10, 12] = True
    goal = 2 * w + 12
    dist = _full(free, goal)
    free[10, 12] = False
    res = _repair_both(dist, free, [10 * w + 12], max_dirty=h * w,
                       max_window=h * w)
    assert res is not None
    np.testing.assert_array_equal(res[0], _full(free, goal))
    assert _repair_both(dist, free, [10 * w + 12]) is None


def test_dirty_overflow_falls_back():
    h = w = 16
    free = np.ones((h, w), np.bool_)
    dist = _full(free, 0)
    free[1, :] = False
    assert _repair_both(dist, free, [w + x for x in range(w)],
                        max_dirty=4) is None


def test_blocked_goal_and_noop_toggle():
    h = w = 12
    free = np.ones((h, w), np.bool_)
    goal = 5 * w + 5
    dist = _full(free, goal)
    res = _repair_both(dist, free, [])
    assert res is not None and res[1] == (0, 0, 0, 0)
    np.testing.assert_array_equal(res[0], dist)
    free.reshape(-1)[goal] = False
    res = _repair_both(dist, free, [goal])
    if res is not None:
        np.testing.assert_array_equal(res[0], _full(free, goal))


def test_big_window_matches_jax_window_fixpoint():
    """A window past ``DIJKSTRA_MAX_CELLS`` takes the sweep fixpoint: the
    port's (``window_fixpoint`` on the CPU, ``sweep_plain`` with one mask)
    equals the JAX package's jitted one on the same window; then a whole
    repair through that path, with the window ceiling lifted, equals both
    the JAX repair and the full recompute."""
    rng = np.random.default_rng(21)
    h = w = 160
    free = rng.random((h, w)) > 0.2
    free[:, 80] = False
    goal = 3 * w + 4
    free.reshape(-1)[goal] = True
    dist = _full(free, goal)
    door = 70 * w + 80
    free.reshape(-1)[door] = True
    y0, y1, x0, x1 = 5, 140, 12, 150
    assert (y1 - y0) * (x1 - x0) > tfr.DIJKSTRA_MAX_CELLS
    before = sweep_kernel.launches
    got = tfr._sweep_window(dist, free, {door}, y0, y1, x0, x1, CPU)
    want = jfr._sweep_window(dist, free, {door}, y0, y1, x0, x1)
    np.testing.assert_array_equal(got, want)
    assert sweep_kernel.launches == before  # the CPU never launches
    res = _repair_both(dist, free, [door], max_window=h * w)
    assert res is not None
    box = res[1]
    assert (box[1] - box[0]) * (box[3] - box[2]) > tfr.DIJKSTRA_MAX_CELLS
    np.testing.assert_array_equal(res[0], _full(free, goal))


def test_window_fixpoint_with_per_window_masks_matches_jax():
    """The batched fixpoint the sector planner runs: one mask per window,
    some windows fully blocked (pow2 padding), against the JAX package's
    ``window_fixpoint`` with the same 3-D mask."""
    rng = np.random.default_rng(5)
    n, hh, ww = 6, 32, 32
    free = rng.random((n, hh, ww)) > 0.25
    free[4:] = False  # padded layers
    free[:, 18:, :] = False  # each window's own blocked halo
    seed = np.full((n, hh, ww), int(td.INF), np.int32)
    for k in range(n):
        cells = np.flatnonzero(free[k].reshape(-1))
        if cells.size:
            seed[k].reshape(-1)[rng.choice(cells, 2)] = [0, 3]
    want = np.asarray(jfr.window_fixpoint(jnp.asarray(seed),
                                          jnp.asarray(free)))
    got = td.window_fixpoint(torch.from_numpy(seed),
                             torch.from_numpy(free)).numpy()
    np.testing.assert_array_equal(got, want)
    # one shared mask as well (the repair windows)
    want = np.asarray(jfr.window_fixpoint(jnp.asarray(seed[:1]),
                                          jnp.asarray(free[0])))
    got = td.window_fixpoint(torch.from_numpy(seed[:1]),
                             torch.from_numpy(free[0])).numpy()
    np.testing.assert_array_equal(got, want)


def test_directions_and_packer_match_jax_and_device_packer():
    rng = np.random.default_rng(7)
    free = rng.random((20, 28)) > 0.25
    goal = int(rng.choice(np.flatnonzero(free.reshape(-1))))
    dist = _full(free, goal)
    ref = _full_dirs(free, goal)
    for band in ((0, None), (5, 13), (0, 3), (17, 20)):
        got = tfr.directions_np(dist, free, *band)
        np.testing.assert_array_equal(got, jfr.directions_np(dist, free,
                                                             *band))
        np.testing.assert_array_equal(got, ref[band[0]:band[1]])
    codes = rng.integers(0, 5, size=(3, 37), dtype=np.uint8)
    ours = tfr.pack_rows_np(codes)
    assert ours.dtype == np.uint32
    np.testing.assert_array_equal(ours, jfr.pack_rows_np(codes))
    np.testing.assert_array_equal(
        ours, td.pack_directions(torch.from_numpy(codes)).numpy()
        .view(np.uint32))
    np.testing.assert_array_equal(
        ours, np.asarray(jd.pack_directions(jnp.asarray(codes))))


def test_default_max_window_picks_by_device():
    """The CPU keeps the JAX package's CPU ceiling (so both daemons count
    the same repairs on the CPU); the card the accelerator one."""
    for n in (100, 64 * 64, 160 * 160, 1024 * 1024):
        cap = max(256, n // tfr.MAX_WINDOW_FRAC)
        assert tfr.default_max_window(n, "cpu") == \
            min(cap, tfr.DIJKSTRA_MAX_CELLS) == jfr.default_max_window(n)
        assert tfr.default_max_window(n, torch.device("cuda")) == cap
    for name in ("MAX_DIRTY_FRAC", "MAX_WINDOW_FRAC", "_MARGIN0",
                 "_MARGIN_GROW", "DIJKSTRA_MAX_CELLS"):
        assert getattr(tfr, name) == getattr(jfr, name)
    assert [tfr._pow2(n) for n in (1, 8, 9, 66, 130)] == \
        [jfr._pow2(n) for n in (1, 8, 9, 66, 130)]
