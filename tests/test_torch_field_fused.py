"""The port's fused field engine against the JAX package's.

On the CPU the port's ``single_direction_fields`` and
``multi_direction_fields`` run their plain version; the JAX package's run
its two Pallas kernels in interpret mode, as tests/test_field_fused.py runs
them.  Both must give the same (G, H, W) uint8 codes, including where
``max_rounds`` stops the fixpoint early.  The mode switch, the shape gates
and the dispatch in ``direction_fields`` are held to the JAX package's too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.ops import distance as jd
from p2p_distributed_tswap_tpu.ops import field_fused as jff
from p2p_distributed_tswap_tpu_torch.ops import distance as td
from p2p_distributed_tswap_tpu_torch.ops import field_fused as tff
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel

MODES = {"single": (jff.single_direction_fields, tff.single_direction_fields),
         "multi": (jff.multi_direction_fields, tff.multi_direction_fields)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Thousands of small tensor ops: on the CPU, intra-op threads cost more
    # than they give, most of all with several test workers on the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret_mode():
    jff.INTERPRET = True
    yield
    jff.INTERPRET = False


def _check(mode, free_np, goals_np, max_rounds=128):
    jax_fn, port_fn = MODES[mode]
    want = np.asarray(jax_fn(jnp.asarray(free_np), jnp.asarray(goals_np),
                             max_rounds))
    launches = dict(tff.launches)
    got = port_fn(torch.from_numpy(free_np), torch.from_numpy(goals_np),
                  max_rounds)
    assert tff.launches == launches  # the CPU runs the plain version
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(want, got.numpy())
    return want


def _free(seed, h, w, density):
    return np.random.default_rng(seed).random((h, w)) > density


def _goals(free_np, k, seed, replace=False):
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(free_np.reshape(-1))
    return rng.choice(cells, k, replace=replace).astype(np.int32)


def test_single_random_obstacles(interpret_mode):
    free = _free(0, 128, 128, 0.3)
    _check("single", free, _goals(free, 3, seed=0))


@pytest.mark.parametrize("mode,h,repeat", [("single", 64, 1),
                                           ("multi", 16, 3)])
def test_goal_on_obstacle_and_corner(interpret_mode, mode, h, repeat):
    """A corner goal, a goal on an obstacle (an all-stay field), and the
    far corner; the multi case repeats them (the same goal in three
    fields of one block)."""
    free = _free(h, h, 128, 0.2)
    free[0, 0] = True
    free[5, 7] = False
    goals = np.array([0, 5 * 128 + 7, (h - 1) * 128 + 127] * repeat,
                     np.int32)
    out = _check(mode, free, goals)
    assert (out[1] == td.DIR_STAY).all()


def test_single_empty_grid(interpret_mode):
    _check("single", np.ones((8, 128), bool),
           np.array([3 * 128 + 64], np.int32))


@pytest.mark.parametrize("g", [16, 11])
def test_multi_full_and_ragged_batches(interpret_mode, g):
    """Two full blocks of eight (G = 16), and G = 11: the goals pad to 16
    by repeating the last one and the pad is dropped."""
    free = _free(g, 64 if g == 16 else 32, 128, 0.3 if g == 16 else 0.25)
    out = _check("multi", free, _goals(free, g, seed=g))
    assert out.shape[0] == g


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_round_cap_binds_on_a_maze(interpret_mode, mode):
    """A maze where 1, 2 and 3 rounds stop short of the fixpoint: per-field
    (single), per-block (multi) and whole-batch (plain) convergence still
    give the same codes."""
    free = _free(5, 32, 128, 0.35)
    goals = _goals(free, 11, seed=5, replace=True)
    full = tff.fields_plain(torch.from_numpy(free), torch.from_numpy(goals))
    for max_rounds in (1, 2, 3):
        out = _check(mode, free, goals, max_rounds)
        assert not np.array_equal(out, full.numpy())  # the cap binds


def test_plain_version_never_launches_a_kernel(monkeypatch):
    """The plain version sweeps with sweep_plain, never sweep_scan: on the
    card it must stay independent of both kernels."""
    def refuse(*args, **kwargs):
        raise AssertionError("sweep_scan called")

    monkeypatch.setattr(sweep_kernel, "sweep_scan", refuse)
    free = _free(1, 16, 128, 0.3)
    goals = torch.from_numpy(_goals(free, 4, seed=1))
    got = tff.fields_plain(torch.from_numpy(free), goals)
    want = td.direction_fields(torch.from_numpy(free), goals)
    assert torch.equal(got, want)


@pytest.mark.parametrize("value,mode", [(None, ""), ("", ""), ("0", ""),
                                        ("1", "multi"), ("multi", "multi"),
                                        ("single", "single"), ("yes", "")])
def test_fused_mode_parsing(monkeypatch, value, mode):
    if value is None:
        monkeypatch.delenv("MAPD_FUSED", raising=False)
    else:
        monkeypatch.setenv("MAPD_FUSED", value)
    assert tff.fused_mode() == jff.fused_mode() == mode


SHAPES = [(8, 128), (64, 128), (60, 128), (64, 100), (100, 100),
          (256, 256), (512, 512), (1024, 1024), (1024, 1536), (1536, 1024),
          (2048, 768), (4096, 4096)]


@pytest.mark.parametrize("h,w", SHAPES)
def test_shape_gates_match(monkeypatch, h, w):
    assert tff.multi_eligible(h, w) == jff.multi_eligible(h, w)
    for env in ("1", "single"):
        monkeypatch.setenv("MAPD_FUSED", env)
        # the JAX package's gate for the same mode on a TPU backend
        monkeypatch.setattr(jff, "_on_tpu", lambda: True)
        assert tff.fused_eligible(h, w, "cuda") == jff.fused_eligible(h, w)
        # never on the CPU, as the JAX package's on a non-TPU backend
        assert not tff.fused_eligible(h, w, "cpu")
        monkeypatch.setattr(jff, "_on_tpu", lambda: False)
        assert not jff.fused_eligible(h, w)


def test_shape_gates_take_the_rungs_paths(monkeypatch):
    """256^2 rungs take multi; 512^2 and 1024^2 only single; 100^2 none."""
    monkeypatch.setenv("MAPD_FUSED", "1")
    assert [tff.fused_eligible(s, s, "cuda") for s in (100, 256, 512, 1024)] \
        == [False, True, False, False]
    monkeypatch.setenv("MAPD_FUSED", "single")
    assert [tff.fused_eligible(s, s, "cuda") for s in (100, 256, 512, 1024)] \
        == [False, True, True, True]


@pytest.mark.parametrize("env", ["1", "single"])
def test_direction_fields_on_cpu_under_mapd_fused(monkeypatch, env):
    monkeypatch.setenv("MAPD_FUSED", env)
    free = _free(3, 32, 128, 0.25)
    goals = _goals(free, 5, seed=3)
    want = np.asarray(jd.direction_fields(jnp.asarray(free),
                                          jnp.asarray(goals)))
    launches = dict(tff.launches)
    got = td.direction_fields(torch.from_numpy(free), torch.from_numpy(goals))
    assert tff.launches == launches
    np.testing.assert_array_equal(want, got.numpy())


# The kernel's split of a field over a cluster of blocks, emulated in plain
# PyTorch: each block owns a band of rows, and the along-H pass is a
# two-phase scan across the bands (csrc/field_fused.cu pass_along_h).

INF = sweep_kernel.INF


def _band_edges(h, bands):
    return [k * h // bands for k in range(bands + 1)]


def _band_sweep_h(d, blocked, bands, reverse):
    """One along-H sweep of (R, H, W) ``d`` as ``bands`` blocks run it.
    Phase 1: each band scans from run = INF (``sweep_plain`` on the band
    alone) and publishes per column its tail (the run at its last row in
    scan order) and whether it holds an obstacle.  Phase 2: each band
    composes the carry from the summaries of the bands before it in scan
    order, and lowers the cells above its first obstacle to
    min(local, carry + i + 1)."""
    _, h, _ = d.shape
    edges = _band_edges(h, bands)
    blk = blocked.bool()
    local, tail, obstacle = [], [], []
    for k in range(bands):
        y0, y1 = edges[k], edges[k + 1]
        loc = sweep_kernel.sweep_plain(d[:, y0:y1].contiguous(),
                                       blocked[y0:y1].contiguous(), 1, reverse)
        local.append(loc)
        tail.append(loc[:, 0 if reverse else -1])
        obstacle.append(blk[y0:y1].any(0))
    order = list(range(bands))[::-1] if reverse else list(range(bands))
    out = torch.empty_like(d)
    for pos, k in enumerate(order):
        carry = torch.full_like(tail[k], INF)
        for j in order[:pos]:
            n = edges[j + 1] - edges[j]
            carry = torch.where(obstacle[j][None], tail[j],
                                torch.minimum(tail[j], carry + n))
        y0, y1 = edges[k], edges[k + 1]
        n = y1 - y0
        i = torch.arange(n, dtype=torch.int32)
        b = blk[y0:y1]
        if reverse:
            i = i.flip(0)
            clear = b.flip(0).cumsum(0).flip(0) == 0
        else:
            clear = b.cumsum(0) == 0
        cand = carry[:, None, :] + i[None, :, None] + 1
        out[:, y0:y1] = torch.where(clear[None],
                                    torch.minimum(local[k], cand), local[k])
    return out


def _band_inputs(seed, r, h, w, kind):
    rng = np.random.default_rng(seed)
    free = rng.random((h, w)) > (0.35 if kind == "maze" else 0.2)
    if kind == "columns":  # whole columns blocked, whole columns free
        free[:, 1::5] = False
        free[:, 2::5] = True
    d = np.where(rng.random((r, h, w)) > 0.95, rng.integers(0, 60, (r, h, w)),
                 INF)
    d = np.where(free[None], d, INF).astype(np.int32)
    return torch.from_numpy(d), torch.from_numpy((~free).astype(np.uint8))


@pytest.mark.parametrize("kind", ["random", "maze", "columns"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bands", [1, 2, 3, 8, 16])
def test_band_split_sweep_equals_the_whole_column_sweep(bands, reverse,
                                                         kind):
    h = 37 if bands in (2, 3, 8) else 48  # 37: bands of unequal length
    d, blocked = _band_inputs(bands * 7 + reverse, 3, h, 29, kind)
    want = sweep_kernel.sweep_plain(d, blocked, 1, reverse)
    np.testing.assert_array_equal(
        _band_sweep_h(d, blocked, bands, reverse).numpy(), want.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_band_carry_stops_winning_for_good(seed):
    """Phase 2 stops at the first cell where the carry does not beat the
    local value: below it, up to the band's first obstacle, it never wins
    again (the local values rise by at most one a row)."""
    d, blocked = _band_inputs(seed, 4, 24, 31, "random")
    loc = sweep_kernel.sweep_plain(d, torch.zeros_like(blocked), 1, False)
    carry = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 40, (4, 1, 31))
    ).to(torch.int32)
    wins = carry + torch.arange(24, dtype=torch.int32)[None, :, None] + 1 < loc
    # once False down a column, False for every later row
    assert torch.equal(wins, wins.cumprod(1).bool())


def _band_fields(free, goals, bands, max_rounds):
    """The whole kernel emulated: seed, rounds of W forward, W reverse and
    the band-split H passes, each field leaving the loop on the first round
    that changes none of its cells, then the codes."""
    h, w = free.shape
    blocked = (~free).to(torch.uint8)
    flat = torch.zeros(h * w, dtype=torch.bool)
    fields = []
    for goal in goals.tolist():
        seed = flat.clone()
        seed[goal] = bool(free.reshape(-1)[goal])
        d = torch.where(seed, 0, INF).to(torch.int32).reshape(1, h, w)
        for _ in range(max_rounds):
            before = d
            d = sweep_kernel.sweep_plain(d, blocked, 2, False)
            d = sweep_kernel.sweep_plain(d, blocked, 2, True)
            d = _band_sweep_h(d, blocked, bands, False)
            d = _band_sweep_h(d, blocked, bands, True)
            if torch.equal(d, before):
                break
        fields.append(d)
    return td.directions_from_distance(torch.cat(fields), free)


@pytest.mark.parametrize("bands,max_rounds", [(2, 2), (5, 2), (3, 128),
                                              (8, 128)])
def test_band_split_kernel_matches_the_pallas_kernel(interpret_mode, bands,
                                                     max_rounds):
    """Per-field convergence over band-split passes gives the JAX
    package's codes, where ``max_rounds`` binds and where it does not."""
    free = _free(5, 32, 128, 0.35)
    goals = _goals(free, 6, seed=bands)
    want = np.asarray(jff.single_direction_fields(
        jnp.asarray(free), jnp.asarray(goals), max_rounds))
    got = _band_fields(torch.from_numpy(free), torch.from_numpy(goals), bands,
                       max_rounds)
    np.testing.assert_array_equal(want, got.numpy())


# An H100's occupancy answer for 1024-thread blocks: 132 SMs, clusters of 16
# only one per GPC.
H100_CLUSTERS = {16: 8, 8: 16, 4: 32, 2: 66, 1: 132}


@pytest.mark.parametrize("g,h,want", [
    (4, 1024, 16),   # the flagship's in-step chunk: 4 clusters of 16 blocks
    (1, 1024, 16),
    (4, 512, 16),    # bands of 32 rows
    (9, 1024, 8),    # more clusters than fit at 16
    (64, 1024, 2),   # the flagship's prime chunk
    (4, 256, 8),     # the congested rung's in-step chunk: bands of 32 rows
    (13, 256, 8),
    (17, 256, 4),
    (64, 256, 2),    # its prime chunk
    (200, 512, 1),   # more fields than SMs
    (4, 64, 2),
    (4, 63, 1),      # no band of 32 rows at 2 blocks
    (4, 5, 1),
])
def test_choose_cluster(g, h, want):
    assert tff.choose_cluster(g, h, H100_CLUSTERS.__getitem__) == want


def test_choose_cluster_takes_one_block_where_no_cluster_is_placed():
    assert tff.choose_cluster(4, 1024, lambda k: 0) == 1


@pytest.mark.parametrize("g", [1, 4, 64, 200])
def test_launch_layout_one_cluster_per_field(monkeypatch, g):
    """One cluster per field, no padded field: G clusters, G K blocks."""
    monkeypatch.setattr(tff, "max_active_clusters",
                        lambda device, k, h, w: H100_CLUSTERS[k])
    layout = tff.launch_layout("cuda", g, 1024, 1024)
    assert layout["blocks"] == g * layout["cluster"]
    assert layout["cluster"] == tff.choose_cluster(
        g, 1024, H100_CLUSTERS.__getitem__)
    assert tff.launch_layout("cuda", g, 1024, 1024, cluster=4) == {
        "cluster": 4, "blocks": 4 * g}


@pytest.mark.parametrize("cluster", [None, 0, 3, 2.0])
def test_launch_layout_raises_where_the_kernel_takes_no_layout(monkeypatch,
                                                               cluster):
    """The kernel's answer (0: a layout it does not take) decides; a forced
    layout is never swapped for another."""
    monkeypatch.setattr(tff, "max_active_clusters",
                        lambda device, k, h, w: 0 if k in (1, 3) else 8)
    with pytest.raises(ValueError, match="does not take"):
        tff.launch_layout("cuda", 4, 16, 32768, cluster)
