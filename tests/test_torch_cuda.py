"""The port on the card: the CUDA kernels (the sweep, with one mask for
every field or one per field, and both instances of the fused field kernel)
against their plain versions, CUDA solves against CPU solves, the field
repair and sector planner on the card against the same calls on the CPU,
the multi-device layers (banded sweeps, sharded solves, the mesh
daemon) on virtual shards of the card, and on real ones where there are
two cards, against the flat path on the card, and reserved space-time A*
on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, run it without the suite's conftest (which pins
JAX to the CPU):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.core.sampling import (
    start_positions_array,
)
from p2p_distributed_tswap_tpu_torch.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu_torch.ops import (
    distance,
    field_fused,
    sweep_kernel,
)
from p2p_distributed_tswap_tpu_torch.solver import mapd

pytestmark = pytest.mark.cuda

DIRECTIONS = [(1, False), (1, True), (2, False), (2, True)]
INF = sweep_kernel.INF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: sweep_scan is CUDA code with no "
                    "CPU mode")
    return torch.device("cuda")


def _inputs(seed, r, h, w, edges):
    rng = np.random.default_rng(seed)
    free = rng.random((h, w)) > 0.25
    if edges:
        free[[0, -1], :] = False
        free[:, [0, -1]] = False
    d = np.where(rng.random((r, h, w)) > 0.95,
                 rng.integers(0, 60, (r, h, w)), INF)
    d = np.where(free[None], d, INF).astype(np.int32)
    return torch.from_numpy(d), torch.from_numpy((~free).astype(np.uint8))


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("r,h,w,edges", [
    (1, 100, 100, True), (3, 37, 53, True), (2, 257, 131, False),
    (1, 8, 4096, True), (4, 128, 1024, False), (1, 1, 1, False),
    (2, 33, 1, False), (2, 1, 33, True)])
def test_kernel_matches_plain(cuda, axis, reverse, r, h, w, edges):
    d, blocked = _inputs(5 * h + w + axis + reverse, r, h, w, edges)
    want = sweep_kernel.sweep_plain(d, blocked, axis, reverse)
    before = sweep_kernel.launches
    got = distance._sweep(d.to(cuda), blocked.to(cuda), axis, reverse)
    torch.cuda.synchronize()
    assert sweep_kernel.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _check_sweep(cuda, d, blocked, axis, reverse, **forced):
    want = sweep_kernel.sweep_plain(d, blocked, axis, reverse)
    before = sweep_kernel.launches
    if forced:
        got = sweep_kernel.sweep_scan_forced(d.to(cuda), blocked.to(cuda),
                                             axis, reverse, **forced)
    else:
        got = sweep_kernel.sweep_scan(d.to(cuda), blocked.to(cuda), axis,
                                      reverse)
    torch.cuda.synchronize()
    assert sweep_kernel.launches == before + 1
    assert torch.equal(got.cpu(), want)


# The along-H layout (tile, rows, bands) the kernel picks at the solver's
# sweep shapes (the in-step and prime chunks of 1024^2, 512^2 and 256^2);
# tests/test_torch_sweep_bands.py imports it and emulates each of them on
# the CPU.
PATH_LAYOUTS = {
    (4, 1024, 1024): (32, 16, 32), (64, 1024, 1024): (32, 16, 8),
    (4, 512, 512): (16, 16, 32), (128, 512, 512): (32, 16, 8),
    (4, 256, 256): (8, 16, 16), (64, 256, 256): (32, 16, 8),
}


def test_layouts_at_the_path_shapes(cuda):
    for (r, h, w), (tile, rows, bands) in PATH_LAYOUTS.items():
        layout = sweep_kernel.launch_layout(r, h, w, 1)
        assert (layout["tile"], layout["rows"], layout["bands"]) == \
            (tile, rows, bands)
        assert layout["threads"] == tile * bands
        assert layout["blocks"] == r * -(-w // tile) >= 128
        along_w = sweep_kernel.launch_layout(r, h, w, 2)
        assert along_w["cells"] == 4 and along_w["threads"] == 256


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("r,h,w", [(4, 1024, 1024), (4, 512, 512),
                                   (4, 256, 256), (64, 512, 512),
                                   (64, 256, 256)])
def test_kernel_matches_plain_in_its_chosen_layouts(cuda, axis, reverse, r,
                                                    h, w):
    """The in-step chunks and two prime-sized batches (at most 8 bands a
    block along H), each in the layout the kernel picks."""
    d, blocked = _inputs(h + axis * 2 + reverse, r, h, w, True)
    _check_sweep(cuda, d, blocked, axis, reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("rows", [8, 16])
def test_every_along_h_layout(cuda, reverse, tile, rows):
    """Each of the six along-H kernel instances, on a ragged shape: H = 1025
    is more than one segment in every one of them, W = 75 ends mid-tile."""
    d, blocked = _inputs(tile + rows + reverse, 2, 1025, 75, True)
    _check_sweep(cuda, d, blocked, 1, reverse, tile=tile, rows=rows)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("tile,rows,bands", [
    (32, 16, 1), (32, 8, 3), (16, 16, 2), (8, 8, 4), (8, 16, 128),
    (32, 16, 16)])
def test_forced_bands_walk_segments(cuda, reverse, tile, rows, bands):
    d, blocked = _inputs(bands + reverse, 3, 300, 40, False)
    _check_sweep(cuda, d, blocked, 1, reverse, tile=tile, rows=rows,
                 bands=bands)


def test_forced_layouts_the_kernel_refuses(cuda):
    d = torch.zeros((2, 64, 64), dtype=torch.int32, device=cuda)
    m = torch.zeros((64, 64), dtype=torch.uint8, device=cuda)
    for forced in ({"tile": 4}, {"tile": 64}, {"rows": 12}, {"rows": 64},
                   {"tile": 16, "bands": 3}, {"tile": 8, "bands": 129},
                   {"tile": 32, "bands": 33}, {"tile": 32, "rows": 32},
                   {"tile": 128}, {"tile": 256}, {"rows": 4}):
        with pytest.raises(ValueError):
            sweep_kernel.launch_layout(2, 64, 64, 1, **forced)
        before = sweep_kernel.launches
        with pytest.raises(RuntimeError):
            sweep_kernel.sweep_scan_forced(d, m, 1, False, **forced)
        assert sweep_kernel.launches == before
    for forced in ({"tile": 2}, {"tile": 8}, {"rows": 8}, {"rows": 32},
                   {"bands": 1}):
        with pytest.raises(ValueError):
            sweep_kernel.launch_layout(2, 64, 64, 2, **forced)
        with pytest.raises(RuntimeError):
            sweep_kernel.sweep_scan_forced(d, m, 2, False, **forced)
    with pytest.raises(ValueError):  # no 16-byte loads on rows of 63
        sweep_kernel.launch_layout(2, 64, 63, 2, tile=4)
    with pytest.raises(RuntimeError):
        sweep_kernel.sweep_scan_forced(d[:, :, :63].contiguous(),
                                       m[:, :63].contiguous(), 2, False,
                                       tile=4)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cells", [1, 4])
@pytest.mark.parametrize("w", [4, 128, 256, 1024, 4100])
def test_every_along_w_layout(cuda, reverse, cells, w):
    """One cell per lane (scalar loads) and four (16-byte loads), forced
    on rows that take either: one chunk, one 256-cell segment, several."""
    d, blocked = _inputs(w + cells + reverse, 3, 21, w, True)
    _check_sweep(cuda, d, blocked, 2, reverse, tile=cells)


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("r", [1, 4, 64, 70000])
def test_field_counts(cuda, axis, reverse, r):
    """R up to past the 65 535 of a grid's y dimension, on a narrow grid."""
    d, blocked = _inputs(r + axis + reverse, r, 9, 12, True)
    _check_sweep(cuda, d, blocked, axis, reverse)


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("h", [1, 31, 33, 1025])
@pytest.mark.parametrize("w", [1, 31, 33, 1025])
def test_ragged_heights_and_widths(cuda, axis, reverse, h, w):
    d, blocked = _inputs(h * w + axis + reverse, 2, h, w, False)
    _check_sweep(cuda, d, blocked, axis, reverse)


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("h,w", [(1024, 1024), (512, 512), (256, 256),
                                 (300, 4100)])
def test_goals_and_obstacles_on_band_and_tile_edges(cuda, axis, reverse, h,
                                                    w):
    """Seeds and obstacles on the first and last row of every band and
    segment of the chosen layout (both scan orders), on every tile's edge
    columns, and on every lane's and chunk's edge cells along W."""
    layout = sweep_kernel.launch_layout(4, h, w, 1)
    rng = np.random.default_rng(h + w + axis + reverse)
    free = rng.random((h, w)) > 0.1
    seeds = np.zeros((4, h, w), dtype=bool)
    rows = {0, layout["rows"], layout["rows"] * layout["bands"]} - {0}
    for step in rows:
        for y in range(0, h, step):
            for yy in {y, y - 1, h - 1 - y, h - y} & set(range(h)):
                free[yy, rng.integers(w, size=w // 4)] = False
                seeds[:, yy, rng.integers(w, size=w // 4)] = True
    for step in (layout["tile"], 4, 128, 1024):
        for x in range(0, w, step):
            for xx in {x, x - 1, w - 1 - x, w - x} & set(range(w)):
                free[rng.integers(h, size=h // 4), xx] = False
                seeds[:, rng.integers(h, size=h // 4), xx] = True
    d = np.where(seeds & free[None], rng.integers(0, 60, (4, h, w)), INF)
    _check_sweep(cuda, torch.from_numpy(d.astype(np.int32)),
                 torch.from_numpy((~free).astype(np.uint8)), axis, reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_along_w_on_unaligned_tensors(cuda, reverse):
    """W % 4 == 0 but the tensors start 4 bytes past an alignment: the
    kernel takes its scalar loads, not the 16-byte vectors."""
    d, blocked = _inputs(8 + reverse, 3, 17, 64, True)
    want = sweep_kernel.sweep_plain(d, blocked, 2, reverse)
    dd = torch.empty(1 + d.numel(), dtype=torch.int32, device=cuda)
    dd[1:] = d.reshape(-1).to(cuda)
    mm = torch.empty(1 + blocked.numel(), dtype=torch.uint8, device=cuda)
    mm[1:] = blocked.reshape(-1).to(cuda)
    got = sweep_kernel.sweep_scan(dd[1:].view(d.shape), mm[1:].view(
        blocked.shape), 2, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_wrapper_checks_dtype_shape_layout(cuda):
    d = torch.zeros((2, 4, 5), dtype=torch.int32, device=cuda)
    m = torch.zeros((4, 5), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        sweep_kernel.sweep_scan(d.long(), m, 1, False)
    with pytest.raises(TypeError):
        sweep_kernel.sweep_scan(d, m.bool(), 1, False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d, m[:, :4].contiguous(), 1, False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d.transpose(1, 2), m.T.contiguous(), 1,
                                False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d, m, 0, False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d, m.cpu(), 1, False)


def _per_field_inputs(seed, r, h, w, pad):
    """(d, blocked) with one mask per field: each field's own random
    obstacles and border, its seeds on its own free cells, and the last
    ``pad`` fields fully blocked (the pow2 padding of a window batch)."""
    rng = np.random.default_rng(seed)
    free = rng.random((r, h, w)) > rng.uniform(0.05, 0.4, (r, 1, 1))
    free[:, [0, -1], :] = False
    free[:, :, [0, -1]] = False
    if pad:
        free[r - pad:] = False
    d = np.where(rng.random((r, h, w)) > 0.95,
                 rng.integers(0, 60, (r, h, w)), INF)
    d = np.where(free, d, INF).astype(np.int32)
    return torch.from_numpy(d), torch.from_numpy((~free).astype(np.uint8))


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("r,h,w,pad", [
    (5, 37, 53, 1), (8, 66, 66, 3), (16, 128, 128, 4), (3, 1025, 33, 1),
    (2, 33, 1025, 0), (4, 31, 1, 1), (70000, 3, 5, 1000),
    (512, 128, 128, 200), (8, 256, 256, 3)])
def test_per_field_masks_match_plain(cuda, axis, reverse, r, h, w, pad):
    """One mask per field (the repair and sector windows): ragged H and W,
    fully blocked padded layers, and the sector planner's batch shapes."""
    d, blocked = _per_field_inputs(r + h + w + axis + reverse, r, h, w, pad)
    _check_sweep(cuda, d, blocked, axis, reverse)
    # each field against its own 2-D mask through the shared-mask path
    k = r - pad - 1 if r > pad else 0
    want = sweep_kernel.sweep_plain(d[k:k + 1], blocked[k], axis, reverse)
    got = sweep_kernel.sweep_scan(d.to(cuda), blocked.to(cuda), axis,
                                  reverse)[k:k + 1]
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("forced", [
    {"tile": 8, "rows": 8}, {"tile": 16, "rows": 16},
    {"tile": 32, "rows": 8}, {"tile": 32, "rows": 16, "bands": 2}])
def test_per_field_masks_in_every_along_h_layout(cuda, reverse, forced):
    d, blocked = _per_field_inputs(len(forced) + reverse, 3, 300, 75, 1)
    _check_sweep(cuda, d, blocked, 1, reverse, **forced)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cells", [1, 4])
def test_per_field_masks_in_every_along_w_layout(cuda, reverse, cells):
    d, blocked = _per_field_inputs(cells + reverse, 5, 21, 1028, 2)
    _check_sweep(cuda, d, blocked, 2, reverse, tile=cells)


def test_per_field_masks_never_reach_the_plain_version(cuda, monkeypatch):
    """A CUDA batch with one mask per field launches the kernel on every
    sweep of the window fixpoint; the plain version is never called."""
    d, blocked = _per_field_inputs(3, 8, 66, 66, 3)
    free = (blocked == 0).to(cuda)

    def _plain(*a, **k):
        raise AssertionError("sweep_plain called on the card")

    want = distance.window_fixpoint(d, blocked == 0)
    monkeypatch.setattr(sweep_kernel, "sweep_plain", _plain)
    before, syncs = sweep_kernel.launches, hostsync.count
    got = distance.window_fixpoint(d.to(cuda), free)
    assert sweep_kernel.launches - before == 4 * (hostsync.count - syncs)
    assert sweep_kernel.launches > before
    assert torch.equal(got.cpu(), want)


def test_wrapper_checks_per_field_mask_shapes(cuda):
    d = torch.zeros((2, 4, 5), dtype=torch.int32, device=cuda)
    for shape in ((3, 4, 5), (1, 4, 5), (2, 5, 4), (2, 4, 5, 1)):
        m = torch.zeros(shape, dtype=torch.uint8, device=cuda)
        with pytest.raises(ValueError):
            sweep_kernel.sweep_scan(d, m, 1, False)
    m = torch.zeros((2, 5, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        sweep_kernel.sweep_scan(d, m.transpose(1, 2), 2, False)


def test_repair_field_on_cuda_matches_cpu(cuda):
    """A door opening into a closed room: the repair window grows until
    it holds the room, past DIJKSTRA_MAX_CELLS, so on the card it sweeps by
    ``sweep_scan`` (the card's window ceiling is half the grid), equal to
    the same repair swept on the CPU and to a full recompute; a small
    toggle stays on the host Dijkstra."""
    from p2p_distributed_tswap_tpu_torch.ops import field_repair

    h = w = 400
    rng = np.random.default_rng(3)
    free = rng.random((h, w)) > 0.1
    free[150, 150:261] = free[260, 150:261] = False
    free[150:261, 150] = free[150:261, 260] = False
    goal = 5 * w + 5
    free.reshape(-1)[goal] = True

    def full(f):
        return distance.distance_fields(
            torch.from_numpy(f.copy()),
            torch.tensor([goal], dtype=torch.int32)).numpy()[0]

    dist = full(free)
    door = 150 * w + 200
    free.reshape(-1)[door] = True
    cap = field_repair.default_max_window(h * w, cuda)
    before = sweep_kernel.launches
    got = field_repair.repair_field(dist, free, [door], device=cuda)
    assert sweep_kernel.launches > before
    assert got is not None
    y0, y1, x0, x1 = got[1]
    assert (y1 - y0) * (x1 - x0) > field_repair.DIJKSTRA_MAX_CELLS
    want = field_repair.repair_field(dist, free, [door], max_window=cap,
                                     device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], full(free))
    cell = 40 * w + int(np.flatnonzero(free[40, 60:])[0]) + 60
    free.reshape(-1)[cell] = False
    before = sweep_kernel.launches
    small = field_repair.repair_field(got[0], free, [cell], device=cuda)
    assert sweep_kernel.launches == before
    assert small is not None
    np.testing.assert_array_equal(small[0], full(free))


@pytest.mark.parametrize("s", [16, 32])
def test_sector_planner_on_cuda_matches_cpu(cuda, s):
    """The planner on the card (the jit path by default: window and
    corridor fixpoints by ``sweep_scan`` with per-window masks) against the
    same planner on the CPU, jit and host paths: portal graphs, plans and
    toggles equal."""
    from p2p_distributed_tswap_tpu_torch.ops import sector

    rng = np.random.default_rng(s)
    free = rng.random((96, 96)) > 0.2
    masks = {k: free.copy() for k in ("cuda", "jit", "host")}
    before = sweep_kernel.launches
    planners = {
        "cuda": sector.SectorPlanner(masks["cuda"], s=s, device=cuda),
        "jit": sector.SectorPlanner(masks["jit"], s=s, use_jit=True,
                                    device="cpu"),
        "host": sector.SectorPlanner(masks["host"], s=s, use_jit=False,
                                     device="cpu")}
    assert planners["cuda"].use_jit and sweep_kernel.launches > before
    state = planners["host"].graph_state()
    assert all(p.graph_state() == state for p in planners.values())
    cells = np.flatnonzero(free.reshape(-1))
    for t in range(6):
        st, gl = (int(c) for c in rng.choice(cells, 2, replace=False))
        plans = {k: p.plan_goal(gl, [st], keep_dist=True)
                 for k, p in planners.items()}
        for k in ("jit", "host"):
            np.testing.assert_array_equal(plans["cuda"].packed,
                                          plans[k].packed)
            np.testing.assert_array_equal(plans["cuda"].dist, plans[k].dist)
    tog = [int(c) for c in rng.choice(cells, 12, replace=False)]
    for k, p in planners.items():
        for c in tog:
            masks[k].reshape(-1)[c] = False
        p.apply_toggles(tog)
    state = planners["host"].graph_state()
    assert all(p.graph_state() == state for p in planners.values())


def test_direction_fields_on_cuda_match_cpu(cuda):
    grid = Grid.warehouse(48, 56)
    rng = np.random.default_rng(1)
    goals = torch.from_numpy(rng.choice(
        np.flatnonzero(grid.free.reshape(-1)), 6).astype(np.int32))
    free = torch.from_numpy(grid.free)
    want = distance.direction_fields(free, goals)
    before = sweep_kernel.launches
    got = distance.direction_fields(free.to(cuda), goals.to(cuda))
    assert sweep_kernel.launches > before
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("radius", [None, 15])
def test_solve_on_cuda_matches_cpu(cuda, radius):
    grid = Grid.warehouse(64, 64)
    starts = start_positions_array(grid, 40, seed=2)
    tasks = TaskGenerator(grid, seed=3).generate_task_arrays(40)
    cfg = SolverConfig(height=64, width=64, num_agents=40,
                       visibility_radius=radius)
    want = mapd.solve_offline(grid, starts, tasks, cfg, device="cpu")
    syncs = hostsync.count
    got = mapd.solve_offline(grid, starts, tasks, cfg)  # default: cuda
    assert hostsync.count > syncs
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _fused_inputs(seed, g, h, w, density):
    rng = np.random.default_rng(seed)
    free = rng.random((h, w)) > density
    free[0, 0] = True
    cells = np.flatnonzero(free.reshape(-1))
    goals = rng.choice(cells, g).astype(np.int32)
    goals[0] = 0                                   # a corner
    if g > 1 and (~free).any():
        goals[1] = np.flatnonzero(~free.reshape(-1))[0]  # on an obstacle
    return torch.from_numpy(free), torch.from_numpy(goals)


@pytest.mark.parametrize("mode", ["single", "multi"])
@pytest.mark.parametrize("g,h,w,density,max_rounds", [
    (3, 100, 100, 0.3, 128), (11, 32, 128, 0.35, 128), (16, 64, 256, 0.2, 128),
    (1, 8, 128, 0.0, 128), (5, 33, 47, 0.3, 2), (11, 32, 128, 0.35, 1),
    (9, 256, 256, 0.1, 128), (2, 3, 1, 0.0, 128)])
def test_fused_kernel_matches_plain(cuda, mode, g, h, w, density, max_rounds):
    free, goals = _fused_inputs(7 * h + w + g, g, h, w, density)
    want = field_fused.fields_plain(free, goals, max_rounds)
    before = dict(field_fused.launches)
    got, rounds = field_fused.fused_kernel(free.to(cuda), goals.to(cuda),
                                           max_rounds, mode)
    torch.cuda.synchronize()
    assert field_fused.launches[mode] == before[mode] + 1
    assert got.dtype == torch.uint8 and got.shape == (g, h, w)
    assert torch.equal(got.cpu(), want)
    assert rounds.shape == (g,) and rounds.dtype == torch.int32
    assert int(rounds.max()) <= max_rounds


def test_fused_wrapper_checks_inputs(cuda):
    free = torch.ones((8, 128), dtype=torch.bool, device=cuda)
    goals = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        field_fused.fused_kernel(free.to(torch.uint8), goals, 8, "single")
    with pytest.raises(TypeError):
        field_fused.fused_kernel(free, goals.long(), 8, "single")
    with pytest.raises(ValueError):
        field_fused.fused_kernel(free, goals.cpu(), 8, "single")
    with pytest.raises(ValueError):
        field_fused.fused_kernel(free.T, goals, 8, "single")
    with pytest.raises(ValueError):
        field_fused.fused_kernel(free, goals[:0], 8, "multi")
    with pytest.raises(ValueError):
        field_fused.fused_kernel(free, goals, 8, "double")
    wide = torch.ones((16, 32768), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        field_fused.fused_kernel(wide, goals, 8, "single")
    with pytest.raises(ValueError, match="cluster"):
        field_fused.fused_kernel(free, goals, 8, "single", cluster=9)
    with pytest.raises(ValueError, match="cluster"):
        field_fused.fused_kernel(free, goals, 8, "single", cluster=17)


def _check_fused(cuda, free, goals, max_rounds, mode, **layout):
    """The kernel == its plain version; returns the (G,) rounds."""
    want = field_fused.fields_plain(free, goals, max_rounds)
    got, rounds = field_fused.fused_kernel(free.to(cuda), goals.to(cuda),
                                           max_rounds, mode, **layout)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert rounds.shape == goals.shape and int(rounds.min()) >= 0
    assert int(rounds.max()) <= max_rounds
    return rounds.cpu()


@pytest.mark.parametrize("mode", ["single", "multi"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_fused_kernel_at_every_cluster_size(cuda, mode, cluster):
    if field_fused.max_active_clusters(cuda, cluster, 96, 256) == 0:
        pytest.skip(f"the card places no cluster of {cluster} blocks")
    free, goals = _fused_inputs(cluster, 5, 96, 256, 0.3)
    _check_fused(cuda, free, goals, 128, mode, cluster=cluster)


@pytest.mark.parametrize("mode", ["single", "multi"])
@pytest.mark.parametrize("g", [1, 3, 4, 5, 11, 64])
def test_fused_kernel_batch_sizes(cuda, mode, g):
    free, goals = _fused_inputs(g, g, 64, 256, 0.25)
    layout = field_fused.launch_layout(cuda, g, 64, 256)
    assert layout["blocks"] == g * layout["cluster"]  # no padded field
    _check_fused(cuda, free, goals, 128, mode)


@pytest.mark.parametrize("mode", ["single", "multi"])
@pytest.mark.parametrize("cluster", [3, 4])
def test_fused_goals_on_band_edges(cuda, mode, cluster):
    """Goals on the last row of a band and the first row of the next."""
    h, w = 64, 128
    free, _ = _fused_inputs(11, 1, h, w, 0.2)
    edges = [k * h // cluster for k in range(1, cluster)]
    rows = [r for e in edges for r in (e - 1, e)]
    rng = np.random.default_rng(cluster)
    goals = torch.tensor([r * w + int(rng.integers(w)) for r in rows],
                         dtype=torch.int32)
    _check_fused(cuda, free, goals, 128, mode, cluster=cluster)


@pytest.mark.parametrize("mode", ["single", "multi"])
@pytest.mark.parametrize("cluster", [1, 8])
def test_fused_round_cap_binds_on_a_maze(cuda, mode, cluster):
    free, goals = _fused_inputs(5, 11, 64, 256, 0.35)
    full = field_fused.fields_plain(free, goals)
    for max_rounds in (1, 2, 3):
        rounds = _check_fused(cuda, free, goals, max_rounds, mode,
                              cluster=cluster)
        assert int(rounds.max()) == max_rounds
        assert not torch.equal(
            field_fused.fields_plain(free, goals, max_rounds), full)


def test_fused_rounds_agree_between_instances(cuda):
    """Per-field rounds (G,) are the same from both instances, whatever the
    cluster size."""
    free, goals = _fused_inputs(6, 20, 64, 256, 0.3)
    want = _check_fused(cuda, free, goals, 128, "single")
    for cluster in (1, 2, 4):
        got = _check_fused(cuda, free, goals, 128, "multi", cluster=cluster)
        assert torch.equal(got, want)


def test_fused_layout_at_the_in_step_chunk(cuda):
    """At the in-step chunk of 4 fields each field is split over a cluster
    of more than one block, one cluster per field."""
    for h in (1024, 256):
        layout = field_fused.launch_layout(cuda, 4, h, h)
        assert layout["cluster"] > 1
        assert layout["blocks"] == 4 * layout["cluster"]


@pytest.mark.parametrize("mode,env", [("multi", "1"), ("multi", "multi"),
                                      ("single", "single")])
def test_direction_fields_takes_the_fused_kernel(cuda, monkeypatch, mode,
                                                 env):
    grid = Grid.warehouse(64, 256)
    rng = np.random.default_rng(2)
    goals = torch.from_numpy(rng.choice(
        np.flatnonzero(grid.free.reshape(-1)), 6).astype(np.int32))
    free = torch.from_numpy(grid.free)
    want = distance.direction_fields(free, goals)
    monkeypatch.setenv("MAPD_FUSED", env)
    assert field_fused.fused_eligible(64, 256, cuda)
    sweeps, fused = sweep_kernel.launches, dict(field_fused.launches)
    got = distance.direction_fields(free.to(cuda), goals.to(cuda))
    assert sweep_kernel.launches == sweeps
    assert field_fused.launches[mode] == fused[mode] + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("fused", ["", "1"])
def test_stale_solve_on_cuda_matches_cpu(cuda, monkeypatch, fused):
    grid = Grid.warehouse(32, 128)
    starts = start_positions_array(grid, 40, seed=4)
    tasks = TaskGenerator(grid, seed=5).generate_task_arrays(40)
    cfg = SolverConfig(height=32, width=128, num_agents=40,
                       visibility_radius=15, view_refresh_steps=2,
                       swap_commit_delay=1, max_timesteps=400)
    want = mapd.solve_offline(grid, starts, tasks, cfg, device="cpu")
    monkeypatch.setenv("MAPD_FUSED", fused)
    sweeps, fused_n = sweep_kernel.launches, field_fused.launches["multi"]
    got = mapd.solve_offline(grid, starts, tasks, cfg)
    assert (field_fused.launches["multi"] > fused_n) == bool(fused)
    assert (sweep_kernel.launches > sweeps) != bool(fused)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _serve_stream(device, free, wire, ticks=30, n=40, seed=6, mesh=None):
    """A short closed-loop request stream served by the port's
    ``TickRunner`` on ``device``, or on ``mesh`` (deferred fields off): the
    fleet adopts each reply's moves and goals, and an agent on its goal
    takes a random next one.  Returns every reply with ``duration_micros``
    dropped."""
    from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    grid = Grid(free.copy())
    w = grid.width
    svc = solverd.PlanService(grid, capacity_min=8, device=device,
                              mesh=mesh)
    svc.defer_fields = False
    runner = solverd.TickRunner(svc, grid)
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(free.reshape(-1))
    pick = rng.choice(cells, 2 * n, replace=False)
    pos, goal = pick[:n].copy(), pick[n:].copy()
    names = [f"a{k}" for k in range(n)]
    enc = pc.PackedFleetEncoder(snapshot_every=10)
    replies = []
    for seq in range(ticks):
        arrived = pos == goal
        goal[arrived] = rng.choice(cells, int(arrived.sum()))
        items = list(zip(names, pos.tolist(), goal.tolist()))
        if wire == "packed":
            req = {"type": "plan_request", "seq": seq, "codec": pc.CODEC_NAME,
                   "caps": [pc.CODEC_NAME],
                   "data": pc.encode_b64(enc.encode_tick(seq, items))}
        else:
            req = {"type": "plan_request", "seq": seq, "agents": [
                {"peer_id": a, "pos": [p % w, p // w],
                 "goal": [g % w, g // w]} for a, p, g in items]}
        resp = runner.handle(req)
        replies.append({k: v for k, v in resp.items()
                        if k != "duration_micros"})
        if wire == "packed":
            rp = pc.decode_b64(resp["data"])
            pos[rp.idx], goal[rp.idx] = rp.pos, rp.goal
        else:
            for m in resp["moves"]:
                k = names.index(m["peer_id"])
                pos[k] = m["next_pos"][1] * w + m["next_pos"][0]
                goal[k] = m["goal"][1] * w + m["goal"][0]
    return replies


@pytest.mark.parametrize("wire", ["packed", "json"])
@pytest.mark.parametrize("fused", ["", "1", "single"])
def test_served_stream_on_cuda_matches_cpu(cuda, monkeypatch, wire, fused):
    free = Grid.warehouse(64, 256).free
    monkeypatch.setenv("MAPD_FUSED", fused)
    counts = (sweep_kernel.launches, dict(field_fused.launches))
    got = _serve_stream(cuda, free, wire)
    mode = {"1": "multi", "single": "single"}.get(fused)
    if mode is None:
        assert sweep_kernel.launches > counts[0]
    else:
        assert field_fused.launches[mode] > counts[1][mode]
        assert sweep_kernel.launches == counts[0]
    assert got == _serve_stream(torch.device("cpu"), free, wire)


def test_warm_builds_the_kernels_and_plans_on_cuda(cuda):
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    grid = Grid.warehouse(64, 256)
    svc = solverd.PlanService(grid, capacity_min=8, device=cuda)
    assert not svc.defer_fields
    before = sweep_kernel.launches
    assert solverd.warm(svc, grid, 12) == 12
    assert sweep_kernel.launches > before
    assert svc.dirs.is_cuda and len(svc.goal_rows) == 12


def _tenant_planes(tenants=8, lanes=1024):
    """The 1k-512 rung's fleets of seeds 0..tenants-1 as ``[T, L]`` slab
    planes (each agent heading for its task's pickup, the lanes past 1000
    padded at cell 0), with the shared field rows of every goal."""
    from p2p_distributed_tswap_tpu_torch.models import scenarios

    pos = np.zeros((tenants, lanes), np.int32)
    goal = np.zeros((tenants, lanes), np.int32)
    active = np.zeros((tenants, lanes), bool)
    for k in range(tenants):
        grid, starts, tasks, _ = scenarios.MEDIUM.build(seed=k)
        n = len(starts)
        pos[k, :n] = starts
        goal[k, :n] = np.asarray(tasks)[np.arange(n) % len(tasks), 0]
        active[k, :n] = True
    goals = np.unique(goal[active])
    slot = np.where(active, np.searchsorted(goals, goal), 0).astype(np.int32)
    return grid, pos, goal, slot, active, goals


def test_folded_step_on_cuda_matches_cpu(cuda):
    """The tenant fold of the step at the width of the 8-tenant serve
    phase, ``[8, 1024]`` lanes on the 1k-512 grid: three steps on the card
    equal the same steps on the CPU, with as many cascade host syncs."""
    from p2p_distributed_tswap_tpu_torch.solver import step

    grid, pos, goal, slot, active, goals = _tenant_planes()
    free = torch.from_numpy(grid.free).to(cuda)
    dirs = torch.cat([
        distance.pack_directions(distance.direction_fields(
            free, torch.from_numpy(goals[o:o + 256].astype(np.int32)).to(
                cuda)).reshape(-1, grid.num_cells))
        for o in range(0, len(goals), 256)])
    t, lanes = pos.shape
    cfg = SolverConfig(height=grid.height, width=grid.width,
                       num_agents=t * lanes)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        s = tuple(torch.from_numpy(x.reshape(-1).copy()).to(dev)
                  for x in (pos, goal, slot))
        act = torch.from_numpy(active.reshape(-1).copy()).to(dev)
        d = dirs.to(dev)
        before, out = hostsync.count, []
        for _ in range(3):
            s = step.step_parallel(cfg, *s, d, act, tenants=t)
            out.append(tuple(x.cpu() for x in s))
        runs[dev.type] = (out, hostsync.count - before)
    assert runs["cuda"][1] == runs["cpu"][1]
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    moved = runs["cpu"][0][-1][0].numpy().reshape(t, lanes) != pos
    assert moved[active].sum() > 1000


def _tenant_stream(device, ticks=20, tenants=3):
    """A 3-tenant closed-loop stream on the ref rung's grid, served by the
    port's ``MultiTenantRunner`` on ``device`` (deferred fields off):
    every tenant asks in every burst, adopts its reply, and an agent on its
    goal takes a random next one.  Returns the publishes with
    ``duration_micros`` dropped."""
    from p2p_distributed_tswap_tpu_torch.models import scenarios
    from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    grid = scenarios.REFERENCE_DEMO.build(seed=0)[0]
    svc = solverd.PlanService(grid, capacity_min=16, device=device)
    svc.defer_fields = False
    pub = []
    runner = solverd.MultiTenantRunner(
        solverd.TenantSlab(svc, grid), grid,
        publish=lambda t, d: pub.append(
            (t, {k: v for k, v in d.items() if k != "duration_micros"})))
    cells = np.flatnonzero(grid.free.reshape(-1))
    fleets = {}
    for k in range(tenants):
        _, starts, tasks, _ = scenarios.REFERENCE_DEMO.build(seed=k)
        fleets[f"t{k}"] = [np.asarray(starts).copy(),
                           np.asarray(tasks)[:len(starts), 0].copy(),
                           pc.PackedFleetEncoder(snapshot_every=10),
                           np.random.default_rng(k)]
    for seq in range(ticks):
        for ns, (pos, goal, enc, rng) in fleets.items():
            arrived = pos == goal
            goal[arrived] = rng.choice(cells, int(arrived.sum()))
            items = [(f"a{j}", int(p), int(g))
                     for j, (p, g) in enumerate(zip(pos, goal))]
            assert runner.ingest(ns, {
                "type": "plan_request", "seq": seq, "codec": pc.CODEC_NAME,
                "caps": [pc.CODEC_NAME],
                "data": pc.encode_b64(enc.encode_tick(seq, items))})
        n = len(pub)
        runner.finish(runner.begin())
        for topic, d in pub[n:]:
            pos, goal = fleets[topic.split(":")[0]][:2]
            rp = pc.decode_b64(d["data"])
            pos[rp.idx], goal[rp.idx] = rp.pos, rp.goal
    assert runner.slab.d_pos.device.type == device.type
    return pub


def test_tenant_runner_on_cuda_matches_cpu(cuda):
    before = sweep_kernel.launches
    got = _tenant_stream(cuda)
    assert sweep_kernel.launches > before
    assert len(got) == 60
    assert got == _tenant_stream(torch.device("cpu"))


# ---------------------------------------------------------------------------
# the multi-device layers on the card: virtual shards on cuda:0, and real
# shards where the machine has two cards or more
# ---------------------------------------------------------------------------


def _cuda_mesh(a, t, real=False):
    from p2p_distributed_tswap_tpu_torch.parallel.mesh import agent_tile_mesh
    from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
        virtual_devices)

    return agent_tile_mesh(a, t, None if real
                           else virtual_devices(a * t, "cuda"))


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards for a mesh of real shards")
    return cuda


@pytest.mark.parametrize("a,t", [(1, 2), (1, 4), (2, 2)])
def test_tiled_fields_on_cuda_match_flat(cuda, a, t):
    from p2p_distributed_tswap_tpu_torch.ops import tiled_distance as td

    grid = Grid.warehouse(256, 256)
    free = torch.from_numpy(grid.free).to(cuda)
    rng = np.random.default_rng(a * 10 + t)
    cells = np.flatnonzero(grid.free.reshape(-1))
    goals = [torch.from_numpy(rng.choice(cells, 6).astype(np.int32))
             for _ in range(a)]
    mesh = _cuda_mesh(a, t)
    before = sweep_kernel.launches
    codes = td.tiled_direction_fields(td.bands_of(free, mesh),
                                      [g.to(cuda) for g in goals], 256)
    assert sweep_kernel.launches > before
    for k in range(a):
        want = distance.direction_fields(free, goals[k].to(cuda), 256)
        assert torch.equal(td.join_bands(codes[k], cuda), want)


def _window(cfg, s, tasks, free, step, steps):
    out = []
    for _ in range(steps):
        s = step(cfg, s, tasks, free)
        out.append((s.pos.cpu().numpy(), s.goal.cpu().numpy(),
                    s.slot.cpu().numpy()))
    return out


def test_sharded_window_on_cuda_matches_flat(cuda):
    """1k-512 on a 4-shard agent mesh of the card: the prime's rows and
    every step's (pos, goal, slot) of a window equal the flat solve's."""
    from p2p_distributed_tswap_tpu_torch.models import scenarios
    from p2p_distributed_tswap_tpu_torch.parallel import sharded

    grid, starts, tasks, cfg = scenarios.MEDIUM.build(seed=0)
    s, tasks_t = mapd.prepare_state(cfg, starts, tasks, grid.free,
                                    device=cuda)
    free = torch.from_numpy(grid.free).to(cuda)
    mesh = _cuda_mesh(4, 1)
    m, mtasks, mfree = sharded.prepare_state_sharded(cfg, mesh, starts,
                                                     tasks, grid.free)
    assert torch.equal(m.dirs.gather(), s.dirs)
    want = _window(cfg, s, tasks_t, free, mapd.mapd_step, 12)
    got = _window(cfg, m, mtasks, mfree,
                  lambda c, st, tk, f: sharded.sharded_mapd_step(
                      c, mesh, st, tk, f), 12)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)


def test_sharded2d_solve_on_cuda_matches_flat(cuda):
    from p2p_distributed_tswap_tpu_torch.parallel import sharded2d

    grid = Grid.warehouse(64, 128)
    starts = start_positions_array(grid, 32, seed=2)
    tasks = TaskGenerator(grid, seed=3).generate_task_arrays(32)
    want = mapd.solve_offline(grid, starts, tasks, device=cuda)
    got = sharded2d.solve_offline_sharded2d(grid, starts, tasks,
                                            mesh=_cuda_mesh(2, 2))
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])


def _mesh_stream(cuda, shape, real=False):
    from p2p_distributed_tswap_tpu_torch.parallel.solver_mesh import (
        SolverMesh)
    from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
        virtual_devices)

    a, t = shape
    devices = None if real else virtual_devices(a * t, "cuda")
    return SolverMesh(a, t, devices=devices)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_mesh_runner_on_cuda_matches_flat(cuda, shape):
    free = Grid.warehouse(64, 256).free
    want = _serve_stream(cuda, free, "packed")
    before = sweep_kernel.launches
    got = _serve_stream(cuda, free, "packed",
                        mesh=_mesh_stream(cuda, shape))
    assert sweep_kernel.launches > before
    assert got == want


def test_mesh_of_real_cards_matches_flat(two_cards):
    """Two cards: a real (2, 1) mesh (peer copies between the cards)
    serves the same replies as one card, and the banded sweep over the two
    cards equals the flat fields."""
    from p2p_distributed_tswap_tpu_torch.ops import tiled_distance as td

    free = Grid.warehouse(64, 256).free
    got = _serve_stream(two_cards, free, "packed",
                        mesh=_mesh_stream(two_cards, (2, 1), real=True))
    assert got == _serve_stream(two_cards, free, "packed")
    mesh = _cuda_mesh(1, 2, real=True)
    assert not mesh.virtual
    f = torch.from_numpy(free).to(two_cards)
    goals = torch.tensor([5, 700, 9000], dtype=torch.int32,
                         device=two_cards)
    codes = td.tiled_direction_fields(td.bands_of(f, mesh), [goals], 256)
    assert codes[0][1].device == torch.device("cuda", 1)
    assert torch.equal(td.join_bands(codes[0], two_cards),
                       distance.direction_fields(f, goals, 256))


def _astar_case(seed, side, nb, horizon):
    """A random grid, distinct starts and goals, and sparse node and edge
    reservations (numpy, from one seed)."""
    rng = np.random.default_rng(seed)
    free = rng.random((side, side)) > 0.2
    cells = np.flatnonzero(free.reshape(-1))
    starts = rng.choice(cells, nb, replace=False).astype(np.int32)
    goals = rng.choice(cells, nb, replace=False).astype(np.int32)
    node = np.zeros((horizon + 1, side * side), bool)
    node[rng.integers(1, horizon, 40), rng.choice(cells, 40)] = True
    edge = np.zeros((horizon + 1, side * side, 4), bool)
    edge[rng.integers(1, horizon, 40), rng.choice(cells, 40),
         rng.integers(0, 4, 40)] = True
    return free, starts, goals, node, edge


@pytest.mark.parametrize("start_time", [0, 3])
def test_reserved_astar_on_cuda_matches_cpu(cuda, start_time):
    import importlib

    ra = importlib.import_module(
        "p2p_distributed_tswap_tpu_torch.ops.reserved_astar")
    free, starts, goals, node, edge = _astar_case(5, 24, 16, 60)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        paths, arrival = ra.reserved_astar(
            free, starts, goals, torch.from_numpy(node).to(dev),
            torch.from_numpy(edge).to(dev), start_time=start_time)
        assert paths.device.type == dev.type
        out[dev.type] = (paths.cpu(), arrival.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert (out["cuda"][1] >= 0).any()


def test_plan_prioritized_on_cuda_matches_cpu(cuda):
    from p2p_distributed_tswap_tpu_torch.ops import plan_prioritized

    free, starts, goals, _, _ = _astar_case(6, 20, 10, 60)
    on_card = plan_prioritized(free, starts, goals, 60)
    on_cpu = plan_prioritized(free, starts, goals, 60, device="cpu")
    assert on_card[0].device.type == "cuda"
    assert torch.equal(on_card[0].cpu(), on_cpu[0])
    assert torch.equal(on_card[1].cpu(), on_cpu[1])


def test_host_prime_fields_on_cuda_matches_prime_fields(cuda):
    """The host-driven burst under the JAX package's name writes the same
    packed rows as ``prime_fields`` on the card, through ``sweep_scan``,
    a clipped tail chunk included (50 agents in chunks of 16)."""
    grid = Grid.random_obstacles(48, 48, 0.1, seed=3)
    n = 50
    cfg = SolverConfig(height=48, width=48, num_agents=n, replan_chunk=16)
    starts = start_positions_array(grid, n, seed=0)
    tasks = TaskGenerator(grid, seed=1).generate_task_arrays(60)
    s0, _ = mapd.prepare_state_unprimed(cfg, starts, tasks, cuda)
    free = torch.as_tensor(grid.free, device=cuda)
    plain = mapd.prime_fields(cfg, s0.replace(dirs=s0.dirs.clone()), free)
    before = sweep_kernel.launches
    hosted = mapd.host_prime_fields(cfg, s0.replace(dirs=s0.dirs.clone()),
                                    free)
    assert sweep_kernel.launches > before
    assert torch.equal(hosted.dirs, plain.dirs)
    assert torch.equal(hosted.need_replan, plain.need_replan)
    assert not hosted.need_replan.any()


def test_mesh_digest_gate_tick_on_virtual_shards_of_the_card(cuda,
                                                             monkeypatch):
    """The mesh smoke twin's digest gate on two virtual shards of
    ``cuda:0``: byte-identical replies and equal audit digests beside the
    flat runner on every tick, through ``sweep_scan``."""
    import importlib.util
    from pathlib import Path

    monkeypatch.delenv("JG_SOLVER_MESH", raising=False)
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_mesh_smoke.py"
    spec = importlib.util.spec_from_file_location("torch_mesh_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    before = sweep_kernel.launches
    ticks = smoke.digest_gate("cuda", log=lambda m: None)
    assert len(ticks) == 6 and sweep_kernel.launches > before
