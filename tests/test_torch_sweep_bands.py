"""The decomposition of the CUDA kernel ``sweep_scan``, emulated on the CPU.

``csrc/sweep_scan.cu`` does not walk an axis cell by cell.  Along H a block
owns a tile of columns cut into bands of rows: each band scans from INF to a
per-column (tail, obstacle) summary, then composes its carry from the
earlier bands' summaries and rescans from it; segments of bands follow one
another with the carry between them.  Along W a warp walks a row in chunks
of 32 lanes x 4 cells (1 on a ragged row): each lane's cells give a
summary, a ballot and five shuffle rounds take the segmented minimum across
lanes, and the chunk's carry passes to the next chunk and segment.  The
functions below repeat that arithmetic step for step in plain PyTorch, so
the algebra is checked here, bit for bit, against ``sweep_plain`` and the
JAX package's Pallas kernels (in interpret mode); the card-only tests hold
the kernel to ``sweep_plain`` and its layouts to ``PATH_LAYOUTS``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import PATH_LAYOUTS

from p2p_distributed_tswap_tpu.ops import sweep_pallas
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel

INF = sweep_kernel.INF
DIRECTIONS = [(1, False), (1, True), (2, False), (2, True)]
LANE_CELLS = 8  # cells a lane loads per row segment (kLaneCells)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Thousands of small tensor ops: on the CPU, intra-op threads cost more
    # than they give, most of all with several test workers on the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _relax(run, v, m):
    """One cell of the recurrence: run = min(run + 1, v); INF where blocked."""
    return torch.where(m, INF, torch.minimum(run + 1, v))


def _compose(carry, tail, obstacle, length):
    """The carry after a stretch of ``length`` cells whose own scan from INF
    ended at ``tail``: an obstacle in it cuts the carry off."""
    return torch.where(obstacle, tail, torch.minimum(tail, carry + length))


def emulate_along_h(d, blocked, reverse, tile, rows, bands):
    """``sweep_along_h`` of csrc/sweep_scan.cu: (R, H, W) int32 ``d``, (H, W)
    uint8 ``blocked``.  The tiles of a field are independent blocks, so they
    run side by side here (columns grouped by ``tile``)."""
    r, h, w = d.shape
    if reverse:  # scan order: the kernel mirrors positions to rows
        d, blocked = d.flip(1), blocked.flip(0)
    seg = rows * bands
    hp, wp = -(-h // seg) * seg, -(-w // tile) * tile
    # rows past H and columns past W: free INF cells, never stored
    v = torch.full((r, hp, wp), INF, dtype=torch.int32)
    v[:, :h, :w] = d
    m = torch.zeros((hp, wp), dtype=torch.bool)
    m[:h, :w] = blocked != 0
    v = v.reshape(r, hp, wp // tile, tile)
    m = m.reshape(hp, wp // tile, tile)
    out = torch.empty_like(v)
    seg_carry = torch.full((r, wp // tile, tile), INF, dtype=torch.int32)
    for p0 in range(0, hp, seg):
        band_rows = [range(p0 + b * rows, p0 + (b + 1) * rows)
                     for b in range(bands)]
        tails, obstacles = [], []
        for ys in band_rows:  # phase 1: each band alone, from INF
            run = torch.full_like(seg_carry, INF)
            for y in ys:
                run = _relax(run, v[:, y], m[y])
            tails.append(run)
            obstacles.append(m[ys.start:ys.stop].any(0))
        next_carry = None
        for b, ys in enumerate(band_rows):  # phase 2, after the barrier
            carry = seg_carry
            for j in range(b):
                carry = _compose(carry, tails[j], obstacles[j], rows)
            if b == bands - 1:
                next_carry = _compose(carry, tails[b], obstacles[b], rows)
            run = carry
            for y in ys:
                run = _relax(run, v[:, y], m[y])
                out[:, y] = run.clamp_max(INF)
        seg_carry = next_carry
    out = out.reshape(r, hp, wp)[:, :h, :w]
    return out.flip(1) if reverse else out


def emulate_along_w(d, blocked, reverse, cells):
    """``sweep_along_w<cells>`` of csrc/sweep_scan.cu: one warp per
    (field, row), segments of 256 cells in chunks of 32 lanes x ``cells``
    cells, the carry from chunk to chunk; inside a chunk the ballot and
    five shuffle rounds."""
    r, h, w = d.shape
    if reverse:
        d, blocked = d.flip(2), blocked.flip(1)
    chunk, seg = 32 * cells, 32 * LANE_CELLS
    wp = -(-w // chunk) * chunk
    v = torch.full((r, h, wp), INF, dtype=torch.int32)
    v[:, :, :w] = d
    m = torch.zeros((h, wp), dtype=torch.bool)
    m[:, :w] = blocked != 0
    m = m.expand(r, h, wp)
    lane = torch.arange(32, dtype=torch.int32)
    carry = torch.full((r, h), INF, dtype=torch.int32)
    out = torch.empty_like(v)
    for s0 in range(0, w, seg):
        for c0 in range(s0, min(s0 + seg, w), chunk):
            vc = v[:, :, c0:c0 + chunk].reshape(r, h, 32, cells)
            mc = m[:, :, c0:c0 + chunk].reshape(r, h, 32, cells)
            run = torch.full((r, h, 32), INF, dtype=torch.int32)
            for k in range(cells):
                run = _relax(run, vc[..., k], mc[..., k])
            has = mc.any(-1)
            # the last lane at or before each lane holding an obstacle
            last = torch.where(has, lane, -1).cummax(-1).values
            before = last >= 0
            last = last.clamp_min(0)
            key = run - cells * lane
            for off in (1, 2, 4, 8, 16):  # __shfl_up_sync(key, off)
                o = torch.cat([key[..., :off], key[..., :-off]], -1)
                key = torch.where(lane - off >= last, torch.minimum(key, o),
                                  key)
            through = key + cells * lane
            through = torch.where(
                before, through,
                torch.minimum(through, carry[..., None] + cells * (lane + 1)))
            through = through.clamp_max(INF)
            cin = torch.cat([carry[..., None], through[..., :-1]], -1)
            carry = through[..., 31]
            run = cin
            for k in range(cells):
                run = _relax(run, vc[..., k], mc[..., k])
                out[:, :, c0:c0 + chunk].view(r, h, 32, cells)[..., k] = \
                    run.clamp_max(INF)
    out = out[:, :, :w]
    return out.flip(2) if reverse else out


def _inputs(seed, r, h, w, kind, rows=0, bands=0, tile=0):
    """d (R, H, W) int32 with sparse seeds, blocked (H, W) uint8.  ``kind``:
    random obstacles; "edges" adds obstacles on the first and last row of
    every band and segment in both scan orders, on every tile's edge
    columns and on every lane's, chunk's and segment's edge cells;
    "columns" blocks whole columns."""
    rng = np.random.default_rng(seed)
    free = rng.random((h, w)) > 0.2
    if kind == "edges":
        for step in {rows, rows * bands} - {0}:
            for y in range(0, h, step):
                for yy in (y, y - 1, h - 1 - y, h - y):
                    if 0 <= yy < h:
                        free[yy, rng.integers(w, size=max(1, w // 3))] = False
        for step in {tile, 4, 32, 128, 1024} - {0}:
            for x in range(0, w, step):
                for xx in (x, x - 1, w - 1 - x, w - x):
                    if 0 <= xx < w:
                        free[rng.integers(h, size=max(1, h // 3)), xx] = False
    elif kind == "columns":
        free[:, 1::5] = False
        free[:, 2::5] = True
        free[1::7, :] = True  # and whole free rows through the blocked ones
    d = np.where(rng.random((r, h, w)) > 0.97, rng.integers(0, 60, (r, h, w)),
                 INF)
    d = np.where(free[None], d, INF).astype(np.int32)
    return torch.from_numpy(d), torch.from_numpy((~free).astype(np.uint8))


def _plain(d, blocked, axis, reverse):
    return sweep_kernel.sweep_plain(d, blocked, axis, reverse).numpy()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("r,h,w,layout", [
    # the path layouts at their own H, on a narrow slice of columns
    (1, 1024, 40, PATH_LAYOUTS[(4, 1024, 1024)]),
    (1, 512, 37, PATH_LAYOUTS[(4, 512, 512)]),
    (1, 512, 33, PATH_LAYOUTS[(128, 512, 512)]),
    (2, 256, 20, PATH_LAYOUTS[(4, 256, 256)]),
    (1, 256, 33, PATH_LAYOUTS[(64, 256, 256)]),
    (2, 1024, 40, PATH_LAYOUTS[(64, 1024, 1024)]),
    # ragged: H one past a whole segment, H not a multiple of the band,
    # H under the bands (padding bands), H = 1, four segments of 16 bands,
    # one band of one column a thread (the whole column in steps of 8)
    (1, 1025, 9, (32, 16, 32)),
    (2, 37, 11, (8, 8, 8)),
    (2, 5, 19, (8, 8, 4)),
    (3, 1, 7, (32, 8, 1)),
    (1, 1024, 17, (32, 16, 16)),
    (2, 300, 5, (32, 8, 1)),
])
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_band_split_along_h_equals_the_plain_sweep(reverse, r, h, w, layout,
                                                   kind):
    tile, rows, bands = layout
    d, blocked = _inputs(h + w + reverse, r, h, w, kind, rows, bands, tile)
    got = emulate_along_h(d, blocked, reverse, tile, rows, bands)
    np.testing.assert_array_equal(got.numpy(), _plain(d, blocked, 1, reverse))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("w,cells", [
    # the layout the kernel takes at each W (4 cells a lane where
    # W % 4 == 0), and the scalar one it takes on unaligned tensors
    (1, 1), (3, 1), (33, 1), (256, 4), (1023, 1), (4096, 4), (4100, 4),
    (4096, 1), (1000, 4), (300, 1)])
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_row_segments_along_w_equal_the_plain_sweep(reverse, w, cells, kind):
    r, h = (2, 3) if w < 4096 else (1, 2)
    d, blocked = _inputs(w + reverse, r, h, w, kind)
    got = emulate_along_w(d, blocked, reverse, cells)
    np.testing.assert_array_equal(got.numpy(), _plain(d, blocked, 2, reverse))


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
def test_whole_blocked_columns_and_rows(axis, reverse):
    """Blocked columns cut every band at every row along W; free rows cross
    them; along H, whole columns are one obstacle from end to end."""
    d, blocked = _inputs(3 + axis + reverse, 2, 64, 300, "columns")
    if axis == 1:
        got = emulate_along_h(d, blocked, reverse, 8, 8, 4)
    else:
        got = emulate_along_w(d, blocked, reverse, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  _plain(d, blocked, axis, reverse))


@pytest.fixture
def _interpret_mode():
    sweep_pallas.INTERPRET = True
    yield
    sweep_pallas.INTERPRET = False


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
def test_emulations_match_the_pallas_kernels(_interpret_mode, axis, reverse):
    """On a shape both Pallas kernels take (H and W multiples of 128): the
    emulated decomposition at the 256^2 in-step layout along H, and the row
    segments along W, against the JAX package's kernel dispatcher."""
    d, blocked = _inputs(50 + axis * 2 + reverse, 2, 256, 128, "edges",
                         16, 16, 8)
    free = jnp.asarray(blocked.numpy() == 0)
    pal = np.asarray(sweep_pallas.sweep(jnp.asarray(d.numpy()), free, axis,
                                        reverse))
    if axis == 1:
        got = emulate_along_h(d, blocked, reverse,
                              *PATH_LAYOUTS[(4, 256, 256)])
    else:
        got = emulate_along_w(d, blocked, reverse, 4)
    np.testing.assert_array_equal(got.numpy(), pal)
