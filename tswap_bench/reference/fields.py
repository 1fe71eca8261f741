"""Plain reference for the distance fields and direction codes.

Exact shortest-path distances on the 4-connected grid from every cell to a
goal, and the next-hop direction code of every cell, written from the
definition in plain PyTorch: no kernel, no code of the program.

Distances: fast sweeping.  A round relaxes the whole batch along +x, -x,
+y and -y; rounds repeat until nothing changes, and the fixpoint is the BFS
distance.  Each directional relax is one ``torch.cummin`` over int64 keys
that carry the free segment of the row (or column) in their high bits, so
that no minimum crosses an obstacle.  ``INF`` (2^30) marks obstacles and
cells the goal does not reach.

Codes: in the order ``(dx, dy)`` = (0, 1), (1, 0), (0, -1), (-1, 0), the
first neighbour whose distance is the least of the four, if that is less
than the cell's own; else 4 (stay): at the goal, on an obstacle, where the
goal is unreachable.
"""

from __future__ import annotations

import torch

INF = 1 << 30
STAY = 4
# (dx, dy) per direction code
DIRS = ((0, 1), (1, 0), (0, -1), (-1, 0))
_SEG = 1 << 32  # > any key of one segment: keys are in [-W, 2 * INF]


def _relax(d: torch.Tensor, free: torch.Tensor, axis: int,
           reverse: bool) -> torch.Tensor:
    """d[i] = min(d[i], min over j before i in its free run of d[j] + |i-j|),
    along ``axis`` of the (B, H, W) int64 batch ``d``; ``free`` is (H, W)."""
    if reverse:
        d, free = d.flip(axis), free.flip(axis - 1)
    n = d.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    pos = torch.arange(n, device=d.device, dtype=torch.int64).reshape(shape)
    # runs counted from the end of the axis, so an earlier run's keys are
    # larger than a later one's and never win its minimum
    blocked = (~free).to(torch.int64)[None]
    run = blocked.flip(axis).cumsum(axis).flip(axis)
    key = torch.where(blocked.bool(), 2 * INF, d - pos) + run * _SEG
    best = key.cummin(axis).values - run * _SEG + pos
    out = torch.where(blocked.bool(), INF, torch.minimum(d, best))
    out = out.clamp_max(INF)
    return out.flip(axis) if reverse else out


def distances(free: torch.Tensor, goals: torch.Tensor,
              max_rounds: int = 4096) -> torch.Tensor:
    """(B, H, W) int32 distances from every cell to each of the (B,) flat
    goal cells; INF at obstacles and unreachable cells."""
    h, w = free.shape
    b = goals.shape[0]
    flat = torch.full((b, h * w), INF, dtype=torch.int64, device=free.device)
    rows = torch.arange(b, device=free.device)
    on_free = free.reshape(-1)[goals.long()]
    flat[rows[on_free], goals.long()[on_free]] = 0
    d = flat.reshape(b, h, w)
    for _ in range(max_rounds):
        nd = d
        for axis, reverse in ((2, False), (2, True), (1, False), (1, True)):
            nd = _relax(nd, free, axis, reverse)
        if torch.equal(nd, d):
            return d.to(torch.int32)
        d = nd
    raise RuntimeError("reference fields: no fixpoint")


def codes(dist: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 direction codes of the (B, H, W) distances."""
    h, w = dist.shape[-2:]
    # every value of either dtype is exact in float64
    d = dist.to(torch.float64)
    big = float("inf")
    pad = torch.nn.functional.pad(d, (1, 1, 1, 1), value=big)
    best = torch.full(d.shape, STAY, dtype=torch.uint8, device=d.device)
    best_val = torch.full_like(d, big)
    for k, (dx, dy) in enumerate(DIRS):
        nv = pad[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        take = nv < best_val
        best = torch.where(take, k, best)
        best_val = torch.where(take, nv, best_val)
    stay = (d == 0) | (d >= INF) | (best_val >= d) | ~free
    return torch.where(stay, STAY, best).to(torch.uint8)


def unpack(words: torch.Tensor, num_cells: int) -> torch.Tensor:
    """(B, num_cells) uint8 codes from (B, ceil(num_cells / 8)) int32 rows
    that hold cell ``8j + l`` in bits ``4l .. 4l + 3`` of word ``j``."""
    w = words.to(torch.int64)
    shifts = torch.arange(8, device=w.device, dtype=torch.int64) * 4
    nib = (w[..., None] >> shifts) & 0xF
    return nib.reshape(*w.shape[:-1], -1)[..., :num_cells].to(torch.uint8)


def next_cell(cell: torch.Tensor, code: torch.Tensor,
              width: int) -> torch.Tensor:
    """The cell a direction code leads to from flat ``cell``."""
    dx = torch.tensor([d[0] for d in DIRS] + [0], device=cell.device)
    dy = torch.tensor([d[1] for d in DIRS] + [0], device=cell.device)
    c = code.long()
    return cell.long() + dy[c] * width + dx[c]
