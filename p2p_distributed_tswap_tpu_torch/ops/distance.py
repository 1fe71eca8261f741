"""Exact BFS distance / direction fields, batched over goals.

Counterpart of the JAX package's ``ops/distance.py``, with the same integer
results.  On an unweighted 4-connected grid the shortest-path next hop is
descent of the BFS distance-to-goal field, so exact distance fields are
computed for a batch of goals at once and turned into dense next-hop
direction fields, nibble-packed into int32 words.

Algorithm: fast sweeping.  One round = 4 directional sweeps (+x, -x, +y, -y),
each a segmented min-plus scan along rows or columns with obstacle cells
breaking the segments (``ops.sweep_kernel``: the CUDA kernel on the card, the
doubling scan on the CPU).  Rounds repeat until the fields stop changing; the
fixpoint is the exact BFS distance.  Each round ends in one host sync
(``hostsync.flag``) where the JAX package's ``lax.while_loop`` tested on the
device.

Directions follow the reference's neighbor order ``[(0,1),(1,0),(0,-1),(-1,0)]``
as (dx, dy), with first-minimum tie-breaking; code 4 = stay (at goal /
unreachable).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel
from p2p_distributed_tswap_tpu_torch.ops.sweep_kernel import INF

# (dx, dy) in the reference's neighbor order; index = direction code.
DIR_DXDY = ((0, 1), (1, 0), (0, -1), (-1, 0))
DIR_STAY = 4
# Packed rows: 8 nibble codes per int32 word; PACKED_STAY is one word of
# 8 DIR_STAY nibbles (0x44444444 < 2^31, so it is a positive int32).
PACKED_LANES = 8
PACKED_STAY = sum(DIR_STAY << (4 * i) for i in range(PACKED_LANES))

# Sweep rounds and batches of :func:`_fixpoint` since the last reset
# (callers reset them to 0): each round is one host sync.
fixpoint_rounds = 0
fixpoint_batches = 0


def _sweep(d: torch.Tensor, blocked: torch.Tensor, axis: int,
           reverse: bool) -> torch.Tensor:
    """One directional sweep of the (R, H, W) int32 batch ``d`` against the
    uint8 mask ``blocked`` (nonzero = obstacle; (H, W) shared by every
    field, or (R, H, W) one per field), along ``axis`` (1 = H, 2 = W): the
    CUDA kernel for a CUDA tensor, the plain doubling scan (the JAX
    package's ``_seg_min_scan`` + ``_sweep_xla``, ported in
    ``ops.sweep_kernel``) for a CPU tensor."""
    if d.is_cuda:
        return sweep_kernel.sweep_scan(d, blocked, axis, reverse)
    if d.device.type != "cpu":
        raise ValueError(f"_sweep: unsupported device {d.device}")
    return sweep_kernel.sweep_plain(d, blocked, axis, reverse)


def _fixpoint(d: torch.Tensor, free: torch.Tensor, max_rounds: int,
              sweep=_sweep) -> torch.Tensor:
    """Sweep rounds over the (R, H, W) batch ``d`` until nothing changes (or
    ``max_rounds``), each directional sweep by ``sweep``; ``free`` is one
    (H, W) mask for every field or an (R, H, W) mask per field.  Counts
    the batch in ``fixpoint_batches`` and each round in
    ``fixpoint_rounds``."""
    global fixpoint_rounds, fixpoint_batches
    fixpoint_batches += 1
    blocked = (~free).to(torch.uint8).contiguous()
    changed, i = True, 0
    while changed and i < max_rounds:
        fixpoint_rounds += 1
        nd = sweep(d, blocked, axis=2, reverse=False)
        nd = sweep(nd, blocked, axis=2, reverse=True)
        nd = sweep(nd, blocked, axis=1, reverse=False)
        nd = sweep(nd, blocked, axis=1, reverse=True)
        changed = hostsync.flag(torch.any(nd != d))
        d, i = nd, i + 1
    return d


def window_fixpoint(seed: torch.Tensor, free_w: torch.Tensor) -> torch.Tensor:
    """Early fixpoint of the directional sweeps over a batch of windows, on
    the device of ``seed``: the counterpart of the JAX package's
    ``field_repair.window_fixpoint``, the same round order and the same cap
    of 128 rounds.

    Args:
      seed: (N, h, w) int32 window values (INF where unknown or blocked).
      free_w: (h, w) bool, one mask for every window (a repair window), or
        (N, h, w), one per window (the sector planner's padded windows).

    Returns the (N, h, w) int32 fixpoint."""
    return _fixpoint(seed, free_w, 128)


def distance_fields(free: torch.Tensor, goals_idx: torch.Tensor,
                    max_rounds: int = 128, sweep=_sweep) -> torch.Tensor:
    """Exact BFS distances from every cell to each goal.

    Args:
      free: (H, W) bool, True where traversable.
      goals_idx: (G,) int32 flat cell indices of goals.
      max_rounds: safety cap on sweep rounds.
      sweep: the directional sweep; the default picks the kernel or the
        plain version by device, ``ops.field_fused`` passes the plain one.

    Returns:
      (G, H, W) int32; INF (2^30) at obstacles and unreachable cells. A goal
      on an obstacle cell yields an all-INF field (agents then stay).
    """
    h, w = free.shape
    g = goals_idx.shape[0]
    cell = torch.arange(h * w, dtype=torch.int32,
                        device=free.device).reshape(1, h, w)
    zero = torch.zeros((), dtype=torch.int32, device=free.device)
    seed = (cell == goals_idx.reshape(g, 1, 1)) & free[None]
    return _fixpoint(torch.where(seed, zero, INF), free, max_rounds,
                     sweep)


def multi_source_field(free: torch.Tensor, sources_idx: torch.Tensor,
                       max_rounds: int = 128) -> torch.Tensor:
    """Exact BFS distance from every cell to its NEAREST source: one (H, W)
    int32 field however many sources, INF at obstacles and at cells no
    source reaches."""
    h, w = free.shape
    d0 = torch.full((h * w,), INF, dtype=torch.int32, device=free.device)
    d0[sources_idx.long()] = 0
    d0 = torch.where(free.reshape(-1), d0, INF).reshape(1, h, w)
    return _fixpoint(d0.contiguous(), free, max_rounds).reshape(h, w)


def directions_from_distance(dist: torch.Tensor,
                             free: torch.Tensor) -> torch.Tensor:
    """Next-hop direction field from a distance field.

    Args:
      dist: (..., H, W) int32 distances (INF = unreachable).
      free: (H, W) bool.

    Returns:
      (..., H, W) uint8 direction codes: 0..3 = step (dx,dy) per DIR_DXDY
      toward the goal (always strictly descends the field on reachable cells),
      4 = stay (at goal, obstacle, or unreachable).
    """
    h, w = dist.shape[-2:]
    padded = F.pad(dist, (1, 1, 1, 1), value=INF)
    # Fold over the 4 directions (first-min tie-break kept by the strict <)
    # instead of stacking them, which would hold 4 int32 copies at once.
    best = torch.full(dist.shape, DIR_STAY, dtype=torch.uint8,
                      device=dist.device)
    best_val = torch.full(dist.shape, INF, dtype=torch.int32,
                          device=dist.device)
    for k, (dx, dy) in enumerate(DIR_DXDY):
        # value of dist at (x+dx, y+dy), INF out of bounds
        nv = padded[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        better = nv < best_val
        best = torch.where(better, k, best)
        best_val = torch.minimum(best_val, nv)
    stay = ((dist == 0) | (dist >= INF) | (best_val >= INF)
            | (best_val >= dist) | ~free)
    return torch.where(stay, DIR_STAY, best).to(torch.uint8)


def direction_fields(free: torch.Tensor, goals_idx: torch.Tensor,
                     max_rounds: int = 128) -> torch.Tensor:
    """(G, H, W) uint8 next-hop directions toward each goal.

    Default path: the sweep fixpoint above, then the direction fold.  With
    ``MAPD_FUSED=1`` (or ``multi``, or ``single``) a CUDA grid of a shape
    the JAX package's gates admit runs the fused field kernel instead, one
    launch from seed to codes (``ops.field_fused``).  Every consumer -- the
    prime burst and the in-step replan -- comes through here."""
    from p2p_distributed_tswap_tpu_torch.ops import field_fused

    h, w = free.shape
    if field_fused.fused_eligible(h, w, free.device):
        return field_fused.fused_direction_fields(free, goals_idx, max_rounds)
    return directions_from_distance(
        distance_fields(free, goals_idx, max_rounds), free)


def packed_cells(num_cells: int) -> int:
    """int32 words per packed direction-field row (8 nibbles per word)."""
    return (num_cells + PACKED_LANES - 1) // PACKED_LANES


def pack_directions(fields: torch.Tensor) -> torch.Tensor:
    """Pack (..., HW) uint8 direction codes (values 0..4) into
    (..., ceil(HW/8)) int32, 8 codes per word: cell ``8j + l`` lives in
    nibble ``l`` (bits ``4l..4l+3``) of word ``j``.  Trailing cells pad with
    DIR_STAY.

    The JAX package stores these words as uint32.  Here they are int32 (the
    CPU build of PyTorch has no uint32 shifts): a code is at most 4, so the
    top nibble never sets bit 31, every word is a non-negative int32 with the
    same bits, and ``>>`` on it is exact.  ``convert.py`` reinterprets the
    bits both ways.
    """
    hw = fields.shape[-1]
    if hw % PACKED_LANES:
        fields = F.pad(fields, (0, -hw % PACKED_LANES), value=DIR_STAY)
    lanes = fields.reshape(*fields.shape[:-1], -1, PACKED_LANES)
    lanes = lanes.to(torch.int32)
    word = lanes[..., 0]
    for lane in range(1, PACKED_LANES):  # disjoint nibbles: OR == sum
        word = word | (lanes[..., lane] << (4 * lane))
    return word


def unpack_code_np(packed_row: np.ndarray, cell: int) -> int:
    """Host-side single-cell unpack of one packed direction row."""
    word = int(packed_row[cell >> 3])
    return (word >> (4 * (cell & 7))) & 0xF


def unpack_rows_np(packed: np.ndarray, num_cells: int) -> np.ndarray:
    """Host-side inverse of pack_directions for (..., pc) int32 or uint32
    rows: returns (..., num_cells) uint8 codes (pad nibbles dropped)."""
    packed = np.asarray(packed).view(np.uint32)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * PACKED_LANES,),
                   np.uint8)
    for lane in range(PACKED_LANES):
        out[..., lane::PACKED_LANES] = (packed >> np.uint32(4 * lane)) \
            & np.uint32(0xF)
    return out[..., :num_cells]


def gather_packed(packed: torch.Tensor, row: torch.Tensor,
                  pos_idx: torch.Tensor) -> torch.Tensor:
    """Direction code at flat cell ``pos_idx`` from packed row ``row``:
    one word gather plus a shift/mask per agent."""
    word = packed[row, pos_idx >> 3]
    nib = (pos_idx & 7) * 4
    return ((word >> nib) & 0xF).to(torch.uint8)


_DX = [d[0] for d in DIR_DXDY] + [0]
_DY = [d[1] for d in DIR_DXDY] + [0]


def apply_direction(pos_idx: torch.Tensor, dir_code: torch.Tensor,
                    width: int) -> torch.Tensor:
    """Next flat cell index after taking ``dir_code`` from ``pos_idx``.
    Stay (code 4) maps to the same cell.  Direction fields never point
    off-grid (off-grid neighbors are INF)."""
    dev = pos_idx.device
    code = dir_code.long()
    dx = torch.tensor(_DX, dtype=torch.int32, device=dev)[code]
    dy = torch.tensor(_DY, dtype=torch.int32, device=dev)[code]
    return pos_idx + dy * width + dx
