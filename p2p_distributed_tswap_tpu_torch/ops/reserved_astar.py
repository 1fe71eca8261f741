"""Batched space-time shortest paths under node/edge reservations.

Counterpart of the JAX package's ``ops/reserved_astar.py``, with the same
results bit for bit: paths, arrival times and reservation tables, the
tie-break included.  It is the reference's ``astar_with_reservation``
(src/algorithm/a_star.rs:32-112), the prioritized-planning primitive: a
shortest path on the 4-connected grid from start to goal, allowed to WAIT in
place, where a shared reservation table forbids being at a cell at a time
(node reservation) or crossing an edge at a time (edge reservation).

The whole batch is solved at once by **time-expanded breadth-first
wavefronts**: ``reach`` is a dense ``(B, H, W)`` boolean layer, and one step
of a loop over arrival times expands it with five shifted and masked AND-OR
updates (4 moves + WAIT).  Unit edge costs make layer-order expansion exact:
the first layer in which the goal lights up is the optimal arrival time.
Each step records a parent-direction layer, and a loop over those layers in
reverse reconstructs every path.  Both loops are PyTorch tensor code on the
inputs' device; nothing leaves it but the loop counts (the JAX package runs
them as ``lax.scan``; it has no Pallas kernel here, and neither does the
port).

Blocking semantics match the reference (a_star.rs:80-96), including its
quirk that a move out of ``pos`` is also blocked when ``pos`` itself is
node-reserved at the arrival time (the ``node_res.contains(&(pos,
next_time))`` arm of a_star.rs:90).

Reservations are dense time-major boolean tables shared by the whole batch:

* ``node_res``: ``(T+1, H*W)`` — cell occupied at absolute time ``t``.
* ``edge_res``: ``(T+1, H*W, 4)`` — directed edge ``cell -> cell+DIR_DXDY[d]``
  crossed arriving at absolute time ``t``.  Either direction of an edge
  blocks both (the reference's symmetric check).

Ties between equal-length paths prefer DIR_DXDY order, then WAIT: the first
candidate that reaches a cell is its parent (the reference's heap order
differs; arrival times are identical).

Memory: a call holds the parent layers, ``(T - start_time, B, H*W)`` uint8
(at B = 64 on 256² with T = 512 that is 2.1 GB), plus a few ``(B, H, W)``
layers of the wavefront and the caller's tables, ``(T+1) * H*W * 5`` bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch.device import resolve_device
from p2p_distributed_tswap_tpu_torch.ops.distance import DIR_DXDY, DIR_STAY

NO_PARENT = 0xF
# opposite direction code under DIR_DXDY's (0,1),(1,0),(0,-1),(-1,0) order
OPP = (2, 3, 0, 1)

_I32 = torch.int32


def _device(device, *tensors) -> torch.device:
    """``device`` if named; else the device of the first tensor given; else
    the card (raising without CUDA)."""
    if device is None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                return t.device
    return resolve_device(device)


def _as(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def empty_reservations(horizon: int, num_cells: int, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-clear ``(node_res, edge_res)`` tables for absolute times
    ``0..horizon`` (the reference's two empty HashSets), on ``cuda`` unless
    ``device`` names another."""
    dev = _device(device)
    return (torch.zeros((horizon + 1, num_cells), dtype=torch.bool,
                        device=dev),
            torch.zeros((horizon + 1, num_cells, 4), dtype=torch.bool,
                        device=dev))


def _shift(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Value of ``a`` at (x-dx, y-dy): a True source cell lights up the cell
    it moves into.  Off-grid sources read as False."""
    out = torch.zeros_like(a)
    h, w = a.shape[-2], a.shape[-1]
    ys = (slice(dy, h), slice(0, h - dy)) if dy >= 0 else \
        (slice(0, h + dy), slice(-dy, h))
    xs = (slice(dx, w), slice(0, w - dx)) if dx >= 0 else \
        (slice(0, w + dx), slice(-dx, w))
    out[..., ys[0], xs[0]] = a[..., ys[1], xs[1]]
    return out


def reserved_astar(free, starts, goals, node_res, edge_res,
                   start_time: int = 0, device=None):
    """Batched reserved space-time shortest paths (ref a_star.rs:32-112).

    Args:
      free: (H, W) bool, True where traversable (numpy or tensor).
      starts: (B,) int32 flat start cells (occupied from ``start_time``).
      goals: (B,) int32 flat goal cells.
      node_res: (T+1, H*W) bool — cell reserved at absolute time t.
      edge_res: (T+1, H*W, 4) bool — directed edge reserved at arrival time
        t (symmetric blocking applied internally).
      start_time: absolute time the agents sit on ``starts``; the search
        runs over arrival times ``start_time+1 .. T``.
      device: where to run; by default the device of ``node_res`` (the card
        when it is not a tensor).

    Returns:
      ``(paths, arrival)`` — paths (B, T+1) int32 flat cells: ``paths[b, t]``
      is agent b's cell at absolute time t (start before/at ``start_time``,
      goal held after arrival); arrival (B,) int32 absolute arrival times,
      ``-1`` where the goal is unreachable within the table horizon.
    """
    dev = _device(device, node_res, edge_res, free)
    free = _as(free, torch.bool, dev)
    starts = _as(starts, _I32, dev).reshape(-1)
    goals = _as(goals, _I32, dev).reshape(-1)
    node_res = _as(node_res, torch.bool, dev)
    edge_res = _as(edge_res, torch.bool, dev)
    h, w = free.shape
    hw = h * w
    horizon = node_res.shape[0] - 1
    nsteps = horizon - start_time
    b = starts.shape[0]

    if nsteps <= 0:
        # Degenerate horizon: no move can be searched.  Agents already on
        # their goal are trivially done (arrival = start_time, ref :53 pop);
        # everyone else is unreachable within the table.  Shapes stay
        # (B, horizon+1) like the searched case.
        arrival = torch.where(starts == goals,
                              torch.tensor(start_time, dtype=_I32, device=dev),
                              torch.tensor(-1, dtype=_I32, device=dev))
        paths = starts[:, None].expand(b, horizon + 1).clone()
        return paths, arrival

    node_g = node_res.reshape(horizon + 1, h, w)
    edge_g = edge_res.reshape(horizon + 1, h, w, 4)
    cell = torch.arange(hw, dtype=_I32, device=dev).reshape(1, h, w)
    reach = (cell == starts.reshape(b, 1, 1)) & free[None]
    parents = torch.empty((nsteps, b, hw), dtype=torch.uint8, device=dev)
    no_parent = torch.tensor(NO_PARENT, dtype=torch.uint8, device=dev)
    codes = [torch.tensor(d, dtype=torch.uint8, device=dev)
             for d in range(DIR_STAY + 1)]
    for i in range(nsteps):
        t = start_time + 1 + i
        node_t = node_g[t][None]                     # (1, H, W)
        edge_t = edge_g[t]                           # (H, W, 4)
        open_t = free[None] & ~node_t
        # a_star.rs:90 — both the target AND the source cell must be free
        # of node reservations at the arrival time
        can_leave = reach & ~node_t
        cands = []
        for d, (dx, dy) in enumerate(DIR_DXDY):
            src_ok = can_leave & ~edge_t[None, :, :, d]       # (pos->np, t)
            arr = _shift(src_ok, dx, dy) & ~edge_t[None, :, :, OPP[d]]
            cands.append(arr & open_t)
        cands.append(can_leave & free[None])                  # WAIT
        # the parent is the FIRST candidate that reaches the cell (the JAX
        # argmax over the stacked bools); NO_PARENT where none does
        parent = no_parent.expand(b, h, w)
        reach = cands[DIR_STAY]
        for d in range(DIR_STAY, -1, -1):
            parent = torch.where(cands[d], codes[d], parent)
            if d < DIR_STAY:
                reach = reach | cands[d]
        parents[i] = parent.reshape(b, hw)

    bidx = torch.arange(b, device=dev)
    at_goal = parents[:, bidx, goals.long()] != NO_PARENT       # (nsteps, B)
    trivially_done = starts == goals                             # ref :53 pop
    any_arrival = at_goal.any(dim=0) | trivially_done
    steps = torch.arange(nsteps, dtype=_I32, device=dev)[:, None]
    first = torch.where(at_goal, steps,
                        torch.tensor(nsteps, dtype=_I32, device=dev)
                        ).amin(dim=0)                            # first True
    arrival = torch.where(
        trivially_done, torch.tensor(start_time, dtype=_I32, device=dev),
        torch.where(any_arrival, start_time + 1 + first,
                    torch.tensor(-1, dtype=_I32, device=dev))).to(_I32)

    # Reverse walk: carry the current cell; before arrival the carry follows
    # parent pointers, after it the path holds the goal, and unreachable
    # agents just sit on start.
    dxs = torch.tensor([d[0] for d in DIR_DXDY] + [0], dtype=_I32,
                       device=dev)
    dys = torch.tensor([d[1] for d in DIR_DXDY] + [0], dtype=_I32,
                       device=dev)
    reached = arrival >= 0
    rest = torch.where(reached, goals, starts)
    cur = rest
    tail = torch.empty((nsteps, b), dtype=_I32, device=dev)
    for i in range(nsteps - 1, -1, -1):
        t_abs = start_time + 1 + i
        on_path = reached & (t_abs <= arrival)
        here = torch.where(on_path, cur, rest)
        tail[i] = torch.where(reached & (t_abs > arrival), goals, here)
        p = torch.clamp(parents[i, bidx, cur.long()], max=DIR_STAY).long()
        prev = cur - dys[p] * w - dxs[p]
        cur = torch.where(on_path, prev, cur)
    head = starts[None, :].expand(start_time + 1, b)
    return torch.cat([head, tail], dim=0).T.contiguous(), arrival


def _direction_codes(path: torch.Tensor, width: int) -> torch.Tensor:
    """The direction code of each step of ``path`` (DIR_STAY for a wait):
    the signed flat delta matched against DIR_DXDY, the last match
    winning as in the JAX chain of ``where``s."""
    move = path[1:] - path[:-1]
    codes = torch.full_like(move, DIR_STAY)
    for d, (dx, dy) in enumerate(DIR_DXDY):
        codes = torch.where(move == dy * width + dx,
                            torch.tensor(d, dtype=codes.dtype,
                                         device=codes.device), codes)
    return codes


def _reserve_path_(node_res: torch.Tensor, edge_res: torch.Tensor,
                   path: torch.Tensor, width: int) -> None:
    """:func:`reserve_path` in place."""
    horizon = node_res.shape[0] - 1
    t = torch.arange(horizon + 1, device=node_res.device)
    node_res[t, path.long()] = True
    codes = _direction_codes(path, width)
    valid = codes != DIR_STAY
    # The JAX table takes ``.at[...].max(valid)``, which sends every wait to
    # the slot (t=0, cell 0, dir 0) with False and leaves what is there:
    # only the moves are written here, so that slot keeps its value too.
    edge_res[t[1:][valid], path[:-1].long()[valid],
             codes.long()[valid]] = True


def reserve_path(node_res, edge_res, path, arrival, width: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one agent's path into the reservation tables (what the
    reference's caller would do between sequential ``astar_with_reservation``
    calls): node-reserve ``path[t]`` for every t up to the horizon (the agent
    keeps occupying its goal — a parked agent is a permanent node
    reservation), and edge-reserve each traversal arriving at time t.
    Returns new tables; the ones given are left as they were.

    Args:
      node_res/edge_res: tables as in :func:`reserved_astar`.
      path: (T+1,) int32 flat cells for absolute times 0..T.
      arrival: ignored beyond documentation; the whole row is reserved since
        the path already holds start/goal outside the motion.
      width: grid width (direction decoding).
    """
    dev = _device(None, node_res, edge_res, path)
    node_res = _as(node_res, torch.bool, dev).clone()
    edge_res = _as(edge_res, torch.bool, dev).clone()
    _reserve_path_(node_res, edge_res, _as(path, _I32, dev).reshape(-1),
                   width)
    return node_res, edge_res


def plan_prioritized(free, starts, goals, horizon: int, device=None):
    """Sequential prioritized planning on top of the batched primitive:
    plan agents in index order, each reserving its path for the next.
    Returns ``(paths (B, T+1), arrival (B,))`` on the device it ran on; an
    agent that cannot reach its goal under the accumulated reservations
    gets arrival ``-1`` and parks on its start (which stays reserved).

    Takes numpy arrays or tensors and runs on ``cuda`` unless ``device``
    names another (raising without CUDA).  A host loop of one single-agent
    solve per agent — a validation tool, not the production path (that is
    the reservation-free TSWAP step, solver/step.py).
    """
    dev = _device(device)
    free = _as(free, torch.bool, dev)
    starts = _as(starts, _I32, dev).reshape(-1)
    goals = _as(goals, _I32, dev).reshape(-1)
    h, w = free.shape
    node_res, edge_res = empty_reservations(horizon, h * w, device=dev)
    paths, arrivals = [], []
    for i in range(int(starts.shape[0])):
        p, a = reserved_astar(free, starts[i:i + 1], goals[i:i + 1],
                              node_res, edge_res)
        path = torch.where(a[0] >= 0, p[0], starts[i].expand_as(p[0]))
        _reserve_path_(node_res, edge_res, path, w)
        paths.append(path)
        arrivals.append(a[0])
    return torch.stack(paths), torch.stack(arrivals)
