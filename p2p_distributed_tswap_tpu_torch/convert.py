"""Carry state across between the JAX package and the port.

- A MAPD solve: the JAX package's ``MapdState`` crosses as a dict of numpy
  arrays, one per field (``np.asarray`` of each), under the same field
  names.
- A serving daemon: :func:`runner_state` reads a ``TickRunner`` of either
  package (its ``PlanService`` and packed-wire decoder) into numpy arrays
  and plain Python values, and :func:`load_runner` puts them into the
  port's, so a request stream can be handed off mid-way.

The only type that differs is that of the packed direction words
(``dirs``): uint32 in the JAX package, int32 here, with the same bits (see
``ops.distance.pack_directions``), so they are reinterpreted with ``.view``
both ways.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch.solver.mapd import MapdState

FIELDS = tuple(f.name for f in dataclasses.fields(MapdState))


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> MapdState:
    """The port's ``MapdState`` on ``device`` from a dict of numpy arrays
    (every field of the JAX package's ``MapdState``)."""
    dev = torch.device(device)
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if name == "dirs":
            if a.dtype not in (np.uint32, np.int32):
                raise TypeError(f"dirs must be uint32 or int32, got {a.dtype}")
            a = a.view(np.int32)
        # a copy: arrays handed over from JAX are read-only views
        out[name] = torch.from_numpy(np.array(a)).to(dev)
    return MapdState(**out)


def state_to_numpy(s: MapdState) -> Dict[str, np.ndarray]:
    """A dict of numpy arrays, one per field, in the JAX package's types
    (``dirs`` as uint32)."""
    out = {name: getattr(s, name).cpu().numpy() for name in FIELDS}
    out["dirs"] = out["dirs"].view(np.uint32)
    return out


def _host(x) -> np.ndarray:
    """A host copy of a tensor of either package (a JAX array converts
    through ``np.asarray``, which needs no JAX import here)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.array(x)


def _words_u32(x) -> np.ndarray:
    return _host(x).view(np.uint32)


# Resident lanes: host mirrors and their device copies.
_LANES = ("pos", "goal", "slot", "active")


def runner_state(runner) -> dict:
    """The state of a ``TickRunner`` of either package (the single-device
    service), as numpy arrays (``dirs`` as uint32 words) and plain Python
    values: the field cache and its LRU order, the goal pins, the resident
    lanes and their host mirrors, the field queue, the parked lanes, the
    world log and the packed decoder's roster."""
    svc = runner.service
    lanes = {}
    for k in _LANES:
        lanes[f"h_{k}"] = np.array(getattr(svc, f"h_{k}"))
        d = getattr(svc, f"d_{k}")
        lanes[f"d_{k}"] = None if d is None else _host(d)
    dec = runner.packed
    return {
        "dirs": None if svc.dirs is None else _words_u32(svc.dirs),
        "goal_rows": [(int(g), int(r)) for g, r in svc.goal_rows.items()],
        "goal_ref": {int(g): int(c) for g, c in svc.goal_ref.items()},
        "r_cap": int(svc.r_cap),
        **lanes,
        "field_queue": [(int(g), e.cause, int(e.enq))
                        for g, e in svc.field_queue.items()],
        "queue_clock": int(svc.queue_clock),
        "lane_wait": {int(k): int(v) for k, v in svc.lane_wait.items()},
        "wait_lanes": {int(g): sorted(int(x) for x in v)
                       for g, v in svc.wait_lanes.items()},
        "free": np.array(svc.free_np),
        "world_seq": int(svc.world_seq),
        "world_log": [int(c) for c in svc.world_log],
        "dist_seq": {int(g): int(v) for g, v in svc.dist_seq.items()},
        "corrupt": dict(svc.corrupt),
        "defer_fields": bool(svc.defer_fields),
        "cache_hits": int(svc.cache_hits),
        "cache_misses": int(svc.cache_misses),
        "last_cap": int(svc._last_cap),
        "names": list(dec.names),
        "roster": dict(dec.state),
        "last_seq": dec.last_seq,
        "ticks": int(runner.ticks),
    }


def load_runner(runner, state: Mapping) -> None:
    """Put :func:`runner_state` output into the port's ``TickRunner``
    (whose service was built on the same grid), on its service's
    device."""
    from p2p_distributed_tswap_tpu_torch.runtime.solverd import (
        FieldQueueEntry)

    svc = runner.service
    dev = svc.device
    dirs = state["dirs"]
    svc.dirs = (None if dirs is None else torch.from_numpy(
        np.array(dirs).view(np.int32)).to(dev))
    svc.goal_rows = OrderedDict(state["goal_rows"])
    svc.goal_ref = dict(state["goal_ref"])
    svc.r_cap = state["r_cap"]
    for k in _LANES:
        setattr(svc, f"h_{k}", np.array(state[f"h_{k}"]))
        d = state[f"d_{k}"]
        setattr(svc, f"d_{k}", None if d is None
                else torch.from_numpy(np.array(d)).to(dev))
    svc.field_queue = OrderedDict(
        (g, FieldQueueEntry(cause, enq))
        for g, cause, enq in state["field_queue"])
    svc.queue_clock = state["queue_clock"]
    svc.lane_wait = dict(state["lane_wait"])
    svc.wait_lanes = {g: set(v) for g, v in state["wait_lanes"].items()}
    svc.free_np = np.array(state["free"])
    svc.free = torch.from_numpy(svc.free_np.copy()).to(dev)
    svc.world_seq = state["world_seq"]
    svc.world_log = list(state["world_log"])
    svc.dist_seq = dict(state["dist_seq"])
    svc.corrupt = dict(state["corrupt"])
    svc.defer_fields = state["defer_fields"]
    svc.cache_hits = state["cache_hits"]
    svc.cache_misses = state["cache_misses"]
    svc._last_cap = state["last_cap"]
    runner.packed.names = list(state["names"])
    runner.packed.state = dict(state["roster"])
    runner.packed.last_seq = state["last_seq"]
    runner.ticks = state["ticks"]
