"""Carry a MAPD solve state across between the JAX package and the port.

The JAX package's ``MapdState`` crosses as a dict of numpy arrays, one per
field (``np.asarray`` of each), under the same field names.  The only field
whose type differs is ``dirs``: uint32 words there, int32 words here, with
the same bits (see ``ops.distance.pack_directions``), so it is reinterpreted
with ``.view`` both ways.
"""

from __future__ import annotations

import dataclasses
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
