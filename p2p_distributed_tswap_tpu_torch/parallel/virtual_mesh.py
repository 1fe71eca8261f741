"""Virtual meshes: every shard of a mesh on one device.

The counterpart of the JAX package's ``force_virtual_cpu_devices`` and
``pin_cpu_backend``, which split the host into N virtual CPU devices for
XLA.  A PyTorch process needs no environment for that: a caller asks for a
virtual mesh by name, and each shard still holds its own blocks, runs its
own sweeps and exchanges its halo rows and contributions as on a mesh of
real devices, only the copies stay on one device.  The CPU tests run the
multi-device layers on ``virtual_devices(n, "cpu")``; on a machine with one
card, ``virtual_devices(n, "cuda:0")`` measures what the mesh costs there
(extra launches, copies and syncs), not how it scales.
"""

from __future__ import annotations

from typing import List

import torch


def virtual_devices(n: int, device="cpu") -> List[torch.device]:
    """``n`` shards on ``device`` (``cpu`` or ``cuda:0``), for the
    ``devices`` argument of the mesh constructors."""
    if n < 1:
        raise ValueError("a mesh has at least one shard")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return [dev] * n
