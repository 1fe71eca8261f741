"""Counted device-to-host reads.

The JAX package runs every data-dependent loop of the solve (the sweep
fixpoint, the assignment rounds, the replan drain, the movement fixpoint, the
termination test) as a ``lax.while_loop`` or ``lax.cond`` on the device.
Eager PyTorch decides each of those on the host, so each decision waits for
the device.  Every such read goes through :func:`flag`, which counts it, so a
run can report its host syncs per step.
"""

from __future__ import annotations

import torch

# Device-to-host reads since the last reset (callers reset it to 0).
count = 0


def flag(t: torch.Tensor) -> bool:
    """``bool(t)`` for a one-element tensor, counted as one host sync."""
    global count
    count += 1
    return bool(t)


def values(t: torch.Tensor) -> list:
    """``t.tolist()`` for a small tensor (one flag or count per shard):
    one device-to-host read, counted as one host sync however many values
    it carries."""
    global count
    count += 1
    return t.tolist()
