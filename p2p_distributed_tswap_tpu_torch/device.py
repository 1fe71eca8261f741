"""The device a solve, a planner or a daemon runs on.

A leaf of the package: it imports only ``torch``, so every module, the
``ops`` package's submodules included, can import it at its top without an
import cycle through ``solver.mapd`` (which imports ``ops``)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: ``cuda`` unless the caller names another.
    Raises when CUDA is asked for (or defaulted to) and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the solve runs on the card unless the "
            "caller passes device='cpu'")
    return dev
