"""Solve-certification invariants, on the device.

Counterpart of the JAX package's ``solver/invariants.py``.  Checked per
transition ``prev_pos -> pos``: vertex-disjointness (no two agents share a
cell), unit moves (stay or a 4-neighbor step), and on-grid legality (every
agent on a free cell).  Pairwise edge exchange is deliberately NOT checked:
mutual position swaps are a sanctioned TSWAP mechanism.
"""

from __future__ import annotations

import torch

from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig


def step_invariants(cfg: SolverConfig, prev_pos: torch.Tensor,
                    pos: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """() bool tensor: True iff ``prev_pos -> pos`` is a legal collision-free
    MAPF step.  Stays on the device: fold results with ``&`` and read once."""
    n, w = cfg.num_agents, cfg.width

    sp = torch.sort(pos).values
    distinct = (torch.all(sp[1:] != sp[:-1]) if n > 1
                else torch.ones((), dtype=torch.bool, device=pos.device))

    dx = (pos % w - prev_pos % w).abs()
    dy = (pos // w - prev_pos // w).abs()
    unit = torch.all(dx + dy <= 1)

    on_free = torch.all(free.reshape(-1)[pos])

    return distinct & unit & on_free
