"""The control of the correctness check: the reference's field computation
put in the program's place, with the distance field held in bfloat16.

The configuration states exact int32 distances.  A 16-bit integer holds
every distance at these sizes (the longest is 2 046 cells, on the
1024x1024 warehouse), and so does float16 (every integer to 2 048); the
16-bit type that a change halving a field's bytes could pick and that
breaks them is bfloat16, which holds every integer only to 256.  Past
that, neighbouring distances round to one value and the codes go wrong,
which the check has to catch.
"""

from __future__ import annotations

import torch

from tswap_bench.reference import fields


def direction_fields(free: torch.Tensor, goals_idx: torch.Tensor,
                     max_rounds: int = 128) -> torch.Tensor:
    """(G, H, W) uint8 codes toward each goal, from the exact distances
    rounded to bfloat16: the signature of the program's
    ``ops.distance.direction_fields``."""
    dist = fields.distances(free, goals_idx).to(torch.bfloat16)
    return fields.codes(dist, free)
