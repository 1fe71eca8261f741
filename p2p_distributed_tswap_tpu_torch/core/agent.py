"""Agent state enums.

Mirrors the reference's two state vocabularies:
- path-recording states PICKING/CARRYING/DELIVERED/IDLE (src/map/agent.rs:9-15)
- the task-lifecycle machine Idle -> MovingToPickup -> MovingToDelivery used by
  both the offline solver (src/algorithm/tswap.rs:83-88) and the decentralized
  agent (src/bin/decentralized/agent.rs:81-88).

Values are small ints so they live in int8/int32 device arrays.
"""

from __future__ import annotations

import enum


class AgentPhase(enum.IntEnum):
    """Task-lifecycle phase (device-resident as int8)."""

    IDLE = 0
    TO_PICKUP = 1
    TO_DELIVERY = 2


class AgentState(enum.IntEnum):
    """Per-timestep recorded state, reference src/map/agent.rs:9-15 and the
    mapping at src/algorithm/tswap.rs:146-156."""

    IDLE = 0
    PICKING = 1
    CARRYING = 2
    DELIVERED = 3
