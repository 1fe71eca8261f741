"""Configuration system.

The reference scatters its knobs across compile-time constants, one CLI flag and
two env vars (SURVEY §5: TSWAP_RADIUS=15 at src/bin/decentralized/agent.rs:796,
planning interval 500 ms at src/bin/centralized/manager.rs:567, timestep cap
2000 at src/algorithm/tswap.rs:167, memory caps, gossipsub tunings, --clean,
TASK_CSV_PATH/PATH_CSV_PATH).  Here the solver's knobs live in one frozen
dataclass, ``SolverConfig``: it fixes the shapes and loop bounds of every
tensor program of the solve.  The port's own copy of the JAX package's
``core/config.py`` (the host-runtime ``RuntimeConfig`` is not needed by the
offline solve and is not copied).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def stale_knobs_active(visibility_radius, view_refresh_steps,
                       view_ttl_steps, swap_commit_delay) -> bool:
    """THE definition of "stale decentralized semantics engaged" — shared
    by SolverConfig.stale_mode (kernel selection) and the scenario/bench
    mode labels so the two can never disagree."""
    return visibility_radius is not None and (
        view_refresh_steps > 1 or swap_commit_delay > 0
        or view_ttl_steps is not None)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver parameters: every field fixes a shape or a loop bound."""

    height: int
    width: int
    num_agents: int
    # Offline-solver horizon cap (ref src/algorithm/tswap.rs:167).
    max_timesteps: int = 2000
    # Max direction-field recomputations processed per replan round; rounds
    # repeat until the dirty set drains. Static so replan has fixed shapes.
    replan_chunk: int = 64
    # Narrow chunk for the in-step replan loop — steady state dirties only
    # a handful of fields per step (task arrivals), and sweep cost is
    # O(chunk * H * W) per round regardless of how few rows are dirty.
    # The default 4 is the JAX package's, chosen there on a TPU; its best
    # value on a GPU has not been measured.
    replan_chunk_small: int = 4
    # Rule-4 deadlock cycles are detected exactly up to this length
    # (ref walks unbounded chains, src/algorithm/tswap.rs:204-249; cycles
    # longer than this simply wait and retry next step).
    cycle_cap: int = 32
    # Decentralized-mode visibility radius (Manhattan); None = centralized
    # global view. Ref: TSWAP_RADIUS=15, src/bin/decentralized/agent.rs:796-801.
    visibility_radius: Optional[int] = None
    # --- stale/async decentralized semantics (ref agent.rs:156-167,
    # 730-789, 1041-1087) ----------------------------------------------
    # Neighbor-view refresh period in steps (the 500 ms position-broadcast
    # cadence analog): agent i re-publishes its (pos, goal) into the shared
    # view every ``view_refresh_steps`` steps on a per-agent phase offset
    # (i mod K), so cadences are decoupled like the reference's
    # per-process timers.  1 = every step (fresh views).
    view_refresh_steps: int = 1
    # View age-out in steps (the 10 s neighbor TTL analog, ref
    # agent.rs:156-167): view entries older than this are invisible
    # (their agent effectively absent).  None = no expiry.
    view_ttl_steps: Optional[int] = None
    # Goal-swap / rotation commit latency in steps: 1 = decisions taken at
    # step t commit at the START of step t+1 — the non-atomic wire
    # coordination analog (ref agent.rs:1041-1087: both sides mutate goals
    # at message-receipt time, not decision time); 0 = atomic in-step.
    # Only {0, 1} are meaningful (the pending buffer holds ONE step of
    # in-flight exchanges); validated in __post_init__.
    swap_commit_delay: int = 0

    def __post_init__(self):
        if self.swap_commit_delay not in (0, 1):
            raise ValueError(
                f"swap_commit_delay={self.swap_commit_delay}: only 0 "
                "(atomic) or 1 (one-step wire latency) are supported")
        # Probe the knob clause of THE shared predicate with a dummy
        # radius: true means "some stale knob is non-default", which is
        # invalid without a real radius.
        if self.visibility_radius is None and stale_knobs_active(
                0, self.view_refresh_steps, self.view_ttl_steps,
                self.swap_commit_delay):
            raise ValueError(
                "stale knobs (view_refresh_steps/view_ttl_steps/"
                "swap_commit_delay) require visibility_radius: staleness is "
                "a property of the neighbor view, and without a radius the "
                "centralized fresh-atomic kernel would silently run instead")
    # Rounds of the (Rule 3, Rule 4) goal-swapping phase per step.  The
    # reference's sequential pass lets swaps cascade within one step
    # (src/algorithm/tswap.rs:180-252); extra parallel rounds approximate that.
    swap_rounds: int = 2
    # Upper bound on movement-phase cascade rounds (each round finalizes at
    # least the front of every convoy; loop exits early at fixpoint).
    max_move_rounds: int = 64
    # Fast-sweeping rounds cap for distance fields (each round = 4 directional
    # scans; fixpoint is reached much earlier on benchmark maps).
    max_sweep_rounds: int = 128
    # Record per-step (pos, state) paths (ref tswap.rs:143-158).  Costs
    # (max_timesteps+1, N) x 5 bytes of device memory — disable for pure
    # benchmark/throughput runs (VERDICT r1 weak item 3).
    record_paths: bool = True
    # Task-chunk width for the parallel assignment's nearest-unused-task
    # search: transient memory is (num_agents, assign_chunk) int32 per chunk.
    assign_chunk: int = 1024

    @property
    def num_cells(self) -> int:
        return self.height * self.width

    @property
    def stale_mode(self) -> bool:
        """True when the decentralized kernel must model stale views and/or
        asynchronous coordination (the reference's actual decentralized
        reality) instead of the fresh-atomic radius mask.  Requires a
        visibility radius: staleness is a property of the neighbor view,
        and the centralized solver has no view — it has the truth."""
        return stale_knobs_active(self.visibility_radius,
                                  self.view_refresh_steps,
                                  self.view_ttl_steps,
                                  self.swap_commit_delay)

