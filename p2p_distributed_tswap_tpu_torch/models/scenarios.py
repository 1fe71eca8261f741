"""Benchmark scenario ladder (BASELINE.json configs).

The reference's scale axes are agent count and grid size (SURVEY §5); these
are the configs the framework is benchmarked on, from the reference's comfort
zone (tens of agents, 100x100 empty grid) to 10k agents on a 1024^2
warehouse.  The port's own copy of the JAX package's ladder: the same names,
grids, seeds and sizes."""

from __future__ import annotations

import dataclasses
from typing import Callable

from p2p_distributed_tswap_tpu_torch.core.config import (
    SolverConfig,
    stale_knobs_active,
)
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.core.sampling import start_positions_array
from p2p_distributed_tswap_tpu_torch.core.tasks import TaskGenerator


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    grid_fn: Callable[[], Grid]
    num_agents: int
    num_tasks: int
    replan_chunk: int = 64
    # None = centralized global view; 15 = the reference's decentralized
    # radius (src/bin/decentralized/agent.rs:796-801).  Same solver, masked
    # visibility inside the kernel — the TPU analog of the reference's
    # central experiment (compare_path_metrics.py:33-106).
    visibility_radius: int | None = None
    # Stale/async decentralized semantics (SolverConfig docs; the
    # reference's actual decentralized reality): neighbor-view refresh
    # period, view TTL, swap-commit latency.
    view_refresh_steps: int = 1
    view_ttl_steps: int | None = None
    swap_commit_delay: int = 0
    # Horizon (ref tswap.rs:167 default 2000); stale rungs wait more
    # rounds and get headroom so divergence shows as a longer makespan,
    # not a failed certification.
    max_timesteps: int = 2000

    def build(self, seed: int = 0):
        grid = self.grid_fn()
        starts = start_positions_array(grid, self.num_agents, seed=seed)
        tasks = TaskGenerator(grid, seed=seed + 1).generate_task_arrays(
            self.num_tasks)
        cfg = SolverConfig(height=grid.height, width=grid.width,
                           num_agents=self.num_agents,
                           max_timesteps=self.max_timesteps,
                           replan_chunk=min(self.replan_chunk, self.num_agents),
                           visibility_radius=self.visibility_radius,
                           view_refresh_steps=self.view_refresh_steps,
                           view_ttl_steps=self.view_ttl_steps,
                           swap_commit_delay=self.swap_commit_delay)
        return grid, starts, tasks, cfg

    def decentralized(self, radius: int = 15) -> "Scenario":
        """The same configuration solved under the reference's radius-15
        local-view semantics, fresh-atomic variant (suffix ``-decent``)."""
        return dataclasses.replace(self, name=f"{self.name}-decent",
                                   visibility_radius=radius)

    def stale(self, radius: int = 15, refresh: int = 2,
              ttl: int | None = None, delay: int = 1,
              horizon_factor: int = 2) -> "Scenario":
        """The decentralized configuration under the reference's ACTUAL
        semantics: views refreshed every ``refresh`` steps on decoupled
        cadences (500 ms broadcast analog) and one-step non-atomic
        goal-swap commits (suffix ``-decent-stale``).

        ``ttl`` (the 10 s cache age-out analog) defaults to None here ON
        PURPOSE: in an offline solve every agent is alive and rebroadcasts
        within ``refresh`` steps, so no entry can ever age past the TTL —
        a ttl knob on these rungs would be dead config dressed up as
        coverage.  The TTL semantics matter when agents die or mute (the
        active-mask / host-runtime case) and are pinned by
        tests/test_stale_mode.py::test_ttl_expires_unrefreshed_entries."""
        return dataclasses.replace(
            self, name=f"{self.name}-decent-stale",
            visibility_radius=radius, view_refresh_steps=refresh,
            view_ttl_steps=ttl, swap_commit_delay=delay,
            max_timesteps=self.max_timesteps * horizon_factor)

    @property
    def mode(self) -> str:
        if self.visibility_radius is None:
            return "centralized"
        base = f"decentralized-r{self.visibility_radius}"
        if stale_knobs_active(self.visibility_radius,
                              self.view_refresh_steps,
                              self.view_ttl_steps, self.swap_commit_delay):
            return (f"{base}-stale(k={self.view_refresh_steps},"
                    f"ttl={self.view_ttl_steps},"
                    f"delay={self.swap_commit_delay})")
        return base


# BASELINE.json config ladder
REFERENCE_DEMO = Scenario(          # the reference's comfortable envelope
    "ref-50x100x100", Grid.default, 50, 50, replan_chunk=50)
SMALL = Scenario(
    "100a-256-obstacles", lambda: Grid.random_obstacles(256, 256, 0.1, seed=0),
    100, 100)
MEDIUM = Scenario(
    "1k-512", lambda: Grid.random_obstacles(512, 512, 0.1, seed=0), 1000, 1000,
    replan_chunk=128)
FLAGSHIP = Scenario(                # north-star config: 10k agents, 1024^2
    # replan_chunk 64: transient replan memory is O(chunk * H * W) int32
    # beside the persistent 5.25 GB of packed fields.
    "10k-1024-warehouse", lambda: Grid.warehouse(1024, 1024), 10_000, 10_000,
    replan_chunk=64)
# The 4096^2 rungs are not copied yet: EXTREME_LITE and EXTREME_LITE_FULL
# (512 agents on one device) wait for ROADMAP queue 1 item 10, and EXTREME
# (100k agents, about 800 GB of packed rows) for item 7, the multi-device
# layers.  The chunked host prime they use is already here
# (``solver/mapd.py`` ``prime_fields``).

LADDER = [REFERENCE_DEMO, SMALL, MEDIUM, FLAGSHIP]

# Decentralized (radius-15) counterparts for the cent-vs-decent table —
# the reference's core experiment at TPU scale (VERDICT r2 missing item 2).
REFERENCE_DEMO_DECENT = REFERENCE_DEMO.decentralized()
MEDIUM_DECENT = MEDIUM.decentralized()
FLAGSHIP_DECENT = FLAGSHIP.decentralized()

# Stale/async counterparts (VERDICT r3 missing item 1): the reference's
# decentralized agents act on views up to 10 s old and commit swaps
# non-atomically; these rungs carry that reality at TPU scale.
REFERENCE_DEMO_DECENT_STALE = REFERENCE_DEMO.stale()
MEDIUM_DECENT_STALE = MEDIUM.stale()
FLAGSHIP_DECENT_STALE = FLAGSHIP.stale()

# Congestion config (VERDICT r3 missing item 2): dense enough that the
# radius mask and staleness actually bite — the rung where centralized vs
# decentralized OUTCOMES diverge, not just step cost.  3k agents on a
# 256^2 warehouse ≈ 6% of free cells occupied (the flagship sits at ~1.3%).
CONGESTED = Scenario(
    "3k-256-congested", lambda: Grid.warehouse(256, 256), 3000, 3000,
    replan_chunk=64, max_timesteps=4000)
CONGESTED_DECENT = CONGESTED.decentralized()
CONGESTED_DECENT_STALE = CONGESTED.stale()
