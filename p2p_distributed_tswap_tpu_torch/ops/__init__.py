"""Batched grid ops of the port: BFS distance/direction fields and their
CUDA sweep kernel, the fused field kernel, their grid-tile-sharded
variants (spatial decomposition with a halo exchange), bounded-region
incremental field repair for dynamic worlds (field_repair), the sector
planner, and reserved space-time A* (the prioritized-planning primitive,
ref src/algorithm/a_star.rs).  The package exports the names the JAX
package's ``ops`` exports."""

from p2p_distributed_tswap_tpu_torch.ops import distance
from p2p_distributed_tswap_tpu_torch.ops import field_repair  # noqa: F401
from p2p_distributed_tswap_tpu_torch.ops.field_repair import (  # noqa: F401
    repair_field,
)
from p2p_distributed_tswap_tpu_torch.ops.distance import (  # noqa: F401
    direction_fields,
    directions_from_distance,
    distance_fields,
    gather_packed,
    pack_directions,
)
from p2p_distributed_tswap_tpu_torch.ops.tiled_distance import (  # noqa: F401
    tiled_direction_fields,
    tiled_distance_fields,
)
from p2p_distributed_tswap_tpu_torch.ops.reserved_astar import (  # noqa: F401
    empty_reservations,
    plan_prioritized,
    reserve_path,
    reserved_astar,
)
