from p2p_distributed_tswap_tpu_torch.core.grid import Grid, DEFAULT_MAP_ASCII
from p2p_distributed_tswap_tpu_torch.core.tasks import Task, TaskGenerator
from p2p_distributed_tswap_tpu_torch.core.agent import AgentPhase, AgentState
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig

__all__ = [
    "Grid",
    "DEFAULT_MAP_ASCII",
    "Task",
    "TaskGenerator",
    "AgentPhase",
    "AgentState",
    "SolverConfig",
]
