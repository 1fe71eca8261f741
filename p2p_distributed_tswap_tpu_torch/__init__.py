"""p2p_distributed_tswap_tpu_torch — the PyTorch / CUDA port of
``p2p_distributed_tswap_tpu`` for an NVIDIA H100.

It mirrors the JAX package's layout module for module and is held against
it bit for bit (the solver is integer math end to end).  It imports torch,
numpy and scipy, never jax, and keeps its own copies of the JAX-free modules
it needs.

Package layout
--------------
- ``core``     — grids, tasks, sampling, agent enums, ``SolverConfig``
- ``models``   — the benchmark scenario ladder
- ``ops``      — BFS distance / direction fields; ``sweep_kernel`` binds the
  hand-written CUDA sweep in ``csrc/sweep_scan.cu``
- ``solver``   — the TSWAP step, invariants and the offline MAPD loop
- ``convert``  — carries a solve state across to and from the JAX package
- ``hostsync`` — counted device-to-host reads
"""

__version__ = "0.1.0"
