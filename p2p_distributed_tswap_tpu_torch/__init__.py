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
  hand-written CUDA sweep in ``csrc/sweep_scan.cu``, ``field_fused`` the
  fused field kernel; ``field_repair`` (bounded-region repair of a field
  after world toggles) and ``sector`` (the hierarchical sector planner)
- ``solver``   — the TSWAP step (with its ``active`` lane mask), invariants,
  the offline MAPD loop and checkpoints
- ``runtime``  — ``solverd``, the serving daemon (single- and
  multi-tenant) behind the C++ manager's ``--solver=tpu``, and copies of the JAX package's
  JAX-free wire and bus modules (``plan_codec``, ``bus_client``, ...)
- ``obs``      — copies of the JAX package's observability modules
  (the port's own registry and tracer)
- ``convert``  — carries a solve state, or a serving daemon's state, across
  from the JAX package
- ``hostsync`` — counted device-to-host reads
"""

__version__ = "0.1.0"
