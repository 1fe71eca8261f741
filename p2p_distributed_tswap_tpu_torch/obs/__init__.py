"""Runtime observability: unified live-metrics registry (obs.registry),
span tracer (obs.trace), per-tick heartbeat (obs.heartbeat), metrics
beacons (obs.beacon), manager-side fleet aggregation
(obs.fleet_aggregator), cross-process task-causality events (obs.events,
trace-context propagation + Perfetto flows + hop-latency histograms), and
the always-on flight-recorder black box (obs.flightrec).

Counters/gauges/histograms are ALWAYS on (one dict op each) and flow into
every read side — Prometheus ``/metrics`` (JG_METRICS_PORT), the periodic
``mapd.metrics`` bus beacon, stats dumps, and trace-file counter events.
Span tracing stays gated by JG_TRACE=1 (near-zero cost off).  The C++ host
runtime mirrors the span schema in cpp/common/trace.hpp and the registry +
beacon in cpp/common/metrics.hpp / bus.hpp; merged trace reports come from
analysis/trace_report.py, the live fleet view from analysis/fleet_top.py.
"""

from p2p_distributed_tswap_tpu_torch.obs import events  # noqa: F401
from p2p_distributed_tswap_tpu_torch.obs import flightrec  # noqa: F401
from p2p_distributed_tswap_tpu_torch.obs import registry  # noqa: F401
from p2p_distributed_tswap_tpu_torch.obs import trace  # noqa: F401
from p2p_distributed_tswap_tpu_torch.obs.heartbeat import (  # noqa: F401
    TICK_BUDGET_MS,
    HeartbeatWriter,
)
