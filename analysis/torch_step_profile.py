"""Device profile of the PyTorch port's MAPD step on an NVIDIA GPU.

Builds a scenario of the port's ladder at full size, runs the prime burst and
a few warm-up steps, then times ``--steps`` calls of ``mapd_step``; then
does it all again from scratch (the solve is deterministic, so the same
work) with the window recorded by ``torch.profiler`` (CPU and CUDA
activities).  Reports, for that window:

- wall ms/step (host clock around the unprofiled window, ended by a
  synchronize), and the same under the profiler;
- device busy ms/step (the sum of CUDA kernel and memory-op self times; one
  stream, so they do not overlap) and the device's idle share of the
  unprofiled wall;
- the top operators and kernels by device time, the share of device time
  of the port's own kernels (``sweep_scan`` and ``field_fused``), and host
  syncs and kernel launches per step;
- per part of ``mapd_step`` (commit_pending, transitions, assign, replan,
  broadcast_view, step_parallel or step_stale, record; profiler ranges
  wrapped round them for the profiled window): host ms, kernel ms and the
  span on the device timeline per step, all as seen under the profiler.

Run from the root of a checkout on a machine with the card:

    python3 analysis/torch_step_profile.py [--scenario flagship] [--steps 10]
        [--out profile.json]

``MAPD_FUSED`` in the environment selects the field path as it does for the
solve (``1``: the multi instance of the fused kernel on 256^2 grids,
``single``: the single instance).

Prints one JSON line (and writes it, indented, to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (  # noqa: E402
    ProfilerActivity,
    profile,
    record_function,
)

from p2p_distributed_tswap_tpu_torch import hostsync  # noqa: E402
from p2p_distributed_tswap_tpu_torch.models import scenarios  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    field_fused,
    sweep_kernel,
)
from p2p_distributed_tswap_tpu_torch.solver import mapd  # noqa: E402

SCENARIOS = {"ref": scenarios.REFERENCE_DEMO, "medium": scenarios.MEDIUM,
             "flagship": scenarios.FLAGSHIP,
             "congested": scenarios.CONGESTED,
             "congested-stale": scenarios.CONGESTED_DECENT_STALE}
# the parts of mapd_step, which looks each up in its module at call time
PHASES = ("_commit_pending", "_transitions", "_assign", "_replan",
          "_broadcast_view", "step_parallel", "step_stale", "_record")
# device kernels of the port, by a part of their names
PORT_KERNELS = {"sweep_scan": "sweep_along", "field_fused": "field_fused"}


def _launches() -> int:
    return sweep_kernel.launches + sum(field_fused.launches.values())


def _label_phases() -> None:
    """Wrap each part of ``mapd_step`` in a profiler range ``mapd.<part>``."""
    for name in PHASES:
        def ranged(*args, _fn=getattr(mapd, name), _label=name, **kw):
            with record_function("mapd." + _label.lstrip("_")):
                return _fn(*args, **kw)
        setattr(mapd, name, ranged)


def _device_us(evt, kind: str = "self_") -> float:
    """``evt``'s (self or total) device time in us, under either of the
    names PyTorch has given it."""
    for name in (f"{kind}device_time_total", f"{kind}cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="flagship", choices=sorted(SCENARIOS))
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    scn = SCENARIOS[args.scenario]
    grid, starts, tasks, cfg = scn.build(seed=0)
    cfg = dataclasses.replace(cfg, record_paths=False)
    free = torch.from_numpy(grid.free).to(dev)
    cuda_build.build()

    def window(profiler=None):
        """Prepare from scratch, warm up, then time ``--steps`` steps: the
        solve is deterministic, so every call runs the same work."""
        s, tasks_t = mapd.prepare_state(cfg, starts, tasks, free, device=dev)
        for _ in range(args.warmup):
            s = mapd.mapd_step(cfg, s, tasks_t, free)
        torch.cuda.synchronize()
        launches0, syncs0 = _launches(), hostsync.count
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            s = mapd.mapd_step(cfg, s, tasks_t, free)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        if profiler is not None:
            profiler.stop()
        return (int(s.t), wall_s, _launches() - launches0,
                hostsync.count - syncs0)

    t_end, wall_s, launches, syncs = window()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _label_phases()
    _, prof_wall_s, _, _ = window(prof)

    rows, phases = [], {}
    for evt in prof.key_averages():
        on_device = evt.device_type == DeviceType.CUDA
        if evt.key.startswith("mapd."):
            # a range appears twice: on the host (its wall time there, which
            # ends in a host sync, and the device time of its kernels) and
            # as a span on the device timeline
            part = phases.setdefault(evt.key, {})
            if on_device:
                part["device_span_ms_per_step"] = \
                    _device_us(evt, "") / 1e3 / args.steps
            else:
                part["host_ms_per_step"] = evt.cpu_time_total / 1e3 / args.steps
                part["kernel_ms_per_step"] = \
                    _device_us(evt, "") / 1e3 / args.steps
                part["calls"] = evt.count
            continue
        us = _device_us(evt)
        if us > 0:
            rows.append({"name": evt.key, "device_ms": us / 1e3,
                         "count": evt.count, "on_device": on_device})
    rows.sort(key=lambda r: -r["device_ms"])
    # kernels and memory ops are the events that ran on the device;
    # operator rows repeat the time of the kernels they launched
    kernels = [r for r in rows if r["on_device"]]
    busy_ms = sum(r["device_ms"] for r in kernels)
    wall_ms = 1e3 * wall_s
    port = {}
    for name, part in PORT_KERNELS.items():
        ms = sum(r["device_ms"] for r in kernels if part in r["name"])
        port[name] = {"ms_per_step": ms / args.steps,
                      "share_of_device": ms / busy_ms if busy_ms else None,
                      "share_of_wall": ms / wall_ms}
    out = {
        "scenario": scn.name, "mode": scn.mode,
        "fused_mode": field_fused.fused_mode(), "card": card,
        "steps": args.steps, "t_end": t_end,
        "wall_ms_per_step": wall_ms / args.steps,
        "profiled_wall_ms_per_step": 1e3 * prof_wall_s / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "port_kernels": port,
        "port_kernel_launches_per_step": launches / args.steps,
        "host_syncs_per_step": syncs / args.steps,
        "phases_profiled": phases,
        "top_kernels": kernels[:15],
        "top_operators": [r for r in rows if not r["on_device"]][:15],
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
