"""Shared busd shard-pool spawner.

Before the pool existed, every harness and test that needed a bus
duplicated the same setup: pick a port, Popen ``mapd_bus``, sleep, hope.
This module is the single place that knows how to launch ONE hub or a
FEDERATED POOL of them — free-port allocation, per-shard log files, the
``--shard/--shards/--peers`` peering flags, and the environment
(``JG_BUS_SHARD_PORTS``) that makes every BusClient in the fleet
shard-aware.  Used by runtime/fleet.py, analysis/bus_scaling.py,
scripts/bus_smoke.py, and the shard-plane tests.

``num_shards=1`` spawns exactly the pre-pool single hub (no peering
flags, no pool env) — the ``JG_BUS_SHARDS=1`` kill switch end to end.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from p2p_distributed_tswap_tpu_torch.runtime import shmlane

SHARD_PORTS_ENV = "JG_BUS_SHARD_PORTS"


def parse_cpu_affinity(spec) -> Optional[List[int]]:
    """A ``--cpu-affinity`` spec -> ordered CPU id list: "0,1,2" pins
    shard i to cpu ``list[i % len]``; "auto" spreads across every CPU
    this process may use; None/'' disables pinning."""
    if spec is None or spec == "":
        return None
    if spec == "auto":
        if not hasattr(os, "sched_getaffinity"):  # non-Linux: no pinning
            return None
        return sorted(os.sched_getaffinity(0))
    cpus = [int(c) for c in str(spec).split(",") if str(c).strip()]
    if not cpus:
        raise ValueError(f"empty cpu affinity spec: {spec!r}")
    return cpus


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_args(shard: int, num_shards: int, ports: Sequence[int]
               ) -> List[str]:
    """The busd CLI flags that make shard ``shard`` a pool member (empty
    for a single hub, keeping its invocation byte-identical)."""
    if num_shards <= 1:
        return []
    return ["--shard", str(shard), "--shards", str(num_shards),
            "--peers", ",".join(str(p) for p in ports)]


def pool_ports(num_shards: int, home_port: Optional[int] = None
               ) -> List[int]:
    """Allocate the pool's port list: the home shard keeps ``home_port``
    (the fleet's advertised bus port) when given, the rest are free
    ports."""
    ports = [free_port() for _ in range(num_shards)]
    if home_port is not None:
        ports[0] = home_port
    return ports


def pool_env(ports: Sequence[int]) -> dict:
    """Environment that makes every BusClient shard-aware.  Empty for a
    single hub: a one-port pool must keep the legacy wire byte-identical
    (shardmap treats the absent env as 'single hub')."""
    if len(ports) <= 1:
        return {}
    return {SHARD_PORTS_ENV: ",".join(str(p) for p in ports)}


class BusPool:
    """A spawned busd pool (single hub when ``num_shards=1``).

    ``spawn`` customizes process creation — the fleet runner passes its
    own (log capture + exit-code tracking); the default writes per-shard
    logs under ``log_dir`` (or discards output).  Shard 0 is the HOME
    shard: spawned first so higher shards' peering dials succeed on the
    first attempt.
    """

    def __init__(self, binary, num_shards: int = 1,
                 home_port: Optional[int] = None,
                 log_dir: Optional[Path] = None,
                 extra_args: Optional[Sequence[str]] = None,
                 spawn: Optional[Callable] = None,
                 settle_s: float = 0.3,
                 cpu_affinity=None):
        self.num_shards = num_shards
        self.ports = pool_ports(num_shards, home_port)
        self.procs: List[subprocess.Popen] = []
        self._logs: List = []
        # per-shard CPU pinning (ROADMAP item 1 remaining headroom): on a
        # many-core host the pool's shards contend less when each relay
        # loop owns a core.  Spec: "0,1,2" (shard i -> cpu[i % len]),
        # "auto" (spread over this process's allowed CPUs), None = off.
        self.cpu_affinity = parse_cpu_affinity(cpu_affinity)
        # zero-copy lanes: lane files of clients that died by
        # SIGKILL survive their sessions; sweep the lane dir once per
        # pool spawn so a fresh fleet never trips over a dead pid's ring
        if shmlane.shm_enabled():
            try:
                shmlane.reclaim_stale()
            except OSError:
                pass  # best-effort hygiene: a locked dir must not block
        for i, port in enumerate(self.ports):
            cmd = [str(binary), str(port),
                   *shard_args(i, num_shards, self.ports),
                   *(extra_args or [])]
            name = "bus" if num_shards <= 1 else f"bus_s{i}"
            if spawn is not None:
                proc = spawn(name, cmd)
            elif log_dir is not None:
                log_dir = Path(log_dir)
                log_dir.mkdir(parents=True, exist_ok=True)
                out = open(log_dir / f"{name}.log", "w")
                self._logs.append(out)
                proc = subprocess.Popen(cmd, stdout=out,
                                        stderr=subprocess.STDOUT)
            else:
                proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                        stderr=subprocess.DEVNULL)
            if self.cpu_affinity and hasattr(os, "sched_setaffinity"):
                # post-spawn pinning is sufficient: busd is a single
                # poll loop (no threads inherit a pre-pin mask)
                cpu = self.cpu_affinity[i % len(self.cpu_affinity)]
                try:
                    os.sched_setaffinity(proc.pid, {cpu})
                except OSError as e:  # bad cpu id / cgroup restriction
                    print(f"⚠️  buspool: cannot pin shard {i} to cpu "
                          f"{cpu}: {e}")
            self.procs.append(proc)
        time.sleep(settle_s)

    @property
    def home_port(self) -> int:
        return self.ports[0]

    def env(self) -> dict:
        return pool_env(self.ports)

    def kill_shard(self, shard: int) -> None:
        """Hard-kill one pool member (the degradation drills: a dead
        shard must cost its regions, not the fleet)."""
        self.procs[shard].kill()
        self.procs[shard].wait(timeout=5)

    def alive(self) -> List[bool]:
        return [p.poll() is None for p in self.procs]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        for f in self._logs:
            try:
                f.close()
            except OSError:
                pass
        self._logs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
