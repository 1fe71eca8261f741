"""Process-spawn fleet runner.

The working equivalent of the reference's bit-rotted ``task_test`` harness
(src/test/run/task.rs:32-284, which spawns binary names that no longer exist
— SURVEY C12): launches bus + manager + N agents as OS processes, forwards
operator commands to the manager's stdin, and kills the whole fleet on exit.

Library use (integration tests) and CLI:
    python -m p2p_distributed_tswap_tpu_torch.runtime.fleet \
        --mode decentralized --agents 3 --duration 30
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

from p2p_distributed_tswap_tpu_torch.core.config import RuntimeConfig
from p2p_distributed_tswap_tpu_torch.obs import trace
from p2p_distributed_tswap_tpu_torch.runtime import buspool
from p2p_distributed_tswap_tpu_torch.runtime import region as regionlib
from p2p_distributed_tswap_tpu_torch.runtime import shmlane

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "cpp" / "build"


def ensure_built() -> Path:
    """Build the C++ runtime if needed; returns the build dir."""
    if not (BUILD_DIR / "mapd_bus").exists():
        subprocess.run(["cmake", "-S", str(REPO_ROOT / "cpp"), "-B",
                        str(BUILD_DIR), "-G", "Ninja"], check=True,
                       capture_output=True)
        subprocess.run(["ninja", "-C", str(BUILD_DIR)], check=True,
                       capture_output=True)
    return BUILD_DIR


def wait_for_log(path, needle: str, timeout_s: float,
                 proc: Optional[subprocess.Popen] = None,
                 tail_bytes: int = 65536) -> bool:
    """Poll a child's log file for a readiness banner, reading only the
    TAIL (a --warm solverd log grows; re-reading it whole 2x/s is wasted
    I/O).  True on match; False on timeout or — when ``proc`` is given —
    on the child exiting first.  Shared by the fleet runner and the
    harnesses (solver_crossover, fleetsim), which each had their own
    copy of this loop before."""
    deadline = time.monotonic() + timeout_s
    path = Path(path)
    needle_b = needle.encode()
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            return False
        if path.exists():
            with open(path, "rb") as f:
                f.seek(0, 2)
                f.seek(max(0, f.tell() - tail_bytes))
                if needle_b in f.read():
                    return True
        time.sleep(0.5)
    return False


def build_single_tu(binary_name: str, source_rel: str) -> Optional[Path]:
    """Build one single-translation-unit runtime binary with a bare g++
    (every cpp/ binary is one TU, so no cmake/ninja needed) — the shared
    helper behind the codec-golden / busd test-and-smoke builders.
    Returns the binary path, or None when it neither exists nor can be
    built (no C++ toolchain)."""
    import shutil

    binary = BUILD_DIR / binary_name
    if binary.exists():
        return binary
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-O2", "-std=c++17", "-Icpp", source_rel,
                    "-o", str(binary)], cwd=str(REPO_ROOT), check=True,
                   capture_output=True)
    return binary


class Fleet:
    """A managed fleet of runtime processes (killed on close/GC)."""

    def __init__(self, mode: str = "decentralized", num_agents: int = 3,
                 port: int = 7450, map_file: Optional[str] = None,
                 solver: str = "cpu", log_dir: Optional[str] = None,
                 env: Optional[dict] = None,
                 config: Optional[RuntimeConfig] = None,
                 solverd_args: Optional[List[str]] = None,
                 bus_shards: Optional[int] = None,
                 bus_cpu_affinity: Optional[str] = None,
                 regions: Optional[str] = None,
                 ha: Optional[bool] = None):
        assert mode in ("centralized", "decentralized")
        # federated world regions: a "CxR" spec brings up one
        # (manager [, solverd]) pair PER REGION on the shared bus pool —
        # region i's manager owns the i-th rectangle (--region-id), its
        # plan wire is solver.r<i>, audit pairing ns r<i>.  None/"1"
        # keeps today's single-pair fleet byte-identical.
        fed_cols, fed_rows = regionlib.fed_parse_spec(regions)
        fed_total = fed_cols * fed_rows
        build = ensure_built()
        self.procs: List[subprocess.Popen] = []
        self._names: List[str] = []
        # Child stderr is never dropped: with no explicit log_dir each run
        # gets a fresh timestamped directory, so a crashing child's last
        # words (and its exit code, see exit_summary) survive the fleet
        # teardown instead of vanishing into DEVNULL.
        if log_dir is None:
            stamp = (datetime.now().strftime("%Y%m%d-%H%M%S")
                     + f"-{os.getpid()}")
            log_dir = REPO_ROOT / "results" / "fleet_logs" / stamp
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.exit_summary: List[Dict] = []
        penv = dict(os.environ)
        # flight-recorder dumps (always-on black box, obs/flightrec.py)
        # land next to the per-process logs unless the caller routed them
        # elsewhere — so a fleet incident leaves logs AND rings together
        penv.setdefault("JG_FLIGHT_DIR", str(self.log_dir))
        # zero-copy bus lanes: when JG_BUS_SHM is on, the
        # fleet's ring files live under the run dir with its logs — one
        # sweep cleans a run, and two concurrent fleets never collide on
        # the default /tmp lane dir
        penv.setdefault(shmlane.SHM_DIR_ENV,
                        str(self.log_dir / "shm_lanes"))
        if config is not None:
            # one RuntimeConfig configures every binary in the fleet
            # (MAPD_* env knobs, cpp/common/knobs.hpp)
            penv.update(config.to_env())
        if env:
            penv.update(env)
        self._logs: List = []

        def spawn(name, cmd, stdin=None):
            out = open(self.log_dir / f"{name}.log", "w")
            self._logs.append(out)
            p = subprocess.Popen(cmd, stdin=stdin, stdout=out,
                                 stderr=subprocess.STDOUT, env=penv)
            self.procs.append(p)
            self._names.append(name)
            trace.instant("fleet.spawn", proc=name, pid=p.pid)
            return p

        map_args = ["--map", map_file] if map_file else []
        # Sharded bus pool: JG_BUS_SHARDS (or the bus_shards
        # arg) spawns that many federated busd shards — shard 0 keeps
        # `port` so external tools (fleet_top, harness watchers) reach
        # the control plane at the advertised address, and every child
        # gets JG_BUS_SHARD_PORTS so its BusClient routes per shard.
        # The default (1) is today's single hub, byte-identical.
        shards = int(bus_shards if bus_shards is not None
                     else (env or {}).get("JG_BUS_SHARDS")
                     or os.environ.get("JG_BUS_SHARDS", "1") or 1)
        # optional per-shard CPU pinning (buspool.parse_cpu_affinity spec;
        # JG_BUS_CPU_AFFINITY env for harnesses that configure via env)
        affinity = (bus_cpu_affinity if bus_cpu_affinity is not None
                    else (env or {}).get("JG_BUS_CPU_AFFINITY")
                    or os.environ.get("JG_BUS_CPU_AFFINITY", ""))
        self.bus_pool = buspool.BusPool(
            build / "mapd_bus", num_shards=max(1, shards), home_port=port,
            spawn=lambda name, cmd: spawn(name, cmd), settle_s=0.0,
            cpu_affinity=affinity)
        # THIS pool is the children's bus — a stale JG_BUS_SHARD_PORTS
        # inherited from the operator's shell (a previous manual pool)
        # must never leak into a fresh fleet
        penv.pop(buspool.SHARD_PORTS_ENV, None)
        penv.update(self.bus_pool.env())
        time.sleep(0.3)
        if mode == "centralized" and solver == "tpu":
            # --solver=tpu planning happens in the JAX solver daemon —
            # one per region in a federated fleet, each on its own
            # plan-wire topic
            for rid in range(fed_total):
                tag = f"_r{rid}" if fed_total > 1 else ""
                fed_args = regionlib.fed_cli_args(rid, fed_cols, fed_rows,
                                                  "solverd")
                sd_proc = spawn(f"solverd{tag}",
                                [sys.executable, "-m",
                                 "p2p_distributed_tswap_tpu_torch.runtime"
                                 ".solverd",
                                 "--port", str(port), *map_args,
                                 *fed_args, *(solverd_args or [])])
                # wait for the readiness banner (printed AFTER any
                # --warm pre-compile) so the manager never opens with a
                # failover window; a startup death just means the
                # manager plans natively; without logs fall back to a
                # fixed headroom sleep
                if self.log_dir:
                    wait_for_log(self.log_dir / f"solverd{tag}.log",
                                 "solverd up", 240, proc=sd_proc)
                else:
                    time.sleep(8)  # accelerator init headroom
        # control-plane HA: ha=True (or JG_HA=1 in the
        # fleet env) pairs every region's manager with a warm standby
        # that tails its ledger1 replication stream and takes over on
        # lease expiry.  centralized-mode only — the decentralized
        # manager is not a replication source (yet).
        if ha is None:
            ha_env = str((env or {}).get("JG_HA")
                         or os.environ.get("JG_HA", ""))
            ha = ha_env not in ("", "0")
        ha_on = bool(ha) and mode == "centralized"
        self.managers: List[subprocess.Popen] = []
        self.standbys: List[Optional[subprocess.Popen]] = []
        for rid in range(fed_total):
            tag = f"_r{rid}" if fed_total > 1 else ""
            mgr_cmd = [str(build / f"mapd_manager_{mode}"),
                       "--port", str(port), *map_args]
            if mode == "centralized":
                mgr_cmd += ["--solver", solver]
            mgr_cmd += regionlib.fed_cli_args(rid, fed_cols, fed_rows,
                                              "manager")
            if ha_on:
                mgr_cmd += ["--ha", "1"]
            self.managers.append(spawn(f"manager{tag}", mgr_cmd,
                                       stdin=subprocess.PIPE))
            self.standbys.append(
                spawn(f"standby{tag}", mgr_cmd + ["--standby"],
                      stdin=subprocess.PIPE) if ha_on else None)
        self.manager = self.managers[0]
        time.sleep(0.3)
        for i in range(1, num_agents + 1):
            spawn(f"agent_{i}",
                  [str(build / f"mapd_agent_{mode}"), "--port", str(port),
                   "--seed", str(i), *map_args])
            time.sleep(0.1)
        self.port = port

    def command(self, line: str) -> None:
        """Send an operator CLI line to the manager (task | tasks N | ...)."""
        assert self.manager.stdin is not None
        self.manager.stdin.write((line + "\n").encode())
        self.manager.stdin.flush()

    def command_region(self, rid: int, line: str) -> None:
        """Send an operator CLI line to region ``rid``'s manager."""
        mgr = self.managers[rid]
        assert mgr.stdin is not None
        mgr.stdin.write((line + "\n").encode())
        mgr.stdin.flush()

    def quit(self, timeout: float = 10.0) -> None:
        try:
            self.command("quit")
            self.manager.wait(timeout=timeout)
        except Exception:
            pass
        self.close()

    def close(self) -> None:
        if not self.procs:
            return  # already closed; keep the recorded exit_summary
        # Children already dead BEFORE the teardown SIGTERM died on their
        # own — their exit codes are the fleet's failure record, not an
        # artifact of shutdown.
        died_early = {id(p): p.poll() for p in self.procs
                      if p.poll() is not None}
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 5
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                try:  # reap, or the summary below reads returncode None
                    p.wait(timeout=1)
                except subprocess.TimeoutExpired:
                    pass
        self.exit_summary = []
        for name, p in zip(self._names, self.procs):
            rec = {"proc": name, "pid": p.pid, "returncode": p.poll(),
                   "died_early": id(p) in died_early,
                   "log": str(self.log_dir / f"{name}.log")}
            self.exit_summary.append(rec)
            trace.instant("fleet.exit", proc=name, pid=p.pid,
                          returncode=rec["returncode"],
                          died_early=rec["died_early"])
            if rec["died_early"] and rec["returncode"] != 0:
                print(f"⚠️  fleet: {name} (pid {p.pid}) exited "
                      f"{rec['returncode']} before shutdown — see "
                      f"{rec['log']}", file=sys.stderr, flush=True)
        self.procs.clear()
        self._names.clear()
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="decentralized",
                    choices=["centralized", "decentralized"])
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--duration", type=int, default=30)
    ap.add_argument("--port", type=int, default=7450)
    ap.add_argument("--map", default=None)
    ap.add_argument("--solver", default="cpu", choices=["cpu", "tpu"])
    ap.add_argument("--tasks-every", type=float, default=3.0)
    ap.add_argument("--log-dir", default="results/fleet")
    args = ap.parse_args(argv)

    with Fleet(args.mode, args.agents, args.port, args.map, args.solver,
               args.log_dir) as fleet:
        print(f"fleet up: {args.mode}, {args.agents} agents, "
              f"bus port {args.port}; logs in {fleet.log_dir}")
        print(f"   live view: python analysis/fleet_top.py "
              f"--port {args.port}   (beacons on bus topic mapd.metrics)")
        time.sleep(3 + args.agents * 0.2)
        end = time.monotonic() + args.duration
        while time.monotonic() < end:
            fleet.command(f"tasks {args.agents}")
            time.sleep(args.tasks_every)
        fleet.command("metrics")
        time.sleep(1)
        fleet.quit()
        bad = [r for r in fleet.exit_summary
               if r["died_early"] and r["returncode"] != 0]
        for r in bad:
            print(f"fleet: {r['proc']} exited {r['returncode']} "
                  f"(log: {r['log']})")
    trace.flush()
    print("fleet shut down" + (f" ({len(bad)} child failure(s))"
                               if bad else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
