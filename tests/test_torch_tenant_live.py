"""The port's multi-tenant daemon on a live bus against the JAX package's
runner.

``mapd_bus`` and ``python -m p2p_distributed_tswap_tpu_torch.runtime.solverd
--cpu`` run as processes, the daemon with ``--tenants t0,t1`` or with
``--multi-tenant`` (a ``tenant_hello`` on ``solver.admit`` admits a tenant
and is answered with ``tenant_welcome``).  Each tenant is a closed-loop
fleet behind its own namespaced ``BusClient``; its requests alternate with
the other tenant's, each waits for its reply, and every reply's ``data``
is held against an in-process JAX ``MultiTenantRunner`` fed the same
requests.  A tenant's client never sees the other tenant's replies.
Deferred fields are off on both sides.  Nothing here asserts on timing:
each reply has its own wait, and the whole drive an overall cap.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.runtime import solverd as jsd
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
from p2p_distributed_tswap_tpu_torch.runtime.bus_client import BusClient

REPO = Path(__file__).resolve().parents[1]
TICKS = 8
REPLY_WAIT_S = 30.0
OVERALL_S = 150.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def built():
    from p2p_distributed_tswap_tpu_torch.runtime.fleet import ensure_built

    return ensure_built()


def _map(side=16, seed=5):
    rng = np.random.default_rng(seed)
    free = rng.random((side, side)) > 0.12
    text = "\n".join("".join("." if f else "@" for f in row) for row in free)
    return free, text + "\n"


def _until(pred, deadline):
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _wait(cli, deadline, want):
    """The first frame ``want(data)`` accepts, every frame seen before it
    kept; None past the deadline."""
    seen = []
    while time.monotonic() < deadline:
        f = cli.recv(timeout=1.0)
        if f is None or f.get("op") != "msg":
            continue
        d = f.get("data") or {}
        seen.append(d)
        if want(d):
            return d, seen
    return None, seen


class _Daemon:
    """The bus and the port's daemon, started with ``args``."""

    def __init__(self, built, tmp_path, args):
        free, text = _map()
        self.free = free
        self.mapf = tmp_path / "live16.map.txt"
        self.mapf.write_text(text)
        self.grid = JaxGrid.from_ascii(text)
        self.port = _free_port()
        env = {**os.environ, "JG_DEFER_FIELDS": "0", "JG_TRACE_CTX": "0",
               "JG_AUDIT": "0"}
        env.pop("JG_BUS_NS", None)
        self.bus = subprocess.Popen([str(Path(built) / "mapd_bus"),
                                     str(self.port)],
                                    stdout=subprocess.DEVNULL)
        self.sd = subprocess.Popen(
            [sys.executable, "-m",
             "p2p_distributed_tswap_tpu_torch.runtime.solverd",
             "--port", str(self.port), "--map", str(self.mapf), "--cpu",
             "--capacity-min", "8", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = []
        threading.Thread(target=lambda: [self.lines.append(x)
                                         for x in self.sd.stdout],
                         daemon=True).start()

    def up(self, deadline):
        return _until(lambda: any("solverd up" in x for x in self.lines),
                      deadline)

    def close(self):
        self.sd.terminate()
        self.sd.wait(timeout=10)
        self.bus.terminate()
        self.bus.wait(timeout=10)


def _drive(daemon, clients, deadline):
    """Alternate the tenants' requests, each reply held against the JAX
    runner's; returns the lanes moved in all."""
    ref_pub = []
    svc = jsd.PlanService(daemon.grid, capacity_min=8)
    svc.defer_fields = False
    ref = jsd.MultiTenantRunner(
        jsd.TenantSlab(svc, daemon.grid), daemon.grid,
        publish=lambda t, d: ref_pub.append((t, d)))
    cells = np.flatnonzero(daemon.free.reshape(-1))
    rng = np.random.default_rng(5)
    fleets, encs = {}, {}
    for k, ns in enumerate(clients):
        picks = rng.choice(cells, 12, replace=False)
        fleets[ns] = {f"{ns}a{j}": [int(picks[j]), int(picks[6 + j])]
                      for j in range(5 + k)}
        encs[ns] = pc.PackedFleetEncoder(snapshot_every=4)
    moved = 0
    for seq in range(1, TICKS + 1):
        for ns, cli in clients.items():
            fleet, enc = fleets[ns], encs[ns]
            items = [(n, p, g) for n, (p, g) in fleet.items()]
            req = {"type": "plan_request", "seq": seq,
                   "codec": pc.CODEC_NAME, "caps": [pc.CODEC_NAME],
                   "data": pc.encode_b64(enc.encode_tick(seq, items))}
            assert ref.ingest(ns, req)
            ref.finish(ref.begin())
            topic, want = ref_pub.pop()
            assert topic == f"{ns}:solver" and not ref_pub
            cli.publish("solver", req)
            got, seen = _wait(cli, min(deadline,
                                       time.monotonic() + REPLY_WAIT_S),
                              lambda d: d.get("type") == "plan_response"
                              and d.get("seq") == seq)
            assert got is not None, (ns, seq, daemon.lines[-5:])
            assert got["data"] == want["data"], (ns, seq)
            # the other tenant's replies never reach this namespace
            assert all(d.get("type") == "plan_request" for d in seen[:-1])
            rp = pc.decode_b64(got["data"])
            moved += rp.idx.size
            for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
                fleet[enc.roster[int(lane)]] = [int(c), int(g)]
            for name, (p, g) in fleet.items():
                if p == g:  # next task
                    fleet[name][1] = int(rng.choice(cells))
    return moved


def _clients(port, names):
    out = {}
    for ns in names:
        c = BusClient(port=port, peer_id=f"mgr-{ns}", namespace=ns)
        c.subscribe("solver")
        out[ns] = c
    return out


def test_static_tenants_reply_like_jax(built, tmp_path):
    deadline = time.monotonic() + OVERALL_S
    daemon = _Daemon(built, tmp_path, ["--tenants", "t0,t1"])
    clients = {}
    try:
        assert daemon.up(deadline), daemon.lines
        assert any("tenants=['t0', 't1']" in x for x in daemon.lines)
        clients = _clients(daemon.port, ("t0", "t1"))
        time.sleep(0.3)
        assert _drive(daemon, clients, deadline) > TICKS
    finally:
        for c in clients.values():
            c.close()
        daemon.close()


def test_dynamic_admission_replies_like_jax(built, tmp_path):
    deadline = time.monotonic() + OVERALL_S
    daemon = _Daemon(built, tmp_path, ["--multi-tenant"])
    orch = None
    clients = {}
    try:
        assert daemon.up(deadline), daemon.lines
        orch = BusClient(port=daemon.port, peer_id="orchestrator")
        orch.subscribe("solver.admit")
        time.sleep(0.3)
        for ns in ("ta", "tb"):
            orch.publish("solver.admit", {"type": "tenant_hello", "ns": ns})
            got, _ = _wait(orch, min(deadline,
                                     time.monotonic() + REPLY_WAIT_S),
                           lambda d, ns=ns: d.get("type") == "tenant_welcome"
                           and d.get("ns") == ns)
            assert got is not None, (ns, daemon.lines[-5:])
        clients = _clients(daemon.port, ("ta", "tb"))
        time.sleep(0.3)
        assert _drive(daemon, clients, deadline) > TICKS
    finally:
        if orch is not None:
            orch.close()
        for c in clients.values():
            c.close()
        daemon.close()
