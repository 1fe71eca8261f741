"""The port's daemon on a live bus against the JAX package's runner.

``mapd_bus`` and ``python -m p2p_distributed_tswap_tpu_torch.runtime.solverd
--cpu`` run as processes; a closed-loop fleet publishes a packed request
stream through the port's ``BusClient``, waits for each reply, and holds
its ``data`` against an in-process JAX ``TickRunner`` fed the same stream.
Deferred fields are off on both sides, so no reply depends on when the
daemon's idle window runs.  Nothing here asserts on timing: each reply has
its own wait, and the whole drive an overall cap.
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
TICKS = 12
REPLY_WAIT_S = 30.0
OVERALL_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def built():
    from p2p_distributed_tswap_tpu.runtime.fleet import ensure_built

    return ensure_built()


def _map(side=16, seed=4):
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


def test_live_daemon_replies_match_jax(built, tmp_path):
    free, text = _map()
    mapf = tmp_path / "live16.map.txt"
    mapf.write_text(text)
    grid = JaxGrid.from_ascii(text)
    np.testing.assert_array_equal(grid.free, free)
    ref = jsd.TickRunner(jsd.PlanService(grid, capacity_min=8), grid)
    ref.service.defer_fields = False

    port = _free_port()
    env = {**os.environ, "JG_DEFER_FIELDS": "0", "JG_TRACE_CTX": "0"}
    bus = subprocess.Popen([str(Path(built) / "mapd_bus"), str(port)],
                           stdout=subprocess.DEVNULL)
    sd = cli = None
    deadline = time.monotonic() + OVERALL_S
    try:
        sd = subprocess.Popen(
            [sys.executable, "-m",
             "p2p_distributed_tswap_tpu_torch.runtime.solverd",
             "--port", str(port), "--map", str(mapf), "--cpu",
             "--capacity-min", "8"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines = []
        threading.Thread(target=lambda: [lines.append(x) for x in sd.stdout],
                         daemon=True).start()
        assert _until(lambda: any("solverd up" in x for x in lines),
                      deadline), lines
        cli = BusClient(port=port, peer_id="fakemgr")
        cli.subscribe("solver")
        time.sleep(0.3)

        rng = np.random.default_rng(4)
        cells = np.flatnonzero(free.reshape(-1))
        picks = rng.choice(cells, 12, replace=False)
        fleet = {f"a{k}": [int(picks[k]), int(picks[6 + k])]
                 for k in range(6)}
        enc = pc.PackedFleetEncoder(snapshot_every=5)
        moved = 0
        for seq in range(1, TICKS + 1):
            items = [(n, p, g) for n, (p, g) in fleet.items()]
            req = {"type": "plan_request", "seq": seq,
                   "codec": pc.CODEC_NAME, "caps": [pc.CODEC_NAME],
                   "data": pc.encode_b64(enc.encode_tick(seq, items))}
            want = ref.handle(req)
            cli.publish("solver", req)
            got = None
            wait_end = min(deadline, time.monotonic() + REPLY_WAIT_S)
            while got is None and time.monotonic() < wait_end:
                f = cli.recv(timeout=1.0)
                d = (f or {}).get("data") or {}
                if d.get("type") == "plan_response" and d.get("seq") == seq:
                    got = d
            assert got is not None, (seq, lines[-5:])
            assert got["data"] == want["data"], seq
            assert got["codec"] == pc.CODEC_NAME
            rp = pc.decode_b64(got["data"])
            moved += rp.idx.size
            for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
                fleet[ref.packed.name_of(int(lane))] = [int(c), int(g)]
            for name, (p, g) in fleet.items():
                if p == g:  # next task
                    fleet[name][1] = int(rng.choice(cells))
        assert moved > TICKS
    finally:
        if cli is not None:
            cli.close()
        if sd is not None:
            sd.terminate()
            sd.wait(timeout=10)
        bus.terminate()
        bus.wait(timeout=10)
