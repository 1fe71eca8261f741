"""The port's mesh daemon (``parallel/solver_mesh.py`` under
``runtime/solverd.py``) against the JAX package's, reply for reply.

The JAX daemon's mesh runs on the virtual CPU mesh of ``tests/conftest.py``
(8 devices); the port's on virtual CPU shards of the same (A, T) shape.
The same request stream goes to both: every reply must be the same bytes
(apart from ``duration_micros``), the services' caches, lanes and audit
digests equal after every tick, and ``resident_shard_bytes`` equal shard
for shard: the port allocates what the JAX daemon does (the cache's row
blocks on every tile of their agent row, the lanes split over the agent
shards when they divide, the slab's planes split along the lane axis).
Covered: mesh-spec parsing, the stream of the JAX package's
``test_mesh_flat_bit_identity`` at (2, 1), (8, 1) and (2, 4), deferred
fields, a seq gap, a tenant slab on a mesh, a dynamic-world toggle with
repair, a hand-off of a mesh daemon's state, and one live ``--mesh 2
--cpu`` daemon on ``mapd_bus``.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.grid import Grid as JaxGrid
from p2p_distributed_tswap_tpu.parallel import solver_mesh as jsm
from p2p_distributed_tswap_tpu.runtime import plan_codec as jpc
from p2p_distributed_tswap_tpu.runtime import solverd as jsd
from p2p_distributed_tswap_tpu_torch import convert
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.obs import registry as treg
from p2p_distributed_tswap_tpu_torch.parallel import solver_mesh as tsm
from p2p_distributed_tswap_tpu_torch.parallel.mesh import Sharded
from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
    virtual_devices)
from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
from p2p_distributed_tswap_tpu_torch.runtime import solverd as tsd

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    for k in ("JG_DYNAMIC_WORLD", "JG_DEFER_FIELDS", "JG_SECTOR",
              "JG_SOLVER_MESH", "MAPD_FUSED", "JG_TRACE_CTX"):
        monkeypatch.delenv(k, raising=False)


def _tmesh(shape):
    a, t = shape
    return tsm.SolverMesh(a, t, devices=virtual_devices(a * t, "cpu"))


def _pair(free, shape, defer=False, capacity_min=4):
    """A JAX mesh runner and a port mesh runner of one (A, T) shape on the
    same grid, deferred fields pinned on both."""
    jg, tg = JaxGrid(free.copy()), Grid(free.copy())
    j = jsd.TickRunner(jsd.PlanService(jg, capacity_min=capacity_min,
                                       mesh=jsm.SolverMesh(*shape)), jg)
    t = tsd.TickRunner(tsd.PlanService(tg, capacity_min=capacity_min,
                                       mesh=_tmesh(shape)), tg)
    j.service.defer_fields = t.service.defer_fields = defer
    return j, t


def _strip(resp):
    if resp is None:
        return None
    return {k: v for k, v in resp.items() if k != "duration_micros"}


def _host(x):
    return x.cpu().numpy() if isinstance(x, (torch.Tensor, Sharded)) \
        else np.asarray(x)


def _assert_services_equal(js, ts):
    assert list(js.goal_rows.items()) == list(ts.goal_rows.items())
    assert js.goal_ref == ts.goal_ref
    assert list(js.field_queue) == list(ts.field_queue)
    for k in ("pos", "goal", "slot", "active"):
        np.testing.assert_array_equal(getattr(js, f"h_{k}"),
                                      getattr(ts, f"h_{k}"))
        dj, dt = getattr(js, f"d_{k}"), getattr(ts, f"d_{k}")
        assert (dj is None) == (dt is None)
        if dj is not None:
            np.testing.assert_array_equal(_host(dj), _host(dt))
    if js.dirs is not None:
        assert isinstance(ts.dirs, Sharded)
        np.testing.assert_array_equal(
            np.asarray(js.dirs), _host(ts.dirs).view(np.uint32))
    assert js.resident_shard_bytes() == ts.resident_shard_bytes()


def _assert_audit_equal(j, t):
    seq = t.packed.last_seq or 0
    ej, xj = jsd.audit_entries(j.service, seq)
    et, xt = tsd.audit_entries(t.service, seq)
    assert [dataclasses.astuple(e) for e in ej] == \
        [dataclasses.astuple(e) for e in et]
    assert xj == xt


def _req(enc, seq, items):
    return {"type": "plan_request", "seq": seq, "codec": pc.CODEC_NAME,
            "caps": [pc.CODEC_NAME],
            "data": pc.encode_b64(enc.encode_tick(seq, items))}


# ---------------------------------------------------------------------------


def test_mesh_spec_parsing_matches_jax():
    for spec in ("2", "8", "2x4", " 2X4 ", "1", "1x1", "16x1"):
        assert tsm.parse_mesh_spec(spec) == jsm.parse_mesh_spec(spec)
    for bad in ("", "0", "0x2", "2x0", "-1", "2x", "x4", "2x4x8", "two",
                "2,4"):
        with pytest.raises(ValueError) as je:
            jsm.parse_mesh_spec(bad)
        with pytest.raises(ValueError) as te:
            tsm.parse_mesh_spec(bad)
        assert str(te.value) == str(je.value)
    for env in (None, "", "1", "1x1", "2", "2x4"):
        assert tsm.mesh_spec_from_env(env) == jsm.mesh_spec_from_env(env)
    with pytest.raises(ValueError):
        tsm.mesh_spec_from_env("nope")


def test_mesh_validates_grid_and_devices():
    grid = Grid(np.ones((10, 16), bool))
    with pytest.raises(ValueError, match="must divide over 4 tiles"):
        tsd.PlanService(grid, capacity_min=4, mesh=_tmesh((2, 4)))
    if not torch.cuda.is_available():
        # no virtual fold: the card's mesh needs its cards
        with pytest.raises(RuntimeError, match="mesh needs 2 devices"):
            tsm.SolverMesh(2)
    m = _tmesh((2, 2))
    assert m.round_lanes(5) == 6 and m.shape_str == "2x2"
    assert m.mesh.virtual and m.mesh.describe()["shape"] == [2, 2]


@pytest.mark.parametrize("shape", [(2, 1), (8, 1), (2, 4)],
                         ids=["2way", "8way", "2x4"])
def test_mesh_stream_matches_jax(shape):
    """The stream of the JAX package's ``test_mesh_flat_bit_identity``
    (joins, leaves, goal churn, a snapshot every 4 ticks) on the ref
    grid: replies byte-identical to the JAX mesh daemon's, caches, lanes,
    audit digests and per-shard resident bytes equal after every tick."""
    free = JaxGrid.default().free
    j, t = _pair(free, shape)
    rng = np.random.default_rng(7)
    cells = np.flatnonzero(free.reshape(-1)).astype(int)
    n = 8
    pick = rng.choice(cells, size=2 * n, replace=False)
    fleet = {f"p{k}": [int(pick[k]), int(pick[n + k])] for k in range(n)}
    enc = pc.PackedFleetEncoder(snapshot_every=4)
    for seq in range(1, 8):
        req = _req(enc, seq, [(k, p, g) for k, (p, g) in
                              sorted(fleet.items())])
        rj, rt = j.handle(req), t.handle(req)
        assert _strip(rj) == _strip(rt), seq
        _assert_services_equal(j.service, t.service)
        _assert_audit_equal(j, t)
        rp = pc.decode_b64(rt["data"])
        for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
            fleet[t.packed.name_of(int(lane))] = [int(c), int(g)]
        k = f"p{int(rng.integers(n))}"
        if k in fleet:
            fleet[k][1] = int(rng.choice(cells))
        if seq == 3:
            fleet.pop(sorted(fleet)[0])
        if seq == 5:
            fleet["q0"] = [int(rng.choice(cells)), int(rng.choice(cells))]
    per = t.service.resident_shard_bytes()
    assert len(per) == shape[0] * shape[1] and min(per.values()) > 0
    assert t.stats()["service"]["mesh"] == {
        "shape": f"{shape[0]}x{shape[1]}", "devices": shape[0] * shape[1],
        "resident_bytes": per}
    gauges = treg.get_registry().snapshot()["gauges"]
    assert any(k.startswith("solverd.resident_bytes") for k in gauges)


def test_mesh_deferred_fields_and_seq_gap_match_jax():
    """Deferred fields (the lanes park on the STAY row, the idle window
    sweeps on the mesh), then a seq gap and the snapshot resync."""
    free = np.ones((16, 16), bool)
    j, t = _pair(free, (2, 1), defer=True)
    enc_j = pc.PackedFleetEncoder(snapshot_every=1000)
    enc_t = pc.PackedFleetEncoder(snapshot_every=1000)
    fleet = [("a", 2 * 16 + 2, 2 * 16 + 7), ("b", 5, 60), ("c", 34, 12)]
    for seq in (1, 2):
        rj, rt = j.handle(_req(enc_j, seq, fleet)), \
            t.handle(_req(enc_t, seq, fleet))
        assert _strip(rj) == _strip(rt)
        while j.service.field_queue or t.service.field_queue:
            assert j.service.process_field_queue() == \
                t.service.process_field_queue()
        _assert_services_equal(j.service, t.service)
    assert -1 in t.service.goal_rows
    # seq 3 is lost on the way to both
    enc_j.encode_tick(3, fleet)
    enc_t.encode_tick(3, fleet)
    fleet2 = fleet[:2] + [("c", 34, 99)]
    assert not j.ingest(_req(enc_j, 4, fleet2))
    assert not t.ingest(_req(enc_t, 4, fleet2))
    assert j.snapshot_needed and t.snapshot_needed
    enc_j.force_snapshot = enc_t.force_snapshot = True
    rj, rt = j.handle(_req(enc_j, 5, fleet2)), \
        t.handle(_req(enc_t, 5, fleet2))
    assert _strip(rj) == _strip(rt)
    _assert_services_equal(j.service, t.service)
    _assert_audit_equal(j, t)


@pytest.mark.parametrize("shape", [(2, 1), (2, 4)], ids=["2way", "2x4"])
def test_mesh_dynamic_world_toggle_and_repair_match_jax(shape):
    """A world toggle on the mesh's cache: the STAY patch, the queued
    repair (on 2x4 through the banded distance sweep the host mirrors
    start from) and the repaired rows equal the JAX mesh daemon's."""
    free = np.ones((16, 16), bool)
    j, t = _pair(free, shape)
    for run in (j, t):
        run.service.dynamic_world = True
        run.service.keep_dist = True
    enc = pc.PackedFleetEncoder()
    fleet = [("a", 0, 37), ("b", 5, 60), ("c", 200, 12)]
    req = _req(enc, 1, fleet)
    assert _strip(j.handle(req)) == _strip(t.handle(req))
    for g in t.service.dist_mirror:
        np.testing.assert_array_equal(j.service.dist_mirror[g],
                                      t.service.dist_mirror[g])
    world = {"type": "world_update", "seq": 1, "world_seq": 1,
             "toggles": [[18, True], [19, True], [36, True]]}
    assert j.handle_world(dict(world)) == t.handle_world(dict(world)) == 3
    _assert_services_equal(j.service, t.service)
    while j.service.field_queue or t.service.field_queue:
        assert j.service.process_field_queue() == \
            t.service.process_field_queue()
    _assert_services_equal(j.service, t.service)
    for seq in (2, 3):
        req = _req(enc, seq, fleet)
        rj, rt = j.handle(req), t.handle(req)
        assert _strip(rj) == _strip(rt)
        _assert_audit_equal(j, t)
    assert sorted(j.service.dist_mirror) == sorted(t.service.dist_mirror)
    for g in t.service.dist_mirror:
        np.testing.assert_array_equal(j.service.dist_mirror[g],
                                      t.service.dist_mirror[g])
        np.testing.assert_array_equal(j.service.dirs_mirror[g],
                                      t.service.dirs_mirror[g])


def test_mesh_state_hands_off_from_jax():
    """A JAX mesh daemon's state crosses to the port's mesh daemon mid
    stream (``convert.runner_state`` / ``load_runner``), laid out over the
    port's mesh; the next replies are the same bytes."""
    free = JaxGrid.default().free
    j, t = _pair(free, (2, 2))
    rng = np.random.default_rng(3)
    cells = np.flatnonzero(free.reshape(-1)).astype(int)
    pick = rng.choice(cells, size=12, replace=False)
    fleet = [(f"a{k}", int(pick[k]), int(pick[6 + k])) for k in range(6)]
    enc = pc.PackedFleetEncoder(snapshot_every=1000)
    j.handle(_req(enc, 1, fleet))
    j.handle(_req(enc, 2, fleet))
    convert.load_runner(t, convert.runner_state(j))
    assert isinstance(t.service.dirs, Sharded)
    _assert_services_equal(j.service, t.service)
    for seq in (3, 4):
        req = _req(enc, seq, fleet)
        assert _strip(j.handle(req)) == _strip(t.handle(req))


def _mt_pair(free, shape):
    out = []
    for pkg, mesh in ((jsd, jsm.SolverMesh(*shape)), (tsd, _tmesh(shape))):
        grid = (JaxGrid if pkg is jsd else Grid)(free.copy())
        pub = []
        svc = pkg.PlanService(grid, capacity_min=4, mesh=mesh)
        svc.defer_fields = False
        slab = pkg.TenantSlab(svc, grid)
        runner = pkg.MultiTenantRunner(
            slab, grid, publish=lambda tp, d, pub=pub: pub.append((tp, d)),
            max_tenants=4, idle_evict_ms=0.0)
        out.append((runner, pub))
    return out


@pytest.mark.parametrize("shape", [(2, 1), (8, 1)], ids=["2way", "8way"])
def test_mesh_tenant_slab_matches_jax(shape):
    """The [T, L] slab on a mesh (the tenant fold with the mesh's next-hop
    lookup): per-tenant replies, audit digests and per-shard resident
    bytes with the slab's planes equal the JAX mesh daemon's."""
    free = np.ones((16, 16), bool)
    (jr, jpub), (tr, tpub) = _mt_pair(free, shape)
    fleets = {"t0": [("a", 0, 37), ("b", 5, 60), ("c", 200, 12)],
              "t1": [("a", 3, 90), ("b", 17, 33)]}
    encs = {r: {ns: pc.PackedFleetEncoder() for ns in fleets}
            for r in ("j", "t")}
    for seq in range(1, 5):
        for ns, fl in fleets.items():
            assert jr.ingest(ns, _req(encs["j"][ns], seq, fl))
            assert tr.ingest(ns, _req(encs["t"][ns], seq, fl))
        jr.finish(jr.begin())
        tr.finish(tr.begin())
        assert [(tp, _strip(d)) for tp, d in jpub] == \
            [(tp, _strip(d)) for tp, d in tpub]
        for ns in fleets:
            ej, _ = jsd.audit_entries_tenant(jr.slab, jr.tenants[ns])
            et, _ = tsd.audit_entries_tenant(tr.slab, tr.tenants[ns])
            assert [dataclasses.astuple(e) for e in ej] == \
                [dataclasses.astuple(e) for e in et]
        extra = lambda s: (s.d_pos, s.d_goal, s.d_slot, s.d_active)  # noqa
        assert jr.slab.service.resident_shard_bytes(extra(jr.slab)) == \
            tr.slab.service.resident_shard_bytes(extra(tr.slab))
        for ns, fl in fleets.items():  # every agent moves on
            fleets[ns] = [(a, g, p) for a, p, g in fl]
    assert sum(1 for _, d in tpub if d.get("type") == "plan_response") == 8
    assert tr.stats()["service"]["mesh"]["shape"] == f"{shape[0]}x1"


# ---------------------------------------------------------------------------
# one live daemon on a mesh
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _until(pred, deadline):
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_live_mesh_daemon_replies_match_jax(tmp_path):
    """``--mesh 2 --cpu`` on a live ``mapd_bus``: the daemon comes up on
    a virtual 2-shard mesh and its replies equal an in-process JAX runner's
    (the JAX daemon's mesh replies equal its flat ones)."""
    from p2p_distributed_tswap_tpu.runtime.fleet import ensure_built
    from p2p_distributed_tswap_tpu_torch.runtime.bus_client import BusClient

    built = ensure_built()
    rng = np.random.default_rng(4)
    free = rng.random((16, 16)) > 0.12
    text = "\n".join("".join("." if f else "@" for f in row) for row in free)
    mapf = tmp_path / "mesh16.map.txt"
    mapf.write_text(text + "\n")
    grid = JaxGrid.from_ascii(text + "\n")
    ref = jsd.TickRunner(jsd.PlanService(grid, capacity_min=8), grid)
    ref.service.defer_fields = False
    port = _free_port()
    env = {**os.environ, "JG_DEFER_FIELDS": "0", "JG_TRACE_CTX": "0"}
    env.pop("JG_SOLVER_MESH", None)
    bus = subprocess.Popen([str(Path(built) / "mapd_bus"), str(port)],
                           stdout=subprocess.DEVNULL)
    sd = cli = None
    deadline = time.monotonic() + 120.0
    try:
        sd = subprocess.Popen(
            [sys.executable, "-m",
             "p2p_distributed_tswap_tpu_torch.runtime.solverd",
             "--port", str(port), "--map", str(mapf), "--cpu",
             "--mesh", "2", "--capacity-min", "8"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines = []
        threading.Thread(target=lambda: [lines.append(x) for x in sd.stdout],
                         daemon=True).start()
        assert _until(lambda: any("solverd up" in x for x in lines),
                      deadline), lines
        assert any("mesh=2x1 [2 devices, virtual]" in x for x in lines)
        cli = BusClient(port=port, peer_id="fakemgr")
        cli.subscribe("solver")
        time.sleep(0.3)
        cells = np.flatnonzero(free.reshape(-1))
        pick = rng.choice(cells, 12, replace=False)
        fleet = {f"a{k}": [int(pick[k]), int(pick[6 + k])] for k in range(6)}
        enc = jpc.PackedFleetEncoder(snapshot_every=5)
        for seq in range(1, 9):
            items = [(n, p, g) for n, (p, g) in fleet.items()]
            req = {"type": "plan_request", "seq": seq,
                   "codec": jpc.CODEC_NAME, "caps": [jpc.CODEC_NAME],
                   "data": jpc.encode_b64(enc.encode_tick(seq, items))}
            want = ref.handle(req)
            cli.publish("solver", req)
            got = None
            while got is None and time.monotonic() < deadline:
                f = cli.recv(timeout=1.0)
                d = (f or {}).get("data") or {}
                if d.get("type") == "plan_response" and d.get("seq") == seq:
                    got = d
            assert got is not None, (seq, lines[-5:])
            assert got["data"] == want["data"], seq
            rp = jpc.decode_b64(got["data"])
            for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
                fleet[ref.packed.name_of(int(lane))] = [int(c), int(g)]
            for name, (p, g) in fleet.items():
                if p == g:
                    fleet[name][1] = int(rng.choice(cells))
    finally:
        if cli is not None:
            cli.close()
        if sd is not None:
            sd.terminate()
            sd.wait(timeout=10)
        bus.terminate()
        bus.wait(timeout=10)
