"""The chaos and mesh twins against their JAX originals, on the CPU.

- ``scripts/torch_chaos_gate.py`` (a copy-twin): ``classify``,
  ``determinism_verdict`` and ``build_fault`` give the original's results
  on the same seeded replay records and captures.
- ``scripts/torch_mesh_smoke.py``: the digest gate's replies and digests,
  tick for tick, equal the JAX daemon's flat and 2-way mesh runners' on the
  same stream (the JAX side on conftest's virtual CPU devices).
- ``analysis/torch_mesh_bench.py``: a rung's fingerprint (every reply
  byte, the mirror, device and field digests) equals the original's rung
  at the same spec.
- ``analysis/torch_sharded_steptime.py``: after the warm-up and K steps,
  the single, 8-way and 2 x 4 states equal the original's.
- ``analysis/torch_extreme_rehearsal.py``: a paused session's checkpoint,
  the run resumed from it and an uninterrupted run equal the original's
  archives, state and latches (times excluded).

Times are never compared.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gates():
    return (_load("scripts/chaos_gate.py", "jax_chaos_gate"),
            _load("scripts/torch_chaos_gate.py", "torch_chaos_gate"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the chaos gate
# ---------------------------------------------------------------------------

CLASSES = ("roster", "device_mirror", "silent", "view", "stale_epoch")
PROCS = ("solverd", "manager", "agent", "simfleet")


def _replay_record(rng) -> dict:
    """A seeded replay record of the shape ``run_replay`` returns."""
    peers = [f"p{k}" for k in range(4)]

    def divs(n):
        return [{"class": str(rng.choice(CLASSES)),
                 "peer_a": str(rng.choice(peers)), "t_rel_s": 1.0 + k}
                for k in range(n)]

    expected = 19
    missing = sorted(rng.choice(expected, int(rng.integers(0, 3)),
                                replace=False).tolist())
    extra = [100] if rng.random() < 0.2 else []
    fired = float(rng.choice([7.2, 9.0]))
    takeovers = [{"t_rel_s": fired + float(rng.random() * 3),
                  "digests_equal": bool(rng.random() < 0.8)}
                 for _ in range(int(rng.integers(0, 3)))]
    notes = [n for n in ("spawned shm-lane victim (lane up)",
                         "shm lane reaped (ring file unlinked)")
             if rng.random() < 0.7]
    return {
        "expected": expected, "missing": missing, "extra_done": extra,
        "completed": expected - len(missing),
        "mgr_completed": expected - len(missing)
        + int(rng.integers(0, 2) if rng.random() < 0.2 else 0),
        "completion_ratio": (expected - len(missing)) / expected,
        "ok": not missing and not extra,
        "audit": {"confirmed": divs(int(rng.integers(0, 4))),
                  "active": divs(int(rng.integers(0, 2))),
                  "epochs": {p: {"proc": f"{rng.choice(PROCS)}-1"}
                             for p in peers}},
        "chaos": {"fired_at_s": fired},
        "chaos_notes": notes,
        "ha": {"enabled": bool(rng.random() < 0.5), "takeovers": takeovers},
        "federation": {"handoffs_sent": int(rng.integers(0, 3)),
                       "handoffs_dup_dropped": 0},
    }


@pytest.mark.parametrize("seed", range(6))
def test_chaos_classify_matches_the_original(gates, seed):
    jcg, tcg = gates
    rng = np.random.default_rng(seed)
    assert tcg.FAULT_KINDS == jcg.FAULT_KINDS
    for _ in range(8):
        res = _replay_record(rng)
        for kind in jcg.FAULT_KINDS:
            assert tcg.classify(kind, res) == jcg.classify(kind, res), kind


def _determinism_record(rng) -> dict:
    ids = list(range(19))
    if rng.random() < 0.3:
        ids = ids[:int(rng.integers(10, 19))]
    digests = {}
    for key in ("ledger", "view", "view_agents", "lanes"):
        if rng.random() < 0.15:
            continue
        digests[key] = {"digest": str(rng.choice(["0f", "10"], p=[.8, .2])),
                        "count": int(rng.choice([19, 18], p=[.8, .2]))}
    return {"completed_ids": ids, "digests": digests,
            "ok": bool(rng.random() < 0.85)}


@pytest.mark.parametrize("seed", range(3))
def test_chaos_determinism_verdict_matches_the_original(gates, seed):
    jcg, tcg = gates
    rng = np.random.default_rng(100 + seed)
    oks = set()
    for _ in range(40):
        a, b = _determinism_record(rng), _determinism_record(rng)
        want = jcg.determinism_verdict(a, b)
        assert tcg.determinism_verdict(a, b) == want
        oks.add(want["ok"])
    assert oks == {True, False}


def _fault_shape(fault) -> dict:
    return {"type": type(fault).__name__, "summary": fault.summary(),
            **{k: getattr(fault, k, None) for k in (
                "kind", "needs_solverd", "needs_shards", "needs_shm",
                "needs_regions", "extra_drain_s", "at_s", "recover_after_s",
                "ha")}}


@pytest.mark.parametrize("ha_env", ["", "1"])
def test_chaos_build_fault_matches_the_original(gates, monkeypatch, ha_env):
    jcg, tcg = gates
    monkeypatch.setenv("JG_HA", ha_env)
    for ms in (1500, 17880, 60000):
        capture = {"duration_ms": ms}
        for kind in jcg.FAULT_KINDS:
            for ha in (None, True, False):
                assert _fault_shape(tcg.build_fault(kind, capture, ha=ha)) \
                    == _fault_shape(jcg.build_fault(kind, capture, ha=ha))
    for mod in gates:
        with pytest.raises(SystemExit):
            mod.build_fault("nope", {"duration_ms": 1000})


# ---------------------------------------------------------------------------
# the mesh smoke's digest gate
# ---------------------------------------------------------------------------

def _jax_gate() -> list:
    """The original's digest gate on the JAX daemon, tick records kept."""
    from p2p_distributed_tswap_tpu.core.grid import Grid
    from p2p_distributed_tswap_tpu.obs import audit as au
    from p2p_distributed_tswap_tpu.parallel.solver_mesh import SolverMesh
    from p2p_distributed_tswap_tpu.runtime import plan_codec as pc
    from p2p_distributed_tswap_tpu.runtime.solverd import (PlanService,
                                                           TickRunner)

    grid = Grid.from_ascii("\n".join(["." * 16] * 16) + "\n")
    flat_svc = PlanService(grid, capacity_min=4)
    flat_svc.defer_fields = False
    mesh_svc = PlanService(grid, capacity_min=4, mesh=SolverMesh(2))
    mesh_svc.defer_fields = False
    flat, mesh = TickRunner(flat_svc, grid), TickRunner(mesh_svc, grid)
    enc_f = pc.PackedFleetEncoder(snapshot_every=4)
    enc_m = pc.PackedFleetEncoder(snapshot_every=4)
    rng = np.random.default_rng(3)
    free = np.flatnonzero(np.asarray(grid.free).reshape(-1)).astype(int)
    cells = rng.choice(free, size=12, replace=False)
    fleet = {f"p{k}": [int(cells[k]), int(cells[6 + k])] for k in range(6)}
    ticks = []
    for seq in range(1, 7):
        items = [(n, p, g) for n, (p, g) in sorted(fleet.items())]

        def req(enc):
            return {"type": "plan_request", "seq": seq,
                    "codec": pc.CODEC_NAME, "caps": [pc.CODEC_NAME],
                    "data": pc.encode_b64(enc.encode_tick(seq, items))}

        rf, rm = flat.handle(req(enc_f)), mesh.handle(req(enc_m))
        assert rm["data"] == rf["data"]
        df = (au.lane_digest(*flat_svc.audit_views("mirror")),
              au.lane_digest(*flat_svc.audit_views("device")))
        ticks.append({"seq": seq, "data": rf["data"], "mirror": df[0],
                      "device": df[1]})
        rp = pc.decode_b64(rf["data"])
        for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
            fleet[flat.packed.name_of(int(lane))] = [int(c), int(g)]
        fleet[f"p{int(rng.integers(6))}"][1] = int(rng.choice(free))
    return ticks


def test_mesh_digest_gate_matches_the_jax_daemon(monkeypatch):
    monkeypatch.delenv("JG_SOLVER_MESH", raising=False)
    for var in ("JG_DYNAMIC_WORLD", "JG_SECTOR"):
        monkeypatch.delenv(var, raising=False)
    smoke = _load("scripts/torch_mesh_smoke.py", "torch_mesh_smoke")
    got = smoke.digest_gate("cpu", log=lambda m: None)
    assert got == _jax_gate()
    monkeypatch.setenv("JG_SOLVER_MESH", "2")
    with pytest.raises(AssertionError, match="leaked"):
        smoke.digest_gate("cpu", log=lambda m: None)


# ---------------------------------------------------------------------------
# the mesh bench's rungs
# ---------------------------------------------------------------------------

RUNG = ["--agents", "8", "--side", "16", "--ticks", "4"]


@pytest.mark.parametrize("spec", ["1", "2"])
def test_mesh_bench_rung_fingerprint_matches_the_original(spec,
                                                          monkeypatch):
    for var in ("JG_SOLVER_MESH", "JG_DYNAMIC_WORLD", "JG_SECTOR"):
        monkeypatch.delenv(var, raising=False)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "analysis" / "mesh_bench.py"), "--rung",
         "--mesh", spec, *RUNG], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    bench = _load("analysis/torch_mesh_bench.py", "torch_mesh_bench")
    args = argparse.Namespace(mesh=spec, agents=8, side=16, ticks=4,
                              cpu=True)
    got = bench.run_rung(args)
    assert got["fingerprint"] == want["fingerprint"]
    assert got["resident_bytes_per_shard"] == {
        k: v for k, v in want["resident_bytes_per_shard"].items()}
    assert got["virtual"] and got["device"] == "cpu"


# ---------------------------------------------------------------------------
# the sharded step time
# ---------------------------------------------------------------------------

STEPS = 2


def test_sharded_steptime_states_match_the_original():
    from p2p_distributed_tswap_tpu.core.config import SolverConfig
    from p2p_distributed_tswap_tpu.core.grid import Grid
    from p2p_distributed_tswap_tpu.core.sampling import (
        start_positions_array)
    from p2p_distributed_tswap_tpu.core.tasks import TaskGenerator

    orig = _load("analysis/sharded_steptime.py", "jax_sharded_steptime")
    twin = _load("analysis/torch_sharded_steptime.py",
                 "torch_sharded_steptime")
    side, n, chunk = 32, 16, 4
    grid = Grid.random_obstacles(side, side, 0.1, seed=0)
    cfg = SolverConfig(height=side, width=side, num_agents=n,
                       replan_chunk=chunk)
    starts = start_positions_array(grid, n, seed=0)
    tasks = TaskGenerator(grid, seed=1).generate_task_arrays(n)
    jargs = (cfg, jnp.asarray(starts, jnp.int32),
             jnp.asarray(tasks, jnp.int32), jnp.asarray(grid.free), STEPS)
    want = {"single": orig.bench_single(*jargs)[1],
            "sharded8": orig.bench_sharded(*jargs)[1],
            "sharded2x4": orig.bench_sharded2d(*jargs)[1]}
    res = twin.run(STEPS, "cpu", problem=twin.build_problem(side, n, chunk),
                   log=lambda m: None)
    assert [r[0] for r in res["rows"]] == [
        "single-device", "sharded 8 (agents)",
        "sharded 2x4 (agents x tiles)"]
    for key, w in want.items():
        s = res["states"][key]
        for name in ("pos", "goal", "slot", "phase", "agent_task",
                     "task_used", "need_replan", "t"):
            np.testing.assert_array_equal(
                getattr(s, name).cpu().numpy(), np.asarray(getattr(w, name)),
                err_msg=f"{key}.{name}")
        dirs = s.dirs.cpu() if hasattr(s.dirs, "cpu") else s.dirs
        np.testing.assert_array_equal(
            dirs.numpy(), np.asarray(jax.device_get(w.dirs)).view(np.int32),
            err_msg=f"{key}.dirs")
        assert int(s.t) == 8 + STEPS


# ---------------------------------------------------------------------------
# the EXTREME-shaped rehearsal and its checkpoints
# ---------------------------------------------------------------------------

SMALL = ["--agents", "16", "--tasks", "16", "--side", "32", "--a-shards",
         "2", "--tiles", "4", "--replan-chunk", "4", "--horizon", "600"]
TIMES = ("__x_prime_s__", "__x_loop_s__")  # the latches that are times


def _archive(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k not in TIMES}


def _assert_archives_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_rehearsal(tmp, name, *extra):
    path = tmp / f"{name}.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "analysis" / "extreme_rehearsal.py"),
         *SMALL, "--checkpoint", str(path), *extra], capture_output=True,
        text=True, timeout=600, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return path


def test_rehearsal_checkpoints_match_the_original(tmp_path):
    twin = _load("analysis/torch_extreme_rehearsal.py",
                 "torch_extreme_rehearsal")
    jax_full = _archive(_jax_rehearsal(tmp_path, "jax_full"))
    jax_paused = _archive(_jax_rehearsal(tmp_path, "jax_paused",
                                         "--max-seconds", "1e-9"))

    def port(*extra):
        args = twin.parser().parse_args([*SMALL, *extra])
        return twin.rehearse(args, "cpu", log=lambda m: None)

    full = tmp_path / "port_full.npz"
    res = port("--checkpoint", str(full))
    assert res["completed"] and res["invariants_ok"]
    assert res["virtual_shards"] == 8
    _assert_archives_equal(_archive(full), jax_full)

    part = tmp_path / "port_part.npz"
    paused = port("--checkpoint", str(part), "--max-seconds", "1e-9")
    assert paused["paused_at_step"] == 32
    _assert_archives_equal(_archive(part), jax_paused)
    resumed = port("--checkpoint", str(part), "--resume")
    assert resumed["sessions"] == 2
    assert resumed["makespan"] == res["makespan"]
    _assert_archives_equal(_archive(part), jax_full | {
        "__x_sessions__": np.asarray(2)})


def test_rehearsal_probe_reports_residency():
    twin = _load("analysis/torch_extreme_rehearsal.py",
                 "torch_extreme_rehearsal")
    res = twin.rehearse(twin.parser().parse_args([*SMALL, "--probe", "3"]),
                        "cpu", log=lambda m: None)
    assert res["probe_steps"] == 3 and res["invariants_ok"]
    # 8 rows of a 2-way agent split x 32 packed words of an 8-row band
    assert res["resident_bytes_per_shard"] == {str(k): 8 * 32 * 4
                                               for k in range(8)}
    assert int(res["state"].t) == 3
