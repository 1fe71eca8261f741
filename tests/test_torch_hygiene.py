"""Boundaries of the PyTorch port.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points run on the card unless the caller asks for the CPU: without
  CUDA they raise instead of quietly running on the CPU.
- The CUDA kernels' wrappers refuse what the kernels do not take, CPU
  tensors included.
- The JAX-free modules the serving path and the fleet launcher need are
  copies of the JAX package's: the same code, the package name rewritten;
  the port's ``RuntimeConfig`` is the JAX package's, field for field.
- The port's ``Fleet`` launcher spawns the port's daemon.
- The twins of the harnesses that drive the daemon
  (``scripts/torch_{audit_smoke,chaos_gate}.py``,
  ``analysis/torch_{fleetsim,tenant_scaling,solver_crossover}.py``) are
  copies of their originals but for the daemon's device: they spawn the
  port's daemon, on the card unless their ``--cpu`` asks for the CPU; they,
  ``analysis/torch_live_fleet.py`` and ``chip_smoke.py`` reach nothing of
  JAX through any import.
- The solver-side and dynamic-world measurement twins
  (``analysis/torch_{parity_table,congestion,decent_premium,roofline,
  quality_gap,field_bench,sector_bench}.py``,
  ``scripts/torch_{field,sector}_fuzz.py``) are ports, not copies: they
  reach nothing of JAX, name no fixed ``/tmp`` path, write none of the
  JAX package's result files by default, and exit nonzero without CUDA
  unless ``--cpu`` is given; so are the twins of the mesh scripts
  (``scripts/torch_mesh_smoke.py``, ``analysis/torch_{mesh_bench,
  sharded_steptime,extreme_rehearsal}.py``).
- Every module of the JAX package has a counterpart at the same path in
  the port (``ops/sweep_pallas.py`` is ``ops/sweep_kernel.py``).
- The daemon serves the mesh (``--mesh`` / ``JG_SOLVER_MESH``, with or
  without tenants; virtual CPU shards under ``--cpu``) and the sector
  planner (``JG_SECTOR=1``), single- and multi-tenant; it refuses a
  malformed mesh spec, a mesh with fewer cards than it names, a custom
  plan topic in multi-tenant mode, and a missing card unless ``--cpu`` is
  given.
"""

import ast
import dataclasses
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.ops import (
    distance,
    field_fused,
    sweep_kernel,
)
from p2p_distributed_tswap_tpu_torch.solver import mapd

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import p2p_distributed_tswap_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k == "p2p_distributed_tswap_tpu"
             or k.startswith("p2p_distributed_tswap_tpu.")
             or k.split(".")[0] in ("jax", "jaxlib", "flax"))
print(len(names), bad)
print(" ".join(names))
"""

# Every module of the port, the kernels' wrappers and their build included.
MODULES = {
    "p2p_distributed_tswap_tpu_torch.convert",
    "p2p_distributed_tswap_tpu_torch.hostsync",
    "p2p_distributed_tswap_tpu_torch.models.scenarios",
    "p2p_distributed_tswap_tpu_torch.ops.cuda_build",
    "p2p_distributed_tswap_tpu_torch.ops.distance",
    "p2p_distributed_tswap_tpu_torch.ops.field_fused",
    "p2p_distributed_tswap_tpu_torch.ops.field_repair",
    "p2p_distributed_tswap_tpu_torch.ops.sector",
    "p2p_distributed_tswap_tpu_torch.ops.sweep_kernel",
    "p2p_distributed_tswap_tpu_torch.solver.invariants",
    "p2p_distributed_tswap_tpu_torch.solver.mapd",
    "p2p_distributed_tswap_tpu_torch.solver.step",
    "p2p_distributed_tswap_tpu_torch.solver.checkpoint",
    "p2p_distributed_tswap_tpu_torch.runtime.solverd",
    "p2p_distributed_tswap_tpu_torch.runtime.plan_codec",
    "p2p_distributed_tswap_tpu_torch.runtime.bus_client",
    "p2p_distributed_tswap_tpu_torch.obs.audit",
    "p2p_distributed_tswap_tpu_torch.obs.registry",
    "p2p_distributed_tswap_tpu_torch.ops.tiled_distance",
    "p2p_distributed_tswap_tpu_torch.parallel.mesh",
    "p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh",
    "p2p_distributed_tswap_tpu_torch.parallel.sharded",
    "p2p_distributed_tswap_tpu_torch.parallel.sharded2d",
    "p2p_distributed_tswap_tpu_torch.parallel.solver_mesh",
    "p2p_distributed_tswap_tpu_torch.ops.reserved_astar",
    "p2p_distributed_tswap_tpu_torch.runtime.simagent",
    "p2p_distributed_tswap_tpu_torch.runtime.ha",
    "p2p_distributed_tswap_tpu_torch.obs.slo",
    "p2p_distributed_tswap_tpu_torch.obs.fleet_aggregator",
    "p2p_distributed_tswap_tpu_torch.solver.oracle",
    "p2p_distributed_tswap_tpu_torch.device",
    "p2p_distributed_tswap_tpu_torch.metrics.task_metrics",
    "p2p_distributed_tswap_tpu_torch.obs.health",
}

# Copied from the JAX package: the same code, with the package name
# rewritten and the JAX package's change-history tags ("ISSUE 10",
# "PR 9 (dynamic worlds)") dropped from comments and docstrings, as
# ``copy_of`` does it.
COPIES = (
    "obs/__init__.py", "obs/audit.py", "obs/beacon.py", "obs/capture.py",
    "obs/events.py", "obs/flightrec.py", "obs/heartbeat.py",
    "obs/registry.py", "obs/trace.py", "runtime/__init__.py",
    "runtime/bus_client.py", "runtime/buspool.py", "runtime/busns.py",
    "runtime/fleet.py", "runtime/plan_codec.py", "runtime/region.py",
    "runtime/shardmap.py", "runtime/shmlane.py",
    # the live fleet's harness side: the sim-agent pool, the SLO engine,
    # the fleet aggregator and the control-plane HA helpers
    "runtime/simagent.py", "obs/slo.py", "obs/fleet_aggregator.py",
    "runtime/ha.py",
    # the sequential oracle the parity twin holds the solver against
    "solver/oracle.py",
    # the last modules: the task metrics and the fleet health plane
    "metrics/__init__.py", "metrics/task_metrics.py", "obs/health.py",
)


# The port's counterpart of each module of the JAX package, where its path
# differs: the Pallas sweep is bound as the CUDA sweep's wrapper.
RENAMED = {"ops/sweep_pallas.py": "ops/sweep_kernel.py"}


def test_every_jax_module_has_a_counterpart_in_the_port():
    jax_pkg = REPO / "p2p_distributed_tswap_tpu"
    port_pkg = REPO / "p2p_distributed_tswap_tpu_torch"
    rels = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py"))
    assert "ops/sweep_pallas.py" in rels and len(rels) > 40
    missing = [rel for rel in rels
               if not (port_pkg / RENAMED.get(rel, rel)).exists()]
    assert missing == []


def _python(code_or_args, **kw):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) \
        else code_or_args
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_and_chip_smoke_import_no_jax():
    out = _python(_IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    summary, names = out.stdout.splitlines()
    count, bad = summary.split(maxsplit=1)
    assert int(count) >= 42
    assert MODULES <= set(names.split())
    assert bad.strip() == "[]", bad


_IMPORT_ONE = """
import importlib, sys
importlib.import_module({name!r})
print(sorted(k for k in sys.modules
             if k == "p2p_distributed_tswap_tpu"
             or k.startswith("p2p_distributed_tswap_tpu.")
             or k.split(".")[0] in ("jax", "jaxlib", "flax")))
"""


@pytest.mark.parametrize("name", ["ops.field_repair", "ops.sector"])
def test_repair_and_sector_modules_import_no_jax(name):
    """The dynamic-world repair and the sector planner, imported alone in
    a fresh interpreter, bring in neither JAX nor the JAX package (the JAX
    package's modules of the same names import jax at their top)."""
    out = _python(_IMPORT_ONE.format(
        name=f"p2p_distributed_tswap_tpu_torch.{name}"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    src = (REPO / "p2p_distributed_tswap_tpu_torch"
           / (name.replace(".", "/") + ".py")).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|p2p_distributed_tswap_tpu)"
                         r"\b(?!_torch)", src, re.M)


@pytest.mark.parametrize("name", [
    "ops.tiled_distance", "parallel.mesh", "parallel.virtual_mesh",
    "parallel.sharded", "parallel.sharded2d", "parallel.solver_mesh"])
def test_mesh_modules_import_no_jax(name):
    """The multi-device layers, each imported alone in a fresh
    interpreter, bring in neither JAX nor the JAX package."""
    out = _python(_IMPORT_ONE.format(
        name=f"p2p_distributed_tswap_tpu_torch.{name}"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    src = (REPO / "p2p_distributed_tswap_tpu_torch"
           / (name.replace(".", "/") + ".py")).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|p2p_distributed_tswap_tpu)"
                         r"\b(?!_torch)", src, re.M)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def test_solve_without_device_refuses_the_cpu(no_cuda):
    grid = Grid.from_ascii("\n".join(["." * 6] * 6))
    starts = np.array([0, 7], np.int32)
    tasks = np.array([[3, 20]], np.int32)
    before = mapd.hostsync.count
    with pytest.raises(RuntimeError, match="CUDA"):
        mapd.solve_offline(grid, starts, tasks)
    with pytest.raises(RuntimeError, match="CUDA"):
        mapd.prepare_state(mapd.SolverConfig(6, 6, 2), starts, tasks,
                           grid.free)
    assert mapd.hostsync.count == before  # nothing ran


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result(no_cuda):
    out = _python(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


def test_cuda_wrapper_refuses_cpu_tensors():
    d = torch.zeros((1, 4, 4), dtype=torch.int32)
    blocked = torch.zeros((4, 4), dtype=torch.uint8)
    before = sweep_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        sweep_kernel.sweep_scan(d, blocked, 1, False)
    assert sweep_kernel.launches == before


def test_sweep_dispatch_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.integers(0, 9, (2, 5, 7)).astype(np.int32))
    blocked = torch.from_numpy((rng.random((5, 7)) > 0.7).astype(np.uint8))
    for axis in (1, 2):
        for reverse in (False, True):
            assert torch.equal(
                distance._sweep(d, blocked, axis, reverse),
                sweep_kernel.sweep_plain(d, blocked, axis, reverse))


def test_per_field_masks_dispatch_by_device():
    """An (R, H, W) mask, one per field: a CPU batch takes the plain
    version, equal to each field swept alone against its own mask, and
    launches nothing; the kernel's wrapper refuses the CPU tensors."""
    rng = np.random.default_rng(2)
    d = torch.from_numpy(rng.integers(0, 9, (3, 5, 7)).astype(np.int32))
    blocked = torch.from_numpy((rng.random((3, 5, 7)) > 0.7)
                               .astype(np.uint8))
    blocked[2] = 1  # a fully blocked padded layer
    before = sweep_kernel.launches
    for axis in (1, 2):
        for reverse in (False, True):
            got = distance._sweep(d, blocked, axis, reverse)
            for k in range(3):
                assert torch.equal(got[k:k + 1], sweep_kernel.sweep_plain(
                    d[k:k + 1], blocked[k], axis, reverse))
    assert (got[2] == distance.INF).all()
    with pytest.raises(ValueError, match="CUDA"):
        sweep_kernel.sweep_scan(d, blocked, 1, False)
    assert sweep_kernel.launches == before


def test_fused_wrapper_refuses_cpu_tensors():
    free = torch.ones((8, 128), dtype=torch.bool)
    goals = torch.zeros(2, dtype=torch.int32)
    before = dict(field_fused.launches)
    for mode in ("single", "multi"):
        with pytest.raises(ValueError, match="CUDA"):
            field_fused.fused_kernel(free, goals, 8, mode)
    assert field_fused.launches == before


def test_fused_dispatch_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    free = torch.from_numpy(rng.random((8, 128)) > 0.2)
    goals = torch.tensor([0, 300, 1000], dtype=torch.int32)
    want = field_fused.fields_plain(free, goals)
    assert torch.equal(field_fused.single_direction_fields(free, goals), want)
    assert torch.equal(field_fused.multi_direction_fields(free, goals), want)


_COPY_RULES = (
    (r"\bp2p_distributed_tswap_tpu\b", "p2p_distributed_tswap_tpu_torch"),
    (r'next to the rings \(ISSUE "\n(\s*)"11\) and',
     r'next to the rings "\n\1"and'),
    (r"PR \d+ \(([^)]*)\)", r"\1"),
    (r"the PR \d+ caveat", "the dynamic-world caveat"),
    (r"\n(\s*)\(ISSUE \d+\)\.  ", r".\n\1"),
    (r" \(ISSUE \d+(?: satellite| tentpole)?\)", ""),
    (r"\(ISSUE \d+(?: satellite| tentpole)?, ", "("),
    (r"\(ISSUE \d+ ", "("),
    (r", ISSUE \d+", ""),
    (r" up to PR \d+ ", " "),
    (r"PR \d+'s ", "the "),
    (r"\(ISSUE \d+,\n(\s*)", r"(\n\1"),
    (r"ISSUE \d+ satellite \(([^)]*)\): ", r"(\1): "),
    (r'"""ISSUE \d+: ', '"""'),
    (r" \(\+ ISSUE \d+\):", ":"),
    (r"\(PR \d+ contract, ", "(the sharded bus's contract, "),
)


def copy_of(original: str) -> str:
    """The port's copy of a JAX-free module of the JAX package."""
    for pattern, repl in _COPY_RULES:
        original = re.sub(pattern, repl, original)
    return original


@pytest.mark.parametrize("rel", COPIES)
def test_jax_free_module_is_a_copy(rel):
    original = (REPO / "p2p_distributed_tswap_tpu" / rel).read_text()
    copy = (REPO / "p2p_distributed_tswap_tpu_torch" / rel).read_text()
    assert copy == copy_of(original)
    # the same code: only comments, strings and the package name differ
    assert _code_shape(copy) == _code_shape(original)
    assert not re.search(r"\bISSUE \d|\bPR \d", copy)


def _code_shape(src: str) -> str:
    """The module's syntax tree with every string constant emptied and the
    package name folded, so that two modules differing only in comments,
    docstrings and messages compare equal."""
    src = re.sub(r"\bp2p_distributed_tswap_tpu(_torch)?\b", "pkg", src)
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            node.value = ""
    return ast.dump(tree)


def test_port_registry_and_tracer_are_its_own():
    from p2p_distributed_tswap_tpu_torch.obs import registry as port_reg
    from p2p_distributed_tswap_tpu.obs import registry as jax_reg

    assert port_reg is not jax_reg
    assert port_reg.get_registry() is not jax_reg.get_registry()


def _solverd(args, env_extra=None, env_drop=()):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update(env_extra or {})
    return _python(["-m", "p2p_distributed_tswap_tpu_torch.runtime.solverd",
                    "--port", "1", *args], env=env)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("args,env_extra", [
    (["--mesh", "2"], {}),
    ([], {"JG_SOLVER_MESH": "2x2"}),
    (["--tenants", "a,b", "--mesh", "2"], {}),
], ids=["mesh", "mesh-env", "tenants"])
def test_daemon_serves_the_mesh(args, env_extra):
    """The mesh, with or without tenants, comes up on virtual CPU shards
    under ``--cpu`` on a live bus and says so in its banner."""
    from p2p_distributed_tswap_tpu_torch.runtime.fleet import ensure_built

    port = _free_port()
    bus = subprocess.Popen([str(ensure_built() / "mapd_bus"), str(port)],
                           stdout=subprocess.DEVNULL)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JG_SOLVER_MESH", "JG_SECTOR")}
    env.update(env_extra)
    sd = subprocess.Popen(
        [sys.executable, "-m", "p2p_distributed_tswap_tpu_torch.runtime."
         "solverd", "--port", str(port), "--cpu", *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: [lines.append(x) for x in sd.stdout], daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and sd.poll() is None \
                and not any("solverd up" in x for x in lines):
            time.sleep(0.1)
        up = [x for x in lines if "solverd up" in x]
        assert up, lines
        shape = "2x2" if env_extra else "2x1"
        assert f"mesh={shape}" in up[0] and "virtual" in up[0]
    finally:
        sd.terminate()
        sd.wait(timeout=10)
        bus.terminate()
        bus.wait(timeout=10)
    # stopped, the daemon printed its launches (none: the CPU runs the
    # kernels' plain versions) and died of the signal
    reader.join(timeout=10)
    report = [x for x in lines if "solverd kernel launches" in x]
    assert len(report) == 1 and sd.returncode == -15, lines[-3:]
    counts = json.loads(report[0].split("launches ", 1)[1])
    assert counts["since_up"]["sweep_scan"] == 0 == \
        counts["total"]["sweep_scan"]


def test_daemon_takes_a_virtual_mesh_of_the_card_when_asked(monkeypatch):
    """``JG_SOLVER_MESH_VIRTUAL=1`` lays a mesh on the card over virtual
    shards of ``cuda:0`` instead of asking for A*T cards; unset, a mesh on
    the card takes real cards (and is refused where there are fewer)."""
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    grid = Grid.from_ascii("\n".join(["." * 8] * 8))
    args = types.SimpleNamespace(tenants=None, multi_tenant=False,
                                 solver_topic="solver", mesh="2", cpu=False)
    monkeypatch.delenv("JG_SOLVER_MESH", raising=False)
    monkeypatch.setenv(solverd.VIRTUAL_MESH_ENV, "1")
    mesh = solverd.build_mesh(args, grid)
    assert mesh.mesh.virtual and mesh.lead == torch.device("cuda", 0)
    assert mesh.shape_str == "2x1"
    if not torch.cuda.is_available():
        assert "CUDA" in solverd.refusal(args)
        monkeypatch.delenv(solverd.VIRTUAL_MESH_ENV)
        assert "mesh needs 2 devices" in solverd.refusal(args)


@pytest.mark.parametrize("args,says", [
    (["--mesh", "0", "--cpu"], "bad mesh spec"),
    (["--mesh", "2"], "mesh needs 2 devices"),
], ids=["malformed", "too-few-cards"])
def test_daemon_refuses_a_mesh_it_cannot_serve(args, says):
    """A malformed spec exits 2; so does a mesh on the card with fewer
    cards than it names (here none, or one), never serving flat."""
    if "--cpu" not in args and torch.cuda.is_available() \
            and torch.cuda.device_count() >= 2:
        pytest.skip("checks a machine with fewer than 2 cards")
    out = _solverd(args, env_drop=("JG_SOLVER_MESH", "JG_SECTOR"))
    assert out.returncode == 2
    assert says in out.stderr and "❌" in out.stderr
    assert "solverd up" not in out.stdout


@pytest.mark.parametrize("multi_tenant", [True, False],
                         ids=["multi-tenant", "sector"])
def test_daemon_serves_the_sector_planner(monkeypatch, multi_tenant):
    """``JG_SECTOR=1`` is served, single-tenant and with
    ``--multi-tenant``: nothing in the arguments or the environment is
    refused."""
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    monkeypatch.delenv("JG_SOLVER_MESH", raising=False)
    monkeypatch.setenv("JG_SECTOR", "1")
    args = types.SimpleNamespace(tenants=None, multi_tenant=multi_tenant,
                                 solver_topic="solver", mesh=None, cpu=True)
    assert solverd.refusal(args) is None


@pytest.mark.parametrize("args", [
    ["--tenants", "t0", "--solver-topic", "solver.r1"],
    ["--multi-tenant", "--solver-topic", "solver.r1"],
], ids=["tenants", "multi-tenant"])
def test_daemon_refuses_a_custom_topic_with_tenants(args):
    out = _solverd([*args, "--cpu"], env_drop=("JG_SOLVER_MESH", "JG_SECTOR",
                                               "JG_SOLVER_TOPIC"))
    assert out.returncode == 2
    assert "--solver-topic is incompatible with multi-tenant" in out.stderr
    assert "solverd up" not in out.stdout


@pytest.mark.parametrize("args", [["--tenants", "t0,t1"], ["--multi-tenant"]],
                         ids=["tenants", "multi-tenant"])
def test_tenant_daemon_without_cuda_refuses_the_cpu(no_cuda, args):
    out = _solverd(args, env_drop=("JG_SOLVER_MESH", "JG_SECTOR"))
    assert out.returncode == 2
    assert "CUDA" in out.stderr and "--cpu" in out.stderr
    assert "solverd up" not in out.stdout


def test_runtime_config_is_the_jax_packages():
    from p2p_distributed_tswap_tpu.core.config import RuntimeConfig as J
    from p2p_distributed_tswap_tpu_torch.core.config import RuntimeConfig as T

    def shape(cls):
        return [(f.name, f.type, f.default)
                for f in dataclasses.fields(cls)]

    assert shape(T) == shape(J)
    kw = {"planning_interval_ms": 250, "log_level": "debug",
          "task_csv_path": "t.csv"}
    assert T(**kw).to_env() == J(**kw).to_env()
    assert T().to_env() == J().to_env()


class _FakeProc:
    pid = 4242

    def __init__(self, cmd, stdin=None, stdout=None, stderr=None, env=None):
        self.cmd, self.env = cmd, env
        self.stdin = types.SimpleNamespace(write=lambda b: None,
                                           flush=lambda: None)

    def poll(self):
        return None

    def send_signal(self, sig):
        pass

    def wait(self, timeout=None):
        return 0


def test_port_fleet_spawns_the_port_daemon(monkeypatch, tmp_path):
    """The launcher's commands, built without the C++ binaries: the
    centralized ``--solver tpu`` fleet starts the port's daemon with the
    caller's arguments, and its RuntimeConfig reaches every child."""
    from p2p_distributed_tswap_tpu_torch.core.config import RuntimeConfig
    from p2p_distributed_tswap_tpu_torch.runtime import fleet

    procs = []

    def popen(cmd, **kw):
        procs.append(_FakeProc(cmd, **kw))
        return procs[-1]

    monkeypatch.setattr(fleet, "ensure_built", lambda: tmp_path / "build")
    monkeypatch.setattr(fleet, "subprocess", types.SimpleNamespace(
        Popen=popen, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT,
        TimeoutExpired=subprocess.TimeoutExpired))
    monkeypatch.setattr(fleet, "time", types.SimpleNamespace(
        sleep=lambda s: None, monotonic=__import__("time").monotonic))
    monkeypatch.setattr(fleet, "wait_for_log", lambda *a, **k: True)
    f = fleet.Fleet("centralized", num_agents=2, port=7777,
                    map_file="m.txt", solver="tpu", log_dir=tmp_path / "logs",
                    config=RuntimeConfig(planning_interval_ms=250),
                    solverd_args=["--tenants", "t0,t1"])
    cmds = {name: p.cmd for name, p in zip(f._names, procs)}
    assert cmds["solverd"] == [
        sys.executable, "-m", "p2p_distributed_tswap_tpu_torch.runtime.solverd",
        "--port", "7777", "--map", "m.txt", "--tenants", "t0,t1"]
    assert cmds["manager"][1:] == ["--port", "7777", "--map", "m.txt",
                                   "--solver", "tpu"]
    assert sorted(cmds) == ["agent_1", "agent_2", "bus", "manager",
                            "solverd"]
    assert {p.env["MAPD_PLANNING_INTERVAL_MS"] for p in procs} == {"250"}
    f.close()
    assert [r["proc"] for r in f.exit_summary] == [
        "bus", "solverd", "manager", "agent_1", "agent_2"]


def test_daemon_without_cuda_refuses_the_cpu(no_cuda):
    out = _solverd([], env_drop=("JG_SOLVER_MESH", "JG_SECTOR"))
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "--cpu" in out.stderr
    assert "solverd up" not in out.stdout


def test_plan_service_builds_the_sector_planner_on_the_cpu(monkeypatch):
    from p2p_distributed_tswap_tpu_torch.ops import sector
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    grid = Grid.from_ascii("\n".join(["." * 6] * 6))
    monkeypatch.setenv("JG_SECTOR", "1")
    monkeypatch.delenv("JG_SECTOR_JIT", raising=False)
    svc = solverd.PlanService(grid, device="cpu")
    assert isinstance(svc.sector, sector.SectorPlanner)
    assert svc.sector.device.type == "cpu" and not svc.sector.use_jit
    assert svc.sector.free is svc.free_np  # toggles reach it in place
    monkeypatch.delenv("JG_SECTOR")
    assert solverd.PlanService(grid, device="cpu").sector is None


def test_plan_service_refuses_missing_cuda(monkeypatch):
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    grid = Grid.from_ascii("\n".join(["." * 6] * 6))
    monkeypatch.delenv("JG_SECTOR", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            solverd.PlanService(grid)
    assert solverd.PlanService(grid, device="cpu").defer_fields


# Each twin: (its original, the original's lines it drops, the lines it
# adds), against ``copy_of(original)``.  Nothing else may differ: the usage
# lines name the twin, the ``--cpu`` flag is added (or, in the crossover,
# replaces ``--tpu``), and the daemon takes ``--cpu`` only from it; the
# maps and logs the original writes to fixed ``/tmp`` paths go under the
# run's ``--log-dir`` or, in the crossover, the temporary directory
# (``TMPDIR``) under names of the twin's own.
_CPU_HELP = 'help="run solverd on the CPU (the default is the card)")'
TWINS = {
    "scripts/torch_chaos_gate.py": (
        "scripts/chaos_gate.py",
        ["JAX_PLATFORMS=cpu python scripts/chaos_gate.py \\",
         "python scripts/chaos_gate.py --capture C --faults \\",
         "--out results/replay_r13.json",
         "from analysis import fleetsim",
         'ap.add_argument("--log-dir", default="/tmp/jg_chaos_logs")'],
        ["python scripts/torch_chaos_gate.py [--cpu] \\",
         "python scripts/torch_chaos_gate.py --capture C --faults \\",
         "--out results/torch_replay.json",
         "import tempfile",
         "from analysis import torch_fleetsim as fleetsim",
         'ap.add_argument("--log-dir", default=os.path.join(',
         'tempfile.gettempdir(), "torch_chaos_logs"))',
         'ap.add_argument("--cpu", action="store_true",', _CPU_HELP,
         "from analysis import torch_fleetsim",
         'torch_fleetsim.SOLVERD_DEVICE_ARGS[:] = ["--cpu"] if args.cpu '
         "else []"]),
    "scripts/torch_audit_smoke.py": (
        "scripts/audit_smoke.py",
        ["Usage:  JAX_PLATFORMS=cpu python scripts/audit_smoke.py",
         '"--port", str(port), "--cpu", "--map", str(mapf),'],
        ["Usage:  python scripts/torch_audit_smoke.py [--cpu]",
         'ap.add_argument("--cpu", action="store_true",', _CPU_HELP,
         '"--port", str(port), *(["--cpu"] if args.cpu else []),',
         '"--map", str(mapf),']),
    "analysis/torch_fleetsim.py": (
        "analysis/fleetsim.py",
        ["python analysis/fleetsim.py --agents 1000 --shards 2 --out \\\\",
         "python analysis/fleetsim.py --agents 40 --side 24 --window 8 \\\\",
         "python analysis/fleetsim.py --saturate 250,500,1000,2000 --shards 3",
         'args.map_file, "--warm", str(agents), "--cpu",',
         'map_file = f"/tmp/fleetsim_replay_{side}.map.txt"',
         '"--warm", str(agents), "--cpu",',
         '"--port", str(port), "--map", args.map_file, "--cpu",',
         'ap.add_argument("--log-dir", default="/tmp/fleetsim_logs")',
         'args.map_file = f"/tmp/fleetsim_{args.side}.map.txt"',
         'args.map_file = f"/tmp/fleetsim_{args.side}.map.txt"'],
        ["python analysis/torch_fleetsim.py --agents 1000 --shards 2 --out "
         "\\\\",
         "python analysis/torch_fleetsim.py --agents 40 --side 24 --window 8 "
         "\\\\",
         "python analysis/torch_fleetsim.py --saturate 250,500,1000,2000 "
         "--shards 3",
         "import tempfile",
         "",
         "# the daemon plans on the card unless --cpu asks for the CPU (main "
         "sets it)",
         "SOLVERD_DEVICE_ARGS: list = []",
         "", "",
         "def _map_path(log_dir, name: str) -> str:",
         '"""A map file of this run, under its log directory, which no '
         'other',
         'run shares."""',
         "Path(log_dir).mkdir(parents=True, exist_ok=True)",
         "return str(Path(log_dir).resolve() / name)",
         'args.map_file, "--warm", str(agents),', "*SOLVERD_DEVICE_ARGS,",
         'map_file = _map_path(log_dir, f"fleetsim_replay_{side}.map.txt")',
         '"--warm", str(agents), *SOLVERD_DEVICE_ARGS,',
         '"--port", str(port), "--map", args.map_file,',
         "*SOLVERD_DEVICE_ARGS,",
         'ap.add_argument("--log-dir", default=os.path.join(',
         'tempfile.gettempdir(), "torch_fleetsim_logs"))',
         'ap.add_argument("--cpu", action="store_true",', _CPU_HELP,
         'SOLVERD_DEVICE_ARGS[:] = ["--cpu"] if args.cpu else []',
         "args.map_file = _map_path(args.log_dir,",
         'f"fleetsim_{args.side}.map.txt")',
         "args.map_file = _map_path(args.log_dir,",
         'f"fleetsim_{args.side}.map.txt")']),
    "analysis/torch_tenant_scaling.py": (
        "analysis/tenant_scaling.py",
        ["python analysis/tenant_scaling.py --tenants 8 --agents 6 \\\\",
         "python analysis/tenant_scaling.py --smoke      # the CI gate (fast)",
         '"--port", str(port), "--map", args.map_file, "--cpu",',
         'ap.add_argument("--log-dir", default="/tmp/tenant_scaling_logs")',
         'args.map_file = f"/tmp/tenant_scaling_{args.side}.map.txt"'],
        ["python analysis/torch_tenant_scaling.py --tenants 8 --agents 6 "
         "\\\\",
         "python analysis/torch_tenant_scaling.py --smoke [--cpu]  # the CI "
         "gate",
         "import tempfile",
         '"--port", str(port), "--map", args.map_file,',
         '*(["--cpu"] if args.cpu else []),',
         'ap.add_argument("--log-dir", default=os.path.join(',
         'tempfile.gettempdir(), "torch_tenant_scaling_logs"))',
         'ap.add_argument("--cpu", action="store_true",', _CPU_HELP,
         "Path(args.log_dir).mkdir(parents=True, exist_ok=True)",
         "args.map_file = str(Path(args.log_dir).resolve()",
         '/ f"tenant_scaling_{args.side}.map.txt")']),
    "analysis/torch_solver_crossover.py": (
        "analysis/solver_crossover.py",
        ["python analysis/solver_crossover.py --out "
         "results/solver_crossover.json",
         "python analysis/solver_crossover.py --counts 50,300 --window 10  "
         "# smoke",
         'log = open(f"/tmp/crossover_{name}_{variant}_{n}.log", "w")',
         'f"/tmp/crossover_solverd_{variant}_{n}.log",',
         'ap.add_argument("--tpu", action="store_true",',
         'help="run solverd on the accelerator backend "',
         '"(default: --cpu, the honest CI floor)")',
         'map_file = f"/tmp/crossover_{args.side}.map.txt"',
         "args.window, args.settle, cpu=not args.tpu)",
         '"solverd_backend": "accelerator" if args.tpu else "cpu",'],
        ["python analysis/torch_solver_crossover.py --out "
         "results/solver_crossover.json",
         "python analysis/torch_solver_crossover.py --counts 50,300 "
         "--window 10  # smoke",
         "import tempfile",
         "# logs and the map in the temporary directory, under names of "
         "their own",
         "TMP = tempfile.gettempdir()",
         'log = open(f"{TMP}/torch_crossover_{name}_{variant}_{n}.log", '
         '"w")',
         'f"{TMP}/torch_crossover_solverd_{variant}_{n}.log",',
         'ap.add_argument("--cpu", action="store_true",', _CPU_HELP,
         'map_file = f"{TMP}/torch_crossover_{args.side}.map.txt"',
         "args.window, args.settle, cpu=args.cpu)",
         '"solverd_backend": "cpu" if args.cpu else "accelerator",']),
}


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_differs_from_its_original_only_in_the_daemon_device(twin):
    import difflib

    original, dropped, added = TWINS[twin]
    want = copy_of((REPO / original).read_text()).splitlines()
    got = (REPO / twin).read_text().splitlines()
    diff = list(difflib.ndiff(want, got))
    assert [d[2:].strip() for d in diff if d.startswith("- ")] == dropped
    assert [d[2:].strip() for d in diff if d.startswith("+ ")] == added
    assert not re.search(r"\bISSUE \d|\bPR \d", "\n".join(got))


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_writes_no_fixed_tmp_path(twin):
    """The originals write their maps and logs to fixed ``/tmp`` paths; a
    twin run beside its original, or beside another checkout's twin, must
    not truncate a file the other is reading, so no twin names ``/tmp``."""
    assert "/tmp" not in (REPO / twin).read_text()


def _imports(path: pathlib.Path) -> set:
    """Every module a file imports, at its top or inside a function."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def _repo_file(name: str):
    """The repo's source file of a module name, or None (a third-party
    module, or a name imported from a module)."""
    parts = name.split(".")
    for cand in (REPO.joinpath(*parts).with_suffix(".py"),
                 REPO.joinpath(*parts, "__init__.py")):
        if cand.exists():
            return cand
    return None


def _closure(path: pathlib.Path) -> set:
    """The module names reached from ``path`` through the repo's files,
    following imports inside functions too."""
    seen, todo, names = set(), [path], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            names.add(name)
            parts = name.split(".")
            for k in range(1, len(parts) + 1):  # parent packages run too
                sub = _repo_file(".".join(parts[:k]))
                if sub is not None and sub not in seen:
                    todo.append(sub)
    return names


def _jax_names(names) -> list:
    return sorted(n for n in names
                  if n.split(".")[0] in ("jax", "jaxlib", "flax")
                  or n == "p2p_distributed_tswap_tpu"
                  or n.startswith("p2p_distributed_tswap_tpu."))


# The measurement twins of the solver side and the dynamic world: ports of
# their originals (each keeps its original's CLI, plus ``--cpu``, its output
# keys and the order of its computation), not copies pinned line for line.
MEASUREMENT_TWINS = (
    "analysis/torch_parity_table.py", "analysis/torch_congestion.py",
    "analysis/torch_decent_premium.py", "analysis/torch_roofline.py",
    "analysis/torch_quality_gap.py", "analysis/torch_field_bench.py",
    "analysis/torch_sector_bench.py", "scripts/torch_field_fuzz.py",
    "scripts/torch_sector_fuzz.py",
)


# The twins of the mesh scripts: ports, not copies, like the measurement
# twins; each runs virtual shards of the card (or of the CPU under --cpu).
MESH_TWINS = (
    "scripts/torch_mesh_smoke.py", "analysis/torch_mesh_bench.py",
    "analysis/torch_sharded_steptime.py",
    "analysis/torch_extreme_rehearsal.py",
)


@pytest.mark.parametrize("path", [*sorted(TWINS), "chip_smoke.py",
                                  "analysis/torch_live_fleet.py",
                                  *MEASUREMENT_TWINS, *MESH_TWINS])
def test_twins_and_chip_smoke_reach_no_jax(path):
    """No import of a twin, of ``chip_smoke.py`` or of the live-fleet
    reader, followed through every file of the repo it reaches (imports
    inside functions included), names JAX or the JAX package; imported in
    a fresh interpreter, a twin or the reader brings neither in."""
    names = _closure(REPO / path)
    assert "p2p_distributed_tswap_tpu_torch" in {n.split(".")[0]
                                                 for n in names}
    assert _jax_names(names) == []
    if path != "chip_smoke.py":
        code = ("import importlib.util, sys\n"
                f"spec = importlib.util.spec_from_file_location('twin', "
                f"{str(REPO / path)!r})\n"
                "importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(importlib.util.module_from_spec("
                "spec))\n"
                "import analysis.task_timeline\n"
                "print(sorted(k for k in sys.modules if k.split('.')[0] in "
                "('jax', 'jaxlib', 'flax') or k == "
                "'p2p_distributed_tswap_tpu' or k.startswith("
                "'p2p_distributed_tswap_tpu.')))")
        out = _python(code)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_spawns_the_port_daemon_with_cpu_only_when_asked(twin):
    """Every daemon module a twin names is the port's; every ``--cpu`` it
    writes sits in its own flag's definition or under a condition on it."""
    tree = ast.parse((REPO / twin).read_text())
    parent = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    consts = [n for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    daemons = {n.value for n in consts if n.value.endswith(".solverd")}
    if twin == "scripts/torch_chaos_gate.py":
        # it spawns the daemon through the fleetsim twin's replays
        assert daemons == set()
        assert "analysis.torch_fleetsim" in _imports(REPO / twin)
    else:
        assert daemons == {"p2p_distributed_tswap_tpu_torch.runtime.solverd"}
    cpu = [n for n in consts if n.value == "--cpu"]
    assert cpu
    for node in cpu:
        up, guarded = node, False
        while up in parent and not guarded:
            up = parent[up]
            guarded = (isinstance(up, (ast.IfExp, ast.If))
                       and "cpu" in ast.unparse(up.test)) or (
                isinstance(up, ast.Call)
                and ast.unparse(up.func).endswith("add_argument"))
        assert guarded, ast.unparse(parent[node])


@pytest.mark.parametrize("argv,log", [
    (["scripts/torch_audit_smoke.py"], "solverd.log"),
    (["analysis/torch_tenant_scaling.py", "--smoke"],
     "tenants2/solverd.log"),
    (["analysis/torch_fleetsim.py", "--replay",
      "results/captures/ci_small.capture.json", "--replay-solver", "tpu"],
     "replay/solverd.log"),
    (["scripts/torch_chaos_gate.py", "--capture",
      "results/captures/ci_small.capture.json", "--faults",
      "solverd_sigkill"], "0_solverd_sigkill/solverd.log"),
], ids=["audit_smoke", "tenant_scaling", "fleetsim", "chaos_gate"])
def test_twin_without_cpu_runs_the_daemon_on_the_card(no_cuda, tmp_path,
                                                      argv, log):
    """Without ``--cpu`` a twin's daemon plans on the card: where there is
    none it refuses, naming CUDA and ``--cpu``, and the twin fails."""
    out = _python([*argv, "--log-dir", str(tmp_path)])
    assert out.returncode != 0
    text = (tmp_path / log).read_text()
    assert "CUDA" in text and "--cpu" in text
    assert "solverd up" not in text


def test_daemon_beacon_carries_its_kernel_launches(monkeypatch):
    """The daemon's beacon sets the process's launch counts of every
    kernel as gauges when it builds a payload, and the payload carries
    them; between beats the counts are not read."""
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    class Bus:
        peer_id = "solverd-test"
        published = []

        def publish(self, topic, data):
            self.published.append((topic, data))

    beacon = solverd.LaunchBeacon(Bus(), proc="solverd", interval_s=3600)
    monkeypatch.setattr(sweep_kernel, "launches", 7)
    monkeypatch.setitem(field_fused.launches, "single", 3)
    payload = beacon.maybe_beat()
    monkeypatch.setattr(sweep_kernel, "launches", 8)
    assert beacon.maybe_beat() is None
    assert Bus.published == [("mapd.metrics", payload)]
    gauges = payload["metrics"]["gauges"]
    assert gauges['solverd.kernel_launches{kernel="sweep_scan"}'] == 7
    assert gauges['solverd.kernel_launches{kernel="field_fused_single"}'] \
        == 3
    assert 'solverd.kernel_launches{kernel="field_fused_multi"}' in gauges


def _docstrings(tree) -> set:
    return {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


@pytest.mark.parametrize("twin", [*MEASUREMENT_TWINS, *MESH_TWINS])
def test_measurement_twin_writes_no_original_result_by_default(twin):
    """No fixed ``/tmp`` path, and no string of the code (docstrings
    aside) names ``PARITY.md`` or a ``results/*_rNN.json`` artifact of the
    JAX package: the twins' defaults are files of their own."""
    text = (REPO / twin).read_text()
    assert "/tmp" not in text
    tree = ast.parse(text)
    docs = _docstrings(tree)
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and id(n) not in docs]
    bad = [v for v in strings
           if "PARITY.md" in v or re.search(r"_r\d+\.json", v)]
    assert bad == []
    assert not re.search(r"\bISSUE \d|\bPR \d", text)


@pytest.mark.parametrize("twin", [*MEASUREMENT_TWINS, *MESH_TWINS])
def test_measurement_twin_without_cuda_refuses_unless_cpu(no_cuda, twin):
    """Without CUDA a twin exits nonzero at once, naming CUDA and
    ``--cpu``, and writes nothing."""
    out = _python([twin])
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "--cpu" in out.stderr
    assert "Traceback" not in out.stderr
