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
- The daemon refuses the modes it does not serve yet (mesh, with or
  without tenants, and the sector planner), a custom plan topic in
  multi-tenant mode, and a missing card unless ``--cpu`` is given.
"""

import ast
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
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
)


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
    assert int(count) >= 37
    assert MODULES <= set(names.split())
    assert bad.strip() == "[]", bad


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


@pytest.mark.parametrize("args,env_extra,item", [
    (["--mesh", "2"], {}, "item 7"),
    ([], {"JG_SOLVER_MESH": "2x2"}, "item 7"),
    # multi-tenant mode is served; with a mesh it is the mesh's item
    (["--tenants", "a,b", "--mesh", "2"], {}, "item 7"),
    (["--multi-tenant"], {"JG_SECTOR": "1"}, "item 6"),
    ([], {"JG_SECTOR": "1"}, "item 6"),
], ids=["mesh", "mesh-env", "tenants", "multi-tenant", "sector"])
def test_daemon_refuses_what_is_not_ported(args, env_extra, item):
    out = _solverd([*args, "--cpu"], env_extra,
                   env_drop=("JG_SOLVER_MESH", "JG_SECTOR"))
    assert out.returncode == 2
    assert item in out.stderr and "not ported" in out.stderr
    assert "solverd up" not in out.stdout


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


def test_plan_service_refuses_sector_and_missing_cuda(monkeypatch):
    from p2p_distributed_tswap_tpu_torch.runtime import solverd

    grid = Grid.from_ascii("\n".join(["." * 6] * 6))
    monkeypatch.setenv("JG_SECTOR", "1")
    with pytest.raises(RuntimeError, match="item 6"):
        solverd.PlanService(grid, device="cpu")
    monkeypatch.delenv("JG_SECTOR")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            solverd.PlanService(grid)
    assert solverd.PlanService(grid, device="cpu").defer_fields
