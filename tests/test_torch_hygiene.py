"""Boundaries of the PyTorch port.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points run on the card unless the caller asks for the CPU: without
  CUDA they raise instead of quietly running on the CPU.
- The CUDA kernels' wrappers refuse what the kernels do not take, CPU
  tensors included.
"""

import pathlib
import subprocess
import sys

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
}


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
    assert int(count) >= 14
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
