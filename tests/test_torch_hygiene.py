"""Boundaries of the PyTorch port.

- The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
- Entry points run on the card unless the caller asks for the CPU: without
  CUDA they raise instead of quietly running on the CPU.
- The CUDA kernel's wrapper refuses what the kernel does not take.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.ops import distance, sweep_kernel
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
"""


def _python(code_or_args, **kw):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) \
        else code_or_args
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_and_chip_smoke_import_no_jax():
    out = _python(_IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(maxsplit=1)
    assert int(count) >= 12
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
