"""The port on the card: the CUDA sweep kernel against its plain version,
and CUDA solves against CPU solves.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, run it without the suite's conftest (which pins
JAX to the CPU):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu_torch import hostsync
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.core.grid import Grid
from p2p_distributed_tswap_tpu_torch.core.sampling import (
    start_positions_array,
)
from p2p_distributed_tswap_tpu_torch.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu_torch.ops import distance, sweep_kernel
from p2p_distributed_tswap_tpu_torch.solver import mapd

pytestmark = pytest.mark.cuda

DIRECTIONS = [(1, False), (1, True), (2, False), (2, True)]
INF = sweep_kernel.INF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: sweep_scan is CUDA code with no "
                    "CPU mode")
    return torch.device("cuda")


def _inputs(seed, r, h, w, edges):
    rng = np.random.default_rng(seed)
    free = rng.random((h, w)) > 0.25
    if edges:
        free[[0, -1], :] = False
        free[:, [0, -1]] = False
    d = np.where(rng.random((r, h, w)) > 0.95,
                 rng.integers(0, 60, (r, h, w)), INF)
    d = np.where(free[None], d, INF).astype(np.int32)
    return torch.from_numpy(d), torch.from_numpy((~free).astype(np.uint8))


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("r,h,w,edges", [
    (1, 100, 100, True), (3, 37, 53, True), (2, 257, 131, False),
    (1, 8, 4096, True), (4, 128, 1024, False), (1, 1, 1, False),
    (2, 33, 1, False), (2, 1, 33, True)])
def test_kernel_matches_plain(cuda, axis, reverse, r, h, w, edges):
    d, blocked = _inputs(5 * h + w + axis + reverse, r, h, w, edges)
    want = sweep_kernel.sweep_plain(d, blocked, axis, reverse)
    before = sweep_kernel.launches
    got = distance._sweep(d.to(cuda), blocked.to(cuda), axis, reverse)
    torch.cuda.synchronize()
    assert sweep_kernel.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_wrapper_checks_dtype_shape_layout(cuda):
    d = torch.zeros((2, 4, 5), dtype=torch.int32, device=cuda)
    m = torch.zeros((4, 5), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        sweep_kernel.sweep_scan(d.long(), m, 1, False)
    with pytest.raises(TypeError):
        sweep_kernel.sweep_scan(d, m.bool(), 1, False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d, m[:, :4].contiguous(), 1, False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d.transpose(1, 2), m.T.contiguous(), 1,
                                False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d, m, 0, False)
    with pytest.raises(ValueError):
        sweep_kernel.sweep_scan(d, m.cpu(), 1, False)


def test_direction_fields_on_cuda_match_cpu(cuda):
    grid = Grid.warehouse(48, 56)
    rng = np.random.default_rng(1)
    goals = torch.from_numpy(rng.choice(
        np.flatnonzero(grid.free.reshape(-1)), 6).astype(np.int32))
    free = torch.from_numpy(grid.free)
    want = distance.direction_fields(free, goals)
    before = sweep_kernel.launches
    got = distance.direction_fields(free.to(cuda), goals.to(cuda))
    assert sweep_kernel.launches > before
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("radius", [None, 15])
def test_solve_on_cuda_matches_cpu(cuda, radius):
    grid = Grid.warehouse(64, 64)
    starts = start_positions_array(grid, 40, seed=2)
    tasks = TaskGenerator(grid, seed=3).generate_task_arrays(40)
    cfg = SolverConfig(height=64, width=64, num_agents=40,
                       visibility_radius=radius)
    want = mapd.solve_offline(grid, starts, tasks, cfg, device="cpu")
    syncs = hostsync.count
    got = mapd.solve_offline(grid, starts, tasks, cfg)  # default: cuda
    assert hostsync.count > syncs
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
