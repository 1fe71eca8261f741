"""The port's checkpoints against the JAX package's.

An archive written by either package restores in the other with every
field equal, a resumed solve is bit-identical to an uninterrupted one, and
a format-1 archive (before the stale view) restores with the view seeded
fresh at the archived step, as in the JAX package.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.core.config import SolverConfig as JaxConfig
from p2p_distributed_tswap_tpu.core.grid import Grid
from p2p_distributed_tswap_tpu.core.sampling import start_positions_array
from p2p_distributed_tswap_tpu.core.tasks import TaskGenerator
from p2p_distributed_tswap_tpu.solver import checkpoint as jckpt
from p2p_distributed_tswap_tpu.solver import mapd as jmapd
from p2p_distributed_tswap_tpu_torch import convert
from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.solver import checkpoint as tckpt
from p2p_distributed_tswap_tpu_torch.solver import mapd as tmapd

CPU = torch.device("cpu")
FIELDS = [f.name for f in dataclasses.fields(tmapd.MapdState)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _instance(radius=None, **kw):
    grid = Grid.random_obstacles(20, 20, 0.15, seed=2)
    n, t = 8, 10
    starts = start_positions_array(grid, n, seed=0)
    tasks = TaskGenerator(grid, seed=1).generate_task_arrays(t)
    ckw = dict(height=20, width=20, num_agents=n, visibility_radius=radius,
               **kw)
    return grid, starts, tasks, JaxConfig(**ckw), SolverConfig(**ckw)


def _port_steps(cfg, s, tasks, free, steps):
    for _ in range(steps):
        s = tmapd.mapd_step(cfg, s, tasks, free)
    return s


def _port_finish(cfg, s, tasks, free):
    while not bool(tmapd._finished(cfg, s)):
        s = tmapd.mapd_step(cfg, s, tasks, free)
    return s


def _jax_state(cfg, starts, tasks, free, steps):
    step = jax.jit(functools.partial(jmapd.mapd_step, cfg))
    s, tasks_j = jax.jit(functools.partial(jmapd.prepare_state, cfg))(
        jnp.asarray(starts, jnp.int32), jnp.asarray(tasks, jnp.int32),
        jnp.asarray(free))
    for _ in range(steps):
        s = step(s, tasks_j, jnp.asarray(free))
    return s, tasks_j, step


def _assert_same(jax_state, port_state):
    want = {n: np.asarray(getattr(jax_state, n)) for n in FIELDS}
    got = convert.state_to_numpy(port_state)
    for name in FIELDS:
        assert want[name].dtype == got[name].dtype, name
        np.testing.assert_array_equal(want[name], got[name], err_msg=name)


@pytest.mark.parametrize("radius,stale", [(None, False), (5, True)],
                         ids=["centralized", "decent-stale"])
def test_jax_archive_loads_into_port_and_resumes(tmp_path, radius, stale):
    kw = dict(view_refresh_steps=2, swap_commit_delay=1) if stale else {}
    grid, starts, tasks, cfg_j, cfg_t = _instance(radius, **kw)
    s_j, tasks_j, step = _jax_state(cfg_j, starts, tasks, grid.free, 6)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, s_j, extra={"steps": 6})
    s_t = tckpt.load_state(path, cfg_t, expected_num_tasks=len(tasks),
                           device=CPU)
    _assert_same(s_j, s_t)
    assert int(tckpt.load_extra(path)["steps"]) == 6
    free_t = torch.from_numpy(grid.free.copy())
    tasks_t = torch.from_numpy(np.array(tasks_j))
    for _ in range(5):  # the two packages step on from the same archive
        s_j = step(s_j, tasks_j, jnp.asarray(grid.free))
        s_t = tmapd.mapd_step(cfg_t, s_t, tasks_t, free_t)
        _assert_same(s_j, s_t)


def test_port_archive_loads_into_jax(tmp_path):
    grid, starts, tasks, cfg_j, cfg_t = _instance()
    s_t, tasks_t = tmapd.prepare_state(cfg_t, starts, tasks, grid.free,
                                       device=CPU)
    free_t = torch.from_numpy(grid.free.copy())
    s_t = _port_steps(cfg_t, s_t, tasks_t, free_t, 7)
    path = str(tmp_path / "port.npz")
    tckpt.save_state(path, s_t)
    with np.load(path) as z:
        assert z["dirs"].dtype == np.uint32
        assert int(z["__format_version__"]) == jckpt.FORMAT_VERSION
    s_j = jckpt.load_state(path, cfg_j, expected_num_tasks=len(tasks))
    _assert_same(s_j, s_t)
    s_j = jmapd.mapd_step(cfg_j, s_j, jnp.asarray(tasks_t.numpy()),
                          jnp.asarray(grid.free))
    s_t = tmapd.mapd_step(cfg_t, s_t, tasks_t, free_t)
    _assert_same(s_j, s_t)


def test_resume_is_bit_identical(tmp_path):
    grid, starts, tasks, _, cfg = _instance()
    free = torch.from_numpy(grid.free.copy())
    ref, tasks_t = tmapd.prepare_state(cfg, starts, tasks, free, device=CPU)
    ref = _port_finish(cfg, ref, tasks_t, free)
    s, _ = tmapd.prepare_state(cfg, starts, tasks, free, device=CPU)
    s = _port_steps(cfg, s, tasks_t, free, 5)
    path = str(tmp_path / "solve.npz")
    tckpt.save_state(path, s)
    restored = tckpt.load_state(path, cfg, expected_num_tasks=len(tasks),
                                device=CPU)
    for name in FIELDS:
        a, b = getattr(s, name), getattr(restored, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    done = _port_finish(cfg, restored, tasks_t, free)
    assert int(done.t) == int(ref.t) > 5
    for name in FIELDS:
        assert torch.equal(getattr(done, name), getattr(ref, name)), name


def test_format_1_archive_restores_like_jax(tmp_path):
    grid, starts, tasks, cfg_j, cfg_t = _instance()
    s = tmapd.init_state(cfg_t, torch.from_numpy(starts.astype(np.int32)),
                         len(tasks))
    s = s.replace(goal=torch.roll(s.goal, 1))
    p = str(tmp_path / "v1.npz")
    tckpt.save_state(p, s)
    with np.load(p) as z:
        arrays = {k: z[k] for k in z.files}
    for name in ("vpos", "vgoal", "vstamp", "pend_from", "pend_push"):
        del arrays[name]
    arrays["__format_version__"] = np.asarray(1)
    arrays["t"] = np.asarray(42, np.int32)
    np.savez_compressed(p, **arrays)
    got = tckpt.load_state(p, cfg_t, device=CPU)
    want = jckpt.load_state(p, cfg_j)
    _assert_same(want, got)
    np.testing.assert_array_equal(got.vstamp.numpy(), 42)
    assert torch.equal(got.vgoal, s.goal)


def test_mismatches_are_refused(tmp_path):
    grid, starts, tasks, _, cfg = _instance()
    s = tmapd.init_state(cfg, torch.from_numpy(starts.astype(np.int32)),
                         len(tasks))
    p = str(tmp_path / "s.npz")
    tckpt.save_state(p, s)
    with pytest.raises(ValueError, match="agents"):
        tckpt.load_state(p, dataclasses.replace(cfg, num_agents=9),
                         device=CPU)
    with pytest.raises(ValueError, match="grid"):
        tckpt.load_state(p, SolverConfig(height=16, width=20, num_agents=8),
                         device=CPU)
    with pytest.raises(ValueError, match="tasks"):
        tckpt.load_state(p, cfg, expected_num_tasks=3, device=CPU)
    np.savez_compressed(p, pos=np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="not a solver checkpoint"):
        tckpt.load_state(p, device=CPU)
