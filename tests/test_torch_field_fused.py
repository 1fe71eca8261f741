"""The port's fused field engine against the JAX package's.

On the CPU the port's ``single_direction_fields`` and
``multi_direction_fields`` run their plain version; the JAX package's run
its two Pallas kernels in interpret mode, as tests/test_field_fused.py runs
them.  Both must give the same (G, H, W) uint8 codes, including where
``max_rounds`` stops the fixpoint early.  The mode switch, the shape gates
and the dispatch in ``direction_fields`` are held to the JAX package's too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.ops import distance as jd
from p2p_distributed_tswap_tpu.ops import field_fused as jff
from p2p_distributed_tswap_tpu_torch.ops import distance as td
from p2p_distributed_tswap_tpu_torch.ops import field_fused as tff
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel

MODES = {"single": (jff.single_direction_fields, tff.single_direction_fields),
         "multi": (jff.multi_direction_fields, tff.multi_direction_fields)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Thousands of small tensor ops: on the CPU, intra-op threads cost more
    # than they give, most of all with several test workers on the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret_mode():
    jff.INTERPRET = True
    yield
    jff.INTERPRET = False


def _check(mode, free_np, goals_np, max_rounds=128):
    jax_fn, port_fn = MODES[mode]
    want = np.asarray(jax_fn(jnp.asarray(free_np), jnp.asarray(goals_np),
                             max_rounds))
    launches = dict(tff.launches)
    got = port_fn(torch.from_numpy(free_np), torch.from_numpy(goals_np),
                  max_rounds)
    assert tff.launches == launches  # the CPU runs the plain version
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(want, got.numpy())
    return want


def _free(seed, h, w, density):
    return np.random.default_rng(seed).random((h, w)) > density


def _goals(free_np, k, seed, replace=False):
    rng = np.random.default_rng(seed)
    cells = np.flatnonzero(free_np.reshape(-1))
    return rng.choice(cells, k, replace=replace).astype(np.int32)


def test_single_random_obstacles(interpret_mode):
    free = _free(0, 128, 128, 0.3)
    _check("single", free, _goals(free, 3, seed=0))


@pytest.mark.parametrize("mode,h,repeat", [("single", 64, 1),
                                           ("multi", 16, 3)])
def test_goal_on_obstacle_and_corner(interpret_mode, mode, h, repeat):
    """A corner goal, a goal on an obstacle (an all-stay field), and the
    far corner; the multi case repeats them (the same goal in three
    fields of one block)."""
    free = _free(h, h, 128, 0.2)
    free[0, 0] = True
    free[5, 7] = False
    goals = np.array([0, 5 * 128 + 7, (h - 1) * 128 + 127] * repeat,
                     np.int32)
    out = _check(mode, free, goals)
    assert (out[1] == td.DIR_STAY).all()


def test_single_empty_grid(interpret_mode):
    _check("single", np.ones((8, 128), bool),
           np.array([3 * 128 + 64], np.int32))


@pytest.mark.parametrize("g", [16, 11])
def test_multi_full_and_ragged_batches(interpret_mode, g):
    """Two full blocks of eight (G = 16), and G = 11: the goals pad to 16
    by repeating the last one and the pad is dropped."""
    free = _free(g, 64 if g == 16 else 32, 128, 0.3 if g == 16 else 0.25)
    out = _check("multi", free, _goals(free, g, seed=g))
    assert out.shape[0] == g


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_round_cap_binds_on_a_maze(interpret_mode, mode):
    """A maze where 1, 2 and 3 rounds stop short of the fixpoint: per-field
    (single), per-block (multi) and whole-batch (plain) convergence still
    give the same codes."""
    free = _free(5, 32, 128, 0.35)
    goals = _goals(free, 11, seed=5, replace=True)
    full = tff.fields_plain(torch.from_numpy(free), torch.from_numpy(goals))
    for max_rounds in (1, 2, 3):
        out = _check(mode, free, goals, max_rounds)
        assert not np.array_equal(out, full.numpy())  # the cap binds


def test_plain_version_never_launches_a_kernel(monkeypatch):
    """The plain version sweeps with sweep_plain, never sweep_scan: on the
    card it must stay independent of both kernels."""
    def refuse(*args, **kwargs):
        raise AssertionError("sweep_scan called")

    monkeypatch.setattr(sweep_kernel, "sweep_scan", refuse)
    free = _free(1, 16, 128, 0.3)
    goals = torch.from_numpy(_goals(free, 4, seed=1))
    got = tff.fields_plain(torch.from_numpy(free), goals)
    want = td.direction_fields(torch.from_numpy(free), goals)
    assert torch.equal(got, want)


@pytest.mark.parametrize("value,mode", [(None, ""), ("", ""), ("0", ""),
                                        ("1", "multi"), ("multi", "multi"),
                                        ("single", "single"), ("yes", "")])
def test_fused_mode_parsing(monkeypatch, value, mode):
    if value is None:
        monkeypatch.delenv("MAPD_FUSED", raising=False)
    else:
        monkeypatch.setenv("MAPD_FUSED", value)
    assert tff.fused_mode() == jff.fused_mode() == mode


SHAPES = [(8, 128), (64, 128), (60, 128), (64, 100), (100, 100),
          (256, 256), (512, 512), (1024, 1024), (1024, 1536), (1536, 1024),
          (2048, 768), (4096, 4096)]


@pytest.mark.parametrize("h,w", SHAPES)
def test_shape_gates_match(monkeypatch, h, w):
    assert tff.multi_eligible(h, w) == jff.multi_eligible(h, w)
    for env in ("1", "single"):
        monkeypatch.setenv("MAPD_FUSED", env)
        # the JAX package's gate for the same mode on a TPU backend
        monkeypatch.setattr(jff, "_on_tpu", lambda: True)
        assert tff.fused_eligible(h, w, "cuda") == jff.fused_eligible(h, w)
        # never on the CPU, as the JAX package's on a non-TPU backend
        assert not tff.fused_eligible(h, w, "cpu")
        monkeypatch.setattr(jff, "_on_tpu", lambda: False)
        assert not jff.fused_eligible(h, w)


def test_shape_gates_take_the_rungs_paths(monkeypatch):
    """256^2 rungs take multi; 512^2 and 1024^2 only single; 100^2 none."""
    monkeypatch.setenv("MAPD_FUSED", "1")
    assert [tff.fused_eligible(s, s, "cuda") for s in (100, 256, 512, 1024)] \
        == [False, True, False, False]
    monkeypatch.setenv("MAPD_FUSED", "single")
    assert [tff.fused_eligible(s, s, "cuda") for s in (100, 256, 512, 1024)] \
        == [False, True, True, True]


@pytest.mark.parametrize("env", ["1", "single"])
def test_direction_fields_on_cpu_under_mapd_fused(monkeypatch, env):
    monkeypatch.setenv("MAPD_FUSED", env)
    free = _free(3, 32, 128, 0.25)
    goals = _goals(free, 5, seed=3)
    want = np.asarray(jd.direction_fields(jnp.asarray(free),
                                          jnp.asarray(goals)))
    launches = dict(tff.launches)
    got = td.direction_fields(torch.from_numpy(free), torch.from_numpy(goals))
    assert tff.launches == launches
    np.testing.assert_array_equal(want, got.numpy())
