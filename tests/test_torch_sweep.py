"""The port's directional sweep against the JAX package's.

``ops.sweep_kernel.sweep_plain`` (the plain version of the CUDA kernel, and
the port's CPU path) must equal the JAX package's doubling-scan sweep
(``distance._sweep_xla``) and its Pallas kernels (run through the Pallas
interpreter, as tests/test_sweep_pallas.py runs them) bit for bit: all are
the same integer recurrence, so the tolerance is zero.  The CUDA kernel is
held against the plain version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_distributed_tswap_tpu.ops import distance, sweep_pallas
from p2p_distributed_tswap_tpu_torch.ops import distance as tdistance
from p2p_distributed_tswap_tpu_torch.ops import sweep_kernel

DIRECTIONS = [(1, False), (1, True), (2, False), (2, True)]
INF = int(distance.INF)


def _inputs(seed, r, h, w, density=0.25, edges=False, hit=0.95):
    rng = np.random.default_rng(seed)
    free = rng.random((h, w)) > density
    if edges:
        free[[0, -1], :] = False
        free[:, [0, -1]] = False
    d = np.where(rng.random((r, h, w)) > hit,
                 rng.integers(0, 60, (r, h, w)), INF)
    d = np.where(free[None], d, INF).astype(np.int32)
    return free, d


def _jax_xla(d, free, axis, reverse):
    h, w = d.shape[1], d.shape[2]
    xc = jnp.arange(w, dtype=jnp.int32).reshape(1, 1, w)
    yc = jnp.arange(h, dtype=jnp.int32).reshape(1, h, 1)
    coord = xc if axis == 2 else yc
    free_b = jnp.broadcast_to(jnp.asarray(free)[None], d.shape)
    return np.asarray(distance._sweep_xla(jnp.asarray(d), free_b, axis,
                                          reverse,
                                          -coord if reverse else coord))


def _port(d, free, axis, reverse):
    blocked = torch.from_numpy((~free).astype(np.uint8))
    return tdistance._sweep(torch.from_numpy(d), blocked, axis,
                            reverse).numpy()


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("r,h,w,edges", [
    (1, 100, 100, False),   # the reference rung's grid, not lane-aligned
    (3, 100, 100, True),
    (1, 37, 53, True),      # ragged both ways, obstacles on every edge
    (3, 37, 53, False),
])
def test_plain_sweep_matches_jax_xla_sweep(axis, reverse, r, h, w, edges):
    free, d = _inputs(7 * h + w + r + axis * 2 + reverse, r, h, w,
                      edges=edges)
    np.testing.assert_array_equal(_jax_xla(d, free, axis, reverse),
                                  _port(d, free, axis, reverse))


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
def test_port_sweep_private_plain_form_matches(axis, reverse):
    """``_sweep_xla`` with a caller's coord (the JAX package's form) and
    ``sweep_plain`` (coord from the shape) are one function."""
    free, d = _inputs(3 + axis * 2 + reverse, 2, 19, 23)
    h, w = free.shape
    n = w if axis == 2 else h
    shape = [1, 1, 1]
    shape[axis] = n
    coord = torch.arange(n, dtype=torch.int32).reshape(shape)
    got = sweep_kernel._sweep_xla(torch.from_numpy(d),
                                  torch.from_numpy(free)[None], axis,
                                  reverse, -coord if reverse else coord)
    np.testing.assert_array_equal(got.numpy(), _port(d, free, axis, reverse))


@pytest.fixture
def _interpret_mode():
    sweep_pallas.INTERPRET = True
    yield
    sweep_pallas.INTERPRET = False


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
@pytest.mark.parametrize("w", [128, 1024])
def test_plain_sweep_matches_pallas_fullrow_kernel(_interpret_mode, axis,
                                                   reverse, w):
    free, d = _inputs(20 + axis * 2 + reverse + w, 3, 128, w)
    blocked = (~jnp.asarray(free)).astype(jnp.int32)
    if axis == 1:
        pal = sweep_pallas._sweep8_rows(jnp.asarray(d), blocked, reverse)
    else:
        pal = sweep_pallas._sweep8_rows(
            jnp.asarray(d).swapaxes(1, 2), blocked.T, reverse).swapaxes(1, 2)
    np.testing.assert_array_equal(np.asarray(pal),
                                  _port(d, free, axis, reverse))


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
def test_plain_sweep_matches_pallas_strip_kernel(_interpret_mode, axis,
                                                 reverse):
    """The round-3 strip kernel (``_sweep_rows``, one (H, 128) strip per
    program), the other TPU kernel the CUDA kernel replaces."""
    free, d = _inputs(30 + axis * 2 + reverse, 2, 128, 256)
    blocked = (~jnp.asarray(free)).astype(jnp.int32)
    if axis == 1:
        pal = sweep_pallas._sweep_rows(jnp.asarray(d), blocked, reverse)
    else:
        pal = sweep_pallas._sweep_rows(
            jnp.asarray(d).swapaxes(1, 2), blocked.T, reverse).swapaxes(1, 2)
    np.testing.assert_array_equal(np.asarray(pal),
                                  _port(d, free, axis, reverse))


@pytest.mark.parametrize("axis,reverse", DIRECTIONS)
def test_plain_sweep_matches_pallas_sweep(_interpret_mode, axis, reverse):
    """``sweep_pallas.sweep`` (the dispatcher over both Pallas kernels) at
    the one-strip 128x128 shape."""
    free, d = _inputs(40 + axis * 2 + reverse, 3, 128, 128, hit=0.97)
    pal = sweep_pallas.sweep(jnp.asarray(d), jnp.asarray(free), axis,
                             reverse)
    np.testing.assert_array_equal(np.asarray(pal),
                                  _port(d, free, axis, reverse))


def test_cpu_sweep_never_launches_the_kernel():
    free, d = _inputs(1, 1, 9, 11)
    before = sweep_kernel.launches
    _port(d, free, 1, False)
    assert sweep_kernel.launches == before
