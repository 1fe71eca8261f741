"""The directional sweep: the CUDA kernel ``sweep_scan`` and its plain version.

Counterpart of the JAX package's ``ops/sweep_pallas.py``.  One fast-sweeping
relax of a batch of BFS distance fields along one axis, in one direction,
not crossing obstacles (the recurrence is written out in
``csrc/sweep_scan.cu``).  ``ops.distance.distance_fields`` runs four of these
per round until the fixpoint.

- :func:`sweep_scan` launches the hand-written kernel in
  ``csrc/sweep_scan.cu``, built at first use with the port's other kernels
  into one shared library with a plain C interface (``ops.cuda_build``) and
  loaded with ``ctypes``.  ``launches`` counts its launches.  The kernel
  picks its layout from the shape (bands of rows and column tiles along H,
  row segments along W); :func:`launch_layout` reports it and
  :func:`sweep_scan_forced` overrides it, for tests and measurement.
- :func:`sweep_plain` is the port of the JAX package's portable path,
  ``_seg_min_scan`` + ``_sweep_xla`` (a Hillis-Steele doubling scan in the
  ``INF + axis_len`` sentinel form).  It is the CPU path and the yardstick the
  kernel is held against on the card.

``ops.distance._sweep`` picks between them by the device of the tensor: a
CUDA tensor goes to the kernel, a CPU tensor to the plain version, and
nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from p2p_distributed_tswap_tpu_torch.ops import cuda_build

INF = 1 << 30

# Launches of the CUDA kernel since the last reset (callers reset it to 0).
launches = 0


def _seg_min_scan(values: torch.Tensor, resets: torch.Tensor, axis: int,
                  reverse: bool) -> torch.Tensor:
    """Segmented running minimum along ``axis``: where ``resets`` is True the
    minimum restarts from that position's value.  Hillis-Steele doubling
    (log2(n) rounds of roll + min/where), as in the JAX package.  ``resets``
    may broadcast against ``values`` on every axis but ``axis``."""
    n = values.shape[axis]
    if reverse:
        values = values.flip(axis)
        resets = resets.flip(axis)
    v, r = values, resets
    idx_shape = [1] * values.ndim
    idx_shape[axis] = n
    idx = torch.arange(n, device=values.device).reshape(idx_shape)
    off = 1
    while off < n:
        # (value, reset) from `off` positions earlier along axis; positions
        # without a predecessor combine with the identity (+inf, no reset).
        valid = idx >= off
        sv = torch.where(valid, torch.roll(v, off, axis), INF + n)
        sr = valid & torch.roll(r, off, axis)
        v = torch.where(r, v, torch.minimum(v, sv))
        r = r | sr
        off *= 2
    if reverse:
        v = v.flip(axis)
    return v


def _sweep_xla(d: torch.Tensor, free: torch.Tensor, axis: int, reverse: bool,
               coord: torch.Tensor) -> torch.Tensor:
    """Port of the JAX package's ``distance._sweep_xla``.  ``free`` (bool)
    and ``coord`` (int32 position along ``axis``, negated for reverse
    sweeps) broadcast against ``d``."""
    blocked = ~free
    # Blocked sentinel must stay >= INF after the coordinate shift below for
    # any position in the axis, else it would leak as a fake INF-eps distance.
    axis_len = d.shape[axis]
    v = torch.where(blocked, INF + axis_len, d - coord)
    m = _seg_min_scan(v, blocked, axis=axis, reverse=reverse)
    relaxed = torch.where(blocked, INF, torch.minimum(d, m + coord))
    # guard overflow: anything >= INF stays INF
    return relaxed.clamp_max(INF)


def sweep_plain(d: torch.Tensor, blocked: torch.Tensor, axis: int,
                reverse: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`sweep_scan`: same arguments, same
    result, on any device.  A 2-D ``blocked`` is shared by every field, a
    3-D one is each field's own."""
    n = d.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    coord = torch.arange(n, dtype=torch.int32, device=d.device).reshape(shape)
    if reverse:
        coord = -coord
    free = blocked == 0
    if free.ndim == 2:
        free = free[None]
    return _sweep_xla(d, free, axis, reverse, coord)


def _fn(name: str = "sweep_scan"):
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    if name == "sweep_scan_forced":
        args += [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return cuda_build.function(name, args + [ctypes.c_void_p])


def launch_layout(r: int, h: int, w: int, axis: int, tile: int = 0,
                  rows: int = 0, bands: int = 0) -> dict:
    """The layout the kernel takes for an (r, h, w) batch along ``axis``,
    as ``csrc/sweep_scan.cu`` chooses it (or with ``tile``, ``rows`` and
    ``bands`` forced, 0 = chosen).  Along H: ``tile`` columns per block
    (8, 16 or 32), ``rows`` per band (8 or 16), ``bands`` per segment of
    the column.  Along W: ``cells`` a lane holds per chunk (4: one 16-byte
    load, 1: a scalar; forced by ``tile``; ``rows`` and ``bands`` stay 0).
    Both with the threads and blocks launched.  Raises ValueError for a
    layout the kernel does not take.  Builds the kernels' library on first
    use."""
    fn = cuda_build.function(
        "sweep_scan_layout",
        [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p])
    out = (ctypes.c_longlong * 5)()
    if fn(r, h, w, axis, tile, rows, bands, ctypes.addressof(out)) != 0:
        raise ValueError(f"sweep_scan: no layout for ({r}, {h}, {w}) along "
                         f"axis {axis} with tile={tile} rows={rows} "
                         f"bands={bands}")
    tile, rows, bands, threads, blocks = (int(v) for v in out)
    if axis == 1:
        return {"tile": tile, "rows": rows, "bands": bands,
                "threads": threads, "blocks": blocks}
    return {"cells": tile, "threads": threads, "blocks": blocks}


def _check(d: torch.Tensor, blocked: torch.Tensor, axis: int) -> None:
    if not (d.is_cuda and blocked.device == d.device):
        raise ValueError("sweep_scan: d and blocked must be on one CUDA "
                         f"device, got {d.device} and {blocked.device}")
    if d.dtype != torch.int32 or blocked.dtype != torch.uint8:
        raise TypeError("sweep_scan: need int32 d and uint8 blocked, got "
                        f"{d.dtype} and {blocked.dtype}")
    if d.ndim != 3 or blocked.shape not in (d.shape[1:], d.shape) \
            or min(d.shape) < 1:
        raise ValueError(f"sweep_scan: bad shapes d={tuple(d.shape)} "
                         f"blocked={tuple(blocked.shape)}")
    if not (d.is_contiguous() and blocked.is_contiguous()):
        raise ValueError("sweep_scan: d and blocked must be contiguous")
    if axis not in (1, 2):
        raise ValueError(f"sweep_scan: axis must be 1 or 2, got {axis}")


def _launch(d: torch.Tensor, blocked: torch.Tensor, axis: int, reverse: bool,
            *forced: int) -> torch.Tensor:
    global launches
    _check(d, blocked, axis)
    fn = _fn("sweep_scan_forced" if forced else "sweep_scan")
    out = torch.empty_like(d)
    r, h, w = d.shape
    mstride = 0 if blocked.ndim == 2 else h * w  # shared plane or per field
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        rc = fn(d.data_ptr(), blocked.data_ptr(), out.data_ptr(), r, h, w,
                mstride, axis, int(reverse), *forced, stream)
    if rc != 0:
        raise RuntimeError(f"sweep_scan: launch failed with CUDA error {rc}")
    launches += 1
    return out


def sweep_scan(d: torch.Tensor, blocked: torch.Tensor, axis: int,
               reverse: bool) -> torch.Tensor:
    """One directional sweep on the card by the CUDA kernel.

    Args:
      d: (R, H, W) int32, contiguous, on a CUDA device; values in [0, INF].
      blocked: uint8, contiguous, same device; nonzero = obstacle.  (H, W):
        one mask shared by every field; (R, H, W): each field's own.
      axis: 1 (along H) or 2 (along W).
      reverse: walk the axis from its end.

    Returns a new (R, H, W) int32 tensor.  Raises on anything else, CPU
    tensors included.
    """
    return _launch(d, blocked, axis, reverse)


def sweep_scan_forced(d: torch.Tensor, blocked: torch.Tensor, axis: int,
                      reverse: bool, tile: int = 0, rows: int = 0,
                      bands: int = 0) -> torch.Tensor:
    """:func:`sweep_scan` in a forced layout (see :func:`launch_layout`).
    For tests and measurement: the solver calls :func:`sweep_scan`.  A
    layout the kernel does not take raises."""
    return _launch(d, blocked, axis, reverse, tile, rows, bands)
