"""The fused direction-field engine: goal seed -> BFS fixpoint -> next-hop
codes in one kernel launch.

Counterpart of the JAX package's ``ops/field_fused.py``.  Opt-in through
``MAPD_FUSED``, read at call time: ``1`` or ``multi`` runs the multi
instance, ``single`` the single instance, anything else leaves
``ops.distance.direction_fields`` on its default path (sweeps by
``sweep_scan`` with one host sync per round).  Which shapes may take which
instance follows the JAX package's gates exactly, so every scenario takes the
same path in both packages; the JAX package's TPU backend test becomes "the
tensors are on a CUDA device", so on the CPU the fused path is never taken.

- :func:`single_direction_fields` and :func:`multi_direction_fields` launch
  the hand-written kernel in ``csrc/field_fused.cu`` (built with the port's
  other kernels by ``ops.cuda_build``) for a CUDA tensor, and run the plain
  version for a CPU tensor.  Nothing falls back.  ``launches`` counts the
  launches of each instance.  Both instances are one kernel: each field is
  split over the blocks of a thread-block cluster (:func:`launch_layout`);
  they differ only in the shape gates that route a grid to them.
- :func:`fields_plain` is the plain version: the seed, the sweep fixpoint by
  ``sweep_kernel.sweep_plain`` (never ``sweep_scan``, even on the card, so the
  kernel is held against arithmetic independent of both kernels) and
  ``directions_from_distance``.  Whole-batch convergence there and per-field
  convergence in the kernel give the same codes, ``max_rounds`` binding or
  not: a round on a converged field changes nothing.
"""

from __future__ import annotations

import ctypes
import os

import torch

from p2p_distributed_tswap_tpu_torch.ops import (
    cuda_build,
    distance,
    sweep_kernel,
)

SUB = 8        # TPU tile rows, kept in the shape gates
LANES = 128
HALO = SUB
# The JAX package's VMEM budgets, kept as shape gates (see fused_eligible).
MAX_SCRATCH_BYTES = 6 << 20
MULTI_MAX_BYTES = 12 << 20
# Blocks per cluster the wrapper tries, most first (16 is past the portable
# 8: the kernel allows it, and the card's occupancy answer decides).
CLUSTER_SIZES = (16, 8, 4, 2)
# Fewest rows a band may have: one per warp of the kernel's 1024-thread
# blocks, whose along-W passes give each warp a row (fewer rows leave warps
# idle while each block still pays the round's cluster barriers).
MIN_BAND_ROWS = 32
# Launches of each kernel instance since the last reset (callers reset them).
launches = {"single": 0, "multi": 0}


def fused_mode() -> str:
    """'' (off, the default), 'multi' (MAPD_FUSED=1 or =multi) or 'single'
    (MAPD_FUSED=single)."""
    v = os.environ.get("MAPD_FUSED", "")
    if v in ("1", "multi"):
        return "multi"
    if v == "single":
        return "single"
    return ""


def multi_eligible(h: int, w: int) -> bool:
    """The JAX package's shape gate for the multi-field kernel: 8-aligned H,
    128-aligned W, and its (H+2, 8, W) scratch plus (H, 8, W) codes block
    within 12 MiB."""
    return (h % SUB == 0 and w % LANES == 0
            and ((h + 2) + h) * SUB * w * 4 <= MULTI_MAX_BYTES)


def fused_eligible(h: int, w: int, device) -> bool:
    """Whether ``direction_fields`` on an (h, w) grid on ``device`` takes the
    fused kernel: a fused mode is set, the device is CUDA, and the shape
    passes the JAX package's gate for that mode (single: (H+16)*W*4 within
    6 MiB)."""
    mode = fused_mode()
    if not mode or torch.device(device).type != "cuda":
        return False
    if mode == "single":
        return (h % SUB == 0 and w % LANES == 0
                and (h + 2 * HALO) * w * 4 <= MAX_SCRATCH_BYTES)
    return multi_eligible(h, w)


def fields_plain(free: torch.Tensor, goals_idx: torch.Tensor,
                 max_rounds: int = 128) -> torch.Tensor:
    """Plain PyTorch version of both instances: (G, H, W) uint8 codes."""
    dist = distance.distance_fields(free, goals_idx, max_rounds,
                                    sweep=sweep_kernel.sweep_plain)
    return distance.directions_from_distance(dist, free)


def _fn():
    return cuda_build.function(
        "field_fused",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def choose_cluster(g: int, h: int, max_active) -> int:
    """Blocks per cluster for ``g`` fields of ``h`` rows: the most of 16, 8,
    4, 2 that leaves every band ``MIN_BAND_ROWS`` rows and for which
    ``max_active(k)``, the clusters of k blocks the card holds at once,
    covers all ``g``; else 1."""
    for k in CLUSTER_SIZES:
        if h // k >= MIN_BAND_ROWS and g <= max_active(k):
            return k
    return 1


_max_clusters: dict = {}


def max_active_clusters(device, cluster: int, h: int, w: int) -> int:
    """Clusters of ``cluster`` blocks, each owning one field of an (h, w)
    grid, that the card of ``device`` holds at once: the CUDA runtime's
    occupancy answer, or 0 where the kernel does not take that layout
    (``csrc/field_fused.cu`` holds the limits).  Cached per process."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, cluster, h, w)
    if key not in _max_clusters:
        fn = cuda_build.function(
            "field_fused_max_clusters",
            [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(cluster, h, w, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"field_fused: occupancy query for clusters of "
                               f"{cluster} failed with CUDA error {rc}")
        _max_clusters[key] = out.value
    return _max_clusters[key]


def launch_layout(device, g: int, h: int, w: int, cluster=None) -> dict:
    """How :func:`fused_kernel` splits G fields of an (h, w) grid: one
    cluster of ``cluster`` blocks per field.  ``cluster`` forces the choice;
    the solver never passes it."""
    def max_active(k):
        return max_active_clusters(device, k, h, w)

    if cluster is None:
        cluster = choose_cluster(g, h, max_active)
    if not isinstance(cluster, int) or cluster < 1 or max_active(cluster) < 1:
        raise ValueError(f"field_fused: the kernel does not take a {h}x{w} "
                         f"grid split over a cluster of {cluster!r} blocks "
                         "(at most 16, at most H, and the band's mask bits "
                         "and summaries within a block's shared memory)")
    return {"cluster": cluster, "blocks": g * cluster}


def fused_kernel(free: torch.Tensor, goals_idx: torch.Tensor,
                 max_rounds: int, mode: str, cluster=None):
    """Launch the CUDA kernel for one instance.

    Args:
      free: (H, W) bool, contiguous, on a CUDA device; True = traversable.
      goals_idx: (G,) int32 flat goal cells, G >= 1, same device.
      max_rounds: cap on fast-sweeping rounds, >= 0.
      mode: 'single' or 'multi', the instance whose launches are counted.
      cluster: blocks per cluster (1..16, at most H); None lets
        :func:`launch_layout` choose.  A launch the card refuses raises.

    Returns ``(codes, rounds)``: (G, H, W) uint8 codes and (G,) int32, the
    rounds each field ran.  Raises on anything else, CPU tensors included.
    """
    if not (free.is_cuda and goals_idx.device == free.device):
        raise ValueError("field_fused: free and goals_idx must be on one CUDA "
                         f"device, got {free.device} and {goals_idx.device}")
    if free.dtype != torch.bool or goals_idx.dtype != torch.int32:
        raise TypeError("field_fused: need bool free and int32 goals_idx, got "
                        f"{free.dtype} and {goals_idx.dtype}")
    if (free.ndim != 2 or min(free.shape) < 1 or goals_idx.ndim != 1
            or goals_idx.shape[0] < 1):
        raise ValueError(f"field_fused: bad shapes free={tuple(free.shape)} "
                         f"goals_idx={tuple(goals_idx.shape)}")
    if not (free.is_contiguous() and goals_idx.is_contiguous()):
        raise ValueError("field_fused: free and goals_idx must be contiguous")
    if not (isinstance(max_rounds, int) and max_rounds >= 0):
        raise ValueError(f"field_fused: bad max_rounds {max_rounds!r}")
    h, w = free.shape
    g = goals_idx.shape[0]
    dev = free.device
    if mode not in launches:
        raise ValueError(f"field_fused: mode must be 'single' or 'multi', "
                         f"got {mode!r}")
    layout = launch_layout(dev, g, h, w, cluster)
    blocked = (~free).to(torch.uint8)
    bits = torch.empty((h, -(-w // 32)), dtype=torch.int32, device=dev)
    dist = torch.empty((g, h, w), dtype=torch.int32, device=dev)
    codes = torch.empty((g, h, w), dtype=torch.uint8, device=dev)
    rounds = torch.empty(g, dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(goals_idx.data_ptr(), g, blocked.data_ptr(), bits.data_ptr(),
                dist.data_ptr(), codes.data_ptr(), rounds.data_ptr(), h, w,
                layout["cluster"], max_rounds, stream)
    if rc != 0:
        raise RuntimeError(f"field_fused: launch of {layout} failed with CUDA "
                           f"error {rc}")
    launches[mode] += 1
    return codes, rounds


def _direction_fields(free, goals_idx, max_rounds, mode):
    if free.is_cuda:
        return fused_kernel(free, goals_idx, max_rounds, mode)[0]
    if free.device.type != "cpu":
        raise ValueError(f"field_fused: unsupported device {free.device}")
    return fields_plain(free, goals_idx, max_rounds)


def single_direction_fields(free: torch.Tensor, goals_idx: torch.Tensor,
                            max_rounds: int = 128) -> torch.Tensor:
    """(G, H, W) uint8 next-hop codes (the counterpart of the JAX
    package's ``_kernel``)."""
    return _direction_fields(free, goals_idx, max_rounds, "single")


def multi_direction_fields(free: torch.Tensor, goals_idx: torch.Tensor,
                           max_rounds: int = 128) -> torch.Tensor:
    """(G, H, W) uint8 next-hop codes (the counterpart of the JAX
    package's ``_multi_kernel``)."""
    return _direction_fields(free, goals_idx, max_rounds, "multi")


def fused_direction_fields(free: torch.Tensor, goals_idx: torch.Tensor,
                           max_rounds: int = 128) -> torch.Tensor:
    """Drop-in for ``ops.distance.direction_fields`` on eligible shapes:
    the multi instance unless ``MAPD_FUSED=single``."""
    if fused_mode() != "single":
        return multi_direction_fields(free, goals_idx, max_rounds)
    return single_direction_fields(free, goals_idx, max_rounds)
