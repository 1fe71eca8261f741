"""Checkpoint / resume for MAPD solver state.

Counterpart of the JAX package's ``solver/checkpoint.py``, archive for
archive: the full :class:`~p2p_distributed_tswap_tpu_torch.solver.mapd.MapdState`
round-trips through a compressed ``.npz`` archive with one entry per field
plus a format version, so a checkpoint written by either package restores
in the other.  The solver is deterministic, so a resumed solve is
bit-identical to an uninterrupted one.

The one field whose type differs between the packages is ``dirs``: uint32
words in the JAX package, int32 words here with the same bits
(``ops.distance.pack_directions``).  The archive always holds uint32, and
loading reinterprets the bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2p_distributed_tswap_tpu_torch.core.config import SolverConfig
from p2p_distributed_tswap_tpu_torch.ops.distance import packed_cells
from p2p_distributed_tswap_tpu_torch.solver.mapd import MapdState, resolve_device

FORMAT_VERSION = 2
_FIELDS = [f.name for f in dataclasses.fields(MapdState)]
# Fields added by format 2 (the stale decentralized view); a format-1
# archive restores with these at their inert defaults.
_V2_FIELDS = ("vpos", "vgoal", "vstamp", "pend_from", "pend_push")


def _v1_defaults(n: int, pos: np.ndarray, goal: np.ndarray,
                 t: int) -> dict:
    # The view is seeded from the archived truth, as if everyone broadcast
    # at the restore step: vgoal from the goals (from the positions, every
    # mid-route agent would look parked on its goal), vstamp at the
    # archived step (a zero stamp would expire under view_ttl_steps).
    return {
        "vpos": pos.astype(np.int32),
        "vgoal": goal.astype(np.int32),
        "vstamp": np.full(n, t, np.int32),
        "pend_from": np.arange(n, dtype=np.int32),
        "pend_push": np.full(n, -1, np.int32),
    }


def save_state(path: str, state: MapdState, extra: dict | None = None
               ) -> None:
    """Write ``state`` to ``path`` as a compressed npz archive (tensors are
    fetched to the host; ``dirs`` is stored as uint32).

    ``extra`` -- optional caller metadata (scalars/arrays) stored in the
    same archive under reserved ``__x_<key>__`` names, so a state and its
    loop latches live in one file that cannot tear on a mid-save kill.
    Read back with :func:`load_extra`."""
    arrays = {name: getattr(state, name).cpu().numpy() for name in _FIELDS}
    arrays["dirs"] = arrays["dirs"].view(np.uint32)
    for k, v in (extra or {}).items():
        arrays[f"__x_{k}__"] = np.asarray(v)
    np.savez_compressed(path, __format_version__=FORMAT_VERSION, **arrays)


def load_extra(path: str) -> dict:
    """Return the ``extra`` dict stored by :func:`save_state` (empty if
    none was stored)."""
    out = {}
    with np.load(path) as z:
        for name in z.files:
            if name.startswith("__x_") and name.endswith("__"):
                out[name[4:-2]] = z[name]
    return out


def load_state(path: str, cfg: SolverConfig | None = None,
               expected_num_tasks: int | None = None,
               device=None) -> MapdState:
    """Restore a :class:`MapdState` saved by :func:`save_state` (of either
    package) onto ``device`` (default ``cuda``, see
    :func:`~p2p_distributed_tswap_tpu_torch.solver.mapd.resolve_device`).

    Pass the ``cfg`` the state will be stepped under to fail fast on a
    mismatch (agent count, grid size, path recording), and
    ``expected_num_tasks`` (``tasks.shape[0]`` of the array the resumed
    solve steps with): ``task_used``'s length comes from the checkpoint,
    and another tasks array would be mis-indexed, not refused."""
    dev = resolve_device(device)
    with np.load(path) as z:
        if "__format_version__" not in z:
            raise ValueError(
                f"{path} is not a solver checkpoint (no format version)")
        version = int(z["__format_version__"])
        if version not in (1, FORMAT_VERSION):
            raise ValueError(
                f"checkpoint format {version} != supported {FORMAT_VERSION}")
        required = [n for n in _FIELDS
                    if not (version == 1 and n in _V2_FIELDS)]
        missing = [n for n in required if n not in z]
        if missing:
            raise ValueError(f"checkpoint missing fields: {missing}")
        arrays = {name: z[name] for name in required}
    if version == 1:
        arrays.update(_v1_defaults(arrays["pos"].shape[0], arrays["pos"],
                                   arrays["goal"], int(arrays["t"])))
    dirs = arrays["dirs"]
    if dirs.dtype not in (np.uint32, np.int32):
        raise ValueError(f"checkpoint dirs are {dirs.dtype}, not uint32")
    arrays["dirs"] = dirs.view(np.int32)
    state = MapdState(**{name: torch.from_numpy(np.array(arrays[name])).to(dev)
                         for name in _FIELDS})
    if cfg is not None:
        n = state.pos.shape[0]
        if n != cfg.num_agents:
            raise ValueError(
                f"checkpoint has {n} agents, config expects "
                f"{cfg.num_agents}")
        if tuple(state.dirs.shape) != (n, packed_cells(cfg.num_cells)):
            raise ValueError(
                f"checkpoint field shape {tuple(state.dirs.shape)} does not "
                f"match a {cfg.height}x{cfg.width} grid "
                f"({(n, packed_cells(cfg.num_cells))} expected)")
        want_tdim = cfg.max_timesteps + 1 if cfg.record_paths else 1
        if state.paths_pos.shape[0] != want_tdim:
            raise ValueError(
                f"checkpoint path buffer has {state.paths_pos.shape[0]} "
                f"rows, config (record_paths={cfg.record_paths}, "
                f"max_timesteps={cfg.max_timesteps}) expects {want_tdim}")
    if expected_num_tasks is not None:
        t = state.task_used.shape[0]
        if t != expected_num_tasks:
            raise ValueError(
                f"checkpoint was saved against {t} tasks, resumed solve "
                f"steps with {expected_num_tasks} -- same tasks array "
                f"required for a valid resume")
    return state
