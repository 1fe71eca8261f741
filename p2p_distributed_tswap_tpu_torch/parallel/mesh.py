"""Device meshes of one process: the port's counterpart of the JAX
package's ``parallel/mesh.py``.

The JAX mesh is single-controller: one process owns every device and runs
``shard_map`` programs over them.  The port keeps that shape without
``torch.distributed``:

- a :class:`Mesh` is an (A, T) grid of ``torch.device`` with the axis
  names ``agents`` (field rows, lanes) and ``tiles`` (grid bands);
- a :class:`Sharded` tensor is a global tensor laid out over a mesh as a
  JAX ``NamedSharding`` lays it out: its ``spec`` names, per dimension, the
  mesh axis that splits it (``None`` = whole); a mesh axis that splits no
  dimension replicates, so each of its devices holds its own copy;
- ``shard_map`` becomes a loop over the shards in mesh order, and the two
  collectives the solvers use are plain functions over per-shard tensors:
  :func:`psum` of int32 contributions (exact: exactly one shard contributes
  a nonzero value per lane) and :func:`ppermute`, which moves one boundary
  row between neighbouring bands;
- state that the JAX package replicates and runs the same control flow on
  (positions, goals, slots, the step's rule phases) is held once, on the
  mesh's first device (:attr:`Mesh.lead`), where the one process runs it;
  contributions are copied there.

A mesh takes real devices (``cuda:0``, ``cuda:1``, ...: copies between
them are peer copies) or a virtual mesh of shards on one device
(``parallel/virtual_mesh.py``).  With no devices given, the constructors
take the first n CUDA devices and raise when there are fewer, as the JAX
package's ``_default_devices`` does: a mesh never folds down to fewer
shards or to the flat path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AGENTS_AXIS = "agents"
TILES_AXIS = "tiles"


def _default_devices(n: int) -> List[torch.device]:
    """The first ``n`` CUDA devices; raises when there are fewer."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"mesh needs {n} devices, have {have} (a virtual mesh: "
            f"devices=virtual_mesh.virtual_devices({n}, device))")
    return [torch.device("cuda", k) for k in range(n)]


class Mesh:
    """An (A, T) grid of devices; ``shape`` is keyed by the axis names
    (``AGENTS_AXIS``, ``TILES_AXIS``)."""

    def __init__(self, devices: Sequence, n_agents: int, n_tiles: int = 1):
        if n_agents < 1 or n_tiles < 1:
            raise ValueError("mesh axes must be >= 1")
        devices = [torch.device(d) for d in devices]
        if len(devices) < n_agents * n_tiles:
            raise RuntimeError(f"mesh needs {n_agents * n_tiles} devices, "
                               f"have {len(devices)}")
        self.devices = np.empty((n_agents, n_tiles), dtype=object)
        for k in range(n_agents * n_tiles):
            self.devices[k // n_tiles, k % n_tiles] = devices[k]
        self.shape = {AGENTS_AXIS: n_agents, TILES_AXIS: n_tiles}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def lead(self) -> torch.device:
        """The device of mesh position (0, 0), where the replicated state
        lives and collectives land."""
        return self.devices[0, 0]

    @property
    def virtual(self) -> bool:
        """True when two shards share a device."""
        return len({str(d) for d in self.devices.reshape(-1)}) < self.size

    def device(self, a: int, t: int = 0) -> torch.device:
        return self.devices[a, t]

    def positions(self) -> List[Tuple[int, int]]:
        """Every (agent shard, tile) in mesh order."""
        a_n, t_n = self.devices.shape
        return [(a, t) for a in range(a_n) for t in range(t_n)]

    def describe(self) -> dict:
        return {"shape": [self.shape[AGENTS_AXIS], self.shape[TILES_AXIS]],
                "virtual": self.virtual,
                "devices": [str(d) for d in self.devices.reshape(-1)]}


def axis_size(mesh: Mesh, axis_name: str) -> int:
    return mesh.shape[axis_name]


def agent_tile_mesh(n_agent_shards: int, n_tiles: int,
                    devices=None) -> Mesh:
    """(agents x tiles) mesh: field rows shard over the agents axis and each
    row's cells (grid bands) over the tiles axis."""
    if devices is None:
        devices = _default_devices(n_agent_shards * n_tiles)
    return Mesh(devices, n_agent_shards, n_tiles)


def agent_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over the agent axis alone (T = 1): ``n_devices`` of
    ``devices``, or all of them, or the first ``n_devices`` CUDA devices
    (all of them when ``n_devices`` is None)."""
    if devices is None:
        if n_devices is None:
            n_devices = (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0)
            if n_devices == 0:
                raise RuntimeError("mesh needs CUDA devices, have 0")
        devices = _default_devices(n_devices)
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(list(devices)[:n_devices], n_devices, 1)


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of per-shard contributions on ``device``, added in mesh
    order: ``lax.psum`` over the shards that produced ``parts``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def ppermute(parts: Sequence[torch.Tensor], perm, devices
             ) -> List[Optional[torch.Tensor]]:
    """``lax.ppermute`` over a list of shards: ``out[dst]`` is
    ``parts[src]`` copied to ``devices[dst]`` for each ``(src, dst)`` of
    ``perm``; a shard that receives nothing gets None (JAX leaves zeros
    there, which callers overwrite)."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(devices[dst], copy=True)
    return out


def _block_slices(mesh: Mesh, spec, shape, a: int, t: int):
    idx = {AGENTS_AXIS: a, TILES_AXIS: t}
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
            continue
        n = mesh.shape[axis]
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide over the {n} shards of {axis}")
        blk = shape[dim] // n
        out.append(slice(idx[axis] * blk, (idx[axis] + 1) * blk))
    return tuple(out)


class Sharded:
    """A global tensor laid out over a mesh, one block per mesh position on
    that position's device (see the module docstring for ``spec``).

    Reads and writes by global index route to the blocks that hold the
    rows: ``x[rows]``, ``x[:, cols]``, ``x[rows] = v`` (every replica
    written), where dim 0 is the only dimension split (the field cache,
    the lanes); other layouts read through :meth:`gather`.
    :meth:`index_put` is out of place in every layout."""

    def __init__(self, mesh: Mesh, spec, shape, dtype, blocks: Dict):
        self.mesh = mesh
        self.spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.blocks = blocks  # (a, t) -> tensor on mesh.device(a, t)

    # -- construction ---------------------------------------------------
    @classmethod
    def put(cls, mesh: Mesh, x, spec) -> "Sharded":
        """Lay the global tensor (or array) ``x`` out over ``mesh``: each
        position gets its own copy of its block."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        spec = tuple(spec) + (None,) * (x.dim() - len(spec))
        blocks = {}
        for a, t in mesh.positions():
            src = x[_block_slices(mesh, spec, x.shape, a, t)]
            blk = torch.empty(src.shape, dtype=x.dtype,
                              device=mesh.device(a, t))
            blocks[(a, t)] = blk.copy_(src)
        return cls(mesh, spec, x.shape, x.dtype, blocks)

    @classmethod
    def full(cls, mesh: Mesh, shape, value, dtype, spec) -> "Sharded":
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        blocks = {}
        for a, t in mesh.positions():
            sl = _block_slices(mesh, spec, shape, a, t)
            bshape = [len(range(*s.indices(n))) for s, n in zip(sl, shape)]
            blocks[(a, t)] = torch.full(bshape, value, dtype=dtype,
                                        device=mesh.device(a, t))
        return cls(mesh, spec, shape, dtype, blocks)

    # -- blocks -----------------------------------------------------------
    def block(self, a: int, t: int = 0) -> torch.Tensor:
        return self.blocks[(a, t)]

    def nbytes(self) -> Dict[int, int]:
        """Bytes each mesh position holds, keyed by its flat position."""
        t_n = self.mesh.shape[TILES_AXIS]
        return {a * t_n + t: b.numel() * b.element_size()
                for (a, t), b in self.blocks.items()}

    def numel(self) -> int:
        return self.shape.numel()

    def dim(self) -> int:
        return len(self.shape)

    def element_size(self) -> int:
        return self.blocks[(0, 0)].element_size()

    def _primary(self):
        """The positions holding one copy of every block (index 0 on the
        axes that replicate)."""
        used = set(self.spec)
        return [(a, t) for a, t in self.mesh.positions()
                if (AGENTS_AXIS in used or a == 0)
                and (TILES_AXIS in used or t == 0)]

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's lead)."""
        device = self.mesh.lead if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for a, t in self._primary():
            out[_block_slices(self.mesh, self.spec, self.shape, a, t)] = \
                self.blocks[(a, t)].to(device)
        return out

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")

    # -- row access (dim 0 split over agents, or replicated) -------------
    def _rows_split(self) -> bool:
        """Whether row access can route to blocks: dim 0 split over the
        agents and nothing else split (or nothing split at all)."""
        return (self.spec[0] in (None, AGENTS_AXIS)
                and not any(self.spec[1:]))

    def _row_groups(self, key0):
        """For a dim-0 key: the number of rows it names, and per agent block
        holding some, (positions in the key, local rows: a host int64 array,
        or ``slice(None)`` for the whole block)."""
        n = self.shape[0]
        n_agents = self.mesh.shape[AGENTS_AXIS]
        split = self.spec[0] == AGENTS_AXIS
        size = n // n_agents if split else n
        if isinstance(key0, slice) and key0 == slice(None):
            if not split:
                return n, [(a, np.arange(n), slice(None))
                           for a in range(n_agents)]
            return n, [(a, np.arange(a * size, (a + 1) * size), slice(None))
                       for a in range(n_agents)]
        if isinstance(key0, slice):
            rows = np.arange(n)[key0]
        elif isinstance(key0, (int, np.integer)):
            rows = np.asarray([int(key0) % n])
        elif isinstance(key0, torch.Tensor):
            rows = key0.detach().cpu().numpy().astype(np.int64).reshape(-1)
        else:
            rows = np.asarray(key0, np.int64).reshape(-1)
        if not split:
            return rows.size, [(a, np.arange(rows.size), rows)
                               for a in range(n_agents)]
        groups = []
        for a in range(n_agents):
            sel = np.flatnonzero((rows >= a * size) & (rows < (a + 1) * size))
            if sel.size:
                groups.append((a, sel, rows[sel] - a * size))
        return rows.size, groups

    @staticmethod
    def _split(key):
        if isinstance(key, tuple):
            return key[0], key[1:]
        return key, ()

    @staticmethod
    def _local(local, device):
        if isinstance(local, slice):
            return local
        return torch.from_numpy(local).to(device)

    def __getitem__(self, key):
        if not self._rows_split():
            return self.gather()[key]
        key0, rest = self._split(key)
        count, groups = self._row_groups(key0)
        if self.spec[0] is None:
            groups = groups[:1]
        lead = self.mesh.lead
        parts = []
        for a, sel, local in groups:
            blk = self.blocks[(a, 0)]
            parts.append((sel, blk[(self._local(local, blk.device), *rest)]))
        out = torch.empty((count, *parts[0][1].shape[1:]), dtype=self.dtype,
                          device=lead)
        for sel, p in parts:
            out[torch.from_numpy(sel).to(lead)] = p.to(lead)
        if isinstance(key0, (int, np.integer)):
            return out[0]
        return out

    def __setitem__(self, key, value) -> None:
        if not self._rows_split():
            raise NotImplementedError(f"row writes on spec {self.spec}")
        key0, rest = self._split(key)
        _, groups = self._row_groups(key0)
        tensor = isinstance(value, torch.Tensor) and value.dim() > 0
        if tensor and isinstance(key0, (int, np.integer)):
            value = value.unsqueeze(0)
        for a, sel, local in groups:
            for t in range(self.mesh.shape[TILES_AXIS]):
                blk = self.blocks[(a, t)]
                v = value
                if tensor:
                    v = value[torch.from_numpy(sel).to(value.device)].to(
                        blk.device)
                blk[(self._local(local, blk.device), *rest)] = v

    def index_put(self, indices, values) -> "Sharded":
        """Out-of-place ``index_put`` by global indices: a new Sharded
        tensor in the same layout (each block a new tensor)."""
        lead = self.mesh.lead
        g = self.gather(lead).index_put(
            tuple(i.to(lead) for i in indices), values.to(lead))
        return Sharded.put(self.mesh, g, self.spec)


def replicate(x, device) -> torch.Tensor:
    """A tensor, or a Sharded tensor gathered, on ``device``."""
    if isinstance(x, Sharded):
        return x.gather(device)
    return x.to(device)


def shard_bytes(mesh: Mesh, arrays) -> Dict[int, int]:
    """Bytes each mesh position holds of ``arrays`` (Sharded tensors;
    anything else holds nothing on the mesh and is skipped), keyed by flat
    mesh position ``a * T + t``."""
    per = {k: 0 for k in range(mesh.size)}
    for x in arrays:
        if isinstance(x, Sharded):
            for k, b in x.nbytes().items():
                per[k] += b
    return per
