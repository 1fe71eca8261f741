"""Dense grid maps.

The reference keeps its world as a 100x100 all-free ASCII constant
(``src/map/map.rs:1-106``: ``'.'`` = free, ``'@'`` = obstacle, ``Point=(x,y)``)
re-parsed by every binary.  Here the grid is a single dense ``(H, W)`` bool array
(True = free) — the layout XLA wants — with loaders for ASCII constants, MAPF
benchmark ``.map`` files, and procedural obstacle/warehouse generators for the
benchmark ladder (256^2 random-obstacle, 1024^2 warehouse, 4096^2).

Coordinates: ``Point = (x, y)`` tuples at the API edge (reference parity,
``src/map/map.rs:4``); internally everything is a flat row-major cell index
``idx = y * W + x`` (int32) so occupancy and field lookups are single gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Point = Tuple[int, int]

# Reference parity: 100x100, all free (src/map/map.rs:5-105).
DEFAULT_WIDTH = 100
DEFAULT_HEIGHT = 100
DEFAULT_MAP_ASCII = "\n".join(["." * DEFAULT_WIDTH] * DEFAULT_HEIGHT)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A static grid world. ``free`` is (H, W) bool, True where traversable."""

    free: np.ndarray  # (H, W) bool

    def __post_init__(self):
        assert self.free.ndim == 2 and self.free.dtype == np.bool_

    # -- constructors -------------------------------------------------------

    @staticmethod
    def default() -> "Grid":
        """The reference's built-in 100x100 empty map (src/map/map.rs:5)."""
        return Grid.from_ascii(DEFAULT_MAP_ASCII)

    @staticmethod
    def from_ascii(text: str) -> "Grid":
        """Parse '.'/'@' rows (same convention as the reference parse_map,
        e.g. src/bin/centralized/manager.rs:25-34). Blank lines are skipped."""
        rows = [line for line in text.splitlines() if line.strip()]
        w = len(rows[0])
        assert all(len(r) == w for r in rows), "ragged map rows"
        free = np.array([[c != "@" for c in row] for row in rows], dtype=np.bool_)
        return Grid(free)

    @staticmethod
    def from_mapf_file(path: str) -> "Grid":
        """Load a MAPF-benchmark ``.map`` file (movingai format: header of
        ``type/height/width/map`` then rows where ``.G S`` are free and
        ``@OTW`` are blocked)."""
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        assert lines[0].startswith("type"), f"not a movingai .map file: {path}"
        h = int(lines[1].split()[1])
        w = int(lines[2].split()[1])
        rows = lines[4 : 4 + h]
        free = np.zeros((h, w), dtype=np.bool_)
        for y, row in enumerate(rows):
            for x, c in enumerate(row[:w]):
                free[y, x] = c in ".GS"
        return Grid(free)

    @staticmethod
    def random_obstacles(height: int, width: int, density: float, seed: int) -> "Grid":
        """Random-obstacle grid (benchmark config "256x256 random-obstacle").

        Keeps only the largest connected free component so every free cell is
        mutually reachable (the solvers assume a connected free graph)."""
        rng = np.random.default_rng(seed)
        free = rng.random((height, width)) >= density
        free = _largest_component(free)
        return Grid(free)

    @staticmethod
    def warehouse(height: int, width: int, shelf_h: int = 2, shelf_w: int = 8,
                  aisle: int = 2, margin: int = 4) -> "Grid":
        """Procedural warehouse map: aligned shelf blocks separated by aisles —
        the structure of the MAPF warehouse benchmarks (1024^2 flagship config)."""
        free = np.ones((height, width), dtype=np.bool_)
        y = margin
        while y + shelf_h <= height - margin:
            x = margin
            while x + shelf_w <= width - margin:
                free[y : y + shelf_h, x : x + shelf_w] = False
                x += shelf_w + aisle
            y += shelf_h + aisle
        return Grid(free)

    # -- geometry -----------------------------------------------------------

    @property
    def height(self) -> int:
        return self.free.shape[0]

    @property
    def width(self) -> int:
        return self.free.shape[1]

    @property
    def num_cells(self) -> int:
        return self.free.size

    def free_cells(self) -> np.ndarray:
        """All free cells as (K, 2) array of (x, y) — enumeration order matches
        the reference's row-major scan (src/map/make_node.rs:5-15)."""
        ys, xs = np.nonzero(self.free)
        return np.stack([xs, ys], axis=1)

    def idx(self, p: Point) -> int:
        """Flat row-major index of point (x, y)."""
        x, y = p
        return int(y) * self.width + int(x)

    def point(self, idx: int) -> Point:
        return (int(idx) % self.width, int(idx) // self.width)

    def idx_array(self, points: np.ndarray) -> np.ndarray:
        """(K, 2) array of (x, y) -> (K,) flat indices."""
        return (points[:, 1].astype(np.int64) * self.width + points[:, 0]).astype(np.int32)

    def to_ascii(self) -> str:
        return "\n".join(
            "".join("." if c else "@" for c in row) for row in self.free
        )


def _largest_component(free: np.ndarray) -> np.ndarray:
    """Keep the largest 4-connected free component (two-pass C labeling;
    a per-cell Python flood fill would take minutes at the 4096^2 scale the
    benchmark ladder targets)."""
    if not free.any():
        return free
    from scipy import ndimage

    four_conn = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    labels, n = ndimage.label(free, structure=four_conn)
    if n <= 1:
        return free
    counts = np.bincount(labels.reshape(-1))
    counts[0] = 0  # background
    return labels == int(np.argmax(counts))
