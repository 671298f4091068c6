"""Domain-decomposition geometry of the slab and pencil chains.

A copy of the pieces of ``distributedfft_tpu/geometry.py`` the port needs:
half-open index boxes (:class:`Box3`, with a storage ``order``), the
bounding box and tiling test of a box list (:func:`find_world`,
:func:`world_complete`), the ceil-division slab rule of the reference
engine (``fft_mpi_3d_api.cpp:274-316``), the balanced splitter,
processor-grid searches (the min-surface pencil grid), slab and pencil
decompositions, and the padded extents an equal-size all-to-all needs.
Pure Python; the two packages must agree on every box, which
``tests/test_torch_slab.py``, ``tests/test_torch_pencil.py`` and
``tests/test_torch_bricks.py`` check.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Iterable, Sequence


@dataclass(frozen=True)
class Box3:
    """A half-open axis-aligned index box ``[low, high)`` in 3D.

    ``order`` is the storage axis order of the caller's buffer for this
    box (heFFTe's ``box3d::order``): the buffer holds the brick as
    ``canonical.permute(order)``, stored dimension j running over world
    axis ``order[j]``, slowest first. As in the reference, ``order``
    takes no part in equality."""

    low: tuple[int, int, int]
    high: tuple[int, int, int]
    order: tuple[int, int, int] = field(default=(0, 1, 2), compare=False)

    def __post_init__(self) -> None:
        if len(self.low) != 3 or len(self.high) != 3:
            raise ValueError("Box3 requires 3D low/high tuples")
        if any(h < l for l, h in zip(self.low, self.high)):
            raise ValueError(
                f"Box3 high must be >= low, got {self.low}..{self.high}")
        if tuple(sorted(self.order)) != (0, 1, 2):
            raise ValueError(
                f"Box3 order must be a permutation of (0, 1, 2), "
                f"got {self.order!r}")

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(h - l for l, h in zip(self.low, self.high))  # type: ignore[return-value]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def storage_shape(self) -> tuple[int, int, int]:
        """Shape of the caller's buffer: ``shape`` permuted by ``order``."""
        s = self.shape
        return tuple(s[o] for o in self.order)  # type: ignore[return-value]

    def with_order(self, order: Sequence[int]) -> "Box3":
        """The same box with another storage order."""
        return Box3(self.low, self.high, tuple(int(o) for o in order))  # type: ignore[arg-type]

    def contains(self, other: "Box3") -> bool:
        return all(sl <= ol and oh <= sh for sl, sh, ol, oh in
                   zip(self.low, self.high, other.low, other.high))

    def intersect(self, other: "Box3") -> "Box3":
        low = tuple(max(a, b) for a, b in zip(self.low, other.low))
        high = tuple(max(l, min(a, b))
                     for l, a, b in zip(low, self.high, other.high))
        return Box3(low, high, self.order)  # type: ignore[arg-type]

    def surface(self) -> int:
        """Total surface area (the min-surface grid cost)."""
        a, b, c = self.shape
        return 2 * (a * b + b * c + a * c)

    def slices(self) -> tuple[slice, slice, slice]:
        """Slices selecting this box out of the world array."""
        return tuple(slice(l, h) for l, h in zip(self.low, self.high))  # type: ignore[return-value]

    def r2c(self, axis: int) -> "Box3":
        """Shrink along ``axis`` to the r2c non-redundant half, size n//2+1
        (cf. ``box3d::r2c``, ``heffte_geometry.h:94``)."""
        n = self.high[axis] - self.low[axis]
        high = list(self.high)
        high[axis] = self.low[axis] + n // 2 + 1
        return Box3(self.low, tuple(high), self.order)  # type: ignore[arg-type]


def world_box(shape: Sequence[int]) -> Box3:
    """The full-problem index box for a global grid ``shape``."""
    return Box3((0, 0, 0), tuple(int(s) for s in shape))  # type: ignore[arg-type]


def find_world(boxes: Iterable[Box3]) -> Box3:
    """Bounding box of a set of boxes (``find_world``,
    ``heffte_geometry.h:196``)."""
    boxes = list(boxes)
    if not boxes:
        raise ValueError("find_world of no boxes")
    low = tuple(min(b.low[i] for b in boxes) for i in range(3))
    high = tuple(max(b.high[i] for b in boxes) for i in range(3))
    return Box3(low, high)  # type: ignore[arg-type]


def world_complete(boxes: Sequence[Box3], world: Box3) -> bool:
    """True iff ``boxes`` tile ``world`` exactly: disjoint and covering
    (``world_complete``, ``heffte_geometry.h:233``)."""
    if sum(b.size for b in boxes) != world.size:
        return False
    full = [b for b in boxes if not b.empty]
    for a, b in itertools.combinations(full, 2):
        if not a.intersect(b).empty:
            return False
    return all(world.contains(b) for b in boxes)


def even_splits(n: int, parts: int) -> list[tuple[int, int]]:
    """Split ``[0, n)`` into ``parts`` contiguous chunks differing by at
    most one (the reference's balanced splitter, ``split_world``)."""
    base, rem = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < rem else 0)
        out.append((start, stop))
        start = stop
    return out


def ceil_splits(n: int, parts: int) -> list[tuple[int, int]]:
    """Split ``[0, n)`` into chunks of ``ceil(n/parts)`` with the remainder
    on the last part (trailing parts may be empty)."""
    step = -(-n // parts)
    return [(min(i * step, n), min((i + 1) * step, n)) for i in range(parts)]


def ceil_shards(n: int, parts: int) -> int:
    """Padded per-shard extent of an axis split ``parts`` ways."""
    return -(-n // parts)


def pad_to(n: int, parts: int) -> int:
    """Smallest multiple of ``parts`` that is >= ``n``."""
    return parts * ceil_shards(n, parts)


def split_world(world: Box3, grid: Sequence[int], *,
                rule=even_splits) -> list[Box3]:
    """Tile ``world`` with a ``grid[0] x grid[1] x grid[2]`` processor
    grid, the first grid axis slowest (row-major rank order)."""
    per_axis = [
        [(world.low[d] + a, world.low[d] + b)
         for a, b in rule(world.shape[d], grid[d])]
        for d in range(3)
    ]
    return [Box3((x0, y0, z0), (x1, y1, z1))
            for (x0, x1), (y0, y1), (z0, z1) in itertools.product(*per_axis)]


def factorizations3(p: int) -> list[tuple[int, int, int]]:
    """All ordered triples (a, b, c) with a*b*c == p."""
    out = []
    for a in range(1, p + 1):
        if p % a:
            continue
        q = p // a
        out.extend((a, b, q // b) for b in range(1, q + 1) if q % b == 0)
    return out


def factorizations2(p: int) -> list[tuple[int, int]]:
    """All ordered pairs (a, b) with a*b == p."""
    return [(a, p // a) for a in range(1, p + 1) if p % a == 0]


def make_procgrid(p: int) -> tuple[int, int]:
    """Most-square 2D factorization of ``p``."""
    best = (1, p)
    for a, b in factorizations2(p):
        if abs(a - b) < abs(best[0] - best[1]):
            best = (a, b)
    return best


def pencil_grid_min_surface(shape: Sequence[int], p: int) -> tuple[int, int]:
    """The 2D grid (rows over axis 0, cols over axis 1) minimizing the
    surface of the input z-pencil boxes; ties prefer more rows."""
    n0, n1, n2 = (int(s) for s in shape)
    best = None  # (cost, r, c)
    for r, c in factorizations2(int(p)):
        sx, sy = n0 / r, n1 / c
        cost = sx * sy + sy * n2 + sx * n2
        if best is None or cost < best[0] or (cost == best[0] and r > best[1]):
            best = (cost, r, c)
    return best[1], best[2]


def proc_setup_min_surface(world: Box3, p: int) -> tuple[int, int, int]:
    """The 3D processor grid minimizing total box surface area."""
    nx, ny, nz = world.shape

    def cost(grid: tuple[int, int, int]) -> float:
        gx, gy, gz = grid
        return (nx / gx) * (ny / gy) + (ny / gy) * (nz / gz) + \
            (nx / gx) * (nz / gz)

    return min(factorizations3(p), key=cost)


def make_slabs(world: Box3, p: int, axis: int = 0, *,
               rule=even_splits) -> list[Box3]:
    """1D slab decomposition over ``axis`` (``make_slabs``,
    ``heffte_geometry.h:546``)."""
    grid = [1, 1, 1]
    grid[axis] = p
    return split_world(world, grid, rule=rule)


def make_pencils(world: Box3, grid2: Sequence[int], long_axis: int, *,
                 rule=even_splits) -> list[Box3]:
    """Pencil decomposition: full extent along ``long_axis``, the 2D
    ``grid2`` over the other two axes."""
    if len(grid2) != 2:
        raise ValueError("grid2 must have two entries")
    grid = [0, 0, 0]
    grid[long_axis] = 1
    others = [d for d in range(3) if d != long_axis]
    grid[others[0]], grid[others[1]] = int(grid2[0]), int(grid2[1])
    return split_world(world, grid, rule=rule)


def is_slab(boxes: Sequence[Box3], world: Box3, axes: tuple[int, int]) -> bool:
    """True if every box spans the world along both ``axes``."""
    return all(b.low[a] == world.low[a] and b.high[a] == world.high[a]
               for b in boxes for a in axes)


def is_pencil(boxes: Sequence[Box3], world: Box3, axis: int) -> bool:
    """True if every box spans the world along ``axis``."""
    return all(b.low[axis] == world.low[axis]
               and b.high[axis] == world.high[axis] for b in boxes)


def fft_flops(shape: Sequence[int]) -> float:
    """The 5 N log2 N flop model of the reference's benchmarks."""
    n = math.prod(shape)
    return 5.0 * n * math.log2(n)
