"""Domain-decomposition geometry of the slab chain.

A copy of the pieces of ``distributedfft_tpu/geometry.py`` the port needs:
half-open index boxes (:class:`Box3`), the ceil-division slab rule of the
reference engine (``fft_mpi_3d_api.cpp:274-316``) and the padded extents
an equal-size all-to-all needs. Pure Python; the two packages must agree
on every box, which ``tests/test_torch_slab.py`` checks.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class Box3:
    """A half-open axis-aligned index box ``[low, high)`` in 3D."""

    low: tuple[int, int, int]
    high: tuple[int, int, int]

    def __post_init__(self) -> None:
        if len(self.low) != 3 or len(self.high) != 3:
            raise ValueError("Box3 requires 3D low/high tuples")
        if any(h < l for l, h in zip(self.low, self.high)):
            raise ValueError(
                f"Box3 high must be >= low, got {self.low}..{self.high}")

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(h - l for l, h in zip(self.low, self.high))  # type: ignore[return-value]

    def slices(self) -> tuple[slice, slice, slice]:
        """Slices selecting this box out of the world array."""
        return tuple(slice(l, h) for l, h in zip(self.low, self.high))  # type: ignore[return-value]

    def r2c(self, axis: int) -> "Box3":
        """Shrink along ``axis`` to the r2c non-redundant half, size n//2+1
        (cf. ``box3d::r2c``, ``heffte_geometry.h:94``)."""
        n = self.high[axis] - self.low[axis]
        high = list(self.high)
        high[axis] = self.low[axis] + n // 2 + 1
        return Box3(self.low, tuple(high))  # type: ignore[arg-type]


def world_box(shape: Sequence[int]) -> Box3:
    """The full-problem index box for a global grid ``shape``."""
    return Box3((0, 0, 0), tuple(int(s) for s in shape))  # type: ignore[arg-type]


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


def make_slabs(world: Box3, p: int, axis: int = 0) -> list[Box3]:
    """1D slab decomposition of ``world`` over ``axis``, rank order, by
    the ceil rule the slab plans of both packages use."""
    per_axis = [
        [(world.low[d] + a, world.low[d] + b)
         for a, b in (ceil_splits(world.shape[d], p) if d == axis
                      else [(0, world.shape[d])])]
        for d in range(3)
    ]
    return [Box3((x0, y0, z0), (x1, y1, z1))
            for (x0, x1), (y0, y1), (z0, z1) in itertools.product(*per_axis)]
