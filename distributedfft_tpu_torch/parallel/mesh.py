"""Worlds of ranks -- the port of ``distributedfft_tpu/parallel/mesh.py``.

A chain runs over a :class:`World`: 1D (P ranks, mesh axis ``"slab"``)
for the slab chain, or 2D (rows x cols ranks, mesh axes ``"row"`` and
``"col"`` unless named otherwise, rank ``r * cols + c`` at row r and
column c) for the pencil chain. An exchange over the second axis
(``"col"``) runs within each row of the grid (the ranks that differ only
in their column), one over the first (``"row"``) within each column.

A hybrid world is a 2D world whose axes are the two fabrics, named
``("dcn", "ici")``: one row per node, one column per card of a node, so
rank ``d * I + e`` is card e of node d. The slab chain runs over such a
world's **combined** axis, the tuple of both names (all ranks, in rank
order); the hierarchical transport splits that exchange into a leg
within each node (``"ici"``) and a leg across nodes (``"dcn"``). Two
backends:

- **loopback**: one process holds every rank's shard as a list on one
  device, and the all-to-all is a split and a concatenation within each
  group. It runs the distributed chain on one card (or on the CPU in the
  tests).
- **process group**: one rank per process, over a ``torch.distributed``
  process group (NCCL on the card, gloo on the CPU). The caller starts the
  group; nothing here reads a cluster's environment. A 2D world makes
  one sub-group per row and per column; every rank makes all of them, in
  the same order, as ``torch.distributed.new_group`` requires.

A layout of a 3D array over a world is a :class:`Spec`, the port's
``jax.sharding.PartitionSpec``: one entry per array dim, each None
(whole), one mesh-axis name, or a tuple of names (the dim split over
their product, the first name slowest). :func:`spec_boxes` gives each
rank's box of such a layout, ceil-split as the JAX package's
``NamedSharding`` places uneven shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch.distributed as dist

from ..geometry import Box3, ceil_splits

SLAB_AXIS = "slab"
PENCIL_AXES = ("row", "col")
HYBRID_AXES = ("dcn", "ici")


@dataclass(frozen=True)
class World:
    """``size`` ranks, on a ``grid`` of (rows, cols) when 2D. ``rank`` is
    None for a loopback world (this process holds every rank), else this
    process's rank in ``group``; ``sub_groups`` maps each mesh axis of a
    2D process-group world to the sub-group this rank exchanges in.
    ``names`` are a 2D world's two axis names (``PENCIL_AXES`` when
    None; ``HYBRID_AXES`` for a hybrid world)."""

    size: int
    rank: int | None = None
    group: Any = None
    grid: tuple[int, int] | None = None
    sub_groups: dict = field(default_factory=dict, compare=False)
    names: tuple[str, str] | None = None

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError(f"a world needs >= 1 rank, got {self.size}")
        if self.grid is not None and (
                len(self.grid) != 2 or min(self.grid) < 1
                or math.prod(self.grid) != self.size):
            raise ValueError(
                f"grid {self.grid} does not hold {self.size} ranks")
        if self.names is not None and (
                self.grid is None or len(self.names) != 2
                or self.names[0] == self.names[1]):
            raise ValueError(
                f"axis names {self.names} need a 2D world and two names")

    @property
    def loopback(self) -> bool:
        return self.rank is None

    @property
    def ranks(self) -> tuple[int, ...]:
        """The ranks whose shards this process holds, in order."""
        return tuple(range(self.size)) if self.loopback else (self.rank,)

    @property
    def backend(self) -> str:
        return "loopback" if self.loopback else dist.get_backend(self.group)

    @property
    def axis_names(self) -> tuple[str, ...]:
        if self.grid is None:
            return (SLAB_AXIS,)
        return self.names if self.names is not None else PENCIL_AXES

    @property
    def combined_axis(self):
        """The mesh-axis spec of all ranks in rank order: the one axis of
        a 1D world, the tuple of both names of a 2D one."""
        return SLAB_AXIS if self.grid is None else self.axis_names

    @property
    def hybrid(self) -> bool:
        """A 2D world whose first axis is ``"dcn"`` (nodes) and second
        the cards of a node."""
        return self.grid is not None and self.axis_names[0] == "dcn"

    def axis_size(self, mesh_axis) -> int:
        """The ranks in each group of ``mesh_axis``."""
        if self._check_axis(mesh_axis) is None:
            return self.size
        return self.grid[self.axis_names.index(mesh_axis)]

    def axis_members(self, mesh_axis) -> list[list[int]]:
        """The groups of ranks that exchange together over ``mesh_axis``,
        each in the order of its index along that axis."""
        i = self._check_axis(mesh_axis)
        if i is None:
            return [list(range(self.size))]
        rows, cols = self.grid
        if i == 1:
            return [[r * cols + c for c in range(cols)] for r in range(rows)]
        return [[r * cols + c for r in range(rows)] for c in range(cols)]

    def axis_group(self, mesh_axis):
        """This rank's process group for an exchange over ``mesh_axis``."""
        if self._check_axis(mesh_axis) is None:
            return self.group
        return self.sub_groups[mesh_axis]

    def _check_axis(self, mesh_axis) -> int | None:
        """The index of ``mesh_axis`` among a 2D world's two axes, or None
        for the whole world (a 1D world's axis, or the combined axis)."""
        if isinstance(mesh_axis, (tuple, list)):
            if tuple(mesh_axis) == self.axis_names:
                return None
        elif mesh_axis in self.axis_names:
            return None if self.grid is None else self.axis_names.index(
                mesh_axis)
        raise ValueError(
            f"mesh axis {mesh_axis!r} is not one of this world's "
            f"{self.axis_names}")


def _grid(shape) -> tuple[int, int] | None:
    if isinstance(shape, int):
        return None
    shape = tuple(int(s) for s in shape)
    if len(shape) == 1:
        return None
    if len(shape) != 2:
        raise ValueError(f"a world is 1D or 2D, got shape {shape}")
    return shape


def make_world(shape: int | Sequence[int],
               axis_names: Sequence[str] | None = None) -> World:
    """A loopback world in this process: ``make_world(4)`` is 1D (the
    slab chain), ``make_world((2, 2))`` 2D (the pencil chain), and
    ``make_world((2, 2), HYBRID_AXES)`` a hybrid world of 2 nodes of 2
    cards."""
    grid = _grid(shape)
    if grid is None:
        if axis_names is not None:
            raise ValueError("axis names name the axes of a 2D world")
        return World(int(shape if isinstance(shape, int) else shape[0]))
    return World(math.prod(grid), grid=grid,
                 names=None if axis_names is None else tuple(axis_names))


def process_group_world(group=None, *, grid: Sequence[int] | None = None,
                        axis_names: Sequence[str] | None = None) -> World:
    """This process's rank of an initialized ``torch.distributed`` group
    (the default group when ``group`` is None); with ``grid=(rows,
    cols)`` a 2D world over it (its axes named ``axis_names``), its row
    and column sub-groups made here. Every rank of ``group`` must call it
    with the same grid.

    A 2D world needs a group that holds every process of the default
    group: ``dist.new_group`` must be entered by all of those processes,
    members or not, so a sub-group's grid would hang the processes
    outside it. Such a grid raises ``ValueError``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "process_group_world needs torch.distributed.init_process_group "
            "first")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if grid is None:
        return World(size, rank, group)
    grid = _grid(grid)
    if size != dist.get_world_size():
        raise ValueError(
            f"a 2D world needs every process of the default group; this "
            f"group holds {size} of {dist.get_world_size()}")
    if grid is None or math.prod(grid) != size:
        raise ValueError(f"grid {grid} does not hold the group's {size} ranks")
    world = World(size, rank, group, grid,
                  names=None if axis_names is None else tuple(axis_names))
    members = dist.get_process_group_ranks(
        group if group is not None else dist.group.WORLD)
    for axis in world.axis_names:
        for ranks in world.axis_members(axis):
            sub = dist.new_group([members[r] for r in ranks])
            if rank in ranks:
                world.sub_groups[axis] = sub
    return world


class Spec:
    """A layout of a 3D array over a world's mesh axes (the port of
    ``PartitionSpec``): ``Spec("slab", None, None)`` shards dim 0 over a
    1D world, ``Spec(None, "row", "col")`` dims 1 and 2 over a 2D one,
    ``Spec(("row", "col"), None, None)`` dim 0 over both. Missing
    trailing entries are None; :func:`spec_entries` validates."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Spec):
            return NotImplemented
        return _padded(self.entries) == _padded(other.entries)

    def __hash__(self) -> int:
        return hash(_padded(self.entries))

    def __repr__(self) -> str:
        return f"Spec({', '.join(repr(e) for e in self.entries)})"


def _padded(entries: tuple) -> tuple:
    """Entries with trailing Nones dropped (a short spec equals its
    padded form)."""
    entries = tuple(entries)
    while entries and entries[-1] is None:
        entries = entries[:-1]
    return entries


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def spec_entries(world: World, spec, ndim: int = 3) -> tuple:
    """Validate a layout against ``world``'s axis names and return its
    entries padded to ``ndim`` (``plan_logic.spec_entries`` of the JAX
    package, its error text)."""
    entries = tuple(spec)
    if len(entries) > ndim:
        raise ValueError(
            f"PartitionSpec {spec} has more entries than the {ndim} array "
            f"dims")
    for entry in entries:
        if entry is None:
            continue
        for nm in _names(entry):
            if nm not in world.axis_names:
                raise ValueError(
                    f"spec {spec} names unknown mesh axis {nm!r}; mesh "
                    f"axes: {world.axis_names}")
    return entries + (None,) * (ndim - len(entries))


def axis_coords(world: World, rank: int) -> dict:
    """{axis name: rank's index along it}: a 1D world's one axis, a 2D
    world's row (rank // cols) and column (rank % cols)."""
    if world.grid is None:
        return {world.axis_names[0]: rank}
    cols = world.grid[1]
    return dict(zip(world.axis_names, (rank // cols, rank % cols)))


def spec_parts(world: World, entry) -> int:
    """Ranks that share one dim under a spec entry (1 for None)."""
    if entry is None:
        return 1
    return math.prod(world.axis_size(nm) for nm in _names(entry))


def spec_boxes(world: World, spec, box: Box3) -> list[Box3]:
    """Each rank's box of layout ``spec`` over ``box``, in rank order: a
    sharded dim cut by the ceil rule into the product of its axes'
    sizes, a rank's chunk its row-major index over the entry's axes;
    dims no entry names are whole, so a spec that leaves an axis unused
    repeats boxes."""
    entries = spec_entries(world, spec, 3)
    out = []
    for r in range(world.size):
        coords = axis_coords(world, r)
        low, high = list(box.low), list(box.high)
        for d, entry in enumerate(entries):
            if entry is None:
                continue
            idx = 0
            for nm in _names(entry):
                idx = idx * world.axis_size(nm) + coords[nm]
            a, b = ceil_splits(box.shape[d], spec_parts(world, entry))[idx]
            low[d], high[d] = box.low[d] + a, box.low[d] + b
        out.append(Box3(tuple(low), tuple(high)))
    return out
