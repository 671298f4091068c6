"""Plan skeleton: which decomposition, which world, which axes, which
boxes.

The port of the decomposition logic of ``distributedfft_tpu/
plan_logic.py``: :func:`choose_decomposition`,
:func:`eligible_decompositions`, :func:`negotiate_device_count` and a
subset of :func:`logic_plan3d` (no layout absorption, no
``PlanOptions``: the device-count renegotiation of an int world runs in
the JAX package's default ``"auto"`` mode). A world of one rank (or none)
is ``"single"``, a 1D world ``"slab"``, a 2D world ``"pencil"``; an int
world picks by :func:`choose_decomposition`, a pencil grid by
:func:`~.geometry.pencil_grid_min_surface`. Per-rank boxes follow the
ceil rule (``stage_layouts``); a real-to-complex plan's complex side is
shrunk along axis 2 (``Box3.r2c``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

from . import geometry as geo
from .parallel.mesh import World, make_world
from .parallel.slab import slab_axes

DECOMPOSITIONS = ("single", "slab", "pencil")


@dataclass(frozen=True)
class LogicPlan:
    shape: tuple[int, int, int]
    decomposition: str                 # "single" | "slab" | "pencil"
    world: World | None
    slab_axes: tuple[int, int] | None = None
    pencil_perm: tuple[int, int, int] | None = None
    pencil_order: str | None = None
    # (requested, used, reason) when an int world's count was judged
    negotiated: tuple | None = None


def eligible_decompositions(shape: Sequence[int], ndev: int
                            ) -> tuple[str, ...]:
    """Decompositions worth measuring for ``ndev`` devices: slab while
    every device owns a plane on both exchange axes, pencil on any
    multi-device count."""
    shape = tuple(int(s) for s in shape)
    if ndev <= 1:
        return ("single",)
    out = []
    if ndev <= min(shape[0], shape[1]):
        out.append("slab")
    out.append("pencil")
    return tuple(out)


def choose_decomposition(shape: Sequence[int], ndev: int) -> str:
    """Slab while every device owns at least one plane of axes 0 and 1,
    pencil once the devices outnumber them."""
    n0, n1, _ = shape
    if ndev <= 1:
        return "single"
    if ndev <= min(n0, n1):
        return "slab"
    return "pencil"


def _chain_pad_axes(shape, decomposition: str, p: int, *,
                    slab_axes: tuple[int, int] | None = None,
                    perm: tuple[int, int, int] | None = None,
                    order: str | None = None) -> list[tuple[int, int]]:
    """(array_axis, parts) pairs the chain ceil-pads at device count p."""
    if decomposition == "slab":
        in_axis, out_axis = slab_axes if slab_axes is not None else (0, 1)
        return [(in_axis, p), (out_axis, p)]
    rows, cols = geo.pencil_grid_min_surface(shape, p)
    a, b, c = perm if perm is not None else (0, 1, 2)
    pairs = [(a, rows), (b, cols)]
    if (order or "col_first") == "col_first":
        pairs += [(c, cols), (b, rows)]
    else:
        pairs += [(c, rows), (a, cols)]
    return pairs


def negotiate_device_count(shape: Sequence[int], ndev: int,
                           decomposition: str = "slab", *,
                           slab_axes: tuple[int, int] | None = None,
                           perm: tuple[int, int, int] | None = None,
                           order: str | None = None) -> int:
    """Largest device count <= ``ndev`` whose slabs or pencils divide
    every padded axis of the chain evenly."""
    shape = tuple(int(s) for s in shape)
    if decomposition == "slab":
        a0, a1 = slab_axes if slab_axes is not None else (0, 1)
        start = min(ndev, shape[a0], shape[a1])
    else:
        start = ndev
    for p in range(start, 0, -1):
        if all(shape[a] % parts == 0
               for a, parts in _chain_pad_axes(shape, decomposition, p,
                                               slab_axes=slab_axes,
                                               perm=perm, order=order)):
            return p
    return 1


def _renegotiate(shape, ndev: int, decomp: str, **axes
                 ) -> tuple[int, tuple | None]:
    """The ``"auto"`` renegotiation: shrink to the evenly-dividing count
    only when every chain axis keeps its per-device ceil extent."""
    neg = negotiate_device_count(shape, ndev, decomp, **axes)
    if neg == ndev:
        return ndev, None
    old = _chain_pad_axes(shape, decomp, ndev, **axes)
    new = _chain_pad_axes(shape, decomp, neg, **axes)
    if all(geo.ceil_shards(shape[a], p1) == geo.ceil_shards(shape[a], p0)
           for (a, p0), (_, p1) in zip(old, new)):
        return neg, (ndev, neg, "auto: even shards at equal per-device "
                                "compute")
    return ndev, (ndev, ndev, f"kept: shrinking to {neg} evenly-dividing "
                              "devices would raise per-device compute more "
                              "than the padding it removes")


def _int_world(shape, decomp: str, ndev: int) -> World:
    if decomp == "slab":
        return make_world(ndev)
    return make_world(geo.pencil_grid_min_surface(shape, ndev))


def logic_plan3d(shape, world: World | int | Sequence[int] | None, *,
                 forward: bool = True, decomposition: str | None = None
                 ) -> LogicPlan:
    """Resolve (shape, world, decomposition) to a plan skeleton. ``world``
    is None (one device), an int (a loopback world of that many ranks,
    the decomposition chosen here and the count renegotiated), a
    ``(rows, cols)`` tuple (a loopback 2D world) or a :class:`World`
    (1D: slab, 2D: pencil). ``decomposition`` (``"auto"`` when None)
    overrides the choice; a world that cannot run it raises."""
    shape = tuple(int(s) for s in shape)
    decomp = decomposition or "auto"
    if decomp not in ("auto",) + DECOMPOSITIONS:
        raise ValueError(
            f"decomposition must be auto|single|slab|pencil, got {decomp!r}")
    requested = None
    if isinstance(world, int):
        requested = world
        if decomp == "auto":
            decomp = choose_decomposition(shape, world)
        world = None if decomp == "single" or world == 1 else _int_world(
            shape, decomp, world)
    elif world is not None and not isinstance(world, World):
        world = make_world(tuple(world))
    if decomp == "single" or world is None or world.size == 1:
        return LogicPlan(shape, "single", None)
    if decomp == "auto":
        decomp = "pencil" if world.grid is not None else "slab"
    if decomp == "slab" and world.grid is not None:
        raise ValueError("slab decomposition requires a 1D world")
    if decomp == "pencil" and world.grid is None:
        raise ValueError("pencil decomposition requires a 2D world")
    axes: dict = {}
    if decomp == "slab":
        axes = dict(slab_axes=slab_axes(forward))
    else:
        axes = dict(perm=(0, 1, 2) if forward else (1, 2, 0),
                    order="col_first" if forward else "row_first")
    negotiated = None
    if requested is not None:
        used, negotiated = _renegotiate(shape, requested, decomp, **axes)
        if used == 1:
            return LogicPlan(shape, "single", None, negotiated=negotiated)
        if used != requested:
            world = _int_world(shape, decomp, used)
    return LogicPlan(shape, decomp, world, axes.get("slab_axes"),
                     axes.get("perm"), axes.get("order"), negotiated)


def _grid_boxes(world: geo.Box3, placements: dict[int, int], *,
                major_dim: int | None = None) -> tuple:
    """Boxes of a layout splitting ``placements`` = {array_dim: parts} by
    the ceil rule, ``major_dim``'s chunk index slowest (row-major rank
    order). One entry is a slab split, two a pencil grid."""
    dims = sorted(placements)
    if major_dim is not None and dims[0] != major_dim:
        dims = [major_dim] + [d for d in dims if d != major_dim]
    chunks = {d: [(world.low[d] + a, world.low[d] + b)
                  for a, b in geo.ceil_splits(world.shape[d], placements[d])]
              for d in dims}
    boxes = []
    for combo in itertools.product(*(range(placements[d]) for d in dims)):
        low, high = list(world.low), list(world.high)
        for d, ci in zip(dims, combo):
            low[d], high[d] = chunks[d][ci]
        boxes.append(geo.Box3(tuple(low), tuple(high)))
    return tuple(boxes)


def stage_layouts(lp: LogicPlan, world: geo.Box3) -> tuple:
    """The per-stage ``(fft_axes, boxes)`` chain of the plan over
    ``world``, its input side first."""
    if lp.decomposition == "single":
        return (((0, 1, 2), (world,)),)
    if lp.decomposition == "slab":
        in_axis, out_axis = lp.slab_axes
        p = lp.world.size
        local_axes = tuple(a for a in range(3) if a != in_axis)
        return ((local_axes, _grid_boxes(world, {in_axis: p})),
                ((in_axis,), _grid_boxes(world, {out_axis: p})))
    rows, cols = lp.world.grid
    a, b, c = lp.pencil_perm
    if lp.pencil_order == "col_first":
        return (((c,), _grid_boxes(world, {a: rows, b: cols}, major_dim=a)),
                ((b,), _grid_boxes(world, {a: rows, c: cols}, major_dim=a)),
                ((a,), _grid_boxes(world, {b: rows, c: cols}, major_dim=b)))
    return (((c,), _grid_boxes(world, {a: rows, b: cols}, major_dim=a)),
            ((a,), _grid_boxes(world, {c: rows, b: cols}, major_dim=c)),
            ((b,), _grid_boxes(world, {c: rows, a: cols}, major_dim=c)))


def io_boxes(lp: LogicPlan, *, forward: bool = True, real: bool = False
             ) -> tuple[list[geo.Box3], list[geo.Box3]]:
    """Per-rank input and output boxes, rank order. ``real``: an r2c
    plan, whose complex side (the output forward, the input backward)
    is the world shrunk along axis 2."""
    world = geo.world_box(lp.shape)
    cworld = world.r2c(2) if real else world
    in_world, out_world = (world, cworld) if forward else (cworld, world)
    return (list(stage_layouts(lp, in_world)[0][1]),
            list(stage_layouts(lp, out_world)[-1][1]))
