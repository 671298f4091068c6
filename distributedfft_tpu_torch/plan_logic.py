"""Plan skeleton: which decomposition, which slab axes, which boxes.

A minimal subset of ``logic_plan3d`` of ``distributedfft_tpu/
plan_logic.py`` (``:701-739``): a world of one rank (or none) is
``"single"``, a larger 1D world is ``"slab"``, and the slab axes are
those of :func:`.parallel.slab.slab_axes`. Per-rank boxes follow the ceil rule,
as the JAX package's ``stage_layouts`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import geometry as geo
from .parallel.mesh import World
from .parallel.slab import slab_axes


@dataclass(frozen=True)
class LogicPlan:
    shape: tuple[int, int, int]
    decomposition: str                 # "single" | "slab"
    world: World | None
    slab_axes: tuple[int, int] | None = None


def logic_plan3d(shape, world: World | None, *, forward: bool = True
                 ) -> LogicPlan:
    shape = tuple(int(s) for s in shape)
    if world is None or world.size == 1:
        return LogicPlan(shape, "single", None)
    return LogicPlan(shape, "slab", world, slab_axes(forward))


def io_boxes(lp: LogicPlan) -> tuple[list[geo.Box3], list[geo.Box3]]:
    """Per-rank input and output boxes, rank order."""
    world = geo.world_box(lp.shape)
    if lp.decomposition == "single":
        return [world], [world]
    in_axis, out_axis = lp.slab_axes
    p = lp.world.size
    return (geo.make_slabs(world, p, in_axis),
            geo.make_slabs(world, p, out_axis))
