"""Plan skeleton: which decomposition, which slab axes, which boxes.

A minimal subset of ``logic_plan3d`` of ``distributedfft_tpu/
plan_logic.py`` (``:701-739``): a world of one rank (or none) is
``"single"``, a larger 1D world is ``"slab"``, and the slab axes are
those of :func:`.parallel.slab.slab_axes`. Per-rank boxes follow the ceil rule,
as the JAX package's ``stage_layouts`` does; a real-to-complex plan's
complex side is shrunk along axis 2 (``Box3.r2c``).
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


def io_boxes(lp: LogicPlan, *, forward: bool = True, real: bool = False
             ) -> tuple[list[geo.Box3], list[geo.Box3]]:
    """Per-rank input and output boxes, rank order. ``real``: an r2c
    plan, whose complex side (the output forward, the input backward)
    is the world shrunk along axis 2."""
    world = geo.world_box(lp.shape)
    cworld = world.r2c(2) if real else world
    in_world, out_world = (world, cworld) if forward else (cworld, world)
    if lp.decomposition == "single":
        return [in_world], [out_world]
    in_axis, out_axis = lp.slab_axes
    p = lp.world.size
    return (geo.make_slabs(in_world, p, in_axis),
            geo.make_slabs(out_world, p, out_axis))
