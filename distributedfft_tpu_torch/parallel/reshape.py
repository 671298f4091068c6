"""Distributed reshapes between two :class:`~.mesh.Spec` layouts.

The port of ``distributedfft_tpu/parallel/reshape.py``. The JAX package
reshards a global array between two ``PartitionSpec`` layouts and lets
XLA pick the collective; here the move is the overlap map of
:mod:`.bricks` between the layouts' rank boxes (:func:`~.mesh.spec_boxes`,
ceil-split where a dim does not divide), by default its exact-count
``a2av`` transport: one ``all_to_all_single`` with split sizes on a
process group, a copy per overlap on a loopback world.

A layout's data is held per rank as a block with the rank's box at its
low corner (:func:`spec_scatter` cuts a loopback world's global array
into such views, :func:`spec_gather` joins them back).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..geometry import Box3, world_box
from .bricks import compile_move, new_blocks, pad_shape_for
from .mesh import World, spec_boxes


def spec_scatter(x: torch.Tensor, world: World, spec,
                 boxes: Sequence[Box3] | None = None) -> list:
    """A loopback world's global array ``[*lead, *shape]`` as the held
    blocks of layout ``spec``: views of ``x``, one per rank."""
    if boxes is None:
        boxes = spec_boxes(world, spec, world_box(x.shape[-3:]))
    return [x[(Ellipsis,) + b.slices()] for b in boxes]


def spec_gather(blocks: list, world: World, spec, shape,
                boxes: Sequence[Box3] | None = None) -> torch.Tensor:
    """The inverse of :func:`spec_scatter`: held blocks (each its rank's
    box at the low corner) joined into the global array."""
    if boxes is None:
        boxes = spec_boxes(world, spec, world_box(shape))
    lead = tuple(blocks[0].shape[:-3])
    out = torch.empty(lead + tuple(shape), dtype=blocks[0].dtype,
                      device=blocks[0].device)
    for blk, b in zip(blocks, boxes):
        if not b.empty:
            out[(Ellipsis,) + b.slices()] = blk[
                (Ellipsis,) + tuple(slice(0, s) for s in b.shape)]
    return out


def make_reshape3d(world: World, in_spec, out_spec, shape, *,
                   algorithm: str = "a2av", out_pad=None,
                   in_boxes=None, out_boxes=None) -> Callable:
    """A reshape of a ``shape`` world from layout ``in_spec`` to
    ``out_spec`` (``make_reshape3d``, ``heffte_reshape3d.h:498``):
    ``fn(blocks)`` takes the held blocks of ``in_spec`` and returns those
    of ``out_spec``, each ``[*lead, *out_pad]`` (default: the largest
    out box) with the box at the low corner and zeros beyond it.
    ``in_boxes`` / ``out_boxes`` override the layouts' own boxes (a
    chain's endpoints). ``fn.move`` is the overlap map."""
    wb = world_box(shape)
    ib = list(in_boxes) if in_boxes is not None else spec_boxes(
        world, in_spec, wb)
    ob = list(out_boxes) if out_boxes is not None else spec_boxes(
        world, out_spec, wb)
    pad = tuple(out_pad) if out_pad is not None else pad_shape_for(ob)
    move = compile_move(world, ib, ob, algorithm, out_pad=pad)

    def fn(blocks: list) -> list:
        dst = new_blocks(world, ob, pad, tuple(blocks[0].shape[:-3]),
                         blocks[0])
        return move.run(blocks, dst)

    fn.move = move
    return fn


def reshape3d(blocks: list, world: World, in_spec, out_spec,
              shape) -> list:
    """One-shot :func:`make_reshape3d`."""
    return make_reshape3d(world, in_spec, out_spec, shape)(blocks)
