"""The t2 global transpose: a tiled all-to-all over a :class:`~.mesh.World`.

The port of the dense ``alltoall`` of ``distributedfft_tpu/parallel/
exchange.py`` (``exchange``, ``exchange_uneven``, ``_pad_axis``). Each
rank splits its block into P equal chunks along ``split_axis``, sends
chunk d to rank d, and concatenates what it receives, in sender order,
along ``concat_axis`` -- the semantics of ``lax.all_to_all(tiled=True)``.

Blocks travel as a list: one per rank this process holds (all P on a
loopback world, its own on a process group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..geometry import pad_to
from .mesh import World


def _pad_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to extent ``to`` (no-op when already there)."""
    if x.shape[axis] == to:
        return x
    shape = list(x.shape)
    shape[axis] = to - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _crop_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    if x.shape[axis] == to:
        return x
    return x.narrow(axis, 0, to)


def exchange(blocks: list[torch.Tensor], world: World, *, split_axis: int,
             concat_axis: int) -> list[torch.Tensor]:
    """Tiled all-to-all of every held block; ``split_axis`` must divide
    by the world size."""
    p = world.size
    if len(blocks) != len(world.ranks):
        raise ValueError(
            f"{len(blocks)} blocks for the {len(world.ranks)} ranks held")
    if blocks[0].shape[split_axis] % p:
        raise ValueError(
            f"split axis extent {blocks[0].shape[split_axis]} does not "
            f"divide by {p} ranks")
    if world.loopback:
        chunks = [b.chunk(p, dim=split_axis) for b in blocks]
        return [torch.cat([chunks[src][dst] for src in range(p)],
                          dim=concat_axis) for dst in range(p)]
    (x,) = blocks
    send = torch.stack(x.chunk(p, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(torch.view_as_real(recv), torch.view_as_real(send),
                           group=world.group)
    return [torch.cat(recv.unbind(0), dim=concat_axis)]


def exchange_uneven(blocks: list[torch.Tensor], world: World, *,
                    split_axis: int, concat_axis: int) -> list[torch.Tensor]:
    """:func:`exchange` after ceil-padding the split axis to a multiple of
    the world size. The result's concat axis holds P ceil-chunks; the
    caller crops it to its true extent."""
    to = pad_to(blocks[0].shape[split_axis], world.size)
    return exchange([_pad_axis(b, split_axis, to) for b in blocks], world,
                    split_axis=split_axis, concat_axis=concat_axis)
