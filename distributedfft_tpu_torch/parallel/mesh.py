"""1D worlds of ranks -- the port of ``distributedfft_tpu/parallel/mesh.py``.

A slab chain runs over a :class:`World` of P ranks, with one of two
backends:

- **loopback**: one process holds all P ranks' shards as a list on one
  device, and the all-to-all is a split and a concatenation. It runs the
  distributed chain on one card (or on the CPU in the tests).
- **process group**: one rank per process, over a ``torch.distributed``
  process group (NCCL on the card, gloo on the CPU). The caller starts the
  group; nothing here reads a cluster's environment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch.distributed as dist


@dataclass(frozen=True)
class World:
    """P ranks. ``rank`` is None for a loopback world (this process holds
    every rank), else this process's rank in ``group``."""

    size: int
    rank: int | None = None
    group: Any = None

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError(f"a world needs >= 1 rank, got {self.size}")

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


def make_world(size: int) -> World:
    """A loopback world of ``size`` ranks in this process."""
    return World(int(size))


def process_group_world(group=None) -> World:
    """This process's rank of an initialized ``torch.distributed`` group
    (the default group when ``group`` is None)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "process_group_world needs torch.distributed.init_process_group "
            "first")
    return World(dist.get_world_size(group), dist.get_rank(group), group)
