"""Stage-graph chain IR: declarative t0..t3 nodes and an eager interpreter.

The port of the node vocabulary of ``distributedfft_tpu/stagegraph.py``
(``LocalNode``, ``ExchangeNode``, ``StageGraph``). Builders emit a graph;
:func:`run_graph` executes it stage by stage on the blocks one process
holds. Local ops are ``("fft", axes, forward)``, ``("pack", axis, to)``,
``("pad", axis, to)`` and ``("crop", axis, to)``. Overlap-K chunking,
wire codecs and kernel fusion are not in this slice.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

from .ops.executors import get_executor
from .parallel.exchange import _crop_axis, _pad_axis, exchange
from .parallel.mesh import World

#: The stage kinds a chain graph may carry.
STAGE_KINDS = ("t0", "t1", "t2", "t3")


@dataclass(frozen=True)
class LocalNode:
    """One local (per-shard, collective-free) stage. ``fuse=True`` marks
    the compute that follows an exchange node."""

    kind: str
    name: str
    ops: tuple = ()
    fuse: bool = False

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(
                f"unknown stage kind {self.kind!r}; use one of {STAGE_KINDS}")


@dataclass(frozen=True)
class ExchangeNode:
    """One global transpose: a tiled all-to-all splitting ``split`` and
    concatenating ``concat`` over ``parts`` ranks."""

    kind: str
    name: str
    parts: int
    split: int
    concat: int

    def __post_init__(self):
        if self.kind != "t2":
            raise ValueError(
                f"exchange node kind must be 't2', got {self.kind!r}")


def local_node(kind: str, name: str, *ops, fuse: bool = False) -> LocalNode:
    return LocalNode(kind=kind, name=name, ops=tuple(ops), fuse=fuse)


def exchange_node(kind: str, name: str, *, parts: int, split: int,
                  concat: int) -> ExchangeNode:
    return ExchangeNode(kind=kind, name=name, parts=int(parts), split=split,
                        concat=concat)


@dataclass(frozen=True)
class StageGraph:
    """One chain as a linear list of nodes over ``world``. The plan
    pads the input axis and cuts the input into shards before the first
    node, and joins and crops the output after the last."""

    world: World
    nodes: tuple
    executor: str = "cuda"

    def validate(self) -> "StageGraph":
        nodes = self.nodes
        for i, n in enumerate(nodes):
            if isinstance(n, ExchangeNode):
                if i + 1 >= len(nodes) or not isinstance(
                        nodes[i + 1], LocalNode) or not nodes[i + 1].fuse:
                    raise ValueError(
                        f"exchange node {n.name!r} must be followed by its "
                        f"fused compute node (LocalNode(fuse=True))")
            elif n.fuse and (i == 0 or not isinstance(
                    nodes[i - 1], ExchangeNode)):
                raise ValueError(
                    f"fused node {n.name!r} has no preceding exchange")
        return self


def run_ops(ops, y: torch.Tensor, ex: Callable) -> torch.Tensor:
    """Apply one node's local ops, in order, to one block."""
    for op in ops:
        tag = op[0]
        if tag == "fft":
            y = ex(y, op[1], op[2])
        elif tag in ("pack", "pad"):
            y = _pad_axis(y, op[1], op[2])
        elif tag == "crop":
            y = _crop_axis(y, op[1], op[2])
        else:
            raise ValueError(f"unknown stage op {tag!r}")
    return y


def run_graph(graph: StageGraph, blocks: list[torch.Tensor],
              timer=None) -> list[torch.Tensor]:
    """Run every node of ``graph`` on the held ``blocks`` (one per rank of
    ``graph.world.ranks``). ``timer`` (:class:`..utils.timing.StageTimer`)
    times each node under its stage kind."""
    graph.validate()
    ex = get_executor(graph.executor)
    stage = timer.stage if timer is not None else (
        lambda kind: contextlib.nullcontext())
    for node in graph.nodes:
        with stage(node.kind):
            if isinstance(node, ExchangeNode):
                blocks = exchange(blocks, graph.world,
                                  split_axis=node.split,
                                  concat_axis=node.concat)
            else:
                blocks = [run_ops(node.ops, b, ex) for b in blocks]
    return blocks
