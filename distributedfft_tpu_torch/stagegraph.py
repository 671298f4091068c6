"""Stage-graph chain IR: declarative t0..t3 nodes, an eager interpreter
and the fusion pass.

The port of the node vocabulary of ``distributedfft_tpu/stagegraph.py``
(``LocalNode``, ``ExchangeNode``, ``StageGraph``), of its fusion pass
(``plan_fusion``, ``_fused_senders``, ``_run_fused_site``) and of the op
interpreter. Builders emit a graph; :func:`run_graph` executes it stage
by stage on the blocks one process holds. Local ops are ``("fft", axes,
forward)``, ``("r2c", axis)``, ``("c2r", n, axis)``, ``("pack", axis,
to)``, ``("pad", axis, to)`` and ``("crop", axis, to)``. An exchange
node names its mesh axis (``"slab"``, or a pencil chain's ``"row"`` and
``"col"``) and ceil-pads its split axis to a multiple of that axis's
group. Overlap-K chunking is not in this port yet.

A graph with a wire codec and the ``:fuse`` executor flag runs each
exchange as a fused site: the stage before it and the encode as one
kernel (:func:`.ops.cuda_fuse.fused_fft_encode`) where that stage is a
single FFT along the split axis, the wire parts through the
all-to-all, then the decode and the stage after it as one kernel
(:func:`.ops.cuda_fuse.fused_decode_fft`) where that stage is a crop and
an FFT along the concat axis. The routes and their fallbacks are those
of the JAX package, recorded per site in ``graph.meta["fusion"]``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from .ops import cuda_fuse
from .ops.executors import get_c2r, get_executor, get_r2c, split_fuse
from .parallel.exchange import (_crop_axis, _pad_axis, exchange_uneven,
                                ship_parts, wire_codec)
from .parallel.mesh import SLAB_AXIS, World

#: The stage kinds a chain graph may carry, and those of its exchanges
#: (a pencil chain's two are t2a and t2b).
STAGE_KINDS = ("t0", "t1", "t2", "t3")
EXCHANGE_KINDS = ("t2", "t2a", "t2b")


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
    """One global transpose: a tiled all-to-all over the ``parts`` ranks
    of each group of ``mesh_axis``, splitting ``split`` (ceil-padded to a
    multiple of ``parts`` first) and concatenating ``concat``."""

    kind: str
    name: str
    mesh_axis: str
    parts: int
    split: int
    concat: int

    def __post_init__(self):
        if self.kind not in EXCHANGE_KINDS:
            raise ValueError(
                f"exchange node kind must be one of {EXCHANGE_KINDS}, "
                f"got {self.kind!r}")


def local_node(kind: str, name: str, *ops, fuse: bool = False) -> LocalNode:
    return LocalNode(kind=kind, name=name, ops=tuple(ops), fuse=fuse)


def exchange_node(kind: str, name: str, *, parts: int, split: int,
                  concat: int, mesh_axis: str = SLAB_AXIS) -> ExchangeNode:
    return ExchangeNode(kind=kind, name=name, mesh_axis=mesh_axis,
                        parts=int(parts), split=split, concat=concat)


@dataclass(frozen=True)
class StageGraph:
    """One chain as a linear list of nodes over ``world``. The plan
    pads the input (``pre``: ``("pad", axis, to)`` of the global array;
    the slab plan reads its spec instead) and cuts it into shards before
    the first node, and joins and crops the output (``post``: ``("crop",
    axis, to)``) after the last. ``wire_dtype`` compresses every
    exchange; ``meta`` holds planner records (the fusion pass's under
    ``"fusion"``)."""

    world: World
    nodes: tuple
    executor: str = "cuda"
    wire_dtype: str | None = None
    pre: tuple = ()
    post: tuple = ()
    meta: dict = field(default_factory=dict, compare=False)

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
        if self.wire_dtype is not None:
            wire_codec(self.wire_dtype)
        return self


class _Interp:
    """The op interpreter: the graph's executor and real pair, resolved
    once, applied to one block in declared order."""

    def __init__(self, executor: str):
        self.ex = get_executor(executor)
        self.r2c = get_r2c(executor)
        self.c2r = get_c2r(executor)

    def run(self, ops, y: torch.Tensor) -> torch.Tensor:
        for op in ops:
            tag = op[0]
            if tag == "fft":
                y = self.ex(y, op[1], op[2])
            elif tag in ("pack", "pad"):
                y = _pad_axis(y, op[1], op[2])
            elif tag == "crop":
                y = _crop_axis(y, op[1], op[2])
            elif tag == "r2c":
                y = self.r2c(y, op[1])
            elif tag == "c2r":
                y = self.c2r(y, op[1], op[2])
            else:
                raise ValueError(f"unknown stage op {tag!r}")
        return y


# ---------------------------------------------------------- fusion pass

def plan_fusion(graph: StageGraph) -> dict:
    """The fusion tier's graph-level gate. Fusion is asked for by the
    ``:fuse`` executor flag and is active only when the graph has a wire
    codec (else ``no_wire_codec``) and an exchange (else
    ``no_exchange``); each failed gate is counted with site ``graph``.
    Returns ``{"requested", "active", "reasons", "sites"}``; ``sites``
    fills in per exchange as the graph runs."""
    info: dict = {"requested": False, "active": False, "reasons": (),
                  "sites": {}}
    try:
        _, fused = split_fuse(graph.executor)
    except ValueError:
        return info
    if not fused:
        return info
    info["requested"] = True
    reasons = []
    if graph.wire_dtype is None:
        reasons.append("no_wire_codec")
    if not any(isinstance(n, ExchangeNode) for n in graph.nodes):
        reasons.append("no_exchange")
    info["reasons"] = tuple(reasons)
    info["active"] = not reasons
    for r in reasons:
        cuda_fuse.record_fusion_fallback("graph", r)
    return info


def _fused_senders(nodes: tuple) -> tuple[dict, set]:
    """Map each exchange index to the run of non-fused local nodes
    right before it (its sender), plus the set of indices those runs
    consume. A fused node or another exchange breaks the run."""
    sender_of: dict = {}
    consumed: set = set()
    for i, n in enumerate(nodes):
        if not isinstance(n, ExchangeNode):
            continue
        js: list = []
        j = i - 1
        while (j >= 0 and isinstance(nodes[j], LocalNode)
               and not nodes[j].fuse and j not in consumed):
            js.append(j)
            j -= 1
        js.reverse()
        sender_of[i] = tuple(js)
        consumed |= set(js)
    return sender_of, consumed


def _run_fused_site(blocks: list, graph: StageGraph, interp: _Interp,
                    n: ExchangeNode, nxt: LocalNode, senders: tuple,
                    site: dict, stage) -> list:
    """One fused exchange site over the held blocks: sender stage and
    encode (one kernel when the stage is a single FFT along the split
    axis and its packs are no-ops), the wire parts through the
    all-to-all, then decode and receiver stage (one kernel when the
    receiver is an FFT along one axis, after at most a no-op crop). Each
    route away from a kernel is counted by its reason, as in the JAX
    package. The codec is timed under the stage it runs with."""
    codec = wire_codec(graph.wire_dtype)
    sender_ops = tuple(op for nd in senders for op in nd.ops)
    packs = [op for op in sender_ops if op[0] == "pack"]
    core = [op for op in sender_ops if op[0] != "pack"]
    y0 = blocks[0]
    packs_noop = all(y0.shape[op[1]] == op[2] for op in packs)

    kernel_reason = None
    if not senders:
        site["sender"] = "encode_only"
    elif (len(core) == 1 and core[0][0] == "fft"
          and len(core[0][1]) == 1 and packs_noop):
        site["sender"] = "kernel"
    else:
        if len(core) == 1 and core[0][0] == "fft" and len(core[0][1]) > 1:
            kernel_reason = "multi_axis"
        elif not packs_noop:
            kernel_reason = "uneven_pack"
        else:
            kernel_reason = "ops"
        site["sender"] = kernel_reason

    if site["sender"] == "kernel":
        fft_node = next(nd for nd in senders
                        if any(op[0] == "fft" for op in nd.ops))
        with stage(fft_node.kind):
            parts = [cuda_fuse.fused_fft_encode(
                y, fft_axis=core[0][1][0], forward=core[0][2],
                tile_axis=n.split, tiles=n.parts,
                wire_dtype=graph.wire_dtype, site=f"{n.name}:sender")
                for y in blocks]
    else:
        if kernel_reason is not None:
            cuda_fuse.record_fusion_fallback(f"{n.name}:sender",
                                             kernel_reason)
        for nd in senders:
            with stage(nd.kind):
                blocks = [interp.run(nd.ops, y) for y in blocks]
        with stage(senders[-1].kind if senders else n.kind):
            parts = [codec.encode(y, tile_axis=n.split, tiles=n.parts)
                     for y in blocks]
    payload_dtype = blocks[0].dtype

    with stage(n.kind):
        shipped = ship_parts(parts, graph.world, split_axis=n.split,
                             concat_axis=n.concat, mesh_axis=n.mesh_axis)

    rshape = shipped[0][0].shape[:-1]
    rops = nxt.ops
    recv_kernel = (
        1 <= len(rops) <= 2 and rops[-1][0] == "fft"
        and len(rops[-1][1]) == 1
        and (len(rops) == 1
             or (rops[0][0] == "crop" and rshape[rops[0][1]] == rops[0][2])))
    with stage(nxt.kind):
        if recv_kernel:
            site["receiver"] = "kernel"
            return [cuda_fuse.fused_decode_fft(
                w, payload_dtype, fft_axis=rops[-1][1][0],
                forward=rops[-1][2], tile_axis=n.concat, tiles=n.parts,
                wire_dtype=graph.wire_dtype, site=f"{nxt.name}:receiver")
                for w in shipped]
        site["receiver"] = "ops"
        cuda_fuse.record_fusion_fallback(f"{nxt.name}:receiver", "ops")
        return [interp.run(nxt.ops, codec.decode(
            w, payload_dtype, tile_axis=n.concat, tiles=n.parts))
            for w in shipped]


# ------------------------------------------------------------ executor

def run_graph(graph: StageGraph, blocks: list[torch.Tensor],
              timer=None) -> list[torch.Tensor]:
    """Run every node of ``graph`` on the held ``blocks`` (one per rank of
    ``graph.world.ranks``). ``timer`` (:class:`..utils.timing.StageTimer`)
    times each node under its stage kind. The fusion pass runs once per
    graph, its record in ``graph.meta["fusion"]``."""
    graph.validate()
    interp = _Interp(graph.executor)
    stage = timer.stage if timer is not None else (
        lambda kind: contextlib.nullcontext())
    nodes = graph.nodes
    fusion = graph.meta.get("fusion")
    if fusion is None:
        fusion = graph.meta["fusion"] = plan_fusion(graph)
    sender_of, consumed = (_fused_senders(nodes) if fusion["active"]
                           else ({}, set()))
    i = 0
    while i < len(nodes):
        node = nodes[i]
        if i in consumed:          # sender nodes run inside their site
            i += 1
        elif isinstance(node, ExchangeNode) and fusion["active"]:
            site = fusion["sites"].setdefault(i, {"exchange": node.name})
            blocks = _run_fused_site(
                blocks, graph, interp, node, nodes[i + 1],
                tuple(nodes[j] for j in sender_of[i]), site, stage)
            i += 2
        else:
            with stage(node.kind):
                if isinstance(node, ExchangeNode):
                    blocks = exchange_uneven(
                        blocks, graph.world, split_axis=node.split,
                        concat_axis=node.concat, wire_dtype=graph.wire_dtype,
                        mesh_axis=node.mesh_axis)
                else:
                    blocks = [interp.run(node.ops, b) for b in blocks]
            i += 1
    return blocks
