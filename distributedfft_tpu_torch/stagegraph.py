"""Stage-graph chain IR: declarative t0..t3 nodes, an eager interpreter
and the fusion pass.

The port of the node vocabulary of ``distributedfft_tpu/stagegraph.py``
(``LocalNode``, ``ExchangeNode``, ``StageGraph``), of its fusion pass
(``plan_fusion``, ``_fused_senders``, ``_run_fused_site``), of the op
interpreter and of the staged compiler (``StagedStage``,
``StagedGraph``, ``compile_staged``), and the brick-I/O edge tier
(``BrickEdgeGraph``, ``compile_brick_io``). Builders emit a graph;
:func:`run_graph` executes it on the blocks one process holds. Local ops
are ``("fft", axes, forward)``, ``("r2c", axis)``, ``("c2r", n, axis)``,
``("pack", axis, to)`` (a pad that the ``alltoallv`` transport skips:
it ships true slices), ``("pad", axis, to)``, ``("crop", axis, to)`` and
``("call", fn)`` (an opaque per-block callable, the midpoint's escape
hatch).
An exchange node names its mesh axis (``"slab"``, a pencil chain's two
axes, or a hybrid world's combined axis), and the graph names the
transport (``algorithm``) and the overlap K: at K > 1 each exchange and
the compute node after it run through
:func:`.parallel.exchange.exchange_overlapped`. Every node runs under a
trace span of its name (:func:`.utils.trace.add_trace`).

A graph with a wire codec and the ``:fuse`` executor flag runs each
exchange as a fused site: the stage before it and the encode as one
kernel (:func:`.ops.cuda_fuse.fused_fft_encode`) where that stage is a
single FFT along the split axis, the wire parts through the
all-to-all, then the decode and the stage after it as one kernel
(:func:`.ops.cuda_fuse.fused_decode_fft`) where that stage is a crop and
an FFT along the concat axis. The routes and their fallbacks are those
of the JAX package, recorded per site in ``graph.meta["fusion"]``.

A batched graph (``batch=B``) carries every axis one place up (its
builders offset them); :func:`scatter` and :func:`gather` cut and join
the spatial dims they name, the leading batch dim whole.

A spectral operator's chain (:mod:`.operators`) carries a ``t_mid`` node
after its outbound exchange: a *factory* node whose per-rank compute
(the forward transform's last FFT, the wavenumber multiplier over the
block's global indices, the inverse's first FFT) takes the overlap
chunk's bounds (``takes_bounds``), so the multiplier is generated for
exactly the chunk's slice. :func:`apply_midpoint` applies it under the
``t_mid_pointwise`` span.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from .ops import cuda_fuse
from .ops.executors import get_c2r, get_executor, get_r2c, split_fuse
from .parallel.exchange import (_crop_axis, _pad_axis, check_algorithm,
                                exchange_chunked, exchange_overlapped,
                                exchange_uneven, hierarchical_legs,
                                overlap_chunk_bounds, ship_parts,
                                wire_codec)
from .parallel.mesh import SLAB_AXIS, World
from .utils.trace import add_trace, trace_stages

#: The stage kinds a chain may carry, and those of its exchanges (a
#: pencil chain's two, and a hierarchical staged exchange's legs, are t2a
#: and t2b).
STAGE_KINDS = ("t0", "t1", "t2", "t2a", "t2b", "t_mid", "t3")
EXCHANGE_KINDS = ("t2", "t2a", "t2b")


@dataclass(frozen=True)
class LocalNode:
    """One local (per-shard, collective-free) stage. ``fuse=True`` marks
    the compute that follows an exchange node. ``factory`` (in place of
    ``ops``) is called with a held block's rank right before the exchange
    before it issues, and returns that block's compute (the midpoint
    closures read their rank's wavenumber offsets there);
    ``takes_bounds`` adds the overlap chunk's (lo, hi) along the
    exchange's chunk axis to each compute call."""

    kind: str
    name: str
    ops: tuple = ()
    fuse: bool = False
    takes_bounds: bool = False
    factory: Callable | None = field(default=None, compare=False)

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(
                f"unknown stage kind {self.kind!r}; use one of {STAGE_KINDS}")


@dataclass(frozen=True)
class ExchangeNode:
    """One global transpose: a tiled all-to-all over the ``parts`` ranks
    of each group of ``mesh_axis``, splitting ``split`` (ceil-padded to a
    multiple of ``parts`` first, except under ``alltoallv``) and
    concatenating ``concat``. ``chunk_axis`` is the bystander axis the
    overlap chunks cut; ``axis_sizes`` the (dcn, ici) grid of a
    hierarchical exchange over a combined axis."""

    kind: str
    name: str
    mesh_axis: Any
    parts: int
    split: int
    concat: int
    chunk_axis: int | None = None
    axis_sizes: tuple | None = None

    def __post_init__(self):
        if self.kind not in EXCHANGE_KINDS:
            raise ValueError(
                f"exchange node kind must be one of {EXCHANGE_KINDS}, "
                f"got {self.kind!r}")


def local_node(kind: str, name: str, *ops, fuse: bool = False,
               takes_bounds: bool = False,
               factory: Callable | None = None) -> LocalNode:
    return LocalNode(kind=kind, name=name, ops=tuple(ops), fuse=fuse,
                     takes_bounds=takes_bounds, factory=factory)


def exchange_node(kind: str, name: str, *, parts: int, split: int,
                  concat: int, mesh_axis=SLAB_AXIS,
                  chunk_axis: int | None = None,
                  axis_sizes: tuple | None = None) -> ExchangeNode:
    if chunk_axis is None:
        chunk_axis = 3 - split - concat
    return ExchangeNode(kind=kind, name=name, mesh_axis=mesh_axis,
                        parts=int(parts), split=split, concat=concat,
                        chunk_axis=chunk_axis, axis_sizes=axis_sizes)


@dataclass(frozen=True)
class StageGraph:
    """One chain as a linear list of nodes over ``world``. The plan pads
    the input (``pre``: ``("pad", axis, to)`` of the global array) and
    cuts it into shards along ``in_dims`` (one dim over a 1D world or a
    combined axis; the row and column dims over a 2D world) before the
    first node, and joins the output along ``out_dims`` and crops it
    (``post``: ``("crop", axis, to)``) after the last (:func:`scatter`,
    :func:`gather`). ``algorithm`` is every exchange's transport,
    ``overlap_chunks`` its K, ``wire_dtype`` its codec; ``batch`` the
    leading batch axis's extent (None: unbatched; the axes the nodes and
    dims name are then offset by one); ``meta`` holds planner records
    (the fusion pass's under ``"fusion"``)."""

    world: World
    nodes: tuple
    executor: str = "cuda"
    wire_dtype: str | None = None
    pre: tuple = ()
    post: tuple = ()
    in_dims: tuple = ()
    out_dims: tuple = ()
    algorithm: str = "alltoall"
    overlap_chunks: int = 1
    batch: int | None = None
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
        check_algorithm(self.algorithm)
        return self


# ------------------------------------------------------------ layouts

def _dim_parts(world: World, dims: tuple) -> dict:
    """{dim: parts} of a layout sharding ``dims`` over ``world``."""
    if len(dims) == 1:
        return {dims[0]: world.size}
    return dict(zip(dims, world.grid))


def _dim_index(world: World, dims: tuple, rank: int) -> dict:
    """{dim: this rank's chunk index} of the layout."""
    if len(dims) == 1:
        return {dims[0]: rank}
    return {dims[0]: rank // world.grid[1], dims[1]: rank % world.grid[1]}


def scatter(graph, x: torch.Tensor) -> list[torch.Tensor]:
    """The plan input as the held blocks: on a loopback world the global
    array padded by ``graph.pre`` and cut along ``graph.in_dims`` (rank
    r*cols + c holding row chunk r and column chunk c); on a process
    group this rank's box padded to its block."""
    world = graph.world
    parts = _dim_parts(world, graph.in_dims)
    if world.loopback:
        for _, axis, to in graph.pre:
            x = _pad_axis(x, axis, to)
        blocks = [x]
        for d in graph.in_dims:
            blocks = [b for blk in blocks
                      for b in blk.tensor_split(parts[d], dim=d)]
        return blocks
    for _, axis, to in graph.pre:
        x = _pad_axis(x, axis, to // parts.get(axis, 1))
    return [x.contiguous()]


def gather(graph, blocks: list[torch.Tensor]) -> torch.Tensor:
    """The plan output from the held blocks: on a loopback world joined
    along ``graph.out_dims`` and cropped by ``graph.post``; on a process
    group this rank's block cropped to its box."""
    world = graph.world
    dims = graph.out_dims
    if world.loopback:
        step = len(blocks)
        for d in dims:
            n = _dim_parts(world, dims)[d]
            step //= n
            blocks = [torch.cat(blocks[i:i + n * step:step], dim=d)
                      for i in range(step)]
        (y,) = blocks
        for _, axis, to in graph.post:
            y = _crop_axis(y, axis, to)
        return y
    (y,) = blocks
    parts = _dim_parts(world, dims)
    index = _dim_index(world, dims, world.rank)
    for _, axis, to in graph.post:
        if axis in parts:
            c = -(-to // parts[axis])
            to = max(0, min(c, to - index[axis] * c))
        y = _crop_axis(y, axis, to)
    return y


class _Interp:
    """The op interpreter: the graph's executor and real pair, resolved
    once, applied to one block in declared order. ``pack`` pads except
    under ``alltoallv``, which ships the true slices; ``("call", fn)``
    runs ``fn(y, rank)``, or ``fn(y, rank, lo, hi)`` given the chunk's
    ``bounds``, ``rank`` being the rank whose block ``y`` is."""

    def __init__(self, executor: str, algorithm: str = "alltoall"):
        self.ex = get_executor(executor)
        self.r2c = get_r2c(executor)
        self.c2r = get_c2r(executor)
        self.algorithm = algorithm

    def run(self, ops, y: torch.Tensor, bounds: tuple | None = None,
            rank: int | None = None) -> torch.Tensor:
        for op in ops:
            tag = op[0]
            if tag == "fft":
                y = self.ex(y, op[1], op[2])
            elif tag == "pack":
                if self.algorithm != "alltoallv":
                    y = _pad_axis(y, op[1], op[2])
            elif tag == "pad":
                y = _pad_axis(y, op[1], op[2])
            elif tag == "crop":
                y = _crop_axis(y, op[1], op[2])
            elif tag == "r2c":
                y = self.r2c(y, op[1])
            elif tag == "c2r":
                y = self.c2r(y, op[1], op[2])
            elif tag == "call":
                y = op[1](y, rank, *(bounds or ()))
            else:
                raise ValueError(f"unknown stage op {tag!r}")
        return y


def apply_multiplier(u: torch.Tensor, m) -> torch.Tensor:
    """Pointwise spectral multiply without dtype surprises: a real
    multiplier is cast to the payload's component dtype (a float64
    constant must not promote a complex64 chain to complex128), a complex
    one to the payload's dtype. ``m`` is rank 3 (spatial), or a scalar,
    and broadcasts over a leading batch axis."""
    if not isinstance(m, torch.Tensor):
        m = torch.as_tensor(m, device=u.device)
    if m.is_complex():
        return u * m.to(u.dtype)
    real = torch.float64 if u.dtype == torch.complex128 else torch.float32
    return u * m.to(real)


def apply_midpoint(u: torch.Tensor, multiplier: Callable,
                   grids: tuple) -> torch.Tensor:
    """The ``t_mid`` pointwise stage: the wavenumber-diagonal multiplier
    generated over the block's (or chunk's) global index ``grids`` and
    applied, under the ``t_mid_pointwise`` span (a sub-span of ``t_mid``
    that :func:`.utils.trace.stage_key` maps to no stage key)."""
    with add_trace("t_mid_pointwise"):
        return apply_multiplier(u, multiplier(*grids))


# ---------------------------------------------------------- fusion pass

def plan_fusion(graph: StageGraph) -> dict:
    """The fusion tier's graph-level gate. Fusion is asked for by the
    ``:fuse`` executor flag and is active only when the graph has a wire
    codec (else ``no_wire_codec``), runs its exchanges whole (else
    ``overlap_k``: the chunked pipeline's per-chunk compute is not a
    fused kernel's) and has an exchange (else ``no_exchange``); each
    failed gate is counted with site ``graph``.
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
    if graph.overlap_chunks != 1:
        reasons.append("overlap_k")
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


@contextlib.contextmanager
def _node_span(stage, node):
    """The node's trace span and its stage kind's timer."""
    with add_trace(node.name), stage(node.kind):
        yield


def _run_fused_site(blocks: list, graph: StageGraph, interp: _Interp,
                    n: ExchangeNode, nxt: LocalNode, senders: tuple,
                    site: dict, stage) -> list:
    """One fused exchange site over the held blocks: sender stage and
    encode (one kernel when the stage is a single FFT along the split
    axis and its packs are no-ops or skipped), the wire parts through the
    graph's transport, then decode and receiver stage (one kernel when
    the receiver is an FFT along one axis, after at most a no-op crop).
    Each route away from a kernel is counted by its reason, as in the
    JAX package. The codec is timed under the stage it runs with."""
    codec = wire_codec(graph.wire_dtype)
    sender_ops = tuple(op for nd in senders for op in nd.ops)
    packs = [op for op in sender_ops if op[0] == "pack"]
    core = [op for op in sender_ops if op[0] != "pack"]
    y0 = blocks[0]
    run_pack = graph.algorithm != "alltoallv"
    packs_noop = all((not run_pack) or y0.shape[op[1]] == op[2]
                     for op in packs)

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
        with _node_span(stage, fft_node):
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
            with _node_span(stage, nd):
                blocks = [interp.run(nd.ops, y, rank=r)
                          for r, y in zip(graph.world.ranks, blocks)]
        with stage(senders[-1].kind if senders else n.kind):
            parts = [codec.encode(y, tile_axis=n.split, tiles=n.parts)
                     for y in blocks]
    payload_dtype = blocks[0].dtype

    with _node_span(stage, n):
        shipped = ship_parts(parts, graph.world, split_axis=n.split,
                             concat_axis=n.concat, mesh_axis=n.mesh_axis,
                             algorithm=graph.algorithm,
                             axis_sizes=n.axis_sizes)

    rshape = shipped[0][0].shape[:-1]
    rops = nxt.ops
    recv_kernel = (
        nxt.factory is None and not nxt.takes_bounds
        and 1 <= len(rops) <= 2 and rops[-1][0] == "fft"
        and len(rops[-1][1]) == 1
        and (len(rops) == 1
             or (rops[0][0] == "crop" and rshape[rops[0][1]] == rops[0][2])))
    with _node_span(stage, nxt):
        if recv_kernel:
            site["receiver"] = "kernel"
            return [cuda_fuse.fused_decode_fft(
                w, payload_dtype, fft_axis=rops[-1][1][0],
                forward=rops[-1][2], tile_axis=n.concat, tiles=n.parts,
                wire_dtype=graph.wire_dtype, site=f"{nxt.name}:receiver")
                for w in shipped]
        # A factory receiver (the t_mid midpoint) is the plain decode and
        # the factory's compute: no fused kernel holds a midpoint.
        site["receiver"] = "factory" if nxt.factory is not None else "ops"
        if nxt.factory is None:
            cuda_fuse.record_fusion_fallback(f"{nxt.name}:receiver", "ops")
        out = []
        for fn, w in zip(_computes(graph, interp, nxt), shipped):
            v = codec.decode(w, payload_dtype, tile_axis=n.concat,
                             tiles=n.parts)
            out.append(fn(v, 0, v.shape[n.chunk_axis]) if nxt.takes_bounds
                       else fn(v))
        return out


# ------------------------------------------------------------ executor

def _computes(graph: StageGraph, interp: _Interp, nxt: LocalNode) -> list:
    """The per-block computes of a fused node, one per held rank: the
    factory's (called here, once per rank, right before the exchange
    issues) or the node's ops; each takes ``(v, lo, hi)`` when the node
    takes bounds, else ``(v)``."""
    ranks = graph.world.ranks
    if nxt.factory is not None:
        return [nxt.factory(r) for r in ranks]
    if nxt.takes_bounds:
        return [lambda v, lo, hi, _r=r: interp.run(
            nxt.ops, v, bounds=(lo, hi), rank=_r) for r in ranks]
    return [lambda v, _r=r: interp.run(nxt.ops, v, rank=_r) for r in ranks]


def _overlap_pair(blocks: list, graph: StageGraph, interp: _Interp,
                  n: ExchangeNode, nxt: LocalNode, stage) -> list:
    """An exchange and its fused compute node, through
    :func:`.parallel.exchange.exchange_overlapped` at the graph's K. At
    K = 1 (or a chunk axis of extent 1) each is timed under its own
    stage kind; at K > 1 they interleave, and the pair is timed as one
    span under ``"<kind>+<kind>"`` (``t2+t3``). A node that takes bounds
    gets each chunk's (lo, hi) along the chunk axis."""
    fns = _computes(graph, interp, nxt)
    if nxt.takes_bounds:
        compute = lambda bs, lo, hi: [f(b, lo, hi) for f, b in zip(fns, bs)]
    else:
        compute = lambda bs: [f(b) for f, b in zip(fns, bs)]
    kw = dict(split_axis=n.split, concat_axis=n.concat,
              algorithm=graph.algorithm, mesh_axis=n.mesh_axis,
              axis_sizes=n.axis_sizes, wire_dtype=graph.wire_dtype)
    extent = blocks[0].shape[n.chunk_axis]
    if len(overlap_chunk_bounds(extent, graph.overlap_chunks)) <= 1:
        with _node_span(stage, n):
            blocks = exchange_uneven(blocks, graph.world, **kw)
        with _node_span(stage, nxt):
            return (compute(blocks, 0, blocks[0].shape[n.chunk_axis])
                    if nxt.takes_bounds else compute(blocks))
    with stage(f"{n.kind}+{nxt.kind}"):
        return exchange_overlapped(
            blocks, graph.world, compute=compute,
            compute_takes_bounds=nxt.takes_bounds,
            overlap_chunks=graph.overlap_chunks, chunk_axis=n.chunk_axis,
            exchange_name=n.name, compute_name=nxt.name, **kw)


def _into(blocks: list, outs: list) -> list:
    """Each output written into its input's storage where shape and dtype
    match (a donated input), else the output as it is."""
    return [b.copy_(y) if (y.shape == b.shape and y.dtype == b.dtype
                           and y.data_ptr() != b.data_ptr()) else y
            for b, y in zip(blocks, outs)]


def run_graph(graph: StageGraph, blocks: list[torch.Tensor],
              timer=None, *, donate: bool = False) -> list[torch.Tensor]:
    """Run every node of ``graph`` on the held ``blocks`` (one per rank of
    ``graph.world.ranks``). ``timer`` (:class:`..utils.timing.StageTimer`)
    times each node under its stage kind. The fusion pass runs once per
    graph, its record in ``graph.meta["fusion"]``. ``donate``: the first
    stage writes its output into the blocks' storage (when it is a plain
    local stage of the blocks' shape and dtype), so the caller's input
    is workspace; the result is the same bits."""
    graph.validate()
    interp = _Interp(graph.executor, graph.algorithm)
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
        elif isinstance(node, ExchangeNode):
            if fusion["active"]:
                site = fusion["sites"].setdefault(i, {"exchange": node.name})
                blocks = _run_fused_site(
                    blocks, graph, interp, node, nodes[i + 1],
                    tuple(nodes[j] for j in sender_of[i]), site, stage)
            else:
                blocks = _overlap_pair(blocks, graph, interp, node,
                                       nodes[i + 1], stage)
            i += 2
        else:
            with _node_span(stage, node):
                outs = [interp.run(node.ops, b, rank=r)
                        for r, b in zip(graph.world.ranks, blocks)]
                blocks = _into(blocks, outs) if donate and i == 0 else outs
            i += 1
    return blocks


# ----------------------------------------------------- staged compiler

@dataclass(frozen=True)
class StagedStage:
    """One stage of a staged pipeline: ``local`` ops on each held block,
    an ``exchange`` (a dict of ``mesh_axis``, ``parts``, ``split``,
    ``concat``, ``chunk_axis`` and optionally ``axis_sizes``), or one
    hierarchical ``leg`` (``which``: ``"ici"`` or ``"dcn"``, with the
    exchange's keys and ``tile_axis_out``)."""

    kind: str
    name: str
    local: tuple | None = None
    exchange: dict | None = None
    leg: dict | None = None

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(
                f"unknown stage kind {self.kind!r}; use one of "
                f"{STAGE_KINDS}")


@dataclass(frozen=True)
class StagedGraph:
    """A staged pipeline over ``world``: the per-stage twin of
    :class:`StageGraph`. Stages pass the held blocks between them; the
    first takes the plan's input (:func:`scatter` by ``pre`` and
    ``in_dims``) and the last returns its output (:func:`gather` by
    ``out_dims`` and ``post``)."""

    world: World
    stages: tuple
    algorithm: str = "alltoall"
    wire_dtype: str | None = None
    overlap_chunks: int = 1
    executor: str = "cuda"
    pre: tuple = ()
    post: tuple = ()
    in_dims: tuple = ()
    out_dims: tuple = ()
    meta: dict = field(default_factory=dict, compare=False)


def _leg_body(stage: StagedStage, graph: StagedGraph):
    """One leg of :func:`.parallel.exchange.hierarchical_legs` over the
    held blocks, inside the wire codec's encode/decode pair when the
    graph compresses: each codec round-trips exactly (bf16 by value,
    int8/split by their pow2 steps), and the legs move peer tiles and
    sidecar rows alike, so decoding on the axis the tiles sit on at the
    leg's exit (``tile_axis_out``) and encoding again gives the bits of
    one encode/decode pair around both legs."""
    cfg = stage.leg
    leg_ici, leg_dcn = hierarchical_legs(
        graph.world, split_axis=cfg["split"], concat_axis=cfg["concat"],
        mesh_axis=cfg["mesh_axis"], axis_sizes=cfg["axis_sizes"])
    leg = leg_ici if cfg["which"] == "ici" else leg_dcn
    if graph.wire_dtype is None:
        return leg
    codec = wire_codec(graph.wire_dtype)
    p, split, out_ax = cfg["parts"], cfg["split"], cfg["tile_axis_out"]

    def run(blocks):
        parts = [codec.encode(u, tile_axis=split, tiles=p) for u in blocks]
        done = [leg([ps[j] for ps in parts]) for j in range(len(parts[0]))]
        return [codec.decode(tuple(m[b] for m in done), u.dtype,
                             tile_axis=out_ax, tiles=p)
                for b, u in enumerate(blocks)]

    return run


def compile_staged(graph: StagedGraph) -> list:
    """The staged pipeline as a ``[(name, fn), ...]`` list, each stage
    under its trace span (:func:`.utils.trace.trace_stages`). Exchanges
    run :func:`.parallel.exchange.exchange_chunked` (K chunks in one
    stage, the hierarchical leg pipeline at K > 1)."""
    interp = _Interp(graph.executor, graph.algorithm)
    world = graph.world

    def build_stage(stage: StagedStage):
        if stage.exchange is not None:
            cfg = stage.exchange
            return lambda blocks: exchange_chunked(
                blocks, world, split_axis=cfg["split"],
                concat_axis=cfg["concat"], mesh_axis=cfg["mesh_axis"],
                algorithm=graph.algorithm,
                overlap_chunks=graph.overlap_chunks,
                chunk_axis=cfg["chunk_axis"], exchange_name=stage.name,
                axis_sizes=cfg.get("axis_sizes"),
                wire_dtype=graph.wire_dtype)
        if stage.leg is not None:
            return _leg_body(stage, graph)
        return lambda blocks: [interp.run(stage.local, b, rank=r)
                               for r, b in zip(world.ranks, blocks)]

    bodies = [build_stage(s) for s in graph.stages]
    last = len(bodies) - 1

    def wrap(i, body):
        def fn(v):
            out = body(scatter(graph, v) if i == 0 else v)
            return gather(graph, out) if i == last else out
        return fn

    return trace_stages([(s.name, wrap(i, b)) for i, (s, b) in
                         enumerate(zip(graph.stages, bodies))])


# --------------------------------------------------- brick-I/O edge tier

@dataclass(frozen=True)
class BrickEdgeGraph:
    """A brick-I/O plan's edges around its chain (the port of the JAX
    package's ``BrickEdgeGraph``). ``edge_in`` is the ``(reorder | None,
    reshape)`` pair applied to the caller's held bricks: ``reorder``
    gives canonical-order views of bricks stored in their boxes' orders,
    ``reshape`` moves them into the chain's input blocks (the
    bricks-to-layout overlap map, then the edge to the chain's own
    layout where the two differ). ``edge_out`` is ``(reshape, reorder |
    None)``: ``reshape(blocks, dst)`` moves the chain's output blocks into
    ``dst``, the canonical views ``reorder`` gives of the output bricks
    (or the bricks themselves). ``alloc(like, lead)`` makes the output:
    ``(result, bricks)``, the value the plan returns and the held bricks
    it holds (zeros beyond each box). ``specs`` is the ``(in, out)``
    :class:`~.parallel.bricks.BrickSpec` accounting pair (None on the
    single-device tier), not read here."""

    edge_in: tuple
    edge_out: tuple
    alloc: Any = None
    specs: tuple | None = None

    def __post_init__(self):
        for label, pair in (("edge_in", self.edge_in),
                            ("edge_out", self.edge_out)):
            if len(pair) != 2:
                raise ValueError(
                    f"{label} must be a (reorder|None, reshape) pair "
                    f"(edge_out: (reshape, reorder|None)), got {pair!r}")


#: Span names of the two edges: those of the JAX package's functions that
#: build them (``plan_bricks_to_spec``, ``plan_spec_to_bricks``), whose
#: programs run inside one jitted call there and have no span of their
#: own.
BRICK_SPANS = ("bricks_to_spec", "spec_to_bricks")


def compile_brick_io(graph: BrickEdgeGraph, inner_fn):
    """The brick plan's ``fn(bricks) -> bricks`` over held bricks: the
    order views, the in-edge move, ``inner_fn`` (held chain blocks in and
    out), the out-edge move into the allocated output bricks, each edge
    under its :data:`BRICK_SPANS` span."""
    in_reorder, in_reshape = graph.edge_in
    out_reshape, out_reorder = graph.edge_out

    def fn(bricks: list, timer=None) -> list:
        with add_trace(BRICK_SPANS[0]):
            views = bricks if in_reorder is None else in_reorder(bricks)
            x = in_reshape(views)
        y = inner_fn(x, timer)
        with add_trace(BRICK_SPANS[1]):
            result, held = graph.alloc(y[0], tuple(y[0].shape[:-3]))
            out_reshape(y, held if out_reorder is None
                        else out_reorder(held))
        return result

    return fn
