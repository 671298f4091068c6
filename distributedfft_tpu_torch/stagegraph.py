"""Stage-graph chain IR: declarative t0..t3 nodes, an eager interpreter
and the fusion pass.

The port of the node vocabulary of ``distributedfft_tpu/stagegraph.py``
(``LocalNode``, ``ExchangeNode``, ``StageGraph``), of its fusion pass
(``plan_fusion``, ``_fused_senders``, ``_run_fused_site``), of the op
interpreter and of the staged compiler (``StagedStage``,
``StagedGraph``, ``compile_staged``), the brick-I/O edge tier
(``BrickEdgeGraph``, ``compile_brick_io``) and the concurrent scheduler
(``schedule_concurrent``, ``schedule_waves``, ``WaveSchedule``).
Builders emit a graph; :func:`_graph_steps` cuts it into schedulable
steps, which :func:`run_graph` walks in order on the blocks one process
holds and :func:`schedule_concurrent` interleaves across several
graphs. Local ops
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
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch

from .ops import cuda_fuse
from .ops.executors import get_c2r, get_executor, get_r2c, split_fuse
from .parallel.exchange import (_Pending, _crop_axis, _pad_axis,
                                check_algorithm,
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
    ``ops``) is called with a held block's rank once per run, before the
    compute, and returns that block's compute (the midpoint closures read
    their rank's wavenumber offsets there);
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


def _timer_spans(timer):
    """The span factory of one plan call: ``span(kind, name=None,
    traced=True)`` is the trace span ``name`` (when given and ``traced``)
    and ``timer``'s stage ``kind``."""
    stage = timer.stage if timer is not None else (
        lambda kind: contextlib.nullcontext())

    @contextlib.contextmanager
    def span(kind, name=None, traced=True):
        with (add_trace(name) if name and traced
              else contextlib.nullcontext()), stage(kind):
            yield

    return span


def _resolve(state):
    """A step's input: the blocks, once an exchange in flight has
    landed."""
    return state.wait() if isinstance(state, _Pending) else state


def _fused_site_steps(graph: StageGraph, interp: _Interp, n: ExchangeNode,
                      nxt: LocalNode, senders: tuple, site: dict) -> list:
    """One fused exchange site as three steps: sender stage and encode
    (one kernel when the stage is a single FFT along the split axis and
    its packs are no-ops or skipped), the wire parts through the graph's
    transport, then decode and receiver stage (one kernel when the
    receiver is an FFT along one axis, after at most a no-op crop). Each
    route away from a kernel is counted by its reason, as in the JAX
    package. The codec is timed under the stage it runs with."""
    codec = wire_codec(graph.wire_dtype)
    sender_ops = tuple(op for nd in senders for op in nd.ops)
    packs = [op for op in sender_ops if op[0] == "pack"]
    core = [op for op in sender_ops if op[0] != "pack"]
    run_pack = graph.algorithm != "alltoallv"
    ranks = graph.world.ranks

    def encode(state, span, defer):
        blocks = _resolve(state)
        y0 = blocks[0]
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
            with span(fft_node.kind, fft_node.name):
                return [cuda_fuse.fused_fft_encode(
                    y, fft_axis=core[0][1][0], forward=core[0][2],
                    tile_axis=n.split, tiles=n.parts,
                    wire_dtype=graph.wire_dtype, site=f"{n.name}:sender")
                    for y in blocks], y0.dtype
        if kernel_reason is not None:
            cuda_fuse.record_fusion_fallback(f"{n.name}:sender",
                                             kernel_reason)
        for nd in senders:
            with span(nd.kind, nd.name):
                blocks = [interp.run(nd.ops, y, rank=r)
                          for r, y in zip(ranks, blocks)]
        with span(senders[-1].kind if senders else n.kind):
            return [codec.encode(y, tile_axis=n.split, tiles=n.parts)
                    for y in blocks], blocks[0].dtype

    def ship(state, span, defer):
        parts, payload_dtype = state
        with span(n.kind, n.name):
            pend = ship_parts(parts, graph.world, split_axis=n.split,
                              concat_axis=n.concat, mesh_axis=n.mesh_axis,
                              algorithm=graph.algorithm,
                              axis_sizes=n.axis_sizes, async_op=True)
            done = _Pending(lambda: (pend.wait(), payload_dtype))
            return done if defer else done.wait()

    def receive(state, span, defer):
        shipped, payload_dtype = _resolve(state)
        rshape = shipped[0][0].shape[:-1]
        rops = nxt.ops
        recv_kernel = (
            nxt.factory is None and not nxt.takes_bounds
            and 1 <= len(rops) <= 2 and rops[-1][0] == "fft"
            and len(rops[-1][1]) == 1
            and (len(rops) == 1
                 or (rops[0][0] == "crop"
                     and rshape[rops[0][1]] == rops[0][2])))
        with span(nxt.kind, nxt.name):
            if recv_kernel:
                site["receiver"] = "kernel"
                return [cuda_fuse.fused_decode_fft(
                    w, payload_dtype, fft_axis=rops[-1][1][0],
                    forward=rops[-1][2], tile_axis=n.concat, tiles=n.parts,
                    wire_dtype=graph.wire_dtype, site=f"{nxt.name}:receiver")
                    for w in shipped]
            # A factory receiver (the t_mid midpoint) is the plain decode
            # and the factory's compute: no fused kernel holds a midpoint.
            site["receiver"] = "factory" if nxt.factory is not None else "ops"
            if nxt.factory is None:
                cuda_fuse.record_fusion_fallback(f"{nxt.name}:receiver",
                                                 "ops")
            out = []
            for fn, w in zip(_computes(graph, interp, nxt), shipped):
                v = codec.decode(w, payload_dtype, tile_axis=n.concat,
                                 tiles=n.parts)
                out.append(fn(v, 0, v.shape[n.chunk_axis])
                           if nxt.takes_bounds else fn(v))
            return out

    label = senders[-1] if senders else n
    return [(label.kind, label.name, encode), (n.kind, n.name, ship),
            (nxt.kind, nxt.name, receive)]


# ------------------------------------------------------------ executor

def _computes(graph: StageGraph, interp: _Interp, nxt: LocalNode) -> list:
    """The per-block computes of a fused node, one per held rank: the
    factory's (called here, once per rank and run) or the node's ops;
    each takes ``(v, lo, hi)`` when the node takes bounds, else
    ``(v)``."""
    ranks = graph.world.ranks
    if nxt.factory is not None:
        return [nxt.factory(r) for r in ranks]
    if nxt.takes_bounds:
        return [lambda v, lo, hi, _r=r: interp.run(
            nxt.ops, v, bounds=(lo, hi), rank=_r) for r in ranks]
    return [lambda v, _r=r: interp.run(nxt.ops, v, rank=_r) for r in ranks]


def _compute_of(graph: StageGraph, interp: _Interp, nxt: LocalNode):
    """``compute(blocks[, lo, hi])`` of a fused node over the held
    blocks."""
    fns = _computes(graph, interp, nxt)
    if nxt.takes_bounds:
        return lambda bs, lo, hi: [f(b, lo, hi) for f, b in zip(fns, bs)]
    return lambda bs: [f(b) for f, b in zip(fns, bs)]


def _pair_steps(graph: StageGraph, interp: _Interp, n: ExchangeNode,
                nxt: LocalNode) -> list:
    """An exchange and its fused compute node. At K = 1 two steps: the
    exchange, issued (asynchronously on a process group) under its span,
    and the compute after it lands. At K > 1 one step through
    :func:`.parallel.exchange.exchange_overlapped`, the pair timed as
    one span under ``"<kind>+<kind>"`` (``t2+t3``), unless the chunk
    axis has extent 1 (then the K = 1 pair, in that one step). A node
    that takes bounds gets each chunk's (lo, hi) along the chunk axis."""
    kw = dict(split_axis=n.split, concat_axis=n.concat,
              algorithm=graph.algorithm, mesh_axis=n.mesh_axis,
              axis_sizes=n.axis_sizes, wire_dtype=graph.wire_dtype)

    def compute_whole(blocks, span):
        compute = _compute_of(graph, interp, nxt)
        with span(nxt.kind, nxt.name):
            return (compute(blocks, 0, blocks[0].shape[n.chunk_axis])
                    if nxt.takes_bounds else compute(blocks))

    def issue(state, span, defer):
        blocks = _resolve(state)
        with span(n.kind, n.name):
            pend = exchange_uneven(blocks, graph.world, async_op=True, **kw)
            return pend if defer else pend.wait()

    def compute(state, span, defer):
        return compute_whole(_resolve(state), span)

    if graph.overlap_chunks <= 1:
        return [(n.kind, n.name, issue), (nxt.kind, nxt.name, compute)]

    def pair(state, span, defer):
        blocks = _resolve(state)
        extent = blocks[0].shape[n.chunk_axis]
        if len(overlap_chunk_bounds(extent, graph.overlap_chunks)) <= 1:
            with span(n.kind, n.name):
                blocks = exchange_uneven(blocks, graph.world, **kw)
            return compute_whole(blocks, span)
        with span(f"{n.kind}+{nxt.kind}", n.name, traced=False):
            return exchange_overlapped(
                blocks, graph.world, compute=_compute_of(graph, interp, nxt),
                compute_takes_bounds=nxt.takes_bounds,
                overlap_chunks=graph.overlap_chunks, chunk_axis=n.chunk_axis,
                exchange_name=n.name, compute_name=nxt.name, **kw)

    return [(n.kind, n.name, pair)]


def _into(blocks: list, outs: list) -> list:
    """Each output written into its input's storage where shape and dtype
    match (a donated input), else the output as it is."""
    return [b.copy_(y) if (y.shape == b.shape and y.dtype == b.dtype
                           and y.data_ptr() != b.data_ptr()) else y
            for b, y in zip(blocks, outs)]


def _graph_steps(graph: StageGraph, interp: _Interp, *,
                 donate: bool = False) -> list:
    """The chain as a list of ``(kind, name, run)`` schedulable steps:
    each local node, each exchange and the compute after it (one step
    for an overlap-K pair), a fused site's sender, wire exchange and
    receiver. ``run(state, span, defer)`` takes the held blocks (or the
    step before's exchange in flight, waited on first) and returns the
    next state; ``span(kind, name=None, traced=True)`` opens each node's
    trace span and timer stage (:func:`_timer_spans`); an exchange step
    with ``defer`` returns its exchange in flight rather than waiting.
    :func:`run_graph` walks them in order; :func:`schedule_concurrent`
    interleaves several chains' steps, so its outputs are those of the
    plans run one after another by construction. The fusion pass runs
    once per graph, its record in ``graph.meta["fusion"]``; ``donate``
    writes the first local stage's output into the blocks' storage."""
    graph.validate()
    nodes = graph.nodes
    fusion = graph.meta.get("fusion")
    if fusion is None:
        fusion = graph.meta["fusion"] = plan_fusion(graph)
    sender_of, consumed = (_fused_senders(nodes) if fusion["active"]
                           else ({}, set()))
    ranks = graph.world.ranks
    steps: list = []
    i = 0
    while i < len(nodes):
        node = nodes[i]
        if i in consumed:          # sender nodes run inside their site
            i += 1
        elif isinstance(node, ExchangeNode):
            if fusion["active"]:
                site = fusion["sites"].setdefault(i, {"exchange": node.name})
                steps += _fused_site_steps(
                    graph, interp, node, nodes[i + 1],
                    tuple(nodes[j] for j in sender_of[i]), site)
            else:
                steps += _pair_steps(graph, interp, node, nodes[i + 1])
            i += 2
        else:
            def local(state, span, defer, _n=node, _into_first=(
                    donate and i == 0)):
                blocks = _resolve(state)
                with span(_n.kind, _n.name):
                    outs = [interp.run(_n.ops, b, rank=r)
                            for r, b in zip(ranks, blocks)]
                    return _into(blocks, outs) if _into_first else outs

            steps.append((node.kind, node.name, local))
            i += 1
    return steps


def run_graph(graph: StageGraph, blocks: list[torch.Tensor],
              timer=None, *, donate: bool = False) -> list[torch.Tensor]:
    """Run every node of ``graph`` on the held ``blocks`` (one per rank of
    ``graph.world.ranks``): its steps (:func:`_graph_steps`) in order,
    each exchange waited on in its own span. ``timer``
    (:class:`..utils.timing.StageTimer`) times each node under its stage
    kind. ``donate``: the first stage writes its output into the blocks'
    storage (when it is a plain local stage of the blocks' shape and
    dtype), so the caller's input is workspace; the result is the same
    bits."""
    span = _timer_spans(timer)
    interp = _Interp(graph.executor, graph.algorithm)
    state = blocks
    for _, _, run in _graph_steps(graph, interp, donate=donate):
        state = run(state, span, False)
    return state


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


# ----------------------------------------------- concurrent scheduling

def graph_of(obj) -> StageGraph | None:
    """The :class:`StageGraph` a plan runs (``plan.graph``), or the one a
    callable carries as ``stage_graph``; None below the IR tier (a
    single-device plan) -- the feature-detection hook of the concurrent
    scheduler."""
    g = getattr(obj, "graph", None)
    return g if isinstance(g, StageGraph) else getattr(obj, "stage_graph",
                                                       None)


def _chain_graph(plan) -> StageGraph | None:
    """The chain a plan's call runs whole: its graph, unless it has none
    or runs it inside layout edges (a ``runner``: user layouts, bricks,
    ``r2c_axis``), which the scheduler does not interleave."""
    g = graph_of(plan)
    return g if g is not None and getattr(plan, "runner", None) is None \
        else None


def _mesh_compatible(a: World, b: World) -> bool:
    """One shared world under :func:`schedule_concurrent`'s rule: the
    same object, or the same ranks, grid, axes and group."""
    return a is b or (a.size == b.size and a.rank == b.rank
                      and a.grid == b.grid and a.axis_names == b.axis_names
                      and a.group is b.group)


def _cc_spans(j: int):
    """The span factory of transform ``j`` of a schedule: each named
    span as ``cc<j>:<name>``, no timer."""

    @contextlib.contextmanager
    def span(kind, name=None, traced=True):
        if name is None:
            yield
        else:
            with add_trace(f"cc{j}:{name}"):
                yield

    return span


@dataclass
class ConcurrentPlan:
    """N independent transforms scheduled as one interleaved program.

    ``fn`` takes the N inputs (one per plan, each what that plan's call
    takes) and returns the N outputs; calling the object does the same.
    ``plans`` are the source plans in schedule order, ``world`` the world
    they share. Every span of transform j carries the prefix ``cc<j>:``
    (:func:`.utils.trace.stage_key` drops it)."""

    fn: Callable
    plans: tuple
    world: World

    def __call__(self, *xs):
        if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
            xs = tuple(xs[0])
        if len(xs) != len(self.plans):
            raise ValueError(
                f"concurrent schedule of {len(self.plans)} transforms "
                f"takes {len(self.plans)} inputs, got {len(xs)}")
        return self.fn(*xs)


#: Memoized schedules: the same plan tuple (by identity) gives the same
#: schedule. Values hold the plans, keeping their ids valid.
_CONCURRENT_CACHE: dict = {}


def schedule_concurrent(plans: Sequence) -> ConcurrentPlan:
    """Merge N independent transforms' step lists into one interleaved
    program (the port of the JAX package's ``schedule_concurrent``):
    transform j's exchanges issue while the others' FFTs run, so wire
    time can hide under another transform's compute even when each
    alone has nothing left to hide it under.

    Policy: transform ``j`` runs its step ``wave - j`` in each wave, and
    within a wave lower ``j`` (deeper into its chain) issues first, so
    two slab transforms issue ``A.t0, A.t2, B.t0, A.t3, B.t2, B.t3``. On
    a process group an exchange step issues its collectives
    asynchronously and its wait runs at the start of that transform's
    next step, so the compute issued between them can overlap it; on a
    loopback world an exchange is copies on the compute stream, done
    when issued.

    Requirements: every plan runs a chain graph whole (a slab or pencil
    plan, C2C, real or operator, without layout edges) over one shared
    world. The steps are the ones :func:`run_graph` walks, so outputs
    equal the plans run one after another, bit for bit. Schedules are
    memoized per plan tuple (at most 64)."""
    plans = tuple(plans)
    if len(plans) < 1:
        raise ValueError("schedule_concurrent takes at least one plan")
    key = tuple(id(p) for p in plans)
    hit = _CONCURRENT_CACHE.get(key)
    if hit is not None:
        return hit[1]
    cp = _build_concurrent(plans)
    if len(_CONCURRENT_CACHE) >= 64:  # bound the program memo
        _CONCURRENT_CACHE.pop(next(iter(_CONCURRENT_CACHE)))
    _CONCURRENT_CACHE[key] = (plans, cp)
    return cp


def _build_concurrent(plans: tuple) -> ConcurrentPlan:
    """Uncached :func:`schedule_concurrent` body."""
    from .api import chain_blocks

    graphs = []
    for p in plans:
        g = _chain_graph(p)
        if g is None:
            why = ("whose layout edges wrap its stage graph"
                   if graph_of(p) is not None else "without a stage graph")
            raise ValueError(
                "schedule_concurrent needs plans built through the "
                f"stage-graph IR (slab/pencil chains); got a plan {why}: "
                f"{type(p).__name__}(decomposition="
                f"{getattr(p, 'decomposition', None)!r})")
        graphs.append(g)
    world = graphs[0].world
    for g in graphs[1:]:
        if not _mesh_compatible(g.world, world):
            raise ValueError(
                "schedule_concurrent requires one shared mesh; got "
                f"{g.world} vs {world}")
    progs = [_graph_steps(g, _Interp(g.executor, g.algorithm))
             for g in graphs]
    lens = [len(p) for p in progs]
    n = len(progs)
    spans = [_cc_spans(j) for j in range(n)]

    def fn(*xs):
        states = [chain_blocks(p, x) for p, x in zip(plans, xs)]
        for wave in range(max(lens) + n - 1):
            for j in range(n):
                k = wave - j
                if 0 <= k < lens[j]:
                    states[j] = progs[j][k][2](states[j], spans[j], True)
        return tuple(gather(g, _resolve(s)) for g, s in zip(graphs, states))

    return ConcurrentPlan(fn=fn, plans=plans, world=world)


# ----------------------------------------------------- wave scheduling

def schedule_waves(plans: Sequence, width: int = 4) -> list[tuple]:
    """Partition N plans into dispatch *waves*: consecutive runs of at
    most ``width`` plans that :func:`schedule_concurrent` can interleave
    (each runs its chain whole, all on one shared world). A plan it
    cannot take breaks the run and rides a singleton wave; a plan on
    another world starts a new run. Order-preserving."""
    if not isinstance(width, int) or width < 1:
        raise ValueError(f"wave width must be a positive int, got {width!r}")
    waves: list[tuple] = []
    cur: list = []
    cur_world = None
    for p in plans:
        g = _chain_graph(p)
        if g is None:
            if cur:
                waves.append(tuple(cur))
                cur, cur_world = [], None
            waves.append((p,))
            continue
        if cur and (len(cur) >= width
                    or not _mesh_compatible(g.world, cur_world)):
            waves.append(tuple(cur))
            cur = []
        if not cur:
            cur_world = g.world
        cur.append(p)
    if cur:
        waves.append(tuple(cur))
    return waves


def _ready_events(outs) -> list:
    """One CUDA event recorded on the current stream of each card the
    outputs lie on, after the wave's last launch (none for CPU
    outputs)."""
    events = []
    for dev in {t.device for t in outs if t.is_cuda}:
        with torch.cuda.device(dev):
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
    return events


class WaveSchedule:
    """Rolling wave-at-a-time dispatch over :func:`schedule_concurrent`
    (the port of the JAX package's ``WaveSchedule``). :meth:`dispatch`
    issues a wave (the card runs it while the host goes on) and enqueues
    it as the newest in flight; :meth:`barrier` waits until the *oldest*
    wave has drained -- on a CUDA event recorded after its last launch,
    not on the whole device -- and retires it. With ``depth=2`` wave k+1
    is assembled and dispatched while wave k still runs; at most
    ``depth`` waves are ever in flight, and they retire in order."""

    def __init__(self, *, max_width: int = 4, depth: int = 2):
        if not isinstance(max_width, int) or max_width < 1:
            raise ValueError(
                f"max_width must be a positive int, got {max_width!r}")
        if not isinstance(depth, int) or depth < 1:
            raise ValueError(f"depth must be a positive int, got {depth!r}")
        self.max_width = max_width
        self.depth = depth
        self.waves = 0  # waves dispatched over the schedule's lifetime
        self.records: list[dict] = []  # retired waves, barrier order
        self._inflight: deque = deque()  # (record, outputs, events)

    @property
    def inflight(self) -> int:
        """Waves dispatched but not yet retired by a barrier."""
        return len(self._inflight)

    def dispatch(self, plans: Sequence, inputs: Sequence) -> tuple:
        """Issue one wave and return its outputs (still being computed on
        the card). Two or more plans :func:`schedule_concurrent` takes,
        on one world, interleave; anything else dispatches plan by plan
        in order. Already ``depth`` waves deep, it first retires the
        oldest (:meth:`barrier`)."""
        plans = tuple(plans)
        inputs = tuple(inputs)
        if len(plans) != len(inputs):
            raise ValueError(
                f"wave of {len(plans)} plans takes {len(plans)} inputs, "
                f"got {len(inputs)}")
        if not plans:
            raise ValueError("cannot dispatch an empty wave")
        if len(plans) > self.max_width:
            raise ValueError(
                f"wave of {len(plans)} plans exceeds max_width="
                f"{self.max_width}; partition with schedule_waves first")
        while len(self._inflight) >= self.depth:
            self.barrier()
        graphs = [_chain_graph(p) for p in plans]
        interleaved = (len(plans) >= 2 and all(g is not None for g in graphs)
                       and all(_mesh_compatible(g.world, graphs[0].world)
                               for g in graphs[1:]))
        if interleaved:
            outs = schedule_concurrent(plans)(*inputs)
        else:
            outs = tuple(p(x) for p, x in zip(plans, inputs))
        rec = {"index": self.waves, "width": len(plans),
               "interleaved": interleaved,
               "dispatched_at": time.perf_counter()}
        self.waves += 1
        self._inflight.append((rec, outs, _ready_events(outs)))
        return outs

    def barrier(self) -> dict | None:
        """Retire the oldest in-flight wave: wait until its outputs are
        ready, stamp its drain time and duration, append it to
        :attr:`records` and return the record (None when nothing is in
        flight)."""
        if not self._inflight:
            return None
        rec, _, events = self._inflight.popleft()
        try:
            for ev in events:
                ev.synchronize()
        finally:
            rec["drained_at"] = time.perf_counter()
            rec["duration_s"] = rec["drained_at"] - rec["dispatched_at"]
            self.records.append(rec)
        return rec

    def drain(self) -> list[dict]:
        """Barrier until nothing is in flight; the retired records in
        barrier order."""
        recs = []
        while self._inflight:
            recs.append(self.barrier())
        return recs


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
