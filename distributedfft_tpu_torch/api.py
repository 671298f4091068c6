"""Plan and execute distributed 3D FFTs -- the port of ``Plan3D`` /
``plan_dft_c2c_3d`` / ``plan_dft_r2c_3d`` / ``plan_dft_c2r_3d`` / the
brick planners / ``execute`` of ``distributedfft_tpu/api.py``.

A plan runs on ``torch.device("cuda")`` unless the caller passes another
device; without a device and without CUDA, planning raises. On a world of
one rank (or none) the plan is ``"single"``: one executor call over axes
(0, 1, 2), or for a real plan the r2c along axis 2 and the C2C over (0,
1). On a larger 1D world it is the slab chain of :mod:`.parallel.slab`,
on a 2D world (a :class:`~.parallel.mesh.World` or a ``(rows, cols)``
tuple) the pencil chain of :mod:`.parallel.pencil`; an int world picks
by :func:`.plan_logic.choose_decomposition`, and ``decomposition=``
overrides. ``dtype`` is complex64 (the default: the card's working type)
or complex128, whose real side is float64.

``algorithm`` picks the exchange transport (``alltoall``, ``alltoallv``,
``ppermute``, or on a 2D hybrid world ``hierarchical``, which runs the
slab C2C chain over its combined axis; pencil and real plans take the
flat three), ``overlap_chunks`` the K of the pipelined t2/t3 overlap (an
int, ``"auto"``, or None for ``DFFT_OVERLAP``, else 1).
``wire_dtype`` (``"bf16"``, ``"int8"``, ``"split"``) compresses the
chain's exchanges; ``fuse=True`` (the ``cuda:fuse`` executor label) asks
the stage graph to fuse the codec into the stages beside each exchange
(at K = 1). Every knob can come as one :class:`~.plan_logic.PlanOptions`
(``options=``) instead. A single-device plan has no exchange and drops
the codec, the transport's choice and K. ``wire_dtype=None`` and
``fuse=None`` read ``DFFT_WIRE_DTYPE`` and ``DFFT_FUSE`` at plan time (a
``DFFT_FUSE`` default is ignored by executors without a fused tier); the
matmul tiers' ``DFFT_MM_PRECISION`` / ``DFFT_MM_COMPLEX`` defaults apply
where no tier is named (:mod:`.ops.dft_matmul`).

Measured planning: ``tune="measure"`` runs the tuner's pruned
tournament over decomposition, transport, executor, K (and, under a
``max_roundtrip_err`` budget, the wire codecs and matmul tiers) on a
wisdom miss and records the winner; ``tune="wisdom"`` replays a stored
winner and plans by the heuristics on a miss (:mod:`.tuner`; None reads
``DFFT_TUNE``). ``executor="auto"`` plans each executor of
:data:`_AUTO_CANDIDATES` (``DFFT_AUTO_EXECUTORS``), times each and keeps
the fastest.

Layouts and batches:

- ``in_spec`` / ``out_spec`` (:class:`~.parallel.mesh.Spec`) name the
  caller's layouts. A slab or pencil layout of the world re-axes the
  chain (absorbed); any other even layout gets an edge reshape
  (:mod:`.parallel.reshape`) into and out of the chain.
- ``batch=B`` runs B transforms of one shape through one chain, every
  exchange shared (I/O ``[B, *shape]``); ``batch=1`` is the unbatched
  plan.
- ``r2c_axis`` 0 or 1 halves that axis: the canonical chain on the
  swapped view, shapes and boxes permuted back.
- ``donate=True`` lets the plan use its input's storage as workspace.
- The brick planners (:func:`plan_brick_dft_c2c_3d` and the real pair)
  take any per-rank boxes, each with a storage ``order``, and bracket
  the canonical chain with the overlap-map edges of
  :mod:`.parallel.bricks`.

:class:`OpPlan3D` is a spectral operator's plan (:mod:`.operators`): a
forward chain, the ``t_mid`` multiplier and the inverse chain as one
call, its I/O the chain's input layout on both sides.

Fault points (:mod:`.faults`, ``DFFT_FAULT_INJECT``): ``plan`` at each
cache-miss build, ``compile`` at a plan's first execution and in
:meth:`Plan3D.compile`, ``exchange`` at each execution of a plan with a
world, ``execute`` at each execution.

I/O of a distributed plan: on a loopback world ``execute`` takes and
returns the global array (``[B, *shape]`` batched), a brick plan the
``[P, *pad]`` stack of :func:`~.parallel.bricks.scatter_bricks` (zero
padding on output); on a process-group world this rank's input box (a
brick plan: its brick, in its box's storage order) and its output box.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Sequence

import torch

from . import faults as _faults
from . import geometry as geo
from .ops.executors import (FUSE_BASES, MM_EXECUTOR_BASES, Scale,
                            apply_scale, fused_name, get_c2r, get_executor,
                            get_r2c, run_donated, scale_factor,
                            split_executor, split_fuse, tiered_name)
from .parallel import bricks
from .parallel.exchange import WIRE_BYTE_KEYS, wire_codec
from .parallel.mesh import (Spec, World, make_world, spec_boxes, spec_entries,
                            spec_parts)
from .parallel.pencil import (PencilSpec, build_pencil_fft3d,
                              build_pencil_rfft3d)
from .parallel.reshape import make_reshape3d, spec_gather, spec_scatter
from .parallel.slab import (SlabSpec, build_slab_fft3d, build_slab_rfft3d,
                            check_batch)
from .plan_logic import (LogicPlan, PlanOptions, exchange_payloads, io_boxes,
                         logic_plan3d, resolve_fuse, resolve_tune_mode,
                         resolve_wire_dtype)
from .stagegraph import (BrickEdgeGraph, StageGraph, compile_brick_io,
                         gather, plan_fusion, run_graph, scatter)
from .utils import metrics as _metrics
from .utils.trace import add_trace

# FFTW sign convention.
FORWARD = -1
BACKWARD = +1

#: The complex working dtypes and their real sides.
REAL_DTYPE = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def resolve_device(device=None) -> torch.device:
    """The plan's device: CUDA unless ``device`` names another. Raises
    when CUDA is asked for (or defaulted to) and absent."""
    d = torch.device("cuda") if device is None else torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: distributedfft_tpu_torch runs on the card "
                "unless the caller passes device='cpu'")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass
class Plan3D:
    """A distributed 3D FFT plan (one direction). ``shape`` is the
    real-space world; ``kind`` is ``"c2c"`` or ``"r2c"`` (a real plan:
    forward real in, complex half-spectrum out along ``r2c_axis``,
    backward the mirror); ``dtype`` is the complex working dtype.
    ``in_shape`` / ``out_shape`` are what ``execute`` takes and returns
    on a loopback world: the world (``[B, ...]`` batched) or a brick
    plan's stack ``[P, *pad]``. ``brick_edges`` is a brick plan's (in,
    out) :class:`~.parallel.bricks.BrickSpec` pair; ``runner`` the
    execution of a plan whose edges wrap another (layouts, bricks, the
    swapped view of ``r2c_axis``)."""

    shape: tuple[int, int, int]
    direction: int
    dtype: torch.dtype
    decomposition: str            # "single" | "slab" | "pencil"
    executor: str
    world: World | None
    device: torch.device
    kind: str = "c2c"
    wire_dtype: str | None = None
    algorithm: str = "alltoall"
    overlap_chunks: int = 1
    options: PlanOptions | None = None
    graph: StageGraph | None = None
    spec: SlabSpec | PencilSpec | None = None
    in_boxes: list[geo.Box3] = field(default_factory=list)
    out_boxes: list[geo.Box3] = field(default_factory=list)
    in_shape: tuple | None = None
    out_shape: tuple | None = None
    batch: int | None = None
    r2c_axis: int = 2
    in_spec: Spec | None = None
    out_spec: Spec | None = None
    donate: bool = False
    logic: LogicPlan | None = None
    brick_edges: tuple | None = None
    runner: Callable | None = None

    def __post_init__(self) -> None:
        bpfx = () if self.batch is None else (self.batch,)
        side = (self.shape, self.complex_shape)
        if self.in_shape is None:
            self.in_shape = bpfx + side[0 if self.forward else 1]
        if self.out_shape is None:
            self.out_shape = bpfx + side[1 if self.forward else 0]

    @property
    def forward(self) -> bool:
        return self.direction == FORWARD

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    @property
    def complex_shape(self) -> tuple[int, int, int]:
        """The complex side's global shape (``r2c_axis`` shrunk on r2c)."""
        if self.kind != "r2c":
            return self.shape
        s = list(self.shape)
        s[self.r2c_axis] = s[self.r2c_axis] // 2 + 1
        return tuple(s)

    @property
    def in_dtype(self) -> torch.dtype:
        return (REAL_DTYPE[self.dtype] if self.kind == "r2c" and self.forward
                else self.dtype)

    @property
    def out_dtype(self) -> torch.dtype:
        return (REAL_DTYPE[self.dtype]
                if self.kind == "r2c" and not self.forward else self.dtype)

    def describe(self) -> dict[str, Any]:
        """The plan's geometry and routing as plain values (see
        :func:`plan_from_reference`); ``grid`` is the (rows, cols) of a
        2D world, else None; ``algorithm`` and ``overlap_chunks`` the
        exchange's transport and resolved K. A box is ``(low, high)``, or
        ``(low, high, order)`` when its storage order is not the
        identity; a spec its entries; ``brick_edges`` each edge's
        transport, payload and wire elements and table bytes."""
        fusion = self.graph.meta["fusion"] if self.graph is not None else {
            "requested": split_fuse(self.executor)[1], "active": False,
            "reasons": ()}
        return dict(
            shape=self.shape,
            world_size=1 if self.world is None else self.world.size,
            grid=None if self.world is None else self.world.grid,
            direction=self.direction,
            dtype=str(self.dtype).removeprefix("torch."),
            kind=self.kind,
            decomposition=self.decomposition,
            executor=self.executor,
            wire_dtype=self.wire_dtype,
            algorithm=self.algorithm,
            overlap_chunks=self.overlap_chunks,
            fusion={k: fusion[k] for k in ("requested", "active", "reasons")},
            in_boxes=[_box_desc(b) for b in self.in_boxes],
            out_boxes=[_box_desc(b) for b in self.out_boxes],
            batch=self.batch,
            r2c_axis=self.r2c_axis,
            in_spec=None if self.in_spec is None else tuple(self.in_spec),
            out_spec=None if self.out_spec is None else tuple(self.out_spec),
            brick_edges=None if self.brick_edges is None else [
                _edge_desc(bs) for bs in self.brick_edges],
        )

    def __call__(self, x: torch.Tensor, *, scale: Scale = Scale.NONE,
                 timer=None) -> torch.Tensor:
        return execute(self, x, scale=scale, timer=timer)

    def compile(self) -> "Plan3D":
        """Warm everything this plan's transform builds on first use (the
        kernel library, twiddle tables, the caching allocator's blocks),
        so later executions only replay: one throwaway execution on zeros
        of the plan's input (:func:`alloc_local`), synchronised. Runs the
        ``compile`` fault point first; returns ``self``."""
        from .utils.timing import sync

        _faults.check("compile", self.executor)
        t0 = time.perf_counter()
        sync(_run_plan(self, alloc_local(self), None))
        self._warm = True  # the compile fault point fired (or passed)
        if _metrics._enabled:
            _metrics.observe(
                "compile_seconds", time.perf_counter() - t0,
                decomposition=self.decomposition, executor=self.executor)
        return self


@dataclass
class OpPlan3D(Plan3D):
    """A spectral-operator plan (:mod:`.operators`): FFT, the pointwise
    multiplier at the chain's transposed midpoint, inverse FFT, as one
    plan call whose I/O is the chain's input layout on both sides.
    ``op`` is the operator's label (``"poisson"``), ``op_spec`` its
    :class:`~.operators.SpectralOp`, ``multiplier`` its generator (the
    staged pipeline rebuilds ``t_mid`` from it)."""

    op: str = ""
    op_spec: Any = None
    multiplier: Any = None

    def describe(self) -> dict[str, Any]:
        """:meth:`Plan3D.describe` with the operator's label as ``op``."""
        return dict(super().describe(), op=self.op)


def _box_desc(b: geo.Box3) -> tuple:
    lh = (tuple(b.low), tuple(b.high))
    return lh if tuple(b.order) == (0, 1, 2) else lh + (tuple(b.order),)


def _edge_desc(bs) -> dict:
    return dict(algorithm=bs.algorithm, payload_elems=bs.payload_elems,
                wire_elems=bs.wire_elems,
                a2av_table_bytes=bs.a2av_table_bytes)


def _resolve_options(options: PlanOptions | None, executor: str,
                     wire_dtype: str | None, fuse: bool | None,
                     decomposition: str | None, algorithm: str,
                     overlap_chunks, donate: bool = False, tune=None,
                     max_roundtrip_err=None, mm_precision=None,
                     mm_complex=None) -> PlanOptions:
    """One :class:`PlanOptions` from ``options=`` or the keywords (not
    both), its executor label canonical (:func:`_apply_mm_tiers`,
    :func:`_apply_fuse`) and its wire resolved (``DFFT_WIRE_DTYPE`` for
    None; ``"none"`` marks the exact wire, so a later resolution keeps
    it exact)."""
    if options is not None:
        if (executor != "cuda" or wire_dtype is not None or fuse is not None
                or decomposition is not None or algorithm != "alltoall"
                or overlap_chunks is not None or donate
                or tune is not None or max_roundtrip_err is not None
                or mm_precision is not None or mm_complex is not None):
            raise ValueError(
                "pass either options= or individual plan keywords, not both")
        opts = options
    else:
        if wire_dtype not in (None, "none"):
            wire_codec(wire_dtype)     # the codec registry's own error
        opts = PlanOptions(decomposition=decomposition or "auto",
                           algorithm=algorithm, executor=executor,
                           overlap_chunks=overlap_chunks,
                           wire_dtype=wire_dtype, fuse=fuse, donate=donate,
                           tune=tune, max_roundtrip_err=max_roundtrip_err,
                           mm_precision=mm_precision, mm_complex=mm_complex)
    opts = _apply_fuse(_apply_mm_tiers(opts))
    if opts.executor != "auto":
        get_executor(opts.executor)
    return replace(opts, wire_dtype=resolve_wire_dtype(opts.wire_dtype)
                   or "none")


def _apply_mm_tiers(opts: PlanOptions) -> PlanOptions:
    """The plan's matmul tier composed into its executor label
    (``matmul`` + ``bf16`` -> ``matmul:bf16``), and a label's own
    suffixes back-filled into ``mm_precision`` / ``mm_complex``: the
    label and the fields are two views of one choice. A tier on an
    executor that never reads it raises, unless the plan is tuned (then
    it pins the tuner's tier axis)."""
    ex = opts.executor
    if opts.mm_precision is None and opts.mm_complex is None:
        if ":" not in ex:
            return opts
        base, tier, cmode = split_executor(ex)
        _, want_fuse = split_fuse(ex)
        return replace(opts, mm_precision=tier, mm_complex=cmode,
                       executor=fused_name(tiered_name(base, tier, cmode),
                                           want_fuse or None))
    if not ex.split(":", 1)[0].startswith(MM_EXECUTOR_BASES):
        if resolve_tune_mode(opts.tune) != "off":
            return opts
        raise ValueError(
            f"mm_precision/mm_complex scope the matmul-family executors "
            f"{MM_EXECUTOR_BASES}; executor={ex!r} never consults them "
            f"(use tune='measure'/'wisdom' to search the tiered "
            f"candidate axis instead)")
    name = tiered_name(ex, opts.mm_precision, opts.mm_complex)
    _, tier, cmode = (split_executor(name) if ":" in name
                      else (name, None, None))
    return replace(opts, executor=name, mm_precision=tier, mm_complex=cmode)


def _apply_fuse(opts: PlanOptions) -> PlanOptions:
    """The fuse flag composed into the executor label (``cuda:fuse``),
    ``fuse`` back-filled from it. ``fuse=True`` on an executor without a
    fused tier raises; the ``DFFT_FUSE`` default is ignored there."""
    ex = opts.executor
    pinned = split_fuse(ex)[1] if ":" in ex else False
    if opts.fuse is False and pinned:
        raise ValueError(
            f"executor {ex!r} already pins the fuse flag; fuse=False "
            f"conflicts (drop one of the two spellings)")
    if resolve_fuse(opts.fuse) and not pinned:
        if ex.split(":", 1)[0] in FUSE_BASES:
            ex = fused_name(ex, True)
            pinned = True
        elif opts.fuse is not None:
            raise ValueError(
                f"fuse=True scopes the fused-tier executors {FUSE_BASES}; "
                f"executor={ex!r} has no fusion tier (the DFFT_FUSE "
                f"default is ignored there)")
    if ex == opts.executor and bool(opts.fuse) == pinned:
        return opts
    return replace(opts, executor=ex, fuse=pinned)


def _norm_batch(batch) -> int | None:
    """``batch`` as None (unbatched) or an int >= 2: ``batch=1`` is the
    unbatched plan."""
    batch = check_batch(batch)
    return None if batch == 1 else batch


def _refuse_batched_layouts(batch, in_spec, out_spec) -> None:
    if batch is not None and (in_spec is not None or out_spec is not None):
        raise ValueError("batched plans take the canonical chain layouts; "
                         "in_spec/out_spec require batch=None (or 1)")


# -------------------------------------------------------- user layouts

def _spec_divides(world: World, spec: Spec, shape) -> bool:
    """True when every sharded dim of ``shape`` divides by its axes'
    product."""
    return all(shape[d] % spec_parts(world, e) == 0
               for d, e in enumerate(spec_entries(world, spec, 3)))


def _chain_specs(plan: Plan3D) -> tuple[Spec, Spec]:
    """The (input, output) layouts of a chain plan's own endpoints."""
    world, spec = plan.world, plan.spec
    entries = [[None] * 3, [None] * 3]
    if isinstance(spec, SlabSpec):
        entries[0][spec.in_axis] = world.combined_axis
        entries[1][spec.out_axis] = world.combined_axis
    else:
        row, col = world.axis_names
        for side, (r, c) in enumerate((spec.in_placement,
                                       spec.out_placement)):
            entries[side][r], entries[side][c] = row, col
    return Spec(*entries[0]), Spec(*entries[1])


def _wrap_user_layout(plan: Plan3D, in_spec, out_spec, in_shape,
                      out_shape) -> None:
    """Edge reshapes around a chain for layouts it could not absorb (the
    port of ``_wrap_user_layout``; heFFTe's planner prepends and appends
    a reshape for such layouts, ``heffte_plan_logic.cpp:162-245``). The
    user layouts must divide their extents evenly; the chain's own
    (ceil-split) endpoints need not. The user layouts' rank boxes are
    :func:`~.parallel.mesh.spec_boxes` (the JAX package's
    ``_layout_boxes``), the chain's blocks those boxes' common pad. Sets
    the plan's boxes and runner."""
    world = plan.world
    for label, spec, shp in (("in_spec", in_spec, in_shape),
                             ("out_spec", out_spec, out_shape)):
        if spec is not None and not _spec_divides(world, spec, shp):
            raise ValueError(
                f"{label}={spec} does not evenly divide extents "
                f"{tuple(shp)} over the mesh; brick layouts need divisible "
                f"shards")
    chain_in, chain_out = list(plan.in_boxes), list(plan.out_boxes)
    in_world, out_world = geo.world_box(in_shape), geo.world_box(out_shape)
    into = outof = None
    if in_spec is not None:
        plan.in_boxes = spec_boxes(world, in_spec, in_world)
        into = make_reshape3d(world, in_spec, None, in_shape,
                              in_boxes=plan.in_boxes, out_boxes=chain_in,
                              out_pad=bricks.pad_shape_for(chain_in))
    if out_spec is not None:
        plan.out_boxes = spec_boxes(world, out_spec, out_world)
        outof = make_reshape3d(world, None, out_spec, out_shape,
                               in_boxes=chain_out, out_boxes=plan.out_boxes)
    graph, in_boxes, out_boxes = plan.graph, plan.in_boxes, plan.out_boxes

    def run(x: torch.Tensor, timer) -> torch.Tensor:
        if world.loopback:
            _check_shape(x, in_shape, "plan input shape")
        else:
            _check_shape(x, in_boxes[world.rank].shape,
                         f"rank {world.rank} input box")
        if into is None:
            blocks = scatter(graph, x)
        else:
            with add_trace("reshape3d_in"):
                user = (spec_scatter(x, world, in_spec, in_boxes)
                        if world.loopback else [x])
                blocks = into(user)
        blocks = run_graph(graph, blocks, timer, donate=plan.donate)
        if outof is None:
            return gather(graph, blocks)
        with add_trace("reshape3d_out"):
            user = outof(blocks)
            if world.loopback:
                return spec_gather(user, world, out_spec, out_shape,
                                   out_boxes)
            return user[0]

    plan.runner = run


def _even_fallback_spec(world: World, pref: Spec, shape) -> Spec:
    """``pref`` if it divides ``shape`` evenly over the world, else the
    first layout using every axis of the world that does."""
    if _spec_divides(world, pref, shape):
        return pref
    names = list(world.axis_names)
    cands = []
    if world.grid is None:
        for d in range(3):
            e: list = [None, None, None]
            e[d] = names[0]
            cands.append(Spec(*e))
    else:
        for da, db in itertools.permutations(range(3), 2):
            e = [None, None, None]
            e[da], e[db] = names[0], names[1]
            cands.append(Spec(*e))
        for d in range(3):            # both axes merged onto one dim
            e = [None, None, None]
            e[d] = tuple(names)
            cands.append(Spec(*e))
    for c in cands:
        if _spec_divides(world, c, shape):
            return c
    raise ValueError(
        f"no mesh-expressible layout of {tuple(shape)} divides evenly over "
        f"mesh axes {world.axis_names} of sizes "
        f"{world.grid or (world.size,)}; brick plans need at least one "
        f"even intermediate layout")


# ------------------------------------------------------------ planning

def _plan(shape, world, *, kind: str, direction: int, dtype: torch.dtype,
          device, opts: PlanOptions, in_spec=None, out_spec=None,
          batch=None) -> Plan3D:
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("3D plans require a 3D shape")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError("direction must be FORWARD (-1) or BACKWARD (+1)")
    if dtype not in REAL_DTYPE:
        raise ValueError(
            f"dtype must be torch.complex64 or torch.complex128, got {dtype}")
    if kind == "r2c" and opts.algorithm == "hierarchical":
        raise ValueError(
            "hierarchical transport supports the c2c chains; r2c/c2r "
            "plans run the flat transports")
    device = resolve_device(device)
    forward = direction == FORWARD
    executor = opts.executor
    # r2c/c2r buffers never alias (real world against half spectrum), so
    # donation is accepted and dropped there, as in the JAX package.
    donate = bool(opts.donate) and kind == "c2c"
    # Real chains keep the canonical axes (the real axis stays local):
    # their layouts always take the edge reshape.
    absorb = kind == "c2c"
    lp = logic_plan3d(shape, world, opts, forward=forward,
                      in_spec=in_spec if absorb else None,
                      out_spec=out_spec if absorb else None, batch=batch)
    if (in_spec is not None or out_spec is not None) and lp.world is None:
        raise ValueError("in_spec/out_spec require a mesh")
    if not absorb:
        lp = replace(lp, in_absorbed=in_spec is None,
                     out_absorbed=out_spec is None)
    wire_dtype = lp.wire_dtype
    graph = spec = None
    kw = dict(executor=executor, forward=forward, wire_dtype=wire_dtype,
              algorithm=lp.algorithm, overlap_chunks=lp.overlap_chunks,
              batch=batch)
    if lp.decomposition == "slab":
        if kind == "c2c":
            graph, spec = build_slab_fft3d(
                lp.world, shape, in_axis=lp.slab_axes[0],
                out_axis=lp.slab_axes[1], **kw)
        else:
            graph, spec = build_slab_rfft3d(lp.world, shape, **kw)
    elif lp.decomposition == "pencil":
        if kind == "c2c":
            graph, spec = build_pencil_fft3d(
                lp.world, shape, perm=lp.pencil_perm, order=lp.pencil_order,
                **kw)
        else:
            graph, spec = build_pencil_rfft3d(lp.world, shape, **kw)
    else:
        wire_dtype = None          # no exchange, nothing to compress
    if graph is not None:
        graph.meta["fusion"] = plan_fusion(graph)
    in_boxes, out_boxes = io_boxes(lp, forward=forward, real=kind == "r2c")
    plan = Plan3D(shape=shape, direction=direction, dtype=dtype,
                  decomposition=lp.decomposition, executor=executor,
                  world=lp.world, device=device, kind=kind,
                  wire_dtype=wire_dtype, algorithm=lp.algorithm,
                  overlap_chunks=lp.overlap_chunks,
                  options=replace(opts, decomposition=lp.decomposition,
                                  overlap_chunks=lp.overlap_chunks,
                                  wire_dtype=wire_dtype, donate=donate),
                  graph=graph, spec=spec, in_boxes=in_boxes,
                  out_boxes=out_boxes, batch=batch, in_spec=in_spec,
                  out_spec=out_spec, donate=donate, logic=lp)
    wrap_in = None if lp.in_absorbed else in_spec
    wrap_out = None if lp.out_absorbed else out_spec
    if wrap_in is not None or wrap_out is not None:
        _wrap_user_layout(plan, wrap_in, wrap_out,
                          plan.in_shape, plan.out_shape)
    return plan


def plan_dft_c2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None = None,
    *,
    direction: int = FORWARD,
    executor: str = "cuda",
    dtype: torch.dtype = torch.complex64,
    device=None,
    wire_dtype: str | None = None,
    fuse: bool | None = None,
    decomposition: str | None = None,
    algorithm: str = "alltoall",
    overlap_chunks: int | str | None = None,
    options: PlanOptions | None = None,
    donate: bool = False,
    in_spec: Spec | None = None,
    out_spec: Spec | None = None,
    batch: int | None = None,
    tune: str | None = None,
    max_roundtrip_err: float | None = None,
    mm_precision: str | None = None,
    mm_complex: str | None = None,
) -> Plan3D:
    """Create a 3D complex-to-complex FFT plan over ``world`` (a
    :class:`~.parallel.mesh.World`, an int for a loopback world of that
    many ranks, a ``(rows, cols)`` tuple for a loopback 2D world -- a
    hybrid one under ``algorithm="hierarchical"`` -- or None for one
    device). ``direction`` uses the FFTW sign convention (-1 forward).
    Forward is unnormalized and backward scaled 1/N (numpy convention),
    as the JAX package's executors are; ``execute``'s ``scale``
    multiplies on top of that. ``wire_dtype``, ``fuse``,
    ``decomposition``, ``algorithm``, ``overlap_chunks``, ``options``,
    ``donate``, ``in_spec`` / ``out_spec`` and ``batch`` as in the
    module docstring; a batched plan refuses layouts. ``tune``,
    ``max_roundtrip_err`` and ``executor="auto"``: measured planning (the
    module docstring). ``mm_precision`` (``bf16``, ``f32``, ``highest``)
    and ``mm_complex`` (``gauss``) scope the matmul-family executors'
    tier to this plan (the label becomes ``matmul:bf16``...)."""
    batch = _norm_batch(batch)
    _refuse_batched_layouts(batch, in_spec, out_spec)
    opts = _resolve_options(options, executor, wire_dtype, fuse,
                            decomposition, algorithm, overlap_chunks, donate,
                            tune, max_roundtrip_err, mm_precision, mm_complex)
    if resolve_tune_mode(opts.tune) != "off":
        from . import tuner

        return tuner.tuned_plan(
            "c2c", shape, world, opts,
            dict(direction=direction, dtype=dtype, device=device,
                 in_spec=in_spec, out_spec=out_spec, batch=batch))
    if opts.executor == "auto":
        return _auto_plan(
            functools.partial(plan_dft_c2c_3d, shape, world), opts, world,
            direction=direction, dtype=dtype, device=device,
            in_spec=in_spec, out_spec=out_spec, batch=batch)
    return _plan(shape, world, kind="c2c", direction=direction, dtype=dtype,
                 device=device, opts=opts, in_spec=in_spec,
                 out_spec=out_spec, batch=batch)


def plan_dft_r2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None = None,
    *,
    direction: int = FORWARD,
    executor: str = "cuda",
    dtype: torch.dtype = torch.complex64,
    device=None,
    wire_dtype: str | None = None,
    fuse: bool | None = None,
    decomposition: str | None = None,
    algorithm: str = "alltoall",
    overlap_chunks: int | str | None = None,
    options: PlanOptions | None = None,
    donate: bool = False,
    in_spec: Spec | None = None,
    out_spec: Spec | None = None,
    r2c_axis: int = 2,
    batch: int | None = None,
    tune: str | None = None,
    max_roundtrip_err: float | None = None,
    mm_precision: str | None = None,
    mm_complex: str | None = None,
) -> Plan3D:
    """Create a real-to-complex (forward) / complex-to-real (backward) 3D
    FFT plan. ``shape`` is the real-space world; the complex side is
    shrunk along ``r2c_axis`` (heFFTe's ``r2c_direction``, default 2) to
    n//2+1. Forward takes the real dtype of ``dtype`` (float32 or
    float64) and returns ``dtype``; backward the mirror, scaled 1/N. The
    flat transports only: ``hierarchical`` raises, as in the JAX package.
    ``r2c_axis`` 0 or 1 runs the canonical chain on a view with that axis
    and axis 2 swapped; a batched plan takes ``r2c_axis=2`` and no
    layouts. ``donate`` is accepted and has no effect (the real and
    half-spectrum buffers never alias). ``tune``, ``max_roundtrip_err``,
    ``executor="auto"`` and the matmul tiers as in
    :func:`plan_dft_c2c_3d`."""
    batch = _norm_batch(batch)
    if r2c_axis != 2:
        if batch is not None:
            raise ValueError(
                "batched r2c plans run the canonical r2c_axis=2 chain; "
                "transpose the batch's world instead of passing r2c_axis")
        return _r2c_axis_wrapped(
            shape, world, r2c_axis, direction=direction, executor=executor,
            dtype=dtype, device=device, wire_dtype=wire_dtype, fuse=fuse,
            decomposition=decomposition, algorithm=algorithm,
            overlap_chunks=overlap_chunks, options=options, donate=donate,
            in_spec=in_spec, out_spec=out_spec, tune=tune,
            max_roundtrip_err=max_roundtrip_err, mm_precision=mm_precision,
            mm_complex=mm_complex)
    _refuse_batched_layouts(batch, in_spec, out_spec)
    opts = _resolve_options(options, executor, wire_dtype, fuse,
                            decomposition, algorithm, overlap_chunks, donate,
                            tune, max_roundtrip_err, mm_precision, mm_complex)
    if resolve_tune_mode(opts.tune) != "off":
        from . import tuner

        return tuner.tuned_plan(
            "r2c", shape, world, opts,
            dict(direction=direction, dtype=dtype, device=device,
                 in_spec=in_spec, out_spec=out_spec, batch=batch))
    if opts.executor == "auto":
        return _auto_plan(
            functools.partial(plan_dft_r2c_3d, shape, world),
            replace(opts, donate=False), world, direction=direction,
            dtype=dtype, device=device, in_spec=in_spec, out_spec=out_spec,
            batch=batch)
    return _plan(shape, world, kind="r2c", direction=direction, dtype=dtype,
                 device=device, opts=opts, in_spec=in_spec,
                 out_spec=out_spec, batch=batch)


def plan_dft_c2r_3d(shape, world=None, **kw) -> Plan3D:
    """The inverse of :func:`plan_dft_r2c_3d` (complex half-spectrum in,
    real out)."""
    kw.setdefault("direction", BACKWARD)
    return plan_dft_r2c_3d(shape, world, **kw)


# ---------------------------------------------------------- r2c_axis

def _swap_perm(axis: int) -> tuple[int, int, int]:
    """The self-inverse permutation swapping ``axis`` with 2."""
    perm = [0, 1, 2]
    perm[axis], perm[2] = perm[2], perm[axis]
    return tuple(perm)


def _permute_spec(spec, perm):
    if spec is None:
        return None
    ent = tuple(spec) + (None,) * (3 - len(tuple(spec)))
    return Spec(*(ent[p] for p in perm))


def _r2c_axis_wrapped(shape, world, axis: int, *, in_spec, out_spec,
                      **kw) -> Plan3D:
    """r2c/c2r with the halved axis 0 or 1 (heFFTe ``r2c_direction``):
    the canonical chain (real axis 2) on the view with ``axis`` and 2
    swapped. Shapes, boxes and layouts are permuted back to the caller's
    axes; ``spec``, ``logic`` and ``graph`` stay in the chain's. The
    swap is its own inverse."""
    if axis not in (0, 1):
        raise ValueError(f"r2c_axis must be 0, 1, or 2; got {axis}")
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("3D plans require a 3D shape")
    perm = _swap_perm(axis)
    try:
        inner = plan_dft_r2c_3d(
            tuple(shape[p] for p in perm), world,
            in_spec=_permute_spec(in_spec, perm),
            out_spec=_permute_spec(out_spec, perm), **kw)
    except ValueError as e:
        raise ValueError(
            f"{e} [note: r2c_axis={axis} plans run on a transposed view -- "
            f"specs and extents in this message are in the chain "
            f"convention (axes {axis} and 2 swapped)]") from e

    def permute_boxes(boxes):
        return [geo.Box3(tuple(b.low[p] for p in perm),
                         tuple(b.high[p] for p in perm)) for b in boxes]

    def run(x: torch.Tensor, timer) -> torch.Tensor:
        y = execute(inner, x.permute(perm).contiguous(), timer=timer)
        return y.permute(perm).contiguous()

    return replace(
        inner, shape=shape, r2c_axis=axis,
        in_boxes=permute_boxes(inner.in_boxes),
        out_boxes=permute_boxes(inner.out_boxes),
        in_shape=tuple(inner.in_shape[p] for p in perm),
        out_shape=tuple(inner.out_shape[p] for p in perm),
        in_spec=in_spec, out_spec=out_spec, runner=run)


# -------------------------------------------------- executor="auto"

#: Executors the ``executor="auto"`` tournament plans and times (the JAX
#: package's ``xla``, ``xla_minor``, ``pallas``, ``matmul``);
#: ``DFFT_AUTO_EXECUTORS`` (comma-separated) overrides.
_AUTO_CANDIDATES = ("torch", "torch_minor", "cuda", "matmul")


def _autotune(make_plan: Callable[[str], Plan3D],
              group="local") -> Plan3D:
    """Plan every candidate executor, time each, keep the fastest: the
    reference's plan-and-pick (``setFFTPlans`` builds hipfft, rocfft and
    templateFFT plans side by side, ``fft_mpi_3d_api.cpp:318-429``). A
    candidate that fails to plan or run is skipped. Each is timed on a
    zero-filled input (an FFT's cost does not depend on the data),
    ``DFFT_TUNE_ITERS`` calls a batch, by
    :func:`.tuner.measured_select` over ``group`` (the processes of a
    process-group world decide together; ``"local"``: this process)."""
    from .tuner import _amortized_measure, measured_select, tune_budget

    names = [e.strip() for e in os.environ.get(
        "DFFT_AUTO_EXECUTORS", ",".join(_AUTO_CANDIDATES)).split(",")
        if e.strip() and e.strip() != "auto"]
    best, plans, _ = measured_select(
        names, make_plan, _amortized_measure(*tune_budget()),
        what="auto executor candidate", group=group)
    return plans[best]


def _auto_plan(plan_fn: Callable, opts: PlanOptions, world=None,
               **kw) -> Plan3D:
    """``executor="auto"`` for every plan family (``plan_fn`` bound to
    the shape and ``world``): the tournament without donation (a donated
    input cannot be timed twice), then the winner rebuilt with the
    caller's ``donate``."""
    from .tuner import _mesh_group

    def mk(ex: str, don: bool) -> Plan3D:
        return plan_fn(options=replace(opts, executor=ex, donate=don), **kw)

    best = _autotune(lambda ex: mk(ex, False), _mesh_group(world))
    return mk(best.executor, opts.donate) if opts.donate else best


def explain(plan: Plan3D, **kw) -> dict:
    """The plan's attribution record: per t0..t3 stage the model, the
    memory view and the measured samples with MFU, link utilisation and
    divergence flags, the whole plan's memory view (:mod:`.explain`).
    ``iters`` sets the measured passes, ``measure=False`` runs nothing,
    ``device_timing=True`` reads the stages from the card's
    ``torch.profiler`` timeline (host brackets where there is none),
    ``allgather=True`` merges every process's stage medians (collective).
    Render with :func:`.explain.format_explain`."""
    from .explain import explain as _explain_impl

    return _explain_impl(plan, **kw)


def alloc_local(plan, fill=None) -> torch.Tensor:
    """The input a plan's ``execute`` takes on this process, on its
    device: zeros, or a copy of ``fill`` (``fft_mpi_alloc_local_memory``,
    ``fft_mpi_3d_api.h:73``). A loopback world's is the global array
    (``plan.in_shape``), a process-group world's this rank's box (a
    batched plan's with the batch axis first)."""
    world = plan.world
    if world is None or world.loopback or plan.brick_edges is not None:
        shape = tuple(plan.in_shape)
    else:
        bpfx = () if plan.batch is None else (plan.batch,)
        shape = bpfx + tuple(plan.in_boxes[world.rank].shape)
    if fill is None:
        return torch.zeros(shape, dtype=plan.in_dtype, device=plan.device)
    x = torch.as_tensor(fill).to(device=plan.device, dtype=plan.in_dtype,
                                 copy=True)
    if tuple(x.shape) != shape:
        raise ValueError(f"fill has shape {tuple(x.shape)}; the plan's "
                         f"input is {shape}")
    return x


# ----------------------------------------------------------- brick plans

def plan_brick_dft_c2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None,
    in_boxes: Sequence[geo.Box3],
    out_boxes: Sequence[geo.Box3],
    *,
    direction: int = FORWARD,
    decomposition: str | None = None,
    executor: str = "cuda",
    dtype: torch.dtype = torch.complex64,
    device=None,
    donate: bool = False,
    algorithm: str = "alltoall",
    options: PlanOptions | None = None,
) -> Plan3D:
    """A 3D C2C plan with any per-rank input and output boxes (heFFTe's
    ``fft3d(inbox, outbox, comm)``, ``heffte_fft3d.h:105-115``): one
    :class:`~.geometry.Box3` per rank, rank order, each tiling list any
    decomposition of the world (uneven, non-grid, axis-swapped), each box
    with its buffer's storage ``order``. The plan brackets the canonical
    chain with the overlap-map edges of :mod:`.parallel.bricks`: the
    ``ring`` transport, or with ``algorithm="alltoallv"`` the exact
    ``a2av`` one (the chain takes the same transport). I/O: the brick
    stack ``[P, *pad]`` of :func:`~.parallel.bricks.scatter_bricks` on a
    loopback world (``plan.in_shape`` / ``out_shape``), a rank's own
    brick on a process group."""
    inner = plan_dft_c2c_3d(
        shape, world, direction=direction, decomposition=decomposition,
        executor=executor, dtype=dtype, device=device, donate=donate,
        algorithm=algorithm, options=options)
    return _wrap_brick_io(inner, in_boxes, out_boxes)


def plan_brick_dft_r2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None,
    in_boxes: Sequence[geo.Box3],
    out_boxes: Sequence[geo.Box3],
    *,
    direction: int = FORWARD,
    r2c_axis: int = 2,
    decomposition: str | None = None,
    executor: str = "cuda",
    dtype: torch.dtype = torch.complex64,
    device=None,
    donate: bool = False,
    algorithm: str = "alltoall",
    options: PlanOptions | None = None,
) -> Plan3D:
    """Real<->complex 3D plan with any per-rank boxes (heFFTe's
    ``fft3d_r2c`` brick tier): forward, ``in_boxes`` tile the real world
    and ``out_boxes`` the world shrunk to n//2+1 along ``r2c_axis``;
    backward the roles swap. I/O as in :func:`plan_brick_dft_c2c_3d`.
    ``r2c_axis`` 0 or 1 runs the canonical chain on the world with that
    axis and axis 2 swapped: each brick is the same buffer there, its box
    permuted and its storage order composed with the swap, so the edges
    transpose nothing more."""
    if r2c_axis not in (0, 1, 2):
        raise ValueError(f"r2c_axis must be 0, 1, or 2; got {r2c_axis}")
    perm = _swap_perm(r2c_axis)
    shape = tuple(int(s) for s in shape)
    inner = plan_dft_r2c_3d(
        tuple(shape[p] for p in perm), world, direction=direction,
        decomposition=decomposition, executor=executor, dtype=dtype,
        device=device, donate=donate, algorithm=algorithm, options=options)
    if r2c_axis == 2:
        return _wrap_brick_io(inner, in_boxes, out_boxes)

    def swapped(b: geo.Box3) -> geo.Box3:
        # stored = caller.permute(order) = chain.permute(perm).permute(order)
        return geo.Box3(tuple(b.low[p] for p in perm),
                        tuple(b.high[p] for p in perm),
                        tuple(perm[o] for o in b.order))

    plan = _wrap_brick_io(inner, [swapped(b) for b in in_boxes],
                          [swapped(b) for b in out_boxes])
    edges = None if plan.brick_edges is None else tuple(
        _swapped_spec(bs, perm) for bs in plan.brick_edges)
    return replace(plan, shape=shape, r2c_axis=r2c_axis,
                   in_boxes=list(in_boxes), out_boxes=list(out_boxes),
                   brick_edges=edges)


def _swapped_spec(bs, perm) -> "bricks.BrickSpec":
    """A brick edge's accounting in the caller's axes: the same moves,
    boxes and pads permuted back (the edges run in the chain's)."""
    pb = lambda boxes: [geo.Box3(tuple(b.low[p] for p in perm),
                                 tuple(b.high[p] for p in perm))
                        for b in boxes]
    pp = lambda pad: tuple(pad[p] for p in perm)
    return bricks.compile_move(None, pb(bs.in_boxes), pb(bs.out_boxes),
                               bs.algorithm, in_pad=pp(bs.in_pad),
                               out_pad=pp(bs.out_pad)).spec


def plan_brick_dft_c2r_3d(shape, world, in_boxes, out_boxes,
                          **kw) -> Plan3D:
    """The inverse of :func:`plan_brick_dft_r2c_3d`."""
    kw.setdefault("direction", BACKWARD)
    return plan_brick_dft_r2c_3d(shape, world, in_boxes, out_boxes, **kw)


def _check_brick_algorithm(algorithm: str) -> None:
    if algorithm not in ("alltoall", "alltoallv", "ppermute"):
        raise ValueError(
            f"unknown algorithm {algorithm!r} for a brick plan; "
            f"expected alltoall|alltoallv|ppermute")


def _check_world_coverage(in_boxes, out_boxes, in_world, out_world) -> None:
    """Both box lists must span their side's world."""
    for label, boxes, want in (("in_boxes", in_boxes, in_world),
                               ("out_boxes", out_boxes, out_world)):
        got = geo.find_world(boxes).shape
        if got != tuple(want):
            raise ValueError(
                f"{label} cover a {got} world; this plan's side is "
                f"{tuple(want)}")


def _stack_alloc(world: World, boxes, dtype: torch.dtype) -> Callable:
    """The output bricks of a brick plan: on a loopback world one stack
    ``[*lead, P, *stack_pad]`` (zeros, unless every brick fills the pad)
    and its bricks as views; on a process group this rank's brick, at
    its storage shape."""
    spad = bricks.stack_pad_for(boxes)

    def alloc(like: torch.Tensor, lead: tuple):
        if world is None or world.loopback:
            full = all(b.storage_shape == spad for b in boxes)
            make = torch.empty if full else torch.zeros
            stack = make(lead + (len(boxes),) + spad, dtype=dtype,
                         device=like.device)
            return stack, list(stack.unbind(len(lead)))
        out = torch.empty(lead + boxes[world.rank].storage_shape,
                          dtype=dtype, device=like.device)
        return out, [out]

    return alloc


def _held_bricks(plan: Plan3D, x: torch.Tensor) -> list:
    """A brick plan's input as held bricks, its shape checked."""
    world = plan.world
    if world is None or world.loopback:
        _check_shape(x, plan.in_shape, "brick plan input stack")
        return list(x.unbind(0))
    _check_shape(x, plan.in_boxes[world.rank].storage_shape,
                 f"rank {world.rank} input brick")
    return [x]


def _order_views(world: World | None, boxes) -> Callable | None:
    """Canonical views of held bricks stored in their boxes' orders (the
    port of ``reorder_stack``, copying nothing); None when no box
    declares an order."""
    if not bricks.has_orders(boxes):
        return None
    ranks = (0,) if world is None else world.ranks
    return lambda held: bricks.canonical_views(held, boxes, ranks)


def _build_brick_edges(inner: Plan3D, in_boxes, out_boxes):
    """The brick plan's edges: the nearest *even* layout to each chain
    endpoint (:func:`_even_fallback_spec`), the overlap-map moves between
    the user bricks and those layouts (``ring``, or ``a2av`` under
    ``algorithm="alltoallv"``), and where an endpoint is itself uneven a
    second move between the even layout and the chain's ceil-split
    blocks. Returns the :class:`BrickEdgeGraph`'s pieces and the (in,
    out) :class:`~.parallel.bricks.BrickSpec` pair."""
    world = inner.world
    _check_brick_algorithm(inner.algorithm)
    _check_world_coverage(in_boxes, out_boxes, inner.in_shape,
                          inner.out_shape)
    chain_in, chain_out = _chain_specs(inner)
    in_world = geo.world_box(inner.in_shape)
    out_world = geo.world_box(inner.out_shape)
    in_target = _even_fallback_spec(world, chain_in, inner.in_shape)
    out_target = _even_fallback_spec(world, chain_out, inner.out_shape)
    alg = "a2av" if inner.algorithm == "alltoallv" else "ring"
    for label, boxes, w in (("input", in_boxes, in_world),
                            ("output", out_boxes, out_world)):
        bricks._validate(boxes, w, label)
        if len(boxes) != world.size:
            raise ValueError(f"need {world.size} {label} bricks, got "
                             f"{len(boxes)}")
    in_t, in_shard = bricks.even_spec_boxes(world, in_target, in_world,
                                            "target")
    out_t, out_shard = bricks.even_spec_boxes(world, out_target, out_world,
                                              "source")
    chain_in_pad = bricks.pad_shape_for(inner.in_boxes)
    to_target = bricks.compile_move(world, in_boxes, in_t, alg,
                                    out_pad=in_shard)
    from_target = bricks.compile_move(world, out_t, out_boxes, alg,
                                      in_pad=out_shard)
    # An uneven chain endpoint: one more (exact) move between the even
    # layout and the chain's own blocks.
    in_fix = (None if in_target == chain_in else bricks.compile_move(
        world, in_t, inner.in_boxes, "a2av", out_pad=chain_in_pad))
    out_fix = (None if out_target == chain_out else bricks.compile_move(
        world, inner.out_boxes, out_t, "a2av", out_pad=out_shard))

    def reshape_in(views: list) -> list:
        lead = tuple(views[0].shape[:-3])
        blocks = to_target.run(views, bricks.new_blocks(
            world, in_t, in_shard, lead, views[0]))
        if in_fix is not None:
            blocks = in_fix.run(blocks, bricks.new_blocks(
                world, inner.in_boxes, chain_in_pad, lead, views[0]))
        return blocks

    def reshape_out(blocks: list, dst: list) -> list:
        if out_fix is not None:
            blocks = out_fix.run(blocks, bricks.new_blocks(
                world, out_t, out_shard, tuple(blocks[0].shape[:-3]),
                blocks[0]))
        return from_target.run(blocks, dst)

    return reshape_in, reshape_out, (to_target.spec, from_target.spec)


def _chain_inner(inner: Plan3D) -> Callable:
    """``fn(blocks, timer)``: a chain plan's graph over held blocks, or a
    single-device plan's executor over its one block."""
    if inner.graph is not None:
        return lambda blocks, timer: run_graph(inner.graph, blocks, timer,
                                               donate=inner.donate)

    def single(blocks, timer):
        (x,) = blocks
        if timer is not None:
            with timer.stage("t0"):
                return [_execute_single(inner, x)]
        return [_execute_single(inner, x)]

    return single


def _wrap_brick_io(inner: Plan3D, in_boxes: Sequence[geo.Box3],
                   out_boxes: Sequence[geo.Box3]) -> Plan3D:
    """Bracket a canonical-chain plan with the brick edges (shared by the
    C2C and real brick planners), declared as a
    :class:`~.stagegraph.BrickEdgeGraph` and composed by
    :func:`~.stagegraph.compile_brick_io`. A single-device inner plan
    takes one box per side: its edges are the storage-order views."""
    in_boxes, out_boxes = list(in_boxes), list(out_boxes)
    world = inner.world
    if world is None:
        for label, boxes in (("in_boxes", in_boxes),
                             ("out_boxes", out_boxes)):
            if len(boxes) != 1:
                raise ValueError(
                    f"single-device brick plans take exactly one box per "
                    f"side; {label} has {len(boxes)}")
        _check_world_coverage(in_boxes, out_boxes, inner.in_shape,
                              inner.out_shape)
        edges = BrickEdgeGraph(
            edge_in=(_order_views(None, in_boxes),
                     lambda views: [views[0].contiguous()]),
            edge_out=(lambda y, dst: dst[0].copy_(y[0]),
                      _order_views(None, out_boxes)),
            alloc=_stack_alloc(None, out_boxes, inner.out_dtype))
        specs = None
    else:
        reshape_in, reshape_out, specs = _build_brick_edges(
            inner, in_boxes, out_boxes)
        edges = BrickEdgeGraph(
            edge_in=(_order_views(world, in_boxes), reshape_in),
            edge_out=(reshape_out, _order_views(world, out_boxes)),
            alloc=_stack_alloc(world, out_boxes, inner.out_dtype),
            specs=specs)
    fn = compile_brick_io(edges, _chain_inner(inner))
    nb = 1 if world is None else world.size

    def run(x: torch.Tensor, timer) -> torch.Tensor:
        return fn(_held_bricks(plan, x), timer)

    plan = replace(inner, in_boxes=in_boxes, out_boxes=out_boxes,
                   in_shape=(nb,) + bricks.stack_pad_for(in_boxes),
                   out_shape=(nb,) + bricks.stack_pad_for(out_boxes),
                   brick_edges=specs, runner=run)
    return plan


# ---------------------------------------------------------- the dd tier

@dataclass
class DDPlan3D:
    """A 3D FFT plan at the emulated-double (dd) tier (the port of the
    JAX package's ``DDPlan3D``): its I/O is a (hi, lo) pair, complex64
    (float32 on the real side of an r2c/c2r plan), ~49 significand bits
    (:mod:`.ops.ddfft`). ``fn(hi, lo, timer=None)`` joins the pair into
    complex128, runs the port's complex128 chain on ``torch.fft`` (the
    internal ``_dd`` executor) and splits the result. ``kind`` is ``"c2c"`` or
    ``"r2c"``; ``graph`` the complex128 chain (None on one device).
    ``world``, ``spec``, the boxes and shapes are those of a
    :class:`Plan3D` of the same chain; a brick plan's in/out shapes are
    its stacks'. Host conversion: :func:`.ops.ddfft.dd_from_host` /
    :func:`.ops.ddfft.dd_to_host`."""

    shape: tuple[int, int, int]
    direction: int
    decomposition: str            # "single" | "slab" | "pencil" | "bricks-*"
    world: World | None
    fn: Callable
    device: torch.device
    kind: str = "c2c"
    graph: StageGraph | None = None
    spec: SlabSpec | PencilSpec | None = None
    in_boxes: list[geo.Box3] = field(default_factory=list)
    out_boxes: list[geo.Box3] = field(default_factory=list)
    in_shape: tuple | None = None
    out_shape: tuple | None = None
    batch: int | None = None
    r2c_axis: int = 2
    donate: bool = False
    algorithm: str = "alltoall"
    overlap_chunks: int = 1
    brick_edges: tuple | None = None

    @property
    def forward(self) -> bool:
        return self.direction == FORWARD

    @property
    def in_dtype(self) -> torch.dtype:
        return (torch.float32 if self.kind == "r2c" and self.forward
                else torch.complex64)

    @property
    def out_dtype(self) -> torch.dtype:
        return (torch.float32 if self.kind == "r2c" and not self.forward
                else torch.complex64)

    def __call__(self, hi: torch.Tensor, lo: torch.Tensor, *,
                 scale: Scale = Scale.NONE, timer=None):
        if _metrics._enabled:
            _metrics.inc("executes", kind="dd",
                         decomposition=self.decomposition, executor="dd")
        with add_trace(f"execute_dd_{self.decomposition}"):
            _check_pair(self, hi, lo)
            yh, yl = self.fn(hi, lo, timer)
            if scale != Scale.NONE:
                from .ops.ddfft import dd_scale

                yh, yl = dd_scale(yh, yl, scale_factor(
                    scale, math.prod(self.shape)))
        return yh, yl


def _check_pair(plan: DDPlan3D, hi, lo) -> None:
    for t in (hi, lo):
        _check_input(plan, t)
    if hi.shape != lo.shape:
        raise ValueError(f"hi and lo differ in shape: {tuple(hi.shape)} "
                         f"and {tuple(lo.shape)}")
    world = plan.world
    if plan.decomposition.startswith("bricks-"):
        return                     # the brick edges check their stacks
    if world is None or world.loopback:
        _check_shape(hi, plan.in_shape, "plan input shape")
    else:
        bpfx = () if plan.batch is None else (plan.batch,)
        _check_shape(hi, bpfx + plan.in_boxes[world.rank].shape,
                     f"rank {world.rank} input box")


def _dd_shape(shape, direction) -> tuple[tuple[int, int, int], bool]:
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("3D plans require a 3D shape")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError("direction must be FORWARD (-1) or BACKWARD (+1)")
    return shape, direction == FORWARD


def _dd_world(world) -> World | None:
    """The world of a dd plan: None (one device), an int (a loopback 1D
    world of that many ranks, even 1), a ``(rows, cols)`` tuple (a
    loopback 2D world) or a :class:`World`."""
    if world is None or isinstance(world, World):
        return world
    try:
        return make_world(world if isinstance(world, int) else tuple(world))
    except (TypeError, ValueError):
        raise ValueError("dd plans support single-device, 1D, or 2D "
                         "meshes") from None


def _dd_single(shape, *, kind: str, forward: bool, batch, donate: bool):
    """One device: ``fn(hi, lo, timer=None)`` joining the pair, the
    complex128 transform over the trailing three axes (the real axis 2
    first forward, last backward on an r2c plan) and the split;
    ``fn.wide`` is that transform alone."""
    from .ops import ddfft

    for n in shape:
        ddfft._check_length(n)
    bo = 0 if batch is None else 1
    axes = (bo, 1 + bo, 2 + bo)
    name = ddfft.PLAN_EXECUTOR
    ex, r2c, c2r = get_executor(name), get_r2c(name), get_c2r(name)
    if kind == "c2c":
        def wide(y):
            return ex(y, axes, forward)
    elif forward:
        def wide(y):
            return ex(r2c(y, axes[2]), axes[:2], True)
    else:
        def wide(y):
            return c2r(ex(y, axes[:2], False), shape[2], axes[2])

    def fn(hi, lo, timer=None):
        with _stage(timer, "t0"):
            return ddfft.split(wide(ddfft.join(hi, lo)),
                               out=(hi, lo) if donate else None)

    fn.wide = wide
    return fn


def _stage(timer, kind: str):
    return contextlib.nullcontext() if timer is None else timer.stage(kind)


def _dd_plan(shape, world, *, kind: str, direction: int, device, donate,
             overlap_chunks, batch) -> DDPlan3D:
    """The dd plan over the world as the JAX planners read it: one
    device, a 1D world's slab chain, a 2D world's pencil chain."""
    from .parallel import ddslab
    from .plan_logic import resolve_overlap_chunks

    shape, forward = _dd_shape(shape, direction)
    batch = _norm_batch(batch)
    world = _dd_world(world)
    device = resolve_device(device)
    real = kind == "r2c"
    donate = bool(donate) and not real
    common = dict(shape=shape, direction=direction, device=device,
                  kind=kind, batch=batch, donate=donate,
                  **_dd_io_shapes(shape, kind, forward, batch))
    if world is None:
        lp = LogicPlan(shape, "single", None, batch=batch)
        ins, outs = io_boxes(lp, forward=forward, real=real)
        return DDPlan3D(decomposition="single", world=None,
                        fn=_dd_single(shape, kind=kind, forward=forward,
                                      batch=batch, donate=donate),
                        in_boxes=ins, out_boxes=outs, **common)
    overlap = resolve_overlap_chunks(overlap_chunks, shape=shape,
                                     ndev=world.size,
                                     itemsize=8 * (batch or 1))
    kw = dict(forward=forward, overlap_chunks=overlap, batch=batch)
    if kind == "c2c":
        kw["donate"] = donate
    if world.grid is None:
        build = (ddslab.build_dd_slab_fft3d if kind == "c2c"
                 else ddslab.build_dd_slab_rfft3d)
        fn, spec = build(world, shape, **kw)
        lp = LogicPlan(shape, "slab", world,
                       slab_axes=(spec.in_axis, spec.out_axis), batch=batch)
    else:
        build = (ddslab.build_dd_pencil_fft3d if kind == "c2c"
                 else ddslab.build_dd_pencil_rfft3d)
        fn, spec = build(world, shape, **kw)
        lp = LogicPlan(shape, "pencil", world, pencil_perm=spec.perm,
                       pencil_order=spec.order, batch=batch)
    ins, outs = io_boxes(lp, forward=forward, real=real)
    return DDPlan3D(decomposition=lp.decomposition, world=world, fn=fn,
                    graph=fn.stage_graph, spec=spec, in_boxes=ins,
                    out_boxes=outs, overlap_chunks=overlap, **common)


def _dd_io_shapes(shape, kind: str, forward: bool, batch) -> dict:
    bpfx = () if batch is None else (batch,)
    half = shape[:2] + (shape[2] // 2 + 1,) if kind == "r2c" else shape
    ins, outs = (shape, half) if forward else (half, shape)
    return dict(in_shape=bpfx + ins, out_shape=bpfx + outs)


def plan_dd_dft_c2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None = None,
    *,
    direction: int = FORWARD,
    donate: bool = False,
    overlap_chunks: int | str | None = None,
    batch: int | None = None,
    device=None,
) -> DDPlan3D:
    """A 3D C2C plan at the emulated-double tier: one device
    (``world=None``), the slab chain over a 1D world (an int is a
    loopback world of that many ranks), the pencil chain over a 2D world
    (a ``(rows, cols)`` tuple or a 2D :class:`World`). Forward
    unnormalized, backward scaled 1/N. ``overlap_chunks`` and ``batch``
    as in :func:`plan_dft_c2c_3d` (both components carry the batch
    axis); ``donate=True`` writes the result into the input pair where
    it has the input's shape."""
    return _dd_plan(shape, world, kind="c2c", direction=direction,
                    device=device, donate=donate,
                    overlap_chunks=overlap_chunks, batch=batch)


def plan_dd_dft_r2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None = None,
    *,
    direction: int = FORWARD,
    r2c_axis: int = 2,
    donate: bool = False,
    overlap_chunks: int | str | None = None,
    batch: int | None = None,
    device=None,
) -> DDPlan3D:
    """A real<->complex 3D plan at the dd tier: ``shape`` is the real
    world; forward takes real float32 pairs and returns the half-spectrum
    complex64 pairs (``r2c_axis`` shrunk to n//2+1), backward inverts,
    scaled 1/N. ``r2c_axis`` 0 or 1 runs the canonical chain on the view
    with that axis and axis 2 swapped (not batched). ``donate`` is
    accepted and has no effect (the real and half-spectrum buffers never
    alias)."""
    batch = _norm_batch(batch)
    if r2c_axis != 2:
        if batch is not None:
            raise ValueError(
                "batched dd r2c plans run the canonical r2c_axis=2 chain; "
                "transpose the batch's world instead of passing r2c_axis")
        return _dd_r2c_axis_wrapped(shape, world, r2c_axis,
                                    direction=direction,
                                    overlap_chunks=overlap_chunks,
                                    device=device)
    del donate
    return _dd_plan(shape, world, kind="r2c", direction=direction,
                    device=device, donate=False,
                    overlap_chunks=overlap_chunks, batch=batch)


def plan_dd_dft_c2r_3d(shape, world=None, **kw) -> DDPlan3D:
    """The inverse of :func:`plan_dd_dft_r2c_3d`."""
    kw.setdefault("direction", BACKWARD)
    return plan_dd_dft_r2c_3d(shape, world, **kw)


def _dd_r2c_axis_wrapped(shape, world, axis: int, *, direction,
                         overlap_chunks=None, device=None) -> DDPlan3D:
    """dd r2c/c2r with the halved axis 0 or 1: the canonical chain on the
    view of both components with ``axis`` and 2 swapped; shapes and
    boxes permuted back to the caller's axes."""
    if axis not in (0, 1):
        raise ValueError(f"r2c_axis must be 0, 1, or 2; got {axis}")
    shape, _ = _dd_shape(shape, direction)
    perm = _swap_perm(axis)
    try:
        inner = plan_dd_dft_r2c_3d(tuple(shape[p] for p in perm), world,
                                   direction=direction,
                                   overlap_chunks=overlap_chunks,
                                   device=device)
    except ValueError as e:
        raise ValueError(
            f"{e} [note: r2c_axis={axis} plans run on a transposed view -- "
            f"extents in this message are in the chain convention (axes "
            f"{axis} and 2 swapped)]") from e
    inner_fn = inner.fn

    def fn(hi, lo, timer=None):
        yh, yl = inner_fn(hi.permute(perm).contiguous(),
                          lo.permute(perm).contiguous(), timer)
        return yh.permute(perm).contiguous(), yl.permute(perm).contiguous()

    def permute_boxes(boxes):
        return [geo.Box3(tuple(b.low[p] for p in perm),
                         tuple(b.high[p] for p in perm)) for b in boxes]

    return replace(inner, shape=shape, r2c_axis=axis, fn=fn,
                   in_boxes=permute_boxes(inner.in_boxes),
                   out_boxes=permute_boxes(inner.out_boxes),
                   in_shape=tuple(inner.in_shape[p] for p in perm),
                   out_shape=tuple(inner.out_shape[p] for p in perm))


def plan_dd_brick_dft_c2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None,
    in_boxes: Sequence[geo.Box3],
    out_boxes: Sequence[geo.Box3],
    *,
    direction: int = FORWARD,
    algorithm: str = "alltoall",
    donate: bool = False,
    device=None,
) -> DDPlan3D:
    """Any per-rank boxes at the dd tier (heFFTe's arbitrary-box double
    capability): the joined complex128 stack travels the brick edges of
    :func:`plan_brick_dft_c2c_3d` (``ring``, or ``a2av`` under
    ``algorithm="alltoallv"``) around the dd chain, ``Box3.order``
    honoured on both sides. I/O is a pair of ``[P, *pad]`` stacks
    (:func:`~.parallel.bricks.scatter_bricks` of each component) on a
    loopback world, a rank's own pair of bricks on a process group."""
    shape, _ = _dd_shape(shape, direction)
    inner = plan_dd_dft_c2c_3d(shape, world, direction=direction,
                               device=device)
    return _dd_brick_wrap(inner, in_boxes, out_boxes, algorithm, donate)


def plan_dd_brick_dft_r2c_3d(
    shape: Sequence[int],
    world: World | int | Sequence[int] | None,
    in_boxes: Sequence[geo.Box3],
    out_boxes: Sequence[geo.Box3],
    *,
    direction: int = FORWARD,
    algorithm: str = "alltoall",
    donate: bool = False,
    device=None,
) -> DDPlan3D:
    """The real<->complex brick plan at the dd tier: forward, ``in_boxes``
    tile the real world (float32 pairs) and ``out_boxes`` the world
    halved along axis 2; backward the roles swap. Canonical
    ``r2c_axis=2`` only; ``donate`` has no effect."""
    del donate
    shape, _ = _dd_shape(shape, direction)
    inner = plan_dd_dft_r2c_3d(shape, world, direction=direction,
                               device=device)
    return _dd_brick_wrap(inner, in_boxes, out_boxes, algorithm, False)


def plan_dd_brick_dft_c2r_3d(shape, world, in_boxes, out_boxes,
                             **kw) -> DDPlan3D:
    """The inverse of :func:`plan_dd_brick_dft_r2c_3d`."""
    kw.setdefault("direction", BACKWARD)
    return plan_dd_brick_dft_r2c_3d(shape, world, in_boxes, out_boxes, **kw)


def _dd_brick_wrap(inner: DDPlan3D, in_boxes, out_boxes, algorithm: str,
                   donate: bool) -> DDPlan3D:
    """Bracket a dd plan with the brick edges of :func:`_wrap_brick_io`:
    the caller's pair of stacks is joined into one complex128 stack, the
    edges and the chain run on it, and the output stack is split."""
    from .ops import ddfft

    in_boxes, out_boxes = list(in_boxes), list(out_boxes)
    world = inner.world
    _check_brick_algorithm(algorithm)
    wide_out = ddfft._WIDE[inner.out_dtype]
    if world is None:
        for label, boxes in (("in_boxes", in_boxes),
                             ("out_boxes", out_boxes)):
            if len(boxes) != 1:
                raise ValueError(
                    f"single-device brick plans take exactly one box per "
                    f"side; {label} has {len(boxes)}")
        _check_world_coverage(in_boxes, out_boxes, inner.in_shape,
                              inner.out_shape)
        wide = inner.fn.wide

        def chain(blocks, timer):
            with _stage(timer, "t0"):
                return [wide(blocks[0])]

        edges = BrickEdgeGraph(
            edge_in=(_order_views(None, in_boxes),
                     lambda views: [views[0].contiguous()]),
            edge_out=(lambda y, dst: dst[0].copy_(y[0]),
                      _order_views(None, out_boxes)),
            alloc=_stack_alloc(None, out_boxes, wide_out))
        specs = None
    else:
        reshape_in, reshape_out, specs = _build_brick_edges(
            replace(inner, algorithm=algorithm), in_boxes, out_boxes)
        graph = inner.graph

        def chain(blocks, timer):
            return run_graph(graph, blocks, timer)

        edges = BrickEdgeGraph(
            edge_in=(_order_views(world, in_boxes), reshape_in),
            edge_out=(reshape_out, _order_views(world, out_boxes)),
            alloc=_stack_alloc(world, out_boxes, wide_out), specs=specs)
    io = compile_brick_io(edges, chain)
    nb = 1 if world is None else world.size
    in_shape = (nb,) + bricks.stack_pad_for(in_boxes)
    out_shape = (nb,) + bricks.stack_pad_for(out_boxes)
    into = donate and in_shape == out_shape

    def fn(hi, lo, timer=None):
        y = io(_held_bricks(plan, ddfft.join(hi, lo)), timer)
        return ddfft.split(y, out=(hi, lo) if into else None)

    plan = replace(inner, decomposition=f"bricks-{inner.decomposition}",
                   fn=fn, in_boxes=in_boxes, out_boxes=out_boxes,
                   in_shape=in_shape, out_shape=out_shape, algorithm=algorithm,
                   brick_edges=specs, donate=bool(donate))
    return plan


# ------------------------------------------------- plans from the reference

#: JAX executor bases and their port counterparts (tier and fuse flags
#: carried over).
_PORT_BASES = {"pallas": "cuda", "xla": "torch", "matmul": "matmul"}


def _port_executor(label: str) -> str:
    """The port's label for a JAX executor label: ``pallas`` is ``cuda``,
    ``xla`` is ``torch``, ``matmul`` is ``matmul``, the flags carried
    over."""
    base, *mods = str(label).split(":")
    if base not in _PORT_BASES:
        raise ValueError(
            f"reference executor {label!r} has no port counterpart; the port "
            f"runs {sorted(_PORT_BASES)} as "
            f"{[_PORT_BASES[k] for k in sorted(_PORT_BASES)]}")
    return ":".join([_PORT_BASES[base]] + mods)


_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def _desc_box(d) -> geo.Box3:
    lo, hi, *order = d
    return geo.Box3(tuple(lo), tuple(hi),
                    tuple(order[0]) if order else (0, 1, 2))


def _norm_boxes(boxes) -> list:
    return [_box_desc(_desc_box(b)) for b in boxes]


def plan_from_reference(desc: dict, *, device=None) -> Plan3D:
    """Build the port's plan, on a loopback world, from a JAX
    ``Plan3D``'s description in plain values: ``shape``, ``world_size``,
    ``direction``, ``dtype`` and the ``in_boxes`` / ``out_boxes`` as
    ``(low, high)`` or ``(low, high, order)`` tuples; optionally ``grid``
    (the (rows, cols) of a pencil plan's mesh, or of a hierarchical
    plan's hybrid mesh), ``kind`` (``"c2c"`` or ``"r2c"``),
    ``wire_dtype``, the JAX ``executor`` label (``pallas`` when absent),
    ``algorithm``, ``overlap_chunks`` (the resolved K), the ``fusion``
    decision (``requested``, ``active``, ``reasons``), ``batch``,
    ``r2c_axis``, the ``in_spec`` / ``out_spec`` entries, and
    ``brick_edges`` (a brick plan: its boxes are the bricks, and each
    edge's ``payload_elems`` must match). An operator plan's description
    also has ``op`` (its label) and ``op_spec`` (its ``SpectralOp``, of
    either package: :func:`.operators.op_from_reference`); the port's
    :func:`.operators.plan_spectral_op` is built from it. Raises when the
    port's geometry, accounting, operator or fusion decision differs
    from the description's."""
    dtype = _DTYPES.get(str(desc["dtype"]))
    if dtype is None:
        raise ValueError(f"the port runs complex64 and complex128, got "
                         f"{desc['dtype']}")
    kind = desc.get("kind", "c2c")
    if kind not in ("c2c", "r2c"):
        raise ValueError(f"unknown plan kind {kind!r}")
    grid = desc.get("grid")
    world = tuple(grid) if grid is not None else int(desc["world_size"])
    kw = dict(direction=desc["direction"], dtype=dtype, device=device,
              executor=_port_executor(desc.get("executor", "pallas")),
              algorithm=desc.get("algorithm", "alltoall"))
    if kind == "r2c":
        kw["r2c_axis"] = desc.get("r2c_axis", 2)
    edges = desc.get("brick_edges")
    if desc.get("op"):
        from .operators import op_from_reference, plan_spectral_op

        if desc.get("op_spec") is None:
            raise ValueError("an operator plan's description needs its "
                             "op_spec (the SpectralOp)")
        kw.pop("direction")
        plan = plan_spectral_op(
            desc["shape"], world, op=op_from_reference(desc["op_spec"]),
            wire_dtype=desc.get("wire_dtype"),
            overlap_chunks=desc.get("overlap_chunks"),
            batch=desc.get("batch"), **kw)
        if plan.op != desc["op"]:
            raise ValueError(f"op differs: port {plan.op!r}, reference "
                             f"{desc['op']!r}")
    elif edges is not None:
        planner = (plan_brick_dft_c2c_3d if kind == "c2c"
                   else plan_brick_dft_r2c_3d)
        plan = planner(desc["shape"], world,
                       [_desc_box(b) for b in desc["in_boxes"]],
                       [_desc_box(b) for b in desc["out_boxes"]], **kw)
    else:
        planner = plan_dft_c2c_3d if kind == "c2c" else plan_dft_r2c_3d
        spec = lambda k: (None if desc.get(k) is None
                          else Spec(*desc[k]))
        plan = planner(desc["shape"], world,
                       wire_dtype=desc.get("wire_dtype"),
                       overlap_chunks=desc.get("overlap_chunks"),
                       in_spec=spec("in_spec"), out_spec=spec("out_spec"),
                       batch=desc.get("batch"), **kw)
    mine = plan.describe()
    for key in ("in_boxes", "out_boxes"):
        theirs = _norm_boxes(desc[key])
        if _norm_boxes(mine[key]) != theirs:
            raise ValueError(f"{key} differ: port {mine[key]}, reference {theirs}")
    if edges is not None:
        got = [e["payload_elems"] for e in mine["brick_edges"]]
        want = [e["payload_elems"] for e in edges]
        if got != want:
            raise ValueError(
                f"brick edge payloads differ: port {got}, reference {want}")
    if "fusion" in desc:
        theirs = {k: desc["fusion"][k] for k in ("requested", "active")}
        theirs["reasons"] = tuple(desc["fusion"]["reasons"])
        if mine["fusion"] != theirs:
            raise ValueError(
                f"fusion differs: port {mine['fusion']}, reference {theirs}")
    return plan


# ------------------------------------------------------------- execute

def execute(plan: Plan3D, x: torch.Tensor, *, scale: Scale = Scale.NONE,
            timer=None) -> torch.Tensor:
    """Run a plan. ``timer`` (:class:`.utils.timing.StageTimer`) records
    each stage under its kind (t0..t3; a pencil plan's exchanges under
    t2a and t2b). With ``donate`` the plan may overwrite ``x``."""
    _check_input(plan, x)
    if _metrics._enabled:
        _metrics.inc("executes", kind=_kind_label(plan),
                     decomposition=plan.decomposition, executor=plan.executor)
        true_b, wire_b = _plan_exchange_bytes(plan)
        if true_b or wire_b:
            _metrics.inc("exchange_true_bytes", float(true_b))
            _metrics.inc("exchange_wire_bytes", float(wire_b))
    with add_trace(f"execute_{_kind_label(plan)}_{plan.decomposition}"):
        # Fault points (:mod:`.faults`): "compile" on a plan's first
        # execution, "exchange" for a plan that owns an exchange (raised
        # on the host: a fault inside a collective cannot be injected),
        # "execute" on every call. Disarmed, each is one env lookup.
        if not getattr(plan, "_warm", False):
            _faults.check("compile", plan.executor)
        if plan.world is not None:
            _faults.check("exchange", plan.algorithm)
        _faults.check("execute", plan.executor)
        y = _run_plan(plan, x, timer)
        plan._warm = True
        return apply_scale(y, scale, plan.world_size)


def _run_plan(plan: Plan3D, x: torch.Tensor, timer) -> torch.Tensor:
    """The plan's transform of ``x`` (checked by :func:`execute`), with
    no fault point, metric or scale."""
    if plan.runner is not None:
        return plan.runner(x, timer)
    if plan.decomposition == "single":
        _check_shape(x, plan.in_shape, "plan input shape")
        if timer is not None:
            with timer.stage("t0"):
                return _execute_single(plan, x.contiguous())
        return _execute_single(plan, x.contiguous())
    return _execute_chain(plan, x, timer)


def _check_input(plan: Plan3D, x) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"execute takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != plan.in_dtype or x.device != plan.device:
        raise ValueError(
            f"plan takes {plan.in_dtype} on {plan.device}, got {x.dtype} on "
            f"{x.device}")


def _kind_label(plan: Plan3D) -> str:
    op = getattr(plan, "op", "")
    if op:
        return f"op_{op}"          # the span is execute_op_<name>_<decomp>
    if plan.kind == "c2c":
        return "c2c"
    return "r2c" if plan.forward else "c2r"


def _check_shape(x: torch.Tensor, want, what: str) -> None:
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{what} is {tuple(want)}, got {tuple(x.shape)}")


def _execute_single(plan: Plan3D, x: torch.Tensor) -> torch.Tensor:
    """The one-device transform over the trailing three axes (a batched
    plan's leading axis rides the executors' own batch)."""
    bo = x.dim() - 3
    ax = (bo, bo + 1, bo + 2)
    if plan.kind == "c2c":
        if plan.donate:
            return run_donated(plan.executor, x, ax, plan.forward)
        return get_executor(plan.executor)(x, ax, plan.forward)
    ex = get_executor(plan.executor)
    if plan.forward:
        return ex(get_r2c(plan.executor)(x, ax[2]), ax[:2], True)
    return get_c2r(plan.executor)(ex(x, ax[:2], False), plan.shape[2], ax[2])


def chain_blocks(plan: Plan3D, x: torch.Tensor) -> list[torch.Tensor]:
    """A chain plan's input as the held blocks, checked as
    :func:`execute` checks it (:func:`.stagegraph.scatter`: on a loopback
    world the global array, on a process group this rank's box padded to
    its block)."""
    _check_input(plan, x)
    world = plan.world
    if world.loopback:
        _check_shape(x, plan.in_shape, "plan input shape")
    else:
        bpfx = () if plan.batch is None else (plan.batch,)
        _check_shape(x, bpfx + plan.in_boxes[world.rank].shape,
                     f"rank {world.rank} input box")
    return scatter(plan.graph, x)


def _execute_chain(plan: Plan3D, x: torch.Tensor, timer) -> torch.Tensor:
    """A slab or pencil chain: the input cut into the held blocks
    (:func:`chain_blocks`), the graph run, the output joined and cropped
    (:func:`.stagegraph.gather`)."""
    return gather(plan.graph, run_graph(plan.graph, chain_blocks(plan, x),
                                        timer, donate=plan.donate))


def _plan_exchange_bytes(plan: Plan3D) -> tuple[int, int]:
    """(true, wire) bytes one execution of ``plan`` moves between ranks:
    the chain's exchanges by :func:`.plan_logic.exchange_payloads` under
    the plan's transport, plus its brick edges. Computed once per plan
    (kept on it)."""
    cached = getattr(plan, "_exchange_bytes", None)
    if cached is not None:
        return cached
    true_b = wire_b = 0
    itemsize = torch.empty((), dtype=plan.dtype).element_size()
    lp = plan.logic
    if lp is not None and lp.world is not None:
        # the complex side of the chain's own world (r2c: axis 2 halved)
        shape = lp.shape if plan.kind == "c2c" else (
            lp.shape[:2] + (lp.shape[2] // 2 + 1,))
        wire_key = WIRE_BYTE_KEYS[lp.algorithm]
        for e in exchange_payloads(lp, shape, itemsize):
            true_b += e["true_bytes"]
            wire_b += int(e[wire_key] * e["wire_factor"])
    for bs in plan.brick_edges or ():
        true_b += bs.payload_elems * itemsize
        wire_b += bs.wire_elems * itemsize
    plan._exchange_bytes = (true_b, wire_b)
    return true_b, wire_b


# ------------------------------------------------------------ plan cache
# Plans are immutable once built and cost host time to build, so the
# public planners memoize on their whole argument set: kind, shape,
# world, the keywords, the resolved device and every environment
# variable planning reads (_PLAN_ENV_KNOBS). Unhashable arguments, and
# worlds over a process group (whose group may be destroyed and another
# made with equal fields), bypass the cache. It holds _PLAN_CACHE_MAX
# plans, the oldest evicted first.

_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 128
_PLAN_ENV_KNOBS = (
    # overlap_chunks=None
    "DFFT_OVERLAP",
    # the defaults of wire_dtype, fuse and the matmul tiers
    "DFFT_WIRE_DTYPE", "DFFT_FUSE", "DFFT_MM_PRECISION", "DFFT_MM_COMPLEX",
    # executor="auto" and the tuner's executor axis
    "DFFT_AUTO_EXECUTORS",
    # tuned planning: mode, wisdom store (and its default home), budget,
    # survivor cap, profile and its corrections
    "DFFT_TUNE", "DFFT_WISDOM", "DFFT_COMPILE_CACHE", "DFFT_TUNE_ITERS",
    "DFFT_TUNE_MAX", "DFFT_HW_PROFILE", "DFFT_TUNE_CORRECTION",
)


def clear_plan_cache() -> None:
    """Drop every memoized plan (tests, peak-memory readings)."""
    _PLAN_CACHE.clear()


def destroy_plan(plan) -> None:
    """The counterpart of ``fft_mpi_destroy_plan`` (the JAX package's
    parity shim): drop ``plan``'s entries from the plan cache, so that
    the cache no longer keeps it, and with it its device blocks, alive.
    Once the caller drops its own reference too, those blocks go back to
    the caching allocator and ``torch.cuda.empty_cache()`` can return
    them to the card. Twiddle tables are shared by every plan of a length
    and stay. The plan stays callable, and warm."""
    for key in [k for k, v in _PLAN_CACHE.items() if v is plan]:
        del _PLAN_CACHE[key]


def _plan_cache_key(kind: str, shape, world, kw: dict):
    """Hashable cache key, or None when the call bypasses the cache."""
    if isinstance(world, World) and not world.loopback:
        return None
    kw = dict(kw)
    device = resolve_device(kw.pop("device", None))
    # each value with its type: batch=True must not find the batch=1 plan
    args = tuple(sorted((k, type(v), v) for k, v in kw.items()))
    key = (kind, shape, type(world), world, args, device,
           tuple(os.environ.get(v, "") for v in _PLAN_ENV_KNOBS))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _timed_build(kind: str, build: Callable, shape, world, kw: dict):
    # Fault point "plan": a cache miss is about to build a plan (a hit
    # replays a built one); the label lets match= pick an executor.
    _faults.check("plan", str(kw.get("executor") or ""))
    t0 = time.perf_counter()
    plan = build(shape, world, **kw)
    if _metrics._enabled:
        _metrics.observe("plan_build_seconds", time.perf_counter() - t0,
                         kind=kind)
        _metrics.inc("plan_builds", kind=kind,
                     decomposition=plan.decomposition,
                     executor=getattr(plan, "executor", "dd"))
    return plan


def _plan_cached(kind: str, build: Callable) -> Callable:
    """Memoizing wrapper of a public planner (``plan_cache_hits`` /
    ``plan_cache_misses`` by ``kind``)."""

    @functools.wraps(build)
    def wrapper(shape, world=None, **kw):
        shape = tuple(int(s) for s in shape)
        key = _plan_cache_key(kind, shape, world, kw)
        if key is None:
            return _timed_build(kind, build, shape, world, kw)
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            if _metrics._enabled:
                _metrics.inc("plan_cache_hits", kind=kind)
            return plan
        if _metrics._enabled:
            _metrics.inc("plan_cache_misses", kind=kind)
        plan = _PLAN_CACHE[key] = _timed_build(kind, build, shape, world, kw)
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        return plan

    return wrapper


plan_dft_c2c_3d = _plan_cached("c2c", plan_dft_c2c_3d)
plan_dft_r2c_3d = _plan_cached("r2c", plan_dft_r2c_3d)
plan_dd_dft_c2c_3d = _plan_cached("dd_c2c", plan_dd_dft_c2c_3d)
plan_dd_dft_r2c_3d = _plan_cached("dd_r2c", plan_dd_dft_r2c_3d)
