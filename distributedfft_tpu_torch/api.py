"""Plan and execute distributed 3D FFTs -- the port of ``Plan3D`` /
``plan_dft_c2c_3d`` / ``plan_dft_r2c_3d`` / ``plan_dft_c2r_3d`` /
``execute`` of ``distributedfft_tpu/api.py``.

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
the codec, the transport's choice and K. The JAX package's
``DFFT_FUSE`` / ``DFFT_WIRE_DTYPE`` environment defaults are not read.

I/O of a distributed plan: on a loopback world ``execute`` takes and
returns the global array (forward: X-slabs in and Y-slabs out, or
z-pencils in and x-pencils out); on a process-group world it takes this
rank's input box and returns its output box.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Sequence

import torch

from . import geometry as geo
from .ops.executors import (MM_EXECUTOR_BASES, Scale, apply_scale,
                            fused_name, get_c2r, get_executor, get_r2c,
                            split_fuse, tiered_name)
from .parallel.exchange import wire_codec
from .parallel.mesh import World
from .parallel.pencil import (PencilSpec, build_pencil_fft3d,
                              build_pencil_rfft3d)
from .parallel.slab import SlabSpec, build_slab_fft3d, build_slab_rfft3d
from .plan_logic import PlanOptions, io_boxes, logic_plan3d
from .stagegraph import StageGraph, gather, plan_fusion, run_graph, scatter
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
    forward real in, complex half-spectrum out along axis 2, backward
    the mirror); ``dtype`` is the complex working dtype."""

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

    @property
    def forward(self) -> bool:
        return self.direction == FORWARD

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    @property
    def complex_shape(self) -> tuple[int, int, int]:
        """The complex side's global shape (axis 2 shrunk on r2c)."""
        n0, n1, n2 = self.shape
        return (n0, n1, n2 // 2 + 1) if self.kind == "r2c" else self.shape

    @property
    def in_shape(self) -> tuple[int, int, int]:
        return self.shape if self.forward else self.complex_shape

    @property
    def out_shape(self) -> tuple[int, int, int]:
        return self.complex_shape if self.forward else self.shape

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
        exchange's transport and resolved K."""
        box = lambda b: (tuple(b.low), tuple(b.high))
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
            in_boxes=[box(b) for b in self.in_boxes],
            out_boxes=[box(b) for b in self.out_boxes],
        )

    def __call__(self, x: torch.Tensor, *, scale: Scale = Scale.NONE,
                 timer=None) -> torch.Tensor:
        return execute(self, x, scale=scale, timer=timer)


def _resolve_options(options: PlanOptions | None, executor: str,
                     wire_dtype: str | None, fuse: bool | None,
                     decomposition: str | None, algorithm: str,
                     overlap_chunks) -> PlanOptions:
    """One :class:`PlanOptions` from ``options=`` or the keywords (not
    both), its executor label canonical: the matmul tiers and the fuse
    flag composed in (the port of ``_apply_mm_tiers`` / ``_apply_fuse``,
    without the environment defaults)."""
    if options is not None:
        if (executor != "cuda" or wire_dtype is not None or fuse is not None
                or decomposition is not None or algorithm != "alltoall"
                or overlap_chunks is not None):
            raise ValueError(
                "pass either options= or individual plan keywords, not both")
        opts = options
    else:
        if wire_dtype not in (None, "none"):
            wire_codec(wire_dtype)     # the codec registry's own error
        opts = PlanOptions(decomposition=decomposition or "auto",
                           algorithm=algorithm, executor=executor,
                           overlap_chunks=overlap_chunks,
                           wire_dtype=wire_dtype, fuse=fuse)
    ex = opts.executor
    if opts.mm_precision is not None or opts.mm_complex is not None:
        if not ex.split(":", 1)[0].startswith(MM_EXECUTOR_BASES):
            raise ValueError(
                f"mm_precision/mm_complex scope the matmul-family "
                f"executors {MM_EXECUTOR_BASES}; executor={ex!r} never "
                f"consults them")
        ex = tiered_name(ex, opts.mm_precision, opts.mm_complex)
    ex = fused_name(ex, opts.fuse)
    get_executor(ex)
    wd = None if opts.wire_dtype == "none" else opts.wire_dtype
    return replace(opts, executor=ex, wire_dtype=wd)


def _plan(shape, world, *, kind: str, direction: int, dtype: torch.dtype,
          device, opts: PlanOptions) -> Plan3D:
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
    executor, wire_dtype = opts.executor, opts.wire_dtype
    lp = logic_plan3d(shape, world, opts, forward=forward)
    graph = spec = None
    kw = dict(executor=executor, forward=forward, wire_dtype=wire_dtype,
              algorithm=lp.algorithm, overlap_chunks=lp.overlap_chunks)
    if lp.decomposition == "slab":
        build = build_slab_fft3d if kind == "c2c" else build_slab_rfft3d
        graph, spec = build(lp.world, shape, **kw)
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
    return Plan3D(shape=shape, direction=direction, dtype=dtype,
                  decomposition=lp.decomposition, executor=executor,
                  world=lp.world, device=device, kind=kind,
                  wire_dtype=wire_dtype, algorithm=lp.algorithm,
                  overlap_chunks=lp.overlap_chunks,
                  options=replace(opts, decomposition=lp.decomposition,
                                  overlap_chunks=lp.overlap_chunks,
                                  wire_dtype=wire_dtype),
                  graph=graph, spec=spec, in_boxes=in_boxes,
                  out_boxes=out_boxes)


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
) -> Plan3D:
    """Create a 3D complex-to-complex FFT plan over ``world`` (a
    :class:`~.parallel.mesh.World`, an int for a loopback world of that
    many ranks, a ``(rows, cols)`` tuple for a loopback 2D world -- a
    hybrid one under ``algorithm="hierarchical"`` -- or None for one
    device). ``direction`` uses the FFTW sign convention (-1 forward).
    Forward is unnormalized and backward scaled 1/N (numpy convention),
    as the JAX package's executors are; ``execute``'s ``scale``
    multiplies on top of that. ``wire_dtype``, ``fuse``,
    ``decomposition``, ``algorithm``, ``overlap_chunks`` and
    ``options`` as in the module docstring."""
    opts = _resolve_options(options, executor, wire_dtype, fuse,
                            decomposition, algorithm, overlap_chunks)
    return _plan(shape, world, kind="c2c", direction=direction, dtype=dtype,
                 device=device, opts=opts)


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
    r2c_axis: int = 2,
) -> Plan3D:
    """Create a real-to-complex (forward) / complex-to-real (backward) 3D
    FFT plan. ``shape`` is the real-space world; the complex side is
    shrunk along axis 2 to n2//2+1. Forward takes the real dtype of
    ``dtype`` (float32 or float64) and returns ``dtype``; backward the
    mirror, scaled 1/N. The flat transports only: ``hierarchical``
    raises, as in the JAX package. Only the canonical ``r2c_axis=2``
    chain is ported."""
    if r2c_axis != 2:
        raise ValueError(
            f"r2c_axis={r2c_axis}: the port runs the canonical r2c_axis=2 "
            f"chain only")
    opts = _resolve_options(options, executor, wire_dtype, fuse,
                            decomposition, algorithm, overlap_chunks)
    return _plan(shape, world, kind="r2c", direction=direction, dtype=dtype,
                 device=device, opts=opts)


def plan_dft_c2r_3d(shape, world=None, **kw) -> Plan3D:
    """The inverse of :func:`plan_dft_r2c_3d` (complex half-spectrum in,
    real out)."""
    kw.setdefault("direction", BACKWARD)
    return plan_dft_r2c_3d(shape, world, **kw)


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


def plan_from_reference(desc: dict, *, device=None) -> Plan3D:
    """Build the port's plan, on a loopback world, from a JAX
    ``Plan3D``'s description in plain values: ``shape``, ``world_size``,
    ``direction``, ``dtype`` and the ``in_boxes`` / ``out_boxes`` as
    ((low), (high)) tuples; optionally ``grid`` (the (rows, cols) of a
    pencil plan's mesh, or of a hierarchical plan's hybrid mesh), ``kind``
    (``"c2c"`` or ``"r2c"``), ``wire_dtype``, the JAX ``executor`` label
    (``pallas`` when absent), ``algorithm``, ``overlap_chunks`` (the
    resolved K) and the ``fusion`` decision (``requested``, ``active``,
    ``reasons``). Raises when the port's geometry or fusion decision
    differs from the description's."""
    dtype = _DTYPES.get(str(desc["dtype"]))
    if dtype is None:
        raise ValueError(f"the port runs complex64 and complex128, got "
                         f"{desc['dtype']}")
    kind = desc.get("kind", "c2c")
    if kind not in ("c2c", "r2c"):
        raise ValueError(f"unknown plan kind {kind!r}")
    grid = desc.get("grid")
    world = tuple(grid) if grid is not None else int(desc["world_size"])
    planner = plan_dft_c2c_3d if kind == "c2c" else plan_dft_r2c_3d
    plan = planner(desc["shape"], world, direction=desc["direction"],
                   dtype=dtype, device=device,
                   executor=_port_executor(desc.get("executor", "pallas")),
                   wire_dtype=desc.get("wire_dtype"),
                   algorithm=desc.get("algorithm", "alltoall"),
                   overlap_chunks=desc.get("overlap_chunks"))
    mine = plan.describe()
    for key in ("in_boxes", "out_boxes"):
        theirs = [(tuple(lo), tuple(hi)) for lo, hi in desc[key]]
        if mine[key] != theirs:
            raise ValueError(f"{key} differ: port {mine[key]}, reference {theirs}")
    if "fusion" in desc:
        theirs = {k: desc["fusion"][k] for k in ("requested", "active")}
        theirs["reasons"] = tuple(desc["fusion"]["reasons"])
        if mine["fusion"] != theirs:
            raise ValueError(
                f"fusion differs: port {mine['fusion']}, reference {theirs}")
    return plan


def execute(plan: Plan3D, x: torch.Tensor, *, scale: Scale = Scale.NONE,
            timer=None) -> torch.Tensor:
    """Run a plan. ``timer`` (:class:`.utils.timing.StageTimer`) records
    each stage under its kind (t0..t3; a pencil plan's exchanges under
    t2a and t2b)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"execute takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != plan.in_dtype or x.device != plan.device:
        raise ValueError(
            f"plan takes {plan.in_dtype} on {plan.device}, got {x.dtype} on "
            f"{x.device}")
    with add_trace(f"execute_{_kind_label(plan)}_{plan.decomposition}"):
        if plan.decomposition == "single":
            _check_shape(x, plan.in_shape, "plan input shape")
            if timer is not None:
                with timer.stage("t0"):
                    y = _execute_single(plan, x.contiguous())
            else:
                y = _execute_single(plan, x.contiguous())
        else:
            y = _execute_chain(plan, x, timer)
        return apply_scale(y, scale, plan.world_size)


def _kind_label(plan: Plan3D) -> str:
    if plan.kind == "c2c":
        return "c2c"
    return "r2c" if plan.forward else "c2r"


def _check_shape(x: torch.Tensor, want, what: str) -> None:
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{what} is {tuple(want)}, got {tuple(x.shape)}")


def _execute_single(plan: Plan3D, x: torch.Tensor) -> torch.Tensor:
    ex = get_executor(plan.executor)
    if plan.kind == "c2c":
        return ex(x, (0, 1, 2), plan.forward)
    if plan.forward:
        return ex(get_r2c(plan.executor)(x, 2), (0, 1), True)
    return get_c2r(plan.executor)(ex(x, (0, 1), False), plan.shape[2], 2)


def _execute_chain(plan: Plan3D, x: torch.Tensor, timer) -> torch.Tensor:
    """A slab or pencil chain: the input cut into the held blocks
    (:func:`.stagegraph.scatter`: on a loopback world the global array,
    on a process group this rank's box padded to its block), the graph
    run, the output joined and cropped (:func:`.stagegraph.gather`)."""
    world = plan.world
    if world.loopback:
        _check_shape(x, plan.in_shape, "plan input shape")
    else:
        _check_shape(x, plan.in_boxes[world.rank].shape,
                     f"rank {world.rank} input box")
    return gather(plan.graph, run_graph(plan.graph, scatter(plan.graph, x),
                                        timer))
