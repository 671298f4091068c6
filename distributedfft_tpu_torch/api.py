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

``wire_dtype`` (``"bf16"``, ``"int8"``, ``"split"``) compresses the
chain's exchanges; ``fuse=True`` (the ``cuda:fuse`` executor label) asks
the stage graph to fuse the codec into the stages beside each exchange.
A single-device plan has no exchange and drops the codec. The JAX
package's ``DFFT_FUSE`` / ``DFFT_WIRE_DTYPE`` environment defaults are
not read.

I/O of a distributed plan: on a loopback world ``execute`` takes and
returns the global array (forward: X-slabs in and Y-slabs out, or
z-pencils in and x-pencils out); on a process-group world it takes this
rank's input box and returns its output box.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from . import geometry as geo
from .ops.executors import (Scale, apply_scale, fused_name, get_executor,
                            get_c2r, get_r2c, split_fuse)
from .parallel.exchange import _crop_axis, _pad_axis, wire_codec
from .parallel.mesh import World
from .parallel.pencil import (PencilSpec, build_pencil_fft3d,
                              build_pencil_rfft3d)
from .parallel.slab import SlabSpec, build_slab_fft3d, build_slab_rfft3d
from .plan_logic import io_boxes, logic_plan3d
from .stagegraph import StageGraph, plan_fusion, run_graph

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
        pencil plan's world, else None."""
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
            fusion={k: fusion[k] for k in ("requested", "active", "reasons")},
            in_boxes=[box(b) for b in self.in_boxes],
            out_boxes=[box(b) for b in self.out_boxes],
        )

    def __call__(self, x: torch.Tensor, *, scale: Scale = Scale.NONE,
                 timer=None) -> torch.Tensor:
        return execute(self, x, scale=scale, timer=timer)


def _executor_label(executor: str, fuse: bool | None) -> str:
    """The executor label with the fuse flag normalised in (the port of
    ``_apply_fuse``, without its ``DFFT_FUSE`` default): ``fuse=True``
    adds ``:fuse`` to a fusable base and raises on any other;
    ``fuse=False`` beside a label that pins ``:fuse`` raises; ``None``
    keeps the label's own flag."""
    executor = fused_name(executor, fuse)
    get_executor(executor)
    return executor


def _plan(shape, world, *, kind: str, direction: int, executor: str,
          dtype: torch.dtype, device, wire_dtype: str | None,
          fuse: bool | None, decomposition: str | None) -> Plan3D:
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("3D plans require a 3D shape")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError("direction must be FORWARD (-1) or BACKWARD (+1)")
    if dtype not in REAL_DTYPE:
        raise ValueError(
            f"dtype must be torch.complex64 or torch.complex128, got {dtype}")
    executor = _executor_label(executor, fuse)
    if wire_dtype is not None:
        wire_codec(wire_dtype)
    device = resolve_device(device)
    forward = direction == FORWARD
    lp = logic_plan3d(shape, world, forward=forward,
                      decomposition=decomposition)
    graph = spec = None
    if lp.decomposition == "slab":
        build = build_slab_fft3d if kind == "c2c" else build_slab_rfft3d
        graph, spec = build(lp.world, shape, executor=executor,
                            forward=forward, wire_dtype=wire_dtype)
    elif lp.decomposition == "pencil":
        if kind == "c2c":
            graph, spec = build_pencil_fft3d(
                lp.world, shape, executor=executor, forward=forward,
                perm=lp.pencil_perm, order=lp.pencil_order,
                wire_dtype=wire_dtype)
        else:
            graph, spec = build_pencil_rfft3d(
                lp.world, shape, executor=executor, forward=forward,
                wire_dtype=wire_dtype)
    else:
        wire_dtype = None          # no exchange, nothing to compress
    if graph is not None:
        graph.meta["fusion"] = plan_fusion(graph)
    in_boxes, out_boxes = io_boxes(lp, forward=forward, real=kind == "r2c")
    return Plan3D(shape=shape, direction=direction, dtype=dtype,
                  decomposition=lp.decomposition, executor=executor,
                  world=lp.world, device=device, kind=kind,
                  wire_dtype=wire_dtype, graph=graph, spec=spec,
                  in_boxes=in_boxes, out_boxes=out_boxes)


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
) -> Plan3D:
    """Create a 3D complex-to-complex FFT plan over ``world`` (a
    :class:`~.parallel.mesh.World`, an int for a loopback world of that
    many ranks, a ``(rows, cols)`` tuple for a loopback 2D world, or None
    for one device). ``direction`` uses the FFTW sign convention (-1
    forward). Forward is unnormalized and backward scaled 1/N (numpy
    convention), as the JAX package's executors are; ``execute``'s
    ``scale`` multiplies on top of that. ``wire_dtype``, ``fuse`` and
    ``decomposition`` as in the module docstring."""
    return _plan(shape, world, kind="c2c", direction=direction,
                 executor=executor, dtype=dtype, device=device,
                 wire_dtype=wire_dtype, fuse=fuse,
                 decomposition=decomposition)


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
    r2c_axis: int = 2,
) -> Plan3D:
    """Create a real-to-complex (forward) / complex-to-real (backward) 3D
    FFT plan. ``shape`` is the real-space world; the complex side is
    shrunk along axis 2 to n2//2+1. Forward takes the real dtype of
    ``dtype`` (float32 or float64) and returns ``dtype``; backward the
    mirror, scaled 1/N. Only the canonical ``r2c_axis=2`` chain is
    ported."""
    if r2c_axis != 2:
        raise ValueError(
            f"r2c_axis={r2c_axis}: the port runs the canonical r2c_axis=2 "
            f"chain only")
    return _plan(shape, world, kind="r2c", direction=direction,
                 executor=executor, dtype=dtype, device=device,
                 wire_dtype=wire_dtype, fuse=fuse,
                 decomposition=decomposition)


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
    pencil plan's mesh), ``kind`` (``"c2c"`` or ``"r2c"``),
    ``wire_dtype``, the JAX ``executor`` label (``pallas`` when absent)
    and the ``fusion`` decision (``requested``, ``active``,
    ``reasons``). Raises when the port's
    geometry or fusion decision differs from the description's."""
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
                   wire_dtype=desc.get("wire_dtype"))
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
    if plan.decomposition == "single":
        _check_shape(x, plan.in_shape, "plan input shape")
        if timer is not None:
            with timer.stage("t0"):
                y = _execute_single(plan, x.contiguous())
        else:
            y = _execute_single(plan, x.contiguous())
    elif plan.decomposition == "slab":
        y = _execute_slab(plan, x, timer)
    else:
        y = _execute_pencil(plan, x, timer)
    return apply_scale(y, scale, plan.world_size)


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


def _execute_slab(plan: Plan3D, x: torch.Tensor, timer) -> torch.Tensor:
    graph, spec, world = plan.graph, plan.spec, plan.world
    ax_in, ax_out = spec.in_axis, spec.out_axis
    in_to = spec.in_padded_extent
    if world.loopback:
        _check_shape(x, plan.in_shape, "plan input shape")
        blocks = list(_pad_axis(x, ax_in, in_to).chunk(world.size, dim=ax_in))
        out = run_graph(graph, blocks, timer)
        return _crop_axis(torch.cat(out, dim=ax_out), ax_out,
                          spec.shape[ax_out])
    _check_shape(x, plan.in_boxes[world.rank].shape,
                 f"rank {world.rank} input box")
    block = _pad_axis(x, ax_in, in_to // world.size)
    (out,) = run_graph(graph, [block], timer)
    return _crop_axis(out, ax_out, plan.out_boxes[world.rank].shape[ax_out])


def _execute_pencil(plan: Plan3D, x: torch.Tensor, timer) -> torch.Tensor:
    """The pencil chain: ``graph.pre`` pads the global input, which is
    cut into rows x cols blocks (rank r*cols + c holds chunk r of the
    input's row axis and chunk c of its col axis); the output blocks are
    joined the same way on the output axes and cropped by
    ``graph.post``. A process-group rank pads its own box to its block
    and crops its block to its output box."""
    graph, spec, world = plan.graph, plan.spec, plan.world
    rows, cols = world.grid
    (ri, ci), (ro, co) = spec.in_placement, spec.out_placement
    if world.loopback:
        _check_shape(x, plan.in_shape, "plan input shape")
        for _, axis, to in graph.pre:
            x = _pad_axis(x, axis, to)
        blocks = [b for strip in x.tensor_split(rows, dim=ri)
                  for b in strip.tensor_split(cols, dim=ci)]
        out = run_graph(graph, blocks, timer)
        y = torch.cat([torch.cat(out[r * cols:(r + 1) * cols], dim=co)
                       for r in range(rows)], dim=ro)
        for _, axis, to in graph.post:
            y = _crop_axis(y, axis, to)
        return y
    _check_shape(x, plan.in_boxes[world.rank].shape,
                 f"rank {world.rank} input box")
    parts = {ri: rows, ci: cols}
    for _, axis, to in graph.pre:
        x = _pad_axis(x, axis, to // parts[axis])
    (out,) = run_graph(graph, [x.contiguous()], timer)
    want = plan.out_boxes[world.rank].shape
    for axis in (ro, co):
        out = _crop_axis(out, axis, want[axis])
    return out
