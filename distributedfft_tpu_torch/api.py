"""Plan and execute distributed 3D C2C FFTs -- the port of
``Plan3D`` / ``plan_dft_c2c_3d`` / ``execute`` of
``distributedfft_tpu/api.py``.

A plan runs on ``torch.device("cuda")`` unless the caller passes another
device; without a device and without CUDA, planning raises. On a world of
one rank (or none) the plan is ``"single"``: one executor call over axes
(0, 1, 2). On a larger 1D world it is the slab chain of
:mod:`.parallel.slab`.

I/O of a slab plan: on a loopback world ``execute`` takes and returns the
global array (X-slabs in and Y-slabs out, forward); on a process-group
world it takes this rank's input box and returns its output box.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from . import geometry as geo
from .ops.cuda_fft import eligible
from .ops.executors import Scale, apply_scale, get_executor
from .parallel.exchange import _crop_axis, _pad_axis
from .parallel.mesh import World, make_world
from .parallel.slab import SlabSpec, build_slab_fft3d
from .plan_logic import io_boxes, logic_plan3d
from .stagegraph import StageGraph, run_graph

# FFTW sign convention.
FORWARD = -1
BACKWARD = +1


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
    """A distributed 3D FFT plan (one direction)."""

    shape: tuple[int, int, int]
    direction: int
    dtype: torch.dtype
    decomposition: str            # "single" | "slab"
    executor: str
    world: World | None
    device: torch.device
    graph: StageGraph | None = None
    spec: SlabSpec | None = None
    in_boxes: list[geo.Box3] = field(default_factory=list)
    out_boxes: list[geo.Box3] = field(default_factory=list)

    @property
    def forward(self) -> bool:
        return self.direction == FORWARD

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    def describe(self) -> dict[str, Any]:
        """The plan's geometry as plain values (see
        :func:`plan_from_reference`)."""
        box = lambda b: (tuple(b.low), tuple(b.high))
        return dict(
            shape=self.shape,
            world_size=1 if self.world is None else self.world.size,
            direction=self.direction,
            dtype=str(self.dtype).removeprefix("torch."),
            decomposition=self.decomposition,
            in_boxes=[box(b) for b in self.in_boxes],
            out_boxes=[box(b) for b in self.out_boxes],
        )

    def __call__(self, x: torch.Tensor, *, scale: Scale = Scale.NONE,
                 timer=None) -> torch.Tensor:
        return execute(self, x, scale=scale, timer=timer)


def plan_dft_c2c_3d(
    shape: Sequence[int],
    world: World | int | None = None,
    *,
    direction: int = FORWARD,
    executor: str = "cuda",
    dtype: torch.dtype = torch.complex64,
    device=None,
) -> Plan3D:
    """Create a 3D complex-to-complex FFT plan over ``world`` (a
    :class:`~.parallel.mesh.World`, an int for a loopback world of that
    many ranks, or None for one device). ``direction`` uses the FFTW sign
    convention (-1 forward). Forward is unnormalized and backward scaled
    1/N (numpy convention), as the JAX package's executors are;
    ``execute``'s ``scale`` multiplies on top of that."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("3D plans require a 3D shape")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError("direction must be FORWARD (-1) or BACKWARD (+1)")
    if dtype != torch.complex64:
        raise ValueError(
            f"cuda executor: dtype {dtype} is not kernel-eligible (reason: "
            f"dtype); this slice runs complex64 only")
    for n in shape:
        if not eligible(n):
            raise ValueError(
                f"cuda executor: length {n} of {shape} is not kernel-eligible "
                f"(reason: length); the dft_matmul route is not ported yet")
    get_executor(executor)
    device = resolve_device(device)
    if isinstance(world, int):
        world = make_world(world)
    forward = direction == FORWARD
    lp = logic_plan3d(shape, world, forward=forward)
    graph = spec = None
    if lp.decomposition == "slab":
        graph, spec = build_slab_fft3d(lp.world, shape, executor=executor,
                                       forward=forward)
    in_boxes, out_boxes = io_boxes(lp)
    return Plan3D(shape=shape, direction=direction, dtype=dtype,
                  decomposition=lp.decomposition, executor=executor,
                  world=lp.world, device=device, graph=graph, spec=spec,
                  in_boxes=in_boxes, out_boxes=out_boxes)


def plan_from_reference(desc: dict, *, device=None) -> Plan3D:
    """Build the port's plan, on a loopback world, from a JAX
    ``Plan3D``'s description in plain values: ``shape``, ``world_size``,
    ``direction``, ``dtype`` and the ``in_boxes`` / ``out_boxes`` as
    ((low), (high)) tuples. Raises when the port's geometry differs from
    the description's."""
    if str(desc["dtype"]) != "complex64":
        raise ValueError(f"this slice runs complex64 only, got {desc['dtype']}")
    plan = plan_dft_c2c_3d(desc["shape"], int(desc["world_size"]),
                           direction=desc["direction"], device=device)
    mine = plan.describe()
    for key in ("in_boxes", "out_boxes"):
        theirs = [(tuple(lo), tuple(hi)) for lo, hi in desc[key]]
        if mine[key] != theirs:
            raise ValueError(f"{key} differ: port {mine[key]}, reference {theirs}")
    return plan


def execute(plan: Plan3D, x: torch.Tensor, *, scale: Scale = Scale.NONE,
            timer=None) -> torch.Tensor:
    """Run a plan. ``timer`` (:class:`.utils.timing.StageTimer`) records
    each stage under t0..t3."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"execute takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != plan.dtype or x.device != plan.device:
        raise ValueError(
            f"plan takes {plan.dtype} on {plan.device}, got {x.dtype} on "
            f"{x.device}")
    if plan.decomposition == "single":
        if tuple(x.shape) != plan.shape:
            raise ValueError(f"plan input shape is {plan.shape}, got {tuple(x.shape)}")
        ex = get_executor(plan.executor)
        if timer is not None:
            with timer.stage("t0"):
                y = ex(x.contiguous(), (0, 1, 2), plan.forward)
        else:
            y = ex(x.contiguous(), (0, 1, 2), plan.forward)
    else:
        y = _execute_slab(plan, x, timer)
    return apply_scale(y, scale, plan.world_size)


def _execute_slab(plan: Plan3D, x: torch.Tensor, timer) -> torch.Tensor:
    graph, spec, world = plan.graph, plan.spec, plan.world
    ax_in, ax_out = spec.in_axis, spec.out_axis
    in_to = spec.in_padded_extent
    if world.loopback:
        if tuple(x.shape) != plan.shape:
            raise ValueError(f"plan input shape is {plan.shape}, got {tuple(x.shape)}")
        blocks = list(_pad_axis(x, ax_in, in_to).chunk(world.size, dim=ax_in))
        out = run_graph(graph, blocks, timer)
        return _crop_axis(torch.cat(out, dim=ax_out), ax_out,
                          spec.shape[ax_out])
    want = plan.in_boxes[world.rank].shape
    if tuple(x.shape) != want:
        raise ValueError(f"rank {world.rank} input box is {want}, got {tuple(x.shape)}")
    block = _pad_axis(x, ax_in, in_to // world.size)
    (out,) = run_graph(graph, [block], timer)
    return _crop_axis(out, ax_out, plan.out_boxes[world.rank].shape[ax_out])
