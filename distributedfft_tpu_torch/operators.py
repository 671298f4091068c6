"""Spectral operators: FFT -> pointwise multiplier -> inverse FFT as one
plan -- the port of ``distributedfft_tpu/operators.py``.

What users run on a 3D FFT is mostly an operator: a Poisson solve, a
spectral derivative, a Gaussian filter, a convolution. A plan of this
module runs the forward chain, stops in the *transposed* midpoint layout
(the slab chain's Y-slabs, the pencil chain's x-pencils), applies the
wavenumber-diagonal multiplier there (the ``t_mid`` stage, its index
grids made per rank and per overlap chunk), and retraces the exchanges
back to the input layout. A forward plan, a multiply in the caller's
layout and a backward plan pay a cancelling pair of global transposes
around the multiply; the fused chain skips it: two exchanges on a slab
world where that pair takes four, four on a pencil world where it takes
six (``parallel.exchange.ROUNDS`` counts them).

Every knob of the transform plans composes: ``batch=B`` (the multiplier
broadcast over the batch), ``overlap_chunks`` (both exchange legs
chunked, the multiplier generated for each chunk's slice),
``wire_dtype`` and ``fuse`` (each leg compressed; the multiplier applies
to the decoded payload), the four transports (``hierarchical`` over a
hybrid world) and ``donate``.

Wavenumber convention: the unit torus, ``k_d = 2 pi f_d`` with ``f_d``
the signed integer frequency of axis d (numpy's ``fftfreq`` times n),
computed on the plan's device at the chain's component precision
(float64 under a complex128 plan).

Differences from the JAX package: plans are not memoised (no plan cache
yet), ``tune`` other than off raises ``NotImplementedError`` (the tuner
is not ported), and on a loopback world the midpoint's factory is called
once per rank (JAX traces it once under ``shard_map``). A ``custom``
op's generator takes and returns torch tensors.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import api as _api
from .api import (FORWARD, REAL_DTYPE, OpPlan3D, _check_shape, _norm_batch,
                  _resolve_options, resolve_device)
from .ops.executors import get_executor, run_donated
from .parallel.pencil import build_pencil_spectral_op
from .parallel.slab import build_slab_spectral_op
from .plan_logic import (PlanOptions, io_boxes, logic_plan3d,
                         resolve_tune_mode)
from .stagegraph import apply_midpoint, plan_fusion

__all__ = [
    "SpectralOp",
    "poisson",
    "biharmonic",
    "helmholtz",
    "gradient",
    "gaussian",
    "convolve",
    "custom",
    "chain",
    "named_op",
    "OP_NAMES",
    "op_from_reference",
    "multiplier_grid",
    "plan_spectral_op",
    "solve_poisson",
    "spectral_gradient",
    "gaussian_filter",
    "fft_convolve",
]


@dataclass(frozen=True)
class SpectralOp:
    """A symbolic pointwise spectral multiplier. ``kind`` names the
    family, ``params`` is the hashable identity (two ops that could
    generate different multipliers never compare equal), ``payload`` the
    data left out of equality (a convolution kernel, whose digest is in
    ``params``; a custom generator, whose id is; a chain's member ops).
    Build instances through the constructors below."""

    kind: str
    params: tuple = ()
    payload: Any = field(default=None, compare=False, repr=False)

    @property
    def name(self) -> str:
        """Short label (``poisson``, ``gradient0``, ``helmholtz2.5``)."""
        if self.kind == "gradient":
            return f"gradient{self.params[0]}"
        if self.kind == "helmholtz":
            return f"helmholtz{self.params[0]:g}"
        if self.kind == "chain":
            return "chain(" + "+".join(o.name for o in self.payload) + ")"
        return self.kind


def poisson() -> SpectralOp:
    """Poisson solve ``laplacian(u) = f`` on the unit torus: multiplier
    ``-1/|k|^2``, the zero mode nulled (the solution is mean-free)."""
    return SpectralOp("poisson")


def biharmonic() -> SpectralOp:
    """Biharmonic solve ``laplacian(laplacian(u)) = f``: multiplier
    ``1/|k|^4``, the zero mode nulled; ``chain([poisson(), poisson()])``
    multiplier for multiplier, in one t_mid multiply."""
    return SpectralOp("biharmonic")


def helmholtz(shift: float) -> SpectralOp:
    """Helmholtz solve ``(shift - laplacian) u = f``: multiplier
    ``1/(shift + |k|^2)``; ``shift == 0`` is the negative Poisson solve
    (zero mode nulled)."""
    s = float(shift)
    if not s >= 0.0:
        raise ValueError(f"helmholtz shift must be >= 0, got {shift!r}")
    return SpectralOp("helmholtz", (s,))


def chain(ops: Sequence[SpectralOp]) -> SpectralOp:
    """The composition of diagonal ops: the product of their multipliers
    at one t_mid (one forward and one inverse transform for the set).
    A single op is itself."""
    ops = tuple(ops)
    if not ops:
        raise ValueError("chain() takes at least one SpectralOp")
    for o in ops:
        if not isinstance(o, SpectralOp):
            raise TypeError(
                f"chain() composes SpectralOp instances, got {o!r}")
    if len(ops) == 1:
        return ops[0]
    return SpectralOp("chain", tuple((o.kind, o.params) for o in ops),
                      payload=ops)


def gradient(axis: int = 0) -> SpectralOp:
    """Spectral derivative along ``axis``: multiplier ``i k_axis``."""
    if axis not in (0, 1, 2):
        raise ValueError(f"gradient axis must be 0, 1, or 2; got {axis}")
    return SpectralOp("gradient", (int(axis),))


def gaussian(sigma: float = 1.0) -> SpectralOp:
    """Gaussian low-pass filter: multiplier ``exp(-|k|^2 sigma^2 / 2)``."""
    if not sigma > 0:
        raise ValueError(f"gaussian sigma must be > 0, got {sigma}")
    return SpectralOp("gaussian", (float(sigma),))


def convolve(kernel) -> SpectralOp:
    """Circular convolution with ``kernel`` (a world-shaped array, numpy
    or torch): multiplier ``fftn(kernel)``, computed on the host at plan
    time and held once per plan on its device. The identity is the
    kernel's content digest (the JAX package's)."""
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().cpu().numpy()
    arr = np.asarray(kernel)
    digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
    return SpectralOp("convolve", (digest, arr.shape), payload=arr)


def custom(name: str, fn: Callable) -> SpectralOp:
    """A caller's multiplier generator: ``fn(i0, i1, i2)`` takes
    broadcastable int32 torch tensors of global indices (offset for the
    rank and chunk) and returns the factor (real or complex, a tensor or
    a scalar)."""
    if not callable(fn):
        raise TypeError("custom() takes a callable multiplier generator")
    return SpectralOp("custom", (str(name), id(fn)), payload=fn)


#: The driver tier's operator menu (``speed3d -op``).
OP_NAMES = ("poisson", "grad", "gauss", "biharm", "helmholtz")


def named_op(name: str, **kw) -> SpectralOp:
    """The operator spelled by name: ``poisson``, ``grad``/``gradient``
    (``axis=``), ``gauss``/``gaussian`` (``sigma=``), ``biharm``/
    ``biharmonic``, ``helmholtz`` (``shift=``, default 1.0)."""
    n = name.strip().lower()
    if n == "poisson":
        return poisson()
    if n in ("grad", "gradient"):
        return gradient(kw.pop("axis", 0))
    if n in ("gauss", "gaussian"):
        return gaussian(kw.pop("sigma", 1.0))
    if n in ("biharm", "biharmonic"):
        return biharmonic()
    if n == "helmholtz":
        return helmholtz(kw.pop("shift", 1.0))
    raise ValueError(
        f"unknown operator {name!r}; expected one of {OP_NAMES}")


def op_from_reference(op) -> SpectralOp:
    """The port's op for a JAX package ``SpectralOp``, read by its
    attributes (``kind``, ``params``, ``payload``) so both apply the same
    multiplier (a ``convolve`` kernel carried as numpy, a ``chain``
    member by member). A port op passes through. A ``custom`` op's
    generator is code of the other framework: it raises ``ValueError``
    (build the port's with :func:`custom`)."""
    if isinstance(op, SpectralOp):
        return op
    kind, params = op.kind, tuple(op.params)
    if kind in ("poisson", "biharmonic"):
        return SpectralOp(kind)
    if kind == "helmholtz":
        return helmholtz(params[0])
    if kind == "gradient":
        return gradient(params[0])
    if kind == "gaussian":
        return gaussian(params[0])
    if kind == "convolve":
        return convolve(np.asarray(op.payload))
    if kind == "chain":
        return chain([op_from_reference(o) for o in op.payload])
    if kind == "custom":
        raise ValueError(
            f"custom op {params[0]!r}: its generator runs in the other "
            f"framework; build the port's op with custom(name, fn) over "
            f"torch tensors")
    raise ValueError(f"unknown SpectralOp kind {kind!r}")


# ------------------------------------------------------- multiplier gen

def _multiplier_fn(op: SpectralOp, shape, cdtype: torch.dtype,
                   device=None) -> Callable:
    """The multiplier generator of ``op`` on a world of ``shape``:
    ``fn(i0, i1, i2)`` over broadcastable int32 global index grids, at
    the component precision of ``cdtype`` (float64 under complex128), on
    the grids' device. A ``convolve`` spectrum is made here once, on
    ``device``, and gathered by every rank's grids."""
    shape = tuple(int(s) for s in shape)
    rdt = REAL_DTYPE[cdtype]
    two_pi = 2.0 * math.pi

    def k_of(i, n):
        # signed integer frequency (numpy fftfreq * n), then angular
        f = torch.where(i < (n + 1) // 2, i, i - n).to(rdt)
        return f * torch.tensor(two_pi, dtype=rdt)

    def ks(i0, i1, i2):
        return (k_of(i0, shape[0]), k_of(i1, shape[1]), k_of(i2, shape[2]))

    def nulled(nz, v):
        return torch.where(nz, v, torch.zeros((), dtype=rdt,
                                              device=v.device))

    if op.kind == "poisson":

        def mult(i0, i1, i2):
            k0, k1, k2 = ks(i0, i1, i2)
            ksq = k0 * k0 + k1 * k1 + k2 * k2
            nz = ksq > 0
            return nulled(nz, -1.0 / torch.where(nz, ksq, 1.0))

        return mult
    if op.kind == "biharmonic":

        def mult(i0, i1, i2):
            k0, k1, k2 = ks(i0, i1, i2)
            ksq = k0 * k0 + k1 * k1 + k2 * k2
            nz = ksq > 0
            return nulled(nz, 1.0 / torch.where(nz, ksq * ksq, 1.0))

        return mult
    if op.kind == "helmholtz":
        shift = torch.tensor(op.params[0], dtype=rdt)

        def mult(i0, i1, i2):
            k0, k1, k2 = ks(i0, i1, i2)
            ksq = shift + k0 * k0 + k1 * k1 + k2 * k2
            if op.params[0] > 0:
                return 1.0 / ksq
            nz = ksq > 0       # shift 0: the mean-free Poisson convention
            return nulled(nz, 1.0 / torch.where(nz, ksq, 1.0))

        return mult
    if op.kind == "chain":
        fns = [_multiplier_fn(o, shape, cdtype, device) for o in op.payload]

        def mult(i0, i1, i2):
            m = fns[0](i0, i1, i2)
            for f in fns[1:]:
                m = m * f(i0, i1, i2)
            return m

        return mult
    if op.kind == "gradient":
        axis = op.params[0]

        def mult(i0, i1, i2):
            k = k_of((i0, i1, i2)[axis], shape[axis])
            return torch.complex(torch.zeros_like(k), k)

        return mult
    if op.kind == "gaussian":
        c = torch.tensor(-0.5 * op.params[0] * op.params[0], dtype=rdt)

        def mult(i0, i1, i2):
            k0, k1, k2 = ks(i0, i1, i2)
            return torch.exp(c * (k0 * k0 + k1 * k1 + k2 * k2))

        return mult
    if op.kind == "convolve":
        kernel = np.asarray(op.payload)
        if kernel.shape != shape:
            raise ValueError(
                f"convolve kernel shape {kernel.shape} != world {shape}")
        npdt = np.complex128 if cdtype == torch.complex128 else np.complex64
        khat = torch.from_numpy(np.fft.fftn(kernel).astype(npdt)).to(
            "cpu" if device is None else device)
        top = [n - 1 for n in shape]

        def mult(i0, i1, i2):
            # indices past the world (the ceil pads, cropped later) read
            # its edge, as the JAX package's gather clamps them
            return khat[i0.clamp(max=top[0]), i1.clamp(max=top[1]),
                        i2.clamp(max=top[2])]

        return mult
    if op.kind == "custom":
        return op.payload
    raise ValueError(f"unknown SpectralOp kind {op.kind!r}")


def _full_grids(shape, device) -> tuple:
    n0, n1, n2 = (int(s) for s in shape)
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=device)
    return ar(n0)[:, None, None], ar(n1)[None, :, None], ar(n2)[None, None, :]


def _cdtype(dtype) -> torch.dtype:
    dtype = torch.complex64 if dtype is None else dtype
    if dtype not in REAL_DTYPE:
        raise ValueError(
            f"dtype must be torch.complex64 or torch.complex128, got {dtype}")
    return dtype


def multiplier_grid(op: SpectralOp, shape, dtype=None,
                    device=None) -> torch.Tensor:
    """The op's whole world-shaped multiplier (the unfused composition's
    factor) on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    return _multiplier_fn(op, shape, _cdtype(dtype), dev)(
        *_full_grids(shape, dev))


# ------------------------------------------------------------- planner

def _single_runner(plan: OpPlan3D, mult: Callable) -> Callable:
    """The one-device operator: forward transform, the multiplier over
    the whole world, inverse transform (timed under t0, t_mid, t3)."""
    ex = get_executor(plan.executor)
    grids = _full_grids(plan.shape, plan.device)

    def run(x: torch.Tensor, timer) -> torch.Tensor:
        _check_shape(x, plan.in_shape, "plan input shape")
        x = x.contiguous()
        bo = x.dim() - 3
        axes = (bo, bo + 1, bo + 2)
        stage = (timer.stage if timer is not None
                 else lambda kind: contextlib.nullcontext())
        with stage("t0"):
            y = (run_donated(plan.executor, x, axes, True) if plan.donate
                 else ex(x, axes, True))
        with stage("t_mid"):
            y = apply_midpoint(y, mult, grids)
        with stage("t3"):
            return ex(y, axes, False)

    return run


def plan_spectral_op(
    shape: Sequence[int],
    world=None,
    *,
    op: SpectralOp,
    decomposition: str | None = None,
    executor: str = "cuda",
    dtype: torch.dtype = torch.complex64,
    device=None,
    donate: bool = False,
    algorithm: str = "alltoall",
    overlap_chunks: int | str | None = None,
    tune: str | None = None,
    wire_dtype: str | None = None,
    max_roundtrip_err: float | None = None,
    fuse: bool | None = None,
    options: PlanOptions | None = None,
    batch: int | None = None,
) -> OpPlan3D:
    """Plan one spectral operator: FFT -> pointwise ``op`` -> inverse FFT
    as one plan call, I/O in the chain's input layout on both sides (a
    unit multiplier is the identity). ``op`` is a :class:`SpectralOp` or
    a sequence of them (their :func:`chain`). ``world``, ``executor``,
    ``dtype``, ``device``, ``algorithm``, ``overlap_chunks``,
    ``wire_dtype``, ``fuse``, ``decomposition``, ``options``, ``donate``
    and ``batch`` as in :func:`.api.plan_dft_c2c_3d`. ``tune="wisdom"`` /
    ``"measure"`` (None: ``DFFT_TUNE``) runs the measured planner under
    the operator's own wisdom kind ``op:<name>`` (transform winners and
    operator winners never replay into each other), its compressed
    candidates admitted under ``max_roundtrip_err``;
    ``executor="auto"`` times each executor."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError("3D plans require a 3D shape")
    if isinstance(op, (list, tuple)):
        op = chain(op)
    if not isinstance(op, SpectralOp):
        raise TypeError(
            f"op must be a SpectralOp (poisson(), gradient(), ...) or "
            f"a sequence of them (operator chaining); got {op!r}")
    batch = _norm_batch(batch)
    opts = _resolve_options(options, executor, wire_dtype, fuse,
                            decomposition, algorithm, overlap_chunks, donate,
                            tune, max_roundtrip_err)
    if resolve_tune_mode(opts.tune) != "off":
        from . import tuner

        # an operator's two exchange legs and its midpoint move the
        # transport and K crossovers, so its winners are its own; under a
        # budget its wire axis is exact and bf16, as in the JAX op tier
        return tuner.tuned_plan(
            f"op:{op.name}", shape, world, opts,
            dict(dtype=_cdtype(dtype), device=device, batch=batch),
            plan_fn=functools.partial(plan_spectral_op, op=op),
            reduced=((None, "bf16"), (None,)))
    if opts.executor == "auto":
        return _api._auto_plan(
            functools.partial(plan_spectral_op, shape, world), opts, world,
            op=op, dtype=dtype, device=device, batch=batch)
    cdtype = _cdtype(dtype)
    device = resolve_device(device)
    lp = logic_plan3d(shape, world, opts, forward=True, batch=batch)
    lp = replace(lp, op=op.name)
    mult = _multiplier_fn(op, shape, cdtype, device)
    graph = spec = None
    wire = lp.wire_dtype
    kw = dict(executor=opts.executor, wire_dtype=wire,
              algorithm=lp.algorithm, overlap_chunks=lp.overlap_chunks,
              batch=batch)
    if lp.decomposition == "slab":
        graph, spec = build_slab_spectral_op(lp.world, shape, mult, **kw)
    elif lp.decomposition == "pencil":
        graph, spec = build_pencil_spectral_op(lp.world, shape, mult, **kw)
    else:
        wire = None                # no exchange, nothing to compress
    if graph is not None:
        graph.meta["fusion"] = plan_fusion(graph)
    # the chain's input layout on both sides: the caller's layout round
    # trip is what the operator saves
    boxes = io_boxes(lp, forward=True)[0]
    io_shape = shape if batch is None else (batch,) + shape
    plan = OpPlan3D(
        shape=shape, direction=FORWARD, dtype=cdtype,
        decomposition=lp.decomposition, executor=opts.executor,
        world=lp.world, device=device, wire_dtype=wire,
        algorithm=lp.algorithm, overlap_chunks=lp.overlap_chunks,
        options=replace(opts, decomposition=lp.decomposition,
                        overlap_chunks=lp.overlap_chunks, wire_dtype=wire),
        graph=graph, spec=spec, in_boxes=list(boxes),
        out_boxes=list(boxes), in_shape=io_shape, out_shape=io_shape,
        batch=batch, donate=opts.donate, logic=lp,
        op=op.name, op_spec=op, multiplier=mult)
    if graph is None:
        plan.runner = _single_runner(plan, mult)
    return plan


plan_spectral_op = _api._plan_cached("op", plan_spectral_op)


def solve_poisson(shape, world=None, **kw) -> OpPlan3D:
    """Poisson solver plan: ``plan(f)`` is the mean-free u with
    ``laplacian(u) = f - mean(f)`` on the unit torus."""
    return plan_spectral_op(shape, world, op=poisson(), **kw)


def spectral_gradient(shape, world=None, *, axis: int = 0,
                      **kw) -> OpPlan3D:
    """Spectral derivative plan along ``axis`` (multiplier ``i k``)."""
    return plan_spectral_op(shape, world, op=gradient(axis), **kw)


def gaussian_filter(shape, world=None, *, sigma: float = 1.0,
                    **kw) -> OpPlan3D:
    """Gaussian filter plan (multiplier ``exp(-|k|^2 sigma^2 / 2)``)."""
    return plan_spectral_op(shape, world, op=gaussian(sigma), **kw)


def fft_convolve(shape, world=None, *, kernel, **kw) -> OpPlan3D:
    """Circular convolution plan with a world-shaped ``kernel``."""
    return plan_spectral_op(shape, world, op=convolve(kernel), **kw)
