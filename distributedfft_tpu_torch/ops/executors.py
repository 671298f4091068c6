"""Local FFT executors: ``fn(x, axes, forward) -> y``, C2C over ``axes``,
forward unnormalized and inverse scaled 1/N (numpy convention), and the
real pair ``r2c(x, axis)`` / ``c2r(y, n, axis)``.

The port of the registry, label algebra and scaling of
``distributedfft_tpu/ops/executors.py``. Executors:

- ``"cuda"`` (the JAX package's ``pallas``, the port's default): a
  trailing 2D plane goes to the plane kernel, every other axis to
  :func:`.cuda_fft.fft_along_axis`, which falls back to
  :mod:`.dft_matmul` by the JAX package's routing rules; its real pair
  is :func:`.cuda_fft.r2c_half` / :func:`.cuda_fft.c2r_half` (one fused
  rows pass each way on the card where the half length allows);
- ``"matmul"``: the DFT by matmuls of :mod:`.dft_matmul`;
- ``"torch"`` (the JAX package's ``xla``): ``torch.fft``;
- ``"torch_minor"`` (the JAX package's ``xla_minor``): ``torch.fft`` one
  axis at a time, each moved to the last axis first (a layout
  candidate of the ``executor="auto"`` tournament; the same values).

Axes the call does not name ride in each kernel's own batch axis (the
plane kernel's planes, the strided kernel's ``lead``, the row kernel's
rows), so a batched plan's ``[B, ...]`` stage, over axes (1, 2, 3) on
one device, launches each kernel once, as its unbatched twin does.
:func:`run_donated` runs an executor with its input as workspace.

Labels compose: ``matmul:bf16`` / ``:f32`` / ``:highest`` scope the
matmul products' precision tier over the call, ``:gauss`` the
three-product complex mode, ``cuda:fuse`` asks the stage graph's fusion
pass to fuse the wire codec into the stages beside each exchange (it
never changes the local executor).
"""

from __future__ import annotations

import enum
import functools
import math
from typing import Callable, Sequence

import torch

from . import cuda_fft, dft_matmul
from .realfft import (c2r_via_half_complex, mirror_half_spectrum,
                      r2c_via_half_complex)

ExecutorFn = Callable[[torch.Tensor, Sequence[int], bool], torch.Tensor]

_REGISTRY: dict[str, ExecutorFn] = {}
_R2C_REGISTRY: dict[str, Callable] = {}
_C2R_REGISTRY: dict[str, Callable] = {}

#: Accuracy tiers of the matmul-family executors, in descending-error
#: order (:mod:`.dft_matmul` says what each is on the card).
MM_TIERS = ("bf16", "f32", "highest")

#: Tier label -> the :func:`.dft_matmul.mm_precision` name the scope pins.
TIER_PRECISION = {"bf16": "default", "f32": "high", "highest": "highest"}

#: The JAX lax spellings of the tiers (``matmul:high`` == ``matmul:f32``).
TIER_ALIASES = {"default": "bf16", "high": "f32"}

#: Bases whose products read the tier (``cuda`` through its matmul
#: fallback).
MM_EXECUTOR_BASES = ("matmul", "cuda")

#: Complex-product modes accepted as a suffix (``native`` is the default).
MM_COMPLEX_MODES = ("native", "gauss")

#: Tiers below the exact default: the ones that cost accuracy and are
#: admitted against a plan's ``max_roundtrip_err`` budget (``highest`` is
#: the bare label's tier).
REDUCED_TIERS = ("bf16", "f32")


class Scale(enum.Enum):
    """Result scaling: heFFTe's none / full (1/N) / symmetric (1/sqrt N)."""

    NONE = "none"
    FULL = "full"
    SYMMETRIC = "symmetric"


def scale_factor(scale: Scale, world_size: int) -> float:
    if scale == Scale.NONE:
        return 1.0
    if scale == Scale.FULL:
        return 1.0 / world_size
    return 1.0 / math.sqrt(world_size)


def apply_scale(x: torch.Tensor, scale: Scale, world_size: int) -> torch.Tensor:
    s = scale_factor(scale, world_size)
    return x if s == 1.0 else x * s


#: The stage-fusion flag token: ``cuda:fuse`` asks the stage graph's
#: fusion pass (``stagegraph.plan_fusion``) to fuse the wire codec into
#: the stages beside each exchange. It never changes the local executor.
FUSE_SUFFIX = "fuse"

#: Bases the fuse flag composes with (those with fused kernels).
FUSE_BASES = ("cuda",)


def split_fuse(name: str) -> tuple[str, bool]:
    """Strip the ``:fuse`` flag off an executor label: ``"cuda:fuse" ->
    ("cuda", True)``; unfused labels return ``(name, False)``. The flag
    may ride only a :data:`FUSE_BASES` base, and at most once."""
    if ":" not in name:
        return name, False
    base, *mods = name.split(":")
    hits = mods.count(FUSE_SUFFIX)
    if hits == 0:
        return name, False
    if hits > 1:
        raise ValueError(f"executor {name!r} repeats the fuse flag")
    if base not in FUSE_BASES:
        raise ValueError(
            f"the :fuse flag applies to {FUSE_BASES} executors, "
            f"got {name!r}")
    rest = [m for m in mods if m != FUSE_SUFFIX]
    return ":".join([base] + rest), True


def fused_name(name: str, fuse: bool | None = None) -> str:
    """Compose the fuse flag onto a label. ``None`` keeps the label's own
    flag; ``True`` adds it (idempotent); ``False`` with a label that pins
    ``:fuse`` raises. The canonical form carries ``:fuse`` last."""
    bare, have = split_fuse(name)
    if fuse is None:
        fuse = have
    elif have and not fuse:
        raise ValueError(
            f"executor {name!r} already pins the fuse flag; "
            f"conflicting request fuse=False")
    if not fuse:
        return bare
    if bare.split(":", 1)[0] not in FUSE_BASES:
        raise ValueError(
            f"the fuse tier applies to {FUSE_BASES} executors, "
            f"got {name!r}")
    return bare + f":{FUSE_SUFFIX}"


def split_executor(name: str) -> tuple[str, str | None, str | None]:
    """Parse a (possibly tiered) label into ``(base, tier,
    complex_mode)``: ``"matmul:bf16:gauss" -> ("matmul", "bf16",
    "gauss")``; bare names give ``(name, None, None)``. Lax spellings
    normalise (``matmul:high -> ("matmul", "f32", None)``). Validates the
    suffixes and that the base reads the tier; the base need not be
    registered."""
    name, _ = split_fuse(name)
    if ":" not in name:
        return name, None, None
    base, *mods = name.split(":")
    tier: str | None = None
    cmode: str | None = None
    for m in mods:
        if m in MM_TIERS or m in TIER_ALIASES:
            if tier is not None:
                raise ValueError(
                    f"executor {name!r} names two precision tiers")
            tier = TIER_ALIASES.get(m, m)
        elif m in MM_COMPLEX_MODES:
            if cmode is not None:
                raise ValueError(
                    f"executor {name!r} repeats the complex mode")
            cmode = m
        else:
            raise ValueError(
                f"unknown executor suffix {m!r} in {name!r}; tiers: "
                f"{MM_TIERS} (or lax spellings {sorted(TIER_ALIASES)}), "
                f"complex modes: {MM_COMPLEX_MODES}")
    if not base.startswith(MM_EXECUTOR_BASES):
        raise ValueError(
            f"executor {base!r} does not consult the matmul precision "
            f"knobs; tier suffixes apply to {MM_EXECUTOR_BASES}")
    return base, tier, cmode


def tiered_name(base: str, precision: str | None = None,
                complex_mode: str | None = None) -> str:
    """Compose the canonical tiered label from a base and tier choices.
    Idempotent; a tier or mode that conflicts with the base's own
    raises. ``None`` leaves the label bare."""
    base, have_fuse = split_fuse(base)
    b, have_tier, have_cmode = (split_executor(base) if ":" in base
                                else (base, None, None))
    if precision is not None:
        precision = TIER_ALIASES.get(precision, precision)
    for what, have, want in (("precision tier", have_tier, precision),
                             ("complex mode", have_cmode, complex_mode)):
        if have is not None and want is not None and have != want:
            raise ValueError(
                f"executor {base!r} already pins {what} {have!r}; "
                f"conflicting request {want!r}")
    tier = precision if precision is not None else have_tier
    cmode = complex_mode if complex_mode is not None else have_cmode
    if tier is not None and tier not in MM_TIERS:
        raise ValueError(
            f"mm_precision must be one of {MM_TIERS} or None, got {tier!r}")
    if cmode is not None and cmode not in MM_COMPLEX_MODES:
        raise ValueError(
            f"mm_complex must be one of {MM_COMPLEX_MODES} or None, "
            f"got {cmode!r}")
    if cmode == "native":
        cmode = None
    if tier is None and cmode is None:
        return fused_name(b, have_fuse) if have_fuse else b
    name = b + (f":{tier}" if tier else "") + (f":{cmode}" if cmode else "")
    split_executor(name)
    return fused_name(name, have_fuse) if have_fuse else name


def _scoped(fn: Callable, tier: str | None, cmode: str | None) -> Callable:
    """``fn`` with its calls inside the tier's :func:`.dft_matmul.mm_scope`."""
    if tier is None and cmode is None:
        return fn
    prec = TIER_PRECISION[tier] if tier is not None else None

    @functools.wraps(fn)
    def scoped(*args, **kw):
        with dft_matmul.mm_scope(precision=prec, complex_mode=cmode):
            return fn(*args, **kw)

    return scoped


def register_executor(name: str, fn: ExecutorFn) -> None:
    _REGISTRY[name] = fn


def register_real_executor(name: str, r2c: Callable, c2r: Callable) -> None:
    _R2C_REGISTRY[name] = r2c
    _C2R_REGISTRY[name] = c2r


def get_executor(name: str) -> ExecutorFn:
    if ":" in name:
        base, tier, cmode = split_executor(name)
        return _scoped(get_executor(base), tier, cmode)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_executors() -> list[str]:
    """The executors a plan's ``executor=`` takes; a name starting with
    ``_`` is internal (the dd tier's ``_dd``) and not listed."""
    return sorted(n for n in _REGISTRY if not n.startswith("_"))


def get_r2c(name: str) -> Callable:
    """The real-to-complex transform of executor ``name``; an
    unregistered name takes the ``torch`` pair, as the JAX package falls
    back to its ``xla`` pair."""
    if ":" in name:
        base, tier, cmode = split_executor(name)
        return _scoped(get_r2c(base), tier, cmode)
    return _R2C_REGISTRY.get(name, _torch_r2c)


def get_c2r(name: str) -> Callable:
    """The complex-to-real transform of executor ``name`` (see
    :func:`get_r2c`)."""
    if ":" in name:
        base, tier, cmode = split_executor(name)
        return _scoped(get_c2r(base), tier, cmode)
    return _C2R_REGISTRY.get(name, _torch_c2r)


_EXEC_ERR_CACHE: dict = {}


def executor_roundtrip_error(name: str, dtype, n: int = 256, *,
                             sample=None, device=None) -> float:
    """Relative round-trip error of one forward + inverse pass of a
    reduced-precision tiered executor (``max |ifft(fft(x)) - x| / max
    |x|`` over a seeded standard-normal ``(8, n)`` block, the seed and
    block of the JAX package's), the number the tuner admits a
    ``matmul:bf16`` candidate against. 0.0 for bare labels and exact
    tiers. Measured on ``device`` through :func:`..api.resolve_device`
    (the card unless the caller names another; without a card it
    raises; on the CPU every tier is the full-precision product, as on
    JAX's CPU backend) and cached per (label, dtype, n, device). The
    callers pass the device of the plan or candidates they price.
    ``sample`` (an ``(8, n)``-reshapeable block) measures on the
    caller's data instead, cached by its digest. ``dtype`` is a numpy or
    torch complex dtype or its name."""
    if ":" not in name:
        return 0.0
    _, tier, _ = split_executor(name)
    if tier not in REDUCED_TIERS:
        return 0.0
    import hashlib

    import numpy as np

    from ..api import resolve_device
    from ..parallel.exchange import np_dtype

    ndt = np_dtype(dtype)
    device = resolve_device(device)
    if sample is not None:
        x = np.asarray(sample, dtype=ndt).reshape(8, -1)
        digest = hashlib.sha256(x.tobytes()).hexdigest()[:16]
        key = (name, str(ndt), x.shape[1], device.type, digest)
    else:
        x = None
        key = (name, str(ndt), int(n), device.type)
    hit = _EXEC_ERR_CACHE.get(key)
    if hit is not None:
        return hit
    if x is None:
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((8, n))
             + 1j * rng.standard_normal((8, n))).astype(ndt)
    fn = get_executor(name)
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    y = fn(fn(t, (1,), True), (1,), False).cpu().numpy()
    err = float(np.max(np.abs(y - x)) / np.max(np.abs(x)))
    _EXEC_ERR_CACHE[key] = err
    return err


# ------------------------------------------------------------- torch

def _torch_executor(x: torch.Tensor, axes: Sequence[int],
                    forward: bool = True) -> torch.Tensor:
    """``torch.fft.fftn`` / ``ifftn`` over ``axes``."""
    fn = torch.fft.fftn if forward else torch.fft.ifftn
    return fn(x, dim=tuple(axes))


def _torch_r2c(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.fft.rfft(x, dim=axis)


def _torch_c2r(y: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    return torch.fft.irfft(y, n=n, dim=axis)


register_executor("torch", _torch_executor)
register_real_executor("torch", _torch_r2c, _torch_c2r)


def _torch_minor_executor(x: torch.Tensor, axes: Sequence[int],
                          forward: bool = True) -> torch.Tensor:
    """``torch.fft`` one axis at a time, each moved to the last axis
    first and back after (the JAX package's ``xla_minor``): the same
    transform as ``torch`` with the transposes placed by hand, for the
    tournament to measure."""
    fft = torch.fft.fft if forward else torch.fft.ifft
    last = x.ndim - 1
    for ax in tuple(a % x.ndim for a in axes):
        if ax == last:
            x = fft(x, dim=-1)
        else:
            x = fft(x.movedim(ax, -1).contiguous(), dim=-1).movedim(-1, ax)
    return x


register_executor("torch_minor", _torch_minor_executor)


# ------------------------------------------------------------ matmul

def _matmul_executor(x: torch.Tensor, axes: Sequence[int],
                     forward: bool = True) -> torch.Tensor:
    for ax in tuple(axes):
        x = dft_matmul.fft_along_axis(x, ax, forward)
    return x


def _half_or_promote_r2c(x: torch.Tensor, axis: int, half,
                         c2c) -> torch.Tensor:
    """Real-to-complex along ``axis``: the half-length packed transform
    ``half(x, axis)`` for even n > 2, else promote (to complex128 from
    8-byte reals), transform through the C2C ``c2c``, slice."""
    n = x.shape[axis]
    if n % 2 == 0 and n > 2 and not x.is_complex():
        return half(x, axis)
    if not x.is_complex():
        x = x.to(torch.complex128 if x.element_size() >= 8
                 else torch.complex64)
    y = c2c(x.contiguous(), axis, True)
    return y.narrow(axis % y.ndim, 0, n // 2 + 1)


def _half_or_mirror_c2r(y: torch.Tensor, n: int, axis: int, half,
                        c2c) -> torch.Tensor:
    """Complex-to-real back to extent ``n`` along ``axis``, scaled 1/n:
    the half-length packed inverse ``half(y, n, axis)`` for even n > 2,
    else the mirrored full spectrum through the inverse C2C ``c2c``."""
    if n % 2 == 0 and n > 2:
        return half(y, n, axis)
    full = mirror_half_spectrum(y, n, axis=axis)
    return c2c(full.contiguous(), axis, False).real


register_executor("matmul", _matmul_executor)
register_real_executor(
    "matmul",
    lambda x, axis: _half_or_promote_r2c(
        x, axis, functools.partial(r2c_via_half_complex,
                                   c2c=dft_matmul.fft_along_axis),
        dft_matmul.fft_along_axis),
    lambda y, n, axis: _half_or_mirror_c2r(
        y, n, axis, functools.partial(c2r_via_half_complex,
                                      c2c=dft_matmul.fft_along_axis),
        dft_matmul.fft_along_axis))


# -------------------------------------------------------------- cuda

def _cuda_executor(x: torch.Tensor, axes: Sequence[int],
                   forward: bool = True) -> torch.Tensor:
    axes = tuple(a % x.ndim for a in axes)
    if (len(axes) >= 2 and x.dtype == torch.complex64 and x.numel() > 0
            and {axes[-2], axes[-1]} == {x.ndim - 2, x.ndim - 1}):
        if cuda_fft.eligible2d(x.shape[-2], x.shape[-1]):
            shape = x.shape
            x = cuda_fft.fft2_last(
                x.reshape((-1,) + tuple(shape[-2:])).contiguous(), forward)
            x = x.reshape(shape)
            axes = axes[:-2]
        else:
            cuda_fft.record_fallback(axes[-1], "plane2d")
    for ax in axes:
        x = cuda_fft.fft_along_axis(x, ax, forward)
    return x


register_executor("cuda", _cuda_executor)


def first_pass(name: str, x: torch.Tensor,
               axes: Sequence[int]) -> tuple[tuple, tuple]:
    """(axes of the first pass, the rest) of executor ``name`` over
    ``axes`` of ``x``: the ``cuda`` executor's trailing plane (or its
    first axis), the ``matmul`` executor's first axis, every axis at
    once for ``torch``. Running the first pass, then the rest, is the
    executor's own order, so a donated input can take the first pass's
    output (:func:`run_donated`) and give the same bits."""
    base = split_fuse(name)[0].split(":", 1)[0]
    axes = tuple(a % x.ndim for a in axes)
    if base == "cuda":
        if (len(axes) >= 2 and x.dtype == torch.complex64 and x.numel() > 0
                and {axes[-2], axes[-1]} == {x.ndim - 2, x.ndim - 1}
                and cuda_fft.eligible2d(x.shape[-2], x.shape[-1])):
            return axes[-2:], axes[:-2]
        return axes[:1], axes[1:]
    if base == "matmul":
        return axes[:1], axes[1:]
    return axes, ()


def run_donated(name: str, x: torch.Tensor, axes: Sequence[int],
                forward: bool) -> torch.Tensor:
    """Executor ``name`` over ``axes`` with ``x`` as workspace: the first
    pass's output is written into ``x`` (whose contents are then
    unspecified) and the rest run from there. Bit-identical to
    ``get_executor(name)(x, axes, forward)``."""
    ex = get_executor(name)
    head, rest = first_pass(name, x, axes)
    x.copy_(ex(x, head, forward))
    return ex(x, rest, forward) if rest else x
register_real_executor(
    "cuda",
    lambda x, axis: _half_or_promote_r2c(x, axis, cuda_fft.r2c_half,
                                         cuda_fft.fft_along_axis),
    lambda y, n, axis: _half_or_mirror_c2r(y, n, axis, cuda_fft.c2r_half,
                                           cuda_fft.fft_along_axis))
