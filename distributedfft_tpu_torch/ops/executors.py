"""Local FFT executors: ``fn(x, axes, forward) -> y``, C2C over ``axes``,
forward unnormalized and inverse scaled 1/N (numpy convention), and the
real pair ``r2c(x, axis)`` / ``c2r(y, n, axis)``.

The port of the registry and scaling of ``distributedfft_tpu/ops/
executors.py`` and of its ``pallas`` executor, registered here as
``"cuda"``: a trailing 2D plane goes to the plane kernel, every other axis
to :func:`.cuda_fft.fft_along_axis`. It is the port's default and, in
this slice, its only executor. ``cuda:fuse`` names the same executor with
the stage-fusion flag, which the stage graph's fusion pass reads.
"""

from __future__ import annotations

import enum
from typing import Callable, Sequence

import torch

from . import cuda_fft
from .realfft import (c2r_via_half_complex, mirror_half_spectrum,
                      r2c_via_half_complex)

ExecutorFn = Callable[[torch.Tensor, Sequence[int], bool], torch.Tensor]

_REGISTRY: dict[str, ExecutorFn] = {}
_R2C_REGISTRY: dict[str, Callable] = {}
_C2R_REGISTRY: dict[str, Callable] = {}


class Scale(enum.Enum):
    """Result scaling (heFFTe's none/full; symmetric is not ported)."""

    NONE = "none"
    FULL = "full"


def scale_factor(scale: Scale, world_size: int) -> float:
    return 1.0 / world_size if scale == Scale.FULL else 1.0


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


def register_executor(name: str, fn: ExecutorFn) -> None:
    _REGISTRY[name] = fn


def register_real_executor(name: str, r2c: Callable, c2r: Callable) -> None:
    _R2C_REGISTRY[name] = r2c
    _C2R_REGISTRY[name] = c2r


def _lookup(table: dict, name: str):
    try:
        return table[split_fuse(name)[0]]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; available: {sorted(table)}"
        ) from None


def get_executor(name: str) -> ExecutorFn:
    return _lookup(_REGISTRY, name)


def get_r2c(name: str) -> Callable:
    return _lookup(_R2C_REGISTRY, name)


def get_c2r(name: str) -> Callable:
    return _lookup(_C2R_REGISTRY, name)


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


def _cuda_r2c(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Real-to-complex along ``axis``: the half-length packed transform
    for even n > 2, else promote to complex64, transform, slice."""
    n = x.shape[axis]
    if n % 2 == 0 and n > 2 and not x.is_complex():
        return r2c_via_half_complex(x, axis, cuda_fft.fft_along_axis)
    if not x.is_complex():
        x = x.to(torch.complex128 if x.element_size() >= 8
                 else torch.complex64)
    y = cuda_fft.fft_along_axis(x.contiguous(), axis, True)
    return y.narrow(axis % y.ndim, 0, n // 2 + 1)


def _cuda_c2r(y: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Complex-to-real back to extent ``n`` along ``axis``, scaled 1/n."""
    if n % 2 == 0 and n > 2:
        return c2r_via_half_complex(y, n, axis, cuda_fft.fft_along_axis)
    full = mirror_half_spectrum(y, n, axis=axis)
    return cuda_fft.fft_along_axis(full.contiguous(), axis, False).real


register_executor("cuda", _cuda_executor)
register_real_executor("cuda", _cuda_r2c, _cuda_c2r)
