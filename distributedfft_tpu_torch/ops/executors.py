"""Local FFT executors: ``fn(x, axes, forward) -> y``, C2C over ``axes``,
forward unnormalized and inverse scaled 1/N (numpy convention).

The port of the registry and scaling of ``distributedfft_tpu/ops/
executors.py`` and of its ``pallas`` executor, registered here as
``"cuda"``: a trailing 2D plane goes to the plane kernel, every other axis
to :func:`.cuda_fft.fft_along_axis`. It is the port's default and, in
this slice, its only executor.
"""

from __future__ import annotations

import enum
from typing import Callable, Sequence

import torch

from . import cuda_fft

ExecutorFn = Callable[[torch.Tensor, Sequence[int], bool], torch.Tensor]

_REGISTRY: dict[str, ExecutorFn] = {}


class Scale(enum.Enum):
    """Result scaling (heFFTe's none/full; symmetric is not ported)."""

    NONE = "none"
    FULL = "full"


def scale_factor(scale: Scale, world_size: int) -> float:
    return 1.0 / world_size if scale == Scale.FULL else 1.0


def apply_scale(x: torch.Tensor, scale: Scale, world_size: int) -> torch.Tensor:
    s = scale_factor(scale, world_size)
    return x if s == 1.0 else x * s


def register_executor(name: str, fn: ExecutorFn) -> None:
    _REGISTRY[name] = fn


def get_executor(name: str) -> ExecutorFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


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
