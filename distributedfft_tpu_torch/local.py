"""Batched local (one-device) 1D, 2D and 3D transforms.

The port of ``distributedfft_tpu/local.py``: a :class:`LocalPlan` is the
batched C2C transform of the trailing ``rank`` axes of a
``[batch, *shape]`` tensor through one executor. It runs on the card
unless ``device`` names another. With ``donate=True`` the plan may use
its input's storage as workspace: the executor's first pass writes into
it (its contents afterwards unspecified), the result the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from .api import resolve_device
from .geometry import fft_flops
from .ops.executors import Scale, apply_scale, get_executor, run_donated

FORWARD = -1
BACKWARD = +1


@dataclass
class LocalPlan:
    """A batched C2C transform over the trailing axes."""

    shape: tuple[int, ...]
    batch: int
    direction: int
    dtype: torch.dtype
    executor: str
    device: torch.device
    donate: bool = False

    @property
    def forward(self) -> bool:
        return self.direction == FORWARD

    @property
    def transform_size(self) -> int:
        return math.prod(self.shape)

    def flops(self) -> float:
        """5 N log2 N per transform times the batch count."""
        return fft_flops(self.shape) * self.batch

    def __call__(self, x, *, scale: Scale = Scale.NONE) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        expect = (self.batch,) + self.shape
        if tuple(x.shape) != expect:
            raise ValueError(
                f"plan input shape is {expect}, got {tuple(x.shape)}")
        axes = tuple(range(1, 1 + len(self.shape)))
        if self.donate:
            y = run_donated(self.executor, x.contiguous(), axes, self.forward)
        else:
            y = get_executor(self.executor)(x.contiguous(), axes,
                                            self.forward)
        return apply_scale(y, scale, self.transform_size)


def plan_dft_c2c(shape: Sequence[int] | int, *, batch: int = 1,
                 direction: int = FORWARD, executor: str = "cuda",
                 dtype: torch.dtype = torch.complex64,
                 device=None, donate: bool = False) -> LocalPlan:
    """Plan a batched local C2C FFT of rank ``len(shape)`` (1, 2 or 3):
    input and output ``[batch, *shape]``, the transform over the
    trailing axes. Forward unnormalized, backward scaled 1/N;
    ``donate`` as in the module docstring."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if not 1 <= len(shape) <= 3:
        raise ValueError("plan_dft_c2c supports rank 1..3 transforms")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError("direction must be FORWARD (-1) or BACKWARD (+1)")
    get_executor(executor)
    return LocalPlan(shape=shape, batch=int(batch), direction=direction,
                     dtype=dtype, executor=executor,
                     device=resolve_device(device), donate=bool(donate))


def plan_dft_c2c_1d(n: int, **kw) -> LocalPlan:
    """Batched 1D plan."""
    return plan_dft_c2c((n,), **kw)


def plan_dft_c2c_2d(shape: Sequence[int], **kw) -> LocalPlan:
    """Batched 2D plan."""
    if len(tuple(shape)) != 2:
        raise ValueError("plan_dft_c2c_2d requires a 2D shape")
    return plan_dft_c2c(shape, **kw)
