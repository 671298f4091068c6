"""Emulated double precision: the 1e-11 accuracy tier as (hi, lo) pairs.

The port of ``distributedfft_tpu/ops/ddfft.py``. The reference's
accuracy bar is double precision at 1e-11 (heFFTe's test gate). The JAX
package reaches it on a TPU, which has no float64, by storing a value as
the unevaluated pair ``hi + lo`` of two complex64 (float32 on the real
side), about 49 significand bits, and building every DFT from exact bf16
slices on the matrix unit. The port keeps the pair as the tier's
interface (its host conversion, its I/O and its 1e-11 gate) and changes
only the device math: the H100 has native FP64, so a dd transform joins
the pair into complex128, transforms it, and splits the result back::

    join:  y = hi.to(c128) + lo.to(c128)         (exact in f64)
    split: hi = y.to(c64); lo = (y - hi.to(c128)).to(c64)

The transforms are the ``torch`` executor's (``torch.fft``, cuFFT Z2Z on
the card); complex128 on the ``cuda`` executor would take the dense
``dft_matmul`` fallback. A real forward transform is ``torch.fft.rfft``
along the last axis, its inverse ``torch.fft.irfft``: the same values as
the JAX package's full complex DFT and slice, not the same bits.

The coverage rule is the JAX tier's: a length above :data:`DD_DENSE_MAX`
needs a factor pair with both factors <= 512 (its dd four-step) or a
Bluestein pad of at most 512^2 (its dd Bluestein); any other length is
refused with the JAX package's ``ValueError``. The port adds no length.

Range: the tier holds for magnitudes in about [1e-25, 3e38], as the JAX
package states: below it ``lo`` turns subnormal (which the TPU flushes;
on the card and the CPU it keeps fewer bits), and an output past the
float32 maximum is ``inf`` in ``hi`` (with ``lo`` zero).

The JAX package's slicing internals (``_extract_slices``,
``_w_slices_np``, the two-float arithmetic, its four-step and Bluestein
bodies and the ``DFFT_DD_DEPTH`` knob) have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .. import native
from .executors import (get_c2r, get_executor, get_r2c,
                        register_executor, register_real_executor)
from .realfft import mirror_half_spectrum  # noqa: F401  (the tier's home)

#: Largest axis length the JAX tier's dense dd DFT covers; longer axes
#: need a dense-coverable four-step split or a Bluestein pad.
DD_DENSE_MAX = 512
_DD_BLUESTEIN_MAX_M = DD_DENSE_MAX * DD_DENSE_MAX

#: The executor of the functions below: ``torch.fft`` at complex128.
ENGINE = "torch"
#: The executor of the dd plans' chains (registered below; internal, so
#: not among ``available_executors()``).
PLAN_EXECUTOR = "_dd"

_WIDE = {torch.complex64: torch.complex128, torch.float32: torch.float64}
_NARROW = {torch.complex128: torch.complex64, torch.float64: torch.float32}


def _dd_split(n: int) -> tuple[int, int] | None:
    """The JAX tier's four-step split: a balanced factor pair with both
    factors <= :data:`DD_DENSE_MAX`, or None."""
    return native.balanced_split(n, DD_DENSE_MAX)


def _dd_bluestein_m(n: int) -> int | None:
    """The JAX tier's Bluestein pad (the power of two >= 2n - 1), or None
    past 512^2."""
    m = 1
    while m < 2 * n - 1:
        m *= 2
    return m if m <= _DD_BLUESTEIN_MAX_M else None


def dd_covers(n: int) -> bool:
    """Whether the JAX tier transforms an axis of length ``n``."""
    return (n <= DD_DENSE_MAX or _dd_split(n) is not None
            or _dd_bluestein_m(n) is not None)


def _check_length(n: int) -> None:
    if not dd_covers(n):
        raise ValueError(
            f"dd executor: no n1*n2 split of {n} with both factors "
            f"<= {DD_DENSE_MAX}, and the Bluestein pad 2^ceil(log2(2n-1)) "
            f"exceeds {_DD_BLUESTEIN_MAX_M} — prime axes above "
            f"{_DD_BLUESTEIN_MAX_M // 2} are out of dd scope")


# ------------------------------------------------ the plans' executor

def _per_item(fn: Callable) -> Callable:
    """A ``torch`` executor function applied to each 3D item of a block
    with leading batch dims, each item contiguous, so that a batched plan
    computes every item as its unbatched twin does, bit for bit
    (``torch.fft`` may compute a strided batch of lines differently from
    one item's)."""

    def run(x: torch.Tensor, *args):
        lead = x.dim() - 3
        if lead <= 0:
            return fn(x.contiguous(), *args)
        items = x.reshape((-1,) + tuple(x.shape[lead:]))
        outs = [fn(items[i].contiguous(), *_shift(args, lead))
                for i in range(items.shape[0])]
        return torch.stack(outs).reshape(tuple(x.shape[:lead])
                                         + tuple(outs[0].shape))

    return run


def _shift(args: tuple, lead: int) -> tuple:
    """The axis arguments of an executor call moved ``lead`` dims down:
    a tuple of axes first (``fft``), an axis last (``r2c`` / ``c2r``)."""
    head, *rest = args
    if isinstance(head, (tuple, list)):
        return (tuple(a - lead for a in head), *rest)
    *front, axis = args
    return (*front, axis - lead)


register_executor(PLAN_EXECUTOR, _per_item(get_executor(ENGINE)))
register_real_executor(PLAN_EXECUTOR, _per_item(get_r2c(ENGINE)),
                       _per_item(get_c2r(ENGINE)))


# ------------------------------------------------------------ pairs

def dd_from_host(x, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-float split of a host float64/complex128 array into (hi,
    lo) float32/complex64 tensors on ``device`` (the card unless another
    is named): ``hi = f32(x)``, ``lo = f32(x - hi)``, as the JAX
    package splits it. ``lo`` itself rounds, so the pair carries ~49
    significand bits."""
    from ..api import resolve_device

    x = np.asarray(x)
    if np.iscomplexobj(x):
        hi = x.astype(np.complex64)
        lo = (x - hi.astype(np.complex128)).astype(np.complex64)
    else:
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
    dev = resolve_device(device)
    return (torch.from_numpy(np.ascontiguousarray(hi)).to(dev),
            torch.from_numpy(np.ascontiguousarray(lo)).to(dev))


def dd_to_host(hi, lo) -> np.ndarray:
    """A (hi, lo) pair as one host float64/complex128 array (the exact
    sum)."""
    h = hi.detach().cpu().numpy() if isinstance(hi, torch.Tensor) else \
        np.asarray(hi)
    lo = lo.detach().cpu().numpy() if isinstance(lo, torch.Tensor) else \
        np.asarray(lo)
    wide = np.complex128 if np.iscomplexobj(h) else np.float64
    return h.astype(wide) + lo.astype(wide)


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The pair's value in complex128 (float64 on the real side); exact."""
    if hi.dtype not in _WIDE or lo.dtype != hi.dtype:
        raise ValueError(
            f"a dd pair is two complex64 (or two float32) tensors, got "
            f"{hi.dtype} and {lo.dtype}")
    return hi.to(_WIDE[hi.dtype]).add_(lo)


def split(y: torch.Tensor, out=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A complex128 (float64) tensor as its (hi, lo) pair, ``y`` used as
    workspace (its contents afterwards are the residual ``y - hi``).
    Where ``hi`` overflows to ``inf``, ``lo`` is 0. ``out``: a pair of
    tensors of the result's shape and dtypes to write into."""
    hi = y.to(_NARROW[y.dtype])
    lo = y.sub_(hi).to(hi.dtype)
    if hi.is_complex():
        hr, lr = torch.view_as_real(hi), torch.view_as_real(lo)
    else:
        hr, lr = hi, lo
    lr.masked_fill_(~torch.isfinite(hr), 0.0)
    if out is None:
        return hi, lo
    out[0].copy_(hi)
    out[1].copy_(lo)
    return out


# ------------------------------------------------------- transforms

def fft_axis_dd(hi: torch.Tensor, lo: torch.Tensor, axis: int,
                forward: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """dd complex DFT along ``axis`` of a complex64 (hi, lo) pair:
    forward unnormalized, inverse scaled 1/n (numpy convention)."""
    _check_length(hi.shape[axis])
    return split(get_executor(ENGINE)(join(hi, lo), (axis,), forward))


def fftn_dd(hi: torch.Tensor, lo: torch.Tensor, axes=None,
            forward: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """dd complex N-D DFT over ``axes`` (default: all): one join, the
    complex128 transform over every axis, one split."""
    if axes is None:
        axes = tuple(range(hi.dim()))
    for ax in axes:
        _check_length(hi.shape[ax])
    return split(get_executor(ENGINE)(join(hi, lo), tuple(axes), forward))


def rfftn_dd(hi: torch.Tensor, lo: torch.Tensor, axes=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """dd real-to-complex DFT over ``axes`` (default: all): real float32
    pairs in, the half spectrum along the last of ``axes`` (n//2 + 1)
    out. The real axis runs first, the others after it."""
    axes = tuple(range(hi.dim())) if axes is None else tuple(axes)
    for ax in axes:
        _check_length(hi.shape[ax])
    y = get_r2c(ENGINE)(join(hi, lo), axes[-1])
    if len(axes) > 1:
        y = get_executor(ENGINE)(y, axes[:-1], True)
    return split(y)


def irfftn_dd(hi: torch.Tensor, lo: torch.Tensor, n2: int, axes=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`rfftn_dd`: the half spectrum in, real pairs of
    extent ``n2`` along the last of ``axes`` out, scaled 1/N (the
    imaginary residue dropped)."""
    axes = tuple(range(hi.dim())) if axes is None else tuple(axes)
    for ax in axes[:-1]:
        _check_length(hi.shape[ax])
    _check_length(n2)
    y = join(hi, lo)
    if len(axes) > 1:
        y = get_executor(ENGINE)(y, axes[:-1], False)
    return split(get_c2r(ENGINE)(y, n2, axes[-1]))


def dd_scale(hi: torch.Tensor, lo: torch.Tensor, s: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multiply a pair by a host scalar at the tier: an exact (signed)
    power of two scales each component, anything else multiplies the
    joined value in float64 and splits it (a float32 multiply of each
    component would round both to 2^-24)."""
    if s == 1.0:
        return hi, lo
    m, _ = math.frexp(s)
    if abs(m) == 0.5:
        return hi * s, lo * s
    return split(join(hi, lo) * s)


def max_err_vs_f64(hi, lo, want: np.ndarray) -> float:
    """max |dd - want| / max |want| against a host float64 reference."""
    got = dd_to_host(hi, lo)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
