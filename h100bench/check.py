"""The comparison that decides ``correct``.

Two numbers, each against its limit from the configuration's file:

- ``fwd_err``: the widest gap between a spectrum the timed window
  produced and the reference's spectrum of the same seeded field, over
  the reference spectrum's root mean square;
- ``bwd_err``: the widest gap between the backward result the window
  produced from that spectrum and the reference's backward transform of
  the same spectrum, over that reference's root mean square.

Widest gaps, so that one altered value fails the check as surely as a
wrong transform does. The reference runs on whole global arrays in
float64; a rank compares its own box of each, as the plans place it."""

from __future__ import annotations

import torch

from .field import make_field

NUMBERS = ("fwd_err", "bwd_err")


def _gap(mine: torch.Tensor, ref_box: torch.Tensor, rms: float) -> float:
    d = mine.to(ref_box.dtype) - ref_box
    gap = float(d.abs().max()) / rms
    return gap if gap == gap else float("inf")  # a NaN reads as wrong


def _rms(t: torch.Tensor) -> float:
    return float(t.abs().pow(2).mean().sqrt())


def _slice(t: torch.Tensor, low, high) -> torch.Tensor:
    return t[low[0]:high[0], low[1]:high[1], low[2]:high[2]]


def compare(layout, ref, seed: int, kept: list, comm) -> list[tuple]:
    """The two numbers of each sampled pair of ``kept`` (``(spectrum,
    backward result)`` of this rank's boxes) of the field of ``seed``,
    the largest over the ranks. ``layout`` gives the transform, the
    global shape and every rank's boxes; ``ref`` is the configuration's
    reference module; ``comm`` gathers over the ranks."""
    shape, transform = layout.shape, layout.transform
    x = make_field(shape, (0, 0, 0), shape, layout.in_dtype, seed,
                   layout.device)
    spec = ref.forward(x, transform)
    del x
    rms_f = _rms(spec)
    gaps = []
    for y, z in kept:
        fwd = _gap(y, _slice(spec, *layout.out_box), rms_f)
        whole = comm.assemble(y, layout.out_boxes, layout.out_shape)
        back = ref.backward(whole, transform, shape)
        del whole
        gaps += [fwd, _gap(z, _slice(back, *layout.in_box), _rms(back))]
        del back
    del spec
    gaps = comm.max(gaps)
    return [tuple(gaps[i:i + 2]) for i in range(0, len(gaps), 2)]


def numbers(per_pair: list[tuple]) -> dict[str, float]:
    """The largest of each number over the sampled pairs."""
    return {k: max(p[i] for p in per_pair) for i, k in enumerate(NUMBERS)}


def failed(per_pair: list[tuple], limits: dict) -> int:
    """How many sampled transforms read above their limit (a NaN does)."""
    return sum(1 for p in per_pair for i, k in enumerate(NUMBERS)
               if not p[i] <= limits[k])


def lines(numbers: dict, limits: dict) -> list[str]:
    """Each number compared beside its limit, one per line."""
    return [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in NUMBERS]


def reference_pairs(layout, ref, seed: int, pairs: int) -> list:
    """The control of a configuration whose control is the reference in
    lower precision: its spectrum and backward result of the field of
    ``seed``, in the program's place (one box: a single-rank layout)."""
    shape = layout.shape
    x = make_field(shape, (0, 0, 0), shape, layout.in_dtype, seed,
                   layout.device)
    y = ref.forward_lowp(x, layout.transform)
    z = ref.backward_lowp(y, layout.transform, shape)
    return [(y, z)] * pairs
