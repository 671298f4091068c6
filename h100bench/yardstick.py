"""The arithmetic every metric rests on: flop and byte counts from the
cell's shapes, the cards' published peaks, the percentile, and the check
that the ranks' boxes tile the grid. Nothing here reads the program."""

from __future__ import annotations

import math

#: Published peaks of each card by the name ``torch.cuda.get_device_name``
#: gives: (HBM bytes/s, float32 FLOP/s outside the tensor cores), NVIDIA's
#: data sheet for the SXM part at its full 700 W.
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}

#: Bytes of one value of each element type a transform reads or writes.
ITEMSIZE = {"complex64": 8, "float32": 4, "complex128": 16, "float64": 8}

#: The complex and real element types of each precision.
DTYPES = {"float32": ("complex64", "float32"),
          "float64": ("complex128", "float64")}


def points(shape) -> int:
    return math.prod(int(s) for s in shape)


def half_shape(shape) -> tuple[int, int, int]:
    """The half spectrum of a real transform along the last axis."""
    n0, n1, n2 = (int(s) for s in shape)
    return n0, n1, n2 // 2 + 1


def transform_flops(shape, factor: float) -> float:
    """``factor`` x N x log2 N for N the global grid points: 5 for a
    complex transform, 2.5 for a real one (heFFTe's ``speed3d.h``)."""
    n = points(shape)
    return factor * n * math.log2(n)


def transform_bytes(shape, transform: str, precision: str,
                    forward: bool) -> int:
    """Bytes one whole transform reads once and writes once: its input
    and its output, whatever implements it."""
    cplx, real = DTYPES[precision]
    full = points(shape) * ITEMSIZE[cplx]
    if transform == "c2c":
        return 2 * full
    realb = points(shape) * ITEMSIZE[real]
    halfb = points(half_shape(shape)) * ITEMSIZE[cplx]
    return realb + halfb if forward else halfb + realb


def pair_least_seconds(shape, transform: str, precision: str,
                       flops_factor: float, ranks: int,
                       device_kind: str) -> float | None:
    """The least time one rank's share of a forward and a backward
    transform could take on ``device_kind``: the larger of its bytes over
    the card's bandwidth and its flops over its float32 peak. None for a
    card with no entry in :data:`PEAKS`."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    bw, fl = peak
    nbytes = sum(transform_bytes(shape, transform, precision, f)
                 for f in (True, False)) / ranks
    flops = 2 * transform_flops(shape, flops_factor) / ranks
    return max(nbytes / bw, flops / fl)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile (0 < q <= 100) of ``values``:
    the smallest value with at least q% of the values at or below it."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def check_tiling(boxes, shape) -> None:
    """Raises unless the boxes (low, high) lie in ``shape``, overlap
    nowhere and together cover it."""
    shape = tuple(int(s) for s in shape)
    for low, high in boxes:
        if not all(0 <= l <= h <= n for l, h, n in zip(low, high, shape)):
            raise ValueError(f"box {low}..{high} leaves the grid {shape}")
    for i, (la, ha) in enumerate(boxes):
        for lb, hb in boxes[i + 1:]:
            if all(max(a, b) < min(c, d)
                   for a, b, c, d in zip(la, lb, ha, hb)):
                raise ValueError(f"boxes {la}..{ha} and {lb}..{hb} overlap")
    if sum(points(h - l for l, h in zip(*b)) for b in boxes) != points(shape):
        raise ValueError(f"the boxes do not cover the grid {shape}")
