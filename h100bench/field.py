"""The seeded input field, made on the device.

Plane ``i`` of the global field (its index along axis 0) is drawn whole
from a generator seeded with a mix of the run's seed and ``i``, so any
box comes out the same on any card, whichever rank draws it:
the program's input on each rank and the reference's global field are
the same numbers. Complex fields are standard complex normal, real ones
standard normal: zero mean, so no bin dominates the spectrum."""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def plane_seed(seed: int, plane: int) -> int:
    """A 63-bit seed for ``plane`` of the field of ``seed`` (any whole
    number, however large)."""
    h = (int(seed) * 0x9E3779B97F4A7C15 + (plane + 1) * 0xBF58476D1CE4E5B9)
    h &= _MASK
    h ^= h >> 31
    return (h * 0x94D049BB133111EB) & _MASK


def make_field(shape, low, high, dtype: torch.dtype, seed: int,
               device) -> torch.Tensor:
    """The box ``[low, high)`` of the global field of ``shape`` as a
    contiguous tensor of ``dtype``: each of its planes drawn whole, and
    cut where the box does not hold whole planes."""
    plane = tuple(int(s) for s in shape[1:])
    x = torch.empty(tuple(h - l for l, h in zip(low, high)), dtype=dtype,
                    device=device)
    whole = tuple(low[1:]) == (0, 0) and tuple(high[1:]) == plane
    buf = None if whole else torch.empty(plane, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    for j, i in enumerate(range(low[0], high[0])):
        g.manual_seed(plane_seed(seed, i))
        torch.randn(plane, generator=g, dtype=dtype, device=device,
                    out=x[j] if whole else buf)
        if not whole:
            x[j] = buf[low[1]:high[1], low[2]:high[2]]
    return x
