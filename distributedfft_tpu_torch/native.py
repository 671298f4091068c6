"""The split rule of the four-step kernels, in pure Python.

The JAX package asks its native scheduler (``native/dfft_native.cpp``,
``dfft_balanced_split``) and keeps a pure-Python mirror in lockstep
(``distributedfft_tpu/native.py:_balanced_split_py``). The port keeps only
that mirror: it loads no shared library.
"""

from __future__ import annotations

import math


def balanced_split(n: int, max_factor: int) -> tuple[int, int] | None:
    """Balanced divisor pair (n1, n2), n1 <= n2 <= max_factor, n1 maximal,
    or None when there is none."""
    for d in range(math.isqrt(n), 1, -1):
        if n % d == 0:
            n1, n2 = d, n // d
            return (n1, n2) if n2 <= max_factor else None
    return None
