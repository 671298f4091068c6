"""The radix route of the row, strided, plane and fused kernels: host
plan, twiddle tables, and the plain PyTorch version of the route.

A length n <= 8192 (so that a whole sequence and its tables fit one
block's shared memory) whose prime factors are all <= 251 is taken by
``csrc/radix.cuh`` as a chain of Stockham stages; a longer one runs two
passes of it, one per factor of its four-step split
(``cuda_fft.two_pass_plain``). Stage k has radix
R and ``ns`` = the product of the radices before it; its butterfly j
(0 <= j < n/R) reads x[j + m n/R] (m < R), multiplies element m by the
stage twiddle w_L^(p m) with L = ns R and p = j mod ns, runs an R-point
DFT, and writes output k to (j div ns) L + p + k ns. After the last
stage the sequence is in natural order. A radix of :data:`HAND_RADICES`
has a butterfly written out in registers; a prime from 19 to 251 runs
the generic prime stage, which sums its R twiddled inputs against the
R roots w_R^q from shared memory.

Everything the kernel needs is decided here: :func:`radix_plan` gives
the radices, :func:`table_np` the stage twiddles (:func:`twiddles_np`)
and the generic stages' roots (:func:`roots_np`), built in float64 and
cast to complex64. The kernel
computes no plan of its own, so the CPU tests check every plan the card
runs. :func:`radix_plain` runs the same stages as tensor ops;
:func:`plan_flops` counts the kernel's arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: Longest length the radix route takes: two ping-pong buffers of one
#: sequence and its n - 1 twiddles fit a block's 227 KB of shared memory.
MAX_N = 8192

#: Largest prime a stage may have: the largest prime of a factor <= 256.
MAX_PRIME = 251

#: The radices with a butterfly written out in registers; every other
#: stage is a prime from 19 to :data:`MAX_PRIME` on the generic stage.
HAND_RADICES = frozenset({2, 3, 4, 5, 7, 8, 11, 13, 16, 17})

#: Output pairs (k, R - k) one thread of a generic stage sums at most
#: (``csrc/radix.cuh``: kPairs).
GENERIC_PAIRS = 4

#: Bytes of device memory one plane chunk of the plane launcher's chunked
#: form may span, so that the Z pass's output is still in the 50 MB L2
#: when the Y pass reads it.
L2_CHUNK_BYTES = 8 * 2**20


def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


@functools.lru_cache(maxsize=None)
def radix_plan(n: int) -> tuple[int, ...] | None:
    """Stage radices of a length-n transform, first stage first, or None
    when n is over :data:`MAX_N` or has a prime factor over
    :data:`MAX_PRIME`. The power-of-two part 2^a goes into ceil(a/4)
    stages of radix 16, 8, 4 or 2, as even as can be (larger first:
    512 = 8.8.8, 256 = 16.16, 8192 = 16.8.8.8); every odd prime is a
    stage of its own, in ascending order (510 = 2.3.5.17, 608 = 8.4.19,
    361 = 19.19). A prime alone is a one-stage plan (241)."""
    if n < 2 or n > MAX_N:
        return None
    primes = _prime_factors(n)
    if primes[-1] > MAX_PRIME:
        return None
    a = primes.count(2)
    stages = -(-a // 4)
    pow2 = [a // stages + (1 if i < a % stages else 0)
            for i in range(stages)] if stages else []
    return tuple(2 ** e for e in pow2) + tuple(p for p in primes if p != 2)


def is_generic(r: int) -> bool:
    """Whether a stage of radix r runs the generic prime stage."""
    return r not in HAND_RADICES


def stage_geometry(plan) -> list[tuple[int, int]]:
    """(radix, ns) of each stage: ns is the product of earlier radices."""
    out, ns = [], 1
    for r in plan:
        out.append((r, ns))
        ns *= r
    return out


@functools.lru_cache(maxsize=None)
def twiddles_np(n: int, forward: bool) -> np.ndarray:
    """The stage twiddles of ``radix_plan(n)``, concatenated: stage (R,
    ns) holds w_L^(p m) = exp(-+2 pi i (p m n/L mod n) / n), L = ns R,
    at (ns - 1) + (m - 1) ns + p for 1 <= m < R, 0 <= p < ns (m = 0 is
    1 and is not stored). n - 1 entries in all, complex64 built in
    float64."""
    sign = -2j if forward else 2j
    out = np.empty(n - 1, dtype=np.complex64)
    for r, ns in stage_geometry(radix_plan(n)):
        span = n // (ns * r)
        k = np.outer(np.arange(1, r), np.arange(ns)) * span % n
        out[ns - 1:ns - 1 + (r - 1) * ns] = np.exp(
            sign * np.pi * k.ravel() / n).astype(np.complex64)
    return out


@functools.lru_cache(maxsize=None)
def roots_np(n: int, forward: bool) -> np.ndarray:
    """The roots of the generic stages of ``radix_plan(n)``, in stage
    order: R entries w_R^q = exp(-+2 pi i q / R), q < R, for each stage
    R that :func:`is_generic`, complex64 built in float64 (empty when the
    plan has none)."""
    sign = -2j if forward else 2j
    parts = [np.exp(sign * np.pi * np.arange(r) / r).astype(np.complex64)
             for r in radix_plan(n) if is_generic(r)]
    return np.concatenate(parts) if parts else np.empty(0, np.complex64)


def table_np(n: int, forward: bool) -> np.ndarray:
    """What the kernels take as a length's table: :func:`twiddles_np`,
    then :func:`roots_np`."""
    return np.concatenate([twiddles_np(n, forward), roots_np(n, forward)])


_DEVICE_TWIDDLES: dict = {}


def device_twiddles(n: int, forward: bool, device) -> torch.Tensor:
    """:func:`table_np` on ``device`` (the stage twiddles, then the
    generic stages' roots), uploaded once per (n, direction, device)."""
    key = (n, forward, str(device))
    hit = _DEVICE_TWIDDLES.get(key)
    if hit is None:
        hit = torch.from_numpy(table_np(n, forward)).to(device)
        _DEVICE_TWIDDLES[key] = hit
    return hit


def _dft_matrix(r: int, forward: bool) -> np.ndarray:
    """The R-point DFT matrix, complex64 built in float64: entry (m, k)
    is w_R^(m k mod R), the root the generic stage reads."""
    sign = -2j if forward else 2j
    jk = np.outer(np.arange(r), np.arange(r)) % r
    return np.exp(sign * np.pi * jk / r).astype(np.complex64)


def radix_plain(x2: torch.Tensor, forward: bool) -> torch.Tensor:
    """The radix route's stages on [rows, n] complex64, unscaled: the
    plan's radices in its order and its complex64 twiddle tables, one
    R-point DFT per stage as an einsum (a generic stage's matrix holds
    the complex64 roots it reads). The sums run in float64 and are
    rounded to complex64 once, at the end, so the plain version's own
    rounding stays far under the kernel's fp32 error it is held
    against."""
    rows, n = x2.shape
    c128 = torch.complex128
    tw = torch.from_numpy(twiddles_np(n, forward)).to(x2.device, c128)
    y = x2.to(c128)
    for r, ns in stage_geometry(radix_plan(n)):
        q = n // (ns * r)
        w = torch.ones((r, ns), dtype=c128, device=x2.device)
        w[1:] = tw[ns - 1:ns - 1 + (r - 1) * ns].reshape(r - 1, ns)
        v = y.reshape(rows, r, q, ns) * w.reshape(1, r, 1, ns)
        f = torch.from_numpy(_dft_matrix(r, forward)).to(x2.device, c128)
        y = torch.einsum("bmqp,mk->bqkp", v, f).reshape(rows, n)
    return y.to(x2.dtype)


# Real flops of one butterfly as csrc/radix.cuh writes it (an FMA counts
# two): radix 8 and 16 are two radix-4 and radix-8 halves joined by
# w_8^k and w_16^k; an odd prime P > 5 is the direct symmetric DFT,
# 8 h^2 + 10 h flops with h = (P - 1)/2.
_BUTTERFLY_FLOPS = {2: 4, 3: 16, 4: 16, 5: 48, 8: 60, 16: 188}


def generic_chunks(r: int) -> int:
    """Threads (items) a generic stage of radix r gives one butterfly:
    its h = (r - 1)/2 output pairs in chunks of at most
    :data:`GENERIC_PAIRS`."""
    return -(-((r - 1) // 2) // GENERIC_PAIRS)


def butterfly_flops(r: int) -> int:
    """Real flops of one radix-r butterfly as the kernel runs it. A
    generic stage's butterfly is :func:`generic_chunks` items; for each m
    of h = (r - 1)/2 an item forms a_m, b_m (4 flops), adds a_m to the
    running sum (2) and adds a_m cos and b_m sin (8) into each of its
    :data:`GENERIC_PAIRS` pair slots, the unused ones of the last chunk
    included; joining the pairs' two halves takes 4 flops a pair."""
    h = (r - 1) // 2
    if not is_generic(r):
        return _BUTTERFLY_FLOPS.get(r, 8 * h * h + 10 * h)
    return generic_chunks(r) * h * (6 + 8 * GENERIC_PAIRS) + 4 * h


def twiddle_flops(r: int) -> int:
    """Real flops of one butterfly's twiddle products after the first
    stage: R - 1 complex products, each formed once per item that reads
    it (a generic stage's chunks each twiddle all R - 1 inputs)."""
    return 6 * (r - 1) * (generic_chunks(r) if is_generic(r) else 1)


def plan_flops(n: int) -> int:
    """Real flops of one length-n transform by the radix route: each
    stage's n/R butterflies, and after the first stage their twiddle
    products (:func:`twiddle_flops`)."""
    total = 0
    for r, ns in stage_geometry(radix_plan(n)):
        total += n // r * (butterfly_flops(r)
                           + (twiddle_flops(r) if ns > 1 else 0))
    return total


def plane_chunk(ny: int, nz: int) -> int:
    """Planes of [ny, nz] complex64 per chunk of the plane launcher's
    chunked form: as many as fit :data:`L2_CHUNK_BYTES`, at least one.
    ``cuda_fft.fft2_last`` runs the whole batch in one go, which measured
    faster; ``chip_smoke.py`` times both forms."""
    return max(1, L2_CHUNK_BYTES // (ny * nz * 8))


def chunk_spans(batch: int, chunk: int) -> list[tuple[int, int]]:
    """(first plane, planes) of each chunk, in the launcher's order; the
    last chunk is ragged when ``chunk`` does not divide ``batch``."""
    return [(b, min(chunk, batch - b)) for b in range(0, batch, chunk)]
