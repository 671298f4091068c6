"""The radix route of the row, strided, plane and fused decode kernels:
host plan, twiddle tables, and the plain PyTorch version of the route.

A length n whose prime factors are all <= 17 (and n <= 8192, so that a
whole sequence and its tables fit one block's shared memory) is taken
by ``csrc/radix.cuh`` as a chain of Stockham stages; a longer such
length runs two passes of it, one per factor of its four-step split
(``cuda_fft.two_pass_plain``). Stage k has radix
R and ``ns`` = the product of the radices before it; its butterfly j
(0 <= j < n/R) reads x[j + m n/R] (m < R), multiplies element m by the
stage twiddle w_L^(p m) with L = ns R and p = j mod ns, runs an R-point
DFT, and writes output k to (j div ns) L + p + k ns. After the last
stage the sequence is in natural order.

Everything the kernel needs is decided here: :func:`radix_plan` gives
the radices, :func:`twiddles_np` the stage tables, built in float64 and
cast to complex64. The kernel computes no plan of its own, so the CPU
tests check every plan the card runs. :func:`radix_plain` runs the same
stages as tensor ops; :func:`plan_flops` counts the kernel's arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: Longest length the radix route takes: two ping-pong buffers of one
#: sequence and its n - 1 twiddles fit a block's 227 KB of shared memory.
MAX_N = 8192

#: Largest prime a stage may have (a direct p-point DFT in registers).
MAX_PRIME = 17

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
    stage of its own, in ascending order (510 = 2.3.5.17)."""
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


_DEVICE_TWIDDLES: dict = {}


def device_twiddles(n: int, forward: bool, device) -> torch.Tensor:
    """:func:`twiddles_np` on ``device``, uploaded once per (n,
    direction, device)."""
    key = (n, forward, str(device))
    hit = _DEVICE_TWIDDLES.get(key)
    if hit is None:
        hit = torch.from_numpy(twiddles_np(n, forward)).to(device)
        _DEVICE_TWIDDLES[key] = hit
    return hit


def _dft_matrix(r: int, forward: bool) -> np.ndarray:
    sign = -2j if forward else 2j
    jk = np.outer(np.arange(r), np.arange(r)) % r
    return np.exp(sign * np.pi * jk / r).astype(np.complex64)


def radix_plain(x2: torch.Tensor, forward: bool) -> torch.Tensor:
    """The radix route's stages on [rows, n] complex64, unscaled: the
    plan's radices in its order and its complex64 twiddle tables, one
    R-point DFT per stage as an einsum. The sums run in float64 and are
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


def butterfly_flops(r: int) -> int:
    h = (r - 1) // 2
    return _BUTTERFLY_FLOPS.get(r, 8 * h * h + 10 * h)


def plan_flops(n: int) -> int:
    """Real flops of one length-n transform by the radix route: each
    stage's n/R butterflies, and after the first stage the R - 1 twiddle
    products (6 flops each) of every butterfly."""
    total = 0
    for r, ns in stage_geometry(radix_plan(n)):
        total += n // r * (butterfly_flops(r) + (6 * (r - 1) if ns > 1 else 0))
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
