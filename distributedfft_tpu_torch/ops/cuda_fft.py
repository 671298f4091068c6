"""Row, strided and plane FFT kernels for the H100 and their plain
PyTorch versions.

The port of ``distributedfft_tpu/ops/pallas_fft.py``. Its three Pallas
kernels become the CUDA launchers of ``csrc/four_step.cu``:

- :func:`fft2_last` (``_make_kernel2d``): 2D DFT over the last two axes of
  [batch, ny, nz];
- :func:`fft_axis0` (``_make_kernel_strided``): DFT over the middle axis of
  [lead, n, cols] -- the leading ``lead`` dimension replaces the JAX
  package's ``vmap`` over middle axes;
- :func:`fft_last` (``_make_kernel``): DFT over the rows of [batch, n].

Routes, chosen by the length alone (:func:`route`). Every eligible
length n <= 8192 takes the radix route (``csrc/radix.cuh``, plan and
table from :mod:`.radix`), a prime factor from 19 to 251 on its generic
prime stage; so does every eligible plane (:func:`route2d`: its axes are
at most 8192 long). The row and strided kernels take the two-pass radix
route (``radix2``) at every eligible 8192 < n <= 65536: with the
four-step split n = m1*m2 (:func:`split_for`, the JAX package's, both
factors <= 256), a radix pass of length m1 whose store multiplies by the
four-step twiddle T (float64-built, the JAX package's, bit for bit),
then a radix pass of length m2 whose store puts (k1, k2) at k1 + m1*k2.
The fused kernels (``cuda_fuse.fused_route``) take the same route at
every length.

Each wrapper takes complex64, contiguous tensors. On a CPU tensor it runs
the plain version of the route the card would take (``*_plain``: the
radix stages of :func:`.radix.radix_plain` or the two passes of
:func:`two_pass_plain`); on a CUDA tensor it launches its kernel or
raises. Each counts its launches in
``<wrapper>.launches``, by route in :data:`ROUTES` and by case in
:data:`CASES`. Forward
transforms are unnormalized, inverse ones scaled by 1/n (numpy
convention); ``normalize=False`` leaves the inverse unscaled.

An axis longer than one kernel's reach whose length splits into two
kernel lengths (:func:`outer_split`) runs the two-level transform
(:func:`_fft_last_big`, the JAX package's ``_fft_last_big``): on the
card, the passes of :func:`two_level_passes` (``csrc/two_level.cu``),
short column passes whose stores carry the next step's twiddle and the
reorder, then one rows pass whose store is the transpose to k order;
its plain version :func:`two_level_passes_plain`.

The real transforms of the ``cuda`` executor, :func:`r2c_half` and
:func:`c2r_half` (the packed-real trick of :mod:`.realfft`), run as one
rows pass each way (``csrc/real_rows.cu``) on a CUDA tensor whose half
length takes the radix route, with the untangle in that pass's store
(R2C) or its first stage's reader (C2R); elsewhere their plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import numpy as np
import torch

from .. import native
from ..utils import metrics as _metrics
from ..utils.trace import add_trace
from . import dft_matmul, radix, realfft
from ._build import check, library

# Largest per-stage factor: one kernel covers n <= 65536.
MAX_FACTOR = 256

# Largest ny*nz plane the 2D route takes (the JAX gate, eligible2d); the
# CUDA plane launcher itself has no plane limit.
_MAX_PLANE_ELEMS = 524288

#: Routes away from a kernel, by (axis, reason): ``plane2d`` counts planes
#: the 2D kernel does not take (they run per axis); ``dtype``, ``empty``
#: and ``length`` count transforms :func:`fft_along_axis` sends to
#: :mod:`.dft_matmul` (a two-level length is no fallback).
FALLBACKS: Counter = Counter()

#: Kernel launches by (wrapper, route): ``radix`` or ``radix2`` (the
#: two-pass route past 8192); the fused wrappers count a last-axis site
#: (cols = 1) under ``radix_rows`` or ``radix2_rows`` (their row form,
#: ``cuda_fuse.fused_form``); the two-level route under
#: ``("fft_last_big", "passes")``; every call of the real wrappers under
#: ``("r2c_half" | "c2r_half", "fused" | "plain")``.
ROUTES: Counter = Counter()

#: Kernel launches by case: (wrapper, forward, shape), with
#: "unnormalized" after an inverse left unscaled (the real wrappers'
#: shape is the real side's [rows, n]); the fused wrappers'
#: (wrapper, wire_dtype, forward, shape, fft_axis, tiles). A process
#: that launches kernels out of sight of its caller (a load-generator
#: worker) reports these, so the caller can tell which cases ran.
CASES: Counter = Counter()


@functools.lru_cache(maxsize=None)
def split_for(n: int) -> tuple[int, int] | None:
    """(n1, n2) factor pair the kernels run, or None."""
    return native.balanced_split(n, MAX_FACTOR)


def eligible(n: int) -> bool:
    """Axis lengths the kernels handle."""
    return n >= 64 and split_for(n) is not None


def eligible2d(ny: int, nz: int) -> bool:
    """Planes the 2D route takes: both axes eligible and ny*nz bounded."""
    return eligible(ny) and eligible(nz) and ny * nz <= _MAX_PLANE_ELEMS


@functools.lru_cache(maxsize=None)
def route(n: int) -> str:
    """The route of a length-n row or strided transform: ``radix`` for an
    eligible n <= 8192 (:func:`.radix.radix_plan` takes every one: its
    prime factors are <= 251), ``radix2`` for an eligible n past it (both
    factors of :func:`split_for` are radix lengths); ``direct`` only for
    a length the kernels do not take at all."""
    if not eligible(n):
        return "direct"
    return "radix" if radix.radix_plan(n) else "radix2"


def route2d(ny: int, nz: int) -> str:
    """The plane's route: ``radix`` when both axes take it by
    :func:`route`, which is every eligible plane: :func:`eligible2d`
    bounds ny*nz by 524288 and each axis by 64 from below, so both are
    at most 8192 long and never ``radix2``. ``direct`` only for a plane
    the kernel does not take at all."""
    return "radix" if route(ny) == route(nz) == "radix" else "direct"


def record_fallback(axis: int, reason: str) -> None:
    """Count one transform sent away from the kernels in
    :data:`FALLBACKS` and in the metrics series ``pallas_fallback``."""
    FALLBACKS[(int(axis), reason)] += 1
    _metrics.inc("pallas_fallback", axis=int(axis), reason=reason)


# ----------------------------------------------------------- the table T

def _dft_matrix_np(n: int, forward: bool) -> np.ndarray:
    """Dense n x n DFT matrix W[j, k] = exp(-+2 pi i j k / n), float64."""
    sign = -2j if forward else 2j
    jk = np.outer(np.arange(n), np.arange(n))
    return np.exp(sign * np.pi * (jk % n) / n)


@functools.lru_cache(maxsize=None)
def tables_np_cached(n: int, n1: int, n2: int, forward: bool):
    """(W1[j1, k1], T[j2, k1], W2[j2, k2]) complex64, built in float64:
    the JAX package's four-step LUTs of n = n1*n2, bit for bit, of which
    the two-pass route reads T."""
    w1 = _dft_matrix_np(n1, forward)
    w2 = _dft_matrix_np(n2, forward)
    sign = -2j if forward else 2j
    jk = np.outer(np.arange(n2), np.arange(n1))
    t = np.exp(sign * np.pi * (jk % n) / n)
    c64 = lambda a: np.ascontiguousarray(a.astype(np.complex64))
    return c64(w1), c64(t), c64(w2)


_DEVICE_TT: dict = {}


def device_tt(n: int, forward: bool, device: torch.device) -> torch.Tensor:
    """The four-step twiddle table T of ``n`` transposed, [m1, m2]
    complex64 (tt[k1, j2] = T[j2, k1] = w_n^(k1*j2), the same bits), on
    ``device``: what the two-pass route's first store reads. Uploaded once
    per (n, direction, device)."""
    key = (n, forward, str(device))
    hit = _DEVICE_TT.get(key)
    if hit is None:
        t = tables_np_cached(n, *split_for(n), forward)[1]
        hit = torch.from_numpy(np.ascontiguousarray(t.T)).to(device)
        _DEVICE_TT[key] = hit
    return hit


# ------------------------------------------------------- plain versions

def two_pass_plain(x2: torch.Tensor, n: int, forward: bool) -> torch.Tensor:
    """The two-pass route's math on [rows, n] complex64, unscaled: with
    (m1, m2) = :func:`split_for` (n), j = j1*m2 + j2 and k = k1 + m1*k2,
    :func:`.radix.radix_plain` over j1, times the four-step twiddle
    T[j2, k1] (the complex64 table of :func:`tables_np_cached`), then
    ``radix_plain`` over j2 and the reorder to k. Everything runs in
    complex128 and is rounded to complex64 once, at the end."""
    rows = x2.shape[0]
    m1, m2 = split_for(n)
    c128 = torch.complex128
    t = torch.from_numpy(tables_np_cached(n, m1, m2, forward)[1]).to(
        x2.device, c128)                                   # [m2, m1]
    a = x2.to(c128).reshape(rows, m1, m2).transpose(1, 2).reshape(-1, m1)
    b = radix.radix_plain(a, forward).reshape(rows, m2, m1) * t
    c = radix.radix_plain(b.transpose(1, 2).reshape(-1, m2), forward)
    return c.reshape(rows, m1, m2).transpose(1, 2).reshape(rows, n).to(
        x2.dtype)


def _rows_plain(x2: torch.Tensor, n: int, forward: bool,
                how: str) -> torch.Tensor:
    """[rows, n] through route ``how``'s plain version, unscaled."""
    if how == "radix":
        return radix.radix_plain(x2, forward)
    if how == "radix2":
        return two_pass_plain(x2, n, forward)
    raise ValueError(f"length {n} is not kernel-eligible: no route")


def fft_last_plain(x: torch.Tensor, forward: bool = True,
                   normalize: bool = True) -> torch.Tensor:
    n = x.shape[-1]
    y = _rows_plain(x, n, forward, route(n))
    return y if forward or not normalize else y * (1.0 / n)


def fft_axis0_plain(x: torch.Tensor, forward: bool = True,
                    normalize: bool = True,
                    how: str | None = None) -> torch.Tensor:
    """The strided kernel's plain version, on route ``how`` (default:
    :func:`route` of the length)."""
    lead, n, cols = x.shape
    y = _rows_plain(x.transpose(1, 2).reshape(-1, n), n, forward,
                    how or route(n))
    y = y.reshape(lead, cols, n).transpose(1, 2).contiguous()
    return y if forward or not normalize else y * (1.0 / n)


def fft2_last_plain(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    b, ny, nz = x.shape
    how = route2d(ny, nz)
    y = _rows_plain(x.reshape(-1, nz), nz, forward, how).reshape(b, ny, nz)
    y = _rows_plain(y.transpose(1, 2).reshape(-1, ny), ny, forward, how)
    y = y.reshape(b, nz, ny).transpose(1, 2).contiguous()
    return y * (1.0 / (ny * nz)) if not forward else y


# ------------------------------------------------------ kernel wrappers

def _check(x: torch.Tensor, ndim: int, what: str, *lengths: int) -> None:
    if x.dtype != torch.complex64:
        raise ValueError(f"{what}: needs complex64, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{what}: needs a {ndim}-D tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous tensor")
    if x.numel() == 0:
        raise ValueError(f"{what}: needs a non-empty tensor")
    for n in lengths:
        if not eligible(n):
            raise ValueError(f"{what}: length {n} is not kernel-eligible")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Call launcher ``name`` of the kernel library on ``x``'s device and
    its current stream; raise on the CUDA error it returns."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(name, x, *args)
    stream = torch.cuda.current_stream().cuda_stream
    check(getattr(library(), name)(*args, stream), name)


@functools.lru_cache(maxsize=None)
def _radices(n: int):
    """(stages, radices) of ``radix_plan(n)`` as the launchers take them."""
    plan = radix.radix_plan(n)
    return len(plan), (ctypes.c_int * len(plan))(*plan)


def _two_pass_args(n: int, forward: bool, device) -> tuple:
    """The two-pass launchers' arguments after the shape: each factor of
    :func:`split_for` (n) with its radices, the direction, each factor's
    stage twiddles and the four-step twiddle table transposed
    (:func:`device_tt`) on ``device`` (uploaded once each)."""
    m1, m2 = split_for(n)
    return (m1, *_radices(m1), m2, *_radices(m2), int(forward),
            radix.device_twiddles(m1, forward, device).data_ptr(),
            radix.device_twiddles(m2, forward, device).data_ptr(),
            device_tt(n, forward, device).data_ptr())


def fft_last(x: torch.Tensor, forward: bool = True,
             normalize: bool = True) -> torch.Tensor:
    """DFT over the rows of ``x`` [batch, n] (the 1D kernel).
    ``normalize=False`` skips the inverse's 1/n (a stage of a composed
    transform)."""
    _check(x, 2, "fft_last", x.shape[1])
    if x.device.type == "cpu":
        return fft_last_plain(x, forward, normalize)
    batch, n = x.shape
    y = torch.empty_like(x)
    scale = 1.0 if forward or not normalize else 1.0 / n
    how = route(n)
    if how == "radix":
        tw = radix.device_twiddles(n, forward, x.device)
        _launch("dfft_fft_rows", x, x.data_ptr(), y.data_ptr(), batch, n,
                *_radices(n), int(forward), tw.data_ptr(), scale)
    else:
        scratch = torch.empty_like(x)
        _launch("dfft_fft_rows_2p", x, x.data_ptr(), y.data_ptr(),
                scratch.data_ptr(), batch,
                *_two_pass_args(n, forward, x.device), scale)
    fft_last.launches += 1
    ROUTES[("fft_last", how)] += 1
    CASES[_case("fft_last", forward, x.shape, normalize)] += 1
    return y


def fft_axis0(x: torch.Tensor, forward: bool = True,
              normalize: bool = True) -> torch.Tensor:
    """DFT over axis 1 of ``x`` [lead, n, cols]: the leading-axis
    transform of each of ``lead`` [n, cols] blocks (the strided kernel;
    a plain axis-0 transform passes lead = 1). ``normalize`` as in
    :func:`fft_last`."""
    _check(x, 3, "fft_axis0", x.shape[1])
    if x.device.type == "cpu":
        return fft_axis0_plain(x, forward, normalize)
    lead, n, cols = x.shape
    y = torch.empty_like(x)
    scale = 1.0 if forward or not normalize else 1.0 / n
    how = route(n)
    if how == "radix":
        tw = radix.device_twiddles(n, forward, x.device)
        _launch("dfft_fft_strided", x, x.data_ptr(), y.data_ptr(), lead,
                cols, n, *_radices(n), int(forward), tw.data_ptr(), scale)
    else:
        scratch = torch.empty_like(x)
        _launch("dfft_fft_strided_2p", x, x.data_ptr(), y.data_ptr(),
                scratch.data_ptr(), lead, cols,
                *_two_pass_args(n, forward, x.device), scale)
    fft_axis0.launches += 1
    ROUTES[("fft_axis0", how)] += 1
    CASES[_case("fft_axis0", forward, x.shape, normalize)] += 1
    return y


def fft2_last(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    """2D DFT over the last two axes of ``x`` [batch, ny, nz] (the plane
    kernel); the inverse is scaled 1/(ny*nz). Runs under the span
    ``fft_plane``."""
    with add_trace("fft_plane"):
        _check(x, 3, "fft2_last", x.shape[1], x.shape[2])
        if route2d(x.shape[1], x.shape[2]) != "radix":
            raise ValueError(f"fft2_last: an axis of the plane "
                             f"{tuple(x.shape[1:])} is past {radix.MAX_N}")
        if x.device.type == "cpu":
            return fft2_last_plain(x, forward)
        return plane_launch(x, forward, x.shape[0])


def plane_launch(x: torch.Tensor, forward: bool, chunk: int) -> torch.Tensor:
    """:func:`fft2_last` on a CUDA tensor, the radix route walking the
    batch ``chunk`` planes at a time. :func:`fft2_last` passes the whole
    batch: chunks sized to the L2 (:func:`.radix.plane_chunk`) measured
    slower on the H100 (``chip_smoke.py`` times both)."""
    if chunk < 1:
        raise ValueError(f"plane_launch: chunk must be >= 1, got {chunk}")
    batch, ny, nz = x.shape
    y = torch.empty_like(x)
    scale = 1.0 / (ny * nz) if not forward else 1.0
    twy = radix.device_twiddles(ny, forward, x.device)
    twz = radix.device_twiddles(nz, forward, x.device)
    _launch("dfft_fft_plane", x, x.data_ptr(), y.data_ptr(), batch, ny,
            *_radices(ny), nz, *_radices(nz), int(forward), twy.data_ptr(),
            twz.data_ptr(), min(chunk, batch), scale)
    fft2_last.launches += 1
    ROUTES[("fft2_last", "radix")] += 1
    CASES[_case("fft2_last", forward, x.shape)] += 1
    return y


def _case(name: str, forward: bool, shape, normalize: bool = True):
    """The :data:`CASES` key of a launch of wrapper ``name``."""
    key = (name, bool(forward), tuple(shape))
    return key + ("unnormalized",) if not forward and not normalize else key


def reset_launches() -> None:
    """Zero every launch count, :data:`ROUTES` and :data:`CASES`
    included."""
    for fn in KERNELS.values():
        fn.launches = 0
    ROUTES.clear()
    CASES.clear()


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


# ------------------------------------------------------------- routing

@functools.lru_cache(maxsize=None)
def outer_split(n: int) -> tuple[int, int] | None:
    """Balanced divisor pair with both factors kernel-eligible, n < 2^31:
    the two-level plan of the JAX package's ``_fft_last_big``
    (``pallas_fft.outer_split``), or None. It decides which lengths take
    the two-level route; the route's passes are :func:`two_level_passes`'
    factoring, the port's own."""
    if n >= 1 << 31:
        return None
    for d in range(math.isqrt(n), 63, -1):
        if n % d == 0 and eligible(d) and eligible(n // d):
            return d, n // d
    return None


def _two_level_angle(m1: int, m2: int, n: int, forward: bool,
                     device) -> torch.Tensor:
    """The two-level twiddle's angle over (k1, j2), [m1, m2] float32. The
    phase k1*j2 < m1*m2 = n < 2^31 is the JAX package's ``(i*j) % n``
    with the mod an identity, and float32(k1*j2) is the float32 product
    of the two index vectors (each exact below 2^24, the product rounded
    once), so ``(sign*pi/n) * float32(phase)`` is formed bit for bit as
    there from two broadcast vectors, with no integer tensor of the full
    [m1, m2] size."""
    i = torch.arange(m1, device=device, dtype=torch.float32)[:, None]
    j = torch.arange(m2, device=device, dtype=torch.float32)[None, :]
    sign = -2.0 if forward else 2.0
    return (sign * math.pi / n) * (i * j)


@functools.lru_cache(maxsize=4)
def _two_level_table(m1: int, m2: int, n: int, forward: bool,
                     device: str) -> torch.Tensor:
    """The [m1, m2] complex64 twiddle w_n^(k1*j2) from
    :func:`_two_level_angle`, made once per (shape, direction, device):
    as large as one batch row of the transform, so the last four are
    kept."""
    ang = _two_level_angle(m1, m2, n, forward, device)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _two_level_twiddle(b: torch.Tensor, n: int,
                       forward: bool) -> torch.Tensor:
    """``b`` [batch, m1, m2] (k1, j2) times the two-level twiddle
    (:func:`_two_level_table`)."""
    _, m1, m2 = b.shape
    return b * _two_level_table(m1, m2, n, forward, str(b.device))


def _two_level(x2: torch.Tensor, n: int, forward: bool, axis0,
               last) -> torch.Tensor:
    """The JAX package's two-level four-step over [batch, n]
    (``_fft_last_big``), its two DFT stages ``axis0`` and ``last``
    unnormalized: with n = m1*m2 (:func:`outer_split`), j = j1*m2 + j2
    and k = k1 + m1*k2, the DFT over j1 of each [m1, m2] block, the
    twiddle (:func:`_two_level_twiddle`), the DFT over j2 of the batch*m1
    rows, and the transpose to k order. Unnormalized both ways. The
    card's route is :func:`_fft_last_big`'s passes; this composition is
    its second plain reference (:func:`_fft_last_big_plain`)."""
    m1, m2 = outer_split(n)
    batch = x2.shape[0]
    b = axis0(x2.reshape(batch, m1, m2), forward, normalize=False)
    b = _two_level_twiddle(b, n, forward)
    c = last(b.reshape(batch * m1, m2), forward, normalize=False)
    return c.reshape(batch, m1, m2).transpose(1, 2).reshape(batch, n)


def _fft_last_big_plain(x2: torch.Tensor, n: int,
                        forward: bool) -> torch.Tensor:
    """The JAX package's two-level composition (``_fft_last_big``) with
    each stage's plain version: the second reference of the route."""
    return _two_level(x2, n, forward, fft_axis0_plain, fft_last_plain)


# ------------------------------------------------- the two-level route

#: Most low bits of the two-table twiddle's index: the low table (2^bits
#: complex64, 16 KB) sits in a column pass's shared memory.
TWIDDLE_LOW_BITS = 11

#: Most passes the two-level launcher takes (csrc/two_level.cu).
MAX_PASSES = 16

#: Longest last pass of the two-level route that holds 16 rows a group
#: with its staged transpose in a block's shared memory (csrc/two_level.cu:
#: rows_pass; 16 rows of 512 with the staging take 208 KB of 227).
STAGED_MAX = 512


def _divisors(n: int) -> list[int]:
    small = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
    return sorted(set(small + [n // d for d in small]))


def pass_length_ok(f: int) -> bool:
    """Whether one radix pass takes length ``f``: a radix plan of two or
    more stages, or one generic prime stage (``radix.cuh:valid_plan``;
    a single hand-written stage is no pass)."""
    plan = radix.radix_plan(f)
    return bool(plan) and (len(plan) > 1 or radix.is_generic(plan[0]))


@functools.lru_cache(maxsize=None)
def _column_factors(m: int, cap: int, k: int) -> tuple[int, ...] | None:
    """``m`` as ``k`` pass lengths of at most ``cap``, largest first, the
    largest as small as can be (then the next, ...), or None."""
    if k == 1:
        return (m,) if m <= cap and pass_length_ok(m) else None
    best = None
    for d in _divisors(m):
        if d > cap or not pass_length_ok(d):
            continue
        rest = _column_factors(m // d, min(cap, d), k - 1)
        if rest is not None and (best is None or (d,) + rest < best):
            best = (d,) + rest
    return best


@functools.lru_cache(maxsize=None)
def two_level_passes(n: int, col_cap: int = MAX_FACTOR,
                     row_cap: int = radix.MAX_N,
                     staged_cap: int = STAGED_MAX
                     ) -> tuple[tuple[int, ...], int] | None:
    """The passes of the two-level route at length ``n``: column factors
    (f1, ..., fk), each at most ``col_cap``, and the last length L, at
    most ``row_cap``, with n = f1 * ... * fk * L; or None. The fewest
    passes whose L is at most ``staged_cap`` (its rows pass holds 16 rows
    a group and stores the transpose in runs of >= 128 bytes: a longer L
    stores 8 bytes at a time, and measured 8-10x its one-pass bound on
    the H100, PERF.md), else the fewest with any L; then the shortest L, then
    the most even column factors. Every length :func:`outer_split`
    accepts has one: both its factors are eligible, so n is a product of
    at most four factors <= 256 with primes <= 251. The column factors
    are short so that a group of a column pass holds >= 16 columns (runs
    of >= 128 bytes, as the two-pass route's first pass)."""
    if n < 2 or n >= 1 << 31:
        return None
    for cap in (min(staged_cap, row_cap), row_cap):
        best = None
        for length in _divisors(n):
            if length > cap or not pass_length_ok(length):
                continue
            for k in range(1, MAX_PASSES):
                cols = _column_factors(n // length, col_cap, k)
                if cols is not None:
                    if best is None or k < len(best[0]):
                        best = (cols, length)
                    break
        if best is not None:
            return best
    return None


def twiddle_bits(big_n: int) -> int:
    """s of the two-table twiddle w_N^p = T_hi[p >> s] * T_lo[p & (2^s -
    1)]: half the bits of N - 1 (rounded up), at most
    :data:`TWIDDLE_LOW_BITS`."""
    return max(1, min(TWIDDLE_LOW_BITS, ((big_n - 1).bit_length() + 1) // 2))


@functools.lru_cache(maxsize=None)
def twiddle_tables_np(big_n: int, forward: bool) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """(T_hi, T_lo) of w_N^p, complex64 built in float64: T_lo[q] =
    w_N^q for q < 2^s, T_hi[a] = w_N^(a 2^s) for a <= (N - 1) >> s
    (s = :func:`twiddle_bits` (N)), about sqrt(N) entries each."""
    s = twiddle_bits(big_n)
    sign = -2j if forward else 2j
    lo = np.arange(1 << s, dtype=np.int64)
    hi = (np.arange(((big_n - 1) >> s) + 1, dtype=np.int64) << s) % big_n
    c64 = lambda q: np.exp(sign * np.pi * q / big_n).astype(np.complex64)
    return c64(hi), c64(lo)


def two_table_twiddle(p, big_n: int, forward: bool) -> np.ndarray:
    """w_N^p for integer array ``p`` (0 <= p < N) as the column passes
    form it: T_hi[p >> s] * T_lo[p & (2^s - 1)] in complex64."""
    hi, lo = twiddle_tables_np(big_n, forward)
    s = twiddle_bits(big_n)
    p = np.asarray(p, dtype=np.int64)
    return hi[p >> s] * lo[p & ((1 << s) - 1)]


def two_level_passes_plain(x2: torch.Tensor, n: int, forward: bool,
                           scale: float = 1.0,
                           passes=None) -> torch.Tensor:
    """The two-level route's math on [rows, n] complex64 (``passes``:
    :func:`two_level_passes` (n) unless given). With F the product of
    the earlier passes' lengths and N the length still to transform, the
    data is [rows, F, N]: block (b, K) holds the sequence of row b whose
    earlier output keys compose to K. A column pass of length f splits
    j = j_f * (N/f) + c, runs :func:`.radix.radix_plain` over j_f,
    multiplies output (k, c) by w_N^(k c) (the complex64 tables of
    :func:`twiddle_tables_np`) and stores it in block K + F*k; the rows
    pass of length L runs ``radix_plain`` over the [rows*F, L] rows and
    puts (K, k) at K + F*k, times ``scale``. Everything runs in
    complex128 and is rounded to complex64 once, at the end."""
    cols_f, length = passes or two_level_passes(n)
    rows = x2.shape[0]
    c128 = torch.complex128
    y = x2.to(c128)
    big_f, big_n = 1, n
    for f in cols_f:
        cols = big_n // f
        a = y.reshape(rows * big_f, f, cols).transpose(1, 2).reshape(-1, f)
        b = radix.radix_plain(a, forward).reshape(rows, big_f, cols, f)
        hi, lo = (torch.from_numpy(t).to(x2.device, c128)
                  for t in twiddle_tables_np(big_n, forward))
        s = twiddle_bits(big_n)
        p = (torch.arange(cols, device=x2.device)[:, None]
             * torch.arange(f, device=x2.device)[None, :])
        b = b * (hi[p >> s] * lo[p & ((1 << s) - 1)])
        y = b.permute(0, 3, 1, 2).reshape(rows, n)       # [rows, f, F, cols]
        big_f, big_n = big_f * f, cols
    c = radix.radix_plain(y.reshape(-1, length), forward)
    c = c.reshape(rows, big_f, length).transpose(1, 2).reshape(rows, n)
    return (c * scale).to(x2.dtype)


_DEVICE_TWO_TABLE: dict = {}


def _device_two_table(big_n: int, forward: bool, device):
    """:func:`twiddle_tables_np` on ``device``, uploaded once per (N,
    direction, device)."""
    key = (big_n, forward, str(device))
    hit = _DEVICE_TWO_TABLE.get(key)
    if hit is None:
        hit = tuple(torch.from_numpy(t).to(device)
                    for t in twiddle_tables_np(big_n, forward))
        _DEVICE_TWO_TABLE[key] = hit
    return hit


def _arr(ctype, values):
    values = list(values)
    return (ctype * len(values))(*values)


@functools.lru_cache(maxsize=64)
def two_level_args(n: int, forward: bool, device, passes) -> tuple:
    """The launcher's arguments after the batch for passes ``passes``
    ((column factors, L)) of length ``n``: the pass count, lengths,
    stage counts and radices, the direction, each pass's stage table
    and each column pass's two twiddle tables and bits, the tables
    uploaded to ``device`` here (once each, kept in the module's
    caches), so that a launch copies nothing to the card; made once per
    (n, direction, device, passes)."""
    cols_f, length = passes
    lengths = (*cols_f, length)
    if len(lengths) > MAX_PASSES or math.prod(lengths) != n:
        raise ValueError(f"two_level_args: passes {passes} do not make {n}")
    plans = [radix.radix_plan(f) for f in lengths]
    tables = [radix.device_twiddles(f, forward, device) for f in lengths]
    his, los, bits, big_n = [], [], [], n
    for f in cols_f:
        hi, lo = _device_two_table(big_n, forward, device)
        his.append(hi.data_ptr())
        los.append(lo.data_ptr())
        bits.append(twiddle_bits(big_n))
        big_n //= f
    vp = ctypes.c_void_p
    return (len(lengths), _arr(ctypes.c_int, lengths),
            _arr(ctypes.c_int, (len(p) for p in plans)),
            _arr(ctypes.c_int, (r for p in plans for r in p)), int(forward),
            _arr(vp, (t.data_ptr() for t in tables)), _arr(vp, his),
            _arr(vp, los), _arr(ctypes.c_int, bits))


def two_level_launch(x2: torch.Tensor, n: int, forward: bool,
                     scale: float, passes) -> torch.Tensor:
    """Launch the two-level route's passes ``passes`` ((column factors,
    L)) over [rows, n] on the card (``csrc/two_level.cu:
    dfft_fft_two_level``); counts nothing (:func:`_fft_last_big` does)."""
    args = two_level_args(n, forward, x2.device, tuple(passes))
    y = torch.empty_like(x2)
    scratch = torch.empty_like(x2)
    _launch("dfft_fft_two_level", x2, x2.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), x2.shape[0], *args, scale)
    return y


def _fft_last_big(x2: torch.Tensor, n: int, forward: bool,
                  scale: float = 1.0) -> torch.Tensor:
    """The two-level transform of [rows, n] complex64 (the JAX package's
    ``_fft_last_big``), times ``scale``: on a CUDA tensor the route's
    passes (:func:`two_level_launch`), counted in ``.launches``,
    :data:`ROUTES` under ``("fft_last_big", "passes")`` and
    :data:`CASES`; on a CPU tensor their plain version
    (:func:`two_level_passes_plain`)."""
    if x2.dtype != torch.complex64 or x2.dim() != 2 or x2.shape[1] != n:
        raise ValueError(f"_fft_last_big: needs [rows, {n}] complex64, got "
                         f"{tuple(x2.shape)} {x2.dtype}")
    if not x2.is_contiguous() or x2.numel() == 0:
        raise ValueError("_fft_last_big: needs a contiguous, non-empty "
                         "tensor")
    passes = two_level_passes(n)
    if passes is None:
        raise ValueError(f"_fft_last_big: no two-level passes for {n}")
    if x2.device.type == "cpu":
        return two_level_passes_plain(x2, n, forward, scale, passes)
    if x2.device.type != "cuda":
        raise ValueError(f"_fft_last_big: no kernel for device {x2.device}")
    y = two_level_launch(x2, n, forward, scale, passes)
    _fft_last_big.launches += 1
    ROUTES[("fft_last_big", "passes")] += 1
    CASES[_case("fft_last_big", forward, x2.shape,
                forward or scale != 1.0)] += 1
    return y


def fft_along_axis(x: torch.Tensor, axis: int,
                   forward: bool = True) -> torch.Tensor:
    """C2C DFT along one axis through the kernels: the last axis by the
    1D kernel, any other by the strided one with the axes before it as
    ``lead``. Routed as ``pallas_fft.fft_along_axis`` routes: a dtype
    other than complex64, an empty tensor, or a length with neither a
    kernel split nor a two-level one (:func:`outer_split`) runs
    :func:`.dft_matmul.fft_along_axis`, the reason counted in
    :data:`FALLBACKS`; a two-level length moves its axis last and runs
    :func:`_fft_last_big` (no fallback: its passes are kernels), the
    inverse's 1/n in the last pass's store. Each call runs under one
    span ``fft_axis[<route>]``: ``radix``, ``radix2``, ``two_level`` or
    ``fallback``."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if x.dtype != torch.complex64 or x.numel() == 0:
        reason = "empty" if x.numel() == 0 else "dtype"
    elif not eligible(n) and outer_split(n) is None:
        reason = "length"
    else:
        reason = None
    if reason is not None:
        with add_trace("fft_axis[fallback]"):
            record_fallback(ax, reason)
            return dft_matmul.fft_along_axis(x, ax, forward)
    if not eligible(n):
        with add_trace("fft_axis[two_level]"):
            moved = x.movedim(ax, -1)
            y = _fft_last_big(moved.reshape(-1, n).contiguous(), n, forward,
                              1.0 if forward else 1.0 / n)
            return y.reshape(moved.shape).movedim(-1, ax).contiguous()
    shape = x.shape
    with add_trace(f"fft_axis[{route(n)}]"):
        if ax < x.ndim - 1:
            lead = math.prod(shape[:ax])
            cols = math.prod(shape[ax + 1:])
            y = fft_axis0(x.reshape(lead, n, cols).contiguous(), forward)
        else:
            y = fft_last(x.reshape(-1, n).contiguous(), forward)
        return y.reshape(shape)


# ------------------------------------------------ the real rows passes

def _real_fused(t: torch.Tensor, n: int, dtype: torch.dtype) -> bool:
    """Whether a length-``n`` real transform of ``t`` takes the fused rows
    pass: a ``dtype`` (the real side float32, the spectrum complex64),
    non-empty CUDA tensor whose half length takes the radix route."""
    return (t.device.type == "cuda" and t.dtype == dtype and t.numel() > 0
            and n % 2 == 0 and route(n // 2) == "radix")


def r2c_half_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`r2c_half`'s plain version: the packed-real trick of
    :func:`.realfft.r2c_via_half_complex` with :func:`fft_along_axis` as
    its C2C."""
    return realfft.r2c_via_half_complex(x, axis, fft_along_axis)


def c2r_half_plain(y: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """:func:`c2r_half`'s plain version (:func:`.realfft.
    c2r_via_half_complex` with :func:`fft_along_axis`)."""
    return realfft.c2r_via_half_complex(y, n, axis, fft_along_axis)


def r2c_half(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Real-to-complex DFT along ``axis`` (extent n even), n//2+1 outputs,
    unnormalized, through the half-length complex transform. A float32
    CUDA tensor whose half length h takes the radix route (:func:`route`)
    runs one rows pass (``csrc/real_rows.cu:dfft_r2c_rows``: the real
    rows read as [rows, h] complex64, the untangle in the store) under
    the span ``r2c_untangle``; anything else runs :func:`r2c_half_plain`.
    Each call counts in :data:`ROUTES` under ``("r2c_half", "fused")`` or
    ``("r2c_half", "plain")``; a launch also in ``r2c_half.launches`` and
    :data:`CASES` under ("r2c_half", True, (rows, n))."""
    n = x.shape[axis]
    if not _real_fused(x, n, torch.float32):
        ROUTES[("r2c_half", "plain")] += 1
        return r2c_half_plain(x, axis)
    with add_trace("r2c_untangle"):
        h = n // 2
        xm = x.movedim(axis, -1)
        x2 = xm.reshape(-1, n).contiguous()
        if x2.data_ptr() % 8:           # read as complex64
            x2 = x2.clone()
        y = torch.empty((x2.shape[0], h + 1), dtype=torch.complex64,
                        device=x.device)
        _launch("dfft_r2c_rows", x, x2.data_ptr(), y.data_ptr(),
                x2.shape[0], h, *_radices(h),
                radix.device_twiddles(h, True, x.device).data_ptr(),
                realfft.twiddle(n, torch.complex64, x.device).data_ptr())
        r2c_half.launches += 1
        ROUTES[("r2c_half", "fused")] += 1
        CASES[_case("r2c_half", True, x2.shape)] += 1
        return y.reshape(xm.shape[:-1] + (h + 1,)).movedim(-1, axis)


def c2r_half(y: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Complex-to-real inverse DFT along ``axis`` back to extent ``n``
    (even) from its n//2+1 hermitian half, scaled 1/n. A complex64 CUDA
    tensor whose half length takes the radix route runs one rows pass
    (``csrc/real_rows.cu:dfft_c2r_rows``: the packing in its first
    stage's reader, the real rows stored as complex64) under the span
    ``c2r_untangle``; anything else runs :func:`c2r_half_plain`. Counted
    in :data:`ROUTES` under ``("c2r_half", "fused" | "plain")``; a launch
    also in ``c2r_half.launches`` and :data:`CASES` under ("c2r_half",
    False, (rows, n))."""
    if y.shape[axis] != n // 2 + 1 or not _real_fused(y, n, torch.complex64):
        ROUTES[("c2r_half", "plain")] += 1
        return c2r_half_plain(y, n, axis)
    with add_trace("c2r_untangle"):
        h = n // 2
        ym = y.movedim(axis, -1)
        y2 = ym.reshape(-1, h + 1).contiguous().resolve_conj()
        x = torch.empty((y2.shape[0], n), dtype=torch.float32,
                        device=y.device)
        _launch("dfft_c2r_rows", y, y2.data_ptr(), x.data_ptr(),
                y2.shape[0], h, *_radices(h),
                radix.device_twiddles(h, False, y.device).data_ptr(),
                realfft.twiddle(n, torch.complex64, y.device).data_ptr(),
                1.0 / h)
        c2r_half.launches += 1
        ROUTES[("c2r_half", "fused")] += 1
        CASES[_case("c2r_half", False, x.shape)] += 1
        return x.reshape(ym.shape[:-1] + (n,)).movedim(-1, axis)


fft_last.launches = 0
fft_axis0.launches = 0
fft2_last.launches = 0
_fft_last_big.launches = 0
r2c_half.launches = 0
c2r_half.launches = 0

#: The kernel wrappers, by the name the launch counts are reported under.
KERNELS = {"fft2_last": fft2_last, "fft_axis0": fft_axis0,
           "fft_last": fft_last, "fft_last_big": _fft_last_big,
           "r2c_half": r2c_half, "c2r_half": c2r_half}
