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

Three routes (:func:`route`), chosen by the length alone. Every kernel
takes the radix route (``csrc/radix.cuh``, plan and twiddles from
:mod:`.radix`) for every length n <= 8192 whose prime factors are all
<= 17, the plane only when both its axes do. The row and strided
kernels take the two-pass radix route (``radix2``) for the lengths
8192 < n <= 65536 with those prime factors: with the four-step split
n = m1*m2 (:func:`split_for`), a radix pass of length m1 whose store
multiplies by the four-step twiddle T, then a radix pass of length m2
whose store puts (k1, k2) at k1 + m1*k2. Every other eligible length
takes the direct route: the four-step sums, whose split n = n1*n2 (both
factors <= 256) and float64-built LUTs (T among them) are the JAX
package's, bit for bit.

Each wrapper takes complex64, contiguous tensors. On a CPU tensor it runs
the plain version of the route the card would take (``*_plain``: the
radix stages of :func:`.radix.radix_plain`, the two passes of
:func:`two_pass_plain`, or the ``_four_step_ref`` math as
``torch.einsum`` with the same LUTs); on a CUDA tensor it
launches its kernel or raises. Each counts its launches in
``<wrapper>.launches``, by route in :data:`ROUTES` and by case in
:data:`CASES`. Forward
transforms are unnormalized, inverse ones scaled by 1/n (numpy
convention); ``normalize=False`` leaves the inverse unscaled.

An axis longer than one kernel's reach whose length splits into two
kernel lengths (:func:`outer_split`) runs the two-level transform of the
JAX package's ``_fft_last_big``: the strided kernel, a twiddle, the row
kernel and a transpose (:func:`_fft_last_big`).
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
from . import dft_matmul, radix
from ._build import check, library

# Largest per-stage factor: one kernel covers n <= 65536.
MAX_FACTOR = 256

# Largest ny*nz plane the 2D route takes (the JAX gate, eligible2d); the
# CUDA plane launcher itself has no plane limit.
_MAX_PLANE_ELEMS = 524288

# Shared memory a block may use for its sequences (2*S*n complex64 each);
# below the 227 KB maximum so that two blocks fit on one SM.
_SMEM_BUDGET = 96 * 1024

#: Routes away from a kernel, by (axis, reason): ``plane2d`` counts planes
#: the 2D kernel does not take (they run per axis); ``dtype``, ``empty``
#: and ``length`` count transforms :func:`fft_along_axis` sends to
#: :mod:`.dft_matmul` (a two-level length is no fallback).
FALLBACKS: Counter = Counter()

#: Kernel launches by (wrapper, route), route ``radix``, ``radix2`` (the
#: two-pass route of the row and strided kernels) or ``direct``.
ROUTES: Counter = Counter()

#: Kernel launches by case: (wrapper, forward, shape), with
#: "unnormalized" after an inverse left unscaled; the fused wrappers'
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
    eligible n that :func:`.radix.radix_plan` takes (n <= 8192, prime
    factors <= 17); ``radix2`` for a longer eligible n whose two factors
    of :func:`split_for` it takes (the same prime factors); else
    ``direct``."""
    if not eligible(n):
        return "direct"
    if radix.radix_plan(n):
        return "radix"
    if all(radix.radix_plan(m) for m in split_for(n)):
        return "radix2"
    return "direct"


def route2d(ny: int, nz: int) -> str:
    """The plane's route: ``radix`` when both axes take it. A plane's
    axes are at most 8192 long (:func:`eligible2d`), so never
    ``radix2``."""
    return "radix" if route(ny) == route(nz) == "radix" else "direct"


def record_fallback(axis: int, reason: str) -> None:
    """Count one transform sent away from the kernels in
    :data:`FALLBACKS` and in the metrics series ``pallas_fallback``."""
    FALLBACKS[(int(axis), reason)] += 1
    _metrics.inc("pallas_fallback", axis=int(axis), reason=reason)


# ------------------------------------------------------------------ LUTs

def _dft_matrix_np(n: int, forward: bool) -> np.ndarray:
    """Dense n x n DFT matrix W[j, k] = exp(-+2 pi i j k / n), float64."""
    sign = -2j if forward else 2j
    jk = np.outer(np.arange(n), np.arange(n))
    return np.exp(sign * np.pi * (jk % n) / n)


@functools.lru_cache(maxsize=None)
def tables_np_cached(n: int, n1: int, n2: int, forward: bool):
    """(W1[j1, k1], T[j2, k1], W2[j2, k2]) complex64, built in float64."""
    w1 = _dft_matrix_np(n1, forward)
    w2 = _dft_matrix_np(n2, forward)
    sign = -2j if forward else 2j
    jk = np.outer(np.arange(n2), np.arange(n1))
    t = np.exp(sign * np.pi * (jk % n) / n)
    c64 = lambda a: np.ascontiguousarray(a.astype(np.complex64))
    return c64(w1), c64(t), c64(w2)


def tables_np(n: int, forward: bool):
    n1, n2 = split_for(n)
    return tables_np_cached(n, n1, n2, forward)


_DEVICE_TABLES: dict = {}


def device_tables(n: int, forward: bool, device: torch.device):
    """The LUTs of ``n`` on ``device``, uploaded once per (n, direction,
    device)."""
    key = (n, forward, str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = tuple(torch.from_numpy(m).to(device) for m in tables_np(n, forward))
        _DEVICE_TABLES[key] = hit
    return hit


_DEVICE_TT: dict = {}


def device_tt(n: int, forward: bool, device: torch.device) -> torch.Tensor:
    """The four-step twiddle table T of ``n`` transposed, [m1, m2]
    complex64 (tt[k1, j2] = T[j2, k1] = w_n^(k1*j2), the same bits), on
    ``device``: what the two-pass route's first store reads. Uploaded once
    per (n, direction, device)."""
    key = (n, forward, str(device))
    hit = _DEVICE_TT.get(key)
    if hit is None:
        t = tables_np(n, forward)[1]
        hit = torch.from_numpy(np.ascontiguousarray(t.T)).to(device)
        _DEVICE_TT[key] = hit
    return hit


# ------------------------------------------------------- plain versions

def four_step_plain(x2: torch.Tensor, n: int, forward: bool) -> torch.Tensor:
    """The kernels' math on [rows, n] complex64 (``_four_step_ref``)."""
    n1, n2 = split_for(n)
    w1, t, w2 = (torch.from_numpy(m).to(x2.device) for m in tables_np(n, forward))
    a = x2.reshape(-1, n1, n2)
    g = torch.einsum("bij,ik->bjk", a, w1)
    h = g * t
    z = torch.einsum("bjk,jl->bkl", h, w2)
    return z.transpose(1, 2).reshape(x2.shape)


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
    if how == "radix":
        return radix.radix_plain(x2, forward)
    if how == "radix2":
        return two_pass_plain(x2, n, forward)
    return four_step_plain(x2, n, forward)


def fft_last_plain(x: torch.Tensor, forward: bool = True,
                   normalize: bool = True) -> torch.Tensor:
    n = x.shape[-1]
    y = _rows_plain(x, n, forward, route(n))
    return y if forward or not normalize else y * (1.0 / n)


def fft_axis0_plain(x: torch.Tensor, forward: bool = True,
                    normalize: bool = True,
                    how: str | None = None) -> torch.Tensor:
    """The strided kernel's plain version, on route ``how`` (default:
    :func:`route` of the length; the fused kernels pass their own)."""
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


def _block_seqs(n: int, most: int, spill: int) -> tuple[int, bool]:
    """(sequences per block, in shared memory?) for length-n sequences:
    the most that fit ``_SMEM_BUDGET``, else ``spill`` per block through
    device scratch."""
    s = most
    while s > 1 and 16 * s * n > _SMEM_BUDGET:
        s //= 2
    if 16 * s * n <= _SMEM_BUDGET:
        return s, True
    return spill, False


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


def _luts(n: int, forward: bool, device) -> list:
    return [t.data_ptr() for t in device_tables(n, forward, device)]


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
    elif how == "radix2":
        scratch = torch.empty_like(x)
        _launch("dfft_fft_rows_2p", x, x.data_ptr(), y.data_ptr(),
                scratch.data_ptr(), batch,
                *_two_pass_args(n, forward, x.device), scale)
    else:
        n1, n2 = split_for(n)
        seqs, smem = _block_seqs(n, 16, 1)
        scratch = None if smem else torch.empty_like(x)
        _launch("dfft_fft_rows_direct", x, x.data_ptr(), y.data_ptr(),
                _ptr(scratch), batch, n1, n2, seqs,
                *_luts(n, forward, x.device), scale)
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
    elif how == "radix2":
        scratch = torch.empty_like(x)
        _launch("dfft_fft_strided_2p", x, x.data_ptr(), y.data_ptr(),
                scratch.data_ptr(), lead, cols,
                *_two_pass_args(n, forward, x.device), scale)
    else:
        n1, n2 = split_for(n)
        seqs, smem = _block_seqs(n, 16, 32)
        scratch = None if smem else torch.empty_like(x)
        _launch("dfft_fft_strided_direct", x, x.data_ptr(), y.data_ptr(),
                _ptr(scratch), lead, cols, n1, n2, seqs,
                *_luts(n, forward, x.device), scale)
    fft_axis0.launches += 1
    ROUTES[("fft_axis0", how)] += 1
    CASES[_case("fft_axis0", forward, x.shape, normalize)] += 1
    return y


def fft2_last(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    """2D DFT over the last two axes of ``x`` [batch, ny, nz] (the plane
    kernel); the inverse is scaled 1/(ny*nz)."""
    _check(x, 3, "fft2_last", x.shape[1], x.shape[2])
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
    how = route2d(ny, nz)
    if how == "radix":
        twy = radix.device_twiddles(ny, forward, x.device)
        twz = radix.device_twiddles(nz, forward, x.device)
        _launch("dfft_fft_plane", x, x.data_ptr(), y.data_ptr(), batch, ny,
                *_radices(ny), nz, *_radices(nz), int(forward),
                twy.data_ptr(), twz.data_ptr(), min(chunk, batch), scale)
    else:
        (y1, y2), (z1, z2) = split_for(ny), split_for(nz)
        seqs_z, z_smem = _block_seqs(nz, 16, 1)
        seqs_y, y_smem = _block_seqs(ny, 16, 32)
        scratch = None if z_smem and y_smem else torch.empty_like(x)
        _launch("dfft_fft_plane_direct", x, x.data_ptr(), y.data_ptr(),
                _ptr(scratch), batch, y1, y2, z1, z2, seqs_z, seqs_y,
                int(z_smem), int(y_smem), *_luts(ny, forward, x.device),
                *_luts(nz, forward, x.device), scale)
    fft2_last.launches += 1
    ROUTES[("fft2_last", how)] += 1
    CASES[_case("fft2_last", forward, x.shape)] += 1
    return y


fft_last.launches = 0
fft_axis0.launches = 0
fft2_last.launches = 0

#: The kernel wrappers, by the name the launch counts are reported under.
KERNELS = {"fft2_last": fft2_last, "fft_axis0": fft_axis0,
           "fft_last": fft_last}


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
    (``pallas_fft.outer_split``), or None."""
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
    """The two-level four-step over [batch, n] (``_fft_last_big``), its
    two DFT stages ``axis0`` and ``last`` unnormalized: with n = m1*m2
    (:func:`outer_split`), j = j1*m2 + j2 and k = k1 + m1*k2, the DFT over
    j1 of each [m1, m2] block (the strided kernel), the twiddle
    (:func:`_two_level_twiddle`), the DFT over j2 of the batch*m1 rows
    (the row kernel), and the transpose to k order. Unnormalized both
    ways: the inverse's 1/n is the caller's."""
    m1, m2 = outer_split(n)
    batch = x2.shape[0]
    b = axis0(x2.reshape(batch, m1, m2), forward, normalize=False)
    b = _two_level_twiddle(b, n, forward)
    c = last(b.reshape(batch * m1, m2), forward, normalize=False)
    return c.reshape(batch, m1, m2).transpose(1, 2).reshape(batch, n)


def _fft_last_big(x2: torch.Tensor, n: int, forward: bool) -> torch.Tensor:
    """The two-level transform of [batch, n] complex64 rows through the
    strided and row kernels (the JAX package's ``_fft_last_big``); on a
    CPU tensor each kernel's plain version runs."""
    return _two_level(x2, n, forward, fft_axis0, fft_last)


def _fft_last_big_plain(x2: torch.Tensor, n: int,
                        forward: bool) -> torch.Tensor:
    """:func:`_fft_last_big` with each stage's plain version."""
    return _two_level(x2, n, forward, fft_axis0_plain, fft_last_plain)


def fft_along_axis(x: torch.Tensor, axis: int,
                   forward: bool = True) -> torch.Tensor:
    """C2C DFT along one axis through the kernels: the last axis by the
    1D kernel, any other by the strided one with the axes before it as
    ``lead``. Routed as ``pallas_fft.fft_along_axis`` routes: a dtype
    other than complex64, an empty tensor, or a length with neither a
    kernel split nor a two-level one (:func:`outer_split`) runs
    :func:`.dft_matmul.fft_along_axis`, the reason counted in
    :data:`FALLBACKS`; a two-level length moves its axis last and runs
    :func:`_fft_last_big` (no fallback: both stages are kernels)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if x.dtype != torch.complex64 or x.numel() == 0:
        record_fallback(ax, "empty" if x.numel() == 0 else "dtype")
        return dft_matmul.fft_along_axis(x, ax, forward)
    shape = x.shape
    if not eligible(n):
        if outer_split(n) is None:
            record_fallback(ax, "length")
            return dft_matmul.fft_along_axis(x, ax, forward)
        moved = x.movedim(ax, -1)
        y = _fft_last_big(moved.reshape(-1, n).contiguous(), n, forward)
        if not forward:
            y = y * (1.0 / n)
        return y.reshape(moved.shape).movedim(-1, ax).contiguous()
    if ax < x.ndim - 1:
        lead = math.prod(shape[:ax])
        cols = math.prod(shape[ax + 1:])
        y = fft_axis0(x.reshape(lead, n, cols).contiguous(), forward)
    else:
        y = fft_last(x.reshape(-1, n).contiguous(), forward)
    return y.reshape(shape)
