"""Four-step FFT kernels for the H100 and their plain PyTorch versions.

The port of ``distributedfft_tpu/ops/pallas_fft.py``. Its three Pallas
kernels become the CUDA launchers of ``csrc/four_step.cu``:

- :func:`fft2_last` (``_make_kernel2d``): 2D DFT over the last two axes of
  [batch, ny, nz];
- :func:`fft_axis0` (``_make_kernel_strided``): DFT over the middle axis of
  [lead, n, cols] -- the leading ``lead`` dimension replaces the JAX
  package's ``vmap`` over middle axes;
- :func:`fft_last` (``_make_kernel``): DFT over the rows of [batch, n].

Each wrapper takes complex64, contiguous tensors. On a CPU tensor it runs
its plain version (``*_plain``: the ``_four_step_ref`` math as
``torch.einsum`` with the same LUTs); on a CUDA tensor it launches its
kernel or raises. Each counts its launches in ``<wrapper>.launches``.

The split n = n1*n2 (both factors <= 256) and the float64-built LUTs are
the JAX package's, bit for bit. Forward transforms are unnormalized,
inverse ones scaled by 1/n (numpy convention).
"""

from __future__ import annotations

import functools
import math
from collections import Counter

import numpy as np
import torch

from .. import native
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
#: and ``length`` count transforms the ``cuda`` executor refuses.
FALLBACKS: Counter = Counter()


def split_for(n: int) -> tuple[int, int] | None:
    """(n1, n2) factor pair the kernels run, or None."""
    return native.balanced_split(n, MAX_FACTOR)


def eligible(n: int) -> bool:
    """Axis lengths the kernels handle."""
    return n >= 64 and split_for(n) is not None


def eligible2d(ny: int, nz: int) -> bool:
    """Planes the 2D route takes: both axes eligible and ny*nz bounded."""
    return eligible(ny) and eligible(nz) and ny * nz <= _MAX_PLANE_ELEMS


def record_fallback(axis: int, reason: str) -> None:
    FALLBACKS[(int(axis), reason)] += 1


def ineligible_reason(x: torch.Tensor, n: int) -> str | None:
    """Why the kernels cannot transform a length-``n`` axis of ``x``
    (the JAX package's fallback reasons), or None."""
    if x.dtype != torch.complex64:
        return "dtype"
    if x.numel() == 0:
        return "empty"
    if not eligible(n):
        return "length"
    return None


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


def fft_last_plain(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    n = x.shape[-1]
    y = four_step_plain(x, n, forward)
    return y if forward else y * (1.0 / n)


def fft_axis0_plain(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    lead, n, cols = x.shape
    y = four_step_plain(x.transpose(1, 2).reshape(-1, n), n, forward)
    y = y.reshape(lead, cols, n).transpose(1, 2).contiguous()
    return y if forward else y * (1.0 / n)


def fft2_last_plain(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    b, ny, nz = x.shape
    y = four_step_plain(x.reshape(-1, nz), nz, forward).reshape(b, ny, nz)
    y = four_step_plain(y.transpose(1, 2).reshape(-1, ny), ny, forward)
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(library(), name)(*args, stream), name)


def _luts(n: int, forward: bool, device) -> list:
    return [t.data_ptr() for t in device_tables(n, forward, device)]


def fft_last(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    """DFT over the rows of ``x`` [batch, n] (the 1D kernel)."""
    _check(x, 2, "fft_last", x.shape[1])
    if x.device.type == "cpu":
        return fft_last_plain(x, forward)
    batch, n = x.shape
    n1, n2 = split_for(n)
    seqs, smem = _block_seqs(n, 16, 1)
    y = torch.empty_like(x)
    scratch = None if smem else torch.empty_like(x)
    scale = 1.0 if forward else 1.0 / n
    _launch("dfft_fft_rows", x, x.data_ptr(), y.data_ptr(), _ptr(scratch),
            batch, n1, n2, seqs, *_luts(n, forward, x.device), scale)
    fft_last.launches += 1
    return y


def fft_axis0(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    """DFT over axis 1 of ``x`` [lead, n, cols]: the leading-axis
    transform of each of ``lead`` [n, cols] blocks (the strided kernel;
    a plain axis-0 transform passes lead = 1)."""
    _check(x, 3, "fft_axis0", x.shape[1])
    if x.device.type == "cpu":
        return fft_axis0_plain(x, forward)
    lead, n, cols = x.shape
    n1, n2 = split_for(n)
    seqs, smem = _block_seqs(n, 16, 32)
    y = torch.empty_like(x)
    scratch = None if smem else torch.empty_like(x)
    scale = 1.0 if forward else 1.0 / n
    _launch("dfft_fft_strided", x, x.data_ptr(), y.data_ptr(),
            _ptr(scratch), lead, cols, n1, n2, seqs,
            *_luts(n, forward, x.device), scale)
    fft_axis0.launches += 1
    return y


def fft2_last(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    """2D DFT over the last two axes of ``x`` [batch, ny, nz] (the plane
    kernel); the inverse is scaled 1/(ny*nz)."""
    _check(x, 3, "fft2_last", x.shape[1], x.shape[2])
    if x.device.type == "cpu":
        return fft2_last_plain(x, forward)
    batch, ny, nz = x.shape
    (y1, y2), (z1, z2) = split_for(ny), split_for(nz)
    seqs_z, z_smem = _block_seqs(nz, 16, 1)
    seqs_y, y_smem = _block_seqs(ny, 16, 32)
    y = torch.empty_like(x)
    scratch = None if z_smem and y_smem else torch.empty_like(x)
    scale = 1.0 / (ny * nz) if not forward else 1.0
    _launch("dfft_fft_plane", x, x.data_ptr(), y.data_ptr(), _ptr(scratch),
            batch, y1, y2, z1, z2, seqs_z, seqs_y, int(z_smem), int(y_smem),
            *_luts(ny, forward, x.device), *_luts(nz, forward, x.device),
            scale)
    fft2_last.launches += 1
    return y


fft_last.launches = 0
fft_axis0.launches = 0
fft2_last.launches = 0

#: The kernel wrappers, by the name the launch counts are reported under.
KERNELS = {"fft2_last": fft2_last, "fft_axis0": fft_axis0,
           "fft_last": fft_last}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


# ------------------------------------------------------------- routing

def fft_along_axis(x: torch.Tensor, axis: int,
                   forward: bool = True) -> torch.Tensor:
    """C2C DFT along one axis through the kernels: the last axis by the
    1D kernel, any other by the strided one with the axes before it as
    ``lead``. Lengths, dtypes and sizes the kernels do not take raise
    ``ValueError`` naming the reason (counted in :data:`FALLBACKS`)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    reason = ineligible_reason(x, n)
    if reason is not None:
        record_fallback(ax, reason)
        raise ValueError(
            f"cuda executor: axis {ax} of {tuple(x.shape)} {x.dtype} is not "
            f"kernel-eligible (reason: {reason}); the dft_matmul route is "
            f"not ported yet")
    shape = x.shape
    if ax < x.ndim - 1:
        lead = math.prod(shape[:ax])
        cols = math.prod(shape[ax + 1:])
        y = fft_axis0(x.reshape(lead, n, cols).contiguous(), forward)
    else:
        y = fft_last(x.reshape(-1, n).contiguous(), forward)
    return y.reshape(shape)
