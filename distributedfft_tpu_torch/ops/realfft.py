"""Real transforms via half-length complex FFTs: the packed-real trick.

A copy of ``distributedfft_tpu/ops/realfft.py`` in PyTorch. The real
sequence of even length n is viewed as a half-length complex one (even
samples the real part, odd samples the imaginary part), transformed with
the executor's own C2C engine, and untangled with one twiddle pass:

    z[m]  = x[2m] + i x[2m+1],           m = 0..h-1,  h = n/2
    Z     = FFT_h(z)
    X[k]  = (Z[k] + Z*[h-k])/2 - (i/2) e^{-2pi i k/n} (Z[k] - Z*[h-k])

for k = 0..h (with Z[h] = Z[0]): the n//2+1 non-redundant outputs. The
inverse packs the hermitian half back into a half-length complex signal
and runs the inverse C2C. The twiddle table (:func:`twiddle`) is built on
the host in float64 and uploaded once per (n, dtype, device), then kept.
Odd n is the caller's promote-and-slice path.

On the card, the ``cuda`` executor runs this math as one kernel each way
where the half length takes the radix route (``cuda_fft.r2c_half`` /
``c2r_half``, ``csrc/real_rows.cu``: the untangle in the rows pass's
store, the packing in its first stage's reader); the functions here are
that route's plain version and every other executor's real transform.

Spans: ``r2c_untangle`` and ``c2r_untangle`` around each transform (the
inner C2C opens its own), ``host_wait[rfft_twiddle]`` around the
twiddle's first upload to a device, a copy from pageable memory that
waits for the card.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.trace import add_trace

# c2c(x, axis, forward) -> y; numpy conventions (inverse scaled by 1/len).
C2CFn = Callable[..., torch.Tensor]


def _cdtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype in (torch.float64,
                                         torch.complex128) else torch.complex64


_TWIDDLES: dict = {}


def twiddle(n: int, cdtype: torch.dtype, device) -> torch.Tensor:
    """e^{-2pi i k / n} for k = 0..n/2, host-exact float64 rounded to
    ``cdtype``, on ``device``: uploaded once per (n, dtype, device) and
    kept, so a warm transform copies nothing from the host."""
    key = (n, cdtype, str(device))
    hit = _TWIDDLES.get(key)
    if hit is None:
        k = np.arange(n // 2 + 1)
        w = np.exp(-2j * np.pi * k / n)
        npdt = np.complex128 if cdtype == torch.complex128 else np.complex64
        host = torch.from_numpy(w.astype(npdt))
        with add_trace("host_wait[rfft_twiddle]"):
            hit = host.to(device)
        _TWIDDLES[key] = hit
    return hit


def r2c_via_half_complex(x: torch.Tensor, axis: int,
                         c2c: C2CFn) -> torch.Tensor:
    """Real-to-complex DFT along ``axis`` (extent n even) using a length-n/2
    complex transform from ``c2c``. Output extent n//2+1, unnormalized."""
    with add_trace("r2c_untangle"):
        n = x.shape[axis]
        if n % 2:
            raise ValueError(
                f"half-complex packing needs even extent, got {n}")
        if x.is_complex():
            raise ValueError(
                "half-complex packing takes REAL input; callers route "
                "complex operands through their promote-and-slice fallback")
        h = n // 2
        cdtype = _cdtype(x.dtype)
        rdtype = (torch.float64 if cdtype == torch.complex128
                  else torch.float32)
        xm = torch.movedim(x, axis, -1)
        pair = xm.reshape(xm.shape[:-1] + (h, 2))
        z = torch.complex(pair[..., 0].to(rdtype), pair[..., 1].to(rdtype))
        big = c2c(z.contiguous(), -1, True)
        zf = torch.cat([big, big[..., :1]], dim=-1)         # Z[h] = Z[0]
        zr = torch.conj(torch.flip(zf, dims=(-1,)))         # Z*[h-k]
        w = twiddle(n, cdtype, x.device)
        out = 0.5 * (zf + zr) - 0.5j * w * (zf - zr)
        return torch.movedim(out, -1, axis)


def c2r_via_half_complex(y: torch.Tensor, n: int, axis: int,
                         c2c: C2CFn) -> torch.Tensor:
    """Complex-to-real inverse DFT along ``axis`` back to true extent ``n``
    (even) from the n//2+1 hermitian half; scaled by 1/n (numpy
    convention). Uses a length-n/2 inverse complex transform."""
    with add_trace("c2r_untangle"):
        if n % 2:
            raise ValueError(
                f"half-complex packing needs even extent, got {n}")
        h = n // 2
        cdtype = _cdtype(y.dtype)
        ym = torch.movedim(y, axis, -1).to(cdtype)
        if ym.shape[-1] != h + 1:
            raise ValueError(
                f"expected {h + 1} hermitian coefficients for n={n}, "
                f"got {ym.shape[-1]}")
        yr = torch.conj(torch.flip(ym, dims=(-1,)))         # Y*[h-k]
        # E = (Y[k]+Y*[h-k])/2 holds FFT(even), O = (Y[k]-Y*[h-k])
        # e^{+2pi i k/n} / 2 holds FFT(odd); the packed half spectrum is
        # Z = E + iO.
        w = torch.conj(twiddle(n, cdtype, y.device))
        e = 0.5 * (ym + yr)
        o = 0.5 * (ym - yr) * w
        big = (e + 1j * o)[..., :h]
        z = c2c(big.contiguous(), -1, False)
        pair = torch.stack([z.real, z.imag], dim=-1)
        xm = pair.reshape(pair.shape[:-2] + (n,))
        return torch.movedim(xm, -1, axis)


def mirror_half_spectrum(y: torch.Tensor, n: int,
                         axis: int = -1) -> torch.Tensor:
    """Rebuild the full hermitian axis (true extent ``n``) from its
    non-redundant half (``distributedfft_tpu/ops/ddfft.py``'s
    ``mirror_half_spectrum``)."""
    h = y.shape[axis]
    m = torch.flip(y.narrow(axis, 1, n - h), dims=(axis,))
    return torch.cat([y, torch.conj(m).resolve_conj()], dim=axis)
