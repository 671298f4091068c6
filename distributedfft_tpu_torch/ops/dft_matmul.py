"""DFT by matrix multiplication: the ``matmul`` executor and the ``cuda``
executor's fallback.

The port of ``distributedfft_tpu/ops/dft_matmul.py`` on torch tensors.
A length at or below :func:`direct_max` is one dense contraction against
its n x n DFT matrix; a longer one is split n = n1 * n2 (the four-step,
or Bailey, decomposition) and recursed:

    view x as A[j1, j2] (j = j1*n2 + j2)
    B[k1, j2] = DFT_n1 over j1
    B        *= w_n^{k1 * j2}
    C[k1, k2] = DFT_n2 over j2
    X[k2*n1 + k1] = C[k1, k2]

Primes above both :func:`direct_max` and :data:`BLUESTEIN_MIN` take
Bluestein's chirp-z transform at a power-of-two length. Every table is
built on the host in float64 and cast to the working dtype. Forward is
unnormalized and the inverse scaled 1/n (numpy convention).

The products are ``torch.einsum`` over real operands: each complex
product is four real ones (``native``) or three (``gauss``), so the
precision tier governs every product. Tiers (set by :func:`mm_scope`,
which the tiered executor labels enter; outside any scope
``DFFT_MM_PRECISION``, unset ``highest``),
on float32 operands on the card:
``highest`` full fp32 with TF32 off, ``high`` (the ``f32`` executor tier)
TF32, ``default`` (``bf16``) operands rounded to bfloat16 and the
products accumulated in fp32. On the CPU, and for float64 operands, every
tier is the full-precision product (as JAX's CPU backend ignores the
precision). A tier's TF32 switch is set for its products only and
restored after each. The JAX package's block-diagonal packing of short
lengths (``pack_factor``) is a TPU layout choice and is not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os

import numpy as np
import torch

from .. import native

# Largest factor transformed as one dense DFT matmul.
DIRECT_MAX = 128

# Prime lengths above this (and above direct_max) use Bluestein's chirp-z
# transform instead of the O(n^2) dense matmul.
BLUESTEIN_MIN = 512

PRECISIONS = ("default", "high", "highest")


def direct_max() -> int:
    """The dense tier's bound: 128 (the JAX package's CPU bound; its TPU
    bound, 512, does not carry over), or ``DFFT_MM_DIRECT_MAX``, an
    integer >= 2."""
    env = os.environ.get("DFFT_MM_DIRECT_MAX")
    if env:
        try:
            bound = int(env)
        except ValueError:
            raise ValueError(
                f"DFFT_MM_DIRECT_MAX={env!r} is not an integer") from None
        if bound < 2:
            raise ValueError(
                f"DFFT_MM_DIRECT_MAX={env!r}: bound must be >= 2 (a "
                f"sub-2 bound would silently disable the dense tier)")
        return bound
    return DIRECT_MAX


@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, forward: bool) -> np.ndarray:
    """Dense n x n DFT matrix W[j, k] = exp(-+ 2 pi i j k / n), float64."""
    sign = -2j if forward else 2j
    jk = np.outer(np.arange(n), np.arange(n))
    return np.exp(sign * np.pi * (jk % n) / n)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n: int, n1: int, n2: int, forward: bool) -> np.ndarray:
    """Inter-stage twiddles w_n^{k1*j2} of shape [n1, n2], float64."""
    sign = -2j if forward else 2j
    k1j2 = np.outer(np.arange(n1), np.arange(n2))
    return np.exp(sign * np.pi * (k1j2 % n) / n)


def _split_override(n: int) -> tuple[int, int] | None:
    """Per-length four-step split from ``DFFT_MM_SPLIT`` (``"512=4x128,
    256=2x128"``). Invalid entries, and keys at or under the always-dense
    floor, raise."""
    spec = os.environ.get("DFFT_MM_SPLIT", "").strip()
    if not spec:
        return None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            key, val = part.split("=")
            a, b = (int(v) for v in val.split("x"))
        except ValueError:
            raise ValueError(
                f"DFFT_MM_SPLIT entry {part!r} is not N=AxB") from None
        floor = min(DIRECT_MAX, direct_max())
        if int(key) <= floor:
            raise ValueError(
                f"DFFT_MM_SPLIT {part!r}: length {key} is at or under the "
                f"always-dense floor ({floor}); the split is policy-blocked "
                f"there, set DFFT_MM_DIRECT_MAX lower to unblock it")
        if int(key) == n:
            if a * b != n or a < 2 or b < 2:
                raise ValueError(
                    f"DFFT_MM_SPLIT {part!r}: {a}x{b} != {n} or factor < 2")
            return (a, b)
    return None


def _best_split(n: int) -> tuple[int, int] | None:
    """Divisor pair (n1, n2), n1 <= n2, n1 as close to sqrt(n) as
    possible; None for primes."""
    return native.balanced_split(n, n)


# Plan-scoped precision and complex-mode overrides, entered by the tiered
# executor labels (``matmul:bf16``...) around each call.
_PRECISION_OVERRIDE: contextvars.ContextVar[str | None] = (
    contextvars.ContextVar("dfft_mm_precision_override", default=None))
_COMPLEX_OVERRIDE: contextvars.ContextVar[str | None] = (
    contextvars.ContextVar("dfft_mm_complex_override", default=None))


@contextlib.contextmanager
def mm_scope(precision: str | None = None, complex_mode: str | None = None):
    """Scope a precision (``"default"|"high"|"highest"``) and complex
    mode (``"native"|"gauss"``) over the products computed inside it;
    ``None`` leaves that setting as the enclosing scope has it
    (``highest`` and ``native`` outside any scope)."""
    tokens = []
    if precision is not None:
        tokens.append((_PRECISION_OVERRIDE,
                       _PRECISION_OVERRIDE.set(precision)))
    if complex_mode is not None:
        tokens.append((_COMPLEX_OVERRIDE,
                       _COMPLEX_OVERRIDE.set(complex_mode)))
    try:
        yield
    finally:
        for var, tok in reversed(tokens):
            var.reset(tok)


def mm_precision() -> str:
    """The precision of every product: the scope's, else
    ``DFFT_MM_PRECISION`` (``default``, ``high`` or ``highest``; unset:
    ``highest``). Read at call time."""
    s = _PRECISION_OVERRIDE.get()
    if s is None:
        s = os.environ.get("DFFT_MM_PRECISION", "highest").strip().lower()
    if s not in PRECISIONS:
        raise ValueError(f"DFFT_MM_PRECISION={s!r} is not a precision "
                         f"tier; use one of {sorted(PRECISIONS)}")
    return s


def complex_mode() -> str:
    """How a complex product is computed: ``native`` (four real
    products) or ``gauss`` (three: m1 = (xr+xi) Wr, m2 = xr (Wi-Wr),
    m3 = xi (Wi+Wr), y = (m1-m3) + i (m1+m2)). The scope's, else
    ``DFFT_MM_COMPLEX`` (unset: ``native``)."""
    m = _COMPLEX_OVERRIDE.get()
    if m is None:
        m = os.environ.get("DFFT_MM_COMPLEX", "native").strip().lower()
    if m not in ("native", "gauss"):
        raise ValueError(f"DFFT_MM_COMPLEX={m!r} is not a complex-product "
                         f"mode; use 'native' or 'gauss'")
    return m


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for the card's float32 products inside, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _real_product(pat: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(pat, x, w)`` of real operands at the current tier."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        return torch.einsum(pat, x, w)
    prec = mm_precision()
    if prec == "default":
        x = x.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    with _tf32(prec == "high"):
        return torch.einsum(pat, x, w)


_CONSTS: dict = {}


def _const(key, build, dtype: torch.dtype, device) -> torch.Tensor:
    """A host-built float64/complex128 table as a tensor of ``dtype`` on
    ``device``, kept per (table, dtype, device)."""
    k = (key, dtype, str(device))
    hit = _CONSTS.get(k)
    if hit is None:
        hit = _CONSTS[k] = torch.from_numpy(
            np.ascontiguousarray(build())).to(device=device, dtype=dtype)
    return hit


def _complex_product(x: torch.Tensor, w_key, w_build, pat: str
                     ) -> torch.Tensor:
    """``einsum(pat, x, W)`` for complex x and a constant complex W
    (built by ``w_build``) as real products: four, or three under
    ``gauss``."""
    rdt = x.real.dtype
    xr, xi = x.real, x.imag
    table = lambda part, f: _const((w_key, part), lambda: f(w_build()), rdt,
                                   x.device)
    wr = table("re", np.real)
    if complex_mode() == "gauss":
        d1 = table("im-re", lambda w: np.imag(w) - np.real(w))
        d2 = table("im+re", lambda w: np.imag(w) + np.real(w))
        m1 = _real_product(pat, xr + xi, wr)
        m2 = _real_product(pat, xr, d1)
        m3 = _real_product(pat, xi, d2)
        return torch.complex(m1 - m3, m1 + m2)
    wi = table("im", np.imag)
    yr = _real_product(pat, xr, wr) - _real_product(pat, xi, wi)
    yi = _real_product(pat, xr, wi) + _real_product(pat, xi, wr)
    return torch.complex(yr, yi)


def _direct(x: torch.Tensor, forward: bool) -> torch.Tensor:
    """Dense DFT of the last axis: one contraction against W_n."""
    n = x.shape[-1]
    return _complex_product(x, ("dft", n, forward),
                            lambda: _dft_matrix_np(n, forward),
                            "...j,jk->...k")


@functools.lru_cache(maxsize=None)
def _bluestein_tables(n: int, m: int, forward: bool):
    """The chirp w[j] = exp(-+ i pi j^2 / n) (j^2 reduced mod 2n) and the
    length-m DFT of the symmetric chirp kernel, float64."""
    j = np.arange(n)
    sign = -1j if forward else 1j
    w = np.exp(sign * np.pi * ((j * j) % (2 * n)) / n)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(w)
    b[m - n + 1:] = np.conj(w[1:][::-1])
    return w, np.fft.fft(b)


def _bluestein(x: torch.Tensor, forward: bool) -> torch.Tensor:
    """Bluestein (chirp-z) DFT of a large prime length as a circular
    convolution at a power-of-two length m >= 2n - 1."""
    n = x.shape[-1]
    m = 1 << (2 * n - 1).bit_length()
    w = _const(("chirp", n, m, forward),
               lambda: _bluestein_tables(n, m, forward)[0], x.dtype, x.device)
    big = _const(("chirp_kernel", n, m, forward),
                 lambda: _bluestein_tables(n, m, forward)[1], x.dtype,
                 x.device)
    a = torch.nn.functional.pad(x * w, (0, m - n))
    c = _fft_last(_fft_last(a, True) * big, False)   # unnormalized inverse
    return c[..., :n] * w * (1.0 / m)


def _fft_last(x: torch.Tensor, forward: bool) -> torch.Tensor:
    """Unnormalized DFT along the last axis (both directions)."""
    n = x.shape[-1]
    if n == 1:
        return x
    split = _split_override(n)
    if split is None and n > direct_max():
        split = _best_split(n)
    if split is None:
        if n > max(direct_max(), BLUESTEIN_MIN):
            return _bluestein(x, forward)
        return _direct(x, forward)
    n1, n2 = split
    a = x.reshape(x.shape[:-1] + (n1, n2))
    # DFT_n1 along axis -2: swap to last, recurse, swap back.
    b = _fft_last(a.transpose(-1, -2), forward).transpose(-1, -2)
    b = b * _const(("twiddle", n, n1, n2, forward),
                   lambda: _twiddle_np(n, n1, n2, forward), x.dtype, x.device)
    c = _fft_last(b, forward)            # DFT_n2 along the last axis
    # c is indexed [..., k1, k2]; the output index is k2*n1 + k1.
    return c.transpose(-1, -2).reshape(x.shape)


def _direct_axis(x: torch.Tensor, axis: int, forward: bool) -> torch.Tensor:
    """Dense DFT contracting ``axis`` in place (no moveaxis copies)."""
    n = x.shape[axis]
    subs = "abcdefgh"[: x.ndim]
    j = subs[axis]
    pat = f"{subs},{j}z->{subs.replace(j, 'z')}"
    return _complex_product(x, ("dft", n, forward),
                            lambda: _dft_matrix_np(n, forward), pat)


def fft_along_axis(x: torch.Tensor, axis: int,
                   forward: bool = True) -> torch.Tensor:
    """C2C DFT along one axis by matmuls. A real input is promoted to
    complex64 (complex128 from 8-byte reals). Forward unnormalized,
    inverse scaled 1/n."""
    if not x.is_complex():
        x = x.to(torch.complex128 if x.element_size() >= 8
                 else torch.complex64)
    n = x.shape[axis]
    ax = axis % x.ndim
    if x.numel() == 0:
        return x.clone()
    if (1 < n <= direct_max() and _split_override(n) is None
            and ax != x.ndim - 1 and x.ndim <= 8):
        y = _direct_axis(x, ax, forward)
    else:
        moved = ax != x.ndim - 1
        y = _fft_last(torch.movedim(x, ax, -1) if moved else x, forward)
        if moved:
            y = torch.movedim(y, -1, ax)
    if not forward:
        y = y * (1.0 / n)
    return y.contiguous()
