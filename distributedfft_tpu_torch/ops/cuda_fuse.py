"""Fused stage+codec kernels for the H100 and their plain PyTorch versions.

The port of ``distributedfft_tpu/ops/pallas_fuse.py``. Its two Pallas
mega-kernels become the CUDA launchers of ``csrc/fuse.cu``:

- :func:`fused_fft_encode` (``_make_encode_kernel``): the DFT along one
  axis, then the wire encode of the result (bf16 cast, or per-(tile,
  plane) pow2 quantization into int8/int16 with an f32 sidecar);
- :func:`fused_decode_fft` (``_make_decode_kernel``): the exact wire
  decode, then the DFT along one axis (inverse scaled 1/n).

Each takes the route :func:`.cuda_fft.fft_axis0` takes at the length
(:func:`fused_route`): ``radix`` for every eligible n <= 8192 (a prime
factor from 19 to 251 on the generic prime stage), ``radix2``, the
two-pass route, past it; and on it the passes of its unfused twin, the
kernel ``fft_along_axis`` runs there: the strided kernel's, or at a
last-axis site (cols = 1) the row kernel's (the row form). Each form is
counted in :data:`.cuda_fft.ROUTES` under ``fft_encode`` and
``decode_fft`` by :func:`fused_form`. Only the encode's storing pass and
the decode's reading pass differ from the twin's, in where a value goes
to or comes from, so on the card the encode equals the codec's encode
of ``fft_along_axis(x)`` and the decode equals ``fft_along_axis`` of the
decoded wire, bit for bit.

Both return what the JAX functions return: the encode gives the tuple
of wire parts, payload first, exactly shaped as
``wire_codec(name).encode`` shapes them; the decode gives the complex
array. A site the kernels do not take (:func:`kernel_ineligible`) runs
the unfused executor and codec, as the JAX package's mirror does, and is
counted in :data:`FUSION_FALLBACKS` by (site, reason). Otherwise a CPU
tensor runs the plain version (``*_plain``: the codec and
:func:`.cuda_fft.fft_axis0_plain` on the fused route) and a CUDA tensor
launches the kernel or raises. Each function counts its
launches in ``<function>.launches``.

One gate of the JAX package is not carried over: ``vmem``. The TPU
kernel holds the whole block in VMEM for one grid step, since the
per-(tile, plane) amax is a reduction over the block, and so refuses
blocks above 524288 elements. The CUDA encode reduces the amax across
blocks with atomics and the decode knows its steps in advance, so they
take blocks of any size. The values are those of the JAX mirror either
way, within fp32 rounding before the quantizer.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from ..parallel.exchange import wire_codec
from ..utils import metrics as _metrics
from . import cuda_fft, radix
from .cuda_fft import _launch, _ptr, _radices, _two_pass_args, eligible

#: Quantized codecs the kernels pack: name -> (signed levels, mantissa
#: dtype, codec id of the C interface). ``bf16`` is the cast-only codec.
_Q_CODECS = {"int8": (127.0, torch.int8, 1),
             "split": (32767.0, torch.int16, 2)}

#: Wire codecs with an in-kernel pack and unpack.
FUSABLE_CODECS = ("bf16",) + tuple(_Q_CODECS)

#: Fusion sites that route away from a fused kernel, by (site, reason):
#: the kernel gate's reasons (:func:`kernel_ineligible`), the stage
#: graph's sender/receiver routes and its graph-level gates.
FUSION_FALLBACKS: Counter = Counter()


def record_fusion_fallback(site, reason: str) -> None:
    """Count one site that runs unfused in :data:`FUSION_FALLBACKS` and
    in the metrics series ``fusion_fallback``."""
    FUSION_FALLBACKS[(str(site), str(reason))] += 1
    _metrics.inc("fusion_fallback", site=str(site), reason=str(reason))


def kernel_ineligible(shape, fft_axis: int, tile_axis: int, tiles: int,
                      dtype, wire_dtype: str) -> str | None:
    """Why the fused kernels cannot run this site, or None if they can:
    the JAX package's taxonomy (codec, dtype, empty, tile_axis, length,
    uneven_tiles) in its order, without ``vmem``."""
    if wire_dtype not in FUSABLE_CODECS:
        return "codec"
    if dtype != torch.complex64:
        return "dtype"
    if math.prod(int(s) for s in shape) == 0:
        return "empty"
    ndim = len(shape)
    fa, ta = fft_axis % ndim, tile_axis % ndim
    if fa != ta:
        return "tile_axis"
    n = int(shape[fa])
    if not eligible(n):
        return "length"
    if tiles < 1 or n % tiles:
        return "uneven_tiles"
    return None


def fused_route(n: int) -> str:
    """The fused kernels' route at length n: :func:`.cuda_fft.route`'s
    (``radix`` for every eligible n <= 8192, the generic prime stage
    included; ``radix2``, the two-pass route, past it)."""
    return cuda_fft.route(n)


def fused_form(n: int, cols: int) -> str:
    """The route a fused launch over [lead, n, cols] is counted under in
    :data:`.cuda_fft.ROUTES`: :func:`fused_route`, with ``_rows`` at
    cols = 1, where the kernels take the row form (the row kernel's
    rows pass; on the two-pass route its second pass)."""
    return fused_route(n) + ("_rows" if cols == 1 else "")


def _strided(shape, axis: int) -> tuple[int, int, int]:
    """(lead, n, cols) of the strided layout of a DFT along ``axis``."""
    ax = axis % len(shape)
    return (math.prod(shape[:ax]), int(shape[ax]),
            math.prod(shape[ax + 1:]))


def _sidecar_shape(ndim: int, axis: int, tiles: int) -> list[int]:
    bshape = [1] * (ndim + 1)
    bshape[axis % ndim] = tiles
    bshape[-1] = 2
    return bshape


# ------------------------------------------------------- plain versions

def fused_fft_encode_plain(x: torch.Tensor, *, fft_axis: int, forward: bool,
                           tile_axis: int, tiles: int,
                           wire_dtype: str) -> tuple:
    """The plain DFT along ``fft_axis`` (``fft_axis0_plain`` on the fused
    route), then the plain codec."""
    lead, n, cols = _strided(x.shape, fft_axis)
    y = cuda_fft.fft_axis0_plain(x.reshape(lead, n, cols).contiguous(),
                                 forward, how=fused_route(n))
    y = y.reshape(x.shape)
    return wire_codec(wire_dtype).encode(y, tile_axis=tile_axis, tiles=tiles)


def fused_decode_fft_plain(parts: tuple, dtype, *, fft_axis: int,
                           forward: bool, tile_axis: int, tiles: int,
                           wire_dtype: str) -> torch.Tensor:
    """The plain codec decode, then the plain DFT (``fft_axis0_plain`` on
    the fused route)."""
    y = wire_codec(wire_dtype).decode(parts, dtype, tile_axis=tile_axis,
                                      tiles=tiles)
    lead, n, cols = _strided(y.shape, fft_axis)
    return cuda_fft.fft_axis0_plain(y.reshape(lead, n, cols).contiguous(),
                                    forward, how=fused_route(n)
                                    ).reshape(y.shape)


# ------------------------------------------------------ kernel wrappers

def _device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")


def fused_fft_encode(x: torch.Tensor, *, fft_axis: int, forward: bool,
                     tile_axis: int, tiles: int, wire_dtype: str,
                     site: str = "fft_encode") -> tuple:
    """DFT along ``fft_axis`` and wire encode as one kernel: returns what
    ``wire_codec(wire_dtype).encode(dft(x), tile_axis=, tiles=)`` returns
    (the payload, then for int8/split the sidecar)."""
    codec = wire_codec(wire_dtype)
    reason = kernel_ineligible(x.shape, fft_axis, tile_axis, tiles, x.dtype,
                               wire_dtype)
    if reason is not None:
        record_fusion_fallback(site, reason)
        y = cuda_fft.fft_along_axis(x, fft_axis, forward)
        return codec.encode(y, tile_axis=tile_axis, tiles=tiles)
    _device(x, "fused_fft_encode")
    kw = dict(fft_axis=fft_axis, forward=forward, tile_axis=tile_axis,
              tiles=tiles, wire_dtype=wire_dtype)
    if x.device.type == "cpu":
        return fused_fft_encode_plain(x, **kw)
    lead, n, cols = _strided(x.shape, fft_axis)
    x3 = x.reshape(lead, n, cols).contiguous()
    scale = 1.0 if forward else 1.0 / n
    if wire_dtype == "bf16":
        levels, qdt, code = 0.0, torch.bfloat16, 0
    else:
        levels, qdt, code = _Q_CODECS[wire_dtype]
    q = torch.empty(tuple(x.shape) + (2,), dtype=qdt, device=x.device)
    amax = side = None
    if code:
        amax = torch.empty(2 * tiles, dtype=torch.int32, device=x.device)
        side = torch.empty((tiles, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x3) if code else None
    if fused_route(n) == "radix":
        tw = radix.device_twiddles(n, forward, x.device)
        _launch("dfft_fft_encode", x, x3.data_ptr(), _ptr(y), q.data_ptr(),
                _ptr(amax), _ptr(side), lead, cols, n, *_radices(n), tiles,
                code, levels, int(forward), tw.data_ptr(), scale)
    else:
        scratch = torch.empty_like(x3)
        _launch("dfft_fft_encode_2p", x, x3.data_ptr(), _ptr(y),
                scratch.data_ptr(), q.data_ptr(), _ptr(amax), _ptr(side),
                lead, cols, tiles, code, levels,
                *_two_pass_args(n, forward, x.device), scale)
    fused_fft_encode.launches += 1
    cuda_fft.ROUTES[("fft_encode", fused_form(n, cols))] += 1
    cuda_fft.CASES[("fft_encode", wire_dtype, bool(forward), tuple(x.shape),
                    fft_axis, tiles)] += 1
    if not code:
        return (q,)
    return (q, side.reshape(_sidecar_shape(x.dim(), fft_axis, tiles)))


def fused_decode_fft(parts: tuple, dtype, *, fft_axis: int, forward: bool,
                     tile_axis: int, tiles: int, wire_dtype: str,
                     site: str = "decode_fft") -> torch.Tensor:
    """Wire decode and DFT along ``fft_axis`` as one kernel: returns what
    ``dft(wire_codec(wire_dtype).decode(parts, dtype, tile_axis=,
    tiles=))`` returns. ``tile_axis`` names where the peer tiles sit now
    (the concat axis after an exchange)."""
    codec = wire_codec(wire_dtype)
    payload = parts[0]
    shape = tuple(payload.shape[:-1])
    reason = kernel_ineligible(shape, fft_axis, tile_axis, tiles, dtype,
                               wire_dtype)
    if reason is not None:
        record_fusion_fallback(site, reason)
        y = codec.decode(parts, dtype, tile_axis=tile_axis, tiles=tiles)
        return cuda_fft.fft_along_axis(y, fft_axis, forward)
    _device(payload, "fused_decode_fft")
    kw = dict(fft_axis=fft_axis, forward=forward, tile_axis=tile_axis,
              tiles=tiles, wire_dtype=wire_dtype)
    if payload.device.type == "cpu":
        return fused_decode_fft_plain(parts, dtype, **kw)
    if wire_dtype == "bf16":
        qdt, code, side = torch.bfloat16, 0, None
    else:
        _, qdt, code = _Q_CODECS[wire_dtype]
        side = parts[1].reshape(tiles, 2).to(torch.float32).contiguous()
    if payload.dtype != qdt:
        raise ValueError(
            f"fused_decode_fft: {wire_dtype} payload must be {qdt}, got "
            f"{payload.dtype}")
    lead, n, cols = _strided(shape, fft_axis)
    q = payload.contiguous()
    y = torch.empty(shape, dtype=torch.complex64, device=payload.device)
    scale = 1.0 if forward else 1.0 / n
    if fused_route(n) == "radix":
        tw = radix.device_twiddles(n, forward, payload.device)
        _launch("dfft_decode_fft", payload, q.data_ptr(), _ptr(side),
                y.data_ptr(), lead, cols, n, *_radices(n), tiles, code,
                int(forward), tw.data_ptr(), scale)
    else:
        scratch = torch.empty_like(y)
        _launch("dfft_decode_fft_2p", payload, q.data_ptr(), _ptr(side),
                y.data_ptr(), scratch.data_ptr(), lead, cols, tiles, code,
                *_two_pass_args(n, forward, payload.device), scale)
    fused_decode_fft.launches += 1
    cuda_fft.ROUTES[("decode_fft", fused_form(n, cols))] += 1
    cuda_fft.CASES[("decode_fft", wire_dtype, bool(forward), shape,
                    fft_axis, tiles)] += 1
    return y


fused_fft_encode.launches = 0
fused_decode_fft.launches = 0

#: The kernel wrappers, by the name the launch counts are reported under.
KERNELS = {"fft_encode": fused_fft_encode, "decode_fft": fused_decode_fft}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
