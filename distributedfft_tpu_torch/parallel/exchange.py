"""The t2 global transpose: a tiled all-to-all over a :class:`~.mesh.World`,
and the wire codecs that compress it.

The port of the dense ``alltoall`` of ``distributedfft_tpu/parallel/
exchange.py`` (``exchange``, ``exchange_uneven``, ``_pad_axis``) and of
its wire-codec registry (``:186-474``). Each rank splits its block into P
equal chunks along ``split_axis``, sends chunk d to rank d, and
concatenates what it receives, in sender order, along ``concat_axis`` --
the semantics of ``lax.all_to_all(tiled=True)``.

Blocks travel as a list: one per rank this process holds (all on a
loopback world, its own on a process group). On a 2D world an exchange
names its mesh axis and runs within each group of that axis (the
world's rows or columns); on a 1D world the group is the whole world.
A process group ships every tensor as a ``uint8`` view of its trailing
axis, so the wire parts (bf16, int8, int16, f32) need no dtype support
from gloo or NCCL.

Wire codecs (``wire_dtype``): ``bf16`` casts the (real, imag) planes to
bfloat16; ``int8`` and ``split`` quantize them with one power-of-two step
per (peer tile, component plane) into int8 (127 levels) or int16
(32767 levels) mantissas, the steps riding as a small f32 sidecar. Given
the same input the encoders give the JAX package's bits: the same
rounding (half to even), the same f32 step expression, the same shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import pad_to
from .mesh import SLAB_AXIS, World


def _pad_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to extent ``to`` (no-op when already there)."""
    if x.shape[axis] == to:
        return x
    shape = list(x.shape)
    shape[axis] = to - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _crop_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    if x.shape[axis] == to:
        return x
    return x.narrow(axis, 0, to)


# ------------------------------------------------------------ wire codecs

def _check_complex(x: torch.Tensor) -> None:
    if not x.is_complex():
        raise TypeError(
            f"wire compression applies to complex exchange payloads, "
            f"got {x.dtype}")


def _component_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(real, imag) stacked on a new trailing axis, float32."""
    return torch.stack([x.real, x.imag], dim=-1).to(torch.float32)


def _unplanes(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    rdt = _component_dtype(dtype)
    return torch.complex(vals[..., 0].to(rdt), vals[..., 1].to(rdt)).to(dtype)


def _bf16_encode(x: torch.Tensor, *, tile_axis: int = 0,
                 tiles: int = 1) -> tuple:
    """bf16 wire form: (real, imag) as a trailing bfloat16 pair, rounded to
    nearest even. Elementwise (``tile_axis``/``tiles`` unused)."""
    _check_complex(x)
    return (torch.stack([x.real, x.imag], dim=-1).to(torch.bfloat16),)


def _bf16_decode(parts, dtype, *, tile_axis: int = 0,
                 tiles: int = 1) -> torch.Tensor:
    (y,) = parts
    return _unplanes(y, dtype)


def exact_pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**k`` for integer-valued ``k``, built from the
    exponent bits and clamped to the normal range."""
    kk = torch.clamp(k, -126.0, 127.0).to(torch.int32)
    return ((kk + 127) << 23).view(torch.float32)


#: 1/ln 2 in float32: XLA evaluates an f32 ``log2(q)`` as ``log(q)`` times
#: this constant, which can sit 1 ulp off an integer where q is a power
#: of two. The steps below use that same expression rather than
#: ``torch.log2``, so they are the JAX package's steps bit for bit there
#: too.
_INV_LN2 = np.float32(1.0 / np.log(2.0))


def _pow2_step_levels(amax: torch.Tensor, levels: float) -> torch.Tensor:
    """Power-of-two step covering ``amax`` in ``levels`` signed levels:
    ``2**ceil(log2(amax / levels))`` in float32, 1.0 where amax is 0."""
    lv = torch.tensor(levels, dtype=torch.float32, device=amax.device)
    safe = torch.where(amax > 0.0, amax, lv)
    step = exact_pow2(torch.ceil(torch.log(safe / lv) * float(_INV_LN2)))
    return torch.where(amax > 0.0, step, torch.ones_like(step))


def _pow2_step(amax: torch.Tensor) -> torch.Tensor:
    """The int8 step: 127 signed levels."""
    return _pow2_step_levels(amax, 127.0)


def _pow2_step16(amax: torch.Tensor) -> torch.Tensor:
    """The split (int16) step: 32767 signed levels."""
    return _pow2_step_levels(amax, 32767.0)


def _per_row(scales: torch.Tensor, t: int, c: int, extent: int) -> torch.Tensor:
    """Each tile's step repeated over its ``c`` rows of axis ``t``, cut to
    ``extent`` rows."""
    return _crop_axis(torch.repeat_interleave(scales, c, dim=t), t, extent)


def _quant_encode(x: torch.Tensor, tile_axis: int, tiles: int,
                  levels: float, qdt: torch.dtype) -> tuple:
    """Per-(tile, plane) pow2 quantization: ``(q, scales)`` with ``q`` of
    shape ``x.shape + (2,)`` and ``scales`` f32 with ``tiles`` on
    ``tile_axis``, 1 on every other payload axis, and the trailing plane
    pair. The tile axis is ceil-split: c = ceil(S / tiles) rows each."""
    _check_complex(x)
    planes = _planes(x)
    t = tile_axis % x.dim()
    p = max(1, int(tiles))
    s = planes.shape[t]
    c = -(-s // p)
    padded = _pad_axis(planes, t, p * c)
    shp = tuple(padded.shape)
    view = padded.reshape(shp[:t] + (p, c) + shp[t + 1:])
    red = tuple(a for a in range(view.dim()) if a != t and a != view.dim() - 1)
    amax = torch.amax(torch.abs(view), dim=red, keepdim=True)
    bshape = [1] * planes.dim()
    bshape[t] = p
    bshape[-1] = 2
    scales = _pow2_step_levels(amax, levels).reshape(bshape)
    per_row = _per_row(scales, t, c, s)
    q = torch.clamp(torch.round(planes / per_row), -levels, levels).to(qdt)
    return (q, scales)


def _quant_decode(parts, dtype, *, tile_axis: int = 0,
                  tiles: int = 1) -> torch.Tensor:
    """Inverse of :func:`_quant_encode`, ``tile_axis`` naming the axis the
    peer tiles sit on now (the concat axis after an exchange). Exact:
    mantissa times a power of two."""
    q, scales = parts
    t = tile_axis % (q.dim() - 1)
    p = max(1, int(tiles))
    s = q.shape[t]
    c = -(-s // p)
    vals = q.to(torch.float32) * _per_row(scales, t, c, s)
    return _unplanes(vals, dtype)


def _int8_encode(x, *, tile_axis: int = 0, tiles: int = 1) -> tuple:
    return _quant_encode(x, tile_axis, tiles, 127.0, torch.int8)


def _split_encode(x, *, tile_axis: int = 0, tiles: int = 1) -> tuple:
    return _quant_encode(x, tile_axis, tiles, 32767.0, torch.int16)


@dataclass(frozen=True)
class WireCodec:
    """One on-wire compression codec of the t2 exchange. ``pair_bytes``
    is the wire bytes per complex element (sidecar included);
    ``encode(x, tile_axis=, tiles=)`` returns the tuple of wire parts,
    payload first; ``decode(parts, dtype, tile_axis=, tiles=)`` restores
    the complex payload with ``tile_axis`` naming where the peer tiles
    sit at decode time. ``sidecar`` flags a multi-part wire."""

    name: str
    pair_bytes: int
    encode: Any
    decode: Any
    sidecar: bool = False


#: The codec registry, one entry per ``wire_dtype`` string.
WIRE_CODECS: dict[str, WireCodec] = {}
WIRE_DTYPES: tuple = (None,)
_WIRE_PAIR_BYTES: dict = {}


def register_wire_codec(codec: WireCodec) -> WireCodec:
    """Register a codec and rebuild the menu and byte tables."""
    global WIRE_DTYPES
    WIRE_CODECS[codec.name] = codec
    _WIRE_PAIR_BYTES[codec.name] = int(codec.pair_bytes)
    WIRE_DTYPES = (None,) + tuple(WIRE_CODECS)
    return codec


register_wire_codec(WireCodec(
    name="bf16", pair_bytes=4, encode=_bf16_encode, decode=_bf16_decode))
register_wire_codec(WireCodec(
    name="int8", pair_bytes=2, encode=_int8_encode, decode=_quant_decode,
    sidecar=True))
register_wire_codec(WireCodec(
    name="split", pair_bytes=4, encode=_split_encode, decode=_quant_decode,
    sidecar=True))


def wire_codec(name: str) -> WireCodec:
    """The registered codec ``name``; raises with the menu otherwise."""
    try:
        return WIRE_CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire_dtype {name!r}; use one of {WIRE_DTYPES}") from None


def wire_itemsize(itemsize: int, wire_dtype: str | None) -> int:
    """Bytes per element on the wire for ``itemsize``-byte complex
    elements under ``wire_dtype`` (None: the payload as it is)."""
    if wire_dtype is None:
        return int(itemsize)
    try:
        return _WIRE_PAIR_BYTES[wire_dtype]
    except KeyError:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; use one of {WIRE_DTYPES}"
        ) from None


_WIRE_ERR_CACHE: dict = {}


def wire_roundtrip_error(dtype, wire_dtype: str | None = "bf16",
                         n: int = 4096) -> float:
    """Relative round-trip error of one wire cast, max |decode(encode(x))
    - x| / max |x|, over the JAX package's seeded standard-normal complex
    block of ``n`` elements tiled 8 ways. 0.0 for the exact wire."""
    if wire_dtype is None:
        return 0.0
    codec = wire_codec(wire_dtype)
    npdt = np.dtype(np.complex128 if dtype == torch.complex128
                    else np.complex64)
    key = (str(npdt), wire_dtype, int(n))
    hit = _WIRE_ERR_CACHE.get(key)
    if hit is not None:
        return hit
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(npdt)
    xt = torch.from_numpy(x)
    parts = codec.encode(xt, tile_axis=0, tiles=8)
    y = codec.decode(parts, xt.dtype, tile_axis=0, tiles=8).numpy()
    err = float(np.max(np.abs(y - x)) / np.max(np.abs(x)))
    _WIRE_ERR_CACHE[key] = err
    return err


# -------------------------------------------------------------- transport

def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as uint8, its trailing axis widened by the item size."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        real = _component_dtype(like.dtype)
        return torch.view_as_complex(b.view(real))
    return b.view(like.dtype)


def _all_to_all(blocks: list[torch.Tensor], world: World, split_axis: int,
                concat_axis: int, mesh_axis: str) -> list[torch.Tensor]:
    p = world.axis_size(mesh_axis)
    if p == 1:
        return list(blocks)
    if world.loopback:
        out: list = [None] * len(blocks)
        for members in world.axis_members(mesh_axis):
            chunks = [blocks[m].tensor_split(p, dim=split_axis)
                      for m in members]
            for d, dst in enumerate(members):
                out[dst] = torch.cat([chunks[s][d] for s in range(p)],
                                     dim=concat_axis)
        return out
    (x,) = blocks
    send = torch.stack(x.tensor_split(p, dim=split_axis))
    raw = _as_bytes(send)
    recv = torch.empty_like(raw)
    dist.all_to_all_single(recv, raw, group=world.axis_group(mesh_axis))
    return [torch.cat(_from_bytes(recv, send).unbind(0), dim=concat_axis)]


def exchange(blocks: list[torch.Tensor], world: World, *, split_axis: int,
             concat_axis: int, wire_dtype: str | None = None,
             mesh_axis: str = SLAB_AXIS) -> list[torch.Tensor]:
    """Tiled all-to-all of every held block within each group of
    ``mesh_axis`` (the whole world on a 1D world); ``split_axis`` must
    divide by the group size. ``wire_dtype`` encodes each block on the
    split axis (one tile per peer), ships every wire part, and decodes on
    the concat axis."""
    p = world.axis_size(mesh_axis)
    if len(blocks) != len(world.ranks):
        raise ValueError(
            f"{len(blocks)} blocks for the {len(world.ranks)} ranks held")
    if blocks[0].shape[split_axis] % p:
        raise ValueError(
            f"split axis extent {blocks[0].shape[split_axis]} does not "
            f"divide by {p} ranks")
    if wire_dtype is None:
        return _all_to_all(blocks, world, split_axis, concat_axis, mesh_axis)
    codec = wire_codec(wire_dtype)
    parts = [codec.encode(b, tile_axis=split_axis, tiles=p) for b in blocks]
    shipped = ship_parts(parts, world, split_axis=split_axis,
                         concat_axis=concat_axis, mesh_axis=mesh_axis)
    return [codec.decode(w, b.dtype, tile_axis=concat_axis, tiles=p)
            for w, b in zip(shipped, blocks)]


def ship_parts(parts: list[tuple], world: World, *, split_axis: int,
               concat_axis: int, mesh_axis: str = SLAB_AXIS) -> list[tuple]:
    """Exchange already-encoded wire parts: ``parts[b]`` is held block
    b's tuple; part i of every block travels in one all-to-all, its split
    axis ceil-padded to a multiple of the group size first (the bytes
    the unfused exchange of the padded block would ship)."""
    p = world.axis_size(mesh_axis)
    padded = [[_pad_axis(w, split_axis, pad_to(w.shape[split_axis], p))
               for w in ps] for ps in parts]
    moved = [_all_to_all([ps[i] for ps in padded], world, split_axis,
                         concat_axis, mesh_axis)
             for i in range(len(parts[0]))]
    return [tuple(m[b] for m in moved) for b in range(len(parts))]


def exchange_uneven(blocks: list[torch.Tensor], world: World, *,
                    split_axis: int, concat_axis: int,
                    wire_dtype: str | None = None,
                    mesh_axis: str = SLAB_AXIS) -> list[torch.Tensor]:
    """:func:`exchange` after ceil-padding the split axis to a multiple of
    the group size. The result's concat axis holds one ceil-chunk per
    sender; the caller crops it to its true extent."""
    to = pad_to(blocks[0].shape[split_axis], world.axis_size(mesh_axis))
    return exchange([_pad_axis(b, split_axis, to) for b in blocks], world,
                    split_axis=split_axis, concat_axis=concat_axis,
                    wire_dtype=wire_dtype, mesh_axis=mesh_axis)
