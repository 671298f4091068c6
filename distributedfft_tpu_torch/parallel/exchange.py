"""The t2 global transpose over a :class:`~.mesh.World`: four transports,
the overlap-K pipeline, and the wire codecs that compress it.

The port of ``distributedfft_tpu/parallel/exchange.py``. Each exchange
splits every block into P chunks along ``split_axis``, sends chunk d to
rank d, and concatenates what it receives, in sender order, along
``concat_axis`` -- the semantics of ``lax.all_to_all(tiled=True)``.
``algorithm`` picks how the chunks travel (:data:`ALGORITHMS`), each with
its own routing on both backends:

- ``alltoall``: one dense all-to-all (``all_to_all_single``);
- ``alltoallv``: each peer's true ceil-split slice of an unpadded split
  axis into a zeroed receive buffer (``all_to_all_single`` with split
  sizes) -- the pads of an uneven axis never travel;
- ``ppermute``: P - 1 ring shifts; in step s rank i sends the chunk for
  (i - s) mod P and receives from (i + s) mod P (``batch_isend_irecv``);
- ``hierarchical``: the two-leg exchange over a hybrid world's combined
  axis: a tiled all-to-all within each node (``"ici"``), a local
  regroup, one across nodes (``"dcn"``), and a reindex onto the concat
  axis.

Transports move bytes and do no arithmetic, so every one equals the
dense exchange bit for bit. :func:`exchange_overlapped` pipelines an
exchange with the compute after it over K chunks of the bystander axis:
chunk k's exchange is issued (asynchronously on a process group) before
chunk k-1's compute runs.

Blocks travel as a list: one per rank this process holds (all on a
loopback world, its own on a process group). An exchange names its mesh
axis and runs within each group of that axis (a 2D world's rows or
columns; the whole world for a 1D world's axis or a combined axis). A
process group ships every tensor as a ``uint8`` view of its trailing
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

from collections import Counter
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import pad_to
from ..utils.trace import add_trace
from .mesh import SLAB_AXIS, World

#: Flat transports: the whole mesh axis is one collective's domain.
FLAT_ALGORITHMS = ("alltoall", "alltoallv", "ppermute")
#: Every transport, with the two-leg one of a hybrid world.
ALGORITHMS = FLAT_ALGORITHMS + ("hierarchical",)

#: The :func:`..plan_logic.exchange_payloads` entry that holds the bytes
#: each transport ships: the dense ones and the ring ship the pads too,
#: the ragged one the true slices of the split axis.
WIRE_BYTE_KEYS = {
    "alltoall": "alltoall_bytes",
    "ppermute": "alltoall_bytes",
    "alltoallv": "alltoallv_bytes",
    "hierarchical": "alltoall_bytes",
}

#: Collective rounds issued, by (algorithm, mesh-axis label): one per
#: dense or ragged all-to-all, P - 1 per ring, one per hierarchical leg
#: (labelled by the leg's axis). A loopback world counts a round once for
#: all its groups, as each process of a process group does.
ROUNDS: Counter = Counter()
#: Payload bytes written into receive buffers, by algorithm, over every
#: rank this process holds.
SHIPPED: Counter = Counter()


def check_algorithm(algorithm: str) -> str:
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown exchange algorithm {algorithm!r}; use {ALGORITHMS}")
    return algorithm


def transport_steps(algorithm: str, parts: int) -> int:
    """Sequential collective launches of one exchange on ``parts`` ranks:
    ``parts - 1`` shifts for the ring, one otherwise (the hierarchical
    transport's ``parts`` being one leg's)."""
    if algorithm == "ppermute":
        return max(1, parts - 1)
    return 1


def exchange_model_seconds(
    wire_bytes_per_dev: float,
    parts: int,
    algorithm: str,
    *,
    wire_gbps: float,
    launch_seconds: float,
    overlap_chunks: int = 1,
    hide_seconds: float = 0.0,
    batch: int = 1,
) -> dict:
    """The analytical time of one exchange under one transport (the
    tuner's pruning model). ``seconds`` is the wire transfer at
    ``wire_gbps`` plus :func:`transport_steps` launch latencies;
    ``exposed_seconds`` what stays on the critical path at
    ``overlap_chunks`` = K with ``hide_seconds`` of downstream compute to
    hide under: ``t/K + max(0, t - hide)(K-1)/K`` plus the K-1 extra
    launches of each step. ``batch`` scales the transfer (B transforms
    share one collective, the launches paid once); callers passing bytes
    already scaled by B keep 1."""
    steps = transport_steps(algorithm, parts)
    t_ex = (max(1, int(batch)) * wire_bytes_per_dev / (wire_gbps * 1e9)
            + steps * launch_seconds)
    k = max(1, int(overlap_chunks))
    exposed = (t_ex / k
               + max(0.0, t_ex - hide_seconds) * (k - 1) / k
               + (k - 1) * steps * launch_seconds)
    return {"seconds": t_ex, "exposed_seconds": exposed, "steps": steps}


def _axis_label(mesh_axis) -> str:
    """Span label of a mesh-axis spec: the name, or ``a+b`` for a
    combined axis."""
    if isinstance(mesh_axis, (tuple, list)):
        return "+".join(str(a) for a in mesh_axis)
    return str(mesh_axis)


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


def np_dtype(dtype) -> np.dtype:
    """A torch dtype, numpy dtype or dtype name as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


_WIRE_ERR_CACHE: dict = {}


def wire_roundtrip_error(dtype, wire_dtype: str | None = "bf16",
                         n: int = 4096) -> float:
    """Relative round-trip error of one wire cast, max |decode(encode(x))
    - x| / max |x|, over the JAX package's seeded standard-normal complex
    block of ``n`` elements tiled 8 ways. 0.0 for the exact wire."""
    if wire_dtype is None:
        return 0.0
    codec = wire_codec(wire_dtype)
    npdt = np.dtype(np.complex128 if np_dtype(dtype) == np.complex128
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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Pending:
    """An exchange in flight. :meth:`wait` waits on its work handles (a
    process group's asynchronous collectives; a loopback exchange is done
    when issued) and returns the received blocks. The send buffers stay
    referenced until then."""

    def __init__(self, finish, works=(), keep=()):
        self._finish, self._works, self._keep = finish, list(works), keep

    def wait(self) -> list:
        for w in self._works:
            w.wait()
        self._works, self._keep = [], ()
        return self._finish()


def _done(blocks) -> _Pending:
    return _Pending(lambda: blocks)


def _position(world: World, mesh_axis) -> tuple[int, list[int]]:
    """This process's index in its group of ``mesh_axis``, and the
    group's ranks."""
    for members in world.axis_members(mesh_axis):
        if world.rank in members:
            return members.index(world.rank), members
    raise ValueError(f"rank {world.rank} is in no group of {mesh_axis!r}")


def _start_dense(blocks: list, world: World, split_axis: int,
                 concat_axis: int, mesh_axis, counter: str = "alltoall",
                 label=None) -> _Pending:
    """The tiled all-to-all within each group of ``mesh_axis``: a split
    and a concatenation per group on a loopback world, one
    ``all_to_all_single`` on a process group."""
    p = world.axis_size(mesh_axis)
    if p == 1:
        return _done(list(blocks))
    ROUNDS[(counter, label or _axis_label(mesh_axis))] += 1
    SHIPPED[counter] += sum(_nbytes(b) for b in blocks)
    if world.loopback:
        out: list = [None] * len(blocks)
        for members in world.axis_members(mesh_axis):
            chunks = [blocks[m].tensor_split(p, dim=split_axis)
                      for m in members]
            for d, dst in enumerate(members):
                out[dst] = torch.cat([chunks[s][d] for s in range(p)],
                                     dim=concat_axis)
        return _done(out)
    (x,) = blocks
    send = torch.stack(x.tensor_split(p, dim=split_axis))
    raw = _as_bytes(send)
    recv = torch.empty_like(raw)
    work = dist.all_to_all_single(recv, raw,
                                  group=world.axis_group(mesh_axis),
                                  async_op=True)
    return _Pending(lambda: [torch.cat(_from_bytes(recv, send).unbind(0),
                                       dim=concat_axis)], [work], (raw,))


def _ragged_table(extent: int, p: int) -> tuple[int, list[int], list[int]]:
    """(ceil chunk, starts, sizes) of the ceil split of ``extent`` over
    ``p`` peers: peer j owns [starts[j], starts[j] + sizes[j])."""
    c = -(-extent // p)
    bounds = np.minimum(np.arange(p + 1) * c, extent)
    return c, [int(v) for v in bounds[:-1]], [int(v) for v in np.diff(bounds)]


def _start_ragged(blocks: list, world: World, split_axis: int,
                  concat_axis: int, mesh_axis) -> _Pending:
    """The ``alltoallv`` transport on an unpadded split axis of extent S:
    receiver d gets each sender's true slice of its ceil chunk, written
    at the top of that sender's ceil chunk of a zeroed buffer whose split
    axis is the ceil chunk c and whose concat axis holds P sender blocks
    -- the shape the dense exchange of the padded block returns."""
    p = world.axis_size(mesh_axis)
    if p == 1:
        return _done(list(blocks))
    ROUNDS[("alltoallv", _axis_label(mesh_axis))] += 1
    s_ext = blocks[0].shape[split_axis]
    c, starts, sizes = _ragged_table(s_ext, p)
    row = _nbytes(blocks[0]) // max(1, s_ext)
    if world.loopback:
        out: list = [None] * len(blocks)
        for members in world.axis_members(mesh_axis):
            for d, dst in enumerate(members):
                shape = list(blocks[dst].shape)
                nc = shape[concat_axis]
                shape[split_axis], shape[concat_axis] = c, p * nc
                buf = blocks[dst].new_zeros(shape)
                if sizes[d]:
                    for s, src in enumerate(members):
                        buf.narrow(concat_axis, s * nc, nc).narrow(
                            split_axis, 0, sizes[d]).copy_(
                            blocks[src].narrow(split_axis, starts[d],
                                               sizes[d]))
                SHIPPED["alltoallv"] += p * sizes[d] * row
                out[dst] = buf
        return _done(out)
    (x,) = blocks
    d, _ = _position(world, mesh_axis)
    lead = x.movedim(split_axis, 0)
    raw = _as_bytes(lead)
    recv = raw.new_empty((p * sizes[d],) + tuple(raw.shape[1:]))
    work = dist.all_to_all_single(
        recv, raw, output_split_sizes=[sizes[d]] * p,
        input_split_sizes=sizes, group=world.axis_group(mesh_axis),
        async_op=True)
    SHIPPED["alltoallv"] += _nbytes(recv)

    def finish():
        rest = tuple(lead.shape[1:])
        buf = x.new_zeros((p, c) + rest)
        buf[:, :sizes[d]] = _from_bytes(recv, x).reshape(
            (p, sizes[d]) + rest)
        return [torch.cat([b.movedim(0, split_axis) for b in buf.unbind(0)],
                          dim=concat_axis)]

    return _Pending(finish, [work], (raw,))


def _start_ring(blocks: list, world: World, split_axis: int,
                concat_axis: int, mesh_axis) -> _Pending:
    """The ``ppermute`` transport: P - 1 shifts around each group. In
    step s rank i sends the chunk for (i - s) mod P and receives its own
    from (i + s) mod P, placed at that sender's concat offset; its own
    chunk stays put. A process group posts every step's send and receive
    (``batch_isend_irecv`` on the group's global ranks) and waits on all
    of them; every rank posts every step, so the matching holds."""
    p = world.axis_size(mesh_axis)
    if p == 1:
        return _done(list(blocks))
    ns = blocks[0].shape[split_axis]
    if ns % p:
        raise ValueError(f"split axis extent {ns} not divisible by {p}")
    c = ns // p
    ROUNDS[("ppermute", _axis_label(mesh_axis))] += p - 1
    SHIPPED["ppermute"] += sum(_nbytes(b) for b in blocks)

    def buffer(x, i):
        shape = list(x.shape)
        nc = shape[concat_axis]
        shape[split_axis], shape[concat_axis] = c, p * nc
        buf = x.new_zeros(shape)
        place(buf, x.narrow(split_axis, i * c, c), i, nc)
        return buf, nc

    def place(buf, chunk, src, nc):
        buf.narrow(concat_axis, src * nc, nc).copy_(chunk)

    if world.loopback:
        out: list = [None] * len(blocks)
        groups = world.axis_members(mesh_axis)
        held = {}
        for members in groups:
            for i, r in enumerate(members):
                held[r] = buffer(blocks[r], i)
        for s in range(1, p):
            for members in groups:
                for i, r in enumerate(members):
                    src = (i + s) % p
                    buf, nc = held[r]
                    place(buf, blocks[members[src]].narrow(
                        split_axis, i * c, c), src, nc)
        for r, (buf, _) in held.items():
            out[r] = buf
        return _done(out)
    (x,) = blocks
    i, members = _position(world, mesh_axis)
    group = world.axis_group(mesh_axis)
    glob = dist.get_process_group_ranks(
        group if group is not None else dist.group.WORLD)
    buf, nc = buffer(x, i)
    works, keep, landed = [], [], []
    for s in range(1, p):
        dst, src = (i - s) % p, (i + s) % p
        send = _as_bytes(x.narrow(split_axis, dst * c, c))
        recv = torch.empty_like(send)
        works += dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, glob[dst], group=group),
            dist.P2POp(dist.irecv, recv, glob[src], group=group)])
        keep.append(send)
        landed.append((recv, src))

    def finish():
        for recv, src in landed:
            place(buf, _from_bytes(recv, x), src, nc)
        return [buf]

    return _Pending(finish, works, tuple(keep))


# ------------------------------------------------ hierarchical (dcn x ici)

def _hier_names_sizes(mesh_axis, axis_sizes) -> tuple[str, str, int, int]:
    """Validate and unpack the (dcn, ici) axis pair of a hierarchical
    exchange."""
    if not (isinstance(mesh_axis, (tuple, list)) and len(mesh_axis) == 2):
        raise ValueError(
            "hierarchical exchange needs a (dcn, ici) mesh-axis name "
            f"pair, got {mesh_axis!r}")
    if not (isinstance(axis_sizes, (tuple, list)) and len(axis_sizes) == 2):
        raise ValueError(
            "hierarchical exchange needs axis_sizes=(dcn_parts, "
            f"ici_parts), got {axis_sizes!r}")
    dcn_name, ici_name = mesh_axis
    return dcn_name, ici_name, int(axis_sizes[0]), int(axis_sizes[1])


def _regroup_split(x: torch.Tensor, split_axis: int, a: int, b: int,
                   c: int) -> torch.Tensor:
    """View ``split_axis`` as [a, b, c] chunk factors and swap the two
    leading ones: the destination-index transpose between the legs."""
    shp = tuple(x.shape)
    pre, post = shp[:split_axis], shp[split_axis + 1:]
    x = x.reshape(pre + (a, b, c) + post)
    x = x.transpose(len(pre), len(pre) + 1)
    return x.reshape(pre + (a * b * c,) + post)


def _senders_to_concat(v: torch.Tensor, split_axis: int, concat_axis: int,
                       p: int) -> torch.Tensor:
    """Lay the P sender-major chunks of ``split_axis`` onto
    ``concat_axis``, where the flat tiled all-to-all puts them."""
    shp = tuple(v.shape)
    c = shp[split_axis] // p
    pre, post = shp[:split_axis], shp[split_axis + 1:]
    v = v.reshape(pre + (p, c) + post).movedim(split_axis, concat_axis)
    out = list(v.shape)
    out[concat_axis:concat_axis + 2] = [out[concat_axis]
                                        * out[concat_axis + 1]]
    return v.reshape(out)


def hierarchical_legs(world: World, *, split_axis: int, concat_axis: int,
                      mesh_axis, axis_sizes):
    """The two legs of :func:`hierarchical_all_to_all` as callables
    ``(leg_ici, leg_dcn)`` over the held blocks. ``leg_ici(blocks,
    async_op=True)`` returns the leg in flight; ``leg_dcn`` includes the
    final reindex onto ``concat_axis``. ``leg_dcn(leg_ici(x))`` is the
    hierarchical exchange."""
    dcn_name, ici_name, d, i = _hier_names_sizes(mesh_axis, axis_sizes)
    if tuple(mesh_axis) != world.axis_names or (d, i) != world.grid:
        raise ValueError(
            f"hierarchical exchange over {tuple(mesh_axis)} sized "
            f"{(d, i)} needs a {d}x{i} world with those axes; this one is "
            f"{world.grid} {world.axis_names}")
    p = d * i

    def leg_ici(blocks, async_op: bool = False):
        c = blocks[0].shape[split_axis] // p
        v = [_regroup_split(b, split_axis, d, i, c) for b in blocks]
        pend = _start_dense(v, world, split_axis, split_axis, ici_name,
                            "hierarchical")
        return pend if async_op else pend.wait()

    def leg_dcn(blocks):
        c = blocks[0].shape[split_axis] // p
        v = [_regroup_split(b, split_axis, i, d, c) for b in blocks]
        v = _start_dense(v, world, split_axis, split_axis, dcn_name,
                         "hierarchical").wait()
        return [_senders_to_concat(b, split_axis, concat_axis, p) for b in v]

    return leg_ici, leg_dcn


def hierarchical_all_to_all(blocks: list, world: World, *, split_axis: int,
                            concat_axis: int, mesh_axis, axis_sizes) -> list:
    """The two-leg all-to-all over a hybrid world's combined axis: a tiled
    all-to-all within each node (leg A, ``"ici"``), a local regroup, one
    across nodes (leg B, ``"dcn"``), and the reindex onto
    ``concat_axis``. Rank ``d*I + e``'s chunks reach their card within
    each node in leg A and their node in leg B, so the result is the flat
    tiled all-to-all's bit for bit. The split extent must divide by D*I
    (the ceil pad of :func:`exchange_uneven`). The legs run under the
    spans ``t2a_exchange_<ici>`` and ``t2b_exchange_<dcn>``."""
    dcn_name, ici_name, d, i = _hier_names_sizes(mesh_axis, axis_sizes)
    s_ext = blocks[0].shape[split_axis]
    if s_ext % (d * i):
        raise ValueError(
            f"split axis extent {s_ext} not divisible by {d * i} (= {d} dcn "
            f"x {i} ici); hierarchical exchange takes the ceil-padded axis")
    leg_ici, leg_dcn = hierarchical_legs(
        world, split_axis=split_axis, concat_axis=concat_axis,
        mesh_axis=mesh_axis, axis_sizes=axis_sizes)
    with add_trace(f"t2a_exchange_{_axis_label(ici_name)}"):
        v = leg_ici(blocks)
    with add_trace(f"t2b_exchange_{_axis_label(dcn_name)}"):
        return leg_dcn(v)


def ragged_all_to_all_exchange(blocks: list, world: World, *,
                               split_axis: int, concat_axis: int,
                               mesh_axis=SLAB_AXIS) -> list:
    """The ``alltoallv`` transport on an unpadded split axis (see
    :func:`_start_ragged`); returns what the dense exchange of the
    ceil-padded blocks returns."""
    return _start_ragged(blocks, world, split_axis, concat_axis,
                         mesh_axis).wait()


def ring_all_to_all(blocks: list, world: World, *, split_axis: int,
                    concat_axis: int, mesh_axis=SLAB_AXIS) -> list:
    """The ``ppermute`` transport: P - 1 ring shifts (see
    :func:`_start_ring`)."""
    return _start_ring(blocks, world, split_axis, concat_axis,
                       mesh_axis).wait()


# ------------------------------------------------------------- exchanges

def _start(blocks, world, split_axis, concat_axis, mesh_axis, algorithm,
           axis_sizes) -> _Pending:
    """One transport over the held blocks, issued."""
    if algorithm == "alltoall":
        return _start_dense(blocks, world, split_axis, concat_axis,
                            mesh_axis)
    if algorithm == "alltoallv":
        return _start_ragged(blocks, world, split_axis, concat_axis,
                             mesh_axis)
    if algorithm == "ppermute":
        return _start_ring(blocks, world, split_axis, concat_axis,
                           mesh_axis)
    if algorithm == "hierarchical":
        return _done(hierarchical_all_to_all(
            blocks, world, split_axis=split_axis, concat_axis=concat_axis,
            mesh_axis=mesh_axis, axis_sizes=axis_sizes))
    check_algorithm(algorithm)


def _start_parts(parts: list[tuple], world, split_axis, concat_axis,
                 mesh_axis, algorithm, axis_sizes) -> _Pending:
    """Wire part i of every held block through one transport each."""
    pends = [_start([ps[i] for ps in parts], world, split_axis, concat_axis,
                    mesh_axis, algorithm, axis_sizes)
             for i in range(len(parts[0]))]

    def finish():
        moved = [pd.wait() for pd in pends]
        return [tuple(m[b] for m in moved) for b in range(len(parts))]

    return _Pending(finish)


def _start_codec(blocks, world, split_axis, concat_axis, mesh_axis,
                 algorithm, axis_sizes, wire_dtype) -> _Pending:
    """Encode each block on the split axis (one tile per peer), ship
    every wire part, decode on the concat axis."""
    if wire_dtype is None:
        return _start(blocks, world, split_axis, concat_axis, mesh_axis,
                      algorithm, axis_sizes)
    codec = wire_codec(wire_dtype)
    p = world.axis_size(mesh_axis)
    dtypes = [b.dtype for b in blocks]
    pend = _start_parts(
        [codec.encode(b, tile_axis=split_axis, tiles=p) for b in blocks],
        world, split_axis, concat_axis, mesh_axis, algorithm, axis_sizes)
    return _Pending(lambda: [
        codec.decode(w, dt, tile_axis=concat_axis, tiles=p)
        for w, dt in zip(pend.wait(), dtypes)])


def _check_blocks(blocks, world) -> None:
    if len(blocks) != len(world.ranks):
        raise ValueError(
            f"{len(blocks)} blocks for the {len(world.ranks)} ranks held")


def exchange(blocks: list[torch.Tensor], world: World, *, split_axis: int,
             concat_axis: int, wire_dtype: str | None = None,
             mesh_axis=SLAB_AXIS, algorithm: str = "alltoall",
             axis_sizes: tuple[int, int] | None = None
             ) -> list[torch.Tensor]:
    """Tiled all-to-all of every held block within each group of
    ``mesh_axis`` (a world's axis name, or a 2D world's combined axis:
    the tuple of both names) by ``algorithm``; ``split_axis`` must divide
    by the group size except under ``alltoallv``. ``axis_sizes`` is the
    (dcn, ici) grid of the hierarchical transport. ``wire_dtype`` encodes
    each block on the split axis (one tile per peer), ships every wire
    part, and decodes on the concat axis."""
    check_algorithm(algorithm)
    _check_blocks(blocks, world)
    p = world.axis_size(mesh_axis)
    if algorithm != "alltoallv" and blocks[0].shape[split_axis] % p:
        raise ValueError(
            f"split axis extent {blocks[0].shape[split_axis]} does not "
            f"divide by {p} ranks")
    return _start_codec(blocks, world, split_axis, concat_axis, mesh_axis,
                        algorithm, axis_sizes, wire_dtype).wait()


def ship_parts(parts: list[tuple], world: World, *, split_axis: int,
               concat_axis: int, mesh_axis=SLAB_AXIS,
               algorithm: str = "alltoall",
               axis_sizes: tuple[int, int] | None = None,
               async_op: bool = False):
    """Exchange already-encoded wire parts: ``parts[b]`` is held block
    b's tuple; part i of every block travels in one exchange by
    ``algorithm``, its split axis ceil-padded to a multiple of the group
    size first (the bytes the unfused exchange of the padded block would
    ship) except under ``alltoallv``, which ships the true slices.
    ``async_op=True`` returns the exchange in flight (its ``wait()``
    gives the received parts)."""
    check_algorithm(algorithm)
    if algorithm != "alltoallv":
        p = world.axis_size(mesh_axis)
        parts = [tuple(_pad_axis(w, split_axis,
                                 pad_to(w.shape[split_axis], p))
                       for w in ps) for ps in parts]
    pend = _start_parts(parts, world, split_axis, concat_axis, mesh_axis,
                        algorithm, axis_sizes)
    return pend if async_op else pend.wait()


def _start_uneven(blocks, world, split_axis, concat_axis, mesh_axis,
                  algorithm, axis_sizes, wire_dtype) -> _Pending:
    if algorithm != "alltoallv":
        to = pad_to(blocks[0].shape[split_axis], world.axis_size(mesh_axis))
        blocks = [_pad_axis(b, split_axis, to) for b in blocks]
    return _start_codec(blocks, world, split_axis, concat_axis, mesh_axis,
                        algorithm, axis_sizes, wire_dtype)


def exchange_uneven(blocks: list[torch.Tensor], world: World, *,
                    split_axis: int, concat_axis: int,
                    wire_dtype: str | None = None, mesh_axis=SLAB_AXIS,
                    algorithm: str = "alltoall",
                    axis_sizes: tuple[int, int] | None = None,
                    async_op: bool = False):
    """An exchange whose split extent need not divide by the group size.
    The dense transports ceil-pad the split axis first; ``alltoallv``
    ships the true slices of the unpadded axis (and, with a codec,
    encodes it unpadded: the codec's ceil tiles are the ragged ownership,
    and the int8 sidecar's split extent is the group size). Either way
    the result's concat axis holds one ceil-chunk per sender; the caller
    crops it to its true extent. ``async_op=True`` returns the exchange
    in flight: its ``wait()`` gives the blocks (a process group's
    collectives issued asynchronously; a loopback exchange is done when
    issued)."""
    check_algorithm(algorithm)
    _check_blocks(blocks, world)
    pend = _start_uneven(blocks, world, split_axis, concat_axis, mesh_axis,
                         algorithm, axis_sizes, wire_dtype)
    return pend if async_op else pend.wait()


# ------------------------------------------------ pipelined t2/t3 overlap

def overlap_chunk_bounds(extent: int, k: int) -> list[tuple[int, int]]:
    """(start, stop) of the K overlap chunks along the bystander axis:
    balanced (the first ``extent % k`` one longer), K clamped to
    [1, extent]."""
    extent = int(extent)
    k = max(1, min(int(k), max(extent, 1)))
    base, rem = divmod(extent, k)
    bounds, start = [], 0
    for i in range(k):
        stop = start + base + (1 if i < rem else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def _take(blocks, chunk_axis: int, lo: int, hi: int) -> list:
    return [b.narrow(chunk_axis, lo, hi - lo) for b in blocks]


def _join(parts: list[list], chunk_axis: int) -> list:
    return [torch.cat([p[b] for p in parts], dim=chunk_axis)
            for b in range(len(parts[0]))]


def _hierarchical_pipelined(blocks: list, world: World, *, split_axis: int,
                            concat_axis: int, mesh_axis, axis_sizes,
                            wire_dtype: str | None,
                            bounds: list[tuple[int, int]], chunk_axis: int,
                            compute=None,
                            compute_name: str = "t3_fft",
                            compute_takes_bounds: bool = False) -> list:
    """The leg-level pipeline of the hierarchical exchange over K > 1
    chunks: chunk k's leg A (within each node) is issued before chunk
    k-1's leg B (across nodes) and its ``compute`` run. Per chunk the
    work is pad, encode, leg A, leg B, decode -- the hierarchical
    exchange's -- so every K gives the same bits. Spans
    ``t2a_exchange_<ici>[k]`` / ``t2b_exchange_<dcn>[k]`` (and
    ``{compute_name}[k]``) show the interleave. ``compute=None`` is the
    staged tier: the exchanged chunks joined back.
    ``compute_takes_bounds`` as in :func:`exchange_overlapped`."""
    dcn_name, ici_name, d, i = _hier_names_sizes(mesh_axis, axis_sizes)
    p = d * i
    leg_ici, leg_dcn = hierarchical_legs(
        world, split_axis=split_axis, concat_axis=concat_axis,
        mesh_axis=mesh_axis, axis_sizes=axis_sizes)
    codec = wire_codec(wire_dtype) if wire_dtype is not None else None
    a_name = f"t2a_exchange_{_axis_label(ici_name)}"
    b_name = f"t2b_exchange_{_axis_label(dcn_name)}"
    dtypes = [b.dtype for b in blocks]

    def leg_a(k, chunk):
        with add_trace(f"{a_name}[{k}]"):
            chunk = [_pad_axis(u, split_axis, pad_to(u.shape[split_axis], p))
                     for u in chunk]
            parts = [codec.encode(u, tile_axis=split_axis, tiles=p)
                     if codec else (u,) for u in chunk]
            return [leg_ici([ps[j] for ps in parts], async_op=True)
                    for j in range(len(parts[0]))]

    def leg_b(k, inflight):
        with add_trace(f"{b_name}[{k}]"):
            done = [leg_dcn(pend.wait()) for pend in inflight]
            if codec is None:
                return done[0]
            return [codec.decode(tuple(m[b] for m in done), dt,
                                 tile_axis=concat_axis, tiles=p)
                    for b, dt in enumerate(dtypes)]

    def run_chunk(k, y):
        if compute is None:
            return y
        with add_trace(f"{compute_name}[{k}]"):
            return (compute(y, *bounds[k]) if compute_takes_bounds
                    else compute(y))

    out = []
    inflight = leg_a(0, _take(blocks, chunk_axis, *bounds[0]))
    for k in range(1, len(bounds)):
        nxt = leg_a(k, _take(blocks, chunk_axis, *bounds[k]))
        out.append(run_chunk(k - 1, leg_b(k - 1, inflight)))
        inflight = nxt
    out.append(run_chunk(len(bounds) - 1, leg_b(len(bounds) - 1, inflight)))
    return _join(out, chunk_axis)


def exchange_overlapped(blocks: list, world: World, *, split_axis: int,
                        concat_axis: int, compute, overlap_chunks: int = 1,
                        chunk_axis: int | None = None,
                        algorithm: str = "alltoall", mesh_axis=SLAB_AXIS,
                        axis_sizes: tuple[int, int] | None = None,
                        wire_dtype: str | None = None,
                        exchange_name: str = "t2_exchange",
                        compute_name: str = "t3_fft",
                        compute_takes_bounds: bool = False) -> list:
    """An exchange (:func:`exchange_uneven`) and the ``compute`` after it
    (held blocks in, held blocks out: the crop and FFT of the next stage),
    pipelined over ``overlap_chunks`` chunks of ``chunk_axis`` (default
    the bystander axis, which neither transforms). Chunk k's exchange is
    issued before chunk k-1's compute; on a process group it is in
    flight (asynchronous collectives, waited on before its output is
    read) while that compute runs, and on a loopback world it is a copy
    on the same stream, so nothing overlaps there. Every chunk sees the
    lines the whole block would, so any K gives the bits of K = 1.

    K <= 1 (or a chunk axis of extent 1) runs the exchange and compute
    once under the spans ``exchange_name`` and ``compute_name``; K > 1
    under ``{exchange_name}[k]`` / ``{compute_name}[k]``, and the
    hierarchical transport pipelines its legs
    (:func:`_hierarchical_pipelined`).

    ``compute_takes_bounds=True`` calls ``compute(blocks, lo, hi)`` with
    the chunk's (start, stop) along ``chunk_axis`` (``(0, extent)`` at K
    <= 1): the bystander axis keeps its positions through the exchange,
    so the bounds are the chunk's slice of the block -- the hook through
    which a spectral operator's midpoint generates its multiplier for
    exactly that slice."""
    check_algorithm(algorithm)
    if chunk_axis is None:
        chunk_axis = 3 - split_axis - concat_axis
    kw = dict(split_axis=split_axis, concat_axis=concat_axis,
              mesh_axis=mesh_axis, algorithm=algorithm,
              axis_sizes=axis_sizes, wire_dtype=wire_dtype)
    extent = blocks[0].shape[chunk_axis]
    bounds = overlap_chunk_bounds(extent, overlap_chunks)

    def run(k, y):
        return (compute(y, *bounds[k]) if compute_takes_bounds
                else compute(y))

    if len(bounds) <= 1:
        with add_trace(exchange_name):
            y = exchange_uneven(blocks, world, **kw)
        with add_trace(compute_name):
            return (compute(y, 0, extent) if compute_takes_bounds
                    else compute(y))
    if algorithm == "hierarchical":
        return _hierarchical_pipelined(
            blocks, world, split_axis=split_axis, concat_axis=concat_axis,
            mesh_axis=mesh_axis, axis_sizes=axis_sizes,
            wire_dtype=wire_dtype, bounds=bounds, chunk_axis=chunk_axis,
            compute=compute, compute_name=compute_name,
            compute_takes_bounds=compute_takes_bounds)

    def issue(k):
        with add_trace(f"{exchange_name}[{k}]"):
            return _start_uneven(_take(blocks, chunk_axis, *bounds[k]),
                                 world, **kw)

    out = []
    inflight = issue(0)
    for k in range(1, len(bounds)):
        nxt = issue(k)                 # issued before chunk k-1's compute
        with add_trace(f"{compute_name}[{k - 1}]"):
            out.append(run(k - 1, inflight.wait()))
        inflight = nxt
    with add_trace(f"{compute_name}[{len(bounds) - 1}]"):
        out.append(run(len(bounds) - 1, inflight.wait()))
    return _join(out, chunk_axis)


def exchange_chunked(blocks: list, world: World, *, split_axis: int,
                     concat_axis: int, mesh_axis=SLAB_AXIS,
                     algorithm: str = "alltoall", overlap_chunks: int = 1,
                     chunk_axis: int | None = None,
                     exchange_name: str = "t2_exchange",
                     axis_sizes: tuple[int, int] | None = None,
                     wire_dtype: str | None = None) -> list:
    """The staged tier of the overlap mode: K per-chunk exchanges of a
    padded split axis (:func:`exchange`) in one stage, under
    ``{exchange_name}[k]``; the hierarchical transport runs its leg
    pipeline without compute. K <= 1 is one exchange."""
    check_algorithm(algorithm)
    if chunk_axis is None:
        chunk_axis = 3 - split_axis - concat_axis
    kw = dict(split_axis=split_axis, concat_axis=concat_axis,
              mesh_axis=mesh_axis, algorithm=algorithm,
              axis_sizes=axis_sizes, wire_dtype=wire_dtype)
    bounds = overlap_chunk_bounds(blocks[0].shape[chunk_axis],
                                  overlap_chunks)
    if len(bounds) <= 1:
        return exchange(blocks, world, **kw)
    if algorithm == "hierarchical":
        return _hierarchical_pipelined(
            blocks, world, split_axis=split_axis, concat_axis=concat_axis,
            mesh_axis=mesh_axis, axis_sizes=axis_sizes,
            wire_dtype=wire_dtype, bounds=bounds, chunk_axis=chunk_axis)
    out = []
    for k, (lo, hi) in enumerate(bounds):
        with add_trace(f"{exchange_name}[{k}]"):
            out.append(exchange(_take(blocks, chunk_axis, lo, hi), world,
                                **kw))
    return _join(out, chunk_axis)
