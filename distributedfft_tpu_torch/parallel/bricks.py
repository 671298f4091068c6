"""Arbitrary-box reshapes -- the overlap-map engine.

The port of ``distributedfft_tpu/parallel/bricks.py``. heFFTe's reshape
engine moves data between any two non-overlapping box decompositions of
one world: each rank intersects its input box with every output box and
ships exactly those intersections (``heffte_reshape3d.h:60-498``, the
``MPI_Alltoallv`` transport ``src/heffte_reshape3d.cpp:375``). Here a
decomposition is held per rank as a block whose last three dims are in
canonical (x, y, z) order, the rank's box at the block's low corner and
zeros beyond it (a brick padded to the common :func:`pad_shape_for`
shape); leading dims (a batch) ride along untouched.

The overlap map is resolved at plan time (:func:`_overlap_steps`, the
JAX package's ring schedule with its shape-group split, and
:func:`_a2av_tables`, the exact per-pair counts), and a move only
replays it. Two transports:

- ``ring``: the (P-1)-shift ring. Step s moves every ``in_box[i] &
  out_box[(i + s) % P]`` overlap one ring hop, each step's group of
  senders in the JAX package's order. The JAX package ships a uniform
  block per step (the largest overlap of the shift) and masks it to the
  true intersection on receipt; the port ships each overlap at its true
  extent, so its wire equals the payload (:attr:`BrickSpec.wire_elems`).
  On a process group a step is one ``batch_isend_irecv`` round that
  every rank posts in the same order.
- ``a2av``: every pair's overlap in one exchange at its exact count, one
  ``all_to_all_single`` with split sizes on a process group.

On a loopback world (every rank's block in this process) a step is a
copy per rank. Self overlaps never leave the rank. The user-facing I/O of
a loopback world is a *brick stack*: ``[P, *pad]`` (or ``[B, P, *pad]``),
each brick stored in its box's ``order`` (:func:`scatter_bricks`,
:func:`gather_bricks`); a process-group rank holds its own brick.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import Box3, find_world, world_complete
from .exchange import ROUNDS, SHIPPED, _axis_label
from .mesh import World, spec_boxes, spec_entries, spec_parts
from .slab import check_batch

__all__ = [
    "BrickSpec", "BrickMove", "plan_brick_reshape", "plan_bricks_to_spec",
    "plan_spec_to_bricks", "scatter_bricks", "gather_bricks",
    "pad_shape_for", "stack_pad_for", "reorder_stack", "has_orders",
    "even_spec_boxes", "canonical_views",
]

ALGORITHMS = ("ring", "a2av")


def pad_shape_for(boxes: Sequence[Box3]) -> tuple[int, int, int]:
    """Common (max-extent) brick shape a stack is padded to."""
    return tuple(max(b.shape[d] for b in boxes) for d in range(3))


def stack_pad_for(boxes: Sequence[Box3]) -> tuple[int, int, int]:
    """Common padded shape of a user-facing brick stack: the max extents
    of the boxes' storage shapes (``Box3.order`` applied)."""
    return tuple(max(b.storage_shape[d] for b in boxes) for d in range(3))


def _inv_perm(order) -> tuple[int, int, int]:
    """Inverse of a 3-axis permutation."""
    return tuple(sorted(range(3), key=lambda a: order[a]))


def has_orders(boxes: Sequence[Box3]) -> bool:
    return any(tuple(b.order) != (0, 1, 2) for b in boxes)


def _check_algorithm(algorithm: str) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be ring|a2av, got {algorithm!r}")


def _validate(boxes: Sequence[Box3], world: Box3, label: str) -> None:
    if not world_complete(boxes, world):
        raise ValueError(
            f"{label} boxes do not partition the world {world}: they must "
            f"be non-overlapping and cover every element exactly once")


# --------------------------------------------------------- the ring plan

@dataclass(frozen=True)
class _Step:
    """One ring shift's overlap map (numpy, resolved at plan time): rows
    of the senders in this step's group; the other rows are zero."""

    shift: int
    block: tuple[int, int, int]       # max overlap extent this step
    send_start: np.ndarray            # [P, 3] src-local overlap origin
    true_size: np.ndarray             # [P, 3] overlap extent per sender
    recv_start: np.ndarray            # [P, 3] dst-local overlap origin


# A ring step whose joint block (elementwise max over the senders'
# overlap shapes) holds more than this factor times the largest single
# overlap is split into shape-similar sender groups, at most this many
# per shift: the JAX package's constants, kept so that both packages
# plan the same steps.
_SPLIT_FACTOR = 2.0
_MAX_GROUPS_PER_SHIFT = 4


def _shape_groups(shapes: dict[int, np.ndarray]) -> list[list[int]]:
    """Senders in shape-similar groups: greedy best fit by descending
    overlap volume, a new group when joining any would inflate its block
    past _SPLIT_FACTOR x its largest member."""
    order = sorted(shapes, key=lambda i: -int(np.prod(shapes[i])))
    groups: list[dict] = []
    for i in order:
        sh = shapes[i]
        best, best_cost = None, None
        for g in groups:
            cost = int(np.prod(np.maximum(g["block"], sh)))
            if cost <= _SPLIT_FACTOR * max(g["vol"], int(np.prod(sh))):
                if best is None or cost < best_cost:
                    best, best_cost = g, cost
        if best is None and len(groups) >= _MAX_GROUPS_PER_SHIFT:
            for g in groups:
                cost = int(np.prod(np.maximum(g["block"], sh)))
                if best is None or cost < best_cost:
                    best, best_cost = g, cost
        if best is None:
            groups.append({"members": [i], "block": sh.copy(),
                           "vol": int(np.prod(sh))})
        else:
            best["members"].append(i)
            best["block"] = np.maximum(best["block"], sh)
            best["vol"] = max(best["vol"], int(np.prod(sh)))
    return [g["members"] for g in groups]


def _overlap_steps(in_boxes: Sequence[Box3],
                   out_boxes: Sequence[Box3]) -> list[_Step]:
    """The ring schedule: for each shift s with any overlap, one step (or
    one per shape group) of ``in_box[i] & out_box[(i + s) % P]``."""
    p = len(in_boxes)
    steps: list[_Step] = []
    for s in range(p):
        send_start = np.zeros((p, 3), np.int64)
        true_size = np.zeros((p, 3), np.int64)
        recv_start = np.zeros((p, 3), np.int64)
        for i in range(p):
            dst = (i + s) % p
            o = in_boxes[i].intersect(out_boxes[dst])
            if o.empty:
                continue
            send_start[i] = np.subtract(o.low, in_boxes[i].low)
            true_size[i] = o.shape
            recv_start[dst] = np.subtract(o.low, out_boxes[dst].low)
        if not true_size.any():
            continue
        active = {i: true_size[i] for i in range(p) if true_size[i].any()}
        joint = tuple(int(true_size[:, d].max()) for d in range(3))
        max_vol = max(int(np.prod(sh)) for sh in active.values())
        groups = [list(active)]
        if math.prod(joint) > _SPLIT_FACTOR * max_vol and len(active) > 1:
            cand = _shape_groups(active)
            if len(cand) > 1:
                split_wire = sum(
                    math.prod(tuple(int(max(true_size[i][d] for i in g))
                                    for d in range(3)))
                    for g in cand)
                if split_wire * _SPLIT_FACTOR <= math.prod(joint):
                    groups = cand
        for members in groups:
            if len(groups) == 1:
                g_send, g_true, g_recv = send_start, true_size, recv_start
            else:
                g_send = np.zeros((p, 3), np.int64)
                g_true = np.zeros((p, 3), np.int64)
                g_recv = np.zeros((p, 3), np.int64)
                for i in members:
                    dst = (i + s) % p
                    g_send[i] = send_start[i]
                    g_true[i] = true_size[i]
                    g_recv[dst] = recv_start[dst]
            block = tuple(int(g_true[:, d].max()) for d in range(3))
            steps.append(_Step(s, block, g_send, g_true, g_recv))
    return steps


# --------------------------------------------------------- the a2av plan

@dataclass(frozen=True)
class _A2AVTables:
    """The exact per-pair counts (numpy): ``sizes[i, d]`` elements from
    rank i to rank d, ``send_off[i, d]`` where that run starts in i's
    send buffer, ``out_off[i, d]`` where it lands in d's receive buffer,
    and the z-run counts of the JAX package's run-length index maps (one
    run per (x, y) point of each overlap), from which
    :attr:`table_bytes_per_device` is the bytes those maps would take."""

    sizes: np.ndarray
    send_off: np.ndarray
    out_off: np.ndarray
    send_cap: int
    recv_cap: int
    send_runs: int
    recv_runs: int

    @property
    def table_bytes_per_device(self) -> int:
        """The JAX package's per-device index-map operands: start and end
        rows of the send and receive runs (int32) and four [P] count
        rows. The port slices each overlap box directly and ships no
        table; the figure is kept for ``plan_info``'s accounting."""
        p = self.sizes.shape[0]
        return int(max(1, self.send_runs) * 8 + max(1, self.recv_runs) * 8
                   + 4 * p * 4)


def _a2av_tables(in_boxes: Sequence[Box3],
                 out_boxes: Sequence[Box3]) -> _A2AVTables:
    p = len(in_boxes)
    sizes = np.zeros((p, p), np.int64)
    runs = np.zeros((p, p), np.int64)
    for i in range(p):
        for d in range(p):
            o = in_boxes[i].intersect(out_boxes[d])
            if not o.empty:
                sizes[i, d] = o.size
                runs[i, d] = o.shape[0] * o.shape[1]
    send_off = np.zeros((p, p), np.int64)
    out_off = np.zeros((p, p), np.int64)
    for i in range(p):
        send_off[i] = np.concatenate(([0], np.cumsum(sizes[i])[:-1]))
    for d in range(p):
        out_off[:, d] = np.concatenate(([0], np.cumsum(sizes[:, d])[:-1]))
    return _A2AVTables(sizes, send_off, out_off,
                       int(sizes.sum(axis=1).max()),
                       int(sizes.sum(axis=0).max()),
                       int(runs.sum(axis=1).max()),
                       int(runs.sum(axis=0).max()))


def _a2av_payload(t: _A2AVTables) -> int:
    """Off-rank elements of the exact transport (self runs stay put)."""
    return int(t.sizes.sum() - np.trace(t.sizes))


@dataclass(frozen=True)
class BrickSpec:
    """Plan-time description of an arbitrary-box reshape.
    ``payload_elems`` is the true overlap crossing between ranks (self
    overlaps excluded), the JAX package's figure; ``wire_elems`` what the
    port ships: the same, on both transports (the ring ships each
    overlap at its true extent, where the JAX package's padded ring
    ships P blocks of the step's largest overlap)."""

    in_boxes: tuple
    out_boxes: tuple
    world: Box3
    in_pad: tuple[int, int, int]
    out_pad: tuple[int, int, int]
    steps: tuple = ()
    algorithm: str = "ring"
    payload_override: int | None = None
    a2av_table_bytes: int | None = None

    @property
    def payload_elems(self) -> int:
        if self.payload_override is not None:
            return self.payload_override
        return sum(int(np.prod(st.true_size[i]))
                   for st in self.steps if st.shift
                   for i in range(len(self.in_boxes)))

    @property
    def wire_elems(self) -> int:
        return self.payload_elems

    @property
    def wire_ratio(self) -> float:
        t = self.payload_elems
        return self.wire_elems / t if t else 1.0


# ------------------------------------------------------------- moving

def _region(t: torch.Tensor, start, size) -> torch.Tensor:
    """The [start, start + size) box of ``t``'s last three dims."""
    return t[(Ellipsis,) + tuple(slice(int(a), int(a) + int(n))
                                 for a, n in zip(start, size))]


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` flattened, as uint8."""
    t = t.contiguous().reshape(-1)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    return t.view(torch.uint8)


def _from_flat_bytes(b: torch.Tensor, dtype: torch.dtype,
                     shape) -> torch.Tensor:
    if dtype.is_complex:
        real = torch.float64 if dtype == torch.complex128 else torch.float32
        return torch.view_as_complex(b.view(real).reshape(-1, 2)).reshape(
            shape)
    return b.view(dtype).reshape(shape)


def _global_ranks(world: World) -> list[int]:
    return dist.get_process_group_ranks(
        world.group if world.group is not None else dist.group.WORLD)


class BrickMove:
    """One compiled overlap map over ``world``: :meth:`run` copies every
    overlap of the source blocks (held in-box data at each block's low
    corner, canonical order) into the destination blocks, which the
    caller allocates and whose other elements it leaves alone."""

    def __init__(self, world: World, spec: BrickSpec):
        self.world, self.spec = world, spec
        self.label = (None if world is None
                      else _axis_label(world.combined_axis))
        # (i, d) -> (overlap shape, origin in i's in-box, in d's out-box)
        p = len(spec.in_boxes)
        self.pairs = {}
        for i, d in itertools.product(range(p), range(p)):
            o = spec.in_boxes[i].intersect(spec.out_boxes[d])
            if not o.empty:
                self.pairs[(i, d)] = (
                    o.shape, tuple(np.subtract(o.low, spec.in_boxes[i].low)),
                    tuple(np.subtract(o.low, spec.out_boxes[d].low)))
        # the ring's senders per step, in step order
        self.ring = [[(i, (i + st.shift) % p) for i in range(p)
                      if st.true_size[i].any()] for st in spec.steps]

    def run(self, src: list, dst: list) -> list:
        if len(src) != len(self.world.ranks) or len(dst) != len(src):
            raise ValueError(
                f"{len(src)} source / {len(dst)} destination blocks for the "
                f"{len(self.world.ranks)} ranks held")
        if self.spec.algorithm == "a2av":
            self._run_a2av(src, dst)
        else:
            self._run_ring(src, dst)
        return dst

    # ---- ring
    def _run_ring(self, src, dst) -> None:
        w = self.world
        p = w.size
        if not w.loopback and w.backend == "nccl":
            # batch_isend_irecv must not be the group's first collective
            # unless every rank joins it; a ring step may leave ranks out.
            dist.barrier(group=w.group)
        for st, senders in zip(self.spec.steps, self.ring):
            if st.shift:
                ROUNDS[("bricks_ring", self.label)] += 1
            if not w.loopback:
                self._ring_step(st, src[0], dst[0])
                continue
            for i, d in senders:
                moved = self._copy(src, dst, i, d)
                if st.shift:
                    SHIPPED["bricks_ring"] += moved

    def _copy(self, src, dst, i: int, d: int) -> int:
        """Overlap (i, d) from held block i into held block d (loopback);
        returns its bytes."""
        size, s0, r0 = self.pairs[(i, d)]
        piece = _region(src[i], s0, size)
        _region(dst[d], r0, size).copy_(piece)
        return piece.numel() * piece.element_size()

    def _ring_step(self, st: _Step, x: torch.Tensor,
                   y: torch.Tensor) -> None:
        w = self.world
        p, i = w.size, w.rank
        size_i = st.true_size[i]
        if not st.shift:
            if size_i.any():
                self._copy({i: x}, {i: y}, i, i)
            return
        glob = _global_ranks(w)
        ops, landed = [], None
        if size_i.any():
            send = _flat_bytes(_region(x, st.send_start[i], size_i))
            ops.append(dist.P2POp(dist.isend, send,
                                  glob[(i + st.shift) % p], group=w.group))
            SHIPPED["bricks_ring"] += send.numel()
        src = (i - st.shift) % p
        size_s = st.true_size[src]
        if size_s.any():
            lead = tuple(x.shape[:-3])
            nbytes = (math.prod(lead) * int(np.prod(size_s))
                      * x.element_size())
            recv = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            ops.append(dist.P2POp(dist.irecv, recv, glob[src],
                                  group=w.group))
            landed = (recv, lead + tuple(int(v) for v in size_s))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if landed is not None:
            recv, shape = landed
            _region(y, st.recv_start[i], shape[-3:]).copy_(
                _from_flat_bytes(recv, x.dtype, shape))

    # ---- a2av
    def _run_a2av(self, src, dst) -> None:
        w = self.world
        p = w.size
        ROUNDS[("bricks_a2av", self.label)] += 1
        if w.loopback:
            for i, d in self.pairs:
                moved = self._copy(src, dst, i, d)
                if i != d:
                    SHIPPED["bricks_a2av"] += moved
            return
        x, y = src[0], dst[0]
        i = w.rank
        lead = tuple(x.shape[:-3])
        per = math.prod(lead) * x.element_size()
        count = lambda a, b: (0 if a == b or (a, b) not in self.pairs
                              else math.prod(self.pairs[(a, b)][0]) * per)
        in_split = [count(i, d) for d in range(p)]
        out_split = [count(s, i) for s in range(p)]
        parts = [_flat_bytes(_region(x, self.pairs[(i, d)][1],
                                     self.pairs[(i, d)][0]))
                 for d in range(p) if in_split[d]]
        send = (torch.cat(parts) if parts
                else torch.empty(0, dtype=torch.uint8, device=x.device))
        recv = torch.empty(sum(out_split), dtype=torch.uint8,
                           device=x.device)
        dist.all_to_all_single(recv, send, output_split_sizes=out_split,
                               input_split_sizes=in_split, group=w.group)
        SHIPPED["bricks_a2av"] += send.numel()
        if (i, i) in self.pairs:
            self._copy({i: x}, {i: y}, i, i)
        off = 0
        for s in range(p):
            if not out_split[s]:
                continue
            size, _, r0 = self.pairs[(s, i)]
            chunk = recv[off:off + out_split[s]]
            off += out_split[s]
            _region(y, r0, size).copy_(
                _from_flat_bytes(chunk, x.dtype, lead + size))


def compile_move(world: World, in_boxes: Sequence[Box3],
                 out_boxes: Sequence[Box3], algorithm: str = "ring",
                 *, in_pad=None, out_pad=None) -> BrickMove:
    """The overlap map from ``in_boxes`` to ``out_boxes`` (one each per
    rank of ``world``, both tiling one world) by ``algorithm``."""
    _check_algorithm(algorithm)
    world_b = find_world(in_boxes)
    in_pad = tuple(in_pad) if in_pad is not None else pad_shape_for(in_boxes)
    out_pad = (tuple(out_pad) if out_pad is not None
               else pad_shape_for(out_boxes))
    if algorithm == "a2av":
        tables = _a2av_tables(in_boxes, out_boxes)
        spec = BrickSpec(tuple(in_boxes), tuple(out_boxes), world_b,
                         in_pad, out_pad, (), algorithm,
                         payload_override=_a2av_payload(tables),
                         a2av_table_bytes=tables.table_bytes_per_device)
        return BrickMove(world, spec)
    spec = BrickSpec(tuple(in_boxes), tuple(out_boxes), world_b, in_pad,
                     out_pad, tuple(_overlap_steps(in_boxes, out_boxes)),
                     algorithm)
    return BrickMove(world, spec)


def new_blocks(world: World, boxes: Sequence[Box3], pad, lead: tuple,
               like: torch.Tensor) -> list[torch.Tensor]:
    """Destination blocks ``[*lead, *pad]`` for the ranks held: zeroed
    where the rank's box does not fill the pad, uninitialized where the
    move writes every element."""
    pad = tuple(pad)
    out = []
    for r in world.ranks:
        make = torch.empty if boxes[r].shape == pad else torch.zeros
        out.append(make(lead + pad, dtype=like.dtype, device=like.device))
    return out


# ---------------------------------------------------- brick stacks, I/O

def canonical_views(blocks: list, boxes: Sequence[Box3],
                    ranks: Sequence[int]) -> list:
    """Views of stored bricks (each ``[*lead, *storage pad]``, rank r's
    brick stored in ``boxes[r].order``) in canonical axis order, cut to
    their boxes. Writing into a view writes the stored brick."""
    out = []
    for blk, r in zip(blocks, ranks):
        b = boxes[r]
        v = blk[(Ellipsis,) + tuple(slice(0, s) for s in b.storage_shape)]
        if tuple(b.order) != (0, 1, 2):
            k = v.dim() - 3
            v = v.permute(*range(k), *(k + a for a in _inv_perm(b.order)))
        out.append(v)
    return out


def reorder_stack(world: World, boxes: Sequence[Box3], *,
                  to_canonical: bool):
    """The order edge of a brick stack (heFFTe's ``transpose_packer`` at
    the user I/O boundary): ``to_canonical=True`` maps held bricks stored
    in their boxes' orders (``[*lead, *stack_pad_for]``) to canonical
    blocks ``[*lead, *pad_shape_for]``; False the inverse. None when
    every order is the identity. The plans read and write the stored
    bricks through :func:`canonical_views` instead, which copies nothing."""
    if not has_orders(boxes):
        return None
    spad, cpad = stack_pad_for(boxes), pad_shape_for(boxes)

    def run(blocks: list) -> list:
        lead = tuple(blocks[0].shape[:-3])
        if to_canonical:
            views = canonical_views(blocks, boxes, world.ranks)
            out = [torch.zeros(lead + cpad, dtype=b.dtype, device=b.device)
                   for b in blocks]
            for o, v in zip(out, views):
                _region(o, (0, 0, 0), v.shape[-3:]).copy_(v)
            return out
        out = [torch.zeros(lead + spad, dtype=b.dtype, device=b.device)
               for b in blocks]
        for o, b, r in zip(out, blocks, world.ranks):
            (v,) = canonical_views([o], boxes, [r])
            v.copy_(_region(b, (0, 0, 0), boxes[r].shape))
        return out

    return run


def _to_torch(x):
    return (x, False) if isinstance(x, torch.Tensor) else (
        torch.from_numpy(np.ascontiguousarray(x)), True)


def scatter_bricks(x, boxes: Sequence[Box3], pad=None):
    """A world array -> its brick stack ``[P, *pad]``: brick i is
    ``x[boxes[i]]`` stored in ``boxes[i].order``, zero-padded (pad:
    :func:`stack_pad_for` by default). Takes and returns numpy arrays or
    torch tensors alike."""
    t, was_np = _to_torch(x)
    pad = stack_pad_for(boxes) if pad is None else tuple(pad)
    stack = torch.zeros((len(boxes),) + pad, dtype=t.dtype, device=t.device)
    views = canonical_views(list(stack.unbind(0)), boxes, range(len(boxes)))
    for v, b in zip(views, boxes):
        v.copy_(t[b.slices()])
    return stack.numpy() if was_np else stack


def gather_bricks(stack, boxes: Sequence[Box3]):
    """A brick stack ``[P, *pad]`` -> the world array, each brick read in
    its box's storage order."""
    t, was_np = _to_torch(stack)
    world = find_world(boxes)
    out = torch.zeros(world.shape, dtype=t.dtype, device=t.device)
    views = canonical_views(list(t.unbind(0)), boxes, range(len(boxes)))
    for v, b in zip(views, boxes):
        out[tuple(slice(l - w, h - w) for l, h, w in
                  zip(b.low, b.high, world.low))] = v
    return out.numpy() if was_np else out


def _stack_blocks(world: World, stack: torch.Tensor, batched: bool) -> list:
    """Held bricks of a loopback stack (``[P, ...]``, or ``[B, P, ...]``
    batched) or a process-group rank's own brick."""
    if not world.loopback:
        return [stack]
    if stack.shape[int(batched)] != world.size:
        raise ValueError(
            f"a brick stack of this world has {world.size} bricks on axis "
            f"{int(batched)}, got shape {tuple(stack.shape)}")
    return list(stack.unbind(int(batched)))


def _check_count(world: World, boxes, label: str) -> None:
    if len(boxes) != world.size:
        raise ValueError(
            f"need exactly one in/out box per device on axes "
            f"{world.axis_names!r} (P={world.size}); got {len(boxes)} "
            f"{label} boxes")


def plan_brick_reshape(world: World, in_boxes: Sequence[Box3],
                       out_boxes: Sequence[Box3], *,
                       algorithm: str = "ring"):
    """``(fn, spec)``: ``fn`` maps an in-brick stack ``[P, *spec.in_pad]``
    to the out-brick stack ``[P, *spec.out_pad]`` (on a process group a
    rank's own brick to its own brick), zeros beyond each box. The
    overlap map is resolved here (``reshape3d_alltoallv``'s
    construction); ``algorithm`` is ``ring`` or ``a2av``."""
    _check_algorithm(algorithm)
    if len(in_boxes) != world.size or len(out_boxes) != world.size:
        raise ValueError(
            f"need exactly one in/out box per device on axes "
            f"{world.axis_names!r} (P={world.size}); got "
            f"{len(in_boxes)}/{len(out_boxes)}")
    wb = find_world(in_boxes)
    _validate(in_boxes, wb, "input")
    _validate(out_boxes, wb, "output")
    move = compile_move(world, in_boxes, out_boxes, algorithm)

    def fn(stack: torch.Tensor) -> torch.Tensor:
        src = _stack_blocks(world, stack, False)
        dst = new_blocks(world, out_boxes, move.spec.out_pad, (), src[0])
        move.run(src, dst)
        return torch.stack(dst) if world.loopback else dst[0]

    return fn, move.spec


def even_spec_boxes(world: World, spec, box: Box3, label: str):
    """Rank boxes of ``spec`` over ``box``, required uniform (each
    sharded dim divides) and distinct, and their common shape."""
    for d, entry in enumerate(spec_entries(world, spec, 3)):
        k = spec_parts(world, entry)
        if box.shape[d] % k:
            raise ValueError(
                f"{label} layout {spec} does not divide {box.shape} into "
                f"uniform shards (dim {d}: {box.shape[d]} % {k} != 0); "
                f"pick a mesh whose axes divide the extents")
    boxes = spec_boxes(world, spec, box)
    if len(set(boxes)) != len(boxes):
        raise ValueError(
            f"{label} layout {spec} leaves some mesh axes unused "
            f"(duplicate shard boxes); bricks need one distinct box per "
            f"device")
    return boxes, boxes[0].shape


def _check_batch(batch):
    batch = check_batch(batch)
    return None if batch == 1 else batch


def plan_bricks_to_spec(world: World, in_boxes: Sequence[Box3], to_spec, *,
                        algorithm: str = "ring", batch: int | None = None):
    """Arbitrary in-bricks -> the world array laid out by ``to_spec``
    (which must divide the world evenly): on a loopback world ``fn`` maps
    the stack ``[P, *in_pad]`` (``[B, P, *in_pad]`` with ``batch=B``) to
    the world array ``[*world]`` (``[B, *world]``), each shard written in
    place; on a process group a rank's brick to its shard. ``batch=1``
    is the unbatched plan."""
    _check_algorithm(algorithm)
    batch = _check_batch(batch)
    wb = find_world(in_boxes)
    _validate(in_boxes, wb, "input")
    out_boxes, shard = even_spec_boxes(world, to_spec, wb, "target")
    if len(in_boxes) != world.size:
        raise ValueError(f"need {world.size} input bricks, got "
                         f"{len(in_boxes)}")
    move = compile_move(world, in_boxes, out_boxes, algorithm, out_pad=shard)
    lead = () if batch is None else (batch,)

    def fn(stack: torch.Tensor) -> torch.Tensor:
        src = _stack_blocks(world, stack, batch is not None)
        if world.loopback:
            out = torch.empty(lead + wb.shape, dtype=stack.dtype,
                              device=stack.device)
            dst = [out[(Ellipsis,) + tuple(
                slice(l - w, h - w) for l, h, w in zip(b.low, b.high, wb.low))]
                for b in out_boxes]
            move.run(src, dst)
            return out
        dst = [torch.empty(lead + shard, dtype=stack.dtype,
                           device=stack.device)]
        return move.run(src, dst)[0]

    return fn, move.spec


def plan_spec_to_bricks(world: World, from_spec, out_boxes: Sequence[Box3],
                        *, algorithm: str = "ring",
                        batch: int | None = None):
    """The world array laid out by ``from_spec`` (even) -> arbitrary
    out-bricks: the inverse of :func:`plan_bricks_to_spec` (loopback:
    ``[*world]`` -> ``[P, *out_pad]``; batched ``[B, *world]`` -> ``[B,
    P, *out_pad]``)."""
    _check_algorithm(algorithm)
    batch = _check_batch(batch)
    wb = find_world(out_boxes)
    _validate(out_boxes, wb, "output")
    in_boxes, shard = even_spec_boxes(world, from_spec, wb, "source")
    if len(out_boxes) != world.size:
        raise ValueError(f"need {world.size} output bricks, got "
                         f"{len(out_boxes)}")
    move = compile_move(world, in_boxes, out_boxes, algorithm, in_pad=shard)
    lead = () if batch is None else (batch,)

    def fn(x: torch.Tensor) -> torch.Tensor:
        if world.loopback:
            src = [x[(Ellipsis,) + tuple(
                slice(l - w, h - w) for l, h, w in zip(b.low, b.high, wb.low))]
                for b in in_boxes]
        else:
            src = [x]
        dst = new_blocks(world, out_boxes, move.spec.out_pad, lead, x)
        move.run(src, dst)
        if not world.loopback:
            return dst[0]
        return torch.stack(dst, dim=len(lead))

    return fn, move.spec
