"""Pencil-decomposed distributed 3D FFT over a 2D world (rows x cols).

The port of ``build_pencil_general`` / ``build_pencil_fft3d`` /
``build_pencil_rfft3d`` of ``distributedfft_tpu/parallel/pencil.py``.
The canonical forward chain, on z-pencils in and x-pencils out:

    t0   1D FFT along Z                          (t0_fft_z)
    t2a  all-to-all over col: Z <-> Y            (t2a_exchange_col)
    t1   crop, 1D FFT along Y                    (t1_fft_y)
    t2b  all-to-all over row: Y <-> X            (t2b_exchange_row)
    t3   crop, 1D FFT along X                    (t3_fft_x)

emitted as a :class:`~..stagegraph.StageGraph` with the JAX package's node
names, pads and crops (the mesh axes named as the world names them).
Each exchange ceil-pads its split axis to a multiple of its group, and
each axis is cropped to its true extent before it is transformed, so the
pads never touch a transform; the split axes keep their pads until the
output is joined (``post``). Both exchanges take a flat transport
(``algorithm``) and the overlap K (``overlap_chunks``, chunks of each
exchange's bystander axis), and ``batch``: a leading batch axis of B
transforms riding every stage and both exchanges (the
:mod:`.slab` convention). :func:`build_pencil_spectral_op` (the
``midpoint=`` hook) is the spectral operator's chain: the forward chain
stopped in the transposed x-pencil layout, the ``t_mid`` node, and the
inverse legs back to z-pencils, four exchanges in all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..geometry import pad_to
from ..ops.executors import get_executor
from ..stagegraph import (StageGraph, apply_midpoint, exchange_node,
                          local_node)
from .exchange import FLAT_ALGORITHMS, _crop_axis
from .mesh import World, axis_coords
from .slab import _L, check_batch, index_grids

__all__ = ["PencilSpec", "chain_geometry", "build_pencil_general",
           "build_pencil_fft3d", "build_pencil_rfft3d",
           "build_pencil_spectral_op"]


@dataclass(frozen=True)
class PencilSpec:
    """Static geometry of a pencil plan on a (rows x cols) world.

    ``perm = (a, b, c)`` is the input layout: axis ``a`` split over the
    rows, ``b`` over the cols, ``c`` whole. ``order`` picks which mesh
    axis exchanges first:

    - ``"col_first"``: fft c | exch col (c<->b) | fft b | exch row (b<->a)
      | fft a -> output ``b`` over rows, ``c`` over cols, ``a`` whole;
    - ``"row_first"``: fft c | exch row (c<->a) | fft a | exch col (a<->b)
      | fft b -> output ``c`` over rows, ``a`` over cols, ``b`` whole.

    The canonical forward plan is perm (0, 1, 2) col_first (z-pencils in,
    x-pencils out); the canonical backward perm (1, 2, 0) row_first.
    """

    shape: tuple[int, int, int]
    rows: int
    cols: int
    row_axis: str = "row"
    col_axis: str = "col"
    perm: tuple[int, int, int] = (0, 1, 2)
    order: str = "col_first"

    @property
    def n0p(self) -> int:
        return pad_to(self.shape[0], self.rows)

    @property
    def n1p_col(self) -> int:
        return pad_to(self.shape[1], self.cols)

    @property
    def n1p_row(self) -> int:
        return pad_to(self.shape[1], self.rows)

    @property
    def in_placement(self) -> tuple[int, int]:
        """(row_dim, col_dim) of the input layout."""
        return self.perm[0], self.perm[1]

    @property
    def out_placement(self) -> tuple[int, int]:
        """(row_dim, col_dim) of the output layout."""
        a, b, c = self.perm
        return (b, c) if self.order == "col_first" else (c, a)


def chain_geometry(perm, order, rows, cols, row_axis, col_axis, n):
    """``(seq, last_fft, in_pads, out_crops)`` of the pencil chain:
    ``seq`` lists ``(mesh_axis, parts, split_axis, concat_axis)`` per
    exchange."""
    a, b, c = perm
    if order == "col_first":
        seq = [(col_axis, cols, c, b), (row_axis, rows, b, a)]
        last_fft = a
    else:
        seq = [(row_axis, rows, c, a), (col_axis, cols, a, b)]
        last_fft = b
    in_pads = ((a, pad_to(n[a], rows)), (b, pad_to(n[b], cols)))
    # Each exchange's split axis keeps its pad on the global output.
    out_crops = tuple((split, n[split]) for _, _, split, _ in seq)
    return seq, last_fft, in_pads, out_crops


def _grid(world: World) -> tuple[int, int]:
    if world.grid is None:
        raise ValueError("the pencil chain runs on a 2D world (rows, cols)")
    return world.grid


def _flat(algorithm: str) -> str:
    if algorithm not in FLAT_ALGORITHMS:
        raise ValueError(
            f"the pencil chain takes the flat transports {FLAT_ALGORITHMS}, "
            f"got {algorithm!r}")
    return algorithm


def build_pencil_general(world: World, shape: tuple[int, int, int], *,
                         perm: tuple[int, int, int], order: str,
                         row_axis: str | None = None,
                         col_axis: str | None = None,
                         executor: str = "cuda", forward: bool = True,
                         wire_dtype: str | None = None,
                         algorithm: str = "alltoall",
                         overlap_chunks: int = 1,
                         batch: int | None = None,
                         midpoint: Callable | None = None
                         ) -> tuple[StageGraph, PencilSpec]:
    """The C2C pencil chain for any input permutation and exchange order
    (see :class:`PencilSpec`); the mesh axes default to the world's
    names. ``midpoint`` (a multiplier generator) builds the spectral
    operator's chain instead (:func:`build_pencil_spectral_op`), in the
    canonical forward orientation only."""
    if midpoint is not None:
        if (not forward or tuple(perm) != (0, 1, 2)
                or order != "col_first"):
            raise ValueError(
                "the midpoint (spectral-operator) hook runs the canonical "
                "forward chain: forward=True, perm=(0, 1, 2), col_first")
        return build_pencil_spectral_op(
            world, shape, midpoint, row_axis=row_axis, col_axis=col_axis,
            executor=executor, wire_dtype=wire_dtype, algorithm=algorithm,
            overlap_chunks=overlap_chunks, batch=batch)
    _flat(algorithm)
    bo = 0 if check_batch(batch) is None else 1
    row_axis = row_axis or world.axis_names[0]
    col_axis = col_axis or world.axis_names[-1]
    if sorted(perm) != [0, 1, 2]:
        raise ValueError(
            f"perm must be a permutation of (0, 1, 2), got {perm}")
    if order not in ("col_first", "row_first"):
        raise ValueError(f"order must be col_first|row_first, got {order!r}")
    rows, cols = _grid(world)
    spec = PencilSpec(tuple(int(s) for s in shape), rows, cols, row_axis,
                      col_axis, tuple(perm), order)
    n = spec.shape
    seq, last_fft, in_pads, out_crops = chain_geometry(
        perm, order, rows, cols, row_axis, col_axis, n)
    fft_names = (f"t0_fft_{_L[seq[0][2]]}", f"t1_fft_{_L[seq[1][2]]}")
    exch_names = (f"t2a_exchange_{seq[0][0]}", f"t2b_exchange_{seq[1][0]}")
    nodes = [local_node("t0", fft_names[0],
                        ("fft", (seq[0][2] + bo,), forward))]
    for i, (mesh_ax, parts, split, concat) in enumerate(seq):
        nodes.append(exchange_node(
            "t2a" if i == 0 else "t2b", exch_names[i], mesh_axis=mesh_ax,
            parts=parts, split=split + bo, concat=concat + bo,
            chunk_axis=3 - split - concat + bo))
        nodes.append(local_node(
            "t1" if i == 0 else "t3",
            fft_names[1] if i == 0 else f"t3_fft_{_L[last_fft]}",
            ("crop", concat + bo, n[concat]),
            ("fft", (concat + bo,), forward), fuse=True))
    graph = StageGraph(
        world=world, nodes=tuple(nodes), executor=executor,
        wire_dtype=wire_dtype,
        pre=tuple(("pad", ax + bo, to) for ax, to in in_pads),
        post=tuple(("crop", ax + bo, to) for ax, to in out_crops),
        in_dims=tuple(d + bo for d in spec.in_placement),
        out_dims=tuple(d + bo for d in spec.out_placement),
        algorithm=algorithm, overlap_chunks=overlap_chunks, batch=batch)
    return graph.validate(), spec


def build_pencil_fft3d(world: World, shape: tuple[int, int, int], *,
                       executor: str = "cuda", forward: bool = True,
                       perm: tuple[int, int, int] | None = None,
                       order: str | None = None,
                       wire_dtype: str | None = None,
                       algorithm: str = "alltoall", overlap_chunks: int = 1,
                       batch: int | None = None
                       ) -> tuple[StageGraph, PencilSpec]:
    """The canonical orientation over :func:`build_pencil_general`:
    forward z-pencils to x-pencils, backward the mirror, unless the
    planner gives another permutation or order."""
    if perm is None:
        perm = (0, 1, 2) if forward else (1, 2, 0)
    if order is None:
        order = "col_first" if forward else "row_first"
    return build_pencil_general(world, shape, perm=perm, order=order,
                                executor=executor, forward=forward,
                                wire_dtype=wire_dtype, algorithm=algorithm,
                                overlap_chunks=overlap_chunks, batch=batch)


def build_pencil_rfft3d(world: World, shape: tuple[int, int, int], *,
                        executor: str = "cuda", forward: bool = True,
                        wire_dtype: str | None = None,
                        algorithm: str = "alltoall", overlap_chunks: int = 1,
                        batch: int | None = None
                        ) -> tuple[StageGraph, PencilSpec]:
    """The pencil real-to-complex (forward) / complex-to-real (backward)
    chain: the real axis Z is whole in the z-pencils, so the r2c shrink
    to n2//2+1 runs before the first exchange. Forward maps real
    z-pencils [N0, N1, N2] to complex x-pencils [N0, N1, N2//2+1];
    backward is its inverse (the real Z transform after the last
    exchange, on the whole joined axis)."""
    _flat(algorithm)
    bo = 0 if check_batch(batch) is None else 1
    x_, y_, z_ = bo, 1 + bo, 2 + bo
    rows, cols = _grid(world)
    row, col = world.axis_names
    spec = PencilSpec(tuple(int(s) for s in shape), rows, cols, row, col,
                      perm=(0, 1, 2) if forward else (1, 2, 0),
                      order="col_first" if forward else "row_first")
    n0, n1, n2 = spec.shape
    n2h = n2 // 2 + 1
    if forward:
        nodes = (
            local_node("t0", "t0_r2c_z", ("r2c", z_)),
            exchange_node("t2a", f"t2a_exchange_{col}", mesh_axis=col,
                          parts=cols, split=z_, concat=y_, chunk_axis=x_),
            local_node("t1", "t1_fft_y", ("crop", y_, n1),
                       ("fft", (y_,), True), fuse=True),
            exchange_node("t2b", f"t2b_exchange_{row}", mesh_axis=row,
                          parts=rows, split=y_, concat=x_, chunk_axis=z_),
            local_node("t3", "t3_fft_x", ("crop", x_, n0),
                       ("fft", (x_,), True), fuse=True),
        )
        pre = (("pad", x_, spec.n0p), ("pad", y_, spec.n1p_col))
        post = (("crop", y_, n1), ("crop", z_, n2h))
    else:
        nodes = (
            local_node("t3", "t3_ifft_x", ("fft", (x_,), False)),
            exchange_node("t2b", f"t2b_exchange_{row}", mesh_axis=row,
                          parts=rows, split=x_, concat=y_, chunk_axis=z_),
            local_node("t1", "t1_ifft_y", ("crop", y_, n1),
                       ("fft", (y_,), False), fuse=True),
            exchange_node("t2a", f"t2a_exchange_{col}", mesh_axis=col,
                          parts=cols, split=y_, concat=z_, chunk_axis=x_),
            local_node("t1", "t1_crop", ("crop", z_, n2h), fuse=True),
            local_node("t0", "t0_c2r_z", ("c2r", n2, z_)),
        )
        pre = (("pad", y_, spec.n1p_row), ("pad", z_, pad_to(n2h, cols)))
        post = (("crop", x_, n0), ("crop", y_, n1))
    graph = StageGraph(world=world, nodes=nodes, executor=executor,
                       wire_dtype=wire_dtype, pre=pre, post=post,
                       in_dims=tuple(d + bo for d in spec.in_placement),
                       out_dims=tuple(d + bo for d in spec.out_placement),
                       algorithm=algorithm, overlap_chunks=overlap_chunks,
                       batch=batch)
    return graph.validate(), spec


def build_pencil_spectral_op(world: World, shape: tuple[int, int, int],
                             multiplier: Callable, *,
                             row_axis: str | None = None,
                             col_axis: str | None = None,
                             executor: str = "cuda",
                             wire_dtype: str | None = None,
                             algorithm: str = "alltoall",
                             overlap_chunks: int = 1,
                             batch: int | None = None
                             ) -> tuple[StageGraph, PencilSpec]:
    """The pencil spectral operator's chain, the port of
    ``build_pencil_spectral_op``: the canonical z-pencil to x-pencil
    chain stopped in the x-pencil layout (k0 whole, k1 on the rows, k2 on
    the columns), ``t_mid`` there (crop, forward X FFT, the multiplier
    over this rank's (row, col) offsets and the overlap chunk's k2
    slice, inverse X FFT), and the inverse legs back: t2b and t2a out,
    t2b and t2a back, where the pair of plans in the caller's layout
    takes six. :func:`.slab.build_slab_spectral_op` has the multiplier's
    contract. I/O is the z-pencil layout on both sides."""
    _flat(algorithm)
    bo = 0 if check_batch(batch) is None else 1
    rows, cols = _grid(world)
    row_axis = row_axis or world.axis_names[0]
    col_axis = col_axis or world.axis_names[-1]
    spec = PencilSpec(tuple(int(s) for s in shape), rows, cols, row_axis,
                      col_axis, (0, 1, 2), "col_first")
    ex = get_executor(executor)
    n0, n1, n2 = spec.shape
    n0p, n1pc, n1pr = spec.n0p, spec.n1p_col, spec.n1p_row
    c1 = n1pr // rows                  # midpoint k1 extent (row shard)
    c2 = pad_to(n2, cols) // cols      # midpoint k2 extent (col shard)

    def mid_factory(rank: int):
        coords = axis_coords(world, rank)
        k1_lo = coords[row_axis] * c1
        k2_lo = coords[col_axis] * c2

        def mid_chunk(u, lo, hi):
            u = ex(_crop_axis(u, bo, n0), (bo,), True)
            u = apply_midpoint(u, multiplier, index_grids(
                n0, (k1_lo, k1_lo + c1), (k2_lo + lo, k2_lo + hi),
                u.device))
            return ex(u, (bo,), False)

        return mid_chunk

    x_, y_, z_ = bo, 1 + bo, 2 + bo
    nodes = (
        local_node("t0", "t0_fft_z", ("fft", (z_,), True)),
        exchange_node("t2a", f"t2a_exchange_{col_axis}", mesh_axis=col_axis,
                      parts=cols, split=z_, concat=y_, chunk_axis=x_),
        local_node("t1", "t1_fft_y", ("crop", y_, n1), ("fft", (y_,), True),
                   fuse=True),
        exchange_node("t2b", f"t2b_exchange_{row_axis}", mesh_axis=row_axis,
                      parts=rows, split=y_, concat=x_, chunk_axis=z_),
        local_node("t_mid", "t_mid", fuse=True, takes_bounds=True,
                   factory=mid_factory),
        exchange_node("t2b", f"t2b_exchange_{row_axis}", mesh_axis=row_axis,
                      parts=rows, split=x_, concat=y_, chunk_axis=z_),
        local_node("t3", "t3_ifft_y", ("crop", y_, n1),
                   ("fft", (y_,), False), fuse=True),
        exchange_node("t2a", f"t2a_exchange_{col_axis}", mesh_axis=col_axis,
                      parts=cols, split=y_, concat=z_, chunk_axis=x_),
        local_node("t3", "t3_ifft_z", ("crop", z_, n2),
                   ("fft", (z_,), False), fuse=True),
    )
    graph = StageGraph(
        world=world, nodes=nodes, executor=executor, wire_dtype=wire_dtype,
        pre=(("pad", x_, n0p), ("pad", y_, n1pc)),
        post=(("crop", x_, n0), ("crop", y_, n1)),
        in_dims=(x_, y_), out_dims=(x_, y_), algorithm=algorithm,
        overlap_chunks=overlap_chunks, batch=batch)
    return graph.validate(), spec
