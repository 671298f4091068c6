"""Slab-decomposed distributed 3D FFT over a 1D world (or the combined
axis of a hybrid world).

The port of ``build_slab_general`` / ``build_slab_fft3d`` of
``distributedfft_tpu/parallel/slab.py``: the reference engine's four
stages (``fft_mpi_3d_api.cpp:181-214``),

    t0  FFT over the two local axes          (t0_fft_yz forward)
    t1  ceil-pad of the axis about to be split (t1_pack)
    t2  one tiled all-to-all                 (t2_exchange_slab)
    t3  crop, then FFT over the slab axis    (t3_fft_x forward)

emitted as a :class:`~..stagegraph.StageGraph` with the JAX package's
node names. Forward runs X-slabs -> Y-slabs, ``(in_axis, out_axis) =
(0, 1)``; backward (1, 0). Uneven extents are ceil-padded before an axis
is split and cropped before it is transformed, so the pads never touch a
transform. :func:`build_slab_rfft3d` is the real-to-complex chain
(``t0_r2c_zy`` ... ``t3_fft_x`` forward, ``t3_ifft_x`` ... ``t0_c2r_z``
backward). Every builder takes the exchange's ``algorithm``, its overlap
K (``overlap_chunks``, chunks of the bystander axis) and its
``wire_dtype``, and ``batch``: a leading batch axis of B transforms
(array axis a + 1 is spatial axis a), every stage batched and each
exchange one shared exchange with the batch a bystander (names and
:class:`SlabSpec` stay spatial). On a 2D hybrid world the C2C chain runs
over the combined axis (rank ``d*I + e`` holds slab ``d*I + e``), its exchange
named ``t2_exchange_dcn+ici``; the hierarchical transport splits it into
the legs ``t2a_exchange_ici`` and ``t2b_exchange_dcn``.
:func:`build_slab_stages` is the staged pipeline of the C2C chain.

:func:`build_slab_spectral_op` is the spectral operator's chain (the
``midpoint=`` hook of :func:`build_slab_general`): the forward chain
stopped in the transposed Y-slab layout, the ``t_mid`` node, and the
inverse legs back to X-slabs, two exchanges in all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..geometry import pad_to
from ..ops.executors import get_executor
from ..stagegraph import (StagedGraph, StagedStage, StageGraph,
                          apply_midpoint, compile_staged, exchange_node,
                          local_node)
from .exchange import _axis_label, _crop_axis
from .mesh import World, axis_coords

_L = "xyz"  # axis index -> stage-name letter


@dataclass(frozen=True)
class SlabSpec:
    """Static geometry of a slab plan: true and padded extents."""

    shape: tuple[int, int, int]
    parts: int
    in_axis: int = 0
    out_axis: int = 1

    @property
    def in_padded_extent(self) -> int:
        return pad_to(self.shape[self.in_axis], self.parts)

    @property
    def out_padded_extent(self) -> int:
        return pad_to(self.shape[self.out_axis], self.parts)

    @property
    def in_padded(self) -> tuple[int, int, int]:
        s = list(self.shape)
        s[self.in_axis] = self.in_padded_extent
        return tuple(s)

    @property
    def out_padded(self) -> tuple[int, int, int]:
        s = list(self.shape)
        s[self.out_axis] = self.out_padded_extent
        return tuple(s)


def check_batch(batch: int | None) -> int | None:
    """Validate a ``batch`` argument: None is the unbatched 3D chain; an
    int >= 1 prepends a leading batch axis of that extent, B independent
    transforms through one shared exchange per t2 stage (the batch a
    bystander of every collective)."""
    if batch is None:
        return None
    if not isinstance(batch, int) or isinstance(batch, bool) or batch < 1:
        raise ValueError(f"batch must be an int >= 1 or None, got {batch!r}")
    return batch


def _slab_axis(world: World) -> tuple:
    """(mesh-axis spec, parts, axis_sizes) of the slab chain's exchange:
    a 1D world's axis, or a 2D world's combined axis with its grid."""
    return world.combined_axis, world.size, world.grid


def build_slab_general(world: World, shape: tuple[int, int, int], *,
                       in_axis: int, out_axis: int, executor="cuda",
                       forward: bool = True, wire_dtype: str | None = None,
                       algorithm: str = "alltoall", overlap_chunks: int = 1,
                       batch: int | None = None,
                       midpoint: Callable | None = None
                       ) -> tuple[StageGraph, SlabSpec]:
    """The slab chain for any ordered pair of distinct axes: the input is
    sharded along ``in_axis``, the other two axes are transformed
    locally, one exchange reshards ``in_axis`` <-> ``out_axis``, and
    ``in_axis`` is transformed last. ``algorithm`` and
    ``overlap_chunks`` pick the exchange's transport and K,
    ``wire_dtype`` compresses it, ``batch`` prepends a batch axis.
    ``midpoint`` (a multiplier generator) builds the spectral operator's
    chain instead (:func:`build_slab_spectral_op`), in the canonical
    forward orientation only."""
    if midpoint is not None:
        if not forward or (in_axis, out_axis) != (0, 1):
            raise ValueError(
                "the midpoint (spectral-operator) hook runs the canonical "
                "forward chain: forward=True, (in_axis, out_axis)=(0, 1)")
        return build_slab_spectral_op(
            world, shape, midpoint, executor=executor,
            wire_dtype=wire_dtype, algorithm=algorithm,
            overlap_chunks=overlap_chunks, batch=batch)
    if in_axis == out_axis or not (0 <= in_axis < 3 and 0 <= out_axis < 3):
        raise ValueError(f"need distinct 3D axes, got {in_axis}, {out_axis}")
    bo = 0 if check_batch(batch) is None else 1
    mesh_axis, p, axis_sizes = _slab_axis(world)
    spec = SlabSpec(tuple(int(s) for s in shape), p, in_axis, out_axis)
    n_in = spec.shape[in_axis]
    local_axes = tuple(a for a in range(3) if a != in_axis)
    ax_in, ax_out = in_axis + bo, out_axis + bo
    nodes = (
        local_node("t0", f"t0_fft_{''.join(_L[a] for a in local_axes)}",
                   ("fft", tuple(a + bo for a in local_axes), forward)),
        local_node("t1", "t1_pack", ("pack", ax_out, spec.out_padded_extent)),
        exchange_node("t2", f"t2_exchange_{_axis_label(mesh_axis)}",
                      mesh_axis=mesh_axis, parts=p, split=ax_out,
                      concat=ax_in, axis_sizes=axis_sizes,
                      chunk_axis=3 - in_axis - out_axis + bo),
        local_node("t3", f"t3_fft_{_L[in_axis]}",
                   ("crop", ax_in, n_in), ("fft", (ax_in,), forward),
                   fuse=True),
    )
    graph = StageGraph(
        world=world, nodes=nodes, executor=executor, wire_dtype=wire_dtype,
        pre=(("pad", ax_in, spec.in_padded_extent),),
        post=(("crop", ax_out, spec.shape[out_axis]),),
        in_dims=(ax_in,), out_dims=(ax_out,), algorithm=algorithm,
        overlap_chunks=overlap_chunks, batch=batch)
    return graph.validate(), spec


def combined_axis_index(world: World, mesh_axis, rank: int) -> int:
    """``rank``'s index along a chain's mesh-axis spec: its coordinate on
    a plain axis, or the row-major index over a combined axis's names (a
    hybrid world's (dcn, ici): d * I + e, the rank itself) -- the order
    the exchange lays the blocks in, so per-rank wavenumber offsets
    agree with where each block sits."""
    coords = axis_coords(world, rank)
    names = (tuple(mesh_axis) if isinstance(mesh_axis, (tuple, list))
             else (mesh_axis,))
    idx = 0
    for a in names:
        idx = idx * world.axis_size(a) + coords[a]
    return idx


def index_grids(n0: int, k1: tuple[int, int], k2: tuple[int, int],
                device) -> tuple:
    """Broadcastable int32 global index grids of a midpoint block: all
    of axis 0, ``[lo, hi)`` of axes 1 and 2."""
    ar = lambda lo, hi: torch.arange(lo, hi, dtype=torch.int32,
                                     device=device)
    return (ar(0, n0)[:, None, None], ar(*k1)[None, :, None],
            ar(*k2)[None, None, :])


def build_slab_spectral_op(world: World, shape: tuple[int, int, int],
                           multiplier: Callable, *, executor="cuda",
                           wire_dtype: str | None = None,
                           algorithm: str = "alltoall",
                           overlap_chunks: int = 1,
                           batch: int | None = None
                           ) -> tuple[StageGraph, SlabSpec]:
    """The slab spectral operator's chain, the port of
    ``build_slab_spectral_op``: t0 (YZ FFTs), t1 pack, the outbound
    exchange, then ``t_mid`` in the transposed Y-slab layout (crop, the
    forward X FFT, the multiplier, the inverse X FFT), t1 pack, the
    return exchange, ``t3_ifft_y`` and ``t3_ifft_z`` back to X-slabs:
    two exchanges where a forward plan, a multiply and a backward plan
    in the caller's layout take four.

    ``multiplier(i0, i1, i2)`` takes broadcastable int32 global index
    grids (this rank's k1 rows, the overlap chunk's k2 columns) and
    returns the pointwise factor; rows in the k1 ceil pad are cropped
    before any inverse transform, so they need only be finite. Every
    knob of :func:`build_slab_general` composes: K chunks both exchanges
    (the multiplier generated per chunk), ``batch`` rides as a bystander
    (the multiplier broadcasts over it), ``wire_dtype`` compresses each
    leg (the multiplier applies to the decoded payload), and a hybrid
    world's ``hierarchical`` transport runs each leg in two. I/O is the
    X-slab layout on both sides; a unit multiplier is the identity."""
    bo = 0 if check_batch(batch) is None else 1
    mesh_axis, p, axis_sizes = _slab_axis(world)
    spec = SlabSpec(tuple(int(s) for s in shape), p, 0, 1)
    ex = get_executor(executor)
    n0, n1, _ = spec.shape
    n0p, n1p = spec.in_padded_extent, spec.out_padded_extent
    c1 = n1p // p          # the midpoint's local extent of the k1 axis
    t2_name = f"t2_exchange_{_axis_label(mesh_axis)}"

    def mid_factory(rank: int):
        # k0 whole, k1 this rank's rows, k2 the overlap chunk's columns
        k1_lo = combined_axis_index(world, mesh_axis, rank) * c1

        def mid_chunk(u, lo, hi):
            u = ex(_crop_axis(u, bo, n0), (bo,), True)
            u = apply_midpoint(u, multiplier, index_grids(
                n0, (k1_lo, k1_lo + c1), (lo, hi), u.device))
            return ex(u, (bo,), False)

        return mid_chunk

    nodes = (
        local_node("t0", "t0_fft_yz", ("fft", (1 + bo, 2 + bo), True)),
        local_node("t1", "t1_pack", ("pack", 1 + bo, n1p)),
        exchange_node("t2", t2_name, mesh_axis=mesh_axis, parts=p,
                      split=1 + bo, concat=bo, chunk_axis=2 + bo,
                      axis_sizes=axis_sizes),
        local_node("t_mid", "t_mid", fuse=True, takes_bounds=True,
                   factory=mid_factory),
        local_node("t1", "t1_pack", ("pack", bo, n0p)),
        exchange_node("t2", t2_name, mesh_axis=mesh_axis, parts=p,
                      split=bo, concat=1 + bo, chunk_axis=2 + bo,
                      axis_sizes=axis_sizes),
        local_node("t3", "t3_ifft_y", ("crop", 1 + bo, n1),
                   ("fft", (1 + bo,), False), fuse=True),
        # the inverse Z pass transforms the chunk axis: it runs on the
        # joined block, after the chunked exchange
        local_node("t3", "t3_ifft_z", ("fft", (2 + bo,), False)),
    )
    graph = StageGraph(
        world=world, nodes=nodes, executor=executor, wire_dtype=wire_dtype,
        pre=(("pad", bo, n0p),), post=(("crop", bo, n0),),
        in_dims=(bo,), out_dims=(bo,), algorithm=algorithm,
        overlap_chunks=overlap_chunks, batch=batch)
    return graph.validate(), spec


def slab_axes(forward: bool) -> tuple[int, int]:
    """(in_axis, out_axis) of the canonical orientation: X-slabs ->
    Y-slabs forward, Y-slabs -> X-slabs backward."""
    return (0, 1) if forward else (1, 0)


def build_slab_fft3d(world: World, shape: tuple[int, int, int], *,
                     executor="cuda", forward: bool = True,
                     wire_dtype: str | None = None,
                     algorithm: str = "alltoall", overlap_chunks: int = 1,
                     in_axis: int | None = None, out_axis: int | None = None,
                     batch: int | None = None
                     ) -> tuple[StageGraph, SlabSpec]:
    """The slab chain in the canonical orientation (:func:`slab_axes`)
    unless the planner gives its axes."""
    d_in, d_out = slab_axes(forward)
    return build_slab_general(
        world, shape, in_axis=d_in if in_axis is None else in_axis,
        out_axis=d_out if out_axis is None else out_axis, executor=executor,
        forward=forward, wire_dtype=wire_dtype, algorithm=algorithm,
        overlap_chunks=overlap_chunks, batch=batch)


def build_slab_rfft3d(world: World, shape: tuple[int, int, int], *,
                      executor="cuda", forward: bool = True,
                      wire_dtype: str | None = None,
                      algorithm: str = "alltoall", overlap_chunks: int = 1,
                      batch: int | None = None
                      ) -> tuple[StageGraph, SlabSpec]:
    """The slab real-to-complex (forward) / complex-to-real (backward)
    chain, the port of ``build_slab_rfft3d``: the real axis is axis 2,
    device-local in both slab layouts, so the r2c shrink to n2//2+1
    happens before the exchange (forward) or after it (backward).
    Forward maps real X-slabs [N0, N1, N2] to complex Y-slabs
    [N0, N1, N2//2+1]; backward is its inverse (real out, 1/N). The
    overlap chunks cut axis 2, so the backward's c2r runs after them on
    the joined block. 1D worlds only: the hierarchical transport runs
    the C2C chains."""
    if world.grid is not None:
        raise ValueError("the slab R2C/C2R chain runs on a 1D world")
    bo = 0 if check_batch(batch) is None else 1
    in_axis, out_axis = slab_axes(forward)
    spec = SlabSpec(tuple(int(s) for s in shape), world.size, in_axis,
                    out_axis)
    n0, n1, n2 = spec.shape
    p = world.size
    x_, y_, z_ = bo, 1 + bo, 2 + bo
    if forward:
        nodes = (
            local_node("t0", "t0_r2c_zy", ("r2c", z_), ("fft", (y_,), True)),
            local_node("t1", "t1_pack", ("pack", y_, spec.out_padded_extent)),
            exchange_node("t2", "t2_exchange_slab", parts=p, split=y_,
                          concat=x_, chunk_axis=z_),
            local_node("t3", "t3_fft_x", ("crop", x_, n0),
                       ("fft", (x_,), True), fuse=True),
        )
    else:
        nodes = (
            local_node("t3", "t3_ifft_x", ("fft", (x_,), False)),
            local_node("t1", "t1_pack", ("pack", x_, spec.out_padded_extent)),
            exchange_node("t2", "t2_exchange_slab", parts=p, split=x_,
                          concat=y_, chunk_axis=z_),
            local_node("t0", "t0_ifft_y", ("crop", y_, n1),
                       ("fft", (y_,), False), fuse=True),
            local_node("t0", "t0_c2r_z", ("c2r", n2, z_)),
        )
    graph = StageGraph(
        world=world, nodes=nodes, executor=executor, wire_dtype=wire_dtype,
        pre=(("pad", in_axis + bo, spec.in_padded_extent),),
        post=(("crop", out_axis + bo, spec.shape[out_axis]),),
        in_dims=(in_axis + bo,), out_dims=(out_axis + bo,),
        algorithm=algorithm, overlap_chunks=overlap_chunks, batch=batch)
    return graph.validate(), spec


def build_slab_stages(world: World, shape: tuple[int, int, int], *,
                      executor="cuda", forward: bool = True,
                      algorithm: str = "alltoall", overlap_chunks: int = 1,
                      wire_dtype: str | None = None,
                      batch: int | None = None
                      ) -> tuple[list, SlabSpec]:
    """The slab C2C chain as separately timed stages (the reference's
    per-execute t0..t3 breakdown): forward ``t0_fft_yz``,
    ``t2_all_to_all``, ``t3_fft_x``; backward ``t3_ifft_x``,
    ``t2_all_to_all``, ``t0_ifft_yz``. Under ``hierarchical`` at K = 1
    the t2 stage is its two legs, ``t2a_exchange_<ici>`` and
    ``t2b_exchange_<dcn>``, each a stage of its own (each with the
    codec's encode/decode pair when ``wire_dtype`` is set); at K > 1 it
    stays one stage whose chunks run the leg pipeline. The composition
    of the stages is the plan's transform, bit for bit; ``batch`` as in
    :func:`build_slab_general`."""
    bo = 0 if check_batch(batch) is None else 1
    mesh_axis, p, axis_sizes = _slab_axis(world)
    in_axis, out_axis = slab_axes(forward)
    spec = SlabSpec(tuple(int(s) for s in shape), p, in_axis, out_axis)
    n0, n1, _ = spec.shape
    n0p, n1p = pad_to(n0, p), pad_to(n1, p)
    x_, y_, z_ = bo, 1 + bo, 2 + bo
    split, concat = out_axis + bo, in_axis + bo
    if algorithm == "hierarchical" and overlap_chunks <= 1:
        dcn, ici = mesh_axis
        leg = dict(mesh_axis=mesh_axis, split=split, concat=concat,
                   axis_sizes=axis_sizes, parts=p)
        t2 = [StagedStage("t2a", f"t2a_exchange_{ici}",
                          leg=dict(leg, which="ici", tile_axis_out=split)),
              StagedStage("t2b", f"t2b_exchange_{dcn}",
                          leg=dict(leg, which="dcn", tile_axis_out=concat))]
    else:
        t2 = [StagedStage("t2", "t2_all_to_all", exchange=dict(
            mesh_axis=mesh_axis, parts=p, split=split, concat=concat,
            chunk_axis=z_, axis_sizes=axis_sizes))]
    if forward:
        stages = [StagedStage("t0", "t0_fft_yz",
                              local=(("fft", (y_, z_), True),
                                     ("pad", y_, n1p))),
                  *t2,
                  StagedStage("t3", "t3_fft_x",
                              local=(("crop", x_, n0), ("fft", (x_,), True)))]
    else:
        stages = [StagedStage("t3", "t3_ifft_x",
                              local=(("fft", (x_,), False), ("pad", x_, n0p))),
                  *t2,
                  StagedStage("t0", "t0_ifft_yz",
                              local=(("crop", y_, n1),
                                     ("fft", (y_, z_), False)))]
    graph = StagedGraph(
        world=world, stages=tuple(stages), algorithm=algorithm,
        wire_dtype=wire_dtype, overlap_chunks=overlap_chunks,
        executor=executor,
        pre=(("pad", in_axis + bo, spec.in_padded_extent),),
        post=(("crop", out_axis + bo, spec.shape[out_axis]),),
        in_dims=(in_axis + bo,), out_dims=(out_axis + bo,))
    return compile_staged(graph), spec
