"""Slab-decomposed distributed 3D FFT over a 1D world.

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
backward). Every builder takes the exchange's ``wire_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..geometry import pad_to
from ..stagegraph import StageGraph, exchange_node, local_node
from .mesh import World

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


def build_slab_general(world: World, shape: tuple[int, int, int], *,
                       in_axis: int, out_axis: int, executor="cuda",
                       forward: bool = True, wire_dtype: str | None = None
                       ) -> tuple[StageGraph, SlabSpec]:
    """The slab chain for any ordered pair of distinct axes: the input is
    sharded along ``in_axis``, the other two axes are transformed
    locally, one exchange reshards ``in_axis`` <-> ``out_axis``, and
    ``in_axis`` is transformed last. ``wire_dtype`` compresses the
    exchange."""
    if in_axis == out_axis or not (0 <= in_axis < 3 and 0 <= out_axis < 3):
        raise ValueError(f"need distinct 3D axes, got {in_axis}, {out_axis}")
    p = world.size
    spec = SlabSpec(tuple(int(s) for s in shape), p, in_axis, out_axis)
    n_in = spec.shape[in_axis]
    local_axes = tuple(a for a in range(3) if a != in_axis)
    nodes = (
        local_node("t0", f"t0_fft_{''.join(_L[a] for a in local_axes)}",
                   ("fft", local_axes, forward)),
        local_node("t1", "t1_pack", ("pack", out_axis, spec.out_padded_extent)),
        exchange_node("t2", "t2_exchange_slab", parts=p,
                      split=out_axis, concat=in_axis),
        local_node("t3", f"t3_fft_{_L[in_axis]}",
                   ("crop", in_axis, n_in), ("fft", (in_axis,), forward),
                   fuse=True),
    )
    graph = StageGraph(world=world, nodes=nodes, executor=executor,
                       wire_dtype=wire_dtype)
    return graph.validate(), spec


def slab_axes(forward: bool) -> tuple[int, int]:
    """(in_axis, out_axis) of the canonical orientation: X-slabs ->
    Y-slabs forward, Y-slabs -> X-slabs backward."""
    return (0, 1) if forward else (1, 0)


def build_slab_fft3d(world: World, shape: tuple[int, int, int], *,
                     executor="cuda", forward: bool = True,
                     wire_dtype: str | None = None
                     ) -> tuple[StageGraph, SlabSpec]:
    """The slab chain in the canonical orientation (:func:`slab_axes`)."""
    in_axis, out_axis = slab_axes(forward)
    return build_slab_general(world, shape, in_axis=in_axis,
                              out_axis=out_axis, executor=executor,
                              forward=forward, wire_dtype=wire_dtype)


def build_slab_rfft3d(world: World, shape: tuple[int, int, int], *,
                      executor="cuda", forward: bool = True,
                      wire_dtype: str | None = None
                      ) -> tuple[StageGraph, SlabSpec]:
    """The slab real-to-complex (forward) / complex-to-real (backward)
    chain, the port of ``build_slab_rfft3d``: the real axis is axis 2,
    device-local in both slab layouts, so the r2c shrink to n2//2+1
    happens before the exchange (forward) or after it (backward).
    Forward maps real X-slabs [N0, N1, N2] to complex Y-slabs
    [N0, N1, N2//2+1]; backward is its inverse (real out, 1/N)."""
    in_axis, out_axis = slab_axes(forward)
    spec = SlabSpec(tuple(int(s) for s in shape), world.size, in_axis,
                    out_axis)
    n0, n1, n2 = spec.shape
    p = world.size
    if forward:
        nodes = (
            local_node("t0", "t0_r2c_zy", ("r2c", 2), ("fft", (1,), True)),
            local_node("t1", "t1_pack", ("pack", 1, spec.out_padded_extent)),
            exchange_node("t2", "t2_exchange_slab", parts=p, split=1,
                          concat=0),
            local_node("t3", "t3_fft_x", ("crop", 0, n0),
                       ("fft", (0,), True), fuse=True),
        )
    else:
        nodes = (
            local_node("t3", "t3_ifft_x", ("fft", (0,), False)),
            local_node("t1", "t1_pack", ("pack", 0, spec.out_padded_extent)),
            exchange_node("t2", "t2_exchange_slab", parts=p, split=0,
                          concat=1),
            local_node("t0", "t0_ifft_y", ("crop", 1, n1),
                       ("fft", (1,), False), fuse=True),
            local_node("t0", "t0_c2r_z", ("c2r", n2, 2)),
        )
    graph = StageGraph(world=world, nodes=nodes, executor=executor,
                       wire_dtype=wire_dtype)
    return graph.validate(), spec
