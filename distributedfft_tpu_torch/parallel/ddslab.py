"""Slab- and pencil-decomposed 3D FFTs at the emulated-double (dd) tier.

The port of ``distributedfft_tpu/parallel/ddslab.py``. A dd value is a
(hi, lo) pair of complex64 (float32 on the real side,
:mod:`..ops.ddfft`). Each builder here joins the pair into complex128 at
its entry, runs the port's complex128 chain of :mod:`.slab` or
:mod:`.pencil` on the ``torch`` executor (``torch.fft``, cuFFT Z2Z on the
card; each item of a batch transformed alone, :data:`ENGINE`), and
splits the result at its exit. The exchange therefore ships
the joined complex128 blocks: 16 bytes an element, as the JAX package's
two complex64 components do. Pad and crop, ``algorithm``,
``overlap_chunks`` and ``batch`` are the chain's own; a length the JAX
tier does not cover is refused (:func:`..ops.ddfft.dd_covers`).

A builder returns ``(fn, spec)``, ``fn(hi, lo, timer=None) -> (hi, lo)``
taking what the chain takes: on a loopback world the global pair
(``[B, ...]`` batched), on a process group this rank's box of each
component. The staged builders (:func:`build_dd_single_stages`,
:func:`build_dd_slab_stages`, :func:`build_dd_pencil_stages`) are the
port's staged pipelines with the JAX package's dd stage names; each
stage maps a pair (a pair of held-block lists between stages), joining
at its entry and splitting at its exit.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import ddfft
from ..stagegraph import gather, run_graph, scatter
from ..utils.trace import trace_stages
from .mesh import World
from .pencil import PencilSpec, build_pencil_fft3d, build_pencil_rfft3d
from .slab import (SlabSpec, build_slab_fft3d, build_slab_rfft3d,
                   build_slab_stages)
from .staged import build_pencil_stages, build_single_stages

ENGINE = ddfft.PLAN_EXECUTOR


def _check_dd_extent(n: int, shape) -> None:
    # Every per-axis transform of these chains is whole and local, so the
    # coverage rule is fft_axis_dd's.
    if not ddfft.dd_covers(n):
        raise ValueError(
            f"dd pipeline: axis length {n} has no dense-coverable "
            f"four-step split and exceeds the Bluestein pad bound "
            f"(shape {tuple(shape)})")


def _checked(shape) -> tuple[int, int, int]:
    shape = tuple(int(s) for s in shape)
    for n in shape:
        _check_dd_extent(n, shape)
    return shape


def _pair_fn(graph, donate: bool = False) -> Callable:
    """``fn(hi, lo, timer=None)``: join, the complex128 chain, split.
    ``donate`` (C2C chains): the output is written into ``hi`` and ``lo``
    when it has their shape."""

    def fn(hi: torch.Tensor, lo: torch.Tensor, timer=None):
        y = gather(graph, run_graph(graph, scatter(graph, ddfft.join(hi, lo)),
                                    timer))
        into = donate and y.shape == hi.shape
        return ddfft.split(y, out=(hi, lo) if into else None)

    fn.stage_graph = graph
    return fn


def build_dd_slab_fft3d(world: World, shape, *, forward: bool = True,
                        algorithm: str = "alltoall", donate: bool = False,
                        overlap_chunks: int = 1, batch: int | None = None
                        ) -> tuple[Callable, SlabSpec]:
    """dd 3D C2C over a 1D world (or a hybrid world's combined axis): X
    slabs in and Y slabs out forward, the mirror backward; forward
    unnormalized, backward scaled 1/N."""
    graph, spec = build_slab_fft3d(
        world, _checked(shape), executor=ENGINE, forward=forward,
        algorithm=algorithm, overlap_chunks=overlap_chunks, batch=batch)
    return _pair_fn(graph, donate), spec


def build_dd_slab_rfft3d(world: World, shape, *, forward: bool = True,
                         algorithm: str = "alltoall", overlap_chunks: int = 1,
                         batch: int | None = None
                         ) -> tuple[Callable, SlabSpec]:
    """Slab dd r2c (forward: real float32 pairs [N0, N1, N2] in X slabs
    to complex pairs [N0, N1, N2//2+1] in Y slabs) and c2r (backward,
    scaled 1/N)."""
    graph, spec = build_slab_rfft3d(
        world, _checked(shape), executor=ENGINE, forward=forward,
        algorithm=algorithm, overlap_chunks=overlap_chunks, batch=batch)
    return _pair_fn(graph), spec


def build_dd_pencil_fft3d(world: World, shape, *, forward: bool = True,
                          algorithm: str = "alltoall", donate: bool = False,
                          overlap_chunks: int = 1, batch: int | None = None
                          ) -> tuple[Callable, PencilSpec]:
    """dd 3D C2C over a (rows x cols) world: z-pencils to x-pencils
    forward, the mirror backward."""
    graph, spec = build_pencil_fft3d(
        world, _checked(shape), executor=ENGINE, forward=forward,
        algorithm=algorithm, overlap_chunks=overlap_chunks, batch=batch)
    return _pair_fn(graph, donate), spec


def build_dd_pencil_rfft3d(world: World, shape, *, forward: bool = True,
                           algorithm: str = "alltoall",
                           overlap_chunks: int = 1, batch: int | None = None
                           ) -> tuple[Callable, PencilSpec]:
    """Pencil dd r2c / c2r: real z-pencils to complex x-pencils forward
    (the real axis shrunk before the first exchange), the mirror
    backward."""
    graph, spec = build_pencil_rfft3d(
        world, _checked(shape), executor=ENGINE, forward=forward,
        algorithm=algorithm, overlap_chunks=overlap_chunks, batch=batch)
    return _pair_fn(graph), spec


# ------------------------------------------------------------ staged

def _join_pair(pair):
    hi, lo = pair
    if isinstance(hi, list):
        return [ddfft.join(h, l) for h, l in zip(hi, lo)]
    return ddfft.join(hi, lo)


def _split_value(y):
    if isinstance(y, list):
        parts = [ddfft.split(b) for b in y]
        return [p[0] for p in parts], [p[1] for p in parts]
    return ddfft.split(y)


def _pair_stages(stages, names: dict) -> list:
    """``stages`` (complex128 stages of the ``torch`` executor) as stages
    over pairs: each one's bare callable between a join and a split,
    under the dd name ``names`` gives its own."""

    def pair_stage(fn):
        return lambda pair: _split_value(fn(_join_pair(pair)))

    return trace_stages([
        (names.get(name, name), pair_stage(getattr(fn, "__wrapped__", fn)))
        for name, fn in stages])


_YZ_X = {"t0_fft_yz": "t0_dd_fft_yz", "t3_fft_x": "t3_dd_fft_x"}


def build_dd_single_stages(shape, *, forward: bool = True,
                           batch: int | None = None) -> list:
    """One device, forward or backward: ``t0_dd_fft_yz`` (the YZ planes)
    and ``t3_dd_fft_x`` (the X lines) over pairs."""
    return _pair_stages(build_single_stages(
        _checked(shape), executor=ENGINE, forward=forward, batch=batch),
        _YZ_X)


def build_dd_slab_stages(world: World, shape, *, algorithm: str = "alltoall",
                         overlap_chunks: int = 1) -> tuple[list, SlabSpec]:
    """The forward dd slab chain as ``t0_dd_fft_yz``, ``t2_all_to_all``
    (under ``hierarchical`` at K = 1 its two legs) and ``t3_dd_fft_x``,
    each stage over pairs."""
    stages, spec = build_slab_stages(
        world, _checked(shape), executor=ENGINE, algorithm=algorithm,
        overlap_chunks=overlap_chunks)
    return _pair_stages(stages, _YZ_X), spec


def build_dd_pencil_stages(world: World, shape, *, algorithm: str = "alltoall",
                           overlap_chunks: int = 1, batch: int | None = None
                           ) -> tuple[list, PencilSpec]:
    """The forward dd pencil chain as its five stages (t0, t2a, t1, t2b,
    t3 under the complex chain's names, as in the JAX package), each
    over pairs."""
    stages, spec = build_pencil_stages(
        world, _checked(shape), executor=ENGINE, algorithm=algorithm,
        overlap_chunks=overlap_chunks, batch=batch)
    return _pair_stages(stages, {}), spec
