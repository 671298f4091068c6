"""Staged pipelines: each plan kind as separately timed stages.

The port of ``distributedfft_tpu/parallel/staged.py``. The reference
prints a t0..t3 breakdown on every distributed execute
(``fft_mpi_3d_api.cpp:184-201``); a staged pipeline is the same
transform as a ``[(name, fn), ...]`` list whose composition is the plan's
transform bit for bit, each stage under its trace span, for
:func:`..utils.timing.time_staged` to time one by one. The stage names
are the JAX package's, in its order. :func:`..parallel.slab
.build_slab_stages` is the slab C2C pipeline; this module has the
single-device, pencil and real ones, and :func:`build_slab_op_stages`,
the slab spectral operator's chain with its ``t_mid`` stage. Stages pass
the blocks each process holds; the first takes the plan's input and the
last returns its output.
"""

from __future__ import annotations

from ..geometry import pad_to
from ..ops.executors import get_executor
from ..stagegraph import (StagedGraph, StagedStage, apply_multiplier,
                          compile_staged)
from ..utils.trace import trace_stages
from .exchange import _crop_axis, _pad_axis
from .mesh import World
from .pencil import FLAT_ALGORITHMS, PencilSpec, _grid
from .slab import SlabSpec, _L, check_batch, index_grids

__all__ = ["build_single_stages", "build_pencil_stages",
           "build_slab_rfft_stages", "build_pencil_rfft_stages",
           "build_slab_op_stages"]


def build_single_stages(shape: tuple[int, int, int], *,
                        executor: str = "cuda", forward: bool = True,
                        batch: int | None = None) -> list:
    """One device: ``t0_fft_yz`` (the YZ planes) and ``t3_fft_x`` (the X
    lines) as two stages; ``batch=B`` runs them over ``[B, ...]``
    tensors."""
    bo = 0 if check_batch(batch) is None else 1
    ex = get_executor(executor)
    return trace_stages([
        ("t0_fft_yz", lambda x: ex(x, (1 + bo, 2 + bo), forward)),
        ("t3_fft_x", lambda y: ex(y, (bo,), forward)),
    ])


def _check_flat(algorithm: str) -> None:
    if algorithm not in FLAT_ALGORITHMS:
        raise ValueError(
            f"the pencil and real pipelines take the flat transports "
            f"{FLAT_ALGORITHMS}, got {algorithm!r}")


def build_pencil_stages(world: World, shape: tuple[int, int, int], *,
                        executor: str = "cuda", forward: bool = True,
                        algorithm: str = "alltoall",
                        perm: tuple[int, int, int] | None = None,
                        order: str | None = None, overlap_chunks: int = 1,
                        wire_dtype: str | None = None,
                        batch: int | None = None
                        ) -> tuple[list, PencilSpec]:
    """The pencil C2C chain as five stages: t0 (first FFT), t2a (first
    exchange), t1 (middle FFT), t2b (second exchange), t3 (last FFT).
    ``overlap_chunks > 1`` runs each exchange stage as K chunked
    exchanges; ``batch=B`` runs the stages over ``[B, ...]`` tensors
    (every axis one place up, one shared exchange per chunk)."""
    _check_flat(algorithm)
    bo = 0 if check_batch(batch) is None else 1
    if perm is None:
        perm = (0, 1, 2) if forward else (1, 2, 0)
    if order is None:
        order = "col_first" if forward else "row_first"
    rows, cols = _grid(world)
    row_axis, col_axis = world.axis_names
    spec = PencilSpec(tuple(int(s) for s in shape), rows, cols, row_axis,
                      col_axis, tuple(perm), order)
    n = spec.shape
    a, b, c = perm
    if order == "col_first":
        seq = [(col_axis, cols, c, b), (row_axis, rows, b, a)]
        mid_fft, last_fft = b, a
    else:
        seq = [(row_axis, rows, c, a), (col_axis, cols, a, b)]
        mid_fft, last_fft = a, b
    pads = {a: pad_to(n[a], rows), b: pad_to(n[b], cols)}
    first_pad = pad_to(n[seq[0][2]], seq[0][1])
    mid_pad = pad_to(n[seq[1][2]], seq[1][1])

    def exch(mesh_axis, parts, split, concat):
        return dict(mesh_axis=mesh_axis, parts=parts, split=split + bo,
                    concat=concat + bo, chunk_axis=3 - split - concat + bo)

    concat0, concat1 = seq[0][3], seq[1][3]
    stages = (
        StagedStage("t0", f"t0_fft_{_L[c]}",
                    local=(("fft", (c + bo,), forward),
                           ("pad", seq[0][2] + bo, first_pad))),
        StagedStage("t2a", f"t2a_exchange_{seq[0][0]}",
                    exchange=exch(*seq[0])),
        StagedStage("t1", f"t1_fft_{_L[mid_fft]}",
                    local=(("crop", concat0 + bo, n[concat0]),
                           ("fft", (mid_fft + bo,), forward),
                           ("pad", seq[1][2] + bo, mid_pad))),
        StagedStage("t2b", f"t2b_exchange_{seq[1][0]}",
                    exchange=exch(*seq[1])),
        StagedStage("t3", f"t3_fft_{_L[last_fft]}",
                    local=(("crop", concat1 + bo, n[concat1]),
                           ("fft", (last_fft + bo,), forward))),
    )
    graph = StagedGraph(
        world=world, stages=stages, algorithm=algorithm,
        wire_dtype=wire_dtype, overlap_chunks=overlap_chunks,
        executor=executor,
        pre=(("pad", a + bo, pads[a]), ("pad", b + bo, pads[b])),
        post=tuple(("crop", ax + bo, n[ax]) for ax in spec.out_placement),
        in_dims=tuple(d + bo for d in spec.in_placement),
        out_dims=tuple(d + bo for d in spec.out_placement))
    return compile_staged(graph), spec


def build_slab_rfft_stages(world: World, shape: tuple[int, int, int], *,
                           executor: str = "cuda", forward: bool = True,
                           algorithm: str = "alltoall",
                           overlap_chunks: int = 1,
                           wire_dtype: str | None = None,
                           batch: int | None = None
                           ) -> tuple[list, SlabSpec]:
    """The slab R2C (forward) / C2R (backward) chain as three stages:
    ``t0_r2c_zy``, ``t2_exchange``, ``t3_fft_x`` forward;
    ``t3_ifft_x``, ``t2_exchange``, ``t0_ifft_y_c2r`` backward;
    ``batch`` as in :func:`build_pencil_stages`."""
    _check_flat(algorithm)
    bo = 0 if check_batch(batch) is None else 1
    if world.grid is not None:
        raise ValueError("the slab R2C/C2R pipeline runs on a 1D world")
    p = world.size
    in_axis, out_axis = (0, 1) if forward else (1, 0)
    spec = SlabSpec(tuple(int(s) for s in shape), p, in_axis, out_axis)
    n0, n1, n2 = spec.shape
    n0p, n1p = pad_to(n0, p), pad_to(n1, p)
    x_, y_, z_ = bo, 1 + bo, 2 + bo
    exch = dict(mesh_axis=world.combined_axis, parts=p, chunk_axis=z_)
    if forward:
        stages = (
            StagedStage("t0", "t0_r2c_zy",
                        local=(("r2c", z_), ("fft", (y_,), True),
                               ("pad", y_, n1p))),
            StagedStage("t2", "t2_exchange",
                        exchange=dict(exch, split=y_, concat=x_)),
            StagedStage("t3", "t3_fft_x",
                        local=(("crop", x_, n0), ("fft", (x_,), True))),
        )
    else:
        stages = (
            StagedStage("t3", "t3_ifft_x",
                        local=(("fft", (x_,), False), ("pad", x_, n0p))),
            StagedStage("t2", "t2_exchange",
                        exchange=dict(exch, split=x_, concat=y_)),
            StagedStage("t0", "t0_ifft_y_c2r",
                        local=(("crop", y_, n1), ("fft", (y_,), False),
                               ("c2r", n2, z_))),
        )
    graph = StagedGraph(
        world=world, stages=stages, algorithm=algorithm,
        wire_dtype=wire_dtype, overlap_chunks=overlap_chunks,
        executor=executor,
        pre=(("pad", in_axis + bo, spec.in_padded_extent),),
        post=(("crop", out_axis + bo, spec.shape[out_axis]),),
        in_dims=(in_axis + bo,), out_dims=(out_axis + bo,))
    return compile_staged(graph), spec


def build_pencil_rfft_stages(world: World, shape: tuple[int, int, int], *,
                             executor: str = "cuda", forward: bool = True,
                             algorithm: str = "alltoall",
                             overlap_chunks: int = 1,
                             wire_dtype: str | None = None,
                             batch: int | None = None
                             ) -> tuple[list, PencilSpec]:
    """The pencil R2C / C2R chain as five stages with t2a/t2b exchange
    lines (the canonical chains of :func:`.pencil.build_pencil_rfft3d`);
    ``batch`` as in :func:`build_pencil_stages`."""
    _check_flat(algorithm)
    bo = 0 if check_batch(batch) is None else 1
    rows, cols = _grid(world)
    row, col = world.axis_names
    spec = PencilSpec(tuple(int(s) for s in shape), rows, cols, row, col,
                      perm=(0, 1, 2) if forward else (1, 2, 0),
                      order="col_first" if forward else "row_first")
    n0, n1, n2 = spec.shape
    n0p, n1pc, n1pr = spec.n0p, spec.n1p_col, spec.n1p_row
    n2h = n2 // 2 + 1
    n2hp = pad_to(n2h, cols)
    x_, y_, z_ = bo, 1 + bo, 2 + bo
    exch_a = dict(mesh_axis=col, parts=cols, chunk_axis=x_)
    exch_b = dict(mesh_axis=row, parts=rows, chunk_axis=z_)
    if forward:
        stages = (
            StagedStage("t0", "t0_r2c_z",
                        local=(("r2c", z_), ("pad", z_, n2hp))),
            StagedStage("t2a", f"t2a_exchange_{col}",
                        exchange=dict(exch_a, split=z_, concat=y_)),
            StagedStage("t1", "t1_fft_y",
                        local=(("crop", y_, n1), ("fft", (y_,), True),
                               ("pad", y_, n1pr))),
            StagedStage("t2b", f"t2b_exchange_{row}",
                        exchange=dict(exch_b, split=y_, concat=x_)),
            StagedStage("t3", "t3_fft_x",
                        local=(("crop", x_, n0), ("fft", (x_,), True))),
        )
        pre = (("pad", x_, n0p), ("pad", y_, n1pc))
        post = (("crop", y_, n1), ("crop", z_, n2h))
    else:
        stages = (
            StagedStage("t3", "t3_ifft_x",
                        local=(("fft", (x_,), False), ("pad", x_, n0p))),
            StagedStage("t2b", f"t2b_exchange_{row}",
                        exchange=dict(exch_b, split=x_, concat=y_)),
            StagedStage("t1", "t1_ifft_y",
                        local=(("crop", y_, n1), ("fft", (y_,), False),
                               ("pad", y_, n1pc))),
            StagedStage("t2a", f"t2a_exchange_{col}",
                        exchange=dict(exch_a, split=y_, concat=z_)),
            StagedStage("t0", "t0_c2r_z",
                        local=(("crop", z_, n2h), ("c2r", n2, z_))),
        )
        pre = (("pad", y_, n1pr), ("pad", z_, n2hp))
        post = (("crop", x_, n0), ("crop", y_, n1))
    graph = StagedGraph(
        world=world, stages=stages, algorithm=algorithm,
        wire_dtype=wire_dtype, overlap_chunks=overlap_chunks,
        executor=executor, pre=pre, post=post,
        in_dims=tuple(d + bo for d in spec.in_placement),
        out_dims=tuple(d + bo for d in spec.out_placement))
    return compile_staged(graph), spec


def build_slab_op_stages(world: World, shape: tuple[int, int, int],
                         multiplier, *, executor: str = "cuda",
                         algorithm: str = "alltoall",
                         overlap_chunks: int = 1,
                         batch: int | None = None,
                         wire_dtype: str | None = None
                         ) -> tuple[list, SlabSpec]:
    """The slab spectral operator's chain
    (:func:`.slab.build_slab_spectral_op`) as five stages, so ``t_mid``
    is timed beside t0, t2 and t3: ``t0_fft_yz`` (forward YZ FFTs and the
    Y pad), ``t2_exchange_out``, ``t_mid`` (crop, forward X FFT, the
    multiplier over this rank's k1 rows and all of k2, inverse X FFT, X
    pad), ``t2_exchange_back`` and ``t3_ifft_yz`` (crop, inverse YZ FFTs).
    ``multiplier`` follows the fused builder's contract. K > 1 runs each
    exchange stage as K chunked exchanges. Flat transports on a 1D world
    only: the hierarchical chain is measured fused."""
    _check_flat(algorithm)
    if world.grid is not None:
        raise ValueError("the staged operator pipeline runs on a 1D world")
    bo = 0 if check_batch(batch) is None else 1
    p = world.size
    spec = SlabSpec(tuple(int(s) for s in shape), p, 0, 1)
    ex = get_executor(executor)
    n0, n1, n2 = spec.shape
    n0p, n1p = spec.in_padded_extent, spec.out_padded_extent
    c1 = n1p // p

    def mid_local(u, rank):
        u = ex(_crop_axis(u, bo, n0), (bo,), True)    # final forward X
        k1_lo = rank * c1                      # a 1D world's slab index
        u = apply_multiplier(u, multiplier(*index_grids(
            n0, (k1_lo, k1_lo + c1), (0, n2), u.device)))
        return _pad_axis(ex(u, (bo,), False), bo, n0p)  # inverse X

    exch = dict(mesh_axis=world.combined_axis, parts=p, chunk_axis=2 + bo)
    stages = (
        StagedStage("t0", "t0_fft_yz",
                    local=(("fft", (1 + bo, 2 + bo), True),
                           ("pad", 1 + bo, n1p))),
        StagedStage("t2", "t2_exchange_out",
                    exchange=dict(exch, split=1 + bo, concat=bo)),
        StagedStage("t_mid", "t_mid", local=(("call", mid_local),)),
        StagedStage("t2", "t2_exchange_back",
                    exchange=dict(exch, split=bo, concat=1 + bo)),
        StagedStage("t3", "t3_ifft_yz",
                    local=(("crop", 1 + bo, n1),
                           ("fft", (1 + bo, 2 + bo), False))),
    )
    graph = StagedGraph(
        world=world, stages=stages, algorithm=algorithm,
        wire_dtype=wire_dtype, overlap_chunks=overlap_chunks,
        executor=executor, pre=(("pad", bo, n0p),),
        post=(("crop", bo, n0),), in_dims=(bo,), out_dims=(bo,))
    return compile_staged(graph), spec
