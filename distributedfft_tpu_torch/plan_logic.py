"""Plan skeleton: which decomposition, which world, which axes, which
boxes.

The port of the decomposition logic of ``distributedfft_tpu/
plan_logic.py``: :class:`PlanOptions` with its validation,
:func:`choose_decomposition`, :func:`eligible_decompositions`,
:func:`negotiate_device_count`, the overlap knob
(:func:`auto_overlap_chunks`, :func:`resolve_overlap_chunks`), the layout
classifier (:func:`classify_layout`) and :func:`logic_plan3d` with its
layout absorption. A world of one rank (or none) is ``"single"``, a 1D
world ``"slab"``, a 2D world ``"pencil"`` (or, under the hierarchical
transport, the slab chain over its combined axis); an int world picks by
:func:`choose_decomposition`, a pencil grid by
:func:`~.geometry.pencil_grid_min_surface`. A caller's ``in_spec`` /
``out_spec`` that is a slab or pencil layout of the world re-axes the
chain to start or end there (heFFTe's reshape minimization,
``heffte_plan_logic.cpp:162-245,265-408``); ``in_absorbed`` /
``out_absorbed`` say which were. Per-rank boxes follow the ceil rule
(``stage_layouts``); a real-to-complex plan's complex side is shrunk
along axis 2 (``Box3.r2c``). ``batch`` records a leading batch axis of B
transforms, whose per-rank block the overlap heuristic sees B-fold.
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass, replace
from typing import Sequence

from . import geometry as geo
from .ops.executors import MM_COMPLEX_MODES, MM_TIERS, TIER_ALIASES
from .parallel.exchange import ALGORITHMS, WIRE_DTYPES, wire_itemsize
from .parallel.mesh import HYBRID_AXES, World, make_world, spec_entries
from .parallel.slab import check_batch, slab_axes

DECOMPOSITIONS = ("single", "slab", "pencil")

#: Valid ``PlanOptions.tune`` values (None: the ``DFFT_TUNE`` default).
TUNE_MODES = (None, "off", "wisdom", "measure")


@dataclass(frozen=True)
class PlanOptions:
    """The plan knobs of the JAX package's ``PlanOptions``, validated
    with its error text.

    ``decomposition``: auto | single | slab | pencil. ``algorithm``: the
    exchange transport (:data:`~.parallel.exchange.ALGORITHMS`).
    ``executor``: the local FFT executor label. ``renegotiate``: the
    device-count rule of an int world (auto: shrink only at equal
    per-rank compute; force: the largest evenly-dividing count; never).
    ``overlap_chunks``: K of the pipelined t2/t3 overlap, an int >= 1,
    ``"auto"`` (:func:`auto_overlap_chunks`), or None (the
    ``DFFT_OVERLAP`` environment variable, else 1). ``wire_dtype``: the
    exchange's wire codec (``"none"`` or None: exact). ``mm_precision``
    / ``mm_complex``: the matmul-family tier and complex mode, composed
    into the executor label. ``fuse``: the ``:fuse`` flag (None keeps the
    label's own).

    ``donate``: the plan may use its input's storage as workspace (its
    contents afterwards unspecified; the result is the same).

    ``tune``: measured planning (:mod:`.tuner`): ``"off"`` plans by the
    static heuristics, ``"wisdom"`` replays a stored winner and falls back
    to the heuristics on a miss, ``"measure"`` runs the pruned tournament
    on a miss and records its winner; None reads ``DFFT_TUNE`` (unset:
    off). ``max_roundtrip_err``: the plan's round-trip error budget, under
    which the tuner admits compressed-wire and reduced-precision
    candidates (their errors summed against the one budget).

    ``wire_dtype=None`` reads ``DFFT_WIRE_DTYPE`` and ``fuse=None``
    ``DFFT_FUSE`` at plan time (:func:`resolve_wire_dtype`,
    :func:`resolve_fuse`; unset: exact, unfused).
    """

    decomposition: str = "auto"
    algorithm: str = "alltoall"
    executor: str = "cuda"
    donate: bool = False
    renegotiate: str = "auto"
    overlap_chunks: int | str | None = None
    tune: str | None = None
    wire_dtype: str | None = None
    max_roundtrip_err: float | None = None
    mm_precision: str | None = None
    mm_complex: str | None = None
    fuse: bool | None = None

    def __post_init__(self) -> None:
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; use one of "
                f"{ALGORITHMS}")
        wd = self.wire_dtype
        if isinstance(wd, str):
            wd = wd.strip().lower()
            object.__setattr__(self, "wire_dtype", wd or None)
            wd = self.wire_dtype
        if wd not in WIRE_DTYPES and wd != "none":
            raise ValueError(
                f"wire_dtype must be one of {WIRE_DTYPES} or 'none', "
                f"got {self.wire_dtype!r}")
        mre = self.max_roundtrip_err
        if mre is not None and (
                not isinstance(mre, (int, float)) or isinstance(mre, bool)
                or not mre > 0):
            raise ValueError(
                f"max_roundtrip_err must be a positive float or None, "
                f"got {mre!r}")
        if self.decomposition not in ("auto",) + DECOMPOSITIONS:
            raise ValueError(f"unknown decomposition {self.decomposition!r}")
        if self.renegotiate not in ("auto", "force", "never"):
            raise ValueError(
                f"renegotiate must be auto|force|never, got "
                f"{self.renegotiate!r}")
        oc = self.overlap_chunks
        if isinstance(oc, str) and oc != "auto":
            try:
                oc = int(oc)
            except ValueError:
                raise ValueError(
                    f"overlap_chunks must be an int >= 1, 'auto', or None, "
                    f"got {self.overlap_chunks!r}") from None
            object.__setattr__(self, "overlap_chunks", oc)
        if oc is not None and oc != "auto" and (
                not isinstance(oc, int) or isinstance(oc, bool) or oc < 1):
            raise ValueError(
                f"overlap_chunks must be an int >= 1, 'auto', or None, "
                f"got {self.overlap_chunks!r}")
        if self.tune not in TUNE_MODES:
            raise ValueError(
                f"tune must be one of {tuple(m for m in TUNE_MODES if m)} "
                f"or None, got {self.tune!r}")
        mp = self.mm_precision
        if isinstance(mp, str):
            mp = mp.strip().lower() or None
            mp = TIER_ALIASES.get(mp, mp)
            object.__setattr__(self, "mm_precision", mp)
        if mp is not None and mp not in MM_TIERS:
            raise ValueError(
                f"mm_precision must be one of {MM_TIERS} or None, "
                f"got {self.mm_precision!r}")
        mc = self.mm_complex
        if isinstance(mc, str):
            mc = mc.strip().lower() or None
            object.__setattr__(self, "mm_complex", mc)
        if mc is not None and mc not in MM_COMPLEX_MODES:
            raise ValueError(
                f"mm_complex must be one of {MM_COMPLEX_MODES} or None, "
                f"got {self.mm_complex!r}")
        fu = self.fuse
        if isinstance(fu, str):
            fu = fu.strip().lower()
            if fu in ("", "none"):
                fu = None
            elif fu in ("1", "true", "on", "fuse"):
                fu = True
            elif fu in ("0", "false", "off"):
                fu = False
            else:
                raise ValueError(
                    f"fuse must be a bool or None, got {self.fuse!r}")
            object.__setattr__(self, "fuse", fu)
        elif fu is not None and not isinstance(fu, bool):
            raise ValueError(
                f"fuse must be a bool or None, got {self.fuse!r}")
        if not isinstance(self.donate, bool):
            raise ValueError(f"donate must be a bool, got {self.donate!r}")


DEFAULT_OPTIONS = PlanOptions()


def default_options(decomposition: str = "auto", **kw) -> PlanOptions:
    """cf. ``default_options<backend>()`` of the reference."""
    return PlanOptions(decomposition=decomposition, **kw)


# The overlap knob's constants are the JAX package's own defaults (a
# per-rank chunk floor and a chunk cap chosen there for the TPU), kept so
# that both packages resolve the same K; they were not measured on the
# H100.
OVERLAP_AUTO_MIN_CHUNK_BYTES = 4 << 20
OVERLAP_AUTO_MAX_CHUNKS = 8


def auto_overlap_chunks(shape: Sequence[int], ndev: int,
                        itemsize: int = 8) -> int:
    """K from the per-rank block bytes: clamp(block /
    OVERLAP_AUTO_MIN_CHUNK_BYTES, 1, OVERLAP_AUTO_MAX_CHUNKS). The chunk
    axis's extent clamps K again (``overlap_chunk_bounds``)."""
    if ndev <= 1:
        return 1
    block = itemsize * math.prod(int(s) for s in shape) // ndev
    return max(1, min(OVERLAP_AUTO_MAX_CHUNKS,
                      block // OVERLAP_AUTO_MIN_CHUNK_BYTES))


def resolve_overlap_chunks(value: int | str | None,
                           shape: Sequence[int] | None = None,
                           ndev: int = 1, itemsize: int = 8) -> int:
    """A ``PlanOptions.overlap_chunks`` value as a concrete K: None reads
    ``DFFT_OVERLAP`` (unset: 1), ``"auto"`` runs
    :func:`auto_overlap_chunks`, ints pass validated."""
    if value is None:
        raw = os.environ.get("DFFT_OVERLAP", "").strip()
        value = raw if raw else 1
    if isinstance(value, str):
        if value == "auto":
            return auto_overlap_chunks(shape, ndev, itemsize) if shape else 1
        try:
            value = int(value)
        except ValueError:
            raise ValueError(
                f"overlap_chunks must be an int >= 1 or 'auto', got "
                f"{value!r} (check DFFT_OVERLAP)") from None
    if value < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {value}")
    return int(value)


def resolve_wire_dtype(value: str | None) -> str | None:
    """A ``PlanOptions.wire_dtype`` value as a concrete wire mode: None
    (exact) or a registered codec name. None reads ``DFFT_WIRE_DTYPE``
    (unset: exact); ``"none"`` pins the exact wire whatever the
    environment says."""
    if value is None:
        value = os.environ.get("DFFT_WIRE_DTYPE", "").strip() or "none"
    v = value.strip().lower() if isinstance(value, str) else value
    if v in (None, "", "none", "0"):
        return None
    if v in WIRE_DTYPES:
        return v
    raise ValueError(
        f"wire_dtype must be one of {tuple(w for w in WIRE_DTYPES if w)} "
        f"or 'none', got {value!r} (check DFFT_WIRE_DTYPE)")


def resolve_fuse(value: bool | None) -> bool:
    """A ``PlanOptions.fuse`` value as a bool: None reads ``DFFT_FUSE``
    (unset: False); explicit bools pass through."""
    if value is None:
        raw = os.environ.get("DFFT_FUSE", "").strip().lower()
        if raw in ("", "0", "false", "off", "none"):
            return False
        if raw in ("1", "true", "on", "fuse"):
            return True
        raise ValueError(
            f"DFFT_FUSE must be 0/1/on/off, got {raw!r}")
    return bool(value)


def resolve_tune_mode(value: str | None) -> str:
    """A ``PlanOptions.tune`` value as a concrete mode: None reads
    ``DFFT_TUNE`` (unset: ``"off"``); strings pass validated."""
    if value is None:
        value = os.environ.get("DFFT_TUNE", "").strip() or "off"
    if value not in TUNE_MODES or value is None:
        raise ValueError(
            f"tune mode must be one of {tuple(m for m in TUNE_MODES if m)}, "
            f"got {value!r} (check DFFT_TUNE)")
    return value


def mm_dft_flops(shape: Sequence[int], axes: Sequence[int] | None = None,
                 ) -> float:
    """Real flops of one dense matmul-DFT transform over ``axes`` (all
    three by default): each axis is one complex contraction of the block
    against an n x n DFT matrix, ``8 * N * n`` real flops. A ranking
    quantity of the tuner's precision-tier model, not a prediction."""
    shape = tuple(int(s) for s in shape)
    n_total = math.prod(shape)
    return sum(8.0 * n_total * shape[a] for a in (axes or range(3)))


@dataclass(frozen=True)
class LogicPlan:
    shape: tuple[int, int, int]
    decomposition: str                 # "single" | "slab" | "pencil"
    world: World | None
    slab_axes: tuple[int, int] | None = None
    pencil_perm: tuple[int, int, int] | None = None
    pencil_order: str | None = None
    # (requested, used, reason) when an int world's count was judged
    negotiated: tuple | None = None
    algorithm: str = "alltoall"
    overlap_chunks: int = 1
    # Whether the caller's in/out layouts are the chain's own endpoints
    # (True) or still need an edge reshape (False).
    in_absorbed: bool = True
    out_absorbed: bool = True
    # Leading batch axis of B coalesced transforms (None: unbatched);
    # geometry and boxes stay per transform.
    batch: int | None = None
    # A spectral operator plan's op label (None: a transform).
    op: str | None = None
    # The exchanges' wire codec (None: exact).
    wire_dtype: str | None = None


def classify_layout(world: World, spec) -> tuple[str, tuple]:
    """A layout against the chain shapes: ``("slab", (axis,))`` when a 1D
    world's axis shards exactly one dim, ``("pencil", (row_dim,
    col_dim))`` when a 2D world's axes each shard one distinct dim, else
    ``("other", ())`` (replicated dims, tupled axes, partial
    placements)."""
    entries = spec_entries(world, spec, 3)
    placement: dict = {}
    for d, e in enumerate(entries):
        if e is None:
            continue
        names = e if isinstance(e, tuple) else (e,)
        if len(names) != 1:
            return ("other", ())
        placement[names[0]] = d
    names = list(world.axis_names)
    if world.grid is None and set(placement) == set(names):
        return ("slab", (placement[names[0]],))
    if world.grid is not None and set(placement) == set(names):
        return ("pencil", (placement[names[0]], placement[names[1]]))
    return ("other", ())


def eligible_decompositions(shape: Sequence[int], ndev: int
                            ) -> tuple[str, ...]:
    """Decompositions worth measuring for ``ndev`` devices: slab while
    every device owns a plane on both exchange axes, pencil on any
    multi-device count."""
    shape = tuple(int(s) for s in shape)
    if ndev <= 1:
        return ("single",)
    out = []
    if ndev <= min(shape[0], shape[1]):
        out.append("slab")
    out.append("pencil")
    return tuple(out)


def choose_decomposition(shape: Sequence[int], ndev: int) -> str:
    """Slab while every device owns at least one plane of axes 0 and 1,
    pencil once the devices outnumber them."""
    n0, n1, _ = shape
    if ndev <= 1:
        return "single"
    if ndev <= min(n0, n1):
        return "slab"
    return "pencil"


def _chain_pad_axes(shape, decomposition: str, p: int, *,
                    slab_axes: tuple[int, int] | None = None,
                    perm: tuple[int, int, int] | None = None,
                    order: str | None = None) -> list[tuple[int, int]]:
    """(array_axis, parts) pairs the chain ceil-pads at device count p."""
    if decomposition == "slab":
        in_axis, out_axis = slab_axes if slab_axes is not None else (0, 1)
        return [(in_axis, p), (out_axis, p)]
    rows, cols = geo.pencil_grid_min_surface(shape, p)
    a, b, c = perm if perm is not None else (0, 1, 2)
    pairs = [(a, rows), (b, cols)]
    if (order or "col_first") == "col_first":
        pairs += [(c, cols), (b, rows)]
    else:
        pairs += [(c, rows), (a, cols)]
    return pairs


def negotiate_device_count(shape: Sequence[int], ndev: int,
                           decomposition: str = "slab", *,
                           slab_axes: tuple[int, int] | None = None,
                           perm: tuple[int, int, int] | None = None,
                           order: str | None = None) -> int:
    """Largest device count <= ``ndev`` whose slabs or pencils divide
    every padded axis of the chain evenly."""
    shape = tuple(int(s) for s in shape)
    if decomposition == "slab":
        a0, a1 = slab_axes if slab_axes is not None else (0, 1)
        start = min(ndev, shape[a0], shape[a1])
    else:
        start = ndev
    for p in range(start, 0, -1):
        if all(shape[a] % parts == 0
               for a, parts in _chain_pad_axes(shape, decomposition, p,
                                               slab_axes=slab_axes,
                                               perm=perm, order=order)):
            return p
    return 1


def _renegotiate(shape, ndev: int, decomp: str, mode: str = "auto", **axes
                 ) -> tuple[int, tuple | None]:
    """Device-count renegotiation: ``"never"`` keeps the request,
    ``"force"`` takes the largest evenly-dividing count, ``"auto"``
    shrinks to it only when every chain axis keeps its per-device ceil
    extent."""
    if mode == "never":
        return ndev, None
    neg = negotiate_device_count(shape, ndev, decomp, **axes)
    if neg == ndev:
        return ndev, None
    if mode == "force":
        return neg, (ndev, neg, "forced: largest evenly-dividing count")
    old = _chain_pad_axes(shape, decomp, ndev, **axes)
    new = _chain_pad_axes(shape, decomp, neg, **axes)
    if all(geo.ceil_shards(shape[a], p1) == geo.ceil_shards(shape[a], p0)
           for (a, p0), (_, p1) in zip(old, new)):
        return neg, (ndev, neg, "auto: even shards at equal per-device "
                                "compute")
    return ndev, (ndev, ndev, f"kept: shrinking to {neg} evenly-dividing "
                              "devices would raise per-device compute more "
                              "than the padding it removes")


def _int_world(shape, decomp: str, ndev: int) -> World:
    if decomp == "slab":
        return make_world(ndev)
    return make_world(geo.pencil_grid_min_surface(shape, ndev))


def logic_plan3d(shape, world: World | int | Sequence[int] | None,
                 options: PlanOptions = DEFAULT_OPTIONS, *,
                 forward: bool = True, in_spec=None, out_spec=None,
                 batch: int | None = None) -> LogicPlan:
    """Resolve (shape, world, options, layouts) to a plan skeleton.
    ``world`` is None (one device), an int (a loopback world of that
    many ranks, the decomposition chosen here and the count renegotiated
    by ``options.renegotiate``), a ``(rows, cols)`` tuple (a loopback 2D
    world) or a :class:`World` (1D: slab, 2D: pencil).
    ``options.decomposition`` overrides the choice; a world that cannot
    run it raises. ``algorithm="hierarchical"`` runs the slab chain over
    a 2D world's combined axis (a tuple is a loopback hybrid world).
    ``in_spec`` / ``out_spec`` (this plan's orientation) that classify as
    a slab or pencil layout of the world re-axe the chain to start or end
    there; the renegotiation is judged on those axes.
    ``options.overlap_chunks`` is resolved to K on the final world."""
    shape = tuple(int(s) for s in shape)
    batch = check_batch(batch)
    decomp = options.decomposition
    hier = options.algorithm == "hierarchical"
    if hier:
        # One logical exchange split into two legs over a hybrid world:
        # a pencil chain's exchanges are within one axis already.
        if isinstance(world, (tuple, list)) and len(world) == 2:
            world = make_world(tuple(world), HYBRID_AXES)
        if not isinstance(world, World) or world.grid is None:
            raise ValueError(
                "algorithm='hierarchical' requires an explicit 2D hybrid "
                "(dcn x ici) world (e.g. multihost.make_hybrid_world()); "
                f"got {world!r}")
        if decomp not in ("auto", "slab"):
            raise ValueError(
                "hierarchical transport runs the slab chain over the "
                f"combined hybrid axis; decomposition={decomp!r} is not "
                "compatible")
        decomp = "slab"
    requested = None
    if isinstance(world, int):
        requested = world
        if decomp == "auto":
            decomp = choose_decomposition(shape, world)
        world = None if decomp == "single" or world == 1 else _int_world(
            shape, decomp, world)
    elif world is not None and not isinstance(world, World):
        world = make_world(tuple(world))
    if decomp == "single" or world is None or world.size == 1:
        return LogicPlan(shape, "single", None, batch=batch)
    if decomp == "auto":
        decomp = "pencil" if world.grid is not None else "slab"
    if decomp == "slab" and world.grid is not None and not hier:
        raise ValueError("slab decomposition requires a 1D world")
    if decomp == "pencil" and world.grid is None:
        raise ValueError("pencil decomposition requires a 2D world")

    # ---- axis assignment (reshape minimization); the hierarchical slab
    # chain runs over the combined axis, so its layouts are not read as
    # a pencil grid's and take the edge reshape.
    kin = (classify_layout(world, in_spec)
           if in_spec is not None and not hier else None)
    kout = (classify_layout(world, out_spec)
            if out_spec is not None and not hier else None)
    in_absorbed, out_absorbed = in_spec is None, out_spec is None
    axes: dict = {}
    if decomp == "slab":
        default_in, default_out = slab_axes(forward)
        in_axis = default_in
        if kin is not None and kin[0] == "slab":
            in_axis, in_absorbed = kin[1][0], True
        if kout is not None and kout[0] == "slab" and kout[1][0] != in_axis:
            out_axis, out_absorbed = kout[1][0], True
        else:
            out_axis = default_out if default_out != in_axis else default_in
        axes = dict(slab_axes=(in_axis, out_axis))
    else:
        perm = (0, 1, 2) if forward else (1, 2, 0)
        order = "col_first" if forward else "row_first"
        if kin is not None and kin[0] == "pencil":
            a, b = kin[1]
            perm, in_absorbed = (a, b, 3 - a - b), True
        # The two exchange orders reach two output layouts; take the one
        # matching the caller's out_spec when there is one.
        if kout is not None and kout[0] == "pencil":
            if kout[1] == (perm[1], perm[2]):
                order, out_absorbed = "col_first", True
            elif kout[1] == (perm[2], perm[0]):
                order, out_absorbed = "row_first", True
        axes = dict(perm=perm, order=order)
    negotiated = None
    if requested is not None:
        used, negotiated = _renegotiate(shape, requested, decomp,
                                        options.renegotiate, **axes)
        if used != requested:
            if used == 1 and (in_spec is not None or out_spec is not None):
                # Layout-carrying plans need a world; keep the request.
                negotiated = (requested, requested,
                              "kept: in_spec/out_spec require a mesh")
            elif used == 1:
                return LogicPlan(shape, "single", None,
                                 negotiated=negotiated, batch=batch)
            else:
                world = _int_world(shape, decomp, used)
    overlap = resolve_overlap_chunks(options.overlap_chunks, shape=shape,
                                     ndev=world.size,
                                     itemsize=8 * (batch or 1))
    wire = resolve_wire_dtype(options.wire_dtype)
    return LogicPlan(shape, decomp, world, axes.get("slab_axes"),
                     axes.get("perm"), axes.get("order"), negotiated,
                     options.algorithm, overlap, in_absorbed, out_absorbed,
                     batch, wire_dtype=wire)


def _grid_boxes(world: geo.Box3, placements: dict[int, int], *,
                major_dim: int | None = None) -> tuple:
    """Boxes of a layout splitting ``placements`` = {array_dim: parts} by
    the ceil rule, ``major_dim``'s chunk index slowest (row-major rank
    order). One entry is a slab split, two a pencil grid."""
    dims = sorted(placements)
    if major_dim is not None and dims[0] != major_dim:
        dims = [major_dim] + [d for d in dims if d != major_dim]
    chunks = {d: [(world.low[d] + a, world.low[d] + b)
                  for a, b in geo.ceil_splits(world.shape[d], placements[d])]
              for d in dims}
    boxes = []
    for combo in itertools.product(*(range(placements[d]) for d in dims)):
        low, high = list(world.low), list(world.high)
        for d, ci in zip(dims, combo):
            low[d], high[d] = chunks[d][ci]
        boxes.append(geo.Box3(tuple(low), tuple(high)))
    return tuple(boxes)


def stage_layouts(lp: LogicPlan, world: geo.Box3) -> tuple:
    """The per-stage ``(fft_axes, boxes)`` chain of the plan over
    ``world``, its input side first."""
    if lp.decomposition == "single":
        return (((0, 1, 2), (world,)),)
    if lp.decomposition == "slab":
        in_axis, out_axis = lp.slab_axes
        p = lp.world.size
        local_axes = tuple(a for a in range(3) if a != in_axis)
        return ((local_axes, _grid_boxes(world, {in_axis: p})),
                ((in_axis,), _grid_boxes(world, {out_axis: p})))
    rows, cols = lp.world.grid
    a, b, c = lp.pencil_perm
    if lp.pencil_order == "col_first":
        return (((c,), _grid_boxes(world, {a: rows, b: cols}, major_dim=a)),
                ((b,), _grid_boxes(world, {a: rows, c: cols}, major_dim=a)),
                ((a,), _grid_boxes(world, {b: rows, c: cols}, major_dim=b)))
    return (((c,), _grid_boxes(world, {a: rows, b: cols}, major_dim=a)),
            ((a,), _grid_boxes(world, {c: rows, b: cols}, major_dim=c)),
            ((b,), _grid_boxes(world, {c: rows, a: cols}, major_dim=c)))


def io_boxes(lp: LogicPlan, *, forward: bool = True, real: bool = False
             ) -> tuple[list[geo.Box3], list[geo.Box3]]:
    """Per-rank input and output boxes, rank order. ``real``: an r2c
    plan, whose complex side (the output forward, the input backward)
    is the world shrunk along axis 2."""
    world = geo.world_box(lp.shape)
    cworld = world.r2c(2) if real else world
    in_world, out_world = (world, cworld) if forward else (cworld, world)
    return (list(stage_layouts(lp, in_world)[0][1]),
            list(stage_layouts(lp, out_world)[-1][1]))


def exchange_payloads(lp: LogicPlan, shape, itemsize: int) -> list[dict]:
    """Per-exchange payload accounting of a plan skeleton (the port of
    ``plan_logic.exchange_payloads``): the true information each
    exchange moves against the bytes each transport ships, for one
    execution of ``shape`` (the per-transform 3D complex-side shape) at
    ``itemsize`` bytes an element.

    Entries ``{stage, mesh_axis, parts, link, wire_factor, true_bytes,
    alltoall_bytes, alltoallv_bytes}``: ``alltoall`` (and the ring) ship
    both the split and the concat axis's ceil pads, ``alltoallv`` strips
    the split axis's; ``link`` is ``"dcn"`` on the hybrid world's node
    axis, else ``"ici"``; ``wire_factor`` scales any byte entry to the
    wire codec's bytes (1.0 exact). A batched plan's entries scale by B.
    A hierarchical slab plan has two entries, ``t2a`` (within nodes) and
    ``t2b`` (across nodes). An operator plan (``lp.op``) has its forward
    entries followed by their mirrors in reverse order (the return
    legs)."""
    if lp.world is None:
        return []

    def _done(entries: list[dict]) -> list[dict]:
        if lp.op:
            return entries + [dict(e) for e in reversed(entries)]
        return entries

    shape = tuple(int(s) for s in shape)
    bsz = lp.batch or 1
    pad = lambda n, k: k * (-(-n // k))  # noqa: E731
    wf = wire_itemsize(itemsize, lp.wire_dtype) / itemsize
    link = lambda ax: "dcn" if str(ax) == "dcn" else "ici"  # noqa: E731
    world = lp.world
    names = world.axis_names
    out = []
    if lp.decomposition == "slab":
        p = world.size
        a_in, a_out = lp.slab_axes if lp.slab_axes else (0, 1)
        oth = 3 - a_in - a_out
        n_in, n_out, n_oth = shape[a_in], shape[a_out], shape[oth]
        if lp.algorithm == "hierarchical" and len(names) == 2:
            # Two legs of one logical exchange, each a dense all-to-all
            # over its own axis of the padded block.
            dcn_name, ici_name = names
            padded = pad(n_in, p) * pad(n_out, p) * n_oth
            truev = n_in * n_out * n_oth
            for stage, ax_name in (("t2a", ici_name), ("t2b", dcn_name)):
                parts = world.axis_size(ax_name)
                f = (parts - 1) / parts
                dense = int(padded * f * itemsize * bsz)
                out.append({
                    "stage": stage, "mesh_axis": ax_name, "parts": parts,
                    "link": link(ax_name), "wire_factor": wf,
                    "true_bytes": int(truev * f * itemsize * bsz),
                    "alltoall_bytes": dense,
                    "alltoallv_bytes": dense,
                })
            return _done(out)
        f = (p - 1) / p
        out.append({
            "stage": "t2", "mesh_axis": names[0], "parts": p,
            "link": link(names[0]), "wire_factor": wf,
            "true_bytes": int(n_in * n_out * n_oth * f * itemsize * bsz),
            "alltoall_bytes": int(pad(n_in, p) * pad(n_out, p) * n_oth * f
                                  * itemsize * bsz),
            "alltoallv_bytes": int(pad(n_in, p) * n_out * n_oth * f
                                   * itemsize * bsz),
        })
        return _done(out)
    rows, cols = world.grid
    a, b, c = lp.pencil_perm if lp.pencil_perm else (0, 1, 2)
    order = lp.pencil_order or "col_first"
    # (stage, mesh axis index, parts, split axis, padded extents of the
    # two other axes at that stage)
    pa, pb = pad(shape[a], rows), pad(shape[b], cols)
    if order == "col_first":
        pc = pad(shape[c], cols)
        seq = [("t2a", 1, cols, c, pa * pb), ("t2b", 0, rows, b, pa * pc)]
    else:
        pc = pad(shape[c], rows)
        seq = [("t2a", 0, rows, c, pa * pb), ("t2b", 1, cols, a, pc * pb)]
    true_vol = shape[0] * shape[1] * shape[2]
    for stage, ax_i, parts, split, bystander_padded in seq:
        f = (parts - 1) / parts
        out.append({
            "stage": stage, "mesh_axis": names[ax_i], "parts": parts,
            "link": link(names[ax_i]), "wire_factor": wf,
            "true_bytes": int(true_vol * f * itemsize * bsz),
            "alltoall_bytes": int(bystander_padded * pad(shape[split], parts)
                                  * f * itemsize * bsz),
            "alltoallv_bytes": int(bystander_padded * shape[split] * f
                                   * itemsize * bsz),
        })
    return _done(out)


# ------------------------------------------------------------ stage model

def fused_model_stages(lp: LogicPlan, shape=None, itemsize: int = 8, *,
                       executor: str | None = None) -> tuple:
    """Stage keys whose codec pass the fusion tier folds into the stage
    kernel for the chain ``lp`` run by ``executor`` (the port of
    ``plan_logic.fused_model_stages``): the ``fused=`` argument of
    :func:`model_stage_seconds`. The port's :class:`LogicPlan` carries no
    executor, so the caller passes the plan's (``plan.executor``).

    Empty unless the fusion gate of :func:`..stagegraph.plan_fusion`
    holds (a ``:fuse`` executor, a wire codec, K == 1, an exchange); then
    ``("t0", "t1", "t3")`` for a pencil chain (sender and every
    receiver), ``("t3",)`` for a slab transform (its receiver), and
    nothing for an operator chain on the slab (its sender and inverse
    pass run the plain codec, whose streams match the unfused chain's).
    ``shape`` and ``itemsize`` resolve a K that is not yet an int."""
    from .ops.executors import split_fuse

    if not isinstance(executor, str):
        return ()
    try:
        if not split_fuse(executor)[1]:
            return ()
    except ValueError:
        return ()
    if lp.wire_dtype is None:
        return ()
    k = lp.overlap_chunks
    if not isinstance(k, int):
        ndev = 1 if lp.world is None else lp.world.size
        k = resolve_overlap_chunks(k, shape, ndev, itemsize)
    if k != 1:
        return ()
    if lp.world is None or lp.decomposition == "single":
        return ()
    if lp.decomposition == "pencil":
        return ("t0", "t1", "t3")
    if lp.op:
        return ()
    return ("t3",)


def model_stage_seconds(
    lp: LogicPlan,
    shape: Sequence[int],
    itemsize: int,
    *,
    hbm_gbps: float,
    wire_gbps: float,
    launch_seconds: float,
    algorithm: str | None = None,
    overlap_chunks: int | None = None,
    exchange_correction: float = 1.0,
    dcn_gbps: float | None = None,
    mm_tflops: float | None = None,
    concurrent_hide_seconds: float = 0.0,
    hide_correction: float = 1.0,
    fused: Sequence[str] = (),
) -> dict:
    """Per-stage analytic time of one execution, keyed ``t0..t3`` (and
    ``t_mid`` for an operator chain): the port of
    ``plan_logic.model_stage_seconds``, the model side of the explain
    join, with its arguments, arithmetic and entries.

    FFT stages are the HBM roofline (each axis pass reads and writes the
    rank's block once); ``t2`` is every exchange's exposed time under the
    plan's transport (:func:`exchange_payloads` and
    :func:`..parallel.exchange.exchange_model_seconds`) with the K-chunk
    crossover, each exchange hiding under the FFT stage that consumes its
    output. ``t0`` is the input-side pass (two axes on the slab, one on
    the pencil), ``t1`` the pencil's middle pass (0 elsewhere), ``t3``
    the output-side pass; an operator chain's ``t_mid`` is the forward
    and inverse pass of the mid axis plus the pointwise multiply, and
    its exchanges count both legs. Every entry has ``seconds``,
    ``flops``, ``hbm_bytes`` and ``wire_bytes``; ``t2`` also ``legs``,
    ``raw_seconds`` and ``steps``.

    ``lp.batch`` = B scales each stage's bytes and flops B-fold.
    ``mm_tflops`` prices FFT stages as dense matmul-DFTs at that rate
    (the HBM stream stays the floor). ``exchange_correction`` scales
    exchange seconds, ``hide_correction`` every hide budget,
    ``concurrent_hide_seconds`` adds co-scheduled transforms' compute to
    it. ``fused`` names stages whose codec pass is fused
    (:func:`fused_model_stages`): each read+write pair of such a stage
    moves ``(1 + wire_factor) * block`` instead of ``2 * block``. The
    defaults leave the plain model unchanged."""
    from .parallel.exchange import WIRE_BYTE_KEYS, exchange_model_seconds

    shape = tuple(int(s) for s in shape)
    ndev = 1 if lp.world is None else lp.world.size
    bsz = lp.batch or 1
    n_total = math.prod(shape) * bsz
    block_bytes = itemsize * n_total / ndev
    alg = algorithm or lp.algorithm
    k = overlap_chunks
    if k is None:
        k = lp.overlap_chunks if isinstance(lp.overlap_chunks, int) else 1

    def fft_stage(axes) -> dict:
        hbm = 2.0 * block_bytes * len(axes)  # read + write per axis pass
        flops = sum(5.0 * n_total * math.log2(max(2, shape[a]))
                    for a in axes) / ndev
        out = {"seconds": hbm / (hbm_gbps * 1e9), "flops": flops,
               "hbm_bytes": hbm, "wire_bytes": 0.0}
        if mm_tflops:
            mm = mm_dft_flops(shape, axes) * bsz / ndev
            out["mm_flops"] = mm
            out["seconds"] = max(out["seconds"], mm / (mm_tflops * 1e12))
        return out

    zero = {"seconds": 0.0, "flops": 0.0, "hbm_bytes": 0.0,
            "wire_bytes": 0.0}
    op_chain = bool(lp.op)
    if op_chain:
        mid = fft_stage((0, 0))  # forward + inverse pass of the mid axis
        pw = 2.0 * block_bytes   # pointwise multiply: read + write once
        mid["hbm_bytes"] += pw
        mid["seconds"] += pw / (hbm_gbps * 1e9)
        mid["flops"] += 6.0 * n_total / ndev  # one complex multiply/elem
        if lp.decomposition == "pencil" and lp.world is not None:
            out = {"t0": fft_stage((2,)), "t1": fft_stage((1,)),
                   "t2": dict(zero), "t_mid": mid,
                   "t3": fft_stage((1, 2))}
        else:
            out = {"t0": fft_stage((1, 2)), "t1": dict(zero),
                   "t2": dict(zero), "t_mid": mid,
                   "t3": fft_stage((1, 2))}
    elif lp.decomposition == "single" or lp.world is None:
        # the staged single pipeline: t0 the YZ planes, t3 the X lines
        out = {"t0": fft_stage((1, 2)), "t1": dict(zero),
               "t2": dict(zero), "t3": fft_stage((0,))}
    else:
        axes = [s[0] for s in stage_layouts(lp, geo.world_box(lp.shape))]
        if lp.decomposition == "slab":
            out = {"t0": fft_stage(axes[0]), "t1": dict(zero),
                   "t2": dict(zero), "t3": fft_stage(axes[1])}
        else:
            out = {"t0": fft_stage(axes[0]), "t1": fft_stage(axes[1]),
                   "t2": dict(zero), "t3": fft_stage(axes[2])}

    if fused:
        wf = wire_itemsize(itemsize, lp.wire_dtype) / float(itemsize)
        for st in fused:
            e = out.get(st)
            if not e or e["hbm_bytes"] <= 0.0 or wf >= 1.0:
                continue
            e["hbm_bytes"] *= (1.0 + wf) / 2.0
            e["seconds"] = e["hbm_bytes"] / (hbm_gbps * 1e9)
            if mm_tflops and e.get("mm_flops"):
                e["seconds"] = max(e["seconds"],
                                   e["mm_flops"] / (mm_tflops * 1e12))
            e["fused"] = True

    # each exchange hides under the stage that consumes its output: slab
    # t2 -> t3 (both hierarchical legs too); pencil t2a -> t1, t2b -> t3;
    # an operator chain's legs under half of t_mid + t3 each
    payloads = exchange_payloads(lp, shape, itemsize)
    hide = {"t2": out["t3"]["seconds"], "t2a": out["t1"]["seconds"],
            "t2b": out["t3"]["seconds"]}
    if lp.decomposition == "slab":
        hide["t2a"] = hide["t2b"] = out["t3"]["seconds"]
    if op_chain:
        half = 0.5 * (out["t_mid"]["seconds"] + out["t3"]["seconds"])
        hide = {"t2": half, "t2a": half, "t2b": half}
    if concurrent_hide_seconds:
        hide = {key: v + float(concurrent_hide_seconds)
                for key, v in hide.items()}
    t2 = out["t2"]
    # the hierarchical leg pipeline at K > 1 hides the ICI leg under the
    # DCN leg's raw transfer too
    leg_pipelined = alg == "hierarchical" and k > 1
    dcn_raw = 0.0
    if leg_pipelined:
        for e in payloads:
            if e["stage"] == "t2b":
                gb = (dcn_gbps if e.get("link") == "dcn" and dcn_gbps
                      else wire_gbps)
                wb = (e[WIRE_BYTE_KEYS[alg]] * e.get("wire_factor", 1.0)
                      / ndev)
                dcn_raw = exchange_model_seconds(
                    wb, e["parts"], alg, wire_gbps=gb,
                    launch_seconds=launch_seconds)["seconds"]
                break
    for e in payloads:
        gbps = (dcn_gbps if e.get("link") == "dcn" and dcn_gbps
                else wire_gbps)
        wire = e[WIRE_BYTE_KEYS[alg]] * e.get("wire_factor", 1.0) / ndev
        hide_s = hide.get(e["stage"], 0.0)
        pipelined = leg_pipelined and e["stage"] == "t2a"
        if pipelined:
            hide_s += dcn_raw
        hide_s *= hide_correction
        m = exchange_model_seconds(
            wire, e["parts"], alg, wire_gbps=gbps,
            launch_seconds=launch_seconds, overlap_chunks=k,
            hide_seconds=hide_s)
        t2["seconds"] += m["exposed_seconds"] * exchange_correction
        t2["wire_bytes"] += wire
        t2.setdefault("raw_seconds", 0.0)
        t2["raw_seconds"] += m["seconds"] * exchange_correction
        t2.setdefault("steps", 0)
        t2["steps"] += m["steps"]
        t2.setdefault("legs", []).append({
            "stage": e["stage"], "mesh_axis": str(e["mesh_axis"]),
            "link": e.get("link", "ici"), "parts": e["parts"],
            "wire_bytes": wire, "wire_gbps": gbps,
            "seconds": m["exposed_seconds"] * exchange_correction,
            "raw_seconds": m["seconds"] * exchange_correction,
            "hide_seconds": hide_s, "leg_pipelined": pipelined,
        })
    return out


def model_concurrent_seconds(
    transforms: Sequence[tuple],
    *,
    hbm_gbps: float,
    wire_gbps: float,
    launch_seconds: float,
    dcn_gbps: float | None = None,
    **model_kw,
) -> dict:
    """The modelled price of a :func:`..stagegraph.schedule_concurrent`
    program over N transforms (the port of
    ``plan_logic.model_concurrent_seconds``): each transform's exchanges
    re-priced with the other transforms' FFT compute as extra hide
    budget (``concurrent_hide_seconds``).

    ``transforms`` holds ``(lp, shape, itemsize)`` triples, or
    ``(lp, shape, itemsize, executor)`` where the executor decides the
    fused stages (:func:`fused_model_stages`; a triple prices the chain
    unfused). Returns ``{"sequential_seconds", "concurrent_seconds",
    "hidden_seconds", "speedup", "per_transform"}``; the concurrent price
    never exceeds the sequential one, and equals it for one
    transform."""
    transforms = [tuple(t) + (None,) * (4 - len(t)) for t in transforms]
    kw = dict(hbm_gbps=hbm_gbps, wire_gbps=wire_gbps,
              launch_seconds=launch_seconds, dcn_gbps=dcn_gbps,
              **model_kw)

    def compute_s(m: dict) -> float:
        return sum(m[key]["seconds"] for key in m if key != "t2")

    def fused_of(lp, shape, itemsize, ex) -> tuple:
        return fused_model_stages(lp, shape, itemsize, executor=ex)

    solo = [model_stage_seconds(lp, shape, itemsize,
                                fused=fused_of(lp, shape, itemsize, ex), **kw)
            for lp, shape, itemsize, ex in transforms]
    comp = [compute_s(m) for m in solo]
    total_comp = sum(comp)
    priced = [
        model_stage_seconds(
            lp, shape, itemsize,
            concurrent_hide_seconds=total_comp - comp[i],
            fused=fused_of(lp, shape, itemsize, ex), **kw)
        for i, (lp, shape, itemsize, ex) in enumerate(transforms)
    ]
    sequential = sum(comp[i] + solo[i]["t2"]["seconds"]
                     for i in range(len(solo)))
    concurrent = min(sequential,
                     total_comp + sum(m["t2"]["seconds"] for m in priced))
    return {
        "sequential_seconds": sequential,
        "concurrent_seconds": concurrent,
        "hidden_seconds": sequential - concurrent,
        "speedup": (sequential / concurrent) if concurrent > 0 else 1.0,
        "per_transform": priced,
    }
