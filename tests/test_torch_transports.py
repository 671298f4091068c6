"""The port's exchange transports, overlap-K pipeline and plan knobs.

- Each transport on a loopback world against the tiled all-to-all
  written out in numpy (even and uneven split axes, complex64 and
  complex128, with every codec), and each one's own routing: the ragged
  transport ships only true slices, the ring takes P - 1 steps, the
  hierarchical legs compose; none of them runs the dense exchange.
- The hierarchical and ring transports against the JAX functions under
  ``shard_map`` on the 8-device CPU mesh (2x4, ``("dcn", "ici")``).
- Plans with every transport and K in {1, 2, 3} against the JAX plans
  (c64 5e-4, c128 1e-11) and bit for bit against the ``alltoall``, K = 1
  plan; ``PlanOptions`` and the overlap knob against the JAX package's.
- A gloo process group of four ranks (a 1D world and a 2x2 hybrid world
  over the same processes), spawned once for the module with a
  ``file://`` store under the test's temporary directory: every
  transport and codec, the overlapped exchanges and the plans equal
  their loopback twins bit for bit. The same ranks over NCCL on four
  cards are the ``cuda``-marked twin.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import plan_logic as tpl
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel import exchange as tex
from distributedfft_tpu_torch.parallel.mesh import (HYBRID_AXES, make_world,
                                                    process_group_world)

CODECS = (None, "bf16", "int8", "split")
TOL = {np.complex64: 5e-4, np.complex128: 1e-11}


def _blocks(n, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
             * 10.0 ** (r % 3 - 1)).astype(dtype) for r in range(n)]


def _tiled(blocks, groups, split, concat):
    """``lax.all_to_all(tiled=True)`` within each group, after ceil-padding
    the split axis, in numpy."""
    out = [None] * len(blocks)
    for g in groups:
        p = len(g)
        s = blocks[g[0]].shape[split]
        to = -(-s // p) * p
        pads = [(0, 0)] * blocks[0].ndim
        pads[split] = (0, to - s)
        chunks = [np.split(np.pad(blocks[m], pads), p, axis=split)
                  for m in g]
        for d, dst in enumerate(g):
            out[dst] = np.concatenate([chunks[s][d] for s in range(p)],
                                      axis=concat)
    return out


def _world(key):
    if key == "1d4":
        return make_world(4), "slab", None
    grid = {"hybrid2x2": (2, 2), "hybrid2x3": (2, 3)}[key]
    return make_world(grid, HYBRID_AXES), HYBRID_AXES, grid


def _torch(blocks):
    return [torch.from_numpy(b) for b in blocks]


TRANSPORT_CASES = ([("1d4", a) for a in tex.FLAT_ALGORITHMS]
                   + [("hybrid2x3", a) for a in tex.ALGORITHMS])


@pytest.mark.parametrize("axes", [(1, 0), (0, 2)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("extent", ["even", "uneven"])
@pytest.mark.parametrize("world_key,algorithm", TRANSPORT_CASES)
def test_loopback_transport_is_tiled_all_to_all(world_key, algorithm,
                                                extent, dtype, axes):
    world, mesh_axis, sizes = _world(world_key)
    split, concat = axes
    p = world.size
    shape = [3, 4, 5]
    shape[split] = 2 * p if extent == "even" else 2 * p - 1
    blocks = _blocks(p, shape, dtype, seed=p + split)
    got = tex.exchange_uneven(_torch(blocks), world, split_axis=split,
                              concat_axis=concat, mesh_axis=mesh_axis,
                              algorithm=algorithm, axis_sizes=sizes)
    want = _tiled(blocks, [list(range(p))], split, concat)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("codec", CODECS[1:])
@pytest.mark.parametrize("world_key,algorithm", TRANSPORT_CASES)
def test_loopback_transport_with_codec_is_the_dense_one(world_key,
                                                        algorithm, codec):
    """A codec over any transport gives the dense exchange's bits: the
    ragged one encodes the unpadded axis (the same ceil tiles) and ships
    each wire part's true slices."""
    world, mesh_axis, sizes = _world(world_key)
    blocks = _torch(_blocks(world.size, (3, 2 * world.size - 1, 5),
                            np.complex64, seed=3))
    kw = dict(split_axis=1, concat_axis=0, mesh_axis=mesh_axis,
              wire_dtype=codec)
    want = tex.exchange_uneven(blocks, world, **kw)
    got = tex.exchange_uneven(blocks, world, algorithm=algorithm,
                              axis_sizes=sizes, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _no_dense(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the dense exchange ran")
    monkeypatch.setattr(tex, "_start_dense", refuse)


def test_alltoallv_ships_only_true_slices(monkeypatch):
    """The ragged transport writes each peer's true slice into a zeroed
    buffer: the bytes it ships are the blocks' bytes, fewer than the
    padded dense exchange's, the tail rank's pad rows stay zero, and it
    never runs the dense exchange."""
    world = make_world(4)
    blocks = _torch(_blocks(4, (3, 7, 5), np.complex64, seed=1))
    before = tex.SHIPPED["alltoall"]
    tex.exchange_uneven(blocks, world, split_axis=1, concat_axis=0)
    dense = tex.SHIPPED["alltoall"] - before
    _no_dense(monkeypatch)
    before = tex.SHIPPED["alltoallv"]
    got = tex.exchange_uneven(blocks, world, split_axis=1, concat_axis=0,
                              algorithm="alltoallv")
    shipped = tex.SHIPPED["alltoallv"] - before
    true = sum(b.numel() * b.element_size() for b in blocks)
    assert shipped == true < dense
    assert [tuple(g.shape) for g in got] == [(12, 2, 5)] * 4
    assert torch.all(got[3][:, 1] == 0)        # rank 3 owns 1 of 2 rows
    want = _tiled([b.numpy() for b in blocks], [[0, 1, 2, 3]], 1, 0)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_ring_takes_p_minus_1_steps(monkeypatch, p):
    _no_dense(monkeypatch)
    world = make_world(p)
    blocks = _blocks(p, (2, 2 * p, 3), np.complex64, seed=p)
    key = ("ppermute", "slab")
    before = tex.ROUNDS[key]
    got = tex.ring_all_to_all(_torch(blocks), world, split_axis=1,
                              concat_axis=0)
    assert tex.ROUNDS[key] - before == p - 1 == tex.transport_steps(
        "ppermute", p)
    want = _tiled(blocks, [list(range(p))], 1, 0)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("grid", [(2, 2), (2, 3), (3, 2)])
def test_hierarchical_legs_compose(grid):
    """Leg A within each node, leg B across nodes: one round on each of
    the two axes, none over the combined axis; the composed legs, the
    transport and the flat exchange agree bit for bit."""
    world = make_world(grid, HYBRID_AXES)
    p = world.size
    blocks = _torch(_blocks(p, (3, 2 * p, 2), np.complex64, seed=p))
    leg_ici, leg_dcn = tex.hierarchical_legs(
        world, split_axis=1, concat_axis=0, mesh_axis=HYBRID_AXES,
        axis_sizes=grid)
    before = dict(tex.ROUNDS)
    legs = leg_dcn(leg_ici(blocks))
    delta = {k: v - before.get(k, 0) for k, v in tex.ROUNDS.items()
             if v != before.get(k, 0)}
    assert delta == {("hierarchical", "ici"): 1, ("hierarchical", "dcn"): 1}
    whole = tex.hierarchical_all_to_all(
        blocks, world, split_axis=1, concat_axis=0, mesh_axis=HYBRID_AXES,
        axis_sizes=grid)
    flat = tex.exchange(blocks, world, split_axis=1, concat_axis=0,
                        mesh_axis=HYBRID_AXES)
    for a, b, c in zip(legs, whole, flat):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_hierarchical_needs_its_hybrid_world():
    blocks = _torch(_blocks(4, (2, 8, 2), np.complex64, seed=0))
    with pytest.raises(ValueError, match="hierarchical exchange needs"):
        tex.exchange(blocks, make_world(4), split_axis=1, concat_axis=0,
                     algorithm="hierarchical")
    with pytest.raises(ValueError, match="needs a 4x1 world"):
        tex.exchange(blocks, make_world((2, 2), HYBRID_AXES), split_axis=1,
                     concat_axis=0, mesh_axis=HYBRID_AXES,
                     algorithm="hierarchical", axis_sizes=(4, 1))
    with pytest.raises(ValueError, match="unknown exchange algorithm"):
        tex.exchange(blocks, make_world(4), split_axis=1, concat_axis=0,
                     algorithm="p2p")


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("world_key,algorithm", TRANSPORT_CASES)
def test_exchange_overlapped_equals_monolithic(world_key, algorithm, k):
    """K chunks of the bystander axis, each exchanged and computed on
    (a crop and an elementwise step, which see every value whatever the
    chunking; the plan tests hold the FFTs): the bits of K = 1, under the
    per-chunk spans."""
    from distributedfft_tpu_torch.utils.trace import capture_events

    world, mesh_axis, sizes = _world(world_key)
    p = world.size
    blocks = _torch(_blocks(p, (2 * p - 1, 2 * p - 1, 5), np.complex64, 9))
    compute = lambda bs: [b[: 2 * p - 1] * (2 - 1j) + 1 for b in bs]
    kw = dict(split_axis=1, concat_axis=0, compute=compute,
              algorithm=algorithm, mesh_axis=mesh_axis, axis_sizes=sizes,
              exchange_name="t2_x", compute_name="t3_y")
    one = tex.exchange_overlapped(blocks, world, overlap_chunks=1, **kw)
    with capture_events() as ev:
        many = tex.exchange_overlapped(blocks, world, overlap_chunks=k, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, many))
    names = [e[0] for e in ev]
    assert [f"t3_y[{i}]" for i in range(k)] == [
        n for n in names if n.startswith("t3_y")]
    if algorithm == "hierarchical":
        assert f"t2a_exchange_ici[{k - 1}]" in names
        assert names.index("t2a_exchange_ici[1]") < names.index(
            "t2b_exchange_dcn[0]")
    else:
        assert names.index("t2_x[1]") < names.index("t3_y[0]")


def test_overlap_bounds_and_steps_match_jax():
    from distributedfft_tpu.parallel import exchange as jex

    for extent in (1, 5, 8, 64, 65):
        for k in (0, 1, 2, 3, 8, 100):
            assert tex.overlap_chunk_bounds(extent, k) == \
                jex.overlap_chunk_bounds(extent, k)
    for alg in tex.ALGORITHMS:
        for parts in (1, 2, 4, 8):
            assert tex.transport_steps(alg, parts) == \
                jex.transport_steps(alg, parts)
    assert tex.ALGORITHMS == jex.ALGORITHMS
    assert tex.FLAT_ALGORITHMS == jex.FLAT_ALGORITHMS


# ------------------------------------------------------- against JAX

def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dcn", "ici"))


@pytest.mark.parametrize("transport", ["hierarchical", "ring", "ragged"])
@pytest.mark.parametrize("shape", [(16, 16, 3), (16, 13, 3)])
def test_transport_matches_jax_shard_map(transport, shape):
    """The same seeded global array, sharded along axis 0 over the
    combined (dcn, ici) axis, through the JAX transport under shard_map
    and the port's on a loopback 2x4 hybrid world: the same bytes."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from distributedfft_tpu.parallel import exchange as jex

    axis = ("dcn", "ici")
    x = _blocks(1, shape, np.complex64, seed=21)[0]
    s = shape[1]
    if transport == "hierarchical":
        sp = -(-s // 8) * 8
        fn = lambda u: jex.hierarchical_all_to_all(
            jex._pad_axis(u, 1, sp), axis, split_axis=1, concat_axis=0,
            axis_sizes=(2, 4))
    elif transport == "ring":
        sp = -(-s // 8) * 8
        fn = lambda u: jex.ring_all_to_all(
            jex._pad_axis(u, 1, sp), axis, split_axis=1, concat_axis=0, p=8)
    else:
        fn = lambda u: jex.ragged_all_to_all_exchange(
            u, axis, split_axis=1, concat_axis=0, p=8, platform="cpu")
    mapped = shard_map(fn, mesh=_jax_mesh(), in_specs=(P(axis),),
                       out_specs=P(None, axis))
    want = np.asarray(jax.jit(mapped)(x))
    world = make_world((2, 4), HYBRID_AXES)
    alg = {"hierarchical": "hierarchical", "ring": "ppermute",
           "ragged": "alltoallv"}[transport]
    got = tex.exchange_uneven(list(torch.from_numpy(x).chunk(8, dim=0)),
                              world, split_axis=1, concat_axis=0,
                              mesh_axis=HYBRID_AXES, algorithm=alg,
                              axis_sizes=(2, 4))
    assert np.array_equal(torch.cat(got, dim=1).numpy(), want)


def _jax_plan(shape, dtype, algorithm, k, direction):
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft

    jdt = jnp.complex64 if dtype == np.complex64 else jnp.complex128
    mesh = (_jax_mesh() if algorithm == "hierarchical"
            else jdfft.make_mesh(4))
    return jdfft.plan_dft_c2c_3d(shape, mesh, dtype=jdt, algorithm=algorithm,
                                 overlap_chunks=k, direction=direction)


PLAN_WORLDS = {"hierarchical": lambda: make_world((2, 4), HYBRID_AXES)}


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("algorithm", tex.ALGORITHMS)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape", [(16, 16, 8), (12, 10, 9)])
def test_plan_matches_jax(shape, dtype, algorithm, k):
    """Forward against the JAX plan of the same transport and K (its xla
    executor) within the tier; bit for bit against the port's alltoall,
    K = 1 plan on the same world size; the backward of it back to the
    input within the tier."""
    world = PLAN_WORLDS.get(algorithm, lambda: make_world(4))()
    tdt = torch.complex64 if dtype == np.complex64 else torch.complex128
    x = testing.make_world_data(shape, dtype, seed=k)
    plan = tdfft.plan_dft_c2c_3d(shape, world, dtype=tdt, device="cpu",
                                 algorithm=algorithm, overlap_chunks=k)
    assert (plan.algorithm, plan.overlap_chunks) == (algorithm, k)
    got = plan(torch.from_numpy(x))
    jplan = _jax_plan(shape, dtype, algorithm, k, tdfft.FORWARD)
    assert testing.rel_error(got.numpy(), np.asarray(jplan(x))) < TOL[dtype]
    base = tdfft.plan_dft_c2c_3d(shape, make_world(world.size), dtype=tdt,
                                 device="cpu")
    assert torch.equal(got, base(torch.from_numpy(x)))
    back = tdfft.plan_dft_c2c_3d(shape, world, dtype=tdt, device="cpu",
                                 algorithm=algorithm, overlap_chunks=k,
                                 direction=tdfft.BACKWARD)(got)
    assert testing.rel_error(back.numpy(), x) < TOL[dtype]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("algorithm", tex.FLAT_ALGORITHMS)
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
@pytest.mark.parametrize("decomposition", ["slab", "pencil"])
def test_every_transport_and_k_is_the_dense_plan(decomposition, kind,
                                                  algorithm, k):
    """Slab and pencil, C2C and R2C/C2R, both directions, an uneven
    shape: every flat transport at every K equals the alltoall, K = 1
    plan bit for bit."""
    shape = (12, 10, 14)
    world = 4 if decomposition == "slab" else (2, 2)
    planner = (tdfft.plan_dft_c2c_3d if kind == "c2c"
               else tdfft.plan_dft_r2c_3d)
    for direction in (tdfft.FORWARD, tdfft.BACKWARD):
        ref = planner(shape, world, device="cpu", direction=direction)
        plan = planner(shape, world, device="cpu", direction=direction,
                       algorithm=algorithm, overlap_chunks=k)
        assert plan.decomposition == decomposition
        real_in = kind == "r2c" and direction == tdfft.FORWARD
        dt = np.float32 if real_in else np.complex64
        x = torch.from_numpy(testing.make_world_data(ref.in_shape, dt, 5))
        assert torch.equal(plan(x), ref(x))


def test_hierarchical_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="requires an explicit 2D hybrid"):
        tdfft.plan_dft_c2c_3d((8, 8, 8), 4, device="cpu",
                              algorithm="hierarchical")
    with pytest.raises(ValueError, match="not compatible"):
        tdfft.plan_dft_c2c_3d((8, 8, 8), (2, 2), device="cpu",
                              algorithm="hierarchical",
                              decomposition="pencil")
    with pytest.raises(ValueError, match="hierarchical transport supports"):
        tdfft.plan_dft_r2c_3d((8, 8, 8), (2, 2), device="cpu",
                              algorithm="hierarchical")
    from distributedfft_tpu_torch.parallel.pencil import build_pencil_fft3d

    with pytest.raises(ValueError, match="flat transports"):
        build_pencil_fft3d(make_world((2, 2)), (8, 8, 8),
                           algorithm="hierarchical")


def test_describe_and_reference_carry_transport_and_k():
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft

    shape = (16, 16, 8)
    jplan = jdfft.plan_dft_c2c_3d(shape, _jax_mesh(), dtype=jnp.complex64,
                                  algorithm="hierarchical", overlap_chunks=2)
    desc = dict(shape=shape, world_size=8, grid=(2, 4), direction=-1,
                dtype="complex64", executor="xla",
                algorithm=jplan.options.algorithm,
                overlap_chunks=jplan.options.overlap_chunks,
                in_boxes=[(b.low, b.high) for b in jplan.in_boxes],
                out_boxes=[(b.low, b.high) for b in jplan.out_boxes])
    plan = tdfft.plan_from_reference(desc, device="cpu")
    d = plan.describe()
    assert (d["algorithm"], d["overlap_chunks"], d["grid"]) == (
        "hierarchical", 2, (2, 4))
    assert plan.world.hybrid and plan.decomposition == "slab"
    info = tdfft.plan_info(plan)
    assert "algorithm: hierarchical" in info and "overlap: 2 chunks" in info


# --------------------------------------------------------- plan options

BAD_OPTIONS = [
    dict(algorithm="nope"), dict(wire_dtype="fp8"), dict(overlap_chunks=0),
    dict(overlap_chunks="x"), dict(overlap_chunks=True),
    dict(overlap_chunks=2.5), dict(tune="x"), dict(mm_precision="x"),
    dict(mm_complex="q"), dict(fuse="x"), dict(fuse=3),
    dict(renegotiate="x"), dict(decomposition="x"),
    dict(max_roundtrip_err=-1), dict(max_roundtrip_err=True),
]


@pytest.mark.parametrize("kw", BAD_OPTIONS, ids=lambda kw: repr(kw))
def test_plan_options_raise_the_jax_errors(kw):
    from distributedfft_tpu.plan_logic import PlanOptions as JaxOptions

    with pytest.raises(ValueError) as theirs:
        JaxOptions(**kw)
    with pytest.raises(ValueError) as mine:
        tpl.PlanOptions(**kw)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("kw", [
    dict(tune="wisdom"), dict(tune="measure"),
    dict(max_roundtrip_err=1e-3)])
def test_plan_options_refuse_what_is_not_ported(kw):
    """The measured-planning knobs, once refused, are taken as the JAX
    package's ``PlanOptions`` takes them: every field but the default
    executor (``xla`` there, ``cuda`` here) equal."""
    import dataclasses

    from distributedfft_tpu.plan_logic import PlanOptions as JaxOptions

    mine = dataclasses.asdict(tpl.PlanOptions(**kw))
    theirs = dataclasses.asdict(JaxOptions(**kw))
    assert mine.pop("executor") == "cuda" and theirs.pop("executor") == "xla"
    assert mine == theirs
    for k, v in kw.items():
        assert mine[k] == v


def test_plan_options_take_donate():
    """``donate`` is a plan knob (the input as workspace); a non-bool
    raises."""
    assert tpl.PlanOptions(donate=True).donate
    with pytest.raises(ValueError, match="donate"):
        tpl.PlanOptions(donate="yes")


def test_plan_options_normalise_as_jax():
    from distributedfft_tpu.plan_logic import PlanOptions as JaxOptions

    for kw in (dict(overlap_chunks="3"), dict(wire_dtype=" BF16 "),
               dict(mm_precision="high"), dict(fuse="on"), dict(fuse="off"),
               dict(wire_dtype="none"), dict(tune="off")):
        mine, theirs = tpl.PlanOptions(**kw), JaxOptions(**kw)
        for key in kw:
            assert getattr(mine, key) == getattr(theirs, key), kw
    assert tpl.default_options("slab").decomposition == "slab"


def test_overlap_knob_matches_jax(monkeypatch):
    from distributedfft_tpu import plan_logic as jpl

    cases = [((512, 512, 512), 4), ((512, 512, 512), 8), ((64, 64, 64), 4),
             ((256, 256, 256), 2), ((16, 16, 8), 8), ((8, 8, 8), 1)]
    for shape, ndev in cases:
        assert tpl.auto_overlap_chunks(shape, ndev) == \
            jpl.auto_overlap_chunks(shape, ndev)
        for v in (None, 1, 3, "2", "auto"):
            assert tpl.resolve_overlap_chunks(v, shape, ndev) == \
                jpl.resolve_overlap_chunks(v, shape, ndev)
    assert tpl.auto_overlap_chunks((512, 512, 512), 4) == 8
    monkeypatch.setenv("DFFT_OVERLAP", "auto")
    assert tpl.resolve_overlap_chunks(None, (512, 512, 512), 4) == 8
    plan = tdfft.plan_dft_c2c_3d((64, 64, 64), 4, device="cpu")
    assert plan.overlap_chunks == jpl.resolve_overlap_chunks(
        None, (64, 64, 64), 4)
    monkeypatch.setenv("DFFT_OVERLAP", "0")
    with pytest.raises(ValueError, match="must be >= 1"):
        tpl.resolve_overlap_chunks(None)
    monkeypatch.setenv("DFFT_OVERLAP", "two")
    with pytest.raises(ValueError, match="check DFFT_OVERLAP"):
        tpl.resolve_overlap_chunks(None)


def test_options_or_keywords_not_both():
    opts = tdfft.PlanOptions(algorithm="ppermute", overlap_chunks=2,
                             executor="cuda")
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 4, device="cpu", options=opts)
    assert (plan.algorithm, plan.overlap_chunks) == ("ppermute", 2)
    assert plan.options.overlap_chunks == 2
    with pytest.raises(ValueError, match="not both"):
        tdfft.plan_dft_c2c_3d((8, 8, 8), 4, device="cpu", options=opts,
                              algorithm="alltoallv")
    one = tdfft.plan_dft_c2c_3d((8, 8, 8), None, device="cpu", options=opts)
    assert one.decomposition == "single" and one.graph is None


@pytest.mark.parametrize("mode", ["auto", "force", "never"])
@pytest.mark.parametrize("shape,ndev", [((12, 10, 9), 8), ((16, 16, 8), 6),
                                        ((64, 64, 64), 8)])
def test_renegotiation_modes_match_jax(mode, shape, ndev):
    """``PlanOptions.renegotiate`` picks the device count of an int world
    as the JAX planner does."""
    from distributedfft_tpu import plan_logic as jpl

    jlp = jpl.logic_plan3d(shape, ndev, jpl.PlanOptions(renegotiate=mode))
    lp = tpl.logic_plan3d(shape, ndev, tpl.PlanOptions(renegotiate=mode))
    assert lp.decomposition == jlp.decomposition
    jsize = 1 if jlp.mesh is None else jlp.mesh.devices.size
    assert (1 if lp.world is None else lp.world.size) == jsize
    assert lp.negotiated == jlp.negotiated


def test_options_compose_the_matmul_tier():
    opts = tdfft.PlanOptions(executor="matmul", mm_precision="high",
                             mm_complex="gauss")
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 2, device="cpu", options=opts)
    assert plan.executor == "matmul:f32:gauss"
    with pytest.raises(ValueError, match="scope the matmul-family"):
        tdfft.plan_dft_c2c_3d((8, 8, 8), 2, device="cpu",
                              options=tdfft.PlanOptions(
                                  executor="torch", mm_precision="bf16"))


def test_fusion_records_overlap_k():
    """A fused plan at K > 1 keeps the unfused chain and says why, as the
    JAX fusion pass does."""
    plan = tdfft.plan_dft_c2c_3d((16, 16, 8), 4, device="cpu",
                                 wire_dtype="split", fuse=True,
                                 overlap_chunks=2)
    f = plan.describe()["fusion"]
    assert f == {"requested": True, "active": False,
                 "reasons": ("overlap_k",)}


# ----------------------------------------------- process-group worlds

PG_SHAPE = (12, 10, 14)


def _pg_cases():
    """(label, world key, algorithm, codec) of each transport case."""
    cases = [(f"1d4-{a}-{c}", "1d", a, c) for a in tex.FLAT_ALGORITHMS
             for c in CODECS]
    cases += [(f"hybrid-{a}-{c}", "hybrid", a, c) for a in tex.ALGORITHMS
              for c in CODECS]
    return cases


#: (label, planner, world key, algorithm, K) of each plan case.
PG_PLANS = [
    ("slab-alltoallv-3", "c2c", "1d", "alltoallv", 3),
    ("slab-ppermute-2", "c2c", "1d", "ppermute", 2),
    ("hier-1", "c2c", "hybrid", "hierarchical", 1),
    ("hier-2", "c2c", "hybrid", "hierarchical", 2),
    ("hier-3", "c2c", "hybrid", "hierarchical", 3),
    ("pencil-ppermute-2", "pencil", "hybrid", "ppermute", 2),
    ("pencil-alltoallv-1", "pencil", "hybrid", "alltoallv", 1),
    ("r2c-ppermute-2", "r2c", "1d", "ppermute", 2),
]


def _pg_blocks(size):
    return _blocks(size, (3, 2 * size - 1, 5), np.complex64, seed=31)


def _pg_plan(kind, world, algorithm, k, device):
    if kind == "pencil":
        return tdfft.plan_dft_c2c_3d(PG_SHAPE, world, device=device,
                                     decomposition="pencil",
                                     algorithm=algorithm, overlap_chunks=k)
    planner = (tdfft.plan_dft_r2c_3d if kind == "r2c"
               else tdfft.plan_dft_c2c_3d)
    return planner(PG_SHAPE, world, device=device, algorithm=algorithm,
                   overlap_chunks=k)


def _pg_input(plan):
    real = plan.in_dtype == torch.float32
    return testing.make_world_data(plan.in_shape, np.float32 if real
                                   else np.complex64, seed=7)


def _transport_rank(rank, size, backend, init, out_dir):
    """One rank: every transport and codec on a 1D world and on a 2x2
    hybrid world over the same processes, overlapped exchanges, and the
    plans of PG_PLANS; each result saved for the parent."""
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size)
    try:
        worlds = {"1d": process_group_world(),
                  "hybrid": process_group_world(grid=(2, 2),
                                                axis_names=HYBRID_AXES)}
        mine = torch.from_numpy(_pg_blocks(size)[rank]).to(device)
        out = {}
        for label, wk, alg, codec in _pg_cases():
            w = worlds[wk]
            (y,) = tex.exchange_uneven(
                [mine], w, split_axis=1, concat_axis=0,
                mesh_axis=w.combined_axis, algorithm=alg,
                axis_sizes=w.grid, wire_dtype=codec)
            out[label] = y.cpu().numpy()
        for alg in tex.ALGORITHMS:
            w = worlds["hybrid"]
            (y,) = tex.exchange_overlapped(
                [mine], w, split_axis=1, concat_axis=0, overlap_chunks=2,
                compute=lambda bs: [b * 2 for b in bs], algorithm=alg,
                mesh_axis=w.combined_axis, axis_sizes=w.grid)
            out[f"overlap-{alg}"] = y.cpu().numpy()
        for label, kind, wk, alg, k in PG_PLANS:
            plan = _pg_plan(kind, worlds[wk], alg, k, device)
            base = _pg_plan(kind, worlds["1d" if kind != "pencil" else wk],
                            "alltoall", 1, device)
            x = torch.from_numpy(
                _pg_input(plan)[plan.in_boxes[rank].slices()].copy())
            for tag, p in (("plan", plan), ("base", base)):
                out[f"{tag}-{label}"] = p(x.to(device)).cpu().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp, backend):
    init = f"file://{tmp / 'store'}"
    mp.start_processes(_transport_rank, args=(4, backend, init, str(tmp)),
                       nprocs=4, join=True, start_method="spawn")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gloo"), "gloo")


def _loopback_transport(wk, alg, codec):
    world = make_world(4) if wk == "1d" else make_world((2, 2), HYBRID_AXES)
    return tex.exchange_uneven(
        _torch(_pg_blocks(4)), world, split_axis=1, concat_axis=0,
        mesh_axis=world.combined_axis, algorithm=alg, axis_sizes=world.grid,
        wire_dtype=codec)


@pytest.mark.parametrize("label,wk,alg,codec", _pg_cases(),
                         ids=[c[0] for c in _pg_cases()])
def test_process_group_transport_matches_loopback(gloo_results, label, wk,
                                                  alg, codec):
    want = _loopback_transport(wk, alg, codec)
    for rank in range(4):
        assert gloo_results[rank][label].tobytes() == \
            want[rank].numpy().tobytes()


@pytest.mark.parametrize("alg", tex.ALGORITHMS)
def test_process_group_overlap_matches_loopback(gloo_results, alg):
    world = make_world((2, 2), HYBRID_AXES)
    want = tex.exchange_overlapped(
        _torch(_pg_blocks(4)), world, split_axis=1, concat_axis=0,
        overlap_chunks=2, compute=lambda bs: [b * 2 for b in bs],
        algorithm=alg, mesh_axis=HYBRID_AXES, axis_sizes=(2, 2))
    for rank in range(4):
        assert np.array_equal(gloo_results[rank][f"overlap-{alg}"],
                              want[rank].numpy())


def _loopback_plan(kind, wk, alg, k):
    grid = (2, 2) if wk == "hybrid" else 4
    world = make_world(grid, HYBRID_AXES) if wk == "hybrid" else grid
    return _pg_plan(kind, world, alg, k, "cpu")


@pytest.mark.parametrize("label,kind,wk,alg,k", PG_PLANS,
                         ids=[c[0] for c in PG_PLANS])
def test_process_group_plan_matches_loopback(gloo_results, label, kind, wk,
                                             alg, k):
    plan = _loopback_plan(kind, wk, alg, k)
    want = plan(torch.from_numpy(_pg_input(plan))).numpy()
    for rank, box in enumerate(plan.out_boxes):
        got = gloo_results[rank][f"plan-{label}"]
        assert got.shape == box.shape
        assert np.array_equal(got, want[box.slices()])
        assert np.array_equal(got, gloo_results[rank][f"base-{label}"])


@pytest.mark.cuda
def test_transports_over_nccl(tmp_path):
    """The same ranks over NCCL on four cards: the transports move bytes,
    so each equals its loopback twin on the CPU bit for bit (the codecs
    encode on the card); each plan equals the card's own alltoall, K = 1
    plan of the same world bit for bit and the CPU loopback plan within
    the complex64 tier. On the cards: ``python -m pytest --noconftest -m
    cuda tests/test_torch_transports.py``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    got = _spawn(tmp_path, "nccl")
    for label, wk, alg, codec in _pg_cases():
        want = _loopback_transport(wk, alg, codec)
        for rank in range(4):
            assert got[rank][label].tobytes() == \
                want[rank].numpy().tobytes(), label
    for label, kind, wk, alg, k in PG_PLANS:
        plan = _loopback_plan(kind, wk, alg, k)
        want = plan(torch.from_numpy(_pg_input(plan))).numpy()
        for rank, box in enumerate(plan.out_boxes):
            mine = got[rank][f"plan-{label}"]
            assert np.array_equal(mine, got[rank][f"base-{label}"]), label
            assert testing.rel_error(mine, want[box.slices()]) < 5e-4, label
