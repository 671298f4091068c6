"""The port's dd plans (``DDPlan3D``, the ``plan_dd_*`` planners,
``parallel/ddslab.py``) against the JAX package's and numpy float64.

The twin of ``tests/test_ddfft.py``'s plan and pipeline cases and of the
dd batch cases of ``tests/test_a2h_operators.py``: the same seeded
inputs through the JAX dd plans on the 8-device CPU mesh
(``tests/conftest.py``) and through the port's on a loopback world of the
same shape (``device="cpu"``). Pairs are compared by value.

- C2C plans in both directions on one device, slab P = 2, uneven slab
  P = 3 and an uneven 2x2 pencil; r2c / c2r on one device, a slab and an
  uneven pencil; ``r2c_axis`` 0 and 1: within 1e-13 of numpy float64,
  within 1e-11 of the JAX plan, round trips within 1e-11.
- ``batch=2`` equals the per-item calls bit for bit (c2c, r2c, c2r on
  each decomposition); ``batch=1`` is the unbatched plan.
- ``Scale``, ``donate``, ``plan_info``, the staged pipelines (stage names
  equal to JAX's), the refusals, and ``cuda_fft.FALLBACKS`` untouched.
- Brick plans with storage orders (c2c against JAX's, r2c / c2r round
  trip, one device), and a 2-rank gloo group (slab c2c and r2c, a brick
  plan) against the loopback plans box by box, bit for bit.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch.geometry import (ceil_splits, make_pencils,
                                               make_slabs, world_box)
from distributedfft_tpu_torch.ops import cuda_fft, ddfft as tdd
from distributedfft_tpu_torch.parallel import ddslab
from distributedfft_tpu_torch.parallel.bricks import (gather_bricks,
                                                      scatter_bricks)
from distributedfft_tpu_torch.utils.timing import time_staged

F64 = 1e-13
TIER = 1e-11
B = 2


@pytest.fixture(autouse=True)
def fresh_plans():
    """Plans built by this file's calls, not another file's on the same
    worker."""
    tdfft.clear_plan_cache()
    yield
    tdfft.clear_plan_cache()


def _jax():
    import distributedfft_tpu as jdfft

    return jdfft


def _jmesh(key):
    return None if key is None else _jax().make_mesh(key)


def _c128(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _pair(x):
    return tdd.dd_from_host(x, device="cpu")


def _jrun(plan, x):
    jd = _jax()
    return jd.dd_to_host(*plan(*jd.dd_from_host(x)))


def _run(plan, x):
    return tdd.dd_to_host(*plan(*_pair(x)))


# (world key, shape, decomposition)
C2C_WORLDS = [
    (None, (8, 8, 8), "single"),
    (2, (16, 8, 8), "slab"),
    (3, (12, 10, 6), "slab"),
    ((2, 2), (16, 24, 20), "pencil"),
]


@pytest.mark.parametrize("direction", [tdfft.FORWARD, tdfft.BACKWARD])
@pytest.mark.parametrize("key,shape,decomp", C2C_WORLDS,
                         ids=["single", "slab2", "slab3_uneven",
                              "pencil2x2_uneven"])
def test_c2c_plans(key, shape, decomp, direction):
    x = _c128(shape, seed=23)
    plan = tdfft.plan_dd_dft_c2c_3d(shape, key, direction=direction,
                                    device="cpu")
    assert isinstance(plan, tdfft.DDPlan3D)
    assert plan.decomposition == decomp
    assert plan.graph is None or plan.graph.executor == tdd.PLAN_EXECUTOR
    assert plan.forward == (direction == tdfft.FORWARD)
    got = _run(plan, x)
    want = np.fft.fftn(x) if plan.forward else np.fft.ifftn(x)
    assert _rel(got, want) < F64
    jplan = _jax().plan_dd_dft_c2c_3d(shape, _jmesh(key),
                                      direction=direction)
    assert jplan.decomposition == decomp
    assert _rel(got, _jrun(jplan, x)) < TIER


@pytest.mark.parametrize("key,shape,decomp", C2C_WORLDS,
                         ids=["single", "slab2", "slab3_uneven",
                              "pencil2x2_uneven"])
def test_c2c_roundtrip(key, shape, decomp):
    x = _c128(shape, seed=29)
    fwd = tdfft.plan_dd_dft_c2c_3d(shape, key, device="cpu")
    bwd = tdfft.plan_dd_dft_c2c_3d(shape, key, direction=tdfft.BACKWARD,
                                   device="cpu")
    back = tdd.dd_to_host(*bwd(*fwd(*_pair(x))))
    assert _rel(back, x) < TIER
    assert fwd.in_boxes and len(fwd.in_boxes) == (
        1 if key is None else int(np.prod(key)))


R2C_WORLDS = [
    (None, (8, 6, 10), "single"),
    (2, (12, 10, 16), "slab"),
    ((2, 2), (8, 12, 16), "pencil"),
]


@pytest.mark.parametrize("key,shape,decomp", R2C_WORLDS,
                         ids=["single", "slab2", "pencil2x2_uneven"])
def test_r2c_c2r_plans(key, shape, decomp):
    x = _real(shape, seed=61)
    fwd = tdfft.plan_dd_dft_r2c_3d(shape, key, device="cpu")
    bwd = tdfft.plan_dd_dft_c2r_3d(shape, key, device="cpu")
    assert fwd.decomposition == decomp and fwd.kind == "r2c"
    assert fwd.in_dtype == torch.float32 and bwd.out_dtype == torch.float32
    hi, lo = _pair(x)
    yh, yl = fwd(hi, lo)
    want = np.fft.rfftn(x)
    assert tuple(yh.shape) == want.shape == fwd.out_shape
    assert tdd.max_err_vs_f64(yh, yl, want) < F64
    jf = _jax().plan_dd_dft_r2c_3d(shape, _jmesh(key))
    assert _rel(tdd.dd_to_host(yh, yl), _jrun(jf, x)) < TIER
    bh, bl = bwd(yh, yl)
    assert bh.dtype == torch.float32
    assert _rel(tdd.dd_to_host(bh, bl), x) < TIER
    # c2r of a hermitian half spectrum against numpy and JAX
    got = _run(bwd, want)
    assert _rel(got, np.fft.irfftn(want, s=shape, axes=(0, 1, 2))) < F64
    jb = _jax().plan_dd_dft_c2r_3d(shape, _jmesh(key))
    assert _rel(got, _jrun(jb, want)) < TIER


@pytest.mark.parametrize("axis,key", [(1, None), (0, 2)])
def test_r2c_axis(axis, key):
    shape = (8, 8, 8)
    x = _real(shape, seed=97)
    pf = tdfft.plan_dd_dft_r2c_3d(shape, key, r2c_axis=axis, device="cpu")
    pb = tdfft.plan_dd_dft_c2r_3d(shape, key, r2c_axis=axis, device="cpu")
    assert pf.r2c_axis == axis and pf.shape == shape
    got = _run(pf, x)
    want = np.take(np.fft.fftn(x), np.arange(5), axis=axis)
    assert got.shape == want.shape == pf.out_shape
    assert _rel(got, want) < F64
    jf = _jax().plan_dd_dft_r2c_3d(shape, _jmesh(key), r2c_axis=axis)
    assert _rel(got, _jrun(jf, x)) < TIER
    hi, lo = _pair(x)
    assert _rel(tdd.dd_to_host(*pb(*pf(hi, lo))), x) < TIER


def test_r2c_refusals():
    shape = (8, 8, 8)
    with pytest.raises(ValueError, match="r2c_axis"):
        tdfft.plan_dd_dft_r2c_3d(shape, None, r2c_axis=5, device="cpu")
    with pytest.raises(ValueError, match="canonical r2c_axis=2"):
        tdfft.plan_dd_dft_r2c_3d(shape, None, r2c_axis=0, batch=B,
                                 device="cpu")
    with pytest.raises(ValueError, match="canonical r2c_axis=2"):
        _jax().plan_dd_dft_r2c_3d(shape, None, r2c_axis=0, batch=B)


BATCH_WORLDS = [None, 2, (2, 2)]


@pytest.mark.parametrize("kind", ["c2c", "r2c", "c2r"])
@pytest.mark.parametrize("key", BATCH_WORLDS, ids=["single", "slab2",
                                                   "pencil2x2"])
def test_batch_equals_per_item_bitwise(key, kind):
    shape = (16, 16, 16)
    if kind == "c2c":
        planner, x = tdfft.plan_dd_dft_c2c_3d, _c128((B,) + shape, seed=3)
    elif kind == "r2c":
        planner, x = tdfft.plan_dd_dft_r2c_3d, _real((B,) + shape, seed=3)
    else:
        planner = tdfft.plan_dd_dft_c2r_3d
        x = np.fft.rfftn(_real((B,) + shape, seed=3), axes=(1, 2, 3))
    pb = planner(shape, key, batch=B, device="cpu")
    p1 = planner(shape, key, device="cpu")
    assert pb.batch == B and p1.batch is None
    hi, lo = _pair(x)
    bh, bl = pb(hi, lo)
    assert tuple(bh.shape) == pb.out_shape
    for i in range(B):
        sh, sl = p1(hi[i].contiguous(), lo[i].contiguous())
        assert torch.equal(bh[i], sh) and torch.equal(bl[i], sl)


@pytest.mark.parametrize("key", BATCH_WORLDS, ids=["single", "slab2",
                                                   "pencil2x2"])
def test_batch_one_is_the_unbatched_plan(key):
    shape = (16, 16, 16)
    base = tdfft.plan_dd_dft_r2c_3d(shape, key, device="cpu")
    b1 = tdfft.plan_dd_dft_r2c_3d(shape, key, batch=1, device="cpu")
    assert b1.batch is None and b1.in_shape == base.in_shape
    hi, lo = _pair(_real(shape, seed=4))
    for got, want in zip(b1(hi, lo), base(hi, lo)):
        assert torch.equal(got, want)


def test_batch_against_jax():
    shape = (16, 16, 16)
    x = _real((B,) + shape, seed=5)
    got = _run(tdfft.plan_dd_dft_r2c_3d(shape, 2, batch=B, device="cpu"), x)
    jp = _jax().plan_dd_dft_r2c_3d(shape, _jmesh(2), batch=B)
    assert _rel(got, _jrun(jp, x)) < TIER
    assert _rel(got, np.fft.rfftn(x, axes=(1, 2, 3))) < F64


@pytest.mark.parametrize("key", [None, 2])
def test_scale(key):
    shape = (8, 8, 8)
    n = 512
    x = _c128(shape, seed=107)
    p = tdfft.plan_dd_dft_c2c_3d(shape, key, device="cpu")
    want = np.fft.fftn(x)
    hi, lo = _pair(x)
    got = tdd.dd_to_host(*p(hi, lo, scale=tdfft.Scale.FULL))
    assert _rel(got, want / n) < F64
    got = tdd.dd_to_host(*p(hi, lo, scale=tdfft.Scale.SYMMETRIC))
    assert _rel(got, want / np.sqrt(n)) < F64


@pytest.mark.parametrize("key", [None, 2, (2, 2)])
def test_donate(key):
    shape = (8, 8, 8)
    x = _c128(shape, seed=109)
    keep = tdfft.plan_dd_dft_c2c_3d(shape, key, device="cpu")
    give = tdfft.plan_dd_dft_c2c_3d(shape, key, donate=True, device="cpu")
    assert give is not keep and give.donate
    wh, wl = keep(*_pair(x))
    hi, lo = _pair(x)
    yh, yl = give(hi, lo)
    assert torch.equal(yh, wh) and torch.equal(yl, wl)
    assert yh.data_ptr() == hi.data_ptr() and yl.data_ptr() == lo.data_ptr()
    assert tdd.max_err_vs_f64(yh, yl, np.fft.fftn(x)) < F64
    r2c = tdfft.plan_dd_dft_r2c_3d(shape, key, donate=True, device="cpu")
    assert not r2c.donate              # accepted, no effect


def test_plan_info():
    p = tdfft.plan_dd_dft_c2c_3d((16, 16, 16), 8, device="cpu")
    info = tdfft.plan_info(p)
    assert "dd tier" in info and "decomposition: slab" in info
    assert "complex128" in info and "torch" in info
    assert "8 ranks" in info
    jinfo = _jax().plan_info(_jax().plan_dd_dft_c2c_3d((16, 16, 16),
                                                       _jmesh(8)))
    assert "dd tier" in jinfo and "decomposition: slab" in jinfo


def test_refusals_are_the_jax_refusals():
    shape = (8, 8, 8)
    with pytest.raises(ValueError, match="single-device, 1D, or 2D"):
        tdfft.plan_dd_dft_c2c_3d(shape, (2, 2, 2), device="cpu")
    import jax
    from jax.sharding import Mesh

    cube = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("a", "b", "c"))
    with pytest.raises(ValueError, match="single-device, 1D, or 2D"):
        _jax().plan_dd_dft_c2c_3d(shape, cube)
    with pytest.raises(ValueError, match="dd pipeline"):
        tdfft.plan_dd_dft_c2c_3d((8, 8, 131101), 2, device="cpu")
    with pytest.raises(ValueError, match="out of dd scope"):
        tdfft.plan_dd_dft_c2c_3d((8, 8, 131101), None, device="cpu")
    p = tdfft.plan_dd_dft_c2c_3d(shape, 2, device="cpu")
    hi, lo = _pair(_c128(shape))
    with pytest.raises(ValueError, match="plan takes"):
        p(hi.to(torch.complex128), lo.to(torch.complex128))
    with pytest.raises(ValueError, match="plan input shape"):
        p(hi[:4], lo[:4])


def test_prime_extent_accepted_on_a_slab():
    fwd, spec = ddslab.build_dd_slab_fft3d(tdfft.make_world(2), (8, 8, 521))
    assert spec.in_axis == 0
    x = _c128((8, 8, 521), seed=7)
    assert tdd.max_err_vs_f64(*fwd(*_pair(x)), np.fft.fftn(x)) < F64


def test_dd_plans_take_no_fallback_and_are_cached():
    before = dict(cuda_fft.FALLBACKS)
    shape = (8, 8, 8)
    for key in (None, 2, (2, 2)):
        p = tdfft.plan_dd_dft_c2c_3d(shape, key, device="cpu")
        assert tdfft.plan_dd_dft_c2c_3d(shape, key, device="cpu") is p
        p(*_pair(_c128(shape)))
        r = tdfft.plan_dd_dft_r2c_3d(shape, key, device="cpu")
        r(*_pair(_real(shape)))
    assert dict(cuda_fft.FALLBACKS) == before


# ---------------------------------------------------------- staged

@pytest.mark.parametrize("shape", [(16, 16, 16), (10, 9, 7)])
def test_staged_pipelines(shape):
    from distributedfft_tpu.parallel import ddslab as jddslab

    x = _c128(shape, seed=41)
    want = np.fft.fftn(x)
    cases = [
        (ddslab.build_dd_single_stages(shape),
         jddslab.build_dd_single_stages(shape)),
        (ddslab.build_dd_slab_stages(tdfft.make_world(4), shape)[0],
         jddslab.build_dd_slab_stages(_jmesh(4), shape)[0]),
        (ddslab.build_dd_pencil_stages(tdfft.make_world((2, 2)), shape)[0],
         jddslab.build_dd_pencil_stages(_jmesh((2, 2)), shape)[0]),
    ]
    for stages, jstages in cases:
        assert [n for n, _ in stages] == [n for n, _ in jstages]
        pair = _pair(x)
        for _, fn in stages:
            pair = fn(pair)
        assert tdd.max_err_vs_f64(*pair, want) < F64
        st, out = time_staged(stages, _pair(x), iters=1)
        assert set(st.times) == {n for n, _ in stages}
        assert torch.equal(out[0], pair[0]) and torch.equal(out[1], pair[1])


def test_single_stages_backward_and_batched():
    shape = (8, 6, 10)
    x = _c128((B,) + shape, seed=43)
    pair = _pair(x)
    for _, fn in ddslab.build_dd_single_stages(shape, forward=False,
                                               batch=B):
        pair = fn(pair)
    assert tdd.max_err_vs_f64(*pair, np.fft.ifftn(x, axes=(1, 2, 3))) < F64


# ----------------------------------------------------------- bricks

def _brick_boxes_c2c(shape):
    w = world_box(shape)
    ins = [b.with_order(o) for b, o in zip(
        make_pencils(w, (4, 2), 2),
        [(0, 1, 2), (2, 1, 0), (1, 0, 2), (2, 0, 1),
         (0, 2, 1), (1, 2, 0), (0, 1, 2), (2, 1, 0)])]
    outs = [b.with_order((1, 2, 0)) for b in
            make_slabs(w, 8, axis=1, rule=ceil_splits)]
    return ins, outs


def _stack_pair(x, boxes):
    hi, lo = _pair(x)
    return scatter_bricks(hi, boxes), scatter_bricks(lo, boxes)


def _gathered(pair, boxes):
    return (gather_bricks(pair[0], boxes).numpy().astype(np.complex128)
            + gather_bricks(pair[1], boxes).numpy())


def test_brick_c2c_with_orders():
    shape = (16, 12, 8)
    ins, outs = _brick_boxes_c2c(shape)
    x = _c128(shape, seed=211)
    fwd = tdfft.plan_dd_brick_dft_c2c_3d(shape, 8, ins, outs, device="cpu")
    bwd = tdfft.plan_dd_brick_dft_c2c_3d(shape, 8, outs, ins,
                                         direction=tdfft.BACKWARD,
                                         device="cpu")
    assert fwd.decomposition == "bricks-slab"
    y = fwd(*_stack_pair(x, ins))
    got = _gathered(y, outs)
    ref = np.fft.fftn(x)
    assert _rel(got, ref) < F64
    back = _gathered(bwd(*y), ins)
    assert _rel(back, x) < TIER
    v = tdfft.plan_dd_brick_dft_c2c_3d(
        shape, 8, ins, outs, algorithm="alltoallv", device="cpu")
    yv = v(*_stack_pair(x, ins))
    assert torch.equal(yv[0], y[0]) and torch.equal(yv[1], y[1])
    # against the JAX brick plan on the 8-device mesh
    jd = _jax()
    from distributedfft_tpu.geometry import Box3 as JBox3
    from distributedfft_tpu.parallel.bricks import (
        gather_bricks as jgather, scatter_bricks as jscatter)

    jins = [JBox3(b.low, b.high, b.order) for b in ins]
    jouts = [JBox3(b.low, b.high, b.order) for b in outs]
    mesh = _jmesh(8)
    jp = jd.plan_dd_brick_dft_c2c_3d(shape, mesh, jins, jouts)
    jh, jl = jd.dd_from_host(x)
    yh, yl = jp(jscatter(np.asarray(jh), jins, mesh=mesh),
                jscatter(np.asarray(jl), jins, mesh=mesh))
    jgot = (jgather(yh, jouts).astype(np.complex128) + jgather(yl, jouts))
    assert _rel(got, jgot) < TIER


def test_brick_r2c_c2r_roundtrip():
    shape, half = (8, 12, 16), (8, 12, 9)
    ins = make_slabs(world_box(shape), 8, axis=1, rule=ceil_splits)
    outs = [b.with_order((2, 1, 0)) for b in
            make_slabs(world_box(half), 8, axis=0, rule=ceil_splits)]
    x = _real(shape, seed=223)
    fwd = tdfft.plan_dd_brick_dft_r2c_3d(shape, 8, ins, outs, device="cpu")
    bwd = tdfft.plan_dd_brick_dft_c2r_3d(shape, 8, outs, ins, device="cpu")
    y = fwd(*_stack_pair(x, ins))
    assert y[0].dtype == torch.complex64
    assert _rel(_gathered(y, outs), np.fft.rfftn(x)) < F64
    b = bwd(*y)
    assert b[0].dtype == torch.float32
    back = (gather_bricks(b[0], ins).numpy().astype(np.float64)
            + gather_bricks(b[1], ins).numpy())
    assert _rel(back, x) < TIER


def test_single_device_brick_with_order():
    shape = (8, 6, 4)
    box_in = world_box(shape).with_order((2, 0, 1))
    box_out = world_box(shape).with_order((1, 2, 0))
    x = _c128(shape, seed=227)
    p = tdfft.plan_dd_brick_dft_c2c_3d(shape, None, [box_in], [box_out],
                                       device="cpu")
    assert p.decomposition == "bricks-single"
    y = p(*_stack_pair(x, [box_in]))
    assert _rel(_gathered(y, [box_out]), np.fft.fftn(x)) < F64
    with pytest.raises(ValueError, match="exactly one box"):
        tdfft.plan_dd_brick_dft_c2c_3d(shape, None, [box_in, box_in],
                                       [box_out], device="cpu")


# --------------------------------------------------- process groups

def _dd_rank(rank, size, init, shape, x, xr, out_dir):
    """One gloo rank: a slab c2c and r2c dd plan and a brick plan on its
    own boxes."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        for tag, planner, data in (
                ("c", tdfft.plan_dd_dft_c2c_3d, x),
                ("r", tdfft.plan_dd_dft_r2c_3d, xr)):
            plan = planner(shape, world, device="cpu")
            hi, lo = tdd.dd_from_host(data[plan.in_boxes[rank].slices()],
                                      device="cpu")
            yh, yl = plan(hi, lo)
            np.save(os.path.join(out_dir, f"{tag}{rank}.npy"),
                    tdd.dd_to_host(yh, yl))
        w = world_box(shape)
        ins = make_slabs(w, size, axis=2, rule=ceil_splits)
        outs = [b.with_order((2, 0, 1)) for b in
                make_slabs(w, size, axis=0, rule=ceil_splits)]
        bp = tdfft.plan_dd_brick_dft_c2c_3d(shape, world, ins, outs,
                                            device="cpu")
        hi, lo = tdd.dd_from_host(x[ins[rank].slices()], device="cpu")
        yh, yl = bp(hi, lo)
        np.save(os.path.join(out_dir, f"b{rank}.npy"), tdd.dd_to_host(yh, yl))
    finally:
        dist.destroy_process_group()


def test_process_group_dd_plans(tmp_path):
    """Two gloo ranks: each rank's output box of the slab c2c, the slab
    r2c and a brick plan equals its loopback twin's, bit for bit."""
    shape = (8, 6, 10)
    x = _c128(shape, seed=31)
    xr = _real(shape, seed=37)
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_dd_rank, args=(2, init, shape, x, xr,
                                       str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    for tag, planner, data in (("c", tdfft.plan_dd_dft_c2c_3d, x),
                               ("r", tdfft.plan_dd_dft_r2c_3d, xr)):
        loop = planner(shape, 2, device="cpu")
        want = _run(loop, data)
        for rank, b in enumerate(loop.out_boxes):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{tag}{rank}.npy"), want[b.slices()])
    w = world_box(shape)
    ins = make_slabs(w, 2, axis=2, rule=ceil_splits)
    outs = [b.with_order((2, 0, 1)) for b in
            make_slabs(w, 2, axis=0, rule=ceil_splits)]
    loop = tdfft.plan_dd_brick_dft_c2c_3d(shape, 2, ins, outs, device="cpu")
    y = loop(*_stack_pair(x, ins))
    for rank, b in enumerate(outs):
        got = np.load(tmp_path / f"b{rank}.npy")
        want = (y[0][rank].numpy().astype(np.complex128)
                + y[1][rank].numpy())[tuple(slice(0, s)
                                            for s in b.storage_shape)]
        np.testing.assert_array_equal(got, want)
