"""The port's user layouts (``in_spec`` / ``out_spec``), ``r2c_axis`` and
``donate`` against the JAX package's.

The cases mirror ``tests/test_brick_io.py``, ``tests/test_plan_min_reshape.py``
and ``tests/test_r2c.py``: the layout classifier and the chain's
absorption of slab and pencil layouts (the ``LogicPlan``'s slab axes,
pencil permutation and order, absorbed flags, and the boxes, all equal to
JAX's), the edge-reshaped layouts the chain cannot absorb (even ones only,
as in JAX), the plans' outputs, the refusals (same error class), the
halved axis 0 and 1 on the single device, slab and pencil, and a donated
input. The JAX side plans on the virtual 8-device CPU mesh
(``tests/conftest.py``) on its ``pallas`` executor; the port on loopback
worlds on the CPU, where a layout is invisible in the global array it
takes and returns, so its edges are held by their boxes and, on a
process group (two gloo ranks), by each rank's own box. Port against JAX
within 1e-5 relative (complex64) and 1e-12 (complex128); each against
numpy within its tier (5e-4, 1e-11).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import distributedfft_tpu as jdfft
from distributedfft_tpu import plan_logic as jlogic
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import geometry as tgeo
from distributedfft_tpu_torch import plan_logic as tlogic
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel.mesh import spec_boxes
from distributedfft_tpu_torch.utils.trace import capture_events, plan_info

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the virtual 8-device mesh")

SHAPE = (16, 16, 16)
SAME = {np.complex64: 1e-5, np.complex128: 1e-12}
TIER = {np.complex64: testing.tolerance(np.complex64),
        np.complex128: testing.tolerance(np.complex128)}
TORCH_DT = {np.complex64: torch.complex64, np.complex128: torch.complex128}


def _spec(p):
    return None if p is None else tdfft.Spec(*tuple(p))


def _data(shape=SHAPE, seed=31, dt=np.complex128, real=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x.astype(np.float64 if dt == np.complex128 else np.float32) \
        if real else (x + 1j * rng.standard_normal(shape)).astype(dt)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _box(b):
    return (tuple(b.low), tuple(b.high))


def _pair(kind, shape, grid, in_spec=None, out_spec=None, dt=np.complex128,
          **kw):
    """(JAX plan, port plan) of one kind, layouts and direction."""
    jplanner = jdfft.plan_dft_c2c_3d if kind == "c2c" else \
        jdfft.plan_dft_r2c_3d
    tplanner = tdfft.plan_dft_c2c_3d if kind == "c2c" else \
        tdfft.plan_dft_r2c_3d
    mesh = None if grid is None else jdfft.make_mesh(grid)
    jp = jplanner(shape, mesh, in_spec=in_spec, out_spec=out_spec,
                  executor="pallas", dtype=dt, **kw)
    tp = tplanner(shape, grid, in_spec=_spec(in_spec),
                  out_spec=_spec(out_spec), dtype=TORCH_DT[dt],
                  device="cpu", **kw)
    return jp, tp


def _run_both(jp, tp, x, dt):
    jy = np.asarray(jp(jnp.asarray(x)))
    ty = tp(torch.from_numpy(x)).numpy()
    assert ty.shape == jy.shape == tuple(tp.out_shape)
    assert _rel(ty, jy) <= SAME[dt]
    return ty


def _same_geometry(jp, tp):
    assert [_box(b) for b in tp.in_boxes] == [_box(b) for b in jp.in_boxes]
    assert [_box(b) for b in tp.out_boxes] == [_box(b)
                                               for b in jp.out_boxes]
    jl, tl = jp.logic, tp.logic
    assert (tl.decomposition, tl.slab_axes, tl.pencil_perm,
            tl.pencil_order, tl.in_absorbed, tl.out_absorbed) == (
        jl.decomposition, jl.slab_axes, jl.pencil_perm, jl.pencil_order,
        jl.in_absorbed, jl.out_absorbed)


# ------------------------------------------------------- classification

@pytest.mark.parametrize("grid,spec", [
    (8, P("slab")), (8, P(None, "slab", None)), (8, P(None, None, "slab")),
    (8, P(None, None, None)), ((2, 4), P("row", "col")),
    ((2, 4), P(None, "col", "row")), ((2, 4), P(("row", "col"),)),
    ((2, 4), P("row", None, None)), ((2, 4), P(None, "row", "col"))])
def test_classify_layout_and_spec_boxes(grid, spec):
    mesh = jdfft.make_mesh(grid)
    world = tdfft.make_world(grid)
    assert tlogic.classify_layout(world, _spec(spec)) == \
        jlogic.classify_layout(mesh, spec)
    for shape in (SHAPE, (8, 16, 24)):
        from distributedfft_tpu.parallel.bricks import spec_boxes as jsb
        from distributedfft_tpu import geometry as jgeo

        want = jsb(mesh, spec, jgeo.world_box(shape))
        got = spec_boxes(world, _spec(spec), tgeo.world_box(shape))
        assert [_box(b) for b in got] == [_box(b) for b in want]


# ------------------------------------------------- absorption, in the chain

@pytest.mark.parametrize("grid,in_spec,out_spec,direction", [
    (8, P(None, "slab", None), None, -1),
    (8, None, P(None, None, "slab"), -1),
    (8, P(None, None, "slab"), P(None, None, "slab"), -1),
    (8, P(None, "slab", None), P("slab", None, None), 1),
    ((2, 4), P(None, "row", "col"), None, -1),
    ((2, 4), None, P("col", None, "row"), -1),
    ((2, 4), P("row", "col", None), P("col", "row", None), -1),
    ((2, 4), P("row", None, "col"), P("col", "row", None), 1),
])
def test_absorbed_and_wrapped_layouts_match_jax(grid, in_spec, out_spec,
                                                direction):
    """The LogicPlan (axes, order, absorbed flags) and boxes equal JAX's;
    the output matches JAX's and numpy's, forward or backward."""
    jp, tp = _pair("c2c", SHAPE, grid, in_spec, out_spec,
                   direction=direction)
    _same_geometry(jp, tp)
    x = _data()
    y = _run_both(jp, tp, x, np.complex128)
    want = np.fft.fftn(x) if direction == -1 else np.fft.ifftn(x)
    assert _rel(y, want) <= TIER[np.complex128]


def test_uneven_absorbed_layout_and_renegotiation():
    """An uneven world absorbs a slab layout with ceil boxes; an int
    world's renegotiation is judged on the absorbed axes, as in JAX."""
    shape = (13, 16, 12)
    jp, tp = _pair("c2c", shape, 8, P(None, None, "slab"), None,
                   dt=np.complex64)
    _same_geometry(jp, tp)
    x = _data(shape, dt=np.complex64)
    assert _rel(_run_both(jp, tp, x, np.complex64), np.fft.fftn(x)) \
        <= TIER[np.complex64]
    for spec in (P(None, "slab", None), P(None, None, "slab")):
        jl = jlogic.logic_plan3d((12, 16, 16), 8, in_spec=spec)
        tl = tlogic.logic_plan3d((12, 16, 16), 8, in_spec=_spec(spec))
        assert tl.negotiated == jl.negotiated
        assert tl.world.size == jl.mesh.size and tl.slab_axes == jl.slab_axes


def test_layout_boxes_follow_device_order_and_cover():
    _, tp = _pair("c2c", SHAPE, (2, 4), None, P("col", "row", None))
    assert _box(tp.out_boxes[1]) == ((4, 0, 0), (8, 8, 16))
    assert _box(tp.out_boxes[4]) == ((0, 8, 0), (4, 16, 16))
    world = tgeo.world_box(SHAPE)
    assert tgeo.world_complete(tp.out_boxes, world)


def test_wrapped_layout_r2c_and_spans():
    """Real plans take every layout by an edge reshape; the edges run
    under their spans, and plan_info says which layouts were absorbed."""
    in_spec = P("row", None, "col")
    jf, tf = _pair("r2c", SHAPE, (2, 4), in_spec, None)
    jb, tb = _pair("r2c", SHAPE, (2, 4), None, in_spec,
                   direction=jdfft.BACKWARD)
    assert [_box(b) for b in tf.in_boxes] == [_box(b) for b in jf.in_boxes]
    assert [_box(b) for b in tb.out_boxes] == [_box(b)
                                               for b in jb.out_boxes]
    x = _data(real=True)
    with capture_events() as ev:
        y = _run_both(jf, tf, x, np.complex128)
    assert "reshape3d_in" in [e[0] for e in ev]
    assert _rel(y, np.fft.rfftn(x)) <= TIER[np.complex128]
    back = _run_both(jb, tb, y, np.complex128)
    assert np.max(np.abs(back - x)) < 1e-11
    assert "in_spec: Spec('row', None, 'col') (edge reshape)" in \
        plan_info(tf)


@pytest.mark.parametrize("kind,kw", [
    ("c2c", dict(in_spec=P(None, None, None, "slab"))),      # overlong
    ("c2c", dict(in_spec=P("rwo", None, None), grid=(2, 4))),  # misspelled
    ("c2c", dict(in_spec=P(None, None, None), grid=None)),     # no mesh
    ("c2c", dict(in_spec=P(("row", "col"), None, None), grid=(2, 4),
                 shape=(12, 16, 16))),                         # not even
    ("c2c", dict(in_spec=P("slab"), batch=2)),                 # batched
    ("r2c", dict(batch=2, r2c_axis=0)),                        # batched axis
    ("r2c", dict(r2c_axis=3)),                                 # bad axis
])
def test_refusals_match_jax(kind, kw):
    """Each of JAX's refusals raises the same error class in the port."""
    kw = dict(kw)
    grid = kw.pop("grid", 8)
    shape = kw.pop("shape", SHAPE)
    with pytest.raises(Exception) as je:
        _pair(kind, shape, grid, dt=np.complex64, **kw)
    assert type(je.value) is ValueError
    jplanner = jdfft.plan_dft_c2c_3d if kind == "c2c" else \
        jdfft.plan_dft_r2c_3d
    with pytest.raises(Exception) as je:
        mesh = None if grid is None else jdfft.make_mesh(grid)
        jplanner(shape, mesh, **kw)
    tkw = {k: _spec(v) if k.endswith("spec") else v for k, v in kw.items()}
    tplanner = tdfft.plan_dft_c2c_3d if kind == "c2c" else \
        tdfft.plan_dft_r2c_3d
    with pytest.raises(Exception) as te:
        tplanner(shape, grid, device="cpu", **tkw)
    assert type(te.value) is type(je.value)
    if "rwo" in str(kw):
        assert "unknown mesh axis" in str(te.value)


@pytest.mark.parametrize("grid,src,dst", [
    (8, ("slab",), (None, None, "slab")),
    ((2, 4), ("row", "col"), (("row", "col"), None, None)),
    ((2, 4), (None, "col", "row"), (None, None, None))])
def test_reshape3d_between_layouts(grid, src, dst):
    """A world moved between two layouts lands each rank's box of the
    target at its block's low corner, zeros beyond (a replicated target
    gives every rank the whole world)."""
    from distributedfft_tpu_torch.parallel.reshape import (
        make_reshape3d, reshape3d, spec_gather, spec_scatter)

    shape = (8, 16, 24)
    world = tdfft.make_world(grid)
    x = torch.from_numpy(_data(shape, dt=np.complex64))
    blocks = spec_scatter(x, world, tdfft.Spec(*src))
    fn = make_reshape3d(world, tdfft.Spec(*src), tdfft.Spec(*dst), shape)
    out = fn(blocks)
    assert fn.move.spec.algorithm == "a2av"
    for blk, b in zip(out, spec_boxes(world, tdfft.Spec(*dst),
                                      tgeo.world_box(shape))):
        assert torch.equal(blk[:b.shape[0], :b.shape[1], :b.shape[2]],
                           x[b.slices()])
    assert torch.equal(spec_gather(out, world, tdfft.Spec(*dst), shape), x)
    again = reshape3d(blocks, world, tdfft.Spec(*src), tdfft.Spec(*dst),
                      shape)
    assert all(torch.equal(a, b) for a, b in zip(again, out))


# ------------------------------------------------------------- r2c_axis

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("grid", [None, 8, (2, 4)])
def test_r2c_axis_matches_jax(axis, grid):
    """heFFTe's r2c_direction: the half spectrum along ``axis`` equals
    JAX's and the full DFT sliced there; the boxes are JAX's; c2r back."""
    shape = (16, 8, 8) if grid is not None else (8, 10, 6)
    x = _data(shape, real=True)
    jf, tf = _pair("r2c", shape, grid, r2c_axis=axis)
    assert tf.r2c_axis == axis
    assert tuple(tf.out_shape) == tuple(jf.out_shape)
    assert [_box(b) for b in tf.out_boxes] == [_box(b)
                                               for b in jf.out_boxes]
    y = _run_both(jf, tf, x, np.complex128)
    h = shape[axis] // 2 + 1
    assert _rel(y, np.take(np.fft.fftn(x), np.arange(h), axis=axis)) \
        <= TIER[np.complex128]
    tb = tdfft.plan_dft_c2r_3d(shape, grid, r2c_axis=axis,
                               dtype=torch.complex128, device="cpu")
    back = tb(torch.from_numpy(y)).numpy()
    assert back.shape == shape and _rel(back, x) <= TIER[np.complex128]


def test_r2c_axis_equals_transposed_canonical_plan():
    """``r2c_axis=0`` is the canonical plan on the transposed input, bit
    for bit (the chain sees exactly the swapped array)."""
    shape = (16, 8, 12)
    x = torch.from_numpy(_data(shape, dt=np.complex64, real=True))
    p0 = tdfft.plan_dft_r2c_3d(shape, 8, r2c_axis=0, device="cpu")
    p2 = tdfft.plan_dft_r2c_3d((12, 8, 16), 8, device="cpu")
    assert torch.equal(p0(x), p2(x.permute(2, 1, 0).contiguous())
                       .permute(2, 1, 0))


# ----------------------------------------------------------------- donate

@pytest.mark.parametrize("grid,kw", [
    (None, {}), (8, {}), ((2, 4), {}), (8, dict(overlap_chunks=2)),
    (8, dict(in_spec=tdfft.Spec(None, None, "slab"))),
    ((2, 4), dict(in_spec=tdfft.Spec(("row", "col"), None, None)))])
def test_donate_equals_not_donated(grid, kw):
    """``donate=True`` may overwrite the input; the output is the
    undonated plan's bit for bit."""
    x = torch.from_numpy(_data(dt=np.complex64))
    keep = tdfft.plan_dft_c2c_3d(SHAPE, grid, device="cpu", **kw)
    give = tdfft.plan_dft_c2c_3d(SHAPE, grid, device="cpu", donate=True,
                                 **kw)
    assert give.donate and not keep.donate
    want = keep(x)
    xd = x.clone()
    assert torch.equal(give(xd), want)
    real = tdfft.plan_dft_r2c_3d(SHAPE, 8, device="cpu", donate=True)
    assert not real.donate                   # nothing to alias: dropped


def test_local_plan_donate():
    x = torch.from_numpy(_data((4, 16, 16), dt=np.complex64))
    want = tdfft.plan_dft_c2c_2d((16, 16), batch=4, device="cpu")(x)
    got = tdfft.plan_dft_c2c_2d((16, 16), batch=4, device="cpu",
                                donate=True)(x.clone())
    assert torch.equal(got, want)


# ------------------------------------------------- plans from the reference

def _describe(plan):
    box = lambda b: (tuple(b.low), tuple(b.high))
    spec = lambda s: None if s is None else tuple(s)
    return dict(shape=plan.shape, world_size=plan.mesh.size,
                grid=(tuple(plan.mesh.devices.shape)
                      if len(plan.mesh.axis_names) == 2 else None),
                direction=plan.direction, dtype=str(np.dtype(plan.dtype)),
                kind="r2c" if plan.real else "c2c", executor=plan.executor,
                r2c_axis=plan.r2c_axis, batch=plan.batch,
                in_spec=spec(plan.in_sharding.spec),
                out_spec=spec(plan.out_sharding.spec),
                in_boxes=[box(b) for b in plan.in_boxes],
                out_boxes=[box(b) for b in plan.out_boxes])


@pytest.mark.parametrize("kind,kw", [
    ("c2c", dict(in_spec=P(None, "row", "col"), out_spec=P("col", "row"))),
    ("r2c", dict(r2c_axis=1))])
def test_plan_from_reference_layouts(kind, kw):
    """A port plan from a JAX plan's description (its specs and halved
    axis): the same boxes and output."""
    jp, _ = _pair(kind, SHAPE, (2, 4), **kw)
    desc = _describe(jp)
    if kind == "r2c":
        desc["in_spec"] = desc["out_spec"] = None
    tp = tdfft.plan_from_reference(desc, device="cpu")
    assert tp.describe()["out_boxes"] == desc["out_boxes"]
    x = _data(real=kind == "r2c")
    _run_both(jp, tp, x, np.complex128)


# --------------------------------------------------------- process groups

def _layout_rank(rank, size, init, shape, x, out_dir):
    """One gloo rank: a wrapped-layout plan on its own box, and a batched
    plan (B = 2) on its own batched box."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        plan = tdfft.plan_dft_c2c_3d(
            shape, world, in_spec=tdfft.Spec(None, None, "slab"),
            out_spec=tdfft.Spec(None, None, "slab"), device="cpu")
        y = plan(torch.from_numpy(x[plan.in_boxes[rank].slices()].copy()))
        np.save(os.path.join(out_dir, f"y{rank}.npy"), y.numpy())
        batched = tdfft.plan_dft_c2c_3d(shape, world, batch=2, device="cpu")
        xb = np.stack([x, 2 * x])
        b = batched.in_boxes[rank]
        y = batched(torch.from_numpy(xb[(slice(None),) + b.slices()].copy()))
        np.save(os.path.join(out_dir, f"b{rank}.npy"), y.numpy())
    finally:
        dist.destroy_process_group()


def test_process_group_layout_and_batch_plans(tmp_path):
    """Two gloo ranks: an edge-reshaped layout (Z-slabs in and out) and a
    batched plan on each rank's own box equal their loopback twins' boxes
    bit for bit."""
    shape = (8, 12, 16)
    x = testing.make_world_data(shape, np.complex64, seed=5)
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_layout_rank, args=(2, init, shape, x,
                                           str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    loop = tdfft.plan_dft_c2c_3d(shape, 2, device="cpu",
                                 in_spec=tdfft.Spec(None, None, "slab"),
                                 out_spec=tdfft.Spec(None, None, "slab"))
    assert not loop.logic.out_absorbed     # same in/out axis: wrapped
    want = loop(torch.from_numpy(x)).numpy()
    for rank, b in enumerate(loop.out_boxes):
        np.testing.assert_array_equal(np.load(tmp_path / f"y{rank}.npy"),
                                      want[b.slices()])
    batched = tdfft.plan_dft_c2c_3d(shape, 2, batch=2, device="cpu")
    want = batched(torch.from_numpy(np.stack([x, 2 * x]))).numpy()
    for rank, b in enumerate(batched.out_boxes):
        np.testing.assert_array_equal(np.load(tmp_path / f"b{rank}.npy"),
                                      want[(slice(None),) + b.slices()])
