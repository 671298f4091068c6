"""The port's overlap-map engine and brick plans against the JAX package's.

The cases mirror ``tests/test_bricks.py``: seeded world data scattered
into a box decomposition, moved, gathered and compared, for box lists a
layout cannot express (uneven slabs with an empty brick, non-grid split
trees, axis-swapped pencils, boxes stored in shuffled axis orders), on
the ``ring`` and ``a2av`` transports; the brick plans (C2C, R2C/C2R,
``r2c_axis`` 0 and 1, slab and pencil inner chains, the single-device
tier) forward and back. The JAX side plans on the virtual 8-device CPU
mesh (``tests/conftest.py``), its ``pallas`` executor as its own tests
run it; the port on loopback worlds on the CPU. Stacks are compared in
full, pads included: port against JAX within 1e-5 relative (complex64)
and 1e-12 (complex128), each against numpy within its tier (5e-4,
1e-11). The plan geometry, pads and ``payload_elems`` equal JAX's.
The process-group brick plans are in ``tests/test_torch_brick_groups.py``
(no JAX there, so the card's machine can run their NCCL twin).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import geometry as jgeo
from distributedfft_tpu.parallel import bricks as jbricks
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import geometry as tgeo
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel import bricks as tbricks
from distributedfft_tpu_torch.parallel.exchange import ROUNDS
from distributedfft_tpu_torch.utils.trace import capture_events, plan_info

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the virtual 8-device mesh")

SAME = {np.complex64: 1e-5, np.complex128: 1e-12}
TIER = {np.complex64: testing.tolerance(np.complex64),
        np.complex128: testing.tolerance(np.complex128)}
TORCH_DT = {np.complex64: torch.complex64, np.complex128: torch.complex128}


def _t(boxes):
    """JAX boxes as the port's (order carried)."""
    return [tgeo.Box3(b.low, b.high, b.order) for b in boxes]


def _cdata(shape, seed, dt=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dt)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _bisect(box, depth):
    """Recursive unequal bisection: a decomposition no layout names."""
    if depth == 0:
        return [box]
    ax = max(range(3), key=lambda d: box.shape[d])
    lo, hi = box.low[ax], box.high[ax]
    cut = lo + max(1, (hi - lo) * 2 // 5)
    la, ha = list(box.low), list(box.high)
    lb, hb = list(box.low), list(box.high)
    ha[ax], lb[ax] = cut, cut
    return (_bisect(jgeo.Box3(tuple(la), tuple(ha)), depth - 1)
            + _bisect(jgeo.Box3(tuple(lb), tuple(hb)), depth - 1))


def _cases():
    """(name, world shape, in boxes, out boxes) of ``test_bricks.py``."""
    w = jgeo.world_box((16, 16, 16))
    u = jgeo.world_box((13, 16, 12))
    s = jgeo.world_box((8, 12, 16))
    n = jgeo.world_box((12, 10, 8))
    return {
        "slabs_to_pencils": ((16, 16, 16), jgeo.make_slabs(w, 8),
                             jgeo.make_pencils(w, (2, 4), 2)),
        "uneven_empty_brick": ((13, 16, 12),
                               jgeo.make_slabs(u, 8, axis=0,
                                               rule=jgeo.ceil_splits),
                               jgeo.make_slabs(u, 8, axis=1)),
        "pencils_axis_swap": ((8, 12, 16), jgeo.make_pencils(s, (4, 2), 0),
                              jgeo.make_pencils(s, (2, 4), 2)),
        "non_grid": ((12, 10, 8), _bisect(n, 3),
                     jgeo.make_slabs(n, 8, rule=jgeo.ceil_splits)),
    }


# ------------------------------------------------------------ geometry

def test_box3_order_field():
    b = tgeo.Box3((0, 0, 0), (4, 6, 8), (2, 0, 1))
    assert b.storage_shape == (8, 4, 6)
    assert b.r2c(2).order == (2, 0, 1)
    assert b.intersect(tgeo.world_box((2, 2, 2))).order == (2, 0, 1)
    assert b == tgeo.Box3((0, 0, 0), (4, 6, 8))
    assert hash(b) == hash(tgeo.Box3((0, 0, 0), (4, 6, 8)))
    with pytest.raises(ValueError):
        tgeo.Box3((0, 0, 0), (4, 4, 4), (0, 0, 2))
    jb = jgeo.Box3((0, 0, 0), (4, 6, 8), (2, 0, 1))
    assert (b.storage_shape, b.with_order((1, 0, 2)).storage_shape) == (
        jb.storage_shape, jb.with_order((1, 0, 2)).storage_shape)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_find_world_world_complete_make_slabs(name):
    _, ins, outs = _cases()[name]
    for boxes in (ins, outs):
        w = jgeo.find_world(boxes)
        assert tgeo.find_world(_t(boxes)) == _t([w])[0]
        assert tgeo.world_complete(_t(boxes), _t([w])[0])
    bad = _t(ins)
    bad[0] = tgeo.Box3(bad[0].low, bad[0].low)
    assert not tgeo.world_complete(bad, tgeo.find_world(_t(ins)))
    for axis in range(3):
        for rule in ("even_splits", "ceil_splits"):
            want = jgeo.make_slabs(jgeo.world_box((13, 9, 7)), 4, axis,
                                   rule=getattr(jgeo, rule))
            got = tgeo.make_slabs(tgeo.world_box((13, 9, 7)), 4, axis,
                                  rule=getattr(tgeo, rule))
            assert got == _t(want)


# ----------------------------------------------------- the reshape engine

@pytest.mark.parametrize("algorithm", ["ring", "a2av"])
@pytest.mark.parametrize("name", sorted(_cases()))
def test_reshape_matches_jax(name, algorithm):
    """Every case round-trips exactly; the stacks, pads, payload and
    ring schedule equal the JAX package's."""
    shape, ins, outs = _cases()[name]
    x = _cdata(shape, 7)
    mesh = jdfft.make_mesh(8)
    jfn, jspec = jbricks.plan_brick_reshape(mesh, ins, outs,
                                            algorithm=algorithm)
    jy = np.asarray(jfn(jbricks.scatter_bricks(x, ins, jspec.in_pad,
                                               mesh=mesh)))
    tfn, tspec = tbricks.plan_brick_reshape(tdfft.make_world(8), _t(ins),
                                            _t(outs), algorithm=algorithm)
    ty = tfn(torch.from_numpy(tbricks.scatter_bricks(x, _t(ins),
                                                     tspec.in_pad))).numpy()
    assert (tspec.in_pad, tspec.out_pad) == (jspec.in_pad, jspec.out_pad)
    assert tspec.payload_elems == jspec.payload_elems
    assert tspec.a2av_table_bytes == jspec.a2av_table_bytes
    assert [(s.shift, s.block) for s in tspec.steps] == [
        (s.shift, s.block) for s in jspec.steps]
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tbricks.gather_bricks(ty, _t(outs)), x)
    # the port ships each overlap at its true extent
    assert tspec.wire_elems == tspec.payload_elems


def test_identity_no_steps_and_shape_skew_split():
    w = jgeo.world_box((8, 8, 8))
    boxes = _t(jgeo.make_slabs(w, 8))
    fn, spec = tbricks.plan_brick_reshape(tdfft.make_world(8), boxes, boxes)
    assert [st.shift for st in spec.steps] == [0] and spec.payload_elems == 0
    n = 16
    w = jgeo.world_box((n, n, n))
    ins = jgeo.make_slabs(w, 8, axis=0)
    outs = [jgeo.Box3((0, 0, 0), (n, n, 1)), jgeo.Box3((0, 0, 1), (n, 1, n))]
    outs += jgeo.make_slabs(jgeo.Box3((0, 1, 1), (n, n, n)), 6, axis=1,
                            rule=jgeo.ceil_splits)
    _, jspec = jbricks.plan_brick_reshape(jdfft.make_mesh(8), ins, outs)
    fn, spec = tbricks.plan_brick_reshape(tdfft.make_world(8), _t(ins),
                                          _t(outs))
    shifts = [st.shift for st in spec.steps if st.shift]
    assert len(shifts) > len(set(shifts))
    assert [(s.shift, s.block) for s in spec.steps] == [
        (s.shift, s.block) for s in jspec.steps]
    x = np.random.default_rng(31).standard_normal((n, n, n)).astype(
        np.float32)
    got = fn(torch.from_numpy(tbricks.scatter_bricks(x, _t(ins))))
    np.testing.assert_array_equal(
        tbricks.gather_bricks(got.numpy(), _t(outs)), x)


def test_reshape_refusals():
    w = jgeo.world_box((8, 8, 8))
    boxes = _t(jgeo.make_slabs(w, 8))
    world = tdfft.make_world(8)
    bad = list(boxes)
    bad[3] = tgeo.Box3((3, 0, 0), (3, 8, 8))
    for jfn, tfn, args in (
            (jbricks.plan_brick_reshape, tbricks.plan_brick_reshape,
             (bad, boxes)),
            (jbricks.plan_brick_reshape, tbricks.plan_brick_reshape,
             (_t(jgeo.make_slabs(w, 4)), _t(jgeo.make_slabs(w, 4))))):
        with pytest.raises(ValueError) as je:
            jfn(jdfft.make_mesh(8), *args)
        with pytest.raises(ValueError) as te:
            tfn(world, *args)
        assert str(te.value).split(" ")[:3] == str(je.value).split(" ")[:3]
    with pytest.raises(ValueError, match="ring|a2av"):
        tbricks.plan_brick_reshape(world, boxes, boxes, algorithm="nope")


@pytest.mark.parametrize("algorithm", ["ring", "a2av"])
def test_bricks_to_spec_batched(algorithm):
    """batch=B through plan_bricks_to_spec / plan_spec_to_bricks: B
    independent reshapes equal B unbatched ones bit for bit and the JAX
    package's global array (uneven slabs, an empty brick)."""
    from jax.sharding import PartitionSpec as P

    u = jgeo.world_box((13, 16, 12))
    boxes = jgeo.make_slabs(u, 8, axis=0, rule=jgeo.ceil_splits)
    world = tdfft.make_world(8)
    xs = [_cdata(u.shape, 11 + b) for b in range(3)]
    stacks = np.stack([tbricks.scatter_bricks(x, _t(boxes)) for x in xs])
    fb, spec = tbricks.plan_bricks_to_spec(world, _t(boxes),
                                           tdfft.Spec(None, "slab"),
                                           algorithm=algorithm, batch=3)
    f1, _ = tbricks.plan_bricks_to_spec(world, _t(boxes),
                                        tdfft.Spec(None, "slab"),
                                        algorithm=algorithm, batch=1)
    jf, jspec = jbricks.plan_bricks_to_spec(jdfft.make_mesh(8), boxes,
                                            P(None, "slab"),
                                            algorithm=algorithm, jit=True)
    assert spec.payload_elems == jspec.payload_elems
    y = fb(torch.from_numpy(stacks)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(y[b], xs[b])
        np.testing.assert_array_equal(
            f1(torch.from_numpy(stacks[b])).numpy(), y[b])
    np.testing.assert_array_equal(
        np.asarray(jf(jnp.asarray(jbricks.scatter_bricks(xs[0], boxes)))),
        y[0])
    inv, _ = tbricks.plan_spec_to_bricks(world, tdfft.Spec(None, "slab"),
                                         _t(boxes), algorithm=algorithm,
                                         batch=3)
    z = inv(torch.from_numpy(np.stack(xs))).numpy()
    for b in range(3):
        np.testing.assert_array_equal(z[b], stacks[b])
    with pytest.raises(ValueError, match="batch"):
        tbricks.plan_bricks_to_spec(world, _t(boxes),
                                    tdfft.Spec(None, "slab"), batch=0)


def test_scatter_gather_and_reorder_with_orders():
    shape = (8, 6, 4)
    w = jgeo.world_box(shape)
    orders = [(0, 1, 2), (2, 1, 0), (1, 2, 0), (0, 2, 1)]
    jboxes = [b.with_order(o) for b, o in zip(jgeo.make_slabs(w, 4), orders)]
    x = _cdata(shape, 7, np.complex128)
    stack = tbricks.scatter_bricks(x, _t(jboxes))
    np.testing.assert_array_equal(stack, jbricks.scatter_bricks(x, jboxes))
    np.testing.assert_array_equal(tbricks.gather_bricks(stack, _t(jboxes)),
                                  x)
    world = tdfft.make_world(4)
    assert tbricks.reorder_stack(world, _t(jgeo.make_slabs(w, 4)),
                                 to_canonical=True) is None
    canon = tbricks.reorder_stack(world, _t(jboxes), to_canonical=True)(
        list(torch.from_numpy(stack).unbind(0)))
    back = tbricks.reorder_stack(world, _t(jboxes), to_canonical=False)(
        canon)
    np.testing.assert_array_equal(torch.stack(back).numpy(), stack)
    for c, b in zip(canon, jboxes):
        np.testing.assert_array_equal(
            c.numpy()[:b.shape[0], :b.shape[1], :b.shape[2]], x[b.slices()])


# ------------------------------------------------------------ brick plans

def _jax_brick(kind, shape, mesh, ins, outs, **kw):
    planner = (jdfft.plan_brick_dft_c2c_3d if kind == "c2c"
               else jdfft.plan_brick_dft_r2c_3d)
    return planner(shape, mesh, ins, outs, executor="pallas", **kw)


def _port_brick(kind, shape, world, ins, outs, **kw):
    planner = (tdfft.plan_brick_dft_c2c_3d if kind == "c2c"
               else tdfft.plan_brick_dft_r2c_3d)
    return planner(shape, world, _t(ins), _t(outs), device="cpu", **kw)


def _check_brick_pair(jplan, tplan, x, dt, numpy_ref):
    """Same stacks as JAX (pads included), same geometry and payloads,
    numpy's tier; returns the port's output stack."""
    assert tplan.in_shape == tuple(jplan.in_shape)
    assert tplan.out_shape == tuple(jplan.out_shape)
    assert tplan.decomposition == jplan.decomposition
    if jplan.brick_edges is not None:
        assert [b.payload_elems for b in tplan.brick_edges] == [
            b.payload_elems for b in jplan.brick_edges]
        assert [(b.in_pad, b.out_pad) for b in tplan.brick_edges] == [
            (b.in_pad, b.out_pad) for b in jplan.brick_edges]
    jin = jbricks.scatter_bricks(x, jplan.in_boxes, jplan.in_shape[1:])
    jy = np.asarray(jplan(jnp.asarray(jin) if jplan.mesh is None else
                          jax.device_put(jin, jplan.in_sharding)))
    ty = tplan(torch.from_numpy(tbricks.scatter_bricks(
        x, tplan.in_boxes, tplan.in_shape[1:]))).numpy()
    assert ty.shape == jy.shape
    assert _rel(ty, jy) <= SAME[dt]
    assert _rel(tbricks.gather_bricks(ty, tplan.out_boxes), numpy_ref) \
        <= TIER[dt]
    pad = np.ones(ty.shape, bool)
    for i, b in enumerate(tplan.out_boxes):
        s = b.storage_shape
        pad[i, :s[0], :s[1], :s[2]] = False
    assert not ty[pad].any()       # the output pads are zero
    return ty


@pytest.mark.parametrize("algorithm", ["alltoall", "alltoallv"])
@pytest.mark.parametrize("case", ["slab", "pencil_nongrid"])
def test_brick_c2c_matches_jax(case, algorithm):
    """Slab inner chain (z-pencils in, Y-slabs out) and pencil inner
    chain (an uneven non-grid partition in, ceil X-slabs out), both edge
    transports, forward and back."""
    if case == "slab":
        shape, mesh, world = (16, 16, 16), jdfft.make_mesh(8), 8
        w = jgeo.world_box(shape)
        ins, outs = jgeo.make_pencils(w, (4, 2), 2), jgeo.make_slabs(w, 8, 1)
    else:
        shape, mesh, world = (16, 12, 8), jdfft.make_mesh((2, 4)), (2, 4)
        w = jgeo.world_box(shape)
        ins = [jgeo.Box3((x0, y0, 0), (x1, y1, 8))
               for x0, x1 in ((0, 6), (6, 16))
               for y0, y1 in ((0, 3), (3, 6), (6, 9), (9, 12))]
        outs = jgeo.make_slabs(w, 8, axis=0, rule=jgeo.ceil_splits)
    x = _cdata(shape, 11)
    kw = dict(algorithm=algorithm, dtype=np.complex64)
    jf = _jax_brick("c2c", shape, mesh, ins, outs, **kw)
    tf = _port_brick("c2c", shape, world, ins, outs,
                     algorithm=algorithm)
    assert [b.algorithm for b in tf.brick_edges] == [
        "a2av" if algorithm == "alltoallv" else "ring"] * 2
    y = _check_brick_pair(jf, tf, x, np.complex64, np.fft.fftn(x))
    tb = _port_brick("c2c", shape, world, outs, ins, algorithm=algorithm,
                     direction=tdfft.BACKWARD)
    back = tbricks.gather_bricks(tb(torch.from_numpy(y)).numpy(), _t(ins))
    assert _rel(back, x) <= TIER[np.complex64]


@pytest.mark.parametrize("algorithm", ["alltoall", "alltoallv"])
def test_brick_plan_shuffled_orders(algorithm):
    """heFFTe's shuffled-order test: bricks stored in non-canonical axis
    orders, different on input and output, complex128."""
    shape = (16, 12, 8)
    w = jgeo.world_box(shape)
    in_orders = [(0, 1, 2), (2, 1, 0), (1, 0, 2), (2, 0, 1),
                 (0, 2, 1), (1, 2, 0), (0, 1, 2), (2, 1, 0)]
    ins = [b.with_order(o) for b, o in zip(jgeo.make_pencils(w, (4, 2), 2),
                                           in_orders)]
    outs = [b.with_order(o) for b, o in zip(
        jgeo.make_slabs(w, 8, axis=1, rule=jgeo.ceil_splits),
        reversed(in_orders))]
    x = _cdata(shape, 11, np.complex128)
    jf = _jax_brick("c2c", shape, jdfft.make_mesh(8), ins, outs,
                    algorithm=algorithm, dtype=np.complex128)
    tf = _port_brick("c2c", shape, 8, ins, outs, algorithm=algorithm,
                     dtype=torch.complex128)
    _check_brick_pair(jf, tf, x, np.complex128, np.fft.fftn(x))


@pytest.mark.parametrize("axis", [2, 0, 1])
def test_brick_r2c_c2r_matches_jax(axis):
    """Real bricks in, half-spectrum bricks (shrunk along ``r2c_axis``,
    stored in another order) out, and back to the real bricks."""
    shape = (8, 12, 16)
    w = jgeo.world_box(shape)
    half = list(shape)
    half[axis] = shape[axis] // 2 + 1
    cw = jgeo.world_box(tuple(half))
    ins = jgeo.make_slabs(w, 8, axis=2 if axis != 2 else 0,
                          rule=jgeo.ceil_splits)
    outs = [b.with_order((1, 0, 2)) for b in
            jgeo.make_slabs(cw, 8, axis=2 if axis != 2 else 0,
                            rule=jgeo.ceil_splits)]
    rng = np.random.default_rng(19)
    x = rng.standard_normal(shape).astype(np.float32)
    kw = dict(r2c_axis=axis)
    jf = _jax_brick("r2c", shape, jdfft.make_mesh(8), ins, outs,
                    dtype=np.complex64, **kw)
    tf = _port_brick("r2c", shape, 8, ins, outs, **kw)
    assert tf.r2c_axis == axis and tf.kind == "r2c"
    ref = np.fft.rfftn(x.astype(np.float64),
                       axes=[a for a in range(3) if a != axis] + [axis])
    y = _check_brick_pair(jf, tf, x, np.complex64, ref)
    tb = tdfft.plan_brick_dft_c2r_3d(shape, 8, _t(outs), _t(ins),
                                     device="cpu", **kw)
    back = tbricks.gather_bricks(tb(torch.from_numpy(y)).numpy(), _t(ins))
    np.testing.assert_allclose(back, x, atol=1e-4)


def test_brick_plan_single_device():
    """One rank: the world is one brick per side, possibly stored in
    another order; the same ``[1, *pad]`` stacks; C2C and R2C."""
    shape = (12, 10, 8)
    w = jgeo.world_box(shape)
    ins, outs = [w.with_order((2, 0, 1))], [w.with_order((1, 2, 0))]
    x = _cdata(shape, 23)
    jf = _jax_brick("c2c", shape, None, ins, outs, dtype=np.complex64)
    tf = _port_brick("c2c", shape, None, ins, outs)
    assert tf.world is None and tf.in_shape == (1,) + ins[0].storage_shape
    y = _check_brick_pair(jf, tf, x, np.complex64, np.fft.fftn(x))
    tb = _port_brick("c2c", shape, None, outs, ins,
                     direction=tdfft.BACKWARD)
    back = tbricks.gather_bricks(tb(torch.from_numpy(y)).numpy(), _t(ins))
    assert _rel(back, x) <= TIER[np.complex64]
    xr = np.random.default_rng(29).standard_normal((8, 12, 10)).astype(
        np.float32)
    rin = [jgeo.world_box((8, 12, 10)).with_order((1, 0, 2))]
    rout = [jgeo.world_box((8, 12, 6)).with_order((2, 1, 0))]
    jr = _jax_brick("r2c", (8, 12, 10), None, rin, rout, dtype=np.complex64)
    tr = _port_brick("r2c", (8, 12, 10), None, rin, rout)
    _check_brick_pair(jr, tr, xr, np.complex64,
                      np.fft.rfftn(xr.astype(np.float64)))
    with pytest.raises(ValueError, match="one box per side"):
        tdfft.plan_brick_dft_c2c_3d(
            (8, 8, 8), None, _t(jgeo.make_slabs(jgeo.world_box((8,) * 3), 2)),
            [tgeo.world_box((8, 8, 8))], device="cpu")


def test_brick_plan_refusals_match_jax():
    """The JAX package's refusals raise the same error class: a box list
    spanning another world, the shrunk-world rule of a real plan, a
    transport with no brick edge, a non-partition."""
    shape = (16, 12, 16)
    mesh = jdfft.make_mesh(8)
    w = jgeo.world_box(shape)
    ins = jgeo.make_slabs(w, 8, axis=1)
    cases = [
        ("r2c", shape, ins, jgeo.make_slabs(w, 8, axis=0), {}, 8, mesh),
        ("c2c", shape, ins, jgeo.make_slabs(jgeo.world_box((8, 8, 8)), 8),
         {}, 8, mesh),
        ("c2c", shape, ins, ins, {"algorithm": "hierarchical"},
         tdfft.make_world((2, 4), tdfft.HYBRID_AXES),
         jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                           ("dcn", "ici"))),
    ]
    bad = list(ins)
    bad[2] = jgeo.Box3(bad[2].low, bad[2].low)
    cases.append(("c2c", shape, bad, ins, {}, 8, mesh))
    for kind, shp, i, o, kw, world, jmesh in cases:
        with pytest.raises(Exception) as je:
            _jax_brick(kind, shp, jmesh, i, o, **kw)
        with pytest.raises(Exception) as te:
            _port_brick(kind, shp, world, i, o, **kw)
        assert type(te.value) is type(je.value)


def test_brick_plan_info_spans_and_scale():
    """plan_info prints both edges' payload/wire accounting; the edges
    run under their spans; Scale applies to the stack (pads stay zero);
    donate gives the same bits."""
    from distributedfft_tpu_torch.ops.executors import Scale

    shape = (16, 16, 16)
    w = tgeo.world_box(shape)
    ins = tgeo.make_pencils(w, (4, 2), 2)
    outs = tgeo.make_slabs(w, 8, axis=2)
    plan = tdfft.plan_brick_dft_c2c_3d(shape, 8, ins, outs, device="cpu")
    info = plan_info(plan)
    assert "brick edge in->chain: 3 ring steps" in info
    assert "brick edge chain->out" in info and "payload" in info
    x = _cdata(shape, 23)
    stack = torch.from_numpy(tbricks.scatter_bricks(x, ins))
    ROUNDS.clear()
    with capture_events() as ev:
        y = plan(stack, scale=Scale.FULL)
    names = [e[0] for e in ev]
    assert names.index("bricks_to_spec") < names.index("t0_fft_yz") \
        < names.index("spec_to_bricks")
    assert ROUNDS[("bricks_ring", "slab")] == sum(
        1 for b in plan.brick_edges for s in b.steps if s.shift)
    np.testing.assert_allclose(tbricks.gather_bricks(y.numpy(), outs),
                               np.fft.fftn(x) / x.size, atol=1e-5)
    donated = tdfft.plan_brick_dft_c2c_3d(shape, 8, ins, outs, device="cpu",
                                          donate=True)
    assert torch.equal(donated(stack.clone()), plan(stack))


def _describe(plan):
    """A JAX plan's geometry as plain values, boxes with their orders."""
    box = lambda b: ((tuple(b.low), tuple(b.high)) if b.order == (0, 1, 2)
                     else (tuple(b.low), tuple(b.high), tuple(b.order)))
    edges = None if plan.brick_edges is None else [
        dict(algorithm=e.algorithm, payload_elems=e.payload_elems,
             wire_elems=e.wire_elems) for e in plan.brick_edges]
    return dict(shape=plan.shape, world_size=plan.mesh.size,
                grid=(tuple(plan.mesh.devices.shape)
                      if len(plan.mesh.axis_names) == 2 else None),
                direction=plan.direction, dtype=str(np.dtype(plan.dtype)),
                kind="r2c" if plan.real else "c2c", executor=plan.executor,
                algorithm=plan.options.algorithm, r2c_axis=plan.r2c_axis,
                in_boxes=[box(b) for b in plan.in_boxes],
                out_boxes=[box(b) for b in plan.out_boxes],
                brick_edges=edges)


def test_plan_from_reference_brick():
    """A port plan built from a JAX brick plan's description: the same
    geometry, payloads and output."""
    shape = (16, 12, 8)
    w = jgeo.world_box(shape)
    ins = [b.with_order((2, 0, 1)) for b in jgeo.make_pencils(w, (4, 2), 2)]
    outs = jgeo.make_slabs(w, 8, axis=1, rule=jgeo.ceil_splits)
    jplan = _jax_brick("c2c", shape, jdfft.make_mesh(8), ins, outs,
                       dtype=np.complex64, algorithm="alltoallv")
    plan = tdfft.plan_from_reference(_describe(jplan), device="cpu")
    assert plan.brick_edges is not None and plan.algorithm == "alltoallv"
    assert plan.describe()["in_boxes"] == _describe(jplan)["in_boxes"]
    x = _cdata(shape, 41)
    _check_brick_pair(jplan, plan, x, np.complex64, np.fft.fftn(x))
    bad = _describe(jplan)
    bad["brick_edges"][0]["payload_elems"] += 1
    with pytest.raises(ValueError, match="payload"):
        tdfft.plan_from_reference(bad, device="cpu")
