"""The port's pencil decomposition against the JAX package's.

The port runs on loopback 2D worlds (rows x cols ranks' shards held as a
list in this process, on the CPU); the JAX side plans on the virtual
8-device CPU mesh (``tests/conftest.py``), its ``pallas`` executor as its
own tests run it. The port's executors map to the JAX ones: ``cuda`` to
``pallas``, ``matmul`` to ``matmul``, ``torch`` to ``xla``. The cases are
those of ``tests/test_fft3d.py``: grids (2,2), (2,4), (4,2), (1,8), (8,1)
at 16^3, the uneven round trips (12,10,14) and (9,7,11) on (2,4), both in
complex64 and complex128. Port and JAX agree within 1e-5 relative
(complex64) and 1e-12 (complex128), and each holds its tier against
numpy's float64 fftn (5e-4, 1e-11).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import geometry as jgeo
from distributedfft_tpu import plan_logic as jlogic
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import geometry as tgeo
from distributedfft_tpu_torch import plan_logic as tlogic
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft

SAME = {np.complex64: 1e-5, np.complex128: 1e-12}
TIER = {np.complex64: testing.tolerance(np.complex64),
        np.complex128: testing.tolerance(np.complex128)}
TORCH_DT = {np.complex64: torch.complex64, np.complex128: torch.complex128}
JAX_DT = {np.complex64: jnp.complex64, np.complex128: jnp.complex128}
#: port executor -> JAX executor
EXECUTORS = {"cuda": "pallas", "matmul": "matmul", "torch": "xla"}
GRIDS = [(2, 2), (2, 4), (4, 2), (1, 8), (8, 1)]


def _describe(plan):
    """A JAX plan's geometry and routing as plain values."""
    box = lambda b: (tuple(b.low), tuple(b.high))
    desc = dict(shape=plan.shape,
                world_size=1 if plan.mesh is None else plan.mesh.size,
                grid=(None if plan.mesh is None or len(plan.mesh.axis_names)
                      != 2 else tuple(plan.mesh.devices.shape)),
                direction=plan.direction, dtype=str(np.dtype(plan.dtype)),
                kind="r2c" if plan.real else "c2c",
                wire_dtype=plan.options.wire_dtype, executor=plan.executor,
                in_boxes=[box(b) for b in plan.in_boxes],
                out_boxes=[box(b) for b in plan.out_boxes])
    if plan.graph is not None:
        desc["fusion"] = plan.graph.meta["fusion"]
    return desc


def _pair(shape, grid, executor, dt):
    """(JAX fwd, JAX bwd, port fwd, port bwd)."""
    mesh = jdfft.make_mesh(grid)
    out = [jdfft.plan_dft_c2c_3d(shape, mesh, direction=d,
                                 executor=EXECUTORS[executor],
                                 dtype=JAX_DT[dt])
           for d in (jdfft.FORWARD, jdfft.BACKWARD)]
    out += [tdfft.plan_dft_c2c_3d(shape, grid, direction=d,
                                  executor=executor, dtype=TORCH_DT[dt],
                                  device="cpu")
            for d in (tdfft.FORWARD, tdfft.BACKWARD)]
    return out


def _check_pair(shape, grid, executor, dt, seed=4242):
    x = testing.make_world_data(shape, dt, seed=seed)
    jf, jb, tf, tb = _pair(shape, grid, executor, dt)
    assert tf.decomposition == jf.decomposition == "pencil"
    assert tf.describe()["in_boxes"] == _describe(jf)["in_boxes"]
    assert tf.describe()["out_boxes"] == _describe(jf)["out_boxes"]
    want = np.asarray(jf(x))
    got = tf(torch.from_numpy(x))
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == shape
    got = got.numpy()
    assert testing.rel_error(got, want) < SAME[dt]
    assert testing.rel_error(got, np.fft.fftn(x.astype(np.complex128))) \
        < TIER[dt]
    back = tb(torch.from_numpy(got)).numpy()
    assert testing.rel_error(back, np.asarray(jb(want))) < SAME[dt]
    assert testing.rel_error(back, x) < TIER[dt]


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("grid", GRIDS)
def test_pencil_matches_reference(grid, executor, dt):
    _check_pair((16, 16, 16), grid, executor, dt)


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("shape", [(12, 10, 14), (9, 7, 11)])
def test_pencil_uneven_roundtrip_matches_reference(shape, executor, dt):
    _check_pair(shape, (2, 4), executor, dt, seed=7)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("grid,shape", [((2, 2), (16, 16, 16)),
                                        ((2, 4), (12, 10, 14)),
                                        ((8, 1), (9, 7, 11)),
                                        ((1, 8), (64, 64, 64))])
def test_plan_from_reference_pencil_geometry(grid, shape, direction):
    """From a JAX pencil plan's description the port builds the same
    grid, boxes, pads and crops, stage names and kinds."""
    d = jdfft.FORWARD if direction == "forward" else jdfft.BACKWARD
    jplan = jdfft.plan_dft_c2c_3d(shape, jdfft.make_mesh(grid), direction=d,
                                  executor="pallas", dtype=jnp.complex128)
    desc = _describe(jplan)
    plan = tdfft.plan_from_reference(desc, device="cpu")
    assert plan.decomposition == "pencil" and plan.world.grid == grid
    assert plan.dtype == torch.complex128
    assert plan.describe()["grid"] == desc["grid"]
    assert (plan.spec.perm, plan.spec.order) == (jplan.spec.perm,
                                                 jplan.spec.order)
    jg = jplan.graph
    assert [(n.name, n.kind) for n in plan.graph.nodes] == [
        (n.name, n.kind) for n in jg.nodes]
    assert [getattr(n, "mesh_axis", None) for n in plan.graph.nodes] == [
        getattr(n, "mesh_axis", None) for n in jg.nodes]
    assert [tuple(n.ops) for n in plan.graph.nodes if hasattr(n, "ops")] \
        == [tuple(n.ops) for n in jg.nodes if hasattr(n, "ops")]
    assert plan.graph.pre == jg.pre and plan.graph.post == jg.post


@pytest.mark.parametrize("label,port", [("pallas", "cuda"),
                                        ("xla", "torch"),
                                        ("matmul:bf16", "matmul:bf16"),
                                        ("pallas:fuse", "cuda:fuse")])
def test_plan_from_reference_maps_executors(label, port):
    jplan = jdfft.plan_dft_c2c_3d((16, 16, 16), jdfft.make_mesh((2, 2)),
                                  executor=label, dtype=jnp.complex64,
                                  wire_dtype="split" if "fuse" in label
                                  else None)
    plan = tdfft.plan_from_reference(_describe(jplan), device="cpu")
    assert plan.executor == port and plan.dtype == torch.complex64


# ------------------------------------------------------ plan logic, grids

@pytest.mark.parametrize("shape,ndev", [((16, 16, 16), 4), ((4, 4, 16), 8),
                                        ((2, 64, 64), 4), ((64, 64, 64), 1),
                                        ((7, 9, 5), 6), ((12, 10, 14), 8)])
def test_decomposition_choice_matches_reference(shape, ndev):
    assert tlogic.choose_decomposition(shape, ndev) == \
        jlogic.choose_decomposition(shape, ndev)
    assert tlogic.eligible_decompositions(shape, ndev) == \
        jlogic.eligible_decompositions(shape, ndev)
    for decomp in ("slab", "pencil"):
        assert tlogic.negotiate_device_count(shape, ndev, decomp) == \
            jlogic.negotiate_device_count(shape, ndev, decomp)
    assert tgeo.pencil_grid_min_surface(shape, ndev) == \
        jgeo.pencil_grid_min_surface(shape, ndev)
    assert tgeo.proc_setup_min_surface(tgeo.world_box(shape), ndev) == \
        jgeo.proc_setup_min_surface(jgeo.world_box(shape), ndev)
    assert tgeo.make_procgrid(ndev) == jgeo.make_procgrid(ndev)


@pytest.mark.parametrize("shape,ndev", [((4, 4, 16), 8), ((16, 16, 16), 4),
                                        ((6, 6, 8), 4), ((3, 3, 8), 6)])
def test_int_world_plans_as_reference(shape, ndev):
    """An int world takes the JAX package's decomposition, grid and
    renegotiated count, and the same boxes."""
    jplan = jdfft.plan_dft_c2c_3d(shape, ndev, executor="pallas",
                                  dtype=jnp.complex64)
    tplan = tdfft.plan_dft_c2c_3d(shape, ndev, device="cpu")
    assert tplan.decomposition == jplan.decomposition
    desc = _describe(jplan)
    mine = tplan.describe()
    for key in ("world_size", "grid", "in_boxes", "out_boxes"):
        assert mine[key] == desc[key], key
    x = testing.make_world_data(shape, np.complex64)
    assert testing.rel_error(tplan(torch.from_numpy(x)).numpy(),
                             np.asarray(jplan(x))) < SAME[np.complex64]


def test_two_d_world_never_runs_slab():
    with pytest.raises(ValueError, match="requires a 1D world"):
        tdfft.plan_dft_c2c_3d((16, 16, 16), (2, 2), decomposition="slab",
                              device="cpu")
    with pytest.raises(ValueError, match="requires a 2D world"):
        tdfft.plan_dft_c2c_3d((16, 16, 16), tdfft.make_world(4),
                              decomposition="pencil", device="cpu")
    plan = tdfft.plan_dft_c2c_3d((16, 16, 16), 4, decomposition="pencil",
                                 device="cpu")
    assert plan.decomposition == "pencil" and plan.world.grid == (2, 2)


@pytest.mark.parametrize("grid", [(2, 3), (3, 2)])
def test_pencil_boxes_match_make_pencils(grid):
    """The input z-pencils are the ceil-rule pencils of the world, rank
    order row-major, and agree with JAX's make_pencils."""
    shape = (9, 7, 11)
    plan = tdfft.plan_dft_c2c_3d(shape, grid, device="cpu")
    world = tgeo.world_box(shape)
    pencils = tgeo.make_pencils(world, grid, 2, rule=tgeo.ceil_splits)
    assert plan.in_boxes == pencils
    assert [(b.low, b.high) for b in pencils] == [
        (b.low, b.high) for b in jgeo.make_pencils(
            jgeo.world_box(shape), grid, 2, rule=jgeo.ceil_splits)]
    assert tgeo.is_pencil(plan.in_boxes, world, 2)
    assert tgeo.is_pencil(plan.out_boxes, world, 0)
    assert not tgeo.is_slab(plan.in_boxes, world, (1, 2))
    assert sum(b.size for b in plan.in_boxes) == world.size


@pytest.mark.parametrize("a,b", [
    (((0, 0, 0), (4, 5, 6)), ((2, 1, 3), (7, 4, 9))),
    (((1, 1, 1), (3, 3, 3)), ((3, 0, 0), (5, 5, 5))),
    (((0, 2, 0), (8, 8, 8)), ((1, 3, 2), (2, 4, 3)))])
def test_box_algebra_matches_reference(a, b):
    ta, tb = tgeo.Box3(*a), tgeo.Box3(*b)
    ja, jb = jgeo.Box3(*a), jgeo.Box3(*b)
    assert (ta.size, ta.empty, ta.surface()) == (ja.size, ja.empty,
                                                 ja.surface())
    assert ta.contains(tb) == ja.contains(jb)
    ti, ji = ta.intersect(tb), ja.intersect(jb)
    assert (ti.low, ti.high, ti.empty) == (ji.low, ji.high, ji.empty)
    assert tgeo.fft_flops(ta.shape) == jgeo.fft_flops(ja.shape)
    assert tgeo.even_splits(ta.shape[2], 4) == jgeo.even_splits(ja.shape[2], 4)


def test_scale_symmetric_matches_reference():
    shape = (16, 16, 16)
    x = testing.make_world_data(shape, np.complex128, seed=5)
    jplan = jdfft.plan_dft_c2c_3d(shape, jdfft.make_mesh((2, 2)),
                                  executor="pallas", dtype=jnp.complex128)
    tplan = tdfft.plan_dft_c2c_3d(shape, (2, 2), dtype=torch.complex128,
                                  device="cpu")
    for scale in ("NONE", "FULL", "SYMMETRIC"):
        want = np.asarray(jdfft.execute(jplan, x,
                                        scale=getattr(jdfft.Scale, scale)))
        got = tdfft.execute(tplan, torch.from_numpy(x),
                            scale=getattr(tdfft.Scale, scale)).numpy()
        assert testing.rel_error(got, want) < SAME[np.complex128]


def test_complex128_slab_falls_back_by_dtype_and_matches_reference():
    """The acceptance case: a complex128 slab plan routes every axis to
    dft_matmul with reason ``dtype`` and matches JAX's pallas plan."""
    shape = (16, 64, 64)
    x = testing.make_world_data(shape, np.complex128, seed=9)
    jplan = jdfft.plan_dft_c2c_3d(shape, jdfft.make_mesh(2),
                                  executor="pallas", dtype=jnp.complex128)
    plan = tdfft.plan_dft_c2c_3d(shape, 2, dtype=torch.complex128,
                                 device="cpu")
    before = sum(v for (_, r), v in cuda_fft.FALLBACKS.items()
                 if r == "dtype")
    got = plan(torch.from_numpy(x)).numpy()
    after = sum(v for (_, r), v in cuda_fft.FALLBACKS.items()
                if r == "dtype")
    # each of the 2 ranks: t0 over axes 1 and 2, t3 over axis 0
    assert after - before == 6
    assert testing.rel_error(got, np.asarray(jplan(x))) < SAME[np.complex128]
    assert testing.rel_error(got, np.fft.fftn(x)) < TIER[np.complex128]


# ------------------------------------------------------------ real plans

@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("grid,shape", [((2, 2), (16, 16, 16)),
                                        ((2, 4), (12, 10, 14)),
                                        ((4, 2), (9, 7, 11))])
def test_pencil_real_matches_reference(grid, shape, dt):
    rdt = np.float32 if dt == np.complex64 else np.float64
    x = testing.make_world_data(shape, rdt, seed=13)
    mesh = jdfft.make_mesh(grid)
    spec = np.fft.rfftn(x.astype(np.float64))
    for direction, inp, ref in ((jdfft.FORWARD, x, spec),
                                (jdfft.BACKWARD, spec.astype(dt), x)):
        jplan = jdfft.plan_dft_r2c_3d(shape, mesh, executor="pallas",
                                      dtype=JAX_DT[dt], direction=direction)
        tplan = tdfft.plan_dft_r2c_3d(shape, grid, dtype=TORCH_DT[dt],
                                      direction=direction, device="cpu")
        desc, mine = _describe(jplan), tplan.describe()
        for key in ("in_boxes", "out_boxes"):
            assert mine[key] == desc[key]
        assert [n.name for n in tplan.graph.nodes] == [
            n.name for n in jplan.graph.nodes]
        want = np.asarray(jplan(inp))
        got = tplan(torch.from_numpy(inp))
        assert got.dtype == tplan.out_dtype
        assert tuple(got.shape) == tplan.out_shape == want.shape
        assert testing.rel_error(got.numpy(), want) < SAME[dt]
        assert testing.rel_error(got.numpy(), ref) < TIER[dt]


# ------------------------------------------------------- compressed wire

def _l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("codec", [None, "bf16", "int8", "split"])
def test_compressed_pencil_matches_reference(codec, fuse):
    """A 64^3 C2C pencil on 2x2 with each codec, fused and not, against
    JAX's ``pallas`` / ``pallas:fuse`` plan: exact plans within 1e-5;
    compressed ones differ only by one-level quantizer flips, so each
    side's error against numpy agrees within 5% and their L2 difference
    is under 0.2 of the codec's own. The fused plan gives exactly the
    unfused plan's values and its sites take the JAX plan's routes
    (forward: the t0 sender on the encode kernel, both receivers on the
    decode kernel; backward likewise, the last receiver on Z)."""
    shape = (64, 64, 64)
    x = testing.make_world_data(shape, np.complex64, seed=21)
    x = (x - x.mean()).astype(np.complex64)
    ref = np.fft.fftn(x.astype(np.complex128))
    mesh = jdfft.make_mesh((2, 2))
    for direction, inp, want_np in ((jdfft.FORWARD, x, ref),
                                    (jdfft.BACKWARD, ref.astype(np.complex64),
                                     x)):
        kw = dict(direction=direction, wire_dtype=codec, fuse=fuse)
        jplan = jdfft.plan_dft_c2c_3d(shape, mesh, executor="pallas",
                                      dtype=jnp.complex64, **kw)
        tplan = tdfft.plan_dft_c2c_3d(shape, (2, 2), device="cpu", **kw)
        want = np.asarray(jplan(inp))
        got = tplan(torch.from_numpy(inp)).numpy()
        if codec is None:
            assert testing.rel_error(got, want) <= SAME[np.complex64]
            assert testing.rel_error(got, want_np) <= TIER[np.complex64]
        else:
            for err in (testing.rel_error, _l2):
                assert abs(err(got, want_np) - err(want, want_np)) <= \
                    0.05 * err(want, want_np)
            assert _l2(got, want) <= 0.2 * _l2(want, want_np)
        jfu, tfu = jplan.graph.meta["fusion"], tplan.graph.meta["fusion"]
        for key in ("requested", "active", "reasons", "sites"):
            assert tfu[key] == jfu[key], key
        if fuse and codec is not None:
            plain = tdfft.plan_dft_c2c_3d(shape, (2, 2), device="cpu",
                                          direction=direction,
                                          wire_dtype=codec)
            assert np.array_equal(plain(torch.from_numpy(inp)).numpy(), got)


@pytest.mark.parametrize("codec,fuse", [("split", True), ("int8", False),
                                        ("bf16", True)])
def test_compressed_real_pencil_matches_reference(codec, fuse):
    shape = (64, 64, 64)
    x = testing.make_world_data(shape, np.float32, seed=23)
    x = (x - x.mean()).astype(np.float32)
    spec = np.fft.rfftn(x.astype(np.float64))
    mesh = jdfft.make_mesh((2, 2))
    for direction, inp, ref in ((jdfft.FORWARD, x, spec),
                                (jdfft.BACKWARD, spec.astype(np.complex64),
                                 x)):
        kw = dict(direction=direction, wire_dtype=codec, fuse=fuse)
        jplan = jdfft.plan_dft_r2c_3d(shape, mesh, executor="pallas",
                                      dtype=jnp.complex64, **kw)
        tplan = tdfft.plan_dft_r2c_3d(shape, (2, 2), device="cpu", **kw)
        want = np.asarray(jplan(inp))
        got = tplan(torch.from_numpy(inp)).numpy()
        for err in (testing.rel_error, _l2):
            assert abs(err(got, ref) - err(want, ref)) <= 0.05 * err(want, ref)
        assert _l2(got, want) <= 0.2 * _l2(want, ref)
        jfu, tfu = jplan.graph.meta["fusion"], tplan.graph.meta["fusion"]
        for key in ("requested", "active", "reasons", "sites"):
            assert tfu[key] == jfu[key], key


def test_pencil_routes_through_the_kernels(monkeypatch):
    """Forward 64^3 on 2x2: t0 rows over Z, t1 strided over Y, t3 strided
    over X; backward the mirror. No fallback at a kernel length."""
    calls = []
    for name in ("fft2_last", "fft_axis0", "fft_last"):
        real = getattr(cuda_fft, name)

        def spy(x, *a, _real=real, _name=name, **k):
            calls.append((_name, tuple(x.shape)))
            return _real(x, *a, **k)
        monkeypatch.setattr(cuda_fft, name, spy)
    shape = (64, 64, 64)
    before = dict(cuda_fft.FALLBACKS)
    tf = tdfft.plan_dft_c2c_3d(shape, (2, 2), device="cpu")
    tb = tdfft.plan_dft_c2c_3d(shape, (2, 2), device="cpu",
                               direction=tdfft.BACKWARD)
    tb(tf(torch.from_numpy(testing.make_world_data(shape, np.complex64))))
    assert dict(cuda_fft.FALLBACKS) == before
    assert calls == ([("fft_last", (32 * 32, 64))] * 4
                     + [("fft_axis0", (32, 64, 32))] * 4
                     + [("fft_axis0", (1, 64, 32 * 32))] * 4
                     + [("fft_axis0", (1, 64, 32 * 32))] * 4
                     + [("fft_axis0", (32, 64, 32))] * 4
                     + [("fft_last", (32 * 32, 64))] * 4)


def test_stage_timer_names_pencil_stages():
    from distributedfft_tpu_torch.utils.timing import StageTimer

    shape = (16, 16, 16)
    tf = tdfft.plan_dft_c2c_3d(shape, (2, 2), device="cpu")
    timer = StageTimer("cpu")
    tf(torch.from_numpy(testing.make_world_data(shape, np.complex64)),
       timer=timer)
    assert list(timer.times()) == ["t0", "t2a", "t1", "t2b", "t3"]
