"""The port's 3D plans against the JAX package's, on the same seeded data.

The slab chain runs on a loopback world (P ranks' shards held as a list
in this process, on the CPU); the JAX side is
``plan_dft_c2c_3d(shape, make_mesh(P), executor="pallas")`` on the
virtual CPU mesh, as ``tests/test_pallas.py`` runs it. Forward results
and round trips hold the complex64 tier, 5e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft

C64 = testing.tolerance(np.complex64)
SAME_MATH = 1e-5


def _jax_plans(shape, p):
    mesh = None if p == 1 else jdfft.make_mesh(p)
    return tuple(jdfft.plan_dft_c2c_3d(shape, mesh, direction=d,
                                       executor="pallas", dtype=jnp.complex64)
                 for d in (jdfft.FORWARD, jdfft.BACKWARD))


def _port_plans(shape, p):
    return tuple(tdfft.plan_dft_c2c_3d(shape, p, direction=d, device="cpu")
                 for d in (tdfft.FORWARD, tdfft.BACKWARD))


def _describe(plan):
    """A JAX plan's geometry as the plain values plan_from_reference takes."""
    box = lambda b: (tuple(b.low), tuple(b.high))
    return dict(shape=plan.shape,
                world_size=1 if plan.mesh is None else plan.mesh.size,
                direction=plan.direction, dtype=str(np.dtype(plan.dtype)),
                in_boxes=[box(b) for b in plan.in_boxes],
                out_boxes=[box(b) for b in plan.out_boxes])


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("shape", [(64, 64, 64), (66, 70, 64)])
def test_slab_matches_reference(shape, p):
    x = testing.make_world_data(shape, np.complex64)
    jf, jb = _jax_plans(shape, p)
    tf, tb = _port_plans(shape, p)
    assert (tf.decomposition, tb.decomposition) == ("slab", "slab")
    want = np.asarray(jf(x))
    got = tf(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    assert testing.rel_error(got.numpy(), want) < SAME_MATH
    ref = np.fft.fftn(x.astype(np.complex128))
    assert testing.rel_error(got.numpy(), ref) < C64
    back = tb(got)
    assert testing.rel_error(back.numpy(), np.asarray(jb(want))) < SAME_MATH
    assert testing.rel_error(back.numpy(), x) < C64


def test_single_device_matches_reference():
    shape = (64, 66, 72)
    x = testing.make_world_data(shape, np.complex64, seed=7)
    jf, jb = _jax_plans(shape, 1)
    tf, tb = _port_plans(shape, 1)
    assert tf.decomposition == jf.decomposition == "single"
    got = tf(torch.from_numpy(x))
    assert testing.rel_error(got.numpy(), np.asarray(jf(x))) < SAME_MATH
    assert testing.rel_error(tb(got).numpy(), x) < C64


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("shape", [(64, 64, 64), (66, 70, 64),
                                   (510, 510, 512)])
def test_plan_from_reference_geometry(shape, p, direction):
    """Built from a JAX plan's description, the port's plan has the same
    decomposition, slab axes, boxes and stage names."""
    mesh = None if p == 1 else jdfft.make_mesh(p)
    d = jdfft.FORWARD if direction == "forward" else jdfft.BACKWARD
    jplan = jdfft.plan_dft_c2c_3d(shape, mesh, direction=d,
                                  executor="pallas", dtype=jnp.complex64)
    plan = tdfft.plan_from_reference(_describe(jplan), device="cpu")
    assert plan.decomposition == jplan.decomposition
    assert plan.describe()["in_boxes"] == _describe(jplan)["in_boxes"]
    assert plan.describe()["out_boxes"] == _describe(jplan)["out_boxes"]
    if p > 1:
        assert (plan.spec.in_axis, plan.spec.out_axis) == (
            jplan.spec.in_axis, jplan.spec.out_axis)
        assert plan.spec.in_padded == jplan.spec.in_padded
        assert plan.spec.out_padded == jplan.spec.out_padded
        assert [n.name for n in plan.graph.nodes] == [
            n.name for n in jplan.graph.nodes]
        assert [n.kind for n in plan.graph.nodes] == [
            n.kind for n in jplan.graph.nodes]


def test_plan_from_reference_rejects_other_geometry():
    desc = _describe(jdfft.plan_dft_c2c_3d(
        (64, 64, 64), jdfft.make_mesh(2), executor="pallas",
        dtype=jnp.complex64))
    desc["out_boxes"] = desc["out_boxes"][::-1]
    with pytest.raises(ValueError, match="out_boxes differ"):
        tdfft.plan_from_reference(desc, device="cpu")


def test_execute_scale_full_matches_reference():
    shape = (64, 64, 64)
    x = testing.make_world_data(shape, np.complex64, seed=3)
    jplan = jdfft.plan_dft_c2c_3d(shape, jdfft.make_mesh(2),
                                  executor="pallas", dtype=jnp.complex64)
    want = np.asarray(jdfft.execute(jplan, x, scale=jdfft.Scale.FULL))
    tplan = tdfft.plan_dft_c2c_3d(shape, 2, device="cpu")
    got = tdfft.execute(tplan, torch.from_numpy(x), scale=tdfft.Scale.FULL)
    assert testing.rel_error(got.numpy(), want) < SAME_MATH


def test_slab_routes_through_every_kernel_wrapper(monkeypatch):
    """Forward t0 takes the plane kernel and t3 the strided one; backward
    t0 the strided and 1D kernels, t3 the strided kernel on axis 1."""
    calls = []
    for name in ("fft2_last", "fft_axis0", "fft_last"):
        real = getattr(cuda_fft, name)

        def spy(x, *a, _real=real, _name=name, **k):
            calls.append((_name, tuple(x.shape)))
            return _real(x, *a, **k)
        monkeypatch.setattr(cuda_fft, name, spy)
    shape = (66, 70, 64)
    tf, tb = _port_plans(shape, 2)
    tb(tf(torch.from_numpy(testing.make_world_data(shape, np.complex64))))
    # Forward: X-slabs of 33 rows -> plane; Y-slabs, X cropped to 66.
    # Backward: Y-slabs of 35 -> axis 0 strided + axis 2 rows; X-slabs of
    # 33 -> strided over the middle axis.
    assert calls == (
        [("fft2_last", (33, 70, 64))] * 2
        + [("fft_axis0", (1, 66, 35 * 64))] * 2
        + [("fft_axis0", (1, 66, 35 * 64)), ("fft_last", (66 * 35, 64))] * 2
        + [("fft_axis0", (33, 70, 64))] * 2)


def test_stage_timer_names_each_stage():
    from distributedfft_tpu_torch.utils.timing import StageTimer

    shape = (64, 64, 64)
    tf, _ = _port_plans(shape, 4)
    timer = StageTimer("cpu")
    tf(torch.from_numpy(testing.make_world_data(shape, np.complex64)),
       timer=timer)
    assert timer.clock == "host"
    assert list(timer.times()) == ["t0", "t1", "t2", "t3"]
