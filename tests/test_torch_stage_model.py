"""The port's stage model (``distributedfft_tpu_torch/plan_logic.py``:
``fused_model_stages``, ``model_stage_seconds``,
``model_concurrent_seconds``) against the JAX package's
(``distributedfft_tpu/plan_logic.py``).

Both packages build the plan skeleton of the same geometry (their own
``logic_plan3d`` on a 1D, 2D or hybrid world of 4, or none), and the
model runs on the same explicit hardware numbers. Every entry of the
returned dicts, the per-leg rows of ``t2`` included, agrees key by key:
numbers within 1e-12 relative, strings and flags exactly. The cases:
slab (forward and backward), pencil, single, R2C, batch = 2, K = 2,
every flat transport, ``hierarchical`` at K = 1 and 2, a split-fused
pencil and slab, the Poisson operator's ``t_mid`` chain on the slab, the
pencil and one device, and the optional knobs (``mm_tflops``, the
corrections, a concurrent hide budget). The port's ``LogicPlan`` has no
executor, so its ``fused_model_stages`` takes the plan's
(``executor=``); the JAX side reads ``lp.options.executor``. Labels map
``xla`` -> ``torch`` and ``pallas:fuse`` -> ``cuda:fuse``.
"""

import dataclasses

import numpy as np
import pytest

from distributedfft_tpu_torch import plan_logic as tpl
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world
from distributedfft_tpu_torch.testing import tree_mismatch

REL = 1e-12
HW = dict(hbm_gbps=800.0, wire_gbps=45.0, launch_seconds=1e-4,
          dcn_gbps=12.5)
SHAPES = [(16, 16, 16), (12, 10, 9)]


def _jax_world(key):
    import jax
    from jax.sharding import Mesh

    import distributedfft_tpu as jdfft

    if key is None:
        return None
    if key == "hybrid":
        return Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("dcn", "ici"))
    return jdfft.make_mesh(key)


def _port_world(key):
    if key is None:
        return None
    if key == "hybrid":
        return make_world((2, 2), HYBRID_AXES)
    return make_world(key)


PORT_EX = {"xla": "torch", "pallas:fuse": "cuda:fuse"}


def _pair(shape, world, *, forward=True, batch=None, op=None,
          executor="xla", **opts):
    """(JAX lp, port lp, port executor) of one geometry."""
    from distributedfft_tpu import plan_logic as jpl

    jlp = jpl.logic_plan3d(
        shape, _jax_world(world),
        jpl.PlanOptions(tune="off", executor=executor, **opts),
        forward=forward, batch=batch)
    tlp = tpl.logic_plan3d(
        shape, _port_world(world), tpl.PlanOptions(tune="off", **opts),
        forward=forward, batch=batch)
    if op is not None:
        jlp = dataclasses.replace(jlp, op=op)
        tlp = dataclasses.replace(tlp, op=op)
    return jlp, tlp, PORT_EX[executor]


def assert_same(got, want):
    """Recursive equality: the same keys, numbers within REL relative,
    everything else exactly."""
    bad = tree_mismatch(got, want, REL)
    assert bad is None, bad


CASES = {
    "slab": dict(world=4),
    "slab_backward": dict(world=4, forward=False),
    "pencil": dict(world=(2, 2)),
    "pencil_backward": dict(world=(2, 2), forward=False),
    "single": dict(world=None),
    "batch2_slab": dict(world=4, batch=2),
    "batch2_pencil": dict(world=(2, 2), batch=2),
    "k2_slab": dict(world=4, overlap_chunks=2),
    "k2_pencil": dict(world=(2, 2), overlap_chunks=2),
    "alltoallv": dict(world=4, algorithm="alltoallv"),
    "ppermute": dict(world=4, algorithm="ppermute", overlap_chunks=2),
    "hierarchical_k1": dict(world="hybrid", algorithm="hierarchical"),
    "hierarchical_k2": dict(world="hybrid", algorithm="hierarchical",
                            overlap_chunks=2),
    "bf16_slab": dict(world=4, wire_dtype="bf16"),
    "split_fused_pencil": dict(world=(2, 2), wire_dtype="split",
                               executor="pallas:fuse"),
    "split_fused_slab": dict(world=4, wire_dtype="split",
                             executor="pallas:fuse"),
    "int8_fused_slab_k2": dict(world=4, wire_dtype="int8",
                               executor="pallas:fuse", overlap_chunks=2),
    "poisson_slab": dict(world=4, op="poisson"),
    "poisson_pencil": dict(world=(2, 2), op="poisson"),
    "poisson_single": dict(world=None, op="poisson"),
    "poisson_slab_k2_bf16": dict(world=4, op="poisson", overlap_chunks=2,
                                 wire_dtype="bf16"),
}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_stage_seconds_matches_jax(case, shape):
    from distributedfft_tpu import plan_logic as jpl

    jlp, tlp, ex = _pair(shape, **CASES[case])
    jf = jpl.fused_model_stages(jlp, shape, 8)
    tf = tpl.fused_model_stages(tlp, shape, 8, executor=ex)
    assert tf == jf
    want = jpl.model_stage_seconds(jlp, shape, 8, fused=jf, **HW)
    got = tpl.model_stage_seconds(tlp, shape, 8, fused=tf, **HW)
    assert_same(got, want)
    if tlp.op:
        assert got["t_mid"]["seconds"] > 0


def _r2c_pair(world, forward):
    """(JAX lp, port lp, complex-side shape) of the R2C/C2R plans."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu.explain import _model_shape_itemsize as jshape

    import distributedfft_tpu_torch as tdfft
    from distributedfft_tpu_torch.explain import _model_shape_itemsize

    shape = (16, 16, 16)
    jd = jdfft.FORWARD if forward else jdfft.BACKWARD
    td = tdfft.FORWARD if forward else tdfft.BACKWARD
    jp = jdfft.plan_dft_r2c_3d(shape, _jax_world(world), direction=jd,
                               dtype=np.complex64)
    tp = tdfft.plan_dft_r2c_3d(shape, _port_world(world), direction=td,
                               device="cpu")
    assert _model_shape_itemsize(tp) == jshape(jp)
    return jp.logic, tp.logic, _model_shape_itemsize(tp)


@pytest.mark.parametrize("forward", [True, False], ids=["r2c", "c2r"])
@pytest.mark.parametrize("world", [4, (2, 2)], ids=["slab", "pencil"])
def test_model_stage_seconds_r2c_matches_jax(world, forward):
    from distributedfft_tpu import plan_logic as jpl

    jlp, tlp, (cshape, itemsize) = _r2c_pair(world, forward)
    assert cshape == (16, 16, 9)
    want = jpl.model_stage_seconds(jlp, cshape, itemsize, **HW)
    got = tpl.model_stage_seconds(tlp, cshape, itemsize, **HW)
    assert_same(got, want)


KNOBS = {
    "mm_tflops": dict(mm_tflops=50.0),
    "corrections": dict(exchange_correction=1.3, hide_correction=0.7),
    "concurrent_hide": dict(concurrent_hide_seconds=2e-5),
    "algorithm_k": dict(algorithm="ppermute", overlap_chunks=4),
}


@pytest.mark.parametrize("world", [4, (2, 2), "hybrid_k2"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_model_stage_seconds_knobs_match_jax(knob, world):
    from distributedfft_tpu import plan_logic as jpl

    shape = (16, 16, 16)
    kw = (dict(world="hybrid", algorithm="hierarchical", overlap_chunks=2)
          if world == "hybrid_k2" else dict(world=world))
    jlp, tlp, _ = _pair(shape, **kw)
    extra = dict(KNOBS[knob])
    if world == "hybrid_k2" and "algorithm" in extra:
        extra["algorithm"] = "hierarchical"
    want = jpl.model_stage_seconds(jlp, shape, 8, **HW, **extra)
    got = tpl.model_stage_seconds(tlp, shape, 8, **HW, **extra)
    assert_same(got, want)


def test_exchange_correction_scales_t2_only():
    lp = tpl.logic_plan3d((32, 32, 32), 8, tpl.PlanOptions(tune="off"))
    kw = dict(hbm_gbps=800.0, wire_gbps=45.0, launch_seconds=1e-4)
    base = tpl.model_stage_seconds(lp, (32, 32, 32), 16, **kw)
    corr = tpl.model_stage_seconds(lp, (32, 32, 32), 16,
                                   exchange_correction=2.0, **kw)
    assert corr["t2"]["seconds"] == pytest.approx(
        2.0 * base["t2"]["seconds"])
    assert corr["t2"]["wire_bytes"] == base["t2"]["wire_bytes"]
    for k in ("t0", "t1", "t3"):
        assert corr[k]["seconds"] == base[k]["seconds"]


FUSED_CASES = {
    "unfused_executor": dict(world=(2, 2), wire_dtype="split"),
    "fuse_without_wire": dict(world=(2, 2), executor="pallas:fuse"),
    "fuse_k2": dict(world=(2, 2), wire_dtype="split",
                    executor="pallas:fuse", overlap_chunks=2),
    "fuse_single": dict(world=None, wire_dtype="split",
                        executor="pallas:fuse"),
    "fuse_pencil": dict(world=(2, 2), wire_dtype="bf16",
                        executor="pallas:fuse"),
    "fuse_slab": dict(world=4, wire_dtype="int8", executor="pallas:fuse"),
    "fuse_op_slab": dict(world=4, wire_dtype="split",
                         executor="pallas:fuse", op="poisson"),
    "fuse_op_pencil": dict(world=(2, 2), wire_dtype="split",
                           executor="pallas:fuse", op="poisson"),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_model_stages_matches_jax(case):
    from distributedfft_tpu import plan_logic as jpl

    shape = (16, 16, 16)
    jlp, tlp, ex = _pair(shape, **FUSED_CASES[case])
    assert (tpl.fused_model_stages(tlp, shape, 8, executor=ex)
            == jpl.fused_model_stages(jlp, shape, 8))


def test_fused_model_stages_needs_the_executor():
    """Without ``executor=`` the port prices every chain unfused (its
    LogicPlan has no executor); an unknown modifier is no fuse flag."""
    lp = tpl.logic_plan3d((16, 16, 16), (2, 2), tpl.PlanOptions(
        tune="off", wire_dtype="split"))
    assert tpl.fused_model_stages(lp, (16, 16, 16), 8) == ()
    assert tpl.fused_model_stages(lp, (16, 16, 16), 8,
                                  executor="cuda:fuse") == ("t0", "t1", "t3")
    assert tpl.fused_model_stages(lp, (16, 16, 16), 8,
                                  executor="torch:fuse") == ()


CONCURRENT = {
    "one": [dict(world=4)],
    "two_slab": [dict(world=4), dict(world=4)],
    "slab_k2_pair": [dict(world=4, overlap_chunks=2),
                     dict(world=4, overlap_chunks=2)],
    "three_mixed": [dict(world=4), dict(world=4, algorithm="ppermute"),
                    dict(world=4, batch=2)],
    "pencil_fused_pair": [dict(world=(2, 2), wire_dtype="split",
                               executor="pallas:fuse"),
                          dict(world=(2, 2))],
}


@pytest.mark.parametrize("case", sorted(CONCURRENT))
def test_model_concurrent_seconds_matches_jax(case):
    from distributedfft_tpu import plan_logic as jpl

    shape = (16, 16, 16)
    pairs = [_pair(shape, **kw) for kw in CONCURRENT[case]]
    want = jpl.model_concurrent_seconds(
        [(j, shape, 8) for j, _, _ in pairs], **HW)
    got = tpl.model_concurrent_seconds(
        [(t, shape, 8, ex) for _, t, ex in pairs], **HW)
    assert_same(got, want)
    assert got["concurrent_seconds"] <= got["sequential_seconds"]
    if len(pairs) == 1:
        assert got["concurrent_seconds"] == got["sequential_seconds"]
        assert got["speedup"] == 1.0


def test_model_concurrent_seconds_triples_price_unfused():
    """A triple (no executor) prices its chain unfused: equal to the
    quadruple with an unfused executor."""
    shape = (16, 16, 16)
    lp = tpl.logic_plan3d(shape, (2, 2), tpl.PlanOptions(
        tune="off", wire_dtype="split"))
    tri = tpl.model_concurrent_seconds([(lp, shape, 8)] * 2, **HW)
    quad = tpl.model_concurrent_seconds([(lp, shape, 8, "cuda")] * 2, **HW)
    fused = tpl.model_concurrent_seconds([(lp, shape, 8, "cuda:fuse")] * 2,
                                         **HW)
    assert_same(tri, quad)
    assert fused["sequential_seconds"] < tri["sequential_seconds"]
