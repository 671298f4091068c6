"""The port's staged pipelines against the JAX package's builders.

Every staged pipeline (slab C2C under each transport, hierarchical at
K = 1 with its per-leg stages and at K = 2 with one pipelined t2 stage,
pencil C2C, slab and pencil R2C/C2R, single device) has the JAX
builder's stage names in its order, and the composition of its stages
is the plan's transform: bit for bit where the stages run the plan's
arithmetic in the plan's order, within 1e-5 where they do not: the slab
C2C backward (under every transport), whose stages transform X before
the exchange (as the JAX package's do) where the plan transforms X and
Z there, and the single
device at these short lengths, whose plan takes the axes one by one from
X (the plane kernel takes Y and Z together only at its lengths, 64 and
up, and then both orders are plane, then X). With ``batch=2`` the
single, pencil and real pipelines take the JAX builders' stage names,
compose to the batched plan, and agree with JAX's batched pipelines
within the complex64 tier.
:func:`~distributedfft_tpu_torch.utils.timing.time_staged` times each
stage.
"""

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel import staged as tst
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world
from distributedfft_tpu_torch.parallel.slab import build_slab_stages
from distributedfft_tpu_torch.utils.timing import time_staged

SHAPES = [(16, 16, 8), (12, 10, 9)]


def _jax_meshes():
    import jax
    from jax.sharding import Mesh

    import distributedfft_tpu as jdfft

    return {"slab": jdfft.make_mesh(4), "pencil": jdfft.make_mesh((2, 2)),
            "hybrid": Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                           ("dcn", "ici"))}


def _jax_names(kind, shape, forward, **kw):
    from distributedfft_tpu.parallel import slab as jslab
    from distributedfft_tpu.parallel import staged as jstaged

    m = _jax_meshes()
    if kind == "single":
        return [n for n, _ in jstaged.build_single_stages(
            shape, forward=forward)]
    if kind == "hierarchical":
        stages, _ = jslab.build_slab_stages(
            m["hybrid"], shape, axis_name=("dcn", "ici"),
            algorithm="hierarchical", forward=forward, **kw)
    elif kind == "slab":
        stages, _ = jslab.build_slab_stages(m["slab"], shape,
                                            forward=forward, **kw)
    elif kind == "pencil":
        stages, _ = jstaged.build_pencil_stages(m["pencil"], shape,
                                                forward=forward, **kw)
    elif kind == "slab_r2c":
        stages, _ = jstaged.build_slab_rfft_stages(m["slab"], shape,
                                                   forward=forward, **kw)
    else:
        stages, _ = jstaged.build_pencil_rfft_stages(m["pencil"], shape,
                                                     forward=forward, **kw)
    return [n for n, _ in stages]


def _port(kind, shape, forward, **kw):
    """(stages, plan) of the port for ``kind``."""
    d = tdfft.FORWARD if forward else tdfft.BACKWARD
    if kind == "single":
        return (tst.build_single_stages(shape, forward=forward),
                tdfft.plan_dft_c2c_3d(shape, device="cpu", direction=d))
    if kind == "hierarchical":
        world = make_world((2, 4), HYBRID_AXES)
        stages, _ = build_slab_stages(world, shape, forward=forward,
                                      algorithm="hierarchical", **kw)
        return stages, tdfft.plan_dft_c2c_3d(
            shape, world, device="cpu", direction=d,
            algorithm="hierarchical", **kw)
    if kind in ("slab", "slab_r2c"):
        world = make_world(4)
        build = build_slab_stages if kind == "slab" else \
            tst.build_slab_rfft_stages
    else:
        world = make_world((2, 2))
        build = (tst.build_pencil_stages if kind == "pencil"
                 else tst.build_pencil_rfft_stages)
    stages, _ = build(world, shape, forward=forward, **kw)
    planner = (tdfft.plan_dft_c2c_3d if kind in ("slab", "pencil")
               else tdfft.plan_dft_r2c_3d)
    return stages, planner(shape, world, device="cpu", direction=d, **kw)


CASES = (
    [(k, f, {}) for k in ("single", "slab", "pencil", "slab_r2c",
                          "pencil_r2c") for f in (True, False)]
    + [("slab", True, dict(algorithm=a, overlap_chunks=k))
       for a in ("alltoallv", "ppermute") for k in (1, 2)]
    + [("hierarchical", f, dict(overlap_chunks=k)) for f in (True, False)
       for k in (1, 2)]
    + [("hierarchical", True, dict(overlap_chunks=1, wire_dtype=w))
       for w in ("bf16", "int8", "split")]
    + [("pencil", True, dict(algorithm="ppermute", overlap_chunks=2)),
       ("pencil_r2c", False, dict(algorithm="alltoallv",
                                  overlap_chunks=3)),
       ("slab_r2c", True, dict(wire_dtype="int8", overlap_chunks=2))])


def _id(case):
    kind, fwd, kw = case
    return "-".join([kind, "fwd" if fwd else "bwd"]
                    + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind,forward,kw", CASES, ids=map(_id, CASES))
def test_stages_are_the_jax_stages_and_the_plan(kind, forward, kw, shape):
    stages, plan = _port(kind, shape, forward, **kw)
    assert [n for n, _ in stages] == _jax_names(kind, shape, forward, **kw)
    real_in = kind.endswith("r2c") and forward
    x = torch.from_numpy(testing.make_world_data(
        plan.in_shape, np.float32 if real_in else np.complex64, seed=3))
    cur = x
    for _, fn in stages:
        cur = fn(cur)
    want = plan(x)
    if kind == "single" or (kind in ("slab", "hierarchical")
                            and not forward):
        assert testing.rel_error(cur.numpy(), want.numpy()) < 1e-5
    else:
        assert torch.equal(cur, want)


def test_hierarchical_stages_show_each_leg():
    """At K = 1 the t2 tier is two stages, one per fabric; at K = 2 one
    stage whose chunks carry the per-leg spans."""
    from distributedfft_tpu_torch.utils.trace import capture_events

    world = make_world((2, 2), HYBRID_AXES)
    x = torch.from_numpy(testing.make_world_data((16, 16, 8), np.complex64))
    one, _ = build_slab_stages(world, (16, 16, 8), algorithm="hierarchical")
    assert [n for n, _ in one][1:3] == ["t2a_exchange_ici",
                                        "t2b_exchange_dcn"]
    two, _ = build_slab_stages(world, (16, 16, 8), algorithm="hierarchical",
                               overlap_chunks=2)
    with capture_events() as ev:
        cur = x
        for _, fn in two:
            cur = fn(cur)
    names = [e[0] for e in ev]
    for span in ("t2a_exchange_ici[0]", "t2a_exchange_ici[1]",
                 "t2b_exchange_dcn[0]", "t2b_exchange_dcn[1]",
                 "t2_all_to_all"):
        assert span in names, span


def test_time_staged_times_every_stage():
    stages, plan = _port("pencil", (16, 16, 8), True)
    x = torch.from_numpy(testing.make_world_data((16, 16, 8), np.complex64))
    times, out = time_staged(stages, x, iters=2)
    assert list(times.times) == [n for n, _ in stages]
    assert all(t >= 0 for t in times.times.values())
    assert times.total == pytest.approx(sum(times.times.values()))
    assert torch.equal(out, plan(x))
    assert "t2a_exchange_col" in times.report()


def test_staged_pipelines_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="flat transports"):
        tst.build_pencil_stages(make_world((2, 2)), (8, 8, 8),
                                algorithm="hierarchical")
    with pytest.raises(ValueError, match="1D world"):
        tst.build_slab_rfft_stages(make_world((2, 2), HYBRID_AXES),
                                   (8, 8, 8))


BATCH_KINDS = ("single", "pencil", "slab_r2c", "pencil_r2c")


def _jax_batched(kind, shape, forward):
    from distributedfft_tpu.parallel import staged as jstaged

    m = _jax_meshes()
    if kind == "single":
        return jstaged.build_single_stages(shape, forward=forward, batch=2)
    build = {"pencil": (jstaged.build_pencil_stages, "pencil"),
             "slab_r2c": (jstaged.build_slab_rfft_stages, "slab"),
             "pencil_r2c": (jstaged.build_pencil_rfft_stages, "pencil")}
    fn, mesh = build[kind]
    return fn(m[mesh], shape, forward=forward, batch=2)[0]


def _port_batched(kind, shape, forward):
    d = tdfft.FORWARD if forward else tdfft.BACKWARD
    if kind == "single":
        return (tst.build_single_stages(shape, forward=forward, batch=2),
                tdfft.plan_dft_c2c_3d(shape, device="cpu", direction=d,
                                      batch=2))
    world = make_world(4) if kind == "slab_r2c" else make_world((2, 2))
    build = {"pencil": tst.build_pencil_stages,
             "slab_r2c": tst.build_slab_rfft_stages,
             "pencil_r2c": tst.build_pencil_rfft_stages}[kind]
    planner = (tdfft.plan_dft_c2c_3d if kind == "pencil"
               else tdfft.plan_dft_r2c_3d)
    return (build(world, shape, forward=forward, batch=2)[0],
            planner(shape, world, device="cpu", direction=d, batch=2))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("kind", BATCH_KINDS)
def test_batched_stages_are_the_jax_stages_and_the_plan(kind, forward,
                                                        shape):
    """``batch=2`` on the single, pencil and real pipelines: the JAX
    builders' stage names, the composition equal to the batched plan (bit
    for bit; the single device within 1e-5, as unbatched) and within the
    complex64 tier of JAX's batched staged pipeline on the same input (a
    real pipeline's backward on a half spectrum of real data)."""
    stages, plan = _port_batched(kind, shape, forward)
    jstages = _jax_batched(kind, shape, forward)
    assert [n for n, _ in stages] == [n for n, _ in jstages]
    real_in = kind.endswith("r2c") and forward
    x = testing.make_world_data(plan.in_shape,
                                np.float32 if real_in else np.complex64,
                                seed=5)
    if kind.endswith("r2c") and not forward:
        # a half spectrum of real data: the C2R of any other input
        # depends on how each implementation reads its redundant bins
        real = testing.make_world_data((2,) + shape, np.float32, seed=5)
        x = np.fft.rfftn(real, axes=(1, 2, 3)).astype(np.complex64)
    cur = torch.from_numpy(x)
    for _, fn in stages:
        cur = fn(cur)
    want = plan(torch.from_numpy(x))
    if kind == "single":
        assert testing.rel_error(cur.numpy(), want.numpy()) < 1e-5
    else:
        assert torch.equal(cur, want)
    jcur = x
    for _, fn in jstages:
        jcur = fn(jcur)
    assert cur.shape == tuple(jcur.shape)
    assert testing.rel_error(cur.numpy(), np.asarray(jcur)) < 5e-4
