"""The port's debug aids (``distributedfft_tpu_torch/utils/debug.py``)
held against ``tests/test_debug.py`` and the JAX package, and its
parity leftovers: ``api.destroy_plan`` and
``parallel.multihost.fft_world_for`` / ``fft_mesh_for``.

``ramp_world`` / ``decode_ramp`` equal the JAX package's;
``ramp_roundtrip_check`` stays within the complex64 tier in both
packages on the same slab plan (P = 4 loopback against JAX's
``make_mesh(4)``) and within the complex128 tier on the port;
``check_layout`` accepts a plan's boxes and names the rank whose box is
shifted; ``dump_local_data`` writes one CSV per block whose first value
decodes to the block's low corner; ``write_plan_info`` names its file
by the process index.
"""

import os

import numpy as np
import pytest
import torch

import jax

import distributedfft_tpu as jdfft
from distributedfft_tpu.utils import debug as jdbg
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import api
from distributedfft_tpu_torch.geometry import Box3
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.parallel.mesh import World
from distributedfft_tpu_torch.utils import debug as dbg

SHAPE = (8, 8, 8)
CPU = dict(device="cpu")
TOL64 = 5e-4
TOL128 = 1e-11

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs the virtual CPU mesh")


@pytest.fixture(autouse=True)
def fresh():
    tdfft.clear_plan_cache()
    yield
    tdfft.clear_plan_cache()


@pytest.mark.parametrize("shape", [SHAPE, (6, 10, 7), (1, 3, 5)])
def test_ramp_and_decode_equal_jax(shape):
    w = dbg.ramp_world(shape)
    assert np.array_equal(w, jdbg.ramp_world(shape))
    assert w.dtype == jdbg.ramp_world(shape).dtype == np.complex128
    for idx in [(0, 0, 0), tuple(s - 1 for s in shape),
                tuple(s // 2 for s in shape)]:
        assert dbg.decode_ramp(w[idx].real, shape) == idx
        assert dbg.decode_ramp(w[idx].real, shape) == \
            jdbg.decode_ramp(w[idx].real, shape)
    assert np.array_equal(dbg.ramp_world(shape, np.float32),
                          jdbg.ramp_world(shape, np.float32))


@needs_mesh
@pytest.mark.parametrize("shape", [SHAPE, (12, 8, 6)])
def test_ramp_roundtrip_c64_equals_jax_tier(shape):
    fwd = tdfft.plan_dft_c2c_3d(shape, 4, **CPU)
    bwd = tdfft.plan_dft_c2c_3d(shape, 4, direction=tdfft.BACKWARD, **CPU)
    err = dbg.ramp_roundtrip_check(fwd, bwd, tol=TOL64)
    mesh = jdfft.make_mesh(4)
    jerr = jdbg.ramp_roundtrip_check(
        jdfft.plan_dft_c2c_3d(shape, mesh, dtype=jax.numpy.complex64),
        jdfft.plan_dft_c2c_3d(shape, mesh, direction=jdfft.BACKWARD,
                              dtype=jax.numpy.complex64), tol=TOL64)
    assert err < TOL64 and jerr < TOL64


def test_ramp_roundtrip_c128_and_tolerance():
    kw = dict(dtype=torch.complex128, **CPU)
    fwd = tdfft.plan_dft_c2c_3d(SHAPE, (2, 2), **kw)
    bwd = tdfft.plan_dft_c2c_3d(SHAPE, (2, 2), direction=tdfft.BACKWARD,
                                **kw)
    assert dbg.ramp_roundtrip_check(fwd, bwd, tol=TOL128) < TOL128
    with pytest.raises(AssertionError, match="exceeds"):
        dbg.ramp_roundtrip_check(fwd, bwd, tol=0.0)


@pytest.mark.parametrize("world", [4, (2, 2)])
def test_check_layout_accepts_the_plans_boxes(world):
    plan = tdfft.plan_dft_c2c_3d(SHAPE, world, **CPU)
    x = torch.from_numpy(dbg.ramp_world(SHAPE))
    dbg.check_layout(x, plan.in_boxes, plan.world)
    dbg.check_layout(plan(x.to(torch.complex64)), plan.out_boxes,
                     plan.world)
    dbg.check_layout(x, [Box3((0, 0, 0), SHAPE)], None)


def _shift(b: Box3, axis: int, by: int) -> Box3:
    d = tuple(by if a == axis else 0 for a in range(3))
    return Box3(tuple(lo + s for lo, s in zip(b.low, d)),
                tuple(hi + s for hi, s in zip(b.high, d)))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_check_layout_names_the_shifted_rank(rank):
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU)
    x = torch.from_numpy(dbg.ramp_world(SHAPE))
    boxes = list(plan.in_boxes)
    boxes[rank] = _shift(boxes[rank], 0, 1)
    with pytest.raises(AssertionError, match=f"rank {rank}:"):
        dbg.check_layout(x, boxes, plan.world)


def test_check_layout_refusals():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU)
    x = torch.from_numpy(dbg.ramp_world(SHAPE))
    with pytest.raises(AssertionError, match="4 rank"):
        dbg.check_layout(x, plan.in_boxes[:3], plan.world)
    with pytest.raises(AssertionError, match="cover"):
        dbg.check_layout(torch.zeros((9, 8, 8)), plan.in_boxes, plan.world)
    # on a process-group world the tensor is this rank's block
    pg = World(4, rank=2)
    block = torch.zeros(plan.in_boxes[2].shape)
    dbg.check_layout(block, plan.in_boxes, pg)
    with pytest.raises(AssertionError, match="rank 2: block extent"):
        dbg.check_layout(torch.zeros((3, 8, 8)), plan.in_boxes, pg)


def test_dump_local_data(tmp_path):
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU)
    x = torch.from_numpy(dbg.ramp_world(SHAPE))
    paths = dbg.dump_local_data(x, prefix=str(tmp_path / "dump"),
                                boxes=plan.in_boxes, world=plan.world)
    assert len(paths) == 4
    for r, path in enumerate(paths):
        lines = open(path).read().splitlines()
        assert lines[0].startswith(f"# device=cpu rank={r} window=")
        assert lines[1] == "local_index,value"
        assert len(lines) == 2 + int(np.prod(plan.in_boxes[r].shape))
        v = complex(lines[2].split(",", 1)[1]).real
        assert dbg.decode_ramp(v, SHAPE) == tuple(plan.in_boxes[r].low)
    (whole,) = dbg.dump_local_data(x, prefix=str(tmp_path / "all"))
    assert len(open(whole).read().splitlines()) == 2 + 512


def test_write_plan_info(tmp_path):
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU)
    path = dbg.write_plan_info(plan, prefix=str(tmp_path / "plan"))
    assert os.path.basename(path) == "plan_0.txt"
    text = open(path).read()
    assert "decomposition: slab" in text and "in box[3]" in text


def test_destroy_plan_drops_the_cache_entry():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU)
    other = tdfft.plan_dft_c2c_3d(SHAPE, 2, **CPU)
    plan.compile()
    assert plan._warm and any(v is plan for v in api._PLAN_CACHE.values())
    tdfft.destroy_plan(plan)
    assert not any(v is plan for v in api._PLAN_CACHE.values())
    assert any(v is other for v in api._PLAN_CACHE.values())
    assert plan._warm                     # nothing but the cache entry
    assert tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU) is not plan
    x = torch.from_numpy(dbg.ramp_world(SHAPE)).to(torch.complex64)
    assert torch.equal(plan(x), tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU)(x))
    tdfft.destroy_plan(plan)              # idempotent
    assert jdfft.destroy_plan.__name__ == tdfft.destroy_plan.__name__


def test_fft_world_for(monkeypatch):
    assert multihost.fft_mesh_for is multihost.fft_world_for
    assert multihost.fft_world_for(4).size == 4
    w = multihost.fft_world_for(device="cpu")
    assert w.size == 1 and w.loopback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.fft_world_for()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert multihost.fft_world_for().size == 4
