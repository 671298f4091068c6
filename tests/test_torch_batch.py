"""The port's batched plans (``batch=B``) against the JAX package's.

The cases mirror ``tests/test_a2e_batch.py``: a batch=B execution equals
B executions of the unbatched plan bit for bit (the batch is a bystander
of every stage: each kernel's per-line arithmetic ignores it), on the
slab and pencil chains, C2C and R2C/C2R, every flat transport and K in
{1, 2}, uneven worlds, the single device and the staged pipeline;
``batch=1`` is the unbatched plan; each exchange is one shared exchange
(the collective rounds of a batched plan are the unbatched plan's); and
the batched plans hold against the JAX package's (its ``pallas``
executor on the virtual 8-device CPU mesh) within 1e-5 relative
(complex64) and 1e-12 (complex128), and against numpy within the tier.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributedfft_tpu as jdfft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel.exchange import ROUNDS
from distributedfft_tpu_torch.parallel.slab import build_slab_stages
from distributedfft_tpu_torch.utils.trace import plan_info

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the virtual 8-device mesh")

SHAPE = (16, 16, 16)
UNEVEN = (12, 10, 9)
ALGS = ("alltoall", "alltoallv", "ppermute")
SAME = {np.complex64: 1e-5, np.complex128: 1e-12}
TIER = {np.complex64: testing.tolerance(np.complex64),
        np.complex128: testing.tolerance(np.complex128)}
TORCH_DT = {np.complex64: torch.complex64, np.complex128: torch.complex128}


def _world(shape=SHAPE, seed=7, real=False, batch=None, dt=np.complex128):
    rng = np.random.default_rng(seed)
    full = shape if batch is None else (batch,) + tuple(shape)
    r = rng.standard_normal(full)
    if real:
        return r.astype(np.float64 if dt == np.complex128 else np.float32)
    return (r + 1j * rng.standard_normal(full)).astype(dt)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _batch_equals_sequential(pb, p1, x):
    """batch=B output bit-identical to B executes of the unbatched plan."""
    x = torch.from_numpy(x)
    yb = pb(x)
    assert tuple(yb.shape) == pb.out_shape
    for i in range(x.shape[0]):
        assert torch.equal(yb[i], p1(x[i].clone()))
    return yb


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("grid", [8, (2, 4)])
def test_c2c_batch_parity_bitwise(grid, alg, k):
    kw = dict(algorithm=alg, overlap_chunks=k, device="cpu",
              dtype=torch.complex128)
    pb = tdfft.plan_dft_c2c_3d(SHAPE, grid, batch=3, **kw)
    p1 = tdfft.plan_dft_c2c_3d(SHAPE, grid, **kw)
    _batch_equals_sequential(pb, p1, _world(batch=3))


@pytest.mark.parametrize("alg", ALGS)
def test_uneven_batch_parity_bitwise(alg):
    """Uneven worlds: the batched pads and crops ride at spatial axis +
    1; K = 2 does not divide the 9-wide bystander."""
    kw = dict(algorithm=alg, overlap_chunks=2, device="cpu",
              dtype=torch.complex128)
    pb = tdfft.plan_dft_c2c_3d(UNEVEN, 8, batch=2, **kw)
    p1 = tdfft.plan_dft_c2c_3d(UNEVEN, 8, **kw)
    _batch_equals_sequential(pb, p1, _world(UNEVEN, batch=2))


@pytest.mark.parametrize("grid", [None, 8, (2, 4)])
@pytest.mark.parametrize("direction", [-1, 1])
def test_r2c_c2r_batch_parity_bitwise(grid, direction):
    kw = dict(direction=direction, device="cpu")
    pb = tdfft.plan_dft_r2c_3d(SHAPE, grid, batch=3, **kw)
    p1 = tdfft.plan_dft_r2c_3d(SHAPE, grid, **kw)
    x = _world(real=True, batch=3, dt=np.complex64)
    if direction == 1:
        x = np.stack([np.fft.rfftn(w) for w in x]).astype(np.complex64)
    _batch_equals_sequential(pb, p1, x)
    assert pb.in_shape == (3,) + p1.in_shape
    assert pb.out_shape == (3,) + p1.out_shape


def test_single_and_fused_batch_parity_bitwise():
    """The single device (the batch folds into the executors' own batch
    axis) and a split-wire fused slab chain against its unbatched twin."""
    pb = tdfft.plan_dft_c2c_3d(SHAPE, None, batch=2, device="cpu")
    p1 = tdfft.plan_dft_c2c_3d(SHAPE, None, device="cpu")
    _batch_equals_sequential(pb, p1, _world(batch=2, dt=np.complex64))
    fb = tdfft.plan_dft_c2c_3d(SHAPE, 4, batch=2, wire_dtype="split",
                               fuse=True, device="cpu")
    ub = tdfft.plan_dft_c2c_3d(SHAPE, 4, batch=2, wire_dtype="split",
                               device="cpu")
    x = torch.from_numpy(_world(batch=2, dt=np.complex64))
    assert torch.equal(fb(x), ub(x))
    assert fb.graph.meta["fusion"]["active"]


@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_batch1_is_the_unbatched_plan(kind):
    planner = tdfft.plan_dft_c2c_3d if kind == "c2c" else \
        tdfft.plan_dft_r2c_3d
    p0 = planner(SHAPE, 8, device="cpu")
    p1 = planner(SHAPE, 8, batch=1, device="cpu")
    assert p1.batch is None and p1.in_shape == p0.in_shape == SHAPE
    x = torch.from_numpy(_world(dt=np.complex64, real=kind == "r2c"))
    assert torch.equal(p1(x), p0(x))


@pytest.mark.parametrize("alg,k", [("alltoall", 1), ("alltoall", 2),
                                   ("ppermute", 1), ("alltoallv", 2)])
def test_batch_shares_every_exchange(alg, k):
    """The batched plan issues exactly the unbatched plan's collective
    rounds: the batch never splits an exchange."""
    counts = []
    for batch in (None, 4):
        plan = tdfft.plan_dft_c2c_3d(SHAPE, (2, 4), batch=batch,
                                     algorithm=alg, overlap_chunks=k,
                                     device="cpu")
        ROUNDS.clear()
        plan(torch.from_numpy(_world(batch=batch, dt=np.complex64)))
        counts.append(dict(ROUNDS))
    assert counts[0] == counts[1] and sum(counts[0].values()) >= 2 * k


def test_staged_batch_parity():
    """The staged slab pipeline with a batch: each stage's composition is
    the batched plan's transform, bit for bit."""
    world = tdfft.make_world(8)
    stages, _ = build_slab_stages(world, SHAPE, batch=2)
    plan = tdfft.plan_dft_c2c_3d(SHAPE, world, batch=2, device="cpu")
    x = torch.from_numpy(_world(batch=2, dt=np.complex64))
    v = x
    for _, fn in stages:
        v = fn(v)
    assert torch.equal(v, plan(x))


@pytest.mark.parametrize("kind,grid,batch,dt,kw", [
    ("c2c", 8, 2, np.complex64, {}),
    ("c2c", (2, 4), 3, np.complex128, dict(algorithm="ppermute")),
    ("c2c", None, 2, np.complex64, {}),
    ("c2c", 8, 2, np.complex64, dict(wire_dtype="bf16")),
    ("r2c", 8, 3, np.complex64, {}),
    ("r2c", (2, 4), 2, np.complex128, dict(direction=1)),
])
def test_batch_matches_jax(kind, grid, batch, dt, kw):
    """Batched plans against the JAX package's batched plans (the codec
    shares each tile's step over the batch in both) and numpy."""
    jplanner = jdfft.plan_dft_c2c_3d if kind == "c2c" else \
        jdfft.plan_dft_r2c_3d
    tplanner = tdfft.plan_dft_c2c_3d if kind == "c2c" else \
        tdfft.plan_dft_r2c_3d
    mesh = None if grid is None else jdfft.make_mesh(grid)
    jp = jplanner(SHAPE, mesh, batch=batch, executor="pallas", dtype=dt,
                  **kw)
    tp = tplanner(SHAPE, grid, batch=batch, dtype=TORCH_DT[dt],
                  device="cpu", **kw)
    assert tp.in_shape == tuple(jp.in_shape)
    assert tp.out_shape == tuple(jp.out_shape)
    real_in = kind == "r2c" and kw.get("direction", -1) == -1
    x = _world(batch=batch, real=real_in, dt=dt)
    if kind == "r2c" and not real_in:
        x = np.stack([np.fft.rfftn(w.real) for w in x]).astype(dt)
    jy = np.asarray(jp(jnp.asarray(x)))
    ty = tp(torch.from_numpy(x)).numpy()
    assert _rel(ty, jy) <= SAME[dt]
    if kind == "c2c":
        want = np.fft.fftn(x, axes=(1, 2, 3))
    elif real_in:
        want = np.fft.rfftn(x, axes=(1, 2, 3))
    else:
        want = np.fft.irfftn(x, s=SHAPE, axes=(1, 2, 3))
    tol = TIER[dt] if "wire_dtype" not in kw else 8e-3
    assert _rel(ty, want) <= tol


def test_batched_plan_metadata_and_refusals():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 8, batch=3, device="cpu",
                                 dtype=torch.complex128)
    assert plan.batch == 3 and plan.logic.batch == 3
    assert plan.in_shape == (3,) + SHAPE
    assert plan.in_boxes[0].shape == (2, 16, 16)      # per transform
    assert "batch: 3 coalesced transforms" in plan_info(plan)
    assert plan.describe()["batch"] == 3
    mesh = jdfft.make_mesh(8)
    for bad in (0, 2.5, True, -1):
        with pytest.raises(ValueError, match="batch") as je:
            jdfft.plan_dft_c2c_3d(SHAPE, mesh, batch=bad)
        with pytest.raises(ValueError, match="batch") as te:
            tdfft.plan_dft_c2c_3d(SHAPE, 8, batch=bad, device="cpu")
        assert type(te.value) is type(je.value)
    x = torch.from_numpy(_world(dt=np.complex128))
    with pytest.raises(ValueError, match="input shape"):
        plan(x)
