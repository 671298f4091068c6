"""The port's spectral operators against the JAX package's.

The same seeded inputs through ``distributedfft_tpu.operators
.plan_spectral_op`` on the 8-device CPU mesh (``tests/conftest.py``) and
through ``distributedfft_tpu_torch.operators.plan_spectral_op`` on a
loopback world of the same shape: the ``pallas`` executor (interpret
mode) against the port's ``cuda`` one at complex64, ``xla`` against
``torch`` at complex128. The port's op is built from the JAX op by
``op_from_reference`` (a ``custom`` op by hand on each side).

- Every op (``chain`` against ``biharmonic``, ``helmholtz(0)``,
  ``gradient`` on each axis, an asymmetric ``custom`` multiplier, a delta
  and an off-centre ``convolve``) on the slab world, even and uneven,
  both dtypes: within 1e-5 (c64) / 1e-12 (c128) of JAX, and within the
  tiers (5e-4, 1e-11) of the unfused composition (forward plan, the
  full multiplier, backward plan) on each side.
- Slab (P = 2, 4), pencil (2x2) and the hierarchical 2x2 hybrid world
  under every transport at K = 1 and 2, the single device, and
  ``batch=3``: against JAX, and bit for bit against the port's own
  ``alltoall``, K = 1, unbatched plan.
- ``wire_dtype`` bf16 and split, fused and unfused: fused equal to
  unfused bit for bit, the fusion sites equal to JAX's, the error against
  the exact plan within 10% of the JAX plan's.
"""

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import operators as top
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world

SHAPE = (16, 16, 16)
UNEVEN = (12, 10, 9)
SAME = {np.complex64: 1e-5, np.complex128: 1e-12}
TIER = {np.complex64: 5e-4, np.complex128: 1e-11}
TDT = {np.complex64: torch.complex64, np.complex128: torch.complex128}
JEX = {np.complex64: "pallas", np.complex128: "xla"}
PEX = {np.complex64: "cuda", np.complex128: "torch"}


def _x(shape, dtype, seed=7, batch=None):
    rng = np.random.default_rng(seed)
    full = tuple(shape) if batch is None else (batch,) + tuple(shape)
    return (rng.standard_normal(full)
            + 1j * rng.standard_normal(full)).astype(dtype)


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(got) - ref))
                 / max(float(np.max(np.abs(ref))), 1e-300))


def _jax_world(key):
    import jax
    from jax.sharding import Mesh

    import distributedfft_tpu as jdfft

    if key is None:
        return None
    if key == "hier":
        return Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("dcn", "ici"))
    return jdfft.make_mesh(key)


def _port_world(key):
    if key == "hier":
        return make_world((2, 2), HYBRID_AXES)
    return key


def _kernel(shape, where, weight=1.0):
    k = np.zeros(shape)
    for idx, w in zip(where, (1.0, weight)):
        k[idx] = w
    return k


def _ops(shape):
    """(label, JAX op, port op) of every operator case on ``shape``; the
    asymmetric custom multiplier in float64 on both sides."""
    from distributedfft_tpu import operators as jop

    asym_j = jop.custom("asym", lambda i0, i1, i2: (
        (i1 + 1.0) * (1.0 + 0.125 * i2) + 0.5j * i0))
    asym_t = top.custom("asym", lambda i0, i1, i2: (
        (i1.double() + 1.0) * (1.0 + 0.125 * i2.double())
        + 0.5j * i0.double()))
    off = _kernel(shape, [(1, 3, 2), (0, 2, 5)], 0.5)
    delta = _kernel(shape, [(0, 0, 0)])
    jops = [("poisson", jop.poisson()), ("biharmonic", jop.biharmonic()),
            ("helmholtz2.5", jop.helmholtz(2.5)),
            ("helmholtz0", jop.helmholtz(0.0)),
            ("gradient0", jop.gradient(0)), ("gradient1", jop.gradient(1)),
            ("gradient2", jop.gradient(2)), ("gaussian", jop.gaussian(0.3)),
            ("delta", jop.convolve(delta)), ("offcentre", jop.convolve(off)),
            ("chain", jop.chain([jop.gaussian(0.4), jop.gradient(1)]))]
    return ([(lbl, j, top.op_from_reference(j)) for lbl, j in jops]
            + [("asym", asym_j, asym_t)])


OP_LABELS = ["poisson", "biharmonic", "helmholtz2.5", "helmholtz0",
             "gradient0", "gradient1", "gradient2", "gaussian", "delta",
             "offcentre", "chain", "asym"]


def _op(label, shape):
    return next((j, t) for lbl, j, t in _ops(shape) if lbl == label)


def _jax_plan(shape, key, op, dtype, **kw):
    import jax.numpy as jnp

    from distributedfft_tpu import operators as jop

    jdt = jnp.complex64 if dtype == np.complex64 else jnp.complex128
    return jop.plan_spectral_op(shape, _jax_world(key), op=op, dtype=jdt,
                                executor=kw.pop("executor", JEX[dtype]),
                                **kw)


def _port_plan(shape, key, op, dtype, **kw):
    return top.plan_spectral_op(shape, _port_world(key), op=op,
                                dtype=TDT[dtype], device="cpu",
                                executor=kw.pop("executor", PEX[dtype]),
                                **kw)


def _port_unfused(shape, key, op, x, dtype):
    """Forward plan, the whole multiplier, backward plan, in the port."""
    kw = dict(dtype=TDT[dtype], device="cpu", executor=PEX[dtype])
    world = _port_world(key)
    alg = "hierarchical" if key == "hier" else "alltoall"
    fwd = tdfft.plan_dft_c2c_3d(shape, world, algorithm=alg, **kw)
    bwd = tdfft.plan_dft_c2c_3d(shape, world, algorithm=alg,
                                direction=tdfft.BACKWARD, **kw)
    m = top.multiplier_grid(op, shape, TDT[dtype], device="cpu")
    m = m.to(TDT[dtype] if m.is_complex()
             else tdfft.api.REAL_DTYPE[TDT[dtype]])
    return bwd(m * fwd(torch.from_numpy(x))).numpy()


def _jax_unfused(shape, key, op, x, dtype):
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft
    from distributedfft_tpu import operators as jop

    jdt = jnp.complex64 if dtype == np.complex64 else jnp.complex128
    mesh = _jax_world(key)
    fwd = jdfft.plan_dft_c2c_3d(shape, mesh, dtype=jdt, executor=JEX[dtype])
    bwd = jdfft.plan_dft_c2c_3d(shape, mesh, dtype=jdt, executor=JEX[dtype],
                                direction=jdfft.BACKWARD)
    m = np.asarray(jop.multiplier_grid(op, shape, jdt))
    return np.asarray(bwd(m * np.asarray(fwd(x))))


# ------------------------------------------------------- every operator

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("label", OP_LABELS)
def test_every_op_matches_jax(label, dtype):
    """Slab P = 4 at (16, 16, 16): the port's op plan within SAME of the
    JAX plan, within the tier of its own unfused composition, the JAX
    plan within the tier of its own."""
    jop, op = _op(label, SHAPE)
    x = _x(SHAPE, dtype)
    got = _port_plan(SHAPE, 4, op, dtype)(torch.from_numpy(x))
    assert got.dtype == TDT[dtype] and tuple(got.shape) == SHAPE
    want = np.asarray(_jax_plan(SHAPE, 4, jop, dtype)(x))
    assert _rel(got.numpy(), want) < SAME[dtype]
    assert _rel(got.numpy(), _port_unfused(SHAPE, 4, op, x, dtype)) \
        < TIER[dtype]
    if label in ("gradient1", "asym", "offcentre"):
        assert _rel(want, _jax_unfused(SHAPE, 4, jop, x, dtype)) \
            < TIER[dtype]


@pytest.mark.parametrize("key", [4, (2, 2)])
@pytest.mark.parametrize("label", ["poisson", "gradient1", "gradient2",
                                   "asym", "offcentre"])
def test_uneven_world_matches_jax(label, key):
    """(12, 10, 9): the k1 and k2 ceil pads carry finite multiplier rows
    (convolve reads the world's edge there, as JAX's gather clamps) that
    are cropped before the inverse transforms."""
    jop, op = _op(label, UNEVEN)
    x = _x(UNEVEN, np.complex128, seed=11)
    got = _port_plan(UNEVEN, key, op, np.complex128)(torch.from_numpy(x))
    want = np.asarray(_jax_plan(UNEVEN, key, jop, np.complex128)(x))
    assert _rel(got.numpy(), want) < SAME[np.complex128]
    assert _rel(got.numpy(),
                _port_unfused(UNEVEN, key, op, x, np.complex128)) < 1e-11


def test_chain_is_biharmonic_and_composes():
    """``chain([poisson, poisson])`` is ``biharmonic`` (JAX's pin): one
    fused plan equal to the other, and a chain of gaussian and gradient
    equal to the two plans in sequence."""
    x = _x(SHAPE, np.complex128, seed=31)
    xt = torch.from_numpy(x)
    kw = dict(dtype=torch.complex128, device="cpu")
    bi = top.plan_spectral_op(SHAPE, 4, op=top.biharmonic(), **kw)(xt)
    pp = top.plan_spectral_op(SHAPE, 4, op=[top.poisson(), top.poisson()],
                              **kw)
    assert pp.op == "chain(poisson+poisson)"
    assert _rel(pp(xt).numpy(), bi.numpy()) < 1e-11
    g = top.plan_spectral_op(SHAPE, 4, op=top.gaussian(0.4), **kw)
    d = top.plan_spectral_op(SHAPE, 4, op=top.gradient(1), **kw)
    c = top.plan_spectral_op(SHAPE, 4, op=[top.gaussian(0.4),
                                           top.gradient(1)], **kw)
    assert c.op == "chain(gaussian+gradient1)"
    assert _rel(c(xt).numpy(), d(g(xt)).numpy()) < 1e-11


# ----------------------------------------- decompositions and transports

WORLD_CASES = ([(2, a) for a in ("alltoall", "alltoallv", "ppermute")]
               + [(4, a) for a in ("alltoall", "alltoallv", "ppermute")]
               + [((2, 2), a) for a in ("alltoall", "alltoallv",
                                        "ppermute")]
               + [("hier", "hierarchical")])


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("key,algorithm", WORLD_CASES,
                         ids=[f"{k}-{a}" for k, a in WORLD_CASES])
def test_worlds_and_transports_match_jax(key, algorithm, k):
    """Each decomposition, transport and K: the JAX plan's output within
    SAME at complex128 (an asymmetric multiplier, so a wrong rank or
    chunk offset shows), and the port's ``alltoall``, K = 1 plan on the
    same world bit for bit."""
    jop, op = _op("asym", SHAPE)
    x = _x(SHAPE, np.complex128, seed=3)
    plan = _port_plan(SHAPE, key, op, np.complex128, algorithm=algorithm,
                      overlap_chunks=k)
    assert (plan.algorithm, plan.overlap_chunks) == (algorithm, k)
    got = plan(torch.from_numpy(x))
    want = np.asarray(_jax_plan(SHAPE, key, jop, np.complex128,
                                algorithm=algorithm, overlap_chunks=k)(x))
    assert _rel(got.numpy(), want) < SAME[np.complex128]
    base = _port_plan(SHAPE, key, op, np.complex128,
                      algorithm=("hierarchical" if key == "hier"
                                 else "alltoall"))
    if key == "hier":       # the flat transport over the same 4 ranks
        base = _port_plan(SHAPE, 4, op, np.complex128)
    assert torch.equal(got, base(torch.from_numpy(x)))


def test_single_device_matches_jax():
    jop, op = _op("gradient2", SHAPE)
    for dtype in (np.complex64, np.complex128):
        x = _x(SHAPE, dtype, seed=5)
        plan = _port_plan(SHAPE, None, op, dtype)
        assert plan.decomposition == "single" and plan.world is None
        got = plan(torch.from_numpy(x)).numpy()
        assert _rel(got, np.asarray(_jax_plan(SHAPE, None, jop, dtype)(x))) \
            < SAME[dtype]
        assert _rel(got, _port_unfused(SHAPE, None, op, x, dtype)) \
            < TIER[dtype]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("key", [4, (2, 2), None])
def test_batch_matches_jax_and_unbatched(key, k):
    """``batch=3``: within SAME of JAX's batched plan (c64, pallas), and
    each element bit for bit the port's unbatched plan."""
    jop, op = _op("gradient0", SHAPE)
    xb = _x(SHAPE, np.complex64, seed=9, batch=3)
    plan = _port_plan(SHAPE, key, op, np.complex64, batch=3,
                      overlap_chunks=k)
    assert plan.in_shape == plan.out_shape == (3,) + SHAPE
    got = plan(torch.from_numpy(xb))
    want = np.asarray(_jax_plan(SHAPE, key, jop, np.complex64, batch=3,
                                overlap_chunks=k)(xb))
    assert _rel(got.numpy(), want) < SAME[np.complex64]
    one = _port_plan(SHAPE, key, op, np.complex64)
    for i in range(3):
        assert torch.equal(got[i], one(torch.from_numpy(xb[i])))


# ----------------------------------------------------------- wire codecs

@pytest.mark.parametrize("wire", ["bf16", "split"])
@pytest.mark.parametrize("key", [4, (2, 2)])
def test_wire_codecs_fused_and_unfused(key, wire):
    """A compressed op plan: fused equal to unfused bit for bit, its
    fusion sites JAX's routes (the slab's t_mid a ``factory`` receiver
    and its return sender ``ops``; the pencil's empty senders
    ``encode_only``), and its error against the exact plan within 10% of
    the JAX plan's (both quantize on the same grid; a value near a
    rounding edge may land one level apart)."""
    jop, op = _op("gradient1", SHAPE)
    x = _x(SHAPE, np.complex64, seed=13)
    xt = torch.from_numpy(x)
    fused = _port_plan(SHAPE, key, op, np.complex64, wire_dtype=wire,
                       fuse=True)
    unfused = _port_plan(SHAPE, key, op, np.complex64, wire_dtype=wire)
    got = fused(xt)
    assert torch.equal(got, unfused(xt))
    jfused = _jax_plan(SHAPE, key, jop, np.complex64, wire_dtype=wire,
                       fuse=True)
    want = np.asarray(jfused(x))
    jsites = jfused.fn.stage_graph.meta["fusion"]
    mine = fused.graph.meta["fusion"]
    assert (mine["requested"], mine["active"], mine["reasons"]) == (
        jsites["requested"], jsites["active"], tuple(jsites["reasons"]))
    assert mine["sites"] == dict(jsites["sites"])
    exact = _port_plan(SHAPE, key, op, np.complex128)(
        torch.from_numpy(x.astype(np.complex128))).numpy()
    err, jerr = _rel(got.numpy(), exact), _rel(want, exact)
    assert err <= 1.1 * jerr and err < (2e-2 if wire == "bf16" else 2e-4)
    assert fused.wire_dtype == wire and fused.options.wire_dtype == wire


def test_fusion_gate_records_overlap_k():
    """At K = 2 the fused flag falls back with reason ``overlap_k``, as
    in JAX, and the plan equals its unfused twin."""
    _, op = _op("gradient1", SHAPE)
    x = torch.from_numpy(_x(SHAPE, np.complex64, seed=2))
    plan = _port_plan(SHAPE, 4, op, np.complex64, wire_dtype="split",
                      fuse=True, overlap_chunks=2)
    assert plan.graph.meta["fusion"]["reasons"] == ("overlap_k",)
    twin = _port_plan(SHAPE, 4, op, np.complex64, wire_dtype="split",
                      overlap_chunks=2)
    assert torch.equal(plan(x), twin(x))
