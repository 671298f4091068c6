"""The port's fusion tier against the JAX package's.

- The fused kernels' plain versions (``ops/cuda_fuse.py``) against the
  Pallas kernel bodies of ``distributedfft_tpu/ops/pallas_fuse.py``, run
  in interpret mode outside ``shard_map`` as ``tests/test_a2q_fusion.py``
  runs them.
- The kernel gate's reasons, the graph gate's reasons, and the
  sender/receiver route of every fused site against the JAX plans'
  ``graph.meta["fusion"]``.
- The real-to-complex plans (exact and compressed, fused and unfused,
  P in {2, 4}, an even and an uneven shape) against
  ``plan_dft_r2c_3d(..., executor="pallas")`` on the virtual CPU mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu.ops import executors as jex
from distributedfft_tpu.ops import pallas_fft, pallas_fuse
from distributedfft_tpu.parallel.exchange import wire_codec as jwire
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, cuda_fuse, executors as tex
from distributedfft_tpu_torch.parallel.exchange import wire_codec as twire
from distributedfft_tpu_torch.stagegraph import (StageGraph, local_node,
                                                 plan_fusion)

SAME_MATH = 1e-5                       # fp32-level rounding on both sides
C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
# The codec bounds of tests/test_a2q_fusion.py (_ENC_BOUNDS): the decoded
# fused encode against the unfused one, relative to max |FFT|.
ENC_BOUNDS = {"bf16": 8e-3, "int8": 2e-2, "split": 2e-4}
CODECS = tuple(cuda_fuse.FUSABLE_CODECS)


def _c64(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _np(t):
    """A wire part as numpy (bf16 widened to float32 exactly)."""
    if isinstance(t, torch.Tensor):
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


# --------------------------------------------------------- kernel gate

@pytest.mark.parametrize("args", [
    ((8, 64), 1, 1, 4, "split"),
    ((8, 64), 1, 1, 4, "nope"),
    ((8, 64), 1, 1, 4, "split", "c128"),
    ((8, 0), 1, 1, 4, "split"),
    ((8, 64), 1, 0, 4, "split"),
    ((8, 24), 1, 1, 4, "split"),
    ((8, 64), 1, 1, 5, "split"),
    ((64, 6, 5), 0, 0, 4, "bf16"),
    ((64, 6, 5), -3, 0, 4, "int8"),
])
def test_kernel_ineligible_matches_reference(args):
    shape, fa, ta, tiles, codec = args[:5]
    wide = len(args) > 5
    mine = cuda_fuse.kernel_ineligible(
        shape, fa, ta, tiles, torch.complex128 if wide else torch.complex64,
        codec)
    ref = pallas_fuse.kernel_ineligible(
        shape, fa, ta, tiles, jnp.complex128 if wide else jnp.complex64, codec)
    assert mine == ref


def test_kernel_gate_drops_vmem():
    """The one recorded difference: a block above the TPU kernel's
    524288-element VMEM bound is refused by JAX (``vmem``) and taken by
    the port's kernels."""
    args = ((512, 32, 257), 0, 0, 4, "split")
    assert pallas_fuse.kernel_ineligible(*args[:4], jnp.complex64,
                                         args[4]) == "vmem"
    assert cuda_fuse.kernel_ineligible(*args[:4], torch.complex64,
                                       args[4]) is None


# ------------------------------------- plain versions vs Pallas bodies

# (shape, axis, tiles): the last axis, axis 0, a middle axis; 36 columns
# at axis 0 (odd columns); and 96 = 8.4.3, a length of the radix route
# that is no power of two, in 3 tiles: each butterfly of the last stage
# (stride 32) writes one output into each tile.
SITES = [((8, 64), 1, 4), ((64, 6, 5), 0, 4), ((3, 64, 5), 1, 2),
         ((64, 4, 9), 0, 4), ((2, 96, 5), 1, 3)]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", SITES)
def test_fused_encode_matches_pallas_body(codec, forward, shape, axis, tiles):
    """Sidecars bit-identical; mantissas at most one level apart (the two
    transforms differ in fp32 rounding before the quantizer: a value on a
    rounding boundary can land on either side); the decoded payloads
    within the codec's bound."""
    x = _c64(len(shape) * 10 + tiles, shape)
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    before = cuda_fuse.launches()
    mine = cuda_fuse.fused_fft_encode(torch.from_numpy(x), **kw)
    assert cuda_fuse.launches() == before        # the CPU runs the plain one
    ref = pallas_fuse.fused_fft_encode(jnp.asarray(x), **kw)
    assert [tuple(m.shape) for m in mine] == [tuple(r.shape) for r in ref]
    assert mine[0].dtype == {"bf16": torch.bfloat16, "int8": torch.int8,
                             "split": torch.int16}[codec]
    q, qr = _np(mine[0]), _np(ref[0])
    if codec == "bf16":
        # One bf16 level at each value, plus the fp32 difference of the
        # two transforms before the cast (which is all there is near 0).
        assert np.all(np.abs(q - qr) <= 2.0 ** -8 * (np.abs(q) + np.abs(qr))
                      + 1e-6 * np.max(np.abs(qr)))
    else:
        assert np.max(np.abs(q.astype(np.int32) - qr.astype(np.int32))) <= 1
        assert np.array_equal(_np(mine[1]).view(np.uint32),
                              _np(ref[1]).view(np.uint32))
    fft = np.asarray(pallas_fft.fft_along_axis(jnp.asarray(x), axis,
                                               forward=forward))
    got = twire(codec).decode(mine, torch.complex64, tile_axis=axis,
                              tiles=tiles).numpy()
    want = np.asarray(jwire(codec).decode(ref, jnp.complex64, tile_axis=axis,
                                          tiles=tiles))
    assert np.max(np.abs(got - want)) / np.max(np.abs(fft)) <= ENC_BOUNDS[codec]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", SITES)
def test_fused_encode_plain_is_the_codec_on_fft_axis0_plain(codec, forward,
                                                            shape, axis,
                                                            tiles):
    """The invariant the card's bit-equality rests on: the encode's plain
    version is the codec's encode of ``fft_axis0_plain`` on the strided
    view [lead, n, cols], payload and sidecar bit for bit (the card's
    kernel runs ``fft_axis0``'s column pass and encodes what it
    produces)."""
    x = torch.from_numpy(_c64(len(shape) * 10 + tiles + 2, shape))
    lead, n = int(np.prod(shape[:axis])), shape[axis]
    y = cuda_fft.fft_axis0_plain(x.reshape(lead, n, -1).contiguous(),
                                 forward).reshape(shape)
    want = twire(codec).encode(y, tile_axis=axis, tiles=tiles)
    got = cuda_fuse.fused_fft_encode_plain(
        x, fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
        wire_dtype=codec)
    assert len(got) == len(want)
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", SITES)
def test_fused_decode_matches_pallas_body(codec, forward, shape, axis, tiles):
    """The unpack is exact on both sides, so the outputs agree to fp32
    rounding of the same four-step sums."""
    y = _c64(len(shape) * 10 + tiles + 1, shape)
    parts = jwire(codec).encode(jnp.asarray(y), tile_axis=axis, tiles=tiles)
    tparts = tuple(torch.from_numpy(np.asarray(p).astype(np.float32))
                   .to(torch.bfloat16) if codec == "bf16" and i == 0
                   else torch.from_numpy(np.array(p))
                   for i, p in enumerate(parts))
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    got = cuda_fuse.fused_decode_fft(tparts, torch.complex64, **kw)
    want = np.asarray(pallas_fuse.fused_decode_fft(parts, jnp.complex64, **kw))
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    assert testing.rel_error(got.numpy(), want) <= SAME_MATH


@pytest.mark.parametrize("tile_axis,tiles,reason", [(1, 3, "uneven_tiles"),
                                                    (0, 2, "tile_axis")])
def test_gate_fallback_is_counted_and_unfused(tile_axis, tiles, reason):
    """A site the kernels do not take runs the unfused executor and codec
    (the same values) and is counted by (site, reason)."""
    x = torch.from_numpy(_c64(3, (4, 64)))
    kw = dict(fft_axis=1, forward=True, tile_axis=tile_axis, tiles=tiles,
              wire_dtype="split")
    key = ("t9", reason)
    before = cuda_fuse.FUSION_FALLBACKS[key]
    parts = cuda_fuse.fused_fft_encode(x, site="t9", **kw)
    assert cuda_fuse.FUSION_FALLBACKS[key] == before + 1
    ref = twire("split").encode(tex.get_executor("cuda")(x, (1,), True),
                                tile_axis=tile_axis, tiles=tiles)
    assert all(torch.equal(a, b) for a, b in zip(parts, ref))
    back = cuda_fuse.fused_decode_fft(parts, torch.complex64, site="t9",
                                      **kw)
    assert cuda_fuse.FUSION_FALLBACKS[key] == before + 2
    assert back.shape == x.shape


# ------------------------------------------------------ labels, gates

def test_fuse_label_algebra_matches_reference():
    port = lambda s: s.replace("pallas", "cuda")
    for label in ("pallas", "pallas:fuse"):
        mine = tex.split_fuse(port(label))
        ref = jex.split_fuse(label)
        assert mine == (port(ref[0]), ref[1])
        assert tex.fused_name(port(label), True) == port(
            jex.fused_name(label, True))
    for bad in ("cuda:fuse:fuse", "xla:fuse"):
        with pytest.raises(ValueError):
            tex.split_fuse(bad)
    with pytest.raises(ValueError, match="pins the fuse flag"):
        tdfft.plan_dft_c2c_3d((64, 64, 64), 2, executor="cuda:fuse",
                              fuse=False, device="cpu")
    plan = tdfft.plan_dft_c2c_3d((64, 64, 64), 2, fuse=True, device="cpu")
    assert plan.executor == "cuda:fuse"


def test_graph_gates_match_reference():
    """Fusion asked for without a codec gates off with ``no_wire_codec``
    (as the JAX plan records it); a graph without an exchange with
    ``no_exchange``; each counted with site ``graph``."""
    shape = (64, 64, 64)
    jplan = jdfft.plan_dft_c2c_3d(shape, jdfft.make_mesh(2),
                                  executor="pallas", dtype=jnp.complex64,
                                  fuse=True)
    tplan = tdfft.plan_dft_c2c_3d(shape, 2, fuse=True, device="cpu")
    ref = jplan.graph.meta["fusion"]
    mine = tplan.graph.meta["fusion"]
    for key in ("requested", "active", "reasons"):
        assert mine[key] == ref[key]
    assert mine["reasons"] == ("no_wire_codec",)
    before = cuda_fuse.FUSION_FALLBACKS[("graph", "no_exchange")]
    lonely = StageGraph(world=tdfft.make_world(2), executor="cuda:fuse",
                        wire_dtype="split",
                        nodes=(local_node("t0", "t0_fft_z",
                                          ("fft", (2,), True)),))
    info = plan_fusion(lonely)
    assert info["requested"] and not info["active"]
    assert info["reasons"] == ("no_exchange",)
    assert cuda_fuse.FUSION_FALLBACKS[("graph", "no_exchange")] == before + 1
    assert not plan_fusion(tdfft.plan_dft_c2c_3d(
        shape, 2, wire_dtype="split", device="cpu").graph)["requested"]


# ------------------------------------------------------- real plans

def _l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _describe(plan):
    """A JAX plan's geometry and routing as plain values."""
    box = lambda b: (tuple(b.low), tuple(b.high))
    desc = dict(shape=plan.shape,
                world_size=1 if plan.mesh is None else plan.mesh.size,
                direction=plan.direction, dtype=str(np.dtype(plan.dtype)),
                kind="r2c" if plan.real else "c2c",
                wire_dtype=plan.options.wire_dtype, executor=plan.executor,
                in_boxes=[box(b) for b in plan.in_boxes],
                out_boxes=[box(b) for b in plan.out_boxes])
    if plan.graph is not None:
        desc["fusion"] = plan.graph.meta["fusion"]
    return desc


# A covering set of (codec, fuse, P, shape): every codec fused and not,
# both world sizes, the even shape (every site on a kernel) and the
# uneven one (the uneven_pack and ops routes at P = 4).
REAL_CASES = [
    (None, False, 2, (64, 64, 128)),
    (None, True, 4, (66, 70, 128)),
    ("bf16", True, 4, (64, 64, 128)),
    ("bf16", False, 2, (66, 70, 128)),
    ("int8", True, 2, (66, 70, 128)),
    ("int8", False, 4, (64, 64, 128)),
    ("split", True, 4, (66, 70, 128)),
    ("split", True, 2, (64, 64, 128)),
    ("split", False, 4, (64, 64, 128)),
]


@pytest.mark.parametrize("codec,fuse,p,shape", REAL_CASES)
def test_real_plans_match_reference(codec, fuse, p, shape):
    """R2C forward and C2R backward against the JAX plans. Exact plans
    agree to 1e-5 (fp32-level rounding of the same transforms: the
    four-step sums on both sides, or the radix route's stages on ours).
    Compressed plans differ from the JAX ones only by one-level flips
    where an fp32 rounding difference moved a value across a quantizer
    boundary: each side's
    error against numpy's float64 transform agrees within 5%, and their
    L2 difference is under 0.2 of the codec's own L2 error (measured: at
    most 0.09). The fused plan gives exactly the unfused plan's values
    (the kernels' plain versions run the executor's sums), and its sites
    take the JAX plan's routes."""
    x = testing.make_world_data(shape, np.float32, seed=31)
    x = (x - x.mean()).astype(np.float32)
    spec = np.fft.rfftn(x.astype(np.float64))
    mesh = jdfft.make_mesh(p)
    for direction, inp, ref in ((jdfft.FORWARD, x, spec),
                                (jdfft.BACKWARD, spec.astype(np.complex64),
                                 x)):
        kw = dict(direction=direction, wire_dtype=codec, fuse=fuse)
        jplan = jdfft.plan_dft_r2c_3d(shape, mesh, executor="pallas",
                                      dtype=jnp.complex64, **kw)
        tplan = tdfft.plan_dft_r2c_3d(shape, p, device="cpu", **kw)
        assert tplan.kind == "r2c" and tplan.executor == (
            "cuda:fuse" if fuse else "cuda")
        assert tplan.describe()["in_boxes"] == _describe(jplan)["in_boxes"]
        assert tplan.describe()["out_boxes"] == _describe(jplan)["out_boxes"]
        assert [n.name for n in tplan.graph.nodes] == [
            n.name for n in jplan.graph.nodes]
        want = np.asarray(jplan(inp))
        got = tplan(torch.from_numpy(inp))
        assert got.dtype == tplan.out_dtype
        assert tuple(got.shape) == tplan.out_shape == want.shape
        got = got.numpy()
        if codec is None:
            assert testing.rel_error(got, want) <= SAME_MATH
            assert testing.rel_error(got, ref) <= C64
        else:
            for err in (testing.rel_error, _l2):
                assert abs(err(got, ref) - err(want, ref)) <= \
                    0.05 * err(want, ref)
            assert _l2(got, want) <= 0.2 * _l2(want, ref)
        jfu, tfu = jplan.graph.meta["fusion"], tplan.graph.meta["fusion"]
        for key in ("requested", "active", "reasons", "sites"):
            assert tfu[key] == jfu[key], key
        if fuse and codec is not None:
            plain = tdfft.plan_dft_r2c_3d(shape, p, device="cpu",
                                          direction=direction,
                                          wire_dtype=codec)
            assert np.array_equal(plain(torch.from_numpy(inp)).numpy(), got)


def test_real_single_device_matches_reference():
    shape = (64, 66, 128)
    x = testing.make_world_data(shape, np.float32, seed=7)
    jf = jdfft.plan_dft_r2c_3d(shape, None, executor="pallas",
                               dtype=jnp.complex64)
    jb = jdfft.plan_dft_c2r_3d(shape, None, executor="pallas",
                               dtype=jnp.complex64)
    tf = tdfft.plan_dft_r2c_3d(shape, device="cpu", wire_dtype="split")
    tb = tdfft.plan_dft_c2r_3d(shape, device="cpu")
    assert tf.decomposition == "single" and tf.wire_dtype is None
    got = tf(torch.from_numpy(x))
    assert testing.rel_error(got.numpy(), np.asarray(jf(x))) <= SAME_MATH
    back = tb(got)
    assert back.dtype == torch.float32 and tuple(back.shape) == shape
    assert testing.rel_error(back.numpy(), np.asarray(jb(np.asarray(jf(x))))) \
        <= SAME_MATH
    assert testing.rel_error(back.numpy(), x) <= C64


def test_half_length_the_kernels_do_not_take_raises():
    """Named for what it checked before the dft_matmul route was ported
    (planning raised): n2 = 72 packs into a half-length 36-point
    transform, below the kernels' 64-point minimum. It now runs
    dft_matmul, counted with reason ``length``, and the plans match
    JAX's pallas R2C/C2R plans, which route it the same way."""
    shape = (64, 64, 72)
    x = testing.make_world_data(shape, np.float32, seed=4)
    mesh = jdfft.make_mesh(2)
    jf = jdfft.plan_dft_r2c_3d(shape, mesh, executor="pallas",
                               dtype=jnp.complex64)
    jb = jdfft.plan_dft_c2r_3d(shape, mesh, executor="pallas",
                               dtype=jnp.complex64)
    tf = tdfft.plan_dft_r2c_3d(shape, 2, device="cpu")
    tb = tdfft.plan_dft_c2r_3d(shape, 2, device="cpu")
    before = cuda_fft.FALLBACKS[(2, "length")]
    got = tf(torch.from_numpy(x))
    assert cuda_fft.FALLBACKS[(2, "length")] == before + 2   # one per rank
    want = np.asarray(jf(x))
    assert testing.rel_error(got.numpy(), want) <= SAME_MATH
    back = tb(got).numpy()
    assert testing.rel_error(back, np.asarray(jb(want))) <= SAME_MATH
    assert testing.rel_error(back, x) <= C64


def test_odd_real_axis_promotes_and_mirrors():
    """An odd real axis takes the promote-and-slice r2c and the mirrored
    c2r (the ``_pallas_r2c`` / ``_pallas_c2r`` odd-n routes)."""
    shape = (64, 64, 65)
    x = testing.make_world_data(shape, np.float32, seed=8)
    tf = tdfft.plan_dft_r2c_3d(shape, 2, device="cpu")
    tb = tdfft.plan_dft_c2r_3d(shape, 2, device="cpu")
    got = tf(torch.from_numpy(x))
    spec = np.fft.rfftn(x.astype(np.float64))
    assert testing.rel_error(got.numpy(), spec) <= C64
    assert testing.rel_error(tb(got).numpy(), x) <= C64


def test_fused_sites_launch_on_the_expected_blocks(monkeypatch):
    """R2C forward at P = 4: the receiver decodes [64, 16, 65] blocks
    along axis 0. C2R backward: the sender encodes [64, 16, 65] blocks
    along axis 0, the receiver decodes [16, 64, 65] blocks along axis 1."""
    calls = []
    for name in ("fused_fft_encode", "fused_decode_fft"):
        real = getattr(cuda_fuse, name)

        def spy(x, *a, _real=real, _name=name, **k):
            shape = tuple((x[0] if isinstance(x, tuple) else x).shape)
            calls.append((_name, shape[:3], k["fft_axis"]))
            return _real(x, *a, **k)
        monkeypatch.setattr(cuda_fuse, name, spy)
    shape = (64, 64, 128)
    tf = tdfft.plan_dft_r2c_3d(shape, 4, wire_dtype="int8", fuse=True,
                               device="cpu")
    tb = tdfft.plan_dft_c2r_3d(shape, 4, wire_dtype="int8", fuse=True,
                               device="cpu")
    tb(tf(torch.from_numpy(testing.make_world_data(shape, np.float32))))
    assert calls == (
        [("fused_decode_fft", (64, 16, 65), 0)] * 4
        + [("fused_fft_encode", (64, 16, 65), 0)] * 4
        + [("fused_decode_fft", (16, 64, 65), 1)] * 4)


@pytest.mark.parametrize("kind,codec,fuse", [("r2c", "split", True),
                                             ("c2c", "int8", False),
                                             ("c2c", None, True)])
def test_plan_from_reference_kind_wire_fusion(kind, codec, fuse):
    shape = (64, 64, 128)
    planner = jdfft.plan_dft_r2c_3d if kind == "r2c" else jdfft.plan_dft_c2c_3d
    jplan = planner(shape, jdfft.make_mesh(4), executor="pallas",
                    dtype=jnp.complex64, wire_dtype=codec, fuse=fuse,
                    direction=jdfft.BACKWARD)
    desc = _describe(jplan)
    plan = tdfft.plan_from_reference(desc, device="cpu")
    assert (plan.kind, plan.wire_dtype, plan.direction) == (
        kind, codec, jdfft.BACKWARD)
    assert plan.executor == desc["executor"].replace("pallas", "cuda")
    bad = dict(desc, fusion=dict(desc["fusion"],
                                 active=not desc["fusion"]["active"]))
    with pytest.raises(ValueError, match="fusion differs"):
        tdfft.plan_from_reference(bad, device="cpu")
    # JAX's xla executor is the port's torch one; xla_minor has no port
    bare = {k: v for k, v in desc.items() if k != "fusion"}
    assert tdfft.plan_from_reference(
        dict(bare, executor="xla"), device="cpu").executor == "torch"
    with pytest.raises(ValueError, match="no port counterpart"):
        tdfft.plan_from_reference(dict(bare, executor="xla_minor"),
                                  device="cpu")
