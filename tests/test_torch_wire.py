"""The port's wire codecs and compressed exchange against the JAX package's.

``distributedfft_tpu_torch/parallel/exchange.py`` encodes with the same
rounding (half to even, bf16 round to nearest even) and the same f32
step expression as ``distributedfft_tpu/parallel/exchange.py``, so on
the same input its wire parts are bit for bit the JAX package's: same
mantissas, same sidecars, same shapes. The compressed C2C plans are held
against the JAX plans with the same codec on the virtual CPU mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu.parallel import exchange as jex
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel import exchange as tex

CODECS = ("bf16", "int8", "split")


def _c64(seed, shape, spread=True):
    """Standard normal complex64; with ``spread`` each index of axis 0
    gets its own magnitude (1e-3 .. 1e3), so the tiles' steps differ."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if spread:
        mag = np.logspace(-3, 3, shape[0]).reshape((-1,) + (1,) * (len(shape) - 1))
        x = x * mag
    return x.astype(np.complex64)


def _bits(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str.encode() + str(a.shape).encode() + a.tobytes()


def _torch_bits(t: torch.Tensor) -> bytes:
    """The same fingerprint for a tensor (bf16 read back as its uint16)."""
    if t.dtype == torch.bfloat16:
        a = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return np.dtype(jnp.bfloat16).str.encode() + str(a.shape).encode() \
            + a.tobytes()
    return _bits(t.numpy())


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape,tile_axis,tiles", [
    ((8, 12, 5), 1, 4),        # even tiles on a middle axis
    ((9, 12, 5), 0, 4),        # ceil tiles: 9 rows in 4 tiles of 3
    ((6, 4, 10), 2, 2),        # the last payload axis
    ((4096,), 0, 8),           # the roundtrip-error block
])
def test_encode_bit_identical_to_reference(codec, shape, tile_axis, tiles):
    x = _c64(len(shape) + tiles, shape)
    if len(shape) == 3:
        x[0] = 0                 # a tile plane of zeros: step 1.0
    mine = tex.wire_codec(codec).encode(torch.from_numpy(x),
                                        tile_axis=tile_axis, tiles=tiles)
    ref = jex.wire_codec(codec).encode(jnp.asarray(x), tile_axis=tile_axis,
                                       tiles=tiles)
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert _torch_bits(m) == _bits(r)
    back = tex.wire_codec(codec).decode(mine, torch.complex64,
                                        tile_axis=tile_axis, tiles=tiles)
    ref_back = jex.wire_codec(codec).decode(ref, jnp.complex64,
                                            tile_axis=tile_axis, tiles=tiles)
    assert _bits(back.numpy()) == _bits(ref_back)


def test_exact_pow2_matches_reference():
    k = np.arange(-140, 141, dtype=np.float32)
    mine = tex.exact_pow2(torch.from_numpy(k)).numpy()
    assert _bits(mine) == _bits(jex.exact_pow2(jnp.asarray(k)))


@pytest.mark.parametrize("levels", [127.0, 32767.0])
def test_pow2_step_matches_reference_near_powers_of_two(levels):
    """amax / levels at, just below and just above powers of two, and 0."""
    q = np.float32(2.0) ** np.arange(-20, 20, dtype=np.float32)
    amax = (q * np.float32(levels)).astype(np.float32)
    amax = np.concatenate([amax, np.nextafter(amax, 0), np.nextafter(
        amax, np.inf), [0.0]]).astype(np.float32)
    ref_fn = jex._pow2_step if levels == 127.0 else jex._pow2_step16
    mine_fn = tex._pow2_step if levels == 127.0 else tex._pow2_step16
    mine = mine_fn(torch.from_numpy(amax)).numpy()
    assert _bits(mine) == _bits(ref_fn(jnp.asarray(amax)))


def test_registry_matches_reference():
    assert tex.WIRE_DTYPES == jex.WIRE_DTYPES
    for name in CODECS:
        mine, ref = tex.wire_codec(name), jex.wire_codec(name)
        assert (mine.pair_bytes, mine.sidecar) == (ref.pair_bytes, ref.sidecar)
        assert tex.wire_itemsize(8, name) == jex.wire_itemsize(8, name)
    assert tex.wire_itemsize(8, None) == jex.wire_itemsize(8, None) == 8
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        tex.wire_codec("fp8")


@pytest.mark.parametrize("codec", CODECS)
def test_roundtrip_error_matches_reference(codec):
    assert tex.wire_roundtrip_error(torch.complex64, codec) == \
        jex.wire_roundtrip_error(jnp.complex64, codec)
    assert tex.wire_roundtrip_error(torch.complex64, None) == 0.0


def _tiled_all_to_all(blocks, split, concat):
    p = len(blocks)
    chunks = [np.split(b, p, axis=split) for b in blocks]
    return [np.concatenate([chunks[s][d] for s in range(p)], axis=concat)
            for d in range(p)]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("p,split,concat", [(2, 1, 0), (4, 0, 1)])
def test_loopback_exchange_with_wire_matches_reference(codec, p, split,
                                                       concat):
    """Encode on the split axis, ship every part, decode on the concat
    axis: the JAX codec around a numpy tiled all-to-all gives the same
    bits."""
    shape = [8, 8, 3]
    blocks = [_c64(10 * p + r, shape, spread=False) * (r + 1)
              for r in range(p)]
    got = tex.exchange([torch.from_numpy(b) for b in blocks],
                       tdfft.make_world(p), split_axis=split,
                       concat_axis=concat, wire_dtype=codec)
    jc = jex.wire_codec(codec)
    parts = [jc.encode(jnp.asarray(b), tile_axis=split, tiles=p)
             for b in blocks]
    moved = [_tiled_all_to_all([np.asarray(ps[i]) for ps in parts], split,
                               concat) for i in range(len(parts[0]))]
    for d, g in enumerate(got):
        want = jc.decode(tuple(jnp.asarray(m[d]) for m in moved),
                         jnp.complex64, tile_axis=concat, tiles=p)
        assert _bits(g.numpy()) == _bits(want)


def test_exchange_uneven_with_wire_pads_then_compresses():
    blocks = [torch.from_numpy(_c64(r, (3, 7, 2), spread=False))
              for r in range(2)]
    out = tex.exchange_uneven(blocks, tdfft.make_world(2), split_axis=1,
                              concat_axis=0, wire_dtype="split")
    assert [tuple(o.shape) for o in out] == [(6, 4, 2), (6, 4, 2)]
    assert torch.all(out[1][:, 3] == 0)       # the ceil pad decodes to zero
    with pytest.raises(TypeError, match="complex exchange payloads"):
        tex.wire_codec("int8").encode(torch.zeros(4, 4), tiles=2)


def _err_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("codec,p,shape,fuse", [
    ("bf16", 2, (64, 64, 64), False),
    ("int8", 4, (66, 70, 64), False),
    ("split", 4, (64, 64, 64), False),
    ("split", 2, (66, 70, 64), False),
    ("split", 4, (64, 64, 64), True),
    ("int8", 2, (66, 70, 64), True),
])
def test_compressed_c2c_matches_reference(codec, p, shape, fuse):
    """Forward and backward C2C with a compressed exchange against the
    JAX plan with the same codec. The two differ only where an fp32
    rounding difference before the quantizer moves a value across a
    rounding boundary (a one-level flip in a few elements), so: each
    side's error against numpy's float64 FFT agrees within 5%, and the
    L2 difference between the two is under 0.2 of the codec's own L2
    error (measured: at most 0.09). Fused, every site takes the JAX
    plan's sender and receiver routes."""
    x = testing.make_world_data(shape, np.complex64, seed=21)
    x = (x - x.mean()).astype(np.complex64)
    spec = np.fft.fftn(x.astype(np.complex128))
    mesh = jdfft.make_mesh(p)
    for direction, inp, ref in ((jdfft.FORWARD, x, spec),
                                (jdfft.BACKWARD, spec.astype(np.complex64),
                                 x)):
        jplan = jdfft.plan_dft_c2c_3d(shape, mesh, direction=direction,
                                      executor="pallas", dtype=jnp.complex64,
                                      wire_dtype=codec, fuse=fuse)
        tplan = tdfft.plan_dft_c2c_3d(shape, p, direction=direction,
                                      device="cpu", wire_dtype=codec,
                                      fuse=fuse)
        assert tplan.wire_dtype == codec and tplan.graph.wire_dtype == codec
        want = np.asarray(jplan(inp))
        got = tplan(torch.from_numpy(inp)).numpy()
        for err in (testing.rel_error, _err_l2):
            assert abs(err(got, ref) - err(want, ref)) <= 0.05 * err(want, ref)
        assert _err_l2(got, want) <= 0.2 * _err_l2(want, ref)
        jfu, tfu = jplan.graph.meta["fusion"], tplan.graph.meta["fusion"]
        assert tfu["active"] == jfu["active"] == fuse
        assert tfu["sites"] == jfu["sites"]


def test_single_device_plan_drops_the_codec():
    plan = tdfft.plan_dft_c2c_3d((64, 64, 64), device="cpu",
                                 wire_dtype="int8")
    assert plan.decomposition == "single" and plan.wire_dtype is None
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        tdfft.plan_dft_c2c_3d((64, 64, 64), 2, device="cpu",
                              wire_dtype="fp8")
