"""The plane kernel (1) and the fused encode and decode kernels (4, 5) on
the generic prime stage, on the CPU.

Every eligible plane and every eligible fused length n <= 8192 takes the
radix route (``cuda_fft.route2d``, ``cuda_fuse.fused_route``), a prime
factor from 19 to 251 as a stage of ``csrc/radix.cuh:generic_stage``;
past 8192 the fused kernels take the two-pass route, as the strided
kernel does. On CPU tensors
the wrappers run the plain versions of that route. These tests check the
routes at 76 = 4*19, 361 = 19*19 and 608 = 8.4.19; the plain versions
against the JAX package's Pallas bodies run in interpret mode (the fused
ones outside ``shard_map``, as ``tests/test_torch_fuse.py`` runs them):
the decode within the complex64 tier (5e-4), the encode's mantissas one
level apart at most, its sidecars bit for bit and its decoded payload
within the codec's own bound of ``tests/test_a2q_fusion.py``; the plane
within 1e-5 of JAX (fp32 rounding on both sides) and 5e-4 of numpy; and
a slab plan at [76, 64, 64] on 4 ranks with the ``split`` and ``bf16``
wires, fused against unfused, equal bit for bit (both run the same radix
stages on the same values) and within the tier (relative L2) of the JAX
``pallas`` plans on the 8-device CPU mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu.ops import pallas_fft, pallas_fuse
from distributedfft_tpu.parallel.exchange import wire_codec as jwire
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, cuda_fuse, radix
from distributedfft_tpu_torch.parallel.exchange import wire_codec as twire

C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
SAME_MATH = 1e-5                       # fp32-level rounding on both sides
# The codec bounds of tests/test_a2q_fusion.py (_ENC_BOUNDS): a decoded
# payload against the other package's, relative to max |FFT|.
ENC_BOUNDS = {"bf16": 8e-3, "int8": 2e-2, "split": 2e-4}
CODECS = tuple(cuda_fuse.FUSABLE_CODECS)
# (shape, axis, tiles) of the fused sites: 608 along axis 0 (cols > 1),
# 361 along a middle axis (two generic stages in a row, one tile: 19
# does not divide into even tiles of 361 / 2), 76 along the last axis
# (cols = 1).
SITES = [((608, 3), 0, 4), ((2, 361, 3), 1, 1), ((3, 76), 1, 4)]


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


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("ny,nz", [(608, 608), (512, 608), (76, 64),
                                   (361, 64)])
def test_planes_off_the_smooth_lengths_take_the_radix_route(ny, nz):
    assert cuda_fft.eligible2d(ny, nz)
    assert cuda_fft.route2d(ny, nz) == cuda_fft.route2d(nz, ny) == "radix"
    assert any(radix.is_generic(r) for n in (ny, nz)
               for r in radix.radix_plan(n))


@pytest.mark.parametrize("n", [76, 361, 608, 8032, 9728, 12482])
def test_fused_route_follows_the_strided_kernel_up_to_8192(n):
    """The fused kernels take the route ``fft_axis0`` takes, the radix
    route up to 8192 and the two-pass route past it (the name is the
    test's own from before they had the two-pass route)."""
    how = cuda_fft.route(n)
    assert how == ("radix" if n <= 8192 else "radix2")
    assert cuda_fuse.fused_route(n) == how


def test_plane_with_an_axis_past_8192_is_refused():
    """No plane route takes an axis past 8192 (``eligible2d`` never sends
    one to the plane kernel; called directly, it raises)."""
    x = torch.zeros((1, 64, 9728), dtype=torch.complex64)
    assert cuda_fft.route2d(64, 9728) == "direct"
    with pytest.raises(ValueError):
        cuda_fft.fft2_last(x)


# ----------------------------------------------- plain versions vs JAX

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", SITES)
def test_fused_encode_plain_matches_pallas_body(codec, forward, shape, axis,
                                                tiles):
    x = _c64(sum(shape) + tiles, shape)
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    mine = cuda_fuse.fused_fft_encode(torch.from_numpy(x), **kw)
    ref = pallas_fuse.fused_fft_encode(jnp.asarray(x), **kw)
    assert [tuple(m.shape) for m in mine] == [tuple(r.shape) for r in ref]
    q, qr = _np(mine[0]), _np(ref[0])
    if codec == "bf16":
        # one bf16 level at each value, plus the fp32 difference of the
        # two transforms before the cast (all there is near 0)
        assert np.all(np.abs(q - qr) <= 2.0 ** -8 * (np.abs(q) + np.abs(qr))
                      + 1e-6 * np.max(np.abs(qr)))
    else:
        assert np.max(np.abs(q.astype(np.int32) - qr.astype(np.int32))) <= 1
        assert np.array_equal(_np(mine[1]).view(np.uint32),
                              _np(ref[1]).view(np.uint32))
    fft = (np.fft.fft if forward else np.fft.ifft)(
        x.astype(np.complex128), axis=axis)
    got = twire(codec).decode(mine, torch.complex64, tile_axis=axis,
                              tiles=tiles).numpy()
    want = np.asarray(jwire(codec).decode(ref, jnp.complex64, tile_axis=axis,
                                          tiles=tiles))
    assert np.max(np.abs(got - want)) / np.max(np.abs(fft)) <= ENC_BOUNDS[codec]
    assert np.max(np.abs(got - fft)) / np.max(np.abs(fft)) <= ENC_BOUNDS[codec]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", SITES)
def test_fused_decode_plain_matches_pallas_body(codec, forward, shape, axis,
                                                tiles):
    """The unpack is exact on both sides: the outputs agree to the
    complex64 tier, and the port's is ``fft_axis0_plain`` of the decoded
    wire on the radix route, bit for bit."""
    y = _c64(sum(shape) + tiles + 1, shape)
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
    assert testing.rel_error(got.numpy(), want) <= C64
    dec = twire(codec).decode(tparts, torch.complex64, tile_axis=axis,
                              tiles=tiles)
    lead, n = int(np.prod(shape[:axis])), shape[axis]
    twin = cuda_fft.fft_axis0_plain(dec.reshape(lead, n, -1).contiguous(),
                                    forward).reshape(shape)
    assert torch.equal(got, twin)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("b,ny,nz", [(1, 608, 608), (1, 512, 608),
                                     (3, 76, 64), (2, 361, 76)])
def test_fft2_last_plain_matches_pallas_plane_kernel(b, ny, nz, forward):
    """The plane's plain version runs the radix stages of both axes (the
    generic stage on 19, twice on 361) and holds 1e-5 of JAX's
    ``fft2_last`` in interpret mode (its four-step sums) and the
    complex64 tier of numpy's float64 ``fft2``."""
    x = _c64(ny + nz + b, (b, ny, nz))
    got = cuda_fft.fft2_last(torch.from_numpy(x), forward)
    want = np.asarray(pallas_fft.fft2_last(jnp.asarray(x), forward))
    assert got.shape == want.shape
    assert testing.rel_error(got.numpy(), want) < SAME_MATH
    ref = (np.fft.fft2 if forward else np.fft.ifft2)(x.astype(np.complex128))
    assert testing.rel_error(got.numpy(), ref) < C64


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("codec", ["split", "bf16"])
def test_fused_slab_plans_equal_their_unfused_twins(codec):
    """A slab plan at [76, 64, 64] on 4 ranks: the forward's receiver is
    the fused decode along X (length 76, on the generic stage), the
    backward's along Y. Fused and unfused run the same radix stages on
    the same exactly decoded values, so their outputs are equal bit for
    bit both ways; each holds the complex64 tier (relative L2) of the
    JAX ``pallas`` plan with the same wire and fusion, and is as accurate
    against the exact transform as that plan, within 10% (the repo's rule
    for a compressed plan against its reference)."""
    shape = (76, 64, 64)
    x = testing.make_world_data(shape, np.complex64, seed=11)
    mesh = jdfft.make_mesh(4)
    for d, td in ((jdfft.FORWARD, tdfft.FORWARD),
                  (jdfft.BACKWARD, tdfft.BACKWARD)):
        fused = tdfft.plan_dft_c2c_3d(shape, 4, direction=td,
                                      wire_dtype=codec, fuse=True,
                                      device="cpu")
        unfused = tdfft.plan_dft_c2c_3d(shape, 4, direction=td,
                                        wire_dtype=codec, device="cpu")
        got = fused(torch.from_numpy(x))
        sites = fused.graph.meta["fusion"]["sites"].values()
        assert [s["receiver"] for s in sites] == ["kernel"]
        assert torch.equal(got, unfused(torch.from_numpy(x)))
        jp = jdfft.plan_dft_c2c_3d(shape, mesh, direction=d,
                                   executor="pallas", wire_dtype=codec,
                                   fuse=True)
        want = np.asarray(jp(x))
        assert _rel_l2(got.numpy(), want) <= C64
        ref = (np.fft.fftn if d == jdfft.FORWARD else np.fft.ifftn)(
            x.astype(np.complex128))
        assert _rel_l2(got.numpy(), ref) <= 1.1 * _rel_l2(want, ref)
