"""The fused encode and decode kernels (4, 5) on every route and form of
their unfused twins, on the CPU.

``cuda_fuse.fused_route`` is ``cuda_fft.route`` at every length: the
radix route up to 8192 and the two-pass route (``radix2``) past it. On
it the fused kernels run their twin's passes (``csrc/fuse.cu``): the
strided kernel's, or at a last-axis site (cols = 1, the row form,
``cuda_fuse.fused_form``) the row kernel's, with the codec in the pass
that stores the transform (the encode) or reads the wire (the decode).
On CPU tensors the wrappers run the plain versions: the codec and
``cuda_fft.fft_axis0_plain`` on the route. These tests check the routes
and forms; hold the plain versions against the JAX package's Pallas
bodies in interpret mode (outside ``shard_map``, as
``tests/test_torch_fuse.py`` runs them) at 1e-5 (fp32-level rounding on
both sides: the decode's outputs, and every mantissa of the encode's
payload where the two differ, which must lie within 1e-5 of the max
|FFT| of the rounding boundary between them) and against the codec on
``fft_axis0_plain(how=route)`` bit for bit; and hold fused slab and
pencil plans with an axis past 8192 equal bit for bit to their unfused
twins and within the complex64 tier (relative L2) of the JAX ``pallas``
plans on the 8-device CPU mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu.ops import pallas_fuse
from distributedfft_tpu.parallel.exchange import wire_codec as jwire
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, cuda_fuse
from distributedfft_tpu_torch.parallel.exchange import wire_codec as twire

SAME_MATH = 1e-5                       # fp32-level rounding on both sides
C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
CODECS = tuple(cuda_fuse.FUSABLE_CODECS)
# (shape, axis) of the sites: the two-pass route with columns (a middle
# axis, axis 0) and at cols = 1 (a 2-D last axis, a 3-D last axis), and
# the radix route's row form at 76 = 4 * 19 (the generic stage).
SITES = [((2, 12288, 3), 1), ((3, 16384), 1), ((4, 4, 12288), 2),
         ((12288, 4, 4), 0), ((64, 4, 76), 2)]
TILES = (1, 4)


def _c64(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _np(t):
    """A wire part as numpy (bf16 widened to float32 exactly)."""
    if isinstance(t, torch.Tensor):
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _torch_parts(parts, codec):
    """JAX wire parts as the port's (the bf16 payload as torch.bfloat16)."""
    return tuple(torch.from_numpy(np.asarray(p).astype(np.float32))
                 .to(torch.bfloat16) if codec == "bf16" and i == 0
                 else torch.from_numpy(np.array(p))
                 for i, p in enumerate(parts))


def _strided(shape, axis):
    ax = axis % len(shape)
    return (int(np.prod(shape[:ax])), shape[ax],
            int(np.prod(shape[ax + 1:])))


def _route_plain(x: torch.Tensor, axis: int, forward: bool) -> torch.Tensor:
    """The transform the fused kernels' twin computes, as
    ``fft_axis0_plain`` on the length's route."""
    lead, n, cols = _strided(tuple(x.shape), axis)
    y = cuda_fft.fft_axis0_plain(x.reshape(lead, n, cols).contiguous(),
                                 forward, how=cuda_fft.route(n))
    return y.reshape(x.shape)


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- routes

def test_fused_route_is_the_strided_kernels_at_every_length():
    """For every kernel-eligible n <= 65536 the fused kernels take the
    route ``fft_axis0`` takes: ``radix`` up to 8192, ``radix2`` past it;
    no eligible length is left on a route of their own."""
    count = {"radix": 0, "radix2": 0}
    for n in range(64, 65537):
        if not cuda_fft.eligible(n):
            continue
        how = cuda_fuse.fused_route(n)
        assert how == cuda_fft.route(n), n
        assert how == ("radix" if n <= 8192 else "radix2"), n
        count[how] += 1
    assert count == {"radix": 4593, "radix2": 12976}


@pytest.mark.parametrize("n", [64, 76, 512, 8192, 8194, 9728, 12288, 65536])
@pytest.mark.parametrize("cols", [1, 2, 3, 64, 4096])
def test_row_form_exactly_at_one_column(n, cols):
    """A launch is counted under its route, with ``_rows`` exactly where
    the site has one column (the row form)."""
    form = cuda_fuse.fused_form(n, cols)
    assert form == cuda_fft.route(n) + ("_rows" if cols == 1 else "")
    assert form.endswith("_rows") == (cols == 1)


# ----------------------------------------------- plain versions vs JAX

def _within_same_math(q, qr, half, exact, scale):
    """Where two encodings of one value differ, each is a rounding (within
    ``half`` a level of itself: half a quantizer step, or half a bf16
    ulp) of a value within SAME_MATH * ``scale`` of the exact transform:
    only fp32-level rounding before the quantizer separates them."""
    off = q != qr
    for v in (q[off], qr[off]):
        assert np.all(np.abs(v - exact[off])
                      <= half(v) + SAME_MATH * scale)


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis", SITES)
def test_fused_encode_plain_matches_pallas_body(shape, axis, forward, codec,
                                                tiles):
    """The encode's plain version is the codec on ``fft_axis0_plain`` of
    the route, bit for bit, and agrees with the Pallas body to fp32-level
    rounding before the quantizer: sidecars bit for bit, a payload value
    differing only where the exact transform sits within 1e-5 of the max
    |FFT| of the boundary between the two levels."""
    x = _c64(sum(shape) + tiles + forward, shape)
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    mine = cuda_fuse.fused_fft_encode(torch.from_numpy(x), **kw)
    twin = twire(codec).encode(_route_plain(torch.from_numpy(x), axis,
                                            forward),
                               tile_axis=axis, tiles=tiles)
    assert len(mine) == len(twin)
    assert all(torch.equal(m, t) for m, t in zip(mine, twin))
    ref = pallas_fuse.fused_fft_encode(jnp.asarray(x), **kw)
    assert [tuple(m.shape) for m in mine] == [tuple(r.shape) for r in ref]
    exact = (np.fft.fft if forward else np.fft.ifft)(
        x.astype(np.complex128), axis=axis)
    exact = np.stack([exact.real, exact.imag], axis=-1)
    scale = float(np.abs(exact).max())
    q, qr = _np(mine[0]).astype(np.float64), _np(ref[0]).astype(np.float64)
    if codec == "bf16":
        half = lambda v: 2.0 ** (np.floor(np.log2(np.abs(v) + 1e-300)) - 8)
        _within_same_math(q, qr, half, exact, scale)
        return
    side, side_r = _np(mine[1]), _np(ref[1])
    assert np.array_equal(side.view(np.uint32), side_r.view(np.uint32))
    step = np.broadcast_to(np.repeat(side, shape[axis] // tiles, axis=axis),
                           q.shape).astype(np.float64)
    _within_same_math(q * step, qr * step, lambda v: step[q != qr] / 2,
                      exact, scale)


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis", SITES)
def test_fused_decode_plain_matches_pallas_body(shape, axis, forward, codec,
                                                tiles):
    """The unpack is exact on both sides: the decode's plain version is
    ``fft_axis0_plain`` of the route on the codec's decode, bit for bit,
    and within 1e-5 of the Pallas body."""
    y = _c64(sum(shape) + tiles + 2 * forward + 1, shape)
    parts = jwire(codec).encode(jnp.asarray(y), tile_axis=axis, tiles=tiles)
    tparts = _torch_parts(parts, codec)
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    got = cuda_fuse.fused_decode_fft(tparts, torch.complex64, **kw)
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    dec = twire(codec).decode(tparts, torch.complex64, tile_axis=axis,
                              tiles=tiles)
    assert torch.equal(got, _route_plain(dec, axis, forward))
    want = np.asarray(pallas_fuse.fused_decode_fft(parts, jnp.complex64,
                                                   **kw))
    assert testing.rel_error(got.numpy(), want) <= SAME_MATH


# ------------------------------------------------------------------ plans

# (shape, world, the fused sites that run kernels past 8192): the slab's
# forward receiver decodes along X = 12288 with columns (its backward
# sender is a two-axis transform, so no kernel); the pencils' last-axis
# sites run the row form (t0_fft_z's encode, the backward's t3_fft_z
# decode) and their X sites the column pass (t3_fft_x's decode, the
# backward's t0_fft_x encode).
PLANS = [((12288, 8, 8), 4), ((8, 8, 12288), (2, 2)),
         ((12288, 8, 8), (2, 2))]


@pytest.mark.parametrize("codec", ["split", "bf16"])
@pytest.mark.parametrize("shape,world", PLANS)
def test_fused_plans_past_8192_equal_their_unfused_twins(shape, world,
                                                         codec):
    """Fused and unfused run the same passes on the same values, so their
    outputs are equal bit for bit both ways; each holds the complex64
    tier (relative L2) of the JAX ``pallas`` plan with the same wire and
    fusion, and is as accurate against the exact transform as that plan,
    within 10% (the repo's rule for a compressed plan against its
    reference)."""
    x = testing.make_world_data(shape, np.complex64, seed=12)
    mesh = jdfft.make_mesh(world)
    for d, td in ((jdfft.FORWARD, tdfft.FORWARD),
                  (jdfft.BACKWARD, tdfft.BACKWARD)):
        fused = tdfft.plan_dft_c2c_3d(shape, world, direction=td,
                                      wire_dtype=codec, fuse=True,
                                      device="cpu")
        unfused = tdfft.plan_dft_c2c_3d(shape, world, direction=td,
                                        wire_dtype=codec, device="cpu")
        got = fused(torch.from_numpy(x))
        sites = fused.graph.meta["fusion"]["sites"].values()
        assert "kernel" in [s["receiver"] for s in sites]
        assert torch.equal(got, unfused(torch.from_numpy(x)))
        jp = jdfft.plan_dft_c2c_3d(shape, mesh, direction=d,
                                   executor="pallas", wire_dtype=codec,
                                   fuse=True)
        want = np.asarray(jp(x))
        assert _rel_l2(got.numpy(), want) <= C64
        ref = (np.fft.fftn if d == jdfft.FORWARD else np.fft.ifftn)(
            x.astype(np.complex128))
        assert _rel_l2(got.numpy(), ref) <= 1.1 * _rel_l2(want, ref)
