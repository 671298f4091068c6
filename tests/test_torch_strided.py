"""The strided kernel (kernel 2) and the fused decode kernel (kernel 5) on
the radix route, on the CPU.

``cuda_fft.fft_axis0`` and ``cuda_fuse.fused_decode_fft`` choose their
route by the length alone (``cuda_fft.route``, ``cuda_fuse.fused_route``):
the radix stages of ``csrc/radix.cuh`` for every eligible n <= 8192 (a
prime factor from 19 to 251 on the generic stage), past 8192 two radix
passes, for both. On CPU tensors they run the plain version of that
route (``fft_axis0_plain``; the codec's decode, then
``fft_axis0_plain``). These tests hold the plain versions against the
JAX package's Pallas bodies in interpret mode (``pallas_fft.fft_axis0``,
``fft_along_axis`` for a leading batch, ``pallas_fuse.fused_decode_fft``)
at 1e-5 relative (fp32-level rounding on both sides, the sums in another
order) and against numpy at the complex64 tier (5e-4), and check that
each route's plain version is its passes bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedfft_tpu.ops import pallas_fft, pallas_fuse
from distributedfft_tpu.parallel.exchange import wire_codec as jwire
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, cuda_fuse, radix
from distributedfft_tpu_torch.parallel.exchange import wire_codec as twire

SAME_MATH = 1e-5                       # fp32-level rounding on both sides
C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
CODECS = tuple(cuda_fuse.FUSABLE_CODECS)


def _c64(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _err(got, want):
    return testing.rel_error(np.asarray(got), np.asarray(want))


def _rows_t(x: torch.Tensor) -> torch.Tensor:
    """[lead, n, cols] as the [lead*cols, n] rows of its columns."""
    return x.transpose(1, 2).reshape(-1, x.shape[1])


def _cols_t(y: torch.Tensor, lead: int, cols: int) -> torch.Tensor:
    return y.reshape(lead, cols, -1).transpose(1, 2).contiguous()


# ------------------------------------------------------- strided kernel

@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("cols", [1, 7, 16, 33, 257])
@pytest.mark.parametrize("lead", [1, 3])
@pytest.mark.parametrize("n", [64, 510, 512, 1024])
def test_fft_axis0_plain_matches_pallas_strided_kernel(n, lead, cols,
                                                       forward):
    """The radix route's plain version against the Pallas strided kernel:
    lead 1 through ``fft_axis0``, a leading batch through the vmap of
    ``fft_along_axis`` on axis 1 (what ``lead`` replaces)."""
    assert cuda_fft.route(n) == "radix"
    x = _c64(7 * n + 3 * lead + cols, (lead, n, cols))
    got = cuda_fft.fft_axis0(torch.from_numpy(x), forward)
    if lead == 1:
        want = np.asarray(pallas_fft.fft_axis0(jnp.asarray(x[0]), forward))
        want = want[None]
    else:
        want = np.asarray(pallas_fft.fft_along_axis(jnp.asarray(x), 1,
                                                    forward))
    assert got.shape == want.shape
    assert _err(got, want) < SAME_MATH
    ref = np.fft.fft(x, axis=1) if forward else np.fft.ifft(x, axis=1)
    assert _err(got, ref) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [64, 510, 512, 1024, 8192])
def test_fft_axis0_plain_runs_the_radix_stages(n, forward):
    """On a radix length the plain version is ``radix_plain`` on the
    columns as rows, bit for bit (and the kernel's plan is the rows')."""
    x = torch.from_numpy(_c64(n + 1, (2, n, 5)))
    want = _cols_t(radix.radix_plain(_rows_t(x), forward), 2, 5)
    if not forward:
        want = want * (1.0 / n)
    assert torch.equal(cuda_fft.fft_axis0_plain(x, forward), want)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [19 * 64, 19 * 512])
def test_direct_route_keeps_the_four_step_sums(n, forward):
    """1216 = 19*64 and 9728 = 19*512 (a prime factor over 17): the
    strided kernel takes the generic stage on its radix route (1216) or
    its two-pass route (9728), and the fused kernels the same route; the
    plain version on the route is ``radix_plain`` or ``two_pass_plain``
    on the columns as rows, bit for bit, and holds the complex64 tier
    against numpy (the name is the test's own from before the fused
    kernels lost their four-step direct route)."""
    assert cuda_fft.eligible(n)
    how = cuda_fft.route(n)
    assert how == ("radix" if n <= 8192 else "radix2")
    assert cuda_fuse.fused_route(n) == how
    x = _c64(n + 2, (2, n, 3))
    got = cuda_fft.fft_axis0_plain(torch.from_numpy(x), forward, how=how)
    rows = _rows_t(torch.from_numpy(x))
    plain = (radix.radix_plain(rows, forward) if how == "radix"
             else cuda_fft.two_pass_plain(rows, n, forward))
    want = _cols_t(plain, 2, 3)
    if not forward:
        want = want * (1.0 / n)
    assert torch.equal(got, want)
    ref = np.fft.fft(x, axis=1) if forward else np.fft.ifft(x, axis=1)
    assert _err(got, ref) < C64
    assert torch.equal(cuda_fft.fft_axis0_plain(torch.from_numpy(x),
                                                forward), got)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [12288, 16384])
def test_two_pass_route_runs_on_the_columns(n, forward):
    """12288 and 16384 (smooth, over 8192) take the two-pass route: the
    plain version is ``two_pass_plain`` on the columns as rows, bit for
    bit, and holds the complex64 tier against numpy."""
    assert cuda_fft.route(n) == "radix2"
    x = _c64(n + 2, (2, n, 3))
    got = cuda_fft.fft_axis0_plain(torch.from_numpy(x), forward)
    want = _cols_t(cuda_fft.two_pass_plain(_rows_t(torch.from_numpy(x)), n,
                                           forward), 2, 3)
    if not forward:
        want = want * (1.0 / n)
    assert torch.equal(got, want)
    ref = np.fft.fft(x, axis=1) if forward else np.fft.ifft(x, axis=1)
    assert _err(got, ref) < C64


# ---------------------------------------------------- fused decode kernel

# (shape, axis, tiles) on radix lengths: axis 0 at the path's n = 512,
# a middle axis at 510 = 2.3.5.17, 257 columns (every other int8 row
# segment 2 bytes off a 4-byte boundary on the card), the last axis.
RADIX_SITES = [((512, 6, 5), 0, 4), ((3, 510, 7), 1, 2),
               ((2, 64, 257), 1, 4), ((4, 3, 512), 2, 4)]


def _wire(codec, y, axis, tiles):
    """The JAX codec's parts of y, and the same parts as torch tensors."""
    parts = jwire(codec).encode(jnp.asarray(y), tile_axis=axis, tiles=tiles)
    tparts = tuple(torch.from_numpy(np.asarray(p).astype(np.float32))
                   .to(torch.bfloat16) if codec == "bf16" and i == 0
                   else torch.from_numpy(np.array(p))
                   for i, p in enumerate(parts))
    return parts, tparts


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", RADIX_SITES)
def test_fused_decode_plain_matches_pallas_body(codec, forward, shape, axis,
                                                tiles):
    """The decode is exact on both sides; the radix stages and the Pallas
    four-step sums then agree to fp32 rounding."""
    assert cuda_fft.route(shape[axis]) == "radix"
    y = _c64(sum(shape) * 3 + tiles, shape)
    parts, tparts = _wire(codec, y, axis, tiles)
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    before = cuda_fuse.launches()
    got = cuda_fuse.fused_decode_fft(tparts, torch.complex64, **kw)
    assert cuda_fuse.launches() == before        # the CPU runs the plain one
    want = np.asarray(pallas_fuse.fused_decode_fft(parts, jnp.complex64, **kw))
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    assert testing.rel_error(got.numpy(), want) <= SAME_MATH


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape,axis,tiles", RADIX_SITES)
def test_fused_decode_plain_is_the_strided_plain_on_the_decode(codec, shape,
                                                               axis, tiles):
    """The CPU side of the fused/unfused parity: the decode's plain
    version is ``fft_along_axis`` (the strided or row plain version of the
    same route) on the codec's decode, bit for bit."""
    y = torch.from_numpy(_c64(sum(shape) + 5, shape))
    codec_ = twire(codec)
    parts = codec_.encode(y, tile_axis=axis, tiles=tiles)
    for forward in (True, False):
        got = cuda_fuse.fused_decode_fft_plain(
            parts, torch.complex64, fft_axis=axis, forward=forward,
            tile_axis=axis, tiles=tiles, wire_dtype=codec)
        dec = codec_.decode(parts, torch.complex64, tile_axis=axis,
                            tiles=tiles)
        assert torch.equal(got, cuda_fft.fft_along_axis(dec, axis, forward))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape,axis,tiles", RADIX_SITES)
def test_fused_encode_plain_on_the_radix_route_matches_pallas_body(
        codec, shape, axis, tiles):
    """Kernel 4 takes the radix route on the card, and its plain version
    follows ``fft_axis0_plain`` onto it: against the Pallas encode body
    (the four-step sums), sidecars bit-identical and mantissas at most
    one level apart (fp32 rounding before the quantizer)."""
    x = _c64(sum(shape) * 5 + tiles, shape)
    kw = dict(fft_axis=axis, forward=False, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    mine = cuda_fuse.fused_fft_encode(torch.from_numpy(x), **kw)
    ref = pallas_fuse.fused_fft_encode(jnp.asarray(x), **kw)
    assert [tuple(m.shape) for m in mine] == [tuple(r.shape) for r in ref]
    if codec == "bf16":
        q = mine[0].to(torch.float32).numpy()
        qr = np.asarray(ref[0]).astype(np.float32)
        assert np.all(np.abs(q - qr) <= 2.0 ** -8 * (np.abs(q) + np.abs(qr))
                      + 1e-6 * np.max(np.abs(qr)))
    else:
        q, qr = mine[0].numpy().astype(np.int32), np.asarray(ref[0])
        assert np.max(np.abs(q - qr.astype(np.int32))) <= 1
        assert np.array_equal(mine[1].numpy().view(np.uint32),
                              np.asarray(ref[1]).view(np.uint32))
