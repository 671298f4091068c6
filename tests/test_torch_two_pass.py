"""The two-pass radix route of the row and strided kernels, on the CPU.

Past 8192, an eligible length whose prime factors are all <= 17 runs on
the card as two radix passes of ``csrc/radix.cuh`` over the four-step
split n = m1*m2 (``cuda_fft.route`` names it ``radix2``): the pass over
j1 with the twiddle T in its store, then the pass over j2 with the
reorder to k = k1 + m1*k2 in its store. On CPU tensors the wrappers run
its plain version (``cuda_fft.two_pass_plain``). These tests hold that
plain version against the JAX package's Pallas kernels in interpret mode
(``pallas_fft._fft_eligible`` for the rows, ``pallas_fft.fft_axis0`` and
``fft_along_axis`` for the strided kernel) at 1e-5 relative (fp32-level
rounding on both sides, the sums in another order) and against numpy at
the complex64 tier (5e-4); check the route by length, the tables the
route reads, and that the fused kernels, which have no two-pass form,
count and run the direct route at these lengths.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedfft_tpu.ops import pallas_fft, pallas_fuse
from distributedfft_tpu.parallel.exchange import wire_codec as jwire
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, cuda_fuse, radix

SAME_MATH = 1e-5                       # fp32-level rounding on both sides
C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
TWO_PASS = [12288, 15625, 16384, 65536]
DIRECT = [76, 19 * 64, 19 * 512]
# (forward, normalize): the forward, the inverse, the unscaled inverse
DIRECTIONS = [(True, True), (False, True), (False, False)]


def _c64(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _err(got, want):
    return testing.rel_error(np.asarray(got), np.asarray(want))


def _smooth(n: int) -> bool:
    for p in (2, 3, 5, 7, 11, 13, 17):
        while n % p == 0:
            n //= p
    return n == 1


def _numpy(x, axis, forward, normalize):
    xd = x.astype(np.complex128)
    if forward:
        return np.fft.fft(xd, axis=axis)
    y = np.fft.ifft(xd, axis=axis)
    return y if normalize else y * x.shape[axis]


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("n", TWO_PASS)
def test_two_pass_lengths_take_the_new_route(n):
    m1, m2 = cuda_fft.split_for(n)
    assert cuda_fft.route(n) == "radix2"
    assert radix.radix_plan(n) is None
    assert radix.radix_plan(m1) and radix.radix_plan(m2)
    assert cuda_fuse.fused_route(n) == "direct"


@pytest.mark.parametrize("n", DIRECT)
def test_lengths_with_a_prime_over_17_stay_direct(n):
    assert cuda_fft.eligible(n)
    assert cuda_fft.route(n) == "direct"
    assert cuda_fuse.fused_route(n) == "direct"


def test_every_eligible_length_past_8192_has_the_rules_route():
    """For every kernel-eligible 8192 < n <= 65536: the route is
    ``radix2`` exactly when every prime factor is <= 17, and then both
    factors of the split have radix plans of at least two stages."""
    count = 0
    for n in range(8193, 65537):
        if not cuda_fft.eligible(n):
            continue
        assert (cuda_fft.route(n) == "radix2") == _smooth(n), n
        if _smooth(n):
            count += 1
            assert all(len(radix.radix_plan(m)) >= 2
                       for m in cuda_fft.split_for(n)), n
        else:
            assert cuda_fft.route(n) == "direct", n
    assert count > 1000


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", TWO_PASS[:3])
def test_the_route_reads_jaxs_four_step_twiddle(n, forward):
    """The pass-1 store multiplies by T of the direct route's tables,
    which are the JAX package's, bit for bit."""
    m1, m2 = cuda_fft.split_for(n)
    mine = cuda_fft.tables_np_cached(n, m1, m2, forward)[1]
    ref = pallas_fft._tables_np_cached(n, m1, m2, forward, 1, 1)[1]
    assert mine.shape == ref.shape == (m2, m1)
    assert np.array_equal(mine.view(np.uint32), ref.view(np.uint32))


# --------------------------------------------------------- plain version

@pytest.mark.parametrize("forward,normalize", DIRECTIONS)
@pytest.mark.parametrize("n", TWO_PASS)
def test_fft_last_plain_matches_pallas_1d_kernel(n, forward, normalize):
    x = _c64(n, (2, n))
    got = cuda_fft.fft_last(torch.from_numpy(x), forward,
                            normalize=normalize)
    want = np.asarray(pallas_fft._fft_eligible(jnp.asarray(x), n, forward))
    if not forward and normalize:   # the Pallas body leaves it unscaled
        want = want / n
    assert got.shape == want.shape
    assert _err(got, want) < SAME_MATH
    assert _err(got, _numpy(x, 1, forward, normalize)) < C64


@pytest.mark.parametrize("forward,normalize", DIRECTIONS)
@pytest.mark.parametrize("n", TWO_PASS)
def test_fft_axis0_plain_matches_pallas_strided_kernel(n, forward,
                                                       normalize):
    x = _c64(n + 1, (1, n, 3))
    got = cuda_fft.fft_axis0(torch.from_numpy(x), forward,
                             normalize=normalize)
    want = np.asarray(pallas_fft.fft_axis0(jnp.asarray(x[0]), forward,
                                           normalize=normalize))[None]
    assert got.shape == want.shape
    assert _err(got, want) < SAME_MATH
    assert _err(got, _numpy(x, 1, forward, normalize)) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [12288, 15625])
def test_fft_axis0_plain_lead_matches_pallas_vmap(n, forward):
    """A leading batch of the strided kernel is the vmap of
    ``fft_along_axis`` on a middle axis."""
    x = _c64(n + 2, (2, n, 5))
    got = cuda_fft.fft_axis0(torch.from_numpy(x), forward)
    want = np.asarray(pallas_fft.fft_along_axis(jnp.asarray(x), 1, forward))
    assert _err(got, want) < SAME_MATH
    assert _err(got, _numpy(x, 1, forward, True)) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", TWO_PASS)
def test_plain_versions_run_the_two_passes(n, forward):
    """Both wrappers' plain versions are ``two_pass_plain`` (the strided
    one on the columns as rows), bit for bit: radix_plain over j1, times
    T, radix_plain over j2, reordered."""
    x = torch.from_numpy(_c64(n + 3, (2, n)))
    want = cuda_fft.two_pass_plain(x, n, forward)
    scale = 1.0 if forward else 1.0 / n
    assert torch.equal(cuda_fft.fft_last_plain(x, forward), want * scale
                       if not forward else want)
    cols = x.reshape(1, 2, n).transpose(1, 2).contiguous()   # [1, n, 2]
    got = cuda_fft.fft_axis0_plain(cols, forward, normalize=False)
    assert torch.equal(got, want.t().reshape(1, n, 2))
    m1, m2 = cuda_fft.split_for(n)
    c128 = torch.complex128
    t = torch.from_numpy(cuda_fft.tables_np_cached(n, m1, m2, forward)[1])
    a = x.to(c128).reshape(2, m1, m2).transpose(1, 2).reshape(-1, m1)
    b = radix.radix_plain(a, forward).reshape(2, m2, m1) * t.to(c128)
    c = radix.radix_plain(b.transpose(1, 2).reshape(-1, m2), forward)
    ref = c.reshape(2, m1, m2).transpose(1, 2).reshape(2, n)
    assert torch.equal(want, ref.to(torch.complex64))


# ------------------------------------------- the fused kernels' route

@pytest.mark.parametrize("codec", ["bf16", "split"])
@pytest.mark.parametrize("forward", [True, False])
def test_fused_plain_runs_the_direct_route_past_8192(codec, forward):
    """At a two-pass length the fused kernels take the direct route on
    the card, and their plain versions run its four-step sums: the
    decode's is ``fft_axis0_plain`` on the direct route of the codec's
    decode, bit for bit, and agrees with the Pallas body."""
    shape, axis, tiles = (1, 12288, 3), 1, 4
    y = _c64(11, shape)
    parts = jwire(codec).encode(jnp.asarray(y), tile_axis=axis, tiles=tiles)
    tparts = tuple(torch.from_numpy(np.asarray(p).astype(np.float32))
                   .to(torch.bfloat16) if codec == "bf16" and i == 0
                   else torch.from_numpy(np.array(p))
                   for i, p in enumerate(parts))
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    got = cuda_fuse.fused_decode_fft(tparts, torch.complex64, **kw)
    from distributedfft_tpu_torch.parallel.exchange import wire_codec
    dec = wire_codec(codec).decode(tparts, torch.complex64, tile_axis=axis,
                                   tiles=tiles)
    assert torch.equal(got, cuda_fft.fft_axis0_plain(dec, forward,
                                                     how="direct"))
    want = np.asarray(pallas_fuse.fused_decode_fft(parts, jnp.complex64,
                                                   **kw))
    assert testing.rel_error(got.numpy(), want) <= SAME_MATH
