"""The radix route of the row and plane kernels, on the CPU.

``distributedfft_tpu_torch/ops/radix.py`` decides everything the radix
kernels of ``csrc/radix.cuh`` run: the stage radices of each length, the
stage twiddle tables and the plane launcher's chunks. These tests check
every plan the card can be given, the tables bit for bit, and the plain
version of the route (its stages as tensor ops, which the wrappers run
on CPU tensors) against numpy's float64 FFT at the complex64 tier (5e-4)
and against the JAX package's Pallas kernels in interpret mode at 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, radix

C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
JAX_TIER = 1e-5                        # fp32 sums in another order
RADICES = {2, 3, 4, 5, 7, 8, 11, 13, 16, 17}


def _c64(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _err(got, want):
    return testing.rel_error(np.asarray(got), np.asarray(want))


def _smooth(n: int) -> bool:
    """All prime factors of n are at most 17."""
    for p in (2, 3, 5, 7, 11, 13, 17):
        while n % p == 0:
            n //= p
    return n == 1


# ------------------------------------------------------------------ plans

def test_every_eligible_length_has_the_rules_route():
    """For every kernel-eligible n in [64, 8192]: the route is radix
    exactly when n <= 8192 and every prime factor is <= 17; a radix plan
    multiplies out to n, uses only the hand-written radices, puts the
    power-of-two part first in ceil(a/4) stages and has at least two
    stages (the kernels' first reads and last writes device memory)."""
    radix_count = 0
    for n in range(64, 8193):
        if not cuda_fft.eligible(n):
            continue
        plan = radix.radix_plan(n)
        assert (cuda_fft.route(n) == "radix") == _smooth(n), n
        assert (plan is not None) == _smooth(n), n
        if plan is None:
            continue
        radix_count += 1
        assert math.prod(plan) == n
        assert set(plan) <= RADICES
        assert len(plan) >= 2
        a = (n & -n).bit_length() - 1
        pow2 = [r for r in plan if r & (r - 1) == 0]
        assert plan[:len(pow2)] == tuple(pow2)
        assert len(pow2) == -(-a // 4)
        assert max(pow2, default=1) <= 2 * min(pow2, default=1)
        odd = list(plan[len(pow2):])
        assert odd == sorted(odd)
    assert radix_count > 300


@pytest.mark.parametrize("n,plan", [(256, (16, 16)), (512, (8, 8, 8)),
                                    (510, (2, 3, 5, 17)), (66, (2, 3, 11)),
                                    (72, (8, 3, 3)), (100, (4, 5, 5)),
                                    (4096, (16, 16, 16)),
                                    (8192, (16, 8, 8, 8))])
def test_main_path_plans(n, plan):
    assert radix.radix_plan(n) == plan
    assert cuda_fft.route(n) == "radix"


@pytest.mark.parametrize("n", [76, 19 * 64, 19 * 512, 4913])
def test_lengths_off_the_radix_route(n):
    """A prime factor over 17 (76 = 4*19; 9728 = 19*512, also over 8192),
    or a smooth length the kernels do not take at all (17^3) is direct."""
    assert cuda_fft.route(n) == "direct"
    assert radix.radix_plan(n) is None or not cuda_fft.eligible(n)
    assert cuda_fft.route2d(512, 76) == cuda_fft.route2d(76, 512) == "direct"


@pytest.mark.parametrize("n", [12288, 15625, 16384, 65536])
def test_smooth_lengths_past_8192_take_the_two_pass_route(n):
    """Past 8192 no one-pass plan exists, but both factors of the split
    have one: the two-pass route, whose plain version holds the
    complex64 tier against numpy."""
    assert radix.radix_plan(n) is None
    assert all(radix.radix_plan(m) for m in cuda_fft.split_for(n))
    assert cuda_fft.route(n) == "radix2"
    x = _c64(n, (2, n))
    got = cuda_fft.fft_last(torch.from_numpy(x), True).numpy()
    assert _err(got, np.fft.fft(x.astype(np.complex128), axis=1)) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [64, 66, 72, 100, 256, 510, 512, 4096, 8192])
def test_twiddles_bit_identical(n, forward):
    """Stage (R, ns) holds exp(-+2 pi i k / n), k = p m n/(ns R), in
    float64 then cast to complex64, at (ns - 1) + (m - 1) ns + p."""
    sign = -1.0 if forward else 1.0
    want = np.empty(n - 1, dtype=np.complex64)
    ns = 1
    for r in radix.radix_plan(n):
        for m in range(1, r):
            for p in range(ns):
                k = (p * m * (n // (ns * r))) % n
                want[ns - 1 + (m - 1) * ns + p] = np.complex64(
                    np.exp(sign * 2j * np.pi * k / n))
        ns *= r
    got = radix.twiddles_np(n, forward)
    assert got.dtype == np.complex64 and got.shape == (n - 1,)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------- plain version

@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [64, 66, 72, 100, 256, 510, 512, 4096, 8192])
def test_radix_plain_matches_numpy(n, forward):
    x = _c64(n, (3, n))
    got = cuda_fft.fft_last(torch.from_numpy(x), forward).numpy()
    xd = x.astype(np.complex128)
    want = np.fft.fft(xd, axis=1) if forward else np.fft.ifft(xd, axis=1)
    assert _err(got, want) < C64
    unscaled = radix.radix_plain(torch.from_numpy(x), forward).numpy()
    assert _err(unscaled, want if forward else want * n) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [72, 100, 256, 510])
def test_radix_plain_matches_pallas_1d_kernel(n, forward):
    x = _c64(n + 7, (4, n))
    got = cuda_fft.fft_last(torch.from_numpy(x), forward)
    want = np.asarray(pallas_fft._fft_eligible(jnp.asarray(x), n, forward))
    if not forward:   # the Pallas body leaves the inverse unscaled
        want = want / n
    assert _err(got, want) < JAX_TIER


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("ny,nz", [(66, 70), (100, 64)])
def test_radix_plain_matches_pallas_plane_kernel(ny, nz, forward):
    assert cuda_fft.route2d(ny, nz) == "radix"
    x = _c64(ny * nz, (2, ny, nz))
    got = cuda_fft.fft2_last(torch.from_numpy(x), forward)
    want = np.asarray(pallas_fft.fft2_last(jnp.asarray(x), forward))
    assert _err(got, want) < JAX_TIER


@pytest.mark.parametrize("forward", [True, False])
def test_direct_route_keeps_the_four_step_sums(forward):
    """76 = 4*19 takes the direct route: its plain version is the
    four-step sums, and a plane with one such axis runs direct whole."""
    x = _c64(76, (3, 76))
    got = cuda_fft.fft_last_plain(torch.from_numpy(x), forward)
    want = cuda_fft.four_step_plain(torch.from_numpy(x), 76, forward)
    if not forward:
        want = want / 76
    assert torch.equal(got, want)
    p = _c64(77, (2, 76, 64))
    ref = np.fft.fft2(p) if forward else np.fft.ifft2(p)
    assert _err(cuda_fft.fft2_last(torch.from_numpy(p), forward), ref) < C64


# ------------------------------------------------------- plane chunking

def test_plane_chunk_fits_the_l2_budget():
    assert radix.plane_chunk(512, 512) == 4
    assert radix.plane_chunk(510, 512) == 4
    assert radix.plane_chunk(64, 64) == 256
    assert radix.plane_chunk(1024, 1024) == 1
    assert radix.plane_chunk(2048, 2048) == 1   # over budget: one plane
    for ny, nz in ((512, 512), (510, 512), (64, 72)):
        assert radix.plane_chunk(ny, nz) * ny * nz * 8 <= radix.L2_CHUNK_BYTES


@pytest.mark.parametrize("batch,chunk,spans", [
    (128, 4, [(b, 4) for b in range(0, 128, 4)]),
    (13, 4, [(0, 4), (4, 4), (8, 4), (12, 1)]),
    (1, 4, [(0, 1)]),
    (5, 1, [(b, 1) for b in range(5)]),
    (3, 8, [(0, 3)]),
])
def test_chunk_spans_cover_the_batch(batch, chunk, spans):
    got = radix.chunk_spans(batch, chunk)
    assert got == spans
    assert sum(c for _, c in got) == batch
    assert all(b + c <= batch for b, c in got)
