"""The generic prime stage of the row and strided kernels, on the CPU.

A length with a prime factor from 19 to 251 runs on the card's radix
route (``csrc/radix.cuh``: ``generic_stage``) as a stage of its own that
sums its R twiddled inputs against the R roots w_R^q; past 8192 each
factor of the four-step split is such a plan, one stage alone when the
factor is a prime (8194 = 34 * 241, 12482 = 79 * 158). These tests check
every plan the row and strided kernels can be given, the roots table bit
for bit, and the plain versions (which the wrappers run on CPU tensors)
against numpy's float64 FFT at the complex64 tier (5e-4) and against
the JAX package's Pallas kernels in interpret mode at 1e-5 (fp32-level
rounding on both sides, the sums in another order); and a slab and a
pencil plan at a non-smooth shape on the port's ``cuda`` executor
against the JAX package's ``pallas`` executor on the 8-device CPU mesh.
The plane and fused kernels take the same radix route at these lengths
(their plain versions are ``tests/test_torch_generic_fused.py``'s), and
the fused kernels the two-pass route past 8192.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu.ops import pallas_fft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, cuda_fuse, radix

C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
SAME_MATH = 1e-5                       # fp32-level rounding on both sides
PRIMES = [p for p in range(19, 252)
          if all(p % d for d in range(2, math.isqrt(p) + 1))]
ALLOWED = set(radix.HAND_RADICES) | set(PRIMES)
# one pass: 3 * 23, 4 * 19, 19 * 19, 2 * 251, 2^5 * 19, 2^8 * 19; two
# passes: 8194 = 34 * 241 (the second pass one stage), 9728 = 76 * 128
# (76 = 4 * 19 on the generic stage)
ONE_PASS = [69, 76, 361, 502, 608, 4864]
TWO_PASS = [8194, 9728]
# (forward, normalize): the forward, the inverse, the unscaled inverse
DIRECTIONS = [(True, True), (False, True), (False, False)]


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


def _numpy(x, axis, forward, normalize):
    xd = x.astype(np.complex128)
    if forward:
        return np.fft.fft(xd, axis=axis)
    y = np.fft.ifft(xd, axis=axis)
    return y if normalize else y * x.shape[axis]


def _check_plan(m: int) -> None:
    plan = radix.radix_plan(m)
    assert plan is not None and math.prod(plan) == m, m
    assert set(plan) <= ALLOWED, (m, plan)
    assert len(plan) >= 2 or (len(plan) == 1 and radix.is_generic(plan[0]))
    odd = [r for r in plan if r % 2]
    assert odd == sorted(odd) and plan[len(plan) - len(odd):] == tuple(odd)


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("lo,hi", [(64, 8192), (8193, 65536)])
def test_every_eligible_length_takes_a_radix_route(lo, hi):
    """For every kernel-eligible n: the row and strided kernels' route is
    ``radix`` up to 8192 and ``radix2`` past it, never ``direct``; the
    plan (or each factor's of the split) multiplies out to n with the
    hand-written radices and primes 19..251 only, one stage only for a
    generic prime, a generic stage exactly where a prime factor is over
    17; the fused kernels take the same route, and a plane with such an
    axis takes the radix route."""
    generic = 0
    for n in range(lo, hi + 1):
        if not cuda_fft.eligible(n):
            continue
        how = cuda_fft.route(n)
        assert how == ("radix" if n <= 8192 else "radix2"), n
        for m in ((n,) if how == "radix" else cuda_fft.split_for(n)):
            _check_plan(m)
        smooth = _smooth(n)
        generic += not smooth
        assert cuda_fuse.fused_route(n) == how, n
        if n <= 8192:
            plan = radix.radix_plan(n)
            assert any(map(radix.is_generic, plan)) == (not smooth), n
            assert cuda_fft.route2d(n, 64) == "radix", n
    assert generic > (3000 if hi <= 8192 else 10000)


@pytest.mark.parametrize("n,plan", [(608, (8, 4, 19)), (361, (19, 19)),
                                    (69, (3, 23)), (76, (4, 19)),
                                    (502, (2, 251)), (4864, (16, 16, 19)),
                                    (241, (241,)), (79, (79,)),
                                    (437, (19, 23))])
def test_generic_plans(n, plan):
    assert radix.radix_plan(n) == plan
    assert max(plan) > 17
    assert all(radix.is_generic(r) == (r > 17) for r in plan)


@pytest.mark.parametrize("n,split,plans", [
    (8194, (34, 241), ((2, 17), (241,))),
    (12482, (79, 158), ((79,), (2, 79))),
    (64256, (251, 256), ((251,), (16, 16))),
    (9728, (76, 128), ((4, 19), (16, 8)))])
def test_two_pass_splits_with_a_one_stage_factor(n, split, plans):
    assert cuda_fft.split_for(n) == split
    assert tuple(radix.radix_plan(m) for m in split) == plans
    assert cuda_fft.route(n) == "radix2"
    assert cuda_fuse.fused_route(n) == "radix2"


@pytest.mark.parametrize("ny,nz", [(608, 608), (512, 608), (76, 64)])
def test_plane_keeps_the_direct_route_off_smooth_lengths(ny, nz):
    """A plane with an axis of a prime factor over 17 no longer keeps the
    direct route: it takes the radix route, as the smooth planes do (the
    name is the test's own from before the plane had a generic stage)."""
    assert cuda_fft.route2d(ny, nz) == "radix"
    assert cuda_fft.route2d(512, 512) == cuda_fft.route2d(510, 512) == "radix"


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [69, 76, 361, 437, 502, 608, 4864, 241, 79])
def test_generic_roots_bit_identical(n, forward):
    """Each generic stage R adds w_R^q = exp(-+2 pi i q / R), q < R, in
    float64 cast to complex64, after the n - 1 stage twiddles, in stage
    order; the kernels' table is the two together."""
    sign = -1.0 if forward else 1.0
    want = [np.complex64(np.exp(sign * 2j * np.pi * q / r))
            for r in radix.radix_plan(n) if r > 17 for q in range(r)]
    want = np.array(want, dtype=np.complex64)
    got = radix.roots_np(n, forward)
    assert got.dtype == np.complex64
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    table = radix.table_np(n, forward)
    assert table.shape == (n - 1 + want.size,)
    assert np.array_equal(table[:n - 1].view(np.uint32),
                          radix.twiddles_np(n, forward).view(np.uint32))
    assert np.array_equal(table[n - 1:].view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [608, 361, 502, 8032])
def test_plan_flops_count_the_generic_stage(n):
    """The generic stage does about 5 h flops an output (h = (R - 1)/2),
    far under the four-step sums' 8 (n1 + n2) a point."""
    per_point = radix.plan_flops(n) / n
    n1, n2 = cuda_fft.split_for(n)
    assert per_point < 8 * (n1 + n2) / 2
    for r in radix.radix_plan(n):
        if radix.is_generic(r):
            h = (r - 1) // 2
            assert 4 * h * h < radix.butterfly_flops(r) < 8 * r * r


# ---------------------------------------------------------- plain version

@pytest.mark.parametrize("forward,normalize", DIRECTIONS)
@pytest.mark.parametrize("n", ONE_PASS + TWO_PASS + [12482])
def test_plain_versions_match_numpy(n, forward, normalize):
    x = _c64(n, (3, n))
    want = _numpy(x, 1, forward, normalize)
    got = cuda_fft.fft_last(torch.from_numpy(x), forward, normalize=normalize)
    assert _err(got, want) < C64
    cols = np.ascontiguousarray(x.T)[None]                  # [1, n, 3]
    got = cuda_fft.fft_axis0(torch.from_numpy(cols), forward,
                             normalize=normalize)
    assert _err(got, want.T[None]) < C64


@pytest.mark.parametrize("forward,normalize", DIRECTIONS)
@pytest.mark.parametrize("n", ONE_PASS + TWO_PASS)
def test_fft_last_plain_matches_pallas_1d_kernel(n, forward, normalize):
    x = _c64(n + 1, (2, n))
    got = cuda_fft.fft_last(torch.from_numpy(x), forward,
                            normalize=normalize)
    want = np.asarray(pallas_fft._fft_eligible(jnp.asarray(x), n, forward))
    if not forward and normalize:   # the Pallas body leaves it unscaled
        want = want / n
    assert got.shape == want.shape
    assert _err(got, want) < SAME_MATH


@pytest.mark.parametrize("forward,normalize", DIRECTIONS)
@pytest.mark.parametrize("n", ONE_PASS + TWO_PASS)
def test_fft_axis0_plain_matches_pallas_strided_kernel(n, forward,
                                                       normalize):
    x = _c64(n + 2, (1, n, 3))
    got = cuda_fft.fft_axis0(torch.from_numpy(x), forward,
                             normalize=normalize)
    want = np.asarray(pallas_fft.fft_axis0(jnp.asarray(x[0]), forward,
                                           normalize=normalize))[None]
    assert got.shape == want.shape
    assert _err(got, want) < SAME_MATH


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [608, 361])
def test_plain_versions_run_the_generic_stages(n, forward):
    """On a generic length the row kernel's plain version is
    ``radix_plain`` (its einsum over the complex64 roots), and the strided
    one the same on the columns as rows, bit for bit."""
    x = torch.from_numpy(_c64(n + 3, (2, n)))
    want = radix.radix_plain(x, forward)
    assert torch.equal(cuda_fft.fft_last_plain(x, forward, normalize=False),
                       want)
    cols = x.t().contiguous().reshape(1, n, 2)
    got = cuda_fft.fft_axis0_plain(cols, forward, normalize=False)
    assert torch.equal(got, want.t().reshape(1, n, 2))


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("shape,world", [((76, 64, 64), 4),
                                         ((64, 64, 76), (2, 2))])
def test_plans_match_jax_pallas_executor(shape, world):
    """A slab plan over 4 ranks at [76, 64, 64] (X on the generic stage)
    and a pencil plan on 2x2 at [64, 64, 76] (Z) on the port's ``cuda``
    executor against the JAX ``pallas`` plans on the CPU mesh, forward and
    backward, from the same seeded input."""
    x = testing.make_world_data(shape, np.complex64, seed=7)
    mesh = jdfft.make_mesh(world)
    for d, td in ((jdfft.FORWARD, tdfft.FORWARD),
                  (jdfft.BACKWARD, tdfft.BACKWARD)):
        jp = jdfft.plan_dft_c2c_3d(shape, mesh, direction=d,
                                   executor="pallas")
        tp = tdfft.plan_dft_c2c_3d(shape, world, direction=td,
                                   executor="cuda", device="cpu")
        want = np.asarray(jp(x))
        got = tp(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == shape
        assert _err(got, want) < C64
        ref = np.fft.fftn(x) if d == jdfft.FORWARD else np.fft.ifftn(x)
        assert _err(got, ref) < C64
