"""The port's two-level long-axis transform against the JAX package's.

An axis longer than one kernel's reach (65536) whose length splits into
two kernel lengths runs ``_fft_last_big``: on the card the two-level
route's passes (``tests/test_torch_two_level_route.py``), here their
plain version. Held here against ``pallas_fft.fft_along_axis``
(the Pallas bodies in interpret mode, as ``tests/test_pallas.py`` runs
them) on the same seeded complex64 inputs, within the complex64 tier
5e-4, on the last axis and on axis 0, forward and inverse; the split
equal to JAX's; no fallback counted; and the local plans at such a
length. On the CPU every kernel wrapper runs its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu.ops import pallas_fft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft as cf

C64 = testing.tolerance(np.complex64)


def _c64(shape, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("n", [131072, 90000])
def test_two_level_matches_jax(n, axis, forward):
    assert not cf.eligible(n) and cf.outer_split(n) is not None
    x = _c64((2, n) if axis == 1 else (n, 2))
    want = np.asarray(pallas_fft.fft_along_axis(jnp.asarray(x), axis,
                                                forward))
    got = cf.fft_along_axis(torch.from_numpy(x), axis, forward).numpy()
    assert got.shape == x.shape and got.dtype == np.complex64
    assert testing.rel_error(got, want) < C64
    f = np.fft.fft if forward else np.fft.ifft
    assert testing.rel_error(got, f(x.astype(np.complex128), axis=axis)) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [131072, 90000, 5 ** 8])
def test_twiddle_angle_equals_jax_bits(n, forward):
    """The angle formed from two float32 index vectors is JAX's angle
    from the int32 phase ``(i*j) % n``, bit for bit."""
    m1, m2 = cf.outer_split(n)
    i = jnp.arange(m1, dtype=jnp.int32)[:, None]
    j = jnp.arange(m2, dtype=jnp.int32)[None, :]
    phase = (i * j) % jnp.int32(n)
    sign = -2.0 if forward else 2.0
    want = np.asarray((sign * np.pi / n) * phase.astype(jnp.float32))
    got = cf._two_level_angle(m1, m2, n, forward, "cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the cached complex64 table is made once from those bits
    table = cf._two_level_table(m1, m2, n, forward, "cpu")
    assert table is cf._two_level_table(m1, m2, n, forward, "cpu")
    ang = torch.tensor(want)
    assert torch.equal(table, torch.complex(torch.cos(ang), torch.sin(ang)))


def test_fft_last_big_is_its_plain_composition():
    """On the CPU the wrapper runs its route's plain version bit for bit,
    within the tier of the JAX-shaped composition of the stages' plain
    versions."""
    n = 90000
    x = torch.from_numpy(_c64((3, n)))
    for forward in (True, False):
        got = cf._fft_last_big(x, n, forward)
        assert torch.equal(got, cf.two_level_passes_plain(x, n, forward))
        assert testing.rel_error(
            got.numpy(), cf._fft_last_big_plain(x, n, forward).numpy()) < C64


@pytest.mark.parametrize("n", [65536 * 2, 90000, 5 ** 8, 3 * 2 ** 17,
                               65537, 131074, 2 ** 31, 257 * 256 * 3,
                               1 << 20, 7 ** 6, 100000])
def test_outer_split_equals_jax(n):
    assert cf.outer_split(n) == pallas_fft.outer_split(n)
    assert cf.eligible(n) == pallas_fft.eligible(n)


def test_outer_split_sweep_equals_jax():
    for n in range(65537, 65537 + 4000, 7):
        assert cf.outer_split(n) == pallas_fft.outer_split(n), n


def test_two_level_ticks_no_fallback_and_raises_nothing():
    n = 131072
    before = dict(cf.FALLBACKS)
    y = cf.fft_along_axis(torch.from_numpy(_c64((1, n))), -1, True)
    assert y.shape == (1, n)
    assert dict(cf.FALLBACKS) == before
    # a length with no two-level split still falls back, as in JAX
    m = 65537                      # prime
    assert cf.outer_split(m) is None
    cf.fft_along_axis(torch.from_numpy(_c64((1, m))), -1, True)
    assert cf.FALLBACKS[(1, "length")] == before.get((1, "length"), 0) + 1


def test_unnormalized_stages():
    x = torch.from_numpy(_c64((2, 256, 8)))
    y = cf.fft_axis0(x, False, normalize=False)
    assert torch.allclose(y * (1.0 / 256), cf.fft_axis0(x, False))
    assert torch.equal(cf.fft_axis0(x, True, normalize=False),
                       cf.fft_axis0(x, True))
    r = torch.from_numpy(_c64((4, 1000)))
    assert torch.allclose(cf.fft_last(r, False, normalize=False) * 1e-3,
                          cf.fft_last(r, False))


@pytest.mark.parametrize("donate", [False, True])
def test_local_1d_plan_at_two_level_length(donate):
    n = 131072
    x = _c64((2, n), seed=5)
    fwd = tdfft.plan_dft_c2c_1d(n, batch=2, device="cpu", donate=donate)
    bwd = tdfft.plan_dft_c2c((n,), batch=2, direction=tdfft.BACKWARD,
                             device="cpu")
    y = fwd(torch.from_numpy(x.copy()))
    want = jdfft.plan_dft_c2c_1d(n, batch=2, executor="pallas",
                                 dtype=jnp.complex64)(x)
    assert testing.rel_error(y.numpy(), np.asarray(want)) < C64
    assert testing.rel_error(y.numpy(), np.fft.fft(x, axis=-1)) < C64
    assert testing.rel_error(bwd(y).numpy(), x) < C64


def test_local_2d_plan_with_a_long_axis():
    shape = (4, 90000)
    x = _c64((1,) + shape, seed=6)
    plan = tdfft.plan_dft_c2c_2d(shape, device="cpu")
    got = plan(torch.from_numpy(x)).numpy()
    assert testing.rel_error(got, np.fft.fft2(x, axes=(1, 2))) < C64

