"""The port's emulated-double functions (``ops/ddfft.py``) against the
JAX package's dd engine and numpy float64.

The same seeded inputs go through ``distributedfft_tpu.ops.ddfft`` (the
exact-sliced bf16 engine, on the CPU) and
``distributedfft_tpu_torch.ops.ddfft`` (the pair joined into complex128,
``torch.fft``, split). Pairs are compared by value (``dd_to_host``),
never component by component: neither package's output pairs are
canonical.

- ``fft_axis_dd`` on a dense (8, 12, 64) block, the JAX tier's four-step
  lengths 600 and 1024, its Bluestein length 521 and a middle axis;
  ``fftn_dd``, ``rfftn_dd`` / ``irfftn_dd`` (even and odd real extents)
  and ``dd_scale`` (powers of two and not): within 1e-13 of numpy
  float64 (relative max-norm), within 1e-11 of the JAX tier, round
  trips within 1e-11.
- The host split is the JAX package's, bit for bit; the coverage rule
  and its refusals are its own.
- Range: 1e37 and 1e-25 data and the near-float32-maximum impulses of
  the JAX tests hold the tier; 1e-30 (below the JAX tier's range) holds
  against float64; an output past the float32 maximum reads ``inf``.
"""

import numpy as np
import pytest
import torch

from distributedfft_tpu_torch.ops import ddfft as tdd
from distributedfft_tpu_torch.ops import realfft

F64 = 1e-13     # the port against numpy float64
TIER = 1e-11    # against the JAX tier; round trips


def _jdd():
    from distributedfft_tpu.ops import ddfft

    return ddfft


def _c128(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _pair(x):
    return tdd.dd_from_host(x, device="cpu")


def _jpair(x):
    return _jdd().dd_from_host(x)


@pytest.mark.parametrize("complex_", [True, False])
def test_host_split_is_the_jax_split(complex_):
    rng = np.random.default_rng(1)
    x = _c128((32,), seed=1) if complex_ else rng.standard_normal(32)
    hi, lo = _pair(x)
    jh, jl = _jpair(x)
    assert hi.device.type == "cpu"
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jl))
    back = tdd.dd_to_host(hi, lo)
    assert back.dtype == (np.complex128 if complex_ else np.float64)
    assert np.max(np.abs(back - x)) < F64
    assert torch.max(torch.abs(lo)) > 0


# (label, array shape, axis, seed): dense, four-step, Bluestein, middle
AXIS_CASES = [
    ("dense", (8, 12, 64), -1, 3),
    ("four_step_600", (2, 600), -1, 600),
    ("four_step_1024", (2, 1024), -1, 1024),
    ("bluestein_521", (2, 521), -1, 79),
    ("middle_axis", (4, 24, 6), 1, 13),
]


@pytest.mark.parametrize("label,shape,axis,seed", AXIS_CASES,
                         ids=[c[0] for c in AXIS_CASES])
def test_fft_axis_dd(label, shape, axis, seed):
    x = _c128(shape, seed)
    want = np.fft.fft(x, axis=axis)
    yh, yl = tdd.fft_axis_dd(*_pair(x), axis=axis)
    assert yh.dtype == torch.complex64 and yh.shape == x.shape
    assert tdd.max_err_vs_f64(yh, yl, want) < F64
    jh, jl = _jdd().fft_axis_dd(*_jpair(x), axis=axis)
    assert _rel(tdd.dd_to_host(yh, yl), _jdd().dd_to_host(jh, jl)) < TIER
    bh, bl = tdd.fft_axis_dd(yh, yl, axis=axis, forward=False)
    assert _rel(tdd.dd_to_host(bh, bl), x) < TIER


@pytest.mark.parametrize("forward", [True, False])
def test_fftn_dd(forward):
    x = _c128((8, 6, 10), seed=11)
    want = np.fft.fftn(x) if forward else np.fft.ifftn(x)
    yh, yl = tdd.fftn_dd(*_pair(x), forward=forward)
    assert tdd.max_err_vs_f64(yh, yl, want) < F64
    jh, jl = _jdd().fftn_dd(*_jpair(x), forward=forward)
    assert _rel(tdd.dd_to_host(yh, yl), _jdd().dd_to_host(jh, jl)) < TIER
    bh, bl = tdd.fftn_dd(yh, yl, forward=not forward)
    assert _rel(tdd.dd_to_host(bh, bl), x) < TIER


def test_fftn_dd_over_axes():
    x = _c128((3, 8, 10), seed=12)
    yh, yl = tdd.fftn_dd(*_pair(x), axes=(1, 2))
    assert tdd.max_err_vs_f64(yh, yl, np.fft.fftn(x, axes=(1, 2))) < F64


@pytest.mark.parametrize("shape", [(8, 6, 10), (4, 6, 9)])
def test_rfftn_irfftn_dd(shape):
    x = np.random.default_rng(59).standard_normal(shape)
    want = np.fft.rfftn(x)
    yh, yl = tdd.rfftn_dd(*_pair(x))
    assert yh.shape == want.shape and yh.dtype == torch.complex64
    assert tdd.max_err_vs_f64(yh, yl, want) < F64
    jh, jl = _jdd().rfftn_dd(*_jpair(x))
    assert _rel(tdd.dd_to_host(yh, yl), _jdd().dd_to_host(jh, jl)) < TIER
    bh, bl = tdd.irfftn_dd(yh, yl, shape[-1])
    assert bh.dtype == torch.float32 and bh.shape == shape
    back = tdd.dd_to_host(bh, bl)
    assert _rel(back, x) < TIER
    jb = _jdd().dd_to_host(*_jdd().irfftn_dd(jh, jl, shape[-1]))
    assert _rel(back, jb) < TIER


@pytest.mark.parametrize("s", [1.0 / 3.0, 1.0 / 512, -0.25, 1.0,
                               1.0 / np.sqrt(512)])
@pytest.mark.parametrize("complex_", [True, False])
def test_dd_scale(s, complex_):
    x = _c128((8, 8), seed=107)
    x = x if complex_ else np.abs(x.real)
    hi, lo = _pair(x)
    zh, zl = tdd.dd_scale(hi, lo, s)
    assert zh.dtype == hi.dtype
    got = tdd.dd_to_host(zh, zl)
    assert np.max(np.abs(got - x * s)) / np.max(np.abs(x * s)) < F64
    jz = _jdd().dd_to_host(*_jdd().dd_scale(*_jpair(x), s))
    assert _rel(got, jz) < TIER
    if abs(np.frexp(s)[0]) == 0.5:     # exact powers of two: bit for bit
        np.testing.assert_array_equal(got, tdd.dd_to_host(hi, lo) * s)


def test_huge_prime_refused_as_in_jax():
    n = 131101
    hi = torch.zeros((2, n), dtype=torch.complex64)
    with pytest.raises(ValueError, match="out of dd scope"):
        tdd.fft_axis_dd(hi, hi, axis=-1)
    jh = np.zeros((2, n), np.complex64)
    with pytest.raises(ValueError, match="out of dd scope"):
        _jdd().fft_axis_dd(jh, jh, axis=-1)
    with pytest.raises(ValueError, match="out of dd scope"):
        tdd.fftn_dd(hi, hi)
    with pytest.raises(ValueError, match="out of dd scope"):
        tdd.rfftn_dd(hi.real.contiguous(), hi.real.contiguous())


@pytest.mark.parametrize("n", [512, 513, 521, 600, 1031, 1024, 4096, 65536,
                               65537, 131071, 131101, 262144, 262147,
                               524288, 2 * 65537])
def test_coverage_rule_is_the_jax_rule(n):
    j = _jdd()
    jax_covers = (n <= j.DD_DENSE_MAX or j._dd_split(n) is not None
                  or j._dd_bluestein_m(n) is not None)
    assert tdd.dd_covers(n) == jax_covers
    assert tdd.DD_DENSE_MAX == j.DD_DENSE_MAX


@pytest.mark.parametrize("scale", [1e37, 1e-25])
def test_extreme_magnitudes_hold_the_tier(scale):
    x = _c128((2, 32), seed=41) * scale
    want = np.fft.fft(x, axis=-1)
    yh, yl = tdd.fft_axis_dd(*_pair(x), axis=-1)
    assert tdd.max_err_vs_f64(yh, yl, want) < F64
    jh, jl = _jdd().fft_axis_dd(*_jpair(x), axis=-1)
    assert _rel(tdd.dd_to_host(yh, yl), _jdd().dd_to_host(jh, jl)) < TIER


def test_below_the_jax_range_holds_against_f64():
    x = _c128((2, 32), seed=43) * 1e-30
    yh, yl = tdd.fft_axis_dd(*_pair(x), axis=-1)
    assert tdd.max_err_vs_f64(yh, yl, np.fft.fft(x, axis=-1)) < F64


@pytest.mark.parametrize("n,peak", [(1024, 2.0 ** 122),
                                    (521, 0.9 * 2.0 ** 126)])
def test_near_f32_max_impulse(n, peak):
    d = np.zeros((1, n), complex)
    d[0, 0] = peak
    want = np.fft.fft(d, axis=-1)
    yh, yl = tdd.fft_axis_dd(*_pair(d), axis=-1)
    assert bool(torch.isfinite(yh).all()) and torch.max(torch.abs(yh)) > 0
    assert tdd.max_err_vs_f64(yh, yl, want) < F64
    jh, jl = _jdd().fft_axis_dd(*_jpair(d), axis=-1)
    assert _rel(tdd.dd_to_host(yh, yl), _jdd().dd_to_host(jh, jl)) < TIER


def test_output_past_f32_max_reads_inf():
    d = np.zeros((1, 64), complex)
    d[0, :4] = 3e38                    # DC term 1.2e39: past float32
    yh, yl = tdd.fft_axis_dd(*_pair(d), axis=-1)
    got = tdd.dd_to_host(yh, yl)
    assert np.isinf(got[0, 0].real) and got[0, 0].real > 0
    assert float(torch.view_as_real(yl)[0, 0, 0]) == 0.0
    want = np.fft.fft(d, axis=-1)
    fin = np.abs(want) < 3e38
    assert np.max(np.abs(got[fin] - want[fin])) / np.max(
        np.abs(want[fin])) < F64


def test_mirror_has_one_home():
    assert tdd.mirror_half_spectrum is realfft.mirror_half_spectrum


def test_max_err_vs_f64_is_the_jax_metric():
    x = _c128((4, 16), seed=5)
    want = np.fft.fft(x, axis=-1)
    yh, yl = tdd.fft_axis_dd(*_pair(x), axis=-1)
    h, l = yh.numpy(), yl.numpy()
    assert tdd.max_err_vs_f64(yh, yl, want) == _jdd().max_err_vs_f64(
        h, l, want)


def test_pairs_are_checked():
    a = torch.zeros(4, dtype=torch.complex64)
    with pytest.raises(ValueError, match="dd pair"):
        tdd.join(a, a.to(torch.complex128))
