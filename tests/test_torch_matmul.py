"""The port's DFT by matmuls, its executors and their label algebra,
against the JAX package's.

``distributedfft_tpu_torch/ops/dft_matmul.py`` against
``distributedfft_tpu/ops/dft_matmul.py`` on the same seeded inputs: the
dense lengths 2-128, the four-step 256 and 1000, the Bluestein primes 521
and 1031, along every axis, both directions, both complex modes, in
complex64 (1e-5 relative) and complex128 (1e-12), each also within its
tier of numpy's float64 FFT; the ``DFFT_MM_SPLIT`` and
``DFFT_MM_DIRECT_MAX`` knobs; the precision tiers (on the CPU every tier
is the full-precision product, as JAX's CPU backend ignores the
precision); the ``torch`` and ``matmul`` executors and their real pairs
against JAX's ``xla`` and ``matmul``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedfft_tpu.ops import dft_matmul as jmm
from distributedfft_tpu.ops import executors as jex
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import dft_matmul as tmm
from distributedfft_tpu_torch.ops import executors as tex

SAME = {np.complex64: 1e-5, np.complex128: 1e-12}
DENSE = [2, 3, 5, 7, 8, 16, 17, 31, 64, 100, 127, 128]
FOUR_STEP = [256, 1000]
BLUESTEIN = [521, 1031]


def _data(shape, dt, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dt)


def _shape_for(n, axis):
    shape = [3, 2, 4]
    shape[axis] = n
    return tuple(shape)


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("n", DENSE + FOUR_STEP + BLUESTEIN)
def test_fft_along_axis_matches_reference(n, dt):
    for axis in range(3):
        x = _data(_shape_for(n, axis), dt, seed=n + axis)
        for mode in ("native", "gauss"):
            for forward in (True, False):
                with tmm.mm_scope(complex_mode=mode):
                    got = tmm.fft_along_axis(torch.from_numpy(x), axis,
                                             forward).numpy()
                with jmm.mm_scope(complex_mode=mode):
                    want = np.asarray(jmm.fft_along_axis(
                        jnp.asarray(x), axis, forward=forward))
                assert got.dtype == dt and got.shape == x.shape
                assert testing.rel_error(got, want) < SAME[dt], (axis, mode)
                fn = np.fft.fft if forward else np.fft.ifft
                ref = fn(x.astype(np.complex128), axis=axis)
                assert testing.rel_error(got, ref) < testing.tolerance(dt)


def test_direct_max_and_bluestein_bounds_match_reference():
    assert tmm.direct_max() == jmm.direct_max() == tmm.DIRECT_MAX
    assert tmm.BLUESTEIN_MIN == jmm.BLUESTEIN_MIN
    for n in (2, 100, 256, 1000, 521, 1031, 4096):
        assert tmm._best_split(n) == jmm._best_split(n)
    for n, m in ((521, 2048), (1031, 4096)):
        for forward in (True, False):
            for a, b in zip(tmm._bluestein_tables(n, m, forward),
                            jmm._bluestein_tables(n, m, forward)):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("spec,n", [("512=4x128", 512), ("256=2x128", 256),
                                    ("1000=8x125,512=4x128", 1000)])
def test_mm_split_override_matches_reference(monkeypatch, spec, n):
    monkeypatch.setenv("DFFT_MM_SPLIT", spec)
    assert tmm._split_override(n) == jmm._split_override(n)
    x = _data((3, n), np.complex128, seed=n)
    got = tmm.fft_along_axis(torch.from_numpy(x), 1).numpy()
    want = np.asarray(jmm.fft_along_axis(jnp.asarray(x), 1))
    assert testing.rel_error(got, want) < SAME[np.complex128]


@pytest.mark.parametrize("spec", ["64=8x8", "512=3x100", "512=1x512",
                                  "abc", "512=4y128"])
def test_mm_split_override_rejects_as_reference(monkeypatch, spec):
    monkeypatch.setenv("DFFT_MM_SPLIT", spec)
    with pytest.raises(ValueError) as mine:
        tmm._split_override(512)
    with pytest.raises(ValueError) as theirs:
        jmm._split_override(512)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("bound", ["256", "16"])
def test_direct_max_override_matches_reference(monkeypatch, bound):
    monkeypatch.setenv("DFFT_MM_DIRECT_MAX", bound)
    assert tmm.direct_max() == jmm.direct_max() == int(bound)
    x = _data((64, 5, 3), np.complex128, seed=1)
    for axis in (0, 1):
        got = tmm.fft_along_axis(torch.from_numpy(x), axis).numpy()
        want = np.asarray(jmm.fft_along_axis(jnp.asarray(x), axis))
        assert testing.rel_error(got, want) < SAME[np.complex128]


@pytest.mark.parametrize("bound", ["1", "x", "0"])
def test_direct_max_override_rejects_as_reference(monkeypatch, bound):
    monkeypatch.setenv("DFFT_MM_DIRECT_MAX", bound)
    with pytest.raises(ValueError) as mine:
        tmm.direct_max()
    with pytest.raises(ValueError) as theirs:
        jmm.direct_max()
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------- tiers

@pytest.mark.parametrize("label", [
    "matmul", "matmul:bf16", "matmul:f32:gauss", "matmul:high",
    "matmul:default", "pallas:highest", "pallas:bf16:fuse",
    "matmul:native", "xla:bf16", "matmul:bf16:f32", "matmul:gauss:gauss",
    "matmul:fast"])
def test_tier_label_algebra_matches_reference(label):
    port = lambda s: s.replace("pallas", "cuda")
    try:
        ref = jex.split_executor(label)
    except ValueError:
        with pytest.raises(ValueError):
            tex.split_executor(port(label))
        return
    assert tex.split_executor(port(label)) == (port(ref[0]),) + ref[1:]


@pytest.mark.parametrize("base,prec,cmode", [
    ("matmul", "bf16", None), ("matmul", "high", "gauss"),
    ("matmul:bf16", "bf16", None), ("matmul:bf16", "f32", None),
    ("pallas:fuse", "highest", None), ("matmul", None, "native"),
    ("matmul", "fast", None)])
def test_tiered_name_matches_reference(base, prec, cmode):
    port = lambda s: s.replace("pallas", "cuda")
    try:
        ref = jex.tiered_name(base, prec, cmode)
    except ValueError:
        with pytest.raises(ValueError):
            tex.tiered_name(port(base), prec, cmode)
        return
    assert tex.tiered_name(port(base), prec, cmode) == port(ref)


def test_tier_scope_is_restored():
    """A tiered label scopes the precision and complex mode over its
    call only; the TF32 switch a product sets is restored after it."""
    seen = []
    real = tmm.fft_along_axis

    def spy(x, axis, forward=True):
        seen.append((tmm.mm_precision(), tmm.complex_mode()))
        return real(x, axis, forward)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    x = torch.from_numpy(_data((4, 16), np.complex64, seed=2))
    try:
        tmm.fft_along_axis = spy
        tex.get_executor("matmul:bf16:gauss")(x, (1,), True)
        tex.get_executor("matmul")(x, (1,), True)
        tex.get_executor("cuda:f32")(x.to(torch.complex128), (1,), True)
    finally:
        tmm.fft_along_axis = real
    assert seen == [("default", "gauss"), ("highest", "native"),
                    ("high", "native")]
    with tmm._tf32(not tf32):
        assert torch.backends.cuda.matmul.allow_tf32 == (not tf32)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


def test_tiers_on_the_cpu_are_full_precision():
    """Every tier is the full fp32 product on the CPU, as JAX's CPU
    backend ignores the precision: the three tiers agree to the bit."""
    x = torch.from_numpy(_data((8, 512), np.complex64, seed=3))
    outs = [tex.get_executor(f"matmul:{t}")(x, (1,), True)
            for t in tex.MM_TIERS]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert testing.rel_error(outs[0].numpy(), np.fft.fft(
        x.numpy().astype(np.complex128), axis=1)) < testing.tolerance(
            np.complex64)


# ------------------------------------------------------------- executors

@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("port,ref", [("torch", "xla"), ("matmul", "matmul"),
                                      ("cuda", "pallas")])
def test_executors_match_reference(port, ref, dt):
    x = _data((6, 10, 12), dt, seed=4)
    for axes in ((0, 1, 2), (1,), (2, 0)):
        for forward in (True, False):
            got = tex.get_executor(port)(torch.from_numpy(x), axes,
                                         forward).numpy()
            want = np.asarray(jex.get_executor(ref)(jnp.asarray(x), axes,
                                                    forward))
            assert testing.rel_error(got, want) < SAME[dt]


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
@pytest.mark.parametrize("n", [12, 13, 2, 64])
@pytest.mark.parametrize("port,ref", [("torch", "xla"), ("matmul", "matmul"),
                                      ("cuda", "pallas")])
def test_real_pairs_match_reference(port, ref, n, rdt):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 5, n)).astype(rdt)
    dt = np.complex64 if rdt == np.float32 else np.complex128
    for axis in (2, 0):
        xa = np.ascontiguousarray(np.swapaxes(x, 2, axis))
        got = tex.get_r2c(port)(torch.from_numpy(xa), axis).numpy()
        want = np.asarray(jex.get_r2c(ref)(jnp.asarray(xa), axis))
        assert got.dtype == dt and got.shape == want.shape
        assert testing.rel_error(got, want) < SAME[dt]
        back = tex.get_c2r(port)(torch.from_numpy(got), xa.shape[axis],
                                 axis).numpy()
        assert testing.rel_error(back, xa) < testing.tolerance(dt)


def test_unregistered_real_pair_falls_back_to_torch():
    """As the JAX package falls back to its xla pair, an unregistered name
    takes the torch pair (the C2C executor of that name still raises)."""
    assert tex.get_r2c("nope") is tex.get_r2c("torch")
    assert tex.get_c2r("nope") is tex.get_c2r("torch")
    with pytest.raises(ValueError, match="unknown executor"):
        tex.get_executor("nope")
    assert tex.available_executors() == ["cuda", "matmul", "torch",
                                        "torch_minor"]
