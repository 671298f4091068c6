"""The two-level route of the port, on the CPU.

A complex64 axis past one kernel's reach whose length ``outer_split``
accepts runs, on the card, the passes of ``cuda_fft.two_level_passes``
(``csrc/two_level.cu``): short column passes (factor <= 256) whose
stores carry the next step's twiddle and the reorder, then one rows pass
(<= 8192) whose store is the transpose to k order. On a CPU tensor
``_fft_last_big`` runs their plain version, ``two_level_passes_plain``.
These tests hold the pass plans to their caps; the plain version to
numpy in complex128 and to the JAX package's ``pallas_fft.fft_along_axis``
(the Pallas bodies in interpret mode, as ``tests/test_torch_fft_big.py``
runs them) within the complex64 tier 5e-4, forward and inverse, on the
last axis and on axis 0; the two-table twiddle to exp(-+2 pi i p / N) in
float64 within 1e-6 (and the column passes' chain of it within 2e-6);
a transcription of the kernels' index arithmetic
and buffer schedule to the plain version; and the CPU wrapper to the
plain version bit for bit.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft as cf

C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier
TWIDDLE_TOL = 1e-6   # two complex64 entries and their product, in fp32
TWIDDLE_CHAIN_TOL = 2e-6  # that, then up to 16 more fp32 products
SAME_MATH = 1e-5     # complex64 twiddles on both sides, sums reordered

# (n, (col_cap, row_cap) or None for the defaults, passes)
PLANS = [(90000, (16, 64), 4), (131072, (64, 64), 3), (90000, (64, 256), 3),
         (131072, (32, 128), 3), (90000, None, 2), (131072, None, 2)]


def _c64(shape, seed=17):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _check_plan(n, plan, col_cap=cf.MAX_FACTOR, row_cap=cf.radix.MAX_N):
    cols, length = plan
    assert math.prod(cols) * length == n
    assert all(f <= col_cap and cf.pass_length_ok(f) for f in cols)
    assert length <= row_cap and cf.pass_length_ok(length)


# ---------------------------------------------------------------- plans

def test_passes_cover_the_outer_split_sweep():
    """Every length the sweep of ``test_outer_split_sweep_equals_jax``
    sends to the two-level path has passes within the default caps."""
    taken = 0
    for n in range(65537, 65537 + 4000, 7):
        if cf.eligible(n) or cf.outer_split(n) is None:
            continue
        plan = cf.two_level_passes(n)
        assert plan is not None, n
        _check_plan(n, plan)
        taken += 1
    assert taken > 0


@pytest.mark.parametrize("n,plan,unstaged", [
    (5 ** 11, ((125, 125, 125), 25), ((125, 125), 3125)),
    (1 << 24, ((256, 256), 256), None),
    (1 << 20, ((256, 128), 32), ((256,), 4096)),
    (1 << 30, ((256, 256, 256), 64), None),
    (3 * 2 ** 17, ((256, 256), 6), ((256,), 1536)),
    (7 ** 6, ((49, 49), 49), ((49,), 2401)),
    (257 * 256 * 3, None, None), (2 ** 31 - 2, None, None)])
def test_passes_of_long_lengths(n, plan, unstaged):
    """The chip's TWO_LEVEL lengths and a few others: the fewest passes
    whose last is at most STAGED_MAX long (``unstaged``: the plan with
    the fewest passes and any L, where it differs), the shortest last
    pass among those; none for a length with a prime over 251."""
    got = cf.two_level_passes(n)
    assert got == plan
    assert cf.two_level_passes(n, staged_cap=cf.radix.MAX_N) == (unstaged
                                                                or plan)
    if plan is None:
        return
    _check_plan(n, plan)
    cols, length = plan
    assert length <= cf.STAGED_MAX
    # no plan with fewer passes has a staged last pass
    for shorter in range(1, len(cols)):
        assert not any(
            cf._column_factors(n // d, cf.MAX_FACTOR, shorter)
            for d in range(2, cf.STAGED_MAX + 1)
            if n % d == 0 and cf.pass_length_ok(d))


def test_staged_cap_fits_the_rows_pass():
    """STAGED_MAX is the longest power of two whose rows pass holds 16
    rows with their padded exchange buffers, stage table (with the most
    generic roots a length can add) and staged transpose in a block's
    227 KB (``csrc/two_level.cu:rows_pass``, ``radix.cuh:padded_ld``)."""
    def smem(length, extra_roots=0):
        ld = length + ((length - 1) >> 4) + 1
        ld += ld & 1
        return 8 * (2 * 16 * ld + length - 1 + extra_roots
                    + length * (16 | 1))
    assert smem(cf.STAGED_MAX, 251) <= 227 * 1024
    assert smem(2 * cf.STAGED_MAX) > 227 * 1024


@pytest.mark.parametrize("n,caps,passes", PLANS)
def test_small_caps_give_longer_plans(n, caps, passes):
    plan = cf.two_level_passes(n, *(caps or ()))
    _check_plan(n, plan, *(caps or ()))
    assert len(plan[0]) + 1 == passes


def test_single_hand_stage_is_no_pass():
    """A radix plan of one hand-written stage (2 .. 17) is no pass of the
    radix kernels (``radix.cuh:valid_plan``); a prime from 19 is."""
    assert not any(cf.pass_length_ok(f) for f in (2, 4, 8, 16, 13, 17))
    assert all(cf.pass_length_ok(f) for f in (6, 32, 19, 241, 256, 8192))
    assert not cf.pass_length_ok(257) and not cf.pass_length_ok(16384)


# ------------------------------------------------------ plain vs references

@functools.lru_cache(maxsize=None)
def _jax(n, axis, forward):
    x = _c64((2, n) if axis == 1 else (n, 2))
    return x, np.asarray(pallas_fft.fft_along_axis(jnp.asarray(x), axis,
                                                   forward))


def _route_along(x, axis, forward, plan):
    """``cf.fft_along_axis``'s two-level branch with the given passes."""
    n = x.shape[axis]
    moved = torch.from_numpy(x).movedim(axis, -1)
    y = cf.two_level_passes_plain(moved.reshape(-1, n).contiguous(), n,
                                  forward, 1.0 if forward else 1.0 / n, plan)
    return y.reshape(moved.shape).movedim(-1, axis).numpy()


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("n,caps", [(90000, (16, 64)), (131072, (64, 64)),
                                    (90000, None), (131072, None)])
def test_plain_route_matches_numpy_and_jax(n, caps, axis, forward):
    plan = cf.two_level_passes(n, *(caps or ()))
    x, want = _jax(n, axis, forward)
    got = _route_along(x, axis, forward, plan)
    assert got.shape == x.shape and got.dtype == np.complex64
    assert testing.rel_error(got, want) < C64
    f = np.fft.fft if forward else np.fft.ifft
    assert testing.rel_error(got, f(x.astype(np.complex128), axis=axis)) < C64


# --------------------------------------------------------------- twiddle

@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("big_n", [5 ** 11, 2 ** 30])
def test_two_table_twiddle(big_n, forward):
    hi, lo = cf.twiddle_tables_np(big_n, forward)
    s = cf.twiddle_bits(big_n)
    assert hi.dtype == lo.dtype == np.complex64
    assert len(lo) == 1 << s <= 1 << cf.TWIDDLE_LOW_BITS
    assert len(hi) == ((big_n - 1) >> s) + 1 and len(hi) * len(lo) >= big_n
    rng = np.random.default_rng(3)
    p = np.concatenate([np.arange(4096), big_n - 1 - np.arange(4096),
                        (np.arange(1, 64) << s) - 1, np.arange(1, 64) << s,
                        rng.integers(0, big_n, 200000)])
    got = cf.two_table_twiddle(p, big_n, forward)
    assert got.dtype == np.complex64
    sign = -2j if forward else 2j
    want = np.exp(sign * np.pi * p.astype(np.float64) / big_n)
    assert np.abs(got.astype(np.complex128) - want).max() < TWIDDLE_TOL


def _chained(f, cols, big_n, forward, c):
    """The column pass's sink twiddles w_N^(k*c), k < f, for columns c,
    as ``csrc/two_level.cu:TwoLevelColsOut`` forms them in complex64:
    the last stage's outputs k = j + m*step (step = f / R) come in the
    order m = 0 .. R - 1, the first from the two tables, each next the
    one before times w_N^(step*c)."""
    step = f // cf.radix.radix_plan(f)[-1]
    ws = cf.two_table_twiddle(step * c, big_n, forward)
    out = np.empty((f, len(c)), np.complex64)
    for j in range(step):
        cur = cf.two_table_twiddle(j * c, big_n, forward)
        out[j] = cur
        for k in range(j + step, f, step):
            cur = cur * ws
            out[k] = cur
    return out


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("f,big_n", [(256, 1 << 24), (256, 1 << 16),
                                     (125, 5 ** 11), (128, 1 << 20),
                                     (49, 7 ** 6)])
def test_chained_twiddle(f, big_n, forward):
    """R - 1 <= 16 products in fp32 after the tables: within
    TWIDDLE_CHAIN_TOL of exp(-+2 pi i k c / N)."""
    rng = np.random.default_rng(11)
    c = np.concatenate([np.arange(64), big_n // f - 1 - np.arange(64),
                        rng.integers(0, big_n // f, 2000)]).astype(np.int64)
    got = _chained(f, big_n // f, big_n, forward, c)
    sign = -2j if forward else 2j
    k = np.arange(f)[:, None]
    want = np.exp(sign * np.pi * (k * c[None, :]).astype(np.float64) / big_n)
    assert np.abs(got.astype(np.complex128) - want).max() < TWIDDLE_CHAIN_TOL


def test_twiddle_bits_are_half_of_n():
    assert cf.twiddle_bits(1 << 16) == 8
    assert cf.twiddle_bits(5 ** 8) == 10
    assert cf.twiddle_bits(1 << 24) == cf.TWIDDLE_LOW_BITS
    assert cf.twiddle_bits(64) == 3


# ------------------------------------- the kernels' arithmetic, transcribed

def _emulate(x, n, forward, scale, plan, group=16):
    """The launcher as ``csrc/two_level.cu`` writes it, in numpy: the
    buffer schedule of ``dfft_fft_two_level``, the destination of each
    output of ``TwoLevelColsOut::column`` and of the last pass (stored
    from registers by ``TwoLevelRowsOut::row``, and by its staged
    ``flush`` over groups of ``group`` rows), the twiddle from the two
    complex64 tables."""
    cols_f, length = plan
    lengths = (*cols_f, length)
    batch = x.shape[0]
    bufs = {"x": x.reshape(-1).astype(np.complex128),
            "y": np.full(batch * n, np.nan, np.complex128),
            "s": np.full(batch * n, np.nan, np.complex128)}
    src, m1, cols = "x", 1, n
    fft = np.fft.fft if forward else (lambda a, axis: np.fft.ifft(
        a, axis=axis) * a.shape[axis])
    for i, f in enumerate(cols_f):
        dst = "y" if (len(lengths) - 1 - i) % 2 == 0 else "s"
        assert dst != src
        big_n, cols = cols, cols // f
        lead = batch * m1
        v = fft(bufs[src].reshape(lead, f, cols), axis=1)   # [l, k, c]
        l, k, c = np.meshgrid(np.arange(lead), np.arange(f), np.arange(cols),
                              indexing="ij")
        e = l * f * cols + c                 # cols_kernel: the column's offset
        span = f * cols
        blk = e // span
        cc = e - blk * span
        b = blk // m1
        k1 = blk - b * m1
        d = (b * m1 * f + k1) * cols + cc + k * (m1 * cols)
        w = cf.two_table_twiddle((k * cc).ravel(), big_n, forward)
        out = np.full(batch * n, np.nan, np.complex128)
        out[d.ravel()] = v.ravel() * w.astype(np.complex128)
        bufs[dst] = out
        src, m1 = dst, m1 * f
    assert src == "s"
    rows = batch * m1
    v = fft(bufs[src].reshape(rows, length), axis=1) * scale
    r, k = np.meshgrid(np.arange(rows), np.arange(length), indexing="ij")
    b = r // m1
    direct = np.full(batch * n, np.nan, np.complex128)
    direct[(b * m1 * length + (r - b * m1) + m1 * k).ravel()] = v.ravel()
    staged = np.full(batch * n, np.nan, np.complex128)
    for r0 in range(0, rows, group):
        cnt = min(group, rows - r0)
        s = np.arange(cnt)[:, None]
        kk = np.arange(length)[None, :]
        b0 = r0 // m1
        k1 = r0 - b0 * m1 + s
        q = k1 // m1
        d = (b0 + q) * m1 * length + (k1 - q * m1) + m1 * kk
        staged[d.ravel()] = v[r0:r0 + cnt].ravel()
    return direct.reshape(batch, n), staged.reshape(batch, n)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("batch,n,plan", [
    (3, 1080, ((6, 9), 20)), (2, 90000, ((15, 15, 10), 40)),
    (5, 7 * 6 * 19 * 32, ((7 * 6, 19), 32)), (1, 131072, ((64, 64), 32))])
def test_kernel_arithmetic_matches_plain(batch, n, plan, forward):
    x = _c64((batch, n), seed=23)
    scale = 1.0 if forward else 1.0 / n
    want = cf.two_level_passes_plain(torch.from_numpy(x), n, forward, scale,
                                     plan).numpy()
    for got in _emulate(x, n, forward, scale, plan):
        assert np.isfinite(got).all()          # every output written once
        assert testing.rel_error(got.astype(np.complex64), want) < SAME_MATH


# ------------------------------------------------------------- wrapper

@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [90000, 131072])
def test_cpu_wrapper_is_the_route_plain(n, forward):
    x = torch.from_numpy(_c64((3, n), seed=5))
    scale = 1.0 if forward else 1.0 / n
    cf.reset_launches()
    got = cf._fft_last_big(x, n, forward, scale)
    assert torch.equal(got, cf.two_level_passes_plain(x, n, forward, scale))
    jaxlike = cf._fft_last_big_plain(x, n, forward) * scale
    assert testing.rel_error(got.numpy(), jaxlike.numpy()) < C64
    assert cf.launches()["fft_last_big"] == 0 and not cf.ROUTES
    assert not cf.CASES


@pytest.mark.parametrize("axis", [-1, 0])
def test_fft_along_axis_scales_in_the_route(axis):
    """The inverse's 1/n is the route's ``scale``: no multiply after."""
    n = 90000
    x = torch.from_numpy(_c64((2, n) if axis == -1 else (n, 2), seed=9))
    got = cf.fft_along_axis(x, axis, False)
    moved = x.movedim(axis, -1).contiguous()
    want = cf._fft_last_big(moved, n, False, 1.0 / n).movedim(-1, axis)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "empty"])
def test_wrapper_refuses(bad):
    n = 90000
    x = torch.zeros((2, n), dtype=torch.complex64)
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "shape":
        x = x.reshape(4, n // 2)
    elif bad == "strided":
        x = torch.zeros((n, 2), dtype=torch.complex64).t()
    else:
        x = x[:0]
    with pytest.raises(ValueError):
        cf._fft_last_big(x, n, True)


def test_launch_refuses_passes_of_another_length():
    x = torch.zeros((1, 90000), dtype=torch.complex64)
    with pytest.raises(ValueError):
        cf.two_level_launch(x, 90000, True, 1.0, ((250,), 180))


def test_launch_arguments():
    """What the launcher is given for 90000 = 15 * 15 * 10 * 40: the
    lengths, each pass's radices, and each column pass's twiddle bits
    (N = 90000, 6000, 400)."""
    args = cf.two_level_args(90000, True, "cpu", ((15, 15, 10), 40))
    count, lengths, stages, radices, fwd, tables, his, los, bits = args
    assert count == 4 and list(lengths) == [15, 15, 10, 40] and fwd == 1
    assert list(stages) == [len(cf.radix.radix_plan(f))
                            for f in (15, 15, 10, 40)]
    assert list(radices) == [r for f in (15, 15, 10, 40)
                             for r in cf.radix.radix_plan(f)]
    assert list(bits) == [cf.twiddle_bits(m) for m in (90000, 6000, 400)]
    assert len(tables) == 4 and len(his) == len(los) == 3
