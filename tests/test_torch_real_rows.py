"""The ``cuda`` executor's real transforms, ``cuda_fft.r2c_half`` /
``c2r_half``: the packed-real trick with the untangle inside the
half-length rows pass on the card (``csrc/real_rows.cu``), and on the CPU
their plain version.

On the CPU: the plain version equals the untangle as it was written
before the fused pass (a copy below, its twiddle table built on every
call) bit for bit; it matches ``numpy.fft.rfft`` / ``irfft`` at even n
with even and odd half lengths, over one row, many rows and a non-last
axis; the twiddle table is uploaded once per (n, dtype, device); and
``cuda_fft.ROUTES`` counts each call by its route.

On the card (``-m cuda``; each skips without one): the fused kernels
against the plain version at half lengths 3 (no radix route: the plain
version), 64, 256, 304 (the generic prime stage), 4096 and 8192, over
one row and a batch that does not fill the last group; the round trip;
and a warm single R2C pair that synchronises nowhere. On the card, run
it alone (it imports no JAX, and the suite's conftest does):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_real_rows.py
"""

import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft, realfft
from distributedfft_tpu_torch.ops.executors import get_c2r, get_r2c
from distributedfft_tpu_torch.utils import trace as ttr

C64 = testing.tolerance(np.complex64)

LENGTHS = [4, 6, 10, 16, 130, 512, 608]


def _real(seed, shape, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)


def _half(seed, shape, device="cpu"):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(y).to(device)


# The untangle as ops/realfft.py wrote it before the fused pass: the
# twiddle built and uploaded on every call, the rest the same ops.
def _old_twiddle(n, cdtype, device):
    k = np.arange(n // 2 + 1)
    w = np.exp(-2j * np.pi * k / n)
    npdt = np.complex128 if cdtype == torch.complex128 else np.complex64
    return torch.from_numpy(w.astype(npdt)).to(device)


def _old_r2c(x, axis, c2c):
    n = x.shape[axis]
    h = n // 2
    cdtype = realfft._cdtype(x.dtype)
    rdtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    xm = torch.movedim(x, axis, -1)
    pair = xm.reshape(xm.shape[:-1] + (h, 2))
    z = torch.complex(pair[..., 0].to(rdtype), pair[..., 1].to(rdtype))
    big = c2c(z.contiguous(), -1, True)
    zf = torch.cat([big, big[..., :1]], dim=-1)
    zr = torch.conj(torch.flip(zf, dims=(-1,)))
    w = _old_twiddle(n, cdtype, x.device)
    out = 0.5 * (zf + zr) - 0.5j * w * (zf - zr)
    return torch.movedim(out, -1, axis)


def _old_c2r(y, n, axis, c2c):
    h = n // 2
    cdtype = realfft._cdtype(y.dtype)
    ym = torch.movedim(y, axis, -1).to(cdtype)
    yr = torch.conj(torch.flip(ym, dims=(-1,)))
    w = torch.conj(_old_twiddle(n, cdtype, y.device))
    e = 0.5 * (ym + yr)
    o = 0.5 * (ym - yr) * w
    big = (e + 1j * o)[..., :h]
    z = c2c(big.contiguous(), -1, False)
    pair = torch.stack([z.real, z.imag], dim=-1)
    xm = pair.reshape(pair.shape[:-2] + (n,))
    return torch.movedim(xm, -1, axis)


# --------------------------------------------------------------- CPU

@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_version_equals_the_old_untangle(n, axis):
    shape = (n, 3) if axis == 0 else (3, n)
    x = _real(n, shape)
    got = cuda_fft.r2c_half(x, axis)
    assert torch.equal(got, _old_r2c(x, axis, cuda_fft.fft_along_axis))
    half = list(shape)
    half[axis] = n // 2 + 1
    y = _half(n + 1, tuple(half))
    back = cuda_fft.c2r_half(y, n, axis)
    assert torch.equal(back, _old_c2r(y, n, axis, cuda_fft.fft_along_axis))


@pytest.mark.parametrize("shape,axis", [((1,), -1), ((7,), -1),
                                        ((None, 5), 0)],
                         ids=["one_row", "rows", "axis0"])
@pytest.mark.parametrize("n", LENGTHS)
def test_matches_numpy(n, shape, axis):
    shape = (n, 5) if shape[0] is None else shape + (n,)
    x = _real(3 * n, shape)
    want = np.fft.rfft(x.numpy().astype(np.float64), axis=axis)
    got = get_r2c("cuda")(x, axis)
    assert got.dtype == torch.complex64
    assert testing.rel_error(got.numpy(), want) < C64
    back = get_c2r("cuda")(torch.from_numpy(want.astype(np.complex64)), n,
                           axis)
    assert testing.rel_error(back.numpy(), x.numpy()) < C64
    inv = np.fft.irfft(want, n=n, axis=axis)
    assert testing.rel_error(back.numpy(), inv) < C64


def test_twiddle_is_uploaded_once():
    n = 202
    for key in [k for k in realfft._TWIDDLES if k[0] == n]:
        del realfft._TWIDDLES[key]
    x = _real(9, (4, n))
    with ttr.capture_events() as ev:
        y = cuda_fft.r2c_half(x, -1)
        cuda_fft.r2c_half(x, -1)
        cuda_fft.c2r_half(y, n, -1)
    counts = Counter(e[0] for e in ev)
    assert counts["host_wait[rfft_twiddle]"] == 1
    assert counts["r2c_untangle"] == 2 and counts["c2r_untangle"] == 1
    assert (n, torch.complex64, "cpu") in realfft._TWIDDLES
    w = realfft.twiddle(n, torch.complex64, "cpu")
    assert torch.equal(w, _old_twiddle(n, torch.complex64, "cpu"))


def test_routes_count_each_call():
    cuda_fft.reset_launches()
    x = _real(11, (2, 3, 64))
    y = get_r2c("cuda")(x, 2)
    get_c2r("cuda")(y, 64, 2)
    cuda_fft.r2c_half(x, 2)
    # the matmul executor's real pair and an odd or 2-long axis do not
    # come here
    get_r2c("matmul")(x, 2)
    get_r2c("cuda")(_real(12, (2, 63)), 1)
    get_r2c("cuda")(_real(13, (5, 2)), 1)
    assert dict(cuda_fft.ROUTES) == {("r2c_half", "plain"): 2,
                                     ("c2r_half", "plain"): 1}
    assert not cuda_fft.CASES
    assert cuda_fft.launches() == {"fft2_last": 0, "fft_axis0": 0,
                                   "fft_last": 0, "fft_last_big": 0,
                                   "r2c_half": 0, "c2r_half": 0}


def test_non_real_input_still_raises():
    with pytest.raises(ValueError, match="REAL"):
        cuda_fft.r2c_half(_half(1, (2, 8)), -1)
    with pytest.raises(ValueError, match="even"):
        cuda_fft.r2c_half(_real(1, (2, 9)), -1)
    with pytest.raises(ValueError, match="hermitian"):
        cuda_fft.c2r_half(_half(1, (2, 6)), 8, -1)


# -------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run this file on one (see its "
                    "docstring)")
    return torch.device("cuda")


def _err(got, want):
    return testing.rel_error(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("h", [3, 64, 256, 304, 4096, 8192])
def test_fused_matches_plain(card, h, rows):
    n = 2 * h
    fused = cuda_fft.route(h) == "radix"
    route = "fused" if fused else "plain"
    x = _real(h + rows, (rows, n), card)
    before = Counter(cuda_fft.ROUTES)
    cases, launched = Counter(cuda_fft.CASES), cuda_fft.launches()
    got = cuda_fft.r2c_half(x, -1)
    y = _half(h + 2 * rows + 1, (rows, h + 1), card)
    back = cuda_fft.c2r_half(y, n, -1)
    torch.cuda.synchronize()
    assert cuda_fft.ROUTES[("r2c_half", route)] == \
        before[("r2c_half", route)] + 1
    assert cuda_fft.ROUTES[("c2r_half", route)] == \
        before[("c2r_half", route)] + 1
    # a launch counts its case, as every kernel wrapper's does
    for name, fwd in (("r2c_half", True), ("c2r_half", False)):
        assert cuda_fft.launches()[name] == launched[name] + fused
        assert cuda_fft.CASES[(name, fwd, (rows, n))] == \
            cases[(name, fwd, (rows, n))] + fused
    assert got.shape == (rows, h + 1) and back.shape == (rows, n)
    assert _err(got, cuda_fft.r2c_half_plain(x, -1)) < C64
    assert _err(back, cuda_fft.c2r_half_plain(y, n, -1)) < C64
    want = np.fft.rfft(x.cpu().numpy().astype(np.float64), axis=-1)
    assert testing.rel_error(got.cpu().numpy(), want) < C64


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("h", [64, 256, 304, 8192])
def test_fused_round_trip(card, h, axis):
    n = 2 * h
    shape = (n, 5) if axis == 0 else (5, n)
    x = _real(7 * h, shape, card)
    before = Counter(cuda_fft.ROUTES)
    back = get_c2r("cuda")(get_r2c("cuda")(x, axis), n, axis)
    assert cuda_fft.ROUTES[("r2c_half", "fused")] == \
        before[("r2c_half", "fused")] + 1
    assert cuda_fft.ROUTES[("c2r_half", "fused")] == \
        before[("c2r_half", "fused")] + 1
    assert back.shape == x.shape
    assert _err(back, x) < C64


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 512])
def test_warm_r2c_pair_synchronises_nowhere(card, n):
    """One warm single R2C pair under ``set_sync_debug_mode("warn")``: no
    synchronising operation and no ``host_wait`` span."""
    fwd = tdfft.plan_dft_r2c_3d((n,) * 3, executor="cuda", device=card)
    bwd = tdfft.plan_dft_c2r_3d((n,) * 3, executor="cuda", device=card)
    x = _real(n, (n,) * 3, card)
    bwd(fwd(x))
    torch.cuda.synchronize(card)
    prev = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                ttr.capture_events() as ev:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            z = bwd(fwd(x))
            torch.cuda.set_sync_debug_mode(prev)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize(card)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert syncs == []
    assert [e[0] for e in ev if e[0].startswith("host_wait[")] == []
    assert _err(z, x) < C64
