"""The CUDA kernels on the card, at shapes ``chip_smoke.py`` does not reach.

Every test here needs an NVIDIA card and ``nvcc``; without them each one
skips. On the card, run this file alone (it imports no JAX, and the
suite's conftest does):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

It holds each kernel against its plain PyTorch version on ragged
batches and column counts (a block's tail), on odd lengths, and on
lengths whose sequences do not fit a block's shared memory (the
device-scratch route), plus the plans against the same plans on the CPU.
The row, strided and plane kernels are held on each of their routes
(radix: 256, 510, 512, ...; two-pass radix past 8192: 12288, 15625,
16384, 65536; direct: 76 = 4*19, 1216 = 19*64, 9728 = 19*512), with
the route counted, on a plane batch the launcher's L2 chunks do not
divide, and by the inverse's scale (a round trip).
The fused stage+codec kernels are held the same way for each codec, both
directions, and a transform along axis 0, a middle axis and the last
axis, on both routes; on the radix route the decode against the strided
kernel on the decoded wire and the encode against the codec's encode of
the strided kernel's output (bit for bit); the fused real plans against
the unfused ones.
"""

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.ops import cuda_fft

pytestmark = pytest.mark.cuda

C64 = testing.tolerance(np.complex64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run this file on one (see its "
                    "docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    return torch.device("cuda")


def _c64(seed, shape, device):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(x).to(device)


def _err(got, want):
    return testing.rel_error(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("batch,n", [(7, 64), (13, 66), (5, 510), (3, 4096),
                                     (3, 8192), (2, 65536), (9, 256),
                                     (33, 512), (5, 76), (4, 75),
                                     (3, 12288), (5, 15625), (17, 16384),
                                     (1, 16384), (3, 9728)])
def test_fft_last_kernel_matches_plain(card, batch, n, forward):
    """Every route (two-pass past 8192 at 12288 ... 65536, with batches
    whose row groups straddle a batch row: 5 x 125 rows of 15625)."""
    x = _c64(n, (batch, n), card)
    before = cuda_fft.fft_last.launches
    how = cuda_fft.route(n)
    routed = cuda_fft.ROUTES[("fft_last", how)]
    got = cuda_fft.fft_last(x, forward)
    torch.cuda.synchronize()
    assert cuda_fft.fft_last.launches == before + 1
    assert cuda_fft.ROUTES[("fft_last", how)] == routed + 1
    assert _err(got, cuda_fft.fft_last_plain(x, forward)) < C64
    ref = (torch.fft.fft if forward else torch.fft.ifft)(x, dim=1)
    assert _err(got, ref) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("lead,n,cols", [(1, 64, 1), (3, 66, 37),
                                         (2, 510, 130), (1, 4096, 9),
                                         (2, 8192, 33), (1, 65536, 3),
                                         (3, 512, 257), (1, 512, 16),
                                         (3, 1024, 7), (2, 1216, 9),
                                         (1, 16384, 5), (2, 12288, 33),
                                         (3, 15625, 1), (2, 16384, 3),
                                         (1, 65536, 1), (2, 65536, 16),
                                         (1, 9728, 5)])
def test_fft_axis0_kernel_matches_plain(card, lead, n, cols, forward):
    """Every route (radix: 64 ... 8192; two-pass: 12288, 15625, 16384,
    65536, with lead > 1 and cols 1, 3, 5, 16, 33; direct: 1216 = 19*64,
    9728 = 19*512), ragged column tiles and columns narrower than a
    group."""
    x = _c64(n + cols, (lead, n, cols), card)
    before = cuda_fft.fft_axis0.launches
    how = cuda_fft.route(n)
    routed = cuda_fft.ROUTES[("fft_axis0", how)]
    got = cuda_fft.fft_axis0(x, forward)
    torch.cuda.synchronize()
    assert cuda_fft.fft_axis0.launches == before + 1
    assert cuda_fft.ROUTES[("fft_axis0", how)] == routed + 1
    assert _err(got, cuda_fft.fft_axis0_plain(x, forward)) < C64
    ref = (torch.fft.fft if forward else torch.fft.ifft)(x, dim=1)
    assert _err(got, ref) < C64


def test_fft_axis0_runs_in_place_on_the_plane(card):
    """The plane's Y pass is the strided kernel's column pass run in
    place (x == y); its result is the out-of-place one's."""
    x = _c64(5, (3, 510, 512), card)
    want = cuda_fft.fft_axis0(cuda_fft.fft_last(x.reshape(-1, 512))
                              .reshape(x.shape))
    assert cuda_fft.route2d(510, 512) == "radix"
    assert _rel_l2(cuda_fft.fft2_last(x), want) < 1e-6


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("batch,ny,nz", [(3, 64, 72), (2, 510, 512),
                                         (1, 64, 8192), (1, 8192, 64),
                                         (3, 256, 256), (13, 512, 512),
                                         (2, 76, 64), (3, 66, 70)])
def test_fft2_last_kernel_matches_plain(card, batch, ny, nz, forward):
    x = _c64(ny + nz, (batch, ny, nz), card)
    before = cuda_fft.fft2_last.launches
    how = cuda_fft.route2d(ny, nz)
    routed = cuda_fft.ROUTES[("fft2_last", how)]
    got = cuda_fft.fft2_last(x, forward)
    torch.cuda.synchronize()
    assert cuda_fft.fft2_last.launches == before + 1
    assert cuda_fft.ROUTES[("fft2_last", how)] == routed + 1
    assert _err(got, cuda_fft.fft2_last_plain(x, forward)) < C64


@pytest.mark.parametrize("n,how", [(256, "radix"), (510, "radix"),
                                   (512, "radix"), (76, "direct")])
def test_routes_and_inverse_scale(card, n, how):
    """Each route as :func:`route` names it; the inverse carries 1/n (a
    row round trip) and 1/(ny*nz) (a plane round trip, chunked and in one
    go), and agrees with torch.fft."""
    assert cuda_fft.route(n) == how
    x = _c64(n + 1, (6, n), card)
    y = cuda_fft.fft_last(x, True)
    assert _err(y, torch.fft.fft(x)) < C64
    assert _err(cuda_fft.fft_last(y, False), x) < C64
    p = _c64(n + 2, (5, n, 64), card)
    q = cuda_fft.fft2_last(p, True)
    assert _err(q, torch.fft.fft2(p)) < C64
    for chunk in (2, 5):
        back = cuda_fft.plane_launch(q, False, chunk)
        assert _err(back, p) < C64


@pytest.mark.parametrize("n", [12288, 15625, 16384, 65536])
def test_two_pass_route_scale_and_round_trip(card, n):
    """The two-pass route: the inverse left unscaled (``normalize=False``,
    a stage of a composed transform) is n times the scaled one, and a row
    and a strided round trip give the input back."""
    assert cuda_fft.route(n) == "radix2"
    x = _c64(n + 3, (3, n), card)
    y = cuda_fft.fft_last(x, True)
    raw = cuda_fft.fft_last(y, False, normalize=False)
    assert _err(raw, n * x) < C64
    assert _err(raw, cuda_fft.fft_last_plain(y, False, normalize=False)) < C64
    assert _err(cuda_fft.fft_last(y, False), x) < C64
    c = _c64(n + 4, (2, n, 7), card)
    d = cuda_fft.fft_axis0(c, True)
    raw = cuda_fft.fft_axis0(d, False, normalize=False)
    assert _err(raw, cuda_fft.fft_axis0_plain(d, False, normalize=False)) < C64
    assert _err(cuda_fft.fft_axis0(d, False), c) < C64


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    with pytest.raises(ValueError):
        cuda_fft.fft_last(torch.zeros((2, 64), dtype=torch.complex128,
                                      device=card))
    with pytest.raises(ValueError):
        cuda_fft.fft_axis0(torch.zeros((1, 64, 8), dtype=torch.complex64,
                                       device=card).transpose(1, 2))
    with pytest.raises(ValueError):
        cuda_fft.fft2_last(torch.zeros((1, 64, 16), dtype=torch.complex64,
                                       device=card))


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("shape", [(64, 64, 64), (66, 70, 64)])
def test_plans_on_the_card_match_the_cpu(card, shape, p):
    x = testing.make_world_data(shape, np.complex64)
    results = {}
    for device in ("cpu", card):
        fwd = tdfft.plan_dft_c2c_3d(shape, p, device=device)
        bwd = tdfft.plan_dft_c2c_3d(shape, p, direction=tdfft.BACKWARD,
                                    device=device)
        y = fwd(torch.from_numpy(x).to(device))
        results[str(device)] = (y.cpu(), bwd(y).cpu())
    (y_cpu, r_cpu), (y_gpu, r_gpu) = results["cpu"], results["cuda"]
    assert testing.rel_error(y_gpu.numpy(), y_cpu.numpy()) < C64
    assert testing.rel_error(y_gpu.numpy(),
                             np.fft.fftn(x.astype(np.complex128))) < C64
    assert testing.rel_error(r_gpu.numpy(), x) < C64


# ------------------------------------------------ fused stage+codec kernels

# (shape, axis, tiles): axis 0 (lead 1), a middle axis with ragged
# columns, the last axis (cols 1), a long radix length (8192), a
# direct-route one (1216 = 19*64) and one the strided kernel takes by
# its two-pass route, which the fused kernels take by the direct one.
FUSED_SITES = [((64, 37, 3), 0, 4), ((3, 66, 37), 1, 2), ((5, 7, 128), 2, 4),
               ((2, 8192, 3), 1, 4), ((2, 1216, 3), 1, 4),
               ((1, 12288, 3), 1, 4)]
LEVELS = {"bf16": None, "int8": 127, "split": 32767}


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("codec", ["bf16", "int8", "split"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", FUSED_SITES)
def test_fft_encode_kernel_matches_plain(card, codec, forward, shape, axis,
                                         tiles):
    """Sidecars bit-identical, mantissas at most one level apart (the
    kernel's and the plain version's fp32 sums differ in rounding before
    the quantizer), the decoded payloads within one level."""
    from distributedfft_tpu_torch.ops import cuda_fuse
    from distributedfft_tpu_torch.parallel.exchange import wire_codec

    x = _c64(sum(shape) + tiles, shape, card)
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    before = cuda_fuse.fused_fft_encode.launches
    how = cuda_fuse.fused_route(shape[axis])
    routed = cuda_fft.ROUTES[("fft_encode", how)]
    got = cuda_fuse.fused_fft_encode(x, **kw)
    torch.cuda.synchronize()
    assert cuda_fuse.fused_fft_encode.launches == before + 1
    assert cuda_fft.ROUTES[("fft_encode", how)] == routed + 1
    want = cuda_fuse.fused_fft_encode_plain(x, **kw)
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype)
                                                 for w in want]
    codec_ = wire_codec(codec)
    dec = lambda p: codec_.decode(p, torch.complex64, tile_axis=axis,
                                  tiles=tiles)
    if codec == "bf16":
        # One bf16 level at each value, plus the fp32 difference of the
        # two transforms before the cast (which is all there is near 0).
        g, w = got[0].float(), want[0].float()
        slack = 1e-6 * w.abs().max()
        assert bool(torch.all((g - w).abs()
                              <= 2.0 ** -8 * (g.abs() + w.abs()) + slack))
    else:
        assert torch.equal(got[1], want[1])
        diff = (got[0].int() - want[0].int()).abs().max().item()
        assert diff <= 1
    step = 2.0 ** -8 if codec == "bf16" else 1.0 / LEVELS[codec]
    ref = dec(want)
    assert (dec(got) - ref).abs().max().item() <= 2 * step * \
        ref.abs().max().item()


@pytest.mark.parametrize("codec", ["bf16", "int8", "split"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("shape,axis,tiles", FUSED_SITES)
def test_decode_fft_kernel_matches_plain(card, codec, forward, shape, axis,
                                         tiles):
    """The unpack is exact, so the kernel and the plain version agree to
    fp32 rounding of the same transform, on the route of the length."""
    from distributedfft_tpu_torch.ops import cuda_fuse
    from distributedfft_tpu_torch.parallel.exchange import wire_codec

    y = _c64(sum(shape) + tiles + 1, shape, card)
    parts = wire_codec(codec).encode(y, tile_axis=axis, tiles=tiles)
    kw = dict(fft_axis=axis, forward=forward, tile_axis=axis, tiles=tiles,
              wire_dtype=codec)
    before = cuda_fuse.fused_decode_fft.launches
    how = cuda_fuse.fused_route(shape[axis])
    routed = cuda_fft.ROUTES[("decode_fft", how)]
    got = cuda_fuse.fused_decode_fft(parts, torch.complex64, **kw)
    torch.cuda.synchronize()
    assert cuda_fuse.fused_decode_fft.launches == before + 1
    assert cuda_fft.ROUTES[("decode_fft", how)] == routed + 1
    want = cuda_fuse.fused_decode_fft_plain(parts, torch.complex64, **kw)
    assert _err(got, want) < C64 and _rel_l2(got, want) < C64


@pytest.mark.parametrize("codec", ["bf16", "int8", "split"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("lead,n,cols", [(2, 512, 16), (2, 512, 257),
                                         (1, 510, 257), (3, 64, 7)])
def test_fused_decode_equals_fft_axis0_of_the_decode(card, codec, forward,
                                                      lead, n, cols):
    """The radix decode kernel runs the strided kernel's stages on the
    exactly unpacked wire, so it equals fft_axis0(decode(parts)) (within
    1e-6 L2; the shared stage code makes them equal to the bit). 257
    columns put every other int8 row segment at 2 mod 4 bytes."""
    from distributedfft_tpu_torch.ops import cuda_fuse
    from distributedfft_tpu_torch.parallel.exchange import wire_codec

    shape = (lead, n, cols)
    y = _c64(n + cols + lead, shape, card)
    codec_ = wire_codec(codec)
    parts = codec_.encode(y, tile_axis=1, tiles=2)
    kw = dict(fft_axis=1, forward=forward, tile_axis=1, tiles=2,
              wire_dtype=codec)
    assert cuda_fft.route(n) == "radix"
    got = cuda_fuse.fused_decode_fft(parts, torch.complex64, **kw)
    want = cuda_fft.fft_axis0(
        codec_.decode(parts, torch.complex64, tile_axis=1, tiles=2), forward)
    assert _rel_l2(got, want) <= 1e-6


# (lead, n, cols, tiles) of the encode against its unfused form: every
# tile count of 1..4 that divides n; 257 columns (odd rows of int8
# pairs), 510 = 2.3.5.17 (tile edges inside the last stage's stride of
# 30), 96 = 8.4.3 and 8192 (one column per group, no prefetch); and 8
# and 6 tiles, more than a thread keeps in registers (the amax goes
# through shared memory).
ENCODE_TWINS = [(lead, n, cols, t)
                for lead, n, cols in [(2, 512, 16), (2, 512, 257),
                                      (1, 510, 257), (3, 64, 7), (2, 96, 5)]
                for t in (1, 2, 3, 4) if n % t == 0] + [
    (1, 8192, 3, 4), (2, 512, 16, 8), (2, 96, 5, 6)]


@pytest.mark.parametrize("codec", ["bf16", "int8", "split"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("lead,n,cols,tiles", ENCODE_TWINS)
def test_fused_encode_equals_codec_of_fft_axis0(card, codec, forward, lead,
                                                n, cols, tiles):
    """The radix encode runs the strided kernel's column pass and packs
    (bf16) or stores and quantizes (int8, split) what it produces, so its
    wire parts are the codec's encode of fft_axis0(x) on the same card,
    payload and sidecar bit for bit."""
    from distributedfft_tpu_torch.ops import cuda_fuse
    from distributedfft_tpu_torch.parallel.exchange import wire_codec

    shape = (lead, n, cols)
    x = _c64(n + cols + lead + tiles, shape, card)
    assert cuda_fft.route(n) == "radix"
    routed = cuda_fft.ROUTES[("fft_encode", "radix")]
    got = cuda_fuse.fused_fft_encode(x, fft_axis=1, forward=forward,
                                     tile_axis=1, tiles=tiles,
                                     wire_dtype=codec)
    torch.cuda.synchronize()
    assert cuda_fft.ROUTES[("fft_encode", "radix")] == routed + 1
    want = wire_codec(codec).encode(cuda_fft.fft_axis0(x, forward),
                                    tile_axis=1, tiles=tiles)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("codec", ["bf16", "int8", "split"])
@pytest.mark.parametrize("p,shape", [(2, (64, 64, 128)), (4, (66, 70, 128))])
def test_fused_real_plans_on_the_card(card, codec, p, shape):
    """R2C forward and C2R backward with the fused codec on the card: as
    accurate as the unfused chain with the same codec (within 10%)."""
    x = testing.make_world_data(shape, np.float32, seed=3)
    x = torch.from_numpy((x - x.mean()).astype(np.float32)).to(card)
    spec = torch.fft.rfftn(x.double())
    errs = {}
    for fuse in (False, True):
        fwd = tdfft.plan_dft_r2c_3d(shape, p, wire_dtype=codec, fuse=fuse,
                                    device=card)
        bwd = tdfft.plan_dft_c2r_3d(shape, p, wire_dtype=codec, fuse=fuse,
                                    device=card)
        y = fwd(x)
        errs[fuse] = (_rel_l2(y.to(torch.complex128), spec),
                      _rel_l2(bwd(y).double(), x.double()))
    for unfused, fused in zip(errs[False], errs[True]):
        assert fused <= 1.1 * unfused


@pytest.mark.parametrize("codec", ["int8", "split"])
def test_fft_encode_steps_match_the_codec_at_powers_of_two(card, codec):
    """A quantized round trip makes amax / levels land on a power of two
    up to fp32 noise. There the kernel's step must still be the plain
    codec's on the same card: both evaluate log(q) * (1/ln 2) with the
    card's logf. (At an exact power of two the CPU's log can give the
    next step up, as XLA's does; the card's gives the exact one.) The
    input is a delta, whose DFT is the constant x[0] exactly, so each
    tile's amax is |Re x[0]| and |Im x[0]|."""
    from distributedfft_tpu_torch.ops import cuda_fuse

    levels = np.float32(LEVELS[codec])
    for k in range(-20, 20):
        a = np.float32(levels * np.float32(2.0) ** k)
        for re, im in ((a, np.nextafter(a, np.float32(np.inf))),
                       (np.nextafter(a, np.float32(0)), a)):
            x = torch.zeros((64, 1), dtype=torch.complex64, device=card)
            x[0, 0] = complex(float(re), float(im))
            kw = dict(fft_axis=0, forward=True, tile_axis=0, tiles=4,
                      wire_dtype=codec)
            got = cuda_fuse.fused_fft_encode(x, **kw)
            want = cuda_fuse.fused_fft_encode_plain(x, **kw)
            assert torch.equal(got[1], want[1]), (k, re, im)
            assert torch.equal(got[0], want[0]), (k, re, im)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("batch,n", [(4, 1 << 20), (1, 5 ** 8),
                                     (2, 3 * 2 ** 17)])
def test_two_level_axis_matches_plain_and_torch_fft(card, batch, n, forward):
    """A length beyond one kernel's reach: the strided and row kernels
    with the twiddle and transpose between them (``_fft_last_big``),
    against its plain composition and torch.fft, one launch of each."""
    assert not cuda_fft.eligible(n) and cuda_fft.outer_split(n) is not None
    x = _c64(29, (batch, n), card)
    before = cuda_fft.launches()
    y = cuda_fft.fft_along_axis(x, 1, forward)
    after = cuda_fft.launches()
    assert after["fft_axis0"] - before["fft_axis0"] == 1
    assert after["fft_last"] - before["fft_last"] == 1
    big = cuda_fft._fft_last_big(x, n, forward)
    assert _err(big, cuda_fft._fft_last_big_plain(x, n, forward)) < C64
    f = torch.fft.fft if forward else torch.fft.ifft
    assert _err(y, f(x.to(torch.complex128), dim=1)) < C64
