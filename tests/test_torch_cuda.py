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
16384, 65536; the generic prime stage: 69 = 3*23, 76 = 4*19, 361 =
19*19, 502 = 2*251, 608, 1216 = 19*64, 8032 = 32*251, the plane at 76,
and past 8192 9728 = 76*128, 8194 = 34*241, 12482 = 79*158, 64256 =
251*256, the last three with a one-stage pass), with the route counted,
on a plane batch the launcher's L2 chunks do not divide, and by the
inverse's scale (a round trip).
The fused stage+codec kernels are held the same way for each codec, both
directions, and a transform along axis 0, a middle axis and the last
axis, on both routes (radix up to 8192, the generic stage at 1216, 608,
76, 482 = 2*241, 722 = 2*19*19 and 361; the two-pass route past it, at
12288, 16384, 9728 = 76*128 and 8194 = 34*241) and both forms (the
column pass, and at cols = 1 the row form); the decode against the
strided or row kernel on the decoded wire and the encode against the
codec's encode of the strided or row kernel's output (bit for bit); the
fused real plans against the unfused ones. The two-level route (a
length past 65536) is held on its default passes and at other pass
plans against its plain version.
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
                                     (1, 16384), (3, 9728), (4, 69),
                                     (5, 361), (7, 502), (3, 608),
                                     (2, 8032), (2, 8194), (3, 12482),
                                     (2, 64256)])
def test_fft_last_kernel_matches_plain(card, batch, n, forward):
    """Every route (two-pass past 8192 at 12288 ... 65536, with batches
    whose row groups straddle a batch row: 5 x 125 rows of 15625; the
    generic stage, one stage alone in a pass at 8194, 12482, 64256)."""
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
                                         (1, 9728, 5), (1, 608, 130),
                                         (2, 361, 7), (3, 502, 17),
                                         (1, 8194, 5), (2, 12482, 3),
                                         (1, 64256, 1)])
def test_fft_axis0_kernel_matches_plain(card, lead, n, cols, forward):
    """Every route (radix: 64 ... 8192, the generic stage at 361, 502,
    608, 1216 = 19*64; two-pass: 12288, 15625, 16384, 65536, with lead >
    1 and cols 1, 3, 5, 16, 33, the generic stage at 9728 = 19*512 and a
    one-stage pass at 8194, 12482, 64256), ragged column tiles and
    columns narrower than a group."""
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
                                         (2, 76, 64), (3, 66, 70),
                                         (2, 608, 76)])
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
                                   (512, "radix"), (76, "radix")])
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


@pytest.mark.parametrize("n", [12288, 15625, 16384, 65536, 8194, 12482])
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
# columns, the last axis (cols 1, the row form), a long radix length
# (8192), one on the generic stage (1216 = 19*64) and lengths on the
# two-pass route, with columns and at cols = 1.
FUSED_SITES = [((64, 37, 3), 0, 4), ((3, 66, 37), 1, 2), ((5, 7, 128), 2, 4),
               ((2, 8192, 3), 1, 4), ((2, 1216, 3), 1, 4),
               ((1, 12288, 3), 1, 4), ((3, 16384), 1, 4),
               ((2, 9728, 1), 1, 2)]
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
    how = cuda_fuse.fused_form(shape[axis], int(np.prod(shape[axis + 1:])))
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
    how = cuda_fuse.fused_form(shape[axis], int(np.prod(shape[axis + 1:])))
    routed = cuda_fft.ROUTES[("decode_fft", how)]
    got = cuda_fuse.fused_decode_fft(parts, torch.complex64, **kw)
    torch.cuda.synchronize()
    assert cuda_fuse.fused_decode_fft.launches == before + 1
    assert cuda_fft.ROUTES[("decode_fft", how)] == routed + 1
    want = cuda_fuse.fused_decode_fft_plain(parts, torch.complex64, **kw)
    assert _err(got, want) < C64 and _rel_l2(got, want) < C64


def _twin(x, forward):
    """The unfused kernel of a fused site over [lead, n, cols]: the row
    kernel at cols = 1 (a last-axis site's), else the strided kernel."""
    lead, n, cols = x.shape
    if cols == 1:
        return cuda_fft.fft_last(x.reshape(lead, n), forward).reshape(x.shape)
    return cuda_fft.fft_axis0(x, forward)


@pytest.mark.parametrize("codec", ["bf16", "int8", "split"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("lead,n,cols", [(2, 512, 16), (2, 512, 257),
                                         (1, 510, 257), (3, 64, 7),
                                         (2, 608, 16), (1, 76, 37),
                                         (2, 482, 3), (4, 722, 1),
                                         (5, 76, 1), (3, 512, 1),
                                         (2, 12288, 5), (3, 16384, 1),
                                         (2, 9728, 3), (2, 8194, 1)])
def test_fused_decode_equals_fft_axis0_of_the_decode(card, codec, forward,
                                                      lead, n, cols):
    """The decode kernel runs its twin's passes (the strided kernel's, or
    at cols = 1 the row kernel's; past 8192 their two) on the exactly
    unpacked wire, so it equals the twin on decode(parts) bit for bit,
    the generic stage's variant included (608 = 8.4.19, 76 = 4.19, 482 =
    2.241, 722 = 2.19.19, 9728 = 76*128, 8194 = 34*241). 257 columns put
    every other int8 row segment at 2 mod 4 bytes, as 76 and 8194 put
    every other row at cols = 1 (the name is the test's own from before
    the row form)."""
    from distributedfft_tpu_torch.ops import cuda_fuse
    from distributedfft_tpu_torch.parallel.exchange import wire_codec

    shape = (lead, n, cols)
    y = _c64(n + cols + lead, shape, card)
    codec_ = wire_codec(codec)
    parts = codec_.encode(y, tile_axis=1, tiles=2)
    kw = dict(fft_axis=1, forward=forward, tile_axis=1, tiles=2,
              wire_dtype=codec)
    assert cuda_fuse.fused_route(n) == cuda_fft.route(n)
    got = cuda_fuse.fused_decode_fft(parts, torch.complex64, **kw)
    want = _twin(codec_.decode(parts, torch.complex64, tile_axis=1,
                               tiles=2), forward)
    assert torch.equal(got, want)


# (lead, n, cols, tiles) of the encode against its unfused form: every
# tile count of 1..4 that divides n; 257 columns (odd rows of int8
# pairs), 510 = 2.3.5.17 (tile edges inside the last stage's stride of
# 30), 96 = 8.4.3 and 8192 (one column per group, no prefetch); 608 =
# 8.4.19 and 76 = 4.19 on the generic stage, 482 = 2.241 and 361 =
# 19.19 (one column) too; and 8 and 6 tiles, more than a thread keeps in
# registers (the amax goes through shared memory).
ENCODE_TWINS = [(lead, n, cols, t)
                for lead, n, cols in [(2, 512, 16), (2, 512, 257),
                                      (1, 510, 257), (3, 64, 7), (2, 96, 5),
                                      (2, 608, 16), (1, 76, 37), (3, 512, 1),
                                      (2, 12288, 5), (3, 16384, 1)]
                for t in (1, 2, 3, 4) if n % t == 0] + [
    (1, 8192, 3, 4), (2, 512, 16, 8), (2, 96, 5, 6), (3, 482, 5, 2),
    (4, 361, 1, 1), (5, 608, 1, 8), (2, 9728, 3, 8), (2, 9728, 1, 2),
    (2, 8194, 1, 2)]


@pytest.mark.parametrize("codec", ["bf16", "int8", "split"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("lead,n,cols,tiles", ENCODE_TWINS)
def test_fused_encode_equals_codec_of_fft_axis0(card, codec, forward, lead,
                                                n, cols, tiles):
    """The encode runs its twin's passes (the strided kernel's, or at
    cols = 1 the row kernel's; past 8192 their two) and packs (bf16) or
    stores and quantizes (int8, split) what the last one produces, so its
    wire parts are the codec's encode of the twin's output on the same
    card, payload and sidecar bit for bit (the name is the test's own
    from before the row form)."""
    from distributedfft_tpu_torch.ops import cuda_fuse
    from distributedfft_tpu_torch.parallel.exchange import wire_codec

    shape = (lead, n, cols)
    x = _c64(n + cols + lead + tiles, shape, card)
    how = cuda_fuse.fused_form(n, cols)
    routed = cuda_fft.ROUTES[("fft_encode", how)]
    got = cuda_fuse.fused_fft_encode(x, fft_axis=1, forward=forward,
                                     tile_axis=1, tiles=tiles,
                                     wire_dtype=codec)
    torch.cuda.synchronize()
    assert cuda_fft.ROUTES[("fft_encode", how)] == routed + 1
    want = wire_codec(codec).encode(_twin(x, forward), tile_axis=1,
                                    tiles=tiles)
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
    """A length beyond one kernel's reach: the two-level route's passes
    (``_fft_last_big``, ``csrc/two_level.cu``), one launch of the route,
    counted under its own route, and no launch of the strided or row
    kernel; against the route's plain version, the JAX-shaped plain
    composition and torch.fft."""
    assert not cuda_fft.eligible(n) and cuda_fft.outer_split(n) is not None
    x = _c64(29, (batch, n), card)
    before = cuda_fft.launches()
    routed = cuda_fft.ROUTES[("fft_last_big", "passes")]
    y = cuda_fft.fft_along_axis(x, 1, forward)
    after = cuda_fft.launches()
    assert after["fft_last_big"] - before["fft_last_big"] == 1
    assert cuda_fft.ROUTES[("fft_last_big", "passes")] == routed + 1
    assert after["fft_axis0"] == before["fft_axis0"]
    assert after["fft_last"] == before["fft_last"]
    scale = 1.0 if forward else 1.0 / n
    assert _err(y, cuda_fft.two_level_passes_plain(x, n, forward,
                                                   scale)) < C64
    assert _err(y, cuda_fft._fft_last_big_plain(x, n, forward) * scale) < C64
    f = torch.fft.fft if forward else torch.fft.ifft
    assert _err(y, f(x.to(torch.complex128), dim=1)) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("batch,n,passes", [
    (3, 241 * 4096, ((241,), 4096)), (2, 95 * 64 * 608, ((95, 64), 608)),
    (1, 256 * 8192, ((256,), 8192)), (2, 6 * 9 * 250 * 40, ((6, 9, 250), 40)),
    (5, 127 * 128 * 64, ((127, 128), 64)), (1, 90000, ((15, 15, 10), 40))])
def test_two_level_route_at_other_plans(card, batch, n, passes, forward):
    """The launcher at pass plans the default caps do not pick: a
    generic prime factor in a column pass (241, 95 = 5*19, 127) and in
    the last (608), a last pass stored straight (4096, 8192) and staged
    (40, 64), three and four passes, groups that cross a batch row."""
    x = _c64(31, (batch, n), card)
    scale = 1.0 if forward else 1.0 / n
    y = cuda_fft.two_level_launch(x, n, forward, scale, passes)
    want = cuda_fft.two_level_passes_plain(x, n, forward, scale, passes)
    assert _err(y, want) < C64
