"""The CUDA kernels on the card, at shapes ``chip_smoke.py`` does not reach.

Every test here needs an NVIDIA card and ``nvcc``; without them each one
skips. On the card, run this file alone (it imports no JAX, and the
suite's conftest does):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

It holds each kernel against its plain PyTorch version on ragged
batches and column counts (a block's tail), on odd lengths, and on
lengths whose sequences do not fit a block's shared memory (the
device-scratch route), plus the plans against the same plans on the CPU.
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
                                     (3, 8192), (2, 65536)])
def test_fft_last_kernel_matches_plain(card, batch, n, forward):
    x = _c64(n, (batch, n), card)
    before = cuda_fft.fft_last.launches
    got = cuda_fft.fft_last(x, forward)
    torch.cuda.synchronize()
    assert cuda_fft.fft_last.launches == before + 1
    assert _err(got, cuda_fft.fft_last_plain(x, forward)) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("lead,n,cols", [(1, 64, 1), (3, 66, 37),
                                         (2, 510, 130), (1, 4096, 9),
                                         (2, 8192, 33), (1, 65536, 3)])
def test_fft_axis0_kernel_matches_plain(card, lead, n, cols, forward):
    x = _c64(n + cols, (lead, n, cols), card)
    before = cuda_fft.fft_axis0.launches
    got = cuda_fft.fft_axis0(x, forward)
    torch.cuda.synchronize()
    assert cuda_fft.fft_axis0.launches == before + 1
    assert _err(got, cuda_fft.fft_axis0_plain(x, forward)) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("batch,ny,nz", [(3, 64, 72), (2, 510, 512),
                                         (1, 64, 8192), (1, 8192, 64)])
def test_fft2_last_kernel_matches_plain(card, batch, ny, nz, forward):
    x = _c64(ny + nz, (batch, ny, nz), card)
    before = cuda_fft.fft2_last.launches
    got = cuda_fft.fft2_last(x, forward)
    torch.cuda.synchronize()
    assert cuda_fft.fft2_last.launches == before + 1
    assert _err(got, cuda_fft.fft2_last_plain(x, forward)) < C64


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
