"""The port's row, strided and plane kernels against the JAX package's
Pallas kernels.

Each kernel of ``distributedfft_tpu_torch/ops/cuda_fft.py`` runs here,
on CPU tensors, as its plain PyTorch version; the JAX side runs the
Pallas kernel bodies of ``distributedfft_tpu/ops/pallas_fft.py`` in
interpret mode, outside ``shard_map``, as ``tests/test_pallas.py`` does.
The strided kernel's plain version computes the Pallas kernel's
four-step sums with the same float64-built LUTs; the row and plane
kernels' plain versions run the radix route's stages
(``tests/test_torch_radix.py``) at every length here, in float64 from
complex64 tables. Either way both sides carry only fp32-level rounding,
so they agree to 1e-5 relative; against numpy they hold the complex64
tier, 5e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributedfft_tpu import native as jax_native
from distributedfft_tpu import testing as jtu
from distributedfft_tpu.ops import executors as jex
from distributedfft_tpu.ops import pallas_fft
from distributedfft_tpu_torch import native, testing
from distributedfft_tpu_torch.ops import cuda_fft
from distributedfft_tpu_torch.ops.executors import get_executor

SAME_MATH = 1e-5                      # fp32-level rounding on both sides
C64 = testing.tolerance(np.complex64)  # 5e-4, the complex64 tier


def _c64(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _err(got, want):
    return testing.rel_error(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------ identities

@pytest.mark.parametrize("n", [16, 64, 66, 72, 100, 510, 512, 4096,
                               8191, 65536, 65537, 131072])
def test_split_and_eligibility_match_reference(n):
    assert cuda_fft.split_for(n) == pallas_fft.split_for(n)
    assert cuda_fft.eligible(n) == pallas_fft.eligible(n)
    assert native.balanced_split(n, 256) == jax_native._balanced_split_py(n, 256)


@pytest.mark.parametrize("ny,nz", [(64, 64), (64, 72), (512, 512),
                                   (512, 1024), (1024, 1024), (16, 512)])
def test_eligible2d_matches_reference(ny, nz):
    assert cuda_fft.eligible2d(ny, nz) == pallas_fft.eligible2d(ny, nz)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [64, 66, 510, 512, 65536])
def test_luts_bit_identical(n, forward):
    n1, n2 = cuda_fft.split_for(n)
    mine = cuda_fft.tables_np(n, forward)
    ref = pallas_fft._tables_np_cached(n, n1, n2, forward, 1, 1)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype == np.complex64
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("shape,dtype", [((8, 6, 4), np.complex64),
                                         ((5, 7, 3), np.complex128),
                                         ((4, 4), np.float32)])
def test_world_data_bit_identical(shape, dtype):
    a = testing.make_world_data(shape, dtype, seed=4242)
    b = jtu.make_world_data(shape, dtype, seed=4242)
    assert a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()
    assert testing.TOLERANCE == jtu.TOLERANCE


# ------------------------------------------------- kernel vs Pallas body

@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [64, 66, 512])
def test_fft_last_matches_pallas_1d_kernel(n, forward):
    x = _c64(1, (6, n))
    got = cuda_fft.fft_last(torch.from_numpy(x), forward)
    want = np.asarray(pallas_fft._fft_eligible(jnp.asarray(x), n, forward))
    if not forward:   # the Pallas body leaves the inverse unscaled
        want = want / n
    assert _err(got, want) < SAME_MATH
    ref = np.fft.fft(x, axis=1) if forward else np.fft.ifft(x, axis=1)
    assert _err(got, ref) < C64


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [64, 66, 512])
def test_fft_axis0_matches_pallas_strided_kernel(n, forward):
    x = _c64(2, (n, 3, 5))
    got = cuda_fft.fft_axis0(torch.from_numpy(x.reshape(1, n, 15)), forward)
    want = np.asarray(pallas_fft.fft_axis0(jnp.asarray(x), forward))
    assert _err(got.reshape(x.shape), want) < SAME_MATH
    ref = np.fft.fft(x, axis=0) if forward else np.fft.ifft(x, axis=0)
    assert _err(got.reshape(x.shape), ref) < C64


@pytest.mark.parametrize("forward", [True, False])
def test_fft_axis0_lead_replaces_vmap(forward):
    """The strided kernel's leading batch dimension is the JAX package's
    vmap over middle axes (``fft_along_axis`` on axis 1)."""
    x = _c64(3, (3, 66, 4))
    got = cuda_fft.fft_axis0(torch.from_numpy(x), forward)
    want = np.asarray(pallas_fft.fft_along_axis(jnp.asarray(x), 1, forward))
    assert _err(got, want) < SAME_MATH


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("ny,nz", [(64, 64), (64, 72)])
def test_fft2_last_matches_pallas_plane_kernel(ny, nz, forward):
    x = _c64(4, (2, ny, nz))
    got = cuda_fft.fft2_last(torch.from_numpy(x), forward)
    want = np.asarray(pallas_fft.fft2_last(jnp.asarray(x), forward))
    assert _err(got, want) < SAME_MATH
    ref = np.fft.fft2(x) if forward else np.fft.ifft2(x)
    assert _err(got, ref) < C64


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("forward", [True, False])
def test_fft_along_axis_matches_reference(axis, forward):
    x = _c64(5, (64, 66, 72))
    got = cuda_fft.fft_along_axis(torch.from_numpy(x), axis, forward)
    want = np.asarray(pallas_fft.fft_along_axis(jnp.asarray(x), axis, forward))
    assert _err(got, want) < SAME_MATH


@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2), (0, 2), (1,)])
@pytest.mark.parametrize("forward", [True, False])
def test_cuda_executor_matches_pallas_executor(axes, forward):
    x = _c64(6, (64, 64, 72))
    got = get_executor("cuda")(torch.from_numpy(x), axes, forward)
    want = np.asarray(jex.get_executor("pallas")(jnp.asarray(x), axes, forward))
    assert _err(got, want) < SAME_MATH


# ------------------------------------------------------ routing and guards

def test_wrappers_count_no_launch_on_cpu():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    cuda_fft.reset_launches()
    x = torch.from_numpy(_c64(7, (2, 64, 64)))
    cuda_fft.fft2_last(x)
    cuda_fft.fft_axis0(x)
    cuda_fft.fft_last(x.reshape(-1, 64))
    assert cuda_fft.launches() == {"fft2_last": 0, "fft_axis0": 0,
                                   "fft_last": 0}


def test_plane_too_large_runs_per_axis_and_is_counted():
    """Both axes eligible but ny*nz over the plane gate: the executor runs
    the strided and 1D kernels per axis and counts ``plane2d``, as the
    JAX ``pallas`` executor does."""
    assert not cuda_fft.eligible2d(1024, 1024)
    x = torch.from_numpy(_c64(8, (1, 1024, 1024)))
    before = cuda_fft.FALLBACKS[(2, "plane2d")]
    got = get_executor("cuda")(x, (1, 2), True)
    assert cuda_fft.FALLBACKS[(2, "plane2d")] == before + 1
    assert _err(got, np.fft.fft2(x.numpy())) < C64


@pytest.mark.parametrize("n,dtype,reason", [
    (16, torch.complex64, "length"),
    (8191, torch.complex64, "length"),
    (64, torch.complex128, "dtype"),
])
def test_executor_raises_with_reason(n, dtype, reason):
    """Named for what it checked before the dft_matmul route was ported
    (the executor raised here): a length or dtype the kernels do not take
    now runs dft_matmul, its reason counted, and matches the JAX
    ``pallas`` executor, which routes it the same way."""
    npdt = np.complex64 if dtype == torch.complex64 else np.complex128
    x = _c64(n, (4, n)).astype(npdt)
    before = cuda_fft.FALLBACKS[(1, reason)]
    got = get_executor("cuda")(torch.from_numpy(x), (1,), True)
    assert cuda_fft.FALLBACKS[(1, reason)] == before + 1
    assert got.dtype == dtype
    want = jex.get_executor("pallas")(jnp.asarray(x), (1,), True)
    assert _err(got.numpy(), want) < (SAME_MATH if npdt == np.complex64
                                      else 1e-12)
    assert _err(got.numpy(), np.fft.fft(x.astype(np.complex128), axis=1)) \
        < testing.tolerance(npdt)


def test_executor_raises_on_empty():
    """Named as above: an empty tensor now runs dft_matmul, counted with
    reason ``empty`` (the JAX package's), and comes back empty."""
    before = cuda_fft.FALLBACKS[(1, "empty")]
    got = get_executor("cuda")(torch.zeros((0, 64), dtype=torch.complex64),
                               (1,), True)
    assert cuda_fft.FALLBACKS[(1, "empty")] == before + 1
    assert tuple(got.shape) == (0, 64) and got.dtype == torch.complex64
    want = jex.get_executor("pallas")(jnp.zeros((0, 64), jnp.complex64),
                                      (1,), True)
    assert tuple(want.shape) == (0, 64)


def test_executor_raises_for_two_kernel_lengths():
    """Named for what it pinned before the two-level path was ported: a
    length the JAX package runs as two kernel passes (``_fft_last_big``)
    now runs, through the ported two-level transform, with no fallback
    counted, and matches numpy."""
    assert cuda_fft.outer_split(131072) == pallas_fft.outer_split(131072)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((1, 131072))
         + 1j * rng.standard_normal((1, 131072))).astype(np.complex64)
    before = dict(cuda_fft.FALLBACKS)
    y = get_executor("cuda")(torch.from_numpy(x), (1,), True)
    assert dict(cuda_fft.FALLBACKS) == before
    assert testing.rel_error(y.numpy(), np.fft.fft(x, axis=1)) < 5e-4


@pytest.mark.parametrize("bad", ["dtype", "ndim", "contiguous", "length"])
def test_wrapper_checks_inputs(bad):
    x = torch.zeros((2, 64, 64), dtype=torch.complex64)
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "ndim":
        x = x.reshape(2, 64, 8, 8)
    elif bad == "contiguous":
        x = x.transpose(1, 2)
    else:
        x = torch.zeros((2, 64, 16), dtype=torch.complex64)
    with pytest.raises(ValueError):
        cuda_fft.fft2_last(x)
