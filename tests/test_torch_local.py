"""The port's batched local plans against the JAX package's.

The cases of ``tests/test_local.py``: batched 1D transforms over the
radix sweep (powers of 2, 3, 5, 7 and two mixed lengths), a batched 2D
one, a batched 3D round trip, the Bluestein primes, a long four-step
length, the validation and the flop model; complex128 data from the
repo's seed, through the port's ``torch``, ``matmul`` and ``cuda``
executors on the CPU against JAX's ``xla`` and ``matmul`` plans (1e-12)
and numpy (1e-11).
"""

import numpy as np
import pytest
import torch

import distributedfft_tpu as jdfft
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing

C128 = testing.tolerance(np.complex128)
SAME = 1e-12
REF = {"torch": "xla", "matmul": "matmul", "cuda": "matmul"}


def _batch_data(batch, shape):
    return testing.make_world_data((batch,) + tuple(shape), np.complex128)


def _plan(planner, shape, executor, **kw):
    return getattr(tdfft, planner)(shape, executor=executor,
                                   dtype=torch.complex128, device="cpu", **kw)


@pytest.mark.parametrize("n", [8, 27, 125, 343, 100, 60])
@pytest.mark.parametrize("executor", ["torch", "matmul", "cuda"])
def test_batched_1d(n, executor):
    x = _batch_data(6, (n,))
    got = _plan("plan_dft_c2c_1d", n, executor, batch=6)(x).numpy()
    want = np.asarray(jdfft.plan_dft_c2c_1d(n, batch=6,
                                            executor=REF[executor])(x))
    assert testing.rel_error(got, want) < SAME
    assert testing.rel_error(got, np.fft.fft(x, axis=-1)) < C128


@pytest.mark.parametrize("executor", ["torch", "matmul", "cuda"])
def test_batched_2d(executor):
    shape = (16, 12)
    x = _batch_data(4, shape)
    got = _plan("plan_dft_c2c_2d", shape, executor, batch=4)(x).numpy()
    want = np.asarray(jdfft.plan_dft_c2c_2d(shape, batch=4,
                                            executor=REF[executor])(x))
    assert testing.rel_error(got, want) < SAME
    assert testing.rel_error(got, np.fft.fft2(x, axes=(1, 2))) < C128


def test_batched_3d_and_inverse():
    shape = (8, 6, 10)
    x = _batch_data(2, shape)
    fwd = _plan("plan_dft_c2c", shape, "cuda", batch=2)
    bwd = _plan("plan_dft_c2c", shape, "cuda", batch=2,
                direction=tdfft.BACKWARD)
    y = fwd(x)
    assert testing.rel_error(y.numpy(), np.fft.fftn(x, axes=(1, 2, 3))) < C128
    assert testing.rel_error(bwd(y).numpy(), x) < C128


@pytest.mark.parametrize("n", [521, 1009])
def test_large_prime_bluestein(n):
    """Primes above BLUESTEIN_MIN take the chirp-z route."""
    x = _batch_data(2, (n,))
    y = _plan("plan_dft_c2c_1d", n, "matmul", batch=2)(x)
    want = np.asarray(jdfft.plan_dft_c2c_1d(n, batch=2, executor="matmul")(x))
    assert testing.rel_error(y.numpy(), want) < SAME
    assert testing.rel_error(y.numpy(), np.fft.fft(x, axis=-1)) < C128
    bwd = _plan("plan_dft_c2c_1d", n, "matmul", batch=2,
                direction=tdfft.BACKWARD)
    assert testing.rel_error(bwd(y).numpy(), x) < C128


def test_long_sequence_four_step():
    """2^15 points: the four-step split, recursed."""
    n = 2 ** 15
    x = _batch_data(1, (n,))
    got = _plan("plan_dft_c2c_1d", n, "matmul", batch=1)(x).numpy()
    assert testing.rel_error(got, np.fft.fft(x, axis=-1)) < C128


def test_local_plan_validation():
    with pytest.raises(ValueError):
        tdfft.plan_dft_c2c((2, 2, 2, 2), device="cpu")
    with pytest.raises(ValueError):
        tdfft.plan_dft_c2c_2d((8,), device="cpu")
    plan = tdfft.plan_dft_c2c_1d(8, batch=2, device="cpu")
    with pytest.raises(ValueError):
        plan(np.zeros((3, 8), np.complex64))
    with pytest.raises(ValueError, match="unknown executor"):
        tdfft.plan_dft_c2c_1d(8, executor="xla", device="cpu")


def test_local_plan_flops_model():
    plan = tdfft.plan_dft_c2c_1d(1024, batch=32, device="cpu")
    assert plan.flops() == jdfft.plan_dft_c2c_1d(1024, batch=32).flops() \
        == 5.0 * 1024 * 10 * 32


def test_local_plan_scale_matches_reference():
    shape = (8, 8)
    x = _batch_data(3, shape)
    tplan = _plan("plan_dft_c2c_2d", shape, "torch", batch=3)
    jplan = jdfft.plan_dft_c2c_2d(shape, batch=3)
    for scale in ("FULL", "SYMMETRIC"):
        got = tplan(x, scale=getattr(tdfft.Scale, scale)).numpy()
        want = np.asarray(jplan(x, scale=getattr(jdfft.Scale, scale)))
        assert testing.rel_error(got, want) < SAME
