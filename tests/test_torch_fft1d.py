"""The port's distributed 1D FFT against the JAX package's.

``plan_dft_c2c_1d_dist`` on a loopback world of P = 2 and 4 against the
JAX plan on a mesh of as many virtual CPU devices, on the same seeded
input: both orders, both directions, the ``alltoall``, ``ppermute`` and
``alltoallv`` transports, complex64 within 5e-4 and complex128 within
1e-11 (the port's ``cuda`` executor on the CPU, its kernels' plain
versions and the matmul DFT, against JAX's ``xla``). The split search,
the suggested length and the exact mulmod helpers equal JAX's exactly;
every transport (and the hierarchical one on a hybrid world) equals
``alltoall`` bit for bit; one rank is the local transform; and a
2-rank gloo process group, each rank holding its contiguous block, gives
its loopback twin's blocks bit for bit.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu.parallel import fft1d as jf
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel import fft1d as tf
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world
from distributedfft_tpu_torch.utils.timing import StageTimer

TOL = {torch.complex64: testing.tolerance(np.complex64),
       torch.complex128: testing.tolerance(np.complex128)}
NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}
JNP = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}
N = 64 * 48


def _data(n, dtype=np.complex128, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)


@pytest.mark.parametrize("n,p", [(64 * 64, 8), (192, 8), (17 * 8, 8),
                                 (N, 4), (2 * 3 * 5 * 7 * 11, 2),
                                 (1 << 20, 4), (3 << 26, 4), (1 << 28, 4),
                                 (5 ** 11, 5), (97, 2), (4096, 3)])
def test_choose_split_equals_jax(n, p):
    try:
        want = jf.choose_split_1d(n, p)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tf.choose_split_1d(n, p)
        assert str(got.value) == str(e)
        assert tf._suggest_length(n, p) == jf._suggest_length(n, p)
        return
    assert tf.choose_split_1d(n, p) == want


@pytest.mark.parametrize("n,idt", [((1 << 29) + 3, "int32"),
                                   ((1 << 30) + 7, "int64"),
                                   (3 << 26, "int32")])
def test_mulmod_equals_jax(n, idt):
    a = np.arange(0, 1 << 13, 97)
    b, ps = 123457, 54321
    ja = jnp.asarray(a, dtype=idt)
    ta = torch.from_numpy(a).to(getattr(torch, idt))
    got = tf._mulmod(ta, b, n, getattr(torch, idt)).numpy()
    assert (got == np.asarray(jf._mulmod(ja, b, n, getattr(jnp, idt)))).all()
    assert (got == (a.astype(object) * b) % n).all()
    got2 = tf._mulmod_traced(ta, torch.tensor(ps), n,
                             getattr(torch, idt)).numpy()
    want2 = jf._mulmod_traced(ja, jnp.asarray(ps, dtype=idt), n,
                              getattr(jnp, idt))
    assert (got2 == np.asarray(want2)).all()
    assert (got2 == (a.astype(object) * ps) % n).all()


@pytest.mark.parametrize("algorithm", ["alltoall", "ppermute", "alltoallv"])
@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("order", ["transposed", "natural"])
@pytest.mark.parametrize("p", [2, 4])
def test_plan_matches_jax(p, order, direction, algorithm):
    mesh = jdfft.make_mesh(p)
    for dtype in (torch.complex64, torch.complex128):
        x = _data(N, NP[dtype])
        jp = jf.plan_dft_c2c_1d_dist(N, mesh, direction=direction,
                                     order=order, algorithm=algorithm,
                                     dtype=JNP[dtype])
        tp = tdfft.plan_dft_c2c_1d_dist(N, p, direction=direction,
                                        order=order, algorithm=algorithm,
                                        dtype=dtype, device="cpu")
        assert (tp.spec.a, tp.spec.b, tp.spec.parts) == (
            jp.spec.a, jp.spec.b, jp.spec.parts)
        got = tp(torch.from_numpy(x)).numpy()
        assert got.shape == (N,) and got.dtype == NP[dtype]
        assert testing.rel_error(got, np.asarray(jp(x))) < TOL[dtype]


@pytest.mark.parametrize("order", ["transposed", "natural"])
def test_forward_against_numpy_and_roundtrip(order):
    x = _data(N, np.complex128, seed=8)
    fwd = tdfft.plan_dft_c2c_1d_dist(N, 4, order=order,
                                     dtype=torch.complex128, device="cpu")
    bwd = tdfft.plan_dft_c2c_1d_dist(N, 4, order=order, direction=1,
                                     dtype=torch.complex128, device="cpu")
    y = fwd(torch.from_numpy(x))
    got = y.numpy()
    if order == "transposed":
        got = got.reshape(fwd.spec.a, fwd.spec.b).T.reshape(-1)
    assert testing.rel_error(got, np.fft.fft(x)) < TOL[torch.complex128]
    assert testing.rel_error(bwd(y).numpy(), x) < TOL[torch.complex128]


@pytest.mark.parametrize("order", ["transposed", "natural"])
@pytest.mark.parametrize("direction", [-1, 1])
def test_every_transport_equals_alltoall(order, direction):
    x = torch.from_numpy(_data(N, np.complex64, seed=4))
    plan = lambda world, alg: tdfft.plan_dft_c2c_1d_dist(
        N, world, order=order, direction=direction, algorithm=alg,
        device="cpu")
    want = plan(4, "alltoall")(x)
    for alg in ("ppermute", "alltoallv"):
        assert torch.equal(plan(4, alg)(x), want), alg
    hybrid = make_world((2, 2), HYBRID_AXES)
    assert torch.equal(plan(hybrid, "hierarchical")(x), want)
    assert torch.equal(plan(hybrid, "alltoall")(x), want)


def test_single_rank_is_the_local_transform():
    x = _data(N, np.complex128, seed=9)
    for world in (None, 1, make_world(1)):
        tp = tdfft.plan_dft_c2c_1d_dist(N, world, order="natural",
                                        dtype=torch.complex128, device="cpu")
        assert tp.spec.parts == 1 and tp.spec.order == "natural"
        jp = jf.plan_dft_c2c_1d_dist(N, None, dtype=jnp.complex128)
        got = tp(torch.from_numpy(x)).numpy()
        assert testing.rel_error(got, np.asarray(jp(x))) < 1e-12
        assert testing.rel_error(got, np.fft.fft(x)) < TOL[torch.complex128]


def test_builder_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    world = make_world(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdfft.build_dist_fft1d(world, N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdfft.plan_dft_c2c_1d_dist(N, world)
    fn, spec = tdfft.build_dist_fft1d(world, N, device="cpu")
    x = torch.from_numpy(_data(N, np.complex64, seed=11))
    assert (spec.a, spec.b, spec.parts) == tf.choose_split_1d(N, 4) + (4,)
    assert torch.equal(fn(x), tdfft.plan_dft_c2c_1d_dist(
        N, world, device="cpu")(x))


def test_stages_timed_and_donate_same_bits():
    x = torch.from_numpy(_data(N, np.complex64, seed=10))
    plan = tdfft.plan_dft_c2c_1d_dist(N, 4, order="natural", device="cpu")
    timer = StageTimer("cpu")
    want = plan(x, timer=timer)
    assert set(timer.times()) == {"s0", "s1", "s2", "s3", "s4", "s5"}
    donor = tdfft.plan_dft_c2c_1d_dist(N, 4, order="natural", donate=True,
                                       device="cpu")
    assert torch.equal(donor(x.clone()), want)
    back = tdfft.plan_dft_c2c_1d_dist(N, 4, direction=1, donate=True,
                                      device="cpu")
    y = tdfft.plan_dft_c2c_1d_dist(N, 4, device="cpu")(x)
    assert torch.equal(back(y.clone()), tdfft.plan_dft_c2c_1d_dist(
        N, 4, direction=1, device="cpu")(y))


def test_refusals():
    plan = tdfft.plan_dft_c2c_1d_dist(N, 4, device="cpu")
    with pytest.raises(ValueError, match="plan input shape"):
        plan(torch.zeros(N - 4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="order"):
        tdfft.plan_dft_c2c_1d_dist(N, 4, order="bitrev", device="cpu")
    with pytest.raises(ValueError, match="factor pair"):
        tdfft.plan_dft_c2c_1d_dist(17 * 8, 8, device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        tdfft.plan_dft_c2c_1d_dist(N, 4, algorithm="bogus", device="cpu")


# --------------------------------------------------------- process groups

def _fft1d_rank(rank, size, init, x, out_dir):
    """One gloo rank: its contiguous block through the forward plan in
    each order, then back."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        n, per = x.size, x.size // size
        mine = torch.from_numpy(x[rank * per:(rank + 1) * per].copy())
        for order in ("transposed", "natural"):
            fwd = tdfft.plan_dft_c2c_1d_dist(n, world, order=order,
                                             algorithm="ppermute",
                                             device="cpu")
            bwd = tdfft.plan_dft_c2c_1d_dist(n, world, order=order,
                                             direction=1, device="cpu")
            y = fwd(mine)
            np.save(os.path.join(out_dir, f"{order}{rank}.npy"), y.numpy())
            np.save(os.path.join(out_dir, f"{order}_back{rank}.npy"),
                    bwd(y).numpy())
    finally:
        dist.destroy_process_group()


def test_process_group_blocks_equal_loopback(tmp_path):
    x = _data(N, np.complex64, seed=12)
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_fft1d_rank, args=(2, init, x, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    per = N // 2
    for order in ("transposed", "natural"):
        want = tdfft.plan_dft_c2c_1d_dist(N, 2, order=order,
                                          device="cpu")(torch.from_numpy(x))
        back = tdfft.plan_dft_c2c_1d_dist(N, 2, order=order, direction=1,
                                          device="cpu")(want)
        for rank in range(2):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{order}{rank}.npy"),
                want.numpy()[rank * per:(rank + 1) * per])
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{order}_back{rank}.npy"),
                back.numpy()[rank * per:(rank + 1) * per])
