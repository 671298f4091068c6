"""The port's worlds, exchange and guards.

- The loopback all-to-all against the JAX package's tiled all-to-all
  semantics, written out in numpy.
- The process-group backend: two ranks spawned with
  ``torch.multiprocessing`` over gloo, meeting at a ``file://`` store
  under ``tmp_path`` (the test workers run in parallel, so no fixed
  port), running the slab chain and held against the JAX plan, and a
  compressed exchange held against the loopback one.
- No JAX: the port imports neither ``jax`` nor ``distributedfft_tpu``.
- The card by default: planning without a device raises when CUDA is
  absent, and dtypes and lengths the kernels do not take raise with the
  JAX package's reason.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel.exchange import (exchange,
                                                        exchange_uneven)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C64 = testing.tolerance(np.complex64)


def _tiled_all_to_all(blocks, split, concat):
    """``lax.all_to_all(tiled=True)`` over a list of per-rank blocks."""
    p = len(blocks)
    chunks = [np.split(b, p, axis=split) for b in blocks]
    return [np.concatenate([chunks[s][d] for s in range(p)], axis=concat)
            for d in range(p)]


@pytest.mark.parametrize("p,split,concat", [(2, 1, 0), (4, 1, 0),
                                            (4, 0, 1), (3, 2, 0)])
def test_loopback_exchange_is_tiled_all_to_all(p, split, concat):
    rng = np.random.default_rng(p)
    shape = [4, 8, 12]
    shape[concat] = 5
    blocks = [(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
               ).astype(np.complex64) for _ in range(p)]
    got = exchange([torch.from_numpy(b) for b in blocks], tdfft.make_world(p),
                   split_axis=split, concat_axis=concat)
    want = _tiled_all_to_all(blocks, split, concat)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_loopback_exchange_uneven_pads_split_axis():
    blocks = [torch.full((3, 7, 2), r + 1, dtype=torch.complex64)
              for r in range(2)]
    out = exchange_uneven(blocks, tdfft.make_world(2), split_axis=1,
                          concat_axis=0)
    assert [tuple(o.shape) for o in out] == [(6, 4, 2), (6, 4, 2)]
    # Rank 1 receives the split axis's ceil pad: its last row is zero.
    assert torch.all(out[1][:, 3] == 0) and torch.all(out[0] != 0)


def _pg_rank(rank, size, backend, init, shape, x, out_dir):
    """One rank of the slab chain over a process group (gloo on the CPU,
    NCCL on card ``rank``): forward, then backward, each result box
    saved for the parent to check."""
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        assert world.backend == backend and world.ranks == (rank,)
        fwd = tdfft.plan_dft_c2c_3d(shape, world, device=device)
        bwd = tdfft.plan_dft_c2c_3d(shape, world, direction=tdfft.BACKWARD,
                                    device=device)
        box = fwd.in_boxes[rank]
        y = fwd(torch.from_numpy(x[box.slices()].copy()).to(device))
        np.save(os.path.join(out_dir, f"fwd{rank}.npy"), y.cpu().numpy())
        full = np.fft.fftn(x.astype(np.complex128)).astype(np.complex64)
        r = bwd(torch.from_numpy(full[bwd.in_boxes[rank].slices()].copy())
                .to(device))
        np.save(os.path.join(out_dir, f"bwd{rank}.npy"), r.cpu().numpy())
    finally:
        dist.destroy_process_group()


def _run_ranks(tmp_path, size, backend, shape, x):
    """Spawn ``size`` ranks of :func:`_pg_rank`; return the world's plan
    (for its boxes)."""
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_pg_rank,
                       args=(size, backend, init, shape, x, str(tmp_path)),
                       nprocs=size, join=True, start_method="spawn")
    return tdfft.plan_dft_c2c_3d(shape, size, device="cpu")


def _check_boxes(tmp_path, plan, want_fwd, x, fwd_tol):
    for rank, box in enumerate(plan.out_boxes):
        got = np.load(tmp_path / f"fwd{rank}.npy")
        assert got.shape == box.shape
        assert testing.rel_error(got, want_fwd[box.slices()]) < fwd_tol
    for rank, box in enumerate(plan.in_boxes):
        back = np.load(tmp_path / f"bwd{rank}.npy")
        assert testing.rel_error(back, x[box.slices()]) < C64


def test_process_group_slab_matches_reference(tmp_path):
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft

    shape, size = (66, 70, 64), 2
    x = testing.make_world_data(shape, np.complex64, seed=11)
    plan = _run_ranks(tmp_path, size, "gloo", shape, x)
    jplan = jdfft.plan_dft_c2c_3d(shape, jdfft.make_mesh(size),
                                  executor="pallas", dtype=jnp.complex64)
    _check_boxes(tmp_path, plan, np.asarray(jplan(x)), x, 1e-5)


@pytest.mark.cuda
def test_process_group_slab_over_nccl(tmp_path):
    """The same chain over NCCL, one rank per card, on every card of the
    host (at least two); held against numpy's float64 fftn. On the card:
    ``python -m pytest --noconftest -m cuda tests/test_torch_world.py``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least two NVIDIA cards")
    shape, size = (130, 132, 128), torch.cuda.device_count()
    x = testing.make_world_data(shape, np.complex64, seed=12)
    plan = _run_ranks(tmp_path, size, "nccl", shape, x)
    _check_boxes(tmp_path, plan, np.fft.fftn(x.astype(np.complex128)), x,
                 C64)


def test_port_imports_no_jax():
    code = ("import sys, distributedfft_tpu_torch as t\n"
            "import distributedfft_tpu_torch.utils.timing\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'distributedfft_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_plan_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdfft.plan_dft_c2c_3d((64, 64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdfft.plan_dft_c2c_3d((64, 64, 64), 2, device="cuda")
    assert tdfft.plan_dft_c2c_3d((64, 64, 64), device="cpu").device == \
        torch.device("cpu")


@pytest.mark.parametrize("shape,dtype,reason", [
    ((16, 64, 64), torch.complex64, "length"),
    ((64, 64, 8191), torch.complex64, "length"),
    ((64, 64, 64), torch.complex128, "dtype"),
])
def test_plan_refuses_what_the_kernels_do_not_take(shape, dtype, reason):
    with pytest.raises(ValueError, match=f"reason: {reason}"):
        tdfft.plan_dft_c2c_3d(shape, 2, dtype=dtype, device="cpu")


def test_execute_checks_input():
    plan = tdfft.plan_dft_c2c_3d((64, 64, 64), 2, device="cpu")
    with pytest.raises(ValueError, match="plan takes"):
        plan(torch.zeros((64, 64, 64), dtype=torch.complex128))
    with pytest.raises(ValueError, match="input shape"):
        plan(torch.zeros((64, 64, 66), dtype=torch.complex64))
    with pytest.raises(ValueError, match="unknown executor"):
        tdfft.plan_dft_c2c_3d((64, 64, 64), executor="xla", device="cpu")


def _wire_rank(rank, size, backend, init, blocks, out_dir):
    """One rank of a compressed exchange (gloo on the CPU, NCCL on card
    ``rank``): every codec, its own block in, the received block saved."""
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        for codec in ("bf16", "int8", "split"):
            (out,) = exchange([torch.from_numpy(blocks[rank]).to(device)],
                              world, split_axis=1, concat_axis=0,
                              wire_dtype=codec)
            np.save(os.path.join(out_dir, f"{codec}{rank}.npy"),
                    out.cpu().numpy())
    finally:
        dist.destroy_process_group()


def _check_compressed_exchange(tmp_path, size, backend):
    """Each wire part (bf16, int8, int16, f32 sidecar) crosses the group
    as a uint8 view of its trailing axis; the received blocks must be bit
    for bit those of the loopback exchange of the same blocks."""
    rng = np.random.default_rng(13)
    blocks = [((rng.standard_normal((3, 4 * size, 5))
                + 1j * rng.standard_normal((3, 4 * size, 5))) * 10.0 ** r
               ).astype(np.complex64) for r in range(size)]
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_wire_rank,
                       args=(size, backend, init, blocks, str(tmp_path)),
                       nprocs=size, join=True, start_method="spawn")
    for codec in ("bf16", "int8", "split"):
        want = exchange([torch.from_numpy(b) for b in blocks],
                        tdfft.make_world(size), split_axis=1, concat_axis=0,
                        wire_dtype=codec)
        for rank in range(size):
            got = np.load(tmp_path / f"{codec}{rank}.npy")
            assert got.tobytes() == want[rank].numpy().tobytes()


def test_process_group_compressed_exchange_matches_loopback(tmp_path):
    _check_compressed_exchange(tmp_path, 2, "gloo")


@pytest.mark.cuda
def test_process_group_compressed_exchange_over_nccl(tmp_path):
    """The same over NCCL, one rank per card, on every card of the host
    (at least two). The encode runs on the card there, the reference on
    the CPU: bit-identical unless a step lands on a power of two, which
    seeded data does not reach."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least two NVIDIA cards")
    _check_compressed_exchange(tmp_path, torch.cuda.device_count(), "nccl")
