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
  absent; dtypes and lengths the kernels do not take run dft_matmul with
  the JAX package's reason counted.
- The pencil chain over a 2D process-group world (four gloo ranks, and
  an NCCL twin on four cards) against its loopback twin; a 2D world over
  a group that leaves out some processes is refused, one over a group of
  every process works.
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


@pytest.mark.parametrize("grid,mesh_axis", [((2, 3), "row"),
                                             ((2, 3), "col"),
                                             ((3, 1), "col")])
def test_loopback_exchange_runs_within_grid_groups(grid, mesh_axis):
    """On a 2D world an exchange over ``col`` runs within each row of the
    grid and one over ``row`` within each column, each group a tiled
    all-to-all in the order of its index along that axis."""
    world = tdfft.make_world(grid)
    groups = world.axis_members(mesh_axis)
    p = world.axis_size(mesh_axis)
    assert sorted(r for g in groups for r in g) == list(range(world.size))
    assert all(len(g) == p for g in groups)
    rng = np.random.default_rng(world.size)
    blocks = [(rng.standard_normal((2, 2 * p, 3))
               + 1j * rng.standard_normal((2, 2 * p, 3))).astype(np.complex64)
              for _ in range(world.size)]
    got = exchange([torch.from_numpy(b) for b in blocks], world,
                   split_axis=1, concat_axis=0, mesh_axis=mesh_axis)
    for g in groups:
        want = _tiled_all_to_all([blocks[r] for r in g], 1, 0)
        for r, w in zip(g, want):
            assert np.array_equal(got[r].numpy(), w)
    with pytest.raises(ValueError, match="mesh axis"):
        world.axis_size("slab")


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
    """These worlds hold what the kernels do not take (a length under 64,
    a prime over 17, complex128). The port once refused them; now each
    plans, and the offending axis runs dft_matmul with the JAX package's
    reason counted in ``cuda_fft.FALLBACKS``, as its ``pallas`` executor
    routes it. The whole plan is held against JAX's pallas plan where the
    world is small; the 8191-point one (a Bluestein prime, 2^25 values)
    on six of its lines, through the two executors."""
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft
    from distributedfft_tpu.ops import executors as jex
    from distributedfft_tpu_torch.ops import cuda_fft
    from distributedfft_tpu_torch.ops.executors import get_executor

    npdt = np.complex64 if dtype == torch.complex64 else np.complex128
    tol = 1e-5 if dtype == torch.complex64 else 1e-12
    jdt = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    plan = tdfft.plan_dft_c2c_3d(shape, 2, dtype=dtype, device="cpu")
    axis = 0 if reason == "dtype" else next(
        a for a, n in enumerate(shape) if not cuda_fft.eligible(n))
    before = cuda_fft.FALLBACKS[(axis, reason)]
    if np.prod(shape) <= 1 << 20:
        jplan = jdfft.plan_dft_c2c_3d(shape, jdfft.make_mesh(2),
                                      executor="pallas", dtype=jdt)
        x = testing.make_world_data(shape, npdt, seed=3)
        got = plan(torch.from_numpy(x)).numpy()
        assert testing.rel_error(got, np.asarray(jplan(x))) < tol
    else:
        assert axis == 2
        x = testing.make_world_data((2, 3, shape[axis]), npdt, seed=3)
        got = get_executor("cuda")(torch.from_numpy(x), (2,), True).numpy()
        want = np.asarray(jex.get_executor("pallas")(jnp.asarray(x), (2,)))
        assert testing.rel_error(got, want) < tol
    assert cuda_fft.FALLBACKS[(axis, reason)] > before


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


# --------------------------------------------------------- process groups

def _pencil_rank(rank, size, backend, init, grid, shape, x, out_dir):
    """One rank of the pencil chain over a 2D process-group world: the
    forward of its z-pencil box and the backward of its x-pencil box of
    the forward's global output, each saved for the parent."""
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world(grid=grid)
        assert world.grid == grid and world.ranks == (rank,)
        fwd = tdfft.plan_dft_c2c_3d(shape, world, device=device)
        bwd = tdfft.plan_dft_c2c_3d(shape, world, direction=tdfft.BACKWARD,
                                    device=device)
        y = fwd(torch.from_numpy(x[fwd.in_boxes[rank].slices()].copy())
                .to(device))
        np.save(os.path.join(out_dir, f"fwd{rank}.npy"), y.cpu().numpy())
        full = np.fft.fftn(x.astype(np.complex128)).astype(np.complex64)
        r = bwd(torch.from_numpy(full[bwd.in_boxes[rank].slices()].copy())
                .to(device))
        np.save(os.path.join(out_dir, f"bwd{rank}.npy"), r.cpu().numpy())
    finally:
        dist.destroy_process_group()


def _check_process_group_pencil(tmp_path, backend, grid, shape, tol):
    size = grid[0] * grid[1]
    x = testing.make_world_data(shape, np.complex64, seed=17)
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_pencil_rank,
                       args=(size, backend, init, grid, shape, x,
                             str(tmp_path)),
                       nprocs=size, join=True, start_method="spawn")
    fwd = tdfft.plan_dft_c2c_3d(shape, grid, device="cpu")
    bwd = tdfft.plan_dft_c2c_3d(shape, grid, direction=tdfft.BACKWARD,
                                device="cpu")
    want = fwd(torch.from_numpy(x)).numpy()
    full = np.fft.fftn(x.astype(np.complex128)).astype(np.complex64)
    back = bwd(torch.from_numpy(full)).numpy()
    for rank, box in enumerate(fwd.out_boxes):
        got = np.load(tmp_path / f"fwd{rank}.npy")
        assert got.shape == box.shape
        assert testing.rel_error(got, want[box.slices()]) <= tol
    for rank, box in enumerate(bwd.out_boxes):
        got = np.load(tmp_path / f"bwd{rank}.npy")
        assert got.shape == box.shape
        assert testing.rel_error(got, back[box.slices()]) <= tol
        assert testing.rel_error(got, x[box.slices()]) < C64


def test_process_group_pencil_matches_loopback(tmp_path):
    """Four gloo ranks on a 2x2 world, an uneven shape: every rank's
    boxes are its loopback twin's, bit for bit."""
    _check_process_group_pencil(tmp_path, "gloo", (2, 2), (12, 10, 14), 0.0)


@pytest.mark.cuda
def test_process_group_pencil_over_nccl(tmp_path):
    """The same over NCCL on four cards (a 2x2 world), held against the
    loopback twin on the CPU within the complex64 tier. On the cards:
    ``python -m pytest --noconftest -m cuda tests/test_torch_world.py``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    _check_process_group_pencil(tmp_path, "nccl", (2, 2), (130, 132, 128),
                                C64)


def _subgroup_rank(rank, size, init, out_dir):
    """One of two gloo ranks: a 2D world over a one-rank sub-group is
    refused; one over a sub-group of both ranks runs the pencil chain."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        part = dist.new_group([0])
        both = dist.new_group([0, 1])
        if rank == 0:
            try:
                tdfft.process_group_world(part, grid=(1, 1))
            except ValueError as e:
                refused = str(e)
            else:
                refused = ""
            with open(os.path.join(out_dir, "refused.txt"), "w") as f:
                f.write(refused)
        world = tdfft.process_group_world(both, grid=(1, 2))
        x = testing.make_world_data((8, 6, 10), np.complex64, seed=5)
        fwd = tdfft.plan_dft_c2c_3d(x.shape, world, device="cpu")
        y = fwd(torch.from_numpy(x[fwd.in_boxes[rank].slices()].copy()))
        np.save(os.path.join(out_dir, f"fwd{rank}.npy"), y.numpy())
    finally:
        dist.destroy_process_group()


def test_process_group_grid_needs_every_process(tmp_path):
    """``dist.new_group`` must be entered by every process of the default
    group, so a 2D world over a sub-group that leaves some out raises
    (it would hang them); over a sub-group of every process it runs and
    matches its loopback twin bit for bit."""
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_subgroup_rank, args=(2, init, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    assert "1 of 2" in (tmp_path / "refused.txt").read_text()
    x = testing.make_world_data((8, 6, 10), np.complex64, seed=5)
    fwd = tdfft.plan_dft_c2c_3d(x.shape, (1, 2), device="cpu")
    want = fwd(torch.from_numpy(x)).numpy()
    for rank, box in enumerate(fwd.out_boxes):
        got = np.load(tmp_path / f"fwd{rank}.npy")
        assert np.array_equal(got, want[box.slices()])
