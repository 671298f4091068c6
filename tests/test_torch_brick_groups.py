"""The port's brick plans over process groups.

Each rank passes its own brick, in its box's storage order, and gets its
own out-brick back: four gloo ranks over a ``file://`` store under
``tmp_path`` (uneven Z-slabs in, one stored in each of three orders;
X-pencils out; the ring and the a2av edges), every rank's brick held
against its loopback twin's bit for bit; and the same over NCCL on four
cards (``cuda``-marked, within the complex64 tier). The file imports no
JAX, so the card's machine runs it: ``python -m pytest --noconftest -m
cuda tests/test_torch_brick_groups.py``.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import geometry as tgeo
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel import bricks as tbricks

C64 = testing.tolerance(np.complex64)


def _brick_rank(rank, size, backend, init, shape, x, ins, outs, out_dir):
    """One rank of the brick plans: its own brick in, its own brick out,
    on both edge transports."""
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        stack = tbricks.scatter_bricks(x, ins)
        s = ins[rank].storage_shape
        mine = torch.from_numpy(
            stack[rank, :s[0], :s[1], :s[2]].copy()).to(device)
        for alg in ("alltoall", "alltoallv"):
            plan = tdfft.plan_brick_dft_c2c_3d(shape, world, ins, outs,
                                               algorithm=alg, device=device)
            y = plan(mine)
            assert tuple(y.shape) == outs[rank].storage_shape
            np.save(os.path.join(out_dir, f"{alg}{rank}.npy"),
                    y.cpu().numpy())
    finally:
        dist.destroy_process_group()


def _check_process_group_bricks(tmp_path, backend, tol):
    shape = (16, 12, 8)
    w = tgeo.world_box(shape)
    ins = [b.with_order(o) for b, o in zip(
        tgeo.make_slabs(w, 4, axis=2, rule=tgeo.ceil_splits),
        [(0, 1, 2), (2, 0, 1), (1, 2, 0), (0, 1, 2)])]
    outs = tgeo.make_pencils(w, (2, 2), 0)
    x = testing.make_world_data(shape, np.complex64, seed=17)
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_brick_rank,
                       args=(4, backend, init, shape, x, ins, outs,
                             str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    loop = tdfft.plan_brick_dft_c2c_3d(shape, 4, ins, outs, device="cpu")
    want = loop(torch.from_numpy(tbricks.scatter_bricks(x, ins))).numpy()
    for alg in ("alltoall", "alltoallv"):
        for rank, b in enumerate(outs):
            s = b.storage_shape
            got = np.load(tmp_path / f"{alg}{rank}.npy")
            assert got.shape == s
            assert testing.rel_error(
                got, want[rank, :s[0], :s[1], :s[2]]) <= tol


def test_process_group_bricks_match_loopback(tmp_path):
    """Four gloo ranks: uneven Z-slabs in (one stored in each of three
    orders), X-pencils out, ring and a2av edges; every rank's brick is
    its loopback twin's bit for bit."""
    _check_process_group_bricks(tmp_path, "gloo", 0.0)


@pytest.mark.cuda
def test_process_group_bricks_over_nccl(tmp_path):
    """The same over NCCL on four cards, within the complex64 tier."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    _check_process_group_bricks(tmp_path, "nccl", C64)
