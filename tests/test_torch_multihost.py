"""The port's multi-node tier: four gloo processes laid out as two nodes
of two (``LOCAL_WORLD_SIZE=2``) start through ``init_multihost`` from a
launcher-style environment (a ``file://`` store under the test's
temporary directory), form the 2x2 hybrid world, and run the
hierarchical plan (K = 1 and 2, forward and backward) to the loopback
plan's bits; ``global_to_host_local`` joins the ranks' boxes; the
single-process fallbacks degrade to the local behaviour.
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
from distributedfft_tpu_torch.parallel import multihost
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world

SHAPE = (12, 10, 14)


def _node_rank(rank, size, init, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(rank % 2))
    assert multihost.init_multihost(init_method=init)
    try:
        assert multihost.init_multihost()          # a second call is a no-op
        world = multihost.make_hybrid_world()
        assert multihost.is_hybrid_world(world)
        assert (world.grid, world.axis_names, world.rank) == (
            (2, 2), HYBRID_AXES, rank)
        assert multihost.fft_world_for().grid == (2, 2)
        x = testing.make_world_data(SHAPE, np.complex64, seed=23)
        out = {}
        for k in (1, 2):
            fwd = tdfft.plan_dft_c2c_3d(SHAPE, world, device="cpu",
                                        algorithm="hierarchical",
                                        overlap_chunks=k)
            bwd = tdfft.plan_dft_c2c_3d(SHAPE, world, device="cpu",
                                        algorithm="hierarchical",
                                        overlap_chunks=k,
                                        direction=tdfft.BACKWARD)
            y = fwd(torch.from_numpy(x[fwd.in_boxes[rank].slices()].copy()))
            out[f"fwd{k}"] = y.numpy()
            joined = multihost.global_to_host_local(world, y, dim=1)
            out[f"joined{k}"] = joined
            r = bwd(torch.from_numpy(joined[bwd.in_boxes[rank].slices()]
                                     .copy()))
            out[f"bwd{k}"] = r.numpy()
        multihost.sync_global_devices()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_four_processes_form_the_hybrid_world(tmp_path):
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_node_rank, args=(4, init, str(tmp_path)), nprocs=4,
                       join=True, start_method="spawn")
    world = make_world((2, 2), HYBRID_AXES)
    x = testing.make_world_data(SHAPE, np.complex64, seed=23)
    fwd = tdfft.plan_dft_c2c_3d(SHAPE, world, device="cpu",
                                algorithm="hierarchical")
    bwd = tdfft.plan_dft_c2c_3d(SHAPE, world, device="cpu",
                                algorithm="hierarchical",
                                direction=tdfft.BACKWARD)
    want = fwd(torch.from_numpy(x)).numpy()
    back = bwd(torch.from_numpy(want)).numpy()
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for k in (1, 2):
            assert np.array_equal(got[f"fwd{k}"],
                                  want[fwd.out_boxes[rank].slices()])
            assert np.array_equal(got[f"joined{k}"], want)
            assert np.array_equal(got[f"bwd{k}"],
                                  back[bwd.out_boxes[rank].slices()])
            assert testing.rel_error(got[f"bwd{k}"],
                                     x[bwd.out_boxes[rank].slices()]) < 5e-4


def test_single_process_degrades_to_local(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert multihost.init_multihost() is False
    assert multihost.local_world_size() == 1
    world = multihost.make_hybrid_world(per_node=4)
    assert world.loopback and world.grid == (1, 4) and world.hybrid
    assert not multihost.is_hybrid_world(make_world((2, 2)))
    assert multihost.fft_world_for(4).size == 4
    x = torch.arange(6.0)
    assert np.array_equal(multihost.global_to_host_local(world, x),
                          x.numpy())
    assert np.array_equal(
        multihost.host_local_to_global(world, x.numpy()).numpy(), x.numpy())
    multihost.sync_global_devices()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert multihost.local_world_size() == 3


def test_hybrid_world_layout():
    """Rank d*I + e is card e of node d: the ici groups are the rows
    (nodes), the dcn groups the columns, the combined axis every rank."""
    world = make_world((2, 3), HYBRID_AXES)
    assert world.axis_members("ici") == [[0, 1, 2], [3, 4, 5]]
    assert world.axis_members("dcn") == [[0, 3], [1, 4], [2, 5]]
    assert world.axis_members(HYBRID_AXES) == [list(range(6))]
    assert world.axis_size("ici") == 3 and world.axis_size("dcn") == 2
    assert world.axis_size(HYBRID_AXES) == 6
    with pytest.raises(ValueError, match="mesh axis"):
        world.axis_size("row")
    with pytest.raises(ValueError, match="two names"):
        make_world((2, 2), ("dcn", "dcn"))
    with pytest.raises(ValueError, match="2D world"):
        make_world(4, HYBRID_AXES)


def test_exchange_tier_imports_no_jax():
    """The modules of the exchange tier, the staged pipelines, the spans
    and the four-card timing script import neither JAX nor the JAX
    package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import distributedfft_tpu_torch.parallel.multihost\n"
            "import distributedfft_tpu_torch.parallel.staged\n"
            "import distributedfft_tpu_torch.utils.trace\n"
            "import distributedfft_tpu_torch.bench_transports\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'distributedfft_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
