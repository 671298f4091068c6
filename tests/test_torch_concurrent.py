"""The port's concurrent scheduler (``schedule_concurrent``) and wave tier
(``schedule_waves``, ``WaveSchedule``), the cases of
``tests/test_a2m_stagegraph.py`` (its parts 2 and 3).

A schedule interleaves the steps of N chains on one world: transform j
runs its step ``wave - j``, lower j first within a wave. Its outputs
equal the plans called one after another, bit for bit (slab and pencil,
each flat transport, N = 2 and 3, mixed shapes, directions and K; a
batched, a real and an operator plan together; the hierarchical
transport; split-wire fused plans; a 2-rank gloo process group, whose
exchanges are issued asynchronously and waited on at the transform's
next step). Its spans carry ``cc<j>:`` in that wave order; schedules
are memoized per plan tuple (at most 64); the wave partition equals
JAX's; a WaveSchedule keeps at most ``depth`` waves in flight and
retires them in order. Complex64 data on the CPU (the kernels' plain
versions), one test against JAX's schedule in complex128 (1e-11).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import stagegraph as jsg
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import stagegraph as sg, testing
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world
from distributedfft_tpu_torch.utils.trace import capture_events, stage_key

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def fresh_plans():
    """Plans made afresh in each test: the tests hold plans and worlds by
    identity, which the plan cache would share between tests."""
    tdfft.clear_plan_cache()
    yield
    tdfft.clear_plan_cache()


def _world_data(shape, seed=7, dtype=np.complex64):
    return torch.from_numpy(testing.make_world_data(shape, dtype, seed=seed))


def _plans(decomposition, algorithm, n, **kw):
    """N independent mixed-shape/direction plans on one shared world."""
    world = make_world(4) if decomposition == "slab" else make_world((2, 2))
    kw = dict(CPU, algorithm=algorithm, **kw)
    menu = [
        tdfft.plan_dft_c2c_3d((16, 16, 16), world, **kw),
        tdfft.plan_dft_c2c_3d((12, 10, 9), world, direction=tdfft.BACKWARD,
                              **kw),
        tdfft.plan_dft_c2c_3d((8, 16, 8), world, overlap_chunks=2, **kw),
    ]
    return menu[:n]


def _sequential_equal(plans, xs, ys):
    for p, x, y in zip(plans, xs, ys):
        ref = p(x)
        assert y.dtype == ref.dtype and y.shape == ref.shape
        assert torch.equal(y, ref)


@pytest.mark.parametrize("algorithm", ("alltoall", "alltoallv",
                                       "ppermute"))
@pytest.mark.parametrize("decomposition", ("slab", "pencil"))
@pytest.mark.parametrize("n", (2, 3))
def test_concurrent_bit_identical_matrix(decomposition, algorithm, n):
    plans = _plans(decomposition, algorithm, n)
    xs = [_world_data(p.in_shape, seed=11 + i) for i, p in enumerate(plans)]
    ys = sg.schedule_concurrent(plans)(*xs)
    assert len(ys) == n
    _sequential_equal(plans, xs, ys)


def test_concurrent_matches_jax_schedule():
    """The port's schedule against JAX's on the same complex128 inputs."""
    jmesh = jdfft.make_mesh(4)
    shapes = ((16, 16, 16), (12, 10, 9))
    jp = [jdfft.plan_dft_c2c_3d(s, jmesh, dtype=jnp.complex128)
          for s in shapes]
    tp = [tdfft.plan_dft_c2c_3d(s, 4, dtype=torch.complex128, **CPU)
          for s in shapes]
    xs = [testing.make_world_data(s, np.complex128, seed=3 + i)
          for i, s in enumerate(shapes)]
    want = jsg.schedule_concurrent(jp)(*xs)
    got = sg.schedule_concurrent(tp)(*[torch.from_numpy(x) for x in xs])
    for g, w in zip(got, want):
        assert testing.rel_error(g.numpy(), np.asarray(w)) < 1e-11


def test_concurrent_mixed_kinds_bit_identical():
    """Batch, real and operator plans co-schedule with a plain transform:
    every chain the IR builds is schedulable."""
    world = make_world(4)
    plans = [
        tdfft.plan_dft_c2c_3d((16, 16, 16), world, batch=2, **CPU),
        tdfft.plan_dft_r2c_3d((16, 16, 16), world, **CPU),
        tdfft.solve_poisson((16, 16, 16), world, **CPU),
        tdfft.plan_dft_c2c_3d((16, 16, 16), world, **CPU),
    ]
    xs = [_world_data(plans[0].in_shape, seed=3),
          _world_data((16, 16, 16), seed=4, dtype=np.float32),
          _world_data((16, 16, 16), seed=5),
          _world_data((16, 16, 16), seed=6)]
    _sequential_equal(plans, xs, sg.schedule_concurrent(plans)(*xs))


def test_concurrent_hierarchical_bit_identical():
    """Slab plans under the two-leg transport and a pencil plan share a
    hybrid world's one schedule."""
    world = make_world((2, 2), HYBRID_AXES)
    kw = dict(CPU, algorithm="hierarchical")
    plans = [tdfft.plan_dft_c2c_3d((16, 16, 16), world, **kw),
             tdfft.plan_dft_c2c_3d((16, 16, 8), world, overlap_chunks=2,
                                   **kw),
             tdfft.plan_dft_c2c_3d((16, 8, 16), world,
                                   decomposition="pencil", **CPU)]
    assert [p.decomposition for p in plans] == ["slab", "slab", "pencil"]
    xs = [_world_data(p.in_shape, seed=21 + i) for i, p in enumerate(plans)]
    _sequential_equal(plans, xs, sg.schedule_concurrent(plans)(*xs))


@pytest.mark.parametrize("decomposition", ("slab", "pencil"))
def test_concurrent_fused_split_wire_pair(decomposition):
    """Split-wire fused plans (the fused sender and receiver kernels'
    plain versions) interleave with each other, forward with backward,
    and their fusion records are the plans' own."""
    world = make_world(4) if decomposition == "slab" else make_world((2, 2))
    kw = dict(CPU, wire_dtype="split", fuse=True)
    plans = [tdfft.plan_dft_c2c_3d((16, 16, 16), world, **kw),
             tdfft.plan_dft_r2c_3d((16, 16, 16), world,
                                   direction=tdfft.BACKWARD, **kw)]
    xs = [_world_data((16, 16, 16), seed=31),
          _world_data(plans[1].in_shape, seed=32)]
    ys = sg.schedule_concurrent(plans)(*xs)
    assert all(p.graph.meta["fusion"]["active"] for p in plans)
    sites = [dict(p.graph.meta["fusion"]["sites"]) for p in plans]
    _sequential_equal(plans, xs, ys)
    assert [p.graph.meta["fusion"]["sites"] for p in plans] == sites


def test_concurrent_spans_show_interleave():
    world = make_world(4)
    p1 = tdfft.plan_dft_c2c_3d((16, 16, 16), world, **CPU)
    p2 = tdfft.plan_dft_c2c_3d((8, 16, 8), world, **CPU)
    cp = sg.schedule_concurrent([p1, p2])
    xs = [_world_data(p.in_shape) for p in (p1, p2)]
    with capture_events() as ev:
        cp(*xs)
    cc = [e[0] for e in ev if e[0].startswith("cc")]
    assert cc == ["cc0:t0_fft_yz", "cc0:t1_pack", "cc1:t0_fft_yz",
                  "cc0:t2_exchange_slab", "cc1:t1_pack", "cc0:t3_fft_x",
                  "cc1:t2_exchange_slab", "cc1:t3_fft_x"]
    # transform 0's exchange is issued before transform 1's t3
    assert cc.index("cc0:t2_exchange_slab") < cc.index("cc1:t3_fft_x")
    # every span of the schedule but the passes inside its stages is
    # prefixed; stage_key drops the prefix
    assert {e[0] for e in ev if not testing.pass_span(e[0])} == set(cc)
    assert {e[0] for e in ev if testing.pass_span(e[0])} == \
        {"fft_axis[fallback]"}
    assert {stage_key(s) for s in cc} == {"t0", "t1", "t2", "t3"}
    assert stage_key("cc12:t2a_exchange_ici[3]") == "t2"
    assert stage_key("ccx:not_a_stage") is None


def test_concurrent_overlap_k_spans_nest_the_chunks():
    world = make_world(4)
    plans = [tdfft.plan_dft_c2c_3d((8, 16, 8), world, overlap_chunks=2,
                                   **CPU) for _ in range(2)]
    with capture_events() as ev:
        sg.schedule_concurrent(plans)(*[_world_data((8, 16, 8))] * 2)
    names = [e[0] for e in ev]
    for j in range(2):
        assert f"cc{j}:t2_exchange_slab" in names
    assert "t2_exchange_slab[1]" in names and "t3_fft_x[1]" in names


def test_concurrent_program_memoized_and_validated(monkeypatch):
    monkeypatch.setattr(sg, "_CONCURRENT_CACHE", {})
    world = make_world(4)
    p1 = tdfft.plan_dft_c2c_3d((16, 16, 16), world, **CPU)
    p2 = tdfft.plan_dft_c2c_3d((8, 16, 8), make_world(4), **CPU)
    cp = sg.schedule_concurrent([p1, p2])
    assert sg.schedule_concurrent([p1, p2]) is cp          # warm replay
    assert sg.schedule_concurrent([p2, p1]) is not cp      # order = schedule
    assert cp.world is world
    solo = tdfft.plan_dft_c2c_3d((8, 8, 8), None, **CPU)
    assert solo.graph is None and sg.graph_of(solo) is None
    with pytest.raises(ValueError, match="stage graph"):
        sg.schedule_concurrent([p1, solo])
    wrapped = tdfft.plan_dft_c2c_3d(
        (8, 8, 8), world, in_spec=tdfft.Spec(None, None, "slab"),
        out_spec=tdfft.Spec(None, None, "slab"), **CPU)
    with pytest.raises(ValueError, match="layout edges"):
        sg.schedule_concurrent([p1, wrapped])
    other = tdfft.plan_dft_c2c_3d((16, 16, 16), (2, 2), **CPU)
    with pytest.raises(ValueError, match="shared mesh"):
        sg.schedule_concurrent([p1, other])
    with pytest.raises(ValueError, match="takes 2 inputs"):
        cp(_world_data((16, 16, 16)))
    with pytest.raises(ValueError, match="at least one"):
        sg.schedule_concurrent([])
    with pytest.raises(ValueError, match="plan input shape"):
        cp(_world_data((16, 16, 16)), _world_data((8, 8, 8)))


def test_concurrent_memo_is_bounded_at_64(monkeypatch):
    monkeypatch.setattr(sg, "_CONCURRENT_CACHE", {})
    world = make_world(2)
    plans = []
    for _ in range(9):               # nine distinct plans, none cached
        tdfft.clear_plan_cache()
        plans.append(tdfft.plan_dft_c2c_3d((8, 8, 8), world, **CPU))
    keys = [(a, b) for a in range(9) for b in range(9)][:65]
    first = sg.schedule_concurrent([plans[a] for a in keys[0]])
    for a, b in keys[1:]:
        sg.schedule_concurrent([plans[a], plans[b]])
    assert len(sg._CONCURRENT_CACHE) == 64
    assert sg.schedule_concurrent([plans[a] for a in keys[0]]) is not first
    assert sg.schedule_concurrent([plans[a] for a in keys[-1]]) is \
        sg._CONCURRENT_CACHE[tuple(id(plans[a]) for a in keys[-1])][1]


def test_schedule_waves_partition_equals_jax():
    """The same plan list, the port's and JAX's, in the same waves."""
    tw, tp = make_world(4), make_world((2, 2))
    mk = lambda shape, w: tdfft.plan_dft_c2c_3d(shape, w, **CPU)
    port = [mk((8, 8, 8), tw), mk((8, 8, 8), tw), mk((8, 8, 8), None),
            mk((8, 8, 8), tw), mk((8, 8, 8), tw), mk((8, 8, 8), tw),
            mk((8, 8, 8), tp), mk((8, 8, 8), tp), mk((8, 8, 8), tw)]
    jm, jp = jdfft.make_mesh(4), jdfft.make_mesh((2, 2))
    jk = lambda shape, m: jdfft.plan_dft_c2c_3d(shape, m,
                                                dtype=jnp.complex128)
    jax_plans = [jk((8, 8, 8), m) for m in (jm, jm, None, jm, jm, jm, jp,
                                            jp, jm)]
    for width in (1, 2, 3, 4):
        got = [[port.index(p) for p in w]
               for w in sg.schedule_waves(port, width)]
        want = [[jax_plans.index(p) for p in w]
                for w in jsg.schedule_waves(jax_plans, width)]
        assert got == want, width
    assert sg.schedule_waves(port, 2)[:2] == [tuple(port[:2]), (port[2],)]
    with pytest.raises(ValueError, match="positive int"):
        sg.schedule_waves(port, 0)


def test_wave_schedule_depth_and_width():
    world = make_world(4)
    plans = [tdfft.plan_dft_c2c_3d((16, 16, 8), world, **CPU),
             tdfft.plan_dft_c2c_3d((8, 16, 16), world, **CPU)]
    solo = tdfft.plan_dft_c2c_3d((8, 8, 8), None, **CPU)
    ws = sg.WaveSchedule(max_width=2, depth=2)
    seen = []
    for k in range(4):
        xs = [_world_data(p.in_shape, seed=40 + 2 * k + i)
              for i, p in enumerate(plans)]
        outs = ws.dispatch(plans, xs)
        assert ws.inflight <= 2
        seen.append(ws.inflight)
        _sequential_equal(plans, xs, outs)
    assert seen == [1, 2, 2, 2]
    assert [r["index"] for r in ws.records] == [0, 1]   # retired in order
    single = ws.dispatch([solo], [_world_data((8, 8, 8))])
    assert torch.equal(single[0], solo(_world_data((8, 8, 8))))
    recs = ws.drain()
    assert [r["index"] for r in recs] == [3, 4] and ws.inflight == 0
    assert [r["index"] for r in ws.records] == [0, 1, 2, 3, 4]
    assert [r["interleaved"] for r in ws.records] == [True] * 4 + [False]
    assert all(r["width"] == 2 for r in ws.records[:4])
    assert all(r["duration_s"] >= 0 for r in ws.records)
    assert ws.barrier() is None and ws.waves == 5
    with pytest.raises(ValueError, match="exceeds max_width"):
        ws.dispatch(plans + plans[:1], [None] * 3)
    with pytest.raises(ValueError, match="empty wave"):
        ws.dispatch([], [])
    with pytest.raises(ValueError, match="takes 2 inputs"):
        ws.dispatch(plans, [None])
    for bad in (dict(max_width=0), dict(depth=0), dict(depth=1.5)):
        with pytest.raises(ValueError, match="positive int"):
            sg.WaveSchedule(**bad)


def test_wave_schedule_depth_one_retires_before_dispatch():
    world = make_world(2)
    plans = [tdfft.plan_dft_c2c_3d((8, 8, 8), world, **CPU)] * 2
    ws = sg.WaveSchedule(max_width=4, depth=1)
    for k in range(3):
        ws.dispatch(plans, [_world_data((8, 8, 8), seed=k)] * 2)
        assert ws.inflight == 1
        assert len(ws.records) == k


# --------------------------------------------------------- process groups

def _cc_rank(rank, size, init, xs, out_dir):
    """One gloo rank: two slab plans (one ring, one dense, K = 2) as one
    schedule, and each called alone."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        plans = [tdfft.plan_dft_c2c_3d((16, 16, 8), world,
                                       algorithm="ppermute", device="cpu"),
                 tdfft.plan_dft_c2c_3d((8, 16, 16), world, overlap_chunks=2,
                                       direction=tdfft.BACKWARD,
                                       device="cpu"),
                 tdfft.plan_dft_r2c_3d((8, 8, 16), world, wire_dtype="split",
                                       fuse=True, device="cpu")]
        mine = [torch.from_numpy(x[p.in_boxes[rank].slices()].copy())
                for p, x in zip(plans, xs)]
        ys = sg.schedule_concurrent(plans)(*mine)
        for j, (p, x, y) in enumerate(zip(plans, mine, ys)):
            np.save(os.path.join(out_dir, f"cc{j}_{rank}.npy"), y.numpy())
            np.save(os.path.join(out_dir, f"seq{j}_{rank}.npy"), p(x).numpy())
    finally:
        dist.destroy_process_group()


def test_process_group_schedule_bit_identical(tmp_path):
    xs = [testing.make_world_data((16, 16, 8), np.complex64, seed=1),
          testing.make_world_data((8, 16, 16), np.complex64, seed=2),
          testing.make_world_data((8, 8, 16), np.float32, seed=3)]
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_cc_rank, args=(2, init, xs, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    loop = [tdfft.plan_dft_c2c_3d((16, 16, 8), 2, algorithm="ppermute",
                                  **CPU),
            tdfft.plan_dft_c2c_3d((8, 16, 16), 2, overlap_chunks=2,
                                  direction=tdfft.BACKWARD, **CPU),
            tdfft.plan_dft_r2c_3d((8, 8, 16), 2, wire_dtype="split",
                                  fuse=True, **CPU)]
    for j, (p, x) in enumerate(zip(loop, xs)):
        want = p(torch.from_numpy(x)).numpy()
        for rank, b in enumerate(p.out_boxes):
            got = np.load(tmp_path / f"cc{j}_{rank}.npy")
            np.testing.assert_array_equal(
                got, np.load(tmp_path / f"seq{j}_{rank}.npy"))
            np.testing.assert_array_equal(got, want[b.slices()])


def test_bench_concurrent_rehearses_on_gloo(tmp_path, capsys):
    """The four-card timing script, rehearsed on two gloo ranks: both
    pairs bit-equal to their sequential calls, four waves retired."""
    import json

    from distributedfft_tpu_torch import bench_transports

    assert bench_transports.main(["--cpu", "--concurrent", "--ranks", "2",
                                  "--n", "16", "--out", str(tmp_path)]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["pair"] for r in rows] == ["slab+slab", "slab+pencil"]
    assert rows[1]["decompositions"] == ["slab", "pencil"]
    for r in rows:
        assert r["bit_identical_to_sequential"]
        assert [w["index"] for w in r["wave_records"]] == [0, 1, 2, 3]


def test_scheduler_and_fft1d_import_no_jax():
    """The scheduler, the distributed 1D plan and the timing script
    import neither JAX nor the JAX package."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import distributedfft_tpu_torch.stagegraph\n"
            "import distributedfft_tpu_torch.parallel.fft1d\n"
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
