"""The pass spans of a plan call (``testing.PASS_SPANS``).

``fft_plane`` and ``fft_axis[<route>]`` open around each kernel pass,
``r2c_untangle`` / ``c2r_untangle`` around a real transform's untangle,
``a2a_pack`` / ``a2a_unpack`` around the process-group all-to-all's
copies and ``host_wait[<site>]`` around each step that blocks the host on
the card. On the CPU, one forward-backward pair under ``torch.profiler``
(CPU activity) of a single C2C plan, an R2C plan (``executor="cuda"``:
its kernels' plain versions) and a 2-rank gloo slab: how often each span
opens, what an untangle holds, and that every op a plan call runs lies
under one of them, views and the collective's own call aside (the CPU's
stand-in for the card's coverage). Then the gate: ``add_trace`` enters
``record_function`` only while a profiler records, and a session and
``capture_events`` still record every span.

On the card, a pair of each single plan, and of a 4-rank NCCL slab on
four cards, under ``torch.cuda.set_sync_debug_mode("warn")`` gives as
many synchronising operations as ``host_wait`` spans. Run it alone (it
imports no JAX, and the suite's conftest does):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pass_spans.py
"""

import json
import os
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel.mesh import process_group_world
from distributedfft_tpu_torch.utils import trace as ttr

PAIR = "test_pair"

#: Ops that move no data (a view of the same storage): the only ops a
#: plan call may run outside its pass spans.
VIEWS = {"aten::reshape", "aten::view", "aten::_reshape_alias",
         "aten::as_strided", "aten::movedim", "aten::transpose",
         "aten::permute", "aten::unsqueeze", "aten::squeeze",
         "aten::select", "aten::slice", "aten::narrow", "aten::alias",
         "aten::unbind", "aten::split", "aten::tensor_split",
         "aten::view_as_real", "aten::view_as_complex",
         "aten::_conj", "aten::resolve_conj", "aten::detach"}

#: The all-to-all's own host ops: its receive buffer's allocation and
#: the collective's call, whose device work is the library's (NCCL's on
#: the card, under the exchange's ``t2`` span).
COLLECTIVE = {"aten::empty_like", "aten::empty_strided",
              "c10d::alltoall_base_", "record_param_comms"}

#: Spans a warm pair opens, by plan: the single C2C plan at 64^3 runs
#: the plane kernel and one strided pass each way; the R2C plan at 128^3
#: (on the CPU, the untangle's plain version) one row pass inside each
#: untangle (half length 64) and two strided passes outside it each way;
#: its twiddle table was uploaded by the warm-up pair, so it waits on
#: nothing.
SINGLE = {
    ("c2c", 64): {"execute_c2c_single": 2, "fft_plane": 2,
                  "fft_axis[radix]": 2},
    ("r2c", 128): {"execute_r2c_single": 1, "execute_c2r_single": 1,
                   "r2c_untangle": 1, "c2r_untangle": 1,
                   "fft_axis[radix]": 6},
}


@pytest.fixture(autouse=True)
def _closed_session():
    """No session leaks in or out of a test."""
    ttr.finalize_tracing()
    yield
    ttr.finalize_tracing()


def _plans(kind, n, world=None, device="cpu", **options):
    kw = dict(executor="cuda", device=device, **options)
    shape = (n, n, n)
    if kind == "c2c":
        return (tdfft.plan_dft_c2c_3d(shape, world, direction=tdfft.FORWARD,
                                      **kw),
                tdfft.plan_dft_c2c_3d(shape, world, direction=tdfft.BACKWARD,
                                      **kw))
    return (tdfft.plan_dft_r2c_3d(shape, world, **kw),
            tdfft.plan_dft_c2r_3d(shape, world, **kw))


def _field(kind, shape, device="cpu"):
    dt = np.complex64 if kind == "c2c" else np.float32
    return torch.from_numpy(testing.make_world_data(shape, dt, seed=5)).to(
        device)


def _profiled_pair(fwd, bwd, x, path):
    """(spans, ops) of one pair under the CPU profiler, each a list of
    (name, start, end) in microseconds, after one unprofiled pair."""
    from torch.profiler import ProfilerActivity, profile, record_function

    bwd(fwd(x))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(PAIR):
            bwd(fwd(x))
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def pick(cat):
        return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("cat") == cat and e.get("ph") == "X"]

    return pick("user_annotation"), pick("cpu_op")


def _inside(a, b) -> bool:
    return b[1] <= a[1] and a[2] <= b[2]


def _findings(spans, ops) -> dict:
    """What the tests hold: each span's count (the pair's own left out),
    the pass spans each untangle holds, and the ops run inside an
    ``execute_*`` span that lie under no pass span and are neither a
    view nor the collective's own."""
    passes = [s for s in spans if testing.pass_span(s[0])]
    calls = [s for s in spans if s[0].startswith("execute_")]
    outside = sorted({o[0] for o in ops
                      if any(_inside(o, c) for c in calls)
                      and not any(_inside(o, p) for p in passes)}
                     - VIEWS - COLLECTIVE)
    held = [sorted(p[0] for p in passes if p is not u and _inside(p, u))
            for u in spans if u[0].endswith("_untangle")]
    return {"counts": dict(Counter(s[0] for s in spans if s[0] != PAIR)),
            "untangles": held, "outside": outside}


@pytest.mark.parametrize("kind,n", list(SINGLE))
def test_single_plan_pair_spans(tmp_path, kind, n):
    fwd, bwd = _plans(kind, n)
    got = _findings(*_profiled_pair(fwd, bwd, _field(kind, (n,) * 3),
                                    tmp_path / "trace.json"))
    assert got["counts"] == SINGLE[(kind, n)]
    # each untangle holds exactly one axis pass (its inner C2C) and no
    # host wait: its twiddle table is the warm-up pair's
    want = [] if kind == "c2c" else [["fft_axis[radix]"]] * 2
    assert got["untangles"] == want
    assert got["outside"] == []


def _slab_rank(rank, size, init, out_dir):
    """One rank of a gloo slab C2C at 64^3: its pair's findings."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        fwd, bwd = _plans("c2c", 64, world=process_group_world())
        box = fwd.in_boxes[rank]
        x = _field("c2c", (64,) * 3)[box.slices()].contiguous()
        got = _findings(*_profiled_pair(
            fwd, bwd, x, os.path.join(out_dir, f"trace{rank}.json")))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def slab_findings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slab_spans")
    mp.start_processes(_slab_rank, args=(2, f"file://{tmp / 'store'}",
                                         str(tmp)),
                       nprocs=2, join=True, start_method="spawn")
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in (0, 1)]


@pytest.mark.parametrize("rank", [0, 1])
def test_slab_pair_spans(slab_findings, rank):
    got = slab_findings[rank]
    counts = got["counts"]
    # one all-to-all each way, its two copies under its t2 span
    assert {k: counts[k] for k in ("a2a_pack", "a2a_unpack")} \
        == {"a2a_pack": 2, "a2a_unpack": 2}
    assert counts["execute_c2c_slab"] == 2
    # the forward's t0 over its [32, 64, 64] slab is one plane pass and
    # its t3 one axis; the backward's t0 takes two axes apart, its t3 one
    assert counts["fft_plane"] == 1
    assert counts["fft_axis[radix]"] == 4
    assert got["untangles"] == []
    assert got["outside"] == []


def test_record_function_only_while_profiling(monkeypatch):
    """With no profiler, session or capture, a pair enters no
    ``record_function``; under the profiler it enters one per span."""
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    fwd, bwd = _plans("r2c", 128)
    x = _field("r2c", (128,) * 3)
    assert not ttr.tracing_enabled() and ttr._capture is None
    bwd(fwd(x))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        bwd(fwd(x))
    assert Counter(entered) == SINGLE[("r2c", 128)]


@pytest.mark.parametrize("recorder", ["python", "c"])
def test_session_and_capture_record_every_span(tmp_path, monkeypatch,
                                               recorder):
    """With no profiler, a session (each recorder) and a capture still
    record each span of a pair, nested captures as well."""
    if recorder == "c" and not tdfft.native.is_available():
        pytest.skip("the port's host library did not build")
    monkeypatch.setenv("DFFT_TRACE_NATIVE", "1" if recorder == "c" else "0")
    fwd, bwd = _plans("r2c", 128)
    x = _field("r2c", (128,) * 3)
    bwd(fwd(x))
    ttr.init_tracing(str(tmp_path / "s"))
    assert (ttr._native_rec is not None) == (recorder == "c")
    with ttr.capture_events() as outer:
        with ttr.capture_events() as ev:
            bwd(fwd(x))
    lines = open(ttr.finalize_tracing()).read().splitlines()[1:]
    want = SINGLE[("r2c", 128)]
    assert Counter(ln.split()[-1] for ln in lines) == want
    assert Counter(e[0] for e in ev) == want
    assert outer == []
    assert all(stop >= start for _, start, stop in ev)


def _sync_count(fwd, bwd, x, dev) -> dict:
    """One pair on the card after a warm one, under
    ``set_sync_debug_mode("warn")``: where each synchronising operation
    was called from, and the ``host_wait`` spans the pair opened."""
    bwd(fwd(x))
    torch.cuda.synchronize(dev)
    prev = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                ttr.capture_events() as ev:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            z = bwd(fwd(x))
            torch.cuda.set_sync_debug_mode(prev)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize(dev)
    assert z.shape == x.shape
    # the mode's own notice on its first use is no synchronising op
    return {"syncs": [f"{w.filename}:{w.lineno}" for w in caught
                      if "called a synchronizing CUDA operation"
                      in str(w.message)],
            "waits": [e[0] for e in ev if e[0].startswith("host_wait[")]}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_sync_warnings_equal_host_waits(kind, n):
    """One warm pair of each single plan on the card: each synchronising
    operation it runs is a ``host_wait`` span's, and neither runs one
    (the R2C pair's twiddle tables were uploaded by the warm-up pair)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run this file on one (see its "
                    "docstring)")
    dev = torch.device("cuda")
    fwd, bwd = _plans(kind, n, device=dev)
    got = _sync_count(fwd, bwd, _field(kind, (n,) * 3, dev), dev)
    print(f"{kind} {n}^3: synchronising operations {got['syncs']}, host "
          f"waits {Counter(got['waits'])}")
    assert len(got["syncs"]) == len(got["waits"])
    assert got["waits"] == []


#: The planner keywords of the benchmark's four-card slab cell.
SLAB_CELL = dict(algorithm="alltoall", overlap_chunks=1, wire_dtype="none",
                 fuse=False, tune="off")


def _slab_sync_rank(rank, size, init, n, out_dir):
    """One rank of an NCCL slab C2C at n^3, each rank on its own card:
    its pair's synchronising operations and host waits."""
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=size)
    try:
        fwd, bwd = _plans("c2c", n, world=process_group_world(), device=dev,
                          **SLAB_CELL)
        x = _field("c2c", (n,) * 3)[fwd.in_boxes[rank].slices()]
        got = _sync_count(fwd, bwd, x.contiguous().to(dev), dev)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 512])
def test_slab_sync_warnings_equal_host_waits(tmp_path, n):
    """One pair of the four-card NCCL slab, as the benchmark's slab cell
    plans it: on every rank, each synchronising operation is a
    ``host_wait`` span's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards; run this file on them (see "
                    "its docstring)")
    mp.start_processes(_slab_sync_rank,
                       args=(4, f"file://{tmp_path / 'store'}", n,
                             str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        print(f"slab {n}^3 rank {rank}: synchronising operations "
              f"{got['syncs']}, host waits {Counter(got['waits'])}")
        assert len(got["syncs"]) == len(got["waits"])
