"""The join of profiler records to spans, on a trace recorded on the
card and on small hand-made ones."""

import gzip
import json
from pathlib import Path

import pytest

from h100bench import devtrace

DATA = Path(__file__).parent / "data"


def _recorded():
    with gzip.open(DATA / "trace_small.json.gz", "rt") as f:
        return devtrace.parse(json.load(f))


def test_recorded_trace_pairs_and_classes():
    tl = _recorded()
    assert tl.pairs == 2
    assert tl.complete()
    counts = tl.per_pair_counts()
    assert counts[0] == counts[1] > 0
    classes = {devtrace.op_class(o) for o in tl.pair_ops()}
    assert "port" in classes
    # the pads launched outside every pair are charged to no pair
    pads = [o for o in tl.ops if o.pair is None]
    assert len(pads) >= 64
    assert all(devtrace.op_class(o) == "library" for o in pads)
    lo, hi = tl.window()
    assert 0 < tl.busy() <= hi - lo
    bd = devtrace.breakdown(tl)
    assert 0 < len(bd["device_ops"]) <= 10
    assert all(s > 0 for _, s in bd["device_ops"])


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _doc(lost=False):
    ev = [
        _ev("user_annotation", "bench_pair", 0, 100),
        _ev("user_annotation", "t0_fft_yz", 5, 40),
        _ev("cpu_op", "aten::copy_", 50, 5),
        _ev("user_annotation", "t2_exchange_slab", 60, 20),
        _ev("user_annotation", "bench_pair", 200, 100),
        _ev("user_annotation", "t0_fft_yz", 205, 40),
        _ev("user_annotation", "t2_exchange_slab", 260, 20),
        # launches
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, 1),
        _ev("cuda_runtime", "cudaMemcpyAsync", 52, 2, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 62, 2, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 2, 4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 252, 2, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 262, 2, 6),
        _ev("cuda_runtime", "cudaLaunchKernel", 400, 2, 7),
        # device
        _ev("kernel", "void radix::rows_kernel<true, 17>(float2 const*)",
            1000, 30, 1),
        _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1030, 10, 2),
        _ev("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
            1050, 50, 3),
        _ev("kernel", "void radix::rows_kernel<true, 17>(float2 const*)",
            1100, 30, 4),
        _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1135, 10, 5),
        _ev("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
            1140, 60, 6),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
            1300, 5, 7),
    ]
    if lost:
        ev = [e for e in ev if (e.get("args") or {}).get("correlation") != 4
              or e["cat"] != "kernel"]
    return {"traceEvents": ev}


def test_join_by_hand():
    tl = devtrace.parse(_doc())
    assert tl.pairs == 2 and tl.complete()
    by = {(o.pair, o.ts): o for o in tl.ops}
    assert by[(0, 1000.0)].spans == ("t0_fft_yz",)
    assert by[(0, 1030.0)].spans == ()  # spans only, not aten ops
    assert by[(0, 1050.0)].spans == ("t2_exchange_slab",)
    assert by[(None, 1300.0)].pair is None
    classes = [devtrace.op_class(o) for o in tl.ops]
    assert classes == ["port", "library", "nccl", "port", "library", "nccl",
                       "library"]
    assert tl.window() == (1000.0, 1200.0)
    # busy: [1000,1040] + [1050,1130] + [1135,1200] = 40 + 80 + 65
    assert tl.busy() == pytest.approx(185.0)
    gaps = tl.gaps()
    assert [g for g, _ in gaps] == [10.0, 5.0]
    assert tl.host_doing(gaps[0][1].launch) == "bench_pair > t2_exchange_slab"
    assert devtrace.stage_key("t2a_exchange_ici[1]") == "t2"
    assert devtrace.stage_key("cc1:t0_fft_yz") == "t0"
    assert devtrace.stage_key("t_mid") is None


def test_lost_records_are_seen():
    tl = devtrace.parse(_doc(lost=True))
    assert tl.per_pair_counts() == [3, 2]
    assert not tl.complete()


def test_not_a_trace():
    assert devtrace.parse({"traceEvents": "x"}) is None
    assert devtrace.parse({"traceEvents": []}).pairs == 0
