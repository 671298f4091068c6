"""The port's trace spans against the JAX package's.

- ``stage_key`` on every span name the JAX package's tests normalise;
- the ``log`` and ``chrome`` files, one per rank;
- the ``DFFT_TRACE_MAX_EVENTS`` ring's evictions, as the JAX recorder
  counts them for the same spans;
- a hierarchical K = 2 plan (and the flat transports at K = 2 and K = 1)
  emits the JAX plan's span names in the JAX plan's order;
- spans land in a ``torch.profiler`` timeline; ``timed_span``,
  ``record_span``, ``traced_stage``, ``CsvRecorder`` and ``plan_info``.
"""

import json

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import testing
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world
from distributedfft_tpu_torch.utils import trace as ttr

#: The span and stage names the JAX package's tests hold stage_key to
#: (tests/test_explain.py, test_a2l_legpipe.py, test_a2m_stagegraph.py).
NAMES = ["t0_fft_yz", "t2_all_to_all", "t2a_exchange_x", "t2b_exchange_y",
         "t3_fft_x[4]", "t1", "tune_build_xla", "execute_c2c_slab", "t_mid",
         "t_mid[2]", "t_mid_pointwise", "t2a[0]", "t2b[2]",
         "t2a_exchange_ici[1]", "t2b_exchange_dcn[0]", "t2a_exchange_ici",
         "t2b_exchange_dcn", "t3_fft_x[1]", "t_mid[0]",
         "cc12:t2a_exchange_ici[3]", "ccx:not_a_stage", "cc3:t0_fft_yz",
         "t1_pack", "t2_exchange_dcn+ici", "t0_r2c_zy", "t3_ifft_x",
         "t0_ifft_y_c2r", "t4_x", "tx", "", "t", "t2c_exchange"]


@pytest.fixture(autouse=True)
def _closed_session():
    """No session leaks in or out of a test."""
    ttr.finalize_tracing()
    yield
    ttr.finalize_tracing()


@pytest.mark.parametrize("name", NAMES)
def test_stage_key_matches_jax(name):
    from distributedfft_tpu.utils.trace import stage_key

    assert ttr.stage_key(name) == stage_key(name)


def test_log_file_per_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("DFFT_TRACE_NATIVE", "0")   # spans in end order
    root = str(tmp_path / "trace")
    ttr.init_tracing(root)
    assert ttr.tracing_enabled()
    with ttr.add_trace("outer"):
        with ttr.add_trace("inner"):
            pass
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 2, device="cpu")
    plan(torch.from_numpy(testing.make_world_data((8, 8, 8), np.complex64)))
    path = ttr.finalize_tracing()
    assert not ttr.tracing_enabled()
    assert path == f"{root}_0.log"
    lines = open(path).read().splitlines()
    assert lines[0] == "process 0 of 1"
    names = [ln.split()[-1] for ln in lines[1:]]
    assert names[:2] == ["inner", "outer"]
    stages = [n for n in names[2:] if not testing.pass_span(n)]
    assert stages == ["t0_fft_yz", "t1_pack", "t2_exchange_slab",
                      "t3_fft_x", "execute_c2c_slab"]
    # 8 is below the kernels' lengths: each axis pass falls back, two
    # ranks' t0 over two axes and t3 over one
    assert [n for n in names[2:] if testing.pass_span(n)] == \
        ["fft_axis[fallback]"] * 6
    assert ttr.finalize_tracing() is None


def test_chrome_file_nests(tmp_path, monkeypatch):
    monkeypatch.setenv("DFFT_TRACE_FORMAT", "chrome")
    root = str(tmp_path / "ct")
    ttr.init_tracing(root)
    with ttr.add_trace("outer"):
        with ttr.add_trace("inner"):
            pass
    path = ttr.finalize_tracing()
    assert path == f"{root}_0.json"
    obj = json.load(open(path))
    assert obj["metadata"]["process"] == 0
    by_name: dict = {}
    for e in obj["traceEvents"]:
        assert e["pid"] == 0
        by_name.setdefault(e["name"], []).append(e)
    for name in ("outer", "inner"):
        begin, end = by_name[name]
        assert [begin["ph"], end["ph"]] == ["B", "E"]
        assert end["ts"] >= begin["ts"]
    assert by_name["outer"][0]["ts"] <= by_name["inner"][0]["ts"]
    assert by_name["inner"][1]["ts"] <= by_name["outer"][1]["ts"]
    with pytest.raises(ValueError, match="format"):
        ttr.init_tracing("x", format="protobuf")
    assert not ttr.tracing_enabled()


def test_reinit_writes_the_open_session(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttr.init_tracing(a)
    with ttr.add_trace("first"):
        pass
    ttr.init_tracing(b)
    with ttr.add_trace("second"):
        pass
    assert "first" in open(f"{a}_0.log").read()
    text = open(ttr.finalize_tracing()).read()
    assert "second" in text and "first" not in text


@pytest.mark.parametrize("cap,spans", [(16, 40), (64, 64), (8, 100),
                                       (0, 50)])
def test_ring_evicts_as_jax(tmp_path, monkeypatch, cap, spans):
    """The same cap and spans: the JAX Python recorder and the port's
    keep the same newest spans and count the same evictions, in the log
    and in the chrome metadata."""
    from distributedfft_tpu.utils import trace as jtr

    monkeypatch.setenv("DFFT_TRACE_MAX_EVENTS", str(cap))
    monkeypatch.setenv("DFFT_TRACE_NATIVE", "0")
    kept = []
    for mod, tag in ((jtr, "jax"), (ttr, "port")):
        mod.init_tracing(str(tmp_path / tag))
        for i in range(spans):
            with mod.add_trace(f"s{i}"):
                pass
        kept.append(([e[0] for e in mod._events], mod.dropped_events()))
        lines = open(mod.finalize_tracing()).read().splitlines()
        dropped = [ln for ln in lines if ln.startswith("dropped_events")]
        assert dropped == ([f"dropped_events {kept[-1][1]}"]
                           if kept[-1][1] else [])
    assert kept[0] == kept[1]
    assert kept[1][1] == (0 if not cap or spans <= cap else
                          spans - len(kept[1][0]))
    monkeypatch.setenv("DFFT_TRACE_FORMAT", "chrome")
    ttr.init_tracing(str(tmp_path / "c"))
    for i in range(spans):
        with ttr.add_trace(f"s{i}"):
            pass
    meta = json.load(open(ttr.finalize_tracing()))["metadata"]
    assert meta.get("dropped_events", 0) == kept[1][1]


def _jax_spans(shape, algorithm, k, mesh):
    import jax.numpy as jnp

    import distributedfft_tpu as jdfft
    from distributedfft_tpu.utils import trace as jtr

    x = testing.make_world_data(shape, np.complex64, seed=2)
    with jtr.capture_events() as ev:
        plan = jdfft.plan_dft_c2c_3d(shape, mesh, dtype=jnp.complex64,
                                     algorithm=algorithm, overlap_chunks=k)
        plan(x)                   # the first call traces the program
    return [e[0] for e in ev]


@pytest.mark.parametrize("algorithm,k", [("hierarchical", 2),
                                         ("hierarchical", 1),
                                         ("hierarchical", 3),
                                         ("alltoall", 2), ("ppermute", 1),
                                         ("alltoallv", 3)])
def test_plan_spans_match_jax(algorithm, k):
    import jax
    from jax.sharding import Mesh

    import distributedfft_tpu as jdfft

    shape = (16, 12, 8)
    if algorithm == "hierarchical":
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("dcn", "ici"))
        world = make_world((2, 4), HYBRID_AXES)
    else:
        mesh, world = jdfft.make_mesh(4), make_world(4)
    want = _jax_spans(shape, algorithm, k, mesh)
    plan = tdfft.plan_dft_c2c_3d(shape, world, device="cpu",
                                 algorithm=algorithm, overlap_chunks=k)
    x = torch.from_numpy(testing.make_world_data(shape, np.complex64, 2))
    with ttr.capture_events() as ev:
        plan(x)
    assert [e[0] for e in ev if not testing.pass_span(e[0])] == want
    assert any(testing.pass_span(e[0]) for e in ev)
    if (algorithm, k) == ("hierarchical", 2):
        assert want[2:8] == ["t2a_exchange_ici[0]", "t2a_exchange_ici[1]",
                             "t2b_exchange_dcn[0]", "t3_fft_x[0]",
                             "t2b_exchange_dcn[1]", "t3_fft_x[1]"]


def test_spans_reach_the_torch_profiler():
    from torch.profiler import ProfilerActivity, profile

    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 2, device="cpu",
                                 algorithm="ppermute", overlap_chunks=2)
    x = torch.from_numpy(testing.make_world_data((8, 8, 8), np.complex64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan(x)
    keys = {e.key for e in prof.key_averages()}
    for span in ("execute_c2c_slab", "t0_fft_yz", "t2_exchange_slab[1]",
                 "t3_fft_x[0]"):
        assert span in keys, span


def test_timed_and_recorded_spans(tmp_path):
    import time

    assert ttr.record_span("late", 0.0, 1.0) is False
    ttr.init_tracing(str(tmp_path / "rs"), format="chrome")
    with ttr.timed_span("work") as t:
        time.sleep(0.01)
    assert t["seconds"] >= 0.01
    now = time.perf_counter()
    assert ttr.record_span("retro", now - 0.25, now) is True
    evs = json.load(open(ttr.finalize_tracing()))["traceEvents"]
    begin, end = sorted((e for e in evs if e["name"] == "retro"),
                        key=lambda e: e["ph"] != "B")
    assert (end["ts"] - begin["ts"]) / 1e6 == pytest.approx(0.25, rel=1e-3)
    fn = ttr.traced_stage("t9_x", lambda v: v + 1)
    assert fn.__wrapped__(1) == 2
    with ttr.capture_events() as ev:
        assert [f(1) for _, f in ttr.trace_stages([("a", fn.__wrapped__)])
                ] == [2]
    assert [e[0] for e in ev] == ["a"]


def test_csv_recorder(tmp_path):
    path = str(tmp_path / "out" / "bench.csv")
    rec = ttr.CsvRecorder(path, ("n", "time", "gflops"))
    rec.record(512, 0.028, 644.1)
    ttr.CsvRecorder(path, ("n", "time", "gflops")).record(1024, 0.3, 500.0)
    assert open(path).read().splitlines() == [
        "n,time,gflops", "512,0.028,644.1", "1024,0.3,500.0"]
    with pytest.raises(ValueError, match="header"):
        ttr.CsvRecorder(path, ("n", "time"))
    with pytest.raises(ValueError, match="expected 3 fields"):
        rec.record(1, 2)


def test_plan_info():
    plan = tdfft.plan_dft_r2c_3d((16, 12, 10), 4, device="cpu",
                                 algorithm="ppermute", overlap_chunks=2)
    info = tdfft.plan_info(plan)
    for text in ("decomposition: slab", "algorithm: ppermute", "r2c",
                 "overlap: 2 chunks", "in box[3]", "out box[3]",
                 "4 ranks"):
        assert text in info, text


# ------------------------------------------------------ the C recorder

requires_c_recorder = pytest.mark.skipif(
    not tdfft.native.is_available(),
    reason="the port's host library did not build")


@requires_c_recorder
def test_c_recorder_log_equals_jax(tmp_path, monkeypatch):
    """A "log" session takes the C recorder in both packages (each its
    own library); the two logs have the same header and span names, in
    the order the spans began."""
    from distributedfft_tpu import native as jnative
    from distributedfft_tpu.utils import trace as jtr

    if not jnative.is_available():
        pytest.skip("the JAX package's library did not build")
    monkeypatch.delenv("DFFT_TRACE_NATIVE", raising=False)
    monkeypatch.delenv("DFFT_TRACE_FORMAT", raising=False)
    logs = []
    for mod, tag in ((jtr, "jax"), (ttr, "port")):
        mod.init_tracing(str(tmp_path / tag))
        assert mod._native_rec is not None
        with mod.add_trace("outer"):
            with mod.add_trace("inner"):
                pass
        for name in ("alpha", "beta[1]", "t0_fft_yz"):
            with mod.add_trace(name):
                pass
        logs.append(open(mod.finalize_tracing()).read().splitlines())
    jlog, tlog = logs
    assert tlog[0] == jlog[0] == "process 0 of 1"
    names = [ln.split()[-1] for ln in tlog[1:]]
    assert names == [ln.split()[-1] for ln in jlog[1:]]
    assert names == ["outer", "inner", "alpha", "beta[1]", "t0_fft_yz"]


@requires_c_recorder
def test_record_span_is_false_under_the_c_recorder(tmp_path, monkeypatch):
    import time

    monkeypatch.delenv("DFFT_TRACE_NATIVE", raising=False)
    ttr.init_tracing(str(tmp_path / "c"))
    assert ttr._native_rec is not None and ttr._events is None
    assert ttr.tracing_enabled()
    now = time.perf_counter()
    assert ttr.record_span("retro", now - 0.1, now) is False
    with ttr.capture_events() as ev:          # the tee works under it
        with ttr.add_trace("live"):
            pass
    assert [e[0] for e in ev] == ["live"]
    text = open(ttr.finalize_tracing()).read()
    assert "live" in text and "retro" not in text
    assert not ttr.tracing_enabled()


def test_native_off_and_chrome_take_the_python_recorder(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("DFFT_TRACE_NATIVE", "0")
    ttr.init_tracing(str(tmp_path / "p"))
    assert ttr._native_rec is None and ttr._events == []
    with ttr.add_trace("gamma"):
        pass
    assert ttr.record_span("retro", 1.0, 2.0) is True
    text = open(ttr.finalize_tracing()).read()
    assert "gamma" in text and "retro" in text
    monkeypatch.delenv("DFFT_TRACE_NATIVE")
    ttr.init_tracing(str(tmp_path / "ch"), format="chrome")
    assert ttr._native_rec is None and ttr._events == []
    assert ttr.finalize_tracing().endswith(".json")


@requires_c_recorder
def test_c_recorder_failed_dump_raises(tmp_path, monkeypatch):
    """A dump the C recorder cannot write raises OSError and keeps the
    session and its spans, as JAX's does."""
    monkeypatch.delenv("DFFT_TRACE_NATIVE", raising=False)
    ttr.init_tracing(str(tmp_path / "no" / "such" / "dir" / "t"))
    with ttr.add_trace("kept"):
        pass
    with pytest.raises(OSError, match="dump"):
        ttr.finalize_tracing()
    assert ttr.tracing_enabled()
    ttr._trace_root = str(tmp_path / "ok")
    assert "kept" in open(ttr.finalize_tracing()).read()


@requires_c_recorder
def test_c_recorder_reinit_and_finalize_inside_a_span(tmp_path,
                                                      monkeypatch):
    """Re-init writes the open session; a finalize and re-init inside an
    open span neither crashes nor lets the stale end land in the new
    session."""
    monkeypatch.delenv("DFFT_TRACE_NATIVE", raising=False)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttr.init_tracing(a)
    with ttr.add_trace("first"):
        pass
    ttr.init_tracing(b)
    assert ttr._native_rec is not None
    with ttr.add_trace("second"):
        pass
    assert "first" in open(f"{a}_0.log").read()
    text = open(ttr.finalize_tracing()).read()
    assert "second" in text and "first" not in text
    ttr.init_tracing(str(tmp_path / "r"))
    with ttr.add_trace("outer"):
        ttr.finalize_tracing()
        ttr.init_tracing(str(tmp_path / "rb"))
        with ttr.add_trace("inner"):
            pass
    lines = open(ttr.finalize_tracing()).read().splitlines()[1:]
    assert [ln.split()[-1] for ln in lines] == ["inner"]
    assert float(lines[0].split()[1]) >= 0.0


@requires_c_recorder
@pytest.mark.parametrize("world", [2, (2, 2)])
def test_c_recorder_plan_spans_equal_the_python_recorders(tmp_path,
                                                         monkeypatch, world):
    """One plan call in a C-recorder session and in a Python-recorder
    session: the same t0..t3 spans by name and count."""
    from collections import Counter

    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), world, device="cpu")
    x = torch.from_numpy(testing.make_world_data((8, 8, 8), np.complex64))
    got = []
    for flag in ("1", "0"):
        monkeypatch.setenv("DFFT_TRACE_NATIVE", flag)
        ttr.init_tracing(str(tmp_path / f"s{flag}"))
        assert (ttr._native_rec is not None) == (flag == "1")
        plan(x)
        lines = open(ttr.finalize_tracing()).read().splitlines()[1:]
        got.append(Counter(ln.split()[-1] for ln in lines))
    assert got[0] == got[1]
    keys = {ttr.stage_key(n) for n in got[0]}
    assert {"t0", "t2", "t3"} <= keys
