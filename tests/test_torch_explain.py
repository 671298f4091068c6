"""The port's explain tier (``distributedfft_tpu_torch/explain.py``,
``dfft.explain``) against the JAX package's (``distributedfft_tpu/
explain.py``), on the CPU.

- ``stage_divergence`` gives JAX's verdicts, bands and ratios on the same
  samples; ``across_hosts_stages`` JAX's rows with ``_allgather_rows``
  replaced in both packages by the same three-process matrix;
  ``format_explain`` JAX's text for one record dict (the profiler's name
  apart, on a device-timed record); ``explain_from_record`` the same
  blocks.
- ``parse_device_trace`` on hand-built ``torch.profiler`` (Kineto)
  chrome documents: known kernel, copy and fill durations under
  ``t0`` / ``t2`` / ``t3`` spans over two passes come back as one
  sample a pass, charged to the innermost stage span by the launch's
  correlation id; an indivisible span count gives one aggregate sample;
  a document without a device operation gives None; the same join over
  spans of one name (``span_key``).
- A CPU explain record of the port's slab, pencil, single and Poisson op
  plans (16^3, worlds of 4 and 2x2) has the key set of the JAX record of
  the same plan, recursively; its model section equals JAX's under the
  same hardware numbers (1e-12 relative); the timing falls back to host
  brackets with the reason; ``measure=False`` runs nothing;
  ``allgather=True`` gives one row on a loopback world and the two
  ranks' medians over a 2-rank gloo group (a ``file://`` store under
  ``tmp_path``).

No test depends on which stage is faster by the clock.
"""

import json

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import explain_mod as tex
from distributedfft_tpu_torch.testing import tree_mismatch
from distributedfft_tpu_torch.utils import metrics as tm
from distributedfft_tpu_torch.utils.trace import OP_STAGE_KEYS, STAGE_KEYS

SHAPE = (16, 16, 16)
HW = {"device_kind": "cpu", "backend": "cpu", "peak_tflops": 100.0,
      "hbm_gbps": 800.0, "wire_gbps": 45.0, "dcn_gbps": 12.5,
      "launch_seconds": 1e-4, "source": "default"}
REL = 1e-12


def assert_same(got, want):
    bad = tree_mismatch(got, want, REL)
    assert bad is None, bad


def _jex():
    import distributedfft_tpu as jdfft

    return jdfft.explain_mod


# ----------------------------------------------------------- divergence

SAMPLE_SETS = [
    (0.001, [0.00201, 0.00199, 0.00200]),
    (0.00200, [0.00203, 0.00198, 0.00201]),
    (0.001, [0.002]),
    (0.0, [0.002, 0.002]),
    (0.004, [0.001, 0.0011, 0.00105, 0.0012]),
    (0.003, [0.0031, 0.0029, 0.0045, 0.0030, 0.0030]),
]


@pytest.mark.parametrize("model,samples", SAMPLE_SETS)
def test_stage_divergence_matches_jax(model, samples):
    want = _jex().stage_divergence(model, samples)
    got = tex.stage_divergence(model, samples)
    assert_same(got, want)
    for kw in (dict(mads=1.0), dict(min_rel=0.5), dict(min_samples=5)):
        assert_same(tex.stage_divergence(model, samples, **kw),
                    _jex().stage_divergence(model, samples, **kw))


def test_divergence_verdicts():
    div = tex.stage_divergence(0.001, [0.00201, 0.00199, 0.00200])
    assert div["diverged"] is True and div["direction"] == "slower"
    assert tex.stage_divergence(0.002, [0.00203, 0.00198])["diverged"] \
        is False
    assert tex.stage_divergence(0.001, [0.002])["diverged"] is None
    assert tex.stage_divergence(0.0, [0.002, 0.002])["diverged"] is None


def test_gate_defaults_match_jax():
    from distributedfft_tpu import regress

    assert (tex.DEFAULT_MADS, tex.DEFAULT_MIN_REL, tex.DEFAULT_MIN_SAMPLES) \
        == (regress.DEFAULT_MADS, regress.DEFAULT_MIN_REL,
            regress.DEFAULT_MIN_SAMPLES)
    assert tex.EXPLAIN_SCHEMA == _jex().EXPLAIN_SCHEMA
    for args in ((0.002, 1e-5, 3.0, 0.05), (0.002, 0.0, 3.0, 0.05),
                 (1.0, 0.3, 2.0, 0.1)):
        assert tex._band(*args) == pytest.approx(regress._band(*args),
                                                 rel=1e-15)


# ------------------------------------------------------- across hosts

def test_across_hosts_stages_matches_jax(monkeypatch):
    def rows(vec, *_):
        out = np.tile(np.asarray(vec, np.float64), (3, 1))
        out[2, 2] *= 3.0      # process 2's t2 three times the others'
        out[1, 0] *= 0.5
        return out

    jex = _jex()
    monkeypatch.setattr(jex, "_allgather_rows", rows)
    monkeypatch.setattr(tex, "_allgather_rows", rows)
    meds = {"t0": 0.001, "t1": None, "t2": 0.002, "t3": 0.001}
    got = tex.across_hosts_stages(meds)
    assert_same(got, jex.across_hosts_stages(meds))
    assert got["processes"] == 3 and "t1" not in got["stages"]
    assert got["stages"]["t2"]["straggler_ratio"] == pytest.approx(3.0)


def test_across_hosts_stages_one_process():
    out = tex.across_hosts_stages({"t0": 0.001, "t2": 0.002})
    assert out["processes"] == 1
    assert out["stages"]["t2"] == {"min": 0.002, "median": 0.002,
                                   "max": 0.002, "n": 1,
                                   "straggler_ratio": 1.0}


# --------------------------------------------------------- rendering

def _record(device: bool = False) -> dict:
    """One explain record as both packages write it: legs, fusion, a
    compressed wire, a whole-plan memory view, hosts and divergence."""
    t2_legs = [
        {"stage": "t2a", "mesh_axis": "col", "link": "ici", "parts": 2,
         "wire_bytes": 4096.0, "wire_gbps": 45.0, "seconds": 1e-4,
         "raw_seconds": 1e-4, "hide_seconds": 0.0, "leg_pipelined": False,
         "measured_seconds": 0.00031, "measured_samples": [0.00031]},
        {"stage": "t2b", "mesh_axis": "row", "link": "dcn", "parts": 2,
         "wire_bytes": 4096.0, "wire_gbps": 12.5, "seconds": 3e-4,
         "raw_seconds": 3e-4, "hide_seconds": 1e-5, "leg_pipelined": True,
         "measured_seconds": None, "measured_samples": []},
    ]

    def stage(model_s, meas, div, **extra):
        return {"model": {"seconds": model_s, "flops": 123456.0},
                "compiled": {"available": True, "flops": None,
                             "peak_hbm_bytes": 3 << 20},
                "measured": {"available": meas is not None,
                             "seconds": meas, "best_seconds": meas,
                             "samples": [] if meas is None else [meas]},
                "divergence": div, "mfu": 0.0123, **extra}

    return {
        "schema": 1,
        "plan": {"shape": [16, 16, 16], "kind": "c2c", "op": None,
                 "forward": False, "decomposition": "pencil",
                 "algorithm": "alltoall", "executor": "cuda:fuse",
                 "overlap_chunks": 1, "devices": 4, "dtype": "complex64"},
        "hw": {"device_kind": "cpu", "hbm_gbps": 800.0, "wire_gbps": 45.0,
               "peak_tflops": 100.0, "source": "default"},
        "wire": {"wire_dtype": "split", "compression_err": 2.01e-05,
                 "wire_factor": 0.5},
        "fusion": {"requested": True, "active": True, "reasons": [],
                   "sites": {"1": {"sender": "kernel",
                                   "receiver": "kernel"}}},
        "timing": ({"source": "device", "device_requested": True}
                   if device else
                   {"source": "host", "device_requested": True,
                    "fallback_reason": "no device operations"}),
        "stages": {
            "t0": stage(1e-6, 0.0021, {"diverged": True, "ratio": 2100.0,
                                       "direction": "slower"}),
            "t1": stage(1e-6, None, {"diverged": None}),
            "t2": stage(4e-4, 0.00031, {"diverged": False},
                        ici_utilization=0.25, legs=t2_legs),
            "t3": stage(1e-6, 1.5e-3, {"diverged": True, "ratio": 1500.0,
                                       "direction": "slower"}),
        },
        "totals": {"model_seconds": 4.03e-4,
                   "measured_stage_seconds": 0.00391},
        "compiled": {"flops": None, "bytes_accessed": None,
                     "peak_hbm_bytes": 9 << 20, "argument_bytes": 32768,
                     "output_bytes": 32768, "temp_bytes": 9371648,
                     "compile_seconds": None},
        "across_hosts": {"processes": 2, "stages": {
            "t0": {"min": 0.002, "median": 0.0021, "max": 0.0031,
                   "straggler_ratio": 1.476}}},
        "divergence": {"any": True, "stages": ["t0", "t3"]},
    }


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_format_explain_matches_jax(device):
    rec = _record(device)
    want = _jex().format_explain(rec)
    if device:
        want = want.replace("jax.profiler", "torch.profiler")
    assert tex.format_explain(rec) == want


def test_format_explain_of_an_op_record_matches_jax():
    rec = _record()
    rec["plan"].update(op="poisson", kind="op_poisson")
    rec["stages"]["t_mid"] = rec["stages"]["t3"]
    rec["compiled"] = None
    rec.pop("fusion")
    assert tex.format_explain(rec) == _jex().format_explain(rec)


def test_explain_from_record_matches_jax():
    rec = _record()
    for doc in (rec, {"explain": rec, "metric": "x"}, {"metric": "x"},
                "text", {"schema": 1, "stages": []}):
        got, want = tex.explain_from_record(doc), _jex().explain_from_record(
            doc)
        assert (got is None) == (want is None)
        if want is not None:
            assert got is want or got == want


# ------------------------------------------------------ device traces

def _kineto_doc(passes=2, device=True, chunks=2):
    """A torch.profiler chrome document: per pass the spans t0_fft_yz,
    t2_all_to_all (with ``chunks`` [k] spans inside) and t3_fft_x, each
    launching device operations of known durations (us), plus a host-only
    ``execute`` span and a kernel launched outside every stage span."""
    evs = [{"ph": "X", "cat": "user_annotation", "name": "execute_c2c_slab",
            "pid": 1, "tid": 1, "ts": 0.0, "dur": 1e6}]
    corr = [0]
    t = 10.0

    def op(cat, host_ts, dur, name="k"):
        corr[0] += 1
        c = corr[0]
        evs.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                    "ts": host_ts, "dur": 1.0, "args": {"correlation": c}})
        if device:
            evs.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                        "tid": 7, "ts": host_ts + 500.0, "dur": dur,
                        "args": {"correlation": c, "device": 0}})

    def span(name, ts, dur):
        evs.append({"ph": "X", "cat": "user_annotation", "name": name,
                    "pid": 1, "tid": 1, "ts": ts, "dur": dur})

    for _ in range(passes):
        span("t0_fft_yz", t, 100.0)
        op("kernel", t + 10, 60.0)
        op("kernel", t + 20, 40.0)
        span("t2_all_to_all", t + 200, 200.0)
        for k in range(chunks):
            span(f"t2_all_to_all[{k}]", t + 210 + 50 * k, 40.0)
            op("gpu_memcpy", t + 215 + 50 * k, 30.0, "Memcpy DtoD")
        op("gpu_memset", t + 390, 5.0, "Memset")   # outer t2, no chunk
        span("t3_fft_x", t + 500, 100.0)
        op("kernel", t + 510, 70.0)
        op("kernel", t + 700, 999.0)               # under no stage span
        t += 1000.0
    return {"traceEvents": evs}


def test_parse_device_trace_attributes_each_pass():
    parsed = tex.parse_device_trace(_kineto_doc(), iters=2)
    assert parsed["device_pids"] == [0]
    assert parsed["samples"]["t0"] == [pytest.approx(100e-6)] * 2
    # the two chunk copies and the fill outside the chunks, per pass
    assert parsed["samples"]["t2"] == [pytest.approx(65e-6)] * 2
    assert parsed["samples"]["t3"] == [pytest.approx(70e-6)] * 2
    assert set(parsed["samples"]) == {"t0", "t2", "t3"}
    assert parsed["chunks"] == {
        "t2_all_to_all[0]": {"count": 2, "seconds": pytest.approx(60e-6)},
        "t2_all_to_all[1]": {"count": 2, "seconds": pytest.approx(60e-6)}}


def test_parse_device_trace_indivisible_count_aggregates():
    parsed = tex.parse_device_trace(_kineto_doc(passes=3), iters=2)
    assert parsed["samples"]["t0"] == [pytest.approx(150e-6)]
    assert parsed["samples"]["t3"] == [pytest.approx(105e-6)]


def test_parse_device_trace_none_without_device_operations():
    assert tex.parse_device_trace(_kineto_doc(device=False)) is None
    assert tex.parse_device_trace({"traceEvents": "garbage"}) is None
    assert tex.parse_device_trace({"traceEvents": []}) is None


def test_join_device_ops_innermost_span():
    ops, spans = tex.join_device_ops(_kineto_doc(passes=1))
    names = [None if s is None else s["name"] for _, _, s in ops]
    assert names == ["t0_fft_yz", "t0_fft_yz", "t2_all_to_all[0]",
                     "t2_all_to_all[1]", "t2_all_to_all", "t3_fft_x", None]
    assert len(spans) == 5   # the execute span has no stage key


def test_trace_doc_round_trips_through_a_file(tmp_path):
    import gzip

    doc = _kineto_doc()
    plain, packed = tmp_path / "t.json", tmp_path / "t.json.gz"
    plain.write_text(json.dumps(doc))
    with gzip.open(packed, "wt") as f:
        json.dump(doc, f)
    for path in (plain, packed):
        assert (tex.parse_device_trace(tex._load_trace_doc(str(path)), 2)
                == tex.parse_device_trace(doc, 2))


# ------------------------------------------------------- live records

def _plans(kind):
    """(port plan, JAX plan) of one geometry at 16^3, complex64."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu import operators as jop

    c64 = np.complex64
    if kind == "slab":
        return (tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu"),
                jdfft.plan_dft_c2c_3d(SHAPE, jdfft.make_mesh(4), dtype=c64))
    if kind == "pencil":
        return (tdfft.plan_dft_c2c_3d(SHAPE, (2, 2), device="cpu"),
                jdfft.plan_dft_c2c_3d(SHAPE, jdfft.make_mesh((2, 2)),
                                      dtype=c64))
    if kind == "single":
        return (tdfft.plan_dft_c2c_3d(SHAPE, None, device="cpu"),
                jdfft.plan_dft_c2c_3d(SHAPE, None, dtype=c64))
    return (tdfft.operators.plan_spectral_op(
                SHAPE, 4, op=tdfft.operators.poisson(), device="cpu"),
            jop.plan_spectral_op(SHAPE, jdfft.make_mesh(4),
                                 op=jop.poisson(), dtype=c64))


def _key_tree(v):
    """The nested key structure of a record: dicts by key, lists of
    dicts by element. A divergence's ``direction`` is left out: it is
    there exactly when the verdict is True, which follows the clock."""
    if isinstance(v, dict):
        if "diverged" in v:
            assert ("direction" in v) == (v["diverged"] is True)
        return {k: _key_tree(x) for k, x in v.items() if k != "direction"}
    if isinstance(v, list) and v and all(isinstance(x, dict) for x in v):
        return [_key_tree(x) for x in v]
    return None


@pytest.mark.parametrize("kind", ["slab", "pencil", "single", "op"])
def test_cpu_explain_record_matches_jax(kind):
    tplan, jplan = _plans(kind)
    rec = tdfft.explain(tplan, iters=2)
    want = _jex().explain(jplan, iters=2)
    assert _key_tree(rec) == _key_tree(want)
    json.dumps(rec)
    keys = OP_STAGE_KEYS if kind == "op" else STAGE_KEYS
    assert tuple(rec["stages"]) == keys
    assert rec["staged_available"] and rec["timing"]["source"] == "host"
    for key in ("t0", "t3") + (("t_mid",) if kind == "op" else ()):
        meas = rec["stages"][key]["measured"]
        assert meas["available"] and len(meas["samples"]) == 2
    if kind == "pencil":
        assert rec["stages"]["t1"]["measured"]["available"]
        assert [leg["stage"] for leg in rec["stages"]["t2"]["legs"]] == [
            "t2a", "t2b"]
    # the model section under the same hardware numbers
    assert_same(tex.model_stage_estimates(tplan, HW),
                _jex().model_stage_estimates(jplan, HW))
    # the allocator's view: the bytes the CPU knows, no peak
    comp = rec["compiled"]
    assert comp["argument_bytes"] == comp["output_bytes"] == 8 * 16 ** 3
    assert comp["peak_hbm_bytes"] is None and comp["flops"] is None
    t0 = rec["stages"]["t0"]["compiled"]
    assert t0["available"] and t0["argument_bytes"] == 8 * 16 ** 3


def test_device_timing_falls_back_on_the_cpu():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu")
    rec = tdfft.explain(plan, iters=2, device_timing=True)
    assert rec["timing"]["source"] == "host"
    assert rec["timing"]["device_requested"] is True
    assert rec["timing"]["fallback_reason"] == (
        "no device operations under stage spans in trace")
    assert "host sync brackets" in tex.format_explain(rec)


def test_device_timing_reads_the_environment(monkeypatch):
    plan = tdfft.plan_dft_c2c_3d(SHAPE, None, device="cpu")
    monkeypatch.setenv("DFFT_DEVICE_TIMING", "1")
    assert tdfft.explain(plan, iters=2)["timing"]["device_requested"]
    monkeypatch.setenv("DFFT_DEVICE_TIMING", "0")
    assert not tdfft.explain(plan, iters=2)["timing"]["device_requested"]


def test_measure_false_runs_nothing(monkeypatch):
    calls = []
    for name in ("_measure_stages", "device_stage_samples",
                 "_run_measured"):
        monkeypatch.setattr(tex, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    tm.metrics_reset()
    tm.enable_metrics()
    try:
        plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, algorithm="ppermute",
                                     device="cpu")
        rec = tdfft.explain(plan, measure=False, device_timing=True)
        assert tm.metrics_snapshot()["counters"].get("executes", {}) == {}
    finally:
        tm.enable_metrics(False)
        tm.metrics_reset()
    assert calls == []
    assert not rec["staged_available"]
    for key in STAGE_KEYS:
        assert rec["stages"][key]["measured"]["available"] is False
    assert rec["stages"]["t2"]["model"]["wire_bytes"] > 0
    assert rec["stages"]["t2"]["model"]["steps"] == 3
    assert rec["compiled"]["peak_hbm_bytes"] is None


def test_compiled_summary_cached_on_the_cpu():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu")
    cs = tex.compiled_summary(plan)
    assert set(cs) == {"compile_seconds", "flops", "bytes_accessed",
                       "argument_bytes", "output_bytes", "temp_bytes",
                       "generated_code_bytes", "peak_hbm_bytes"}
    assert tex.compiled_summary(plan) is cs


def test_staged_refusals_follow_jax():
    """No staged twin: a real single plan, a brick plan, an r2c_axis
    view, a pencil operator; a hierarchical slab plan has one."""
    import distributedfft_tpu_torch.geometry as geo

    w = geo.world_box(SHAPE)
    ins = geo.make_slabs(w, 4, axis=2)
    outs = geo.make_slabs(w, 4, axis=0)
    refused = [
        tdfft.plan_dft_r2c_3d(SHAPE, None, device="cpu"),
        tdfft.plan_brick_dft_c2c_3d(SHAPE, 4, ins, outs, device="cpu"),
        tdfft.plan_dft_r2c_3d(SHAPE, 4, r2c_axis=0, device="cpu"),
        tdfft.operators.plan_spectral_op(
            SHAPE, (2, 2), op=tdfft.operators.poisson(), device="cpu"),
    ]
    for plan in refused:
        assert tex._staged_for(plan) is None, plan.describe()["kind"]
    hier = tdfft.plan_dft_c2c_3d(
        SHAPE, tdfft.make_world((2, 2), tdfft.HYBRID_AXES),
        algorithm="hierarchical", device="cpu")
    names = [n for n, _ in tex._staged_for(hier)]
    assert names[1:3] == ["t2a_exchange_ici", "t2b_exchange_dcn"]
    rec = tdfft.explain(hier, iters=2)
    legs = rec["stages"]["t2"]["legs"]
    assert [leg["stage"] for leg in legs] == ["t2a", "t2b"]
    assert all(len(leg["measured_samples"]) == 2 for leg in legs)


def test_device_profile_on_the_cpu(tmp_path, monkeypatch):
    from distributedfft_tpu_torch import calibrate as cal
    from distributedfft_tpu_torch import tuner

    monkeypatch.setenv("DFFT_HW_PROFILE", str(tmp_path / "p.json"))
    base = tex.device_profile()
    assert base["source"] == "default"
    assert (base["device_kind"], base["backend"]) == ("cpu", "cpu")
    assert base["hbm_gbps"] == tuner.MODEL_HBM_GBPS
    assert base["peak_tflops"] == max(tuner.MODEL_MM_TFLOPS.values())
    cal.write_profile({"schema": cal.PROFILE_SCHEMA, "device_kind": "cpu",
                       "platform": "cpu", "hbm_gbps": 55.5,
                       "wire_gbps": None, "mm_highest_tflops": 7.5,
                       "ici_gbps": 33.0,
                       "recorded_at": "2026-08-04T00:00:00"})
    hw = tex.device_profile()
    assert hw["source"] == "calibrated"
    assert hw["hbm_gbps"] == 55.5 and hw["mm_highest_tflops"] == 7.5
    assert hw["wire_gbps"] == 33.0
    assert hw["calibrated_at"] == "2026-08-04T00:00:00"
    assert hw["launch_seconds"] == base["launch_seconds"]
    monkeypatch.setenv("DFFT_HW_PROFILE", "0")
    assert tex.device_profile()["source"] == "default"


def test_device_specs_hold_the_h100_row_only():
    assert list(tex.DEVICE_SPECS) == ["h100 80gb hbm3"]
    peak, hbm, wire = tex.DEVICE_SPECS["h100 80gb hbm3"]
    assert (peak, hbm) == (989.0, 3350.0)
    from distributedfft_tpu_torch.tuner import MODEL_WIRE_GBPS

    assert wire == MODEL_WIRE_GBPS


def test_explain_name_rule():
    """``dfft.explain`` is the function, ``dfft.explain_mod`` the module,
    whoever imports the module later."""
    import importlib

    importlib.import_module("distributedfft_tpu_torch.explain")
    assert callable(tdfft.explain) and not hasattr(tdfft.explain,
                                                   "format_explain")
    assert tdfft.explain_mod is tex


def test_explain_allgather_on_a_loopback_world():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu")
    rec = tdfft.explain(plan, iters=2, allgather=True)
    ah = rec["across_hosts"]
    assert ah["processes"] == 1
    assert set(ah["stages"]) == {"t0", "t2", "t3"}
    assert all(row["n"] == 1 for row in ah["stages"].values())
    assert "across 1 host process(es)" in tex.format_explain(rec)


def _explain_rank(rank, size, init, out_dir):
    """One gloo rank: the explain record of a slab plan over the process
    group, its stage medians gathered across the ranks."""
    import os

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        world = tdfft.process_group_world()
        plan = tdfft.plan_dft_c2c_3d(SHAPE, world, device="cpu")
        rec = tdfft.explain(plan, iters=2, allgather=True)
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump(dict(across=rec["across_hosts"],
                           devices=rec["plan"]["devices"],
                           staged=rec["staged_available"],
                           own={k: rec["stages"][k]["measured"]["seconds"]
                                for k in STAGE_KEYS}), f)
    finally:
        dist.destroy_process_group()


def test_explain_allgather_over_a_gloo_group(tmp_path):
    import torch.multiprocessing as mp

    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_explain_rank, args=(2, init, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    r0, r1 = (json.load(open(tmp_path / f"r{r}.json")) for r in (0, 1))
    assert r0["across"] == r1["across"]
    assert r0["devices"] == 2 and r0["staged"] and r1["staged"]
    ah = r0["across"]
    assert ah["processes"] == 2 and set(ah["stages"]) == {"t0", "t2", "t3"}
    for key, row in ah["stages"].items():
        assert row["n"] == 2
        assert row["min"] == min(r0["own"][key], r1["own"][key])
        assert row["max"] == max(r0["own"][key], r1["own"][key])


def test_join_device_ops_by_another_span_key():
    """The join over spans of one name (chip_smoke's pointwise spans):
    each chunk span alone."""
    ops, spans = tex.join_device_ops(
        _kineto_doc(passes=2), span_key=lambda n: n if n.endswith("[1]")
        else None)
    assert len(spans) == 2
    assert sum(op["dur"] for op, _, s in ops if s is not None) == 60.0


def test_device_capture_made_again_after_a_lost_pass(monkeypatch):
    """A capture whose stage has device time in some passes and none in
    another is made again; the first whole one is kept."""
    good = tex.parse_device_trace(_kineto_doc(), iters=2)
    lost = {"samples": dict(good["samples"], t0=[0.0, 100e-6]),
            "chunks": {}, "device_pids": [0]}
    assert tex._lost_pass(lost) and not tex._lost_pass(good)
    seen = iter([lost, good])
    monkeypatch.setattr(tex, "parse_device_trace",
                        lambda doc, iters: next(seen))
    monkeypatch.setattr(tex, "_load_trace_doc", lambda path: {})
    plan = tdfft.plan_dft_c2c_3d(SHAPE, None, device="cpu")
    stages = tex._staged_for(plan)
    parsed, reason = tex.device_stage_samples(stages, tdfft.alloc_local(plan),
                                              iters=2)
    assert reason is None and parsed is good


def test_device_capture_pads_the_window(monkeypatch):
    """Each capture launches a pad of fills after the profiled window
    opens and another before it closes, with the passes between; a
    capture that lost a pass makes the next one's pads DEVICE_PAD_GROWTH
    times longer, and the kept capture records its pad length."""
    good = tex.parse_device_trace(_kineto_doc(), iters=2)
    lost = {"samples": dict(good["samples"], t0=[0.0, 100e-6]),
            "chunks": {}, "device_pids": [0]}
    seen = iter([lost, lost, good])
    monkeypatch.setattr(tex, "parse_device_trace",
                        lambda doc, iters: next(seen))
    monkeypatch.setattr(tex, "_load_trace_doc", lambda path: {})
    events = []
    monkeypatch.setattr(tex, "_pad", lambda scratch, n: events.append(n))
    plan = tdfft.plan_dft_c2c_3d(SHAPE, None, device="cpu")
    stages = [(k, (lambda fn: lambda x: (events.append("pass"), fn(x))[1])(
        fn)) for k, fn in tex._staged_for(plan)]
    parsed, reason = tex.device_stage_samples(stages, tdfft.alloc_local(plan),
                                              iters=2)
    assert reason is None and parsed is good
    p0, g = tex.DEVICE_PAD_LAUNCHES, tex.DEVICE_PAD_GROWTH
    assert parsed["pad_launches"] == p0 * g * g
    pads = [n for n in events if n != "pass"]
    assert pads == [p0, p0, p0 * g, p0 * g, p0 * g * g, p0 * g * g]
    # per capture: the warm-up step's pass, a pad, the passes, a pad
    per = len(stages)
    capture = ["pass"] * per + [p0] + ["pass"] * (2 * per) + [p0]
    assert events[per:per + len(capture)] == capture


def test_pad_fills_its_scratch():
    scratch = torch.ones(8)
    tex._pad(scratch, 3)
    assert not scratch.any()
    tex._pad(scratch, 0)
