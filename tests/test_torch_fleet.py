"""The port's fleet plane (``distributedfft_tpu_torch/fleet.py``) held
against ``tests/test_fleet.py`` and the JAX package: ``series_path``,
``load_fleet``, ``estimate_offsets``, ``merge_streams``,
``fleet_health``, ``prometheus_from_fleet`` and ``format_fleet`` give
the JAX package's dicts and text on the same inputs: the
``tests/data/fleet_skew`` fixtures (stream 102's wall clock +5 s ahead,
103 torn, 999 empty, a foreign README; ``mixed_schema`` across monitor
schemas 2-4), synthetic streams, and series the port's ``Monitor``
wrote from live queues, which the JAX package's ``load_fleet`` /
``fleet_health`` also read to the same verdict.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from distributedfft_tpu import fleet as jfleet
from distributedfft_tpu import monitor as jmon
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import fleet as tfleet
from distributedfft_tpu_torch import monitor as tmon
from distributedfft_tpu_torch.utils import metrics as tm

FIXDIR = os.path.join(os.path.dirname(__file__), "data", "fleet_skew")
MIXDIR = os.path.join(FIXDIR, "mixed_schema")


def _sample(pid, i, *, skew=0.0, host="h1", waits=(0.01,), submits=None,
            shed=0, misses=0, stalls=0, depth=0, flush=None, slo=1.0,
            tenant="acme", pi=None):
    """The JAX test's synthetic schema-2 sample."""
    waits = list(waits)
    return {
        "schema": 2, "ts": 1000.0 + i + skew, "mono": 50.0 + i,
        "host": host, "pid": pid,
        "process_index": pi, "seq": i,
        "metrics": {"counters": {
            "serving_submits": {"op=fft": float(5 * (i + 1))}}},
        "queue": {"kind": "c2c", "depth": depth,
                  "groups": 1 if depth else 0,
                  "oldest_pending_age_s": 0.5 * depth,
                  "flush_seq": flush if flush is not None else i,
                  "stalls_total": stalls},
        "qos": {"schema": 1, "tenants": {tenant: {
            "class": "interactive", "weight": 1.0, "rate": None,
            "submits": submits if submits is not None else 5 * (i + 1),
            "transforms": 5 * i, "quota_shed": shed,
            "deadline_misses": misses, "slo_wait_s": slo,
            "wait_p50_s": sorted(waits)[len(waits) // 2],
            "wait_p99_s": max(waits), "slo_ok": True,
            "waits": waits}}},
    }


def _stream(pid, n=6, **kw):
    return [_sample(pid, i, **kw) for i in range(n)]


def _with_waves(stream, waves, idle, busy, width):
    out = copy.deepcopy(stream)
    for s in out:
        s["queue"]["waves"] = {"waves": waves, "preemptions": 1,
                               "bumped_groups": 1, "bumped_transforms": 2,
                               "idle_s": idle, "busy_s": busy,
                               "width_mean": width,
                               "wave_duration_max_s": 0.01 * waves}
        s["queue"]["streaming"] = True
    return out


STREAMS = {
    "healthy_pair": lambda: {"h1:1": _stream(1, depth=2),
                             "h1:2": _stream(2, depth=1)},
    "slow_sampler": lambda: {"h1:1": _stream(1, n=8),
                             "h1:2": _stream(2, n=2)},
    "skewed": lambda: {"h1:1": _stream(1), "h1:2": _stream(2, skew=5.0)},
    "quantile_pools": lambda: {
        "h1:1": _stream(1, waits=[0.010 + 0.0001 * k for k in range(40)]),
        "h1:2": _stream(2, waits=[0.100 + 0.0005 * k for k in range(40)])},
    "stalled_member": lambda: {
        "h1:1": _stream(1, n=8),
        "h1:2": [_sample(2, i, stalls=(1 if i >= 5 else 0), depth=3,
                         flush=2) for i in range(8)]},
    "quiet_member": lambda: {"h1:1": _stream(1, n=12),
                             "h1:2": _stream(2, n=3, depth=4),
                             "h1:3": _stream(3, n=3, depth=0)},
    "wait_straggler": lambda: {"h1:1": _stream(1, waits=[0.01] * 8),
                               "h1:2": _stream(2, waits=[0.012] * 8),
                               "h1:3": _stream(3, waits=[0.5] * 8)},
    "burn_straggler": lambda: {
        "h1:1": _stream(1), "h1:2": _stream(2),
        "h1:3": [_sample(3, i, submits=5 * (i + 1), misses=2 * i)
                 for i in range(6)]},
    "quota_imbalance": lambda: {
        "h1:1": _stream(1),
        "h1:2": [_sample(2, i, submits=1) for i in range(6)]},
    "two_hosts": lambda: {
        "hostA:1": _stream(1, host="hostA"),
        "hostB:2": [dict(s, mono=s["mono"] + 1e6)
                    for s in _stream(2, host="hostB")]},
    "waves": lambda: {
        "h1:1": _with_waves(_stream(1), 10, 0.5, 1.5, 1.5),
        "h1:2": _with_waves(_stream(2), 1000, 1.0, 9.0, 2.0)},
    "fixtures": lambda: tfleet.load_fleet(FIXDIR),
    "mixed_schema": lambda: tfleet.load_fleet(MIXDIR),
}


def test_constants_and_names_match_jax():
    assert tfleet.__all__ == jfleet.__all__
    for name in ("FLEET_SCHEMA", "DEFAULT_LAG_FACTOR", "DEFAULT_SKEW_FACTOR",
                 "DEFAULT_MIN_SKEW_S", "DEFAULT_IMBALANCE_SHARE",
                 "_IMBALANCE_MIN_SUBMITS"):
        assert getattr(tfleet, name) == getattr(jfleet, name), name


def test_series_path_and_env(monkeypatch, tmp_path):
    p = tfleet.series_path(str(tmp_path))
    assert p == jfleet.series_path(str(tmp_path)) == str(
        tmp_path / f"monitor-{tmon._HOST}-{os.getpid()}.jsonl")
    assert tfleet.series_path("d", host="h", pid=7) == os.path.join(
        "d", "monitor-h-7.jsonl")
    for val, want in ((None, None), ("  ", None),
                      (str(tmp_path), str(tmp_path))):
        if val is None:
            monkeypatch.delenv("DFFT_MONITOR_DIR", raising=False)
        else:
            monkeypatch.setenv("DFFT_MONITOR_DIR", val)
        assert tfleet.monitor_dir_from_env() == want
        assert jfleet.monitor_dir_from_env() == want


@pytest.mark.parametrize("d", [FIXDIR, MIXDIR, "no-such-dir"])
def test_load_fleet_equals_jax(d):
    path = os.path.join(FIXDIR, d) if d == "no-such-dir" else d
    got = tfleet.load_fleet(path)
    assert got == jfleet.load_fleet(path)
    if d == FIXDIR:
        assert sorted(got) == ["fixhost:101#0", "fixhost:102#1",
                               "fixhost:103#2"]
        assert len(got["fixhost:103#2"]) == 7


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_offsets_and_merge_equal_jax(case):
    streams = STREAMS[case]()
    off = tfleet.estimate_offsets(streams)
    assert off == jfleet.estimate_offsets(streams)
    merged = tfleet.merge_streams(streams)
    assert merged == jfleet.merge_streams(streams)
    assert tfleet.merge_streams(streams, offsets=off, bucket_s=0.5) == \
        jfleet.merge_streams(streams, offsets=off, bucket_s=0.5)
    assert tmon.health_from_samples(merged) == \
        jmon.health_from_samples(merged)


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_fleet_health_and_views_equal_jax(case):
    streams = STREAMS[case]()
    doc = tfleet.fleet_health(streams)
    assert doc == jfleet.fleet_health(streams)
    kw = dict(fast_window_s=3.0, skew_factor=2.0, imbalance_share=0.6,
              lag_factor=1.5)
    assert tfleet.fleet_health(streams, **kw) == \
        jfleet.fleet_health(streams, **kw)
    assert tfleet.format_fleet(doc) == jfleet.format_fleet(doc)
    assert tfleet.prometheus_from_fleet(streams) == \
        jfleet.prometheus_from_fleet(streams)


def test_verdicts_on_the_jax_cases():
    """The verdicts ``tests/test_fleet.py`` pins, on the port."""
    assert tfleet.fleet_health({})["status"] == "unknown"
    assert tfleet.merge_streams({}) == []
    assert tfleet.fleet_health(STREAMS["healthy_pair"]())["status"] == "ok"
    doc = tfleet.fleet_health(STREAMS["stalled_member"]())
    assert ("fleet_stall", "h1:2") in {(a["name"], a.get("proc"))
                                       for a in doc["alerts"]}
    assert doc["status"] == "alert"
    doc = tfleet.fleet_health(STREAMS["quiet_member"]())
    assert {a.get("proc") for a in doc["alerts"]
            if a["name"] == "fleet_stall"} == {"h1:2"}
    doc = tfleet.fleet_health(STREAMS["wait_straggler"]())
    assert [a["proc"] for a in doc["alerts"]
            if a["name"] == "straggler_skew"][0] == "h1:3"
    doc = tfleet.fleet_health(STREAMS["quota_imbalance"]())
    assert doc["status"] == "warn"
    doc = tfleet.fleet_health(STREAMS["fixtures"]())
    assert doc["status"] in ("ok", "warn")
    assert doc["offsets"]["fixhost:102#1"] == pytest.approx(5.0)
    w = tfleet.merge_streams(STREAMS["waves"]())[-1]["queue"]["waves"]
    assert w["waves"] == 1010
    assert w["idle_fraction"] == pytest.approx(1.5 / 12.0)
    assert w["width_mean"] == pytest.approx((15 + 2000) / 1010)


def test_quantile_merge_is_the_pooled_quantile():
    streams = STREAMS["quantile_pools"]()
    t = tfleet.merge_streams(streams)[-1]["qos"]["tenants"]["acme"]
    pool = sorted(streams["h1:1"][0]["qos"]["tenants"]["acme"]["waits"]
                  + streams["h1:2"][0]["qos"]["tenants"]["acme"]["waits"])
    assert t["wait_p50_s"] == pool[int(0.50 * len(pool))]
    assert t["wait_p99_s"] == pool[min(len(pool) - 1,
                                       int(0.99 * len(pool)))]


def test_numerics_pool_equals_jax():
    """The mixed-schema fleet's one numerics block, and two members
    with numerics blocks pooled per (plan, tenant) bucket."""
    streams = STREAMS["mixed_schema"]()
    blocks = [s[-1].get("numerics") for s in streams.values()]
    assert any(blocks)
    assert tfleet._merge_numerics(blocks) == jfleet._merge_numerics(blocks)
    b = next(x for x in blocks if x)
    two = [b, dict(b, sampled=3, nonfinite={"output:nan": 1})]
    got = tfleet._merge_numerics(two)
    assert got == jfleet._merge_numerics(two)
    assert got["nonfinite"].get("output:nan", 0) >= 1
    assert tfleet._merge_numerics([None, None]) is None


# ------------------------------------- series written by the port's Monitor

def _live_series(dir_, stalled: bool):
    """Two streams written by the port's Monitor from live queues into
    ``dir_``; with ``stalled`` the second member's group ages past the
    watchdog with no flush in between."""
    rng = np.random.default_rng(5)
    paths = []
    for member in range(2):
        q = tdfft.CoalescingQueue(None, dtype=torch.complex128,
                                  max_batch=64, device="cpu")
        path = tfleet.series_path(dir_, host="livehost", pid=500 + member)
        mon = tmon.Monitor(q, path=path, stall_factor=1.0,
                           stall_grace_s=1e-9)
        for k in range(3):
            x = rng.standard_normal((8, 8, 8)) + 0j
            q.submit(torch.from_numpy(x))
            if not (stalled and member == 1):
                q.flush()
            mon.sample()
            mon.sample()
        q.flush()
        mon.sample()
        paths.append(path)
    return paths


@pytest.mark.parametrize("stalled", [False, True])
def test_jax_reads_the_ports_series(tmp_path, stalled):
    """Schema compatibility: the JAX package's fleet reader takes the
    port's series and gives the port's verdict."""
    tm.enable_metrics()
    tm.metrics_reset()
    try:
        _live_series(str(tmp_path), stalled)
    finally:
        tm.metrics_reset()
        tm.enable_metrics(False)
    streams = tfleet.load_fleet(str(tmp_path))
    assert len(streams) == 2
    assert streams == jfleet.load_fleet(str(tmp_path))
    doc = tfleet.fleet_health(streams)
    assert doc == jfleet.fleet_health(jfleet.load_fleet(str(tmp_path)))
    assert tfleet.prometheus_from_fleet(streams) == \
        jfleet.prometheus_from_fleet(streams)
    for samples in streams.values():
        assert all(s["schema"] == tmon.MONITOR_SCHEMA for s in samples)
    if stalled:
        assert doc["status"] == "alert"
        assert any(a["name"] == "stall" for a in doc["alerts"])
    else:
        assert doc["status"] in ("ok", "warn")
        assert not [a for a in doc["alerts"] if a["severity"] == "alert"]
    json.dumps(doc)
