"""The port's live monitor (``distributedfft_tpu_torch/monitor.py``:
``Monitor``, ``load_series``, the health engine, the Prometheus
rendering), held against ``tests/test_monitor.py``, the monitor parts of
``tests/test_a2o_monitor.py`` and the JAX package.

- ``Monitor.from_env`` reads ``DFFT_MONITOR`` / ``DFFT_MONITOR_DIR`` as
  JAX's does (same interval, same path, same ``ValueError``); the daemon
  sampler's loop is driven with a stop event the test controls, and a
  sampler that raises is swallowed and counted.
- A queue without the variables carries no monitor and, in flush mode,
  no wave stats; its results equal an armed queue's bit for bit. Armed,
  it carries both, and ``close()`` stops the sampler.
- ``health_from_samples`` and ``prometheus_from_sample`` give the JAX
  package's dict and text on the same series (synthetic ones, and ones
  the port's ``Monitor`` wrote), and ``load_series`` reads the same.
- A port queue and a JAX queue fed the same seeded submits and flushes,
  their clocks and QoS buckets on one fake time axis, give equal
  ``queue`` (depth, groups, flush_seq, stalls), ``qos`` and
  ``numerics`` blocks; the stall watchdog fires once per group per
  episode and re-arms, in both, and the port records its
  ``serve_stall[c2c]`` spans.

No test waits on the wall clock; thread joins are bounded.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import monitor as jmon
from distributedfft_tpu import numerics as jnum
from distributedfft_tpu import qos as jqos
from distributedfft_tpu import serving as jserving
from distributedfft_tpu.utils import metrics as jm
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import monitor as tmon
from distributedfft_tpu_torch import numerics as tnum
from distributedfft_tpu_torch import qos as tqos
from distributedfft_tpu_torch import serving as tserving
from distributedfft_tpu_torch.utils import metrics as tm
from distributedfft_tpu_torch.utils import trace as tr

SHAPE = (8, 8, 8)
CPU = dict(device="cpu")
T128 = torch.complex128
J128 = jnp.complex128


class FakeClock:
    """``perf_counter`` / ``monotonic`` / ``time`` / ``sleep`` on one fake
    axis (a sleep advances it by at least a microsecond)."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    monotonic = time = perf_counter

    def sleep(self, s):
        self.t += max(s, 1e-6)


class FakeTimer:
    """A ``threading.Timer`` that never starts."""

    def __init__(self, interval, fn, args=()):
        self.daemon = True

    def start(self):
        pass


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both packages' serving and monitor modules."""
    c = FakeClock()
    for mod in (tserving, jserving, tmon, jmon):
        monkeypatch.setattr(mod, "time", c)
    for mod in (tserving, jserving):
        monkeypatch.setattr(mod.threading, "Timer", FakeTimer)
    return c


@pytest.fixture
def metrics_on():
    for reg in (tm, jm):
        reg.enable_metrics()
        reg.metrics_reset()
    yield
    for reg in (tm, jm):
        reg.metrics_reset()
        reg.enable_metrics(False)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Every test starts with no monitor variables and a dark numerics
    plane in both packages; the process-lifetime armed flags are
    restored afterwards, so no later test sees a numerics block."""
    for var in ("DFFT_MONITOR", "DFFT_MONITOR_DIR", "DFFT_QOS",
                "DFFT_SHADOW_RATE", "DFFT_RETRY_MAX",
                "DFFT_SERVE_STREAMING", "DFFT_CONCURRENT_GROUPS",
                "DFFT_FAULT_INJECT"):
        monkeypatch.delenv(var, raising=False)
    armed = (tnum._ARMED, jnum._ARMED)
    for mod in (tnum, jnum):
        mod.reset_numerics()
    tdfft.clear_plan_cache()
    yield
    for mod in (tnum, jnum):
        mod.reset_numerics()
    tnum._ARMED, jnum._ARMED = armed
    tdfft.clear_plan_cache()


def _np_world(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _queue(**kw):
    kw.setdefault("max_batch", 64)
    return tdfft.CoalescingQueue(None, dtype=T128, **CPU, **kw)


def _jqueue(**kw):
    kw.setdefault("max_batch", 64)
    return jdfft.CoalescingQueue(None, dtype=J128, **kw)


# ------------------------------------------------------------ lifecycle

ENV_CASES = [
    ({}, None),
    ({"DFFT_MONITOR": "0"}, None),
    ({"DFFT_MONITOR": "-2"}, None),
    ({"DFFT_MONITOR": "0.5"}, (0.5, None)),
    ({"DFFT_MONITOR": "0.25, /tmp/series.jsonl "},
     (0.25, "/tmp/series.jsonl")),
    ({"DFFT_MONITOR_DIR": "DIR"}, (tmon.DEFAULT_DIR_INTERVAL_S, "DIR")),
    ({"DFFT_MONITOR_DIR": "DIR", "DFFT_MONITOR": "0.05"}, (0.05, "DIR")),
    ({"DFFT_MONITOR_DIR": "DIR",
      "DFFT_MONITOR": "0.05,/tmp/explicit.jsonl"},
     (0.05, "/tmp/explicit.jsonl")),
    ({"DFFT_MONITOR_DIR": "DIR", "DFFT_MONITOR": "0"}, None),
    ({"DFFT_MONITOR_DIR": "  "}, None),
]


@pytest.mark.parametrize("env, want", ENV_CASES)
def test_from_env_matches_jax(monkeypatch, tmp_path, env, want):
    """Both packages arm the same interval and path from the same
    variables; ``DIR`` stands for a temporary directory, whose series
    is ``monitor-<host>-<pid>.jsonl`` in both."""
    for k, v in env.items():
        monkeypatch.setenv(k, v.replace("DIR", str(tmp_path)))
    got = [tmon.Monitor.from_env(), jmon.Monitor.from_env()]
    if want is None:
        assert got == [None, None]
        return
    interval, path = want
    if path == "DIR":
        path = os.path.join(str(tmp_path), f"monitor-{tmon._HOST}-"
                                           f"{os.getpid()}.jsonl")
    for mon in got:
        assert (mon.interval_s, mon.path) == (interval, path)
    assert tmon._HOST == jmon._HOST


def test_from_env_malformed_raises_jax_message(monkeypatch):
    monkeypatch.setenv("DFFT_MONITOR", "fast,/tmp/x")
    msgs = []
    for mod in (tmon, jmon):
        with pytest.raises(ValueError, match="DFFT_MONITOR") as e:
            mod.Monitor.from_env()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("bad", [0, -1.0, True, "1"])
def test_interval_validation(bad):
    for mod in (tmon, jmon):
        with pytest.raises(ValueError, match="interval_s"):
            mod.Monitor(interval_s=bad)


def test_constants_match_jax():
    for name in ("MONITOR_SCHEMA", "HEALTH_SCHEMA", "DEFAULT_DIR_INTERVAL_S",
                 "DEFAULT_STALL_FACTOR", "DEFAULT_STALL_GRACE_S",
                 "DEFAULT_FAST_WINDOW_S", "DEFAULT_SLOW_WINDOW_S",
                 "DEFAULT_BURN_THRESHOLD"):
        assert getattr(tmon, name) == getattr(jmon, name), name
    assert tmon.__all__ == jmon.__all__


def test_process_index_without_a_group():
    assert not torch.distributed.is_initialized()
    assert tmon._process_index() is None
    assert tmon.Monitor().sample()["process_index"] is None


def test_start_stop_idempotent(tmp_path):
    """A long interval: the thread never samples on its own; ``stop``
    joins it and takes the one final sample."""
    path = str(tmp_path / "s.jsonl")
    mon = tmon.Monitor(interval_s=60.0, path=path)
    try:
        assert mon.start() is mon
        t1 = mon._thread
        assert t1 is not None and t1.is_alive() and t1.daemon
        mon.start()
        assert mon._thread is t1
    finally:
        mon.stop()
    assert not t1.is_alive() and mon._thread is None
    assert [d["seq"] for d in tmon.load_series(path)] == [0]
    mon.stop()                          # idempotent: no second sample
    assert len(tmon.load_series(path)) == 1
    mon.start()
    t2 = mon._thread
    assert t2 is not None and t2 is not t1 and t2.is_alive()
    mon.stop()
    assert not t2.is_alive() and len(tmon.load_series(path)) == 2
    manual = tmon.Monitor()
    assert manual.start() is manual and manual._thread is None
    assert manual.sample()["schema"] == tmon.MONITOR_SCHEMA
    manual.stop()
    assert len(manual.samples) == 1     # no thread: no final sample


class _Ticks:
    """A stop event whose ``wait`` lets ``n`` intervals pass, then
    stops."""

    def __init__(self, n):
        self.n, self.waits = n, []

    def wait(self, timeout):
        self.waits.append(timeout)
        self.n -= 1
        return self.n < 0


def test_sampler_loop_streams_jsonl(tmp_path):
    path = str(tmp_path / "series.jsonl")
    mon = tmon.Monitor(interval_s=0.02, path=path)
    mon._stop = ticks = _Ticks(3)
    mon._run()
    assert ticks.waits == [0.02] * 4
    docs = tmon.load_series(path)
    assert [d["seq"] for d in docs] == [0, 1, 2]
    assert all(d["schema"] == tmon.MONITOR_SCHEMA for d in docs)
    assert docs == json.loads(json.dumps(mon.samples))
    assert mon.errors == 0


def test_sampler_loop_swallows_and_counts_errors(monkeypatch):
    """A sampler that fails every time keeps the process up and shows as
    an empty series plus its error count."""
    mon = tmon.Monitor(interval_s=0.02)
    monkeypatch.setattr(tmon._metrics, "metrics_snapshot",
                        lambda: 1 / 0)
    mon._stop = _Ticks(5)
    mon._run()
    assert mon.errors == 5 and mon.samples == []


def test_sample_document_shape_matches_jax(metrics_on):
    tpol = tqos.QosPolicy([tqos.Tenant("acme", "interactive",
                                       slo_wait_s=1.0)])
    jpol = jqos.QosPolicy([jqos.Tenant("acme", "interactive",
                                       slo_wait_s=1.0)])
    q, jq = _queue(policy=tpol), _jqueue(policy=jpol)
    x = _np_world(1)
    q.submit(torch.from_numpy(x), tenant="acme")
    jq.submit(jnp.asarray(x), tenant="acme")
    doc, jdoc = tmon.Monitor(q).sample(), jmon.Monitor(jq).sample()
    assert set(doc) == set(jdoc) == {
        "schema", "ts", "mono", "host", "pid", "process_index", "seq",
        "metrics", "queue", "qos"}
    assert (doc["host"], doc["pid"]) == (tmon._HOST, os.getpid())
    assert isinstance(doc["mono"], float)
    assert set(doc["queue"]) == set(jdoc["queue"])
    qb = doc["queue"]
    assert (qb["kind"], qb["depth"], qb["groups"], qb["stalls_total"]) \
        == ("c2c", 1, 1, 0)
    assert isinstance(doc["qos"]["tenants"]["acme"]["waits"], list)
    bare = tmon.Monitor().sample()
    assert bare["queue"] is None and bare["qos"] is None
    q.flush()
    jq.flush()


def test_concurrent_writers_one_series(tmp_path):
    path = str(tmp_path / "shared.jsonl")
    nthreads, nsamples = 4, 25

    def worker():
        mon = tmon.Monitor(path=path)
        for _ in range(nsamples):
            mon.sample()

    threads = [threading.Thread(target=worker) for _ in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == nthreads * nsamples
    for ln in lines:
        json.loads(ln)
    assert len(tmon.load_series(path)) == nthreads * nsamples


# -------------------------------------------------- arming in the queue

def test_disarmed_queue_has_no_hook_and_equals_an_armed_one(
        monkeypatch, tmp_path):
    """Without the variables: no monitor and, in flush mode, no wave
    stats. Armed: both, and the same submits give the same outputs bit
    for bit."""
    xs = [torch.from_numpy(_np_world(s)) for s in (1, 2, 3)]
    plain = _queue()
    assert plain._monitor is None and plain._wave_stats is None
    hs = [plain.submit(x) for x in xs]
    assert plain.flush() == 3
    want = [h.result() for h in hs]
    plain.close()
    assert plain._monitor is None and plain._wave_stats is None
    monkeypatch.setenv("DFFT_MONITOR", f"60,{tmp_path / 'armed.jsonl'}")
    armed = _queue()
    try:
        assert armed._monitor is not None
        assert armed._wave_stats is not None and not armed._streaming
        hs = [armed.submit(x) for x in xs]
        assert armed.flush() == 3
        for h, w in zip(hs, want):
            assert torch.equal(h.result(), w)
    finally:
        armed.close()
    docs = tmon.load_series(str(tmp_path / "armed.jsonl"))
    assert len(docs) == 1 and docs[0]["queue"]["waves"]["waves"] == 1


def test_env_armed_queue_and_close(tmp_path, monkeypatch):
    path = str(tmp_path / "armed.jsonl")
    monkeypatch.setenv("DFFT_MONITOR", f"60,{path}")
    q = _queue()
    mon = q._monitor
    assert mon is not None and mon.queue is q and mon.interval_s == 60.0
    assert mon._thread is not None and mon._thread.is_alive()
    x = torch.from_numpy(_np_world(3))
    h = q.submit(x)
    mid = mon.sample()
    assert mid["queue"]["depth"] == 1 and mid["queue"]["streaming"] is False
    q.flush()
    ref = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, **CPU)
    assert torch.equal(h.result(), ref(x))
    t = mon._thread
    q.close()
    assert not t.is_alive()
    docs = tmon.load_series(path)
    assert [d["queue"]["depth"] for d in docs] == [1, 0]
    q.close()                           # idempotent
    h2 = q.submit(torch.from_numpy(_np_world(4)))
    q.flush()
    h2.result()


def test_monitor_dir_names_the_series(tmp_path, monkeypatch):
    from distributedfft_tpu_torch.fleet import series_path

    monkeypatch.setenv("DFFT_MONITOR_DIR", str(tmp_path))
    monkeypatch.setenv("DFFT_MONITOR", "60")
    q = _queue()
    try:
        assert q._monitor.path == series_path(str(tmp_path))
    finally:
        q.close()
    assert os.path.exists(series_path(str(tmp_path)))


# -------------------------------------------------------- health engine

def _hsample(ts, *, submits=0.0, misses=0.0, shed=0.0, declared=True,
             slo_ok=None, stalls=0.0, degraded=0.0, tenant="acme",
             numerics=None):
    """One synthetic monitor sample with lifetime ledger totals (the
    JAX test's, plus an optional numerics block)."""
    t = {"class": "interactive", "submits": submits, "transforms": submits,
         "deadline_misses": misses, "quota_shed": shed}
    if declared:
        t["slo_wait_s"] = 1.0
    if slo_ok is not None:
        t["slo_ok"] = slo_ok
    counters = {}
    if degraded:
        counters["serving_degraded"] = {"kind=c2c": degraded}
    doc = {
        "schema": 1, "ts": ts, "pid": 1, "seq": int(ts),
        "metrics": {"counters": counters},
        "queue": {"kind": "c2c", "depth": 0, "groups": 0,
                  "oldest_pending_age_s": 0.0, "flush_seq": 0,
                  "stalls_total": stalls},
        "qos": {"schema": 1, "tenants": {tenant: t}},
    }
    if numerics is not None:
        doc["numerics"] = numerics
    return doc


def _nblock(nonfinite=None, drifting=False):
    return {"schema": 1, "sampled": 4, "audited": 4, "audit_failures": 0,
            "slack": 8.0, "nonfinite": dict(nonfinite or {}),
            "plans": {"p|acme": {
                "plan": "slab4:c2c", "tenant": "acme", "n": 40,
                "admitted_err": 1e-6, "floor": 1e-7,
                "realized_p50": 2e-6, "realized_p99": 9e-5 if drifting
                else 3e-6, "drift_ratio": 90.0 if drifting else 3.0,
                "drifting": drifting, "errors": [2e-6, 3e-6]}}}


HEALTH_CASES = {
    "empty": ([], "unknown"),
    "ok_below_threshold": ([_hsample(0, submits=100),
                            _hsample(50, submits=120, misses=1)], "ok"),
    "fast_burn": ([_hsample(0, submits=100),
                   _hsample(50, submits=120, misses=10)], "alert"),
    "diffed_not_rates": ([_hsample(0, submits=1000, misses=400),
                          _hsample(30, submits=1000, misses=400)], "ok"),
    "slow_burn": ([_hsample(0, submits=100),
                   _hsample(300, submits=200, misses=40),
                   _hsample(500, submits=201, misses=40),
                   _hsample(520, submits=202, misses=40)], "warn"),
    "lifetime_violation": ([_hsample(0, submits=10, slo_ok=False)],
                           "alert"),
    "quota_and_degraded": ([
        _hsample(0, submits=10, declared=False),
        _hsample(30, submits=20, shed=3, declared=False, degraded=2.0)],
        "warn"),
    "stall": ([_hsample(0), _hsample(30, stalls=1.0)], "alert"),
    "burn_and_stall": ([_hsample(0, submits=100),
                        _hsample(50, submits=120, misses=10, stalls=1.0)],
                       "alert"),
    "accuracy_drift": ([_hsample(0, numerics=_nblock()),
                        _hsample(10, numerics=_nblock(drifting=True))],
                       "alert"),
    "nonfinite_output": ([_hsample(0, numerics=_nblock()),
                          _hsample(10, numerics=_nblock(
                              {"output:nan": 2}))], "alert"),
    "nonfinite_input": ([_hsample(0, numerics=_nblock()),
                         _hsample(10, numerics=_nblock(
                             {"input:inf": 1}))], "warn"),
}


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_health_from_samples_equals_jax(case):
    samples, status = HEALTH_CASES[case]
    got = tmon.health_from_samples(samples)
    assert got == jmon.health_from_samples(samples)
    assert got["status"] == status
    kw = dict(fast_window_s=20.0, slow_window_s=40.0, burn_threshold=0.3)
    assert tmon.health_from_samples(samples, **kw) == \
        jmon.health_from_samples(samples, **kw)


def test_health_verdict_details():
    v = tmon.health_from_samples(HEALTH_CASES["fast_burn"][0])
    (a,) = [x for x in v["alerts"] if x["name"] == "slo_burn"]
    assert a["tenant"] == "acme" and a["burn_fast"] == pytest.approx(0.5)
    (a,) = tmon.health_from_samples(HEALTH_CASES["slow_burn"][0])["alerts"]
    assert a["name"] == "slo_burn_slow" and a["burn_slow"] > 0.1
    v = tmon.health_from_samples(HEALTH_CASES["stall"][0])
    assert [a["name"] for a in v["alerts"]] == ["stall"]
    assert v["totals"]["stalls"] == 1.0


def test_health_snapshot_single_shot(metrics_on):
    v = tmon.health_snapshot()
    assert v["schema"] == tmon.HEALTH_SCHEMA
    assert v["status"] == "ok" and v["samples"] == 1


def test_monitor_health_uses_its_windows():
    mon = tmon.Monitor(fast_window_s=5.0, slow_window_s=9.0,
                       burn_threshold=0.5)
    v = mon.health(HEALTH_CASES["fast_burn"][0])
    assert v == jmon.health_from_samples(
        HEALTH_CASES["fast_burn"][0], fast_window_s=5.0, slow_window_s=9.0,
        burn_threshold=0.5)
    assert mon.health()["samples"] == 1    # a fresh sample when empty


# --------------------------------------------------- Prometheus rendering

PROM_SAMPLE = {
    "ts": 1234.5,
    "metrics": {
        "counters": {"executes": {"kind=c2c,shape=(64, 64, 64)": 3}},
        "gauges": {"serving_queue_depth": {"kind=c2c": 2}},
        "histograms": {"serving_wait_seconds": {"kind=c2c": {
            "count": 2, "total": 0.3, "mean": 0.15, "min": 0.1,
            "max": 0.2, "p50": 0.15, "p99": 0.2, "exact": True}}},
    },
    "queue": {"kind": "c2c", "depth": 5, "groups": 2,
              "oldest_pending_age_s": 0.25, "flush_seq": 7,
              "stalls_total": 1,
              "waves": {"waves": 4, "preemptions": 1,
                        "bumped_transforms": 2, "idle_s": 0.5,
                        "busy_s": 1.5, "idle_fraction": 0.25,
                        "width_mean": 1.5, "wave_duration_max_s": 0.1,
                        "admit_wait": {"realtime": {"n": 3, "p50_s": 0.01,
                                                    "p99_s": 0.02}}}},
    "qos": {"tenants": {"acme": {
        "submits": 10, "transforms": 9, "quota_shed": 2,
        "deadline_misses": 1, "wait_p50_s": 0.01, "wait_p99_s": 0.2,
        "slo_wait_s": 0.05, "slo_ok": False}}},
    "numerics": _nblock({"output:nan": 1}),
}


def test_prometheus_rendering_equals_jax():
    text = tmon.prometheus_from_sample(PROM_SAMPLE)
    assert text == jmon.prometheus_from_sample(PROM_SAMPLE)
    lines = text.splitlines()
    assert ('dfft_executes_total{kind="c2c",shape="(64, 64, 64)"} 3'
            in lines)
    assert "# TYPE dfft_executes_total counter" in lines
    assert 'dfft_serving_wait_seconds_count{kind="c2c"} 2' in lines
    assert ('dfft_serving_wait_seconds{kind="c2c",quantile="0.5"} 0.15'
            in lines)
    assert 'dfft_queue_stalls_total{kind="c2c"} 1' in lines
    assert 'dfft_wave_idle_fraction{kind="c2c"} 0.25' in lines
    assert 'dfft_tenant_slo_ok{tenant="acme"} 0' in lines
    assert ('dfft_numerics_nonfinite_total{site="output",kind="nan"} 1'
            in lines)
    assert text.endswith("\n")
    extra = {"proc": "h:1", "host": "h"}
    assert tmon._render_prom(tmon._prom_rows(PROM_SAMPLE, extra)) == \
        jmon._render_prom(jmon._prom_rows(PROM_SAMPLE, extra))


def test_prometheus_text_from_live_monitor(metrics_on):
    q = _queue()
    q.submit(torch.from_numpy(_np_world(9)))
    text = tmon.Monitor(q).prometheus_text()
    assert 'dfft_serving_submits_total{kind="c2c"} 1' in text
    assert 'dfft_queue_depth{kind="c2c"} 1' in text
    q.flush()


def test_load_series_is_lenient_and_sorts(tmp_path):
    path = str(tmp_path / "messy.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps(_hsample(20)) + "\n")
        f.write("{torn line\n")
        f.write("[1, 2]\n")
        f.write(json.dumps(_hsample(5)) + "\n")
    docs = tmon.load_series(path)
    assert [d["ts"] for d in docs] == [5, 20]
    assert docs == jmon.load_series(path)
    assert tmon.load_series(str(tmp_path / "absent.jsonl")) == []


# --------------------------------------- a port queue beside a JAX queue

def _comparable(doc):
    """A sample's queue, qos and numerics blocks without the wall-clock
    ages."""
    qb = dict(doc["queue"])
    qb.pop("oldest_pending_age_s")
    if "stalled" in qb:
        qb["stalled"] = [{k: v for k, v in s.items() if k != "age_s"}
                         for s in qb["stalled"]]
    return {"queue": qb, "qos": doc["qos"], "numerics": doc.get("numerics")}


def test_live_samples_equal_jax(clock, metrics_on, monkeypatch, tmp_path):
    """Two tenants, the numerics sentinels armed (``DFFT_SHADOW_RATE=0``)
    and one NaN input, the same seeded submits and flushes in both
    packages on one fake clock: each sample's queue, qos and numerics
    blocks are equal, and the port's series reads back through both
    packages' ``load_series`` and health engines alike."""
    monkeypatch.setenv("DFFT_SHADOW_RATE", "0")
    def policy(mod):
        return mod.QosPolicy([mod.Tenant("acme", "interactive",
                                         slo_wait_s=5.0),
                              mod.Tenant("bulk", "batch")],
                             clock=clock.monotonic)

    q, jq = _queue(policy=policy(tqos)), _jqueue(policy=policy(jqos))
    path = str(tmp_path / "port.jsonl")
    mon, jmonitor = tmon.Monitor(q, path=path), jmon.Monitor(jq)
    seq = [(1, "acme", 8), (2, "bulk", 8), (3, "acme", 4),
           (4, "acme", 8), (5, "bulk", 8)]
    for i, (seed, tenant, n) in enumerate(seq):
        x = _np_world(seed, (n, 8, 8))
        if i == 2:
            x[0, 0, 0] = np.nan
        q.submit(torch.from_numpy(x), tenant=tenant)
        jq.submit(jnp.asarray(x), tenant=tenant)
        clock.t += 0.01
        if i in (1, 4):
            assert _comparable(mon.sample()) == \
                _comparable(jmonitor.sample())
            q.flush()
            jq.flush()
            clock.t += 0.01
            assert _comparable(mon.sample()) == \
                _comparable(jmonitor.sample())
    docs = tmon.load_series(path)
    assert len(docs) == 4 and docs == jmon.load_series(path)
    newest = docs[-1]
    assert newest["numerics"]["nonfinite"] == {"input:nan": 1}
    assert newest["qos"]["tenants"]["acme"]["submits"] == 3
    assert tmon.health_from_samples(docs) == jmon.health_from_samples(docs)
    assert tmon.prometheus_from_sample(newest) == \
        jmon.prometheus_from_sample(newest)


def test_stall_watchdog_fires_once_and_rearms(clock, metrics_on, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("DFFT_TRACE_NATIVE", "0")
    tr.init_tracing(str(tmp_path / "stall"))
    try:
        q, jq = _queue(), _jqueue()
        mons = [tmon.Monitor(q, stall_factor=1.0, stall_grace_s=0.05),
                jmon.Monitor(jq, stall_factor=1.0, stall_grace_s=0.05)]
        qs = [q, jq]

        def step(submit_seed=None, advance=0.0, flush=False):
            if submit_seed is not None:
                x = _np_world(submit_seed)
                q.submit(torch.from_numpy(x))
                jq.submit(jnp.asarray(x))
            clock.t += advance
            if flush:
                for qq in qs:
                    qq.flush()
            docs = [m.sample() for m in mons]
            assert _comparable(docs[0]) == _comparable(docs[1])
            return docs[0]["queue"]

        s1 = step(submit_seed=7)
        assert s1["stalls_total"] == 0      # no progress baseline yet
        s2 = step(advance=0.12)
        assert s2["stalls_total"] == 1
        assert s2["stalled"] == [{"age_s": pytest.approx(0.12),
                                  "tenant": None}]
        s3 = step()                          # the same episode
        assert s3["stalls_total"] == 1 and "stalled" not in s3
        assert tm.counter_total("serving_stalls") == 1
        assert jm.counter_total("serving_stalls") == 1
        s4 = step(flush=True)                # progress re-arms
        assert s4["depth"] == 0 and s4["flush_seq"] > s2["flush_seq"]
        s5 = step(submit_seed=8, advance=0.12)   # a new episode
        assert s5["stalls_total"] == 2
        for qq in qs:
            qq.flush()
        names = [n for n, _, _ in tr._events]
    finally:
        tr.finalize_tracing()
    assert names.count("serve_stall[c2c]") == 2
