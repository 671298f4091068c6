"""The port's serving tier (``serving.py``: ``Handle``, ``submit``,
``CoalescingQueue``, ``warm_pool``), held against ``tests/test_serving.py``
(not the bench.py / speed3d drivers), the serving part of
``tests/test_a2e_batch.py`` and ``tests/test_a2f_flightrec.py``, and
the JAX package.

A port queue and a JAX queue fed the same seeded requests give the same
group keys (shape, dtype name, direction[, tenant]), flush reasons,
drain order and ``serving_*`` counters, each read from its package's own
registry; their outputs agree within the complex128 tier (1e-11), and
the port's batched outputs equal its unbatched plan bit for bit on the
CPU. ``warm_pool`` preplans from a wisdom file written by the port's
tuner the tuples JAX's preplans from its own. The constructor refuses a
process-group world, and ``DFFT_MONITOR`` / ``DFFT_MONITOR_DIR`` arm a
live monitor with the interval and series path they name (a flush-mode
queue then also carries wave stats). The queue's timers are fired by hand and its clock is fake where a deadline
is under test; thread joins carry timeouts of 10 s or less.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import tuner as jtuner
from distributedfft_tpu.utils import metrics as jm
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import serving, tuner
from distributedfft_tpu_torch.parallel.mesh import World
from distributedfft_tpu_torch.serving import Handle
from distributedfft_tpu_torch.utils import metrics as tm
from distributedfft_tpu_torch.utils import trace as tr

SHAPE = (8, 8, 8)
CPU = dict(device="cpu")
T128 = torch.complex128
J128 = jnp.complex128
TOL128 = 1e-11


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 1e-6)


class FakeTimer:
    """A ``threading.Timer`` the test fires by hand."""

    armed: list = []

    def __init__(self, interval, fn, args=()):
        self.interval, self.fn, self.args = interval, fn, args
        self.daemon = True

    def start(self):
        FakeTimer.armed.append(self)

    def fire(self):
        self.fn(*self.args)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(serving, "time", c)
    FakeTimer.armed = []
    monkeypatch.setattr(serving.threading, "Timer", FakeTimer)
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
    for var in ("DFFT_MONITOR", "DFFT_MONITOR_DIR", "DFFT_QOS",
                "DFFT_SHADOW_RATE", "DFFT_RETRY_MAX",
                "DFFT_SERVE_STREAMING", "DFFT_CONCURRENT_GROUPS"):
        monkeypatch.delenv(var, raising=False)
    tdfft.clear_plan_cache()
    yield
    tdfft.clear_plan_cache()


def _np_world(seed=0, shape=SHAPE, real=False):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal(shape)
    return r if real else r + 1j * rng.standard_normal(shape)


def _world(seed=0, shape=SHAPE, real=False):
    return torch.from_numpy(_np_world(seed, shape, real))


def _queue(world=None, **kw):
    kw.setdefault("max_batch", 8)
    return tdfft.CoalescingQueue(world, dtype=T128, **CPU, **kw)


def _plan(world=None, shape=SHAPE, **kw):
    return tdfft.plan_dft_c2c_3d(shape, world, dtype=T128, **CPU, **kw)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _reason_count(reason: str) -> float:
    rows = tdfft.metrics_snapshot()["counters"].get(
        "serving_flush_reasons", {})
    return sum(v for lbl, v in rows.items() if f"reason={reason}" in lbl)


# ---------------------------------------------------------------- handles

def test_submit_returns_a_resolved_handle():
    plan = _plan()
    x = _world(1)
    h = tdfft.submit(plan, x)
    y = h.result()
    assert h.done() and h._ready == ()      # a CPU output has no event
    assert torch.equal(y, plan(x))
    assert torch.equal(h.result(), y)       # idempotent
    jy = jdfft.submit(jdfft.plan_dft_c2c_3d(SHAPE, None, dtype=J128),
                      jnp.asarray(x.numpy())).result()
    assert _rel(y.numpy(), jy) < TOL128


def test_handle_failure_propagates():
    h = Handle()
    h._fail(RuntimeError("boom"))
    assert h.done()
    with pytest.raises(RuntimeError, match="boom"):
        h.result()


def test_pending_handle_times_out_without_queue():
    with pytest.raises(TimeoutError):
        Handle().result(timeout=0.01)


def test_handle_waits_on_its_ready_events():
    """``result()`` synchronises every event recorded after the launches
    that made the output; ``done()`` asks each whether it has passed."""

    class Ev:
        def __init__(self, ok):
            self.ok, self.synced = ok, 0

        def query(self):
            return self.ok

        def synchronize(self):
            self.synced += 1
            self.ok = True

    evs = (Ev(True), Ev(False))
    h = Handle._resolved("y", evs)
    assert not h.done()
    assert h.result() == "y"
    assert [e.synced for e in evs] == [1, 1] and h.done()


# ------------------------------------------------------------------ queue

def test_queue_groups_by_shape_dtype_direction_as_jax():
    """Three tuples, three groups, keyed as the JAX queue keys them."""
    reqs = [(_np_world(2), -1), (_np_world(3, (4, 4, 4)), -1),
            (_np_world(4), 1)]
    q = _queue()
    jq = jdfft.CoalescingQueue(None, dtype=J128, max_batch=8)
    hs = [q.submit(torch.from_numpy(v), direction=d) for v, d in reqs]
    jhs = [jq.submit(jnp.asarray(v), direction=d) for v, d in reqs]
    assert q.pending() == 3 and len(q._pending) == 3
    assert list(q._pending) == list(jq._pending)
    assert [h._key for h in hs] == [h._key for h in jhs]
    assert q.flush() == jq.flush() == 3
    for (v, d), h, jh in zip(reqs, hs, jhs):
        y = h.result(timeout=10)
        assert torch.equal(y, _plan(shape=v.shape, direction=d)(
            torch.from_numpy(v)))
        assert _rel(y.numpy(), jh.result(timeout=10)) < TOL128


@pytest.mark.parametrize("world", [None, 4, (2, 2)])
def test_batched_flush_equals_unbatched_plan(world, metrics_on):
    """A group of 3 runs one batch=3 plan call (one ``executes``), equal
    to the unbatched plan bit for bit and to JAX's within the tier."""
    xs = [_np_world(s) for s in (5, 6, 7)]
    q = _queue(world)
    hs = [q.submit(torch.from_numpy(v)) for v in xs]
    assert q.flush() == 3
    snap = tdfft.metrics_snapshot()
    assert snap["counters"]["serving_flushes"]["kind=c2c"] == 1.0
    assert snap["counters"]["serving_transforms"]["kind=c2c"] == 3.0
    assert sum(snap["counters"]["executes"].values()) == 1.0
    ref = _plan(world)
    jref = jdfft.plan_dft_c2c_3d(
        SHAPE, None if world is None else jdfft.make_mesh(world), dtype=J128)
    for v, h in zip(xs, hs):
        y = h.result(timeout=10)
        assert torch.equal(y, ref(torch.from_numpy(v)))
        assert _rel(y.numpy(), jref(jnp.asarray(v))) < TOL128


def test_queue_validation():
    with pytest.raises(ValueError, match="kind"):
        tdfft.CoalescingQueue(None, kind="c2r", **CPU)
    with pytest.raises(ValueError, match="max_batch"):
        tdfft.CoalescingQueue(None, max_batch=0, **CPU)
    with pytest.raises(ValueError, match="owned by the queue"):
        tdfft.CoalescingQueue(None, batch=4, **CPU)
    q = _queue()
    with pytest.raises(ValueError, match="3D"):
        q.submit(torch.zeros((2,) + SHAPE, dtype=T128))
    with pytest.raises(ValueError, match="backward r2c"):
        tdfft.CoalescingQueue(None, kind="r2c", **CPU).submit(
            torch.zeros((8, 8, 5)), direction=tdfft.BACKWARD)


def test_process_group_world_is_refused():
    with pytest.raises(ValueError, match="process group"):
        tdfft.CoalescingQueue(World(4, rank=1), **CPU)
    tdfft.CoalescingQueue(World(4), **CPU)      # loopback: served


@pytest.mark.parametrize("var, value", [("DFFT_MONITOR", "0.5"),
                                        ("DFFT_MONITOR", "1,TMP/x.jsonl"),
                                        ("DFFT_MONITOR_DIR", "TMP/mon")])
def test_monitor_env_raises_until_the_monitor_exists(monkeypatch, tmp_path,
                                                     var, value):
    """The variables arm a monitor with the interval and path they name
    (the name is kept from when the port refused them)."""
    from distributedfft_tpu_torch.fleet import series_path
    from distributedfft_tpu_torch.monitor import (DEFAULT_DIR_INTERVAL_S,
                                                  Monitor)

    monkeypatch.setenv(var, value.replace("TMP", str(tmp_path)))
    q = tdfft.CoalescingQueue(None, **CPU)
    try:
        mon = q._monitor
        assert isinstance(mon, Monitor) and mon.queue is q
        assert mon._thread is not None and mon._thread.is_alive()
        want = {"0.5": (0.5, None),
                "1,TMP/x.jsonl": (1.0, str(tmp_path / "x.jsonl")),
                "TMP/mon": (DEFAULT_DIR_INTERVAL_S,
                            series_path(str(tmp_path / "mon")))}[value]
        assert (mon.interval_s, mon.path) == want
        assert q._wave_stats is not None and not q._streaming
    finally:
        q.close()
    assert mon._thread is None


def test_monitor_env_off_values_are_quiet(monkeypatch):
    monkeypatch.setenv("DFFT_MONITOR", "0")
    monkeypatch.setenv("DFFT_MONITOR_DIR", "  ")
    q = tdfft.CoalescingQueue(None, **CPU)
    assert q._monitor is None and q._wave_stats is None


def test_queue_r2c_forward():
    xs = [_np_world(s, real=True) for s in (8, 9)]
    q = tdfft.CoalescingQueue(None, kind="r2c", max_batch=4, dtype=T128,
                              **CPU)
    hs = [q.submit(torch.from_numpy(v)) for v in xs]
    q.flush()
    ref = tdfft.plan_dft_r2c_3d(SHAPE, None, dtype=T128, **CPU)
    jref = jdfft.plan_dft_r2c_3d(SHAPE, None, dtype=J128)
    for v, h in zip(xs, hs):
        y = h.result(timeout=10)
        assert torch.equal(y, ref(torch.from_numpy(v)))
        assert _rel(y.numpy(), jref(jnp.asarray(v))) < TOL128


def test_queue_coerces_inputs_to_the_plan():
    """numpy and complex64 requests become complex128 tensors on the
    plan's device (as JAX's ``jnp.asarray(x, dtype)``)."""
    q = _queue()
    v = _np_world(10)
    h1 = q.submit(v)
    h2 = q.submit(torch.from_numpy(v.astype(np.complex64)))
    q.flush()
    ref = _plan()
    assert torch.equal(h1.result(timeout=10), ref(torch.from_numpy(v)))
    assert torch.equal(h2.result(timeout=10), ref(torch.from_numpy(
        v.astype(np.complex64).astype(np.complex128))))


def test_queue_warm_preplans_and_compiles(metrics_on):
    """``warm`` builds each plan a flush will use into the plan cache and
    compiles it (one throwaway execution each)."""
    q = _queue(max_batch=4)
    assert q.warm([SHAPE], batches=(None, 4)) == 2
    plan = q._plan((SHAPE, T128, tdfft.FORWARD), 4, False)
    assert plan.batch == 4 and plan._warm
    assert tm.counter_total("plan_cache_hits") == 1
    assert sum(h["count"] for h in tdfft.metrics_snapshot()["histograms"][
        "compile_seconds"].values()) == 2


def test_auto_flush_and_lazy_result_on_a_world():
    ref = _plan(4)
    q = _queue(4, max_batch=2)
    x1, x2 = _world(11), _world(12)
    h1 = q.submit(x1)
    q.submit(x2)                       # reaches max_batch: auto-flush
    assert q.pending() == 0
    assert torch.equal(h1.result(timeout=10), ref(x1))
    h3 = q.submit(x1)                  # a singleton: the unbatched plan
    assert q.pending() == 1
    assert torch.equal(h3.result(timeout=10), ref(x1))
    assert q.pending() == 0


def test_submit_await_direct_on_a_world():
    plan = _plan(4)
    x = _world(21)
    h = tdfft.submit(plan, x)
    assert torch.equal(h.result(), plan(x)) and h.done()


# ------------------------------------------------------ deadline flush

def test_deadline_flushes_stale_group_with_reason(clock, metrics_on):
    q = _queue(max_wait_s=0.1)
    h = q.submit(_world(11))
    (timer,) = FakeTimer.armed
    assert timer.interval == 0.1 and q.pending() == 1
    timer.fire()                       # not yet aged: left alone
    assert q.pending() == 1
    clock.t += 0.1
    timer.fire()
    assert q.pending() == 0
    assert torch.equal(h.result(timeout=10), _plan()(_world(11)))
    assert _reason_count("deadline") == 1


def test_deadline_never_misfires_on_a_full_flushed_group(clock,
                                                         metrics_on):
    q = _queue(max_batch=2, max_wait_s=0.15)
    h1 = q.submit(_world(12))
    h2 = q.submit(_world(13))          # full: flushed at once
    assert q.pending() == 0
    h1.result(timeout=10), h2.result(timeout=10)
    clock.t += 1.0
    FakeTimer.armed[0].fire()          # the old group's timer
    assert _reason_count("full") == 1 and _reason_count("deadline") == 0
    h3 = q.submit(_world(14))          # a new group, its own timer
    assert len(FakeTimer.armed) == 2
    clock.t += 0.2
    FakeTimer.armed[1].fire()
    assert q.pending() == 0
    h3.result(timeout=10)
    assert _reason_count("deadline") == 1


def test_deadline_validation_and_default_off(clock):
    with pytest.raises(ValueError, match="max_wait_s"):
        tdfft.CoalescingQueue(None, max_wait_s=0.0, **CPU)
    with pytest.raises(ValueError, match="max_wait_s"):
        tdfft.CoalescingQueue(None, max_wait_s=True, **CPU)
    q = _queue()
    h = q.submit(_world(15))
    assert FakeTimer.armed == [] and h._enqueued is None
    clock.t += 100.0
    assert q.pending() == 1
    q.flush()
    h.result(timeout=10)


def test_request_deadline_cancels_with_wait_breakdown(clock, metrics_on):
    q = _queue()
    doomed = q.submit(_world(61), deadline_s=0.05)
    safe = q.submit(_world(62))
    (timer,) = FakeTimer.armed
    clock.t += 0.07
    timer.fire()
    assert doomed.done()
    with pytest.raises(tdfft.DeadlineExceeded) as ei:
        doomed.result(timeout=10)
    assert (ei.value.stage, ei.value.deadline_s) == ("queued", 0.05)
    assert ei.value.waited_s == pytest.approx(0.07)
    assert q.pending() == 1
    q.flush()
    assert torch.equal(safe.result(timeout=10), _plan()(_world(62)))
    assert sum(tdfft.metrics_snapshot()["counters"][
        "serving_expired"].values()) == 1


def test_request_expired_at_flush_fails_alone(clock, metrics_on):
    """A request whose deadline passed before its timer ran is failed by
    the flush's expiry filter; its group runs without it."""
    q = _queue()
    doomed = q.submit(_world(63), deadline_s=0.05)
    safe = q.submit(_world(64))
    clock.t += 0.06
    assert q.flush() == 1
    with pytest.raises(tdfft.DeadlineExceeded):
        doomed.result(timeout=10)
    assert torch.equal(safe.result(timeout=10), _plan()(_world(64)))


def test_deadline_met_in_time_resolves_normally():
    q = _queue()
    h = q.submit(_world(63), deadline_s=30.0)
    q.flush()
    assert torch.equal(h.result(timeout=10), _plan()(_world(63)))


def test_deadline_validation():
    q = _queue()
    for bad in (0.0, True, -1):
        with pytest.raises(ValueError, match="deadline_s"):
            q.submit(_world(64), deadline_s=bad)


# ---------------------------------------------------------- backpressure

def test_backpressure_raise_policy_sheds_load(metrics_on):
    q = _queue(max_pending=1, admission="raise")
    h = q.submit(_world(65))
    with pytest.raises(tdfft.QueueFull):
        q.submit(_world(66))
    assert sum(tdfft.metrics_snapshot()["counters"][
        "serving_rejected"].values()) == 1
    q.flush()
    h.result(timeout=10)
    h2 = q.submit(_world(66))          # depth fell: admission open
    q.flush()
    h2.result(timeout=10)


def test_backpressure_block_policy_waits_for_space():
    """The second submit parks on the admission condition (seen through
    a wrapped ``wait``), and a flush wakes it."""
    q = _queue(max_pending=1)
    h1 = q.submit(_world(67))
    parked = threading.Event()
    real_wait = q._space.wait

    def wait(timeout=None):
        parked.set()
        return real_wait(timeout)

    q._space.wait = wait
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault("h", q.submit(_world(68))),
        daemon=True)
    t.start()
    assert parked.wait(10)
    assert q.pending() == 1
    q.flush()
    t.join(10)
    assert not t.is_alive()
    h1.result(timeout=10)
    q.flush()
    assert torch.equal(out["h"].result(timeout=10), _plan()(_world(68)))


def test_backpressure_block_honors_request_deadline():
    q = _queue(max_pending=1)
    q.submit(_world(69))
    with pytest.raises(tdfft.DeadlineExceeded) as ei:
        q.submit(_world(70), deadline_s=0.05)
    assert ei.value.stage == "admission"
    q.flush()


def test_queue_robustness_validation():
    with pytest.raises(ValueError, match="max_pending"):
        tdfft.CoalescingQueue(None, max_pending=0, **CPU)
    with pytest.raises(ValueError, match="admission"):
        tdfft.CoalescingQueue(None, admission="dropnewest", **CPU)
    with pytest.raises(ValueError, match="retry_backoff_s"):
        tdfft.CoalescingQueue(None, retry_backoff_s=-1.0, **CPU)


def test_result_flushes_before_its_timeout():
    q = _queue()
    q.warm([SHAPE])
    h = q.submit(_world(71))
    assert q.pending() == 1
    assert torch.equal(h.result(timeout=10), _plan()(_world(71)))
    assert q.pending() == 0


# --------------------------------------------------------- flight recorder

def test_disabled_recorder_records_nothing():
    assert not tr.tracing_enabled()
    tm.enable_metrics(False)
    tm.metrics_reset()
    q = _queue()
    xs = [_world(s) for s in (31, 32)]
    hs = [q.submit(v) for v in xs]
    assert all(h._req_id is None and h._enqueued is None for h in hs)
    assert q.flush(reason="manual") == 2
    for v, h in zip(xs, hs):
        assert torch.equal(h.result(), _plan()(v))
    snap = tdfft.metrics_snapshot()
    assert snap["counters"] == snap["histograms"] == snap["gauges"] == {}
    assert tdfft.submit(_plan(), xs[0])._req_id is None


def test_metrics_only_run_records_depth_wait_and_reason(metrics_on):
    assert not tr.tracing_enabled()
    q = _queue(max_batch=2)
    h1 = q.submit(_world(41))
    snap = tdfft.metrics_snapshot()
    assert snap["gauges"]["serving_queue_depth"]["kind=c2c"] == 1.0
    q.submit(_world(42))               # auto-flush
    h1.result()
    q.submit(_world(43)).result()      # lazy flush
    snap = tdfft.metrics_snapshot()
    reasons = snap["counters"]["serving_flush_reasons"]
    assert reasons["kind=c2c,reason=full"] == 1.0
    assert reasons["kind=c2c,reason=result"] == 1.0
    assert snap["histograms"]["serving_wait_seconds"]["kind=c2c"][
        "count"] == 3
    assert snap["gauges"]["serving_queue_depth"]["kind=c2c"] == 0.0
    assert snap["counters"]["serving_flushes"]["kind=c2c"] == 2.0


class _Session:
    """A trace session under ``tmp_path``; ``events`` holds its spans
    (``record_span``'s retroactive ones too) once the block exits."""

    def __init__(self, tmp_path):
        self.root, self.events = str(tmp_path / "trace"), []

    def __enter__(self):
        tr.init_tracing(self.root)
        return self

    def __exit__(self, *exc):
        self.events = list(tr._events or ())
        tr.finalize_tracing()


@pytest.mark.parametrize("world", [None, 4])
def test_request_spans_with_the_stage_spans(tmp_path, metrics_on, world):
    """submit / wait / flush / plan / execute / result spans, unique ids,
    on one timeline with the chain's t0..t3 stage spans."""
    with _Session(tmp_path) as session:
        q = _queue(world)
        hs = [q.submit(_world(s)) for s in (1, 2, 3)]
        assert q.flush() == 3
        for h in hs:
            h.result()
            assert h._req_id is not None
    ev = session.events
    names = [e[0] for e in ev]
    assert sum(n.startswith("serve_submit[") for n in names) == 3
    assert len({n for n in names if n.startswith("serve_wait[")}) == 3
    for span in ("serve_flush", "serve_plan", "serve_execute"):
        assert f"{span}[c2c:b3:manual]" in names
    assert sum(n.startswith("serve_result[") for n in names) == 3
    if world is not None:
        assert {"t0", "t2", "t3"} <= {tr.stage_key(n) for n in names}
    flush = next(e for e in ev if e[0] == "serve_flush[c2c:b3:manual]")
    for name, _, stop in ev:
        if name.startswith("serve_wait["):
            assert stop <= flush[2]


def test_auto_flush_reason_and_result_reason(tmp_path, metrics_on):
    with _Session(tmp_path) as session:
        q = _queue(4, max_batch=2)
        h1 = q.submit(_world(11))
        q.submit(_world(12))
        h1.result()
        q.submit(_world(13)).result()
    names = {e[0] for e in session.events}
    assert {"serve_flush[c2c:b2:full]", "serve_flush[c2c:b1:result]"} <= \
        names


# ------------------------------------------------- queue parity with JAX

def _serving_counters(snap):
    return {(name, lbl): v for name, rows in snap["counters"].items()
            if name.startswith("serving_") for lbl, v in rows.items()}


def _serving_hists(snap):
    return {(name, lbl): (h["count"], h["total"] if "wait" not in name
                          else None)
            for name, rows in snap["histograms"].items()
            if name.startswith("serving_") for lbl, h in rows.items()}


@pytest.mark.parametrize("world", [None, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_queue_script_equals_jax(metrics_on, world, seed):
    """The same seeded script of submits (shapes, directions, tenants),
    auto-flushes, limited flushes and awaits in both packages: the same
    group keys, executed groups in the same order with the same flush
    reasons, the same ``serving_*`` counters and histogram counts, and
    outputs within the tier."""
    rng = np.random.default_rng(seed)
    script = []
    for i in range(24):
        op = rng.integers(10)
        if op < 7:
            script.append(("submit", i, [(8, 8, 8), (4, 8, 8)][
                rng.integers(2)], int([-1, 1][rng.integers(2)]),
                [None, "acme"][rng.integers(2)]))
        elif op < 9:
            script.append(("flush", int(rng.integers(1, 4))))
        else:
            script.append(("result",))
    runs = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            q = _queue(world, max_batch=3)
            wrap, conv, reg = torch.from_numpy, lambda y: y.numpy(), tm
        else:
            q = jdfft.CoalescingQueue(
                None if world is None else jdfft.make_mesh(world),
                dtype=J128, max_batch=3)
            wrap, conv, reg = jnp.asarray, np.asarray, jm
        reg.metrics_reset()
        executed = []
        real = q._execute_group

        def spy(key, group, _real=real, _ex=executed, **kw):
            _ex.append((key, len(group), kw.get("reason")))
            return _real(key, group, **kw)

        q._execute_group = spy
        hs = []
        for step in script:
            if step[0] == "submit":
                _, i, shape, d, tenant = step
                hs.append(q.submit(wrap(_np_world(i, shape)), direction=d,
                                   tenant=tenant))
            elif step[0] == "flush":
                q.flush(limit=step[1])
            elif hs:
                hs[-1].result(timeout=10)
        q.flush()
        outs = [conv(h.result(timeout=10)) for h in hs]
        snap = reg.metrics_snapshot()
        runs.append((executed, [h._key for h in hs], outs,
                     _serving_counters(snap), _serving_hists(snap)))
    (ex, keys, outs, cnt, hist), (jex, jkeys, jouts, jcnt, jhist) = runs
    assert ex == jex and keys == jkeys
    assert cnt == jcnt and hist == jhist
    for a, b in zip(outs, jouts):
        assert _rel(a, b) < TOL128


def test_concurrent_flush_equals_sequential_and_jax(metrics_on):
    """``concurrent_groups=2`` on a 4-rank world: two groups in one
    interleaved dispatch, each output equal to its plan's bit for bit;
    the concurrent counters as JAX's."""
    a, b = _np_world(80, (16, 8, 8)), _np_world(81, (8, 16, 8))
    q = _queue(4, max_batch=64, concurrent_groups=2)
    jq = jdfft.CoalescingQueue(jdfft.make_mesh(4), dtype=J128, max_batch=64,
                               concurrent_groups=2)
    hs = [q.submit(torch.from_numpy(v)) for v in (a, a, b)]
    jhs = [jq.submit(jnp.asarray(v)) for v in (a, a, b)]
    q.flush()
    jq.flush()
    ra = _plan(4, (16, 8, 8), batch=2)(torch.from_numpy(np.stack([a, a])))
    rb = _plan(4, (8, 16, 8))(torch.from_numpy(b))
    for h, want in zip(hs, (ra[0], ra[1], rb)):
        assert torch.equal(h.result(timeout=10), want)
    for h, jh in zip(hs, jhs):
        assert _rel(h.result().numpy(), jh.result(timeout=10)) < TOL128
    snap, jsnap = tdfft.metrics_snapshot(), jdfft.metrics_snapshot()
    for name in ("serving_concurrent_dispatches",
                 "serving_concurrent_transforms", "serving_flushes"):
        assert snap["counters"][name] == jsnap["counters"][name]


def test_auto_width_equals_jax():
    """``concurrent_groups="auto"`` prices the same pending groups to the
    same width in both packages (on a loopback world at K = 1 the model
    hides no exchange under another group's compute, so one)."""
    q = _queue(4, max_batch=64, concurrent_groups="auto")
    jq = jdfft.CoalescingQueue(jdfft.make_mesh(4), dtype=J128, max_batch=64,
                               concurrent_groups="auto")
    for qq, wrap in ((q, torch.from_numpy), (jq, jnp.asarray)):
        for s, shape in ((82, (16, 8, 8)), (83, (8, 16, 8)),
                         (84, (16, 8, 8))):
            qq.submit(wrap(_np_world(s, shape)))
    with q._lock:
        w = q._concurrent_width(list(q._pending.items()))
    with jq._lock:
        jw = jq._concurrent_width(list(jq._pending.items()))
    assert w == jw == 1
    q.flush()
    jq.flush()


# -------------------------------------------------------------- warm pool

def _port_entry(path, recorded_at, shape=SHAPE, batch=None, ndev=1,
                **extra):
    key = tuner.wisdom_key(kind="c2c", shape=shape, dtype=T128,
                           direction=tdfft.FORWARD, ndev=ndev,
                           mesh_dims=None, batch=batch)
    key.update(extra)
    entry = {"schema": tuner.WISDOM_SCHEMA, "recorded_at": recorded_at,
             "key": key,
             "winner": {"decomposition": "slab", "algorithm": "alltoall",
                        "executor": "cuda", "overlap_chunks": 1},
             "seconds": 0.001}
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def _jax_entry(path, recorded_at, shape=SHAPE, batch=None, ndev=1):
    key = jtuner.wisdom_key(kind="c2c", shape=shape, dtype=J128,
                            direction=-1, ndev=ndev, mesh_dims=None,
                            batch=batch)
    with open(path, "a") as f:
        f.write(json.dumps({
            "schema": jtuner.WISDOM_SCHEMA, "recorded_at": recorded_at,
            "key": key,
            "winner": {"decomposition": "slab", "algorithm": "alltoall",
                       "executor": "xla", "overlap_chunks": 1},
            "seconds": 0.001}) + "\n")


def _stores(tmp_path, entries):
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    for e in entries:
        _port_entry(mine, *e)
        _jax_entry(theirs, *e)
    return str(mine), str(theirs)


@pytest.mark.parametrize("top_n, max_batch", [(2, None), (1, None),
                                              (1, 4), (8, 2)])
def test_warm_pool_preplans_the_tuples_jax_does(tmp_path, top_n,
                                                max_batch):
    """From a store written with the port's ``wisdom_key`` (JAX's from
    its own): the newest ``top_n`` tuples of this world size, each also
    at ``max_batch``; a foreign world size filtered out."""
    mine, theirs = _stores(tmp_path, [
        ("2026-08-01T00:00:00",), ("2026-08-02T00:00:00", (4, 4, 4)),
        ("2026-08-03T00:00:00", (6, 6, 6), None, 64),
        ("2026-08-04T00:00:00", (8, 4, 4), 2)])
    got = tdfft.warm_pool(None, top_n=top_n, path=mine,
                          max_batch=max_batch, **CPU)
    want = jdfft.warm_pool(None, top_n=top_n, path=theirs,
                           max_batch=max_batch)
    assert [(p.shape, p.batch) for p in got] == [
        (p.shape, p.batch) for p in want]
    assert got


def test_warm_pool_on_a_world_size(tmp_path):
    mine, theirs = _stores(tmp_path, [
        ("2026-08-01T00:00:00", SHAPE, None, 4),
        ("2026-08-02T00:00:00", (4, 4, 4), None, 1)])
    got = tdfft.warm_pool(4, path=mine, **CPU)
    want = jdfft.warm_pool(jdfft.make_mesh(4), path=theirs)
    assert [p.shape for p in got] == [p.shape for p in want] == [SHAPE]
    assert got[0].world.size == 4


def test_warm_pool_keeps_this_build_only(tmp_path):
    """An entry of another torch or CUDA version, another platform, a
    layout or a degraded annotation is never replayed."""
    path = tmp_path / "w.jsonl"
    _port_entry(path, "2026-08-01T00:00:00")
    _port_entry(path, "2026-08-02T00:00:00", (4, 4, 4), torch="0.0")
    _port_entry(path, "2026-08-03T00:00:00", (6, 6, 6), cuda="99.9")
    _port_entry(path, "2026-08-04T00:00:00", (8, 4, 4), platform="gpu")
    _port_entry(path, "2026-08-05T00:00:00", (4, 8, 4), layouts="a|b")
    _port_entry(path, "2026-08-06T00:00:00", (4, 4, 8),
                annotation="degraded")
    assert [p.shape for p in tdfft.warm_pool(None, top_n=8,
                                             path=str(path), **CPU)] == [
        SHAPE]


def test_warm_pool_empty_store_is_quiet(tmp_path):
    assert tdfft.warm_pool(None, path=str(tmp_path / "none.jsonl"),
                           **CPU) == []


def test_warm_pool_counts_stale_skips(tmp_path, capsys, metrics_on):
    path = tmp_path / "w.jsonl"
    _port_entry(path, "2026-08-01T00:00:00")
    _port_entry(path, "2026-08-03T00:00:00", (8, 8))
    plans = tdfft.warm_pool(None, top_n=4, path=str(path), **CPU)
    assert [p.shape for p in plans] == [SHAPE]
    snap = tdfft.metrics_snapshot()
    assert snap["counters"]["serving_warm_pool_skipped"][""] == 1.0
    assert snap["gauges"]["serving_warm_pool_plans"][""] == 1.0
    assert "skipped 1 stale wisdom tuple" in capsys.readouterr().err


def test_warm_pool_spans_and_zero_timing(tmp_path, metrics_on):
    path = tmp_path / "w.jsonl"
    _port_entry(path, "2026-08-01T00:00:00")
    _port_entry(path, "2026-08-02T00:00:00", (4, 4, 4))
    with _Session(tmp_path) as session:
        plans = tdfft.warm_pool(None, top_n=2, path=str(path),
                                max_batch=4, **CPU)
    assert len(plans) == 4
    warm = [e[0] for e in session.events if e[0].startswith("warm_plan[")]
    assert {"warm_plan[c2c:4x4x4]", "warm_plan[c2c:4x4x4:b4]"} <= set(warm)
    assert len(warm) == 4
    assert tdfft.metrics_snapshot()["gauges"]["serving_warm_pool_plans"][
        ""] == 4.0
    assert tm.counter_total("plan_builds") >= 1
    assert tm.counter_total("tune_timing_executions") == 0
