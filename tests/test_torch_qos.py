"""The port's multi-tenant QoS (``qos.py``) and its use by the serving
queue, held against ``tests/test_a2n_qos.py``'s cases and the JAX
package (the ``report qos`` command goes with the report's port).

``parse_qos``, ``order_groups``, ``concurrent_chunks``, ``preempt_wave``,
the token-bucket arithmetic and the SLO ledger equal JAX's under the
same fake ``clock=``. The queue's clocks (``time.perf_counter`` and
``time.sleep`` in ``serving``) and its timers (``threading.Timer``) are
replaced by a fake clock and a timer list the test fires by hand, so no
test waits on the wall clock; thread joins carry a 10 s timeout.
"""

import threading

import numpy as np
import pytest
import torch

import distributedfft_tpu as jdfft
from distributedfft_tpu import qos as jqos
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import api, qos, serving
from distributedfft_tpu_torch.qos import QosPolicy, QuotaExceeded, Tenant
from distributedfft_tpu_torch.utils import metrics as tm
from distributedfft_tpu_torch.utils import trace as tr

SHAPE = (8, 8, 8)
CPU = dict(device="cpu")
T128 = torch.complex128


class FakeClock:
    """``perf_counter`` / ``monotonic`` / ``sleep`` on one fake axis; a
    sleep advances it by at least a microsecond, as a real one does."""

    def __init__(self):
        self.t = 0.0
        self.slept = []

    def perf_counter(self):
        return self.t

    monotonic = perf_counter

    def sleep(self, s):
        self.slept.append(s)
        self.t += max(s, 1e-6)


class FakeTimer:
    """A ``threading.Timer`` that never starts: the test fires it."""

    armed: list = []

    def __init__(self, interval, fn, args=()):
        self.interval, self.fn, self.args = interval, fn, args
        self.daemon = True

    def start(self):
        FakeTimer.armed.append(self)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(serving, "time", c)
    FakeTimer.armed = []
    monkeypatch.setattr(serving.threading, "Timer", FakeTimer)
    return c


@pytest.fixture
def metrics_on():
    tm.enable_metrics()
    tm.metrics_reset()
    yield
    tm.metrics_reset()
    tm.enable_metrics(False)


@pytest.fixture(autouse=True)
def fresh():
    tdfft.clear_plan_cache()
    yield
    tdfft.clear_plan_cache()


def _world(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))


def _queue(policy=None, **kw):
    kw.setdefault("max_batch", 64)
    return tdfft.CoalescingQueue(None, policy=policy, dtype=T128, **CPU,
                                 **kw)


def _ref(x):
    return tdfft.plan_dft_c2c_3d(tuple(x.shape), None, dtype=T128,
                                 **CPU)(x)


def _three_class(mod, **kw):
    return mod.QosPolicy([mod.Tenant("rt", "realtime", weight=1.0),
                          mod.Tenant("it", "interactive", weight=1.0),
                          mod.Tenant("bt", "batch", weight=1.0)], **kw)


# ------------------------------------------------------------ spec/units

QOS_SPECS = [
    "acme:class=realtime,weight=3,rate=100,burst=20,slo=0.05;"
    "bulk:class=batch,rate=10",
    "", "  ;  ", "a:weight=2.5", "x:class=interactive,slo=1;y:class=batch",
    "solo:rate=0.5,burst=3",
]


@pytest.mark.parametrize("spec", QOS_SPECS)
def test_parse_qos_equals_jax(spec):
    mine = [vars(t) for t in qos.parse_qos(spec)]
    theirs = [vars(t) for t in jqos.parse_qos(spec)]
    assert mine == theirs


@pytest.mark.parametrize("bad", [
    "noclause", "x:class=warp", "x:weight=-1", "x:rate=0",
    "x:unknown=1", "x:weight", "x:burst=5",
])
def test_parse_qos_rejects_malformed_as_jax(bad):
    with pytest.raises(ValueError):
        QosPolicy(qos.parse_qos(bad))
    with pytest.raises(ValueError):
        jqos.QosPolicy(jqos.parse_qos(bad))


def test_parse_qos_grammar():
    a, b = qos.parse_qos(QOS_SPECS[0])
    assert (a.klass, a.weight, a.rate, a.burst, a.slo_wait_s) == (
        "realtime", 3.0, 100.0, 20.0, 0.05)
    assert (b.klass, b.rate, b.burst, b.bucket_burst) == (
        "batch", 10.0, None, 10.0)


@pytest.mark.parametrize("kw, msg", [
    (dict(name="x", klass="urgent"), "class"),
    (dict(name="x", weight=0), "weight"),
    (dict(name=""), "name"),
    (dict(name="x", rate=True), "rate"),
    (dict(name="x", burst=2.0), "burst"),
])
def test_tenant_validation_as_jax(kw, msg):
    with pytest.raises(ValueError, match=msg):
        Tenant(**kw)
    with pytest.raises(ValueError, match=msg):
        jqos.Tenant(**kw)


def test_policy_resolve_and_unknown_tenant():
    pol = QosPolicy([Tenant("a")])
    assert pol.resolve("a").name == "a"
    assert (pol.resolve(None).name, pol.resolve(None).klass) == (
        "default", "interactive")
    with pytest.raises(ValueError, match="unknown tenant"):
        pol.resolve("ghost")
    with pytest.raises(ValueError, match="unknown tenant"):
        _queue(policy=pol).submit(_world(1), tenant="ghost")


def test_starve_factor_env(monkeypatch):
    monkeypatch.setenv("DFFT_QOS_STARVE_FACTOR", "2.5")
    pol = QosPolicy([])
    assert pol.starvation_factor == 2.5
    assert pol.starvation_s(0.2) == pytest.approx(0.5)
    assert pol.starvation_s(None) == pytest.approx(
        2.5 * qos.DEFAULT_STARVE_WAIT_S)
    assert jqos.QosPolicy([]).starvation_s(0.2) == pol.starvation_s(0.2)


def test_qos_knobs_not_plan_cache_keyed():
    assert "DFFT_QOS" not in api._PLAN_ENV_KNOBS
    assert "DFFT_QOS_STARVE_FACTOR" not in api._PLAN_ENV_KNOBS


# --------------------------------------- the policy against JAX's, fake clock

def _policies(tenants, **kw):
    """The port's and JAX's policy over the same tenants and one fake
    clock each."""
    out = []
    for mod in (qos, jqos):
        c = {"t": 0.0}
        pol = mod.QosPolicy([mod.Tenant(**t) for t in tenants],
                            clock=lambda c=c: c["t"], **kw)
        out.append((pol, c))
    return out


BUCKET_TENANTS = [dict(name="rt", klass="realtime", rate=100.0, burst=3.0),
                  dict(name="bt", klass="batch", rate=40.0, burst=2.0),
                  dict(name="it", klass="interactive", rate=7.0),
                  dict(name="free")]


@pytest.mark.parametrize("seed", range(4))
def test_bucket_arithmetic_equals_jax(seed):
    """A seeded script of admits, charges and clock steps gives the same
    waits and balances in both packages."""
    rng = np.random.default_rng(seed)
    (mine, mc), (theirs, jc) = _policies(BUCKET_TENANTS)
    for _ in range(200):
        t = ["rt", "bt", "it", "free", None][rng.integers(5)]
        op = rng.integers(3)
        if op == 0:
            n = int(rng.integers(1, 4))
            assert mine.admit(t, n) == theirs.admit(t, n)
        elif op == 1:
            n = int(rng.integers(1, 3))
            mine.charge(t, n)
            theirs.charge(t, n)
        else:
            dt = float(rng.exponential(0.02))
            mc["t"] += dt
            jc["t"] += dt
    for name, b in mine._buckets.items():
        jb = theirs._buckets[name]
        assert (b.tokens, b.stamp) == (jb.tokens, jb.stamp)


def _infos(rng, tenants, n):
    return [{"key": f"g{i}", "tenant": tenants[rng.integers(len(tenants))],
             "n": int(rng.integers(1, 9)),
             "age_s": float(rng.exponential(0.5))} for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_order_groups_equals_jax(seed):
    """Strict class, weighted-fair within a class, starvation promotion,
    the persistent virtual times across rounds: the same orders."""
    tenants = [dict(name="rt", klass="realtime", weight=2.0),
               dict(name="r2", klass="realtime", weight=1.0),
               dict(name="it", klass="interactive", weight=3.0),
               dict(name="bt", klass="batch", weight=1.0),
               dict(name="b2", klass="batch", weight=0.5)]
    names = [t["name"] for t in tenants]
    rng = np.random.default_rng(seed)
    (mine, _), (theirs, _) = _policies(tenants, starvation_factor=2.0)
    for _ in range(12):
        infos = _infos(rng, names, int(rng.integers(1, 9)))
        mw = [None, 0.1, 1.0][rng.integers(3)]
        got = [i["key"] for i in mine.order_groups(infos, max_wait_s=mw)]
        want = [i["key"] for i in theirs.order_groups(infos, max_wait_s=mw)]
        assert got == want
        for i in infos[:int(rng.integers(0, len(infos) + 1))]:
            mine.account_drain(i["tenant"], i["n"])
            theirs.account_drain(i["tenant"], i["n"])
    assert mine.slo_report() == theirs.slo_report()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("width", (1, 2, 3, 4))
def test_chunks_and_preemption_equal_jax(seed, width):
    rng = np.random.default_rng(100 + seed)
    names = ["rt", "it", "bt", "default"]
    infos = _infos(rng, names, int(rng.integers(1, 10)))
    (mine, _), (theirs, _) = _policies(
        [dict(name="rt", klass="realtime", rate=50.0),
         dict(name="it", klass="interactive"),
         dict(name="bt", klass="batch")])
    keys = [[i["key"] for i in c] for c in mine.concurrent_chunks(infos,
                                                                  width)]
    assert keys == [[i["key"] for i in c]
                    for c in theirs.concurrent_chunks(infos, width)]
    a, b, ch = mine.preempt_wave(infos, width)
    ja, jb, jch = theirs.preempt_wave(infos, width)
    assert ([i["key"] for i in a], [i["key"] for i in b], ch) == (
        [i["key"] for i in ja], [i["key"] for i in jb], jch)
    assert mine.slo_report() == theirs.slo_report()


def test_order_groups_strict_class_then_promotion():
    pol = _three_class(qos, starvation_factor=4.0)
    infos = [{"key": "b", "tenant": "bt", "n": 1, "age_s": 0.0},
             {"key": "i", "tenant": "it", "n": 1, "age_s": 0.0},
             {"key": "r", "tenant": "rt", "n": 1, "age_s": 0.0}]
    assert [i["key"] for i in pol.order_groups(infos, max_wait_s=1.0)] == [
        "r", "i", "b"]
    infos[0]["age_s"] = 100.0
    assert [i["key"] for i in pol.order_groups(infos, max_wait_s=1.0)] == [
        "b", "r", "i"]


def test_concurrent_chunks_realtime_never_rides_batch():
    pol = _three_class(qos)
    infos = [{"key": k, "tenant": t, "n": 1}
             for k, t in (("r1", "rt"), ("r2", "rt"), ("i1", "it"),
                          ("b1", "bt"), ("b2", "bt"))]
    assert [[i["key"] for i in c] for c in pol.concurrent_chunks(
        infos, 4)] == [["r1", "r2", "i1"], ["b1", "b2"]]
    assert [[i["key"] for i in c] for c in pol.concurrent_chunks(
        infos, 2)] == [["r1", "r2"], ["i1", "b1"], ["b2"]]


def test_slo_ledger_equals_jax():
    out = []
    for mod in (qos, jqos):
        pol = mod.QosPolicy([mod.Tenant("a", slo_wait_s=1.0),
                             mod.Tenant("b")])
        for w in (0.01, 0.02, 0.03, 0.5):
            pol.note_wait("a", w)
        pol.account_drain("a", 4)
        pol.note_submit("b", 2)
        pol.note_shed("b")
        pol.note_miss("b")
        out.append((pol.slo_report(), pol.slo_report(include_waits=2),
                    pol.ledger_json()))
    assert out[0] == out[1]
    rep = out[0][0]["tenants"]["a"]
    assert (rep["transforms"], rep["wait_p50_s"], rep["wait_p99_s"],
            rep["slo_ok"]) == (4, 0.03, 0.5, True)
    assert "slo_ok" not in out[0][0]["tenants"]["b"]


def test_write_ledger(tmp_path):
    import json

    pol = QosPolicy([Tenant("acme", "realtime", weight=3.0, rate=100.0,
                            slo_wait_s=1.0)])
    pol.note_wait("acme", 0.01)
    path = qos.write_ledger(pol, str(tmp_path / "d" / "ledger.json"))
    assert json.load(open(path)) == pol.slo_report()


# ----------------------------------------------------------- queue wiring

def test_queue_policy_validation():
    with pytest.raises(ValueError, match="policy"):
        tdfft.CoalescingQueue(None, policy=42, **CPU)
    with pytest.raises(ValueError, match="concurrent_groups"):
        tdfft.CoalescingQueue(None, concurrent_groups="fast", **CPU)
    q = tdfft.CoalescingQueue(None, **CPU)
    with pytest.raises(ValueError, match="limit"):
        q.flush(limit=0)
    with pytest.raises(ValueError, match="tenant"):
        q.submit(torch.zeros(SHAPE, dtype=torch.complex64), tenant=7)


def test_dfft_qos_env_arms_policy(monkeypatch):
    monkeypatch.setenv("DFFT_QOS", "acme:class=realtime,weight=2")
    q = tdfft.CoalescingQueue(None, **CPU)
    assert q.policy.tenant("acme").klass == "realtime"
    assert tdfft.CoalescingQueue(None, policy="off", **CPU).policy is None
    monkeypatch.setenv("DFFT_QOS", "")
    assert tdfft.CoalescingQueue(None, **CPU).policy is None


def test_no_policy_is_the_anonymous_tier(tmp_path):
    """No policy: 3-tuple keys, no metrics while disabled, results equal
    the plan's, the FIFO state emptied, the span names JAX's."""
    tm.enable_metrics(False)
    tm.metrics_reset()
    tr.init_tracing(str(tmp_path / "pin"))
    try:
        with tr.capture_events() as ev:
            q = _queue()
            xs = [_world(s) for s in (1, 2)]
            hs = [q.submit(v) for v in xs]
            (key,) = set(h._key for h in hs)
            assert len(key) == 3
            assert q.flush() == 2
            outs = [h.result(timeout=10) for h in hs]
    finally:
        tr.finalize_tracing()
    for v, y in zip(xs, outs):
        assert torch.equal(y, _ref(v))
    assert tdfft.metrics_snapshot()["counters"] == {}
    assert q._pending == {} and q._formed == {}
    names = [e[0] for e in ev]
    assert "serve_flush[c2c:b2:manual]" in names
    assert not any("tenant" in n for n in names)


def test_tenant_label_without_policy_is_accounting_only(metrics_on):
    q = _queue()
    h = q.submit(_world(5), tenant="acme")
    assert len(h._key) == 3
    q.flush()
    h.result(timeout=10)
    assert tdfft.metrics_snapshot()["counters"]["serving_tenant_submits"][
        "kind=c2c,tenant=acme"] == 1.0


def test_policy_free_fifo_drain_order_is_formation_order():
    q = _queue()
    q.submit(_world(6))
    q.submit(_world(7, (4, 4, 4)))
    q.submit(_world(8), direction=tdfft.BACKWARD)
    formed = sorted(q._pending, key=lambda k: q._formed[k][0])
    with q._lock:
        items = list(q._pending.items())[::-1]
        q._pending.clear()
        q._pending.update(items)
    assert list(q._pending) != formed
    executed = []
    real = q._execute_group

    def spy(key, group, **kw):
        executed.append(key)
        return real(key, group, **kw)

    q._execute_group = spy
    assert q.flush() == 3
    assert executed == formed


def test_flush_limit_splits_group_and_preserves_remainder():
    q = _queue()
    xs = [_world(s) for s in range(10, 15)]
    hs = [q.submit(v) for v in xs]
    assert q.flush(limit=2) == 2 and q.pending() == 3
    assert q.flush(limit=2) == 2 and q.flush() == 1
    for v, h in zip(xs, hs):
        assert torch.equal(h.result(timeout=10), _ref(v))


def test_quota_shed_raises_quota_exceeded(metrics_on):
    pol = QosPolicy([Tenant("bulk", "batch", rate=1000.0, burst=2.0)],
                    clock=lambda: 0.0)
    q = _queue(policy=pol, admission="raise")
    q.submit(_world(20), tenant="bulk")
    q.submit(_world(21), tenant="bulk")
    with pytest.raises(QuotaExceeded) as ei:
        q.submit(_world(22), tenant="bulk")
    assert ei.value.tenant == "bulk" and ei.value.retry_after_s > 0
    assert tdfft.metrics_snapshot()["counters"]["serving_tenant_quota_shed"][
        "kind=c2c,tenant=bulk"] == 1.0
    rep = pol.slo_report()["tenants"]["bulk"]
    assert rep["quota_shed"] == 1 and rep["submits"] == 3
    q.flush()


def test_quota_park_sleeps_until_refill(clock):
    """``admission="block"``: the submit parks for the bucket's refill
    (on the fake clock: exactly 1/rate) and then admits."""
    pol = QosPolicy([Tenant("bulk", "batch", rate=50.0, burst=1.0)],
                    clock=clock.monotonic)
    q = _queue(policy=pol)
    q.submit(_world(23), tenant="bulk")
    h = q.submit(_world(24), tenant="bulk")
    assert clock.slept == [pytest.approx(0.02)]
    q.flush()
    assert torch.equal(h.result(timeout=10), _ref(_world(24)))


def test_quota_park_honors_deadline(clock):
    pol = QosPolicy([Tenant("bulk", "batch", rate=0.5, burst=1.0)],
                    clock=clock.monotonic)
    q = _queue(policy=pol)
    q.submit(_world(25), tenant="bulk")
    with pytest.raises(tdfft.DeadlineExceeded) as ei:
        q.submit(_world(26), tenant="bulk", deadline_s=0.05)
    assert ei.value.stage == "admission" and clock.slept == []
    assert pol.slo_report()["tenants"]["bulk"]["deadline_misses"] == 1
    q.flush()


def test_realtime_never_sheds_before_batch():
    pol = QosPolicy([Tenant("rt", "realtime", rate=1000.0, burst=2.0),
                     Tenant("bt", "batch", rate=1000.0, burst=2.0)],
                    clock=lambda: 0.0)
    q = _queue(policy=pol, admission="raise")
    for i in range(2):
        q.submit(_world(30 + i), tenant="rt")
        q.submit(_world(40 + i), tenant="bt")
    with pytest.raises(QuotaExceeded):
        q.submit(_world(50), tenant="bt")
    h = q.submit(_world(51), tenant="rt")      # overdraft
    q.submit(_world(52), tenant="rt")
    with pytest.raises(QuotaExceeded):
        q.submit(_world(53), tenant="rt")
    q.flush()
    assert torch.equal(h.result(timeout=10), _ref(_world(51)))


def test_retry_is_charged_to_the_tenant_bucket(monkeypatch):
    from distributedfft_tpu_torch import faults

    pol = QosPolicy([Tenant("acme", "interactive", rate=1000.0,
                            burst=100.0)], clock=lambda: 0.0)
    q = _queue(policy=pol, retry_max=2, retry_backoff_s=0.0)
    h = q.submit(_world(60), tenant="acme")
    monkeypatch.delenv("DFFT_FAULT_INJECT", raising=False)
    faults.reset()
    try:
        with faults.injected("execute", once=True, kind="transient"):
            q.flush()
    finally:
        faults.reset()
    assert torch.equal(h.result(timeout=10), _ref(_world(60)))
    assert pol._buckets["acme"].tokens == pytest.approx(98.0)


def test_degraded_rebuild_is_charged_to_the_tenant_bucket(monkeypatch,
                                                          tmp_path):
    from distributedfft_tpu_torch import faults

    monkeypatch.setenv("DFFT_WISDOM", str(tmp_path / "w.jsonl"))
    pol = QosPolicy([Tenant("acme", rate=1000.0, burst=100.0)],
                    clock=lambda: 0.0)
    q = _queue(policy=pol, retry_max=0)
    hs = [q.submit(_world(s), tenant="acme") for s in (61, 62)]
    faults.reset()
    try:
        with faults.injected("execute", once=True, kind="deterministic"):
            q.flush()
    finally:
        faults.reset()
    assert all(h.degraded for h in hs)
    assert pol._buckets["acme"].tokens == pytest.approx(96.0)


def test_weighted_fair_drain_shares_3_to_1():
    """3:1 weights drain 3:1 over the contention window (within 15%);
    every request equals the plan's output."""
    pol = QosPolicy([Tenant("heavy", "interactive", weight=3.0),
                     Tenant("light", "interactive", weight=1.0)])
    q = _queue(policy=pol)
    n = 48
    xs = {t: [_world(1000 * k + i) for i in range(n)]
          for k, t in enumerate(("heavy", "light"))}
    hs = {t: [q.submit(v, tenant=t) for v in xs[t]] for t in xs}
    drained = []
    while q.pending():
        before = {k: len(g) for k, g in q._pending.items()}
        q.flush(limit=4)
        after = {k: len(g) for k, g in q._pending.items()}
        drained += [(k[3], w - after.get(k, 0)) for k, w in before.items()
                    if w - after.get(k, 0)]
    totals = {"heavy": 0, "light": 0}
    heavy = light = 0
    for t, took in drained:
        totals[t] += took
        if max(totals.values()) >= n:
            break
        heavy, light = totals["heavy"], totals["light"]
    assert light > 0 and abs(heavy / light - 3.0) <= 0.15 * 3.0, drained
    for t in xs:
        for v, h in zip(xs[t], hs[t]):
            assert torch.equal(h.result(timeout=10), _ref(v))


def test_starvation_clock_promotes_batch_under_realtime_flood(clock):
    pol = _three_class(qos, starvation_factor=0.05)
    q = _queue(policy=pol)
    hb = q.submit(_world(70), tenant="bt")
    clock.t += 0.08            # the batch group ages past 0.05 s
    for i in range(6):
        q.submit(_world(71 + i), tenant="rt")
    executed = []
    real = q._execute_group

    def spy(key, group, **kw):
        executed.append(key)
        return real(key, group, **kw)

    q._execute_group = spy
    q.flush(limit=1)
    assert executed == [hb._key]
    q.flush()
    assert torch.equal(hb.result(timeout=10), _ref(_world(70)))


def test_multithreaded_submits_drain_deterministically():
    """Four tenants submit from threads (joins bounded at 10 s); the
    drain after all submits is decided by classes and virtual times
    alone, so the realtime shares hold at 3:1 and every request equals
    the plan's output whatever the threads' interleaving."""
    pol = QosPolicy([Tenant("rt-a", "realtime", weight=3.0),
                     Tenant("rt-b", "realtime", weight=1.0),
                     Tenant("bt-a", "batch", weight=1.0),
                     Tenant("bt-b", "batch", weight=1.0)])
    q = _queue(policy=pol)
    n = 12
    results, errs = {}, []

    def submitter(k, tenant):
        try:
            results[tenant] = [
                (v, q.submit(v, tenant=tenant))
                for v in (_world(100 * k + i) for i in range(n))]
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=submitter, args=(k, t))
               for k, t in enumerate(("rt-a", "rt-b", "bt-a", "bt-b"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert not errs
    drained = []
    while q.pending():
        before = {k: len(g) for k, g in q._pending.items()}
        q.flush(limit=4)
        after = {k: len(g) for k, g in q._pending.items()}
        drained += [(k[3], w - after.get(k, 0)) for k, w in before.items()
                    if w - after.get(k, 0)]
    totals = {"rt-a": 0, "rt-b": 0}
    a = b = 0
    for t, took in drained:
        if t in totals:
            totals[t] += took
            if max(totals.values()) >= n:
                break
            a, b = totals["rt-a"], totals["rt-b"]
    assert b > 0 and abs(a / b - 3.0) <= 0.45 * 3.0, drained
    assert [t for t, _ in drained[:4]] == ["rt-a", "rt-b", "rt-a", "rt-a"]
    assert {t for t, _ in drained[-6:]} == {"bt-a", "bt-b"}
    for tenant, hs in results.items():
        for v, h in hs:
            assert torch.equal(h.result(timeout=10), _ref(v))


def test_concurrent_flush_splits_realtime_from_batch_cohort(metrics_on):
    """On a 4-rank world with ``concurrent_groups=2``, a realtime and a
    batch group flush apart; a realtime and an interactive group merge
    into one interleaved dispatch. Outputs equal the plans'."""
    pol = _three_class(qos)
    q = tdfft.CoalescingQueue(4, dtype=T128, max_batch=64,
                              concurrent_groups=2, policy=pol, **CPU)
    a, b = _world(80, (16, 8, 8)), _world(81, (8, 16, 8))
    ra = tdfft.plan_dft_c2c_3d((16, 8, 8), 4, dtype=T128, **CPU)
    rb = tdfft.plan_dft_c2c_3d((8, 16, 8), 4, dtype=T128, **CPU)
    ha, hb = q.submit(a, tenant="rt"), q.submit(b, tenant="bt")
    q.flush()
    assert tm.counter_total("serving_concurrent_dispatches") == 0
    assert torch.equal(ha.result(timeout=10), ra(a))
    assert torch.equal(hb.result(timeout=10), rb(b))
    h2a, h2b = q.submit(a, tenant="rt"), q.submit(b, tenant="it")
    q.flush()
    assert tm.counter_total("serving_concurrent_dispatches") == 1.0
    assert torch.equal(h2a.result(timeout=10), ra(a))
    assert torch.equal(h2b.result(timeout=10), rb(b))


def test_concurrent_auto_width_prices_with_the_executor(metrics_on,
                                                        monkeypatch):
    """``concurrent_groups="auto"`` on a 4-rank world: a width in 1..4
    from ``model_concurrent_seconds``, which receives each plan's
    executor with its logic, shape and itemsize; memoized."""
    from distributedfft_tpu_torch import plan_logic

    monkeypatch.delenv("DFFT_WIDTH_TOURNAMENT", raising=False)
    seen = []
    real = plan_logic.model_concurrent_seconds

    def spy(transforms, **kw):
        seen.append([t[3] for t in transforms])
        return real(transforms, **kw)

    monkeypatch.setattr(plan_logic, "model_concurrent_seconds", spy)
    q = tdfft.CoalescingQueue(4, dtype=T128, max_batch=64,
                              concurrent_groups="auto",
                              executor="cuda:fuse", wire_dtype="split",
                              **CPU)
    a, b = _world(82, (16, 8, 8)), _world(83, (8, 16, 8))
    ha, hb = q.submit(a), q.submit(b)
    with q._lock:
        groups = list(q._pending.items())
        w = q._concurrent_width(groups)
    assert 1 <= w <= 2 and seen and all(
        ex == ["cuda:fuse"] * len(ex) for ex in seen)
    q.flush()
    for x, h in ((a, ha), (b, hb)):
        ref = tdfft.plan_dft_c2c_3d(tuple(x.shape), 4, dtype=T128,
                                    executor="cuda:fuse", wire_dtype="split",
                                    **CPU)
        assert torch.equal(h.result(timeout=10), ref(x))
    n_calls = len(seen)
    with q._lock:
        assert q._concurrent_width(groups) == w
    assert len(seen) == n_calls


def test_concurrent_auto_falls_back_below_the_stage_graph():
    q = _queue(concurrent_groups="auto")
    ha, hb = q.submit(_world(84)), q.submit(_world(85, (4, 4, 4)))
    with q._lock:
        assert q._concurrent_width(list(q._pending.items())) == 1
    q.flush()
    ha.result(timeout=10)
    hb.result(timeout=10)


def test_env_concurrent_auto(monkeypatch):
    monkeypatch.setenv("DFFT_CONCURRENT_GROUPS", "auto")
    assert tdfft.CoalescingQueue(None, **CPU).concurrent_groups == "auto"
    monkeypatch.setenv("DFFT_CONCURRENT_GROUPS", "3")
    assert tdfft.CoalescingQueue(None, **CPU).concurrent_groups == 3


def test_tenant_metrics_and_span_names(tmp_path, metrics_on):
    pol = QosPolicy([Tenant("acme", "realtime", slo_wait_s=10.0)])
    tr.init_tracing(str(tmp_path / "qos"))
    try:
        with tr.capture_events() as ev:
            q = _queue(policy=pol)
            h = q.submit(_world(90), tenant="acme")
            q.flush()
            h.result(timeout=10)
    finally:
        tr.finalize_tracing()
    names = [e[0] for e in ev]
    assert any(n.startswith("serve_submit[") and n.endswith(
        ":tenant=acme]") for n in names)
    assert "serve_flush[c2c:b1:manual:tenant=acme]" in names
    snap = tdfft.metrics_snapshot()
    lbl = "kind=c2c,tenant=acme"
    assert snap["counters"]["serving_tenant_submits"][lbl] == 1.0
    assert snap["counters"]["serving_tenant_transforms"][lbl] == 1.0
    assert snap["histograms"]["serving_tenant_wait_seconds"][lbl][
        "count"] == 1


def test_deadline_miss_lands_in_tenant_ledger(clock, metrics_on):
    """The request's deadline timer (fired by hand once the fake clock
    passed it) cancels it and charges the tenant's ledger."""
    pol = QosPolicy([Tenant("acme", slo_wait_s=10.0)],
                    clock=clock.monotonic)
    q = _queue(policy=pol)
    doomed = q.submit(_world(91), tenant="acme", deadline_s=0.05)
    (timer,) = FakeTimer.armed
    assert timer.interval == 0.05
    clock.t += 0.06
    timer.fn(*timer.args)
    with pytest.raises(tdfft.DeadlineExceeded) as ei:
        doomed.result(timeout=10)
    assert ei.value.stage == "queued"
    assert ei.value.waited_s == pytest.approx(0.06)
    rep = pol.slo_report()["tenants"]["acme"]
    assert rep["deadline_misses"] == 1 and rep["slo_ok"] is False
    assert tdfft.metrics_snapshot()["counters"][
        "serving_tenant_deadline_misses"]["kind=c2c,tenant=acme"] == 1.0


def test_queue_drain_order_equals_jax_under_a_policy():
    """The same seeded requests and tenants in both packages' queues
    drain in the same order, flush quantum by flush quantum."""
    import jax.numpy as jnp

    spec = "a:class=realtime,weight=2;b:class=interactive,weight=3;" \
           "c:class=interactive;d:class=batch"
    rng = np.random.default_rng(5)
    plan_reqs = [(["a", "b", "c", "d", None][rng.integers(5)],
                  [(8, 8, 8), (4, 8, 8)][rng.integers(2)],
                  [-1, 1][rng.integers(2)]) for _ in range(30)]
    orders = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            pol = QosPolicy.from_spec(spec)
            q = tdfft.CoalescingQueue(None, policy=pol, dtype=T128,
                                      max_batch=64, **CPU)
            wrap = (lambda s, sh: _world(s, sh))
        else:
            pol = jqos.QosPolicy.from_spec(spec)
            q = jdfft.CoalescingQueue(None, policy=pol,
                                      dtype=jnp.complex128, max_batch=64)
            wrap = (lambda s, sh: jnp.asarray(_world(s, sh).numpy()))
        for i, (t, sh, d) in enumerate(plan_reqs):
            q.submit(wrap(i, sh), tenant=t, direction=d)
        drained = []
        while q.pending():
            before = {k: len(g) for k, g in q._pending.items()}
            q.flush(limit=3)
            after = {k: len(g) for k, g in q._pending.items()}
            drained.append(sorted(
                (k[0], k[2], k[3], w - after.get(k, 0))
                for k, w in before.items() if w - after.get(k, 0)))
        orders.append((drained, pol.slo_report()["tenants"]))
    assert orders[0][0] == orders[1][0]
    for name, row in orders[0][1].items():
        jrow = orders[1][1][name]
        assert {k: row[k] for k in ("class", "submits", "transforms",
                                    "quota_shed", "preemptions")} == {
            k: jrow[k] for k in ("class", "submits", "transforms",
                                 "quota_shed", "preemptions")}
