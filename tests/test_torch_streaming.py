"""The port's streaming drain loop (``CoalescingQueue.serve`` / ``stop``,
``_next_wave``, ``_execute_wave``, ``_WaveStats``) and wave preemption
(``QosPolicy.preempt_wave``), held against
``tests/test_a2p_streaming.py`` and the JAX package (its slow occupancy
comparison, a wall-clock measurement, is not ported).

Wave assembly is compared with JAX's directly: the same pending groups
give the same next wave (keys, splits at ``max_batch``, preemption
bumps). The loop itself runs on its own thread: a test asserts only
what holds whatever the waves were (every handle resolved and equal to
the plan's output, the loop stopped, nothing pending), and every join
and wait is bounded at 10 s.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import qos as jqos
from distributedfft_tpu import serving as jserving
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import faults, qos, serving, tuner
from distributedfft_tpu_torch.serving import CoalescingQueue

SHAPE = (8, 8, 8)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for var in ("DFFT_SERVE_STREAMING", "DFFT_QOS", "DFFT_FAULT_INJECT",
                "DFFT_WIDTH_TOURNAMENT", "DFFT_CONCURRENT_GROUPS"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    tdfft.clear_plan_cache()
    yield
    faults.reset()
    tdfft.clear_plan_cache()


def _np(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _x(seed=0, shape=SHAPE):
    return torch.from_numpy(_np(seed, shape))


def _rt_policy(mod=qos):
    pol = mod.QosPolicy()
    pol.register(mod.Tenant("rt", klass="realtime"))
    pol.register(mod.Tenant("bulk", klass="batch"))
    return pol


# ------------------------------------------------- wave preemption

PREEMPT_CASES = [
    ([("b1", "bulk", 3), ("b2", "bulk", 2), ("r1", "rt", 1)], 2,
     ["b1", "r1"], ["b2"], {"rt": 2}),
    ([(f"b{i}", "bulk", 1) for i in range(3)]
     + [(f"r{i}", "rt", 1) for i in range(2)], 2,
     ["r0", "r1"], ["b0", "b1"], {"rt": 2}),
    ([(f"b{i}", "bulk", 1) for i in range(4)], 2, ["b0", "b1"], [], {}),
    ([("b1", "bulk", 1), ("r1", "rt", 1), ("b2", "bulk", 1)], 3,
     ["b1", "r1", "b2"], [], {}),
]


@pytest.mark.parametrize("infos, width, admit, bumped, charges",
                         PREEMPT_CASES)
def test_preempt_wave_equals_jax(infos, width, admit, bumped, charges):
    """A realtime group past a saturated wave's cutoff takes a slot in
    this wave; the bumped groups come back for re-queueing and their
    transforms are charged to the preempting tenant; without one, plain
    truncation."""
    rows = [{"key": k, "tenant": t, "n": n} for k, t, n in infos]
    out = []
    for pol in (_rt_policy(), _rt_policy(jqos)):
        a, b, c = pol.preempt_wave([dict(r) for r in rows], width)
        out.append(([i["key"] for i in a], [i["key"] for i in b], c,
                    pol.slo_report()))
    assert out[0] == out[1]
    assert out[0][:3] == (admit, bumped, charges)
    assert out[0][3]["tenants"]["rt"]["preemptions"] == sum(
        charges.values())


# ------------------------------------- wave assembly against JAX's

@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("with_policy", [False, True])
def test_next_wave_equals_jax(width, with_policy):
    """The same pending groups assemble into the same waves: drain
    order, splits at ``max_batch`` (the remainder keeps its formation
    stamp), realtime preemption and its wave-stats record."""
    reqs = [("bulk", (8, 8, 8), -1)] * 5 + [("bulk", (4, 8, 8), -1)] * 2 \
        + [("rt", (8, 8, 8), 1)] * 2 + [(None, (8, 4, 8), -1)]
    waves = []
    kw = dict(max_batch=3, concurrent_groups=width)
    for q, wrap, mod, srv in (
            (CoalescingQueue(4, **CPU, **kw), torch.from_numpy, qos,
             serving),
            (jdfft.CoalescingQueue(jdfft.make_mesh(4), dtype=jnp.complex64,
                                   **kw), jnp.asarray, jqos, jserving)):
        # no loop runs: _next_wave is called by hand
        q.policy = _rt_policy(mod) if with_policy else None
        q._wave_stats = srv._WaveStats()
        for i, (t, shape, d) in enumerate(reqs):
            q.submit(wrap(_np(i, shape)), direction=d,
                     tenant=t if with_policy else None)
        seq = []
        while True:
            wave = q._next_wave()
            if wave is None:
                break
            groups, w = wave
            seq.append([(k, len(g)) for k, g in groups])
            q._execute_wave(groups, flushed_at=0.0)
        snap = q._wave_stats.snapshot()
        waves.append((seq, snap["preemptions"], snap["bumped_groups"],
                       snap["bumped_transforms"]))
        q._wave_stats.stop()
    assert waves[0] == waves[1]
    assert all(n <= 3 for wave in waves[0][0] for _, n in wave)


def test_execute_wave_outputs_equal_the_plans():
    q = CoalescingQueue(4, max_batch=4, concurrent_groups=2, **CPU)
    xs = {(8, 8, 8): [_x(i) for i in range(3)],
          (4, 8, 8): [_x(10 + i, (4, 8, 8)) for i in range(2)]}
    hs = {s: [q.submit(x) for x in v] for s, v in xs.items()}
    groups, _ = q._next_wave()
    assert len(groups) == 2
    outs = q._execute_wave(groups, flushed_at=0.0)
    assert len(outs) == 5 and q.pending() == 0
    for s, v in xs.items():
        ref = tdfft.plan_dft_c2c_3d(s, 4, **CPU)
        for x, h in zip(v, hs[s]):
            assert torch.equal(h.result(timeout=10), ref(x))


def test_wave_stats_snapshot():
    """Widths, periods, admit waits by class, preemptions; the stamper
    closes each wave (CPU outputs carry no event)."""
    ws = serving._WaveStats("c2c")
    for i, w in enumerate((1, 3, 2)):
        ws.note_wave(width=w, t_dispatch=float(i),
                     outputs=[torch.zeros(2)],
                     waits=[("realtime", 0.1 * (i + 1)), (None, 0.5)])
    ws.note_preemption(2, 5)
    ws.stop()
    ws._thread.join(10)
    assert not ws._thread.is_alive()
    snap = ws.snapshot()
    assert (snap["waves"], snap["preemptions"], snap["bumped_groups"],
            snap["bumped_transforms"]) == (3, 1, 2, 5)
    assert (snap["width_mean"], snap["width_max"]) == (2.0, 3.0)
    assert snap["wave_period_p50_s"] == 1.0
    assert snap["admit_wait"]["realtime"]["n"] == 3
    assert snap["admit_wait"]["realtime"]["max_s"] == pytest.approx(0.3)
    assert snap["admit_wait"]["none"]["n"] == 3
    assert len(ws._durations) == 3


# ------------------------------------- the streaming drain loop

def test_streaming_parity_and_clean_shutdown():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, **CPU)
    xs = [_x(i) for i in range(10)]
    want = [plan(x) for x in xs]
    q = CoalescingQueue(4, max_batch=4, streaming=True, **CPU)
    try:
        assert q._streaming and q._serve_thread is not None
        handles = [q.submit(x) for x in xs]
        q.stop(drain=True, timeout=10)
        for h, w in zip(handles, want):
            assert torch.equal(h.result(timeout=10), w)
        assert q.pending() == 0 and q._serve_thread is None
        q.stop()                       # idempotent
        q.serve()
        assert q._serve_thread is not None
        assert q.serve() is q          # idempotent while running
        h = q.submit(xs[0])
        q.stop(drain=True, timeout=10)
        assert torch.equal(h.result(timeout=10), want[0])
    finally:
        q.close()


def test_streaming_stop_without_drain_leaves_work_queued():
    """``stop(drain=False)`` exits after the wave in flight; what is
    still pending stays queued for flush mode."""
    q = CoalescingQueue(None, max_batch=4, **CPU)
    hs = [q.submit(_x(i)) for i in range(3)]   # queued before the loop
    q._streaming = True                # the loop would own dispatch
    q._serve_stop.set()
    q._drain_on_stop = False
    q._serve_loop(0.01)                # returns at once: no wave taken
    assert q.pending() == 3
    q._streaming = False
    q.flush()
    for h, x in zip(hs, (_x(i) for i in range(3))):
        assert torch.equal(h.result(timeout=10),
                           tdfft.plan_dft_c2c_3d(SHAPE, None, **CPU)(x))


def test_streaming_records_wave_occupancy():
    q = CoalescingQueue(4, max_batch=4, streaming=True, **CPU)
    try:
        hs = [q.submit(_x(i)) for i in range(8)]
        q.stop(drain=True, timeout=10)
        for h in hs:
            h.result(timeout=10)
        snap = q._wave_stats.snapshot()
        assert snap["waves"] >= 2 and snap["width_max"] >= 1
        assert sum(v["n"] for v in snap["admit_wait"].values()) == 8
    finally:
        q.close()


def test_env_knob_arms_streaming(monkeypatch):
    monkeypatch.setenv("DFFT_SERVE_STREAMING", "1")
    q = CoalescingQueue(max_batch=2, **CPU)
    try:
        assert q._streaming and q._serve_thread.is_alive()
        h = q.submit(_x(3))
        q.stop(drain=True, timeout=10)
        h.result(timeout=10)
    finally:
        q.close()
    monkeypatch.setenv("DFFT_SERVE_STREAMING", "0")
    q2 = CoalescingQueue(max_batch=2, **CPU)
    assert not q2._streaming and q2._serve_thread is None


def test_streaming_realtime_admitted_under_saturation():
    pol = _rt_policy()
    q = CoalescingQueue(4, max_batch=2, policy=pol, streaming=True, **CPU)
    try:
        hs = [q.submit(_x(i), tenant="bulk") for i in range(8)]
        hs += [q.submit(_x(100 + i), tenant="rt") for i in range(3)]
        q.stop(drain=True, timeout=10)
        for h in hs:
            h.result(timeout=10)
        led = pol.slo_report()["tenants"]
        assert (led["rt"]["transforms"], led["bulk"]["transforms"]) == (
            3, 8)
    finally:
        q.close()


def test_fault_mid_wave_does_not_wedge_the_loop(monkeypatch):
    """A deterministic fault on every other execution (no retry chain):
    each handle resolves or carries the error, the loop exits, and
    disarmed the queue serves again."""
    q = CoalescingQueue(4, max_batch=2, streaming=True, **CPU)
    try:
        monkeypatch.setenv("DFFT_FAULT_INJECT",
                           "execute:every=2,kind=deterministic")
        faults.reset()
        hs = [q.submit(_x(i)) for i in range(8)]
        q.stop(drain=True, timeout=10)
        outcomes = []
        for h in hs:
            try:
                h.result(timeout=10)
                outcomes.append("ok")
            except tdfft.InjectedFault:
                outcomes.append("err")
        assert len(outcomes) == 8 and "err" in outcomes
        assert q._serve_thread is None and q.pending() == 0
        monkeypatch.delenv("DFFT_FAULT_INJECT")
        faults.reset()
        q.serve()
        h = q.submit(_x(42))
        q.stop(drain=True, timeout=10)
        assert h.result(timeout=10).shape == SHAPE
    finally:
        q.close()


# ---------------------------------------- the width tournament

def test_width_budget_grammar(monkeypatch):
    assert tuner.width_budget() is None
    for off in ("0", "off", ""):
        monkeypatch.setenv("DFFT_WIDTH_TOURNAMENT", off)
        assert tuner.width_budget() is None
    monkeypatch.setenv("DFFT_WIDTH_TOURNAMENT", "3")
    assert tuner.width_budget() == (3, 2)
    monkeypatch.setenv("DFFT_WIDTH_TOURNAMENT", "4x5")
    assert tuner.width_budget() == (4, 5)
    monkeypatch.setenv("DFFT_WIDTH_TOURNAMENT", "junk")
    with pytest.raises(ValueError):
        tuner.width_budget()


def test_queue_auto_width_uses_the_tournament(monkeypatch, tmp_path):
    """Armed, ``concurrent_groups="auto"`` runs the measured width
    tournament for the live plan tuple and keeps its winner in the
    wisdom store; the flush's outputs equal the plans'."""
    path = tmp_path / "wisdom.jsonl"
    monkeypatch.setenv("DFFT_WISDOM", str(path))
    monkeypatch.setenv("DFFT_WIDTH_TOURNAMENT", "1x1")
    q = CoalescingQueue(4, max_batch=4, concurrent_groups="auto", **CPU)
    xs = [_x(i) for i in range(2)] + [_x(9 + i, (16, 8, 4))
                                      for i in range(2)]
    hs = [q.submit(x) for x in xs]
    q.flush()
    for x, h in zip(xs, hs):
        ref = tdfft.plan_dft_c2c_3d(tuple(x.shape), 4, **CPU)
        assert torch.equal(h.result(timeout=10), ref(x))
    import json

    entries = [json.loads(ln) for ln in open(path)]
    assert any(e["key"]["kind"] == "concurrent" for e in entries)
    q.close()
