"""The port's fault injection (``faults.py``), the fault points of its
``api.py`` and ``Plan3D.compile``, and the serving queue's recovery
chain, held against ``tests/test_a2i_faults.py``'s cases and the JAX
package.

The same spec fires on the same check numbers in both packages (``p=``
with a seed included: both draw from ``random.Random(seed)``), and
``classify`` sorts an injected fault as JAX's does (the port also sorts
the allocator's out-of-memory error as transient and a CUDA launch or
illegal-address error as deterministic). Under the same spec a port
queue and a JAX queue fed the same seeded requests give the same
outcome per handle (resolved, degraded, or failed with which error),
the same ``serving_*`` and ``fault_injected`` counters, and outputs
within the complex128 tier (1e-11). No test waits on a clock or a
thread: flushes are explicit.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import faults as jfaults
from distributedfft_tpu.utils import metrics as jm
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import faults
from distributedfft_tpu_torch.utils import metrics as tm

SHAPE = (8, 8, 8)
CPU = dict(device="cpu")
T128 = torch.complex128
J128 = jnp.complex128
TOL128 = 1e-11


@pytest.fixture
def chaos(monkeypatch):
    """The port's chaos fixture: ``arm(spec)`` sets ``DFFT_FAULT_INJECT``
    with fresh counters in both packages (both read the variable);
    teardown disarms both, even on failure."""
    monkeypatch.delenv("DFFT_FAULT_INJECT", raising=False)
    faults.reset()
    jfaults.reset()

    def arm(spec: str) -> None:
        monkeypatch.setenv("DFFT_FAULT_INJECT", spec)
        faults.reset()
        jfaults.reset()

    try:
        yield arm
    finally:
        monkeypatch.delenv("DFFT_FAULT_INJECT", raising=False)
        faults.reset()
        jfaults.reset()


@pytest.fixture
def metrics_on():
    for reg in (tm, jm):
        reg.enable_metrics()
        reg.metrics_reset()
    try:
        yield
    finally:
        for reg in (tm, jm):
            reg.metrics_reset()
            reg.enable_metrics(False)


@pytest.fixture(autouse=True)
def fresh(tmp_path, monkeypatch):
    """Fresh plans and a wisdom store of the test's own (the degraded
    rebuild appends its annotation there)."""
    monkeypatch.setenv("DFFT_WISDOM", str(tmp_path / "wisdom.jsonl"))
    tdfft.clear_plan_cache()
    jdfft.clear_plan_cache()
    yield
    tdfft.clear_plan_cache()
    jdfft.clear_plan_cache()


def _world(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)


def _counter(snap, name: str, **labels) -> float:
    rows = snap["counters"].get(name, {})
    want = [f"{k}={v}" for k, v in labels.items()]
    return sum(v for lbl, v in rows.items()
               if all(w in lbl.split(",") for w in want))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ------------------------------------------------------------- spec grammar

SPECS = (
    "execute:every=3; plan:once; exchange:seed=7,p=0.25;"
    "compile:at=1+3,kind=deterministic,times=2,match=cuda",
    "execute:p=0.5,seed=11,times=5",
    "plan:every=2,kind=deterministic,match=mat",
)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_parses_as_jax(spec):
    mine = faults.parse_spec(spec)
    theirs = jfaults.parse_spec(spec)
    fields = ("point", "kind", "mode", "n", "at", "p", "times", "match")
    assert [[getattr(p, f) for f in fields] for p in mine] == [
        [getattr(p, f) for f in fields] for p in theirs]


def test_spec_grammar_parses_every_directive():
    pts = faults.parse_spec(SPECS[0])
    assert [p.point for p in pts] == ["execute", "plan", "exchange",
                                      "compile"]
    assert pts[0].mode == "every" and pts[0].n == 3
    assert pts[1].mode == "once" and pts[1].times == 1
    assert pts[2].mode == "p" and pts[2].p == 0.25
    assert pts[3].at == frozenset({1, 3})
    assert pts[3].kind == "deterministic" and pts[3].match == "cuda"


@pytest.mark.parametrize("bad, msg", [
    ("warp:once", "unknown fault point"),
    ("execute", "lacks a ':'"),
    ("execute:once,every=2", "exactly one of"),
    ("execute:kind=transient", "exactly one of"),
    ("execute:frobnicate=1", "unknown directive"),
    ("execute:once,kind=sometimes", "transient|deterministic"),
    ("execute:every=0", "must be >= 1"),
    ("execute:p=1.5", "must be in"),
])
def test_spec_grammar_rejects_garbage_as_jax(bad, msg):
    with pytest.raises(ValueError, match=msg):
        faults.parse_spec(bad)
    with pytest.raises(ValueError, match=msg):
        jfaults.parse_spec(bad)


@pytest.mark.parametrize("spec", [
    "execute:seed=7,p=0.5", "execute:seed=0,p=0.25", "execute:p=0.9,seed=3",
    "execute:every=3", "execute:at=2+5+6", "execute:once",
    "execute:every=1,times=4", "execute:seed=5,p=0.5,match=cuda",
])
def test_same_spec_fires_on_the_same_checks(spec):
    """Count-based and seeded modes give the same fire sequence in both
    packages (labels alternate so ``match=`` skips half the checks)."""
    mine = faults.parse_spec(spec)[0]
    theirs = jfaults.parse_spec(spec)[0]
    labels = ["cuda" if i % 2 else "other" for i in range(64)]
    fires = [mine.should_fire(lb) for lb in labels]
    assert fires == [theirs.should_fire(lb) for lb in labels]
    assert any(fires)


def test_seeded_probability_is_reproducible():
    a = faults.parse_spec("execute:seed=7,p=0.5")[0]
    b = faults.parse_spec("execute:seed=7,p=0.5")[0]
    fires = [a.should_fire("") for _ in range(64)]
    assert fires == [b.should_fire("") for _ in range(64)]
    assert any(fires) and not all(fires)


def test_env_spec_fires_on_the_same_checks_in_both(chaos):
    """Through ``check`` and the env variable: both packages raise on the
    same check numbers, and a changed value starts a fresh sequence."""
    for spec in ("execute:at=2+4", "execute:seed=9,p=0.4"):
        chaos(spec)
        got = []
        for _ in range(12):
            row = []
            for mod in (faults, jfaults):
                try:
                    mod.check("execute", "cuda")
                    row.append(False)
                except RuntimeError as e:
                    row.append(type(e).__name__)
            got.append(row)
        assert all(a == b for a, b in got)
        assert any(a for a, _ in got)


def test_every_n_fires_on_schedule(chaos):
    chaos("execute:every=3,kind=deterministic")
    fired = []
    for _ in range(6):
        try:
            faults.check("execute")
            fired.append(False)
        except tdfft.InjectedFault:
            fired.append(True)
    assert fired == [False, False, True, False, False, True]


def test_programmatic_injected_scopes_and_clears(chaos):
    with faults.injected("execute", every=1, kind="deterministic"):
        with pytest.raises(tdfft.InjectedFault) as ei:
            faults.check("execute")
        assert not ei.value.transient and ei.value.point == "execute"
    faults.check("execute")  # disarmed on exit
    faults.inject("plan", once=True)
    faults.clear()
    faults.check("plan")     # clear() disarmed it


def test_fire_counts_metric_and_marks_the_timeline(chaos, metrics_on,
                                                  tmp_path):
    from distributedfft_tpu_torch.utils import trace

    chaos("execute:once,kind=deterministic")
    trace.init_tracing(str(tmp_path / "trace"))
    try:
        with trace.capture_events() as ev, pytest.raises(
                tdfft.InjectedFault):
            faults.check("execute")
    finally:
        trace.finalize_tracing()
    assert [e[0] for e in ev] == ["fault_injected[execute:deterministic]"]
    assert _counter(tdfft.metrics_snapshot(), "fault_injected",
                    point="execute", kind="deterministic") == 1


# ----------------------------------------------------------- classify

@pytest.mark.parametrize("make", [
    lambda m: m.InjectedFault("execute", "transient", 1),
    lambda m: m.InjectedFault("plan", "deterministic", 1),
    lambda m: TimeoutError(),
    lambda m: ConnectionError("reset"),
    lambda m: RuntimeError("RESOURCE_EXHAUSTED: oom"),
    lambda m: RuntimeError("UNAVAILABLE: peer"),
    lambda m: ValueError("bad shape"),
    lambda m: RuntimeError("compile failed"),
])
def test_classify_sorts_as_jax(make):
    assert faults.classify(make(faults)) == jfaults.classify(make(jfaults))


def test_classify_cuda_errors():
    """The allocator's out-of-memory error may pass (transient); a CUDA
    launch or illegal-address error poisons the context and is never
    retried (deterministic), whatever status word its message holds."""
    assert faults.classify(torch.cuda.OutOfMemoryError("oom")) == \
        "transient"
    for msg in ("CUDA error: an illegal memory access was encountered",
                "fft_rows: CUDA error 700 at launch",
                "CUDA error: unspecified launch failure",
                "device-side assert triggered",
                "CUDA error: RESOURCE_EXHAUSTED while launching"):
        assert faults.classify(RuntimeError(msg)) == "deterministic"
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        try:
            err = accel("illegal address")
        except TypeError:
            err = None
        if err is not None:
            assert faults.classify(err) == "deterministic"


# ----------------------------------------------- api fault points, compile

def test_plan_point_fires_on_a_cache_miss_only(chaos):
    """The label is the executor the caller passed (as in JAX)."""
    chaos("plan:every=1,match=cuda")
    tdfft.plan_dft_c2c_3d(SHAPE, None, executor="torch", **CPU)
    with pytest.raises(tdfft.InjectedFault):
        tdfft.plan_dft_c2c_3d(SHAPE, None, executor="cuda", **CPU)
    chaos("")
    p = tdfft.plan_dft_c2c_3d(SHAPE, None, **CPU)
    chaos("plan:every=1")
    assert tdfft.plan_dft_c2c_3d(SHAPE, None, **CPU) is p  # a hit
    with pytest.raises(tdfft.InjectedFault):
        tdfft.plan_dft_c2c_3d(SHAPE, None, executor="matmul", **CPU)


def test_compile_point_fires_on_first_execution_only(chaos):
    p = tdfft.plan_dft_c2c_3d(SHAPE, 4, dtype=T128, **CPU)
    x = torch.from_numpy(_world(1))
    chaos("compile:every=1")
    with pytest.raises(tdfft.InjectedFault):
        p(x)
    chaos("")
    y = p(x)
    chaos("compile:every=1")
    assert torch.equal(p(x), y)   # warm: the point is not checked again


def test_exchange_point_only_for_plans_with_a_world(chaos):
    single = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, **CPU)
    slab = tdfft.plan_dft_c2c_3d(SHAPE, 4, dtype=T128,
                                 algorithm="ppermute", **CPU)
    x = torch.from_numpy(_world(2))
    chaos("exchange:every=1,match=ppermute")
    single(x)
    with pytest.raises(tdfft.InjectedFault) as ei:
        slab(x)
    assert ei.value.point == "exchange"


def test_plan_compile_warms_and_records(chaos, metrics_on):
    """``Plan3D.compile``: the compile point, one throwaway execution on
    zeros, ``_warm`` set, ``compile_seconds`` observed; no ``executes``
    count (the throwaway run is not a user execution)."""
    p = tdfft.plan_dft_c2c_3d(SHAPE, 4, dtype=T128, **CPU)
    chaos("compile:once")
    with pytest.raises(tdfft.InjectedFault):
        p.compile()
    assert not getattr(p, "_warm", False)
    assert p.compile() is p and p._warm
    snap = tdfft.metrics_snapshot()
    h = snap["histograms"]["compile_seconds"]
    assert sum(v["count"] for v in h.values()) == 1
    assert "executes" not in snap["counters"]
    x = torch.from_numpy(_world(3))
    ref = tdfft.plan_dft_c2c_3d(SHAPE, 4, dtype=T128, executor="torch",
                                **CPU)(x)
    chaos("compile:every=1")
    assert _rel(p(x), ref) < TOL128   # compiled: no compile check left


def test_disarmed_points_change_nothing():
    p = tdfft.plan_dft_c2c_3d(SHAPE, 4, dtype=T128, **CPU)
    x = torch.from_numpy(_world(4))
    want = jdfft.plan_dft_c2c_3d(SHAPE, jdfft.make_mesh(4), dtype=J128)(
        jnp.asarray(x.numpy()))
    assert _rel(p(x), want) < TOL128


# ---------------------------------------------- the queue's recovery chain

def _outcomes(q, handles, conv):
    out = []
    for h in handles:
        try:
            out.append(("ok", h.degraded, conv(h.result(timeout=10))))
        except Exception as e:  # noqa: BLE001 -- the outcome under test
            out.append((type(e).__name__, h.degraded, None))
    return out


def _parity(chaos, spec, seeds, *, world=None, arm_before=-1, **kw):
    """Feed both packages' queues the same seeded requests under the same
    spec (armed before submit number ``arm_before``; -1: before the
    flush) and compare outcomes and counters. Returns the port's
    outcomes and metrics snapshot."""
    jworld = None if world is None else jdfft.make_mesh(world)
    got = {}
    for pkg, q, conv, wrap in (
            ("port", tdfft.CoalescingQueue(world, dtype=T128, **CPU, **kw),
             lambda y: y.numpy(), torch.from_numpy),
            ("jax", jdfft.CoalescingQueue(jworld, dtype=J128, **kw),
             np.asarray, jnp.asarray)):
        tm.metrics_reset()
        jm.metrics_reset()
        chaos("")
        hs = []
        for i, s in enumerate(seeds):
            if i == arm_before:
                chaos(spec)
            hs.append(q.submit(wrap(_world(s))))
        if arm_before < 0:
            chaos(spec)
        try:
            q.flush()
            raised = None
        except Exception as e:  # noqa: BLE001
            raised = type(e).__name__
        snap = (tm if pkg == "port" else jm).metrics_snapshot()
        got[pkg] = (raised, _outcomes(q, hs, conv), snap)
    chaos("")
    (r_t, o_t, s_t), (r_j, o_j, s_j) = got["port"], got["jax"]
    assert r_t == r_j
    assert [o[:2] for o in o_t] == [o[:2] for o in o_j]
    for a, b in zip(o_t, o_j):
        if a[2] is not None:
            assert _rel(a[2], b[2]) < TOL128
    for name in ("serving_retries", "serving_degraded",
                 "serving_isolated_failures", "fault_injected",
                 "serving_flushes", "serving_transforms"):
        assert _counter(s_t, name) == _counter(s_j, name), name
    return o_t, s_t


CHAIN_CASES = [
    # (spec, seeds, queue knobs, arm before submit #)
    ("execute:once", (1, 2), dict(max_batch=4, retry_max=2), -1),
    ("plan:once", (1, 2), dict(max_batch=4, retry_max=2), -1),
    ("compile:once", (1, 2), dict(max_batch=4, retry_max=2), -1),
    ("execute:once,kind=deterministic", (3, 4),
     dict(max_batch=4, retry_max=1), -1),
    ("plan:once,kind=deterministic", (3, 4),
     dict(max_batch=4, retry_max=1), -1),
    ("execute:at=1+3,kind=deterministic", (6, 7, 8),
     dict(max_batch=3, retry_max=0, fallback_executor="0"), 2),
    ("execute:at=1+2+4,kind=deterministic", (9, 10),
     dict(max_batch=2, retry_max=0), 1),
    ("execute:every=1", (1, 2), dict(max_batch=4, retry_max=2), -1),
    ("execute:every=1,kind=deterministic", (1, 2),
     dict(max_batch=4, retry_max=0, fallback_executor="none"), -1),
]


@pytest.mark.parametrize("spec, seeds, kw, arm", CHAIN_CASES)
def test_recovery_chain_outcomes_equal_jax(chaos, metrics_on, spec, seeds,
                                           kw, arm):
    """Retry, degraded rebuild, bisection: the same spec gives each
    handle the same fate in both packages (the executors' labels differ,
    so no spec here matches on one)."""
    _parity(chaos, spec, seeds, arm_before=arm, **kw)


def test_no_knobs_legacy_dispatch_equals_jax(chaos, metrics_on,
                                             monkeypatch):
    """Without the retry knobs a failed flush fails every co-batched
    handle and raises, in both packages."""
    for var in ("DFFT_RETRY_MAX", "DFFT_RETRY_BACKOFF_S",
                "DFFT_FALLBACK_EXECUTOR"):
        monkeypatch.delenv(var, raising=False)
    out, _ = _parity(chaos, "execute:every=1", (12, 13), max_batch=8)
    assert [o[0] for o in out] == ["InjectedFault"] * 2


@pytest.mark.parametrize("kind", ["transient", "deterministic"])
def test_exchange_fault_on_a_world_equals_jax(chaos, metrics_on, kind):
    """exchange x {transient, deterministic} on a 4-rank world: retried
    on the same chain, or degraded onto the matmul chain; the port's
    handle is bit-equal to its own plan of the chain that produced it."""
    out, snap = _parity(chaos, f"exchange:once,kind={kind}", (5,), world=4,
                        max_batch=4, retry_max=2, retry_backoff_s=0.0)
    ex = "matmul" if kind == "deterministic" else "cuda"
    ref = tdfft.plan_dft_c2c_3d(SHAPE, 4, dtype=T128, executor=ex, **CPU)
    assert np.array_equal(out[0][2],
                          ref(torch.from_numpy(_world(5))).numpy())
    assert out[0][1] == (kind == "deterministic")
    assert _counter(snap, "fault_injected", point="exchange",
                    kind=kind) == 1


@pytest.mark.parametrize("point", ("plan", "compile", "execute"))
def test_transient_fault_is_retried_to_success(chaos, metrics_on, point):
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=4, retry_max=2,
                              retry_backoff_s=0.0, **CPU)
    xs = [_world(1), _world(2)]
    hs = [q.submit(torch.from_numpy(v)) for v in xs]
    chaos(f"{point}:once")
    assert q.flush() == 2
    chaos("")
    ref = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, batch=2, **CPU)(
        torch.from_numpy(np.stack(xs)))
    for i, h in enumerate(hs):
        assert torch.equal(h.result(timeout=10), ref[i])
        assert not h.degraded
    snap = tdfft.metrics_snapshot()
    assert _counter(snap, "fault_injected", point=point,
                    kind="transient") == 1
    assert _counter(snap, "serving_retries") == 1
    assert _counter(snap, "serving_isolated_failures") == 0


@pytest.mark.parametrize("point", ("plan", "compile", "execute"))
def test_deterministic_fault_degrades_to_matmul(chaos, metrics_on, point,
                                                tmp_path):
    """No retry: the group rebuilds on the matmul fallback, bit-equal to
    a matmul plan built directly, and the fallback lands in the wisdom
    store under a degraded annotation that warm_pool never replays."""
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=4, retry_max=1,
                              retry_backoff_s=0.0, **CPU)
    xs = [_world(3), _world(4)]
    hs = [q.submit(torch.from_numpy(v)) for v in xs]
    chaos(f"{point}:once,kind=deterministic")
    assert q.flush() == 2
    chaos("")
    mm = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, executor="matmul",
                               batch=2, **CPU)
    want = mm(torch.from_numpy(np.stack(xs)))
    for i, h in enumerate(hs):
        assert torch.equal(h.result(timeout=10), want[i])
        assert h.degraded
    snap = tdfft.metrics_snapshot()
    assert _counter(snap, "serving_retries") == 0
    assert _counter(snap, "serving_degraded", executor="matmul") == 2
    entries = [json.loads(ln) for ln in open(tmp_path / "wisdom.jsonl")]
    assert entries and all(
        e["key"]["annotation"] == "degraded"
        and e["winner"]["executor"] == "matmul" for e in entries)
    assert tdfft.warm_pool(None, top_n=8,
                           path=str(tmp_path / "wisdom.jsonl"),
                           **CPU) == []


def test_batched_flush_isolates_one_poisoned_request(chaos, metrics_on):
    """Execute check 1 is the batch, 2-4 the bisected singletons:
    ``at=1+3`` poisons the batch and the middle request alone."""
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=3, retry_max=0,
                              fallback_executor="0", **CPU)
    xs = [_world(s) for s in (6, 7, 8)]
    hs = []
    for i, v in enumerate(xs):
        if i == 2:
            chaos("execute:at=1+3,kind=deterministic")
        hs.append(q.submit(torch.from_numpy(v)))   # the 3rd auto-flushes
    assert q.pending() == 0
    chaos("")
    ref = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, **CPU)
    with pytest.raises(tdfft.InjectedFault):
        hs[1].result(timeout=10)
    for i in (0, 2):
        assert torch.equal(hs[i].result(timeout=10),
                           ref(torch.from_numpy(xs[i])))
        assert not hs[i].degraded
    assert _counter(tdfft.metrics_snapshot(),
                    "serving_isolated_failures") == 1


def test_bisected_request_recovers_via_degraded_fallback(chaos,
                                                         metrics_on):
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=2, retry_max=0,
                              **CPU)
    xs = [_world(9), _world(10)]
    hs = [q.submit(torch.from_numpy(xs[0]))]
    chaos("execute:at=1+2+4,kind=deterministic")
    hs.append(q.submit(torch.from_numpy(xs[1])))
    chaos("")
    ref = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, **CPU)
    mm = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, executor="matmul",
                               **CPU)
    assert not hs[0].degraded and hs[1].degraded
    assert torch.equal(hs[0].result(timeout=10),
                       ref(torch.from_numpy(xs[0])))
    assert torch.equal(hs[1].result(timeout=10),
                       mm(torch.from_numpy(xs[1])))
    snap = tdfft.metrics_snapshot()
    assert _counter(snap, "serving_degraded", executor="matmul") == 1
    assert _counter(snap, "serving_isolated_failures") == 0


def test_degraded_parity_with_direct_matmul(chaos):
    """A request forced onto the fallback by ``match=cuda`` equals a
    directly built matmul plan bit for bit, and numpy's fftn within the
    complex128 tier."""
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=8, retry_max=0,
                              **CPU)
    x = _world(11)
    h = q.submit(torch.from_numpy(x))
    chaos("execute:every=1,kind=deterministic,match=cuda")
    q.flush()
    chaos("")
    got = h.result(timeout=10)
    assert h.degraded
    mm = tdfft.plan_dft_c2c_3d(SHAPE, None, dtype=T128, executor="matmul",
                               **CPU)
    assert torch.equal(got, mm(torch.from_numpy(x)))
    assert _rel(got.numpy(), np.fft.fftn(x)) < TOL128


KERNEL_FAULTS = ("nvcc failed:\nnvcc -c fuse.cu -> 1",
                 "nvcc not found (PATH, $CUDA_HOME/bin)",
                 "fft_rows: CUDA error 700 at launch",
                 "CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("msg", KERNEL_FAULTS)
def test_kernel_fault_is_recognised(msg):
    assert faults.kernel_fault(RuntimeError(msg))
    assert faults.classify(RuntimeError(msg)) == "deterministic"


@pytest.mark.parametrize("err", [
    faults.InjectedFault("execute", "deterministic", 1),
    RuntimeError("compile failed"), ValueError("bad shape"),
    torch.cuda.OutOfMemoryError("CUDA out of memory")])
def test_other_errors_are_not_kernel_faults(err):
    assert not faults.kernel_fault(err)


def _failing_runs(q, monkeypatch, errors):
    """Replace ``q._run_group`` by one that records each run's (batch,
    executor) and raises the next of ``errors`` (the real run once
    they are spent)."""
    runs, real, errs = [], q._run_group, list(errors)

    def run(key, group, tag, tracing, *, executor=None):
        runs.append((len(group), executor))
        if errs:
            raise errs.pop(0)
        return real(key, group, tag, tracing, executor=executor)

    monkeypatch.setattr(q, "_run_group", run)
    return runs


@pytest.mark.parametrize("msg", KERNEL_FAULTS)
def test_kernel_fault_fails_the_group_without_fallback(metrics_on,
                                                       monkeypatch, msg):
    """A kernel that fails to build or launch is not served on the
    matmul fallback, and a CUDA fault is not run again on its poisoned
    context: the group runs once, every handle fails with the error,
    and nothing is retried, degraded or bisected."""
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=4, retry_max=2,
                              retry_backoff_s=0.0, **CPU)
    hs = [q.submit(torch.from_numpy(_world(s))) for s in (20, 21, 22)]
    runs = _failing_runs(q, monkeypatch, [RuntimeError(msg)])
    assert q.flush() == 3
    assert runs == [(3, None)]
    for h in hs:
        with pytest.raises(RuntimeError, match="nvcc|CUDA error"):
            h.result(timeout=10)
        assert not h.degraded
    snap = tdfft.metrics_snapshot()
    for name in ("serving_retries", "serving_degraded",
                 "serving_isolated_failures"):
        assert _counter(snap, name) == 0


def test_kernel_fault_in_bisection_fails_the_rest(metrics_on, monkeypatch):
    """A deterministic fault that the degraded rebuild cannot recover
    starts the bisection; a kernel fault in its first singleton ends it:
    that request and the ones after it fail with the kernel fault, and
    none runs again."""
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=4, retry_max=2,
                              retry_backoff_s=0.0, **CPU)
    hs = [q.submit(torch.from_numpy(_world(s))) for s in (23, 24, 25)]
    cuda = RuntimeError("fft_rows: CUDA error 700 at launch")
    runs = _failing_runs(q, monkeypatch, [
        faults.InjectedFault("execute", "deterministic", 1),
        ValueError("matmul rebuild failed"), cuda])
    assert q.flush() == 3
    assert runs == [(3, None), (3, "matmul"), (1, None)]
    for h in hs:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            h.result(timeout=10)
    snap = tdfft.metrics_snapshot()
    for name in ("serving_retries", "serving_degraded",
                 "serving_isolated_failures"):
        assert _counter(snap, name) == 0


def test_no_knobs_means_no_fault_tolerance_state(monkeypatch):
    for var in ("DFFT_FAULT_INJECT", "DFFT_RETRY_MAX",
                "DFFT_RETRY_BACKOFF_S", "DFFT_FALLBACK_EXECUTOR"):
        monkeypatch.delenv(var, raising=False)
    q = tdfft.CoalescingQueue(None, dtype=T128, max_batch=8, **CPU)
    assert q._retry_max is None
    hs = [q.submit(torch.from_numpy(_world(s))) for s in (12, 13)]
    with faults.injected("execute", every=1, kind="transient"):
        with pytest.raises(tdfft.InjectedFault):
            q.flush()   # the flush itself raises
    for h in hs:
        with pytest.raises(tdfft.InjectedFault):
            h.result(timeout=10)


def test_retry_knobs_resolve_from_env(monkeypatch):
    monkeypatch.setenv("DFFT_RETRY_MAX", "3")
    monkeypatch.setenv("DFFT_RETRY_BACKOFF_S", "0.25")
    monkeypatch.setenv("DFFT_FALLBACK_EXECUTOR", "none")
    q = tdfft.CoalescingQueue(None, dtype=T128, **CPU)
    assert (q._retry_max, q._retry_backoff, q._fallback_executor) == (
        3, 0.25, "")
    monkeypatch.setenv("DFFT_RETRY_MAX", "nope")
    with pytest.raises(ValueError, match="DFFT_RETRY_MAX"):
        tdfft.CoalescingQueue(None, dtype=T128, **CPU)
    monkeypatch.delenv("DFFT_RETRY_MAX")
    with pytest.raises(ValueError, match="retry_max"):
        tdfft.CoalescingQueue(None, dtype=T128, retry_max=-1, **CPU)
