"""The port's numerics plane (``numerics.py``) and its serving hooks, held
against ``tests/test_a2r_numerics.py``'s cases and the JAX package.

The pure parts equal JAX's on the same inputs: ``parse_shadow_rate``,
the seeded sampler's picks, the ``Reservoir`` (values, tail,
quantiles), ``judge_bucket`` and the ledger's snapshot. The array
helpers run on torch tensors: ``realized_error`` (two norms in
complex128 on the tensors' device) equals JAX's host computation within
1e-12 relative, ``drift_floor`` takes a torch dtype and equals JAX's,
``nonfinite_kind`` agrees on clean, NaN, Inf and integer data. On a
queue the audit observes without changing a bit, an int8 cohort with
one hot request drifts as JAX's does, shadow work is charged to the
tenant, and the non-finite guard quarantines a poisoned request (also
through the concurrent path) while a caller's NaN is delivered. The
monitor, fleet and report surfaces go with the monitor's port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributedfft_tpu as jdfft
from distributedfft_tpu import numerics as jnum
from distributedfft_tpu.parallel import exchange as jex
import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import numerics
from distributedfft_tpu_torch.parallel import exchange as tex

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _clean_ledger(monkeypatch):
    """Every test starts dark in both packages; the process-lifetime
    armed flags are restored afterwards."""
    monkeypatch.delenv("DFFT_SHADOW_RATE", raising=False)
    monkeypatch.delenv("DFFT_WIRE_DTYPE", raising=False)
    armed = (numerics._ARMED, jnum._ARMED)
    for mod in (numerics, jnum):
        mod.reset_numerics()
    tdfft.clear_plan_cache()
    yield
    for mod in (numerics, jnum):
        mod.reset_numerics()
    numerics._ARMED, jnum._ARMED = armed
    tdfft.clear_plan_cache()


def _mk(rng, shape=(8, 8, 8)):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- parsing


@pytest.mark.parametrize("raw", [None, "", "  ", "0.25", "0.1,7", "1",
                                 "1.5", "-0.5,3", "0,9", " 0.3 , 4 "])
def test_parse_shadow_rate_equals_jax(raw):
    assert numerics.parse_shadow_rate(raw) == jnum.parse_shadow_rate(raw)


@pytest.mark.parametrize("raw", ["lots", "0.5,many", "1,2,3"])
def test_parse_shadow_rate_rejects_as_jax(raw):
    with pytest.raises(ValueError, match="DFFT_SHADOW_RATE"):
        numerics.parse_shadow_rate(raw)
    with pytest.raises(ValueError, match="DFFT_SHADOW_RATE"):
        jnum.parse_shadow_rate(raw)


@pytest.mark.parametrize("rate, seed", [(0.5, 7), (0.1, 0), (0.9, 3),
                                        (1.0, 5), (0.0, 2)])
def test_sampler_picks_equal_jax(rate, seed):
    a = numerics.NumericsPlane(rate, seed=seed)
    b = jnum.NumericsPlane(rate, seed=seed)
    assert [a.pick() for _ in range(128)] == [b.pick() for _ in range(128)]


def test_rate_zero_arms_the_sentinels():
    z = numerics.NumericsPlane(0.0, seed=0)
    assert not any(z.pick() for _ in range(32))
    assert numerics.numerics_snapshot() is not None


# ------------------------------------------------ reservoir and verdict


@pytest.mark.parametrize("cap, seed, n", [(16, 3, 1000), (256, 0, 300),
                                          (8, 5, 8), (4, 1, 0)])
def test_reservoir_equals_jax(cap, seed, n):
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(size=n).tolist()
    a, b = numerics.Reservoir(cap=cap, seed=seed), jnum.Reservoir(
        cap=cap, seed=seed)
    for v in vals:
        a.add(v)
        b.add(v)
    assert (a.n, a.values, a.tail(4), a.tail()) == (
        b.n, b.values, b.tail(4), b.tail())
    for q in (0.0, 0.5, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)


@pytest.mark.parametrize("errs, n, admitted, floor, slack", [
    ([0.1] * 10, 10, 0.001, 1e-6, 8.0),
    ([0.1] * 3, 3, 0.001, 1e-6, 8.0),
    ([0.002] * 10, 10, 0.001, 1e-6, 8.0),
    ([1e-7] * 10, 10, 0.0, 1.19e-5, 8.0),
    ([], 0, 0.0, 0.0, 8.0),
    ([3e-4, 1e-5, 2e-3, 5e-5, 7e-4, 1e-3], 6, 2e-5, 1.19e-5, 4.0),
])
def test_judge_bucket_equals_jax(errs, n, admitted, floor, slack):
    assert numerics.judge_bucket(errs, n, admitted, floor, slack) == \
        jnum.judge_bucket(errs, n, admitted, floor, slack)


def test_judge_bucket_verdict_rules():
    assert numerics.judge_bucket([0.1] * 10, 10, 0.001, 1e-6)["drifting"]
    assert not numerics.judge_bucket([0.1] * 3, 3, 0.001, 1e-6)["drifting"]
    assert not numerics.judge_bucket([0.002] * 10, 10, 0.001,
                                     1e-6)["drifting"]
    assert not numerics.judge_bucket([1e-7] * 10, 10, 0.0,
                                     1.19e-5)["drifting"]


def test_ledger_snapshot_equals_jax():
    """The same audits, failures and non-finite counts recorded in both
    ledgers give the same monitor block."""
    rng = np.random.default_rng(4)
    for mod in (numerics, jnum):
        mod.NumericsPlane(0.5, seed=1)
    for i in range(40):
        label = f"c2c:8x8x8:complex64:fwd:x:{'int8' if i % 3 else 'exact'}"
        tenant = (None, "acme", "bulk")[i % 3]
        err = float(rng.lognormal(-8))
        for mod in (numerics, jnum):
            mod.record_audit(label, tenant, err, 5e-3, 1.19e-5)
    for mod in (numerics, jnum):
        mod.record_audit_failure()
        mod.record_nonfinite("output", "inf")
        mod.record_nonfinite("input", "nan")
        mod.record_sampled()
    assert numerics.numerics_snapshot() == jnum.numerics_snapshot()
    assert numerics.numerics_snapshot(slack=2.0) == jnum.numerics_snapshot(
        slack=2.0)


# -------------------------------------------------------- array helpers


def _pairs():
    rng = np.random.default_rng(11)
    for shape in ((8, 8, 8), (3, 5, 7), (64,), (2, 16, 16, 16)):
        for dt in (np.complex64, np.complex128):
            a = _mk(rng, shape).astype(dt)
            b = (a + 1e-3 * _mk(rng, shape)).astype(dt)
            yield a, b
    r = rng.standard_normal((6, 6, 6))
    yield r.astype(np.float32), (r * 1.001).astype(np.float32)
    yield r, r + 1e-9
    z = np.zeros((4, 4), np.complex64)
    yield _mk(rng, (4, 4)), z
    yield z, z


@pytest.mark.parametrize("i", range(12))
def test_realized_error_equals_jax(i):
    """Norms in complex128 (float64 for two real tensors) on the tensors'
    device: JAX's value within 1e-12 relative, for complex64/128, real
    and zero references."""
    a, b = list(_pairs())[i]
    want = jnum.realized_error(a, b)
    got = numerics.realized_error(_t(a), _t(b))
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


def test_realized_error_nonfinite_and_identity():
    y = torch.ones(8, dtype=torch.complex64)
    assert numerics.realized_error(y, y) == 0.0
    assert numerics.realized_error(2 * y, y) == pytest.approx(1.0)
    nan = torch.full((8,), float("nan"), dtype=torch.complex64)
    assert numerics.realized_error(nan, y) == float("inf")
    inf = y.clone()
    inf[0] = float("inf")
    assert numerics.realized_error(inf, y) == jnum.realized_error(
        inf.numpy(), y.numpy()) == float("inf")


@pytest.mark.parametrize("tdt, ndt", [(torch.complex64, np.complex64),
                                      (torch.complex128, np.complex128),
                                      (torch.float32, np.float32),
                                      (torch.float64, np.float64)])
def test_drift_floor_equals_jax(tdt, ndt):
    assert numerics.drift_floor(tdt) == jnum.drift_floor(ndt)


def test_drift_floor_of_a_non_float_dtype():
    assert numerics.drift_floor(torch.int32) == 1e-12
    assert numerics.drift_floor("complex64") == 1e-12


@pytest.mark.parametrize("case", ["clean", "nan", "inf", "nan+inf",
                                  "int", "real-inf"])
def test_nonfinite_kind_equals_jax(case):
    y = np.ones(8, np.complex64)
    if case in ("nan", "nan+inf"):
        y[0] = np.nan
    if case in ("inf", "nan+inf"):
        y[3] = np.inf
    if case == "int":
        y = np.arange(4)
    if case == "real-inf":
        y = np.array([1.0, -np.inf], np.float32)
    assert numerics.nonfinite_kind(_t(y)) == jnum.nonfinite_kind(y)
    assert numerics.nonfinite_kind(y) == jnum.nonfinite_kind(y)


# ------------------------------------------------- serving: the audit


def _run(q, xs, tenant=None):
    hs = [q.submit(_t(x), **({} if tenant is None else {"tenant": tenant}))
          for x in xs]
    q.flush()
    out = [h.result(timeout=10) for h in hs]
    q.close()
    return out


def test_disarmed_pin_and_armed_bit_identical(monkeypatch):
    """Unset: the queue has no plane; armed at rate 1, the primary
    outputs do not change by a bit, every request is audited against
    the exact plan (realized 0), and the bucket is labelled as JAX's
    with the port's executor."""
    rng = np.random.default_rng(0)
    xs = [_mk(rng) for _ in range(4)]
    q0 = tdfft.CoalescingQueue(8, policy="off", **CPU)
    assert q0._numerics is None
    base = _run(q0, xs)
    assert numerics.numerics_snapshot() is None

    monkeypatch.setenv("DFFT_SHADOW_RATE", "1,3")
    q1 = tdfft.CoalescingQueue(8, policy="off", **CPU)
    assert q1._numerics is not None and q1._numerics.rate == 1.0
    armed = _run(q1, xs)
    assert all(torch.equal(a, b) for a, b in zip(armed, base))
    snap = numerics.numerics_snapshot()
    assert (snap["sampled"], snap["audited"], snap["audit_failures"]) == (
        4, 4, 0)
    (key, bucket), = snap["plans"].items()
    assert key == "c2c:8x8x8:complex64:fwd:cuda:exact@-"
    assert bucket["realized_p99"] == 0.0 and not bucket["drifting"]
    assert bucket["n"] == 4

    jq = jdfft.CoalescingQueue(jdfft.make_mesh(8), dtype=jnp.complex64,
                               policy="off")
    hs = [jq.submit(jnp.asarray(x)) for x in xs]
    jq.flush()
    for h in hs:
        h.result(timeout=10)
    jq.close()
    (jkey, jbucket), = jnum.numerics_snapshot()["plans"].items()
    assert jkey == key.replace(":cuda:", ":xla:")
    assert {k: v for k, v in jbucket.items() if k != "plan"} == {
        k: v for k, v in bucket.items() if k != "plan"}


def test_shadow_audit_int8_contamination_drifts_as_jax(monkeypatch):
    """One hot co-batched request poisons the cohort's shared wire
    scales: O(1) realized error against the admitted int8 budget, the
    bucket drifting, in both packages."""
    monkeypatch.setenv("DFFT_SHADOW_RATE", "1,3")
    rng = np.random.default_rng(0)
    hot = _mk(rng)
    hot[:4, :4, :4] *= 1e4
    xs = [_mk(rng) for _ in range(5)] + [hot]
    q = tdfft.CoalescingQueue(8, policy="off", max_batch=8,
                              wire_dtype="int8", **CPU)
    _run(q, xs)
    jq = jdfft.CoalescingQueue(jdfft.make_mesh(8), dtype=jnp.complex64,
                               policy="off", max_batch=8, wire_dtype="int8")
    hs = [jq.submit(jnp.asarray(x)) for x in xs]
    jq.flush()
    for h in hs:
        h.result(timeout=10)
    jq.close()
    (key, b), = numerics.numerics_snapshot()["plans"].items()
    (_, jb), = jnum.numerics_snapshot()["plans"].items()
    assert ":int8@" in key
    assert b["n"] == jb["n"] == 6
    assert b["admitted_err"] == pytest.approx(jb["admitted_err"], rel=1e-12)
    assert b["drifting"] and jb["drifting"]
    assert b["drift_ratio"] > numerics.DEFAULT_SLACK
    assert b["realized_p99"] > 0.1
    assert b["realized_p99"] == pytest.approx(jb["realized_p99"], rel=1e-2)


def test_shadow_audit_charges_owning_tenant(monkeypatch):
    """Each audited request costs its tenant one more transform (a
    frozen clock: the balance is pure arithmetic)."""
    monkeypatch.setenv("DFFT_SHADOW_RATE", "1,3")
    rng = np.random.default_rng(0)
    pol = tdfft.QosPolicy([tdfft.Tenant("acme", rate=1000.0, burst=1000.0)],
                          clock=lambda: 0.0)
    q = tdfft.CoalescingQueue(8, policy=pol, **CPU)
    _run(q, [_mk(rng) for _ in range(3)], tenant="acme")
    snap = numerics.numerics_snapshot()
    assert snap["audited"] == 3
    (key, bucket), = snap["plans"].items()
    assert key.endswith("@acme") and bucket["tenant"] == "acme"
    assert pol._buckets["acme"].tokens == pytest.approx(1000.0 - 6.0)


def test_shadow_plan_is_the_exact_tier():
    """The reference of a compressed, fused, tiered queue: exact wire,
    no fusion, the base executor's exact tier."""
    q = tdfft.CoalescingQueue(4, policy="off", executor="cuda:fuse",
                              wire_dtype="split", **CPU)
    ref = q._shadow_plan(((16, 16, 16), "complex64", -1))
    assert (ref.executor, ref.wire_dtype, ref.batch) == (
        "cuda:highest", None, None)
    assert not ref.graph.meta["fusion"]["active"]
    qm = tdfft.CoalescingQueue(4, policy="off", executor="matmul:bf16",
                               **CPU)
    assert qm._shadow_plan(((16, 16, 16), "complex64", -1)).executor == \
        "matmul:highest"
    assert q._admitted_err(q._plan(((16, 16, 16), "complex64", -1), 2,
                                   False)) == pytest.approx(
        jex.wire_roundtrip_error(np.complex64, "split"), rel=1e-12)


# --------------------------------------- serving: non-finite sentinels


def test_quarantine_poisoned_request_fails_alone(monkeypatch):
    """A finite input whose transform overflows: its handle gets
    NonFiniteResult through the bisect chain, the cohort equals the
    no-poison baseline bit for bit."""
    monkeypatch.setenv("DFFT_SHADOW_RATE", "0")
    rng = np.random.default_rng(1)
    clean = [_mk(rng) for _ in range(3)]
    poison = np.full((8, 8, 8), 3e38 + 0j, np.complex64)
    base = _run(tdfft.CoalescingQueue(8, policy="off", retry_max=0, **CPU),
                clean)
    numerics.reset_numerics()
    q = tdfft.CoalescingQueue(8, policy="off", retry_max=0, **CPU)
    hs = [q.submit(_t(c)) for c in clean]
    hp = q.submit(_t(poison))
    q.flush()
    outs = [h.result(timeout=10) for h in hs]
    with pytest.raises(tdfft.NonFiniteResult) as ei:
        hp.result(timeout=10)
    q.close()
    assert ei.value.site == "output" and ei.value.kind in ("nan", "inf")
    assert all(torch.equal(a, b) for a, b in zip(outs, base))
    nf = numerics.numerics_snapshot()["nonfinite"]
    assert sum(v for k, v in nf.items() if k.startswith("output:")) >= 1


def test_nonfinite_input_delivered_never_retried(monkeypatch):
    monkeypatch.setenv("DFFT_SHADOW_RATE", "0")
    rng = np.random.default_rng(2)
    bad = _mk(rng)
    bad[0, 0, 0] = np.nan
    (y,) = _run(tdfft.CoalescingQueue(8, policy="off", retry_max=0, **CPU),
                [bad])
    assert not bool(torch.isfinite(y).all())
    nf = numerics.numerics_snapshot()["nonfinite"]
    assert nf.get("input:nan", 0) >= 1
    assert not any(k.startswith("output:") for k in nf)


def test_quarantine_through_concurrent_dispatch(monkeypatch):
    """The concurrent path hands a poisoned chunk to the per-group chain:
    the poisoned handle alone fails, as in JAX."""
    monkeypatch.setenv("DFFT_SHADOW_RATE", "0")
    rng = np.random.default_rng(3)
    q = tdfft.CoalescingQueue(8, policy="off", retry_max=0,
                              concurrent_groups=2, **CPU)
    hs = []
    for sh in ((8, 8, 8), (16, 8, 8)):
        for j in range(3):
            x = _mk(rng, sh)
            if sh == (8, 8, 8) and j == 1:
                x = np.full(sh, 3e38 + 0j, np.complex64)
            hs.append(q.submit(_t(x)))
    q.flush()
    failures = 0
    for h in hs:
        try:
            assert bool(torch.isfinite(h.result(timeout=10)).all())
        except tdfft.NonFiniteResult:
            failures += 1
    q.close()
    assert failures == 1


# ------------------------------------- adversarial dynamic-range parity


def test_adversarial_range_ratios_equal_jax():
    """The block-scaled codecs' seeded figures are optimistic on a
    heavy-tailed batch (int8 and split > 10x, the elementwise bf16 cast
    <= 2x); the port's codecs and figures give JAX's ratios."""
    rng = np.random.default_rng(0)
    normals = [_mk(rng) for _ in range(4)]
    hot = _mk(rng)
    hot[:4, :4, :4] *= 1e4
    batch = np.stack(normals + [hot])

    def ratios(ex, wrap, unwrap, dt):
        out = {}
        for wd in ("bf16", "int8", "split"):
            codec = ex.wire_codec(wd)
            y = unwrap(codec.decode(codec.encode(wrap(batch), tile_axis=1,
                                                 tiles=8),
                                    dt, tile_axis=1, tiles=8))
            worst = max(float(np.linalg.norm(y[i] - batch[i])
                              / np.linalg.norm(batch[i]))
                        for i in range(len(normals)))
            out[wd] = worst / ex.wire_roundtrip_error(np.complex64, wd)
        return out

    mine = ratios(tex, _t, lambda y: y.numpy(), torch.complex64)
    theirs = ratios(jex, jnp.asarray, np.asarray, np.complex64)
    assert mine["int8"] > 10.0 and mine["split"] > 10.0
    assert mine["bf16"] <= 2.0
    for wd in mine:
        assert mine[wd] == pytest.approx(theirs[wd], rel=1e-9)


@pytest.mark.parametrize("grid", [(2, 2), 4])
def test_split_realized_error_equals_jax(grid):
    """A split plan's realized L2 error against the exact plan (what the
    shadow audit records) equals JAX's on the same data within 1%, and
    lies above the admitted one-cast figure plus the floor and below the
    drift slack times it: the audit's bound is the slack, not the bare
    figure."""
    from distributedfft_tpu_torch.parallel.exchange import (
        wire_roundtrip_error)

    shape = (32, 32, 32)
    x = _mk(np.random.default_rng(0), shape)
    mine = numerics.realized_error(
        tdfft.plan_dft_c2c_3d(shape, grid, wire_dtype="split", fuse=True,
                              **CPU)(_t(x)),
        tdfft.plan_dft_c2c_3d(shape, grid, **CPU)(_t(x)))
    mesh = jdfft.make_mesh(grid)
    theirs = jnum.realized_error(
        jdfft.plan_dft_c2c_3d(shape, mesh, dtype=jnp.complex64,
                              wire_dtype="split")(jnp.asarray(x)),
        jdfft.plan_dft_c2c_3d(shape, mesh, dtype=jnp.complex64)(
            jnp.asarray(x)))
    assert mine == pytest.approx(theirs, rel=1e-2)
    admitted = wire_roundtrip_error(torch.complex64, "split")
    floor = numerics.drift_floor(torch.complex64)
    assert admitted + floor < mine < numerics.DEFAULT_SLACK * admitted
