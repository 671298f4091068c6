"""The port's metrics registry, plan cache and exchange accounting
against the JAX package's.

- The registry (``utils/metrics.py``): the same inc / set_gauge /
  observe sequence (a reservoir series past its capacity included) gives
  the JAX registry's snapshot, time stamps apart; off by default, and no
  environment variable turns it on.
- The plan cache: the same planner sequence (c2c, r2c, c2r, the dd
  planners, ``r2c_axis``, the op planner, ``clear_plan_cache``, an
  unhashable argument that bypasses, 130 plans that evict the oldest)
  gives the JAX cache's hit and miss counts by kind and its build count;
  a cached plan gives a fresh plan's bits.
- ``exchange_payloads`` equals the JAX entry list entry for entry (slab,
  pencil, uneven, backward, batch, operator, every codec, every
  transport, the hierarchical legs, real plans), and an execute's
  exchange counters equal the JAX execute's.
- The wiring: ``executes`` per execute and per dd call, the
  ``pallas_fallback`` and ``fusion_fallback`` series beside the port's
  own counters.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import operators as top
from distributedfft_tpu_torch import plan_logic as tpl
from distributedfft_tpu_torch.ops import cuda_fft, cuda_fuse
from distributedfft_tpu_torch.parallel.mesh import HYBRID_AXES, make_world
from distributedfft_tpu_torch.utils import metrics as tm

CPU = dict(device="cpu")


def _jax():
    import distributedfft_tpu as jdfft

    return jdfft


def _jm():
    from distributedfft_tpu.utils import metrics as jm

    return jm


@pytest.fixture
def metrics_on():
    """Both registries fresh and on, both plan caches empty; restored to
    the disabled default afterwards."""
    jd, jm = _jax(), _jm()
    for m, clear in ((tm, tdfft.clear_plan_cache),
                     (jm, jd.clear_plan_cache)):
        clear()
        m.metrics_reset()
        m.enable_metrics()
    yield
    for m, clear in ((tm, tdfft.clear_plan_cache),
                     (jm, jd.clear_plan_cache)):
        m.enable_metrics(False)
        m.metrics_reset()
        clear()


def _drive(m):
    m._res_rng.seed(0x0FF7)
    m.inc("c", 2.0, kind="x")
    m.inc("c", 3.0, kind="x")
    m.inc("c", kind="y", decomposition="slab")
    m.inc("plain")
    m.set_gauge("g", 3.5, role="r")
    m.set_gauge("g", 1.25, role="r")
    m.set_gauge("q", 7)
    m.observe("h", 1.0)
    m.observe("h", 3.0, kind="a")
    m.observe("h", -2.0, kind="a")
    for i in range(m.RESERVOIR_SIZE + 300):
        m.observe("serving_wait_seconds", (i * 37 % 1009) / 1009.0,
                  kind="c2c")
    for i in range(5):
        m.observe("serving_tenant_wait_seconds", float(i), tenant="t")
    return m.metrics_snapshot()


def test_registry_snapshot_equals_jax(metrics_on):
    mine, theirs = _drive(tm), _drive(_jm())
    for snap in (mine, theirs):
        snap.pop("captured_at_monotonic")
    assert mine == theirs
    assert mine["schema"] == tm.METRICS_SCHEMA == _jm().METRICS_SCHEMA
    assert mine["histograms"]["serving_wait_seconds"]["kind=c2c"][
        "exact"] is False
    assert tm.counter_total("c") == _jm().counter_total("c") == 6.0
    json.dumps(mine)
    tm.metrics_reset()
    empty = tm.metrics_snapshot()
    assert (empty["counters"], empty["gauges"], empty["histograms"]) == (
        {}, {}, {})


def test_registry_off_by_default_and_env_blind(monkeypatch):
    monkeypatch.setenv("DFFT_METRICS", "1")
    importlib.reload(tm)
    try:
        assert not tm.metrics_enabled()
        tm.inc("c")
        tm.observe("h", 1.0)
        snap = tm.metrics_snapshot()
        assert snap["counters"] == {} and snap["histograms"] == {}
        assert snap["enabled"] is False
    finally:
        monkeypatch.delenv("DFFT_METRICS")
        importlib.reload(tm)


def _sequence(dd, planners, clear, world, ops):
    """One planner call sequence, run on either package."""
    c2c, r2c, c2r, ddc, ddr, op = planners
    shape = (8, 8, 8)
    c2c(shape, world)                                   # miss
    c2c(shape, world)                                   # hit
    c2c(shape, world, direction=dd.BACKWARD)            # miss
    c2c((8, 8, 4), world)                               # miss
    r2c(shape, world)                                   # miss
    c2r(shape, world)                                   # miss (r2c kind)
    r2c(shape, world)                                   # hit
    ddc(shape, None)                                    # miss
    ddc(shape, None)                                    # hit
    ddc(shape, world, direction=dd.BACKWARD)            # miss
    ddr(shape, None, r2c_axis=1)                        # miss + inner miss
    ddr(shape, None, r2c_axis=1)                        # hit
    op(shape, world, op=ops.poisson())                  # miss
    op(shape, world, op=ops.poisson())                  # hit
    op(shape, world, op=[ops.poisson(), ops.gaussian(1.0)])  # bypass
    clear()
    c2c(shape, world)                                   # miss again
    ddc(shape, None)                                    # miss again
    first = c2c((2, 2, 2), None)
    for n in range(3, 3 + 129):                         # evicts the oldest
        c2c((2, 2, n), None)
    assert c2c((2, 2, 2), None) is not first            # evicted: miss
    c2c((2, 2, 3 + 128), None)                          # newest: hit


def _counts(m) -> dict:
    snap = m.metrics_snapshot()["counters"]
    out = {k: snap.get(k, {}) for k in ("plan_cache_hits",
                                        "plan_cache_misses")}
    builds: dict = {}
    for labels, v in snap.get("plan_builds", {}).items():
        kind = dict(p.split("=") for p in labels.split(","))["kind"]
        builds[kind] = builds.get(kind, 0) + v
    out["plan_builds"] = builds
    return out


def test_plan_cache_counts_equal_jax(metrics_on):
    jd = _jax()
    from distributedfft_tpu import operators as jops

    def port(fn):
        return lambda shape, world, **kw: fn(shape, world, **CPU, **kw)

    _sequence(tdfft, [port(f) for f in (
        tdfft.plan_dft_c2c_3d, tdfft.plan_dft_r2c_3d, tdfft.plan_dft_c2r_3d,
        tdfft.plan_dd_dft_c2c_3d, tdfft.plan_dd_dft_r2c_3d,
        top.plan_spectral_op)], tdfft.clear_plan_cache, 2, top)
    _sequence(jd, [jd.plan_dft_c2c_3d, jd.plan_dft_r2c_3d,
                   jd.plan_dft_c2r_3d, jd.plan_dd_dft_c2c_3d,
                   jd.plan_dd_dft_r2c_3d, jops.plan_spectral_op],
              jd.clear_plan_cache, jd.make_mesh(2), jops)
    mine, theirs = _counts(tm), _counts(_jm())
    assert mine == theirs
    assert mine["plan_cache_hits"]["kind=dd_c2c"] == 1
    assert mine["plan_cache_misses"]["kind=dd_r2c"] == 2
    assert set(tm.metrics_snapshot()["histograms"]["plan_build_seconds"]) \
        == set(_jm().metrics_snapshot()["histograms"]["plan_build_seconds"])


def test_cache_identity_and_bypass(metrics_on):
    p = tdfft.plan_dft_c2c_3d((8, 6, 4), 2, **CPU)
    assert tdfft.plan_dft_c2c_3d((8, 6, 4), 2, **CPU) is p
    assert tdfft.plan_dft_c2c_3d((8, 6, 4), 2, device=torch.device("cpu")) \
        is p                                       # the resolved device
    assert tdfft.plan_dft_c2c_3d((8, 6, 4), 2, batch=1, **CPU) is not p
    one = tdfft.plan_dft_c2c_3d((8, 6, 4), 2, batch=1, **CPU)
    with pytest.raises(ValueError, match="batch"):  # True is not 1 here
        tdfft.plan_dft_c2c_3d((8, 6, 4), 2, batch=True, **CPU)
    assert one.batch is None
    a = tdfft.plan_dft_c2c_3d((8, 6, 4), [2, 2], **CPU)   # unhashable
    assert tdfft.plan_dft_c2c_3d((8, 6, 4), [2, 2], **CPU) is not a
    assert tm.counter_total("plan_builds") == 4


def test_cache_keys_the_overlap_environment(monkeypatch):
    tdfft.clear_plan_cache()
    shape = (64, 64, 64)
    monkeypatch.setenv("DFFT_OVERLAP", "1")
    one = tdfft.plan_dft_c2c_3d(shape, 4, **CPU)
    monkeypatch.setenv("DFFT_OVERLAP", "2")
    two = tdfft.plan_dft_c2c_3d(shape, 4, **CPU)
    assert (one.overlap_chunks, two.overlap_chunks) == (1, 2)
    tdfft.clear_plan_cache()


@pytest.mark.parametrize("planner,dd", [("c2c", False), ("r2c", False),
                                        ("dd_c2c", True), ("op", False)])
def test_cached_plan_gives_fresh_bits(planner, dd):
    shape = (8, 6, 10)
    build = {"c2c": tdfft.plan_dft_c2c_3d, "r2c": tdfft.plan_dft_r2c_3d,
             "dd_c2c": tdfft.plan_dd_dft_c2c_3d,
             "op": lambda s, w, **kw: top.plan_spectral_op(
                 s, w, op=top.poisson(), **kw)}[planner]
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    tdfft.clear_plan_cache()
    cached = build(shape, 2, **CPU)
    assert build(shape, 2, **CPU) is cached
    tdfft.clear_plan_cache()
    fresh = build(shape, 2, **CPU)
    assert fresh is not cached
    if dd:
        args = tdfft.dd_from_host(x, device="cpu")
        for got, want in zip(cached(*args), fresh(*args)):
            assert torch.equal(got, want)
    else:
        xt = torch.from_numpy((x.real if planner == "r2c" else x).astype(
            np.float32 if planner == "r2c" else np.complex64))
        assert torch.equal(cached(xt), fresh(xt))
    tdfft.clear_plan_cache()


# ------------------------------------------------------ exchange_payloads

def _jworld(key):
    import jax
    from jax.sharding import Mesh

    if key == "hier":
        return Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("dcn", "ici"))
    return _jax().make_mesh(key)


def _tworld(key):
    return make_world((2, 2), HYBRID_AXES) if key == "hier" else key


PAYLOAD_CASES = [
    # (id, planner, shape, world key, keywords)
    ("slab", "c2c", (16, 16, 16), 4, {}),
    ("slab_bwd", "c2c", (16, 16, 16), 4, {"direction": 1}),
    ("slab_uneven", "c2c", (12, 10, 9), 4, {}),
    ("slab_alltoallv", "c2c", (12, 10, 9), 4, {"algorithm": "alltoallv"}),
    ("slab_ppermute", "c2c", (12, 10, 9), 4, {"algorithm": "ppermute"}),
    ("pencil", "c2c", (16, 24, 20), (2, 2), {}),
    ("pencil_bwd", "c2c", (16, 24, 20), (2, 2), {"direction": 1}),
    ("pencil_alltoallv", "c2c", (16, 24, 20), (2, 2),
     {"algorithm": "alltoallv"}),
    ("pencil_ppermute", "c2c", (16, 24, 20), (2, 2),
     {"algorithm": "ppermute"}),
    ("hierarchical", "c2c", (16, 12, 8), "hier",
     {"algorithm": "hierarchical"}),
    ("batch", "c2c", (12, 10, 9), 4, {"batch": 3}),
    ("bf16", "c2c", (16, 16, 16), 4, {"wire_dtype": "bf16"}),
    ("int8", "c2c", (16, 16, 16), 4, {"wire_dtype": "int8"}),
    ("split", "c2c", (16, 16, 16), (2, 2), {"wire_dtype": "split"}),
    ("r2c_slab", "r2c", (12, 10, 16), 4, {}),
    ("r2c_pencil", "r2c", (8, 12, 16), (2, 2), {}),
    ("op_slab", "op", (16, 16, 16), 4, {}),
    ("op_pencil", "op", (16, 24, 20), (2, 2), {"batch": 2}),
]


@pytest.mark.parametrize("label,planner,shape,key,kw", PAYLOAD_CASES,
                         ids=[c[0] for c in PAYLOAD_CASES])
def test_exchange_payloads_equal_jax(label, planner, shape, key, kw):
    from distributedfft_tpu import operators as jops
    from distributedfft_tpu import plan_logic as jpl

    jd = _jax()
    if planner == "op":
        jp = jops.plan_spectral_op(shape, _jworld(key), op=jops.poisson(),
                                   **kw)
        tp = top.plan_spectral_op(shape, _tworld(key), op=top.poisson(),
                                  **kw, **CPU)
    else:
        jplanner = (jd.plan_dft_c2c_3d if planner == "c2c"
                    else jd.plan_dft_r2c_3d)
        tplanner = (tdfft.plan_dft_c2c_3d if planner == "c2c"
                    else tdfft.plan_dft_r2c_3d)
        jp = jplanner(shape, _jworld(key), **kw)
        tp = tplanner(shape, _tworld(key), **kw, **CPU)
    side = shape if planner != "r2c" else shape[:2] + (shape[2] // 2 + 1,)
    want = jpl.exchange_payloads(jp.logic, side, 8)
    got = tpl.exchange_payloads(tp.logic, side, 8)
    assert want and got == want


def test_single_device_has_no_payload():
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), None, **CPU)
    assert tpl.exchange_payloads(plan.logic, (8, 8, 8), 8) == []


def test_execute_exchange_counters_equal_jax(metrics_on):
    jd = _jax()
    shape = (12, 10, 9)
    x = np.zeros(shape, np.complex64)
    jp = jd.plan_dft_c2c_3d(shape, jd.make_mesh(4), dtype=np.complex64)
    jp(x)
    tp = tdfft.plan_dft_c2c_3d(shape, 4, **CPU)
    tp(torch.from_numpy(x))
    for name in ("executes", "exchange_true_bytes", "exchange_wire_bytes"):
        assert tm.counter_total(name) == _jm().counter_total(name) > 0
    brick = tdfft.plan_brick_dft_c2c_3d(
        shape, 4, tp.in_boxes, tp.out_boxes, **CPU)
    chain = tm.counter_total("exchange_true_bytes")     # one execute
    brick(tdfft.scatter_bricks(torch.from_numpy(x), tp.in_boxes))
    edges = sum(bs.payload_elems for bs in brick.brick_edges) * 8
    assert tm.counter_total("exchange_true_bytes") == 2 * chain + edges


# ------------------------------------------------------------ wiring

def test_executes_and_fallback_series(metrics_on):
    shape = (8, 8, 8)
    x = torch.zeros(shape, dtype=torch.complex64)
    tdfft.plan_dft_c2c_3d(shape, 2, **CPU)(x)
    top.plan_spectral_op(shape, 2, op=top.poisson(), **CPU)(x)
    p = tdfft.plan_dd_dft_c2c_3d(shape, 2, **CPU)
    p(*tdfft.dd_from_host(np.zeros(shape, complex), device="cpu"))
    snap = tm.metrics_snapshot()["counters"]["executes"]
    assert snap == {"decomposition=slab,executor=cuda,kind=c2c": 1.0,
                    "decomposition=slab,executor=cuda,kind=op_poisson": 1.0,
                    "decomposition=slab,executor=dd,kind=dd": 1.0}
    before = dict(cuda_fft.FALLBACKS)
    tm.metrics_reset()
    tdfft.plan_dft_c2c_3d(shape, 2, dtype=torch.complex128, **CPU)(
        x.to(torch.complex128))
    grown = {k: v - before.get(k, 0) for k, v in cuda_fft.FALLBACKS.items()
             if v != before.get(k, 0)}
    series = tm.metrics_snapshot()["counters"]["pallas_fallback"]
    assert (0, "dtype") in grown
    assert series == {f"axis={a},reason={r}": float(v)
                      for (a, r), v in sorted(grown.items())}
    fb = dict(cuda_fuse.FUSION_FALLBACKS)
    tm.metrics_reset()
    tdfft.clear_plan_cache()
    tdfft.plan_dft_c2c_3d((16, 16, 16), 2, fuse=True, **CPU)
    grown = {k: v - fb.get(k, 0) for k, v in cuda_fuse.FUSION_FALLBACKS.items()
             if v != fb.get(k, 0)}
    assert grown == {("graph", "no_wire_codec"): 1}
    assert tm.metrics_snapshot()["counters"]["fusion_fallback"] == {
        "reason=no_wire_codec,site=graph": 1.0}


def test_disabled_records_nothing():
    tm.enable_metrics(False)
    tm.metrics_reset()
    tdfft.clear_plan_cache()
    plan = tdfft.plan_dft_c2c_3d((4, 6, 4), 2, **CPU)
    plan(torch.zeros((4, 6, 4), dtype=torch.complex64))
    snap = tdfft.metrics_snapshot()
    assert (snap["counters"], snap["gauges"], snap["histograms"]) == (
        {}, {}, {})
    assert not hasattr(plan, "_exchange_bytes")
    tdfft.clear_plan_cache()
