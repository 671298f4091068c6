"""The port's tuner (``distributedfft_tpu_torch/tuner.py``) against the
JAX package's (``distributedfft_tpu/tuner.py``).

Under the label map (``xla`` -> ``torch``, ``xla_minor`` ->
``torch_minor``, ``pallas`` -> ``cuda``, ``matmul`` -> ``matmul``):

- the options plumbing: ``PlanOptions.tune``, ``resolve_tune_mode``,
  ``resolve_wire_dtype``, ``resolve_fuse`` and ``tune_budget`` give the
  JAX outputs and error text; ``tune`` unset never reaches the tuner;
- ``enumerate_candidates`` and ``prune_candidates`` give the JAX
  candidates (both modules' ranking constants set alike), and
  ``model_cost`` (``corrected=False``) the JAX seconds within 1e-12
  relative, ``exchange_model_seconds`` and ``mm_dft_flops`` the JAX
  values; the ``cuda`` family is priced by the HBM roofline where JAX
  prices ``pallas`` as matmuls (a deliberate difference);
- ``agree_winner`` and ``measured_select`` (two processes simulated)
  pick the JAX winners from the same matrices;
- the wisdom store: ``wisdom_key`` fields apart from the library
  identity, key isolation, the newest entry winning, corrupt lines
  skipped with a count, a disabled store;
- tuned planning on loopback worlds at 16^3-scale shapes with
  ``DFFT_TUNE_ITERS=1x1`` and a measure stub that ranks both packages'
  candidates alike: the same winning label, outputs within the tiers of
  ``distributedfft_tpu/testing.py`` (c64 5e-4, c128 1e-11) of the JAX
  plan's, a wisdom replay with no timing execution, the width
  tournament;
- a 2-rank gloo group (a ``file://`` store under ``tmp_path``) where one
  rank fails one candidate's build: that candidate is timed on neither
  rank and both pick the same winner;
- the plan cache keys every environment variable planning reads.

No test depends on which candidate is faster by the clock: every test
that asserts a winner stubs the measurement.
"""

import ast
import json
import math
import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import plan_logic as tpl
from distributedfft_tpu_torch import tuner
from distributedfft_tpu_torch.parallel import exchange as tex
from distributedfft_tpu_torch.utils import metrics as tm

CPU = dict(device="cpu")
PORT = {"xla": "torch", "xla_minor": "torch_minor", "pallas": "cuda",
        "matmul": "matmul"}
TIER = {np.complex64: 5e-4, np.complex128: 1e-11}
TDT = {np.complex64: torch.complex64, np.complex128: torch.complex128}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jt():
    from distributedfft_tpu import tuner as jt

    return jt


def _port_ex(ex: str) -> str:
    base, *mods = ex.split(":")
    return ":".join([PORT[base]] + mods)


def _port_cand(c) -> tuple:
    return (c.decomposition, c.algorithm, _port_ex(c.executor),
            c.overlap_chunks, c.wire_dtype)


def _mine(c) -> tuple:
    return (c.decomposition, c.algorithm, c.executor, c.overlap_chunks,
            c.wire_dtype)


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def _x(shape, dtype, seed=3):
    rng = np.random.default_rng(seed)
    if dtype in (np.float32, np.float64):
        return rng.standard_normal(shape).astype(dtype)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.fixture
def same_constants(monkeypatch):
    """Both modules' ranking constants set to the same values."""
    jt = _jt()
    vals = dict(MODEL_WIRE_GBPS=150.0, MODEL_HBM_GBPS=3000.0,
                MODEL_LAUNCH_SECONDS=2e-5, MODEL_DCN_GBPS=25.0)
    for mod in (jt, tuner):
        for k, v in vals.items():
            monkeypatch.setattr(mod, k, v)
        monkeypatch.setattr(mod, "MODEL_MM_TFLOPS",
                            {"bf16": 40.0, "f32": 200.0, "highest": 45.0})
    monkeypatch.setenv("DFFT_HW_PROFILE", "0")
    monkeypatch.delenv("DFFT_TUNE_MAX", raising=False)


@pytest.fixture
def store(tmp_path, monkeypatch):
    """Fresh wisdom stores (port and JAX), the smallest timing budget,
    the JAX compile cache left as the suite set it, both plan caches
    and registries cleared and on."""
    from distributedfft_tpu.utils import metrics as jm

    import distributedfft_tpu as jdfft

    monkeypatch.setenv("DFFT_WISDOM", str(tmp_path / "wisdom.jsonl"))
    monkeypatch.setenv("DFFT_TUNE_ITERS", "1x1")
    monkeypatch.setenv("DFFT_NO_COMPILE_CACHE", "1")
    monkeypatch.setenv("DFFT_HW_PROFILE", "0")
    for m, clear in ((tm, tdfft.clear_plan_cache),
                     (jm, jdfft.clear_plan_cache)):
        clear()
        m.metrics_reset()
        m.enable_metrics()
    yield str(tmp_path / "wisdom.jsonl")
    for m, clear in ((tm, tdfft.clear_plan_cache),
                     (jm, jdfft.clear_plan_cache)):
        m.enable_metrics(False)
        m.metrics_reset()
        clear()


# ----------------------------------------------------- options plumbing

@pytest.mark.parametrize("tune", [None, "off", "wisdom", "measure"])
def test_plan_options_take_tune(tune):
    from distributedfft_tpu.plan_logic import PlanOptions as JaxOptions

    assert tpl.PlanOptions(tune=tune).tune == JaxOptions(tune=tune).tune


@pytest.mark.parametrize("env,value", [
    (None, None), (None, "wisdom"), ("measure", None), ("off", None),
    ("nonsense", None), (None, "bogus")])
def test_resolve_tune_mode_matches_jax(env, value, monkeypatch):
    from distributedfft_tpu.plan_logic import resolve_tune_mode

    if env is None:
        monkeypatch.delenv("DFFT_TUNE", raising=False)
    else:
        monkeypatch.setenv("DFFT_TUNE", env)
    try:
        want = resolve_tune_mode(value)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            tpl.resolve_tune_mode(value)
        assert str(mine.value) == str(e)
        return
    assert tpl.resolve_tune_mode(value) == want


@pytest.mark.parametrize("env,value", [
    (None, None), ("bf16", None), ("int8", None), ("bf16", "none"),
    (None, "split"), ("fp8", None), (None, " BF16 ")])
def test_resolve_wire_dtype_matches_jax(env, value, monkeypatch):
    from distributedfft_tpu.plan_logic import resolve_wire_dtype

    if env is None:
        monkeypatch.delenv("DFFT_WIRE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("DFFT_WIRE_DTYPE", env)
    try:
        want = resolve_wire_dtype(value)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            tpl.resolve_wire_dtype(value)
        assert str(mine.value) == str(e)
        return
    assert tpl.resolve_wire_dtype(value) == want


@pytest.mark.parametrize("env,value", [
    (None, None), ("1", None), ("off", None), ("on", False), ("x", None),
    (None, True)])
def test_resolve_fuse_matches_jax(env, value, monkeypatch):
    from distributedfft_tpu.plan_logic import resolve_fuse

    if env is None:
        monkeypatch.delenv("DFFT_FUSE", raising=False)
    else:
        monkeypatch.setenv("DFFT_FUSE", env)
    try:
        want = resolve_fuse(value)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            tpl.resolve_fuse(value)
        assert str(mine.value) == str(e)
        return
    assert tpl.resolve_fuse(value) == want


def test_env_defaults_reach_the_plans(monkeypatch):
    """``DFFT_WIRE_DTYPE`` and ``DFFT_FUSE`` fill the unset knobs of a
    plan; an explicit ``"none"`` keeps the exact wire; the fuse default
    is ignored by an executor without a fused tier."""
    tdfft.clear_plan_cache()
    monkeypatch.setenv("DFFT_WIRE_DTYPE", "split")
    monkeypatch.setenv("DFFT_FUSE", "1")
    plan = tdfft.plan_dft_c2c_3d((16, 16, 8), 4, **CPU)
    assert (plan.wire_dtype, plan.executor) == ("split", "cuda:fuse")
    exact = tdfft.plan_dft_c2c_3d((16, 16, 8), 4, wire_dtype="none", **CPU)
    assert exact.wire_dtype is None
    other = tdfft.plan_dft_c2c_3d((16, 16, 8), 4, executor="torch", **CPU)
    assert other.executor == "torch"
    tdfft.clear_plan_cache()


def test_default_off_never_dispatches_to_tuner(monkeypatch):
    monkeypatch.delenv("DFFT_TUNE", raising=False)

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("tuner dispatched on a default planner call")

    monkeypatch.setattr(tuner, "tuned_plan", boom)
    tdfft.clear_plan_cache()
    plan = tdfft.plan_dft_c2c_3d((8, 6, 4), 2, **CPU)
    assert plan.options.tune in (None, "off")
    x = _x((8, 6, 4), np.complex64)
    assert _rel(plan(torch.from_numpy(x)).numpy(), np.fft.fftn(x)) < 5e-4
    tdfft.clear_plan_cache()


@pytest.mark.parametrize("raw", [None, "6", "4x3", "0", "x", "3x0", "abc",
                                 "1x2x3"])
def test_tune_budget_matches_jax(raw, monkeypatch):
    jt = _jt()
    if raw is None:
        monkeypatch.delenv("DFFT_TUNE_ITERS", raising=False)
    else:
        monkeypatch.setenv("DFFT_TUNE_ITERS", raw)
    try:
        want = jt.tune_budget()
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            tuner.tune_budget()
        assert str(mine.value) == str(e)
        return
    assert tuner.tune_budget() == want


@pytest.mark.parametrize("raw", [None, "off", "0", "5", "2x3", "x", "0x2"])
def test_width_budget_matches_jax(raw, monkeypatch):
    jt = _jt()
    if raw is None:
        monkeypatch.delenv("DFFT_WIDTH_TOURNAMENT", raising=False)
    else:
        monkeypatch.setenv("DFFT_WIDTH_TOURNAMENT", raw)
    try:
        want = jt.width_budget()
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            tuner.width_budget()
        assert str(mine.value) == str(e)
        return
    assert tuner.width_budget() == want


# ------------------------------------------------- candidates + pruning

ENUM_CASES = [
    dict(shape=(64, 64, 64), ndev=8, executors=["xla", "matmul"]),
    dict(shape=(16, 16, 16), ndev=8, mesh_dims=(8,), executors=["xla"]),
    dict(shape=(16, 16, 16), ndev=8, mesh_dims=(2, 4), executors=["xla"]),
    dict(shape=(64, 64, 32), ndev=4, executors=["xla", "xla_minor",
                                                "pallas", "matmul"],
         wire_dtypes=(None, "bf16", "int8", "split"),
         mm_tiers=(None, "bf16", "f32")),
    dict(shape=(32, 32, 32), ndev=4, executors=["pallas", "matmul"],
         hybrid=True, wire_dtypes=(None, "split")),
    dict(shape=(32, 16, 64), ndev=4, executors=["xla", "pallas"],
         batch=3, itemsize=16),
    dict(shape=(8, 8, 8), ndev=16, executors=["xla"]),
]


@pytest.mark.parametrize("case", ENUM_CASES, ids=lambda c: str(c["shape"])
                         + f"/{c['ndev']}")
def test_enumerate_candidates_matches_jax(case):
    jt = _jt()
    kw = dict(case)
    shape, ndev = kw.pop("shape"), kw.pop("ndev")
    want = [_port_cand(c) for c in jt.enumerate_candidates(shape, ndev, **kw)]
    kw["executors"] = [PORT[e] for e in kw["executors"]]
    got = [_mine(c) for c in tuner.enumerate_candidates(shape, ndev, **kw)]
    assert got == want


def test_default_executors_drop_cuda_off_the_card(monkeypatch):
    """As the JAX package drops ``pallas`` off the TPU, the port drops
    ``cuda`` off the card (and ``auto`` always)."""
    jt = _jt()
    monkeypatch.delenv("DFFT_AUTO_EXECUTORS", raising=False)
    assert tuner._default_executors("cpu") == [
        PORT[e] for e in jt._default_executors()]
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "auto, cuda, matmul")
    assert tuner._default_executors("cpu") == ["matmul"]
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "cuda")
    assert tuner._default_executors("cpu") == ["torch"]
    assert tuner._default_executors("cuda") == ["cuda"]


@pytest.mark.parametrize("shape,itemsize,real,tiered", [
    ((64, 64, 64), 8, False, False),    # every length a radix kernel's
    ((64, 64, 32), 8, False, True),     # 32 runs dft_matmul
    ((64, 64, 64), 16, False, True),    # complex128 runs dft_matmul
    ((64, 64, 64), 8, True, True),      # the R2C axis's packed 32
    ((128, 128, 128), 8, True, False),  # packed 64: a kernel's
], ids=["c64", "short-axis", "c128", "r2c-short-half", "r2c"])
def test_cuda_takes_tiers_only_where_they_reach_a_matmul(shape, itemsize,
                                                         real, tiered):
    """``cuda`` is crossed with the matmul tiers only where a transform
    of the plan runs :mod:`.ops.dft_matmul` (the deliberate difference
    from the JAX package, which crosses ``pallas`` always); ``matmul``
    always is."""
    cands = tuner.enumerate_candidates(
        shape, 4, mesh_dims=(4,), executors=["cuda", "matmul"],
        itemsize=itemsize, wire_dtypes=(None, "int8"),
        mm_tiers=(None, "bf16", "f32"), real=real)
    execs = {c.executor for c in cands}
    assert {"matmul:bf16", "matmul:f32", "cuda", "cuda:fuse"} <= execs
    assert tuner._cuda_reads_tiers(shape, itemsize, real) == tiered
    tiers = {"cuda:bf16", "cuda:f32", "cuda:bf16:fuse", "cuda:f32:fuse"}
    if tiered:
        assert tiers <= execs
    else:
        assert not tiers & execs


PRUNE_CASES = [
    dict(shape=(64, 64, 64), mesh=8, executors=["xla", "matmul"], limit=4),
    dict(shape=(64, 64, 32), mesh=4, executors=["xla", "xla_minor",
                                                "matmul"],
         wire_dtypes=(None, "bf16", "int8", "split"),
         mm_tiers=(None, "bf16", "f32"), max_err=1e-3),
    dict(shape=(64, 64, 32), mesh=4, executors=["xla", "matmul"],
         wire_dtypes=(None, "bf16", "int8"), max_err=1e-2, limit=12),
    dict(shape=(32, 32, 32), mesh=4, executors=["xla", "matmul"],
         batch=2),
    dict(shape=(128, 64, 64), mesh=8, executors=["xla", "xla_minor"],
         limit=20),
]


@pytest.mark.parametrize("case", PRUNE_CASES,
                         ids=lambda c: str(c["shape"]) + f"/{c['mesh']}")
def test_prune_candidates_matches_jax(case, same_constants):
    jt = _jt()
    kw = dict(case)
    shape, mesh = kw.pop("shape"), kw.pop("mesh")
    ekw = {k: kw.pop(k) for k in ("executors", "wire_dtypes", "mm_tiers")
           if k in kw}
    pkw = dict(limit=kw.pop("limit", None), max_err=kw.pop("max_err", None),
               batch=kw.get("batch"))
    jc = jt.enumerate_candidates(shape, mesh, batch=kw.get("batch"), **ekw)
    want = [_port_cand(c) for c in jt.prune_candidates(
        jc, shape, mesh, dtype=np.complex64, **pkw)]
    ekw["executors"] = [PORT[e] for e in ekw["executors"]]
    tc = tuner.enumerate_candidates(shape, mesh, batch=kw.get("batch"),
                                    **ekw)
    got = [_mine(c) for c in tuner.prune_candidates(
        tc, shape, mesh, dtype=torch.complex64, device="cpu", **pkw)]
    assert got == want


def test_model_cost_matches_jax(same_constants):
    """``model_cost`` with ``corrected=False`` over a joint space with
    every transport, K, codec, tier, batch and the hybrid world: the
    JAX seconds within 1e-12 relative (the ``pallas`` family aside)."""
    import jax
    from jax.sharding import Mesh

    from distributedfft_tpu.parallel.mesh import make_mesh

    jt = _jt()
    worlds = [(8, 8), (4, 4), (make_mesh((2, 2)), (2, 2)),
              (Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("dcn", "ici")),
               tdfft.make_world((2, 2), tdfft.HYBRID_AXES))]
    n = 0
    for jmesh, pworld in worlds:
        hybrid = isinstance(jmesh, Mesh) and jmesh.axis_names[0] == "dcn"
        ndev = jmesh if isinstance(jmesh, int) else jmesh.devices.size
        dims = (None if isinstance(jmesh, int)
                else tuple(jmesh.devices.shape))
        for shape, batch in (((64, 64, 32), None), ((32, 48, 64), 2)):
            cands = jt.enumerate_candidates(
                shape, ndev, mesh_dims=dims, hybrid=hybrid, batch=batch,
                executors=["xla", "xla_minor", "matmul"],
                wire_dtypes=(None, "bf16", "int8"),
                mm_tiers=(None, "bf16"))
            for c in cands:
                want = jt.model_cost(c, shape, jmesh, batch=batch,
                                     corrected=False)
                mine = tuner.Candidate(*_port_cand(c))
                got = tuner.model_cost(mine, shape, pworld, batch=batch,
                                       corrected=False)
                assert math.isclose(got, want, rel_tol=1e-12), (c, got, want)
                n += 1
    assert n > 200


def test_cuda_family_priced_by_the_hbm_roofline(same_constants):
    """The deliberate difference: ``cuda`` (its kernels are radix FFTs)
    costs what ``torch`` costs, where JAX prices ``pallas`` at the matmul
    tier's rate; ``cuda:fuse`` takes the fused stage's discount."""
    shape = (64, 64, 64)
    base = tuner.Candidate("slab", "alltoall", "torch", 1, "int8")
    for ex in ("cuda", "cuda:bf16", "cuda:f32"):
        assert tuner.mm_tier_tflops(ex) is None
        c = tuner.Candidate("slab", "alltoall", ex, 1, "int8")
        assert tuner.model_cost(c, shape, 4) == tuner.model_cost(
            base, shape, 4)
    assert tuner.mm_tier_tflops("matmul:f32") == 200.0
    fused = tuner.Candidate("slab", "alltoall", "cuda:fuse", 1, "int8")
    assert tuner.model_cost(fused, shape, 4) < tuner.model_cost(
        base, shape, 4)


@pytest.mark.parametrize("kw", [
    dict(wire_bytes_per_dev=3e6, parts=4, algorithm="alltoall"),
    dict(wire_bytes_per_dev=3e6, parts=4, algorithm="ppermute",
         overlap_chunks=4, hide_seconds=1e-4),
    dict(wire_bytes_per_dev=1e5, parts=8, algorithm="alltoallv",
         overlap_chunks=2, hide_seconds=1.0, batch=3),
    dict(wire_bytes_per_dev=5e7, parts=2, algorithm="hierarchical",
         overlap_chunks=8)])
def test_exchange_model_seconds_matches_jax(kw):
    from distributedfft_tpu.parallel.exchange import exchange_model_seconds

    kw = dict(kw, wire_gbps=45.0, launch_seconds=1e-4)
    assert tex.exchange_model_seconds(**kw) == exchange_model_seconds(**kw)


def test_mm_dft_flops_matches_jax():
    from distributedfft_tpu.plan_logic import mm_dft_flops

    for shape, axes in (((8, 16, 32), None), ((64, 64, 64), (1,)),
                        ((5, 7, 9), (0, 2))):
        assert tpl.mm_dft_flops(shape, axes) == mm_dft_flops(shape, axes)


def test_reduced_tiers_and_roundtrip_errors():
    from distributedfft_tpu.ops import executors as jex

    from distributedfft_tpu_torch.ops import executors as tx

    assert tx.REDUCED_TIERS == jex.REDUCED_TIERS
    for name in ("torch", "matmul", "matmul:highest", "cuda:gauss"):
        assert tx.executor_roundtrip_error(name, np.complex64) == 0.0
    for name in ("matmul:bf16", "matmul:f32", "cuda:bf16"):
        # on the CPU every tier is the full-precision product, as on
        # JAX's CPU backend: the round trip's own rounding only
        err = tx.executor_roundtrip_error(name, "complex64", device="cpu")
        assert 0.0 < err < 1e-5
        assert tx.executor_roundtrip_error(name, torch.complex64,
                                           device="cpu") == err
    assert tx.executor_roundtrip_error("matmul:bf16", np.complex128,
                                       device="cpu") < 1e-13


# ------------------------------------------------------- winner picking

@pytest.mark.parametrize("times", [
    [[2.0, 1.0], [1.0, 2.0]],
    [[0.001, 0.002], [np.inf, 0.002]],
    [[np.inf, 3.0, 1.0], [1.0, 1.0, np.nan]],
    [[np.inf], [np.inf]]])
def test_agree_winner_matches_jax(times):
    jt = _jt()
    names = [f"c{i}" for i in range(len(times[0]))]
    times = np.array(times)
    try:
        want = jt.agree_winner(times, names)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            tuner.agree_winner(times, names)
        assert str(mine.value) == str(e)
        return
    assert tuner.agree_winner(times, names) == want


def _simulated(mod, monkeypatch, fail_other=0):
    """Two simulated processes: both built everything; candidate
    ``fail_other`` failed timing on the other one."""
    calls = []
    monkeypatch.setattr(mod, "_process_count", lambda *a, **k: 2)

    def gather(vec, *a, **k):
        calls.append(np.array(vec))
        if len(calls) == 1:
            return np.stack([vec, vec])
        other = np.array(vec)
        other[fail_other] = np.inf
        return np.stack([vec, other])

    monkeypatch.setattr(mod, "_allgather_rows", gather)
    return calls


def test_measured_select_multiprocess_matches_jax(monkeypatch):
    local = {"quick": 0.001, "steady": 0.002, "slow": 0.003}
    out = []
    for mod in (_jt(), tuner):
        monkeypatch.setenv("DFFT_NO_COMPILE_CACHE", "1")
        calls = _simulated(mod, monkeypatch)
        winner, built, times = mod.measured_select(
            list(local), build=lambda nm: nm, measure=lambda nm: local[nm])
        out.append((winner, built, times, len(calls)))
    assert out[0] == out[1]
    assert out[1][0] == "steady" and out[1][3] == 2


def test_measured_select_skips_failed_builds_as_jax(monkeypatch):
    monkeypatch.setenv("DFFT_NO_COMPILE_CACHE", "1")

    def build(nm):
        if nm == "broken":
            raise RuntimeError("no such executor")
        return nm

    for mod in (_jt(), tuner):
        winner, built, _ = mod.measured_select(
            ["broken", "ok"], build=build, measure=lambda nm: 1.0)
        assert winner == "ok" and "broken" not in built
    msgs = []
    for mod in (_jt(), tuner):
        with pytest.raises(ValueError) as e:
            mod.measured_select(["a"], build=lambda nm: 1 / 0,
                                measure=lambda nm: 1.0, what="thing")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no thing succeeded" in msgs[1]
    with pytest.raises(ValueError, match="every thing failed timing"):
        tuner.measured_select(["a"], build=lambda nm: nm,
                              measure=lambda nm: 1 / 0, what="thing")


def test_measured_select_logs_and_counts_skipped_candidates(capsys):
    """A candidate that fails to build or to time is skipped as in the
    JAX package, and each skip is one stderr line with its exception and
    one ``tune_candidate_failures`` count by candidate and phase."""
    tm.metrics_reset()
    tm.enable_metrics()

    def build(nm):
        if nm == "broken":
            raise RuntimeError("kernel did not build")
        return nm

    def measure(nm):
        if nm == "sick":
            raise RuntimeError("launch failed")
        return 1.0

    try:
        winner, built, times = tuner.measured_select(
            ["broken", "sick", "ok"], build, measure, what="thing")
        assert winner == "ok" and "broken" not in built
        assert times == {"sick": math.inf, "ok": 1.0}
        err = capsys.readouterr().err
        assert ("tuner: thing broken skipped (build): RuntimeError: kernel "
                "did not build") in err
        assert ("tuner: thing sick skipped (measure): RuntimeError: launch "
                "failed") in err
        assert tm.counter_total("tune_candidate_failures") == 2
        assert set(tm.metrics_snapshot()["counters"][
            "tune_candidate_failures"]) == {
            "candidate=broken,phase=build", "candidate=sick,phase=measure"}
    finally:
        tm.enable_metrics(False)
        tm.metrics_reset()


def test_measured_select_records_spans_and_metrics():
    tm.metrics_reset()
    tm.enable_metrics()
    try:
        with tdfft.utils.trace.capture_events() as events:
            tuner.measured_select(["a", "b"], build=lambda nm: nm,
                                  measure={"a": 2.0, "b": 1.0}.__getitem__)
        names = [e[0] for e in events]
        assert names == ["tune_build_a", "tune_build_b", "tune_measure_a",
                         "tune_measure_b"]
        assert tm.counter_total("tune_timing_executions") == 2
        snap = tm.metrics_snapshot()["histograms"]
        assert set(snap["tune_build_seconds"]) == {"candidate=a",
                                                   "candidate=b"}
        assert snap["tune_measure_seconds"]["candidate=b"]["count"] == 1
    finally:
        tm.enable_metrics(False)
        tm.metrics_reset()


# --------------------------------------------------------------- wisdom

_LIBRARY = {"jax", "x64", "torch", "cuda"}


@pytest.mark.parametrize("over", [
    {}, dict(mesh_dims=(2, 4)), dict(batch=4, err_budget=1e-3),
    dict(layouts="a|b", mm_precision="bf16", direction=1),
    dict(dtype=np.complex128, kind="r2c")])
def test_wisdom_key_matches_jax_apart_from_the_library(over):
    jt = _jt()
    kw = dict(kind="c2c", shape=(16, 16, 16), dtype=np.complex64,
              direction=-1, ndev=8, mesh_dims=None, device_kind="cpu",
              platform="cpu")
    kw.update(over)
    want = {k: v for k, v in jt.wisdom_key(**kw).items()
            if k not in _LIBRARY}
    kw["dtype"] = TDT[kw["dtype"]]
    mine = tuner.wisdom_key(**kw)
    assert {k: v for k, v in mine.items() if k not in _LIBRARY} == want
    assert mine["torch"] == torch.__version__
    assert set(mine) == tuner._CURRENT_KEY_FIELDS


def _key(**over):
    kw = dict(kind="c2c", shape=(16, 16, 16), dtype=np.complex64,
              direction=-1, ndev=8, mesh_dims=None, device_kind="cpu",
              platform="cpu")
    kw.update(over)
    return tuner.wisdom_key(**kw)


def test_wisdom_key_isolation(tmp_path):
    path = str(tmp_path / "w.jsonl")
    tuner.record_wisdom(_key(), tuner.Candidate("slab", "alltoall", "torch",
                                                1), 0.001, path=path)
    assert tuner.lookup_wisdom(_key(), path) is not None
    for other in (_key(device_kind="NVIDIA H100 80GB HBM3"),
                  _key(mesh_dims=(2, 4)), _key(ndev=4),
                  _key(dtype=np.complex128), _key(direction=+1),
                  _key(shape=(16, 16, 8)), _key(kind="r2c"),
                  _key(err_budget=1e-2), _key(batch=2)):
        assert tuner.lookup_wisdom(other, path) is None


def test_wisdom_newest_entry_wins_as_jax(tmp_path):
    """The same two records through both stores: the newest wins, and
    the winner fields are the JAX entry's under the label map."""
    jt = _jt()
    out = []
    for mod, lab in ((jt, lambda e: e), (tuner, _port_ex)):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        key = {"k": 1}
        mod.record_wisdom(key, mod.Candidate("slab", "alltoall", lab("xla"),
                                             1), 0.001, path=path)
        mod.record_wisdom(key, mod.Candidate("pencil", "ppermute",
                                             lab("matmul"), 2, "bf16"),
                          0.0005, path=path, times={"a": 1.0, "b": math.inf})
        entry = mod.lookup_wisdom(key, path)
        out.append({k: entry[k] for k in ("winner", "seconds", "times",
                                           "compression_err")})
    assert out[0]["winner"] == out[1]["winner"]
    assert out[1]["winner"]["decomposition"] == "pencil"
    assert out[0]["times"] == out[1]["times"] == {"a": 1.0, "b": None}
    assert out[0]["seconds"] == out[1]["seconds"]
    assert out[1]["compression_err"] == tex.wire_roundtrip_error(
        "complex64", "bf16")


def test_corrupt_wisdom_lines_skipped(tmp_path, capsys):
    path = str(tmp_path / "w.jsonl")
    entry = tuner.record_wisdom(
        _key(), tuner.Candidate("slab", "alltoall", "torch", 1), 0.001,
        path=path)
    with open(path, "a") as f:
        f.write("not json at all\n")
        f.write(json.dumps({"schema": 1, "no_key": True}) + "\n")
        f.write(json.dumps(entry)[: len(json.dumps(entry)) // 2] + "\n")
    entries, dropped = tuner.load_wisdom(path)
    assert len(entries) == 1 and dropped == 3
    assert tuner.lookup_wisdom(_key(), path) is not None
    assert "skipped 3 malformed wisdom line" in capsys.readouterr().err
    jentries, jdropped = _jt().load_wisdom(path)
    assert (list(jentries), jdropped) == (list(entries), dropped)


def test_stale_wisdom_entries_counted(tmp_path, capsys):
    path = str(tmp_path / "w.jsonl")
    old = {k: v for k, v in _key().items() if k != "mm_precision"}
    tuner.record_wisdom(old, tuner.Candidate("slab", "alltoall", "torch", 1),
                        0.001, path=path)
    tuner.record_wisdom(_key(), tuner.Candidate("slab", "alltoall", "torch",
                                                1), 0.001, path=path)
    entries, _ = tuner.load_wisdom(path)
    assert tuner.stale_wisdom_entries(entries) == 1
    tuner.lookup_wisdom(_key(), path)
    assert "older key schema" in capsys.readouterr().err


def test_wisdom_store_missing_or_disabled(tmp_path, monkeypatch):
    assert tuner.load_wisdom(str(tmp_path / "absent.jsonl")) == ({}, 0)
    assert tuner.load_wisdom(None) == ({}, 0)
    for off in ("", "0"):
        monkeypatch.setenv("DFFT_WISDOM", off)
        assert tuner.default_wisdom_path() is None
        assert tuner.record_wisdom(_key(), tuner.Candidate(
            "slab", "alltoall", "torch", 1), 1.0) is None
    monkeypatch.delenv("DFFT_WISDOM", raising=False)
    monkeypatch.setenv("DFFT_COMPILE_CACHE", str(tmp_path / "cc"))
    assert tuner.default_wisdom_path() == str(tmp_path / "cc" /
                                              "wisdom.jsonl")


def test_robust_stats_matches_jax():
    from distributedfft_tpu.regress import robust_stats

    for vals in ([], [1.0], [3.0, 1.0], [5.0, 1.0, 2.0, 8.0, 2.5],
                 [1.0, 1.0, 1.0, 40.0]):
        np.testing.assert_array_equal(tuner.robust_stats(vals),
                                      robust_stats(vals))


# ---------------------------------------------- tuned planning, loopback

def _ranked_measure(mod, monkeypatch, order):
    """Stub each tournament's measurement in ``mod``: a candidate's time
    is its rank in ``order(label)`` (no clock). The builds are kept."""
    orig = mod.measured_select

    def select(names, build, measure, **kw):
        ids = {}

        def build2(nm):
            obj = build(nm)
            ids[id(obj)] = nm
            return obj

        def measure2(obj):
            return order(ids[id(obj)])

        return orig(names, build2, measure2, **kw)

    monkeypatch.setattr(mod, "measured_select", select)


def _stable_order(label: str) -> float:
    """A deterministic ranking of a (port-spelled) label, independent of
    the clock: a hash of the label mapped into [1, 2) seconds."""
    h = int.from_bytes(label.encode(), "little") % 1000003
    return 1.0 + h / 1000003.0


def _port_label(jlabel: str) -> str:
    d, a, ex, rest = jlabel.split("/", 3)
    return "/".join([d, a, _port_ex(ex), rest])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_tuned_c2c_picks_the_jax_winner(dtype, store, same_constants,
                                        monkeypatch):
    """The same stubbed ranking gives both packages' tournaments the same
    winning label; the port's tuned plan agrees with the JAX plan within
    the tier; a second call replays wisdom with no timing execution."""
    import distributedfft_tpu as jdfft

    jt = _jt()
    monkeypatch.setenv("DFFT_TUNE_MAX", "6")
    _ranked_measure(jt, monkeypatch, lambda lb: _stable_order(
        _port_label(lb)))
    _ranked_measure(tuner, monkeypatch, _stable_order)
    shape = (16, 12, 8)
    monkeypatch.setenv("DFFT_WISDOM", store + ".jax")
    jplan = jdfft.plan_dft_c2c_3d(shape, 4, dtype=dtype, tune="measure")
    monkeypatch.setenv("DFFT_WISDOM", store)
    plan = tdfft.plan_dft_c2c_3d(shape, 4, dtype=TDT[dtype], tune="measure",
                                 **CPU)
    assert tuner.tuned_label(plan) == _port_label(jt.tuned_label(jplan))
    assert tm.counter_total("tune_tournaments") == 1
    assert tm.counter_total("tune_timing_executions") >= 2
    x = _x(shape, dtype)
    want = np.asarray(jplan(x))
    assert _rel(plan(torch.from_numpy(x)).numpy(), want) <= TIER[dtype]
    tdfft.clear_plan_cache()
    tm.metrics_reset()
    again = tdfft.plan_dft_c2c_3d(shape, 4, dtype=TDT[dtype], tune="wisdom",
                                  **CPU)
    assert tm.counter_total("tune_timing_executions") == 0
    assert tm.counter_total("tune_wisdom_hits") == 1
    assert tuner.tuned_label(again) == tuner.tuned_label(plan)
    assert torch.equal(again(torch.from_numpy(x)), plan(torch.from_numpy(x)))


def test_tuned_r2c_under_a_budget_picks_the_jax_winner(store, same_constants,
                                                       monkeypatch):
    """A budgeted R2C tournament on a fixed slab world (compressed wires
    and reduced tiers admitted): the same winner as JAX's, its output
    within the winner's own error of the JAX plan, the recorded entry
    carrying the wire's error."""
    import distributedfft_tpu as jdfft

    jt = _jt()
    monkeypatch.setenv("DFFT_TUNE_MAX", "10")
    _ranked_measure(jt, monkeypatch, lambda lb: _stable_order(
        _port_label(lb)))
    _ranked_measure(tuner, monkeypatch, _stable_order)
    shape = (8, 8, 16)
    monkeypatch.setenv("DFFT_WISDOM", store + ".jax")
    jplan = jdfft.plan_dft_r2c_3d(shape, jdfft.make_mesh(4), tune="measure",
                                  max_roundtrip_err=1e-2, dtype=np.complex64)
    monkeypatch.setenv("DFFT_WISDOM", store)
    plan = tdfft.plan_dft_r2c_3d(shape, tdfft.make_world(4), tune="measure",
                                 max_roundtrip_err=1e-2, **CPU)
    label = tuner.tuned_label(plan)
    assert label == _port_label(jt.tuned_label(jplan))
    assert plan.decomposition == "slab"
    x = _x(shape, np.float32)
    want = np.fft.rfftn(x.astype(np.float64))
    err = _rel(plan(torch.from_numpy(x)).numpy(), want)
    jerr = _rel(np.asarray(jplan(x)), want)
    assert err <= 1.1 * jerr + 5e-4
    entries, _ = tuner.load_wisdom(store)
    (entry,) = entries.values()
    assert entry["key"]["err_budget"] == 1e-2
    if entry["winner"]["wire_dtype"]:
        assert entry["compression_err"] == tex.wire_roundtrip_error(
            "complex64", entry["winner"]["wire_dtype"])


def test_wisdom_mode_never_measures(store):
    plan = tdfft.plan_dft_c2c_3d((16, 16, 16), 4, tune="wisdom", **CPU)
    assert tm.counter_total("tune_timing_executions") == 0
    assert tm.counter_total("tune_tournaments") == 0
    assert tm.counter_total("tune_wisdom_misses") == 1
    assert plan.decomposition == "slab" and plan.executor == "cuda"


def test_single_device_tune_short_circuits(store):
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), None, tune="measure", **CPU)
    assert plan.decomposition == "single"
    assert tm.counter_total("tune_tournaments") == 0
    assert tuner.load_wisdom(store)[0] == {}


def test_measure_honors_donate_by_rebuilding(store, monkeypatch):
    monkeypatch.setenv("DFFT_TUNE_MAX", "1")
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 4, tune="measure", donate=True,
                                 **CPU)
    assert plan.options.donate is True and plan.donate is True
    x = _x((8, 8, 8), np.complex64)
    y = plan(tdfft.alloc_local(plan, fill=x))
    assert _rel(y.numpy(), np.fft.fftn(x)) < 5e-4


def test_reduced_winner_replays_exact_without_a_budget(store, monkeypatch):
    """A stored compressed, reduced-tier, fused winner replays as is under
    a budget that admits its errors, and exact (bare, unfused label,
    exact wire) without one, as in the JAX package."""
    shape = (16, 16, 8)
    key = tuner.wisdom_key(kind="c2c", shape=shape, dtype=torch.complex64,
                           direction=-1, ndev=4, err_budget=1e-2)
    win = tuner.Candidate("slab", "ppermute", "cuda:f32:fuse", 1, "bf16")
    entry = tuner.record_wisdom(key, win, 1e-3, device="cpu")
    assert tuner._replay_candidate(entry, torch.complex64, 1e-2) == win
    exact = tuner._replay_candidate(entry, torch.complex64, None)
    assert exact == tuner.Candidate("slab", "ppermute", "cuda", 1, None)
    plan = tdfft.plan_dft_c2c_3d(shape, 4, tune="wisdom",
                                 max_roundtrip_err=1e-2, **CPU)
    assert tuner.tuned_label(plan) == win.label
    assert tm.counter_total("tune_wisdom_hits") == 1


def test_tune_concurrent_width_replays_from_wisdom(store, monkeypatch):
    monkeypatch.setenv("DFFT_WIDTH_TOURNAMENT", "1x1")
    plans = [tdfft.plan_dft_c2c_3d((8, 8, 8), 2, **CPU)] * 2
    _ranked_measure(tuner, monkeypatch, lambda nm: {"w1": 2.0,
                                                   "w2": 1.0}[nm])
    assert tuner.tune_concurrent_width(plans, [1, 1]) == 2
    tm.metrics_reset()
    assert tuner.tune_concurrent_width(plans, [1, 1]) == 2
    assert tm.counter_total("tune_timing_executions") == 0
    key = tuner.concurrent_width_key(plans, [1, 1])
    assert key["tuple"] == ["8x8x8:complex64:d-1:b1"] * 2
    monkeypatch.delenv("DFFT_WIDTH_TOURNAMENT")
    assert tuner.tune_concurrent_width(plans, [1, 1]) is None


# ---------------------------------------------------------- plan cache

#: Every environment variable the port's planning reads (the defaults of
#: overlap_chunks, wire_dtype, fuse and the matmul tiers; auto; tuned
#: planning, its store, home, budget, cap, profile and corrections).
PLAN_AFFECTING = {
    "DFFT_OVERLAP", "DFFT_WIRE_DTYPE", "DFFT_FUSE", "DFFT_MM_PRECISION",
    "DFFT_MM_COMPLEX", "DFFT_AUTO_EXECUTORS", "DFFT_TUNE", "DFFT_WISDOM",
    "DFFT_COMPILE_CACHE", "DFFT_TUNE_ITERS", "DFFT_TUNE_MAX",
    "DFFT_HW_PROFILE", "DFFT_TUNE_CORRECTION",
}


def _plan_env_knobs_literal() -> set:
    with open(os.path.join(REPO, "distributedfft_tpu_torch", "api.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_PLAN_ENV_KNOBS"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError("api._PLAN_ENV_KNOBS not found")


def _package_knobs() -> set:
    knobs = set()
    pkg = os.path.join(REPO, "distributedfft_tpu_torch")
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    knobs |= set(re.findall(r'"(DFFT_[A-Z0-9_]+)"',
                                            f.read()))
    return knobs


def test_plan_affecting_knobs_are_plan_cache_keyed():
    keyed = _plan_env_knobs_literal()
    missing = PLAN_AFFECTING - keyed
    assert not missing, f"not in api._PLAN_ENV_KNOBS: {sorted(missing)}"
    unknown = keyed - _package_knobs()
    assert not unknown, f"keyed knobs nothing reads: {sorted(unknown)}"
    from distributedfft_tpu.api import _PLAN_ENV_KNOBS as jax_knobs

    # the JAX key's tuned-planning and default knobs, all keyed here
    assert {k for k in jax_knobs if k in PLAN_AFFECTING} <= keyed


def test_a_changed_knob_misses_the_plan_cache(monkeypatch):
    tdfft.clear_plan_cache()
    monkeypatch.delenv("DFFT_WIRE_DTYPE", raising=False)
    a = tdfft.plan_dft_c2c_3d((8, 8, 8), 2, **CPU)
    assert tdfft.plan_dft_c2c_3d((8, 8, 8), 2, **CPU) is a
    monkeypatch.setenv("DFFT_WIRE_DTYPE", "bf16")
    b = tdfft.plan_dft_c2c_3d((8, 8, 8), 2, **CPU)
    assert b is not a and b.wire_dtype == "bf16"
    monkeypatch.setenv("DFFT_TUNE_MAX", "3")
    assert tdfft.plan_dft_c2c_3d((8, 8, 8), 2, **CPU) is not b
    tdfft.clear_plan_cache()


# ------------------------------------------------------- process groups

def _select_rank(rank, size, init, out_dir):
    """One gloo rank: a tournament of three candidates where rank 1
    cannot build ``b``; every rank records what it timed and won."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=size)
    try:
        timed = []

        def build(nm):
            if nm == "b" and rank == 1:
                raise RuntimeError("cannot build b here")
            return nm

        def measure(nm):
            timed.append(nm)
            # b would win on either clock; c beats a on rank 0's only
            return {"a": 2.0, "b": 0.5, "c": 1.0 if rank == 0 else 3.0}[nm]

        world = tdfft.process_group_world()
        winner, built, times = tuner.measured_select(
            ["a", "b", "c"], build, measure, group=world.group)
        plan = tdfft.plan_dft_c2c_3d((8, 8, 8), world, device="cpu",
                                     executor="auto")
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump(dict(winner=winner, built=sorted(built), timed=timed,
                           auto=plan.executor), f)
    finally:
        dist.destroy_process_group()


def test_measured_select_agrees_across_gloo_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("DFFT_TUNE_ITERS", "1x1")
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "torch,matmul")
    init = f"file://{tmp_path / 'store'}"
    mp.start_processes(_select_rank, args=(2, init, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    r0, r1 = (json.load(open(tmp_path / f"r{r}.json")) for r in (0, 1))
    assert r0["winner"] == r1["winner"] == "c"
    assert r0["timed"] == r1["timed"] == ["a", "c"]
    assert r0["built"] == ["a", "b", "c"] and r1["built"] == ["a", "c"]
    assert r0["auto"] == r1["auto"] in ("torch", "matmul")
