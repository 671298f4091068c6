"""``executor="auto"`` in the port against the JAX package's
(``tests/test_auto_executor.py``): plan every executor of
``_AUTO_CANDIDATES`` (``DFFT_AUTO_EXECUTORS``), time each, keep the
fastest: the reference's plan-and-pick (``setFFTPlans``,
``fft_mpi_3d_api.cpp:318-429``).

Seeded inputs through the port's ``auto`` plans on loopback worlds and
the JAX plans on the 8-device CPU mesh: outputs within the tiers of
``distributedfft_tpu/testing.py`` (c64 5e-4, c128 1e-11). Where a test
asserts which executor wins, the measurement is stubbed: the clock never
decides a test.
"""

import numpy as np
import pytest
import torch

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import api as tapi
from distributedfft_tpu_torch import operators as top
from distributedfft_tpu_torch import tuner
from distributedfft_tpu_torch.utils import timing

CPU = dict(device="cpu")
TIER = {np.complex64: 5e-4, np.complex128: 1e-11}
TDT = {np.complex64: torch.complex64, np.complex128: torch.complex128}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DFFT_TUNE_ITERS", "1x1")
    monkeypatch.delenv("DFFT_AUTO_EXECUTORS", raising=False)
    tdfft.clear_plan_cache()
    yield
    tdfft.clear_plan_cache()


def _x(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    if dtype in (np.float32, np.float64):
        return rng.standard_normal(shape).astype(dtype)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def _rank_executors(monkeypatch, times: dict):
    """Stub the amortised timing: each plan's time is ``times`` of its
    executor (no clock)."""
    def fake(fn, *args, iters=10, repeats=3):
        return times[fn.executor], None

    monkeypatch.setattr(timing, "time_fn_amortized", fake)


def test_auto_candidates_are_the_jax_menu():
    from distributedfft_tpu.api import _AUTO_CANDIDATES as jax_menu

    port = {"xla": "torch", "xla_minor": "torch_minor", "pallas": "cuda",
            "matmul": "matmul"}
    assert tapi._AUTO_CANDIDATES == tuple(port[e] for e in jax_menu)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("world", [None, 4, (2, 2)])
def test_auto_picks_a_candidate_and_matches_jax(dtype, world):
    import distributedfft_tpu as jdfft

    shape = (16, 12, 8)
    plan = tdfft.plan_dft_c2c_3d(shape, world, executor="auto",
                                 dtype=TDT[dtype], **CPU)
    assert plan.executor in tapi._AUTO_CANDIDATES
    jmesh = None if world is None else jdfft.make_mesh(world)
    jplan = jdfft.plan_dft_c2c_3d(shape, jmesh, executor="xla", dtype=dtype)
    x = _x(shape, dtype)
    assert _rel(plan(torch.from_numpy(x)).numpy(),
                np.asarray(jplan(x))) <= TIER[dtype]


def test_auto_keeps_the_fastest(monkeypatch):
    _rank_executors(monkeypatch, {"torch": 3.0, "torch_minor": 2.0,
                                  "cuda": 4.0, "matmul": 1.0})
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 4, executor="auto", **CPU)
    assert plan.executor == "matmul"
    _rank_executors(monkeypatch, {"torch": 3.0, "torch_minor": 0.5,
                                  "cuda": 4.0, "matmul": 1.0})
    tdfft.clear_plan_cache()
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 4, executor="auto", **CPU)
    assert plan.executor == "torch_minor"


def test_auto_respects_env_candidates(monkeypatch):
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "matmul")
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 4, executor="auto", **CPU)
    assert plan.executor == "matmul"


def test_auto_rejects_recursive_candidate(monkeypatch):
    """``auto`` in the candidate list cannot recurse."""
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "auto, torch")
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 4, executor="auto", **CPU)
    assert plan.executor == "torch"


def test_auto_skips_a_candidate_that_fails(monkeypatch):
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "nope, torch")
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 2, executor="auto", **CPU)
    assert plan.executor == "torch"
    monkeypatch.setenv("DFFT_AUTO_EXECUTORS", "nope")
    with pytest.raises(ValueError, match="no auto executor candidate"):
        tdfft.plan_dft_c2c_3d((8, 8, 16), 2, executor="auto", **CPU)


@pytest.mark.parametrize("world", [None, 4])
def test_auto_r2c_matches_jax(world):
    import distributedfft_tpu as jdfft

    shape = (8, 8, 16)
    plan = tdfft.plan_dft_r2c_3d(shape, world, executor="auto",
                                 dtype=torch.complex128, **CPU)
    x = _x(shape, np.float64)
    jmesh = None if world is None else jdfft.make_mesh(world)
    want = np.asarray(jdfft.plan_dft_r2c_3d(shape, jmesh)(x))
    assert _rel(plan(torch.from_numpy(x)).numpy(), want) <= 1e-11
    back = tdfft.plan_dft_c2r_3d(shape, world, executor="auto",
                                 dtype=torch.complex128, **CPU)
    assert _rel(back(plan(torch.from_numpy(x))).numpy(), x) <= 1e-11


def test_auto_with_donation_rebuilds_winner(monkeypatch):
    _rank_executors(monkeypatch, {"torch": 1.0, "torch_minor": 2.0,
                                  "cuda": 3.0, "matmul": 4.0})
    shape = (8, 8, 8)
    plan = tdfft.plan_dft_c2c_3d(shape, 4, executor="auto", donate=True,
                                 **CPU)
    assert plan.options.donate is True and plan.executor == "torch"
    x = _x(shape, np.complex64)
    want = np.fft.fftn(x)
    y = plan(tdfft.alloc_local(plan, fill=x))     # may consume its input
    assert _rel(y.numpy(), want) <= 5e-4


def test_auto_op_plan_matches_jax():
    """The operator planner takes ``executor="auto"`` too."""
    import distributedfft_tpu as jdfft
    from distributedfft_tpu import operators as jop

    shape = (16, 16, 16)
    plan = top.plan_spectral_op(shape, 4, op=top.poisson(), executor="auto",
                                **CPU)
    assert plan.executor in tapi._AUTO_CANDIDATES
    x = _x(shape, np.complex64)
    want = np.asarray(jop.plan_spectral_op(shape, jdfft.make_mesh(4),
                                           op=jop.poisson(), executor="xla",
                                           dtype=np.complex64)(x))
    assert _rel(plan(torch.from_numpy(x)).numpy(), want) <= 5e-4


def test_torch_minor_matches_torch_and_jax_xla_minor():
    """The ``torch_minor`` executor (each axis moved last, transformed,
    moved back) gives ``torch``'s values, and the JAX ``xla_minor``
    executor's within the tier."""
    from distributedfft_tpu.ops import executors as jex

    from distributedfft_tpu_torch.ops import executors as tex

    x = _x((6, 10, 12), np.complex128)
    for axes in ((0, 1, 2), (1,), (0, 2), (2, 0)):
        for fwd in (True, False):
            got = tex.get_executor("torch_minor")(torch.from_numpy(x), axes,
                                                  fwd).numpy()
            ref = tex.get_executor("torch")(torch.from_numpy(x), axes,
                                            fwd).numpy()
            want = np.asarray(jex.get_executor("xla_minor")(x, axes, fwd))
            assert _rel(got, ref) <= 1e-14
            assert _rel(got, want) <= 1e-11


def test_auto_on_tuned_measure_path_is_not_consulted(monkeypatch, tmp_path):
    """A tuned plan's candidates carry their own executors: the base
    ``auto`` of the options is only the search's starting point."""
    monkeypatch.setenv("DFFT_WISDOM", str(tmp_path / "w.jsonl"))
    monkeypatch.setenv("DFFT_TUNE_MAX", "2")
    plan = tdfft.plan_dft_c2c_3d((8, 8, 8), 4, executor="auto",
                                 tune="measure", **CPU)
    assert plan.executor in ("torch", "torch_minor", "matmul")
    assert tuner.tuned_label(plan).startswith("slab/")
