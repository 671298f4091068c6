"""The port's calibrated hardware profile
(``distributedfft_tpu_torch/calibrate.py``) against the JAX package's
(``distributedfft_tpu/calibrate.py``), and the port's timing and cache
helpers.

- Profile I/O: ``default_profile_path`` under the same environment,
  ``load_profile`` leniency, ``matching_profile`` by identity
  (``("cpu", "cpu")`` on both sides here), and ``update_model_correction``
  / ``model_correction`` on the same profile documents give the JAX
  documents and factors (time stamps apart).
- ``calibrate(device="cpu")`` on the CPU at small sizes (without
  ``device=`` it measures the card, and raises without one): every field, the wire, DCN
  and fuse fields null (one process, off the card), the matmul tiers
  measured one by one (``mm_highest_tflops`` is the port's own field),
  corrections carried over; ``format_profile`` renders each field.
- ``time_fn_amortized`` / ``sync`` and ``compile_cache_dir``.
"""

import json
import math
import os

import pytest
import torch

from distributedfft_tpu_torch import calibrate as tc
from distributedfft_tpu_torch import tuner
from distributedfft_tpu_torch.utils import cache, timing


def _jc():
    from distributedfft_tpu import calibrate as jc

    return jc


@pytest.fixture
def small(monkeypatch):
    """CPU-sized microbenchmarks."""
    monkeypatch.setattr(tc, "_HBM_BYTES", 1 << 20)
    monkeypatch.setattr(tc, "_MM_N", 64)


@pytest.mark.parametrize("env", [None, "", "0", " 0 ", "/some/where.json"])
def test_default_profile_path_matches_jax(env, monkeypatch, tmp_path):
    monkeypatch.setenv("DFFT_COMPILE_CACHE", str(tmp_path / "cc"))
    if env is None:
        monkeypatch.delenv("DFFT_HW_PROFILE", raising=False)
    else:
        monkeypatch.setenv("DFFT_HW_PROFILE", env)
    assert tc.default_profile_path() == _jc().default_profile_path()


def test_compile_cache_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("DFFT_COMPILE_CACHE", str(tmp_path / "cc"))
    assert cache.compile_cache_dir() == str(tmp_path / "cc")
    monkeypatch.delenv("DFFT_COMPILE_CACHE")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert cache.compile_cache_dir() == str(tmp_path / "dfft_torch_cache")
    from distributedfft_tpu.utils.cache import compile_cache_dir

    assert cache.compile_cache_dir() != compile_cache_dir()


@pytest.mark.parametrize("text", [None, "not json", "[1, 2]", "{}",
                                  '{"device_kind": "cpu", "platform": "cpu",'
                                  ' "hbm_gbps": 5.0}'])
def test_load_and_matching_profile_match_jax(text, tmp_path):
    path = str(tmp_path / "hw.json")
    if text is not None:
        with open(path, "w") as f:
            f.write(text)
    jc = _jc()
    assert tc.load_profile(path) == jc.load_profile(path)
    assert tc.matching_profile(path) == jc.matching_profile(path)


def test_identity_is_the_jax_cpu_identity():
    assert tc._current_identity() == _jc()._current_identity() == (
        "cpu", "cpu")


DOCS = [
    None,
    {"schema": 1, "device_kind": "cpu", "platform": "cpu",
     "hbm_gbps": 12.5},
    {"schema": 1, "device_kind": "cpu", "platform": "cpu",
     "model_correction": {"alltoall": 2.0, "ppermute": 0.5}},
    {"schema": 1, "device_kind": "TPU v5 lite", "platform": "tpu",
     "model_correction": {"alltoall": 3.0}},
]


@pytest.mark.parametrize("doc", DOCS)
@pytest.mark.parametrize("ratios", [
    {"alltoall": 4.0}, {"alltoall": 1.5, "ppermute": 30.0},
    {"alltoallv": -1.0, "x": math.nan}, {}])
def test_model_correction_matches_jax(doc, ratios, tmp_path):
    """The same profile document and ratios through both packages: the
    same merged document (time stamps apart) and the same clamped
    factor per transport."""
    jc = _jc()
    docs = []
    for mod, name in ((jc, "jax.json"), (tc, "port.json")):
        path = str(tmp_path / name)
        if doc is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        got = mod.update_model_correction(ratios, path)
        factors = {a: mod.model_correction(a, path)
                   for a in ("alltoall", "alltoallv", "ppermute", "x")}
        stored = mod.load_profile(path)
        for d in (got, stored):
            if d is not None:
                d.pop("correction_updated_at", None)
        docs.append((got, stored, factors))
    assert docs[0] == docs[1]


def test_write_profile_replaces_atomically(tmp_path, monkeypatch):
    path = str(tmp_path / "sub" / "hw.json")
    monkeypatch.setenv("DFFT_HW_PROFILE", path)
    assert tc.write_profile({"a": 1}) == path
    assert tc.write_profile({"b": 2}) == path
    assert tc.load_profile() == {"b": 2}
    assert os.listdir(tmp_path / "sub") == ["hw.json"]
    monkeypatch.setenv("DFFT_HW_PROFILE", "0")
    assert tc.write_profile({"c": 3}) is None
    assert tc.update_model_correction({"alltoall": 2.0}) is None
    assert tc.model_correction("alltoall") == 1.0


FIELDS = {"schema", "recorded_at", "device_kind", "platform", "ndev",
          "torch", "cuda", "hbm_gbps", "peak_tflops", "wire_gbps",
          "launch_seconds", "fuse_speedup", "mm_bf16_tflops",
          "mm_f32_tflops", "mm_highest_tflops", "ici_gbps", "dcn_gbps"}


def test_calibrate_on_the_cpu(small, tmp_path, monkeypatch):
    path = str(tmp_path / "hw.json")
    monkeypatch.setenv("DFFT_HW_PROFILE", path)
    tc.update_model_correction({"alltoall": 2.0})
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.calibrate(iters=1)
    prof = tc.calibrate(iters=2, device="cpu")
    assert set(prof) == FIELDS | {"model_correction"}
    assert prof["model_correction"] == {"alltoall": 2.0}
    assert (prof["device_kind"], prof["platform"], prof["ndev"]) == (
        "cpu", "cpu", 1)
    for f in ("hbm_gbps", "peak_tflops", "launch_seconds",
              "mm_bf16_tflops", "mm_f32_tflops", "mm_highest_tflops"):
        assert isinstance(prof[f], float) and prof[f] > 0, f
    for f in ("wire_gbps", "fuse_speedup", "ici_gbps", "dcn_gbps"):
        assert prof[f] is None, f
    assert tc.calibrate(iters=1, wire=False,
                        device="cpu")["wire_gbps"] is None
    tc.write_profile(prof)
    assert tc.matching_profile() == prof
    text = tc.format_profile(prof)
    for word in ("hbm bandwidth", "matmul highest", "fuse speedup",
                 "one process: not measurable", "model correction: "
                 "alltoall=2x"):
        assert word in text
    # the tuner prices each tier at the profile's measured rate
    assert tuner.mm_tier_tflops("matmul") == prof["mm_highest_tflops"]
    assert tuner.mm_tier_tflops("matmul:bf16") == prof["mm_bf16_tflops"]
    assert tuner.mm_tier_tflops("matmul:f32") == prof["mm_f32_tflops"]


def test_highest_tier_derived_without_its_field(tmp_path, monkeypatch):
    """A profile without ``mm_highest_tflops`` (a JAX-style profile)
    prices ``highest`` at half the ``f32`` rate, as the JAX package."""
    path = str(tmp_path / "hw.json")
    monkeypatch.setenv("DFFT_HW_PROFILE", path)
    tc.write_profile({"device_kind": "cpu", "platform": "cpu",
                      "mm_f32_tflops": 10.0, "mm_bf16_tflops": 30.0})
    assert tuner.mm_tier_tflops("matmul") == 5.0
    assert tuner.mm_tier_tflops("matmul:bf16") == 30.0
    assert tuner.mm_tier_tflops("torch") is None


def test_a_failing_benchmark_nulls_its_field(small, monkeypatch, tmp_path):
    monkeypatch.setenv("DFFT_HW_PROFILE", str(tmp_path / "hw.json"))

    def boom(iters, device=None):
        raise RuntimeError("sick")

    monkeypatch.setattr(tc, "_measure_hbm_gbps", boom)
    monkeypatch.setattr(tc, "_measure_mm_tier_tflops", boom)
    prof = tc.calibrate(iters=1, device="cpu")
    assert prof["hbm_gbps"] is None and prof["mm_highest_tflops"] is None
    assert prof["peak_tflops"] > 0


def test_size_check_reports_both_sizes(monkeypatch):
    """``size_check`` times the JAX package's sizes (its 64 MiB block and
    n = 1024) against 1 GiB and n = 8192, and keeps a small size only
    where every rate holds within 10% of the large size's."""
    jc = _jc()
    assert (tc._JAX_HBM_BYTES, tc._JAX_MM_N) == (jc._HBM_BYTES, jc._MM_N)
    seen = []
    hbm = {tc._JAX_HBM_BYTES: 2700.0, 1 << 30: 3000.0}
    monkeypatch.setattr(tc, "_measure_hbm_gbps",
                        lambda iters, nbytes, device=None:
                        seen.append(nbytes) or hbm[nbytes])
    mm = {1024: 1.0, 8192: 2.0}
    monkeypatch.setattr(tc, "_mm_tflops",
                        lambda iters, product, dtype=None, n=None,
                        device=None: seen.append(n) or mm[n])
    out = tc.size_check(1, device="cpu")
    assert seen == [tc._JAX_HBM_BYTES, 1 << 30] + [1024] * 4 + [8192] * 4
    assert out["hbm_gbps"] == {str(tc._JAX_HBM_BYTES): 2700.0,
                               str(1 << 30): 3000.0}
    assert out["mm_tflops"]["1024"] == {"bf16": 1.0, "f32": 1.0,
                                        "highest": 1.0, "peak": 1.0}
    assert out["hbm_share"] == pytest.approx(0.9)
    assert out["mm_share"] == {"bf16": 0.5, "f32": 0.5, "highest": 0.5,
                               "peak": 0.5}
    assert out["keep_jax_hbm"] and not out["keep_jax_mm"]
    hbm[tc._JAX_HBM_BYTES] = 2600.0
    assert not tc.size_check(1, device="cpu")["keep_jax_hbm"]


def test_time_fn_amortized_counts_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    t, out = timing.time_fn_amortized(fn, torch.zeros(4), iters=3,
                                      repeats=2)
    assert len(calls) == 1 + 3 * 2 and t >= 0.0
    assert torch.equal(out, torch.ones(4))
    timing.sync([torch.zeros(2), (torch.zeros(1),)])
    timing.sync(None)
