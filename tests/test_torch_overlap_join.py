"""The port's overlap joins (``distributedfft_tpu_torch/monitor.py``:
``dispatch_spans``, ``realized_overlap``, ``overlap_from_events``,
``update_overlap_correction``) and explain's overlap block, against the
JAX package's (``distributedfft_tpu/monitor.py``).

- ``realized_overlap`` / ``overlap_from_events`` give JAX's joins on the
  same event lists (interleaved, back to back, one group, chunk
  suffixes under ``cc<j>:`` prefixes, empty).
- ``update_overlap_correction`` writes JAX's ratios into a profile of
  its own (each package at a temporary path), and refuses what JAX
  refuses.
- ``dispatch_spans`` of two 16^3 slab plans on a loopback world of 4
  holds both transforms' ``cc<j>:`` spans, interleaved (the schedule
  alternates their steps, so each transform's extent spans the other's
  dispatches); a single-device plan is refused. The port runs the merged
  program once where JAX evaluates it abstractly.
- ``dfft.explain`` fills ``record["overlap"]`` for ``concurrent=2`` and
  for a K = 2 plan, with the model's hide ratio on JAX's scale (equal to
  JAX's for the same plans and hardware numbers), gives None at K = 1
  without a cohort, and refuses ``concurrent`` of True or 1.
- Importing ``explain`` and ``monitor`` imports neither JAX nor the JAX
  package.

The assertions on measured ratios hold for any timing: they follow from
the dispatch order, not from the clock.
"""

import json

import pytest

import distributedfft_tpu_torch as tdfft
from distributedfft_tpu_torch import explain_mod as tex
from distributedfft_tpu_torch import monitor as tmon
from distributedfft_tpu_torch.testing import tree_mismatch

SHAPE = (16, 16, 16)
HW = {"device_kind": "cpu", "backend": "cpu", "peak_tflops": 100.0,
      "hbm_gbps": 800.0, "wire_gbps": 45.0, "dcn_gbps": 12.5,
      "launch_seconds": 1e-4, "source": "default"}


def _jmon():
    from distributedfft_tpu import monitor as jmon

    return jmon


def _jex():
    import distributedfft_tpu as jdfft

    return jdfft.explain_mod


EVENTS = {
    "interleaved": [("cc0:t0_fft", 0.0, 1.0), ("cc1:t0_fft", 0.5, 1.5)],
    "back_to_back": [("cc0:a", 0.0, 1.0), ("cc1:b", 1.5, 2.5)],
    "one_group": [("cc0:a", 0.0, 1.0)],
    "chunks": [("cc0:t2_exchange_slab[0]", 0.0, 1.0),
               ("cc0:t2_exchange_slab[1]", 0.5, 1.5),
               ("t3_fft_x", 2.0, 3.0)],
    "three_way": [("cc0:t0", 0.0, 1.0), ("cc1:t0", 0.2, 1.1),
                  ("cc2:t0", 0.4, 0.9), ("cc0:t2[0]", 1.0, 2.0),
                  ("cc1:t2[1]", 1.2, 2.5), ("other", 0.0, 9.0)],
    "zero_extent": [("cc0:a", 1.0, 1.0), ("cc1:b", 1.0, 1.0)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(EVENTS))
def test_overlap_from_events_matches_jax(case):
    ev = EVENTS[case]
    got, want = tmon.overlap_from_events(ev), _jmon().overlap_from_events(ev)
    assert tree_mismatch(got, want) is None


def test_realized_overlap_values():
    cc = tmon.overlap_from_events(EVENTS["interleaved"])
    assert cc["legs"] is None
    assert cc["concurrent"]["groups"] == 2
    assert cc["concurrent"]["hide_ratio"] == pytest.approx(0.25)
    assert tmon.overlap_from_events(
        EVENTS["back_to_back"])["concurrent"]["hide_ratio"] == 0.0
    legs = tmon.overlap_from_events(EVENTS["chunks"])["legs"]
    assert legs["groups"] == 2 and legs["hide_ratio"] == pytest.approx(0.25)
    assert tmon.realized_overlap([], lambda n: None) is None
    for events in (EVENTS["one_group"], EVENTS["zero_extent"]):
        for group_of in (lambda n: n[:3], lambda n: n):
            assert (tmon.realized_overlap(events, group_of)
                    == _jmon().realized_overlap(events, group_of))


BLOCKS = [
    None,
    {"kind": "concurrent"},
    {"kind": "concurrent", "measured_hide_ratio": 0.3,
     "model_hide_ratio": 0.0},
    {"kind": "warp", "measured_hide_ratio": 0.3, "model_hide_ratio": 0.5},
    {"kind": "concurrent", "measured_hide_ratio": 0.3,
     "model_hide_ratio": 0.5},
    {"kind": "overlap_k", "measured_hide_ratio": 0.1,
     "model_hide_ratio": 0.4},
]


def test_update_overlap_correction_matches_jax(tmp_path, monkeypatch):
    from distributedfft_tpu import calibrate as jcal

    from distributedfft_tpu_torch import calibrate as tcal

    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    for block in BLOCKS + BLOCKS[-2:]:      # the last two blend twice
        got = tmon.update_overlap_correction(block, tpath)
        want = _jmon().update_overlap_correction(block, jpath)
        assert (got is None) == (want is None), block
        if want is not None:
            assert tree_mismatch(got["model_correction"],
                                 want["model_correction"]) is None
    monkeypatch.setenv("DFFT_HW_PROFILE", tpath)
    t_leg = tcal.model_correction("leg_hide")
    monkeypatch.setenv("DFFT_HW_PROFILE", jpath)
    assert t_leg == pytest.approx(jcal.model_correction("leg_hide"))
    assert t_leg == pytest.approx(0.25)
    monkeypatch.setenv("DFFT_HW_PROFILE", "0")
    assert tmon.update_overlap_correction(BLOCKS[-1]) is None


def test_dispatch_spans_interleave_on_a_loopback_world():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu")
    spans = tmon.dispatch_spans([plan, plan])
    names = [n for n, _, _ in spans]
    assert any(n.startswith("cc0:") for n in names)
    assert any(n.startswith("cc1:") for n in names)
    at = {j: [i for i, n in enumerate(names) if n.startswith(f"cc{j}:")]
          for j in (0, 1)}
    first = {j: at[j][0] for j in (0, 1)}
    last = {j: at[j][-1] for j in (0, 1)}
    # the schedule alternates the two transforms' steps
    assert first[0] < first[1] < last[0] < last[1]
    cc = tmon.overlap_from_events(spans)["concurrent"]
    assert cc["groups"] == 2 and 0.0 < cc["hide_ratio"] < 1.0
    with pytest.raises(ValueError):
        tmon.dispatch_spans([tdfft.plan_dft_c2c_3d(SHAPE, None,
                                                   device="cpu")])


def test_dispatch_spans_chunk_suffixes_at_k2():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, overlap_chunks=2, device="cpu")
    spans = tmon.dispatch_spans([plan])
    legs = tmon.overlap_from_events(spans)["legs"]
    assert legs["groups"] == 2
    assert 0.0 <= legs["hide_ratio"] <= 1.0


def _jax_plan(**kw):
    import numpy as np

    import distributedfft_tpu as jdfft

    return jdfft.plan_dft_c2c_3d(SHAPE, jdfft.make_mesh(4),
                                 dtype=np.complex64, **kw)


def test_explain_measured_overlap_concurrent(monkeypatch):
    monkeypatch.setattr(tex, "device_profile", lambda: dict(HW))
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu")
    rec = tdfft.explain(plan, iters=2, concurrent=2)
    ov = rec["overlap"]
    assert ov["kind"] == "concurrent" and ov["cohort"] == 2
    assert ov["groups"] == 2 and 0.0 < ov["measured_hide_ratio"] < 1.0
    assert len(ov["measured_samples"]) == 2
    assert {"model_speedup", "divergence", "model_hide_seconds"} <= set(ov)
    json.dumps(rec)
    # the model side equals JAX's for the same plans and numbers
    jex = _jex()
    monkeypatch.setattr(jex, "device_profile", lambda: dict(HW))
    jov = jex.explain(_jax_plan(), measure=False, concurrent=2)["overlap"]
    for key in ("model_hide_seconds", "model_hide_ratio", "model_speedup"):
        assert tree_mismatch(ov[key], jov[key]) is None, key


def test_explain_measured_overlap_leg_pipeline(monkeypatch):
    monkeypatch.setattr(tex, "device_profile", lambda: dict(HW))
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, overlap_chunks=2, device="cpu")
    rec = tdfft.explain(plan, iters=2)
    ov = rec["overlap"]
    assert ov["kind"] == "overlap_k" and ov["cohort"] == 1
    assert ov["groups"] == 2
    assert 0.0 <= ov["measured_hide_ratio"] <= 1.0
    assert 0.0 <= ov["model_hide_ratio"] <= 1.0
    jex = _jex()
    monkeypatch.setattr(jex, "device_profile", lambda: dict(HW))
    jov = jex.explain(_jax_plan(overlap_chunks=2), measure=False)["overlap"]
    for key in ("model_hide_seconds", "model_hide_ratio"):
        assert tree_mismatch(ov[key], jov[key]) is None, key


def test_explain_overlap_without_measurement(monkeypatch):
    """``measure=False``: the model side only; the merged program is not
    run."""
    calls = []
    monkeypatch.setattr(tmon, "dispatch_spans",
                        lambda plans: calls.append(plans))
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu")
    ov = tdfft.explain(plan, measure=False, concurrent=2)["overlap"]
    assert calls == []
    assert ov["measured_hide_ratio"] is None and ov["measured_samples"] == []
    assert isinstance(ov["model_hide_ratio"], float)
    assert ov["divergence"]["diverged"] is None


def test_explain_overlap_disarmed_and_validation():
    plan = tdfft.plan_dft_c2c_3d(SHAPE, 4, device="cpu")
    assert tdfft.explain(plan, measure=False)["overlap"] is None
    with pytest.raises(ValueError):
        tdfft.explain(plan, measure=False, concurrent=True)
    with pytest.raises(ValueError):
        tdfft.explain(plan, measure=False, concurrent=1)
    single = tdfft.plan_dft_c2c_3d(SHAPE, None, device="cpu")
    assert tdfft.explain(single, measure=False, concurrent=2)[
        "overlap"] is None


def test_explain_tier_imports_no_jax():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import distributedfft_tpu_torch.explain\n"
            "import distributedfft_tpu_torch.monitor\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'distributedfft_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
