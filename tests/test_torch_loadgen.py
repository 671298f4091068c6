"""The port's load generator (``python -m
distributedfft_tpu_torch.loadgen``) held against ``tests/test_loadgen.py``
and the JAX package: ``build_schedule`` gives the JAX package's event
tuples for the same ``(seed, rank, knobs)``, ``parse_mix`` /
``parse_shapes`` parse alike, an in-process ``--worker --device cpu`` run
streams a series ``load_fleet`` reads, the default device raises without
a card, and the two-process run on the CPU gates 0 when healthy and 1
in the fault drill (``DFFT_FAULT_INJECT`` on rank 0 only, which wedges).
The monitor, fleet, load generator and debug modules import neither JAX
nor the JAX package.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from distributedfft_tpu import loadgen as jloadgen
from distributedfft_tpu_torch import loadgen
from distributedfft_tpu_torch.fleet import load_fleet
from distributedfft_tpu_torch.loadgen import (build_schedule, parse_mix,
                                              parse_shapes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = ["rt:3,bulk:1", "a:1,-:2,c:0.5"]


def _knobs(mod, mix, **kw):
    base = dict(seed=7, rank=0, duration_s=2.0, rate_hz=50.0,
                mix=mod.parse_mix(mix),
                shapes=mod.parse_shapes("8x8x8,16x8x4,256x256x128"),
                dtypes=["complex64", "complex128"], ops=["fft", "ifft"])
    base.update(kw)
    return base


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("mix", MIXES)
def test_schedule_equals_jax(seed, rank, mix):
    got = [e.astuple() for e in build_schedule(
        **_knobs(loadgen, mix, seed=seed, rank=rank))]
    want = [e.astuple() for e in jloadgen.build_schedule(
        **_knobs(jloadgen, mix, seed=seed, rank=rank))]
    assert got == want and len(got) > 0


def test_schedule_is_deterministic_per_seed_and_rank():
    a = [e.astuple() for e in build_schedule(**_knobs(loadgen, MIXES[0]))]
    assert a == [e.astuple() for e in build_schedule(
        **_knobs(loadgen, MIXES[0]))]
    assert a != [e.astuple() for e in build_schedule(
        **_knobs(loadgen, MIXES[0], seed=8))]
    assert a != [e.astuple() for e in build_schedule(
        **_knobs(loadgen, MIXES[0], rank=1))]


def test_schedule_open_loop_poisson_shape():
    evs = build_schedule(**_knobs(loadgen, MIXES[0], duration_s=4.0,
                                  rate_hz=100.0))
    ts = [e.t for e in evs]
    assert ts == sorted(ts) and 0.0 < ts[0] and ts[-1] < 4.0
    assert 250 < len(evs) < 600
    assert {e.tenant for e in evs} == {"rt", "bulk"}
    assert sum(1 for e in evs if e.tenant == "rt") > len(evs) / 2
    assert build_schedule(
        **_knobs(loadgen, MIXES[0], rate_hz=0.0)) == []
    assert build_schedule(**_knobs(loadgen, MIXES[0], duration_s=0.0)) == []


@pytest.mark.parametrize("raw", ["rt:3,bulk:1", "solo", "-", "", "rt:0",
                                 " a : 2 , - "])
def test_parse_mix_equals_jax(raw):
    try:
        want = jloadgen.parse_mix(raw)
    except ValueError as e:
        with pytest.raises(ValueError, match="weight"):
            parse_mix(raw)
        assert "weight" in str(e)
        return
    assert parse_mix(raw) == want


@pytest.mark.parametrize("raw", ["8x8x8, 16x8x4", "256x256x256", "8x0x8",
                                 "", "16x16"])
def test_parse_shapes_equals_jax(raw):
    try:
        want = jloadgen.parse_shapes(raw)
    except ValueError:
        with pytest.raises(ValueError):
            parse_shapes(raw)
        return
    assert parse_shapes(raw) == want


def test_defaults_match_jax():
    for name in ("DEFAULT_QOS", "DEFAULT_MIX", "DEFAULT_SHAPES"):
        assert getattr(loadgen, name) == getattr(jloadgen, name)
    assert loadgen.__all__ == jloadgen.__all__


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.main(["--procs", "1", "--dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.main(["--worker", "--duration", "0.1"])
    assert os.listdir(tmp_path) == []       # nothing was spawned


def test_worker_in_process_streams_series(tmp_path, monkeypatch, capsys):
    """One worker run inline on the CPU: a real queue, its monitor
    series in the fleet directory, its stats line on stdout."""
    from distributedfft_tpu_torch.utils import metrics

    monkeypatch.setenv("DFFT_MONITOR_DIR", str(tmp_path))
    monkeypatch.setenv("DFFT_MONITOR", "60")
    monkeypatch.setenv(
        "DFFT_QOS", "rt:class=realtime,weight=3,slo=5;bulk:class=batch")
    monkeypatch.delenv("DFFT_FAULT_INJECT", raising=False)
    try:
        rc = loadgen.main(["--worker", "--rank", "0", "--seed", "3",
                           "--duration", "0.3", "--rate", "40",
                           "--device", "cpu"])
        assert metrics.metrics_enabled()
    finally:
        metrics.metrics_reset()
        metrics.enable_metrics(False)
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and not stats["wedged"]
    assert stats["submitted"] > 0 and stats["shed"] == 0
    assert set(stats["launches"]) >= {"fft2_last", "fft_axis0", "fft_last"}
    assert stats["cases"] == []           # the plain versions launch nothing
    streams = load_fleet(str(tmp_path))
    assert len(streams) == 1
    newest = next(iter(streams.values()))[-1]
    assert newest["pid"] == os.getpid()
    tenants = newest["qos"]["tenants"]
    assert set(tenants) == {"rt", "bulk"}
    assert sum(t["submits"] for t in tenants.values()) == stats["submitted"]
    assert newest["queue"]["stalls_total"] == 0
    assert newest["queue"]["depth"] == 0
    assert newest["queue"]["waves"]["waves"] > 0   # flush mode, monitored
    assert sum(newest["metrics"]["counters"]["executes"].values()) > 0


@pytest.mark.parametrize("name,forward,normalize,want", [
    ("fft_last", True, False, ("fft_last", True, (8, 16))),
    ("fft_axis0", False, True, ("fft_axis0", False, (8, 16))),
    ("fft_axis0", False, False, ("fft_axis0", False, (8, 16),
                                 "unnormalized")),
])
def test_case_key_of_a_launch(name, forward, normalize, want):
    """The key a worker reports each launch under (``stats["cases"]``):
    the wrapper, the direction and the shape, and "unnormalized" only
    for an inverse left unscaled."""
    from distributedfft_tpu_torch.ops import cuda_fft

    assert cuda_fft._case(name, forward, torch.Size([8, 16]),
                          normalize) == want


@pytest.mark.parametrize("drill", ["healthy", "fault"])
def test_two_process_loadgen_and_fault_drill(tmp_path, drill):
    """The fleet smoke on the CPU at the JAX package's default shapes:
    a healthy two-process run gates 0; with ``DFFT_FAULT_INJECT`` rank 0
    wedges, and the run gates 1 on a stall on its stream only."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DFFT_FAULT_INJECT", "DFFT_QOS",
                        "DFFT_MONITOR", "DFFT_MONITOR_DIR")}
    env["PYTHONPATH"] = REPO
    if drill == "fault":
        env["DFFT_FAULT_INJECT"] = "execute:every=1,kind=deterministic"
    r = subprocess.run(
        [sys.executable, "-m", "distributedfft_tpu_torch.loadgen",
         "--procs", "2", "--duration", "2", "--rate", "30",
         "--device", "cpu", "--mesh", "0", "--dir", str(tmp_path),
         "--gate", "--json"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=60)
    doc = json.loads(r.stdout)
    assert doc["worker_rcs"] == [0, 0], r.stderr
    assert len(doc["procs"]) == 2 and len(doc["workers"]) == 2
    by_rank = {w["rank"]: w for w in doc["workers"]}
    sid = {w["rank"]: next(s for s in doc["procs"]
                           if s.split(":")[1].split("#")[0]
                           == str(w["pid"])) for w in doc["workers"]}
    if drill == "healthy":
        assert r.returncode == 0, r.stdout + r.stderr
        assert doc["status"] in ("ok", "warn")
        assert not [a for a in doc["alerts"] if a["severity"] == "alert"]
        assert not any(w["wedged"] for w in doc["workers"])
        return
    assert r.returncode == 1, r.stdout + r.stderr
    assert doc["status"] == "alert"
    assert by_rank[0]["wedged"] and not by_rank[1]["wedged"]
    assert any(a["name"] in ("stall", "fleet_stall") for a in doc["alerts"])
    assert any(a["name"] == "stall" for a in doc["procs"][sid[0]]["alerts"])
    assert [a for a in doc["alerts"] if a["name"] == "fleet_stall"] and all(
        a["proc"] == sid[0] for a in doc["alerts"]
        if a["name"] == "fleet_stall")
    assert doc["procs"][sid[1]]["alerts"] == []


@pytest.mark.parametrize("module", ["monitor", "fleet", "loadgen",
                                    "utils.debug"])
def test_modules_import_no_jax(module):
    code = (f"import sys, distributedfft_tpu_torch.{module}\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'distributedfft_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
