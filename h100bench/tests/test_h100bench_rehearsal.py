"""Whole runs on the CPU at a tiny size: one rank, and four ranks over
gloo; the result line's schema; a run without the cards it needs."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench import run
from helpers import REPO, last_json, tiny_root

SEED = 2 ** 31 + 11  # past 32 signed bits


def _run(root, cell, trace, capsys, seconds=0.3, extra=()):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", str(trace), "--root", str(root),
                   *extra])
    out, err = capsys.readouterr()
    return rc, out, err


def _units(section):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return {m["name"]: m["unit"] for m in bench[section]}


def check_schema(line, trace, count):
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 4 and line["attempted"] % 2 == 0
    units = _units("per_layer" if trace else "end_to_end")
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
        assert isinstance(m["value"], float)
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == count
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k, c in line["checks"].items():
        assert k in ("fwd_err", "bwd_err")
        assert 0 <= c["value"] <= c["limit"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["grid512_1card.c2c", "grid512_1card.r2c"])
def test_one_rank(tmp_path, capsys, cell, trace):
    rc, out, err = _run(tiny_root(tmp_path), cell, trace, capsys,
                        extra=("--cpu",))
    assert rc == 0, err
    line = last_json(out)
    check_schema(line, trace, 1)
    names = set(line["metrics"])
    # a rehearsal reports no device metric
    assert names == ({"host_call_ms"} if trace else {"gflops", "setup_s"})
    tail = err.strip().splitlines()[-2:]
    assert [t.split()[0] for t in tail] == ["fwd_err", "bwd_err"]
    assert all(" limit " in t for t in tail)


def test_four_ranks_gloo(tmp_path, capsys):
    rc, out, err = _run(tiny_root(tmp_path), "grid512_slab4.c2c", 1, capsys,
                        extra=("--cpu",))
    assert rc == 0, err
    check_schema(last_json(out), 1, 4)


def test_too_few_cards_fails_without_a_result(tmp_path, capsys):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine holds the four cards the cell asks for")
    rc, out, err = _run(tiny_root(tmp_path), "grid512_slab4.c2c", 0, capsys)
    assert rc != 0
    assert out.strip() == ""
    assert "needs 4 NVIDIA cards" in err


def test_bare_benchmark_directory_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's own
    files has no program to run: the run fails and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                        "grid512_1card.c2c", "--seed", "1", "--seconds", "1",
                        "--cpu"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
