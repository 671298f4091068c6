"""BENCHMARK.json keeps to the benchmark contract's format, and every
name in it finds its file."""

import json
import re

import pytest

from helpers import REPO

B = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in B["command"])
    assert B["paths"] == ["h100bench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("h100bench/")
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in conf for k in c["reduced"])
        assert len(conf["source"]) <= 200
        assert (REPO / "h100bench" / "references"
                / f"{conf['reference']}.py").exists()
        assert any(w["config"] == c["name"] for w in B["workloads"])
    assert len({c["file"] for c in B["configs"]}) == len(B["configs"])


def test_workloads():
    names = [w["name"] for w in B["workloads"]]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in B["workloads"]}) == \
        len(names)
    configs = {c["name"] for c in B["configs"]}
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(names) // 4)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (REPO / "h100bench" / "traffic"
                / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B[section]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if section == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in (SOURCES_E2E if section == "end_to_end"
                               else SOURCES)
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "h100bench" / "metrics" / f"{m['name']}.py").exists()
        if section == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)


def test_every_cell_reports_enough():
    for w in B["workloads"]:
        e2e = [m for m in B["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in B["per_layer"])
