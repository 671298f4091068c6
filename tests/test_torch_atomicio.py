"""The port's concurrent-writer-safe store primitives
(``distributedfft_tpu_torch/utils/atomicio.py``) against the JAX
package's (``tests/test_atomic_stores.py``).

The wisdom JSONL and the hardware profile route through them (one
``O_APPEND`` ``os.write`` per append; temp file and rename for a whole
document). Four processes appending to one file at once produce exactly
4 x 250 whole lines in per-writer order; the same calls through both
packages' modules give the same bytes; the tuner's and the profile's
writers leave no torn line and no temp file.
"""

import json
import os
import subprocess
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
AIO = os.path.join(REPO, "distributedfft_tpu_torch", "utils", "atomicio.py")
JAIO = os.path.join(REPO, "distributedfft_tpu", "utils", "atomicio.py")

_WORKER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("aio", sys.argv[1])
aio = importlib.util.module_from_spec(spec)
spec.loader.exec_module(aio)
path, wid, n = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
for i in range(n):
    aio.append_line(path, json.dumps(
        {"writer": wid, "i": i, "pad": "x" * 256}))
"""


def _load(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_module_is_standard_library_only():
    import ast

    with open(AIO) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or ".").split(".")[0])
    assert mods == {"__future__", "os"}


def test_multiprocess_appends_never_tear_or_interleave(tmp_path):
    path = str(tmp_path / "store.jsonl")
    nproc, nlines = 4, 250
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, AIO, path, str(w), str(nlines)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for w in range(nproc)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == nproc * nlines
    seen: dict[int, list[int]] = {w: [] for w in range(nproc)}
    for ln in lines:
        obj = json.loads(ln)
        assert obj["pad"] == "x" * 256
        seen[obj["writer"]].append(obj["i"])
    for idxs in seen.values():
        assert idxs == list(range(nlines))


@pytest.mark.parametrize("calls", [
    [("lines", ["a", "b\n"]), ("line", "c"), ("lines", [])],
    [("line", "x" * 1000), ("lines", ["\n", "y"])],
    [("replace", "{\"v\": 1}\n"), ("replace", "{\"v\": 2}\n")],
])
def test_same_bytes_as_jax(calls, tmp_path):
    out = []
    for src, name in ((JAIO, "_jaio"), (AIO, "_taio")):
        aio = _load(src, name)
        path = str(tmp_path / name / "f.txt")
        for what, arg in calls:
            {"lines": aio.append_lines, "line": aio.append_line,
             "replace": aio.replace_file}[what](path, arg)
        with open(path, "rb") as f:
            out.append(f.read())
        assert os.listdir(os.path.dirname(path)) == ["f.txt"]
    assert out[0] == out[1]


def test_replace_file_is_atomic_and_total(tmp_path):
    aio = _load(AIO, "_taio2")
    path = str(tmp_path / "doc.json")
    aio.replace_file(path, "{\"v\": 1}\n")
    aio.replace_file(path, "{\"v\": 2}\n")
    with open(path) as f:
        assert json.load(f) == {"v": 2}
    assert os.listdir(tmp_path) == ["doc.json"]


def test_wisdom_and_profile_routes_go_through_one_write(tmp_path):
    """The tuner's wisdom writer and the profile writer produce whole
    documents through the helpers: every record reads back, no drop."""
    from distributedfft_tpu_torch import calibrate, tuner

    path = str(tmp_path / "w.jsonl")
    for i in range(5):
        tuner.record_wisdom({"i": i}, tuner.Candidate(
            "slab", "alltoall", "torch", 1), 0.1 * (i + 1), path=path)
    entries, dropped = tuner.load_wisdom(path)
    assert dropped == 0 and len(entries) == 5
    prof = str(tmp_path / "hw.json")
    calibrate.write_profile({"schema": 1}, prof)
    assert calibrate.load_profile(prof) == {"schema": 1}
    assert sorted(os.listdir(tmp_path)) == ["hw.json", "w.jsonl"]
