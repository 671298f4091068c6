"""A bench root of tiny cells for the CPU tests: ``BENCHMARK.json`` and
the data files of the real one, every grid cut to ``n``^3."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA_DIRS = ("configs", "traffic", "metrics", "references")


def tiny_root(tmp: Path, n: int = 16) -> Path:
    """A copy of the benchmark's data under ``tmp`` with every
    configuration's grid at ``n``^3; returns the root."""
    for d in DATA_DIRS:
        shutil.copytree(REPO / "h100bench" / d, tmp / "h100bench" / d)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        conf = json.loads(path.read_text())
        conf["shape"] = [n, n, n]
        path.write_text(json.dumps(conf))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
