"""Each cell's control (its configuration's lower-precision path, the
reference in bfloat16 or the program's bf16 wire) comes out as not
correct, and the program as correct, at a size a test run holds."""

import json

import pytest

from h100bench import bench, control
from helpers import tiny_root


@pytest.mark.parametrize("cell", ["grid512_1card.c2c", "grid512_1card.r2c",
                                  "grid512_slab4.c2c"])
def test_control_fails_and_program_passes(tmp_path, cell):
    root = tiny_root(tmp_path / "root", n=32)
    out = tmp_path / "control.json"
    rc = control.main(["--workload", cell, "--first-seed", str(2 ** 40),
                       "--seeds", "3", "--cpu", "--root", str(root),
                       "--out", str(out)])
    assert rc == 0
    rows = json.loads(out.read_text())["rows"]
    lim = bench.limits(bench.load_cell(root, cell))
    assert len(rows) == 3
    for r in rows:
        assert all(r["program"][k] <= lim[k] for k in lim)
        assert any(r["control"][k] > lim[k] for k in lim)
