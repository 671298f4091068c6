"""The readings a cell's limits are set from: the numbers of
:mod:`h100bench.check` for the program over many seeds (the lower
reading is their largest) and for the configuration's control (the
upper reading is its smallest), in one process per rank::

    python3 -m h100bench.control --workload grid512_1card.c2c \\
        --first-seed 5000 --seeds 12 --out control.json

Each seed's program reading runs one warm pair and then
``bench.SAMPLE_PAIRS`` pairs back to back at the cell's own size, and
compares those, as a run compares its kept pairs. The control is the
configuration's ``control``: ``reference_lowp``, the reference in
bfloat16 in the program's place, or ``program``, the program with the
lower-precision path its ``plan`` names switched on. ``--cpu`` rehearses
on the CPU (the tests, at tiny sizes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import bench, check
from .field import make_field


def _pairs(fwd, bwd, x, n: int) -> list:
    bwd(fwd(x))
    out = []
    for _ in range(n):
        y = fwd(x)
        out.append((y, bwd(y)))
    return out


def readings(rank: int, size: int, cell, seeds, cpu: bool,
             init: str | None = None) -> list | None:
    """Every seed's program and control numbers (rank 0; None on the
    others)."""
    with bench.rank_context(rank, size, cpu, init) as device:
        comm, world, layout, plans = bench.open_rank(cell, rank, size,
                                                     device)
        ref = bench.reference(cell)
        ctl = cell.config["control"]
        n = bench.SAMPLE_PAIRS
        lowp = None
        if ctl["kind"] == "program":
            lowp = bench.make_plans(cell, world, device, extra=ctl["plan"])
        elif ctl["kind"] != "reference_lowp" or size > 1:
            raise ValueError(f"no control {ctl!r} on {size} ranks")
        rows = []
        for seed in seeds:
            row = {"seed": seed}
            for side, ps in (("program", plans), ("control", lowp)):
                if ps is None:
                    kept = check.reference_pairs(layout, ref, seed, n)
                else:
                    x = make_field(layout.shape, *layout.in_box,
                                   layout.in_dtype, seed, device)
                    kept = _pairs(*ps, x, n)
                    del x
                row[side] = check.numbers(
                    check.compare(layout, ref, seed, kept, comm))
                del kept
            rows.append(row)
            if rank == 0:
                print(json.dumps(row), flush=True)
        return rows if rank == 0 else None


def _entry(rank, size, cell, seeds, cpu, init, out) -> None:
    rows = readings(rank, size, cell, seeds, cpu, init)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(rows, f)


def summary(rows: list) -> dict:
    """Per number: the program's largest reading (the lower end of a
    limit) and the control's smallest (the upper end)."""
    return {k: {"program_max": max(r["program"][k] for r in rows),
                "control_min": min(r["control"][k] for r in rows)}
            for k in check.NUMBERS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--root", default=str(bench.CODE_ROOT))
    args = ap.parse_args(argv)
    cell = bench.load_cell(args.root, args.workload)
    if not args.cpu and torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} NVIDIA cards", file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    if cell.chips == 1:
        rows = readings(0, 1, cell, seeds, args.cpu)
    else:
        rows = bench.spawn(_entry, cell.chips, cell, seeds, args.cpu)
    result = {"workload": cell.name, "rows": rows, "summary": summary(rows)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
